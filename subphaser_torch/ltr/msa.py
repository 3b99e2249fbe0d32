"""Progressive multiple alignment of domain peptides + alignment distances.

Port of the JAX package's ltr/msa.py. The host parts are copies, numpy
kept as numpy (the Gotoh DP's path depends on the last bit of the profile
scores, and the Kimura correction is held in float64). The device part is
:func:`match_counts`, the all-pairs valid and match counts behind the
Kimura distances: hand-written CUDA kernels (csrc/tree_counts.cu) with its
plain PyTorch version beside them (:func:`match_counts_plain`, the JAX
function's 21 one-hot products). A CPU tensor takes the plain version; a
CUDA tensor launches a kernel or raises
:class:`~subphaser_torch.kernels.KernelError`. The kernel has two routes,
picked from the weights' values before the launch
(:func:`match_counts_route`): ``bits`` (bit planes and popcounts over the
columns expanded by their integer weights; every call of the trees' path)
and ``float`` (a float32 add a pair and column, for any other weights).
``launches["match_counts"]`` counts the calls that launched a kernel,
``route_launches["match_counts"]`` the same calls by route.

Replaces the reference's external MSA/phylogeny stack — mafft alignment of
concatenated domain peptides, trimal trimming, FastTree ML with local
supports (reference LTR.py:144-299, run `mafft/trimal/FastTree` at
LTR.py:196-221, api/TEsorter/modules/concatenate_domains.py:10-143) — with:

- a native progressive profile-profile aligner (csrc/ltr_native.cpp
  sp_profile_align, Gotoh affine-gap DP over 21-dim column-frequency dot
  products; guide tree by UPGMA over k-mer-sketch distances),
- trimal-style gap-column trimming,
- Kimura-corrected protein distances over the all-pairs match/valid counts
  (on the device),
- neighbor joining (native sp_nj_tree) with BOOTSTRAP support values from
  column-resampled distance replicates (FastTree's local supports analogue).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from subphaser_torch.device import resolve_device
from subphaser_torch.kernels import KernelError
from subphaser_torch.ltr.native import nj_tree, profile_align

AA = "ACDEFGHIKLMNPQRSTVWY"
AA_ORD = {a: i for i, a in enumerate(AA)}
GAP = 20  # gap index in the 21-letter profile alphabet

# BLOSUM62 over the 20 canonical amino acids (order = AA above), public
# constants (Henikoff & Henikoff 1992).
_B62 = """
 4  0 -2 -1 -2  0 -2 -1 -1 -1 -1 -2 -1 -1 -1  1  0  0 -3 -2
 0  9 -3 -4 -2 -3 -3 -1 -3 -1 -1 -3 -3 -3 -3 -1 -1 -1 -2 -2
-2 -3  6  2 -3 -1 -1 -3 -1 -4 -3  1 -1  0 -2  0 -1 -3 -4 -3
-1 -4  2  5 -3 -2  0 -3  1 -3 -2  0 -1  2  0  0 -1 -2 -3 -2
-2 -2 -3 -3  6 -3 -1  0 -3  0  0 -3 -4 -3 -3 -2 -2 -1  1  3
 0 -3 -1 -2 -3  6 -2 -4 -2 -4 -3  0 -2 -2 -2  0 -2 -3 -2 -3
-2 -3 -1  0 -1 -2  8 -3 -1 -3 -2  1 -2  0  0 -1 -2 -3 -2  2
-1 -1 -3 -3  0 -4 -3  4 -3  2  1 -3 -3 -3 -3 -2 -1  3 -3 -1
-1 -3 -1  1 -3 -2 -1 -3  5 -2 -1  0 -1  1  2  0 -1 -2 -3 -2
-1 -1 -4 -3  0 -4 -3  2 -2  4  2 -3 -3 -2 -2 -2 -1  1 -2 -1
-1 -1 -3 -2  0 -3 -2  1 -1  2  5 -2 -2  0 -1 -1 -1  1 -1 -1
-2 -3  1  0 -3  0  1 -3  0 -3 -2  6 -2  0  0  1  0 -3 -4 -2
-1 -3 -1 -1 -4 -2 -2 -3 -1 -3 -2 -2  7 -1 -2 -1 -1 -2 -4 -3
-1 -3  0  2 -3 -2  0 -3  1 -2  0  0 -1  5  1  0 -1 -2 -2 -1
-1 -3 -2  0 -3 -2  0 -3  2 -2 -1  0 -2  1  5 -1 -1 -3 -3 -2
 1 -1  0  0 -2  0 -1 -2  0 -2 -1  1 -1  0 -1  4  1 -2 -3 -2
 0 -1 -1 -1 -2 -2 -2 -1 -1 -1 -1  0 -1 -1 -1  1  5  0 -2 -2
 0 -1 -3 -2 -1 -3 -3  3 -2  1  1 -3 -2 -2 -3 -2  0  4 -3 -1
-3 -2 -4 -3  1 -2 -2 -3 -3 -2 -1 -4 -4 -2 -3 -3 -2 -3 11  2
-2 -2 -3 -2  3 -3  2 -1 -2 -1 -1 -2 -3 -1 -2 -2 -2 -1  2  7
"""


def blosum62_21() -> np.ndarray:
    """(21, 21) float32: BLOSUM62 with a gap row/column.

    Gap-vs-residue scores a mild penalty (the affine open/extend penalties
    carry the real gap cost in the DP); gap-vs-gap is free, as in standard
    profile sum-of-pairs scoring."""
    s = np.array(_B62.split(), dtype=np.float32).reshape(20, 20)
    out = np.full((21, 21), -1.0, dtype=np.float32)
    out[:20, :20] = s
    out[GAP, GAP] = 0.0
    return out


def encode_peptides(peps: list[str]) -> list[np.ndarray]:
    """Peptide strings -> uint8 index arrays (unknown residues dropped)."""
    out = []
    for p in peps:
        idx = np.array([AA_ORD.get(a, -1) for a in p.upper()], dtype=np.int16)
        out.append(idx[idx >= 0].astype(np.uint8))
    return out


def _kmer_profile(seq: np.ndarray, k: int = 3, dim: int = 4096) -> np.ndarray:
    """Hashed k-mer count vector for guide-tree distances (cheap, host)."""
    v = np.zeros(dim, dtype=np.float64)
    n = seq.size - k + 1
    if n <= 0:
        return v
    code = np.zeros(n, dtype=np.int64)
    for j in range(k):
        code = code * 20 + seq[j : j + n]
    np.add.at(v, code % dim, 1.0)
    nrm = np.linalg.norm(v)
    return v / nrm if nrm > 0 else v


def _guide_order(seqs: list[np.ndarray]) -> list[tuple[int, int]]:
    """UPGMA merge schedule over cosine k-mer distances.

    Returns (i, j) merges over cluster ids: leaves are 0..n-1, merge t
    creates cluster n + t."""
    n = len(seqs)
    profs = np.stack([_kmer_profile(s) for s in seqs])
    dm = 1.0 - profs @ profs.T
    np.fill_diagonal(dm, np.inf)
    size = {i: 1 for i in range(n)}
    merges = []
    rows = list(range(n))  # rows[r] = cluster id occupying row r (or None)
    alive = np.ones(n, dtype=bool)
    for t in range(n - 1):
        sub = np.where(alive)[0]
        block = dm[np.ix_(sub, sub)]
        r, c = np.unravel_index(np.argmin(block), block.shape)
        ri, rj = int(sub[r]), int(sub[c])
        ci, cj = rows[ri], rows[rj]
        merges.append((ci, cj))
        new_id = n + t
        si, sj = size[ci], size[cj]
        # UPGMA average-linkage update into row ri
        dm[ri, :] = (si * dm[ri, :] + sj * dm[rj, :]) / (si + sj)
        dm[:, ri] = dm[ri, :]
        dm[ri, ri] = np.inf
        alive[rj] = False
        rows[ri] = new_id
        size[new_id] = si + sj
    return merges


def _profile(block: np.ndarray) -> np.ndarray:
    """(m, L) uint8 aligned block -> (L, 21) float32 column frequencies."""
    m, L = block.shape
    prof = np.zeros((L, 21), dtype=np.float32)
    for a in range(21):
        prof[:, a] = (block == a).sum(axis=0)
    return prof / max(m, 1)


def _apply_ops(b1: np.ndarray, b2: np.ndarray, ops: np.ndarray) -> np.ndarray:
    """Merge two aligned blocks along an (op, len) run list."""
    cols1, cols2 = [], []
    i = j = 0
    for op, ln in ops:
        if op == 0:
            cols1.append(b1[:, i : i + ln]); cols2.append(b2[:, j : j + ln])
            i += ln; j += ln
        elif op == 1:
            cols1.append(b1[:, i : i + ln])
            cols2.append(np.full((b2.shape[0], ln), GAP, np.uint8))
            i += ln
        else:
            cols1.append(np.full((b1.shape[0], ln), GAP, np.uint8))
            cols2.append(b2[:, j : j + ln])
            j += ln
    top = np.concatenate(cols1, axis=1) if cols1 else b1[:, :0]
    bot = np.concatenate(cols2, axis=1) if cols2 else b2[:, :0]
    return np.concatenate([top, bot], axis=0)


def progressive_msa(peptides: list[str], gap_open: float = 11.0,
                    gap_ext: float = 1.0) -> np.ndarray:
    """Align peptides progressively along a UPGMA guide tree.

    Returns (n, L) uint8 with rows in INPUT order (20 = gap). Mirrors the
    role of the reference's mafft run (LTR.py:196-204) with a native
    profile-profile Gotoh aligner per merge."""
    seqs = encode_peptides(peptides)
    n = len(seqs)
    if n == 0:
        return np.zeros((0, 0), dtype=np.uint8)
    if n == 1:
        return seqs[0][None, :]
    S = blosum62_21()
    merges = _guide_order(seqs)
    # cluster id -> (row indices, aligned block)
    clusters: dict[int, tuple[list[int], np.ndarray]] = {
        i: ([i], seqs[i][None, :].astype(np.uint8)) for i in range(n)
    }
    for t, (ci, cj) in enumerate(merges):
        rows1, b1 = clusters.pop(ci)
        rows2, b2 = clusters.pop(cj)
        if b1.shape[1] == 0 or b2.shape[1] == 0:
            # degenerate empty profile: pad the empty one with gaps
            L = max(b1.shape[1], b2.shape[1])
            b1p = np.full((b1.shape[0], L), GAP, np.uint8); b1p[:, : b1.shape[1]] = b1
            b2p = np.full((b2.shape[0], L), GAP, np.uint8); b2p[:, : b2.shape[1]] = b2
            merged = np.concatenate([b1p, b2p], axis=0)
        else:
            p1 = _profile(b1)
            sp2 = _profile(b2) @ S.T
            ops = profile_align(p1, sp2, gap_open=gap_open, gap_ext=gap_ext)
            merged = _apply_ops(b1, b2, ops)
        clusters[n + t] = (rows1 + rows2, merged)
    (rows, block), = clusters.values()
    order = np.argsort(np.asarray(rows))
    return block[order]


def trim_alignment(aln: np.ndarray, min_residue_frac: float = 0.1,
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Drop columns whose non-gap fraction is below ``min_residue_frac``
    (trimal -gt analogue; the reference runs trimal -automated1,
    LTR.py:205-213). Returns (trimmed, kept column indices)."""
    if aln.size == 0:
        return aln, np.zeros(0, np.int64)
    frac = (aln != GAP).mean(axis=0)
    keep = np.flatnonzero(frac >= min_residue_frac)
    if keep.size == 0:  # never trim to nothing
        keep = np.arange(aln.shape[1])
    return aln[:, keep], keep


# ---------------------------------------------------------------------------
# all-pairs valid and match counts: plain PyTorch version and the CUDA kernel
# ---------------------------------------------------------------------------
launches = {"match_counts": 0}
route_launches = {"match_counts": {"bits": 0, "float": 0}}
# csrc/tree_counts.cu EXPANDED_LIMIT: the bits route takes weights summing below it
EXPANDED_LIMIT = 1 << 16
PLANES = 8  # csrc/tree_counts.cu: scratch words a (row, 32 expanded columns)
_launch_lock = threading.Lock()
_lib = None


def match_counts_plain(aln: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``_match_counts`` in plain PyTorch: (n, L) uint8 alignment
    (GAP = 20) and (L,) float32 column weights -> (V, M), each (n, n)
    float32: V the weighted count of columns where both rows hold a
    residue, M of columns where both hold the same one of the 20, as 21
    float32 one-hot matmuls."""
    valid = (aln != GAP).to(torch.float32)
    V = (valid * w) @ valid.T
    M = torch.zeros((aln.shape[0], aln.shape[0]), dtype=torch.float32, device=aln.device)
    for c in range(20):
        x = (aln == c).to(torch.float32)
        M = M + (x * w) @ x.T
    return V, M


def match_counts_route(w: np.ndarray) -> str:
    """The route of :func:`match_counts` for these (host) weights:
    ``"bits"`` where every weight is a non-negative integer and their sum
    is below EXPANDED_LIMIT (so every count is an integer below 2^24, exact
    in float32), else ``"float"``."""
    w = np.asarray(w, dtype=np.float64)
    if not np.isfinite(w).all() or (w < 0).any() or (w != np.floor(w)).any():
        return "float"
    return "bits" if w.sum() < EXPANDED_LIMIT else "float"


def expansion_index(w: np.ndarray) -> np.ndarray:
    """The bits route's expanded columns: column c repeated w_c times
    (int32). ``match_counts_plain(aln[:, idx], ones)`` equals
    ``match_counts_plain(aln, w)`` for non-negative integer weights."""
    w = np.asarray(w)
    return np.repeat(np.arange(w.size, dtype=np.int32), w.astype(np.int64))


def tree_counts_lib():
    """csrc/tree_counts.cu (both tree kernels), built at first use."""
    global _lib
    with _launch_lock:
        if _lib is None:
            import ctypes

            from subphaser_torch import kernels

            lib = kernels.load("tree_counts")
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.tc_match_counts.argtypes = [ptr, ptr, i32, i32, ptr, ptr, ptr]
            lib.tc_match_counts_bits.argtypes = [ptr, i32, i32, ptr, i32, ptr, ptr, ptr, ptr]
            lib.tc_inter_counts.argtypes = [ptr, i32, ptr, ptr, ctypes.c_longlong, ptr, ptr]
            lib.tc_error_string.argtypes = [i32]
            for fn in (lib.tc_match_counts, lib.tc_match_counts_bits, lib.tc_inter_counts):
                fn.restype = i32
            lib.tc_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def match_counts(aln: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """All-pairs (V, M) of :func:`match_counts_plain`. A CUDA tensor
    launches csrc/tree_counts.cu on the current stream (thread-safe:
    outputs and scratch are allocated a call, the launch counts are
    updated under a lock); a CPU tensor takes the plain version.

    The route is :func:`match_counts_route` of the weights, read from the
    card once. ``bits`` packs each row's columns,
    expanded by :func:`expansion_index`, into bit planes and counts pairs
    by popcounts: integer sums, equal to the JAX package's float32 matmuls
    bit for bit. ``float`` adds each column's weight in float32 where the
    matmuls multiply one-hot columns, in another order: with non-integer
    weights the two may differ in the last bits."""
    if aln.dim() != 2 or aln.dtype != torch.uint8:
        raise ValueError(f"match_counts: the alignment must be (n, L) uint8, got "
                         f"{aln.dtype} {tuple(aln.shape)}")
    n, length = aln.shape
    if w.shape != (length,) or w.dtype != torch.float32:
        raise ValueError(f"match_counts: weights must be ({length},) float32, got "
                         f"{w.dtype} {tuple(w.shape)}")
    if aln.device != w.device:
        raise ValueError("match_counts: the alignment and weights must be on one device")
    if aln.device.type == "cpu":
        return match_counts_plain(aln, w)
    if aln.device.type != "cuda":
        raise ValueError(f"match_counts: unsupported device {aln.device}")
    V = torch.empty((n, n), dtype=torch.float32, device=aln.device)
    M = torch.empty((n, n), dtype=torch.float32, device=aln.device)
    if n == 0:
        return V, M
    wh = w.cpu().numpy()
    route = match_counts_route(wh)
    lib = tree_counts_lib()
    a = aln.contiguous()
    with torch.cuda.device(aln.device):
        stream = torch.cuda.current_stream(aln.device).cuda_stream
        if route == "bits":
            idx = torch.from_numpy(expansion_index(wh)).to(aln.device)
            words = -(-idx.numel() // 32)
            planes = torch.empty(n * words * PLANES, dtype=torch.int32, device=aln.device)
            err = lib.tc_match_counts_bits(a.data_ptr(), n, length, idx.data_ptr(), idx.numel(),
                                           planes.data_ptr(), V.data_ptr(), M.data_ptr(),
                                           stream)
        else:
            wc = w.contiguous()
            err = lib.tc_match_counts(a.data_ptr(), wc.data_ptr(), n, length, V.data_ptr(),
                                      M.data_ptr(), stream)
    if err != 0:
        raise KernelError(f"tc_match_counts ({route} route) launch failed: "
                          + lib.tc_error_string(err).decode())
    with _launch_lock:
        launches["match_counts"] += 1
        route_launches["match_counts"][route] += 1
    return V, M


def kimura_distances(aln: np.ndarray, weights: np.ndarray | None = None,
                     device=None) -> np.ndarray:
    """Kimura-corrected protein distances from an alignment.

    p = mismatches / mutually-ungapped columns per pair;
    d = -ln(1 - p - 0.2 p^2) (Kimura 1983, the correction FastTree and
    scoredist-style tools apply). The all-pairs match and valid counts are
    :func:`match_counts` on ``device`` (CUDA unless the caller asks for the
    CPU); the correction is host float64. ``weights`` (float per column)
    supports bootstrap column resampling."""
    n, L = aln.shape
    if n == 0:
        return np.zeros((0, 0))
    dev = resolve_device(device)
    w = np.ones(L, np.float32) if weights is None else weights.astype(np.float32)
    V, M = match_counts(torch.from_numpy(np.ascontiguousarray(aln, dtype=np.uint8)).to(dev),
                        torch.from_numpy(w).to(dev))
    V_np = V.cpu().numpy().astype(np.float64)
    M_np = M.cpu().numpy().astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = 1.0 - M_np / V_np
    p = np.clip(np.nan_to_num(p, nan=1.0), 0.0, 0.85)
    d = -np.log(np.maximum(1.0 - p - 0.2 * p * p, 1e-6))
    np.fill_diagonal(d, 0.0)
    return d


def _bipartitions(newick: str) -> set[frozenset[str]]:
    """Non-trivial bipartitions (as the smaller-side leaf set canonicalized
    by the full leaf set) of a newick tree."""
    from subphaser_torch.ltr.tree import parse_newick

    root = parse_newick(newick)
    all_leaves: set[str] = set()
    parts: list[set[str]] = []

    def walk(n) -> set[str]:
        if not n.children:
            all_leaves.add(n.name)
            return {n.name}
        s: set[str] = set()
        for c in n.children:
            s |= walk(c)
        parts.append(s)
        return s

    walk(root)
    out: set[frozenset[str]] = set()
    for s in parts:
        if 1 < len(s) < len(all_leaves) - 1:
            comp = all_leaves - s
            out.add(frozenset(min(s, comp, key=lambda x: sorted(x))))
    return out


def _annotate_supports(newick: str, support: dict[frozenset[str], int]) -> str:
    """Write integer bootstrap percentages as internal node labels."""
    from subphaser_torch.ltr.tree import _to_newick, parse_newick

    root = parse_newick(newick)
    all_leaves: set[str] = set()

    def leaves(n) -> set[str]:
        if not n.children:
            all_leaves.add(n.name)
            return {n.name}
        s: set[str] = set()
        for c in n.children:
            s |= leaves(c)
        return s

    leaves(root)

    def walk(n) -> set[str]:
        if not n.children:
            return {n.name}
        s: set[str] = set()
        for c in n.children:
            s |= walk(c)
        if 1 < len(s) < len(all_leaves) - 1:
            key = frozenset(min(s, all_leaves - s, key=lambda x: sorted(x)))
            if key in support:
                n.name = str(support[key])
        return s

    walk(root)
    out = _to_newick(root)
    return out[: out.rfind(":")] + ";"


def nj_with_support(aln: np.ndarray, names: list[str], n_boot: int = 100,
                    seed: int = 0, threads: int = 8, device=None) -> str:
    """NJ tree from Kimura distances + bootstrap supports.

    Bootstrap = resample alignment columns (multinomial weights reuse the
    same device counts), NJ per replicate (native, GIL released ->
    thread-parallel), support = % of replicates containing each bipartition
    — the role of FastTree's local support values (reference LTR.py:216).
    The distances' counts run on ``device`` (CUDA unless the caller asks for
    the CPU), from ``threads`` threads at once.
    """
    n, L = aln.shape
    device = resolve_device(device)
    dist = kimura_distances(aln, device=device)
    main = nj_tree(dist, names)
    if n_boot <= 0 or n < 4 or L < 2:
        return main
    rng = np.random.default_rng(seed)
    weight_sets = rng.multinomial(L, np.full(L, 1.0 / L), size=n_boot)

    def one(b: int) -> set[frozenset[str]]:
        d = kimura_distances(aln, weights=weight_sets[b], device=device)
        return _bipartitions(nj_tree(d, names))

    counts: dict[frozenset[str], int] = {}
    with ThreadPoolExecutor(max_workers=threads) as ex:
        for parts in ex.map(one, range(n_boot)):
            for p in parts:
                counts[p] = counts.get(p, 0) + 1
    support = {p: round(100.0 * c / n_boot) for p, c in counts.items()}
    return _annotate_supports(main, support)


def write_fasta_alignment(path: str, names: list[str], aln: np.ndarray) -> None:
    """MSA -> aligned FASTA ('-' gaps), the reference's .aln artifact."""
    letters = np.array(list(AA + "-"), dtype="U1")
    with open(path, "w") as f:
        for name, row in zip(names, aln):
            f.write(f">{name}\n")
            f.write("".join(letters[row].tolist()) + "\n")
