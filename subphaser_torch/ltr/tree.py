"""Subgenome-specific LTR phylogenies -> NJ trees -> circular plot.

Port of the JAX package's ltr/tree.py. The host parts are copies. The
device part is :func:`inter_counts`, the shared values of pairs of MinHash
sketches behind the Mash distances: a hand-written CUDA kernel
(csrc/tree_counts.cu ``inter_counts_kernel``, a warp merge of each pair's
rows) with its plain PyTorch version beside it (:func:`inter_counts_plain`,
the JAX function's batched searchsorted). A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises :class:`~subphaser_torch.kernels.KernelError`.
``launches["inter_counts"]`` counts the calls that launched the kernel. The
sketches themselves are ltr/classify.py's ``_sketch`` (one copy in the
port).

The reference pipeline concatenates TEsorter domain peptides per
(Copia/Gypsy), aligns with mafft, trims with trimal, runs FastTree,
reroots, and renders with ggtree (reference LTR.py:144-299). This native
redesign:

- groups SG-specific LTRs by classified superfamily (or one group when the
  classification database is absent)
- with domain peptides: ALIGNMENT-BASED trees — native progressive MSA +
  trimming + device Kimura distances + NJ with bootstrap supports (ltr/msa)
- without domains (whole-element DNA): alignment-free MinHash sketch (Mash)
  distances, pair intersections computed on the device
- builds trees with the native neighbor-joining (csrc/ltr_native.cpp
  sp_nj_tree)
- renders a circular tree colored by subgenome with matplotlib, where it
  imports
"""

from __future__ import annotations

import math
import threading
from collections import defaultdict

import numpy as np
import torch

from subphaser_torch.device import resolve_device
from subphaser_torch.kernels import KernelError
from subphaser_torch.ltr.classify import SKETCH_K, _sketch
from subphaser_torch.ltr.msa import tree_counts_lib
from subphaser_torch.ltr.native import nj_tree
from subphaser_torch.utils.log import logger

INT32_MAX = np.iinfo(np.int32).max  # sketch padding
PAIR_CHUNK = 1 << 14  # sketch pairs a call of inter_counts

# ---------------------------------------------------------------------------
# shared sketch values of pairs: plain PyTorch version and the CUDA kernel
# ---------------------------------------------------------------------------
launches = {"inter_counts": 0}
_launch_lock = threading.Lock()


def inter_counts_plain(pad: torch.Tensor, ai: torch.Tensor, bi: torch.Tensor) -> torch.Tensor:
    """The JAX ``inter_counts`` in plain PyTorch: sketches (n, s) int32,
    each row sorted and padded with INT32_MAX, and pair row indices (P,)
    int64 -> (P,) int32, for each pair the number of values of row ai
    (other than INT32_MAX) found in row bi by a searchsorted."""
    a, b = pad[ai], pad[bi]
    pos = torch.searchsorted(b, a).clamp_max(pad.shape[1] - 1)
    hit = (torch.gather(b, 1, pos) == a) & (a != INT32_MAX)
    return hit.sum(dim=1, dtype=torch.int32)


def inter_counts(pad: torch.Tensor, ai: torch.Tensor, bi: torch.Tensor, *,
                 checked: bool = False) -> torch.Tensor:
    """Shared values of the sketch pairs (ai[t], bi[t]), as
    :func:`inter_counts_plain`; exact. A CUDA tensor launches
    ``inter_counts_kernel`` of csrc/tree_counts.cu on the current stream
    (a warp a run of consecutive pairs, a merge of the two rows of ``pad``
    the indices name; at most 1536 values a sketch); a CPU tensor takes the
    plain version. Raises ValueError for indices outside [0, n); on CUDA
    that check reads the indices' range back from the card, so a caller
    that built its indices in range on the host passes ``checked=True`` and
    the call does not wait on the card."""
    if pad.dim() != 2 or pad.dtype != torch.int32:
        raise ValueError(f"inter_counts: sketches must be (n, s) int32, got "
                         f"{pad.dtype} {tuple(pad.shape)}")
    if ai.dim() != 1 or ai.shape != bi.shape or ai.dtype != torch.int64 \
            or bi.dtype != torch.int64:
        raise ValueError("inter_counts: pair indices must be two (P,) int64 tensors")
    if len({pad.device, ai.device, bi.device}) != 1:
        raise ValueError("inter_counts: all tensors must be on one device")
    if pad.device.type not in ("cpu", "cuda"):
        raise ValueError(f"inter_counts: unsupported device {pad.device}")
    if ai.numel() and (pad.device.type == "cpu" or not checked) \
            and bool(((ai < 0) | (bi < 0) | (ai >= pad.shape[0]) | (bi >= pad.shape[0])).any()):
        raise ValueError(f"inter_counts: pair indices outside [0, {pad.shape[0]})")
    if pad.device.type == "cpu":
        return inter_counts_plain(pad, ai, bi)
    n_pairs, s = ai.shape[0], pad.shape[1]
    if s > 1536:
        raise ValueError(f"inter_counts: sketches of {s} values; the kernel takes 1536")
    if n_pairs == 0 or s == 0:
        return torch.zeros(n_pairs, dtype=torch.int32, device=pad.device)
    out = torch.empty(n_pairs, dtype=torch.int32, device=pad.device)  # every pair written
    lib = tree_counts_lib()
    p, a, b = pad.contiguous(), ai.contiguous(), bi.contiguous()
    with torch.cuda.device(pad.device):
        stream = torch.cuda.current_stream(pad.device).cuda_stream
        err = lib.tc_inter_counts(p.data_ptr(), s, a.data_ptr(), b.data_ptr(), n_pairs,
                                  out.data_ptr(), stream)
    if err != 0:
        raise KernelError("tc_inter_counts launch failed: " + lib.tc_error_string(err).decode())
    with _launch_lock:
        launches["inter_counts"] += 1
    return out


def pad_sketches(sketches: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """uint64 sketches -> ((n, s) int32 rows, sorted and padded with
    INT32_MAX, s the longest sketch; (n,) int32 sizes). The hashes are
    reduced to 31 bits as the JAX package does (it runs without x64;
    collision probability is negligible at sketch size 256 vs 2^31 space)."""
    s = max((x.size for x in sketches), default=0)
    pad = np.full((len(sketches), s), np.int32(INT32_MAX), dtype=np.int32)
    sizes = np.zeros(len(sketches), dtype=np.int32)
    for i, x in enumerate(sketches):
        v = (x >> np.uint64(33)).astype(np.int32)
        v = np.unique(v)
        pad[i, : v.size] = v
        sizes[i] = v.size
    return pad, sizes


def mash_distances(sketches: list[np.ndarray], k: int = SKETCH_K, device=None) -> np.ndarray:
    """Pairwise Mash distances from bottom-s sketches; the pairs' shared
    values are counted by :func:`inter_counts` on ``device`` (CUDA unless
    the caller asks for the CPU), PAIR_CHUNK pairs a call, and read back
    once."""
    n = len(sketches)
    if n == 0 or max(x.size for x in sketches) == 0:
        return np.zeros((n, n))
    pad, sizes = pad_sketches(sketches)
    a_idx, b_idx = np.triu_indices(n, 1)  # in [0, n) by construction: checked=True below
    dev = resolve_device(device)
    pad_dev = torch.from_numpy(pad).to(dev)
    ai_dev, bi_dev = torch.from_numpy(a_idx).to(dev), torch.from_numpy(b_idx).to(dev)
    parts = [inter_counts(pad_dev, ai_dev[lo : lo + PAIR_CHUNK], bi_dev[lo : lo + PAIR_CHUNK],
                          checked=True)
             for lo in range(0, a_idx.size, PAIR_CHUNK)]
    counts = np.zeros(0, np.int64) if not parts else \
        torch.cat(parts).cpu().numpy().astype(np.int64)  # one read back a call

    dist = np.zeros((n, n))
    for t, (i, j) in enumerate(zip(a_idx, b_idx)):
        union = min(int(sizes[i]) + int(sizes[j]) - int(counts[t]),
                    int(sizes[i]) + int(sizes[j]))
        jac = counts[t] / union if union > 0 else 0.0
        if jac <= 0:
            d = 1.0
        else:
            d = min(1.0, -1.0 / k * math.log(2.0 * jac / (1.0 + jac)))
        dist[i, j] = dist[j, i] = d
    return dist


_DOMAIN_ALIASES = {"AP": "PROT", "RNASEH": "RH"}


def build_ltr_trees(
    enrich_ltrs,
    d_seqs: dict[str, str],
    out_prefix: str,
    domains=None,
    subsample: int = 1000,
    exclude_exchanges: bool = False,
    d_colors: dict | None = None,
    figfmt: str = "pdf",
    seed: int = 0,
    d_class: dict | None = None,
    trim_gt: float | None = None,
    n_boot: int = 100,
    use_branch_lengths: bool = False,
    device=None,
) -> dict[str, tuple[str, str]]:
    """Build one tree per classified superfamily group.

    With ``d_class`` (id -> Classification carrying per-domain peptides),
    trees are built from the CONCATENATED domain peptides of the requested
    ``domains`` — the reference's per-(Copia, Gypsy) INT+RT+RH
    concatenated-domain trees (LTR.py:144-299,
    concatenate_domains.py:10-143) — and elements lacking every requested
    domain are dropped from that group's tree, as the reference does.
    Without domain info, whole-element DNA sketches are used. All trees are
    midpoint-rerooted (nw_reroot analogue, LTR.py:222). The pairwise
    counts run on ``device`` (CUDA unless the caller asks for the CPU); the
    figure is drawn where matplotlib imports.

    Returns {group: (treefile, mapfile)}.
    """
    device = resolve_device(device)
    try:
        import matplotlib  # noqa: F401
        can_plot = True
    except ImportError:
        can_plot = False
        logger.info("matplotlib is not installed: the LTR tree figures are not drawn")
    rng = np.random.default_rng(seed)
    want_doms = [
        _DOMAIN_ALIASES.get(d.upper(), d.upper()) for d in (domains or [])
    ]
    groups = defaultdict(list)
    for ltr in enrich_ltrs:
        if exclude_exchanges and ltr.exchange == "yes":
            continue
        key = ltr.superfamily or "LTR"
        groups[key].append(ltr)

    out = {}
    for key, ltrs in sorted(groups.items()):
        if len(ltrs) < 4:
            logger.info("LTR tree group %s: only %d members, skipping", key, len(ltrs))
            continue
        if subsample and len(ltrs) > subsample:
            idx = rng.choice(len(ltrs), subsample, replace=False)
            ltrs = [ltrs[i] for i in sorted(idx)]

        # concatenated domain peptides when the classifier recorded them
        peptides = None
        if d_class and want_doms:
            peptides = []
            for ltr in ltrs:
                cls = d_class.get(ltr.id)
                dseqs = getattr(cls, "domain_seqs", None) or {}
                peptides.append(
                    "".join(dseqs[d] for d in want_doms if d in dseqs)
                )
            with_dom = [i for i, p in enumerate(peptides) if len(p) >= 30]
            if len(with_dom) >= 4:
                logger.info(
                    "LTR tree group %s: %d/%d elements carry %s domains",
                    key, len(with_dom), len(ltrs), "+".join(want_doms),
                )
                ltrs = [ltrs[i] for i in with_dom]
                peptides = [peptides[i] for i in with_dom]
            else:
                peptides = None

        # ':' in LTR ids collides with newick branch-length syntax
        names = [ltr.id.replace(":", "_") for ltr in ltrs]
        if peptides is not None:
            # alignment-based tree (reference LTR.py:144-299: mafft + trimal
            # + FastTree): native progressive MSA, trimal-style trimming,
            # device Kimura distances, NJ + bootstrap supports (ltr/msa)
            from subphaser_torch.ltr import msa as msamod

            aln = msamod.progressive_msa(peptides)
            msamod.write_fasta_alignment(f"{out_prefix}.{key}.aln", names, aln)
            trimmed, _kept = msamod.trim_alignment(
                aln, min_residue_frac=trim_gt if trim_gt is not None else 0.1
            )
            msamod.write_fasta_alignment(
                f"{out_prefix}.{key}.trimal", names, trimmed
            )
            newick = msamod.nj_with_support(trimmed, names, n_boot=n_boot, device=device)
        else:
            sketches = [
                _sketch(ltr.get_full_seq(d_seqs[ltr.seq_id])) for ltr in ltrs
            ]
            dist = mash_distances(sketches, device=device)
            newick = nj_tree(dist, names)
        try:
            newick = reroot_midpoint(newick)
        except Exception as e:  # noqa: BLE001 — plotting must not kill runs
            logger.warning("Midpoint reroot for %s failed: %s", key, e)
        treefile = f"{out_prefix}.{key}.tree.nwk"
        mapfile = f"{out_prefix}.{key}.tree.map"
        with open(treefile, "w") as f:
            f.write(newick + "\n")
        with open(mapfile, "w") as f:
            for ltr, safe in zip(ltrs, names):
                f.write(f"{safe}\t{ltr.id}\t{ltr.sg}\n")
        if can_plot:
            try:
                plot_circular_tree(newick, {s: l.sg for s, l in zip(names, ltrs)},
                                   d_colors or {}, f"{out_prefix}.{key}.tree.{figfmt}",
                                   use_branch_lengths=use_branch_lengths)
            except Exception as e:
                logger.warning("Tree plot for %s failed: %s", key, e)
        logger.info("LTR tree for %s: %d leaves -> %s", key, len(ltrs), treefile)
        out[key] = (treefile, mapfile)
    return out


# ---------------------------------------------------------------------------
# minimal newick parsing + circular rendering (ggtree-circular analogue)
# ---------------------------------------------------------------------------
class _Node:
    __slots__ = ("name", "length", "children", "angle", "radius")

    def __init__(self):
        self.name = ""
        self.length = 0.0
        self.children = []
        self.angle = 0.0
        self.radius = 0.0


def parse_newick(s: str) -> _Node:
    s = s.strip().rstrip(";")
    pos = [0]

    def parse() -> _Node:
        node = _Node()
        if s[pos[0]] == "(":
            pos[0] += 1
            while True:
                node.children.append(parse())
                if s[pos[0]] == ",":
                    pos[0] += 1
                    continue
                if s[pos[0]] == ")":
                    pos[0] += 1
                    break
        # name
        start = pos[0]
        while pos[0] < len(s) and s[pos[0]] not in ",():;":
            pos[0] += 1
        label = s[start : pos[0]]
        if ":" in label:
            name, _, ln = label.partition(":")
            node.name = name
            node.length = float(ln) if ln else 0.0
        else:
            node.name = label
        if pos[0] < len(s) and s[pos[0]] == ":":
            pos[0] += 1
            start = pos[0]
            while pos[0] < len(s) and s[pos[0]] not in ",()":
                pos[0] += 1
            node.length = float(s[start : pos[0]])
        return node

    return parse()


def _to_newick(node: _Node) -> str:
    if not node.children:
        return f"{node.name}:{node.length:.6g}"
    inner = ",".join(_to_newick(c) for c in node.children)
    return f"({inner}){node.name}:{node.length:.6g}"


def reroot_midpoint(newick: str) -> str:
    """Reroot at the midpoint of the longest leaf-to-leaf path.

    The reference pipes its trees through nw_reroot before plotting
    (LTR.py:222); midpoint rooting is the label-free equivalent.
    """
    import sys

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100_000))
    root = parse_newick(newick)
    # undirected adjacency over node objects
    adj: dict[int, list[tuple[_Node, float]]] = {}
    nodes: dict[int, _Node] = {}

    def walk(n):
        nodes[id(n)] = n
        adj.setdefault(id(n), [])
        for c in n.children:
            adj.setdefault(id(c), [])
            adj[id(n)].append((c, c.length))
            adj[id(c)].append((n, c.length))
            walk(c)

    walk(root)
    leaves = [n for n in nodes.values() if not n.children]
    if len(leaves) < 3:
        return newick

    def farthest(start):
        dist = {id(start): 0.0}
        prev: dict[int, _Node] = {}
        stack = [start]
        while stack:
            u = stack.pop()
            for v, w in adj[id(u)]:
                if id(v) not in dist:
                    dist[id(v)] = dist[id(u)] + w
                    prev[id(v)] = u
                    stack.append(v)
        best = max(leaves, key=lambda l: dist[id(l)])
        return best, dist, prev

    a, _, _ = farthest(leaves[0])
    b, dist, prev = farthest(a)
    # path a -> b; walk back from b until the midpoint edge
    half = dist[id(b)] / 2.0
    cur, walked = b, 0.0
    while id(cur) in prev:
        parent = prev[id(cur)]
        elen = dist[id(cur)] - dist[id(parent)]
        if walked + elen >= half:
            # midpoint lies on edge (parent, cur), at `half - walked` from cur
            off = half - walked
            new_root = _Node()
            new_root.name = ""
            new_root.length = 0.0

            def hang(n, come_from, blen):
                """Re-orient: make n a child subtree rooted away from come_from."""
                m = _Node()
                m.name = n.name
                m.length = blen
                for v, w in adj[id(n)]:
                    if v is come_from:
                        continue
                    m.children.append(hang(v, n, w))
                return m

            c1 = hang(cur, parent, off)
            c2 = hang(parent, cur, elen - off)
            new_root.children = [c1, c2]
            return _to_newick(new_root)[: _to_newick(new_root).rfind(":")] + ";"
        walked += elen
        cur = parent
    return newick


def plot_circular_tree(newick: str, d_sg: dict[str, str], d_colors: dict,
                       outfig: str, use_branch_lengths: bool = False) -> None:
    """``use_branch_lengths`` mirrors -ggtree_options: the reference
    default ``branch.length='none'`` is the cladogram depth layout; any
    other value renders radial distance as cumulative branch length
    (reference __main__.py:200-204 -> LTR.py ggtree call)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    root = parse_newick(newick)
    leaves: list[_Node] = []

    def collect(n):
        if not n.children:
            leaves.append(n)
        for c in n.children:
            collect(c)

    collect(root)
    n_leaves = len(leaves)
    for i, leaf in enumerate(leaves):
        leaf.angle = 2 * math.pi * i / max(n_leaves, 1)

    def assign(n, depth):
        # cladogram depth layout (branch.length='none' in the reference
        # opts) or phylogram cumulative-length layout
        n.radius = depth
        if n.children:
            for c in n.children:
                step = max(c.length, 0.0) if use_branch_lengths else 1
                assign(c, depth + step)
            n.angle = float(np.mean([c.angle for c in n.children]))

    assign(root, 0)
    maxdepth = max((l.radius for l in leaves), default=1)
    if not use_branch_lengths:
        for leaf in leaves:
            leaf.radius = maxdepth  # leaves on the outer ring

    fig = plt.figure(figsize=(8, 8), dpi=200)
    ax = fig.add_subplot(111, polar=True)
    ax.set_axis_off()

    def draw(n):
        for c in n.children:
            # radial segment
            ax.plot([c.angle, c.angle], [n.radius, c.radius], c="black", lw=0.5)
            draw(c)
        if n.children:
            angles = [c.angle for c in n.children]
            arc = np.linspace(min(angles), max(angles), 24)
            ax.plot(arc, [n.radius] * len(arc), c="black", lw=0.5)

    draw(root)
    seen = set()
    for leaf in leaves:
        sg = d_sg.get(leaf.name)
        color = d_colors.get(sg, "#888888")
        label = sg if sg not in seen else None
        seen.add(sg)
        ax.plot([leaf.angle], [leaf.radius], "o", ms=2.5, color=color, label=label)
    ax.legend(loc="upper right", fontsize=9)
    fig.savefig(outfig, bbox_inches="tight")
    plt.close(fig)
