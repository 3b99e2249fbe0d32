"""The fused multi-device phasing step over a 2-D mesh.

Counterpart of the JAX package's parallel/phase_step.py, one step over a
``(data, kmer)`` mesh:

  tiles (sharded "data") -> canonical k-mer codes -> per-tile sort/RLE ->
  candidate counts by chromosome (the candidate table sharded "kmer";
  :func:`candidate_counts`, a CUDA kernel) -> sum over "data" ->
  differential fold / window gates (shard-local on "kmer", float32) ->
  feature-sharded k-means (distances summed over "kmer") ->
  canonical subgenome labels

This is the reference's process pools and file merges (reference
Jellyfish.py:671-704, 439-460; Cluster.py:17-143) in one process. Where the
JAX step runs XLA collectives, this one copies and sums between the mesh's
devices: the psum over "data" is each shard's partial moved to the kmer
shard's first device and added there. Given the candidate table (from a
discovery pass), the step's shapes are fixed.

Randomness comes from an explicit ``torch.Generator`` (on the host); it
cannot give ``jax.random``'s draws, so the step is held to the same
canonical labels, not to the same streams. Float32 products run with TF32
off, as everywhere in the port.

:func:`candidate_counts` runs ``cc_bounds_kernel`` and ``cc_count_kernel``
of csrc/parallel.cu on CUDA tensors (two kernels, one C entry) and raises
:class:`~subphaser_torch.kernels.KernelError` if it cannot; CPU tensors take
:func:`candidate_counts_plain`. ``launches["candidate_counts"]`` counts the
wrapper calls that launched them.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from subphaser_torch.ops.count import sort_rle
from subphaser_torch.ops.kmeans import canonical_labels
from subphaser_torch.ops.kmer import SENTINEL, kmer_codes
from subphaser_torch.parallel.sharded_count import launch, parallel_lib

launches = {"candidate_counts": 0}
_launch_lock = threading.Lock()


# ---------------------------------------------------------------------------
# the per-shard counts: the kernel and its plain version
# ---------------------------------------------------------------------------
def candidate_counts_plain(ucodes, ucounts, tile_chrom, cand, n_chrom: int):
    """The plain version of :func:`candidate_counts`: searchsorted, gather
    and ``index_add_`` (the JAX step's searchsorted and one-hot integer
    product)."""
    t, n = ucodes.shape
    idx = torch.searchsorted(ucodes, cand.expand(t, -1).contiguous())
    idx_c = idx.clamp_max(n - 1)
    hit = (idx < n) & (torch.gather(ucodes, 1, idx_c) == cand) & (cand != SENTINEL)
    vals = torch.where(hit, torch.gather(ucounts, 1, idx_c), 0).to(torch.int32)
    out = torch.zeros((cand.numel(), n_chrom), dtype=torch.int32, device=cand.device)
    real = tile_chrom >= 0
    out.index_add_(1, tile_chrom[real].long(), vals[real].T.contiguous())
    return out


def candidate_counts(ucodes, ucounts, tile_chrom, cand, n_chrom: int):
    """(T, N) tiles' sorted unique spectra (int32 codes, SENTINEL padded;
    int32 counts), each tile's chromosome ((T,) int32; -1 for a padding
    tile), candidates ((B,) int32, SENTINEL for none) -> (B, n_chrom) int32:
    each candidate's count summed over the tiles of each chromosome. A CUDA
    tensor launches the two kernels of ``pl_candidate_counts`` (the tiles'
    segments of each candidate block, then the counts); a CPU tensor takes
    :func:`candidate_counts_plain`."""
    if any(x.dtype != torch.int32 for x in (ucodes, ucounts, tile_chrom, cand)):
        raise ValueError("candidate_counts: every input must be int32")
    if ucodes.dim() != 2 or ucodes.shape != ucounts.shape or ucodes.shape[1] < 1 \
            or tile_chrom.shape != (ucodes.shape[0],) or cand.dim() != 1:
        raise ValueError(f"candidate_counts: shapes {tuple(ucodes.shape)}, "
                         f"{tuple(ucounts.shape)}, {tuple(tile_chrom.shape)}, "
                         f"{tuple(cand.shape)}")
    if len({x.device for x in (ucodes, ucounts, tile_chrom, cand)}) != 1:
        raise ValueError("candidate_counts: inputs on several devices")
    if n_chrom < 1:
        raise ValueError(f"candidate_counts: n_chrom={n_chrom}")
    dev = cand.device
    if dev.type == "cpu":
        return candidate_counts_plain(ucodes, ucounts, tile_chrom, cand, n_chrom)
    if dev.type != "cuda":
        raise ValueError(f"candidate_counts: unsupported device {dev}")
    if cand.numel() == 0 or ucodes.shape[0] == 0:
        return torch.zeros((cand.numel(), n_chrom), dtype=torch.int32, device=dev)
    out = torch.empty((cand.numel(), n_chrom), dtype=torch.int32, device=dev)  # zeroed there
    scratch = torch.empty(parallel_lib().pl_candidate_counts_scratch(cand.numel(),
                                                                     ucodes.shape[0]),
                          dtype=torch.int64, device=dev)
    launch("pl_candidate_counts", ucodes.contiguous(), ucounts.contiguous(),
           ucodes.shape[1], tile_chrom.contiguous(), ucodes.shape[0], cand.contiguous(),
           cand.numel(), n_chrom, scratch, out)
    with _launch_lock:
        launches["candidate_counts"] += 1
    return out


def tile_spectra(words, vwords, k: int, n_pos_words: int):
    """(T, W) tiles -> (T, N) sorted unique codes and counts, one sort_rle
    (the radix sort kernel) a tile."""
    parts = [sort_rle(kmer_codes(w, v, k, n_pos_words).reshape(-1))
             for w, v in zip(words, vwords)]
    return torch.stack([u for u, _c in parts]), torch.stack([c for _u, c in parts])


# ---------------------------------------------------------------------------
# feature-sharded k-means (features = k-mers, on the "kmer" axis)
# ---------------------------------------------------------------------------
def _sh_dist2(xs, centers, dev0):
    """Squared distances (..., n, K) with the features cut over shards:
    each shard's partial x2 + c2 - 2 x c^T, summed on ``dev0``."""
    total = None
    for x, c in zip(xs, centers):
        part = (x * x).sum(-1, keepdim=True) + (c * c).sum(-1).unsqueeze(-2) \
            - 2.0 * (x @ c.transpose(-1, -2))
        total = part.to(dev0) if total is None else total + part.to(dev0)
    return total


def _sh_kmeanspp(xs, gen, n_clusters: int, n_init: int, dev0):
    """kmeans++ seeds for ``n_init`` restarts at once -> per shard
    (n_init, K, F_j) centers."""
    n = xs[0].shape[0]
    first = torch.randint(0, n, (n_init,), generator=gen)
    centers = [torch.zeros(n_init, n_clusters, x.shape[1], dtype=x.dtype, device=x.device)
               for x in xs]
    for x, c in zip(xs, centers):
        c[:, 0] = x[first.to(x.device)]
    filled_all = torch.arange(n_clusters, device=dev0)
    for k in range(1, n_clusters):
        d2 = torch.where(filled_all < k, _sh_dist2(xs, centers, dev0), torch.inf).amin(-1)
        d2 = d2.clamp_min(0.0)
        tot = d2.sum(-1, keepdim=True)
        probs = torch.where(tot > 0, d2 / tot.clamp_min(1e-30), 1.0 / n)
        cdf = probs.cumsum(-1)  # inverse-CDF draw: zero-probability rows are never picked
        u = torch.rand(n_init, 1, generator=gen).to(dev0, cdf.dtype)
        idx = torch.searchsorted(cdf, u * cdf[..., -1:], right=True).clamp_max(n - 1)
        idx = idx.squeeze(-1)
        for x, c in zip(xs, centers):
            c[:, k] = x[idx.to(x.device)]
    return centers


def _sh_lloyd(xs, centers, n_iter: int, dev0):
    k = centers[0].shape[-2]
    for _ in range(n_iter):
        labels = _sh_dist2(xs, centers, dev0).argmin(-1)
        onehot = F.one_hot(labels, k).to(xs[0].dtype)   # (n_init, n, K)
        counts = onehot.sum(-2)                         # replicated
        new_centers = []
        for x, c in zip(xs, centers):                   # feature-sharded, no exchange
            oh, cnt = onehot.to(x.device), counts.to(x.device)
            new = (oh.transpose(-1, -2) @ x) / cnt.clamp_min(1.0)[..., None]
            new_centers.append(torch.where(cnt[..., None] > 0, new, c))
        centers = new_centers
    d2 = _sh_dist2(xs, centers, dev0)
    return d2.argmin(-1), d2.amin(-1).sum(-1)


def _sh_kmeans(xs, gen, n_clusters: int, dev0, n_init: int = 10, n_iter: int = 50):
    """Labels (n,) of the restart with the least inertia (first on ties)."""
    labels, inertia = _sh_lloyd(xs, _sh_kmeanspp(xs, gen, n_clusters, n_init, dev0),
                                n_iter, dev0)
    return labels[inertia.argmin()]


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
@dataclass
class Sharded:
    """A host array cut along its first axis over one mesh axis:
    ``parts[i]`` is shard i, on the first device of the mesh along that
    axis at index i."""

    parts: list

    def numpy(self) -> np.ndarray:
        return torch.cat([p.cpu() for p in self.parts]).numpy()


def _gates(counts_i, cand, lengths, member, set_groups, set_ncols, set_valid, *,
           min_freq, max_freq, min_fold, ratio, baseline):
    """The differential fold and window gates on one kmer shard, float32
    (the JAX step's expressions)."""
    tot = counts_i.sum(1, dtype=torch.int32)
    in_window = (tot >= min_freq) & (tot <= max_freq)
    counts = counts_i.to(torch.float32)
    gcount = counts @ member.T                         # (B_local, G)
    glen = member @ lengths
    gfreq = gcount / glen * 1e6
    pad = set_groups < 0
    gathered = torch.where(pad[None], -torch.inf, gfreq[:, set_groups.clamp_min(0).long()])
    desc = -torch.sort(-gathered, dim=-1).values
    top = desc[..., 0]
    if baseline < 0:
        bidx = set_ncols + baseline
    else:
        bidx = torch.full_like(set_ncols, baseline)
    bidx = bidx.clamp(0, set_groups.shape[1] - 1).long()
    base = desc.gather(-1, bidx[None, :, None].expand(desc.shape[0], -1, 1))[..., 0]
    include = (top / (base + 1e-20)) >= min_fold
    n_valid = set_valid.sum()
    votes = (include & set_valid[None, :]).sum(1)
    fold_ok = (votes.to(torch.float32) / n_valid.to(torch.float32)) >= ratio
    return fold_ok & in_window & (cand != SENTINEL), counts


def build_phase_step(mesh, *, k: int, n_pos_words: int, n_clusters: int, min_freq: float,
                     max_freq: float, min_fold: float, ratio: float = 1.0, baseline: int = 1):
    """Returns step(words, vwords, chrom_onehot, cand_codes, lengths, member,
    set_groups, set_ncols, set_valid, order, gen) -> (labels (C,), counts
    (B, C) int32, diff (B,) bool), all on the mesh's first device; the first
    four arguments are :class:`Sharded` (see :func:`shard_inputs`), ``gen``
    a host ``torch.Generator``."""
    grid = mesh.devices
    nd, nk = mesh.shape["data"], mesh.shape["kmer"]
    dev0 = grid[0, 0]

    def step(words, vwords, chrom_onehot, cand, lengths, member, set_groups, set_ncols,
             set_valid, order, gen):
        torch.backends.cuda.matmul.allow_tf32 = False
        n_chrom = lengths.numel()
        partials = [[None] * nk for _ in range(nd)]
        for d in range(nd):
            ucodes, ucounts = tile_spectra(words.parts[d], vwords.parts[d], k, n_pos_words)
            oh = chrom_onehot.parts[d]
            tile_chrom = torch.where(oh.sum(1) > 0, oh.argmax(1), -1).to(torch.int32)
            for j in range(nk):
                dev = grid[d, j]
                partials[d][j] = candidate_counts(
                    ucodes.to(dev), ucounts.to(dev), tile_chrom.to(dev),
                    cand.parts[j].to(dev), n_chrom)
        xs, counts_out, diff_out = [], [], []
        for j in range(nk):
            dev = grid[0, j]
            counts_i = partials[0][j].to(dev)
            for d in range(1, nd):  # the psum over "data"
                counts_i = counts_i + partials[d][j].to(dev)
            cand_j = cand.parts[j].to(dev)
            lengths_j = lengths.to(dev)
            diff, counts = _gates(
                counts_i, cand_j, lengths_j, member.to(dev), set_groups.to(dev),
                set_ncols.to(dev), set_valid.to(dev), min_freq=min_freq,
                max_freq=max_freq, min_fold=min_fold, ratio=ratio, baseline=baseline)
            data = (counts / lengths_j[None, :]).T      # (C, B_local)
            mean = data.mean(0, keepdim=True)
            std = data.std(0, correction=0, keepdim=True)
            z = (data - mean) / torch.where(std > 0, std, 1.0)
            xs.append(torch.where(diff[None, :], z, 0.0))  # masked = dropped columns
            counts_out.append(counts_i.to(dev0))
            diff_out.append(diff.to(dev0))
        labels = _sh_kmeans(xs, gen, n_clusters, dev0)
        labels = canonical_labels(labels, order.to(dev0), n_clusters)
        return labels, torch.cat(counts_out), torch.cat(diff_out)

    return step


def shard_inputs(mesh, words, vwords, chrom_onehot, cand_codes, *replicated):
    """Place host arrays for the step: words, vwords and the (T, C) one-hot
    chromosome of each tile cut over "data" (padded with empty tiles to a
    multiple of it), the candidate codes over "kmer" (SENTINEL padded);
    every other array whole on the mesh's first device."""
    nd, nk = mesh.shape["data"], mesh.shape["kmer"]
    dev0 = mesh.devices[0, 0]

    def pad_axis0(a, m, fill=0):
        a = np.asarray(a)
        r = (-a.shape[0]) % m
        if r:
            a = np.concatenate([a, np.full((r,) + a.shape[1:], fill, dtype=a.dtype)])
        return a

    def cut(a, axis):
        devs = mesh.axis_devices(axis)
        per = a.shape[0] // len(devs)
        return Sharded([torch.from_numpy(np.ascontiguousarray(a[i * per:(i + 1) * per])).to(dv)
                        for i, dv in enumerate(devs)])

    onehot = np.asarray(chrom_onehot)
    if not (np.isin(onehot, (0, 1)).all() and (onehot.sum(1) <= 1).all()):
        raise ValueError("shard_inputs: chrom_onehot must hold one 1 at most a tile")
    outs = [cut(pad_axis0(words, nd), "data"), cut(pad_axis0(vwords, nd), "data"),
            cut(pad_axis0(onehot, nd), "data"),
            cut(pad_axis0(np.asarray(cand_codes, np.int32), nk, fill=SENTINEL), "kmer")]
    outs += [torch.as_tensor(np.asarray(r)).to(dev0) for r in replicated]
    return outs
