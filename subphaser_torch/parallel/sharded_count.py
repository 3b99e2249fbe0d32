"""Sharded k-mer spectrum discovery: tiles data-parallel, the code space
exchanged between the shards.

Counterpart of the JAX package's parallel/sharded_count.py. The reference
merges per-process counts through the filesystem (dump files read into one
dict, reference Jellyfish.py:446-458). Over a mesh's "data" axis of D shards:

1. every shard sorts and run-length encodes the canonical codes of its tiles
   (``sort_rle``: the radix sort kernel, K1+K2's counterpart);
2. the code space [0, 4^k) is cut into D equal ranges, shard d owning range
   d; each shard cuts its sorted spectrum at the range bounds into D send
   slots of ``quota`` entries (:func:`range_slots`, a CUDA kernel);
3. the exchange: slot d of shard s is copied to shard d (the JAX
   ``all_to_all``; a same-device copy where shards share a device);
4. each shard merges the runs it received (sort + segmented sum) into its
   disjoint piece of the spectrum.

Quotas are fixed (``local // D * slack + 16``); a run longer than its quota
sets the overflow flag, read back once an attempt, and the exchange retries
with twice the slack, up to slack D, where a quota holds a whole local
spectrum.

:func:`range_slots` runs ``range_slots_kernel`` of csrc/parallel.cu on a
CUDA tensor and raises :class:`~subphaser_torch.kernels.KernelError` if it
cannot; a CPU tensor takes :func:`range_slots_plain`.
``launches["range_slots"]`` counts the wrapper calls that launched it.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from subphaser_torch.kernels import KernelError
from subphaser_torch.ops.count import _compact_survivors, _merge_sorted_runs, sort_rle
from subphaser_torch.ops.kmer import SENTINEL, kmer_codes

launches = {"range_slots": 0}
_launch_lock = threading.Lock()
_lib = None


def parallel_lib():
    """csrc/parallel.cu, built at first use (range_slots and
    candidate_counts)."""
    global _lib
    with _launch_lock:
        if _lib is None:
            import ctypes

            from subphaser_torch import kernels

            lib = kernels.load("parallel")
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.pl_range_slots.argtypes = [ptr, ptr, i64, i32, i64, i32, ptr, ptr, ptr, ptr]
            lib.pl_range_slots.restype = i32
            lib.pl_candidate_counts.argtypes = [ptr, ptr, i64, ptr, i32, ptr, i64, i32, ptr,
                                                ptr, ptr]
            lib.pl_candidate_counts.restype = i32
            lib.pl_candidate_counts_scratch.argtypes = [i64, i32]
            lib.pl_candidate_counts_scratch.restype = i64
            lib.pl_error_string.argtypes = [i32]
            lib.pl_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(entry: str, *args) -> None:
    """Call the C entry ``entry`` of csrc/parallel.cu on the current stream
    of the first tensor's device (tensors passed as pointers); raises
    KernelError if the launch failed."""
    lib = parallel_lib()
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(*cargs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise KernelError(f"{entry} launch failed: " + lib.pl_error_string(err).decode())


def range_bounds(k: int, n_dev: int) -> list[int]:
    """The D - 1 cuts of the code space [0, 4^k) (Python ints, as in the
    JAX package)."""
    return [(i * (1 << (2 * k))) // n_dev for i in range(1, n_dev)]


def range_slots_plain(ucodes: torch.Tensor, ucounts: torch.Tensor, *, k: int, n_dev: int,
                      quota: int):
    """The plain version of :func:`range_slots`: the JAX program in torch
    (searchsorted cuts, a masked gather)."""
    n = ucodes.numel()
    dev = ucodes.device
    bounds = torch.tensor(range_bounds(k, n_dev), dtype=torch.int32, device=dev)
    cut = torch.searchsorted(ucodes, bounds)
    starts = torch.cat([torch.zeros(1, dtype=cut.dtype, device=dev), cut])
    space_end = torch.tensor([(1 << (2 * k)) - 1], dtype=torch.int32, device=dev)
    n_real = torch.searchsorted(ucodes, space_end, right=True)
    sizes = torch.cat([cut, n_real]) - starts
    overflow = (sizes > quota).any().to(torch.int32).reshape(1)
    slot = torch.arange(quota, device=dev)[None, :]
    src = (starts[:, None] + slot).clamp_max(n - 1)
    valid = slot < sizes[:, None]
    send_codes = torch.where(valid, ucodes[src], SENTINEL)
    send_counts = torch.where(valid, ucounts[src], 0)
    return send_codes, send_counts, overflow


def range_slots(ucodes: torch.Tensor, ucounts: torch.Tensor, *, k: int, n_dev: int,
                quota: int):
    """One shard's sorted unique spectrum (int32 codes ascending, SENTINEL
    padded; int32 counts) -> ((n_dev, quota) send codes, SENTINEL padded,
    (n_dev, quota) send counts, 0 padded, (1,) int32 overflow flag): slot d
    holds the run of codes in [d 4^k / n_dev, (d + 1) 4^k / n_dev), cut at
    ``quota``; the flag is 1 where a run is longer. A CUDA tensor launches
    ``range_slots_kernel`` (one launch); a CPU tensor takes
    :func:`range_slots_plain`."""
    if ucodes.dtype != torch.int32 or ucounts.dtype != torch.int32:
        raise ValueError("range_slots: codes and counts must be int32")
    if ucodes.dim() != 1 or ucodes.shape != ucounts.shape or ucodes.numel() < 1:
        raise ValueError(f"range_slots: shapes {tuple(ucodes.shape)}, {tuple(ucounts.shape)}")
    if ucodes.device != ucounts.device:
        raise ValueError("range_slots: codes and counts on two devices")
    if not (1 <= k <= 15 and 1 <= n_dev <= 1024 and quota >= 1):
        raise ValueError(f"range_slots: k={k}, n_dev={n_dev}, quota={quota}")
    if ucodes.device.type == "cpu":
        return range_slots_plain(ucodes, ucounts, k=k, n_dev=n_dev, quota=quota)
    if ucodes.device.type != "cuda":
        raise ValueError(f"range_slots: unsupported device {ucodes.device}")
    dev = ucodes.device
    send_codes = torch.empty((n_dev, quota), dtype=torch.int32, device=dev)
    send_counts = torch.empty((n_dev, quota), dtype=torch.int32, device=dev)
    overflow = torch.empty(1, dtype=torch.int32, device=dev)
    launch("pl_range_slots", ucodes.contiguous(), ucounts.contiguous(), ucodes.numel(),
           n_dev, quota, k, send_codes, send_counts, overflow)
    with _launch_lock:
        launches["range_slots"] += 1
    return send_codes, send_counts, overflow


def _local_spectrum(words: torch.Tensor, vwords: torch.Tensor, k: int, n_pos_words: int):
    """One shard's (T_local, W) tiles -> its sorted unique (codes, counts)."""
    codes = torch.cat([kmer_codes(w, v, k, n_pos_words).reshape(-1)
                       for w, v in zip(words, vwords)])
    return sort_rle(codes)


def _exchange_and_merge(sends: list, devices: list, quota: int):
    """The all_to_all (slot d of every shard to shard d) and each owner's
    merge of the runs it received -> per shard (codes, counts), SENTINEL / 0
    padded to n_dev * quota."""
    out = []
    for d, dev in enumerate(devices):
        recv_codes = torch.cat([sc[d].to(dev) for sc, _sn in sends])
        recv_counts = torch.cat([sn[d].to(dev) for _sc, sn in sends])
        out.append(_compact_survivors(_merge_sorted_runs(recv_codes, recv_counts, 1),
                                      recv_codes.numel()))
    return out


def build_sharded_count(mesh, *, k: int, n_pos_words: int, tiles_per_dev: int,
                        slack: float = 2.0):
    """fn(words shards, vwords shards) -> (per-shard (codes, counts), overflow
    bool): the spectrum sharded over the mesh's "data" axis by code range.
    ``words[d]`` is shard d's (tiles_per_dev, W) tiles on its device."""
    devices = mesh.axis_devices("data")
    n_dev = len(devices)
    local = tiles_per_dev * 16 * n_pos_words
    quota = int(local // n_dev * slack) + 16

    def step(words, vwords):
        sends, flags = [], []
        for w, v in zip(words, vwords):
            ucodes, ucounts = _local_spectrum(w, v, k, n_pos_words)
            send_codes, send_counts, over = range_slots(ucodes, ucounts, k=k, n_dev=n_dev,
                                                        quota=quota)
            sends.append((send_codes, send_counts))
            flags.append(over.to(devices[0]))
        overflow = bool(torch.cat(flags).any())  # one read back an attempt
        return _exchange_and_merge(sends, devices, quota), overflow

    return step


def sharded_spectrum(mesh, tiles, k: int, n_pos_words: int) -> tuple[np.ndarray, np.ndarray]:
    """Count one chromosome's tiles across the mesh's "data" axis -> host
    (codes int32, counts int64), sorted.

    ``tiles``: Tile objects; the list is padded to a multiple of the shards
    with empty tiles. On a quota overflow the exchange retries with doubled
    slack."""
    devices = mesh.axis_devices("data")
    n_dev = len(devices)
    words = np.stack([t.words for t in tiles])
    vwords = np.stack([t.vwords for t in tiles])
    pad = (-len(tiles)) % n_dev
    if pad:
        words = np.concatenate([words, np.zeros((pad,) + words.shape[1:], words.dtype)])
        vwords = np.concatenate([vwords, np.zeros((pad,) + vwords.shape[1:], vwords.dtype)])
    tiles_per_dev = words.shape[0] // n_dev
    words_d = [torch.from_numpy(words[i * tiles_per_dev:(i + 1) * tiles_per_dev]).to(dev)
               for i, dev in enumerate(devices)]
    vwords_d = [torch.from_numpy(vwords[i * tiles_per_dev:(i + 1) * tiles_per_dev]).to(dev)
                for i, dev in enumerate(devices)]
    slack = 2.0
    while True:
        step = build_sharded_count(mesh, k=k, n_pos_words=n_pos_words,
                                   tiles_per_dev=tiles_per_dev, slack=slack)
        shards, overflow = step(words_d, vwords_d)
        if not overflow:
            break
        if slack >= float(n_dev):  # quota == full local spectrum: cannot overflow
            raise RuntimeError("sharded_spectrum overflow at maximum slack")
        slack = min(slack * 2.0, float(n_dev))
    codes = np.concatenate([c.cpu().numpy() for c, _n in shards])
    counts = np.concatenate([n.cpu().numpy() for _c, n in shards])
    m = codes != SENTINEL
    codes, counts = codes[m], counts[m]
    order = np.argsort(codes, kind="stable")
    return codes[order], counts[order].astype(np.int64)
