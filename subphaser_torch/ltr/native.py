"""ctypes bindings for the LTR step's native host library
(csrc/ltr_native.cpp): the detectors' refinement (X-drop, banded identity,
TSD), finder chaining, base unpacking, and the LTR trees' profile-profile
alignment and neighbor joining. The library's other entry points (blocks)
are bound when a step that needs them is ported.

The library is compiled with g++ at first use into the package's git-ignored
``_build/`` (see kernels.py, which builds it with the CUDA kernels), never
beside its source.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_lock = threading.Lock()
_lib = None


class LtrParams(ctypes.Structure):
    _fields_ = [
        ("k", ctypes.c_int),
        ("minlenltr", ctypes.c_int),
        ("maxlenltr", ctypes.c_int),
        ("mindistltr", ctypes.c_int),
        ("maxdistltr", ctypes.c_int),
        ("similar", ctypes.c_double),
        ("mintsd", ctypes.c_int),
        ("maxtsd", ctypes.c_int),
        ("vic", ctypes.c_int),
        ("xdrop", ctypes.c_int),
        ("band", ctypes.c_int),
        ("max_gap", ctypes.c_int),
    ]


class LtrOut(ctypes.Structure):
    _fields_ = [
        ("start", ctypes.c_int32),
        ("end", ctypes.c_int32),
        ("lltr_len", ctypes.c_int32),
        ("rltr_len", ctypes.c_int32),
        ("similarity", ctypes.c_double),
        ("tsd_len", ctypes.c_int32),
    ]


class FinderOut(ctypes.Structure):
    _fields_ = [
        ("start", ctypes.c_int32),
        ("end", ctypes.c_int32),
        ("lltr_len", ctypes.c_int32),
        ("rltr_len", ctypes.c_int32),
        ("similarity", ctypes.c_double),
        ("tsd_len", ctypes.c_int32),
        ("score", ctypes.c_int32),
        ("flags", ctypes.c_int32),
        ("strand", ctypes.c_int32),
    ]


class ChainOut(ctypes.Structure):
    _fields_ = [
        ("q_start", ctypes.c_int64),
        ("q_end", ctypes.c_int64),
        ("t_start", ctypes.c_int64),
        ("t_end", ctypes.c_int64),
        ("n_anchors", ctypes.c_int32),
        ("strand", ctypes.c_int32),
        ("score", ctypes.c_double),
    ]


def load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from subphaser_torch import kernels

        lib = kernels.load("ltr_native")
        lib.sp_refine_ltr.restype = ctypes.c_int
        lib.sp_refine_ltr.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.POINTER(LtrParams), ctypes.POINTER(LtrOut),
            ctypes.c_int64,
        ]
        lib.sp_finder_ltr.restype = ctypes.c_int
        lib.sp_finder_ltr.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(LtrParams), ctypes.c_int32,
            ctypes.POINTER(FinderOut), ctypes.c_int64,
        ]
        lib.sp_chain_anchors.restype = ctypes.c_int
        lib.sp_chain_anchors.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ChainOut), ctypes.c_int64,
        ]
        lib.sp_unpack_codes.restype = None
        lib.sp_unpack_codes.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.sp_nj_tree.restype = ctypes.c_int
        lib.sp_nj_tree.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.sp_profile_align.restype = ctypes.c_int
        lib.sp_profile_align.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
            ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        _lib = lib
        return lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


_LTR_FIELDS = {name for name, _t in LtrParams._fields_}


def _ltr_params(params: dict) -> LtrParams:
    """Build the C param struct, ignoring detector-level keys (e.g. the
    device seeding 'seed'/'min_score' params) the native layer doesn't take."""
    return LtrParams(**{k: v for k, v in params.items() if k in _LTR_FIELDS})


def unpack_codes(packed: np.ndarray, vmask: np.ndarray, n_bases: int
                 ) -> np.ndarray:
    """2-bit packed words -> uint8 base codes (0..3, 4 = N), one native
    pass (the numpy broadcast unpack cost ~6 s per 26 Mb chromosome)."""
    lib = load()
    packed = np.ascontiguousarray(packed, dtype=np.int32)
    vmask = np.ascontiguousarray(vmask, dtype=np.int32)
    out = np.empty(max(n_bases, 1), dtype=np.uint8)
    i32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa: E731
    lib.sp_unpack_codes(i32p(packed), i32p(vmask), packed.size, n_bases,
                        _u8ptr(out))
    return out[:n_bases]


def refine_ltr(seq_codes: np.ndarray, seed_i: np.ndarray, seed_j: np.ndarray,
               params: dict, out_cap: int = 1 << 16) -> np.ndarray:
    """seq_codes: uint8 (0..3, >=4 N). Returns structured array of candidates."""
    lib = load()
    seq = np.ascontiguousarray(seq_codes, dtype=np.uint8)
    si = np.ascontiguousarray(seed_i, dtype=np.int32)
    sj = np.ascontiguousarray(seed_j, dtype=np.int32)
    prm = _ltr_params(params)
    out = (LtrOut * out_cap)()
    n = lib.sp_refine_ltr(
        _u8ptr(seq), seq.size,
        si.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sj.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        si.size, ctypes.byref(prm), out, out_cap,
    )
    dtype = np.dtype(
        [("start", np.int32), ("end", np.int32), ("lltr_len", np.int32),
         ("rltr_len", np.int32), ("similarity", np.float64), ("tsd_len", np.int32)]
    )
    res = np.zeros(n, dtype=dtype)
    for i in range(n):
        res[i] = (out[i].start, out[i].end, out[i].lltr_len, out[i].rltr_len,
                  out[i].similarity, out[i].tsd_len)
    return res


def finder_ltr(seq_codes: np.ndarray, ls: np.ndarray, le: np.ndarray,
               rs: np.ndarray, re: np.ndarray, params: dict,
               min_score: int = 2, out_cap: int = 1 << 16) -> np.ndarray:
    """ltr_finder-style structural refinement of chained candidate spans.

    Each candidate is a colinear seed chain: left copy [ls, le), right copy
    [rs, re). Returns a structured array with the signals the reference's
    LTRFinderRecord carries (TSD/PBS/PPT/strand/score, LTR.py:715-725)."""
    lib = load()
    seq = np.ascontiguousarray(seq_codes, dtype=np.uint8)
    a_ls = np.ascontiguousarray(ls, dtype=np.int64)
    a_le = np.ascontiguousarray(le, dtype=np.int64)
    a_rs = np.ascontiguousarray(rs, dtype=np.int64)
    a_re = np.ascontiguousarray(re, dtype=np.int64)
    prm = _ltr_params(params)
    out = (FinderOut * out_cap)()
    i64p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    n = lib.sp_finder_ltr(
        _u8ptr(seq), seq.size, i64p(a_ls), i64p(a_le), i64p(a_rs), i64p(a_re),
        a_ls.size, ctypes.byref(prm), min_score, out, out_cap,
    )
    dtype = np.dtype(
        [("start", np.int32), ("end", np.int32), ("lltr_len", np.int32),
         ("rltr_len", np.int32), ("similarity", np.float64),
         ("tsd_len", np.int32), ("score", np.int32), ("flags", np.int32),
         ("strand", np.int32)]
    )
    res = np.zeros(n, dtype=dtype)
    for i in range(n):
        res[i] = (out[i].start, out[i].end, out[i].lltr_len, out[i].rltr_len,
                  out[i].similarity, out[i].tsd_len, out[i].score,
                  out[i].flags, out[i].strand)
    return res


def chain_anchors(qpos: np.ndarray, tpos: np.ndarray, alen: np.ndarray,
                  strand: int, max_gap: int = 10000, min_chain_len: int = 5000,
                  min_chain_anchors: int = 5, out_cap: int = 1 << 16) -> np.ndarray:
    lib = load()
    q = np.ascontiguousarray(qpos, dtype=np.int64)
    t = np.ascontiguousarray(tpos, dtype=np.int64)
    a = np.ascontiguousarray(alen, dtype=np.int32)
    out = (ChainOut * out_cap)()
    n = lib.sp_chain_anchors(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        q.size, strand, max_gap, min_chain_len, min_chain_anchors, out, out_cap,
    )
    dtype = np.dtype(
        [("q_start", np.int64), ("q_end", np.int64), ("t_start", np.int64),
         ("t_end", np.int64), ("n_anchors", np.int32), ("strand", np.int32),
         ("score", np.float64)]
    )
    res = np.zeros(n, dtype=dtype)
    for i in range(n):
        res[i] = (out[i].q_start, out[i].q_end, out[i].t_start, out[i].t_end,
                  out[i].n_anchors, out[i].strand, out[i].score)
    return res


def profile_align(p1: np.ndarray, sp2: np.ndarray,
                  gap_open: float = 11.0, gap_ext: float = 1.0) -> np.ndarray:
    """Global affine-gap alignment of two peptide profiles (progressive-MSA
    merge; replaces the reference's mafft call, LTR.py:144-299).

    ``p1``: (L1, 21) float32 column frequencies. ``sp2``: (L2, 21) float32 =
    profile-2 frequencies premultiplied by the substitution matrix
    (``f2 @ S.T``). Returns (n, 2) int32 (op, len) runs: 0 = aligned column
    pair, 1 = column from profile 1 only, 2 = from profile 2 only."""
    lib = load()
    p1 = np.ascontiguousarray(p1, dtype=np.float32)
    sp2 = np.ascontiguousarray(sp2, dtype=np.float32)
    l1, l2 = p1.shape[0], sp2.shape[0]
    cap = 2 * (l1 + l2) + 16
    out = np.zeros(2 * cap, dtype=np.int32)
    fptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))  # noqa: E731
    n = lib.sp_profile_align(
        fptr(p1), l1, fptr(sp2), l2,
        ctypes.c_float(gap_open), ctypes.c_float(gap_ext),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
    )
    if n < 0:
        raise RuntimeError("sp_profile_align: ops buffer too small")
    return out[: 2 * n].reshape(n, 2)


def nj_tree(dist: np.ndarray, names: list[str]) -> str:
    """Neighbor-joining tree of a (n, n) float64 distance matrix -> newick
    with ``names`` as leaf labels."""
    lib = load()
    n = len(names)
    d = np.ascontiguousarray(dist, dtype=np.float64)
    blob = b"".join(name.encode() + b"\0" for name in names)
    cap = 1 << 22
    out = ctypes.create_string_buffer(cap)
    r = lib.sp_nj_tree(
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, blob, out, cap
    )
    if r < 0:
        raise RuntimeError(f"sp_nj_tree failed: {r}")
    return out.value.decode()
