"""PyTorch port: the run-length kernel of ops/count (csrc/runs.cu, through
``run_scan`` and ``run_compact``) against its plain version, bit for bit.

The tests marked ``cuda`` skip without a card; the plain version is held to
the JAX package's counting by tests/test_torch_count.py. Tolerance: exact
(integer keys, counts and survivor counts).
"""

import pytest
import torch

from subphaser_torch.ops import count
from subphaser_torch.ops.kmer import SENTINEL
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TILE = 4096  # keys a block of csrc/runs.cu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _keys(n: int, sentinel_run: int, seed: int, device) -> torch.Tensor:
    """Sorted keys: runs of a few from n/3 values, runs of ~1,000 (across
    tiles) from n/4096 values, then a SENTINEL run."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    short = torch.randint(0, max(n // 3, 1), (n - n // 4,), generator=gen, device=device,
                          dtype=torch.int32)
    long = torch.randint(0, max(n // 4096, 1), (n // 4,), generator=gen, device=device,
                         dtype=torch.int32) * 4099
    keys = torch.sort(torch.cat([short, long])).values
    if sentinel_run:
        keys[n - sentinel_run:] = SENTINEL
    return keys


def _weights(n: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    return torch.randint(0, 4, (n,), generator=gen, device=device, dtype=torch.int32)


def _plain(keys, weights, lower, cap):
    kept_k, kept_t = count.run_scan_plain(keys, weights, lower)
    return (count._pad_to(kept_k, cap, SENTINEL), count._pad_to(kept_t, cap, 0)), kept_k.numel()


def _check(keys, weights, lower):
    """Kernel against plain at caps n, the survivor count, half of it and
    2^10 (cut), with the launches counted."""
    before = dict(count.entry_launches)
    runs = count.run_scan(keys, weights, lower)
    m = int(runs.m)
    n = keys.numel()
    for cap in sorted({n, min(m, n), max(m // 2, 1), min(1 << 10, n)}):
        got = count.run_compact(runs, cap)
        torch.cuda.synchronize()
        ref, m_ref = _plain(keys, weights, lower, cap)
        assert m == m_ref
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), cap
    assert count.entry_launches["rn_count"] == before["rn_count"] + 1
    assert count.entry_launches["rn_write"] > before["rn_write"]


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [1, 3])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n", [1 << 10, 1 << 24, (1 << 24) + 3])
def test_cuda_runs_match_plain(n, weighted, lower):
    _card()
    keys = _keys(n, n // 100, n + lower, "cuda")
    _check(keys, _weights(n, n, "cuda") if weighted else None, lower)


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_cuda_runs_at_2_to_27_with_a_long_sentinel_run(weighted):
    _card()
    n = 1 << 27
    keys = _keys(n, 5_000_000, 27, "cuda")
    _check(keys, _weights(n, 27, "cuda") if weighted else None, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, TILE - 1, TILE, TILE + 1, 3 * TILE + 5])
def test_cuda_runs_edge_shapes(n):
    """Tiny arrays, sizes around a tile, one run over the whole array, and
    all SENTINEL."""
    _card()
    for keys in (_keys(n, 0, n, "cuda"), torch.full((n,), 7, dtype=torch.int32, device="cuda"),
                 torch.full((n,), SENTINEL, dtype=torch.int32, device="cuda")):
        for weights in (None, _weights(n, n, "cuda")):
            _check(keys, weights, 1)
            _check(keys, weights, n + 1)  # above every total


@pytest.mark.cuda
def test_cuda_runs_take_unaligned_views():
    _card()
    keys = _keys(3 * TILE, 10, 5, "cuda")
    view = keys[1:]
    assert view.data_ptr() % 16
    _check(view, None, 1)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_runs_wrapper_refuses_bad_inputs(device):
    if device == "cuda":
        _card()
    keys = torch.arange(64, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        count.run_scan(keys[::2], None, 1)
    with pytest.raises(ValueError, match="int32"):
        count.run_scan(keys.to(torch.int16), None, 1)
    with pytest.raises(ValueError, match="weights"):
        count.run_scan(keys, keys.long(), 1)
    with pytest.raises(ValueError, match="weights"):
        count.run_scan(keys, torch.ones(32, dtype=torch.int32, device=device), 1)


def test_runs_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="device"):
        count.run_scan(torch.zeros(8, dtype=torch.int32, device="meta"), None, 1)


def test_cpu_runs_do_not_launch():
    before = dict(count.entry_launches)
    keys = _keys(3 * TILE, 10, 5, "cpu")
    runs = count.run_scan(keys, None, 1)
    count.run_compact(runs, keys.numel())
    assert count.entry_launches == before
