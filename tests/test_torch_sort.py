"""PyTorch port: the sorts of ops/sort_smem (radix and bitonic) against numpy
and the JAX package's Pallas VMEM sort.

On the CPU ``sort_int32_pow2`` runs the plain versions: the bitonic network
up to 2^13 keys, the radix schedule above. The bitonic block / global /
descent schedule is checked here with small ``blk_bits`` so every stage
kind runs, the radix schedule over digit widths and tile sizes. The CUDA
kernels themselves are checked against the plain versions by the tests
marked ``cuda`` (skip without a card) and by chip_smoke.py.
Tolerance: exact (integer sort).
"""

import numpy as np
import pytest
import torch

from subphaser_torch.ops import sort_smem
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("bits", [1, 2, 3, 5, 8, 11, 16])
@pytest.mark.parametrize("blk_bits", [1, 3, 5, 13])
def test_plain_network_matches_np_sort(bits, blk_bits):
    rng = np.random.default_rng(bits * 31 + blk_bits)
    n = 1 << bits
    x = rng.integers(-(1 << 31), (1 << 31) - 1, size=n, dtype=np.int64).astype(np.int32)
    x[rng.random(n) < 0.3] = 7  # duplicates
    got = sort_smem.bitonic_sort_plain(torch.from_numpy(x), blk_bits=blk_bits).numpy()
    assert np.array_equal(got, np.sort(x))


def test_plain_network_matches_vmem_sort_with_sentinel_padding():
    """Same keys through the JAX package's Pallas sort (interpret mode, as
    tests/test_sort_vmem.py runs it) and the port's CPU path."""
    import jax
    from jax.experimental.pallas import tpu as pltpu

    from subphaser_tpu.ops import sort_vmem

    rng = np.random.default_rng(3)
    n = 1 << 18
    x = rng.integers(0, 1 << 12, size=n, dtype=np.int32)
    x[n // 2:] = sort_smem.SENTINEL
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(sort_vmem.vmem_sort(jax.numpy.asarray(x)))
    got = sort_smem.sort_int32_pow2(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, ref)
    assert got[-1] == sort_smem.SENTINEL


@pytest.mark.parametrize("n", [0, 1, 3, 100, (1 << 10) + 1])
def test_non_pow2_sizes_raise(n):
    with pytest.raises(ValueError):
        sort_smem.sort_int32_pow2(torch.zeros(n, dtype=torch.int32))


def test_wrong_dtype_raises():
    with pytest.raises(ValueError):
        sort_smem.sort_int32_pow2(torch.zeros(8, dtype=torch.int64))


@pytest.mark.parametrize("n", [0, 1, 5, 1000, 4096])
def test_sort_int32_any_size(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 50, size=n, dtype=np.int32)
    got = sort_smem.sort_int32(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.sort(x))


def test_cpu_path_does_not_launch():
    before = sort_smem.launches
    sort_smem.sort_int32_pow2(torch.arange(16, dtype=torch.int32).flip(0))
    assert sort_smem.launches == before


def _full_range(rng, n):
    x = rng.integers(-(1 << 31), 1 << 31, size=n, dtype=np.int64).astype(np.int32)
    x[rng.random(n) < 0.3] = 7  # duplicates
    return x


@pytest.mark.parametrize("bits", [1, 3, 8, 14, 16])
@pytest.mark.parametrize("tile_bits", [2, 5, 13])
@pytest.mark.parametrize("digit_bits", [1, 2, 4, 8])
def test_radix_plain_matches_np_sort(digit_bits, tile_bits, bits):
    rng = np.random.default_rng(bits * 1000 + tile_bits * 10 + digit_bits)
    x = _full_range(rng, 1 << bits)
    got = sort_smem.radix_sort_plain(torch.from_numpy(x), digit_bits=digit_bits,
                                     tile_bits=tile_bits).numpy()
    assert np.array_equal(got, np.sort(x))


def _skewed(kind, n, rng):
    """Inputs that the radix passes meet on the mapping path (nearly all
    SENTINEL) or that show an unstable pass."""
    if kind == "all_sentinel":
        return np.full(n, sort_smem.SENTINEL, dtype=np.int32)
    if kind == "mostly_sentinel":
        x = np.full(n, sort_smem.SENTINEL, dtype=np.int32)
        hit = rng.random(n) < 0.001
        x[hit] = rng.integers(0, 1 << 30, size=int(hit.sum()), dtype=np.int32)
        return x
    x = np.sort(_full_range(rng, n))
    if kind == "reversed":
        return x[::-1].copy()
    if kind == "int32_min":
        x = rng.permutation(x)
        x[:: 97] = np.iinfo(np.int32).min
        return x
    assert kind == "sorted"
    return x


@pytest.mark.parametrize("kind", ["all_sentinel", "mostly_sentinel", "sorted", "reversed",
                                  "int32_min"])
@pytest.mark.parametrize("digit_bits", [4, 8])
def test_radix_plain_on_skewed_inputs(kind, digit_bits):
    rng = np.random.default_rng(11)
    x = _skewed(kind, 1 << 15, rng)
    got = sort_smem.radix_sort_plain(torch.from_numpy(x), digit_bits=digit_bits).numpy()
    assert np.array_equal(got, np.sort(x))


@pytest.mark.parametrize("kind", ["all_sentinel", "mostly_sentinel", "sorted", "reversed",
                                  "int32_min"])
def test_cpu_route_on_skewed_inputs(kind):
    """``sort_int32_pow2`` on the CPU takes the radix schedule above 2^13."""
    rng = np.random.default_rng(12)
    x = _skewed(kind, 1 << 14, rng)
    got = sort_smem.sort_int32_pow2(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.sort(x))


def test_cpu_route_by_size(monkeypatch):
    """Up to 2^BLK_BITS keys the block network, above it the radix schedule."""
    calls = []
    for name in ("bitonic_sort_plain", "radix_sort_plain"):
        real = getattr(sort_smem, name)
        monkeypatch.setattr(sort_smem, name,
                            lambda x, _r=real, _n=name, **kw: (calls.append(_n), _r(x, **kw))[1])
    rng = np.random.default_rng(5)
    for bits in (sort_smem.BLK_BITS, sort_smem.BLK_BITS + 1):
        x = _full_range(rng, 1 << bits)
        assert np.array_equal(sort_smem.sort_int32_pow2(torch.from_numpy(x)).numpy(), np.sort(x))
    assert calls == ["bitonic_sort_plain", "radix_sort_plain"]


@pytest.mark.parametrize("bits", [1, 6, 13, 15])
def test_bitonic_entry_matches_np_sort_on_cpu(bits):
    rng = np.random.default_rng(bits)
    x = _full_range(rng, 1 << bits)
    before = sort_smem.bitonic_launches
    got = sort_smem.bitonic_sort_int32_pow2(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.sort(x))
    assert sort_smem.bitonic_launches == before


@pytest.mark.parametrize("digit_bits,tile_bits", [(0, 13), (17, 13), (8, 0)])
def test_radix_plain_refuses_bad_parameters(digit_bits, tile_bits):
    with pytest.raises(ValueError):
        sort_smem.radix_sort_plain(torch.zeros(8, dtype=torch.int32), digit_bits=digit_bits,
                                   tile_bits=tile_bits)


def _cuda_input(kind, n):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(n % 1000 + len(kind))
    if kind == "uniform":  # many duplicates: keys drawn from n/8 values
        return torch.randint(0, max(n // 8, 2), (n,), generator=gen, device="cuda",
                             dtype=torch.int32)
    x = torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen, device="cuda",
                      dtype=torch.int64).to(torch.int32)
    if kind == "skewed":  # 99.9% SENTINEL, as on the mapping path
        miss = torch.rand(n, generator=gen, device="cuda") >= 0.001
        x[miss] = sort_smem.SENTINEL
    else:
        assert kind == "full_range"
        x[::1001] = -(1 << 31)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "skewed", "full_range"])
@pytest.mark.parametrize("bits", [14, 18, 20, 23])
def test_cuda_radix_kernel_matches_plain(bits, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = _cuda_input(kind, 1 << bits)
    keep = x.clone()
    before = sort_smem.launches
    got = sort_smem.sort_int32_pow2(x)
    torch.cuda.synchronize()
    assert sort_smem.launches == before + 1
    assert torch.equal(x, keep)  # the input is read only
    assert torch.equal(got, torch.sort(x).values)
    assert torch.equal(got, sort_smem.radix_sort_plain(x))
    assert torch.equal(got, sort_smem.bitonic_sort_plain(x))


@pytest.mark.cuda
def test_cuda_radix_kernel_takes_unaligned_views():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = _cuda_input("full_range", (1 << 15) + 1)
    for view in (x[1:], x[:-1][::2].repeat_interleave(2)):
        assert torch.equal(sort_smem.sort_int32_pow2(view), torch.sort(view).values)


@pytest.mark.cuda
def test_cuda_radix_kernel_at_2_to_31_keys():
    """The largest size: offsets are unsigned 32-bit. Checked in slices (no
    library sort of 8 GiB beside it): ascending, same sum, same sum of squares."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, step = 1 << 31, 1 << 27
    x = torch.empty(n, dtype=torch.int32, device="cuda")
    for i in range(0, n, step):
        x[i:i + step] = _cuda_input("full_range", step)
        x[i:i + step] ^= i >> 27  # slices differ
    got = sort_smem.sort_int32_pow2(x)
    torch.cuda.synchronize()

    def sums(v):
        parts = [v[i:i + step].long() for i in range(0, n, step)]
        return sum(int(p.sum()) for p in parts), sum(int((p * p % 1000003).sum()) for p in parts)

    assert sums(got) == sums(x)
    for i in range(0, n, step):
        part = got[i:min(i + step + 1, n)]
        assert bool((part[1:] >= part[:-1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 13, 14, 20])
def test_cuda_bitonic_entry_matches_plain(bits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = _cuda_input("full_range", 1 << bits)
    before, before_main = sort_smem.bitonic_launches, sort_smem.launches
    got = sort_smem.bitonic_sort_int32_pow2(x)
    torch.cuda.synchronize()
    assert sort_smem.bitonic_launches == before + 1
    assert sort_smem.launches == before_main
    assert torch.equal(got, sort_smem.bitonic_sort_plain(x))
    assert torch.equal(got, torch.sort(x).values)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 4, 10, 13, 14, 18, 20])
def test_cuda_kernel_matches_plain(bits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(bits)
    n = 1 << bits
    x = torch.randint(0, max(n // 8, 2), (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    before = sort_smem.launches
    got = sort_smem.sort_int32_pow2(x)
    torch.cuda.synchronize()
    assert sort_smem.launches == before + 1
    assert torch.equal(got, sort_smem.bitonic_sort_plain(x))
    assert torch.equal(got, torch.sort(x).values)
