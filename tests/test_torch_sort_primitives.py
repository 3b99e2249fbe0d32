"""PyTorch port: the plain versions of the sort primitives (ops/
sort_primitives, kernels K3-K6) against the JAX package's Pallas kernels
and against a numpy statement of each function.

The Pallas kernels run on the CPU as tests/test_sort_vmem.py runs them
(``pltpu.force_tpu_interpret_mode()``), on 2 blocks of 2^18 keys: the JAX
functions take their grid from ``x.shape[0]``. The CUDA kernels themselves
are held to these plain versions by the test marked ``cuda`` (skips without
a card) and by chip_smoke.py. Tolerance: exact (int32 keys).
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from subphaser_torch.ops import sort_primitives as sp
from subphaser_torch.ops import sort_smem
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_BLOCKS = 2
R, C = 2048, 128


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "bench_sort_primitives", ROOT / "tools" / "bench_sort_primitives.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(seed: int, n_blocks: int = N_BLOCKS) -> np.ndarray:
    """The tool's inputs: values in [0, 2^30) xor a small salt."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 30, size=n_blocks * sp.BLOCK, dtype=np.int32) ^ np.int32(3)


def _np_stages(x: np.ndarray, bits, dir_bit=None) -> np.ndarray:
    """Compare-exchange stages stated with the XOR partner: element i keeps
    the smaller of (x[i], x[i ^ stride]) iff it is the lower of the pair,
    the other way round where index bit ``dir_bit`` is set."""
    y = x.copy()
    idx = np.arange(y.size)
    for sb in bits:
        partner = y[idx ^ (1 << sb)]
        take_min = ((idx >> sb) & 1) == 0
        if dir_bit is not None:
            take_min ^= ((idx >> dir_bit) & 1) == 1
        y = np.where(take_min, np.minimum(y, partner), np.maximum(y, partner))
    return y


def _np_block_sort(x: np.ndarray, blk_bits: int) -> np.ndarray:
    """Blocks of 2^blk_bits keys sorted, odd blocks descending."""
    y = np.sort(x.reshape(-1, 1 << blk_bits), axis=1)
    y[1::2] = y[1::2, ::-1]
    return y.reshape(-1)


def _run_pallas(fn, x: np.ndarray, shape) -> np.ndarray:
    import jax
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(jax.numpy.asarray(x.reshape(shape)))).reshape(-1)


NP_BITS = dict(sp.STAGE_BITS, elementwise30=[], transpose8=[])


@pytest.mark.parametrize("name", sp.BLOCK_MAP_CANDIDATES)
def test_block_map_plain_matches_pallas_and_numpy(jax_tool, name):
    x = _keys(len(name))
    shape = (N_BLOCKS, 16, 128, 128) if name == "transpose8" else (N_BLOCKS, R, C)
    ref = _run_pallas(jax_tool.CANDIDATES[name](), x, shape)
    got = sp.block_map(name, torch.from_numpy(x)).numpy()
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _np_stages(x, NP_BITS[name]))


def test_descent18_sorts_a_bitonic_block():
    x = _keys(18).reshape(N_BLOCKS, 2, -1)
    x = np.concatenate([np.sort(x[:, 0], axis=1), np.sort(x[:, 1], axis=1)[:, ::-1]], axis=1)
    got = sp.block_map("descent18", torch.from_numpy(x.reshape(-1).copy())).numpy()
    assert np.array_equal(got.reshape(N_BLOCKS, -1), np.sort(x, axis=1))


def test_elementwise_and_transpose_do_their_work():
    """Off the tool's inputs the two are no identities: int32 min wraps to
    int32 max, and an odd number of transposes would show."""
    x = _keys(5)
    x[::7] = np.iinfo(np.int32).min
    want = np.where(x == np.iinfo(np.int32).min, np.iinfo(np.int32).max, x)
    for name in ("elementwise30", "transpose8"):
        assert np.array_equal(sp.block_map_plain(name, torch.from_numpy(x)).numpy(), want)
    y = torch.from_numpy(_keys(6)).reshape(-1, 128, 128)
    assert torch.equal(sp._max_dec(y.transpose(1, 2)).transpose(1, 2), y)
    assert not torch.equal(y.transpose(1, 2), y)


def test_descent_masked_plain_matches_pallas_and_numpy(jax_tool):
    x = _keys(9)
    ref = _run_pallas(jax_tool.CANDIDATES["descent18_masked"](), x, (N_BLOCKS, R, C))
    got = sp.descent_masked(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _np_stages(x, range(8, -1, -1), dir_bit=9))


def test_descent_grid2d_plain_matches_pallas_and_numpy(jax_tool):
    x = _keys(4)
    ref = _run_pallas(jax_tool.CANDIDATES["descent18_grid2d"](), x, (N_BLOCKS, R, C))
    got = sp.descent_grid2d(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, ref)
    bits = [(i % 7) if i % 2 else (10 + i % 8) for i in range(18)] * 4
    assert np.array_equal(got, _np_stages(x, bits))


@functools.lru_cache(maxsize=None)
def _pallas_k3(n_blocks: int) -> np.ndarray:
    """K3 (`_block_sort_kernel`, which nothing in the JAX package calls)
    launched with `_sort_impl`'s block spec in interpret mode on _keys(3)."""
    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from subphaser_tpu.ops import sort_vmem as sv

    x = _keys(3, n_blocks)
    total_bits = 18 + n_blocks - 1
    spec = pl.BlockSpec((1, sv.R, sv.C), lambda b: (b, 0, 0), memory_space=pltpu.VMEM)
    blocks = jax.numpy.asarray(x.reshape(n_blocks, sv.R, sv.C))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(
            sv._block_sort_kernel(total_bits),
            out_shape=jax.ShapeDtypeStruct(blocks.shape, blocks.dtype),
            grid=(n_blocks,), in_specs=[spec], out_specs=spec,
        )(blocks)).reshape(-1)


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_block_sort_plain_matches_pallas_k3(n_blocks):
    """The plain version at blk_bits = 18 gives K3's bits: one block
    ascending, two blocks ascending then descending."""
    x = _keys(3, n_blocks)
    ref = _pallas_k3(n_blocks)
    got = sort_smem.block_sort_plain(torch.from_numpy(x), blk_bits=18).numpy()
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _np_block_sort(x, 18))


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_block_sort_unrolled_matches_pallas_k3(n_blocks):
    """K3's counterpart itself (its CPU route) on 2^18-key blocks: the same
    bits as the Pallas kernel, not the 2^13-key block sort of the card's
    tile."""
    x = torch.from_numpy(_keys(3, n_blocks))
    got = sp.block_sort_unrolled(x)
    assert np.array_equal(got.numpy(), _pallas_k3(n_blocks))
    assert not torch.equal(got, sort_smem.block_sort(x))


@pytest.mark.parametrize("blk_bits", range(1, 14))
def test_block_sort_plain_is_phase_a_of_the_sort(blk_bits):
    """At every block size up to the port's 2^13: blocks sorted, odd blocks
    descending; and the rest of the network finishes the sort from there."""
    rng = np.random.default_rng(blk_bits)
    x = rng.integers(-50, 50, size=1 << 15, dtype=np.int32)
    got = sort_smem.block_sort_plain(torch.from_numpy(x), blk_bits=blk_bits)
    assert np.array_equal(got.numpy(), _np_block_sort(x, blk_bits))
    y = got.clone()
    for p in range(blk_bits + 1, 16):
        for sb in range(p - 1, blk_bits - 1, -1):
            y = sort_smem._stage(y, sb, p)
        y = sort_smem._descent(y, p, blk_bits)
    assert torch.equal(y, sort_smem.bitonic_sort_plain(torch.from_numpy(x), blk_bits))
    assert np.array_equal(y.numpy(), np.sort(x))


@pytest.mark.parametrize("bits", [1, 5, 13, 14])
def test_block_sort_wrappers_on_cpu(bits):
    """block_sort runs phases 1..13 (the card's tile), block_sort_unrolled
    K3's phases 1..18: both sort an array of at most their block."""
    x = torch.from_numpy(np.random.default_rng(bits).integers(0, 9, 1 << bits, dtype=np.int32))
    want = sort_smem.block_sort_plain(x)
    assert torch.equal(sort_smem.block_sort(x), want)
    assert torch.equal(sp.block_sort_unrolled(x), sort_smem.block_sort_plain(x, sp.BLOCK_BITS))
    assert torch.equal(sp.block_sort_unrolled(x), torch.sort(x).values)
    if bits <= sort_smem.BLK_BITS:
        assert torch.equal(want, torch.sort(x).values)


def test_cpu_path_does_not_launch_and_names_match_the_jax_tool(jax_tool):
    before = dict(sp.launches)
    x = torch.from_numpy(_keys(1, 1))
    fns, plains = sp.candidates(), sp.plain_versions()
    assert set(fns) == set(plains)
    assert set(jax_tool.CANDIDATES) <= set(fns)
    for name, fn in fns.items():
        assert torch.equal(fn(x), plains[name](x)), name
    assert sp.launches == before


@pytest.mark.parametrize("fn", [
    lambda x: sp.block_map("descent18", x), sp.descent_masked, sp.descent_grid2d])
def test_wrappers_refuse_bad_input(fn):
    with pytest.raises(ValueError, match="whole blocks"):
        fn(torch.zeros(1 << 17, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        fn(torch.zeros(sp.BLOCK, dtype=torch.int64))
    with pytest.raises(ValueError, match="device"):
        fn(torch.zeros(sp.BLOCK, dtype=torch.int32, device="meta"))


def test_unknown_candidate_raises():
    with pytest.raises(ValueError, match="unknown"):
        sp.block_map("nope", torch.zeros(sp.BLOCK, dtype=torch.int32))
    with pytest.raises(ValueError):
        sp.block_sort_unrolled(torch.zeros(100, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(
    sp.BLOCK_MAP_CANDIDATES + ["descent18_masked", "descent18_grid2d",
                               "block_sort", "block_sort_unrolled"]))
def test_cuda_kernels_match_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.from_numpy(_keys(11, 2)).cuda()
    x[::1001] = -(1 << 31)
    before = sum(sp.launches.values())
    got = sp.candidates()[name](x)
    torch.cuda.synchronize()
    assert sum(sp.launches.values()) == before + (name != "block_sort")
    assert torch.equal(got, sp.plain_versions()[name](x))
    if name in ("descent18_masked", "descent18_grid2d"):
        # K5 and K6 at one block and at 3: one launch of their warp kernel each
        entry = {"descent18_masked": "sp_descent_masked_warp",
                 "descent18_grid2d": "sp_descent_grid2d_warp"}[name]
        for blocks in (1, 3):
            y = torch.from_numpy(_keys(blocks, blocks)).cuda()
            y[::777] = -(1 << 31)
            y[5::779] = (1 << 31) - 1
            before = sp.entry_launches.get(entry, 0)
            got = sp.candidates()[name](y)
            torch.cuda.synchronize()
            assert sp.entry_launches[entry] == before + 1
            assert torch.equal(got, sp.plain_versions()[name](y))
        # a view that does not start on a 16-byte boundary
        y = torch.from_numpy(_keys(12, 2)).cuda()[1:1 + sp.BLOCK]
        assert torch.equal(sp.candidates()[name](y), sp.plain_versions()[name](y))
    if name == "block_sort_unrolled":
        # K3's cluster launch shapes: one CTA with padding, one CTA, clusters
        # of 2, and 2 and 4 clusters of 8
        for bits in (10, 15, 16, 19, 20):
            y = torch.from_numpy(_keys(bits, 1 << max(bits - 18, 0))).cuda()[:1 << bits]
            y[::777] = -(1 << 31)
            assert torch.equal(sp.block_sort_unrolled(y), sort_smem.block_sort_plain(y, 18))
