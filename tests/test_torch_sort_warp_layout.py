"""PyTorch port: the schedule of the warp kernel (csrc/sort_primitives.cu
``warp_stages``, K5 and K6) checked on the CPU.

The kernel runs only on the card. Here a plain PyTorch emulation runs its
schedule on its data layout: keys as (warp, lane, register) with register
r = 4 * slot + component, one warp a tile; the load and store index maps of
the source note's layout table for any tile id (the tile id's bits
deposited, low to high, into the index bits the tile does not hold); a
stage on a component or slot bit as a compare-exchange of two registers, a
stage on a lane bit as a lane-XOR gather with the lower lane keeping the
min; K5's direction as the kernel takes it, a complement of a warp's keys
where bit 9 of their index is set. The constants, stride lists and layout
table are read from the .cu. The emulation is held exact (int32 keys, with
INT32_MIN and INT32_MAX sown in) to ``descent_masked_plain`` and
``descent_grid2d_plain`` at 1, 2 and 3 blocks, and copies of it with one
layout bit swapped, one shuffle mask off, or K5's direction taken from
another bit are held to fail.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from subphaser_torch.ops import sort_primitives as sp
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SRC = pathlib.Path(sp.__file__).resolve().parents[1] / "csrc" / "sort_primitives.cu"
TEXT = SRC.read_text()
INT_MIN, INT_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def _defines() -> dict:
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"^#define (WR_\w+) (\d+)\b", TEXT, re.M)}


def _arrays() -> dict:
    return {m.group(1): [int(v) for v in m.group(2).split(",")]
            for m in re.finditer(r"^constexpr int (WR_\w+)\[\] = \{([^}]*)\};", TEXT, re.M)}


def _note_table() -> dict:
    """The source note's layout table: kernel -> (component bits, lane bits,
    slot bits, tile id bits below the open-ended top, top, direction bit)."""
    rows = re.findall(r"^//\s+(K[56])\s+(\d+)\.\.(\d+)\s+(\d+)\.\.(\d+)\s+((?:\d+ )*\d+)\s+"
                      r"((?:\d+ )*\d+)\.\.\s+(\d+|none)\s*$", TEXT, re.M)
    table = {}
    for name, c0, c1, l0, l1, slots, tile, direction in rows:
        tile_bits = [int(b) for b in tile.split()]
        table[name] = (list(range(int(c0), int(c1) + 1)), list(range(int(l0), int(l1) + 1)),
                       [int(b) for b in slots.split()], tile_bits[:-1], tile_bits[-1],
                       None if direction == "none" else int(direction))
    return table


DEF, ARR, TABLE = _defines(), _arrays(), _note_table()
LANE_LO, LANE_BITS, WARPS = DEF["WR_LANE_LO"], DEF["WR_LANE_BITS"], DEF["WR_WARPS"]
# kernel -> (component bits, lane bits, slot bits, stride bits of a revisit,
# revisits, direction bit) as the kernel's constants give them
SCHEDULES = {
    "K5": (list(range(LANE_LO)), list(range(LANE_LO, LANE_LO + LANE_BITS)), ARR["WR_K5_SLOTS"],
           ARR["WR_K5_BITS"], 1, DEF["WR_K5_DIR_BIT"]),
    "K6": (list(range(LANE_LO)), list(range(LANE_LO, LANE_LO + LANE_BITS)), ARR["WR_K6_SLOTS"],
           ARR["WR_K6_BITS"], DEF["WR_K6_REVISITS"], None),
}
PLAIN = {"K5": sp.descent_masked_plain, "K6": sp.descent_grid2d_plain}


def _tile_bases(tiles: int, local: list) -> torch.Tensor:
    """Index of each tile's first key (the kernel's wr_tile_base)."""
    top = max(local) + 1
    free = [b for b in range(top) if b not in local]
    t = torch.arange(tiles, dtype=torch.int64)
    g = torch.zeros_like(t)
    for k, b in enumerate(free):
        g |= ((t >> k) & 1) << b
    return g | ((t >> len(free)) << top)


class WarpEmulation:
    """The kernel's schedule on its layout. ``layout`` (component, lane and
    slot bits of the load and store maps), ``shuffle_mask`` and ``dir_bit``
    are parameters so that broken copies can be made; the stages always
    find their registers and lanes by the kernel's own layout."""

    def __init__(self, name: str, layout=None, shuffle_mask=lambda m: 1 << m, dir_bit="kernel"):
        comp, lanes, slots, self.bits, self.revisits, kernel_dir = SCHEDULES[name]
        self.stage_layout = (comp, lanes, slots)
        self.layout = layout or self.stage_layout
        self.shuffle_mask = shuffle_mask
        self.dir_bit = kernel_dir if dir_bit == "kernel" else dir_bit
        self.shuffles = self.registers = 0

    def index(self, n: int) -> torch.Tensor:
        """(tiles, 32, registers) index of each key the kernel loads."""
        comp, lanes, slots = self.layout
        reg_bits = comp + slots
        tiles = n >> (len(comp) + len(lanes) + len(slots))
        lane = torch.arange(32)
        reg = torch.arange(1 << len(reg_bits))
        idx = _tile_bases(tiles, comp + lanes + slots)[:, None, None].clone()
        for j, b in enumerate(lanes):
            idx = idx | (((lane >> j) & 1) << b)[None, :, None]
        for j, b in enumerate(reg_bits):
            idx = idx | (((reg >> j) & 1) << b)[None, None, :]
        return idx

    def stage(self, v: torch.Tensor, b: int) -> torch.Tensor:
        comp, lanes, slots = self.stage_layout
        if b in comp or b in slots:  # wr_reg_bit: component bits, then slot bits
            j = b if b in comp else len(comp) + slots.index(b)
            lo = [r for r in range(v.shape[2]) if not r >> j & 1]
            hi = [r | 1 << j for r in lo]
            a, c = v[:, :, lo], v[:, :, hi]
            v[:, :, lo], v[:, :, hi] = torch.minimum(a, c), torch.maximum(a, c)
            self.registers += 1
            return v
        m = lanes.index(b)  # raises where the stride lies outside the tile
        lane = torch.arange(32)
        other = v[:, lane ^ self.shuffle_mask(m), :]
        lower = ((lane >> m) & 1 == 0)[None, :, None]
        self.shuffles += 1
        return torch.where(lower, torch.minimum(v, other), torch.maximum(v, other))

    def run(self, x: torch.Tensor) -> torch.Tensor:
        idx = self.index(x.numel())
        v = x[idx]
        flip = torch.zeros(idx.shape[:2] + (1,), dtype=torch.int32)
        if self.dir_bit is not None:  # one word a lane, from its register 0's index
            flip = -((idx[:, :, :1] >> self.dir_bit) & 1).to(torch.int32)
        v = v ^ flip
        for _ in range(self.revisits):
            for b in self.bits:
                v = self.stage(v, b)
        v = v ^ flip
        out = torch.empty_like(x)
        out[idx.reshape(-1)] = v.reshape(-1)
        return out


def _keys(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.integers(INT_MIN, INT_MAX, size=n, endpoint=True, dtype=np.int64).astype(np.int32)
    x[::97] = INT_MIN
    x[5::101] = INT_MAX
    return torch.from_numpy(x)


def test_constants_match_the_wrapper_and_the_note():
    assert (LANE_LO, LANE_BITS) == (2, 5) and WARPS >= 1
    assert SCHEDULES["K5"][3] == sp.MASKED_BITS
    assert SCHEDULES["K5"][5] == sp.MASKED_P
    assert SCHEDULES["K6"][3] == sp.GRID2D_BITS
    assert SCHEDULES["K6"][4] == sp.GRID2D_REVISITS
    assert set(TABLE) == {"K5", "K6"}
    for name, (comp, lanes, slots, tile, top, direction) in TABLE.items():
        k_comp, k_lanes, k_slots, _bits, _rev, k_dir = SCHEDULES[name]
        assert (comp, lanes, slots, direction) == (k_comp, k_lanes, k_slots, k_dir)
        local = comp + lanes + slots
        # the tile id fills the bits the tile does not hold, then every bit
        # from one above the tile's highest
        assert tile == [b for b in range(max(local) + 1) if b not in local]
        assert top == max(local) + 1


@pytest.mark.parametrize("name,counts", [("K5", (5, 4)), ("K6", (6, 12))])
def test_stage_kinds_match_the_module_table(name, counts):
    """Shuffle and register stages of one revisit, as the kernel places
    them and as ops/sort_primitives' candidate table states them."""
    comp, lanes, slots, bits, _rev, _dir = SCHEDULES[name]
    assert set(bits) <= set(comp + lanes + slots)
    shuffles = sum(b in lanes for b in bits)
    assert (shuffles, len(bits) - shuffles) == counts
    doc = sp.__doc__
    if name == "K5":
        m = re.search(r"descent18_masked \(K5\)\s+one warp a 512-key group: (\d+) shuffle,\s+"
                      r"(\d+) register", doc)
    else:
        m = re.search(r"descent18_grid2d \(K6\)\s+one warp a strided 2\^11-key tile: 4 x \((\d+)\s+"
                      r"shuffle \+ (\d+) register\)", doc)
    assert m and (int(m.group(1)), int(m.group(2))) == counts


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("name", ["K5", "K6"])
def test_index_map_is_a_coalesced_bijection(name, blocks):
    """Every key is loaded once, and a slot of a warp is 128 consecutive
    keys (512 contiguous bytes, aligned)."""
    n = blocks * sp.BLOCK
    idx = WarpEmulation(name).index(n)
    assert torch.equal(torch.sort(idx.reshape(-1)).values, torch.arange(n))
    slots = idx.reshape(idx.shape[0], 32, -1, 4).transpose(1, 2).reshape(idx.shape[0], -1, 128)
    assert torch.equal(slots - slots[:, :, :1], torch.arange(128).expand_as(slots))
    assert bool((slots[:, :, 0] % 128 == 0).all())


def test_k5_direction_is_one_per_warp():
    idx = WarpEmulation("K5").index(2 * sp.BLOCK)
    d = (idx >> sp.MASKED_P) & 1
    assert bool((d == d[:, :1, :1]).all())
    assert set(d[:, 0, 0].tolist()) == {0, 1}


@pytest.mark.parametrize("blocks", [1, 2, 3])
@pytest.mark.parametrize("name", ["K5", "K6"])
def test_schedule_matches_the_plain_version(name, blocks):
    x = _keys(blocks * sp.BLOCK, blocks)
    emu = WarpEmulation(name)
    assert torch.equal(emu.run(x), PLAIN[name](x))
    comp, lanes, _slots, bits, revisits, _dir = SCHEDULES[name]
    assert emu.shuffles == revisits * sum(b in lanes for b in bits)


def _swap(name: str, a: int, b: int):
    """The kernel's layout with index bits a and b swapped in the load and
    store maps."""
    comp, lanes, slots = SCHEDULES[name][:3]
    return tuple([b if v == a else a if v == b else v for v in group]
                  for group in (comp, lanes, slots))


@pytest.mark.parametrize("name,broken", [
    ("K6", dict(layout=_swap("K6", 10, 11))),  # a slot bit is a tile-id bit
    ("K6", dict(layout=_swap("K6", 2, 10))),   # a lane bit is a slot bit
    ("K5", dict(layout=_swap("K5", 8, 9))),    # a slot bit is the direction bit
    ("K5", dict(layout=_swap("K5", 1, 2))),    # a component bit is a lane bit
    ("K6", dict(shuffle_mask=lambda m: 1 << (m + 1) % 5)),
    ("K5", dict(shuffle_mask=lambda m: (1 << m) ^ 1 if m else 2)),
    ("K5", dict(dir_bit=8)),
    ("K5", dict(dir_bit=10)),
])
def test_broken_copies_fail(name, broken):
    x = _keys(sp.BLOCK, 7)
    assert not torch.equal(WarpEmulation(name, **broken).run(x), PLAIN[name](x))


def test_kernel_keeps_no_shared_state():
    """warp_stages uses no shared memory, no barrier and no stage list, and
    the tile kernel it replaced is gone with its entry points."""
    body = TEXT[TEXT.index("warp_stages(const int*"):]
    body = body[:body.index("\n}\n")]
    for banned in ("__shared__", "__syncthreads", "__syncwarp", "StageList", "cluster"):
        assert banned not in body, banned
    for gone in ("tile_stages", "sp_run_stages(", "sp_run_stages_resident", "sp_tile_bits",
                 "TileMap", "pair_desc"):
        assert gone not in TEXT, gone
