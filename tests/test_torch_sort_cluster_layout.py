"""PyTorch port: the schedule of the cluster kernel (csrc/sort_primitives.cu
``cluster_stages``, K3 and K4's lists of stages) checked on the CPU.

The kernel runs only on the card. Here a plain PyTorch emulation runs its
schedule on its data layout: keys in (CTA, thread, slot) registers, 32 slots
a thread and 1024 threads a CTA; the three register layouts of the source
note (which local index bits are slot, lane and warp bits); a change of
layout as a write to and a read from a shared-memory image with one pad
word every 32; a run of stages of stride >= 2^15 as a gather of a chunk of
positions from the group of CTAs it spans, the stages, and a scatter back; the directions as complements of the keys (the kernel's flip word,
one pattern per slot bit); the launch shape (n / 2^15 CTAs, clusters of up
to 8, one CTA with INT32_MAX padding below 2^15 keys). The constants are
read from the .cu. The emulation is held exact (int32 keys) to
``block_sort_plain(x, 18)`` at n = 2^1 .. 2^19 and to every K4 list's plain
version, and copies of it with one layout bit or one direction rule broken
are held to fail.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from subphaser_torch.ops import sort_primitives as sp
from subphaser_torch.ops import sort_smem
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SRC = pathlib.Path(sp.__file__).resolve().parents[1] / "csrc" / "sort_primitives.cu"
INT_MAX = np.iinfo(np.int32).max
# the kernel's flip patterns: bit r of PATTERN[j] is bit j of r
PATTERN = [sum(1 << r for r in range(32) if r >> j & 1) for j in range(5)]


def _defines() -> dict:
    text = SRC.read_text()
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"^#define (CL_\w+) (\d+)\b", text, re.M)}


def _note_layouts() -> list:
    """The source note's layout table: [(slot bits, lane bits, warp bits)]."""
    rows = re.findall(r"^//\s+L(\d)\s+(\d+)\.\.(\d+)\s+(\d+)\.\.(\d+)\s+(\d+)\.\.(\d+)\s*$",
                      SRC.read_text(), re.M)
    return [tuple(list(range(int(a), int(b) + 1)) for a, b in zip(r[1::2], r[2::2]))
            for r in sorted(rows)]


DEF = _defines()
CTA_BITS, BLOCK_BITS, SLOT_BITS = DEF["CL_CTA_BITS"], DEF["CL_BLOCK_BITS"], DEF["CL_SLOT_BITS"]
KPT = 1 << SLOT_BITS
THREADS = 1 << (CTA_BITS - SLOT_BITS)
LAYOUTS = _note_layouts()


def _local_index(layout) -> torch.Tensor:
    """(THREADS, KPT) local index of each (thread, slot) in a layout given
    as (slot bits, lane bits, warp bits)."""
    slot_bits, lane_bits, warp_bits = layout
    t = torch.arange(THREADS)[:, None]
    r = torch.arange(KPT)[None, :]
    lane, warp = t & 31, t >> 5
    idx = torch.zeros(THREADS, KPT, dtype=torch.int64)
    for src, bits in ((r, slot_bits), (lane, lane_bits), (warp, warp_bits)):
        for j, b in enumerate(bits):
            idx |= ((src >> j) & 1) << b
    return idx


class Emulation:
    """The kernel's schedule on its layout. ``layouts`` and ``flip_pair``
    (K3: the mask between phases p and p + 1) are parameters so that broken
    copies can be made."""

    def __init__(self, layouts=None, flip_pair=lambda p: (1 << p) | (2 << p)):
        self.layouts = layouts or LAYOUTS
        self.idx = [_local_index(lay) for lay in self.layouts]
        self.flip_pair = flip_pair
        self.changes = {"cta": 0, "warp": 0}
        self.crosses = 0

    # launch shape ----------------------------------------------------------
    @staticmethod
    def shape(n: int) -> tuple[int, int]:
        """(CTAs, CTAs a cluster) of the launch for n keys."""
        ctas = max(n >> CTA_BITS, 1)
        return ctas, min(ctas, 1 << (BLOCK_BITS - CTA_BITS))

    # the kernel's steps ----------------------------------------------------
    def _phys(self, layout):
        idx = self.idx[layout]
        return idx + (idx >> 5)

    def _to_smem(self):
        smem = torch.zeros(self.v.shape[0], (1 << CTA_BITS) + (1 << (CTA_BITS - 5)),
                           dtype=torch.int32)
        phys = self._phys(self.layout).reshape(-1)
        smem[:, phys] = self.v.reshape(self.v.shape[0], -1)
        return smem

    def _from(self, smem, layout):
        return smem[:, self._phys(layout).reshape(-1)].reshape(self.v.shape)

    def relayout(self, to: int):
        """A round trip through shared memory; between L0 and L1 (the same
        warp bits) each warp only reads back what it wrote."""
        in_warp = set(self.layouts[self.layout][2]) == set(self.layouts[to][2])
        self.v = self._from(self._to_smem(), to)
        self.layout = to
        self.changes["warp" if in_warp else "cta"] += 1

    def reg_stage(self, j: int):
        lo = [r for r in range(KPT) if not r >> j & 1]
        hi = [r | 1 << j for r in lo]
        a, b = self.v[:, :, lo], self.v[:, :, hi]
        self.v[:, :, lo], self.v[:, :, hi] = torch.minimum(a, b), torch.maximum(a, b)

    def cross_run(self, cs, to: int):
        """cl_cross_run: rank bits cs in order; the group of CTAs whose ranks
        differ only in those bits splits the positions in G chunks, CTA j of
        the group gathers the G keys of chunk j's positions q * 1024 +
        thread, runs the stages on them, scatters them back; then every CTA
        reads its keys in layout ``to``."""
        smem = self._to_smem()
        ctas = smem.shape[0]
        smask = 0
        for c in cs:
            smask |= 1 << c
        set_bits = [c for c in range(BLOCK_BITS - CTA_BITS) if smask >> c & 1]
        g_n = 1 << len(set_bits)
        rank = torch.arange(ctas)
        j = sum(((rank >> c) & 1) << k for k, c in enumerate(set_bits))
        member = torch.stack([(rank & ~smask) | sum(((g >> k) & 1) << c for k, c in
                                                     enumerate(set_bits)) for g in range(g_n)], 1)
        q = torch.arange(KPT // g_n)[:, None]
        t = torch.arange(THREADS)[None, :]
        pos = (j[:, None, None] * ((1 << CTA_BITS) // g_n) + q * THREADS + t)  # (ctas, Q, T)
        phys = pos + (pos >> 5)
        rows = member[:, :, None, None].expand(-1, -1, *pos.shape[1:])        # (ctas, G, Q, T)
        cols = phys[:, None].expand_as(rows)
        vals = smem[rows, cols]
        for c in cs:
            k = bin(smask & ((1 << c) - 1)).count("1")
            lo = [g for g in range(g_n) if not g >> k & 1]
            hi = [g | 1 << k for g in lo]
            a, b = vals[:, lo], vals[:, hi]
            vals[:, lo], vals[:, hi] = torch.minimum(a, b), torch.maximum(a, b)
        smem[rows, cols] = vals
        self.v = self._from(smem, to)
        self.layout = to
        self.crosses += 1

    def stage(self, b: int):
        need = next(i for i, lay in enumerate(self.layouts) if b in lay[0])
        if need != self.layout:
            self.relayout(need)
        self.reg_stage(self.layouts[need][0].index(b))

    def stages(self, bits):
        """The K4 interpreter: runs of strides >= 2^15 as one cross run,
        read back in the next stage's layout (L1 at the end)."""
        i = 0
        while i < len(bits):
            if bits[i] < CTA_BITS:
                self.stage(bits[i])
                i += 1
                continue
            e = i
            while e < len(bits) and bits[e] >= CTA_BITS:
                e += 1
            to = bits[e] // SLOT_BITS if e < len(bits) else 1
            self.cross_run([b - CTA_BITS for b in bits[i:e]], to)
            i = e

    def flip(self, mask: int):
        """cl_flip_l: the thread's parity of (slot 0's global index & mask),
        xor the pattern of every mask bit held in a slot bit."""
        slot_bits = self.layouts[self.layout][0]
        g0 = (torch.arange(self.v.shape[0])[:, None] << CTA_BITS) | self.idx[self.layout][:, 0][None, :]
        parity = torch.zeros_like(g0)
        for b in range(32):
            if mask >> b & 1:
                parity ^= (g0 >> b) & 1
        f = parity * 0xFFFFFFFF
        for j, b in enumerate(slot_bits):
            if mask >> b & 1:
                f ^= PATTERN[j]
        bit = (f[:, :, None] >> torch.arange(KPT)) & 1
        self.v ^= (-bit).to(torch.int32)

    # entries ---------------------------------------------------------------
    def run(self, x: torch.Tensor, sort_bits: int = 0, bits=(), dir_bit: int = -1):
        n = x.numel()
        ctas, _cluster = self.shape(n)
        keys = torch.full((ctas << CTA_BITS,), INT_MAX, dtype=torch.int32)
        keys[:n] = x
        self.layout = 1
        self.v = keys.view(ctas, -1)[:, self.idx[1].reshape(-1)].reshape(ctas, THREADS, KPT)
        if sort_bits:
            last = min(max(sort_bits, CTA_BITS), BLOCK_BITS)
            self.flip(2)
            for p in range(1, last + 1):
                b = p - 1
                if b >= CTA_BITS:
                    self.cross_run(list(range(b - CTA_BITS, -1, -1)), 2)
                    b = CTA_BITS - 1
                for b in range(b, -1, -1):
                    self.stage(b)
                self.flip(self.flip_pair(p) if p < last else 1 << p)
        else:
            if dir_bit >= 0:
                self.flip(1 << dir_bit)
            self.stages(list(bits))
            if dir_bit >= 0:
                self.flip(1 << dir_bit)
        if self.layout == 0:
            self.relayout(1)
        out = torch.empty_like(keys).view(ctas, -1)
        out[:, self.idx[self.layout].reshape(-1)] = self.v.reshape(ctas, -1)
        return out.reshape(-1)[:n]


def _keys(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.integers(-(1 << 31), 1 << 31, size=n, dtype=np.int64).astype(np.int32)
    x[::97] = np.iinfo(np.int32).min
    x[5::101] = INT_MAX
    return torch.from_numpy(x)


def test_constants_match_the_kernel():
    """The launch and layout constants the emulation reads from the .cu."""
    assert (CTA_BITS, BLOCK_BITS, SLOT_BITS) == (sp.CTA_BITS, sp.BLOCK_BITS, 5)
    assert len(LAYOUTS) == 3
    for slot, lane, warp in LAYOUTS:
        assert len(slot) == len(lane) == SLOT_BITS
        assert sorted(slot + lane + warp) == list(range(CTA_BITS))
    # the kernel picks a stride's layout as b / 5, and slot bit b % 5
    for b in range(CTA_BITS):
        assert LAYOUTS[b // SLOT_BITS][0][b % SLOT_BITS] == b
    assert Emulation.shape(2) == (1, 1) and Emulation.shape(1 << 15) == (1, 1)
    assert Emulation.shape(1 << 16) == (2, 2) and Emulation.shape(1 << 25) == (1024, 8)


@pytest.mark.parametrize("layout", range(3))
def test_layouts_are_conflict_free(layout):
    """Every slot's 32 lanes hit 32 banks of the padded image, and a warp's
    slot in L1 and L2 reads 32 consecutive keys (coalesced)."""
    idx = _local_index(LAYOUTS[layout])
    phys = idx + (idx >> 5)
    for warp in (0, 5, 31):
        rows = phys[warp * 32:(warp + 1) * 32]
        for r in range(KPT):
            assert len(set((rows[:, r] % 32).tolist())) == 32
        if layout:
            assert torch.equal(idx[warp * 32:(warp + 1) * 32, 3] - idx[warp * 32, 3],
                               torch.arange(32))


@pytest.mark.parametrize("bits", range(1, 20))
def test_k3_schedule_matches_block_sort_plain(bits):
    x = _keys(1 << bits, bits)
    got = Emulation().run(x, sort_bits=bits)
    assert torch.equal(got, sort_smem.block_sort_plain(x, sp.BLOCK_BITS))


@pytest.mark.parametrize("name", sorted(sp.STAGE_BITS))
def test_k4_lists_match_their_plain_versions(name):
    x = _keys(2 * sp.BLOCK, len(name))
    emu = Emulation()
    got = emu.run(x, bits=sp.STAGE_BITS[name])
    assert torch.equal(got, sp.block_map_plain(name, x))


@pytest.mark.parametrize("dir_bit", [12, 18])
def test_lists_with_a_direction_bit(dir_bit):
    """sp_run_stages_cluster's dir_bit: a complement around the list."""
    x = _keys(2 * sp.BLOCK, dir_bit)
    bits = [b for b in sp.STAGE_BITS["descent18"] if b < dir_bit]
    got = Emulation().run(x, bits=bits, dir_bit=dir_bit)
    assert torch.equal(got, sp._stages_plain(x, bits, dir_bit))


# changes of layout between warps / inside warps, and cross-CTA runs, per
# schedule (the module docstring's table)
COUNTS = {"passthrough": (0, 0, 0), "lane_roll_stages": (0, 6, 0),
          "sublane_reshape_small": (0, 0, 0), "sublane_reshape_vreg": (1, 0, 2),
          "sublane_roll_stages": (2, 0, 1), "descent18": (1, 2, 1),
          "block_sort_unrolled": (13, 20, 3)}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_round_trips_and_cross_runs(name):
    emu = Emulation()
    x = _keys(sp.BLOCK, 1)
    if name == "block_sort_unrolled":
        emu.run(x, sort_bits=BLOCK_BITS)
    else:
        emu.run(x, bits=sp.STAGE_BITS[name])
    assert (emu.changes["cta"], emu.changes["warp"], emu.crosses) == COUNTS[name]


def _swap(layouts, li, a, b):
    """Layouts with index bits a (a slot bit of layout li) and b swapped."""
    out = [tuple(list(g) for g in lay) for lay in layouts]
    for group in out[li]:
        for i, bit in enumerate(group):
            group[i] = b if bit == a else a if bit == b else bit
    return [tuple(g) for g in out]


@pytest.mark.parametrize("broken", [
    dict(layouts=_swap(LAYOUTS, 2, 10, 9)),   # a slot bit of L2 is a warp bit
    dict(layouts=_swap(LAYOUTS, 0, 4, 5)),    # a slot bit of L0 is a lane bit
    dict(flip_pair=lambda p: 1 << p),         # phase p + 1 keeps ascending
    dict(flip_pair=lambda p: (1 << p) | (4 << p)),  # next direction from bit p + 2
])
def test_broken_copies_fail(broken):
    x = _keys(1 << 17, 3)
    emu = Emulation(**broken)
    if "layouts" in broken:  # the stage still takes the layout b / 5 and slot b % 5
        emu.stage = lambda b, e=emu: (e.relayout(b // 5) if e.layout != b // 5 else None,
                                      e.reg_stage(b % 5))
    assert not torch.equal(emu.run(x, sort_bits=17), sort_smem.block_sort_plain(x, 18))
