// Compare-exchange primitives of the bitonic sort on Hopper (sm_90a).
//
// Counterparts of the four Pallas kernels the JAX package keeps beside its
// VMEM sort:
//   K3  ops/sort_vmem.py `_block_sort_kernel`: bitonic phases 1..18 of
//       every 2^18-key block              -> cluster_stages, phases generated
//                                            in the kernel (sp_block_sort_cluster)
//   K4  tools/bench_sort_primitives.py `pallas_block_map(body)`: one body
//       per candidate                     -> cluster_stages for the six lists
//                                            of stages (sp_run_stages_cluster);
//                                            elementwise_chain, transpose_tiles
//   K5  same tool, `_descent_masked`      -> warp_stages<WrK5>, one warp a
//                                            512-key group (sp_descent_masked_warp)
//   K6  same tool, `_descent_grid2d`      -> warp_stages<WrK6>, one warp a
//                                            strided 2^11-key tile
//                                            (sp_descent_grid2d_warp)
//
// Each computes the function of its TPU kernel on the WHOLE int32 array, not
// its blocking.
//
// K3 and K4: the TPU held a 2^18-key block (1 MiB) in VMEM. On Hopper a
// thread-block cluster of 8 CTAs holds it: 2^15 keys a CTA in 132 KB of
// dynamic shared memory (one CTA an SM), each CTA reading its partner's
// shared memory directly (distributed shared memory). The array moves
// through device memory once in and once out; every stride of a block stays
// on chip. K3's network does 171 stages of min/max over n/2 pairs, about
// ten times the compares a sort needs; the bound of K3 and of K4's 18-stage
// lists is bytes (8n).
//
// Inside a CTA the 2^15 keys live in registers, 32 a thread x 1024 threads,
// in one of three layouts. Local index bits (l = 0..14) by layout:
//
//   layout   thread-local (slot r)   warp-local (lane)   CTA-local (warp)
//   L0       0..4                    5..9                10..14
//   L1       5..9                    0..4                10..14
//   L2       10..14                  0..4                5..9
//
// and global bits 15..17 are cluster-local (the CTA's rank). A stage of
// stride 2^b with b < 15 runs in layout b / 5 as a register compare-exchange
// with compile-time slot indices (slot bit b % 5); switching layouts is one
// round trip through shared memory (write all 32 slots, barrier, read all
// 32), which serves every consecutive stage whose bit the layout holds in
// registers. L0 and L1 have the same warp bits, so between them a warp
// reads back only what it wrote and a warp barrier does; to or from L2 the
// keys change warps and the CTA waits at a barrier. Shared memory holds
// local index l at word l + l / 32: every layout's 32 lanes then hit 32
// banks, and every slot's address is its thread's base plus a compile-time
// offset. The block is read into registers in L1 (a warp reads 32
// consecutive keys per slot, coalesced) and written out from L1 or L2.
//
// Stages with b >= 15 pair CTA ranks that differ in bit b - 15. A run of
// them (K3's phase p >= 16 begins with the strides 2^(p-1)..2^15) spans a
// group of G = 2, 4 or 8 CTAs. Every CTA writes its keys to its shared
// memory; cluster barrier; CTA j of a group takes chunk j of the positions
// (2^15 / G of them, a warp on 32 consecutive ones), gathers the G keys of
// each from the group's shared memories (distributed shared memory, mapa +
// ld.shared::cluster), runs the whole run on them in registers (32 / G
// positions x G keys a thread) and scatters them back; cluster barrier;
// every CTA reads its keys in the layout of the next stage. A key crosses
// the cluster twice a run, not once a stage: distributed shared memory
// moves far fewer bytes a clock than local shared memory.
//
// Directions: every compare-exchange is ascending. A stage sequence whose
// pairs sort descending where index bit d is set is run as: complement (~x,
// an exact reversal of int32 order) every key whose index has bit d, run
// ascending, complement them back; pairs never cross bit d. K3's phase p
// takes its direction from bit p, so between phases p and p + 1 a key is
// complemented where bits p and p + 1 of its global index differ: one XOR a
// key a phase instead of a select a compare. The block's parity (bit 18)
// flips the last phase when the array holds more than one block; an array
// of one block or less comes out ascending. An array under 2^15 keys is one
// CTA whose missing keys are INT32_MAX: phases 1..15 sort it, and its first
// n keys are the n keys sorted.
//
// K5 and K6: neither function pairs keys of two tiles. K6's 72 stages
// touch only index bits {0..6, 10, 12, 14, 16}, so a 2^18-key block is 128
// independent tiles of 2^11 keys; K5's 9 stages touch bits 0..8 and take
// their direction from bit 9, so it is independent 512-key groups of one
// direction each. warp_stages gives each tile to one warp, in registers: a
// lane holds 2^slot int4 (4 << slot keys, register r = 4 * slot + component).
// Index bits of a tile's keys by where they live:
//
//   tile  component  lane   slot          tile id, low to high     direction
//   K5    0..1       2..6   7 8           9..                      9
//   K6    0..1       2..6   10 12 14 16   7 8 9 11 13 15 17..      none
//
// A stage on a component or slot bit is a compare-exchange of two registers
// with compile-time indices; a stage on a lane bit is one __shfl_xor_sync a
// key with a compile-time lane mask, the lower lane keeping the min. The
// schedule (WR_K5_BITS; WR_K6_BITS, WR_K6_REVISITS times) is unrolled by
// templates (one revisit of K6 unrolled, the revisits a loop): no shared
// memory, no barrier, no stage list read at run time.
// A slot of a warp is 32 lanes x 16 bytes = 512 contiguous bytes, so every
// lane starts all its 16-byte loads before the first stage, and its stores
// mirror them. K5's direction is one per warp: where the tile's bit 9 is set
// its keys are complemented (~x, an exact reversal of int32 order) after the
// load and before the store, and every stage is ascending. At 128 min/max a
// clock an SM both are bound by bytes (8n; K6's 72 stages of n min/max come
// to 0.9 of that). The card runs int32 min/max (VIMNMX) at half that
// rate, and a shuffle stage costs two a key (a predicated min for the lower
// lane, a predicated max for the upper), so K6's 96n min/max, not its bytes,
// set its pace; K5 is its one pass through memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace cg = cooperative_groups;

#define MAX_STAGES 96
#define TDIM 128          // transpose tile edge
#define TPAD (TDIM + 1)   // padded row: conflict-free column access

// the cluster kernel (K3, K4's stage lists)
#define CL_BLOCK_BITS 18                   // keys of a block = of a full cluster
#define CL_CTA_BITS 15                     // keys of a CTA
#define CL_SLOT_BITS 5                     // keys of a thread: 32 registers
#define CL_KPT (1 << CL_SLOT_BITS)
#define CL_THREADS (1 << (CL_CTA_BITS - CL_SLOT_BITS))
#define CL_MAX_CTAS (1 << (CL_BLOCK_BITS - CL_CTA_BITS))
#define CL_SMEM_WORDS ((1 << CL_CTA_BITS) + (1 << (CL_CTA_BITS - 5)))  // + 1 pad word / 32
#define CL_SMEM_BYTES (CL_SMEM_WORDS * 4)
#define SP_ERR_NO_CLUSTER (-1)             // no cluster of the launch's shape fits

// the warp kernel (K5, K6)
#define WR_WARPS 4                         // warps (tiles) a CTA
#define WR_LANE_LO 2                       // index bits 2..6 are the lane
#define WR_LANE_BITS 5
constexpr int WR_K5_BITS[] = {8, 7, 6, 5, 4, 3, 2, 1, 0};  // stride bits, in order
constexpr int WR_K5_SLOTS[] = {7, 8};                       // index bit of each slot bit
#define WR_K5_DIR_BIT 9
constexpr int WR_K6_BITS[] = {10, 1, 12, 3, 14, 5, 16, 0, 10, 2, 12, 4, 14, 6, 16, 1, 10, 3};
constexpr int WR_K6_SLOTS[] = {10, 12, 14, 16};
#define WR_K6_REVISITS 4

struct StageList {
    int n;
    unsigned char sb[MAX_STAGES];  // LOCAL bit of each stage's stride
};

// ---------------------------------------------------------------------------
// warp_stages: K5 and K6, one tile a warp (see the note above)
// ---------------------------------------------------------------------------
#define WR_LEN(a) ((int)(sizeof(a) / sizeof((a)[0])))

// A schedule: the stride bits of one revisit in order, run `revisits`
// times; the index bit of each slot bit; its direction bit (-1: ascending
// throughout).
struct WrK5 {
    static constexpr int slot_bits = WR_LEN(WR_K5_SLOTS);
    static constexpr int stages = WR_LEN(WR_K5_BITS);
    static constexpr int revisits = 1;
    static constexpr int dir_bit = WR_K5_DIR_BIT;
    __host__ __device__ static constexpr int bit(int i) { return WR_K5_BITS[i]; }
    __host__ __device__ static constexpr int slot(int k) { return WR_K5_SLOTS[k]; }
};
struct WrK6 {
    static constexpr int slot_bits = WR_LEN(WR_K6_SLOTS);
    static constexpr int stages = WR_LEN(WR_K6_BITS);
    static constexpr int revisits = WR_K6_REVISITS;
    static constexpr int dir_bit = -1;
    __host__ __device__ static constexpr int bit(int i) { return WR_K6_BITS[i]; }
    __host__ __device__ static constexpr int slot(int k) { return WR_K6_SLOTS[k]; }
};

// The register bit (of r = 4 * slot + component) that holds index bit b,
// or -1 where b is not in registers: the WR_LANE_LO component bits, then the
// slot bits.
template <class S>
__host__ __device__ constexpr int wr_reg_bit(int b) {
    if (b < WR_LANE_LO) return b;
    for (int k = 0; k < S::slot_bits; ++k)
        if (S::slot(k) == b) return WR_LANE_LO + k;
    return -1;
}

// The index bits a tile holds (component, lane and slot bits).
template <class S>
__host__ __device__ constexpr unsigned long long wr_local_mask() {
    unsigned long long m = (1ull << (WR_LANE_LO + WR_LANE_BITS)) - 1;
    for (int k = 0; k < S::slot_bits; ++k) m |= 1ull << S::slot(k);
    return m;
}

// One above the highest index bit a tile holds.
template <class S>
__host__ __device__ constexpr int wr_top() {
    int t = 0;
    while (wr_local_mask<S>() >> t) ++t;
    return t;
}

// Offset of slot s from the tile's slot 0.
template <class S>
__host__ __device__ constexpr long long wr_slot_offset(int s) {
    long long g = 0;
    for (int k = 0; k < S::slot_bits; ++k)
        if ((s >> k) & 1) g |= 1LL << S::slot(k);
    return g;
}

// Index of tile t's first key: the bits of t deposited, low to high, into
// the index bits the tile does not hold.
template <class S>
__device__ __forceinline__ long long wr_tile_base(long long t) {
    constexpr unsigned long long local = wr_local_mask<S>();
    constexpr int top = wr_top<S>();
    long long g = 0;
    int k = 0;
#pragma unroll
    for (int b = 0; b < top; ++b) {
        if (!((local >> b) & 1)) {
            g |= ((t >> k) & 1) << b;
            ++k;
        }
    }
    return g | ((t >> k) << top);
}

template <class S, int s>
__device__ __forceinline__ void wr_load_slot(const int* p, int* v) {
    constexpr long long off = wr_slot_offset<S>(s);
    const int4 q = __ldcs(reinterpret_cast<const int4*>(p + off));  // read once
    v[4 * s] = q.x;
    v[4 * s + 1] = q.y;
    v[4 * s + 2] = q.z;
    v[4 * s + 3] = q.w;
}

template <class S, int s>
__device__ __forceinline__ void wr_store_slot(int* p, const int* v) {
    constexpr long long off = wr_slot_offset<S>(s);
    __stcs(reinterpret_cast<int4*>(p + off),
           make_int4(v[4 * s], v[4 * s + 1], v[4 * s + 2], v[4 * s + 3]));
}

template <class S, int... s>
__device__ __forceinline__ void wr_load(const int* p, int* v, std::integer_sequence<int, s...>) {
    (wr_load_slot<S, s>(p, v), ...);
}

template <class S, int... s>
__device__ __forceinline__ void wr_store(int* p, const int* v, std::integer_sequence<int, s...>) {
    (wr_store_slot<S, s>(p, v), ...);
}

// Stage i of schedule S: an ascending compare-exchange at stride 2^S::bit(i).
template <class S, int i>
__device__ __forceinline__ void wr_stage(int* v, int lane) {
    constexpr int KPL = 4 << S::slot_bits;
    constexpr int b = S::bit(i);
    constexpr int j = wr_reg_bit<S>(b);
    static_assert(j >= 0 || (b >= WR_LANE_LO && b < WR_LANE_LO + WR_LANE_BITS),
                  "a stage's stride bit lies outside the tile");
    if constexpr (j >= 0) {
#pragma unroll
        for (int r = 0; r < KPL; ++r) {
            if ((r >> j) & 1) continue;
            const int a = v[r], c = v[r | (1 << j)];
            v[r] = min(a, c);
            v[r | (1 << j)] = max(a, c);
        }
    } else {
        constexpr int m = 1 << (b - WR_LANE_LO);
        const bool lower = (lane & m) == 0;
#pragma unroll
        for (int r = 0; r < KPL; ++r) {
            const int o = __shfl_xor_sync(0xffffffffu, v[r], m);
            v[r] = lower ? min(v[r], o) : max(v[r], o);
        }
    }
}

template <class S, int... i>
__device__ __forceinline__ void wr_run(int* v, int lane, std::integer_sequence<int, i...>) {
    (wr_stage<S, i>(v, lane), ...);
}

// One warp a tile: `tiles` tiles of 4 << (S::slot_bits + WR_LANE_BITS) keys.
template <class S>
__global__ void __launch_bounds__(WR_WARPS * 32)
warp_stages(const int* __restrict__ src, int* __restrict__ dst, long long tiles) {
    constexpr int KPL = 4 << S::slot_bits;
    constexpr int SLOTS = 1 << S::slot_bits;
    const long long tile = (long long)blockIdx.x * WR_WARPS + (threadIdx.x >> 5);
    if (tile >= tiles) return;  // whole warps only: no shuffle loses its partner
    const int lane = threadIdx.x & 31;
    const long long base = wr_tile_base<S>(tile) + (lane << WR_LANE_LO);
    int v[KPL];
    wr_load<S>(src + base, v, std::make_integer_sequence<int, SLOTS>{});
    // a descending tile as the complement of its keys (0 where S has no direction)
    constexpr int d = S::dir_bit < 0 ? 0 : S::dir_bit;
    const int flip = S::dir_bit < 0 ? 0 : -(int)((base >> d) & 1);
#pragma unroll
    for (int r = 0; r < KPL; ++r) v[r] ^= flip;
    // one revisit unrolled, the revisits a loop: all of K6's 72 stages
    // unrolled ran slower (a larger body than the instruction cache keeps)
#pragma unroll 1
    for (int rv = 0; rv < S::revisits; ++rv)
        wr_run<S>(v, lane, std::make_integer_sequence<int, S::stages>{});
#pragma unroll
    for (int r = 0; r < KPL; ++r) v[r] ^= flip;
    wr_store<S>(dst + base, v, std::make_integer_sequence<int, SLOTS>{});
}

// x -> max(x, x - 1), `iters` times in a dependent chain; x - 1 wraps like
// the array libraries' int32 (so the compiler cannot assume x - 1 < x and
// drop the chain).
__device__ __forceinline__ int max_dec(int x) {
    return max(x, (int)((unsigned)x - 1u));
}

__global__ void elementwise_chain(const int4* src, int4* dst, long long n4, int iters) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n4) return;
    int4 q = src[t];
    for (int i = 0; i < iters; ++i) {
        q.x = max_dec(q.x);
        q.y = max_dec(q.y);
        q.z = max_dec(q.z);
        q.w = max_dec(q.w);
    }
    dst[t] = q;
}

// `reps` times: transpose a 128 x 128 tile in shared memory, then max_dec.
__global__ void __launch_bounds__(1024)
transpose_tiles(const int* src, int* dst, int reps) {
    extern __shared__ int tbuf[];  // TDIM x TPAD
    const long long base = (long long)blockIdx.x * (TDIM * TDIM);
    for (int idx = threadIdx.x; idx < TDIM * TDIM; idx += blockDim.x)
        tbuf[(idx / TDIM) * TPAD + idx % TDIM] = src[base + idx];
    __syncthreads();
    for (int rep = 0; rep < reps; ++rep) {
        for (int idx = threadIdx.x; idx < TDIM * TDIM; idx += blockDim.x) {
            const int r = idx / TDIM, c = idx % TDIM;
            if (r < c) {
                const int a = tbuf[r * TPAD + c], b = tbuf[c * TPAD + r];
                tbuf[r * TPAD + c] = max_dec(b);
                tbuf[c * TPAD + r] = max_dec(a);
            } else if (r == c) {
                tbuf[r * TPAD + c] = max_dec(tbuf[r * TPAD + c]);
            }
        }
        __syncthreads();
    }
    for (int idx = threadIdx.x; idx < TDIM * TDIM; idx += blockDim.x)
        dst[base + idx] = tbuf[(idx / TDIM) * TPAD + idx % TDIM];
}

// ---------------------------------------------------------------------------
// cluster_stages: K3 and K4's lists of stages on 2^18-key blocks, one block a
// cluster of 8 CTAs (see the note at the top for the layouts)
// ---------------------------------------------------------------------------
static_assert(CL_SLOT_BITS == 5 && CL_CTA_BITS == 15,
              "three layouts of 5 slot bits, 5 lane bits and 5 warp bits");

// The lowest index bit layout L holds in its slots.
__host__ __device__ constexpr int cl_shift(int layout) {
    return layout == 0 ? 0 : layout == 1 ? CL_SLOT_BITS : CL_CTA_BITS - CL_SLOT_BITS;
}

// The layout that holds index bit b < CL_CTA_BITS in its slots.
__host__ __device__ constexpr int cl_layout_of(int b) {
    return b < CL_SLOT_BITS ? 0 : b < 2 * CL_SLOT_BITS ? 1 : 2;
}

// Word of local index l in shared memory: one pad word every 32.
__device__ __forceinline__ int cl_phys(int l) { return l + (l >> 5); }

// Local index of this thread's slot 0 in layout L, and of slot r relative to
// it (disjoint bits, so cl_phys of the sum is the sum of the cl_phys).
template <int L>
__device__ __forceinline__ int cl_base(int lane, int warp) {
    return L == 0 ? (lane << 5) | (warp << 10) : L == 1 ? lane | (warp << 10) : lane | (warp << 5);
}
template <int L>
__device__ __forceinline__ int cl_off(int r) { return r << cl_shift(L); }

template <int L>
__device__ __forceinline__ void cl_store(int* s, const int (&v)[CL_KPT], int lane, int warp) {
    const int pb = cl_phys(cl_base<L>(lane, warp));
#pragma unroll
    for (int r = 0; r < CL_KPT; ++r) s[pb + cl_phys(cl_off<L>(r))] = v[r];
}

template <int L>
__device__ __forceinline__ void cl_load(const int* s, int (&v)[CL_KPT], int lane, int warp) {
    const int pb = cl_phys(cl_base<L>(lane, warp));
#pragma unroll
    for (int r = 0; r < CL_KPT; ++r) v[r] = s[pb + cl_phys(cl_off<L>(r))];
}

__device__ __forceinline__ void cl_to_smem(int* s, const int (&v)[CL_KPT], int layout,
                                           int lane, int warp) {
    if (layout == 0) cl_store<0>(s, v, lane, warp);
    else if (layout == 1) cl_store<1>(s, v, lane, warp);
    else cl_store<2>(s, v, lane, warp);
}

__device__ __forceinline__ void cl_from_smem(const int* s, int (&v)[CL_KPT], int layout,
                                             int lane, int warp) {
    if (layout == 0) cl_load<0>(s, v, lane, warp);
    else if (layout == 1) cl_load<1>(s, v, lane, warp);
    else cl_load<2>(s, v, lane, warp);
}

// The keys from layout `from` into layout `to`: one round trip through
// shared memory (the first barrier: every read of the last round trip is
// done). L0 and L1 share their warp bits, so between them a warp writes and
// reads back only its own 1024 keys and a warp barrier is enough; a change
// to or from L2 moves keys between warps.
__device__ __forceinline__ void cl_relayout(int* s, int (&v)[CL_KPT], int from, int to,
                                            int lane, int warp) {
    const bool in_warp = (from | to) == 1;
    if (in_warp) __syncwarp(); else __syncthreads();
    cl_to_smem(s, v, from, lane, warp);
    if (in_warp) __syncwarp(); else __syncthreads();
    cl_from_smem(s, v, to, lane, warp);
}

// Ascending compare-exchange of the slot pairs (r, r | 2^J).
template <int J>
__device__ __forceinline__ void cl_reg_stage(int (&v)[CL_KPT]) {
#pragma unroll
    for (int r = 0; r < CL_KPT; ++r) {
        if (r & (1 << J)) continue;
        const int a = v[r], b = v[r | (1 << J)];
        v[r] = min(a, b);
        v[r | (1 << J)] = max(a, b);
    }
}

// Complements every key whose global index has an odd number of the bits of
// `mask` set; g0 is the global index of this thread's slot 0 in layout L.
// Bit r of f says whether slot r flips: the thread's own parity, xor the
// pattern of each mask bit the layout holds in slot bit j.
template <int L>
__device__ __forceinline__ void cl_flip_l(int (&v)[CL_KPT], unsigned mask, unsigned g0) {
    const unsigned slot_mask = (mask >> cl_shift(L)) & (CL_KPT - 1);
    unsigned f = (__popc(g0 & mask) & 1) ? 0xffffffffu : 0u;
    if (slot_mask & 1) f ^= 0xaaaaaaaau;
    if (slot_mask & 2) f ^= 0xccccccccu;
    if (slot_mask & 4) f ^= 0xf0f0f0f0u;
    if (slot_mask & 8) f ^= 0xff00ff00u;
    if (slot_mask & 16) f ^= 0xffff0000u;
#pragma unroll
    for (int r = 0; r < CL_KPT; ++r) v[r] ^= (int)(f << (31 - r)) >> 31;
}

__device__ __forceinline__ void cl_flip(int (&v)[CL_KPT], int layout, unsigned mask,
                                        unsigned cta_g, int lane, int warp) {
    if (layout == 0) cl_flip_l<0>(v, mask, cta_g | cl_base<0>(lane, warp));
    else if (layout == 1) cl_flip_l<1>(v, mask, cta_g | cl_base<1>(lane, warp));
    else cl_flip_l<2>(v, mask, cta_g | cl_base<2>(lane, warp));
}

// Distributed shared memory: the address of word `w` of CTA `rank`'s shared
// memory in the cluster window, and a load and a store through it.
__device__ __forceinline__ unsigned cl_mapa(const int* s, int w, unsigned rank) {
    unsigned d;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(d) : "r"((unsigned)__cvta_generic_to_shared(s + w)), "r"(rank));
    return d;
}
__device__ __forceinline__ int cl_ld(unsigned a) {
    int x;
    asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(x) : "r"(a) : "memory");
    return x;
}
__device__ __forceinline__ void cl_st(unsigned a, int x) {
    asm volatile("st.shared::cluster.u32 [%0], %1;" :: "r"(a), "r"(x) : "memory");
}

// Ascending compare-exchange of group slots (g, g | 2^K) of every position q:
// v[q * G + g] holds position q's key of the group's g-th CTA.
template <int G, int K>
__device__ __forceinline__ void cl_group_stage(int (&v)[CL_KPT]) {
#pragma unroll
    for (int q = 0; q < CL_KPT / G; ++q) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
            if (g & (1 << K)) continue;
            const int a = v[q * G + g], b = v[q * G + (g | (1 << K))];
            v[q * G + g] = min(a, b);
            v[q * G + (g | (1 << K))] = max(a, b);
        }
    }
}

// The rank of the g-th CTA of this CTA's group: its own rank with the bits
// of smask replaced by the bits of g.
__device__ __forceinline__ unsigned cl_group_rank(unsigned rank, unsigned smask, int g) {
    unsigned r = rank & ~smask;
    for (int c = 0, k = 0; c < CL_BLOCK_BITS - CL_CTA_BITS; ++c)
        if ((smask >> c) & 1) r |= ((unsigned)(g >> k++) & 1) << c;
    return r;
}

// A run of consecutive stages of stride >= 2^15, as rank bits: bits[0..n)
// minus CL_CTA_BITS, or, where bits is null, top, top - 1, .., 0. The CTAs
// whose ranks differ only in the run's bits (smask) form a group of G; each
// takes 1/G of the positions, gathers the G keys of each from the group's
// shared memories, runs the whole run on them in registers and scatters
// them back, so a key crosses the cluster twice a run however many stages it
// has. Then every CTA reads its keys back in layout `to`.
template <int G>
__device__ __forceinline__ void cl_cross_run(int* s, int (&v)[CL_KPT], int& layout, int to,
                                             const unsigned char* bits, int n, int top,
                                             unsigned smask, int lane, int warp) {
    constexpr int QN = CL_KPT / G;  // positions a thread
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    unsigned j = 0;  // this CTA's index in its group: its rank bits in smask
    for (int c = 0, k = 0; c < CL_BLOCK_BITS - CL_CTA_BITS; ++c)
        if ((smask >> c) & 1) j |= ((rank >> c) & 1) << k++;
    // position q of this thread: chunk j, then q * 1024 + thread (a warp
    // reads 32 consecutive keys)
    const int w0 = cl_phys((int)j * ((1 << CL_CTA_BITS) / G) + (int)threadIdx.x);
    __syncthreads();  // every read of this CTA's shared memory is done
    cl_to_smem(s, v, layout, lane, warp);
    cluster.sync();   // every CTA's keys are in its shared memory
#pragma unroll
    for (int g = 0; g < G; ++g) {
        const unsigned a = cl_mapa(s, w0, cl_group_rank(rank, smask, g));
#pragma unroll
        for (int q = 0; q < QN; ++q) v[q * G + g] = cl_ld(a + 4 * cl_phys(q * CL_THREADS));
    }
    const int count = bits ? n : top + 1;
    for (int i = 0; i < count; ++i) {
        const unsigned c = bits ? bits[i] - CL_CTA_BITS : top - i;
        switch (__popc(smask & ((1u << c) - 1))) {  // the group slot bit of rank bit c
            case 0: cl_group_stage<G, 0>(v); break;
            case 1: if (G >= 4) cl_group_stage<G, (G >= 4 ? 1 : 0)>(v); break;
            default: if (G >= 8) cl_group_stage<G, (G >= 8 ? 2 : 0)>(v); break;
        }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
        const unsigned a = cl_mapa(s, w0, cl_group_rank(rank, smask, g));
#pragma unroll
        for (int q = 0; q < QN; ++q) cl_st(a + 4 * cl_phys(q * CL_THREADS), v[q * G + g]);
    }
    cluster.sync();   // every CTA's keys are back in its shared memory
    cl_from_smem(s, v, to, lane, warp);
    layout = to;
}

__device__ __forceinline__ void cl_cross(int* s, int (&v)[CL_KPT], int& layout, int to,
                                         const unsigned char* bits, int n, int top,
                                         unsigned smask, int lane, int warp) {
    const int g = __popc(smask);
    if (g == 1) cl_cross_run<2>(s, v, layout, to, bits, n, top, smask, lane, warp);
    else if (g == 2) cl_cross_run<4>(s, v, layout, to, bits, n, top, smask, lane, warp);
    else cl_cross_run<8>(s, v, layout, to, bits, n, top, smask, lane, warp);
}

// One ascending stage at stride 2^b < 2^15, in the layout that holds bit b
// in slots.
__device__ __forceinline__ void cl_stage(int* s, int (&v)[CL_KPT], int& layout, int b,
                                         int lane, int warp) {
    const int need = cl_layout_of(b);
    if (need != layout) {
        cl_relayout(s, v, layout, need, lane, warp);
        layout = need;
    }
    switch (b - cl_shift(need)) {
        case 0: cl_reg_stage<0>(v); break;
        case 1: cl_reg_stage<1>(v); break;
        case 2: cl_reg_stage<2>(v); break;
        case 3: cl_reg_stage<3>(v); break;
        default: cl_reg_stage<4>(v); break;
    }
}

// sort_bits > 0 (K3): bitonic phases 1..min(max(sort_bits, 15), 18) of the
// array of 2^sort_bits keys, the direction of phase p from bit p of the
// global index. sort_bits == 0 (K4): the stages st.sb[0..st.n) (strides
// < 2^18), descending where index bit dir_bit is set (dir_bit < 0: ascending).
__global__ void __launch_bounds__(CL_THREADS, 1)
cluster_stages(const int* __restrict__ src, int* __restrict__ dst, long long n, int sort_bits,
               const __grid_constant__ StageList st, int dir_bit) {
    extern __shared__ int cl_smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long cta_base = (long long)blockIdx.x << CL_CTA_BITS;
    const unsigned cta_g = (unsigned)cta_base;
    const int valid = n < (1 << CL_CTA_BITS) ? (int)n : (1 << CL_CTA_BITS);
    int v[CL_KPT];
    int layout = 1;
    {
        const int b = cl_base<1>(lane, warp);
#pragma unroll
        for (int r = 0; r < CL_KPT; ++r) {
            const int l = b | cl_off<1>(r);
            v[r] = l < valid ? src[cta_base + l] : 0x7fffffff;
        }
    }
    if (sort_bits > 0) {
        const int last = min(max(sort_bits, CL_CTA_BITS), CL_BLOCK_BITS);
        cl_flip(v, layout, 2u, cta_g, lane, warp);
        for (int p = 1; p <= last; ++p) {
            int b = p - 1;
            if (b >= CL_CTA_BITS) {  // strides 2^(p-1)..2^15: one run, then L2
                const int top = b - CL_CTA_BITS;
                cl_cross(cl_smem, v, layout, 2, nullptr, 0, top, (2u << top) - 1, lane, warp);
                b = CL_CTA_BITS - 1;
            }
            for (; b >= 0; --b) cl_stage(cl_smem, v, layout, b, lane, warp);
            // back from bit p's direction, on to bit p + 1's
            cl_flip(v, layout, (1u << p) | (p < last ? 2u << p : 0u), cta_g, lane, warp);
        }
    } else {
        const unsigned dmask = dir_bit >= 0 ? 1u << dir_bit : 0u;
        if (dmask) cl_flip(v, layout, dmask, cta_g, lane, warp);
        for (int i = 0; i < st.n;) {
            if (st.sb[i] < CL_CTA_BITS) {
                cl_stage(cl_smem, v, layout, st.sb[i++], lane, warp);
                continue;
            }
            int e = i;  // a run of strides >= 2^15; then the next stage's layout
            unsigned smask = 0;
            for (; e < st.n && st.sb[e] >= CL_CTA_BITS; ++e) smask |= 1u << (st.sb[e] - CL_CTA_BITS);
            const int to = e == st.n ? 1 : cl_layout_of(st.sb[e]);
            cl_cross(cl_smem, v, layout, to, st.sb + i, e - i, 0, smask, lane, warp);
            i = e;
        }
        if (dmask) cl_flip(v, layout, dmask, cta_g, lane, warp);
    }
    if (layout == 0) {
        cl_relayout(cl_smem, v, 0, 1, lane, warp);
        layout = 1;
    }
    if (layout == 1) {
        const int b = cl_base<1>(lane, warp);
#pragma unroll
        for (int r = 0; r < CL_KPT; ++r) {
            const int l = b | cl_off<1>(r);
            if (l < valid) dst[cta_base + l] = v[r];
        }
    } else {
        const int b = cl_base<2>(lane, warp);
#pragma unroll
        for (int r = 0; r < CL_KPT; ++r) {
            const int l = b | cl_off<2>(r);
            if (l < valid) dst[cta_base + l] = v[r];
        }
    }
}

// The launch of n keys (one CTA below 2^15 keys): n / 2^15 CTAs in clusters
// of up to 8, 132 KB of dynamic shared memory each.
static void cl_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1], long long n,
                      cudaStream_t stream) {
    const long long ctas = n >> CL_CTA_BITS > 0 ? n >> CL_CTA_BITS : 1;
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3((unsigned)ctas);
    cfg.blockDim = dim3(CL_THREADS);
    cfg.dynamicSmemBytes = CL_SMEM_BYTES;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)(ctas < CL_MAX_CTAS ? ctas : CL_MAX_CTAS);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
}

// Clusters of n's launch shape that fit on the current device at once
// (cudaOccupancyMaxActiveClusters), found once a process per device and
// cluster size; the first call also lifts the kernel's shared-memory limit.
static cudaError_t cl_fit(long long n, int* clusters) {
    static int cache[16][4] = {};  // device x log2(cluster size): fit + 1
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const long long ctas = n >> CL_CTA_BITS;
    int size_log = 0;
    while (size_log < CL_BLOCK_BITS - CL_CTA_BITS && (2LL << size_log) <= ctas) ++size_log;
    if (dev < 16 && cache[dev][size_log] > 0) {
        *clusters = cache[dev][size_log] - 1;
        return cudaSuccess;
    }
    err = cudaFuncSetAttribute(cluster_stages, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               CL_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cl_config(cfg, attr, n, 0);
    err = cudaOccupancyMaxActiveClusters(clusters, cluster_stages, &cfg);
    if (err == cudaSuccess && dev < 16) cache[dev][size_log] = *clusters + 1;
    return err;
}

static int cl_launch(const void* src, void* dst, long long n, int sort_bits,
                     const StageList& st, int dir_bit, void* stream) {
    int clusters = 0;
    cudaError_t err = cl_fit(n, &clusters);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return SP_ERR_NO_CLUSTER;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cl_config(cfg, attr, n, static_cast<cudaStream_t>(stream));
    err = cudaLaunchKernelEx(&cfg, cluster_stages, static_cast<const int*>(src),
                             static_cast<int*>(dst), n, sort_bits, st, dir_bit);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// Every entry point returns the first cudaError_t of its launches (0 on
// success), or SP_ERR_NO_CLUSTER, and does not synchronise.

extern "C" int sp_cluster_tile_bits(void) { return CL_CTA_BITS; }
extern "C" int sp_cluster_block_bits(void) { return CL_BLOCK_BITS; }

// How many clusters of the launch shape of n keys fit on the current device
// at once, into *clusters.
extern "C" int sp_cluster_occupancy(long long n, int* clusters) {
    if (n < 1 || n > (1LL << 31)) return (int)cudaErrorInvalidValue;
    return (int)cl_fit(n, clusters);
}

// K3: phases 1..min(total_bits, 18) of src[0 .. 2^total_bits) into dst, in
// one cluster launch.
extern "C" int sp_block_sort_cluster(const void* src, void* dst, int total_bits, void* stream) {
    if (total_bits < 1 || total_bits > 31) return (int)cudaErrorInvalidValue;
    StageList st;
    st.n = 0;
    return cl_launch(src, dst, 1LL << total_bits, total_bits, st, -1, stream);
}

// K4's lists: the stages bits[0..n_bits) (stride 2^bits[i] < 2^18) in order
// over src[0..n) (whole 2^18-key blocks) into dst, in one cluster launch;
// dir_bit >= 0: pairs sort descending where that index bit is set, above
// every stride.
extern "C" int sp_run_stages_cluster(const void* src, void* dst, long long n,
                                     const unsigned char* bits, int n_bits, int dir_bit,
                                     void* stream) {
    if (n <= 0 || n > (1LL << 31) || n % (1LL << CL_BLOCK_BITS) != 0 || n_bits < 0 ||
        n_bits > MAX_STAGES || dir_bit > 30)
        return (int)cudaErrorInvalidValue;
    StageList st;
    st.n = n_bits;
    for (int i = 0; i < n_bits; ++i) {
        if (bits[i] >= CL_BLOCK_BITS || (dir_bit >= 0 && bits[i] >= dir_bit))
            return (int)cudaErrorInvalidValue;
        st.sb[i] = bits[i];
    }
    return cl_launch(src, dst, n, 0, st, dir_bit, stream);
}

// K5 and K6 over src[0..n) (whole 2^18-key blocks) into dst: one launch of
// warp_stages, one warp a tile.
template <class S>
static int wr_launch(const void* src, void* dst, long long n, void* stream) {
    constexpr int tile_bits = WR_LANE_LO + WR_LANE_BITS + S::slot_bits;
    if (n <= 0 || n > (1LL << 31) || n % (1LL << CL_BLOCK_BITS) != 0)
        return (int)cudaErrorInvalidValue;
    const long long tiles = n >> tile_bits;
    warp_stages<S><<<(unsigned)((tiles + WR_WARPS - 1) / WR_WARPS), WR_WARPS * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(src), static_cast<int*>(dst), tiles);
    return (int)cudaGetLastError();
}

extern "C" int sp_descent_masked_warp(const void* src, void* dst, long long n, void* stream) {
    return wr_launch<WrK5>(src, dst, n, stream);
}

extern "C" int sp_descent_grid2d_warp(const void* src, void* dst, long long n, void* stream) {
    return wr_launch<WrK6>(src, dst, n, stream);
}

extern "C" int sp_elementwise_chain(const void* src_p, void* dst_p, long long n, int iters,
                                    void* stream_p) {
    if (n <= 0 || n % 4 != 0 || iters < 0) return (int)cudaErrorInvalidValue;
    const long long n4 = n >> 2;
    elementwise_chain<<<(unsigned)((n4 + 255) / 256), 256, 0,
                        static_cast<cudaStream_t>(stream_p)>>>(
        static_cast<const int4*>(src_p), static_cast<int4*>(dst_p), n4, iters);
    return (int)cudaGetLastError();
}

extern "C" int sp_transpose_tiles(const void* src_p, void* dst_p, long long n, int reps,
                                  void* stream_p) {
    if (n <= 0 || n % (TDIM * TDIM) != 0 || reps < 0) return (int)cudaErrorInvalidValue;
    const int smem = TDIM * TPAD * (int)sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(
        transpose_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    transpose_tiles<<<(unsigned)(n / (TDIM * TDIM)), 1024, smem,
                      static_cast<cudaStream_t>(stream_p)>>>(
        static_cast<const int*>(src_p), static_cast<int*>(dst_p), reps);
    return (int)cudaGetLastError();
}

extern "C" const char* sp_error_string(int err) {
    if (err == SP_ERR_NO_CLUSTER)
        return "no cluster of this launch's shape fits on the device "
               "(cudaOccupancyMaxActiveClusters is 0)";
    return cudaGetErrorString((cudaError_t)err);
}
