// Anchor sampling and the anchor join of the homoeologous blocks, on Hopper
// (sm_90a).
//
// Counterparts of two XLA-lowered device programs of the JAX package:
//   ops/anchors.py sampled_anchors            -> kernel A (sample_count_kernel,
//                                                sample_write_kernel)
//   ops/anchors.py _combine_runs + _match_emit -> kernel B (match_scan_kernel,
//                                                match_emit_kernel)
//
// Kernel A. Input: one tile of packed bases, words and validity words int32
// (n_words >= W + 1, W = start words). For every start position it computes
// the canonical and forward k-mer codes as ops/kmer._codes does (k <= 15),
// strand = (canon != fwd), and takes the position where the code is valid and
// (uint32)(canon * 2654435761) < 2^32 / mod. The taken (code, pos, strand)
// are written in the JAX arrays' order, offset-major: flat index
// f = p * W + w for the k-mer at base w * 16 + p; the first `cap` of them,
// then SENTINEL / -1 / 0 pads up to cap, and the count before the cap.
// What bounds it: bytes, the two word arrays read once (8 B a word) and
// 12 B a slot of the outputs written once; about 1/16 of the 16 W positions
// are taken at mod 16.
// Two launches. A block owns a run of `rounds` x A_THREADS words and all 16
// offsets of each; in a round each thread takes one word (a warp reads 128
// contiguous bytes of each array; the next word, the pair's second, comes
// from the same lines), its loads issued a round ahead.
//   sample_count_kernel computes each word's 16 codes in registers, from
//     the word pair reversed once and the valid starts found once
//     (word_takes), and writes each word's take mask (16 bits, 2 B a word)
//     and, per block, the taken k-mers at each offset: a (16, blocks)
//     table, offset-major (a thread counts in 4-bit fields, four offsets an
//     add, emptied into 16 counters every NIB_ROUNDS rounds). Each word is
//     read once and its 16 codes computed once: the codes are the kernel's
//     cost (integer operations, ~10 a k-mer), so the write pass does not
//     compute them again.
//   sample_write_kernel: every block first scans the whole table itself (it
//     is 16 x 512 ints at a 2^23-base tile): thread t reads columns t and
//     t + 256 of the 16 rows, coalesced, and warp reductions give the rows'
//     sums and the sums of each row's entries before the block, so the
//     block's output offset at p, the exclusive prefix at entry
//     p * blocks + b in offset order, is a scan of 16 row sums plus its own
//     prefix. No block waits on another and no scan launch is needed. A
//     block then takes its words' masks round by round, two barriers a
//     round: a ballot a warp and offset ranks each taken k-mer among its
//     warp; every warp reads the warps' counts and scans them over the
//     offsets itself, which gives each offset's run in a shared staging area
//     (A_THREADS x 16 slots: code, and thread | strand << 8); a thread
//     computes the codes of its taken k-mers only (code_at, from the words),
//     and the threads copy the staged runs out, each offset's run to
//     consecutive output slots.
//     After its scan, before its rounds, each block writes its share of the
//     pads from min(count, cap) to cap (trailing pad blocks would each scan
//     the table again for the count); then blocks whose first offset is past
//     the cap return. Block 0 writes the count. The write pass is launched
//     behind the count pass with programmatic stream serialization
//     (launch_after): its blocks are scheduled while the count pass's last
//     blocks run, and wait for its table and masks.
// Runs are A_ROUNDS rounds (1,024 words: 512 blocks at a 2^23-base tile, up
// to four an SM; that ran faster than runs of 2,048 or 4,096 words) unless W
// needs more than A_MAX_BLOCKS blocks; then a block takes more rounds, so
// the table every block scans stays at most 16 x A_MAX_BLOCKS ints.
//
// Kernel B. Inputs: the query anchors' codes, occurrence counts of their code
// in the query, positions and strands (qc, q_occ, qp, qs, n of each), the
// target's anchors sorted by code (tp_s, ts_s) and each query code's run
// [lo, hi) in the sorted target codes. A query anchor is kept when
// 0 < hi - lo <= max_occ, q_occ <= max_occ and qc != SENTINEL (the rule of
// _combine_runs); every kept anchor emits one (qpos, tpos, rel) for each
// target of its run, rel = (qs != ts), in query order and, within a run, in
// sorted-target order: the csum order of _match_emit. Two launches, and the
// host's read of the totals between them to size the outputs.
//   match_scan_kernel, one pass over the query side: a block reads its TILE
//     queries of qc, q_occ, lo and hi once, 16-byte vector loads (VEC
//     queries a thread and round, ROUNDS rounds, all loads issued first),
//     and takes each query's kept run length. The scan counts two things at
//     once, the kept queries and the pairs before each query, packed in one
//     64-bit word (kept << KEPT_SHIFT | pairs; both stay below 2^31, so
//     neither field carries into the other). A thread sums its VEC queries
//     of a round, warps scan the sums by shuffles, and the block's warp
//     totals, round by round, give each query its prefix inside the block.
//     Then a single-pass chained scan with decoupled look-back: thread 0
//     publishes the block's aggregate in its status word (flag
//     FLAG_AGGREGATE in the top two bits, block 0 FLAG_PREFIX at once); warp
//     0 reads the status words of the LOOKBACK blocks before it, one a lane,
//     spinning while any is still 0; it adds the values from the nearest
//     block up to and including the nearest FLAG_PREFIX word, or all of them
//     and steps LOOKBACK blocks back when none is; then publishes the
//     block's inclusive prefix (FLAG_PREFIX). A status word is written and
//     read whole (relaxed 64-bit accesses), so no fence is needed: it
//     carries its flag and its value together. The status words are zeroed
//     by a memset before the launch. Before the look-back each thread stages
//     its kept queries in shared memory at their place in the block's query
//     order: lo, the first output row inside the block, and the position
//     and strand, gathered from qp and qs by asynchronous copies (cp.async)
//     that are in flight while warp 0 looks back. After it the block writes
//     its staged queries out, coalesced, behind the kept queries of the
//     blocks before it: the compact list (k_lo, k_row, k_pos, k_str; 16
//     bytes a kept query). The last block writes the pair total and the
//     kept count.
//   match_emit_kernel reads only the compact list: a warp takes a run of RUN
//     consecutive kept queries, one a lane, and spreads the run's rows over
//     its lanes, 32 x EMIT_ROWS consecutive output rows a step (EMIT_ROWS
//     rows a lane, their gathers in flight together; a run of 32 kept
//     queries has ~33 rows on the blocks path): a lane finds the query of a
//     row by a binary search of the run's first rows in the lanes'
//     registers (shuffles), gathers tp_s and ts_s at lo + (row - first row)
//     and writes the three outputs, coalesced.
// What bounds it: bytes, as chip_smoke.py counts them: the four arrays of the
// keep rule for every query (16 B), the kept queries' positions and strands
// (8 B each), the gathered targets' positions and strands (8 B a pair) and
// the three outputs (12 B a pair): 4 x (4 n + 2 n_kept + 5 n_pairs) bytes.
// Beyond them the compact list is written once and read once (32 B a kept
// query, ~5% of the queries on the blocks path). The gathers read whole
// 32-byte sectors: about one a kept query for each of qp and qs, and one or
// two a kept query for each of tp_s and ts_s, scattered over the target.

// The entry points launch on the caller's stream and return
// cudaGetLastError() of their launches (0 = launched); an_error_string names
// an error.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>
#include <initializer_list>

#include "launch_after.cuh"

namespace {

constexpr int THREADS = 128;                 // kernel B: threads a block (4 warps)
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 4;                       // kernel B: queries a 16-byte load (int4)
constexpr int ROUNDS = 4;                    // kernel B: vector loads a thread and array
constexpr int TILE = THREADS * VEC * ROUNDS; // kernel B: query anchors a block of the scan
constexpr int LOOKBACK = 32;                 // status words a look-back step reads, one a lane
constexpr int KEPT_SHIFT = 31;               // scan word: kept << KEPT_SHIFT | pairs
constexpr int FLAG_SHIFT = 62;               // status word: flag << FLAG_SHIFT | scan word
constexpr int FLAG_AGGREGATE = 1;            // the block's own sum
constexpr int FLAG_PREFIX = 2;               // the sum of every block up to this one
constexpr int RUN = 32;                      // kernel B: kept queries a warp of the emit
constexpr int EMIT_ROWS = 2;                 // kernel B: output rows a lane and step of the emit
static_assert(VEC == 4, "kernel B's scan reads int4 vectors");
constexpr int32_t SENTINEL = 0x7fffffff;
constexpr uint32_t HASH_MUL = 2654435761u;
constexpr int OFFSETS = 16;                  // bases a word: the k-mers starting in it
constexpr int A_THREADS = 256;               // kernel A: words a round, one a thread
constexpr int A_WARPS = A_THREADS / 32;
constexpr int A_ROUNDS = 4;                  // kernel A: the fewest rounds a block
constexpr int A_MAX_BLOCKS = 512;            // kernel A: more rounds a block past this
constexpr int STAGE = A_THREADS * OFFSETS;   // kernel A: staged k-mers a round, at most
constexpr int NIB_ROUNDS = 15;               // kernel A: rounds a 4-bit counter holds
constexpr unsigned FULL = 0xffffffffu;

// The 16 base pairs of x in reverse order: base i at 2-bit slot 15 - i.
__device__ __forceinline__ uint32_t reverse2bits(uint32_t x) {
    x = __brev(x);
    return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// Bit p: bases p .. p + k - 1 all valid (bit i of vv: base i valid), by
// doubling runs, then one overlapping step.
__device__ __forceinline__ uint32_t valid_starts(uint32_t vv, int k) {
    uint32_t run = vv;  // bit p: the len bases from p valid
    int len = 1;
    while (2 * len <= k) {
        run &= run >> len;
        len *= 2;
    }
    return len < k ? run & (run >> (k - len)) : run;
}

// The k-mers taken among those starting in word w (at bases w * 16 + p,
// p < 16), from the words w0 = words[w], w1 = words[w + 1] and their
// validity words: bit p is set where the k-mer is valid and its canonical
// code's hash is at most lim ((canon * HASH_MUL) mod 2^32 < thr = lim + 1;
// none when `any` is false, thr = 0). The codes are computed as
// ops/kmer._codes does, all 16 from the word pair reversed once.
__device__ __forceinline__ uint32_t word_takes(uint32_t w0, uint32_t w1, uint32_t v0, uint32_t v1,
                                               int k, uint32_t lim, bool any) {
    const uint32_t mask = (1u << (2 * k)) - 1;
    // base i of the pair (w1:w0) at 2-bit slot 31 - i; then the forward code
    // at offset p is (x >> (30 - 2p)) & mask
    const uint64_t r = ((uint64_t)reverse2bits(w0) << 32) | reverse2bits(w1);
    const uint64_t x = r >> (34 - 2 * k);
    uint32_t hit = 0;
#pragma unroll
    for (int p = 0; p < OFFSETS; ++p) {
        const uint32_t val = __funnelshift_r(w0, w1, 2 * p);  // base p in the low bits
        const uint32_t fwd = (uint32_t)(x >> (30 - 2 * p)) & mask;
        const uint32_t c = min(fwd, ~val & mask);
        hit |= (uint32_t)(c * HASH_MUL <= lim) << p;
    }
    return any ? hit & valid_starts(v0 | (v1 << 16), k) & 0xffffu : 0u;
}

// The canonical code of the k-mer at offset p of the word pair (w1:w0),
// given the pair reversed (rev, as in word_takes), and its strand.
__device__ __forceinline__ uint32_t code_at(uint32_t w0, uint32_t w1, uint64_t rev, int k, int p,
                                            uint32_t& strand) {
    const uint32_t mask = (1u << (2 * k)) - 1;
    const uint32_t fwd = (uint32_t)(rev >> (64 - 2 * p - 2 * k)) & mask;
    const uint32_t c = min(fwd, ~__funnelshift_r(w0, w1, 2 * p) & mask);
    strand = c != fwd;
    return c;
}

__global__ void __launch_bounds__(A_THREADS)
sample_count_kernel(const int32_t* __restrict__ words, const int32_t* __restrict__ vwords, int k,
                    int W, uint32_t lim, bool any, int rounds, int nb,
                    int32_t* __restrict__ table, uint16_t* __restrict__ masks) {
    __shared__ int part[A_WARPS][OFFSETS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int w = blockIdx.x * rounds * A_THREADS + threadIdx.x;
    int cnt[OFFSETS];
#pragma unroll
    for (int p = 0; p < OFFSETS; ++p) cnt[p] = 0;
    // nibble q of nib[j]: the thread's taken k-mers at offset 4q + j, four
    // counters an add; added into cnt every NIB_ROUNDS rounds, before a
    // nibble can overflow
    uint32_t nib[4] = {0u, 0u, 0u, 0u};
    auto flush = [&]() {
#pragma unroll
        for (int p = 0; p < OFFSETS; ++p) cnt[p] += (nib[p & 3] >> (4 * (p >> 2))) & 15u;
#pragma unroll
        for (int j = 0; j < 4; ++j) nib[j] = 0u;
    };
    uint32_t n0 = 0, n1 = 0, m0 = 0, m1 = 0;  // the next round's words, loaded a round ahead
    if (w < W) {
        n0 = words[w], n1 = words[w + 1], m0 = vwords[w], m1 = vwords[w + 1];
    }
    for (int r = 0; r < rounds && w < W; ++r, w += A_THREADS) {
        const uint32_t w0 = n0, w1 = n1, v0 = m0, v1 = m1;
        if (r + 1 < rounds && w + A_THREADS < W) {
            const int x = w + A_THREADS;
            n0 = words[x], n1 = words[x + 1], m0 = vwords[x], m1 = vwords[x + 1];
        }
        const uint32_t take = word_takes(w0, w1, v0, v1, k, lim, any);
        masks[w] = (uint16_t)take;
#pragma unroll
        for (int j = 0; j < 4; ++j) nib[j] += (take >> j) & 0x1111u;
        if (r % NIB_ROUNDS == NIB_ROUNDS - 1) flush();
    }
    flush();
#pragma unroll
    for (int p = 0; p < OFFSETS; ++p) {
        const int s = __reduce_add_sync(FULL, cnt[p]);
        if (lane == 0) part[warp][p] = s;
    }
    __syncthreads();
    if (threadIdx.x < OFFSETS) {
        int s = 0;
#pragma unroll
        for (int i = 0; i < A_WARPS; ++i) s += part[i][threadIdx.x];
        table[threadIdx.x * nb + blockIdx.x] = s;
    }
}

__global__ void __launch_bounds__(A_THREADS)
sample_write_kernel(const int32_t* __restrict__ words, int k, int W, int rounds, int nb,
                    const int32_t* __restrict__ table, const uint16_t* __restrict__ masks,
                    int32_t* __restrict__ n_total, int cap, int32_t* __restrict__ out_c,
                    int32_t* __restrict__ out_p, int32_t* __restrict__ out_s) {
    __shared__ int s_rows[A_WARPS][OFFSETS];      // a warp's share of the table's row p
    __shared__ int s_pre[A_WARPS][OFFSETS];       // of its entries of blocks before b
    __shared__ int s_off[OFFSETS];                // the block's first output slot at p
    __shared__ int s_total;
    __shared__ int s_wc[A_WARPS][OFFSETS];        // taken a warp and offset, this round
    __shared__ uint32_t s_bal[A_WARPS][OFFSETS];  // the warp's ballot at p, this round
    __shared__ int s_wbase[A_WARPS][OFFSETS];     // staging slot of the warp's first at p
    __shared__ int s_rp[OFFSETS + 1];             // staging slot of the run of p; [16]: all
    __shared__ int s_out[OFFSETS];                // output slot of the run of p
    __shared__ int32_t s_code[STAGE];
    __shared__ uint16_t s_meta[STAGE];            // thread | strand << 8
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.x;
    wait_primary();  // the count pass's table and masks

    // The table's exclusive scan in offset-major order at the entries (p, b):
    // the sums of the rows p' < p and of row p's entries before b. Thread t
    // reads column t (and t + A_THREADS, ...) of all 16 rows, coalesced.
    int row[OFFSETS], pre[OFFSETS];
#pragma unroll
    for (int p = 0; p < OFFSETS; ++p) row[p] = pre[p] = 0;
    for (int c = threadIdx.x; c < nb; c += A_THREADS) {
#pragma unroll
        for (int p = 0; p < OFFSETS; ++p) {
            const int x = table[p * nb + c];
            row[p] += x;
            pre[p] += c < b ? x : 0;
        }
    }
#pragma unroll
    for (int p = 0; p < OFFSETS; ++p) {
        const int rs = __reduce_add_sync(FULL, row[p]), ps = __reduce_add_sync(FULL, pre[p]);
        if (lane == 0) {
            s_rows[warp][p] = rs;
            s_pre[warp][p] = ps;
        }
    }
    __syncthreads();
    if (warp == 0) {  // offset p = lane, lanes 0..15
        int rs = 0, ps = 0;
        if (lane < OFFSETS)
#pragma unroll
            for (int i = 0; i < A_WARPS; ++i) {
                rs += s_rows[i][lane];
                ps += s_pre[i][lane];
            }
        int inc = rs;
#pragma unroll
        for (int o = 1; o < OFFSETS; o <<= 1) {
            const int v = __shfl_up_sync(FULL, inc, o);
            if (lane >= o) inc += v;
        }
        if (lane < OFFSETS) s_off[lane] = inc - rs + ps;
        if (lane == OFFSETS - 1) s_total = inc;
    }
    __syncthreads();
    const int total = s_total;
    if (b == 0 && threadIdx.x == 0) *n_total = total;
    // the pads, from min(count, cap) to cap, shared out over the blocks
    for (int i = min(total, cap) + b * A_THREADS + threadIdx.x; i < cap; i += nb * A_THREADS) {
        out_c[i] = SENTINEL;
        out_p[i] = -1;
        out_s[i] = 0;
    }
    if (s_off[0] >= cap) return;  // every slot of the block lies past the cap

    const unsigned below = (1u << lane) - 1u;
    const int run0 = b * rounds * A_THREADS;
    int done = 0;  // lane p < 16 of warp 0: the block's k-mers at p in earlier rounds
    int w = run0 + threadIdx.x;
    uint32_t nt = 0, n0 = 0, n1 = 0;  // the next round's mask and words, loaded a round ahead
    if (w < W) {
        nt = masks[w], n0 = words[w], n1 = words[w + 1];
    }
    for (int r = 0; r < rounds; ++r, w += A_THREADS) {
        const uint32_t take = nt, w0 = n0, w1 = n1;
        nt = 0;
        if (r + 1 < rounds && w + A_THREADS < W) {
            const int x = w + A_THREADS;
            nt = masks[x], n0 = words[x], n1 = words[x + 1];
        }
#pragma unroll
        for (int p = 0; p < OFFSETS; ++p) {
            const uint32_t bal = __ballot_sync(FULL, (take >> p) & 1u);
            if (lane == p) {
                s_wc[warp][p] = __popc(bal);
                s_bal[warp][p] = bal;
            }
        }
        __syncthreads();
        // every warp: lane p < 16 sums the round's count at p and the counts
        // of the warps before this one; a scan over the lanes gives the
        // staging slot of each offset's run
        int acc = 0, before = 0;
        if (lane < OFFSETS)
#pragma unroll
            for (int i = 0; i < A_WARPS; ++i) {
                const int c = s_wc[i][lane];
                acc += c;
                before += i < warp ? c : 0;
            }
        int inc = acc;
#pragma unroll
        for (int o = 1; o < OFFSETS; o <<= 1) {
            const int v = __shfl_up_sync(FULL, inc, o);
            if (lane >= o) inc += v;
        }
        const int rp = inc - acc;
        if (lane < OFFSETS) s_wbase[warp][lane] = rp + before;
        if (warp == 0 && lane < OFFSETS) {
            s_rp[lane] = rp;
            if (lane == OFFSETS - 1) s_rp[OFFSETS] = inc;
            s_out[lane] = s_off[lane] + done;
            done += acc;
        }
        __syncwarp();
        if (take) {  // the codes of the taken k-mers only
            const uint64_t rev = ((uint64_t)reverse2bits(w0) << 32) | reverse2bits(w1);
            for (uint32_t rest = take; rest; rest &= rest - 1) {
                const int p = __ffs(rest) - 1;
                uint32_t strand;
                const uint32_t c = code_at(w0, w1, rev, k, p, strand);
                const int slot = s_wbase[warp][p] + __popc(s_bal[warp][p] & below);
                s_code[slot] = (int32_t)c;
                s_meta[slot] = (uint16_t)(threadIdx.x | (strand << 8));
            }
        }
        __syncthreads();
        const int staged = s_rp[OFFSETS];
        for (int e = threadIdx.x; e < staged; e += A_THREADS) {
            int p = 0;  // the last offset whose run starts at or before e
#pragma unroll
            for (int step = OFFSETS / 2; step > 0; step >>= 1)
                if (s_rp[p + step] <= e) p += step;
            const int o = s_out[p] + e - s_rp[p];
            if (o < cap) {
                const int meta = s_meta[e];
                out_c[o] = s_code[e];
                out_p[o] = (run0 + r * A_THREADS + (meta & 0xff)) * OFFSETS + p;
                out_s[o] = meta >> 8;
            }
        }
    }
}

using u64 = unsigned long long;
constexpr u64 PAIRS_MASK = (1ull << KEPT_SHIFT) - 1;
constexpr u64 VALUE_MASK = (1ull << FLAG_SHIFT) - 1;

__device__ __forceinline__ u64 load_status(const u64* p) {
    u64 v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_status(u64* p, u64 v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ int get(const int4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// VEC entries of x from i, 0 at n and past it.
__device__ __forceinline__ int4 ragged_load(const int32_t* __restrict__ x, int i, int n) {
    return make_int4(i < n ? x[i] : 0, i + 1 < n ? x[i + 1] : 0, i + 2 < n ? x[i + 2] : 0,
                     i + 3 < n ? x[i + 3] : 0);
}

// The scan word of a query: its kept flag and run length (0 when dropped).
__device__ __forceinline__ u64 scan_word(int32_t c, int32_t occ, int32_t l, int32_t h,
                                         int max_occ) {
    const int run = h - l;
    const bool keep = run > 0 && run <= max_occ && occ <= max_occ && c != SENTINEL;
    return keep ? (1ull << KEPT_SHIFT) | (u64)run : 0ull;
}

__device__ __forceinline__ u64 warp_sum(u64 v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// Warp 0 of block b > 0: the sum of the blocks before b (decoupled
// look-back over their status words); valid in every lane.
__device__ __forceinline__ u64 look_back(const u64* status, int b, int lane) {
    u64 before = 0;
    for (int pos = b - 1;; pos -= LOOKBACK) {
        const int i = pos - lane;  // lane 0: the nearest block
        u64 s;
        while (true) {
            s = i >= 0 ? load_status(status + i) : (u64)FLAG_PREFIX << FLAG_SHIFT;
            if (!__any_sync(FULL, (s >> FLAG_SHIFT) == 0)) break;
            __nanosleep(32);
        }
        const unsigned prefix = __ballot_sync(FULL, (s >> FLAG_SHIFT) == FLAG_PREFIX);
        const int last = prefix ? __ffs(prefix) - 1 : LOOKBACK - 1;  // the lanes to add
        before += warp_sum(lane <= last ? s & VALUE_MASK : 0ull);
        if (prefix) return before;
    }
}

// An asynchronous 4-byte copy from device to shared memory (cp.async): the
// thread goes on while it is in flight.
__device__ __forceinline__ void copy_async(int32_t* dst, const int32_t* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
}

__global__ void __launch_bounds__(THREADS)
match_scan_kernel(const int32_t* __restrict__ qc, const int32_t* __restrict__ q_occ,
                  const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
                  const int32_t* __restrict__ qp, const int32_t* __restrict__ qs, int n,
                  int max_occ, u64* __restrict__ status, int32_t* __restrict__ totals,
                  int32_t* __restrict__ k_lo, int32_t* __restrict__ k_row,
                  int32_t* __restrict__ k_pos, int32_t* __restrict__ k_str) {
    __shared__ u64 s_warp[ROUNDS][WARPS];
    __shared__ u64 s_before;
    // the block's kept queries, in query order: lo, first row inside the
    // block, position, strand
    __shared__ int32_t s_lo[TILE], s_row[TILE], s_pos[TILE], s_str[TILE];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.x;
    int4 c[ROUNDS], o[ROUNDS], l[ROUNDS], h[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {  // every load issued before any is used
        const int i = b * TILE + (r * THREADS + threadIdx.x) * VEC;
        if (i + VEC <= n) {
            c[r] = __ldcs(reinterpret_cast<const int4*>(qc + i));
            o[r] = __ldcs(reinterpret_cast<const int4*>(q_occ + i));
            l[r] = __ldcs(reinterpret_cast<const int4*>(lo + i));
            h[r] = __ldcs(reinterpret_cast<const int4*>(hi + i));
        } else {  // the ragged end: a query past n has an empty run
            c[r] = ragged_load(qc, i, n);
            o[r] = ragged_load(q_occ, i, n);
            l[r] = ragged_load(lo, i, n);
            h[r] = ragged_load(hi, i, n);
        }
    }
    u64 w[ROUNDS][VEC], incl[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        u64 t = 0;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            w[r][j] = scan_word(get(c[r], j), get(o[r], j), get(l[r], j), get(h[r], j),
                                max_occ);
            t += w[r][j];
        }
        incl[r] = t;  // inclusive scan over the warp's lanes
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const u64 v = __shfl_up_sync(FULL, incl[r], d);
            if (lane >= d) incl[r] += v;
        }
        if (lane == 31) s_warp[r][warp] = incl[r];
        incl[r] -= t;  // now exclusive
    }
    __syncthreads();
    u64 agg = 0;  // the block's sum, and each round's warps' sums before this warp
    u64 pre[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        pre[r] = agg;
#pragma unroll
        for (int v = 0; v < WARPS; ++v) {
            pre[r] += v < warp ? s_warp[r][v] : 0ull;
            agg += s_warp[r][v];
        }
    }
    if (threadIdx.x == 0)
        store_status(status + b,
                     (u64)(b == 0 ? FLAG_PREFIX : FLAG_AGGREGATE) << FLAG_SHIFT | agg);
    // Stage the kept queries before the look-back: the gathers of their
    // positions and strands are in flight while it runs.
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const int i = b * TILE + (r * THREADS + threadIdx.x) * VEC;
        u64 at = pre[r] + incl[r];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            if (w[r][j]) {
                const int k = (int)(at >> KEPT_SHIFT);
                s_lo[k] = get(l[r], j);
                s_row[k] = (int)(at & PAIRS_MASK);
                copy_async(s_pos + k, qp + i + j);
                copy_async(s_str + k, qs + i + j);
            }
            at += w[r][j];
        }
    }
    if (warp == 0) {
        const u64 before = b == 0 ? 0ull : look_back(status, b, lane);
        if (lane == 0) {
            if (b > 0) store_status(status + b, (u64)FLAG_PREFIX << FLAG_SHIFT | (before + agg));
            if (b == gridDim.x - 1) {
                totals[0] = (int32_t)((before + agg) & PAIRS_MASK);
                totals[1] = (int32_t)((before + agg) >> KEPT_SHIFT);
            }
            s_before = before;
        }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    // the staged queries out, coalesced, at the kept count before the block
    const u64 before = s_before;
    const int k0 = (int)(before >> KEPT_SHIFT), row0 = (int)(before & PAIRS_MASK);
    for (int k = threadIdx.x; k < (int)(agg >> KEPT_SHIFT); k += THREADS) {
        k_lo[k0 + k] = s_lo[k];
        k_row[k0 + k] = row0 + s_row[k];
        k_pos[k0 + k] = s_pos[k];
        k_str[k0 + k] = s_str[k];
    }
}

__global__ void __launch_bounds__(THREADS)
match_emit_kernel(const int32_t* __restrict__ k_lo, const int32_t* __restrict__ k_row,
                  const int32_t* __restrict__ k_pos, const int32_t* __restrict__ k_str,
                  int n_kept, int n_pairs, const int32_t* __restrict__ tp_s,
                  const int32_t* __restrict__ ts_s, int32_t* __restrict__ out_q,
                  int32_t* __restrict__ out_t, int32_t* __restrict__ out_r) {
    const int lane = threadIdx.x & 31;
    const int first = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * RUN;  // the warp's run
    if (first >= n_kept) return;
    const int k = first + lane;
    const bool has = k < n_kept;
    const int32_t t0 = has ? k_lo[k] : 0;
    const int32_t row = has ? k_row[k] : INT32_MAX;  // never at or below a row
    const int32_t pos = has ? k_pos[k] : 0, strand = has ? k_str[k] : 0;
    const int begin = __shfl_sync(FULL, row, 0);
    const int end = first + RUN < n_kept ? k_row[first + RUN] : n_pairs;
    for (int base = begin; base < end; base += 32 * EMIT_ROWS) {
        int r[EMIT_ROWS], p[EMIT_ROWS], tpos[EMIT_ROWS], tstr[EMIT_ROWS];
#pragma unroll
        for (int e = 0; e < EMIT_ROWS; ++e) {  // the rows' gathers all in flight at once
            r[e] = base + e * 32 + lane;
            p[e] = 0;  // the last lane whose first row is at or before r
#pragma unroll
            for (int step = RUN / 2; step > 0; step >>= 1)
                if (__shfl_sync(FULL, row, p[e] + step) <= r[e]) p[e] += step;
            const int t = __shfl_sync(FULL, t0, p[e]) + r[e] - __shfl_sync(FULL, row, p[e]);
            tpos[e] = r[e] < end ? tp_s[t] : 0;
            tstr[e] = r[e] < end ? ts_s[t] : 0;
        }
#pragma unroll
        for (int e = 0; e < EMIT_ROWS; ++e) {
            const int32_t qpos = __shfl_sync(FULL, pos, p[e]);
            const int32_t qstr = __shfl_sync(FULL, strand, p[e]);
            if (r[e] < end) {
                out_q[r[e]] = qpos;
                out_t[r[e]] = tpos[e];
                out_r[r[e]] = qstr != tstr[e];
            }
        }
    }
}

int scan_blocks(long long n) { return (int)((n + TILE - 1) / TILE); }

// Kernel A's grid: rounds a block and blocks (runs of rounds x A_THREADS words).
void sample_grid(int W, int& rounds, int& nb) {
    const int units = (W + A_THREADS - 1) / A_THREADS;
    rounds = std::max(A_ROUNDS, (units + A_MAX_BLOCKS - 1) / A_MAX_BLOCKS);
    nb = (units + rounds - 1) / rounds;
}

}  // namespace

// Kernel A's scratch, in int32: the (16, blocks) count table of sample_grid's
// blocks, then the words' take masks, uint16.
extern "C" long long an_sample_scratch_size(int W) {
    int rounds, nb;
    sample_grid(W, rounds, nb);
    return (long long)OFFSETS * nb + (W + 1) / 2;
}

// Kernel A. words, vwords int32 (>= W + 1 each); thr = 2^32 / mod; out_c,
// out_p, out_s int32 (cap,); n_total int32 (1,), the count before the cap;
// scratch int32 of an_sample_scratch_size(W). 1 <= k <= 15, 1 <= W,
// 16 W < 2^31, cap >= 1, thr <= 2^32.
extern "C" int an_sampled_anchors(const void* words, const void* vwords, int k, int W,
                                  unsigned long long thr, int cap, void* out_c, void* out_p,
                                  void* out_s, void* n_total, void* scratch,
                                  void* stream_p) {
    if (k < 1 || k > 15 || W < 1 || 16LL * W > 0x7fffffffLL || cap < 1 || thr > (1ULL << 32))
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
    int rounds, nb;
    sample_grid(W, rounds, nb);
    auto* tab = static_cast<int32_t*>(scratch);
    auto* w = static_cast<const int32_t*>(words);
    auto* v = static_cast<const int32_t*>(vwords);
    // hash < thr, as hash <= lim in 32 bits (thr <= 2^32 for mod >= 1)
    const bool any = thr > 0;
    const uint32_t lim = any ? (uint32_t)(thr - 1) : 0u;
    uint16_t* masks = reinterpret_cast<uint16_t*>(tab + OFFSETS * nb);
    sample_count_kernel<<<nb, A_THREADS, 0, stream>>>(w, v, k, W, lim, any, rounds, nb, tab, masks);
    const cudaError_t err = launch_after(
        sample_write_kernel, dim3(nb), dim3(A_THREADS), stream, w, k, W, rounds, nb,
        static_cast<const int32_t*>(tab), static_cast<const uint16_t*>(masks),
        static_cast<int32_t*>(n_total), cap, static_cast<int32_t*>(out_c),
        static_cast<int32_t*>(out_p), static_cast<int32_t*>(out_s));
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Kernel B's scratch, in int32: the scan's status words (u64, one a block),
// then the compact list's four arrays (n each).
extern "C" long long an_match_scratch_size(int n) {
    return 2LL * scan_blocks(n) + 4LL * n;
}

// Kernel B, the scan. qc, q_occ, lo, hi int32 (n,), 16-byte aligned; qp, qs
// int32 (n,); totals int32 (2,): the number of pairs and of kept queries;
// scratch int32 of an_match_scratch_size(n). n >= 1, n x max_occ < 2^31.
extern "C" int an_match_scan(const void* qc, const void* q_occ, const void* lo, const void* hi,
                             const void* qp, const void* qs, int n, int max_occ,
                             void* totals, void* scratch, void* stream_p) {
    if (n < 1 || n > INT32_MAX - TILE || max_occ < 1 ||
        (long long)n * max_occ >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    for (const void* p : {qc, q_occ, lo, hi})
        if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
    const int nb = scan_blocks(n);
    auto* status = static_cast<u64*>(scratch);
    auto* list = static_cast<int32_t*>(scratch) + 2LL * nb;
    const cudaError_t err = cudaMemsetAsync(status, 0, sizeof(u64) * nb, stream);
    if (err != cudaSuccess) return (int)err;
    match_scan_kernel<<<nb, THREADS, 0, stream>>>(
        static_cast<const int32_t*>(qc), static_cast<const int32_t*>(q_occ),
        static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
        static_cast<const int32_t*>(qp), static_cast<const int32_t*>(qs), n, max_occ, status,
        static_cast<int32_t*>(totals), list, list + n, list + 2LL * n, list + 3LL * n);
    return (int)cudaGetLastError();
}

// Kernel B, the emit, after an_match_scan of the same n and scratch, with
// the totals it wrote (n_kept >= 1). tp_s, ts_s int32 (target anchors);
// out_q, out_t, out_r int32 (n_pairs,).
extern "C" int an_match_emit(const void* tp_s, const void* ts_s, int n, const void* scratch,
                             int n_kept, int n_pairs, void* out_q, void* out_t, void* out_r,
                             void* stream_p) {
    if (n < 1 || n_kept < 1 || n_kept > n || n_pairs < n_kept) return (int)cudaErrorInvalidValue;
    const auto* list = static_cast<const int32_t*>(scratch) + 2LL * scan_blocks(n);
    const int blocks = (n_kept + WARPS * RUN - 1) / (WARPS * RUN);
    match_emit_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream_p)>>>(
        list, list + n, list + 2LL * n, list + 3LL * n, n_kept, n_pairs,
        static_cast<const int32_t*>(tp_s), static_cast<const int32_t*>(ts_s),
        static_cast<int32_t*>(out_q), static_cast<int32_t*>(out_t), static_cast<int32_t*>(out_r));
    return (int)cudaGetLastError();
}

extern "C" const char* an_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
