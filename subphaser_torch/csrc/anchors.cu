// Anchor sampling and the anchor join of the homoeologous blocks, on Hopper
// (sm_90a).
//
// Counterparts of two XLA-lowered device programs of the JAX package:
//   ops/anchors.py sampled_anchors            -> kernel A (sample_count_kernel,
//                                                sample_write_kernel)
//   ops/anchors.py _combine_runs + _match_emit -> kernel B (match_count_kernel,
//                                                scan_kernel, match_emit_kernel)
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
// sorted-target order: the csum order of _match_emit. Count pass (kept run
// length summed a block), the same scan, then the emit pass: a block
// exclusive scan of the run lengths (warp shuffles and the warp totals)
// gives each query anchor its first output row. The host reads the total
// between the scan and the emit pass to size the outputs.
// What bounds it: bytes. It reads 24 B a query anchor (and lo, hi, qc, q_occ
// again in the emit pass) and writes 12 B a pair; the target reads are
// gathers of at most max_occ consecutive entries.
//
// The entry points launch on the caller's stream and return
// cudaGetLastError() of their launches (0 = launched); an_error_string names
// an error.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "launch_after.cuh"

namespace {

constexpr int THREADS = 256;                 // kernel B: threads a block (8 warps)
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 8;                    // kernel B: rounds a block
constexpr int TILE = THREADS * ROUNDS;       // kernel B: query anchors a block
constexpr int SCAN_THREADS = 1024;           // the one block of scan_kernel
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

// Sum of v over the block; the result is valid in thread 0.
__device__ __forceinline__ int block_sum(int v, int* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    int t = 0;
    if (threadIdx.x == 0)
        for (int i = 0; i < WARPS; ++i) t += red[i];
    return t;
}

// counts[0, nb) -> their exclusive prefix sums, in place; counts[nb] = total.
// One block: thread t scans its chunk of ceil(nb / SCAN_THREADS) serially.
__global__ void __launch_bounds__(SCAN_THREADS) scan_kernel(int32_t* __restrict__ counts, int nb) {
    __shared__ int sums[SCAN_THREADS];
    const int chunk = (nb + SCAN_THREADS - 1) / SCAN_THREADS;
    const int lo = threadIdx.x * chunk, hi = min(lo + chunk, nb);
    int s = 0;
    for (int i = lo; i < hi; ++i) s += counts[i];
    sums[threadIdx.x] = s;
    __syncthreads();
    for (int o = 1; o < SCAN_THREADS; o <<= 1) {  // Hillis-Steele, inclusive
        const int add = threadIdx.x >= o ? sums[threadIdx.x - o] : 0;
        __syncthreads();
        sums[threadIdx.x] += add;
        __syncthreads();
    }
    int run = sums[threadIdx.x] - s;
    for (int i = lo; i < hi; ++i) {
        const int c = counts[i];
        counts[i] = run;
        run += c;
    }
    if (threadIdx.x == SCAN_THREADS - 1) counts[nb] = sums[SCAN_THREADS - 1];
}

// Kept run length of query anchor i (0 when it is dropped).
__device__ __forceinline__ int kept_run(const int32_t* __restrict__ qc,
                                        const int32_t* __restrict__ q_occ,
                                        const int32_t* __restrict__ lo,
                                        const int32_t* __restrict__ hi, int i, int max_occ) {
    const int run = hi[i] - lo[i];
    const bool keep = run > 0 && run <= max_occ && q_occ[i] <= max_occ && qc[i] != SENTINEL;
    return keep ? run : 0;
}

__global__ void __launch_bounds__(THREADS)
match_count_kernel(const int32_t* __restrict__ qc, const int32_t* __restrict__ q_occ,
                   const int32_t* __restrict__ lo, const int32_t* __restrict__ hi, int n,
                   int max_occ, int32_t* __restrict__ counts) {
    __shared__ int red[WARPS];
    const int base = blockIdx.x * TILE + threadIdx.x;
    int c = 0;
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const int i = base + r * THREADS;
        if (i < n) c += kept_run(qc, q_occ, lo, hi, i, max_occ);
    }
    c = block_sum(c, red);
    if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

__global__ void __launch_bounds__(THREADS)
match_emit_kernel(const int32_t* __restrict__ qc, const int32_t* __restrict__ q_occ,
                  const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
                  const int32_t* __restrict__ qp, const int32_t* __restrict__ qs,
                  const int32_t* __restrict__ tp_s, const int32_t* __restrict__ ts_s, int n,
                  int max_occ, const int32_t* __restrict__ offsets,
                  int32_t* __restrict__ out_q, int32_t* __restrict__ out_t,
                  int32_t* __restrict__ out_r) {
    __shared__ int warp_totals[WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int base = blockIdx.x * TILE + threadIdx.x;
    int running = offsets[blockIdx.x];
    for (int r = 0; r < ROUNDS; ++r) {
        const int i = base + r * THREADS;
        const int len = i < n ? kept_run(qc, q_occ, lo, hi, i, max_occ) : 0;
        int incl = len;  // inclusive scan over the warp
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += v;
        }
        if (lane == 31) warp_totals[warp] = incl;
        __syncthreads();
        int before = 0, total = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            before += w < warp ? warp_totals[w] : 0;
            total += warp_totals[w];
        }
        if (len > 0) {
            const int row = running + before + incl - len;
            const int32_t q = qp[i], s = qs[i], t0 = lo[i];
            for (int j = 0; j < len; ++j) {
                out_q[row + j] = q;
                out_t[row + j] = tp_s[t0 + j];
                out_r[row + j] = s != ts_s[t0 + j];
            }
        }
        running += total;
        __syncthreads();  // warp_totals is rewritten next round
    }
}

int blocks_for(long long n) { return (int)((n + TILE - 1) / TILE); }

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

// Kernel B, count pass and scan. qc, q_occ, lo, hi int32 (n,); counts int32
// (blocks + 1) scratch, counts[blocks] = the number of pairs. n >= 1.
extern "C" int an_match_count(const void* qc, const void* q_occ, const void* lo, const void* hi,
                              int n, int max_occ, void* counts, void* stream_p) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
    const int nb = blocks_for(n);
    auto* cnt = static_cast<int32_t*>(counts);
    match_count_kernel<<<nb, THREADS, 0, stream>>>(
        static_cast<const int32_t*>(qc), static_cast<const int32_t*>(q_occ),
        static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi), n, max_occ, cnt);
    scan_kernel<<<1, SCAN_THREADS, 0, stream>>>(cnt, nb);
    return (int)cudaGetLastError();
}

// Kernel B, emit pass, after an_match_count on the same inputs and counts.
// qp, qs int32 (n,); tp_s, ts_s int32 (target anchors); out_q, out_t, out_r
// int32 (counts[blocks],).
extern "C" int an_match_emit(const void* qc, const void* q_occ, const void* lo, const void* hi,
                             const void* qp, const void* qs, const void* tp_s, const void* ts_s,
                             int n, int max_occ, const void* counts, void* out_q, void* out_t,
                             void* out_r, void* stream_p) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    match_emit_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream_p)>>>(
        static_cast<const int32_t*>(qc), static_cast<const int32_t*>(q_occ),
        static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
        static_cast<const int32_t*>(qp), static_cast<const int32_t*>(qs),
        static_cast<const int32_t*>(tp_s), static_cast<const int32_t*>(ts_s), n, max_occ,
        static_cast<const int32_t*>(counts), static_cast<int32_t*>(out_q),
        static_cast<int32_t*>(out_t), static_cast<int32_t*>(out_r));
    return (int)cudaGetLastError();
}

extern "C" const char* an_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
