// The two device programs of multi-device phasing, on Hopper (sm_90a).
//
// Counterparts of two XLA-lowered device programs of the JAX package:
//   parallel/sharded_count.py _local_count_and_exchange, the range cuts,
//     sizes, overflow test and slot gather            -> range_slots_kernel
//   parallel/phase_step.py _tile_candidate_counts (searchsorted and gather)
//     and the int32 dot_general with the tiles'
//     chromosome one-hot                              -> cc_bounds_kernel and
//                                                        cc_count_kernel
//
// range_slots. Input: one shard's sorted unique spectrum (codes int32
// ascending, SENTINEL padded; counts int32) of length n, the number of shards
// D, the slot quota and k. Shard d owns the codes [d * 4^k / D, (d + 1) * 4^k
// / D) (integer division, as the JAX package's Python ints). Output: (D,
// quota) send slots, slot d holding shard d's run of the spectrum, codes
// padded with SENTINEL and counts with 0, cut at quota; and overflow = 1 when
// a run is longer than quota. Each block first finds the D + 1 run bounds
// itself (bound 0 is 0, bound i < D the first code >= i * 4^k / D, bound D
// the first code > 4^k - 1: the real entries end there; one binary search a
// thread), then walks the flat slots grid-stride: slot element (d, j) takes
// entry bound[d] + j when j < bound[d + 1] - bound[d]. Block 0 writes the
// overflow flag. What bounds it: bytes, the real entries read once and 8 B a
// slot element written; the D + 1 searches a block are a few microseconds.
//
// candidate_counts. Input: T tiles' sorted unique spectra as (T, N) row-major
// codes and counts (each row as sort_rle gives it), each tile's chromosome
// (-1: a padding tile, which adds nothing), and B candidate codes (SENTINEL:
// no candidate). Output: out (B, C) int32 gets for every candidate b and tile
// t of chromosome c the tile's count of the candidate (0 where the tile lacks
// it) added to out[b, c]: the JAX package's one-hot integer product of the
// per-tile counts. Candidates go in blocks of CC_CANDS, CC_PER consecutive
// ones a thread; a tile holds a block's candidates only inside its segment
// [lo, hi): lo the first entry >= the block's least live candidate, hi the
// first entry > its greatest. Two launches:
//   cc_bounds_kernel: one block of CB_THREADS threads a candidate block
//     reduces the block's least and greatest live candidate, zeroes the
//     block's rows of out, and finds every tile's segment, each bound (lo or
//     hi of one tile) by a (CB_WAYS + 1)-ary search of CB_WAYS lanes, all at
//     once: 10 rounds of dependent loads for a 2^23-entry row, off the count
//     blocks' path. Segments go to scratch, (blocks, T, 2) int64.
//   cc_count_kernel (launched behind it with programmatic stream
//     serialization, launch_after): a block of CC_THREADS threads walks
//     CC_TILES consecutive tiles (blockIdx.y picks the group). Each tile's
//     segment is staged into shared memory, codes and counts, by cp.async
//     copies (16 bytes from the segment's first entry rounded down to 4,
//     where the rows are 16-byte aligned; else 4 bytes) into a ring of
//     CC_SLOTS slots: tiles i + 1 .. i + CC_SLOTS - 1 are in flight while
//     tile i is searched in slot i % CC_SLOTS. A thread searches its first
//     live candidate by halving steps and each later one, when it is
//     greater than the one before (sorted candidates: the path's), by
//     doubling steps from the position before, then halving: a few probes
//     where the next candidate is a few entries on. It reads the count
//     beside a hit. A segment longer than the stage (an unsorted block, a
//     sparse region) is not staged and not cut: its tile is searched in
//     device memory inside the segment. A thread sums each candidate's counts
//     over the group's consecutive tiles of one chromosome and adds the sum
//     with one integer atomic when the chromosome changes and at the end.
//     Integer adds wrap modulo 2^32 whatever their order, as the int32
//     product does, so the result is exact and does not depend on the order
//     of the atomics.
// What bounds it: bytes, a tile's code entry for each candidate (at most the
// row) and the count of each hit, read once. At the path's shapes a row holds
// ~1.6 M entries for 605,002 candidates, so 512 candidates span ~1,340
// entries, and with ~2.8 hits a 32-byte sector every sector of a segment is
// read whatever the method: the staged segments are the bytes it needs.
// CC_PER candidates a thread share the staging, the barriers and the
// searches' first probes.
//
// The entry points launch on the caller's stream and return
// cudaGetLastError() of their launch (0 = launched); pl_error_string names an
// error.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_after.cuh"

namespace {

constexpr int32_t SENTINEL = 0x7fffffff;   // ops/kmer.SENTINEL: sorts after every code
constexpr int RS_THREADS = 256;
constexpr int RS_MAX_BLOCKS = 4096;
constexpr int MAX_SHARDS = 1024;
constexpr int CC_THREADS = 256;           // threads a count block
constexpr int CC_PER = 2;                 // consecutive candidates a thread
constexpr int CC_CANDS = CC_THREADS * CC_PER;  // candidates a block
constexpr int CC_TILES = 8;               // tiles a count block walks
constexpr int CC_STAGE = 2048;            // entries of a staged segment's slot
constexpr int CC_SLOTS = 2;               // staged segments: in flight, and the one searched
constexpr int CC_MIN_BLOCKS = 6;          // count blocks an SM at once, at least (registers)
constexpr int CB_THREADS = 256;           // threads a bounds block
constexpr int CB_PER = CC_CANDS / CB_THREADS;  // candidates a bounds thread reduces
constexpr int CB_WAYS = 4;                // lanes a search: a (CB_WAYS + 1)-ary search
constexpr int CB_SEARCHES = CB_THREADS / CB_WAYS;  // searches a bounds block at once
static_assert(CC_CANDS % CB_THREADS == 0 && CB_PER >= 1 && 32 % CB_WAYS == 0,
              "a bounds thread reduces whole candidates; search groups lie inside warps");

// first index in [lo, hi) with a[i] >= v (hi if none)
__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ a, int64_t lo,
                                               int64_t hi, int32_t v) {
    while (lo < hi) {
        const int64_t mid = lo + ((hi - lo) >> 1);
        if (a[mid] < v) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// first index in [lo, hi) with a[i] > v (hi if none)
__device__ __forceinline__ int64_t upper_bound(const int32_t* __restrict__ a, int64_t lo,
                                               int64_t hi, int32_t v) {
    while (lo < hi) {
        const int64_t mid = lo + ((hi - lo) >> 1);
        if (a[mid] <= v) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__global__ void __launch_bounds__(RS_THREADS)
range_slots_kernel(const int32_t* __restrict__ codes, const int32_t* __restrict__ counts,
                   int64_t n, int n_dev, int64_t quota, int k,
                   int32_t* __restrict__ out_codes, int32_t* __restrict__ out_counts,
                   int32_t* __restrict__ overflow) {
    __shared__ int64_t bound[MAX_SHARDS + 1];
    const int64_t space = int64_t(1) << (2 * k);
    for (int i = threadIdx.x; i <= n_dev; i += RS_THREADS) {
        int64_t b = 0;
        if (i == n_dev) b = upper_bound(codes, 0, n, (int32_t)(space - 1));
        else if (i > 0) b = lower_bound(codes, 0, n, (int32_t)((i * space) / n_dev));
        bound[i] = b;
    }
    __syncthreads();
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        int32_t over = 0;
        for (int d = 0; d < n_dev; ++d) over |= (bound[d + 1] - bound[d] > quota);
        *overflow = over;
    }
    const int64_t total = (int64_t)n_dev * quota;
    for (int64_t e = (int64_t)blockIdx.x * RS_THREADS + threadIdx.x; e < total;
         e += (int64_t)gridDim.x * RS_THREADS) {
        const int d = (int)(e / quota);
        const int64_t j = e - (int64_t)d * quota;
        const int64_t start = bound[d];
        if (j < bound[d + 1] - start) {
            out_codes[e] = codes[start + j];
            out_counts[e] = counts[start + j];
        } else {
            out_codes[e] = SENTINEL;
            out_counts[e] = 0;
        }
    }
}

// first index in [0, len) with a[i] >= v (len if none), by halving steps
// with no branch
__device__ __forceinline__ int lower_bound_stage(const int32_t* a, int len, int32_t v) {
    int pos = 0;
    for (int step = 1 << (31 - __clz(max(len, 1))); step > 0; step >>= 1)
        if (pos + step <= len && a[pos + step - 1] < v) pos += step;
    return pos;
}

// first index in [0, len) with a[i] >= v, given a[i] < v for i < p: doubling
// steps from p, then halving
__device__ __forceinline__ int lower_bound_after(const int32_t* a, int len, int p, int32_t v) {
    int step = 1;
    while (p + step <= len && a[p + step - 1] < v) {
        p += step;
        step <<= 1;
    }
    for (step >>= 1; step > 0; step >>= 1)
        if (p + step <= len && a[p + step - 1] < v) p += step;
    return p;
}

// 16-byte asynchronous copy global -> shared (cp.async, L2 only)
__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

// 4-byte asynchronous copy global -> shared (cp.async, L1-cached)
__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// waits until at most CC_SLOTS - 1 groups of this thread's copies are in flight
__device__ __forceinline__ void cp_async_wait_slots() {
    asm volatile("cp.async.wait_group %0;" ::"n"(CC_SLOTS - 1) : "memory");
}

// The first index in [0, n) of row whose entry is not below v (upper: not
// at or below v), by CB_WAYS lanes of a warp together (lane k of the group,
// live: the group has a search): each round probes CB_WAYS positions that
// cut the range into CB_WAYS + 1 parts and keeps the part where the
// predicate turns, so 2^23 entries take 10 rounds of dependent loads, not 23.
// Every lane of the warp runs every round (ballots).
__device__ __forceinline__ int64_t search_ways(const int32_t* __restrict__ row, int64_t n,
                                               int32_t v, bool upper, bool live, int k) {
    int64_t lo = 0, hi = live ? n : 0;
    const int shift = (threadIdx.x & 31) / CB_WAYS * CB_WAYS;
    while (__any_sync(0xffffffffu, hi > lo)) {
        const int64_t len = hi - lo;
        int64_t pos = lo + k;
        if (len > CB_WAYS) pos = lo + len * (k + 1) / (CB_WAYS + 1);
        const bool probe = len > CB_WAYS || k < len;
        bool pred = false;
        if (probe) {
            const int32_t x = row[pos];
            pred = upper ? x <= v : x < v;
        }
        const unsigned bits = (__ballot_sync(0xffffffffu, probe && pred) >> shift) &
                              ((1u << CB_WAYS) - 1);
        const int c = __popc(bits);  // probes below the turn (the predicate is monotone)
        if (len > CB_WAYS) {
            const int64_t nlo = c > 0 ? lo + len * c / (CB_WAYS + 1) + 1 : lo;
            hi = c < CB_WAYS ? lo + len * (c + 1) / (CB_WAYS + 1) : hi;
            lo = nlo;
        } else if (len > 0) {
            lo += c;
            hi = lo;
        }
    }
    return lo;
}

__global__ void __launch_bounds__(CB_THREADS)
cc_bounds_kernel(const int32_t* __restrict__ codes, int64_t n,
                 const int32_t* __restrict__ tile_chrom, int n_tiles,
                 const int32_t* __restrict__ cand, int64_t n_cand, int n_chrom,
                 int64_t* __restrict__ seg, uint32_t* __restrict__ out) {
    __shared__ int32_t warp_min[CB_THREADS / 32], warp_max[CB_THREADS / 32];
    const int64_t b0 = (int64_t)blockIdx.x * CC_CANDS;
    int32_t mn = INT32_MAX, mx = INT32_MIN;
    for (int r = 0; r < CB_PER; ++r) {
        const int64_t b = b0 + r * CB_THREADS + threadIdx.x;
        const int32_t c = b < n_cand ? cand[b] : SENTINEL;
        if (c != SENTINEL) {
            mn = min(mn, c);
            mx = max(mx, c);
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
        mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if ((threadIdx.x & 31) == 0) {
        warp_min[threadIdx.x >> 5] = mn;
        warp_max[threadIdx.x >> 5] = mx;
    }
    __syncthreads();
    for (int w = 0; w < CB_THREADS / 32; ++w) {
        mn = min(mn, warp_min[w]);
        mx = max(mx, warp_max[w]);
    }
    if (blockIdx.y == 0) {                 // the block's rows of out
        const int64_t e0 = b0 * n_chrom;
        const int64_t e1 = min(b0 + CC_CANDS, n_cand) * n_chrom;
        for (int64_t e = e0 + threadIdx.x; e < e1; e += CB_THREADS) out[e] = 0u;
    }
    // search q: tile q / 2, lo (even) or hi (odd); CB_SEARCHES at once, all
    // lanes of a warp in every round of the loop
    const int k = threadIdx.x % CB_WAYS;
    for (int q0 = blockIdx.y * CB_SEARCHES; q0 < 2 * n_tiles; q0 += gridDim.y * CB_SEARCHES) {
        const int q = q0 + threadIdx.x / CB_WAYS;
        const int t = min(q, 2 * n_tiles - 1) >> 1;
        const bool live = q < 2 * n_tiles && mn <= mx && tile_chrom[t] >= 0;
        // 0 for no live candidate or a padding tile
        const int64_t v = search_ways(codes + (int64_t)t * n, n, (q & 1) ? mx : mn, q & 1,
                                      live, k);
        if (q < 2 * n_tiles && k == 0) seg[((int64_t)blockIdx.x * n_tiles + t) * 2 + (q & 1)] = v;
    }
}

__global__ void __launch_bounds__(CC_THREADS, CC_MIN_BLOCKS)
cc_count_kernel(const int32_t* __restrict__ codes, const int32_t* __restrict__ counts,
                int64_t n, const int32_t* __restrict__ tile_chrom, int n_tiles,
                const int32_t* __restrict__ cand, int64_t n_cand, int n_chrom,
                const int64_t* __restrict__ seg, bool vec, uint32_t* __restrict__ out) {
    __shared__ __align__(16) int32_t s_codes[CC_SLOTS][CC_STAGE];
    __shared__ __align__(16) int32_t s_counts[CC_SLOTS][CC_STAGE];
    __shared__ int64_t s_lo[CC_TILES], s_hi[CC_TILES];
    __shared__ int32_t s_chrom[CC_TILES];
    const int64_t b0 = (int64_t)blockIdx.x * CC_CANDS + threadIdx.x * CC_PER;  // this thread's
    int32_t c[CC_PER];
    bool any = false;
#pragma unroll
    for (int r = 0; r < CC_PER; ++r) {  // the bounds kernel writes no candidate
        c[r] = b0 + r < n_cand ? cand[b0 + r] : SENTINEL;
        any |= c[r] != SENTINEL;
    }
    wait_primary();                        // the segments, and out zeroed
    if (!__syncthreads_or(any)) return;    // no live candidate: the whole block leaves
    const int t0 = blockIdx.y * CC_TILES;
    const int nt = min(CC_TILES, n_tiles - t0);
    if (threadIdx.x < nt) {
        const int64_t* sg = seg + ((int64_t)blockIdx.x * n_tiles + t0 + threadIdx.x) * 2;
        s_lo[threadIdx.x] = sg[0];
        s_hi[threadIdx.x] = sg[1];
        s_chrom[threadIdx.x] = tile_chrom[t0 + threadIdx.x];
    }
    __syncthreads();
    // a segment is staged from its first entry rounded down to 4 (vec), or
    // from the entry itself; staged when it fits the slot so
    auto staged = [&](int i) { return s_hi[i] - s_lo[i] <= CC_STAGE - 3; };
    auto start = [&](int i) { return vec ? s_lo[i] & ~(int64_t)3 : s_lo[i]; };
    // tile i's segment into slot i % CC_SLOTS (nothing for a padding tile, a
    // segment beyond the slot or i past the group), one commit group a tile
    auto stage = [&](int i) {
        if (i < nt && s_chrom[i] >= 0 && staged(i)) {
            const int64_t from = start(i);
            const int words = (int)(s_hi[i] - from);
            const int64_t base = (int64_t)(t0 + i) * n + from;
            int32_t* dc = s_codes[i % CC_SLOTS];
            int32_t* dn = s_counts[i % CC_SLOTS];
            if (vec) {
                for (int j = 4 * threadIdx.x; j < words; j += 4 * CC_THREADS) {
                    cp_async16(dc + j, codes + base + j);
                    cp_async16(dn + j, counts + base + j);
                }
            } else {
                for (int j = threadIdx.x; j < words; j += CC_THREADS) {
                    cp_async4(dc + j, codes + base + j);
                    cp_async4(dn + j, counts + base + j);
                }
            }
        }
        cp_async_commit();
    };
    for (int i = 0; i < CC_SLOTS - 1; ++i) stage(i);
    int cur = -1;
    uint32_t acc[CC_PER] = {};
    for (int i = 0; i < nt; ++i) {
        stage(i + CC_SLOTS - 1);           // CC_SLOTS - 1 tiles ahead
        cp_async_wait_slots();             // this thread's copies of tile i have landed
        __syncthreads();                   // and every thread's
        const int ch = s_chrom[i];
        if (any && ch >= 0) {
            const int64_t lo = s_lo[i], hi = s_hi[i];
            uint32_t v[CC_PER] = {};
            if (staged(i)) {
                const int len = (int)(hi - lo), off = (int)(lo - start(i));
                const int32_t* sc = s_codes[i % CC_SLOTS] + off;
                const int32_t* sn = s_counts[i % CC_SLOTS] + off;
                int p = -1;                // position of the last live candidate
                int32_t prev = 0;
#pragma unroll
                for (int r = 0; r < CC_PER; ++r) {
                    if (c[r] == SENTINEL) continue;
                    p = (p >= 0 && c[r] > prev) ? lower_bound_after(sc, len, p, c[r])
                                                : lower_bound_stage(sc, len, c[r]);
                    prev = c[r];
                    if (p < len && sc[p] == c[r]) v[r] = (uint32_t)sn[p];
                }
            } else {                       // a segment beyond the slot: device memory
                const int32_t* row = codes + (int64_t)(t0 + i) * n;
#pragma unroll
                for (int r = 0; r < CC_PER; ++r) {
                    if (c[r] == SENTINEL) continue;
                    const int64_t j = lower_bound(row, lo, hi, c[r]);
                    if (j < hi && row[j] == c[r])
                        v[r] = (uint32_t)counts[(int64_t)(t0 + i) * n + j];
                }
            }
            if (ch != cur) {
#pragma unroll
                for (int r = 0; r < CC_PER; ++r) {
                    if (cur >= 0 && acc[r]) atomicAdd(out + (b0 + r) * n_chrom + cur, acc[r]);
                    acc[r] = 0;
                }
                cur = ch;
            }
#pragma unroll
            for (int r = 0; r < CC_PER; ++r) acc[r] += v[r];
        }
        __syncthreads();                   // slot i % CC_SLOTS is staged again next
    }
    if (cur >= 0) {
#pragma unroll
        for (int r = 0; r < CC_PER; ++r)
            if (acc[r]) atomicAdd(out + (b0 + r) * n_chrom + cur, acc[r]);
    }
}

}  // namespace

// codes, counts: (n,) int32; out_codes, out_counts: (n_dev * quota,) int32;
// overflow: (1,) int32; all on the card. n >= 1, 1 <= n_dev <= 1024,
// quota >= 1, 1 <= k <= 15.
extern "C" int pl_range_slots(const void* codes, const void* counts, long long n, int n_dev,
                              long long quota, int k, void* out_codes, void* out_counts,
                              void* overflow, void* stream_p) {
    if (n < 1 || n_dev < 1 || n_dev > MAX_SHARDS || quota < 1 || k < 1 || k > 15)
        return (int)cudaErrorInvalidValue;
    const long long total = (long long)n_dev * quota;
    long long blocks = (total + RS_THREADS - 1) / RS_THREADS;
    if (blocks > RS_MAX_BLOCKS) blocks = RS_MAX_BLOCKS;
    range_slots_kernel<<<(unsigned)blocks, RS_THREADS, 0, static_cast<cudaStream_t>(stream_p)>>>(
        static_cast<const int32_t*>(codes), static_cast<const int32_t*>(counts), (int64_t)n,
        n_dev, (int64_t)quota, k, static_cast<int32_t*>(out_codes),
        static_cast<int32_t*>(out_counts), static_cast<int32_t*>(overflow));
    return (int)cudaGetLastError();
}

static long long cc_blocks(long long n_cand) { return (n_cand + CC_CANDS - 1) / CC_CANDS; }

// int64 elements of candidate_counts' scratch (each candidate block's
// segment of each tile).
extern "C" long long pl_candidate_counts_scratch(long long n_cand, int n_tiles) {
    return cc_blocks(n_cand) * n_tiles * 2;
}

// codes, counts: (n_tiles, n) int32; tile_chrom: (n_tiles,) int32 in
// [-1, n_chrom); cand: (n_cand,) int32; scratch: pl_candidate_counts_scratch
// int64; out: (n_cand, n_chrom) int32 (the bounds kernel zeroes it); all on
// the card. n >= 1, n_tiles >= 1, n_cand >= 1, n_chrom >= 1. Two launches.
extern "C" int pl_candidate_counts(const void* codes, const void* counts, long long n,
                                   const void* tile_chrom, int n_tiles, const void* cand,
                                   long long n_cand, int n_chrom, void* scratch, void* out,
                                   void* stream_p) {
    if (n < 1 || n_tiles < 1 || n_cand < 1 || n_chrom < 1) return (int)cudaErrorInvalidValue;
    const long long gx = cc_blocks(n_cand);
    const long long gy_bounds = (2LL * n_tiles + CB_SEARCHES - 1) / CB_SEARCHES;
    const long long gy = (n_tiles + CC_TILES - 1) / CC_TILES;
    if (gx > 0x7fffffffLL || gy_bounds > 65535 || gy > 65535) return (int)cudaErrorInvalidValue;
    const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(counts) % 16 == 0;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
    const int32_t* c32 = static_cast<const int32_t*>(codes);
    const int32_t* chrom = static_cast<const int32_t*>(tile_chrom);
    const int32_t* cd = static_cast<const int32_t*>(cand);
    int64_t* seg = static_cast<int64_t*>(scratch);
    uint32_t* o = static_cast<uint32_t*>(out);
    cc_bounds_kernel<<<dim3((unsigned)gx, (unsigned)gy_bounds), CB_THREADS, 0, stream>>>(
        c32, (int64_t)n, chrom, n_tiles, cd, (int64_t)n_cand, n_chrom, seg, o);
    const cudaError_t err = launch_after(
        cc_count_kernel, dim3((unsigned)gx, (unsigned)gy), dim3(CC_THREADS), stream, c32,
        static_cast<const int32_t*>(counts), (int64_t)n, chrom, n_tiles, cd, (int64_t)n_cand,
        n_chrom, static_cast<const int64_t*>(seg), vec, o);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

extern "C" const char* pl_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
