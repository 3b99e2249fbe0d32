// Least-significant-digit radix sort of a power-of-two int32 array on Hopper
// (sm_90a).
//
// Replaces, on the port's counting and mapping paths, the JAX package's
// Pallas VMEM bitonic sort (ops/sort_vmem.py: K1 `_block_sort_kernel_grid`
// and K2 `_descent_kernel` behind `vmem_sort`). It computes the same
// function: an ascending sort of n = 2^t int32 keys, any values, SENTINEL
// (INT32_MAX) padding trailing. The block-structured counterpart of K1/K2
// stays in bitonic_sort.cu.
//
// What bounds it: bytes. The function's own bound is 8n bytes (read 4n,
// write 4n). A comparison network pays log^2 n stages and this card has no
// memory large enough to hide them: the bitonic kernel moves the array
// ~120 times at n = 2^27. A radix sort with 8-bit digits is 4 passes,
// each reading the keys twice and writing them once: 48n bytes, the
// design's floor, plus a histogram table of 256 x n/TILE counters per pass
// (3% of the keys at TILE = 2^13).
//
// One pass, out of place (src is never written), keys in tiles of TILE:
//   radix_hist     one block per tile: the tile's 256 digit counts in
//                  shared memory (a warp whose 32 digits are equal adds 32
//                  once, any other warp one atomic per key), written
//                  digit-major: hist[digit * ntiles + tile].
//   radix_scan     one block per digit: exclusive scan of the digit's row
//                  over tiles (in place) and the digit's total.
//   radix_scatter  one block per tile: stable rank of every key among the
//                  tile's keys of its digit, the tile reordered by digit in
//                  shared memory, then runs of equal digit written to
//                  base[digit] + row_scan[digit][tile] + i, neighbouring
//                  threads on neighbouring addresses. base is the exclusive
//                  scan of the 256 totals, redone in each block's prologue.
//
// Stability (what makes LSD right): a tile's keys go to warps and lanes in
// index order (warp w takes keys w*512 .. w*512+511, round r of it the 32
// keys from r*32, lane l the l-th), a key's rank is (keys of its digit in
// earlier warps) + (in earlier rounds of its warp) + (in lower lanes of
// its round), and tiles are scanned in index order.
//
// Skew (nearly all keys SENTINEL on the mapping path): a warp's 32 equal
// digits cost one counter update, not 32 conflicting atomics, and the
// scatter's output is then one long run. The other way round, the cost of
// __match_any_sync grows with the number of distinct digits in the warp
// (on keys whose digits all differ it doubled radix_scatter's time and
// quadrupled radix_hist's), so radix_hist counts with plain shared-memory
// atomics and radix_scatter finds a lane's peers by what the warp holds
// (peers_of).
//
// The digit of a key is taken from key ^ 0x80000000, so the top pass orders
// negatives first. Counts and offsets are unsigned 32-bit (n <= 2^31),
// addresses 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_BITS 13
#define TILE (1 << TILE_BITS)
#define THREADS 512
#define WARPS (THREADS / 32)
#define ROUNDS (TILE / THREADS)  // keys per thread
#define RADIX 256
#define SCAN_THREADS 1024
#define SCATTER_MIN_BLOCKS 2  // blocks of radix_scatter per SM the register budget allows
#define FULL 0xffffffffu

typedef unsigned int u32;

__device__ __forceinline__ u32 digit_of(int key, int shift) {
    return (((u32)key ^ 0x80000000u) >> shift) & (RADIX - 1);
}

#define MATCH_MIN_LIKE_FIRST 24  // lanes like lane 0 from which a warp has few distinct digits

// The lanes of the warp whose digit equals this lane's; every lane of the
// warp calls it. All digits equal: no search. Nearly all equal:
// __match_any_sync, whose cost grows with the number of distinct digits.
// Otherwise every lane ORs its bit into its digit's word of `masks` (the
// warp's 256 words of shared memory, zero on entry and again after the
// caller's next __syncwarp).
__device__ __forceinline__ u32 peers_of(u32 d, u32* masks, int lane) {
    const u32 like_first = __ballot_sync(FULL, d == __shfl_sync(FULL, d, 0));
    if (like_first == FULL) return FULL;
    if (__popc(like_first) >= MATCH_MIN_LIKE_FIRST) return __match_any_sync(FULL, d);
    atomicOr(&masks[d], 1u << lane);
    __syncwarp();
    const u32 peers = masks[d];
    __syncwarp();
    if (lane == __ffs(peers) - 1) masks[d] = 0;
    return peers;
}

// Exclusive scan of one value per thread over the block (blockDim.x a
// multiple of 32, at most 1024); `total` gets the block's sum. `ws` is 33
// words of shared memory, free again on return.
__device__ __forceinline__ u32 block_exclusive_scan(u32 v, u32* ws, u32* total) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    u32 incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const u32 t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
    }
    if (lane == 31) ws[w] = incl;
    __syncthreads();
    if (w == 0) {
        const u32 s = lane < (int)(blockDim.x >> 5) ? ws[lane] : 0;
        u32 si = s;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const u32 t = __shfl_up_sync(FULL, si, o);
            if (lane >= o) si += t;
        }
        ws[lane] = si - s;
        if (lane == 31) ws[32] = si;
    }
    __syncthreads();
    const u32 res = ws[w] + incl - v;
    *total = ws[32];
    __syncthreads();
    return res;
}

__global__ void __launch_bounds__(THREADS)
radix_hist(const int* __restrict__ src, u32* __restrict__ hist, u32 ntiles, int shift) {
    __shared__ u32 cnt[RADIX];
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < RADIX) cnt[threadIdx.x] = 0;
    __syncthreads();
    const int4* tile = reinterpret_cast<const int4*>(src + (size_t)blockIdx.x * TILE);
    int4 v[ROUNDS / 4];
#pragma unroll
    for (int r = 0; r < ROUNDS / 4; ++r) v[r] = tile[r * THREADS + threadIdx.x];
#pragma unroll
    for (int r = 0; r < ROUNDS / 4; ++r) {
        const int k[4] = {v[r].x, v[r].y, v[r].z, v[r].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const u32 d = digit_of(k[j], shift);
            if (__all_sync(FULL, d == __shfl_sync(FULL, d, 0))) {
                if (lane == 0) atomicAdd(&cnt[d], 32);
            } else {
                atomicAdd(&cnt[d], 1);
            }
        }
    }
    __syncthreads();
    if (threadIdx.x < RADIX)
        hist[(size_t)threadIdx.x * ntiles + blockIdx.x] = cnt[threadIdx.x];
}

__global__ void __launch_bounds__(SCAN_THREADS)
radix_scan(u32* __restrict__ hist, u32* __restrict__ totals, u32 ntiles) {
    __shared__ u32 ws[33];
    u32* row = hist + (size_t)blockIdx.x * ntiles;
    u32 carry = 0;
    for (u32 start = 0; start < ntiles; start += SCAN_THREADS) {
        const u32 i = start + threadIdx.x;
        const u32 v = i < ntiles ? row[i] : 0;
        u32 total;
        const u32 ex = block_exclusive_scan(v, ws, &total);
        if (i < ntiles) row[i] = carry + ex;
        carry += total;
    }
    if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(THREADS, SCATTER_MIN_BLOCKS)
radix_scatter(const int* __restrict__ src, int* __restrict__ dst,
              const u32* __restrict__ row_scan, const u32* __restrict__ totals,
              u32 ntiles, int shift) {
    __shared__ int keys[TILE];                     // the tile ordered by digit
    __shared__ unsigned short warp_cnt[WARPS][RADIX];  // per warp: count, then offset
    __shared__ u32 tile_start[RADIX];              // first slot of a digit in `keys`
    __shared__ u32 dst_off[RADIX];                 // global index of slot 0 of a digit's run, minus tile_start
    __shared__ u32 ws[33];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const u32 lanes_below = (1u << lane) - 1;

    for (int i = tid; i < WARPS * RADIX; i += THREADS) (&warp_cnt[0][0])[i] = 0;
    // peers_of's table, 256 words per warp, in the space `keys` needs later
    u32* masks = reinterpret_cast<u32*>(keys) + w * RADIX;
    for (int i = tid; i < WARPS * RADIX; i += THREADS) reinterpret_cast<u32*>(keys)[i] = 0;
    const int* tile = src + (size_t)blockIdx.x * TILE + w * (32 * ROUNDS) + lane;
    int key[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) key[r] = tile[r * 32];
    // every block redoes the exclusive scan of the 256 digit totals
    u32 unused;
    const u32 base = block_exclusive_scan(tid < RADIX ? totals[tid] : 0, ws, &unused);
    // (the scan's barriers also publish the zeroed warp_cnt and masks)

    // rank among the warp's keys of the same digit, in index order
    unsigned short rank[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const u32 d = digit_of(key[r], shift);
        const u32 peers = peers_of(d, masks, lane);
        const int leader = __ffs(peers) - 1;
        u32 before = 0;
        if (lane == leader) {
            before = warp_cnt[w][d];
            warp_cnt[w][d] = (unsigned short)(before + __popc(peers));
        }
        before = __shfl_sync(FULL, before, leader);
        rank[r] = (unsigned short)(before + __popc(peers & lanes_below));
        __syncwarp();
    }
    __syncthreads();

    // thread d: warp counts of digit d -> exclusive offsets over warps
    u32 mine = 0;
    if (tid < RADIX) {
#pragma unroll
        for (int ww = 0; ww < WARPS; ++ww) {
            const u32 c = warp_cnt[ww][tid];
            warp_cnt[ww][tid] = (unsigned short)mine;
            mine += c;
        }
    }
    const u32 start = block_exclusive_scan(mine, ws, &unused);
    if (tid < RADIX) {
        tile_start[tid] = start;
        dst_off[tid] = base + row_scan[(size_t)tid * ntiles + blockIdx.x] - start;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const u32 d = digit_of(key[r], shift);
        keys[tile_start[d] + warp_cnt[w][d] + rank[r]] = key[r];
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const u32 i = r * THREADS + tid;
        const int k = keys[i];
        dst[(size_t)(u32)(dst_off[digit_of(k, shift)] + i)] = k;
    }
}

extern "C" int radix_tile_bits(void) { return TILE_BITS; }

// Words of scratch `radix_sort_int32` needs for 2^total_bits keys.
extern "C" long long radix_scratch_words(int total_bits) {
    if (total_bits <= TILE_BITS) return 0;
    return (long long)RADIX * (1LL << (total_bits - TILE_BITS)) + RADIX;
}

// Sorts x[0 .. 2^total_bits), total_bits > TILE_BITS, on `stream`:
// x -> a -> b -> a -> b, so the result is in b and x is left as it was.
// a and b hold 2^total_bits int32 each, scratch radix_scratch_words() u32.
// Returns the first cudaError_t of any launch (0 on success); does not
// synchronise and allocates nothing.
extern "C" int radix_sort_int32(const void* x_ptr, void* a_ptr, void* b_ptr,
                                void* scratch_ptr, int total_bits, void* stream_ptr) {
    if (total_bits <= TILE_BITS || total_bits > 31) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const u32 ntiles = 1u << (total_bits - TILE_BITS);
    u32* hist = static_cast<u32*>(scratch_ptr);
    u32* totals = hist + (size_t)RADIX * ntiles;
    const int* src = static_cast<const int*>(x_ptr);
    int* bufs[2] = {static_cast<int*>(a_ptr), static_cast<int*>(b_ptr)};
    for (int pass = 0; pass < 4; ++pass) {
        const int shift = 8 * pass;
        int* dst = bufs[pass & 1];
        radix_hist<<<ntiles, THREADS, 0, stream>>>(src, hist, ntiles, shift);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        radix_scan<<<RADIX, SCAN_THREADS, 0, stream>>>(hist, totals, ntiles);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        radix_scatter<<<ntiles, THREADS, 0, stream>>>(src, dst, hist, totals, ntiles, shift);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        src = dst;
    }
    return 0;
}

extern "C" const char* radix_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
