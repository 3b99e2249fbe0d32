// Run lengths and run totals of a sorted int32 or int64 array, thresholded
// and compacted in order, on Hopper (sm_90a).
//
// Counterpart of the run-length passes of the JAX package's counting,
// ops/count.py _sorted_run_survivors (run lengths) and
// _merge_sorted_runs (run totals of per-entry counts), which take the
// distance to each run's start from a prefix maximum, jax.lax.cummax: XLA
// lowers it, no Pallas kernel stands behind it; and of their pair-code
// twins, ops/count_pair.py _sorted_pair_survivors and _merge_sorted_runs_pair
// (k > 15), whose two-key runs are one int64 key hi << 31 | lo here. A run's
// length or total comes from the positions of consecutive run ends instead:
// entry i ends a run when i = n - 1 or keys[i] != keys[i + 1] (the full key,
// both words of a pair), and the run ending at i totals the weights in (the
// previous run end, i] (weight 1 an entry without weights: its length). A
// run survives where its end passes
//   keep = total >= lower && !pad(key) && total > 0;
// pad(key) is key == SENTINEL for int32 keys and (key >> 31) == SENTINEL, the
// hi word alone, for int64 pair codes (as ops/count_pair's _is_pad; PAD64 is
// the pair (SENTINEL, SENTINEL)). The survivors' keys (ascending) and totals
// are written in order: int32 keys as they are, int64 keys as the pair's two
// int32 planes, hi = key >> 31 then lo = key & 0x7fffffff.
//
// Totals are unsigned 32-bit sums: a difference of two such prefixes is the
// exact total of any run below 2^32, and every caller's total is below 2^31
// (the weights are the counts of one chromosome's k-mers, or 1 an entry), so
// no int64 prefix is kept.
//
// The scan across tiles. Entries are taken in tiles of TILE (THREADS
// threads x VEC entries of a 16-byte load of keys x ROUNDS rounds, all loads
// issued first; VEC and ROUNDS are the key type's, Keys<Key> below, so that
// a tile is TILE entries for either width). A run may span any number of
// tiles (a padded array's SENTINEL run is millions of entries long), so what
// enters a tile is the weight of the run left open by the tiles before it: a
// segmented sum, carried in a 64-bit word (END_BIT: the range holds a run
// end; low 32 bits: the weight after its last run end, or the whole range's
// sum when it holds none). A thread combines its VEC entries, warps scan by
// shuffles, the block's warp words in index order give each thread the word
// before its entries. Then a single-pass chained scan with decoupled
// look-back over status words (flag in the top two bits, the word below), as
// match_scan_kernel of anchors.cu does: thread 0 publishes the block's word
// (FLAG_AGGREGATE, block 0 FLAG_PREFIX), warp 0 reads the words of the
// LOOKBACK blocks before it, one a lane, and adds the values from the nearest
// block up to the nearest one that is a prefix or holds a run end (either
// one's value is the open weight at its end, whatever lies before it), then
// publishes the block's own prefix. With the weight entering it the block
// knows every run end's total and its keep flag exactly; the survivors'
// output slots come from a second chained scan of the same kind over the
// blocks' exact survivor counts (plain sums). The last block writes the
// survivor count m.
//
// Two launches, one kernel (runs_kernel<Key, WEIGHTED, WRITE>), two C entries
// a key width (rn_count / rn_write: int32; rn_count64 / rn_write64: int64):
//   count (WRITE = false): the two chained scans; writes m to device memory
//     and leaves every block's two prefixes in the status words;
//   write (WRITE = true): reads each block's weight in and survivor offset
//     from the finished status words, takes the tile again and writes its
//     survivors below `cap`; its grid also writes the pads (SENTINEL, or the
//     pair (SENTINEL, SENTINEL), and 0) of the output slots [m, cap). Blocks
//     whose offset is at or past cap read nothing.
// Two launches because the merges size their outputs on the host, from m,
// between them; the callers with a fixed cap launch the second right behind
// the first, and m stays on the device until they read it.
//
// What bounds it: bytes. The function reads its keys (4 or 8 n bytes) and
// weights (4 n) once and writes 8 (int32 keys) or 12 (a pair's two words)
// bytes an output slot (cap): at 2^24 int32 keys and cap = n (sort_rle)
// 12 n bytes, 60 us at 3.35 TB/s; at a 2^28-entry int32 merge 8 n bytes
// read, 0.64 ms, and its outputs are the survivors only; at 2^24 pair codes
// and cap = n (a batch of the pair path) 20 n bytes, 0.10 ms; at a 2^28-entry
// pair merge 12 n bytes read, 0.96 ms. The design reads the inputs twice
// (the write launch takes the tile again rather than keeping per-entry state
// between the launches: 8 bytes a surviving entry, 2 GB at a 2^28-entry
// merge, would outgrow the reads it saves), and the status words, 16 bytes a
// block, once each way. The look-backs cost latency, not bytes: a block
// publishes its own word before it waits, so a wait is a few hundred
// nanoseconds behind the block before it.

// The entry points launch on the caller's stream and return
// cudaGetLastError() of their launches (0 = launched); rn_error_string
// names an error.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t SENTINEL = INT32_MAX;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;                  // threads a block (8 warps)
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 4096;                    // entries a block, either key width
constexpr int LOOKBACK = 32;                  // status words a look-back step reads, one a lane
constexpr int FLAG_SHIFT = 62;                // status word: flag << FLAG_SHIFT | word
constexpr int FLAG_AGGREGATE = 1;             // the block's own word
constexpr int FLAG_PREFIX = 2;                // the word of every block up to this one

using u64 = unsigned long long;
using u32 = unsigned int;
constexpr u64 END_BIT = 1ull << 32;           // carry word: the range holds a run end
constexpr u64 VALUE_MASK = 0xffffffffull;     // carry word: the open weight; count word: the count

// The segmented sum: range a followed by range b.
__device__ __forceinline__ u64 combine(u64 a, u64 b) {
    return (b & END_BIT) ? b : ((a & END_BIT) | ((a + b) & VALUE_MASK));
}

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

__device__ __forceinline__ int get(const int2& v, int j) { return j == 0 ? v.x : v.y; }

__device__ __forceinline__ long long get(const longlong2& v, int j) { return j == 0 ? v.x : v.y; }

// VEC entries of x from i (16-byte aligned), 0 at n and past it.
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ x, long long i, long long n) {
    if (i + 4 <= n) return *reinterpret_cast<const int4*>(x + i);
    return make_int4(i < n ? x[i] : 0, i + 1 < n ? x[i + 1] : 0, i + 2 < n ? x[i + 2] : 0,
                     i + 3 < n ? x[i + 3] : 0);
}

// 2 entries of x from i (aligned to their vector), 0 at n and past it.
__device__ __forceinline__ int2 load2(const int32_t* __restrict__ x, long long i, long long n) {
    if (i + 2 <= n) return *reinterpret_cast<const int2*>(x + i);
    return make_int2(i < n ? x[i] : 0, 0);
}

__device__ __forceinline__ longlong2 load2(const long long* __restrict__ x, long long i,
                                           long long n) {
    if (i + 2 <= n) return *reinterpret_cast<const longlong2*>(x + i);
    return make_longlong2(i < n ? x[i] : 0, 0);
}

// What the key's width sets: the entries a 16-byte load of keys holds (VEC),
// the loads a thread makes (ROUNDS: a tile is TILE entries), how keys and
// weights are read, the pad test, and how a survivor's key and a pad are
// written to the output planes.
template <typename Key>
struct Keys;

// int32 keys (the k <= 15 codes, mapping's hit sets): an int4 of keys and an
// int4 of weights a load; the pad is SENTINEL; one output plane.
template <>
struct Keys<int32_t> {
    static constexpr int VEC = 4;
    static constexpr int ROUNDS = TILE / (THREADS * VEC);
    using KeyVec = int4;
    using WeightVec = int4;
    __device__ static KeyVec keys(const int32_t* x, long long i, long long n) {
        return load4(x, i, n);
    }
    __device__ static WeightVec weights(const int32_t* w, long long i, long long n) {
        return load4(w, i, n);
    }
    __device__ static WeightVec ones() { return make_int4(1, 1, 1, 1); }
    __device__ static bool pad(int32_t key) { return key == SENTINEL; }
    __device__ static void store(int32_t* out, int cap, long long at, int32_t key) {
        out[at] = key;
    }
    __device__ static void store_pad(int32_t* out, int cap, long long at) { out[at] = SENTINEL; }
};

// int64 keys (the pair codes hi << 31 | lo of k > 15): a longlong2 of keys
// and an int2 of weights a load; the pad test reads the hi word; two output
// planes of cap int32 each, hi then lo (the pad pair (SENTINEL, SENTINEL)).
template <>
struct Keys<long long> {
    static constexpr int VEC = 2;
    static constexpr int ROUNDS = TILE / (THREADS * VEC);
    using KeyVec = longlong2;
    using WeightVec = int2;
    __device__ static KeyVec keys(const long long* x, long long i, long long n) {
        return load2(x, i, n);
    }
    __device__ static WeightVec weights(const int32_t* w, long long i, long long n) {
        return load2(w, i, n);
    }
    __device__ static WeightVec ones() { return make_int2(1, 1); }
    __device__ static bool pad(long long key) { return (key >> 31) == SENTINEL; }
    __device__ static void store(int32_t* out, int cap, long long at, long long key) {
        out[at] = (int32_t)(key >> 31);
        out[(long long)cap + at] = (int32_t)(key & 0x7fffffff);
    }
    __device__ static void store_pad(int32_t* out, int cap, long long at) {
        out[at] = SENTINEL;
        out[(long long)cap + at] = SENTINEL;
    }
};

// Warp 0 of block b > 0: the value of the blocks before b (decoupled
// look-back over their status words), valid in every lane. Walking back, a
// word that is a prefix or holds a run end (END_BIT; never set in a count
// word) ends the walk: its value is already everything before it that
// counts.
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
        const unsigned stop =
            __ballot_sync(FULL, (s >> FLAG_SHIFT) == FLAG_PREFIX || (s & END_BIT));
        const int last = stop ? __ffs(stop) - 1 : LOOKBACK - 1;  // the lanes to add
        u64 v = lane <= last ? s & VALUE_MASK : 0ull;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
        before = (before + v) & VALUE_MASK;
        if (stop) return before;
    }
}

template <typename Key, bool WEIGHTED, bool WRITE>
__global__ void __launch_bounds__(THREADS)
runs_kernel(const Key* __restrict__ keys, const int32_t* __restrict__ weights, long long n,
            int lower, u64* __restrict__ carry_status, u64* __restrict__ count_status,
            int32_t* __restrict__ m, int cap, int32_t* __restrict__ out_keys,
            int32_t* __restrict__ out_tot) {
    using K = Keys<Key>;
    constexpr int VEC = K::VEC, ROUNDS = K::ROUNDS;
    __shared__ u64 s_carry[ROUNDS][WARPS];
    __shared__ int s_count[ROUNDS][WARPS];
    __shared__ u64 s_before;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.x;
    const int nb = (int)((n + TILE - 1) / TILE);
    u32 cin = 0;        // the open weight entering the block
    long long soff = 0;  // the survivors before the block
    if constexpr (WRITE) {
        const long long first = (long long)b * TILE, last = first + TILE;
        const long long lo = *m > first ? *m : first, hi = cap < last ? cap : last;
        for (long long k = lo + threadIdx.x; k < hi; k += THREADS) {  // the pads
            K::store_pad(out_keys, cap, k);
            out_tot[k] = 0;
        }
        if (b >= nb) return;
        if (b > 0) {
            soff = (long long)(count_status[b - 1] & VALUE_MASK);
            cin = (u32)(carry_status[b - 1] & VALUE_MASK);
        }
        if (soff >= cap) return;
    }
    typename K::KeyVec k[ROUNDS];
    typename K::WeightVec w[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {  // every load issued before any is used
        const long long i = (long long)b * TILE + (r * THREADS + threadIdx.x) * VEC;
        k[r] = K::keys(keys, i, n);
        w[r] = WEIGHTED ? K::weights(weights, i, n) : K::ones();
    }
    // run ends: the key after a thread's last entry is the next lane's
    // first, or, in lane 31, read from memory (the next warp's line)
    unsigned ends[ROUNDS];  // bit j: entry j ends a run
    u64 excl[ROUNDS];       // the carry word before the thread's entries, inside its warp
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const long long i = (long long)b * TILE + (r * THREADS + threadIdx.x) * VEC;
        Key next = __shfl_down_sync(FULL, get(k[r], 0), 1);
        if (lane == 31) next = i + VEC < n ? keys[i + VEC] : 0;
        ends[r] = 0;
        u64 t = 0;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            const Key after = j + 1 < VEC ? get(k[r], j + 1) : next;
            const bool end = i + j < n && (i + j == n - 1 || get(k[r], j) != after);
            ends[r] |= (unsigned)end << j;
            t = combine(t, end ? END_BIT : (i + j < n ? (u64)(u32)get(w[r], j) : 0ull));
        }
        u64 inc = t;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const u64 v = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc = combine(v, inc);
        }
        if (lane == 31) s_carry[r][warp] = inc;
        const u64 prev = __shfl_up_sync(FULL, inc, 1);
        excl[r] = lane == 0 ? 0ull : prev;
    }
    __syncthreads();
    u64 agg = 0, pre[ROUNDS] = {};  // the block's word; each round's warps' words before this warp
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
#pragma unroll
        for (int v = 0; v < WARPS; ++v) {
            if (v == warp) pre[r] = agg;
            agg = combine(agg, s_carry[r][v]);
        }
    }
    if constexpr (!WRITE) {
        if (threadIdx.x == 0)
            store_status(carry_status + b,
                         (u64)(b == 0 ? FLAG_PREFIX : FLAG_AGGREGATE) << FLAG_SHIFT | agg);
        if (warp == 0) {
            const u64 before = b == 0 ? 0ull : look_back(carry_status, b, lane);
            if (lane == 0) {
                if (b > 0)
                    store_status(carry_status + b, (u64)FLAG_PREFIX << FLAG_SHIFT |
                                                       (combine(before, agg) & VALUE_MASK));
                s_before = before;
            }
        }
        __syncthreads();
        cin = (u32)s_before;
    }
    // every run end's total and keep flag, and the survivors before each
    // thread's entries inside its warp
    u32 tot[ROUNDS][VEC];
    unsigned kept[ROUNDS];
    int kexcl[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        u32 c = (u32)(combine(combine(cin, pre[r]), excl[r]) & VALUE_MASK);
        kept[r] = 0;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            const u32 t = c + (u32)get(w[r], j);
            tot[r][j] = t;
            if (ends[r] >> j & 1) {
                const bool keep = !K::pad(get(k[r], j)) && (int)t >= lower && (int)t > 0;
                kept[r] |= (unsigned)keep << j;
                c = 0;
            } else {
                c = t;
            }
        }
        const int nk = __popc(kept[r]);
        int inc = nk;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc += v;
        }
        if (lane == 31) s_count[r][warp] = inc;
        kexcl[r] = inc - nk;
    }
    __syncthreads();
    int count = 0, kpre[ROUNDS] = {};  // the block's survivors; each round's before this warp
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
#pragma unroll
        for (int v = 0; v < WARPS; ++v) {
            if (v == warp) kpre[r] = count;
            count += s_count[r][v];
        }
    }
    if constexpr (!WRITE) {
        if (threadIdx.x == 0)
            store_status(count_status + b,
                         (u64)(b == 0 ? FLAG_PREFIX : FLAG_AGGREGATE) << FLAG_SHIFT | (u64)count);
        if (warp == 0) {
            const u64 before = b == 0 ? 0ull : look_back(count_status, b, lane);
            if (lane == 0) {
                if (b > 0)
                    store_status(count_status + b,
                                 (u64)FLAG_PREFIX << FLAG_SHIFT | (before + (u64)count));
                if (b == nb - 1) *m = (int32_t)(before + (u64)count);
            }
        }
    } else {
#pragma unroll
        for (int r = 0; r < ROUNDS; ++r) {
            long long at = soff + kpre[r] + kexcl[r];
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
                if (kept[r] >> j & 1) {
                    if (at < cap) {
                        K::store(out_keys, cap, at, get(k[r], j));
                        out_tot[at] = (int32_t)tot[r][j];
                    }
                    ++at;
                }
            }
        }
    }
}

int blocks(long long n) { return (int)((n + TILE - 1) / TILE); }

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

template <typename Key>
int launch_count(const void* keys, const void* weights, long long n, int lower, void* m,
                 void* scratch, void* stream_p) {
    if (n < 1 || n > INT32_MAX) return (int)cudaErrorInvalidValue;
    if (misaligned(keys) || (weights && misaligned(weights)))
        return (int)cudaErrorMisalignedAddress;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
    const int nb = blocks(n);
    auto* status = static_cast<u64*>(scratch);
    const cudaError_t err = cudaMemsetAsync(status, 0, 2 * sizeof(u64) * nb, stream);
    if (err != cudaSuccess) return (int)err;
    auto* k = static_cast<const Key*>(keys);
    auto* w = static_cast<const int32_t*>(weights);
    auto* mm = static_cast<int32_t*>(m);
    if (weights)
        runs_kernel<Key, true, false><<<nb, THREADS, 0, stream>>>(
            k, w, n, lower, status, status + nb, mm, 0, nullptr, nullptr);
    else
        runs_kernel<Key, false, false><<<nb, THREADS, 0, stream>>>(
            k, w, n, lower, status, status + nb, mm, 0, nullptr, nullptr);
    return (int)cudaGetLastError();
}

template <typename Key>
int launch_write(const void* keys, const void* weights, long long n, int lower, const void* m,
                 const void* scratch, int cap, void* out_keys, void* out_tot, void* stream_p) {
    if (n < 1 || n > INT32_MAX || cap < 0) return (int)cudaErrorInvalidValue;
    if (misaligned(keys) || (weights && misaligned(weights)))
        return (int)cudaErrorMisalignedAddress;
    const int nb = blocks(n);
    const int grid = std::max(nb, blocks(cap));
    cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
    auto* status = static_cast<u64*>(const_cast<void*>(scratch));
    auto* k = static_cast<const Key*>(keys);
    auto* w = static_cast<const int32_t*>(weights);
    auto* mm = static_cast<int32_t*>(const_cast<void*>(m));
    auto* ok = static_cast<int32_t*>(out_keys);
    auto* ot = static_cast<int32_t*>(out_tot);
    if (weights)
        runs_kernel<Key, true, true><<<grid, THREADS, 0, stream>>>(k, w, n, lower, status,
                                                                  status + nb, mm, cap, ok, ot);
    else
        runs_kernel<Key, false, true><<<grid, THREADS, 0, stream>>>(k, w, n, lower, status,
                                                                   status + nb, mm, cap, ok, ot);
    return (int)cudaGetLastError();
}

}  // namespace

// Scratch of both launches, in int32: two status words (u64) a block; the
// same for either key width (a tile is TILE entries of both).
extern "C" long long rn_scratch_size(long long n) { return 4LL * blocks(n); }

// The first launch. keys int32 (n,), sorted ascending; weights int32 (n,),
// >= 0, or null (every weight 1); m int32 (1,): the survivor count; scratch
// int32 of rn_scratch_size(n), its status words zeroed here. keys and
// weights 16-byte aligned; 1 <= n < 2^31; every run total below 2^31.
extern "C" int rn_count(const void* keys, const void* weights, long long n, int lower, void* m,
                        void* scratch, void* stream_p) {
    return launch_count<int32_t>(keys, weights, n, lower, m, scratch, stream_p);
}

// The second launch, after rn_count of the same keys, weights, n, lower, m
// and scratch: out_keys, out_tot int32 (cap,), 0 <= cap < 2^31: the first
// cap survivors' keys and totals, then SENTINEL / 0 pads from m.
extern "C" int rn_write(const void* keys, const void* weights, long long n, int lower,
                        const void* m, const void* scratch, int cap, void* out_keys,
                        void* out_tot, void* stream_p) {
    return launch_write<int32_t>(keys, weights, n, lower, m, scratch, cap, out_keys, out_tot,
                                 stream_p);
}

// rn_count of int64 keys (pair codes hi << 31 | lo, sorted ascending; the
// pad test reads the hi word); weights, m, scratch and the limits as there.
extern "C" int rn_count64(const void* keys, const void* weights, long long n, int lower,
                          void* m, void* scratch, void* stream_p) {
    return launch_count<long long>(keys, weights, n, lower, m, scratch, stream_p);
}

// rn_write of int64 keys, after rn_count64: out_keys int32 (2, cap), the
// survivors' hi words in row 0 and lo words in row 1, then the pad pair
// (SENTINEL, SENTINEL) from m; out_tot int32 (cap,) as there.
extern "C" int rn_write64(const void* keys, const void* weights, long long n, int lower,
                          const void* m, const void* scratch, int cap, void* out_keys,
                          void* out_tot, void* stream_p) {
    return launch_write<long long>(keys, weights, n, lower, m, scratch, cap, out_keys, out_tot,
                                   stream_p);
}

extern "C" const char* rn_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
