// The one-sided Fisher exact test of 2x2 tables on Hopper (sm_90a).
//
// Counterpart of an XLA-lowered device program of the JAX package:
//   ops/stats.py fisher_right_tail  (a lax.scan of max_terms steps over every
//                                    table at once)   -> fisher_first_kernel,
//                                                        fisher_queue_kernel
//
// Input: four float32 arrays a, b, c, d of n tables [[a, b], [c, d]] (counts,
// held in float32 as the JAX function holds them) and max_terms. Output: p
// (n,) float32, P(X >= a) of the hypergeometric law with population
// m = a + b + c + d, n1 = a + b successes and k1 = a + c draws: lp0 = log
// pmf(a) from lgammaf, then the upward recurrence pmf(x + 1) / pmf(x) =
// (n1 - x)(k1 - x) / ((x + 1)(m - n1 - k1 + x + 1)) in log space, each term
// added to the running sum with logaddexp, with every float32 operation in
// the order of the JAX step and of the plain PyTorch version
// (ops/stats.fisher_right_tail_plain): log_term += logf(ratio) and log_sum =
// logaddexp(log_sum, log_term), term after term. Then p = exp(log_sum), 0
// where a > min(n1, k1), clipped to [0, 1] (a NaN stays NaN).
//
// Accurate logf, expf and log1pf (no --use_fast_math): the kernels and the
// plain version on the card call the same CUDA math functions in the same
// order. No product here feeds an add of the result, so no multiply-add is
// contracted into it.
//
// Where the walk stops. The JAX scan runs all max_terms steps for every
// table; a table's walk here stops at the first step after which no later
// step can change its float32 result:
//   (1) the end: a term past min(n1, k1) or with a ratio <= 0 is -inf in the
//       JAX step, and so is every later one (the log term carries the -inf;
//       so does a log term that has become -inf), and logaddexp(s, -inf) = s;
//       or max_terms terms are summed.
//   (2) log_sum >= 0: logaddexp never lowers log_sum (max(s, t) >= s, and
//       log1pf of expf(...) >= 0, in rounded arithmetic too), so exp of the
//       final sum is >= 1 and p clips to 1.
//   (3) the gap: after a term with ratio <= RATIO_EXIT and x + 1 > 0, every
//       later ratio is below 1: the four factors are positive, so the exact
//       ratio of the float inputs falls as x rises, and the computed one is
//       within ~8 rounding errors (2^-21) of it, far inside the 2^-16 of
//       RATIO_EXIT; so every later logf(ratio) <= 0 and, as rounding is
//       monotone, every later log term <= this one, t. With log_sum s, a
//       later step computes m = max(s, t') = s and adds y = log1pf(expf(-g'))
//       with g' = fl(s - t') >= fl(s - t) = g. If g > EXIT_GAP = 150,
//       expf(-g') = 0 (e^-150 < 2^-216, far below the least float32
//       denormal), so y = 0 and the sum stays s bit for bit. If s < 0 with
//       |s| >= 2^ULP_EXP_MIN, E = floor(log2 |s|): the float next to s toward
//       zero is at least 2^(E-24) away, so s + y rounds to s whenever
//       y < 2^(E-ULP_BITS) (ULP_BITS = 25); expf and log1pf are within a few
//       ulp of e^-g' and of log1p, and log1p(e) <= e, so y <= e^-g (1 + 2^-20),
//       and g > (ULP_BITS - E) ln 2 + 1e-3 is enough. So the walk stops when
//       g exceeds that gap (150 where s is smaller than 2^ULP_EXP_MIN in
//       magnitude), and the sum is already what the remaining steps give.
//
// Scheduling. Walks differ in length by thousands of terms (the 480 Mb bins:
// half of the tables stop after one term, the longest after ~2,700 with the
// exits), and a warp runs as long as its longest lane, so one thread a table
// in table order would leave most lanes idle. Both kernels walk in steps of UNROLL
// terms: each term of a step guarded by exit (1), exits (2) and (3) checked
// after the step's last term (a check after a later term than the first one
// that qualifies is as exact: the terms between add nothing). Two launches:
//   fisher_first_kernel: one thread a table, in table order: lp0 and at most
//     FIRST_TERMS terms; a table that stops there writes p. The others queue
//     their state (table, terms walked, log_sum, log_term; 16 B), tables with
//     LONG_TERMS or more terms still ahead at the front of the queue, the
//     rest at its back, by one atomic a block and class. A thread computes a
//     step's carry-free values (x, the ratio, its validity, logf of it) for
//     the next step beside the chain.
//   fisher_queue_kernel (launched behind it with launch_after): a persistent
//     grid of warp pairs. The consumer warp's lanes each hold a queued table
//     and, when it stops, take the next one, so each lane holds a table
//     while the queue lasts; the warp takes tickets POOL at a time by one
//     atomic and hands them to its idle lanes, the queue's front (the long
//     tables) first. The producer warp computes the carry-free values of
//     the same lanes' tables a step ahead into shared memory (two buffers of
//     UNROLL terms a lane; an invalid term's logf is written as NaN, which a
//     valid term's never is), and the pair meets at a named barrier once a
//     step. So the consumer's chain is one add, logaddexp's expf and log1pf
//     and a select a term, while the producer's division and logf (whose
//     IEEE division has a branch to its slow path, which would keep them
//     apart in one thread's instruction stream) run in the other warp. A
//     lane that takes a new table skips the step the producer computed for
//     its last one.
// What bounds it: the special-function unit over the terms the walks need
// (chip_smoke.py counts them with its own walk), or, where few tables are
// long (a 480 Mb genome's bins), the longest walk's chain of dependent terms:
// a term is log_term's add, logaddexp's difference, expf (one MUFU.EX2),
// log1pf (a polynomial, and a branch around its inf/NaN case), the add and
// the select, about 30 dependent instructions (chip_smoke.py times the cycles
// a term costs on one table alone).

// The entry point launches on the caller's stream and returns
// cudaGetLastError() of the launches (0 = launched); st_error_string names an
// error.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "launch_after.cuh"

namespace {

constexpr int THREADS = 256;        // fisher_first_kernel: threads a block (8 warps)
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;           // terms a step adds; exits (2) and (3) checked after each
constexpr int FIRST_TERMS = 64;     // terms a table walks before it is queued
constexpr int LONG_TERMS = 1024;    // queued tables with this many terms ahead go first
constexpr int PAIRS = 2;            // fisher_queue_kernel: (consumer, producer) warps a block
constexpr int QUEUE_THREADS = 64 * PAIRS;
constexpr int POOL = 32;            // tickets a warp takes at once
constexpr int EXIT_GAP = 150;       // exit (3): the gap at any log_sum
constexpr int ULP_BITS = 25;        // exit (3): y < 2^(E - ULP_BITS) leaves s as it is
constexpr int ULP_EXP_MIN = -100;   // exit (3): the least exponent of s for that rule
constexpr float RATIO_EXIT = 1.0f - 1.0f / 65536;  // exit (3): ratios at most this
constexpr unsigned FULL = 0xffffffffu;
static_assert(FIRST_TERMS % UNROLL == 0, "a queued walk resumes at a step's start");

// torch.logaddexp's formula for real operands (and jnp.logaddexp's for
// finite ones): equal infinities pass through. Branch-free, so the next
// term's carry-free values can be scheduled beside it.
__device__ __forceinline__ float logaddexp(float a, float b) {
    const float m = fmaxf(a, b);
    const float r = m + log1pf(expf(-fabsf(a - b)));
    return isinf(a) && a == b ? a : r;
}

__device__ __forceinline__ float lchoose(float a, float b) {
    return lgammaf(a + 1.0f) - lgammaf(b + 1.0f) - lgammaf(a - b + 1.0f);
}

// Exit (3)'s gap for log_sum s < 0.
__device__ __forceinline__ float exit_gap(float s) {
    const int e = ((__float_as_int(s) >> 23) & 0xff) - 127;  // floor(log2 |s|), s normal
    if (e < ULP_EXP_MIN || e > 127) return (float)EXIT_GAP;
    return fmaxf((float)(ULP_BITS - e) * 0.6931472f + 1e-3f, 0.0f);
}

// A table as its walk needs it.
struct Table {
    float a, n1, k1, upper, mk;  // mk = m - n1 - k1, as the step's left-to-right sum forms it
};

__device__ __forceinline__ Table table_of(float a, float b, float c, float d) {
    const float m = a + b + c + d;
    const float n1 = a + b;
    const float k1 = a + c;
    return {a, n1, k1, fminf(n1, k1), m - n1 - k1};
}

// Term j's carry-free values, in the JAX step's order.
__device__ __forceinline__ void term_values(const Table& tb, int j, float& ratio, float& lr,
                                            bool& valid) {
    const float x = tb.a + (float)j;
    ratio = ((tb.n1 - x) * (tb.k1 - x)) / ((x + 1.0f) * (tb.mk + x + 1.0f));
    valid = x < tb.upper && ratio > 0.0f;
    lr = logf(fmaxf(ratio, 1e-38f));
}

// A walk's state: log_sum, log_term, terms summed.
struct Walk {
    Table tb;
    float s, t;
    int i;
};

// Adds a step of UNROLL terms, given their logf of the ratio (NaN where a
// term is invalid) and ratios; false once the walk has stopped.
__device__ __forceinline__ bool add_step(Walk& w, const float (&lr)[UNROLL],
                                         const float (&ratio)[UNROLL], int max_terms) {
    bool go = true;
    float last = 0.0f;  // the ratio of the last term added
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
        const float t = w.t + lr[k];
        // exit (1): an invalid term, a -inf log term, max_terms terms
        go = go && !isnan(lr[k]) && w.i < max_terms && !(isinf(t) && t < 0.0f);
        const float s = logaddexp(w.s, t);
        w.s = go ? s : w.s;
        w.t = go ? t : w.t;
        last = go ? ratio[k] : last;
        w.i += go;
    }
    if (!go || w.i >= max_terms || w.s >= 0.0f) return false;  // exits (1), (2)
    const bool decreasing = last <= RATIO_EXIT && (w.tb.a + (float)(w.i - 1)) + 1.0f > 0.0f;
    return !(decreasing && w.s - w.t > exit_gap(w.s));  // exit (3)
}

// A step's carry-free values from term j on (logf NaN where invalid).
__device__ __forceinline__ void step_values(const Table& tb, int j, float (&lr)[UNROLL],
                                            float (&ratio)[UNROLL]) {
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
        bool valid;
        term_values(tb, j + k, ratio[k], lr[k], valid);
        lr[k] = valid ? lr[k] : __int_as_float(0x7fffffff);
    }
}

__device__ __forceinline__ float result(const Walk& w) {
    float p = expf(w.s);
    if (w.tb.a > w.tb.upper) p = 0.0f;
    return p < 0.0f ? 0.0f : (p > 1.0f ? 1.0f : p);
}

// The queue: n entries (table, terms walked, log_sum, log_term bits); the
// front grows up from 0, the back down from n - 1. counters: front, back,
// tickets taken.
__global__ void __launch_bounds__(THREADS)
fisher_first_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ C, const float* __restrict__ D, int n,
                    int max_terms, float* __restrict__ out, int* __restrict__ counters,
                    int4* __restrict__ queue) {
    __shared__ int s_count[2][WARPS];
    __shared__ int s_base[2];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int k = blockIdx.x * THREADS + threadIdx.x;
    int cls = -1;  // 0: the front, 1: the back, -1: not queued
    Walk w;
    if (k < n) {
        const float a = A[k], b = B[k], c = C[k], d = D[k];
        w.tb = table_of(a, b, c, d);
        const float m = a + b + c + d;
        const float lp0 = lchoose(w.tb.n1, a) + lchoose(m - w.tb.n1, w.tb.k1 - a) -
                          lchoose(m, w.tb.k1);
        w.s = w.t = lp0;
        w.i = 0;
        float lr[UNROLL], ratio[UNROLL];
        step_values(w.tb, 0, lr, ratio);
        bool going = max_terms > 0;
        for (int j = 0; j < FIRST_TERMS / UNROLL && going; ++j) {
            float next_lr[UNROLL], next_ratio[UNROLL];
            step_values(w.tb, w.i + UNROLL, next_lr, next_ratio);  // beside the chain
            going = add_step(w, lr, ratio, max_terms);
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                lr[u] = next_lr[u];
                ratio[u] = next_ratio[u];
            }
        }
        if (going) {
            const float ahead = fminf(w.tb.upper - a, (float)max_terms) - (float)w.i;
            cls = ahead >= (float)LONG_TERMS ? 0 : 1;
        } else {
            out[k] = result(w);
        }
    }
    const unsigned front = __ballot_sync(FULL, cls == 0), back = __ballot_sync(FULL, cls == 1);
    if (lane == 0) {
        s_count[0][warp] = __popc(front);
        s_count[1][warp] = __popc(back);
    }
    __syncthreads();
    if (threadIdx.x < 2) {
        int sum = 0;
        for (int v = 0; v < WARPS; ++v) {
            const int c = s_count[threadIdx.x][v];
            s_count[threadIdx.x][v] = sum;
            sum += c;
        }
        s_base[threadIdx.x] = sum ? atomicAdd(counters + threadIdx.x, sum) : 0;
    }
    __syncthreads();
    if (cls >= 0) {
        const int slot = s_base[cls] + s_count[cls][warp] +
                         __popc((cls == 0 ? front : back) & ((1u << lane) - 1u));
        queue[cls == 0 ? slot : n - 1 - slot] =
            make_int4(k, w.i, __float_as_int(w.s), __float_as_int(w.t));
    }
}

// The pair's named barrier (0 is __syncthreads).
__device__ __forceinline__ void pair_sync(int pair) {
    asm volatile("bar.sync %0, 64;" ::"r"(pair + 1) : "memory");
}

// Steps r = 0, 1, ...: the producer computes step r for the tables the
// consumer assigned in step r - 1 into buffer r % 2, while the consumer adds
// step r - 1 from the other buffer, hands out tickets and assigns; then the
// pair meets at its barrier.
__global__ void __launch_bounds__(QUEUE_THREADS)
fisher_queue_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ C, const float* __restrict__ D, int n,
                    int max_terms, float* __restrict__ out, int* __restrict__ counters,
                    const int4* __restrict__ queue) {
    __shared__ float s_lr[PAIRS][2][UNROLL][32];     // logf of the ratio; NaN: invalid
    __shared__ float s_ratio[PAIRS][2][UNROLL][32];
    __shared__ int s_table[PAIRS][2][32];            // a consumer lane's table, -1: none
    __shared__ int s_from[PAIRS][2][32];             // the term its walk goes on from
    __shared__ int s_quit[PAIRS];
    const int lane = threadIdx.x & 31, pair = threadIdx.x >> 6;
    const bool producer = (threadIdx.x >> 5) & 1;
    if (!producer) {
        s_table[pair][1][lane] = -1;  // what the producer reads at step 0
        if (lane == 0) s_quit[pair] = 0;
    }
    __syncthreads();
    wait_primary();  // the first pass's queue and counters
    if (producer) {
        Table tb;
        int table = -1, j = 0;
        for (int r = 0;; ++r) {
            const int want = s_table[pair][(r - 1) & 1][lane];
            if (want != table) {  // a new table (or none)
                table = want;
                if (table >= 0) {
                    tb = table_of(A[table], B[table], C[table], D[table]);
                    j = s_from[pair][(r - 1) & 1][lane];
                }
            } else {
                j += UNROLL;
            }
            if (table >= 0) {
                float lr[UNROLL], ratio[UNROLL];
                step_values(tb, j, lr, ratio);
#pragma unroll
                for (int k = 0; k < UNROLL; ++k) {
                    s_lr[pair][r & 1][k][lane] = lr[k];
                    s_ratio[pair][r & 1][k][lane] = ratio[k];
                }
            }
            pair_sync(pair);
            if (s_quit[pair]) return;
        }
    }
    Walk w;
    int table = -1;              // the lane's table; -1: idle
    bool skip = false;           // the step the producer has now is for the lane's last table
    int pool = 0, pool_end = 0;  // the warp's tickets not yet handed out
    bool drained = false;        // the queue has no ticket left for this warp
    const int front = counters[0], total = front + counters[1];
    for (int r = 0;; ++r) {
        if (r > 0 && table >= 0 && !skip) {
            float lr[UNROLL], ratio[UNROLL];
#pragma unroll
            for (int k = 0; k < UNROLL; ++k) {
                lr[k] = s_lr[pair][(r - 1) & 1][k][lane];
                ratio[k] = s_ratio[pair][(r - 1) & 1][k][lane];
            }
            if (!add_step(w, lr, ratio, max_terms)) {
                out[table] = result(w);
                table = -1;
            }
        }
        skip = false;
        unsigned idle = __ballot_sync(FULL, table < 0);
        while (idle && !drained) {  // hand tickets to the idle lanes
            if (pool == pool_end) {
                int base = 0;
                if (lane == 0) base = atomicAdd(counters + 2, POOL);
                base = __shfl_sync(FULL, base, 0);
                pool = min(base, total);
                pool_end = min(base + POOL, total);
                drained = pool == pool_end;
                if (drained) break;
            }
            const int take = min(__popc(idle), pool_end - pool);
            const int rank = __popc(idle & ((1u << lane) - 1u));
            if (table < 0 && rank < take) {
                const int q = pool + rank;
                const int4 e = queue[q < front ? q : n - 1 - (q - front)];
                table = e.x;
                w.tb = table_of(A[table], B[table], C[table], D[table]);
                w.i = e.y;
                w.s = __int_as_float(e.z);
                w.t = __int_as_float(e.w);
                skip = true;
            }
            pool += take;
            idle = __ballot_sync(FULL, table < 0);
        }
        s_table[pair][r & 1][lane] = table;
        s_from[pair][r & 1][lane] = w.i;
        const bool quit = !__any_sync(FULL, table >= 0);
        if (quit && lane == 0) s_quit[pair] = 1;
        pair_sync(pair);
        if (quit) return;
    }
}

int sm_count() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    return sms;
}

}  // namespace

// Scratch of st_fisher_right_tail, in int32: 4 counters (the queue's front
// and back, the tickets taken, and one that keeps the queue 16-byte
// aligned), then the queue of n 16-byte entries.
extern "C" long long st_fisher_scratch_size(long long n) { return 4 + 4 * n; }

// a, b, c, d, out: (n,) float32 on the card; scratch int32 of
// st_fisher_scratch_size(n), 16-byte aligned; 1 <= n < 2^31, max_terms >= 0.
extern "C" int st_fisher_right_tail(const void* a, const void* b, const void* c, const void* d,
                                    long long n, int max_terms, void* out, void* scratch,
                                    void* stream_p) {
    if (n < 1 || n >= (1LL << 31) || max_terms < 0 ||
        reinterpret_cast<uintptr_t>(scratch) % 16)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
    auto* counters = static_cast<int*>(scratch);
    auto* queue = reinterpret_cast<int4*>(counters + 4);
    const auto *fa = static_cast<const float*>(a), *fb = static_cast<const float*>(b),
               *fc = static_cast<const float*>(c), *fd = static_cast<const float*>(d);
    auto* p = static_cast<float*>(out);
    cudaError_t err = cudaMemsetAsync(counters, 0, 4 * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (int)((n + THREADS - 1) / THREADS);
    fisher_first_kernel<<<blocks, THREADS, 0, stream>>>(fa, fb, fc, fd, (int)n, max_terms, p,
                                                        counters, queue);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    static int per_sm = 0;
    if (per_sm == 0 &&
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fisher_queue_kernel,
                                                             QUEUE_THREADS, 0)) != cudaSuccess)
        return (int)err;
    const long long grid = std::min<long long>((long long)per_sm * sm_count(),
                                               (n + QUEUE_THREADS - 1) / QUEUE_THREADS);
    err = launch_after(fisher_queue_kernel, dim3((unsigned)grid), dim3(QUEUE_THREADS), stream,
                       fa, fb, fc, fd, (int)n, max_terms, p, counters,
                       static_cast<const int4*>(queue));
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

extern "C" const char* st_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
