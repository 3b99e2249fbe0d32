// The one-sided Fisher exact test of 2x2 tables on Hopper (sm_90a).
//
// Counterpart of an XLA-lowered device program of the JAX package:
//   ops/stats.py fisher_right_tail  (a lax.scan of max_terms steps over every
//                                    table at once)   -> fisher_tail_kernel
//
// Input: four float32 arrays a, b, c, d of n tables [[a, b], [c, d]] (counts,
// held in float32 as the JAX function holds them) and max_terms. Output: p
// (n,) float32, P(X >= a) of the hypergeometric law with population
// m = a + b + c + d, n1 = a + b successes and k1 = a + c draws. One thread a
// table. It computes lp0 = log pmf(a) from lgammaf, then walks the upward
// recurrence pmf(x + 1) / pmf(x) = (n1 - x)(k1 - x) / ((x + 1)(m - n1 - k1 +
// x + 1)) in log space, adding each term to the running sum with logaddexp,
// with every float32 operation in the order of the JAX step and of the plain
// PyTorch version (ops/stats.fisher_right_tail_plain). The JAX scan runs all
// max_terms steps for every table; a term past min(n1, k1) (or with a ratio
// <= 0) is -inf there, and so is every later one (the log term carries the
// -inf), and logaddexp(s, -inf) = s exactly, so the thread stops at its first
// -inf term: the same sum after min(upper - a, max_terms) steps instead of
// max_terms. Then p = exp(sum), 0 where a > min(n1, k1), clipped to [0, 1]
// (a NaN stays NaN, as in jnp.clip and torch.clamp).
//
// Accurate logf, expf and log1pf (no --use_fast_math): the kernel and its
// plain version on the card call the same CUDA math functions in the same
// order. No product here feeds an add, so no multiply-add is contracted.
//
// What bounds it: the special-function unit. A term costs three
// transcendental calls (the log of the ratio, and the exp and log1p of
// logaddexp) and about twenty float32 operations; the inputs are 16 bytes a
// table and the output 4, so bytes bound it only when the tables run few
// terms. The terms are independent across tables, so the design is one
// thread a table with nothing shared: no shared memory, no barrier; a warp
// runs as long as its longest table.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError() of the launch (0 = launched); st_error_string names an
// error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// torch.logaddexp's formula for real operands (and jnp.logaddexp's for
// finite ones): equal infinities pass through.
__device__ __forceinline__ float logaddexp(float a, float b) {
    if (isinf(a) && a == b) return a;
    const float m = fmaxf(a, b);
    return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float lchoose(float a, float b) {
    return lgammaf(a + 1.0f) - lgammaf(b + 1.0f) - lgammaf(a - b + 1.0f);
}

__global__ void __launch_bounds__(THREADS)
fisher_tail_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ C, const float* __restrict__ D, int64_t n,
                   int max_terms, float* __restrict__ out) {
    const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (t >= n) return;
    const float a = A[t], b = B[t], c = C[t], d = D[t];
    const float m = a + b + c + d;
    const float n1 = a + b;
    const float k1 = a + c;
    const float upper = fminf(n1, k1);
    const float lp0 = lchoose(n1, a) + lchoose(m - n1, k1 - a) - lchoose(m, k1);
    float log_sum = lp0, log_term = lp0;
    for (int i = 0; i < max_terms; ++i) {
        const float x = a + (float)i;
        const float ratio = ((n1 - x) * (k1 - x)) / ((x + 1.0f) * (m - n1 - k1 + x + 1.0f));
        if (!(x < upper && ratio > 0.0f)) break;       // this and every later term: -inf
        log_term = log_term + logf(fmaxf(ratio, 1e-38f));
        if (isinf(log_term) && log_term < 0.0f) break;  // -inf carried on
        log_sum = logaddexp(log_sum, log_term);
    }
    float p = expf(log_sum);
    if (a > upper) p = 0.0f;
    out[t] = p < 0.0f ? 0.0f : (p > 1.0f ? 1.0f : p);
}

}  // namespace

// a, b, c, d, out: (n,) float32 on the card; n >= 1, max_terms >= 0.
extern "C" int st_fisher_right_tail(const void* a, const void* b, const void* c, const void* d,
                                    long long n, int max_terms, void* out, void* stream_p) {
    if (n < 1 || max_terms < 0) return (int)cudaErrorInvalidValue;
    const long long blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    fisher_tail_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream_p)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(c), static_cast<const float*>(d), (int64_t)n, max_terms,
        static_cast<float*>(out));
    return (int)cudaGetLastError();
}

extern "C" const char* st_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
