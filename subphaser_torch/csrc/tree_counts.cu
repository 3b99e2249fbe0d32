// Pairwise counts of the LTR trees on Hopper (sm_90a).
//
// Counterparts of two XLA-lowered functions of the JAX package:
//   ltr/msa.py _match_counts   (V = (valid * w) @ valid.T and
//                               M = sum over the 20 residues r of
//                               ((a == r) * w) @ (a == r).T: 21 float32
//                               one-hot matmuls)      -> match_counts_kernel
//   ltr/tree.py mash_distances.inter_counts
//                              (vmapped searchsorted of one sorted sketch in
//                               another, then an equality count)
//                                                     -> inter_counts_kernel
//
// match_counts_kernel. Input: an alignment (n, L) uint8 (GAP = 20) and
// column weights (L,) float32. Output V and M, (n, n) float32:
//   V[i, j] = sum_c w_c [a_ic != GAP and a_jc != GAP]
//   M[i, j] = sum_c w_c [a_ic == a_jc and a_ic < 20]
// computed directly, with no one-hot matrices: a byte compare and a
// predicated add where the matmuls do 21 multiply-adds. A block owns a
// 64 x 64 tile of (i, j) pairs, each of its 256 threads 4 x 4 pairs in
// registers. The block stages 64 columns of its 64 i-rows and 64 j-rows in
// shared memory column-major (a column's 64 row bytes in a 68-byte pitch:
// 17 words, so the staging stores of 32 consecutive columns hit 32 banks,
// and a thread reads its 4 rows as one 32-bit word), with the columns'
// weights, then accumulates in float32 in column order. Tiles below the
// diagonal are not computed: each upper tile writes its pairs and their
// mirror (V and M are symmetric, and (i, j) and (j, i) add the same terms in
// the same order). On the trees' path the weights are integers (ones, or
// bootstrap counts from a multinomial draw of L columns), so every partial
// sum is an integer below 2^24 and the results equal the JAX package's
// float32 matmuls bit for bit in any order of accumulation.
// What bounds it: operations, two predicated float32 adds a (pair, column)
// over the n(n + 1)/2 pairs; its inputs and outputs are a few MB.
//
// inter_counts_kernel. Input: sketches (n, s) int32, each row sorted and
// padded with INT32_MAX, and P pairs of row indices (ai, bi) int64. Output:
// for each pair the number of values of row ai, other than INT32_MAX, that
// row bi holds, int32 (what the JAX function computes through
// searchsorted). One warp a pair: the warp copies row bi into its own slice
// of shared memory, each lane binary-searches its share of row ai's values
// in it (lower bound, the position clamped to s - 1, as the JAX search is),
// and the lanes' counts are summed by a warp reduction. No barrier across
// warps. What bounds it: operations, the compares of the searches; the
// sketches are read from L2 (1 MB at n = 1000, s = 256).
//
// Both launch on the caller's stream and return cudaGetLastError() of the
// launch (0 = launched); tc_error_string names an error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GAP = 20;
constexpr int TILE = 64;                        // i-rows and j-rows of a block
constexpr int CHUNK = 64;                       // columns staged a step
constexpr int PAIRS = 4;                        // i-rows (and j-rows) a thread
constexpr int SIDE = TILE / PAIRS;              // threads along each side: 16
constexpr int THREADS = SIDE * SIDE;            // 256
constexpr int PITCH = TILE + 4;                 // bytes of a staged column
constexpr int IC_WARPS = 8;                     // pairs (warps) a block

__global__ void __launch_bounds__(THREADS)
match_counts_kernel(const uint8_t* __restrict__ aln, const float* __restrict__ w, int n, int L,
                    float* __restrict__ V, float* __restrict__ M) {
    const int ti = blockIdx.y, tj = blockIdx.x;
    if (tj < ti) return;  // mirrored by tile (tj, ti)
    __shared__ __align__(16) uint8_t sa[CHUNK][PITCH];
    __shared__ __align__(16) uint8_t sb[CHUNK][PITCH];
    __shared__ float sw[CHUNK];
    const int tid = threadIdx.x;
    const int tx = tid % SIDE, ty = tid / SIDE;  // j-rows tx*4.., i-rows ty*4..
    const int i0 = ti * TILE, j0 = tj * TILE;
    float v[PAIRS][PAIRS], m[PAIRS][PAIRS];
#pragma unroll
    for (int p = 0; p < PAIRS; ++p)
#pragma unroll
        for (int q = 0; q < PAIRS; ++q) v[p][q] = m[p][q] = 0.f;

    for (int c0 = 0; c0 < L; c0 += CHUNK) {
        // element e of the staging is row e / CHUNK, column e % CHUNK:
        // a warp reads 32 consecutive bytes of one row
        for (int e = tid; e < TILE * CHUNK; e += THREADS) {
            const int r = e / CHUNK, c = e % CHUNK, col = c0 + c;
            uint8_t x = GAP, y = GAP;
            if (col < L) {
                if (i0 + r < n) x = aln[(size_t)(i0 + r) * L + col];
                if (j0 + r < n) y = aln[(size_t)(j0 + r) * L + col];
            }
            sa[c][r] = x;
            sb[c][r] = y;
        }
        if (tid < CHUNK) sw[tid] = c0 + tid < L ? w[c0 + tid] : 0.f;
        __syncthreads();
        const int cn = min(CHUNK, L - c0);
        for (int c = 0; c < cn; ++c) {
            const uint32_t a4 = *reinterpret_cast<const uint32_t*>(&sa[c][ty * PAIRS]);
            const uint32_t b4 = *reinterpret_cast<const uint32_t*>(&sb[c][tx * PAIRS]);
            const float wc = sw[c];
#pragma unroll
            for (int p = 0; p < PAIRS; ++p) {
                const uint32_t a = (a4 >> (8 * p)) & 0xffu;
                const bool a_valid = a != GAP, a_letter = a < GAP;
#pragma unroll
                for (int q = 0; q < PAIRS; ++q) {
                    const uint32_t b = (b4 >> (8 * q)) & 0xffu;
                    if (a_valid && b != GAP) v[p][q] += wc;
                    if (a_letter && a == b) m[p][q] += wc;
                }
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
        const int i = i0 + ty * PAIRS + p;
#pragma unroll
        for (int q = 0; q < PAIRS; ++q) {
            const int j = j0 + tx * PAIRS + q;
            if (i < n && j < n) {
                V[(size_t)i * n + j] = v[p][q];
                M[(size_t)i * n + j] = m[p][q];
                V[(size_t)j * n + i] = v[p][q];
                M[(size_t)j * n + i] = m[p][q];
            }
        }
    }
}

__global__ void __launch_bounds__(IC_WARPS * 32)
inter_counts_kernel(const int32_t* __restrict__ pad, int s, const int64_t* __restrict__ ai,
                    const int64_t* __restrict__ bi, int64_t n_pairs, int32_t* __restrict__ out) {
    extern __shared__ int32_t srow[];  // IC_WARPS rows of s values
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int64_t pair = (int64_t)blockIdx.x * IC_WARPS + warp;
    if (pair >= n_pairs) return;  // the whole warp: no barrier follows across warps
    int32_t* b = srow + warp * s;
    const int32_t* arow = pad + ai[pair] * s;
    const int32_t* brow = pad + bi[pair] * s;
    for (int t = lane; t < s; t += 32) b[t] = brow[t];
    __syncwarp();
    int count = 0;
    for (int t = lane; t < s; t += 32) {
        const int32_t a = arow[t];
        int lo = 0, hi = s;  // lower bound: the first position with b[pos] >= a
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (b[mid] < a) lo = mid + 1;
            else hi = mid;
        }
        const int pos = min(lo, s - 1);
        count += (b[pos] == a) & (a != INT32_MAX);
    }
    count = __reduce_add_sync(0xffffffffu, count);
    if (lane == 0) out[pair] = count;
}

}  // namespace

// aln (n, L) uint8, w (L,) float32 -> V, M (n, n) float32; n >= 1, L >= 0.
extern "C" int tc_match_counts(const void* aln, const void* w, int n, int L, void* V, void* M,
                               void* stream_p) {
    if (n < 1 || L < 0) return (int)cudaErrorInvalidValue;
    const int tiles = (n + TILE - 1) / TILE;
    match_counts_kernel<<<dim3(tiles, tiles), THREADS, 0, static_cast<cudaStream_t>(stream_p)>>>(
        static_cast<const uint8_t*>(aln), static_cast<const float*>(w), n, L,
        static_cast<float*>(V), static_cast<float*>(M));
    return (int)cudaGetLastError();
}

// pad (n, s) int32 rows sorted and INT32_MAX-padded, ai/bi (P,) int64 row
// indices in [0, n) -> out (P,) int32; 1 <= s <= 1536, P >= 1.
extern "C" int tc_inter_counts(const void* pad, int s, const void* ai, const void* bi,
                               long long n_pairs, void* out, void* stream_p) {
    if (s < 1 || n_pairs < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = (n_pairs + IC_WARPS - 1) / IC_WARPS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)IC_WARPS * s * sizeof(int32_t);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // s <= 1536
    inter_counts_kernel<<<(unsigned)blocks, IC_WARPS * 32, smem,
                          static_cast<cudaStream_t>(stream_p)>>>(
        static_cast<const int32_t*>(pad), s, static_cast<const int64_t*>(ai),
        static_cast<const int64_t*>(bi), (int64_t)n_pairs, static_cast<int32_t*>(out));
    return (int)cudaGetLastError();
}

extern "C" const char* tc_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
