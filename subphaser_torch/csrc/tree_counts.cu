// Pairwise counts of the LTR trees on Hopper (sm_90a).
//
// Counterparts of two XLA-lowered functions of the JAX package:
//   ltr/msa.py _match_counts   (V = (valid * w) @ valid.T and
//                               M = sum over the 20 residues r of
//                               ((a == r) * w) @ (a == r).T: 21 float32
//                               one-hot matmuls)      -> the bits route
//                                                        (pack_planes_kernel,
//                                                        bit_counts_kernel), and
//                                                        the float route
//                                                        (match_counts_kernel)
//   ltr/tree.py mash_distances.inter_counts
//                              (vmapped searchsorted of one sorted sketch in
//                               another, then an equality count)
//                                                     -> inter_counts_kernel
//
// match_counts. Input: an alignment (n, L) uint8 (GAP = 20; a byte above 20
// is a residue that matches nothing) and column weights (L,) float32. Output
// V and M, (n, n) float32:
//   V[i, j] = sum_c w_c [a_ic != GAP and a_jc != GAP]
//   M[i, j] = sum_c w_c [a_ic == a_jc and a_ic < 20]
//
// The bits route (tc_match_counts_bits), for weights that are non-negative
// integers summing to Lx < EXPANDED_LIMIT, which every call on the trees'
// path has (ones, or bootstrap counts from a multinomial draw of L columns:
// Lx = L). The weighted counts are then plain counts over an expanded column
// list in which column c appears w_c times; the host builds that list (idx,
// Lx int32 column indices). Two launches:
//   pack_planes_kernel: one warp a (row, 32 expanded columns): lane l reads
//     the byte of column idx[word * 32 + l] (GAP past Lx), and one
//     __ballot_sync a plane packs the word: five planes of the residue code
//     (a byte above 20 takes the spare code SPARE), `valid` (byte != GAP) and
//     `letter` (byte < 20), and a zero word, PLANES words a (row, word) in
//     device memory. Packing here and not in the count blocks: each row is
//     in about n / BT_TILE tiles, and would be packed that many times;
//   bit_counts_kernel: a block a BT_TILE x BT_TILE tile of (i, j) pairs of
//     the upper triangle (a 1-D grid of T(T + 1)/2 tiles, T = ceil(n /
//     BT_TILE): 300 blocks at n = 767, up to four an SM at 128 registers a
//     thread, so all in one wave). KGROUPS groups of 64 threads each cover
//     the whole tile, a thread BT_PAIRS x BT_PAIRS pairs (i-rows ty + 8p,
//     j-rows tx + 8q) in int32 registers, group g on words g, g + KGROUPS,
//     ...: 4 warps a block and up to 16 an SM hide the popcounts' latency
//     (4 groups a block, at 2 blocks an SM, and 1 group, ran slower). The
//     block stages KW words of its 2 x BT_TILE rows' planes in shared memory
//     (BT_PITCH = 4 mod 32 words a row: a warp's 16-byte reads of 4 i-rows
//     or 8 j-rows hit distinct banks), then for each pair and word:
//     M += popc(letter_i & ~((x0_i ^ x0_j) | ... | (x4_i ^ x4_j))) and
//     V += popc(valid_i & valid_j), seven LOP3s and two popcounts for 32
//     columns (KW = 20 words a step: one step at the trees' trimmed lengths,
//     L 628). The groups' partial tiles are summed in shared memory and go
//     to coalesced stores of the tile's rows and, off the diagonal, of its
//     mirror (V and M are symmetric). It is launched behind the pack kernel
//     with programmatic stream serialization (launch_after): its blocks are
//     scheduled while the pack's last blocks run and wait for its planes.
// Sums are int32, converted to float32 at the store: exact below 2^24, so
// the values equal the JAX package's float32 matmuls bit for bit.
// What bounds it on this card: the larger of its bytes (the alignment, the
// weights and V and M once) and its popcounts, two a (pair, 32-column word)
// over the n(n + 1)/2 pairs at 16 a clock an SM (the CUDA programming
// guide's throughput for compute capability 9.0).
//
// The float route (tc_match_counts): match_counts_kernel, for any other
// weights (fractions, negatives, or Lx at or above EXPANDED_LIMIT; no path
// passes such weights). It computes V and M directly, a byte compare and a
// predicated float32 add where the matmuls do 21 multiply-adds. A block owns
// a 64 x 64 tile of (i, j) pairs, each of its 256 threads 4 x 4 pairs in
// registers. The block stages 64 columns of its 64 i-rows and 64 j-rows in
// shared memory column-major (a column's 64 row bytes in a 68-byte pitch:
// 17 words, so the staging stores of 32 consecutive columns hit 32 banks,
// and a thread reads its 4 rows as one 32-bit word), with the columns'
// weights, then accumulates in float32 in column order. Tiles below the
// diagonal are not computed: each upper tile writes its pairs and their
// mirror. With integer weights every partial sum is an integer below 2^24
// and it is exact too; with fractions it may differ from the matmuls in the
// last bits. What bounds it: two predicated float32 adds a (pair, column).
//
// inter_counts_kernel. Input: sketches (n, s) int32, each row sorted and
// padded with INT32_MAX, and P pairs of row indices (ai, bi) int64. Output:
// for each pair the number of values of row ai, other than INT32_MAX, that
// row bi holds, int32 (what the JAX function computes through searchsorted).
// One warp takes a run of IC_RUN consecutive pairs; the path's pairs come in
// triu order, so a run's pairs mostly share ai. The warp stages rows into
// four slots of its own shared memory (two for a rows, two for b rows) by
// cp.async copies (16 bytes where the rows are 16-byte aligned),
// double-buffered: pair k + 1's b row, and its a row where ai changes, are
// in flight while pair k is counted, and an a row is staged once for the
// pairs of a run that share it. Each slot ends in INT32_MAX words. The count
// is a warp merge of the two rows: lane l takes the merged positions
// [l * per, (l + 1) * per), per = ceil(2s / 32), finds where its range
// starts in each row by one merge-path search along the diagonal (a value of
// row a before an equal value of row b), then walks its range with no
// branch: a value of row a that it takes is in row b exactly when row b's
// value at the walk's position equals it (the b values before it are the
// smaller ones: the searchsorted position). The lanes' counts are summed by
// a warp reduction. No barrier across warps. What bounds it: operations, a
// merge's compare a value of either row; the sketches are read from L2 (1 MB
// at n = 1000, s = 256).
//
// The entries launch on the caller's stream and return cudaGetLastError()
// of their launches (0 = launched); tc_error_string names an error.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch_after.cuh"

namespace {

constexpr int GAP = 20;
constexpr int TILE = 64;                        // i-rows and j-rows of a block
constexpr int CHUNK = 64;                       // columns staged a step
constexpr int PAIRS = 4;                        // i-rows (and j-rows) a thread
constexpr int SIDE = TILE / PAIRS;              // threads along each side: 16
constexpr int THREADS = SIDE * SIDE;            // 256
constexpr int PITCH = TILE + 4;                 // bytes of a staged column
constexpr int IC_WARPS = 8;                     // warps a block, at most
constexpr int IC_RUN = 4;                       // consecutive pairs a warp
constexpr int IC_SLOTS = 4;                     // a rows x 2, b rows x 2
constexpr int IC_MAX_S = 1536;                  // values a sketch, at most
constexpr int IC_SMEM = 48 * 1024;              // shared memory a block, at most
// the bits route
constexpr int EXPANDED_LIMIT = 1 << 16;         // expanded columns Lx < this (scratch 32 B a
                                                // row and word: 64 MB at n = 1000)
constexpr int SPARE = 31;                       // the code of a byte above GAP
constexpr int PLANES = 8;                       // words a (row, word): x0..x4, valid, letter, 0
constexpr int PACK_WARPS = 8;                   // (row, word) units (warps) a pack block
constexpr int BT_TILE = 32;                     // i-rows and j-rows of a count block
constexpr int BT_PAIRS = 4;                     // i-rows (and j-rows) a thread
constexpr int BT_SIDE = BT_TILE / BT_PAIRS;     // threads along each side of a group: 8
constexpr int BT_GROUP = BT_SIDE * BT_SIDE;     // threads a group, the whole tile: 64
constexpr int KGROUPS = 2;                      // groups a block, each on every 2nd word
constexpr int BT_THREADS = BT_GROUP * KGROUPS;  // 128
constexpr int KW = 20;                          // words of a row staged a step: 640 columns
constexpr int BT_PITCH = KW * PLANES + 4;       // uint32 of a staged row: 164
constexpr int OUT_PITCH = BT_TILE + 1;          // ints of a row of a group's partial tile
constexpr unsigned FULL = 0xffffffffu;

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

__global__ void __launch_bounds__(PACK_WARPS * 32)
pack_planes_kernel(const uint8_t* __restrict__ aln, int n, int L, const int32_t* __restrict__ idx,
                   int Lx, int NW, uint32_t* __restrict__ planes) {
    const int lane = threadIdx.x & 31;
    const long long unit = (long long)blockIdx.x * PACK_WARPS + (threadIdx.x >> 5);
    if (unit >= (long long)n * NW) return;  // the whole warp
    const int row = (int)(unit / NW), c = (int)(unit % NW) * 32 + lane;
    const uint32_t b = c < Lx ? aln[(size_t)row * L + idx[c]] : (uint32_t)GAP;
    const uint32_t code = b <= (uint32_t)GAP ? b : (uint32_t)SPARE;
    uint32_t mine = 0;  // lane q keeps plane q
#pragma unroll
    for (int q = 0; q < 5; ++q) {
        const uint32_t bits = __ballot_sync(FULL, (code >> q) & 1u);
        if (lane == q) mine = bits;
    }
    const uint32_t valid = __ballot_sync(FULL, b != (uint32_t)GAP);
    const uint32_t letter = __ballot_sync(FULL, b < (uint32_t)GAP);
    if (lane == 5) mine = valid;
    if (lane == 6) mine = letter;
    if (lane < PLANES) planes[unit * PLANES + lane] = mine;
}

__global__ void __launch_bounds__(BT_THREADS, 4)
bit_counts_kernel(const uint32_t* __restrict__ planes, int n, int NW, int T,
                  float* __restrict__ V, float* __restrict__ M) {
    __shared__ __align__(16) uint32_t s[2 * BT_TILE * BT_PITCH];  // i-rows, then j-rows
    int ti = 0, rem = blockIdx.x;  // upper tile (ti <= tj), row-major
    while (rem >= T - ti) {
        rem -= T - ti;
        ++ti;
    }
    const int tj = ti + rem;
    const int i0 = ti * BT_TILE, j0 = tj * BT_TILE;
    wait_primary();  // the pack kernel's planes
    const int tid = threadIdx.x, g = tid / BT_GROUP, gt = tid % BT_GROUP;
    const int ty = gt / BT_SIDE, tx = gt % BT_SIDE;
    int v[BT_PAIRS][BT_PAIRS], m[BT_PAIRS][BT_PAIRS];
#pragma unroll
    for (int p = 0; p < BT_PAIRS; ++p)
#pragma unroll
        for (int q = 0; q < BT_PAIRS; ++q) v[p][q] = m[p][q] = 0;

    for (int c0 = 0; c0 < NW; c0 += KW) {
        const int kw = min(KW, NW - c0);
        // element e: staged row e / (2 KW), word (e / 2) % KW, half e % 2; a
        // warp moves 512 contiguous bytes of one row
        for (int e = tid; e < 2 * BT_TILE * KW * 2; e += BT_THREADS) {
            const int r = e / (2 * KW), w = (e / 2) % KW, h = e % 2;
            const int row = r < BT_TILE ? i0 + r : j0 + r - BT_TILE;
            uint4 x = make_uint4(0u, 0u, 0u, 0u);
            if (row < n && w < kw)
                x = *reinterpret_cast<const uint4*>(
                    planes + ((size_t)row * NW + c0 + w) * PLANES + h * 4);
            *reinterpret_cast<uint4*>(&s[r * BT_PITCH + w * PLANES + h * 4]) = x;
        }
        __syncthreads();
        for (int w = g; w < kw; w += KGROUPS) {  // group g: words g, g + KGROUPS, ...
            const uint32_t* sw = s + w * PLANES;
            uint4 b0[BT_PAIRS];  // x0..x3 of the j-rows
            uint2 b1[BT_PAIRS];  // x4, valid
#pragma unroll
            for (int q = 0; q < BT_PAIRS; ++q) {
                const uint32_t* row = sw + (BT_TILE + tx + BT_SIDE * q) * BT_PITCH;
                b0[q] = *reinterpret_cast<const uint4*>(row);
                b1[q] = *reinterpret_cast<const uint2*>(row + 4);
            }
#pragma unroll
            for (int p = 0; p < BT_PAIRS; ++p) {
                const uint32_t* row = sw + (ty + BT_SIDE * p) * BT_PITCH;
                const uint4 a0 = *reinterpret_cast<const uint4*>(row);
                const uint2 a1 = *reinterpret_cast<const uint2*>(row + 4);
                const uint32_t letter = row[6];
#pragma unroll
                for (int q = 0; q < BT_PAIRS; ++q) {
                    const uint32_t d = (a0.x ^ b0[q].x) | (a0.y ^ b0[q].y) | (a0.z ^ b0[q].z) |
                                       (a0.w ^ b0[q].w) | (a1.x ^ b1[q].x);
                    m[p][q] += __popc(letter & ~d);        // a letter, codes equal
                    v[p][q] += __popc(a1.y & b1[q].y);     // both valid
                }
            }
        }
        __syncthreads();
    }
    // each group's partial tile, then their sum: row-major stores of the
    // tile's rows and, off the diagonal, of its mirror
    int* part = reinterpret_cast<int*>(s);  // [KGROUPS][2][BT_TILE][OUT_PITCH]
#pragma unroll
    for (int p = 0; p < BT_PAIRS; ++p)
#pragma unroll
        for (int q = 0; q < BT_PAIRS; ++q) {
            const int at = ((g * 2) * BT_TILE + ty + BT_SIDE * p) * OUT_PITCH + tx + BT_SIDE * q;
            part[at] = v[p][q];
            part[at + BT_TILE * OUT_PITCH] = m[p][q];
        }
    __syncthreads();
    for (int e = tid; e < BT_TILE * BT_TILE; e += BT_THREADS) {
        const int r = e / BT_TILE, c = e % BT_TILE;
        int sv = 0, sm = 0, tv = 0, tm = 0;
#pragma unroll
        for (int k = 0; k < KGROUPS; ++k) {
            const int* pv = part + (k * 2) * BT_TILE * OUT_PITCH;
            const int* pm = pv + BT_TILE * OUT_PITCH;
            sv += pv[r * OUT_PITCH + c];
            sm += pm[r * OUT_PITCH + c];
            tv += pv[c * OUT_PITCH + r];
            tm += pm[c * OUT_PITCH + r];
        }
        if (i0 + r < n && j0 + c < n) {  // row i0 + r of the tile
            V[(size_t)(i0 + r) * n + j0 + c] = (float)sv;
            M[(size_t)(i0 + r) * n + j0 + c] = (float)sm;
        }
        if (ti != tj && j0 + r < n && i0 + c < n) {  // row j0 + r of the mirror
            V[(size_t)(j0 + r) * n + i0 + c] = (float)tv;
            M[(size_t)(j0 + r) * n + i0 + c] = (float)tm;
        }
    }
}

// words of a slot of s values: the row, then at least ceil(2s / 32) + 1 words
// of INT32_MAX (a lane's walk reads past a row's end by at most its length,
// and once more for the value after its last step), rounded to 16 bytes
__host__ __device__ __forceinline__ int ic_slot_words(int s) {
    return (s + (2 * s + 31) / 32 + 1 + 3) & ~3;
}

// row src (s values) into the slot at dst by the warp's lanes: 16-byte copies
// where the rows are 16-byte aligned (vec), else 4-byte copies
__device__ __forceinline__ void ic_stage(int32_t* dst, const int32_t* __restrict__ src, int s,
                                         bool vec, int lane) {
    if (vec) {
        for (int p = 4 * lane; p < s; p += 128) {
            const unsigned d = (unsigned)__cvta_generic_to_shared(dst + p);
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src + p)
                         : "memory");
        }
    } else {
        for (int p = lane; p < s; p += 32) {
            const unsigned d = (unsigned)__cvta_generic_to_shared(dst + p);
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src + p)
                         : "memory");
        }
    }
}

// the values of a that b holds (a's INT32_MAX excepted), on lane's range of
// the merge of two slots of s values
__device__ __forceinline__ int ic_merge_count(const int32_t* a, const int32_t* b, int s,
                                              int lane) {
    const int total = 2 * s, per = (total + 31) / 32;
    const int d0 = min(lane * per, total), d1 = min(d0 + per, total);
    int lo = max(0, d0 - s), hi = min(d0, s);
    while (lo < hi) {  // a values among the first d0 of the merge, a before b on ties
        const int mid = (lo + hi) >> 1;
        if (a[mid] <= b[d0 - 1 - mid]) lo = mid + 1;
        else hi = mid;
    }
    // The walk, with no branch and one load a step (the value that replaces
    // the one taken). Past a row's end it reads the slot's INT32_MAX words: a
    // real value of a then goes before them and finds no equal, and an
    // INT32_MAX of a counts nothing, so no step needs to know where the rows
    // end.
    int i = lo, j = d0 - lo, count = 0;
    int32_t av = a[i], bv = b[j];
    for (int d = d0; d < d1; ++d) {
        const bool take_a = av <= bv;
        count += (av == bv) & (av != INT32_MAX);
        i += take_a;
        j += !take_a;
        const int32_t x = *(take_a ? a + i : b + j);
        av = take_a ? x : av;
        bv = take_a ? bv : x;
    }
    return count;
}

__global__ void __launch_bounds__(IC_WARPS * 32)
inter_counts_kernel(const int32_t* __restrict__ pad, int s, const int64_t* __restrict__ ai,
                    const int64_t* __restrict__ bi, int64_t n_pairs, bool vec,
                    int32_t* __restrict__ out) {
    extern __shared__ __align__(16) int32_t ic_slots[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t p0 = ((int64_t)blockIdx.x * (blockDim.x >> 5) + warp) * IC_RUN;
    if (p0 >= n_pairs) return;  // the whole warp: no barrier follows across warps
    const int np = (int)min((int64_t)IC_RUN, n_pairs - p0);
    const int sw = ic_slot_words(s);
    int32_t* slot = ic_slots + warp * IC_SLOTS * sw;  // a0, a1, b0, b1
    for (int e = lane; e < IC_SLOTS * (sw - s); e += 32)  // each slot's INT32_MAX words
        slot[e / (sw - s) * sw + s + e % (sw - s)] = INT32_MAX;
    // the run's row indices, lane k holding pair k's
    const int64_t my_a = lane < np ? ai[p0 + lane] : 0, my_b = lane < np ? bi[p0 + lane] : 0;
    int64_t cur_a = __shfl_sync(0xffffffffu, my_a, 0);
    ic_stage(slot, pad + cur_a * s, s, vec, lane);
    ic_stage(slot + 2 * sw, pad + __shfl_sync(0xffffffffu, my_b, 0) * s, s, vec, lane);
    asm volatile("cp.async.commit_group;" ::: "memory");
    int aslot = 0;
    for (int k = 0; k < np; ++k) {
        int next_aslot = aslot;
        const int64_t next_a = __shfl_sync(0xffffffffu, my_a, min(k + 1, np - 1));
        const int64_t next_b = __shfl_sync(0xffffffffu, my_b, min(k + 1, np - 1));
        if (k + 1 < np) {
            if (next_a != cur_a) {  // a new a row: into the a slot not in use
                next_aslot = aslot ^ 1;
                ic_stage(slot + next_aslot * sw, pad + next_a * s, s, vec, lane);
            }
            ic_stage(slot + (2 + ((k + 1) & 1)) * sw, pad + next_b * s, s, vec, lane);
        }
        asm volatile("cp.async.commit_group;" ::: "memory");  // empty at the run's end
        asm volatile("cp.async.wait_group 1;" ::: "memory");  // pair k's rows, this lane's
        __syncwarp();                                         // and every lane's
        int count = ic_merge_count(slot + aslot * sw, slot + (2 + (k & 1)) * sw, s, lane);
        count = __reduce_add_sync(0xffffffffu, count);
        if (lane == 0) out[p0 + k] = count;
        __syncwarp();  // pair k's slots are staged again for pair k + 2
        aslot = next_aslot;
        cur_a = next_a;
    }
}

}  // namespace

// The bits route. aln (n, L) uint8, idx (Lx,) int32 column indices in [0, L)
// (column c repeated w_c times), planes uint32 scratch of n * ceil(Lx / 32)
// * PLANES words -> V, M (n, n) float32; n >= 1, 0 <= Lx < EXPANDED_LIMIT.
extern "C" int tc_match_counts_bits(const void* aln, int n, int L, const void* idx, int Lx,
                                    void* planes, void* V, void* M, void* stream_p) {
    if (n < 1 || L < 0 || Lx < 0 || Lx >= EXPANDED_LIMIT) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
    const int NW = (Lx + 31) / 32;
    if (NW > 0) {
        const long long units = (long long)n * NW;
        pack_planes_kernel<<<(unsigned)((units + PACK_WARPS - 1) / PACK_WARPS), PACK_WARPS * 32,
                             0, stream>>>(static_cast<const uint8_t*>(aln), n, L,
                                          static_cast<const int32_t*>(idx), Lx, NW,
                                          static_cast<uint32_t*>(planes));
    }
    const int T = (n + BT_TILE - 1) / BT_TILE;
    const cudaError_t err = launch_after(
        bit_counts_kernel, dim3(T * (T + 1) / 2), dim3(BT_THREADS), stream,
        static_cast<const uint32_t*>(planes), n, NW, T, static_cast<float*>(V),
        static_cast<float*>(M));
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The float route. aln (n, L) uint8, w (L,) float32 -> V, M (n, n) float32;
// n >= 1, L >= 0.
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
    if (s < 1 || s > IC_MAX_S || n_pairs < 1) return (int)cudaErrorInvalidValue;
    const int warp_bytes = IC_SLOTS * ic_slot_words(s) * (int)sizeof(int32_t);
    const int fit = IC_SMEM / warp_bytes;
    const int warps = fit < IC_WARPS ? fit : IC_WARPS;  // 8 at s 256, 1 at s 1536
    const long long runs = (n_pairs + IC_RUN - 1) / IC_RUN;
    const long long blocks = (runs + warps - 1) / warps;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const bool vec = s % 4 == 0 && reinterpret_cast<uintptr_t>(pad) % 16 == 0;
    inter_counts_kernel<<<(unsigned)blocks, warps * 32, (size_t)warps * warp_bytes,
                          static_cast<cudaStream_t>(stream_p)>>>(
        static_cast<const int32_t*>(pad), s, static_cast<const int64_t*>(ai),
        static_cast<const int64_t*>(bi), (int64_t)n_pairs, vec, static_cast<int32_t*>(out));
    return (int)cudaGetLastError();
}

extern "C" const char* tc_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
