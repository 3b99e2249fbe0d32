// Compare-exchange primitives of the bitonic sort on Hopper (sm_90a).
//
// Counterparts of the four Pallas kernels the JAX package keeps beside its
// VMEM sort:
//   K3  ops/sort_vmem.py `_block_sort_kernel`: every phase of a block sort
//       in one straight-line program      -> block_sort_unrolled<BITS>
//   K4  tools/bench_sort_primitives.py `pallas_block_map(body)`: one body
//       per candidate                     -> tile_stages / global_stage,
//                                            elementwise_chain, transpose_tiles
//   K5  same tool, `_descent_masked`      -> tile_stages with a direction bit
//   K6  same tool, `_descent_grid2d`      -> tile_stages on a strided tile,
//                                            revisits looped inside the kernel
//
// Each computes the function of its TPU kernel on the WHOLE int32 array, not
// its blocking: the TPU held a 2^18-key block in VMEM; a CUDA block holds a
// tile of at most 2^13 keys (32 KB of static shared memory). Where the
// partner x[i ^ stride] of a stage lives decides its cost, and is what the
// sort-primitives tool measures. For a tile, by LOCAL stride bit:
//   0..1   inside the thread's own int4 (registers)
//   2..6   another lane of the warp (__shfl_xor_sync)
//   7..12  another warp of the block (shared memory)
// and a stride of 2^13 or more on a contiguous tile is one pass over device
// memory (global_stage). A tile need not be contiguous: its low 7 index
// bits are (128 keys = 512 bytes, coalesced), the others may be any set of
// global bits, so K6's strides {2^0..2^6, 2^10, 2^12, 2^14, 2^16} all stay
// inside one 2^11-key tile and the block stays resident across revisits.
//
// What bounds them: bytes (8n: one read and one write of the array). Every
// launch reads its input once and writes its output once; the work between
// is registers, shuffles and shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_BITS 13
#define TILE (1 << TILE_BITS)
#define THREADS 512
#define LOW_BITS 7        // contiguous low index bits of every tile
#define SMEM_LEVEL 7      // local stride bits >= this go through shared memory
#define MAX_STAGES 96
#define MAX_HIGH (TILE_BITS - LOW_BITS)
#define TDIM 128          // transpose tile edge
#define TPAD (TDIM + 1)   // padded row: conflict-free column access

struct StageList {
    int n;
    unsigned char sb[MAX_STAGES];  // LOCAL bit of each stage's stride
};

// Local index bit j of a tile is global bit j for j < lowb and global bit
// high[j - lowb] above; the tile id fills the remaining global bits.
struct TileMap {
    int tile_bits;
    int lowb;
    int nhigh;
    int high[MAX_HIGH];
};

__device__ __forceinline__ long long tile_base(long long tile, const TileMap& m) {
    long long g = 0;
    int hi = 0, bit = m.lowb;
    while (tile) {
        if (hi < m.nhigh && m.high[hi] == bit) {
            ++hi;
        } else {
            g |= (tile & 1) << bit;
            tile >>= 1;
        }
        ++bit;
    }
    return g;
}

__device__ __forceinline__ long long local_offset(int l, const TileMap& m) {
    long long g = l & ((1 << m.lowb) - 1);
    const int lh = l >> m.lowb;
    for (int i = 0; i < m.nhigh; ++i) g |= (long long)((lh >> i) & 1) << m.high[i];
    return g;
}

// Direction of the pair whose lower local index is i: descending iff local
// bit dir_bit of i is set (dir_bit < 0: ascending everywhere).
__device__ __forceinline__ bool pair_desc(int i, int dir_bit) {
    return dir_bit >= 0 && ((i >> dir_bit) & 1);
}

__device__ __forceinline__ void cmpx_reg(int& a, int& b, bool desc) {
    const int mn = min(a, b), mx = max(a, b);
    a = desc ? mx : mn;
    b = desc ? mn : mx;
}

// One stage at local stride bit sb < SMEM_LEVEL on the four keys v[] that
// start at local index l (l % 4 == 0, lane = (l >> 2) % 32).
__device__ __forceinline__ void reg_stage(int (&v)[4], int sb, int l, int dir_bit) {
    if (sb == 0) {
        cmpx_reg(v[0], v[1], pair_desc(l, dir_bit));
        cmpx_reg(v[2], v[3], pair_desc(l + 2, dir_bit));
    } else if (sb == 1) {
        cmpx_reg(v[0], v[2], pair_desc(l, dir_bit));
        cmpx_reg(v[1], v[3], pair_desc(l + 1, dir_bit));
    } else {
        const int stride = 1 << sb;
        const bool is_lo = (l & stride) == 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int other = __shfl_xor_sync(0xffffffffu, v[e], stride >> 2);
            const bool desc = pair_desc((l + e) & ~stride, dir_bit);
            v[e] = (is_lo != desc) ? min(v[e], other) : max(v[e], other);
        }
    }
}

// Runs `revisits` times the stage list on one tile held in shared memory.
// The two structs are indexed at run time: as __grid_constant__ they are read
// in place from the parameter bank; without it every thread first copies
// them to its local-memory stack, which tripled the time of a launch.
__global__ void __launch_bounds__(THREADS, 4)
tile_stages(const int* src, int* dst, const __grid_constant__ StageList st,
            const __grid_constant__ TileMap map, int dir_bit, int revisits) {
    __shared__ __align__(16) int s[TILE];
    const int ntile = 1 << map.tile_bits;
    const int nchunk = ntile >> 2;
    const long long base = tile_base(blockIdx.x, map);
    // all of a thread's loads start before the first is used, so each
    // thread keeps up to four 16-byte requests in flight
    int4 q[TILE / 4 / THREADS];
#pragma unroll
    for (int k = 0; k < TILE / 4 / THREADS; ++k) {
        const int c = threadIdx.x + k * blockDim.x;
        if (c < nchunk)
            q[k] = *reinterpret_cast<const int4*>(src + base + local_offset(c << 2, map));
    }
#pragma unroll
    for (int k = 0; k < TILE / 4 / THREADS; ++k) {
        const int c = threadIdx.x + k * blockDim.x;
        if (c < nchunk) *reinterpret_cast<int4*>(s + (c << 2)) = q[k];
    }
    __syncthreads();
    for (int r = 0; r < revisits; ++r) {
        int i = 0;
        while (i < st.n) {
            const int sb = st.sb[i];
            if (sb >= SMEM_LEVEL) {
                const int stride = 1 << sb;
                for (int t = threadIdx.x; t < (ntile >> 1); t += blockDim.x) {
                    const int lo = ((t >> sb) << (sb + 1)) | (t & (stride - 1));
                    const int a = s[lo], b = s[lo | stride];
                    if ((a > b) != pair_desc(lo, dir_bit)) {
                        s[lo] = b;
                        s[lo | stride] = a;
                    }
                }
                ++i;
            } else {
                // a run of register/shuffle stages: one trip through registers
                int j = i;
                while (j < st.n && st.sb[j] < SMEM_LEVEL) ++j;
                for (int c = threadIdx.x; c < nchunk; c += blockDim.x) {
                    const int l = c << 2;
                    const int4 w = *reinterpret_cast<const int4*>(s + l);
                    int v[4] = {w.x, w.y, w.z, w.w};
                    for (int a = i; a < j; ++a) reg_stage(v, st.sb[a], l, dir_bit);
                    *reinterpret_cast<int4*>(s + l) = make_int4(v[0], v[1], v[2], v[3]);
                }
                i = j;
            }
            __syncthreads();
        }
    }
    for (int c = threadIdx.x; c < nchunk; c += blockDim.x) {
        const int l = c << 2;
        *reinterpret_cast<int4*>(dst + base + local_offset(l, map)) =
            *reinterpret_cast<const int4*>(s + l);
    }
}

// One ascending stage at stride 2^sb through device memory.
__global__ void global_stage(const int* src, int* dst, long long n_half, int sb) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_half) return;
    const long long i = ((t >> sb) << (sb + 1)) | (t & ((1LL << sb) - 1));
    const long long j = i | (1LL << sb);
    const int a = src[i], b = src[j];
    dst[i] = min(a, b);
    dst[j] = max(a, b);
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

// K3: bitonic phases 1..BITS of each 2^BITS-key block, phases and strides
// unrolled at compile time. Direction of a pair = bit p of its global index
// (block parity in the last phase; ascending when the array is one block).
template <int BITS>
__global__ void block_sort_unrolled(const int* src, int* dst) {
    constexpr int N = 1 << BITS;
    constexpr int NT = (N / 2) < THREADS ? (N / 2) : THREADS;
    __shared__ int s[N];
    const long long base = (long long)blockIdx.x * N;
#pragma unroll
    for (int i = threadIdx.x; i < N; i += NT) s[i] = src[base + i];
    __syncthreads();
#pragma unroll
    for (int p = 1; p <= BITS; ++p) {
#pragma unroll
        for (int sb = p - 1; sb >= 0; --sb) {
#pragma unroll
            for (int t = threadIdx.x; t < N / 2; t += NT) {
                const int i = ((t >> sb) << (sb + 1)) | (t & ((1 << sb) - 1));
                const bool desc = ((base + i) >> p) & 1;
                const int a = s[i], b = s[i | (1 << sb)];
                if ((a > b) != desc) {
                    s[i] = b;
                    s[i | (1 << sb)] = a;
                }
            }
            __syncthreads();
        }
    }
#pragma unroll
    for (int i = threadIdx.x; i < N; i += NT) dst[base + i] = s[i];
}

template <int BITS>
static cudaError_t launch_block_sort(const int* src, int* dst, long long n, cudaStream_t stream) {
    constexpr int N = 1 << BITS;
    constexpr int NT = (N / 2) < THREADS ? (N / 2) : THREADS;
    block_sort_unrolled<BITS><<<(unsigned)(n / N), NT, 0, stream>>>(src, dst);
    return cudaGetLastError();
}

extern "C" int sp_tile_bits(void) { return TILE_BITS; }

// Phases 1..min(total_bits, TILE_BITS) of src[0 .. 2^total_bits) into dst.
// Every entry point returns the first cudaError_t of its launches (0 on
// success) and does not synchronise.
extern "C" int sp_block_sort_unrolled(const void* src_p, void* dst_p, int total_bits,
                                      void* stream_p) {
    const int* src = static_cast<const int*>(src_p);
    int* dst = static_cast<int*>(dst_p);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
    if (total_bits < 1 || total_bits > 31) return (int)cudaErrorInvalidValue;
    const long long n = 1LL << total_bits;
    switch (total_bits < TILE_BITS ? total_bits : TILE_BITS) {
        case 1: return (int)launch_block_sort<1>(src, dst, n, stream);
        case 2: return (int)launch_block_sort<2>(src, dst, n, stream);
        case 3: return (int)launch_block_sort<3>(src, dst, n, stream);
        case 4: return (int)launch_block_sort<4>(src, dst, n, stream);
        case 5: return (int)launch_block_sort<5>(src, dst, n, stream);
        case 6: return (int)launch_block_sort<6>(src, dst, n, stream);
        case 7: return (int)launch_block_sort<7>(src, dst, n, stream);
        case 8: return (int)launch_block_sort<8>(src, dst, n, stream);
        case 9: return (int)launch_block_sort<9>(src, dst, n, stream);
        case 10: return (int)launch_block_sort<10>(src, dst, n, stream);
        case 11: return (int)launch_block_sort<11>(src, dst, n, stream);
        case 12: return (int)launch_block_sort<12>(src, dst, n, stream);
        default: return (int)launch_block_sort<TILE_BITS>(src, dst, n, stream);
    }
}

static bool stages_valid(long long n, const unsigned char* bits, int n_stages) {
    if (n <= 0 || n % TILE != 0 || n_stages < 0) return false;
    for (int i = 0; i < n_stages; ++i)
        if (bits[i] > 30 || n % (2LL << bits[i]) != 0) return false;
    return true;
}

// The stages bits[0..n_stages) (stride 2^bits[i]) in order over src[0..n)
// into dst, on contiguous tiles: runs of strides < 2^TILE_BITS are one
// tile_stages launch each, a larger stride is one global_stage launch.
// dir_bit >= 0: pairs sort descending where that index bit is set; it must
// lie inside the tile and above every stride. No stage: a plain copy
// through shared memory.
extern "C" int sp_run_stages(const void* src_p, void* dst_p, long long n,
                             const unsigned char* bits, int n_stages, int dir_bit,
                             void* stream_p) {
    const int* cur = static_cast<const int*>(src_p);
    int* dst = static_cast<int*>(dst_p);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
    if (!stages_valid(n, bits, n_stages) || dir_bit >= TILE_BITS)
        return (int)cudaErrorInvalidValue;
    if (dir_bit >= 0)
        for (int i = 0; i < n_stages; ++i)
            if (bits[i] >= dir_bit) return (int)cudaErrorInvalidValue;
    TileMap map = {TILE_BITS, TILE_BITS, 0, {0}};
    int i = 0;
    do {
        if (i < n_stages && bits[i] >= TILE_BITS) {
            const long long n_half = n >> 1;
            global_stage<<<(unsigned)((n_half + 255) / 256), 256, 0, stream>>>(
                cur, dst, n_half, bits[i++]);
        } else {
            StageList st;
            st.n = 0;
            while (i < n_stages && bits[i] < TILE_BITS && st.n < MAX_STAGES)
                st.sb[st.n++] = bits[i++];
            tile_stages<<<(unsigned)(n / TILE), THREADS, 0, stream>>>(
                cur, dst, st, map, dir_bit, 1);
        }
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        cur = dst;
    } while (i < n_stages);
    return 0;
}

// `revisits` times the ascending stages bits[0..n_stages) in ONE launch:
// the tile is the low LOW_BITS index bits plus every distinct stride bit
// above them (at most MAX_HIGH), so all stages stay on chip.
extern "C" int sp_run_stages_resident(const void* src_p, void* dst_p, long long n,
                                      const unsigned char* bits, int n_stages,
                                      int revisits, void* stream_p) {
    const int* src = static_cast<const int*>(src_p);
    int* dst = static_cast<int*>(dst_p);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
    if (!stages_valid(n, bits, n_stages) || n_stages > MAX_STAGES || revisits < 1)
        return (int)cudaErrorInvalidValue;
    TileMap map = {LOW_BITS, LOW_BITS, 0, {0}};
    for (int b = LOW_BITS; b <= 30; ++b) {
        bool used = false;
        for (int i = 0; i < n_stages; ++i) used = used || bits[i] == b;
        if (!used) continue;
        if (map.nhigh == MAX_HIGH) return (int)cudaErrorInvalidValue;
        map.high[map.nhigh++] = b;
    }
    map.tile_bits = LOW_BITS + map.nhigh;
    StageList st;
    st.n = n_stages;
    for (int i = 0; i < n_stages; ++i) {
        int local = bits[i];
        for (int h = 0; h < map.nhigh; ++h)
            if (map.high[h] == bits[i]) local = LOW_BITS + h;
        st.sb[i] = (unsigned char)local;
    }
    const int ntile = 1 << map.tile_bits;
    const int threads = (ntile >> 2) < THREADS ? (ntile >> 2) : THREADS;
    tile_stages<<<(unsigned)(n / ntile), threads, 0, stream>>>(src, dst, st, map, -1, revisits);
    return (int)cudaGetLastError();
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
    return cudaGetErrorString((cudaError_t)err);
}
