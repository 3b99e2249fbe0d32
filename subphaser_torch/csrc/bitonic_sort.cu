// Bitonic sort of a power-of-two int32 array on Hopper (sm_90a).
//
// Replaces the JAX package's Pallas VMEM bitonic sort
// (ops/sort_vmem.py: K1 `_block_sort_kernel_grid` and K2 `_descent_kernel`,
// with the XLA `_cross_stage` min/max between them). It computes the same
// function: an ascending sort of n = 2^t int32 keys, SENTINEL (INT32_MAX)
// padding trailing, for every t >= 1.
//
// Schedule (BLK = 2^BLK_BITS keys per CUDA block, held in shared memory):
//   (a) block_sort: bitonic phases 1..min(t, BLK_BITS) inside each block;
//       the direction of an element in phase p is bit p of its GLOBAL index
//       (which is 0 everywhere in the last phase p = t, i.e. ascending).
//   (b) global_stage: for each merge level p > BLK_BITS, the strides
//       2^(p-1)..BLK, one launch per stride, one thread per pair, in device
//       memory.
//   (c) descent: then strides BLK/2..1 of level p in shared memory, with one
//       direction per block (bit p of the block's first index).
//
// What bounds it: bytes. Each global stage reads and writes all 4n bytes
// once; the block sort and each descent also move 8n bytes through device
// memory, and their inner stages run at shared-memory bandwidth. At
// n = 2^27 and BLK = 2^13 that is 105 global stages + 15 shared passes,
// ~120 x 8n bytes, against a bound of 8n bytes (one read, one write).
//
// Why the block is small: the TPU kernel held 2^18 keys (1 MiB) in VMEM; a
// CUDA block can use at most 227 KB of shared memory, and the static
// 48 KB limit is enough for 2^13 keys (32 KB) with several blocks resident
// per SM, so no dynamic shared-memory attribute is needed. Merging several
// global stages per launch (fewer passes over device memory) is left to a
// later change.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLK_BITS 13
#define BLK (1 << BLK_BITS)
#define THREADS 512

__device__ __forceinline__ void cmpx(int* s, int i, int j, bool desc) {
    int a = s[i], b = s[j];
    if ((a > b) != desc) {
        s[i] = b;
        s[j] = a;
    }
}

// (a) phases 1..local_bits on blocks of 2^local_bits keys.
__global__ void block_sort(int* x, int local_bits) {
    __shared__ int s[BLK];
    const int nloc = 1 << local_bits;
    const long long base = (long long)blockIdx.x * nloc;
    for (int i = threadIdx.x; i < nloc; i += blockDim.x) s[i] = x[base + i];
    __syncthreads();
    for (int p = 1; p <= local_bits; ++p) {
        for (int sb = p - 1; sb >= 0; --sb) {
            const int stride = 1 << sb;
            for (int t = threadIdx.x; t < (nloc >> 1); t += blockDim.x) {
                const int i = ((t >> sb) << (sb + 1)) | (t & (stride - 1));
                const bool desc = ((base + i) >> p) & 1;
                cmpx(s, i, i | stride, desc);
            }
            __syncthreads();
        }
    }
    for (int i = threadIdx.x; i < nloc; i += blockDim.x) x[base + i] = s[i];
}

// (b) one compare-exchange stage at stride 2^sb >= BLK of merge level p.
__global__ void global_stage(int* x, long long n_half, int sb, int p) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_half) return;
    const long long i = ((t >> sb) << (sb + 1)) | (t & ((1LL << sb) - 1));
    const long long j = i | (1LL << sb);
    const bool desc = (i >> p) & 1;
    const int a = x[i], b = x[j];
    const int mn = a < b ? a : b, mx = a < b ? b : a;
    x[i] = desc ? mx : mn;
    x[j] = desc ? mn : mx;
}

// (c) strides BLK/2..1 of merge level p > BLK_BITS, one direction per block.
__global__ void descent(int* x, int p) {
    __shared__ int s[BLK];
    const long long base = (long long)blockIdx.x * BLK;
    for (int i = threadIdx.x; i < BLK; i += blockDim.x) s[i] = x[base + i];
    __syncthreads();
    const bool desc = (base >> p) & 1;
    for (int sb = BLK_BITS - 1; sb >= 0; --sb) {
        const int stride = 1 << sb;
        for (int t = threadIdx.x; t < BLK / 2; t += blockDim.x) {
            const int i = ((t >> sb) << (sb + 1)) | (t & (stride - 1));
            cmpx(s, i, i | stride, desc);
        }
        __syncthreads();
    }
    for (int i = threadIdx.x; i < BLK; i += blockDim.x) x[base + i] = s[i];
}

extern "C" int bitonic_blk_bits(void) { return BLK_BITS; }

// Sorts x[0 .. 2^total_bits) in place on `stream`. Returns the first
// cudaError_t of any launch (0 on success); does not synchronise.
extern "C" int bitonic_sort_int32(void* x_ptr, int total_bits, void* stream_ptr) {
    int* x = static_cast<int*>(x_ptr);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (total_bits < 1 || total_bits > 31) return (int)cudaErrorInvalidValue;
    const long long n = 1LL << total_bits;
    const int local_bits = total_bits < BLK_BITS ? total_bits : BLK_BITS;
    const int nloc = 1 << local_bits;
    const int threads_small = (nloc >> 1) < THREADS ? (nloc >> 1) : THREADS;
    block_sort<<<(unsigned)(n / nloc), threads_small, 0, stream>>>(x, local_bits);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long n_half = n >> 1;
    const unsigned stage_blocks = (unsigned)((n_half + 255) / 256);
    for (int p = BLK_BITS + 1; p <= total_bits; ++p) {
        for (int sb = p - 1; sb >= BLK_BITS; --sb) {
            global_stage<<<stage_blocks, 256, 0, stream>>>(x, n_half, sb, p);
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
        descent<<<(unsigned)(n / BLK), THREADS, 0, stream>>>(x, p);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

// Phase (a) alone, in place: what the unrolled block sort of
// sort_primitives.cu is held against.
extern "C" int bitonic_block_sort_int32(void* x_ptr, int total_bits, void* stream_ptr) {
    if (total_bits < 1 || total_bits > 31) return (int)cudaErrorInvalidValue;
    const long long n = 1LL << total_bits;
    const int local_bits = total_bits < BLK_BITS ? total_bits : BLK_BITS;
    const int nloc = 1 << local_bits;
    const int threads = (nloc >> 1) < THREADS ? (nloc >> 1) : THREADS;
    block_sort<<<(unsigned)(n / nloc), threads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
        static_cast<int*>(x_ptr), local_bits);
    return (int)cudaGetLastError();
}

extern "C" const char* bitonic_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
