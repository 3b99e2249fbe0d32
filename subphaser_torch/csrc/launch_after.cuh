// Programmatic stream serialization (sm_90) for a pair of kernels: the
// second kernel is scheduled while the first one's last blocks run, and
// waits for the first one's completion and memory (griddepcontrol.wait)
// before its first access to memory.
#pragma once

#include <cuda_runtime.h>

namespace {

// Called by the second kernel before its first access to memory.
__device__ __forceinline__ void wait_primary() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launches kernel on stream after the stream's preceding kernel, which may
// still be finishing: the kernel calls wait_primary() first.
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, dim3 block, cudaStream_t stream,
                         Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace
