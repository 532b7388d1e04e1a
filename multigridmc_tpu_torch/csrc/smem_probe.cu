// Probe of the dynamic shared memory a thread block is granted, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas kernel of _probe_limit_compiles in
// multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py, an (8, 128) float32 copy
// that tells whether a raised fast-memory limit is granted.  Here: one block
// copies n floats from `in` to `out` through `smem_bytes` of dynamic shared
// memory (the values are spread over the whole region), after asking for that
// size with cudaFuncAttributeMaxDynamicSharedMemorySize.  A card that does not
// grant the size refuses the attribute or the launch, and the caller (the
// subtree kernel's placement of fields) then asks for less.
//
// Bound: n floats read and written once; the launch is latency.

#include <cuda_runtime.h>

extern __shared__ float probe_smem[];

__global__ void smem_probe_kernel(const float* __restrict__ in, float* __restrict__ out, int n,
                                  int stride) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) probe_smem[(size_t)i * stride] = in[i];
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = probe_smem[(size_t)i * stride];
}

// 0: copied; 1000 + e: the size was refused with CUDA error e before any
// launch; otherwise the launch's CUDA error.
extern "C" int smem_probe(const float* in, float* out, int n, int smem_bytes, void* stream) {
    const int nfloats = smem_bytes / (int)sizeof(float);
    if (n < 1 || nfloats < n) return 1000 + (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return 1000 + (int)e;
    }
    smem_probe_kernel<<<1, 256, smem_bytes, (cudaStream_t)stream>>>(in, out, n, nfloats / n);
    return (int)cudaGetLastError();
}
