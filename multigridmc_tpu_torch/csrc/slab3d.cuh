// What the 3d kernels that hold a chain's field in shared memory share
// (mgmc_visit_smem3d.cu: the 3d level visits; sor_sweep_smem3d.cu: the 3d
// 7-point sweeps): the field cut into slabs of whole z-planes over a
// thread-block cluster of S blocks, block k holding its slab in dynamic
// shared memory, each plane padded with a zero row and column a side (a
// padded row PX = W + 2 floats, a padded plane PP = (Y + 2) PX), with one
// padded ghost plane a side: the neighbouring ranks' edge planes, copied in
// after each cluster barrier (zero at the field's two z faces).  Slab plane lz
// sits at padded plane lz + 1.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block_stamps.cuh"

namespace cg = cooperative_groups;

// first plane and number of planes of rank k of S over Z planes: the first
// Z % S ranks take one more
__device__ __forceinline__ void slab_of(int Z, int S, int k, int* z0, int* nz) {
    const int base = Z / S, rem = Z % S;
    *nz = base + (k < rem ? 1 : 0);
    *z0 = k * base + (k < rem ? k : rem);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The slab's nz planes of x (the field's planes from xf on, Y rows of W) into
// their padded planes with cp.async, one warp a padded row (4 bytes a thread:
// a 63-float row is only 4-byte aligned, so no TMA); the halo and both ghost
// planes zeroed.  The caller waits for the copies (cp_async_wait_all).
__device__ __forceinline__ void slab_load(float* xs, const float* xf, int nz, int Y, int W,
                                          int PX) {
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < (nz + 2) * (Y + 2); r += blockDim.x >> 5) {
        const int pl = r / (Y + 2), yy = r - pl * (Y + 2);
        const int lz = pl - 1, y = yy - 1;
        const bool live = lz >= 0 && lz < nz && y >= 0 && y < Y;
        for (int jq = lane; jq < PX; jq += 32) {
            const int j = jq - 1;
            if (live && j >= 0 && j < W)
                cp_async4(xs + r * PX + jq, xf + (lz * Y + y) * W + j);
            else
                xs[r * PX + jq] = 0.0f;
        }
    }
}

// The slab's planes back to the field (from xf on), once, coalesced: one warp
// a row.
__device__ __forceinline__ void slab_store(const float* xs, float* xf, int nz, int Y, int W,
                                           int PX) {
    const int lane = threadIdx.x & 31;
    for (int lr = threadIdx.x >> 5; lr < nz * Y; lr += blockDim.x >> 5) {
        const int lz = lr / Y, y = lr - lz * Y;
        for (int j = lane; j < W; j += 32)
            xf[lr * W + j] = xs[((lz + 1) * (Y + 2) + y + 1) * PX + j + 1];
    }
}

// A barrier of the cluster (of the block where S is 1 or `block` is set),
// counted and stamped by thread 0 in the stamps build.
template <bool STAMPS>
__device__ __forceinline__ void smem_sync(cg::cluster_group& cluster, int S, bool block = false) {
    if (S > 1 && !block)
        cluster.sync();
    else
        __syncthreads();
    if (STAMPS && threadIdx.x == 0) {
        ++pass_sync_count;
        pass_stamp_row[pass_sync_count] = global_timer();
    }
}

// The ghost copy: the neighbours' edge planes (rank - 1's last, rank + 1's
// first; xlo, xhi their slabs in the cluster's shared memory) into this
// block's ghost planes, every point of the plane, then a block barrier.
// Called after a cluster barrier, before a pass that reads across a cut.
__device__ __forceinline__ void ghost_copy(int S, int PX, int PP, float* xs, const float* xlo,
                                           const float* xhi, int rank, int nz, int lo_nz, int Y,
                                           int W) {
    const int n2 = Y * W;
    const bool lo = rank > 0, hi = rank + 1 < S;
    for (int t = threadIdx.x; t < (lo + hi) * n2; t += blockDim.x) {
        const bool up = !lo || t >= n2;
        const int e = up && lo ? t - n2 : t;
        const int y = e / W, j = e - y * W;
        const int off = (y + 1) * PX + j + 1;
        if (up)
            xs[(nz + 1) * PP + off] = xhi[PP + off];
        else
            xs[off] = xlo[lo_nz * PP + off];
    }
    __syncthreads();
}

// ------------------------------------------------------------ host helpers
static int planes_of_widest(int Z, int S) { return (Z + S - 1) / S; }

// the cluster sizes up to 16, and the dynamic shared memory asked for (every
// launch: below 48 KiB the static share may still take the sum over it)
static cudaError_t configure(const void* fn, int bytes) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return e;
}

static void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int blocks, int S,
                           int threads, int bytes, cudaStream_t stream) {
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(blocks, 1, 1);
    cfg->blockDim = dim3(threads, 1, 1);
    cfg->dynamicSmemBytes = bytes;
    cfg->stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
}
