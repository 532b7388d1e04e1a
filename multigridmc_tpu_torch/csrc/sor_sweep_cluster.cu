// Colour-ordered SOR and Gibbs sweep kernels for few chains, NVIDIA Hopper
// (sm_90a), float32, 2d and 3d: each chain's field split over a thread-block
// cluster, its bands in shared memory.
//
// Replace, as sor_sweep.cu does, the Pallas kernels sweep_batched_v2 /
// gibbs_sweep_batched_v2 of multigridmc_tpu/ops/kernels/sor_pallas_v2.py, and
// compute what sor_sweep.cu states, in place, from the same parameter block
// (SweepParams, sor_sweep.cuh) and the same noise modes:
//
//   sor:    for colour ci in order:  x[p] += omega (b[p] - (A_stencil x)[p]) / diag[p]
//           on the points p of colour ci
//   gibbs:  the same sweep on c = f + sqrt(diag (2-omega)/omega) xi
//
// Why a second implementation.  sor_sweep.cu runs one block per chain, so a
// sweep of one chain (the drivers' time series, the deterministic solve) runs
// on one SM of 132: the block walks every colour phase over the whole field
// with a block barrier after each, every neighbour comes from L2, and the
// Gibbs kernel writes c to a scratch field and reads it back.  That is
// latency, not bytes: 0.12-0.16 ms per 255^2 sweep against a byte bound under
// 0.001 ms.
//
// Design.  A chain is split over a cluster of S blocks (S = 2 .. 16, the
// cluster dimension of the launch; 16 is above the portable size and needs
// cudaFuncAttributeNonPortableClusterSizeAllowed).  Block k of the cluster
// owns a band of consecutive UNITS of the slowest axis - rows y in 2d, planes z
// in 3d - which is one contiguous span of the chain's field:
//   1. it copies its band of x into dynamic shared memory once (4-byte
//      cp.async: a row of 255 floats starts only 4-byte aligned, and the field
//      is not padded in global memory) and, in the Gibbs kernel, forms its
//      band of c = f + ns xi there, by Philox groups (a group of four points
//      lies inside one row, so inside one band, and has the number
//      r * ceil(X / 4) + g of sor_sweep.cu: the same normals);
//   2. it runs every colour phase on its band: a neighbour inside the band is
//      read from its own shared memory, one of the `reach` units just outside
//      from the neighbouring rank's, through distributed shared memory
//      (cluster.map_shared_rank); cluster.sync() stands between the phases
//      and is the only synchronisation between blocks;
//   3. after the last phase's cluster.sync() - which also keeps every block
//      resident until no block reads another's shared memory - it writes its
//      band back to global memory once, coalesced.
// Each point accumulates (A x)[p] in offset order and updates
// x[p] += omega (c[p] - ax) / diag as sweep_phases (sor_sweep.cu) does, with
// the same values (the colouring is proper, so no point of a phase reads
// another point of that phase): under one Philox stream the two
// implementations agree bitwise.  No atomics: the same seed and counter give
// the same field.
//
// The host (ops/kernels/sor_sweep.py, sweep_route) takes this route for few
// chains where the band layout fits a block's shared memory
// (sor_sweep_cluster_smem_bytes; split_smem_bytes is the host's mirror) and
// the cluster schedules (sor_sweep_cluster_max_active), with S at most
// units / reach so that the halo lies in the neighbouring band.
//
// Bound: as sor_sweep.cu, bytes (x read and written and b read once per
// chain); a sweep of one chain is some microseconds of latency: the band's
// load, n_order + 1 cluster barriers, the write.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "sor_sweep.cuh"

namespace cg = cooperative_groups;

#define MAX_CLUSTER 16
// the first-point table before the bands: j0 of (order index, row colour base)
#define SPLIT_TABLE_INTS (MAX_COLORS * MAX_COLORS)

// the split of a (Z, Y, X) field into units of the slowest axis: planes z
// where Z > 1, rows y in 2d (Z == 1)
struct SplitLayout {
    int L;          // units
    int unit_rows;  // rows of X points per unit
    int plane;      // points per unit
    int nb_max;     // units of the widest band
};

__host__ __device__ inline SplitLayout split_layout(int Z, int Y, int X, int S) {
    SplitLayout l;
    l.L = Z > 1 ? Z : Y;
    l.unit_rows = Z > 1 ? Y : 1;
    l.plane = l.unit_rows * X;
    l.nb_max = (l.L + S - 1) / S;
    return l;
}

// first unit and number of units of rank k: the first L % S ranks take one more
__device__ __forceinline__ void band_of(int L, int S, int k, int* u0, int* nb) {
    const int base = L / S, rem = L % S;
    *nb = base + (k < rem ? 1 : 0);
    *u0 = k * base + (k < rem ? k : rem);
}

// ------------------------------------------------------------ cp.async, 4 B
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// ------------------------------------------------------------------- kernel
template <bool GIBBS>
__global__ void __launch_bounds__(MAX_THREADS)
cluster_sweep_kernel(const __grid_constant__ SweepParams P, float* x_all,
                     const float* __restrict__ b_all, const float* __restrict__ coeffs,
                     const float* __restrict__ ns, const float* __restrict__ xi_all) {
    extern __shared__ __align__(16) float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int S = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int chain = blockIdx.x / S;
    const int n = P.Z * P.Y * P.X;
    const SplitLayout lay = split_layout(P.Z, P.Y, P.X, S);
    const bool slow_z = P.Z > 1;

    int u0, nb, lo0, lo_nb, hi0, hi_nb;
    band_of(lay.L, S, rank, &u0, &nb);
    band_of(lay.L, S, rank > 0 ? rank - 1 : rank, &lo0, &lo_nb);
    band_of(lay.L, S, rank + 1 < S ? rank + 1 : rank, &hi0, &hi_nb);
    const int u1 = u0 + nb;
    // first point of each band in the chain's field
    const int first = u0 * lay.plane, first_lo = lo0 * lay.plane, first_hi = hi0 * lay.plane;
    const int count = nb * lay.plane;
    const int rows = nb * lay.unit_rows;  // rows of X points in the band
    const int r_first = u0 * lay.unit_rows;

    int* j0tab = reinterpret_cast<int*>(smem);
    float* xs = smem + SPLIT_TABLE_INTS;
    float* cs = xs + lay.nb_max * lay.plane;  // the Gibbs kernel's band of c

    float* x = x_all + (size_t)chain * n;
    const float* b = b_all + (P.b_batched ? (size_t)chain * n : 0);

    // 1. the band of x into shared memory; the table of first points
    for (int i = threadIdx.x; i < count; i += blockDim.x) cp_async4(xs + i, x + first + i);
    cp_async_commit();
    for (int q = threadIdx.x; q < P.n_order * P.n_colors; q += blockDim.x) {
        const int o = q / P.n_colors, base = q - o * P.n_colors;
        const int ci = P.order[o];
        int j0 = -1;
        for (int jj = 0; jj < P.jstride; ++jj)
            if ((base + P.wx * jj) % P.n_colors == ci) { j0 = jj; break; }
        j0tab[o * MAX_COLORS + base] = j0;
    }
    if (GIBBS) {  // c = f + sqrt(diag (2 - omega) / omega) xi, by Philox group
        const int G = (P.X + 3) >> 2;
        const float* xi = P.noise_mode == 2 ? xi_all + (size_t)chain * n : nullptr;
        for (int i = threadIdx.x; i < rows * G; i += blockDim.x) {
            const int lr = i / G, g = i - lr * G;
            const int r = r_first + lr;
            float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (P.noise_mode == 1)
                philox_normals4((uint32_t)(r * G + g), (uint32_t)chain, P.seed, P.counter, z);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int j = 4 * g + q;
                if (j >= P.X) break;
                const int p = r * P.X + j;
                const float zq = (P.noise_mode == 2) ? xi[p] : z[q];
                cs[p - first] = b[p] + (P.ns_const ? P.ns_val : ns[p]) * zq;
            }
        }
    }
    cp_async_wait_all();
    // every band loaded, and every block of the cluster running, before any
    // block reads a neighbour's shared memory
    cluster.sync();

    const float* xlo = cluster.map_shared_rank(xs, rank > 0 ? rank - 1 : rank);
    const float* xhi = cluster.map_shared_rank(xs, rank + 1 < S ? rank + 1 : rank);

    // 2. the colour phases on the band
    const int s = P.jstride;
    const int Gs = (P.X + s - 1) / s;  // candidate points of a colour per row
    for (int o = 0; o < P.n_order; ++o) {
        for (int i = threadIdx.x; i < rows * Gs; i += blockDim.x) {
            const int lr = i / Gs, kk = i - lr * Gs;
            const int r = r_first + lr;
            const int zz = r / P.Y, yy = r - zz * P.Y;
            const int base = (P.wz * zz + P.wy * yy) % P.n_colors;
            const int j0 = j0tab[o * MAX_COLORS + base];
            const int j = j0 + s * kk;
            if (j0 < 0 || j >= P.X) continue;  // no point of the colour here
            const int p = r * P.X + j;
            float ax = 0.0f;  // (A_stencil x)[p], accumulated in offset order
            for (int k = 0; k < P.K; ++k) {
                const int z2 = zz + P.dz[k], y2 = yy + P.dy[k], x2 = j + P.dx[k];
                if (z2 >= 0 && z2 < P.Z && y2 >= 0 && y2 < P.Y && x2 >= 0 && x2 < P.X) {
                    const int u2 = slow_z ? z2 : y2;
                    const float* src = xs;
                    int off = first;
                    if (u2 < u0) {
                        src = xlo;
                        off = first_lo;
                    } else if (u2 >= u1) {
                        src = xhi;
                        off = first_hi;
                    }
                    ax += coeff_at(P, coeffs, k, n, p) * src[(z2 * P.Y + y2) * P.X + x2 - off];
                }
            }
            const float diag = coeff_at(P, coeffs, P.diag_index, n, p);
            const float c = GIBBS ? cs[p - first] : b[p];
            xs[p - first] = xs[p - first] + P.omega * (c - ax) / diag;
        }
        cluster.sync();
    }

    // 3. the band back to global memory, once
    for (int i = threadIdx.x; i < count; i += blockDim.x) x[first + i] = xs[i];
}

// ------------------------------------------------------------ host helpers
// reach of the stencil along the axis the bands split
static int slow_reach(const SweepParams& P) {
    int r = 0;
    for (int k = 0; k < P.K; ++k) {
        const int d = P.Z > 1 ? P.dz[k] : P.dy[k];
        r = d > r ? d : (-d > r ? -d : r);
    }
    return r;
}

// per kernel: clusters above the portable size, and the dynamic shared memory
template <bool GIBBS>
static cudaError_t configure(int bytes) {
    auto kernel = cluster_sweep_kernel<GIBBS>;
    static int granted = 0;
    if (granted == 0) {
        cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return e;
        granted = 48 * 1024;
    }
    if (bytes > granted) {
        cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return e;
        granted = bytes;
    }
    return cudaSuccess;
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

// ------------------------------------------------------------ C entry points
// Dynamic shared memory of one block of the split route: the first-point
// table, then the widest band of x, then (noise_mode != 0, the Gibbs kernel)
// the band of c.  -1 where the field cannot be split so: S outside 2 .. 16,
// more ranks than units, or a band narrower than the stencil's reach.
extern "C" int sor_sweep_cluster_smem_bytes(int Z, int Y, int X, int S, int reach,
                                            int noise_mode) {
    if (S < 2 || S > MAX_CLUSTER || Z < 1 || Y < 1 || X < 1) return -1;
    const SplitLayout l = split_layout(Z, Y, X, S);
    if (S > l.L || l.L / S < reach) return -1;
    const long long floats =
        SPLIT_TABLE_INTS + (long long)l.nb_max * l.plane * (noise_mode != 0 ? 2 : 1);
    return floats * 4 > 0x7FFFFFFF ? -1 : (int)(floats * 4);
}

// How many clusters of S blocks of `threads` threads and `bytes` of dynamic
// shared memory the card can hold at once (cudaOccupancyMaxActiveClusters):
// 0 means such a cluster never schedules.  Returns the CUDA error.
extern "C" int sor_sweep_cluster_max_active(int gibbs, int S, int threads, int bytes,
                                            int* clusters) {
    *clusters = 0;
    cudaError_t e = gibbs ? configure<true>(bytes) : configure<false>(bytes);
    if (e == cudaSuccess) {
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr[1];
        cluster_config(&cfg, attr, S, S, threads, bytes, 0);
        e = cudaOccupancyMaxActiveClusters(
            clusters,
            gibbs ? (const void*)cluster_sweep_kernel<true> : (const void*)cluster_sweep_kernel<false>,
            &cfg);
    }
    if (e != cudaSuccess) {
        cudaGetLastError();
        *clusters = 0;
    }
    return (int)e;
}

template <bool GIBBS>
static int launch(const SweepParams* P, float* x, const float* b, const float* coeffs,
                  const float* ns, const float* xi, int S, int threads, cudaStream_t stream) {
    const int bytes = sor_sweep_cluster_smem_bytes(P->Z, P->Y, P->X, S, slow_reach(*P),
                                                   GIBBS ? 1 : 0);
    if (bytes < 0 || threads < 64 || threads > MAX_THREADS || threads % 32 ||
        P->n_order > MAX_COLORS || P->n_colors > MAX_COLORS || P->C < 1 || P->K < 1 ||
        P->K > MAX_OFFSETS)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = configure<GIBBS>(bytes);
    if (e == cudaSuccess) {
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr[1];
        cluster_config(&cfg, attr, P->C * S, S, threads, bytes, stream);
        SweepParams Pc = *P;
        void* args[] = {&Pc, &x, &b, &coeffs, &ns, &xi};
        e = cudaLaunchKernelExC(&cfg, (const void*)cluster_sweep_kernel<GIBBS>, args);
    }
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    return (int)cudaGetLastError();
}

extern "C" int sor_sweep_cluster(const SweepParams* P, float* x, const float* b,
                                 const float* coeffs, int S, int threads, void* stream) {
    return launch<false>(P, x, b, coeffs, nullptr, nullptr, S, threads, (cudaStream_t)stream);
}

extern "C" int sor_gibbs_sweep_cluster(const SweepParams* P, float* x, const float* f,
                                       const float* coeffs, const float* ns, const float* xi,
                                       int S, int threads, void* stream) {
    return launch<true>(P, x, f, coeffs, ns, xi, S, threads, (cudaStream_t)stream);
}
