// Colour-ordered SOR and Gibbs sweep kernels for NVIDIA Hopper (sm_90a),
// float32, 2d and 3d.
//
// Replace the Pallas kernels sweep_batched_v2 / gibbs_sweep_batched_v2 of
// multigridmc_tpu/ops/kernels/sor_pallas_v2.py.  One launch is one sweep of
// all chains, in place:
//
//   sor_sweep_kernel:    for colour ci in order:
//                            x[p] += omega (b[p] - (A_stencil x)[p]) / diag[p]
//                        on the points p of colour ci, colour =
//                        (wz z + wy y + wx x) mod n_colors
//   gibbs_sweep_kernel:  the same sweep on c = f + sqrt(diag (2-omega)/omega) xi,
//                        xi ~ N(0, 1) drawn in the kernel (or read from a tensor)
//
// Design.  The colour phases are Gauss-Seidel: phase c must see what phase
// c-1 wrote everywhere in that chain's field, so a field cannot be tiled over
// blocks with stale halos, and one 255^2 float32 field (260 KB) exceeds a
// block's 227 KB of shared memory.  Hence, as in mgmc_visit.cu: ONE THREAD
// BLOCK PER CHAIN, the field in global memory (it stays in the 50 MB L2 for the
// blocks in flight), one warp per row of the field with the lanes along the
// row, and __syncthreads() between the colour phases.  A single chain is a
// batch of one: one block, bound by latency and not by bytes; for few chains
// the host takes sor_sweep_cluster.cu instead, which splits each chain over a
// thread-block cluster (ops/kernels/sor_sweep.py, sweep_route).
//
// A sweep is bound by bytes: per chain it must read b (unless shared) and x
// and write x once, plus the coefficient planes once for all chains.  What the
// design spends on top is traffic to L2: the Gibbs kernel writes c to a
// scratch field before the first phase (every phase reads c at its own colour
// only, but the noise comes in groups of four consecutive points), and
// coefficient planes that vary in space are read by every chain.  Spatially
// constant coefficient planes and a constant noise scale travel as scalars.
//
// Neighbours are read with a bounds test (zero-Dirichlet), so any offset set
// works: 5- and 9-point in 2d, 7- and 27-point in 3d, reach 2 (13-point).
//
// Field noise: the generator of philox.cuh, addressed by (seed, launch
// counter, chain, point group); group g of row r has the number
// r * ceil(X / 4) + g, rows numbered in storage order (r = z * Y + y).
// noise_mode 2 reads xi from a tensor instead, so that the kernel and its plain
// PyTorch version can be fed the same normals.  No atomics: two launches with
// the same seed and counter are bitwise equal.
//
// Since the sweeps of 2d reach-1 stencils run on the passes of
// level_passes.cuh (sor_sweep_passes.cu), and the reach-2 and 3d stencils on
// sor_sweep_smem.cu (a chain in shared memory) or on sor_sweep_passes.cu's
// reach-2 and 3d builds, these kernels take what none of those does (2d
// stencils of reach 3 and more, 3d reach 2); the host launches them on the
// other shapes only to hold the bodies against each other.
//
// SWEEP_STAMPS_BUILD: the measurement build, a library of its own, taken only
// where the host passes a stamps tensor, (C, SWEEP_STAMP_WIDTH) int64: per
// block the timer (ns) at entry, after the Gibbs rhs pass and after each
// colour phase, at exit, then the barriers passed and the SM (block_stamps.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_stamps.cuh"
#include "philox.cuh"
#include "sor_sweep.cuh"

// one warp per row of the field (lanes along the row)
#define WARP_ROWS(r, nrows) \
    for (int r = threadIdx.x >> 5; r < (nrows); r += blockDim.x >> 5)

// all colour phases of one sweep of one chain; ends with a barrier
template <bool STAMPS>
__device__ void sweep_phases(const SweepParams& P, const float* __restrict__ coeffs,
                             const float* c, float* x) {
    const int n = P.Z * P.Y * P.X;
    const int rows = P.Z * P.Y;
    const int lane = threadIdx.x & 31;
    const int s = P.jstride;
    for (int o = 0; o < P.n_order; ++o) {
        const int ci = P.order[o];
        WARP_ROWS(r, rows) {
            const int zz = r / P.Y, yy = r - zz * P.Y;
            const int base = (P.wz * zz + P.wy * yy) % P.n_colors;
            int j0 = -1;
            for (int jj = 0; jj < s; ++jj)
                if ((base + P.wx * jj) % P.n_colors == ci) { j0 = jj; break; }
            if (j0 < 0) continue;  // this row holds no point of the colour
            for (int j = j0 + s * lane; j < P.X; j += 32 * s) {
                const int p = r * P.X + j;
                float ax = 0.0f;  // (A_stencil x)[p], accumulated in offset order
                for (int k = 0; k < P.K; ++k) {
                    const int z2 = zz + P.dz[k], y2 = yy + P.dy[k], x2 = j + P.dx[k];
                    if (z2 >= 0 && z2 < P.Z && y2 >= 0 && y2 < P.Y && x2 >= 0 && x2 < P.X)
                        ax += coeff_at(P, coeffs, k, n, p) * x[(z2 * P.Y + y2) * P.X + x2];
                }
                const float diag = coeff_at(P, coeffs, P.diag_index, n, p);
                x[p] = x[p] + P.omega * (c[p] - ax) / diag;
            }
        }
        block_sync<STAMPS>();
    }
}

// ------------------------------------------------------------------- kernels
template <bool STAMPS>
__global__ void __launch_bounds__(MAX_THREADS)
sor_sweep_kernel(const __grid_constant__ SweepParams P, float* x_all,
                 const float* __restrict__ b_all, const float* __restrict__ coeffs,
                 unsigned long long* stamps) {
    const int chain = blockIdx.x;
    const size_t n = (size_t)P.Z * P.Y * P.X;
    unsigned long long* srow = STAMPS ? stamps + (size_t)chain * SWEEP_STAMP_WIDTH : nullptr;
    stamps_open<STAMPS>(srow);
    sweep_phases<STAMPS>(P, coeffs, b_all + (P.b_batched ? chain * n : 0), x_all + chain * n);
    stamps_close<STAMPS>(srow, SWEEP_STAMP_WIDTH);
}

template <bool STAMPS>
__global__ void __launch_bounds__(MAX_THREADS)
gibbs_sweep_kernel(const __grid_constant__ SweepParams P, float* x_all,
                   const float* __restrict__ f_all, float* scr_all,
                   const float* __restrict__ coeffs, const float* __restrict__ ns,
                   const float* __restrict__ xi_all, unsigned long long* stamps) {
    const int chain = blockIdx.x;
    const size_t n = (size_t)P.Z * P.Y * P.X;
    unsigned long long* srow = STAMPS ? stamps + (size_t)chain * SWEEP_STAMP_WIDTH : nullptr;
    stamps_open<STAMPS>(srow);
    const float* f = f_all + (P.b_batched ? chain * n : 0);
    const float* xi = P.noise_mode == 2 ? xi_all + chain * n : nullptr;
    float* scr = scr_all + chain * n;
    // c = f + sqrt(diag (2 - omega) / omega) xi
    const int rows = P.Z * P.Y;
    const int lane = threadIdx.x & 31;
    const int G = (P.X + 3) >> 2;
    WARP_ROWS(r, rows) {
        for (int g = lane; g < G; g += 32) {
            float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (P.noise_mode == 1)
                philox_normals4((uint32_t)(r * G + g), (uint32_t)chain, P.seed, P.counter, z);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int j = 4 * g + q;
                if (j >= P.X) break;
                const int p = r * P.X + j;
                const float zq = (P.noise_mode == 2) ? xi[p] : z[q];
                scr[p] = f[p] + (P.ns_const ? P.ns_val : ns[p]) * zq;
            }
        }
    }
    block_sync<STAMPS>();
    sweep_phases<STAMPS>(P, coeffs, scr, x_all + chain * n);
    stamps_close<STAMPS>(srow, SWEEP_STAMP_WIDTH);
}

// ------------------------------------------------------------ C entry points
extern "C" int sor_sweep_params_size() { return (int)sizeof(SweepParams); }

extern "C" int sor_sweep_stamp_width() { return SWEEP_STAMP_WIDTH; }

extern "C" int sor_sweep_stamps_build() { return SWEEP_STAMPS_BUILD; }

// a stamps tensor goes to the stamps build only
extern "C" int sor_sweep_batched(const SweepParams* P, float* x, const float* b,
                                 const float* coeffs, int threads, void* stamps, void* stream) {
    unsigned long long* st = static_cast<unsigned long long*>(stamps);
    if ((st != nullptr) != (bool)SWEEP_STAMPS_BUILD) return (int)cudaErrorInvalidValue;
    sor_sweep_kernel<(bool)SWEEP_STAMPS_BUILD><<<P->C, threads, 0, (cudaStream_t)stream>>>(
        *P, x, b, coeffs, st);
    return (int)cudaGetLastError();
}

extern "C" int sor_gibbs_sweep_batched(const SweepParams* P, float* x, const float* f,
                                       float* scratch, const float* coeffs, const float* ns,
                                       const float* xi, int threads, void* stamps,
                                       void* stream) {
    unsigned long long* st = static_cast<unsigned long long*>(stamps);
    if ((st != nullptr) != (bool)SWEEP_STAMPS_BUILD) return (int)cudaErrorInvalidValue;
    gibbs_sweep_kernel<(bool)SWEEP_STAMPS_BUILD><<<P->C, threads, 0, (cudaStream_t)stream>>>(
        *P, x, f, scratch, coeffs, ns, xi, st);
    return (int)cudaGetLastError();
}
