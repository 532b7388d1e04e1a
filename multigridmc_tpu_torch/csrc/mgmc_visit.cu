// Fused MGMC level-visit kernels for NVIDIA Hopper (sm_90a), float32, 2d.
//
// Replaces the Pallas kernels descend_visit / ascend_visit of
// multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py.  One launch is one visit
// of one multigrid level for all chains:
//
//   descend:  c   = f + sqrt(D(2-w)/w) xi + sum_k xi'_k B_k     (Gibbs rhs)
//             x  <- colour-ordered SOR sweep(c, x)
//             x  <- x - sum_l u_l Y_l,  u = W B^T x              (Woodbury:
//                   B_bar = Y W with Y = M^-1 B, W = (Sigma + B^T Y)^-1)
//             r   = f - A_stencil x - sum_k t_k B_k,  t = Sigma^-1 (I - G) B^T x
//             f_c = R r                                (full weighting)
//   ascend:   x  <- x + gamma P x_c                    (d-linear interpolation)
//             c, sweep, Woodbury as above (post direction)
//
// Design.  The colour phases are Gauss-Seidel: phase c must see what phase
// c-1 wrote everywhere in that chain's field, so a field cannot be tiled over
// blocks with stale halos.  One 255^2 float32 field (260 KB) does not fit the
// 227 KB of shared memory of a block either.  Hence: ONE THREAD BLOCK PER
// CHAIN, the field in global memory (it stays in the 50 MB L2 for the blocks
// in flight), block-stride loops over the points of the current colour and
// __syncthreads() between phases.  No atomics and a fixed reduction tree, so
// two launches with the same seed and counter are bitwise equal.
//
// The visit is bound by bytes: per chain it must read f, x (and x_c) and
// write x (and f_c) once.  What the design spends on top of that is traffic
// to L2 (a scratch field for c and r, the coefficient planes that all chains
// share).  Two of the TPU kernel's resident-set compressions are kept because
// they cut that traffic: spatially constant coefficient planes and a constant
// noise scale travel as scalars, and each measurement column B_k is only read
// inside its bounding box (a radius-0 column is one-hot; its restrictions are
// 3x3), which also shortens the B^T x reductions.  The Woodbury correction is
// applied in the factored form x -= sum_l (W B^T x)_l Y_l for the same reason:
// a column of B_bar = Y W is dense wherever any measurement is, while Y_l =
// M^-1 B_l stays within a few points of B_l's support (the splitting solve
// widens it by the stencil once per colour), so the correction touches tens of
// points per chain and not m whole planes.
//
// Field noise: the generator of philox.cuh (shared with sor_sweep.cu):
// Philox4x32-10, counter = (point group, chain, launch counter lo, hi), key =
// seed ^ PHILOX_KEY_MIX (lo, hi); each call yields four normals (two Box-Muller pairs, sine
// and cosine branch) for four consecutive points of a row (group g of row i
// has the number i * ceil(W / 4) + g).
// noise_mode 2 reads xi from a tensor instead, so that the kernel and its
// plain PyTorch version can be fed the same noise.
//
// Restriction and prolongation are the {0.5, 1, 0.5} stencils computed
// directly (no banded matmul); stencil reads are bounds-checked
// (zero-Dirichlet), not rolled and masked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "visit_phases.cuh"

// ------------------------------------------------------------------- kernels
// The phases and the two visit bodies are in visit_phases.cuh, shared with the
// subtree kernel (mgmc_subtree.cu).
__global__ void __launch_bounds__(MAX_THREADS)
descend_kernel(const __grid_constant__ VisitParams P, float* x_all,
               const float* __restrict__ f_all, float* scr_all, float* fc_all,
               const float* __restrict__ coeffs, const float* __restrict__ ns,
               const float* __restrict__ B, const float* __restrict__ Y,
               const float* __restrict__ Wm, const float* __restrict__ xilr,
               const float* __restrict__ sinv, const float* __restrict__ G,
               const float* __restrict__ xi_all) {
    __shared__ float s_red[33];
    __shared__ float s_btx[MAX_LOWRANK];
    __shared__ float s_lr[MAX_LOWRANK];
    __shared__ float s_u[MAX_LOWRANK];
    const int chain = blockIdx.x;
    const int n = P.H * P.W, nc = P.Hc * P.Wc;
    float* x = x_all + (size_t)chain * n;
    const float* f = f_all + (P.f_batched ? (size_t)chain * n : 0);
    float* scr = scr_all + (size_t)chain * n;
    float* fc = fc_all + (size_t)chain * nc;

    if (P.noise_mode) {
        if (threadIdx.x < P.m) s_lr[threadIdx.x] = xilr[(size_t)chain * P.m + threadIdx.x];
        __syncthreads();
    }
    descend_body(P, chain, x, f, scr, fc, coeffs, ns, B, Y, Wm, sinv, G,
                 xi_all ? xi_all + (size_t)chain * n : nullptr, nullptr,
                 s_red, s_btx, s_lr, s_u);
}

__global__ void __launch_bounds__(MAX_THREADS)
ascend_kernel(const __grid_constant__ VisitParams P, float* x_all,
              const float* __restrict__ f_all, float* scr_all,
              const float* __restrict__ xc_all, const float* __restrict__ coeffs,
              const float* __restrict__ ns, const float* __restrict__ B,
              const float* __restrict__ Y, const float* __restrict__ Wm,
              const float* __restrict__ xilr, const float* __restrict__ xi_all) {
    __shared__ float s_red[33];
    __shared__ float s_btx[MAX_LOWRANK];
    __shared__ float s_lr[MAX_LOWRANK];
    __shared__ float s_u[MAX_LOWRANK];
    const int chain = blockIdx.x;
    const int n = P.H * P.W, nc = P.Hc * P.Wc;
    float* x = x_all + (size_t)chain * n;
    const float* f = f_all + (P.f_batched ? (size_t)chain * n : 0);
    float* scr = scr_all + (size_t)chain * n;
    const float* xc = xc_all + (size_t)chain * nc;

    if (P.noise_mode && threadIdx.x < P.m)
        s_lr[threadIdx.x] = xilr[(size_t)chain * P.m + threadIdx.x];
    __syncthreads();
    ascend_body(P, chain, x, f, scr, xc, coeffs, ns, B, Y, Wm,
                xi_all ? xi_all + (size_t)chain * n : nullptr, nullptr,
                s_red, s_btx, s_lr, s_u);
}

// ------------------------------------------------------------ C entry points
extern "C" int mgmc_visit_params_size() { return (int)sizeof(VisitParams); }

extern "C" int mgmc_descend_visit(const VisitParams* P, float* x, const float* f, float* scratch,
                                  float* fc, const float* coeffs, const float* ns,
                                  const float* B, const float* Y, const float* Wm,
                                  const float* xilr, const float* sinv, const float* G,
                                  const float* xi, int threads, void* stream) {
    descend_kernel<<<P->C, threads, 0, (cudaStream_t)stream>>>(
        *P, x, f, scratch, fc, coeffs, ns, B, Y, Wm, xilr, sinv, G, xi);
    return (int)cudaGetLastError();
}

extern "C" int mgmc_ascend_visit(const VisitParams* P, float* x, const float* f, float* scratch,
                                 const float* xc, const float* coeffs, const float* ns,
                                 const float* B, const float* Y, const float* Wm,
                                 const float* xilr, const float* xi, int threads,
                                 void* stream) {
    ascend_kernel<<<P->C, threads, 0, (cudaStream_t)stream>>>(
        *P, x, f, scratch, xc, coeffs, ns, B, Y, Wm, xilr, xi);
    return (int)cudaGetLastError();
}
