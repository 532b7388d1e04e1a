// The phases of one MGMC level visit, shared by the two level-visit kernels
// (mgmc_visit.cu) and the subtree kernel (mgmc_subtree.cu): float32, 2d, one
// thread block per chain, __syncthreads() between phases.
//
//   descend_body:  c   = f + sqrt(D(2-w)/w) xi + sum_k xi'_k B_k     (Gibbs rhs)
//                  x  <- colour-ordered SOR sweep(c, x)
//                  x  <- x - sum_l u_l Y_l,  u = W B^T x      (Woodbury:
//                        B_bar = Y W with Y = M^-1 B, W = (Sigma + B^T Y)^-1)
//                  r   = f - A_stencil x - sum_k t_k B_k,  t = Sigma^-1 (I - G) B^T x
//                  f_c = R r                                (full weighting)
//   ascend_body:   x  <- x + gamma P x_c                    (d-linear interpolation)
//                  c, sweep, Woodbury as above (post direction)
//
// Where a field lies (global memory that the L2 holds, or shared memory) is a
// pointer; the arithmetic is the same.  No atomics and a fixed reduction tree,
// so equal seeds and counters give bitwise equal fields.
//
// Field noise: the generator of philox.cuh, counter = (point group, chain,
// launch counter lo, hi), key = seed ^ PHILOX_KEY_MIX; each call yields four normals for four
// consecutive points of a row (group g of row i has the number
// i * ceil(W / 4) + g).  noise_mode 2 reads xi from memory instead, so that a
// kernel and its plain PyTorch version can be fed the same noise.
//
// Restriction and prolongation are the {0.5, 1, 0.5} stencils computed
// directly (no banded matmul); stencil reads are bounds-checked
// (zero-Dirichlet), not rolled and masked.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

#define MAX_OFFSETS 9
#define MAX_COLORS 8
#define MAX_LOWRANK 32
#define MAX_THREADS 1024

struct VisitParams {
    int C, H, W, Hc, Wc;
    int K, diag_index;
    int dy[MAX_OFFSETS];
    int dx[MAX_OFFSETS];
    int coeff_const[MAX_OFFSETS];
    float coeff_val[MAX_OFFSETS];
    int n_colors, w0, w1, jstride;
    int n_order;
    int order[MAX_COLORS];
    float omega;
    float gamma;
    int m;
    int bbox[MAX_LOWRANK][4];  // i0, i1, j0, j1 (half open) of column B_k's support
    int ybox[MAX_LOWRANK][4];  // the same for Y_k = M^-1 B_k of this sweep direction
    int noise_mode;            // 0 off, 1 in-kernel Philox, 2 xi read from memory
    int ns_const;
    float ns_val;
    int f_batched;
    unsigned long long seed;
    unsigned long long counter;
};

// ------------------------------------------------------------------- helpers
// deterministic block-wide sum (fixed shuffle tree, fixed warp order)
__device__ float block_sum(float v, float* s_red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) s_red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        float r = lane < nwarps ? s_red[lane] : 0.0f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) r += __shfl_down_sync(0xffffffffu, r, o);
        if (lane == 0) s_red[32] = r;
    }
    __syncthreads();
    float total = s_red[32];
    __syncthreads();
    return total;
}

__device__ __forceinline__ float coeff_at(const VisitParams& P, const float* __restrict__ coeffs,
                                          int k, int n, int p) {
    return P.coeff_const[k] ? P.coeff_val[k] : coeffs[(size_t)k * n + p];
}

// (A_stencil x)[i, j], zero-Dirichlet shifted reads, accumulated in offset order
__device__ __forceinline__ float stencil_at(const VisitParams& P, const float* __restrict__ coeffs,
                                            const float* x, int i, int j, int n, int p) {
    float ax = 0.0f;
    for (int k = 0; k < P.K; ++k) {
        int ii = i + P.dy[k], jj = j + P.dx[k];
        if (ii >= 0 && ii < P.H && jj >= 0 && jj < P.W)
            ax += coeff_at(P, coeffs, k, n, p) * x[ii * P.W + jj];
    }
    return ax;
}

// All loops over a field run one warp per row (lanes along the row), so no
// thread divides by the row length.
#define WARP_ROWS(i, nrows) \
    for (int i = threadIdx.x >> 5; i < (nrows); i += blockDim.x >> 5)

// dst[p] += sign * s_coef[k] * B_k[p] over column k's bounding box, one column
// after the other (their boxes may overlap); ends with a barrier
__device__ void add_lowrank(const VisitParams& P, const float* __restrict__ B,
                            const float* s_coef, float sign, float* dst) {
    const int n = P.H * P.W;
    for (int k = 0; k < P.m; ++k) {
        const int i0 = P.bbox[k][0], j0 = P.bbox[k][2];
        const int bh = P.bbox[k][1] - i0, bw = P.bbox[k][3] - j0;
        for (int q = threadIdx.x; q < bh * bw; q += blockDim.x) {
            int p = (i0 + q / bw) * P.W + j0 + q % bw;
            dst[p] += sign * s_coef[k] * B[(size_t)k * n + p];
        }
        __syncthreads();
    }
}

// c = f + ns * xi + sum_k s_lr[k] B_k   (written to scr), fused with the
// ascend's x += gamma P x_c, which is pointwise too.  Noise group g of row i
// holds the points (i, 4g .. 4g+3); a non-null xi_rec receives the normals
// used.  Ends with a barrier.
__device__ void rhs_phase(const VisitParams& P, int chain, const float* __restrict__ f,
                          const float* __restrict__ ns, const float* __restrict__ B,
                          const float* s_lr, const float* __restrict__ xi, float* xi_rec,
                          float* scr, float* x, const float* __restrict__ xc) {
    const int lane = threadIdx.x & 31;
    const int G = (P.W + 3) >> 2;
    WARP_ROWS(i, P.H) {
        // (P x_c)[i, j]: an odd fine index 2I+1 takes coarse I with weight 1, an
        // even one takes its two coarse neighbours with 0.5 each
        const int nI = (i & 1) ? 1 : 2, Ia = (i >> 1) - (nI - 1);
        const float wi = (i & 1) ? 1.0f : 0.5f;
        for (int g = lane; g < G; g += 32) {
            float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (P.noise_mode == 1)
                philox_normals4((uint32_t)(i * G + g), (uint32_t)chain, P.seed, P.counter, z);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int j = 4 * g + q;
                if (j >= P.W) break;
                const int p = i * P.W + j;
                if (xc != nullptr) {
                    const int nJ = (j & 1) ? 1 : 2, Ja = (j >> 1) - (nJ - 1);
                    const float wj = (j & 1) ? 1.0f : 0.5f;
                    float px = 0.0f;
                    for (int a = 0; a < nI; ++a) {
                        int I = Ia + a;
                        if (I < 0 || I >= P.Hc) continue;
                        float row = 0.0f;
                        for (int b = 0; b < nJ; ++b) {
                            int J = Ja + b;
                            if (J < 0 || J >= P.Wc) continue;
                            row += wj * xc[I * P.Wc + J];
                        }
                        px += wi * row;
                    }
                    x[p] = x[p] + P.gamma * px;
                }
                if (P.noise_mode) {
                    float zq = (P.noise_mode == 2) ? xi[p] : z[q];
                    if (xi_rec != nullptr) xi_rec[p] = zq;
                    scr[p] = f[p] + (P.ns_const ? P.ns_val : ns[p]) * zq;
                }
            }
        }
    }
    __syncthreads();
    if (P.noise_mode) add_lowrank(P, B, s_lr, 1.0f, scr);
}

// one colour-ordered SOR sweep: x[p] += omega (c[p] - (A x)[p]) / diag[p] on the
// points of the current colour, colour by colour; colour = (w0 i + w1 j) mod K.
// Within a row the points of one colour are j0, j0 + s, j0 + 2s, ...
__device__ void sweep_phase(const VisitParams& P, const float* __restrict__ coeffs,
                            const float* c, float* x) {
    const int n = P.H * P.W;
    const int lane = threadIdx.x & 31;
    const int s = P.jstride;
    for (int o = 0; o < P.n_order; ++o) {
        const int ci = P.order[o];
        WARP_ROWS(i, P.H) {
            const int base = (P.w0 * i) % P.n_colors;
            int j0 = -1;
            for (int jj = 0; jj < s; ++jj)
                if ((base + P.w1 * jj) % P.n_colors == ci) { j0 = jj; break; }
            if (j0 < 0) continue;  // this row holds no point of the colour
            for (int j = j0 + s * lane; j < P.W; j += 32 * s) {
                const int p = i * P.W + j;
                float ax = stencil_at(P, coeffs, x, i, j, n, p);
                float diag = coeff_at(P, coeffs, P.diag_index, n, p);
                x[p] = x[p] + P.omega * (c[p] - ax) / diag;
            }
        }
        __syncthreads();
    }
}

// s_btx[k] = <B_k, x> over column k's bounding box; u = W s_btx; then
// x -= u_l Y_l over Y_l's bounding box, one column after the other (their
// supports may overlap)
__device__ void woodbury_phase(const VisitParams& P, const float* __restrict__ B,
                               const float* __restrict__ Y, const float* __restrict__ Wm,
                               float* x, float* s_btx, float* s_u, float* s_red) {
    const int n = P.H * P.W;
    for (int k = 0; k < P.m; ++k) {
        const int i0 = P.bbox[k][0], j0 = P.bbox[k][2];
        const int bh = P.bbox[k][1] - i0, bw = P.bbox[k][3] - j0;
        float acc = 0.0f;
        for (int q = threadIdx.x; q < bh * bw; q += blockDim.x) {
            int i = i0 + q / bw, j = j0 + q % bw;
            int p = i * P.W + j;
            acc += x[p] * B[(size_t)k * n + p];
        }
        float total = block_sum(acc, s_red);
        if (threadIdx.x == 0) s_btx[k] = total;
    }
    __syncthreads();
    if (threadIdx.x < P.m) {
        const int l = threadIdx.x;
        float u = 0.0f;
        for (int k = 0; k < P.m; ++k) u += Wm[l * P.m + k] * s_btx[k];
        s_u[l] = u;
    }
    __syncthreads();
    for (int l = 0; l < P.m; ++l) {
        const int i0 = P.ybox[l][0], j0 = P.ybox[l][2];
        const int bh = P.ybox[l][1] - i0, bw = P.ybox[l][3] - j0;
        for (int q = threadIdx.x; q < bh * bw; q += blockDim.x) {
            int i = i0 + q / bw, j = j0 + q % bw;
            int p = i * P.W + j;
            x[p] -= s_u[l] * Y[(size_t)l * n + p];
        }
        __syncthreads();
    }
}

// --------------------------------------------------------------- whole visits
// One descend visit of one chain.  x, f, scr and fc are this chain's fields;
// with noise on, s_lr holds the m low-rank normals scaled by Sigma^-1/2 and a
// barrier lies between their writing and this call.  s_red (33 floats) and
// s_btx, s_lr, s_u (MAX_LOWRANK each) are shared memory.  No barrier after the
// last write of fc.
__device__ void descend_body(const VisitParams& P, int chain, float* x, const float* f,
                             float* scr, float* fc, const float* __restrict__ coeffs,
                             const float* __restrict__ ns, const float* __restrict__ B,
                             const float* __restrict__ Y, const float* __restrict__ Wm,
                             const float* __restrict__ sinv, const float* __restrict__ G,
                             const float* __restrict__ xi, float* xi_rec, float* s_red,
                             float* s_btx, float* s_lr, float* s_u) {
    const int n = P.H * P.W;
    const float* c = f;
    if (P.noise_mode) {
        rhs_phase(P, chain, f, ns, B, s_lr, xi, xi_rec, scr, nullptr, nullptr);
        c = scr;
    }
    sweep_phase(P, coeffs, c, x);
    if (P.m) {
        woodbury_phase(P, B, Y, Wm, x, s_btx, s_u, s_red);
        // B^T x after the correction without a second reduction: (I - G) B^T x,
        // G[k, l] = <B_k, (Y W)_l>; scaled by Sigma^-1 for the residual
        if (threadIdx.x < P.m) {
            const int k = threadIdx.x;
            float v = s_btx[k];
            for (int l = 0; l < P.m; ++l) v -= G[k * P.m + l] * s_btx[l];
            s_lr[k] = v * sinv[k];
        }
        __syncthreads();
    }
    // residual r = f - A x (c is dead: scr is reused for r)
    const int lane = threadIdx.x & 31;
    WARP_ROWS(i, P.H) {
        for (int j = lane; j < P.W; j += 32) {
            const int p = i * P.W + j;
            scr[p] = f[p] - stencil_at(P, coeffs, x, i, j, n, p);
        }
    }
    __syncthreads();
    if (P.m) add_lowrank(P, B, s_lr, -1.0f, scr);
    // f_c[I, J] = sum_{a, b} w_a w_b r[2I+1+a, 2J+1+b], w = {0.5, 1, 0.5}
    WARP_ROWS(I, P.Hc) {
        for (int J = lane; J < P.Wc; J += 32) {
            float acc = 0.0f;
            for (int a = -1; a <= 1; ++a) {
                int i = 2 * I + 1 + a;
                if (i < 0 || i >= P.H) continue;
                float row = 0.0f;
                for (int b = -1; b <= 1; ++b) {
                    int j = 2 * J + 1 + b;
                    if (j < 0 || j >= P.W) continue;
                    row += (b ? 0.5f : 1.0f) * scr[i * P.W + j];
                }
                acc += (a ? 0.5f : 1.0f) * row;
            }
            fc[I * P.Wc + J] = acc;
        }
    }
}

// One ascend visit of one chain; arguments as descend_body, xc the coarse
// state.  Ends with a barrier.
__device__ void ascend_body(const VisitParams& P, int chain, float* x, const float* f,
                            float* scr, const float* xc, const float* __restrict__ coeffs,
                            const float* __restrict__ ns, const float* __restrict__ B,
                            const float* __restrict__ Y, const float* __restrict__ Wm,
                            const float* __restrict__ xi, float* xi_rec, float* s_red,
                            float* s_btx, float* s_lr, float* s_u) {
    rhs_phase(P, chain, f, ns, B, s_lr, xi, xi_rec, scr, x, xc);
    sweep_phase(P, coeffs, P.noise_mode ? scr : f, x);
    if (P.m) woodbury_phase(P, B, Y, Wm, x, s_btx, s_u, s_red);
}
