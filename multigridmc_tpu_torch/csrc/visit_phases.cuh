// What every level-visit kernel shares: the parameter block of one visit
// (struct VisitParams, mirrored by mgmc_visit.py::VisitParams), the stencil
// read term by term (coeff_at, stencil_at) and the warp-per-row loop.  The
// passes of a visit are in level_passes.cuh (the phase kernels of
// mgmc_visit.cu and the subtree kernel); the stream (mgmc_visit_stream.cu) and
// split (mgmc_visit_split.cu) kernels compute the same passes in their own
// layouts, from the same values in the same order per point.
//
// Stencil reads are bounds-checked (zero-Dirichlet), not rolled and masked;
// stencil_at adds the terms in offset order, the order every kernel keeps.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

// The limits of one build's parameter block: the reach-1 default (every
// kernel), or what the phase kernels' reach-2 and 3d builds set before they
// include this header (mgmc_visit.cu, VISIT_REACH 2: 25 offsets, 9 colours;
// VISIT_DIM 3: 27 offsets).
#ifndef VISIT_DIM
#define VISIT_DIM 2
#endif
#ifndef MAX_OFFSETS
#define MAX_OFFSETS 9
#endif
#ifndef MAX_COLORS
#define MAX_COLORS 8
#endif
#define MAX_LOWRANK 32
#define MAX_THREADS 1024
// ints of a box: (i0, i1, j0, j1) in 2d, (k0, k1, i0, i1, j0, j1) in 3d
#define BOX_INTS (2 * VISIT_DIM)

// A 3d level (VISIT_DIM 3) is Z planes of Y rows of W points, stored row major:
// H = Z Y rows of W points, Hc = Zc Yc coarse rows of Wc points; the passes
// take a row r = z Y + y where a 2d level takes row i.
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
    int bbox[MAX_LOWRANK][BOX_INTS];  // the box (half open) of column B_k's support
    int ybox[MAX_LOWRANK][BOX_INTS];  // the same for Y_k = M^-1 B_k of this sweep direction
    int noise_mode;            // 0 off, 1 in-kernel Philox, 2 xi read from memory
    int ns_const;
    float ns_val;
    int f_batched;
    unsigned long long seed;
    unsigned long long counter;
#if VISIT_DIM == 3
    int Z, Y, Zc, Yc;
    int dz[MAX_OFFSETS];
    int wz;  // the colour weight of z: colour = (wz z + w0 y + w1 j) mod n_colors
#endif
};

// ------------------------------------------------------------------- helpers
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
