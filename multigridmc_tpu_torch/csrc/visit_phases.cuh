// What every level-visit kernel shares: the parameter block of one visit
// (struct VisitParams, mirrored by mgmc_visit.py::VisitParams), the stencil
// read term by term (coeff_at, stencil_at), the warp-per-row loop and the
// low-rank vectors' scratch (LANE_SLOTS, lowrank_scratch_floats, warp_matvec).  The
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
#define MAX_THREADS 1024
// ints of a box: (i0, i1, j0, j1) in 2d, (k0, k1, i0, i1, j0, j1) in 3d
#define BOX_INTS (2 * VISIT_DIM)

// The low-rank vectors of a visit (the m-vectors n of a sweep's normals, B^T x
// - Sigma^1/2 n, u = W (...) and t) of a level of m measurements.  Up to
// LANE_SLOTS of them (m <= LANE_SLOTS) a vector is one entry a lane, in
// static shared memory of LANE_SLOTS floats a slot, and the boxes lie in the
// parameter block.  A level of more takes kernels compiled for it (LR): its
// scratch in dynamic shared memory sized by its m (lowrank_scratch_floats),
// each lane holding the entries lane, lane + 32, ..., u = W v one row at a
// time with the lanes along the row (warp_matvec), every box read from a
// device table.  So the kernels of a level of up to LANE_SLOTS keep their
// code, their static shared memory and every byte they had.
#define LANE_SLOTS 32

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
    // the box (half open) of column B_k's support, and the same for Y_k = M^-1
    // B_k of this sweep direction, of the first LANE_SLOTS columns (every
    // column of a level of up to LANE_SLOTS measurements; the kernels of a
    // level of more read every box from a device table, so that no block's
    // size depends on m)
    int bbox[LANE_SLOTS][BOX_INTS];
    int ybox[LANE_SLOTS][BOX_INTS];
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

// The box of column k: the parameter block's (up to LANE_SLOTS measurements)
// or, in a kernel compiled for more (LR), the level's device table's.
#define BOX_OF(LR, table, params, k) ((LR) ? (table)[k] : (params)[k])

// sum over the warp, the total in lane 0 (a fixed shuffle tree)
__device__ __forceinline__ float warp_total(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// Floats of dynamic shared memory that the low-rank scratch of a level of m
// measurements takes in a block of `threads` (0 where m <= LANE_SLOTS): one
// m-vector of the block, then per warp two (mgmc_visit.py::
// lowrank_scratch_bytes; the split kernels, whose vectors are the block's,
// size theirs themselves).
__host__ __device__ inline int lowrank_scratch_floats(int m, int threads) {
    return m > LANE_SLOTS ? m * (1 + 2 * (threads >> 5)) : 0;
}

// u = W v for a level of m > LANE_SLOTS measurements, by one warp: W m x m row
// major (device or shared memory), v in shared memory; row r in turn, the
// lanes along it (entries lane, lane + 32, ...), a fixed shuffle tree, lane 0
// writes u[r].  u must not be v.
__device__ __forceinline__ void warp_matvec(const float* __restrict__ Wm, const float* v, int m,
                                            float* u) {
    const int lane = threadIdx.x & 31;
    for (int r = 0; r < m; ++r) {
        float acc = 0.0f;
        for (int k = lane; k < m; k += 32) acc += Wm[(size_t)r * m + k] * v[k];
        acc = warp_total(acc);
        if (lane == 0) u[r] = acc;
    }
    __syncwarp();
}
