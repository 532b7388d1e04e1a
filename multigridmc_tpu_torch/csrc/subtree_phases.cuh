// The level visits of the subtree kernel (mgmc_subtree.cu): float32, 2d, one
// thread block per chain, the same function and the same arithmetic per point
// as the visits of visit_phases.cuh.
//
//   descend: c  = f + sqrt(D(2-w)/w) xi + sum_k s_k B_k     (Gibbs rhs)
//            x <- colour-ordered SOR sweep(c, x)
//            x <- x - sum_l u_l Y_l,  u = W B^T x           (Woodbury)
//            r  = f - A x - sum_k t_k B_k,  t = Sigma^-1 (I - G) B^T x
//            f_c = R r                                     (full weighting)
//   ascend:  x <- x + gamma P x_c, then c, sweep, Woodbury as above
//
// What the passes rely on:
//
// * The tables lie in shared memory for the whole launch (struct LevelTables:
//   B_k inside its bounding box and Y_k of both directions inside theirs, each
//   box row major, column after column; W, G, 1/Sigma, Sigma^-1/2).
// * Each low-rank term is one pass: sum_k s_k B_k joins the rhs pass, sum_k
//   t_k B_k the residual pass, and the Woodbury correction is one pass.  Every
//   point has one owner thread, which adds the columns whose box holds it in
//   column order; the boxes overlap, so that order, not atomics, makes each
//   point's sum the same as a loop over the columns.  B^T x is one warp per
//   column (lanes along its box, a fixed shuffle tree).  The m scalars a pass
//   needs (s, u or t) each warp computes for itself into its own slot.
// * The sweep's warps take the rows that hold the colour in turn (T.rows), so
//   every warp has rows in every colour phase; within a colour no point reads
//   another, so the order of the rows does not change the result.  The 3x3 box
//   of the Galerkin levels is read with its coefficients in registers (Box9),
//   any other reach-1 stencil term by term from the parameter block
//   (stencil_at); both over the same rows.
//
// Barriers (block_sync; COUNT, the kernel's stamps mode, counts them): a
// descend has n_order + 5 (rhs, colours, B^T x, Woodbury, residual,
// restriction), an ascend n_order + 3, each without the two low-rank ones
// where m = 0.

#pragma once

#include "visit_phases.cuh"

// Barriers this block has passed, counted by thread 0 where COUNT is set (the
// kernel's stamps mode, which zeroes it at launch start and reports it).
__shared__ unsigned subtree_sync_count;

template <bool COUNT>
__device__ __forceinline__ void block_sync() {
    __syncthreads();
    if (COUNT && threadIdx.x == 0) ++subtree_sync_count;
}

// sum over the warp, the total in lane 0 (a fixed shuffle tree)
__device__ __forceinline__ float warp_total(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// One level's tables for one sweep direction, in shared memory.
struct LevelTables {
    const float* bval;     // B_k inside bbox_k, column after column, each box row major
    const int* boff;       // m + 1 starts of the columns in bval
    const float* yval;     // Y_k = M^-1 B_k of this direction inside ybox_k, likewise
    const int* yoff;       // m + 1 starts in yval
    const float* wm;       // W of this direction, m x m row major
    const float* g;        // G[k, l] = <B_k, (Y W)_l> of the pre direction, m x m
    const float* sinv;     // 1 / Sigma
    const float* lrscale;  // Sigma^-1/2
    // per colour of the sweep order, 1 + 2 n_colors words: the number R of
    // row residues mod n_colors whose rows hold the colour, then R pairs
    // (residue, first column of the colour in such a row), residues ascending
    const int* rows;
};

// The level's stencil where it is the 3x3 box in raster order (the Galerkin
// levels): its coefficients held in registers, the neighbours outside the
// field skipped by predicates, each term added in offset order as stencil_at
// adds it, so the two agree bitwise.
struct Box9 {
    bool on;     // the stencil is the raster 3x3 box
    int planes;  // bit k: coefficient k varies in space and is read per point
    float c[9];
};

__device__ __forceinline__ Box9 box9(const VisitParams& P) {
    Box9 b;
    b.on = P.K == 9;
    b.planes = 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        b.on = b.on && P.dy[k] == k / 3 - 1 && P.dx[k] == k % 3 - 1;
        b.c[k] = P.coeff_val[k];
        if (!P.coeff_const[k]) b.planes |= 1 << k;
    }
    return b;
}

// (A_stencil x)[i, j] for a Box9 stencil, zero-Dirichlet
__device__ __forceinline__ float stencil_box9(const Box9& b, const float* __restrict__ coeffs,
                                              const float* x, int H, int W, int i, int j, int n,
                                              int p) {
    const bool up = i > 0, dn = i < H - 1, lf = j > 0, rt = j < W - 1;
    const bool in[9] = {up && lf, up, up && rt, lf, true, rt, dn && lf, dn, dn && rt};
    // the rows above, at and below the point: the neighbours at fixed offsets
    const float* row[3] = {x + p - W, x + p, x + p + W};
    float ax = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k)
        if (in[k])
            ax += (((b.planes >> k) & 1) ? coeffs[(size_t)k * n + p] : b.c[k]) *
                  row[k / 3][k % 3 - 1];
    return ax;
}

// One colour-ordered SOR sweep, the arithmetic of sweep_phase
// (visit_phases.cuh) per point.  The warps take the rows that hold the colour
// in turn (T.rows); BOX: the stencil is the 3x3 box (Box9), else stencil_at.
template <bool BOX, bool COUNT>
__device__ __forceinline__ void sweep_colours(const VisitParams& P, const Box9& b,
                                              const LevelTables& T,
                                              const float* __restrict__ coeffs,
                                              const float* __restrict__ c, float* x) {
    const int H = P.H, W = P.W, n = H * W, lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const int s = P.jstride, K = P.n_colors, d = P.diag_index;
    const bool dplane = !P.coeff_const[d];
    const float dval = P.coeff_val[d], omega = P.omega;
    for (int o = 0; o < P.n_order; ++o) {
        const int* cr = T.rows + o * (1 + 2 * K);
        const int R = cr[0];
        for (int r = warp; R > 0; r += nwarps) {
            const int q = r / R, t = r - q * R;
            const int i = q * K + cr[1 + 2 * t];
            if (i >= H) break;
            for (int j = cr[2 + 2 * t] + s * lane; j < W; j += 32 * s) {
                const int p = i * W + j;
                const float ax = BOX ? stencil_box9(b, coeffs, x, H, W, i, j, n, p)
                                     : stencil_at(P, coeffs, x, i, j, n, p);
                const float diag = dplane ? coeffs[(size_t)d * n + p] : dval;
                x[p] = x[p] + omega * (c[p] - ax) / diag;
            }
        }
        block_sync<COUNT>();
    }
}

// Ends with a barrier.
template <bool COUNT>
__device__ void subtree_sweep(const VisitParams& P, const Box9& b, const LevelTables& T,
                              const float* __restrict__ coeffs, const float* __restrict__ c,
                              float* x) {
    if (b.on)
        sweep_colours<true, COUNT>(P, b, T, coeffs, c, x);
    else
        sweep_colours<false, COUNT>(P, b, T, coeffs, c, x);
}

// [lo, hi): the columns that the boxes holding row i span (lo >= hi: none)
__device__ __forceinline__ void row_span(const int (*box)[4], int m, int i, int& lo, int& hi) {
    lo = 1 << 30;
    hi = 0;
    for (int k = 0; k < m; ++k)
        if (box[k][0] <= i && i < box[k][1]) {
            lo = min(lo, box[k][2]);
            hi = max(hi, box[k][3]);
        }
}

// v + sign * coef[k] * F_k[i, j] for each column k whose box holds (i, j), in
// column order: F_k's values lie row major inside box k from val + off[k]
__device__ __forceinline__ float add_columns(const int (*box)[4], int m, const float* val,
                                             const int* off, const float* coef, float sign,
                                             int i, int j, float v) {
    for (int k = 0; k < m; ++k) {
        const int i0 = box[k][0], j0 = box[k][2];
        if (i >= i0 && i < box[k][1] && j >= j0 && j < box[k][3])
            v += sign * coef[k] * val[off[k] + (i - i0) * (box[k][3] - j0) + (j - j0)];
    }
    return v;
}

// This warp's s = Sigma^-1/2 z: the m low-rank normals of a sweep (mode 1:
// the generator under `counter`, point groups 0 .. ceil(m / 4) - 1; mode 2:
// read from xi), recorded by warp 0 where xi_rec is set.  m <= 32.
__device__ __forceinline__ void lowrank_normals(const LevelTables& T, int m, int chain, int noise_mode,
                                                unsigned long long seed,
                                                unsigned long long counter, const float* xi,
                                                float* xi_rec, float* wv) {
    const int lane = threadIdx.x & 31;
    if (lane < m) {
        float z;
        if (noise_mode == 1) {
            float z4[4];
            philox_normals4((uint32_t)(lane >> 2), (uint32_t)chain, seed, counter, z4);
            const int q = lane & 3;
            z = q == 0 ? z4[0] : (q == 1 ? z4[1] : (q == 2 ? z4[2] : z4[3]));
            if (xi_rec != nullptr && threadIdx.x < 32) xi_rec[lane] = z;
        } else {
            z = xi[lane];
        }
        wv[lane] = T.lrscale[lane] * z;
    }
    __syncwarp();
}

// The pass before the sweep: x = 0 (zero), x += gamma P x_c (xc not null: an
// ascend) and, with noise, the Gibbs rhs c = f + ns xi + sum_k s_k B_k into
// scr (wv: this warp's s).  Noise group g of row i holds the points
// (i, 4g .. 4g+3); the block's threads take the groups of the whole field in
// turn (a row of a small level has fewer groups than a warp has lanes);
// xi_rec receives the normals used.  No barrier.
__device__ void rhs_pass(const VisitParams& P, const LevelTables& T, int chain, int noise_mode,
                         unsigned long long seed, unsigned long long counter,
                         const float* __restrict__ f, const float* __restrict__ ns,
                         const float* __restrict__ xi, float* __restrict__ xi_rec,
                         const float* wv, float* __restrict__ scr, float* __restrict__ x,
                         const float* __restrict__ xc, bool zero) {
    const int H = P.H, W = P.W, Hc = P.Hc, Wc = P.Wc, m = P.m;
    const int G = (W + 3) >> 2;
    const bool ns_const = P.ns_const;
    const float ns_val = P.ns_val, gamma = P.gamma;
    for (int q4 = threadIdx.x; q4 < H * G; q4 += blockDim.x) {
        const int i = q4 / G, g = q4 - i * G;
        int lo = 0, hi = 0;  // the columns that B's boxes span in this row
        if (noise_mode) row_span(P.bbox, m, i, lo, hi);
        // (P x_c)[i, j]: an odd fine index 2I+1 takes coarse I with weight 1, an
        // even one takes its two coarse neighbours with 0.5 each
        const int nI = (i & 1) ? 1 : 2, Ia = (i >> 1) - (nI - 1);
        const float wi = (i & 1) ? 1.0f : 0.5f;
        // the group's loads first, so that they are in flight during the draw
        float fv[4], xv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int j = 4 * g + q, p = i * W + j;
            fv[q] = (noise_mode && j < W) ? f[p] : 0.0f;
            xv[q] = (xc != nullptr && j < W) ? x[p] : 0.0f;
        }
        float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (noise_mode == 1) philox_normals4((uint32_t)q4, (uint32_t)chain, seed, counter, z);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int j = 4 * g + q;
            if (j >= W) break;
            const int p = i * W + j;
            if (zero) x[p] = 0.0f;
            if (xc != nullptr) {
                const int nJ = (j & 1) ? 1 : 2, Ja = (j >> 1) - (nJ - 1);
                const float wj = (j & 1) ? 1.0f : 0.5f;
                float px = 0.0f;
                for (int a = 0; a < nI; ++a) {
                    int I = Ia + a;
                    if (I < 0 || I >= Hc) continue;
                    float row = 0.0f;
                    for (int b = 0; b < nJ; ++b) {
                        int J = Ja + b;
                        if (J < 0 || J >= Wc) continue;
                        row += wj * xc[I * Wc + J];
                    }
                    px += wi * row;
                }
                x[p] = xv[q] + gamma * px;
            }
            if (noise_mode) {
                float zq = (noise_mode == 2) ? xi[p] : z[q];
                if (xi_rec != nullptr) xi_rec[p] = zq;
                float c = fv[q] + (ns_const ? ns_val : ns[p]) * zq;
                if (j >= lo && j < hi) c = add_columns(P.bbox, m, T.bval, T.boff, wv, 1.0f, i, j, c);
                scr[p] = c;
            }
        }
    }
}

// s_btx[k] = <B_k, x> over column k's box: one warp per column, lanes along
// the box, a shuffle tree.  Ends with a barrier.
template <bool COUNT>
__device__ void btx_pass(const VisitParams& P, const LevelTables& T, const float* x, float* s_btx) {
    const int lane = threadIdx.x & 31;
    for (int k = threadIdx.x >> 5; k < P.m; k += blockDim.x >> 5) {
        const int i0 = P.bbox[k][0], j0 = P.bbox[k][2];
        const int bw = P.bbox[k][3] - j0, area = (P.bbox[k][1] - i0) * bw;
        const float* v = T.bval + T.boff[k];
        float acc = 0.0f;
        for (int q = lane; q < area; q += 32) acc += x[(i0 + q / bw) * P.W + j0 + q % bw] * v[q];
        acc = warp_total(acc);
        if (lane == 0) s_btx[k] = acc;
    }
    block_sync<COUNT>();
}

// x -= sum_l u_l Y_l with u = W B^T x (this warp's copy in wv), one warp per
// row over the columns that Y's boxes span.  Ends with a barrier.
template <bool COUNT>
__device__ void woodbury_pass(const VisitParams& P, const LevelTables& T, const float* s_btx,
                              float* wv, float* x) {
    const int lane = threadIdx.x & 31;
    if (lane < P.m) {
        float u = 0.0f;
        for (int k = 0; k < P.m; ++k) u += T.wm[lane * P.m + k] * s_btx[k];
        wv[lane] = u;
    }
    __syncwarp();
    WARP_ROWS(i, P.H) {
        int lo, hi;
        row_span(P.ybox, P.m, i, lo, hi);
        for (int j = lo + lane; j < hi; j += 32) {
            const int p = i * P.W + j;
            x[p] = add_columns(P.ybox, P.m, T.yval, T.yoff, wv, -1.0f, i, j, x[p]);
        }
    }
    block_sync<COUNT>();
}

// r = f - A x - sum_k t_k B_k into scr (wv: this warp's t), one warp per row.
// Ends with a barrier.
template <bool COUNT>
__device__ void residual_pass(const VisitParams& P, const Box9& b, const LevelTables& T,
                              const float* __restrict__ coeffs, const float* wv,
                              const float* __restrict__ f, const float* __restrict__ x,
                              float* __restrict__ scr) {
    const int lane = threadIdx.x & 31, H = P.H, W = P.W, n = H * W;
    WARP_ROWS(i, H) {
        int lo = 0, hi = 0;
        if (P.m) row_span(P.bbox, P.m, i, lo, hi);
        for (int j = lane; j < W; j += 32) {
            const int p = i * W + j;
            float r = f[p] - (b.on ? stencil_box9(b, coeffs, x, H, W, i, j, n, p)
                                   : stencil_at(P, coeffs, x, i, j, n, p));
            if (j >= lo && j < hi) r = add_columns(P.bbox, P.m, T.bval, T.boff, wv, -1.0f, i, j, r);
            scr[p] = r;
        }
    }
    block_sync<COUNT>();
}

// --------------------------------------------------------------- whole visits
// One descend visit of one chain (arguments as descend_body of
// visit_phases.cuh; T the level's tables in the pre direction, wv this warp's
// m scalars, holding s when noise is on, s_btx shared).  `zero` sets x = 0
// first.  Ends with a barrier.
template <bool COUNT>
__device__ void subtree_descend(const VisitParams& P, const LevelTables& T, int chain,
                                int noise_mode, unsigned long long seed,
                                unsigned long long counter, bool zero, float* x, const float* f,
                                float* scr, float* fc, const float* __restrict__ coeffs,
                                const float* __restrict__ ns, const float* __restrict__ xi,
                                float* xi_rec, float* wv, float* s_btx) {
    const Box9 box = box9(P);
    const float* c = f;
    if (noise_mode || zero) {
        rhs_pass(P, T, chain, noise_mode, seed, counter, f, ns, xi, xi_rec, wv, scr, x, nullptr,
                 zero);
        block_sync<COUNT>();
        if (noise_mode) c = scr;
    }
    subtree_sweep<COUNT>(P, box, T, coeffs, c, x);
    if (P.m) {
        btx_pass<COUNT>(P, T, x, s_btx);
        woodbury_pass<COUNT>(P, T, s_btx, wv, x);
        // t = Sigma^-1 (I - G) B^T x: B^T x after the correction without a
        // second reduction, from the one before it
        const int k = threadIdx.x & 31;
        if (k < P.m) {
            float v = s_btx[k];
            for (int l = 0; l < P.m; ++l) v -= T.g[k * P.m + l] * s_btx[l];
            wv[k] = v * T.sinv[k];
        }
        __syncwarp();
    }
    residual_pass<COUNT>(P, box, T, coeffs, wv, f, x, scr);
    const int lane = threadIdx.x & 31;
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
    block_sync<COUNT>();
}

// One ascend visit of one chain; T in the post direction, xc the coarse
// state.  Ends with a barrier.
template <bool COUNT>
__device__ void subtree_ascend(const VisitParams& P, const LevelTables& T, int chain, int noise_mode,
                               unsigned long long seed, unsigned long long counter, float* x,
                               const float* f, float* scr, const float* xc,
                               const float* __restrict__ coeffs, const float* __restrict__ ns,
                               const float* __restrict__ xi, float* xi_rec, float* wv,
                               float* s_btx) {
    rhs_pass(P, T, chain, noise_mode, seed, counter, f, ns, xi, xi_rec, wv, scr, x, xc, false);
    block_sync<COUNT>();
    subtree_sweep<COUNT>(P, box9(P), T, coeffs, noise_mode ? scr : f, x);
    if (P.m) {
        btx_pass<COUNT>(P, T, x, s_btx);
        woodbury_pass<COUNT>(P, T, s_btx, wv, x);
    }
}
