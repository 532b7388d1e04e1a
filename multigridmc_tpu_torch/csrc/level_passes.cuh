// The passes of one MGMC level visit, float32, 2d (and, in the phase kernels'
// 3d build, 3d), one thread block per chain, run by the two level-visit
// kernels of the phase route (mgmc_visit.cu) and by the subtree kernel
// (mgmc_subtree.cu).  One definition of each pass serves both.
//
//   descend: per sweep direction d (one: SOR; forward then backward: SSOR)
//            c  = f + sqrt(D(2-w)/w) xi_d                  (Gibbs rhs)
//            x <- colour-ordered SOR sweep(c, x)
//            x <- x - sum_l u_l Y_l,  u = W (B^T x - Sigma^1/2 n_d)   (Woodbury:
//                 B_bar = Y W with Y = M^-1 B, W = (Sigma + B^T Y)^-1)
//            then, after the last direction,
//            r  = f - A x - sum_k t_k B_k,  t = u + Sigma^-1/2 n_d
//            f_c = R r                                     (full weighting)
//   ascend:  x <- x + gamma P x_c, then per direction c, sweep, Woodbury as above
//
// The low-rank normals n_d of a sweep enter its Woodbury correction, not its
// rhs: the sweep is linear and Y = M^-1 B, so the x' is the one of a rhs that
// holds B Sigma^-1/2 n_d (Y (I - W B^T Y) = Y W Sigma), and t = Sigma^-1 B^T x'
// exactly (B^T x' = Sigma u + Sigma^1/2 n_d).  In float32 neither the rhs term
// (about 1e3 at a measured vertex with Sigma about 1e-6, which the correction
// would have to cancel to about 1e-3) nor a Gram matrix of the correction is
// formed.
//
// What the passes rely on:
//
// * One level's tables for each sweep direction (struct LevelTables: B_k
//   inside its bounding box and Y_k inside its own, each box row major,
//   column after column, and the boxes; W, Sigma^1/2; the rows of each
//   colour), made by the host.  Where they lie is a pointer: a block's shared
//   memory where they fit, else the device tensor they were uploaded to.
// * Each low-rank term is one pass: sum_k t_k B_k joins the residual pass,
//   and the Woodbury correction is one pass.  Every
//   point has one owner thread, which adds the columns whose box holds it in
//   column order; the boxes overlap, so that order, not atomics, makes each
//   point's sum the same as a loop over the columns.  B^T x is one warp per
//   column (lanes along its box, a fixed shuffle tree).  The m scalars a pass
//   needs (n, u or t) each warp computes for itself into its own slot: up
//   to LANE_SLOTS of them one a lane.  A kernel compiled for more (LR,
//   m > LANE_SLOTS, visit_phases.cuh) holds entries lane, lane + 32, ... in
//   a lane, the warp's slot two m-vectors (u, then t; and n), B^T x -
//   Sigma^1/2 n formed by the B^T x pass in the block's vector, all in
//   dynamic shared memory sized by m (lowrank_scratch_floats), W v a row at a
//   time (warp_matvec); the kernels of up to LANE_SLOTS keep the code they
//   had, the LR code compiled out of them.
// * The sweep's warps take the rows that hold the colour in turn (T.rows), so
//   every warp has rows in every colour phase; within a colour no point reads
//   another, so the order of the rows does not change the result.
// * The stencil, any reach-1 stencil of at most 9 offsets (and, in the phase
//   kernels' reach-2 build, a reach-2 stencil of at most 13 offsets or the
//   5x5 box), is held in registers for a pass (struct Stencil): each offset as
//   an address offset and each constant coefficient read once, a coefficient
//   that varies in space read per point.  A lane loads what its points read (neighbours,
//   planes, the rhs) together before their arithmetic, LANE_POINTS points at
//   once where the registers allow, so that several round trips to the L2 or
//   to device memory are in flight; a neighbour outside the field is neither
//   loaded nor added, and the terms are added in offset order, as stencil_at
//   (visit_phases.cuh) adds them, so the two agree bitwise.  The sweep and
//   the residual are compiled per stencil form (STENCIL_DISPATCH).
//
// * 3d (VISIT_DIM 3, the phase kernels' 3d build): a level of Z planes of Y
//   rows of W points is H = Z Y rows of W points, row r = z Y + y, so the
//   passes that go row by row (the rhs, its Philox groups, the Woodbury
//   correction, the residual) run unchanged; the stencil's offsets are
//   dz Y W + dy W + dx with two more edge bits (z), a box is (k0, k1, i0, i1,
//   j0, j1), a row's colours follow (wz z + w0 y) mod n_colors (the colour
//   rows are (z, y) residue pairs), and the transfers are 3d (restrict_rows3,
//   prolong_rows3).
//
// Barriers (block_sync; COUNT, a kernel's stamps build, counts them and, where
// pass_stamp_row is set, stamps the timer after each): per sweep direction
// n_order + 3 (rhs, colours, B^T x, Woodbury), without the two low-rank ones
// where m = 0, and a descend 2 more (residual, restriction).  A descend's
// first direction that neither draws noise nor zeroes x has no rhs pass and
// no barrier for it unless the caller asks for one (the phase kernels do: it
// publishes their table copy); a later direction has its rhs barrier always.

#pragma once

#include "block_stamps.cuh"
#include "visit_phases.cuh"

// One level's tables for one sweep direction.
struct LevelTables {
    const float* bval;     // B_k inside bbox_k, column after column, each box row major
    const int* boff;       // m + 1 starts of the columns in bval
    const float* yval;     // Y_k = M^-1 B_k of this direction inside ybox_k, likewise
    const int* yoff;       // m + 1 starts in yval
    const float* wm;       // W of this direction, m x m row major
    const float* sroot;    // Sigma^1/2
    const int (*bbox)[BOX_INTS];  // B_k's box (half open), as VisitParams::bbox
    const int (*ybox)[BOX_INTS];  // the same for Y_k of this direction
    // per row i, (lo, hi): the columns that the boxes holding the row span
    // (lo >= hi: none), of B's and of Y's boxes; null: found from the boxes
    const int* bspan;
    const int* yspan;
    // per colour of the sweep order, COLOUR_ROW_WORDS(n_colors) words: the
    // number R of row residues mod n_colors whose rows hold the colour, then R
    // pairs (residue, first column of the colour in such a row), residues
    // ascending; in 3d R triples (z residue, y residue, first column) of the
    // rows (z, y) with z, y = those residues mod n_colors
    const int* rows;
};

#if VISIT_DIM == 3
#define COLOUR_ROW_WORDS(K) (1 + 3 * (K) * (K))
// a row's extent along y, where a pass that takes row r = z Y + y needs it
#define ROW_NY(P) ((P).Y)
#else
#define COLOUR_ROW_WORDS(K) (1 + 2 * (K))
#define ROW_NY(P) 0
#endif

// ------------------------------------------------------- the stencil in registers
// A stencil of reach REACH (1, or 2 in the phase kernels' reach-2 build) and
// at most KMAX offsets, read once per pass.  Bit k of up / dn / lf / rt:
// offset k reads a row above / below, a column to the left / right, so a
// point on the field's edge drops those terms; at reach 2, bit k of up2 / dn2
// / lf2 / rt2: offset k reads two rows above / below, two columns to the left
// / right, so a point one row or column in from the edge drops those.  BOX:
// the stencil is the (2 REACH + 1)^2 box in raster order (the Galerkin
// levels), whose offsets and edge bits the compiler knows.  3d: bit k of fr /
// bk: offset k reads a plane in front (z - 1) / behind (z + 1); BOX is the 3x3x3
// box in raster order.
template <int KMAX, bool BOX, int REACH = 1>
struct Stencil {
    unsigned all;                // bit k for every offset k < K
    unsigned planes;             // bit k: coefficient k varies in space, read per point
    unsigned up, dn, lf, rt;
    unsigned up2, dn2, lf2, rt2;  // reach 2 only
#if VISIT_DIM == 3
    unsigned fr, bk;
#endif
    int off[KMAX];               // dy_k W + dx_k (3d: dz_k Y W + dy_k W + dx_k)
    float c[KMAX];               // the constant coefficients
};

template <int KMAX, bool BOX, int REACH = 1>
__device__ __forceinline__ Stencil<KMAX, BOX, REACH> stencil_regs(const VisitParams& P) {
    constexpr int SIDE = 2 * REACH + 1;
    Stencil<KMAX, BOX, REACH> s;
    s.all = s.planes = s.up = s.dn = s.lf = s.rt = 0;
    s.up2 = s.dn2 = s.lf2 = s.rt2 = 0;
#if VISIT_DIM == 3
    s.fr = s.bk = 0;
#endif
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
        const bool on = BOX || k < P.K;
#if VISIT_DIM == 3
        const int dz = BOX ? k / (SIDE * SIDE) - REACH : (on ? P.dz[k] : 0);
        const int dy = BOX ? (k / SIDE) % SIDE - REACH : (on ? P.dy[k] : 0);
        const int dx = BOX ? k % SIDE - REACH : (on ? P.dx[k] : 0);
        s.off[k] = (dz * P.Y + dy) * P.W + dx;
        s.fr |= (on && dz < 0) ? 1u << k : 0u;
        s.bk |= (on && dz > 0) ? 1u << k : 0u;
#else
        const int dy = BOX ? k / SIDE - REACH : (on ? P.dy[k] : 0);
        const int dx = BOX ? k % SIDE - REACH : (on ? P.dx[k] : 0);
        s.off[k] = dy * P.W + dx;
#endif
        s.c[k] = on ? P.coeff_val[k] : 0.0f;
        const unsigned bit = on ? 1u << k : 0u;
        s.all |= bit;
        if (!P.coeff_const[k]) s.planes |= bit;
        s.up |= dy < 0 ? bit : 0u;
        s.dn |= dy > 0 ? bit : 0u;
        s.lf |= dx < 0 ? bit : 0u;
        s.rt |= dx > 0 ? bit : 0u;
        if constexpr (REACH > 1) {
            s.up2 |= dy < -1 ? bit : 0u;
            s.dn2 |= dy > 1 ? bit : 0u;
            s.lf2 |= dx < -1 ? bit : 0u;
            s.rt2 |= dx > 1 ? bit : 0u;
        }
    }
    return s;
}

// whether the stencil is the 3x3 box in raster order
__device__ __forceinline__ bool raster_box(const VisitParams& P) {
    bool box = P.K == 9;
#pragma unroll
    for (int k = 0; k < 9; ++k) box = box && P.dy[k] == k / 3 - 1 && P.dx[k] == k % 3 - 1;
    return box;
}

// the terms that a point of row i adds: every offset but those that leave the
// field through the top or the bottom row
template <int KMAX, bool BOX, int REACH>
__device__ __forceinline__ unsigned row_terms(const Stencil<KMAX, BOX, REACH>& s, int i, int H) {
    unsigned t = s.all & ~(i == 0 ? s.up : 0u) & ~(i == H - 1 ? s.dn : 0u);
    if constexpr (REACH > 1) t &= ~(i == 1 ? s.up2 : 0u) & ~(i == H - 2 ? s.dn2 : 0u);
    return t;
}

#if VISIT_DIM == 3
// the terms that a point of row (z, y) adds: every offset but those that leave
// the field through its first or last row or plane
template <int KMAX, bool BOX, int REACH>
__device__ __forceinline__ unsigned row_terms3(const Stencil<KMAX, BOX, REACH>& s,
                                               const VisitParams& P, int z, int y) {
    return s.all & ~(y == 0 ? s.up : 0u) & ~(y == P.Y - 1 ? s.dn : 0u) &
           ~(z == 0 ? s.fr : 0u) & ~(z == P.Z - 1 ? s.bk : 0u);
}
#endif

// the terms that point j of a row with terms `row` adds; none where j >= W
template <int KMAX, bool BOX, int REACH>
__device__ __forceinline__ unsigned point_terms(const Stencil<KMAX, BOX, REACH>& s, unsigned row,
                                                int j, int W) {
    if (j >= W) return 0u;
    unsigned t = row & ~(j == 0 ? s.lf : 0u) & ~(j == W - 1 ? s.rt : 0u);
    if constexpr (REACH > 1) t &= ~(j == 1 ? s.lf2 : 0u) & ~(j == W - 2 ? s.rt2 : 0u);
    return t;
}

// The operands of (A x)[p] for U points: the neighbours and, where a
// coefficient plane is read (PLANES), the coefficients; all loads issued
// before any is used
template <int KMAX, int U, bool PLANES>
struct Operands {
    float v[U][KMAX];
    float a[PLANES ? U : 1][KMAX];
};

template <int KMAX, bool BOX, int U, bool PLANES, int REACH>
__device__ __forceinline__ void load_operands(const Stencil<KMAX, BOX, REACH>& s,
                                              const float* __restrict__ coeffs, const float* x,
                                              int n, const int (&p)[U], const unsigned (&in)[U],
                                              Operands<KMAX, U, PLANES>& o) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
            const bool use = (in[u] >> k) & 1u;
            o.v[u][k] = use ? x[p[u] + s.off[k]] : 0.0f;
            if (PLANES)
                o.a[PLANES ? u : 0][k] = (use && ((s.planes >> k) & 1u))
                                             ? coeffs[(size_t)k * n + p[u]] : s.c[k];
        }
}

// (A x)[p_u], the terms in offset order as stencil_at adds them
template <int KMAX, bool BOX, int U, bool PLANES, int REACH>
__device__ __forceinline__ float apply_operands(const Stencil<KMAX, BOX, REACH>& s,
                                                const Operands<KMAX, U, PLANES>& o, unsigned in,
                                                int u) {
    float ax = 0.0f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
        if ((in >> k) & 1u) ax += (PLANES ? o.a[PLANES ? u : 0][k] : s.c[k]) * o.v[u][k];
    return ax;
}

// ------------------------------------------------------------------- the sweep
// Where c of point (i, j), of colour ci, lies in a rhs scratch packed by
// colour (rhs_packed): colour after colour, each H rows of ceil(W / s)
// values, point (i, j) at j / s in its row (a colour's first column in a row
// is below s), so that a colour's points of a row are contiguous.
__device__ __forceinline__ int packed_index(const VisitParams& P, int ci, int i, int j) {
    const int s = P.jstride;
    return (ci * P.H + i) * ((P.W + s - 1) / s) + j / s;
}

// One colour-ordered SOR sweep: x[p] += omega (c[p] - (A x)[p]) / diag[p] on
// the points of the current colour, colour by colour in the order;
// colour = (w0 i + w1 j) mod n_colors.  The warps take the rows
// that hold the colour in turn (T.rows); within a row a lane updates U points
// of the colour at a time, its loads first, its stores last (no point of a
// colour reads another).  PACKED: c lies packed by colour (packed_index).
// 3d: slot r of a colour is (z block qz, y block qy, residue pair t), the row
// z = qz K + zr_t, y = qy K + yr_t; slots past the field's edge are skipped.
template <int KMAX, bool BOX, int U, bool PLANES, bool COUNT, bool PACKED, int REACH = 1>
__device__ __forceinline__ void sweep_colours(const VisitParams& P, const LevelTables& T,
                                              const float* __restrict__ coeffs,
                                              const float* __restrict__ c, float* x) {
    const Stencil<KMAX, BOX, REACH> st = stencil_regs<KMAX, BOX, REACH>(P);
    const int H = P.H, W = P.W, n = H * W, lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const int s = P.jstride, K = P.n_colors, d = P.diag_index;
    const bool dplane = !P.coeff_const[d];
    const float dval = P.coeff_val[d], omega = P.omega;
#if VISIT_DIM == 3
    const int nqy = (P.Y + K - 1) / K;
#endif
    for (int o = 0; o < P.n_order; ++o) {
        const int* cr = T.rows + o * COLOUR_ROW_WORDS(K);
        const int R = cr[0];
        for (int r = warp; R > 0; r += nwarps) {
            const int q = r / R, t = r - q * R;
#if VISIT_DIM == 3
            const int qz = q / nqy, qy = q - qz * nqy;
            if (qz * K >= P.Z) break;
            const int z = qz * K + cr[1 + 3 * t], y = qy * K + cr[2 + 3 * t];
            if (z >= P.Z || y >= P.Y) continue;
            const int i = z * P.Y + y, jfirst = cr[3 + 3 * t];
            const unsigned rin = row_terms3(st, P, z, y);
#else
            const int i = q * K + cr[1 + 2 * t];
            if (i >= H) break;
            const int jfirst = cr[2 + 2 * t];
            const unsigned rin = row_terms(st, i, H);
#endif
            if constexpr (PACKED) {
                // the row's k-th point of the colour is column jc + s k, its c at
                // crow + k.  (The same body as below, stepping k rather than the
                // column: each form measured faster where it is taken, PERF.md.)
                const int jc = jfirst;
                const int crow = packed_index(P, P.order[o], i, jc);
                for (int k0 = lane; jc + s * k0 < W; k0 += 32 * U) {
                    int p[U];
                    unsigned in[U];
                    float cv[U], dv[U], xv[U];
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        const int j = jc + s * (k0 + 32 * u);
                        const bool ok = j < W;
                        p[u] = i * W + (ok ? j : 0);
                        in[u] = point_terms(st, rin, j, W);
                        cv[u] = ok ? c[crow + k0 + 32 * u] : 0.0f;
                        xv[u] = ok ? x[p[u]] : 0.0f;
                        dv[u] = (ok && dplane) ? coeffs[(size_t)d * n + p[u]] : dval;
                    }
                    Operands<KMAX, U, PLANES> op;
                    load_operands<KMAX, BOX, U, PLANES>(st, coeffs, x, n, p, in, op);
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        const float ax = apply_operands<KMAX, BOX, U, PLANES>(st, op, in[u], u);
                        if (jc + s * (k0 + 32 * u) < W)
                            x[p[u]] = xv[u] + omega * (cv[u] - ax) / dv[u];
                    }
                }
                continue;
            }
            for (int j0 = jfirst + s * lane; j0 < W; j0 += 32 * s * U) {
                int p[U];
                unsigned in[U];
                float cv[U], dv[U], xv[U];
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int j = j0 + 32 * s * u;
                    const bool ok = j < W;
                    p[u] = i * W + (ok ? j : 0);
                    in[u] = point_terms(st, rin, j, W);
                    cv[u] = ok ? c[p[u]] : 0.0f;
                    xv[u] = ok ? x[p[u]] : 0.0f;
                    dv[u] = (ok && dplane) ? coeffs[(size_t)d * n + p[u]] : dval;
                }
                Operands<KMAX, U, PLANES> op;
                load_operands<KMAX, BOX, U, PLANES>(st, coeffs, x, n, p, in, op);
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const float ax = apply_operands<KMAX, BOX, U, PLANES>(st, op, in[u], u);
                    if (j0 + 32 * s * u < W) x[p[u]] = xv[u] + omega * (cv[u] - ax) / dv[u];
                }
            }
        }
        block_sync<COUNT>();
    }
}

// Points per lane in flight in the sweep, by the stencil's size and whether a
// coefficient plane is read per point: as many as the 64 registers a thread
// has (at 1024 threads per SM) hold without spilling.
#define LANE_POINTS(KMAX, PLANES) ((KMAX) == 5 ? ((PLANES) ? 2 : 4) : ((PLANES) ? 1 : 2))

// Whether a coefficient plane is read per point.
__device__ __forceinline__ bool any_plane(const VisitParams& P) {
    bool planes = false;
    for (int k = 0; k < P.K; ++k) planes = planes || !P.coeff_const[k];
    return planes;
}

// The stencil forms a pass is compiled for: 0 / 1 up to 5 offsets, 2 / 3 the
// raster 3x3 box, 4 / 5 any other of up to 9; the odd ones read a coefficient
// plane per point.  FORM >= 0: that form alone (the phase kernels, one kernel
// per form, chosen by the host); FORM < 0: the level's form, found at run time
// (the subtree kernel, whose levels differ).
#define STENCIL_FORMS 6

__device__ __forceinline__ int stencil_form(const VisitParams& P) {
    return (P.K <= 5 ? 0 : raster_box(P) ? 2 : 4) + (any_plane(P) ? 1 : 0);
}

#define STENCIL_DISPATCH(FORM, P, CALL)                   \
    do {                                                   \
        switch ((FORM) >= 0 ? (FORM) : stencil_form(P)) {  \
            case 0: CALL(5, false, false); break;          \
            case 1: CALL(5, false, true); break;           \
            case 2: CALL(9, true, false); break;           \
            case 3: CALL(9, true, true); break;            \
            case 4: CALL(9, false, false); break;          \
            default: CALL(9, false, true); break;          \
        }                                                  \
    } while (0)

// The reach-2 forms, compiled only into the phase kernels' reach-2 build
// (mgmc_visit.cu, VISIT_REACH 2), each a kernel of its own: 6 / 7 a reach-2
// stencil of at most 13 offsets (the squared FD prior's diamond), 8 / 9 the
// 5x5 box in raster order (its Galerkin levels); the odd ones read a
// coefficient plane per point.  One point per lane at a time: the 25 operands
// of the box (and as many coefficients) fill a thread's registers.
#define WIDE_FORM0 6
#define WIDE_FORMS 4
#define WIDE_KMAX(FORM) ((FORM) < 8 ? 13 : 25)
#define WIDE_BOX(FORM) ((FORM) >= 8)
#define WIDE_PLANES(FORM) (((FORM) & 1) != 0)

// The 3d forms, compiled only into the phase kernels' 3d build (mgmc_visit.cu,
// VISIT_DIM 3), each a kernel of its own: 10 / 11 up to 7 offsets (the FD
// prior's 7-point stencil), 12 / 13 the 3x3x3 box in raster order (its
// Galerkin levels), 14 / 15 any other of up to 27 offsets; the odd ones read
// a coefficient plane per point.  The 27-offset forms take one point per lane
// (their operands fill a thread's registers), the 7-point form several.
#define DIM3_FORM0 10
#define DIM3_FORMS 6
#define DIM3_KMAX(FORM) ((FORM) < 12 ? 7 : 27)
#define DIM3_BOX(FORM) ((FORM) == 12 || (FORM) == 13)
#define DIM3_PLANES(FORM) (((FORM) & 1) != 0)
#define DIM3_POINTS(FORM) ((FORM) < 12 ? (DIM3_PLANES(FORM) ? 2 : 4) : 1)

// PACKED: c packed by colour.  Ends with a barrier.
template <int FORM, bool COUNT, bool PACKED = false>
__device__ void level_sweep(const VisitParams& P, const LevelTables& T,
                            const float* __restrict__ coeffs, const float* __restrict__ c,
                            float* x) {
#define SWEEP(KMAX, BOX, PLANES) \
    sweep_colours<KMAX, BOX, LANE_POINTS(KMAX, PLANES), PLANES, COUNT, PACKED>(P, T, coeffs, c, x)
#if VISIT_DIM == 3
    sweep_colours<DIM3_KMAX(FORM), DIM3_BOX(FORM), DIM3_POINTS(FORM), DIM3_PLANES(FORM), COUNT,
                  PACKED>(P, T, coeffs, c, x);
#else
    if constexpr (FORM >= WIDE_FORM0) {
        sweep_colours<WIDE_KMAX(FORM), WIDE_BOX(FORM), 1, WIDE_PLANES(FORM), COUNT, PACKED, 2>(
            P, T, coeffs, c, x);
    } else {
        STENCIL_DISPATCH(FORM, P, SWEEP);
    }
#endif
#undef SWEEP
}

// ------------------------------------------------- the sweep by colour points
// A sweep direction's colours as lists of points, for the subtree kernel's
// reach-2 build, whose levels' 9 colours leave a row 3 or 4 points of a
// colour (a warp per row would keep 28 of 32 lanes idle): per colour o of the
// order its points (i << 16) | j, entries[start[o] .. start[o + 1]), the first
// plain[o] of them interior (every coefficient whose neighbour lies in the
// field equals the level's interior value, which the parameter block's
// coeff_val holds for every offset: they read no coefficient plane), the rest
// after them, each part in storage order; the block's threads take a colour's
// points in turn.  The host builds them (mgmc_subtree.py::point_tables).
struct PointTables {
    const int* entries;
    const int* start;  // n_order + 1
    const int* plain;  // n_order
};

// One colour-ordered SOR sweep from the colours' point lists: the stencil in
// registers as sweep_colours holds it, a point's loads before its arithmetic,
// the terms in offset order with out-of-field terms skipped (the values
// sweep_colours computes).  A barrier after each colour.
template <int KMAX, bool BOX, bool COUNT, int REACH>
__device__ __forceinline__ void sweep_points(const VisitParams& P, const PointTables& Q,
                                             const float* __restrict__ coeffs,
                                             const float* __restrict__ c, float* x) {
    const Stencil<KMAX, BOX, REACH> st = stencil_regs<KMAX, BOX, REACH>(P);
    const int H = P.H, W = P.W, n = H * W, d = P.diag_index;
    const float omega = P.omega, dval = P.coeff_val[d];
    const bool dplane = !P.coeff_const[d];
    for (int o = 0; o < P.n_order; ++o) {
        const int first = Q.start[o], count = Q.start[o + 1] - first, plain = Q.plain[o];
        for (int t = threadIdx.x; t < count; t += blockDim.x) {
            const int e = __ldg(Q.entries + first + t);
            const int i = e >> 16, j = e & 0xffff, p = i * W + j;
            const unsigned in = point_terms(st, row_terms(st, i, H), j, W);
            float v[KMAX];
#pragma unroll
            for (int k = 0; k < KMAX; ++k) v[k] = ((in >> k) & 1u) ? x[p + st.off[k]] : 0.0f;
            const float cv = c[p], xv = x[p];
            float ax = 0.0f, dv;
            if (t < plain) {
#pragma unroll
                for (int k = 0; k < KMAX; ++k)
                    if ((in >> k) & 1u) ax += st.c[k] * v[k];
                dv = dval;
            } else {
                float a[KMAX];
#pragma unroll
                for (int k = 0; k < KMAX; ++k)
                    a[k] = ((in >> k) & (st.planes >> k) & 1u) ? coeffs[(size_t)k * n + p] : st.c[k];
                dv = dplane ? coeffs[(size_t)d * n + p] : dval;
#pragma unroll
                for (int k = 0; k < KMAX; ++k)
                    if ((in >> k) & 1u) ax += a[k] * v[k];
            }
            x[p] = xv + omega * (cv - ax) / dv;
        }
        block_sync<COUNT>();
    }
}

// The reach-2 forms' sweep from point lists (FORM >= WIDE_FORM0).  Ends with a
// barrier.
template <int FORM, bool COUNT>
__device__ void level_sweep_points(const VisitParams& P, const PointTables& Q,
                                   const float* __restrict__ coeffs, const float* __restrict__ c,
                                   float* x) {
    static_assert(FORM >= WIDE_FORM0 && FORM < WIDE_FORM0 + WIDE_FORMS, "a reach-2 form");
    sweep_points<WIDE_KMAX(FORM), WIDE_BOX(FORM), COUNT, 2>(P, Q, coeffs, c, x);
}

// --------------------------------------------------------- the low-rank terms
// [lo, hi): the columns that the boxes holding row i span (lo >= hi: none),
// from the host's table of spans where there is one (the 3d build has one
// always)
__device__ __forceinline__ void row_span(const int (*box)[BOX_INTS], const int* spans, int m,
                                         int i, int& lo, int& hi) {
    if (VISIT_DIM == 3 || spans != nullptr) {
        lo = spans[2 * i];
        hi = spans[2 * i + 1];
        return;
    }
    lo = 1 << 30;
    hi = 0;
    for (int k = 0; k < m; ++k)
        if (box[k][0] <= i && i < box[k][1]) {
            lo = min(lo, box[k][2]);
            hi = max(hi, box[k][3]);
        }
}

// v + sign * coef[k] * F_k[i, j] for each column k whose box holds (i, j), in
// column order: F_k's values lie row major inside box k from val + off[k].
// 3d: i is the row z ny + y, and box k holds (z, y, j).
__device__ __forceinline__ float add_columns(const int (*box)[BOX_INTS], int m, const float* val,
                                             const int* off, const float* coef, float sign,
                                             int i, int j, float v, int ny) {
#if VISIT_DIM == 3
    const int z = i / ny, y = i - z * ny;
    for (int k = 0; k < m; ++k) {
        const int z0 = box[k][0], i0 = box[k][2], j0 = box[k][4];
        if (z >= z0 && z < box[k][1] && y >= i0 && y < box[k][3] && j >= j0 && j < box[k][5])
            v += sign * coef[k] *
                 val[off[k] + ((z - z0) * (box[k][3] - i0) + (y - i0)) * (box[k][5] - j0) +
                     (j - j0)];
    }
#else
    for (int k = 0; k < m; ++k) {
        const int i0 = box[k][0], j0 = box[k][2];
        if (i >= i0 && i < box[k][1] && j >= j0 && j < box[k][3])
            v += sign * coef[k] * val[off[k] + (i - i0) * (box[k][3] - j0) + (j - j0)];
    }
#endif
    return v;
}

// Where a warp's slot wv (m floats up to LANE_SLOTS, 2 m in an LR kernel)
// holds its n: the slot itself (n, then u, then t), or past its u.
template <bool LR>
__device__ __forceinline__ float* normals_of(float* wv, int m) {
    return LR ? wv + m : wv;
}

// This warp's n: the m low-rank normals of a sweep (mode 1: the generator
// under `counter`, normal k element k % 4 of point group k / 4; mode 2: read
// from xi), recorded by warp 0 where xi_rec is set.  (The subtree kernel
// draws them; the phase kernels are handed them.)
template <bool LR>
__device__ __forceinline__ void lowrank_normals(int m, int chain, int noise_mode,
                                                unsigned long long seed,
                                                unsigned long long counter, const float* xi,
                                                float* xi_rec, float* wv) {
    if constexpr (LR) {
        float* nv = normals_of<LR>(wv, m);
        for (int k = threadIdx.x & 31; k < m; k += 32) {
            float z;
            if (noise_mode == 1) {
                float z4[4];
                philox_normals4((uint32_t)(k >> 2), (uint32_t)chain, seed, counter, z4);
                const int q = k & 3;
                z = q == 0 ? z4[0] : (q == 1 ? z4[1] : (q == 2 ? z4[2] : z4[3]));
                if (xi_rec != nullptr && threadIdx.x < 32) xi_rec[k] = z;
            } else {
                z = xi[k];
            }
            nv[k] = z;
        }
    } else {
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
            wv[lane] = z;
        }
    }
    __syncwarp();
}

// This warp's n of a later sweep direction, from the chain's normals in
// memory (noise on and m > 0; else nothing).  The warp has read its slot's
// last values before (the barrier after the Woodbury pass).
template <bool LR>
__device__ __forceinline__ void next_normals(const VisitParams& P, int noise_mode,
                                             const float* __restrict__ nlr, float* wv) {
    if constexpr (LR) {
        float* nv = normals_of<LR>(wv, P.m);
        if (noise_mode)
            for (int k = threadIdx.x & 31; k < P.m; k += 32) nv[k] = nlr[k];
    } else {
        const int lane = threadIdx.x & 31;
        if (noise_mode && lane < P.m) wv[lane] = nlr[lane];
    }
    __syncwarp();
}

// ------------------------------------------------------------------- the rhs
// A warp's stores of its 32 noise groups, lane-contiguous: the groups' points
// lie in one span of memory (a row's last group ends where the next row's
// first begins), so each lane puts its four values at their place in the
// warp's staging buffer (128 floats of shared memory) and the warp writes the
// span back, lane l the points l, l + 32, l + 64, l + 96 of it.  p0: the
// span's first point, n its length.
__device__ __forceinline__ void store_span(float* stage, float* __restrict__ dst, int p0, int n,
                                           const int (&off)[4], const float (&v)[4]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int q = 0; q < 4; ++q)
        if (off[q] >= 0) stage[off[q]] = v[q];
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 4; ++u)
        if (lane + 32 * u < n) dst[p0 + lane + 32 * u] = stage[lane + 32 * u];
    __syncwarp();
}

// The pass before the sweep: x = 0 (zero), x += gamma P x_c (xc not null: an
// ascend) and, with noise, the Gibbs rhs c = f + ns xi into scr (the sweep's
// low-rank noise enters its Woodbury correction).  Noise group g of row i holds the points
// (i, 4g .. 4g+3) and has the Philox counter (i * ceil(W / 4) + g, chain,
// counter); the block's threads take the groups of the whole field in turn (a
// row of a small level has fewer groups than a warp has lanes), each group's
// loads issued before its draw; xi_rec receives the normals used.  stage: this
// warp's 128 floats of shared memory (the phase kernels), through which the
// warp stores x and scr lane-contiguous (store_span); null: each lane stores
// its group's points itself (the subtree kernel, whose shared memory holds
// its fields).  No barrier.
__device__ void rhs_pass(const VisitParams& P, int chain, int noise_mode,
                         unsigned long long seed, unsigned long long counter,
                         const float* __restrict__ f, const float* __restrict__ ns,
                         const float* __restrict__ xi, float* __restrict__ xi_rec,
                         float* __restrict__ scr, float* __restrict__ x,
                         const float* __restrict__ xc, bool zero, float* stage) {
    const int H = P.H, W = P.W, Hc = P.Hc, Wc = P.Wc;
    const int G = (W + 3) >> 2, NG = H * G;
    const bool ns_const = P.ns_const;
    const float ns_val = P.ns_val, gamma = P.gamma;
    const int lane = threadIdx.x & 31;
    // with staging the loop runs warp-uniform: a warp takes a turn while its
    // first group is live
    const int end = stage != nullptr ? NG + lane : NG;
    // group q4 is (row i, group g); a turn steps q4 by the block's size
    const int di = blockDim.x / G, dg = blockDim.x - di * G;
    int i = threadIdx.x / G, g = threadIdx.x - i * G;
    for (int q4 = threadIdx.x; q4 < end; q4 += blockDim.x) {
        const bool live = q4 < NG;
        // (P x_c)[i, j]: an odd fine index 2I+1 takes coarse I with weight 1,
        // an even one its two coarse neighbours with 0.5 each.  The group's
        // points read the coarse rows Ia, Ia + 1 (odd i: Ia alone) and the
        // coarse columns 2g - 1 + t, t = 0, 1, 2; a coarse value outside the
        // coarse field is read as 0, and adds +0 where the loop of the other
        // kernels skips it: the same sum, bit for bit.
        const int nI = (i & 1) ? 1 : 2, Ia = (i >> 1) - (nI - 1);
        const float wi = (i & 1) ? 1.0f : 0.5f;
        // the group's loads first, so that they are in flight during the draw
        float fv[4], xv[4], cv[2][3];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int j = 4 * g + q, p = i * W + j;
            fv[q] = (live && noise_mode && j < W) ? f[p] : 0.0f;
            xv[q] = (live && xc != nullptr && j < W) ? x[p] : 0.0f;
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int t = 0; t < 3; ++t) {
                const int I = Ia + a, J = 2 * g - 1 + t;
                cv[a][t] = (live && xc != nullptr && a < nI && I >= 0 && I < Hc && J >= 0 &&
                            J < Wc) ? xc[I * Wc + J] : 0.0f;
            }
        float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (noise_mode == 1 && live)
            philox_normals4((uint32_t)q4, (uint32_t)chain, seed, counter, z);
        float xo[4], co[4];
        int off[4];
        // the span of the warp's groups (staging only): from the first point
        // of lane 0's group to the last point of the last live lane's
        int p0 = 0, pe = 0;
        if (stage != nullptr) {
            p0 = __shfl_sync(0xffffffffu, i * W + 4 * g, 0);
            pe = __shfl_sync(0xffffffffu, i * W + min(4 * g + 3, W - 1),
                             min(31, NG - 1 - (q4 - lane)));
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int j = 4 * g + q;
            const int p = i * W + j;
            off[q] = (live && j < W) ? p - p0 : -1;
            xo[q] = 0.0f;
            co[q] = 0.0f;
            if (off[q] < 0) continue;
            if (zero) x[p] = 0.0f;
            if (xc != nullptr) {
                // j = 4g + q: an even q reads columns t0, t0 + 1 (weight 0.5
                // each), an odd q column t0 (weight 1); t0 = 0, 1, 1, 2
                const int t0 = (q + 1) >> 1;
                const float wj = (q & 1) ? 1.0f : 0.5f;
                float px = 0.0f;
#pragma unroll
                for (int a = 0; a < 2; ++a) {
                    float row = 0.0f;
                    row += wj * cv[a][t0];
                    if (!(q & 1)) row += wj * cv[a][t0 + 1];
                    px += wi * row;
                }
                xo[q] = xv[q] + gamma * px;
                if (stage == nullptr) x[p] = xo[q];
            }
            if (noise_mode) {
                float zq = (noise_mode == 2) ? xi[p] : z[q];
                if (xi_rec != nullptr) xi_rec[p] = zq;
                const float c = fv[q] + (ns_const ? ns_val : ns[p]) * zq;
                co[q] = c;
                if (stage == nullptr) scr[p] = c;
            }
        }
        if (stage != nullptr) {
            if (xc != nullptr) store_span(stage, x, p0, pe - p0 + 1, off, xo);
            if (noise_mode) store_span(stage, scr, p0, pe - p0 + 1, off, co);
        }
        i += di;
        g += dg;
        if (g >= G) {
            g -= G;
            ++i;
        }
    }
}

// The Gibbs rhs of a sweep with no low-rank term into a scratch packed by
// colour (packed_index), so that each colour reads whole sectors of it: c = f
// + ns xi (noise group g of row i has the Philox counter (i * ceil(W / 4) +
// g, chain, counter), as rhs_pass).  The block's threads take the groups in
// turn, each group's f loaded before its draw; a lane's points of a colour
// are contiguous in the scratch, and so are the lanes' (a warp's stores of a
// colour cover whole sectors without staging).  3d: row i is (z, y), its
// colours (wz z + w0 y + w1 j) mod n_colors.  Ends with a barrier.
template <bool COUNT>
__device__ void rhs_packed(const VisitParams& P, int chain, const float* __restrict__ f,
                           const float* __restrict__ ns, const float* __restrict__ xi,
                           float* __restrict__ cpk) {
    const int H = P.H, W = P.W, G = (W + 3) >> 2, NG = H * G, K = P.n_colors;
    const int di = blockDim.x / G, dg = blockDim.x - di * G;
    int i = threadIdx.x / G, g = threadIdx.x - i * G;
    for (int q4 = threadIdx.x; q4 < NG; q4 += blockDim.x) {
        float fv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) fv[q] = 4 * g + q < W ? f[i * W + 4 * g + q] : 0.0f;
        float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (P.noise_mode == 1) philox_normals4((uint32_t)q4, (uint32_t)chain, P.seed, P.counter, z);
#if VISIT_DIM == 3
        const int zr = i / P.Y, rowc = P.wz * zr + P.w0 * (i - zr * P.Y);
#else
        const int rowc = P.w0 * i;
#endif
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int j = 4 * g + q, p = i * W + j;
            if (j >= W) break;
            const float zq = P.noise_mode == 2 ? xi[p] : z[q];
            cpk[packed_index(P, (rowc + P.w1 * j) % K, i, j)] =
                fv[q] + (P.ns_const ? P.ns_val : ns[p]) * zq;
        }
        i += di;
        g += dg;
        if (g >= G) {
            g -= G;
            ++i;
        }
    }
    block_sync<COUNT>();
}

// ------------------------------------------------------------ B^T x, Woodbury
// s_btx[k] = <B_k, x> over column k's box: one warp per column, lanes along
// the box, a shuffle tree; in an LR kernel the Woodbury argument <B_k, x> -
// Sigma^1/2_k n_k (n from the warp's slot wv where `noise` is on, else 0),
// which every warp reads there.  Ends with a barrier.
template <bool COUNT, bool LR = false>
__device__ void btx_pass(const VisitParams& P, const LevelTables& T, const float* x, float* s_btx,
                         const float* wv, bool noise) {
    const int lane = threadIdx.x & 31;
    for (int k = threadIdx.x >> 5; k < P.m; k += blockDim.x >> 5) {
#if VISIT_DIM == 3
        // the box's rows (z, y) in turn: row q of the box is z0 + q / bh, i0 + q % bh
        const int z0 = T.bbox[k][0], i0 = T.bbox[k][2], j0 = T.bbox[k][4];
        const int bh = T.bbox[k][3] - i0, bw = T.bbox[k][5] - j0;
        const int area = (T.bbox[k][1] - z0) * bh * bw;
        const float* v = T.bval + T.boff[k];
        float acc = 0.0f;
        for (int q = lane; q < area; q += 32) {
            const int row = q / bw, zq = row / bh;
            acc += x[((z0 + zq) * P.Y + i0 + row - zq * bh) * P.W + j0 + q - row * bw] * v[q];
        }
#else
        const int i0 = T.bbox[k][0], j0 = T.bbox[k][2];
        const int bw = T.bbox[k][3] - j0, area = (T.bbox[k][1] - i0) * bw;
        const float* v = T.bval + T.boff[k];
        float acc = 0.0f;
        for (int q = lane; q < area; q += 32) acc += x[(i0 + q / bw) * P.W + j0 + q % bw] * v[q];
#endif
        acc = warp_total(acc);
        if constexpr (LR) acc -= T.sroot[k] * (noise ? wv[P.m + k] : 0.0f);
        if (lane == 0) s_btx[k] = acc;
    }
    block_sync<COUNT>();
}

// x -= sum_l u_l Y_l with u = W (B^T x - Sigma^1/2 n), one warp per row over
// the columns that Y's boxes span: wv holds this warp's n, the sweep's
// low-rank normals (read only with `noise`: else n = 0), and receives its
// copy of u.  With `residual` it then receives t = u + Sigma^-1/2 n = Sigma^-1
// B^T x of the corrected x, the descend's residual term.  In an LR kernel
// s_btx holds B^T x - Sigma^1/2 n already (btx_pass) and n lies past u in the
// slot (normals_of).  Ends with a barrier.
template <bool COUNT, bool LR = false>
__device__ void woodbury_pass(const VisitParams& P, const LevelTables& T, const float* s_btx,
                              bool noise, bool residual, float* wv, float* x) {
    const int lane = threadIdx.x & 31;
    float nk = 0.0f, sk = 1.0f, u = 0.0f;
    if constexpr (LR) {
        warp_matvec(T.wm, s_btx, P.m, wv);
    } else {
        if (lane < P.m) {
            sk = T.sroot[lane];
            if (noise) nk = wv[lane];
        }
        __syncwarp();
        if (lane < P.m) wv[lane] = s_btx[lane] - sk * nk;
        __syncwarp();
        if (lane < P.m)
            for (int k = 0; k < P.m; ++k) u += T.wm[lane * P.m + k] * wv[k];
        __syncwarp();
        if (lane < P.m) wv[lane] = u;
        __syncwarp();
    }
    WARP_ROWS(i, P.H) {
        int lo, hi;
        row_span(T.ybox, T.yspan, P.m, i, lo, hi);
        for (int j = lo + lane; j < hi; j += 32) {
            const int p = i * P.W + j;
            x[p] = add_columns(T.ybox, P.m, T.yval, T.yoff, wv, -1.0f, i, j, x[p], ROW_NY(P));
        }
    }
    if (residual) {
        __syncwarp();
        if constexpr (LR) {
            const float* nv = wv + P.m;
            for (int k = lane; k < P.m; k += 32)
                wv[k] = wv[k] + (noise ? nv[k] : 0.0f) / T.sroot[k];
        } else if (lane < P.m) {
            wv[lane] = u + nk / sk;
        }
        __syncwarp();
    }
    block_sync<COUNT>();
}

// ------------------------------------------------------------------ residual
// r = f - A x - sum_k t_k B_k into scr (wv: this warp's t), one warp per row,
// U points of a row per lane at a time, their loads first.  No barrier.
template <int KMAX, bool BOX, int U, bool PLANES, int REACH = 1>
__device__ __forceinline__ void residual_rows(const VisitParams& P, const LevelTables& T,
                                              const float* __restrict__ coeffs, const float* wv,
                                              const float* __restrict__ f,
                                              const float* __restrict__ x,
                                              float* __restrict__ scr) {
    const Stencil<KMAX, BOX, REACH> st = stencil_regs<KMAX, BOX, REACH>(P);
    const int lane = threadIdx.x & 31, H = P.H, W = P.W, n = H * W;
    WARP_ROWS(i, H) {
        int lo = 0, hi = 0;
        if (P.m) row_span(T.bbox, T.bspan, P.m, i, lo, hi);
#if VISIT_DIM == 3
        const int z = i / P.Y;
        const unsigned rin = row_terms3(st, P, z, i - z * P.Y);
#else
        const unsigned rin = row_terms(st, i, H);
#endif
        for (int j0 = lane; j0 < W; j0 += 32 * U) {
            int p[U];
            unsigned in[U];
            float fv[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int j = j0 + 32 * u;
                p[u] = i * W + (j < W ? j : 0);
                in[u] = point_terms(st, rin, j, W);
                fv[u] = j < W ? f[p[u]] : 0.0f;
            }
            Operands<KMAX, U, PLANES> op;
            load_operands<KMAX, BOX, U, PLANES>(st, coeffs, x, n, p, in, op);
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int j = j0 + 32 * u;
                if (j >= W) break;
                float r = fv[u] - apply_operands<KMAX, BOX, U, PLANES>(st, op, in[u], u);
                if (j >= lo && j < hi)
                    r = add_columns(T.bbox, P.m, T.bval, T.boff, wv, -1.0f, i, j, r, ROW_NY(P));
                scr[p[u]] = r;
            }
        }
    }
}

// Points per lane in flight in the residual, whose owner also adds the
// low-rank term: as LANE_POINTS, fewer for the 9-offset forms, where that
// spills.
#define RESIDUAL_POINTS(KMAX, PLANES) ((KMAX) == 5 ? ((PLANES) ? 2 : 4) : 1)

// Ends with a barrier.
template <int FORM, bool COUNT>
__device__ void residual_pass(const VisitParams& P, const LevelTables& T,
                              const float* __restrict__ coeffs, const float* wv,
                              const float* __restrict__ f, const float* __restrict__ x,
                              float* __restrict__ scr) {
#define RESIDUAL(KMAX, BOX, PLANES) \
    residual_rows<KMAX, BOX, RESIDUAL_POINTS(KMAX, PLANES), PLANES>(P, T, coeffs, wv, f, x, scr)
#if VISIT_DIM == 3
    residual_rows<DIM3_KMAX(FORM), DIM3_BOX(FORM), DIM3_POINTS(FORM), DIM3_PLANES(FORM)>(
        P, T, coeffs, wv, f, x, scr);
#else
    if constexpr (FORM >= WIDE_FORM0) {
        residual_rows<WIDE_KMAX(FORM), WIDE_BOX(FORM), 1, WIDE_PLANES(FORM), 2>(P, T, coeffs, wv,
                                                                                f, x, scr);
    } else {
        STENCIL_DISPATCH(FORM, P, RESIDUAL);
    }
#endif
#undef RESIDUAL
    block_sync<COUNT>();
}

// f_c[I, J] = sum_{a, b} w_a w_b r[2I+1+a, 2J+1+b], w = {0.5, 1, 0.5}, one
// warp per coarse row, U coarse points per lane at a time, their loads first.
template <int U>
__device__ __forceinline__ void restrict_rows(const VisitParams& P, const float* __restrict__ r,
                                              float* __restrict__ fc) {
    const int lane = threadIdx.x & 31, H = P.H, W = P.W, Wc = P.Wc;
    WARP_ROWS(I, P.Hc) {
        for (int J0 = lane; J0 < Wc; J0 += 32 * U) {
            float v[U][3][3];
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int a = 0; a < 3; ++a)
#pragma unroll
                    for (int b = 0; b < 3; ++b) {
                        const int i = 2 * I + a, j = 2 * (J0 + 32 * u) + b;
                        v[u][a][b] = (J0 + 32 * u < Wc && i < H && j < W) ? r[i * W + j] : 0.0f;
                    }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int J = J0 + 32 * u;
                if (J >= Wc) break;
                float acc = 0.0f;
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                    if (2 * I + a >= H) continue;
                    float row = 0.0f;
#pragma unroll
                    for (int b = 0; b < 3; ++b) {
                        if (2 * J + b >= W) continue;
                        row += (b == 1 ? 1.0f : 0.5f) * v[u][a][b];
                    }
                    acc += (a == 1 ? 1.0f : 0.5f) * row;
                }
                fc[I * Wc + J] = acc;
            }
        }
    }
}

#if VISIT_DIM == 3
// f_c[Kz, I, J] = sum_{c, a, b} w_c w_a w_b r[2Kz+c, 2I+a, 2J+b], w = {0.5, 1,
// 0.5}, one warp per coarse row (Kz, I), one coarse point per lane at a time,
// its 27 loads first.
__device__ __forceinline__ void restrict_rows3(const VisitParams& P, const float* __restrict__ r,
                                               float* __restrict__ fc) {
    const int lane = threadIdx.x & 31, W = P.W, Wc = P.Wc;
    WARP_ROWS(R, P.Hc) {
        const int Kz = R / P.Yc, I = R - Kz * P.Yc;
        for (int J = lane; J < Wc; J += 32) {
            float v[3][3][3];
#pragma unroll
            for (int c = 0; c < 3; ++c)
#pragma unroll
                for (int a = 0; a < 3; ++a)
#pragma unroll
                    for (int b = 0; b < 3; ++b) {
                        const int z = 2 * Kz + c, i = 2 * I + a, j = 2 * J + b;
                        const bool in = z < P.Z && i < P.Y && j < W;
                        v[c][a][b] = in ? r[(z * P.Y + i) * W + j] : 0.0f;
                    }
            float acc = 0.0f;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                float plane = 0.0f;
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                    float row = 0.0f;
#pragma unroll
                    for (int b = 0; b < 3; ++b) row += (b == 1 ? 1.0f : 0.5f) * v[c][a][b];
                    plane += (a == 1 ? 1.0f : 0.5f) * row;
                }
                acc += (c == 1 ? 1.0f : 0.5f) * plane;
            }
            fc[R * Wc + J] = acc;
        }
    }
}

// x += gamma P x_c, one warp per fine row (z, y), one point per lane at a
// time: along each axis an odd fine index 2I + 1 takes coarse I with weight 1,
// an even one 2I its coarse neighbours I - 1 and I with 0.5 each (a coarse
// index outside the coarse field adds nothing).  No barrier.
__device__ __forceinline__ void prolong_rows3(const VisitParams& P, float* __restrict__ x,
                                              const float* __restrict__ xc) {
    const int lane = threadIdx.x & 31, W = P.W, Wc = P.Wc;
    WARP_ROWS(i, P.H) {
        const int z = i / P.Y, y = i - z * P.Y;
        const int nz = 2 - (z & 1), nyc = 2 - (y & 1);
        const int z0 = (z >> 1) - (nz - 1), y0 = (y >> 1) - (nyc - 1);
        const float wz = (z & 1) ? 1.0f : 0.5f, wy = (y & 1) ? 1.0f : 0.5f;
        for (int j = lane; j < W; j += 32) {
            const int nj = 2 - (j & 1), j0 = (j >> 1) - (nj - 1);
            const float wj = (j & 1) ? 1.0f : 0.5f;
            float px = 0.0f;
            for (int a = 0; a < nz; ++a) {
                const int Zc = z0 + a;
                if (Zc < 0 || Zc >= P.Zc) continue;
                float plane = 0.0f;
                for (int b = 0; b < nyc; ++b) {
                    const int Yc = y0 + b;
                    if (Yc < 0 || Yc >= P.Yc) continue;
                    float row = 0.0f;
                    for (int c = 0; c < nj; ++c) {
                        const int Jc = j0 + c;
                        if (Jc >= 0 && Jc < Wc) row += wj * xc[(Zc * P.Yc + Yc) * Wc + Jc];
                    }
                    plane += wy * row;
                }
                px += wz * plane;
            }
            x[i * W + j] += P.gamma * px;
        }
    }
}
#endif

// Two coarse points per lane where a coarse row has more than two warps'
// width of points, one otherwise (3d: restrict_rows3).  Ends with a barrier.
template <bool COUNT>
__device__ void restrict_pass(const VisitParams& P, const float* __restrict__ r,
                              float* __restrict__ fc) {
#if VISIT_DIM == 3
    restrict_rows3(P, r, fc);
#else
    if (P.Wc > 64)
        restrict_rows<2>(P, r, fc);
    else
        restrict_rows<1>(P, r, fc);
#endif
    block_sync<COUNT>();
}

// --------------------------------------------------------------- whole visits
// One descend visit of one chain: x, f, scr and fc are this chain's fields
// (f_c the coarse rhs it writes), tables(d) the level's tables in the pre
// direction d < ndir (one: SOR; two: SSOR, forward then backward), NDIR the
// count compiled in (one direction compiles to the straight-line passes, two
// to a loop that is not unrolled: unrolled, the two-sweep reach-2 visits took
// 1.3-1.5x as long) or 0 for the count ndir at run time, wv this
// warp's slot (holding the first direction's low-rank normals where noise is
// on, normals_of; those of direction d >= 1 at nlr + (d - 1) m), s_btx the
// block's m floats.  LR: compiled for more than LANE_SLOTS measurements.
// `zero` sets x = 0 first; `sync_first` places the first barrier even where
// there is no rhs pass.  Noise: mode 0 off, 1 the generator under (seed,
// counter + d) for direction d, 2 the field normals read from xi + d xi_step;
// xi_rec, where set, receives those used (one direction); stage: this warp's
// staging buffer of the rhs pass, or null.  The residual and the restriction
// follow the last direction.  Ends with a barrier.  FORM: the stencil's form
// (see STENCIL_DISPATCH).
//
// POINTS (the subtree kernel's reach-2 build, one direction): the sweep from
// the colours' point lists *pts (sweep_points).
template <int FORM, bool COUNT, int NDIR, class Tables, bool POINTS = false, bool LR = false>
__device__ void level_descend(const VisitParams& P, const Tables& tables, int ndir, int chain,
                              int noise_mode, unsigned long long seed,
                              unsigned long long counter, bool zero, bool sync_first, float* x,
                              const float* f, float* scr, float* fc,
                              const float* __restrict__ coeffs, const float* __restrict__ ns,
                              const float* __restrict__ xi, size_t xi_step,
                              const float* __restrict__ nlr, float* xi_rec, float* wv,
                              float* s_btx, float* stage, const PointTables* pts = nullptr) {
    const int nd = NDIR > 0 ? NDIR : ndir;
#pragma unroll 1
    for (int d = 0; d < nd; ++d) {
        const LevelTables T = tables(d);
        const float* c = f;
        if (d > 0 || noise_mode || zero || sync_first) {
            if (d > 0) next_normals<LR>(P, noise_mode, nlr + (size_t)(d - 1) * P.m, wv);
            if (noise_mode || (zero && d == 0))
                rhs_pass(P, chain, noise_mode, seed, counter + d, f, ns,
                         xi ? xi + d * xi_step : nullptr, xi_rec, scr, x, nullptr,
                         zero && d == 0, stage);
            block_sync<COUNT>();
            if (noise_mode) c = scr;
        }
        if constexpr (POINTS)
            level_sweep_points<FORM, COUNT>(P, *pts, coeffs, c, x);
        else
            level_sweep<FORM, COUNT>(P, T, coeffs, c, x);
        if (P.m) {
            btx_pass<COUNT, LR>(P, T, x, s_btx, wv, noise_mode != 0);
            woodbury_pass<COUNT, LR>(P, T, s_btx, noise_mode != 0, d == nd - 1, wv, x);
        }
    }
    residual_pass<FORM, COUNT>(P, tables(nd - 1), coeffs, wv, f, x, scr);
    restrict_pass<COUNT>(P, scr, fc);
}

// One ascend visit of one chain; tables(d) in the post direction d, xc the coarse
// state, the rest as level_descend (3d: the prolongation in a loop of its own
// before the first rhs, in the same pass: the two write different fields).
// Ends with a barrier.
template <int FORM, bool COUNT, int NDIR, class Tables, bool POINTS = false, bool LR = false>
__device__ void level_ascend(const VisitParams& P, const Tables& tables, int ndir, int chain,
                             int noise_mode, unsigned long long seed,
                             unsigned long long counter, float* x, const float* f, float* scr,
                             const float* xc, const float* __restrict__ coeffs,
                             const float* __restrict__ ns, const float* __restrict__ xi,
                             size_t xi_step, const float* __restrict__ nlr, float* xi_rec,
                             float* wv, float* s_btx, float* stage,
                             const PointTables* pts = nullptr) {
    const int nd = NDIR > 0 ? NDIR : ndir;
#pragma unroll 1
    for (int d = 0; d < nd; ++d) {
        const LevelTables T = tables(d);
        const float* xid = xi ? xi + d * xi_step : nullptr;
        if (d > 0) next_normals<LR>(P, noise_mode, nlr + (size_t)(d - 1) * P.m, wv);
#if VISIT_DIM == 3
        if (d == 0) prolong_rows3(P, x, xc);
        if (noise_mode)
            rhs_pass(P, chain, noise_mode, seed, counter + d, f, ns, xid, xi_rec, scr, x,
                     nullptr, false, stage);
#else
        if (d == 0 || noise_mode)
            rhs_pass(P, chain, noise_mode, seed, counter + d, f, ns, xid, xi_rec, scr, x,
                     d == 0 ? xc : nullptr, false, stage);
#endif
        block_sync<COUNT>();
        if constexpr (POINTS)
            level_sweep_points<FORM, COUNT>(P, *pts, coeffs, noise_mode ? scr : f, x);
        else
            level_sweep<FORM, COUNT>(P, T, coeffs, noise_mode ? scr : f, x);
        if (P.m) {
            btx_pass<COUNT, LR>(P, T, x, s_btx, wv, noise_mode != 0);
            woodbury_pass<COUNT, LR>(P, T, s_btx, noise_mode != 0, false, wv, x);
        }
    }
}
