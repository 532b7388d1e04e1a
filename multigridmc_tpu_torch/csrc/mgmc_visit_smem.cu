// Fused MGMC level-visit kernels for 2d levels, NVIDIA Hopper (sm_90a),
// float32: each chain's field in shared memory, in one block where it fits
// and split in bands over a thread-block cluster where it does not (the
// "smem" route).
//
// Replace, for the squared shifted-Laplace prior's 13-point levels and the 5x5
// box of its Galerkin levels, and for the reach-1 levels of two sweeps a visit
// (SSOR: the FD prior's 5-point level, the 3x3 box of its Galerkin levels),
// the Pallas kernels descend_visit and ascend_visit of
// multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py, and compute what
// level_descend / level_ascend of level_passes.cuh compute (the phase
// kernels' reach-2 build, mgmc_visit.cu -DVISIT_REACH=2, and their reach-1
// build), from the same parameter block (VisitParams of 25 offsets and 9
// colours, one per sweep direction; the host widens a reach-1 level's block
// of 9 offsets and 8 colours to it) and the same noise modes (0 off, 1
// in-kernel Philox, 2 xi read from memory), with one directed sweep (SOR) or
// two, forward then backward (SSOR):
//
//   descend:  c   = f + sqrt(D(2-w)/w) xi_d                       (Gibbs rhs)
//             x  <- colour-ordered SOR sweep(c, x)
//             x  <- x - sum_l u_l Y_l,  u = W (B^T x - Sigma^1/2 n_d)   (Woodbury)
//             r   = f - A_stencil x - sum_k t_k B_k,  t = u + Sigma^-1/2 n_d
//             f_c = R r                          (full weighting; after the last d)
//   ascend:   x  <- x + gamma P x_c,  then per direction c, sweep, Woodbury
//
// Why.  The phase kernels run these levels one block per chain over fields in
// device memory: one point per lane with 25 operands and coefficients in
// registers (the forms spill), every term tested against the field's edge
// two deep, every colour pass and the residual reading x again from L1/L2,
// and at 9 colours a warp per row leaves 18 of 32 lanes idle.  At reach 1 a
// two-sweep visit of 256 chains of 255^2 holds 67 MB of x alone, more than
// the 50 MB L2, so each of its four colour passes and the residual read x
// back from HBM (they took 62% of the phase descend); the stream kernels
// cannot take two sweeps, because the Woodbury patch between them needs the
// whole chain's B^T x.  Here:
//
// * Residency.  A cluster of S blocks holds one chain (S = 1 where the chain
//   fits one block: the 127^2 level).  Block k holds its band of rows
//   (band_of, as the split kernels cut them) in dynamic shared memory with
//   two zero columns a side and two rows a side (a reach-1 stencil reads one
//   of them), zero on the field's top and bottom edge; x is copied in once
//   with cp.async (4 bytes a thread: rows of
//   255 or 127 floats start only 4-byte aligned, below the 16-byte alignment
//   a TMA tensor map asks of its row stride, so no TMA) and written back once,
//   coalesced.  The rhs c (and the descend's residual r) sits beside it in
//   shared memory where the host says it fits (c_shared), else in the chain's
//   scratch field in device memory, read once per point and sweep.
// * Across a cut.  The two rows beyond a band are read from the neighbouring
//   rank's shared memory (cluster.map_shared_rank); a cluster barrier stands
//   between colours; no halo is copied.
// * Colours.  Each thread takes its points from a table the host builds once
//   per (shape, order, band) (mgmc_visit_smem.py::visit_tables): colour after
//   colour, first the points whose every coefficient equals the level's
//   interior value and whose stencil stays in the band (their coefficients
//   are the scalars cval, their neighbours at the padded offsets soff), then
//   the edge points (the coefficient planes that vary read from device
//   memory, a row beyond a cut from the neighbour), each part dealt round the
//   32 banks.  Every lane is busy at any number of colours (9 at reach 2, 2
//   or 4 at reach 1).  The terms are added in offset order, as stencil_at
//   adds them; a neighbour in the zero halo adds +-0, so the two routes agree
//   to float32 rounding.
// * Low-rank and coarse terms.  The rhs takes the Philox numbering of
//   rhs_pass (group i ceil(W / 4) + g, chain, launch counter; direction d the
//   counter + d), so all routes agree under one stream.  B^T x is summed per
//   band, and every warp sums the bands' partial vectors in rank order, then
//   forms u = W (B^T x - Sigma^1/2 n) itself, so every block holds the same u
//   bit for bit without atomics; the Woodbury patch runs over the block's
//   band, each point by one owner in column order; the low-rank noise enters
//   the correction (level_passes.cuh).  The residual reads x from shared
//   memory; the restriction's coarse row I belongs to the block that owns
//   fine row 2I + 1, whose rows 2I and 2I + 2 may lie in the neighbours'
//   bands.  Up to LANE_SLOTS (32) measurements the band's share and each
//   warp's slot are static arrays, one entry a lane, and the boxes lie in the
//   parameter block.  A level of more takes the kernels compiled with LR:
//   the share and the slots after the band (and its rows of c) in dynamic
//   shared memory, lowrank_scratch_floats of visit_phases.cuh (per warp v,
//   then u and t), each lane holding entries lane, lane + 32, ..., u = W v a
//   row at a time (warp_matvec), the boxes from the level's device tables -
//   bytes the band loses, so the host's rule (mgmc_visit_smem.py::candidates)
//   counts them before it takes the route.
//
// Barriers (smem_sync; the stamps build counts and stamps each): an ascend's
// copy-in (after its first rhs, which is drawn while the copy lands: the
// prolongation that follows reads x; a descend's copy lands behind its first
// rhs barrier), per direction the rhs, each colour and (m > 0) the bands'
// shares of B^T x, then a descend 3 (the corrected x, the residual, the end)
// and an ascend 1 (the corrected x): mgmc_visit_smem.py::barrier_count.
// Between blocks of a cluster each is a cluster barrier (the copy-in's is the
// block's).
//
// Bound: by bytes, per chain x read and written, f (unless shared), f_c
// written or x_c read: 0.045 ms at 256 chains of 255^2 on an H100 (a 13-point
// visit of one sweep); by operations at reach 1 with two sweeps, the Philox
// normals of both sweeps (0.052 ms a descend at 256 chains of 255^2); the
// planes, B, Y and the tables stay in the L2 for all chains.
//
// SMEM_VISIT_STAMPS_BUILD: the measurement build, a library of its own, taken
// only where the host passes a stamps tensor, (C S, SMEM_STAMP_WIDTH) int64,
// per block (block_stamps.cuh): the timer at entry and after each barrier, at
// exit, the barriers passed, the SM.

#define MAX_OFFSETS 25
#define MAX_COLORS 9

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_stamps.cuh"
#include "visit_phases.cuh"

namespace cg = cooperative_groups;

#define SMEM_MAX_CLUSTER 16
// the sweep directions a launch may hold: one (SOR) or two (SSOR)
#define MAX_DIRS 2
// the block bound: 64 registers a thread, so that two blocks of 512 share an SM
#define SMEM_VISIT_MAX_THREADS 1024
// the zero halo: the stencil's reach
#define SMEM_HALO 2
// interior points a thread carries at once in the colours and the residual:
// as many FMA chains in flight (each point's sum is a chain in offset order)
#define SMEM_POINTS 4
// per (direction, rank) of the table's head: the n_order + 1 starts of the
// colours' entries, then the interior points of each colour
#define SMEM_HEAD_INTS (2 * MAX_COLORS + 1)
// the timer at entry, after the copy-in, after up to MAX_COLORS + 2 barriers
// of each direction and the descend's 3, at exit, the barriers passed, the SM
#define SMEM_STAMP_WIDTH (1 + 1 + MAX_DIRS * (MAX_COLORS + 2) + 3 + 3)

#ifndef SMEM_VISIT_STAMPS_BUILD
#define SMEM_VISIT_STAMPS_BUILD 0
#endif

// A launch's parameter blocks, one per sweep direction, and the layout of a
// band in shared memory.
struct SmemVisitParams {
    VisitParams v[MAX_DIRS];
    int ndir;
    int S;         // blocks a chain (the cluster's size)
    int PX;        // a padded row: W + 2 SMEM_HALO
    int nb_max;    // rows of the widest band
    int c_shared;  // 1: c and r in shared memory, else in the scratch field
    int margin;    // a point at least this far from the field's edge has interior coefficients
    int soff[MAX_OFFSETS];    // offset k in the padded band: dy PX + dx (0 from K on)
    float cval[MAX_OFFSETS];  // the interior coefficients (0 from K on)
    unsigned planes;          // bit k: coefficient k varies (the edge points read its plane)
};

extern __shared__ __align__(16) float smem_band[];

// first row and number of rows of rank k of S over H rows: the first H % S
// ranks take one more (mgmc_visit_split.cu cuts its bands so)
__device__ __forceinline__ void band_of(int H, int S, int k, int* u0, int* nb) {
    const int base = H / S, rem = H % S;
    *nb = base + (k < rem ? 1 : 0);
    *u0 = k * base + (k < rem ? k : rem);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// (A_stencil x) at an edge point (band row lr, column j, field index p): the
// planes that vary read from device memory, a row beyond a cut from the
// neighbour's band (xlo: rank - 1, lo_nb rows; xhi: rank + 1), the terms in
// offset order (a neighbour in the zero halo adds +-0).  All KMAX terms: the
// host pads a stencil of fewer offsets with zero coefficients at the centre
// (each adds +-0), so that no branch keeps a load behind the FMA chain.
template <int KMAX>
__device__ __forceinline__ float edge_ax(const SmemVisitParams& SP, const VisitParams& P,
                                         const float* __restrict__ coeffs, const float* xs,
                                         const float* xlo, const float* xhi, int rank, int nb,
                                         int lo_nb, int lr, int j, int p, int n) {
    const int PX = SP.PX;
    // every operand and coefficient first (a neighbour's row may lie in another
    // block's shared memory, a plane in the L2: their round trips overlap),
    // then the chain of FMAs
    float v[KMAX], a[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
        const int r = lr + P.dy[k];
        const float* row = (r < 0 && rank > 0) ? xlo + (r + lo_nb + SMEM_HALO) * PX
                           : (r >= nb && rank + 1 < SP.S) ? xhi + (r - nb + SMEM_HALO) * PX
                                                           : xs + (r + SMEM_HALO) * PX;
        v[k] = row[j + SMEM_HALO + P.dx[k]];
        const float* ak = ((SP.planes >> k) & 1u) ? coeffs + (size_t)k * n + p : &SP.cval[k];
        a[k] = *ak;
    }
    float ax = 0.0f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) ax += a[k] * v[k];
    return ax;
}

// r - sum_k t_k B_k[p] over the columns whose box holds (i, j), in column
// order (residual_rows' add_columns); wv: this warp's t
template <bool LR>
__device__ __forceinline__ float lowrank_term(const VisitParams& P, const int (*bt)[BOX_INTS],
                                              const float* __restrict__ B, const float* wv, int m,
                                              int i, int j, int p, int n, float r) {
    for (int k = 0; k < m; ++k)
        if (BOX_OF(LR, bt, P.bbox, k)[0] <= i && i < BOX_OF(LR, bt, P.bbox, k)[1] &&
            BOX_OF(LR, bt, P.bbox, k)[2] <= j && j < BOX_OF(LR, bt, P.bbox, k)[3])
            r += -1.0f * wv[k] * B[(size_t)k * n + p];
    return r;
}

// One point group of the rhs (rhs_pass): group g of band row lr, its four
// points' f, noise scale and (noise mode 2) xi loaded first, so that they are
// in flight during the draw; then the ascend's first direction adds gamma P
// x_c to x (shared memory) and c = f + ns xi goes to the band's place of c.
// One point group of the rhs (rhs_pass): its four points' f, noise scale and
// (noise mode 2) xi are loaded first, so that they are in flight during the
// draw; then c = f + ns xi goes to c's place (c[q] for point q of the group).
struct RhsGroup {
    float fv[4], sv[4], z[4];

    __device__ __forceinline__ void load(const VisitParams& P, int p0, int j0,
                                         const float* __restrict__ f,
                                         const float* __restrict__ ns, const float* xi) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const bool live = j0 + q < P.W;
            fv[q] = live ? f[p0 + q] : 0.0f;
            sv[q] = live && !P.ns_const ? ns[p0 + q] : P.ns_val;
            z[q] = live && P.noise_mode == 2 ? xi[p0 + q] : 0.0f;
        }
    }

    __device__ __forceinline__ void store(const VisitParams& P, int g, float* c) const {
#pragma unroll
        for (int q = 0; q < 4; ++q)
            if (4 * g + q < P.W) c[q] = fv[q] + sv[q] * z[q];
    }
};

// x += gamma (P x_c) on point group g of row i (xrow: the row's first point in
// shared memory).  (P x_c)[i, j]: an odd fine index 2I+1 takes coarse I with
// weight 1, an even one its two coarse neighbours with 0.5 each; the group
// reads coarse rows Ia, Ia + 1 (odd i: Ia) and columns 2g - 1 + t, t = 0, 1,
// 2, once (rhs_pass: a value outside the coarse field is 0 and adds +0).
__device__ __forceinline__ void prolongate_group(const VisitParams& P, int i, int g, float* xrow,
                                                 const float* __restrict__ xc) {
    const int nI = (i & 1) ? 1 : 2, Ia = (i >> 1) - (nI - 1);
    const float wi = (i & 1) ? 1.0f : 0.5f;
    float cv[2][3];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int t3 = 0; t3 < 3; ++t3) {
            const int I = Ia + a, J = 2 * g - 1 + t3;
            cv[a][t3] = (a < nI && I >= 0 && I < P.Hc && J >= 0 && J < P.Wc)
                            ? xc[I * P.Wc + J] : 0.0f;
        }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int j = 4 * g + q;
        if (j >= P.W) break;
        // j = 4g + q: an even q reads columns t0, t0 + 1 (weight 0.5 each), an
        // odd q column t0 (weight 1); t0 = 0, 1, 1, 2
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
        xrow[j] = xrow[j] + P.gamma * px;
    }
}

// ------------------------------------------------------------------- kernel
// KMAX: the stencil's size, 5 (reach-1 forms 0 / 1), 9 (the 3x3 box and any
// other reach-1 stencil, forms 2-5), 13 (forms 6 / 7) or 25 (the 5x5 box, 8 /
// 9); a kernel each.  The sweep count (1 or 2) is read at run time.
template <int KMAX, bool DESCEND, bool STAMPS, bool LR = false>
__global__ void __launch_bounds__(SMEM_VISIT_MAX_THREADS)
smem_visit_kernel(const __grid_constant__ SmemVisitParams SP, const int* __restrict__ tables,
                  float* x_all, const float* __restrict__ f_all, float* scr_all, float* fc_all,
                  const float* __restrict__ xc_all, const float* __restrict__ coeffs,
                  const float* __restrict__ ns, const float* __restrict__ B,
                  const float* __restrict__ Y0, const float* __restrict__ W0,
                  const float* __restrict__ Y1, const float* __restrict__ W1,
                  const float* __restrict__ xilr, const float* __restrict__ sroot,
                  const float* __restrict__ xi_all, unsigned long long* stamps,
                  const int* __restrict__ boxes0, const int* __restrict__ boxes1) {
    __shared__ float s_part[LANE_SLOTS];              // this band's share of B^T x
    __shared__ float s_wv[32 * LANE_SLOTS];           // per warp: u, then t
    cg::cluster_group cluster = cg::this_cluster();
    const VisitParams& P = SP.v[0];  // what the directions share
    const int S = SP.S, PX = SP.PX;
    const int rank = S > 1 ? (int)cluster.block_rank() : 0;
    const int chain = blockIdx.x / S;
    const int H = P.H, W = P.W, n = H * W, m = P.m;
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5;
    unsigned long long* srow = STAMPS ? stamps + (size_t)blockIdx.x * SMEM_STAMP_WIDTH : nullptr;
    stamps_open<STAMPS>(srow);

    int u0, nb, lo0, lo_nb;
    band_of(H, S, rank, &u0, &nb);
    band_of(H, S, rank > 0 ? rank - 1 : 0, &lo0, &lo_nb);
    const int u1 = u0 + nb, first = u0 * W;
    float* xs = smem_band;                               // band row r at padded row r + 2
    float* cs = xs + (SP.nb_max + 2 * SMEM_HALO) * PX;  // c, then r (c_shared), W a row
    const bool csh = SP.c_shared != 0;
    float* x = x_all + (size_t)chain * n;
    const float* f = f_all + (P.f_batched ? (size_t)chain * n : 0);
    float* scr = scr_all + (size_t)chain * n;  // c, then r, where not in shared memory
    const float* nlr = P.noise_mode ? xilr + (size_t)chain * SP.ndir * m : nullptr;
    const float* xlo = S > 1 ? cluster.map_shared_rank(xs, rank > 0 ? rank - 1 : rank) : xs;
    const float* xhi = S > 1 ? cluster.map_shared_rank(xs, rank + 1 < S ? rank + 1 : rank) : xs;
    // the low-rank scratch (LR: after the band and c's rows: the band's share,
    // then per warp 2 m floats) and the boxes (LR: the device tables, B's then
    // each direction's Y's)
    float* lrs = cs + (csh ? SP.nb_max * W : 0);
    float* spart = LR ? lrs : s_part;
    float* wv = LR ? lrs + m + (size_t)warp * 2 * m : s_wv + warp * LANE_SLOTS;
    const int(*bbx)[BOX_INTS] = reinterpret_cast<const int(*)[BOX_INTS]>(boxes0);

    // 1. the band of x into its padded rows, the halo zeroed; f's band into c
    //    where c is in shared memory and no noise is drawn
    WARP_ROWS(r, nb + 2 * SMEM_HALO) {
        const int lr = r - SMEM_HALO;
        const bool live = lr >= 0 && lr < nb;
        for (int jq = lane; jq < PX; jq += 32) {
            const int j = jq - SMEM_HALO;
            if (live && j >= 0 && j < W)
                cp_async4(xs + r * PX + jq, x + first + lr * W + j);
            else
                xs[r * PX + jq] = 0.0f;
        }
    }
    if (csh && !P.noise_mode)
        for (int t = tid; t < nb * W; t += nthreads) cp_async4(cs + t, f + first + t);

    const int G4 = (W + 3) >> 2;
#pragma unroll 1
    for (int d = 0; d < SP.ndir; ++d) {
        const VisitParams& Pd = SP.v[d];
        const int(*ybx)[BOX_INTS] =
            reinterpret_cast<const int(*)[BOX_INTS]>(d ? boxes1 : boxes0) + m;
        // 2. the rhs (rhs_pass): c = f + ns xi; the block's threads take the
        //    band's point groups (group g of band row lr) the block's size
        //    apart, stepped with a carry (no division in the loop)
        const int dl = nthreads / G4, dg = nthreads - dl * G4;
        if (P.noise_mode) {
            const float* xi = P.noise_mode == 2 ? xi_all + ((size_t)d * P.C + chain) * n : nullptr;
            for (int lr = tid / G4, g = tid % G4; lr < nb; lr += dl, g += dg) {
                if (g >= G4) {
                    g -= G4;
                    if (++lr >= nb) break;
                }
                const int i = u0 + lr, p0 = i * W + 4 * g;
                RhsGroup a;
                a.load(P, p0, 4 * g, f, ns, xi);
                if (P.noise_mode == 1)
                    philox_normals4((uint32_t)(i * G4 + g), (uint32_t)chain, Pd.seed, Pd.counter,
                                    a.z);
                a.store(P, g, csh ? cs + (p0 - first) : scr + p0);
            }
        }
        if (d == 0) {
            cp_async_wait_all();  // the band's copy, landed while the rhs was drawn
            if (!DESCEND) {
                // the ascend's x += gamma P x_c, which reads the copy: every
                // thread's copy first
                smem_sync<STAMPS>(cluster, S, true);
                const float* xc = xc_all + (size_t)chain * P.Hc * P.Wc;
                for (int lr = tid / G4, g = tid % G4; lr < nb; lr += dl, g += dg) {
                    if (g >= G4) {
                        g -= G4;
                        if (++lr >= nb) break;
                    }
                    prolongate_group(P, u0 + lr, g, xs + (lr + SMEM_HALO) * PX + SMEM_HALO, xc);
                }
            }
        }
        // every band formed (and corrected by the previous direction) before
        // any block reads a neighbour's rows
        smem_sync<STAMPS>(cluster, S);

        // 3. the colour phases on the band, from the table of (direction, rank)
        const int* head = tables + (size_t)(d * S + rank) * SMEM_HEAD_INTS;
        const float* cg_ = P.noise_mode ? scr : f;  // c in device memory
        const float omega = P.omega;
        const float dval = SP.cval[P.diag_index];
        for (int o = 0; o < P.n_order; ++o) {
            const int e0 = __ldg(head + o), count = __ldg(head + o + 1) - e0;
            const int plain = __ldg(head + MAX_COLORS + 1 + o);
            //    the interior points, SMEM_POINTS a thread at once: their entries
            //    and c first, then as many FMA chains side by side (each in
            //    offset order)
            for (int t = tid; t < plain; t += SMEM_POINTS * nthreads) {
                int q[SMEM_POINTS];
                float cv[SMEM_POINTS], ax[SMEM_POINTS];
#pragma unroll
                for (int u = 0; u < SMEM_POINTS; ++u) {
                    const int tu = t + u * nthreads;
                    const unsigned e = (unsigned)__ldg(tables + e0 + (tu < plain ? tu : t));
                    q[u] = (int)(e >> 16);
                    const int p = (int)(e & 0xffffu);
                    cv[u] = csh ? cs[p - first] : cg_[p];
                    ax[u] = 0.0f;
                }
#pragma unroll
                for (int k = 0; k < KMAX; ++k)
#pragma unroll
                    for (int u = 0; u < SMEM_POINTS; ++u)
                        ax[u] += SP.cval[k] * xs[q[u] + SP.soff[k]];
#pragma unroll
                for (int u = 0; u < SMEM_POINTS; ++u)
                    if (t + u * nthreads < plain)
                        xs[q[u]] = xs[q[u]] + omega * (cv[u] - ax[u]) / dval;
            }
            //    the edge points, one a thread at once
            for (int t = plain + tid; t < count; t += nthreads) {
                const unsigned e = (unsigned)__ldg(tables + e0 + t);
                const int q = (int)(e >> 16), p = (int)(e & 0xffffu);
                const float cv = csh ? cs[p - first] : cg_[p];
                const int i = p / W, j = p - i * W;
                const float ax =
                    edge_ax<KMAX>(SP, P, coeffs, xs, xlo, xhi, rank, nb, lo_nb, i - u0, j, p, n);
                const float dv = ((SP.planes >> P.diag_index) & 1u)
                                     ? __ldg(coeffs + (size_t)P.diag_index * n + p)
                                     : dval;
                xs[q] = xs[q] + omega * (cv - ax) / dv;
            }
            smem_sync<STAMPS>(cluster, S);  // the colour done on every band
        }

        // 4. Woodbury: this band's share of B^T x, one warp per column (lanes
        //    along its box, a fixed shuffle tree)
        if (m) {
            const int nwarps = nthreads >> 5;
            for (int k = warp; k < m; k += nwarps) {
                const int i0 = max(BOX_OF(LR, bbx, P.bbox, k)[0], u0);
                const int i1 = min(BOX_OF(LR, bbx, P.bbox, k)[1], u1);
                const int j0 = BOX_OF(LR, bbx, P.bbox, k)[2];
                const int bw = BOX_OF(LR, bbx, P.bbox, k)[3] - j0;
                float acc = 0.0f;
                if (i0 < i1 && bw > 0)
                    for (int qq = lane; qq < (i1 - i0) * bw; qq += 32) {
                        const int i = i0 + qq / bw, j = j0 + qq % bw;
                        acc += xs[(i - u0 + SMEM_HALO) * PX + j + SMEM_HALO] *
                               B[(size_t)k * n + i * W + j];
                    }
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
                if (lane == 0) spart[k] = acc;
            }
            smem_sync<STAMPS>(cluster, S);  // every band's share
            //    every warp: the shares in rank order (the same sum in every
            //    block), B^T x - Sigma^1/2 n, u = W (...) into its slot
            const float* Wd = d ? W1 : W0;
            float sk = 1.0f, nk = 0.0f, u = 0.0f;
            if constexpr (LR) {
                float* vv = wv + m;
                for (int k = lane; k < m; k += 32) {
                    float bt = 0.0f;
                    for (int r = 0; r < S; ++r)
                        bt += (S > 1 ? cluster.map_shared_rank(spart, r) : spart)[k];
                    vv[k] = bt - sroot[k] * (P.noise_mode ? nlr[(size_t)d * m + k] : 0.0f);
                }
                __syncwarp();
                warp_matvec(Wd, vv, m, wv);
            } else {
                if (lane < m) {
                    float bt = 0.0f;
                    for (int r = 0; r < S; ++r) {
                        const float* part =
                            S > 1 ? cluster.map_shared_rank(&s_part[0], r) : s_part;
                        bt += part[lane];
                    }
                    sk = sroot[lane];
                    if (P.noise_mode) nk = nlr[(size_t)d * m + lane];
                    wv[lane] = bt - sk * nk;
                }
                __syncwarp();
                if (lane < m)
                    for (int k = 0; k < m; ++k) u += Wd[lane * m + k] * wv[k];
                __syncwarp();
                if (lane < m) wv[lane] = u;
                __syncwarp();
            }
            //    x -= sum_l u_l Y_l over the band's rows, each point by its owner,
            //    the columns in order (the boxes overlap)
            const float* Yd = d ? Y1 : Y0;
            WARP_ROWS(lr, nb) {
                const int i = u0 + lr;
                int lo = 1 << 30, hi = 0;
                for (int k = 0; k < m; ++k)
                    if (BOX_OF(LR, ybx, Pd.ybox, k)[0] <= i &&
                        i < BOX_OF(LR, ybx, Pd.ybox, k)[1]) {
                        lo = min(lo, BOX_OF(LR, ybx, Pd.ybox, k)[2]);
                        hi = max(hi, BOX_OF(LR, ybx, Pd.ybox, k)[3]);
                    }
                for (int j = lo + lane; j < hi; j += 32) {
                    float* xq = xs + (lr + SMEM_HALO) * PX + j + SMEM_HALO;
                    float v = *xq;
                    // eight columns' values at once (a column whose box misses
                    // the point adds -0 or +0), then their terms in order
                    for (int k0 = 0; k0 < m; k0 += 8) {
                        float y[8];
#pragma unroll
                        for (int u = 0; u < 8; ++u) {
                            const int k = k0 + u;
                            y[u] = (k < m && BOX_OF(LR, ybx, Pd.ybox, k)[0] <= i &&
                                    i < BOX_OF(LR, ybx, Pd.ybox, k)[1] &&
                                    BOX_OF(LR, ybx, Pd.ybox, k)[2] <= j &&
                                    j < BOX_OF(LR, ybx, Pd.ybox, k)[3])
                                       ? Yd[(size_t)k * n + i * W + j] : 0.0f;
                        }
#pragma unroll
                        for (int u = 0; u < 8; ++u)
                            if (k0 + u < m) v += -1.0f * wv[k0 + u] * y[u];
                    }
                    *xq = v;
                }
            }
            if (DESCEND && d == SP.ndir - 1) {
                // t = u + Sigma^-1/2 n = Sigma^-1 B^T x of the corrected x, for
                // the residual
                __syncwarp();
                if constexpr (LR) {
                    for (int k = lane; k < m; k += 32)
                        wv[k] = wv[k] + (P.noise_mode ? nlr[(size_t)d * m + k] : 0.0f) / sroot[k];
                } else if (lane < m) {
                    wv[lane] = u + nk / sk;
                }
                __syncwarp();
            }
        }
    }
    // every band corrected (and, with m > 0, every share read) before the
    // residual reads the neighbours' rows or a block leaves
    smem_sync<STAMPS>(cluster, S);
    //    the band back to device memory, once
    WARP_ROWS(lr, nb) {
        for (int j = lane; j < W; j += 32)
            x[first + lr * W + j] = xs[(lr + SMEM_HALO) * PX + j + SMEM_HALO];
    }

    if (DESCEND) {
        // 5. r = f - A x - sum_k t_k B_k over the band (c's place), one warp per
        //    row; a row within two of a cut or of the edge takes edge_ax where
        //    its terms leave the band or its coefficients the interior
        float* rs = csh ? cs - first : scr;  // r[p] for p in the band
        // the band's interior rectangle: rows [ra, rb) of the band, columns
        // [mg, W - mg) (interior coefficients, no row beyond a cut); the rest
        // of the band is its frame
        const int mg = SP.margin;
        const int ra = max(max(mg - u0, 0), rank > 0 ? SMEM_HALO : 0);
        const int rb = max(ra, min(min(H - mg - u0, nb), rank + 1 < S ? nb - SMEM_HALO : nb));
        const int ja = min(mg, W), jb = max(ja, W - mg);
        const int lanes = 32 * SMEM_POINTS;
        for (int lr = ra + warp; lr < rb; lr += nthreads >> 5) {
            const int i = u0 + lr;
            int lo = 1 << 30, hi = 0;
            for (int k = 0; k < m; ++k)
                if (BOX_OF(LR, bbx, P.bbox, k)[0] <= i && i < BOX_OF(LR, bbx, P.bbox, k)[1]) {
                    lo = min(lo, BOX_OF(LR, bbx, P.bbox, k)[2]);
                    hi = max(hi, BOX_OF(LR, bbx, P.bbox, k)[3]);
                }
            const float* xrow = xs + (lr + SMEM_HALO) * PX + SMEM_HALO;
            for (int j0 = ja + lane; j0 < jb; j0 += lanes) {
                int jj[SMEM_POINTS];
                float fv[SMEM_POINTS], ax[SMEM_POINTS];
#pragma unroll
                for (int u = 0; u < SMEM_POINTS; ++u) {
                    jj[u] = j0 + 32 * u < jb ? j0 + 32 * u : j0;
                    fv[u] = f[i * W + jj[u]];
                    ax[u] = 0.0f;
                }
#pragma unroll
                for (int k = 0; k < KMAX; ++k)
#pragma unroll
                    for (int u = 0; u < SMEM_POINTS; ++u)
                        ax[u] += SP.cval[k] * xrow[jj[u] + SP.soff[k]];
#pragma unroll
                for (int u = 0; u < SMEM_POINTS; ++u) {
                    const int j = j0 + 32 * u, p = i * W + j;
                    if (j >= jb) break;
                    float r = fv[u] - ax[u];
                    if (j >= lo && j < hi) r = lowrank_term<LR>(P, bbx, B, wv, m, i, j, p, n, r);
                    rs[p] = r;
                }
            }
        }
        //    the frame, a point a thread: rows [0, ra) and [rb, nb) whole, the
        //    first and last mg columns of the rows between
        const int top = ra * W, side = (rb - ra) * (W - (jb - ja));
        for (int e = tid; e < nb * W - (rb - ra) * (jb - ja); e += nthreads) {
            int lr, j;
            if (e < top) {
                lr = e / W;
                j = e - lr * W;
            } else if (e < top + side) {
                const int c = e - top, w = W - (jb - ja);
                lr = ra + c / w;
                j = c % w;
                j = j < ja ? j : jb + j - ja;
            } else {
                const int c = e - top - side;
                lr = rb + c / W;
                j = c - (lr - rb) * W;
            }
            const int i = u0 + lr, p = i * W + j;
            float r = f[p] - edge_ax<KMAX>(SP, P, coeffs, xs, xlo, xhi, rank, nb, lo_nb, lr, j, p,
                                           n);
            r = lowrank_term<LR>(P, bbx, B, wv, m, i, j, p, n, r);
            rs[p] = r;
        }
        smem_sync<STAMPS>(cluster, S);  // every band's residual
        // 6. f_c[I, J] = sum_{a, b} w_a w_b r[2I+1+a, 2J+1+b], w = {0.5, 1, 0.5},
        //    for the coarse rows whose centre row 2I+1 lies in this band
        const float* rlo = csh && S > 1 ? cluster.map_shared_rank(cs, rank > 0 ? rank - 1 : rank)
                                        : cs;
        const float* rhi =
            csh && S > 1 ? cluster.map_shared_rank(cs, rank + 1 < S ? rank + 1 : rank) : cs;
        float* fc = fc_all + (size_t)chain * P.Hc * P.Wc;
        const int I0 = u0 / 2, I1 = min(u1 / 2, P.Hc);
        for (int t = tid; t < (I1 - I0) * P.Wc; t += nthreads) {
            const int dI = t / P.Wc, J = t - dI * P.Wc, I = I0 + dI;
            float acc = 0.0f;
            // the nine values first (row 2I + 2 lies outside the field only
            // where H is even; a value outside adds +0), then the sums in order
            float v[3][3];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                const int i = 2 * I + a;
                const float* rrow = !csh ? scr + i * W
                                    : i < u0 ? rlo + (i - lo0) * W
                                    : i >= u1 ? rhi + (i - u1) * W
                                              : cs + (i - u0) * W;
#pragma unroll
                for (int b = 0; b < 3; ++b)
                    v[a][b] = (i < H && 2 * J + b < W) ? rrow[2 * J + b] : 0.0f;
            }
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                float row = 0.0f;
#pragma unroll
                for (int b = 0; b < 3; ++b) row += (b == 1 ? 1.0f : 0.5f) * v[a][b];
                acc += (a == 1 ? 1.0f : 0.5f) * row;
            }
            fc[I * P.Wc + J] = acc;
        }
        // no block leaves while another still reads its residual
        smem_sync<STAMPS>(cluster, S);
    }
    stamps_close<STAMPS>(srow, SMEM_STAMP_WIDTH);
}

// the kernel of (descend, kmax) of up to LANE_SLOTS measurements or of more
// (lr) in this library's build, or null
static const void* smem_kernel(int descend, int kmax, bool lr = false) {
    constexpr bool ST = SMEM_VISIT_STAMPS_BUILD;
    if (kmax == 5)
        return lr ? (descend ? (const void*)smem_visit_kernel<5, true, ST, true>
                             : (const void*)smem_visit_kernel<5, false, ST, true>)
                  : (descend ? (const void*)smem_visit_kernel<5, true, ST>
                             : (const void*)smem_visit_kernel<5, false, ST>);
    if (kmax == 9)
        return lr ? (descend ? (const void*)smem_visit_kernel<9, true, ST, true>
                             : (const void*)smem_visit_kernel<9, false, ST, true>)
                  : (descend ? (const void*)smem_visit_kernel<9, true, ST>
                             : (const void*)smem_visit_kernel<9, false, ST>);
    if (kmax == 13)
        return lr ? (descend ? (const void*)smem_visit_kernel<13, true, ST, true>
                             : (const void*)smem_visit_kernel<13, false, ST, true>)
                  : (descend ? (const void*)smem_visit_kernel<13, true, ST>
                             : (const void*)smem_visit_kernel<13, false, ST>);
    if (kmax == 25)
        return lr ? (descend ? (const void*)smem_visit_kernel<25, true, ST, true>
                             : (const void*)smem_visit_kernel<25, false, ST, true>)
                  : (descend ? (const void*)smem_visit_kernel<25, true, ST>
                             : (const void*)smem_visit_kernel<25, false, ST>);
    return nullptr;
}

// ------------------------------------------------------------ host helpers
static int rows_of_widest(int H, int S) { return (H + S - 1) / S; }

// the kernels' static shared memory at most (s_part, s_wv, the barrier count
// and the stamps pointer; mgmc_visit_smem.py::STATIC_SMEM)
#define SMEM_STATIC_BOUND (4 * (LANE_SLOTS + 32 * LANE_SLOTS) + 16)

// Whether a launch with `bytes` of dynamic shared memory must opt in to it:
// where the dynamic and the static share together exceed the 48 KiB a block
// gets without asking.
static bool needs_opt_in(int bytes) { return bytes > 0 && bytes + SMEM_STATIC_BOUND > 48 * 1024; }

static cudaError_t configure(const void* fn, int bytes) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess && needs_opt_in(bytes))
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

// ------------------------------------------------------------ C entry points
extern "C" int mgmc_smem_visit_params_size() { return (int)sizeof(SmemVisitParams); }

extern "C" int mgmc_smem_visit_stamp_width() { return SMEM_STAMP_WIDTH; }

extern "C" int mgmc_smem_visit_stamps_build() { return SMEM_VISIT_STAMPS_BUILD; }

extern "C" int mgmc_smem_visit_head_ints() { return SMEM_HEAD_INTS; }

extern "C" int mgmc_smem_visit_max_threads() { return SMEM_VISIT_MAX_THREADS; }

// Dynamic shared memory of one block (bytes): the widest band of x padded to
// PX columns with two rows a side, and with c_shared its rows of c and r.
// -1 where the level does not split so: S outside 1 .. 16, a band of fewer
// than two rows, a pitch narrower than the padded row.
extern "C" int mgmc_smem_visit_smem_bytes(int H, int W, int S, int PX, int c_shared) {
    if (S < 1 || S > SMEM_MAX_CLUSTER || H < 1 || W < 1 || H / S < SMEM_HALO ||
        PX < W + 2 * SMEM_HALO)
        return -1;
    const int nb = rows_of_widest(H, S);
    const long long floats = (long long)(nb + 2 * SMEM_HALO) * PX + (c_shared ? (long long)nb * W : 0);
    return floats * 4 > 0x7FFFFFFF ? -1 : (int)(floats * 4);
}

// the largest static shared memory of the library's kernels (bytes), or -1
extern "C" int mgmc_smem_visit_static_smem() {
    int most = 0;
    const int sizes[4] = {5, 9, 13, 25};
    for (int kmax : sizes)
        for (int descend = 0; descend < 2; ++descend)
            for (int lr = 0; lr < 2; ++lr) {
                cudaFuncAttributes a;
                if (cudaFuncGetAttributes(&a, smem_kernel(descend, kmax, lr)) != cudaSuccess) {
                    cudaGetLastError();
                    return -1;
                }
                most = a.sharedSizeBytes > (size_t)most ? (int)a.sharedSizeBytes : most;
            }
    return most;
}

// registers per thread, local (spill) bytes per thread and static shared
// bytes of the kernel of (descend, kmax); 0 or an error
extern "C" int mgmc_smem_visit_kernel_attributes(int descend, int kmax, int* out) {
    const void* fn = smem_kernel(descend, kmax);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, fn);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    return 0;
}

// blocks of `threads` with `bytes` of dynamic shared memory of the kernel of
// (descend, kmax) that one SM holds at once, or -1
extern "C" int mgmc_smem_visit_blocks_per_sm(int descend, int kmax, int threads, int bytes) {
    const void* fn = smem_kernel(descend, kmax);
    int blocks = 0;
    if (fn == nullptr || configure(fn, bytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, bytes) !=
            cudaSuccess) {
        cudaGetLastError();
        return -1;
    }
    return blocks;
}

// How many clusters of S blocks of `threads` threads and `bytes` of dynamic
// shared memory of the kernel of (descend, kmax) the card holds at once
// (cudaOccupancyMaxActiveClusters): 0 means such a cluster never schedules.
// Returns the CUDA error.
extern "C" int mgmc_smem_visit_max_active(int descend, int kmax, int S, int threads, int bytes,
                                          int* clusters) {
    *clusters = 0;
    const void* fn = smem_kernel(descend, kmax);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t e = configure(fn, bytes);
    if (e == cudaSuccess) {
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr[1];
        cluster_config(&cfg, attr, S, S, threads, bytes, 0);
        e = cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
    }
    if (e != cudaSuccess) cudaGetLastError();
    return (int)e;
}

static int launch(int descend, const SmemVisitParams* SP, void** args, int kmax, int threads,
                  int bytes, bool stamps, const int* boxes0, const int* boxes1,
                  cudaStream_t stream) {
    const VisitParams* P = &SP->v[0];
    const bool lr = P->m > LANE_SLOTS;
    const void* fn = smem_kernel(descend, kmax, lr);
    const bool two = SP->ndir == 2;
    if (fn == nullptr || stamps != (bool)SMEM_VISIT_STAMPS_BUILD || threads < 32 ||
        threads > SMEM_VISIT_MAX_THREADS || threads % 32 || SP->ndir < 1 ||
        SP->ndir > MAX_DIRS || P->K < 1 || P->K > kmax || P->n_colors > MAX_COLORS ||
        P->n_order > MAX_COLORS || P->C < 1 || P->m < 0 ||
        (lr && (boxes0 == nullptr || (two && boxes1 == nullptr))) ||
        P->Hc != P->H / 2 || P->Wc != P->W / 2 || (two && SP->v[1].n_order != P->n_order) ||
        bytes != mgmc_smem_visit_smem_bytes(P->H, P->W, SP->S, SP->PX, SP->c_shared) +
                     4 * lowrank_scratch_floats(P->m, threads) ||
        SP->nb_max != rows_of_widest(P->H, SP->S))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = configure(fn, bytes);
    if (e == cudaSuccess) {
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr[1];
        cluster_config(&cfg, attr, P->C * SP->S, SP->S, threads, bytes, stream);
        e = cudaLaunchKernelExC(&cfg, fn, args);
    }
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    return (int)cudaGetLastError();
}

// tables: the launch's heads and entries (mgmc_visit_smem.py::visit_tables);
// scratch: a field per chain (c and r where they are not in shared memory);
// Y0, W0 the first direction's Woodbury factors, Y1, W1 the second's (null
// with one direction); xilr (C, ndir m) the low-rank normals as drawn, sroot
// Sigma^1/2; xi (ndir, C, H, W) where noise_mode is 2; stamps (C S,
// SMEM_STAMP_WIDTH) in the stamps build, else null; boxes0, boxes1 each
// direction's box table (B's boxes, then its Y's; read where m > LANE_SLOTS).
extern "C" int mgmc_smem_descend(const SmemVisitParams* SP, const int* tables, float* x,
                                 const float* f, float* scratch, float* fc, const float* coeffs,
                                 const float* ns, const float* B, const float* Y0,
                                 const float* W0, const float* Y1, const float* W1,
                                 const float* xilr, const float* sroot, const float* xi,
                                 int kmax, int threads, int bytes, void* stamps,
                                 const int* boxes0, const int* boxes1, void* stream) {
    SmemVisitParams Pc = *SP;
    const float* xc = nullptr;
    unsigned long long* st = static_cast<unsigned long long*>(stamps);
    void* args[] = {&Pc, &tables, &x, &f, &scratch, &fc, &xc, &coeffs, &ns, &B, &Y0, &W0,
                    &Y1, &W1, &xilr, &sroot, &xi, &st, &boxes0, &boxes1};
    return launch(1, SP, args, kmax, threads, bytes, st != nullptr, boxes0, boxes1,
                  (cudaStream_t)stream);
}

extern "C" int mgmc_smem_ascend(const SmemVisitParams* SP, const int* tables, float* x,
                                const float* f, float* scratch, const float* xc,
                                const float* coeffs, const float* ns, const float* B,
                                const float* Y0, const float* W0, const float* Y1,
                                const float* W1, const float* xilr, const float* sroot,
                                const float* xi, int kmax, int threads, int bytes, void* stamps,
                                const int* boxes0, const int* boxes1, void* stream) {
    SmemVisitParams Pc = *SP;
    float* fc = nullptr;
    unsigned long long* st = static_cast<unsigned long long*>(stamps);
    void* args[] = {&Pc, &tables, &x, &f, &scratch, &fc, &xc, &coeffs, &ns, &B, &Y0, &W0,
                    &Y1, &W1, &xilr, &sroot, &xi, &st, &boxes0, &boxes1};
    return launch(0, SP, args, kmax, threads, bytes, st != nullptr, boxes0, boxes1,
                  (cudaStream_t)stream);
}
