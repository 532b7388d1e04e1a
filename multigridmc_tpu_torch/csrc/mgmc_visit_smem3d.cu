// Fused MGMC level-visit kernels for 3d levels, NVIDIA Hopper (sm_90a),
// float32: each chain's field in shared memory, in one block where it fits
// and split in slabs of whole z-planes over a thread-block cluster where it
// does not (the "smem" route of a 3d level).
//
// Replace, for the 7-point FD levels and the 27-point Galerkin levels of a 3d
// lattice, the Pallas kernels descend_visit and ascend_visit of
// multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py (their flat-3d form), and
// compute what level_descend / level_ascend of level_passes.cuh compute in the
// phase kernels' 3d build (mgmc_visit.cu -DVISIT_DIM=3), from the same
// parameter block (VisitParams of 27 offsets with Z, Y, Zc, Yc, dz and wz, one
// per sweep direction) and the same noise modes (0 off, 1 in-kernel Philox, 2
// xi read from memory), with one directed sweep (SOR) or two, forward then
// backward (SSOR):
//
//   descend:  c   = f + sqrt(D(2-w)/w) xi_d                       (Gibbs rhs)
//             x  <- colour-ordered SOR sweep(c, x)
//             x  <- x - sum_l u_l Y_l,  u = W (B^T x - Sigma^1/2 n_d)   (Woodbury)
//             r   = f - A_stencil x - sum_k t_k B_k,  t = u + Sigma^-1/2 n_d
//             f_c = R r                          (3d full weighting; after the last d)
//   ascend:   x  <- x + gamma P x_c (trilinear),  then per direction c, sweep, Woodbury
//
// Why.  The phase kernels' 3d build runs one block per chain over fields in
// device memory: at 32 chains 100 of an H100's 132 SMs idle, and every colour
// pass, the residual and the transfers read x again from the L2.  Here:
//
// * Residency.  A cluster of S blocks holds one chain (S = 1 where the chain
//   fits one block).  Block k holds its slab of z-planes [z0, z1) (slab_of:
//   the first Z % S ranks take one plane more) in dynamic shared memory, each
//   plane padded with one zero row and column a side, and one padded plane a
//   side (the ghost planes: zero at the field's two z faces); x is copied in
//   once with cp.async (4 bytes a thread: a 63-float row is only 4-byte
//   aligned, so no TMA) and written back once, coalesced.  The rhs c (and the
//   descend's residual r) sits beside it where the host says it fits
//   (c_shared), else in the chain's scratch field in device memory.
// * Across a cut.  A plane beyond the slab lies in the neighbouring rank's
//   shared memory (cluster.map_shared_rank), with a cluster barrier between
//   colours.  After each cluster barrier that precedes a pass reading across a
//   cut (each colour, the residual), each block copies the neighbours' edge
//   planes into its ghost planes, then a block barrier; every point then reads
//   its own shared memory, and a point next to a cut is an interior point like
//   any other.  During colour c only colour-c points change and no colour-c
//   point reads another, so the copy taken after the barrier that ends colour
//   c - 1 holds every value colour c reads.  (Reading the neighbour's plane in
//   place, the points next to a cut as edge points, measured slower at every
//   cluster size: PERF.md section 6.)
// * Colours.  Each thread takes its points from a table the host builds once
//   per (shape, order, slab) (mgmc_visit_smem3d.py::visit_tables): colour
//   after colour, first the points whose every coefficient equals the level's
//   interior value - their coefficients the scalars cval, their neighbours at
//   the padded offsets soff, SMEM_POINTS a thread in flight - then the edge
//   points (a coefficient plane that varies), each part dealt round the 32
//   banks.  The terms are added in offset order, as stencil_at adds them; a
//   neighbour in the zero halo adds +-0, so the routes agree to float32
//   rounding.
// * Low-rank and coarse terms.  The rhs takes the Philox numbering of
//   rhs_pass (group g of row z Y + y has the number (z Y + y) ceil(W / 4) +
//   g, chain, launch counter; direction d the counter + d), so all routes
//   agree under one stream.  B^T x is summed per slab, and every warp sums
//   the slabs' partial vectors in rank order, then forms u = W (B^T x -
//   Sigma^1/2 n) itself, so every block holds the same u bit for bit without
//   atomics; the Woodbury patch runs over the block's slab, each point by one
//   owner in column order; the low-rank noise enters the correction
//   (level_passes.cuh).  The restriction's coarse plane I belongs to the
//   block that owns fine plane 2I + 1, whose planes 2I and 2I + 2 may lie in
//   the neighbours' slabs; the prolongation reads x_c from device memory.
//   Up to LANE_SLOTS (32) measurements the slab's share and each warp's slot
//   are static arrays, one entry a lane, and the boxes lie in the parameter
//   block.  A level of more takes the kernels compiled with LR: the share and
//   the slots after the slab (and its planes of c) in dynamic shared memory,
//   lowrank_scratch_floats of visit_phases.cuh (per warp v, then u and t),
//   each lane holding entries lane, lane + 32, ..., u = W v a row at a time
//   (warp_matvec), the boxes from the level's device tables - bytes the slab
//   loses, so the host's route (mgmc_visit_smem3d.py::smem_cluster) counts
//   them before it takes it.
//
// The slab helpers (slab_of, the copy-in and write-back, the ghost copy, the
// cluster barrier, the launch's cluster attributes) live in slab3d.cuh, which
// the 3d 7-point sweeps of sor_sweep_smem3d.cu share.
//
// Barriers (smem_sync; the stamps build counts and stamps each): an ascend's
// copy-in (a descend's lands during its first rhs, behind that barrier), per
// direction the rhs, each colour and (m > 0) the slabs' shares of B^T x, then a
// descend 3 (the corrected x, the residual, the end) and an ascend 1 (the
// corrected x): mgmc_visit_smem3d.py::barrier_count.  Between blocks of a
// cluster each is a cluster barrier (the copy-in's is the block's).  A ghost
// copy's block barrier belongs to the pass it opens and is not counted.
//
// Bound: by bytes, per chain x read and written, f (unless shared), f_c
// written or x_c read; the planes, B, Y and the tables stay in the L2.
//
// SMEM_VISIT_STAMPS_BUILD: the measurement build, a library of its own, taken
// only where the host passes a stamps tensor, (C S, SMEM_STAMP_WIDTH) int64,
// per block (block_stamps.cuh): the timer at entry and after each barrier, at
// exit, the barriers passed, the SM.

#define VISIT_DIM 3
#define MAX_OFFSETS 27

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_stamps.cuh"
#include "slab3d.cuh"
#include "visit_phases.cuh"

#define SMEM_MAX_CLUSTER 16
// the sweep directions a launch may hold: one (SOR) or two (SSOR)
#define MAX_DIRS 2
// the block bound: 64 registers a thread, so that two blocks of 512 share an SM
#define SMEM_VISIT_MAX_THREADS 1024
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
// slab in shared memory.
struct SmemVolumeParams {
    VisitParams v[MAX_DIRS];
    int ndir;
    int S;         // blocks a chain (the cluster's size)
    int PX;        // a padded row: W + 2
    int PP;        // a padded plane: (Y + 2) PX
    int nz_max;    // planes of the widest slab
    int c_shared;  // 1: c and r in shared memory, else in the scratch field
    int margin;    // a point at least this far from the field's faces has interior coefficients
    int soff[MAX_OFFSETS];    // offset k in the padded slab: dz PP + dy PX + dx (0 from K on)
    float cval[MAX_OFFSETS];  // the interior coefficients (0 from K on)
    unsigned planes;          // bit k: coefficient k varies (the edge points read its plane)
};

extern __shared__ __align__(16) float smem_slab[];

// (A_stencil x) at an edge point (slab plane lz, row y, column j, field index
// p): the planes that vary read from device memory, the terms in offset order
// (a neighbour in the zero halo adds +-0; one beyond a cut lies in a ghost
// plane).  All KMAX terms: the host pads a stencil of fewer offsets with zero
// coefficients at the centre (each adds +-0).
template <int KMAX>
__device__ __forceinline__ float edge_ax(const SmemVolumeParams& SP, const VisitParams& P,
                                         const float* __restrict__ coeffs, const float* xs,
                                         int lz, int y, int j, int p, int n) {
    const int PX = SP.PX, PP = SP.PP;
    // every operand and coefficient first (a coefficient plane in the L2: the
    // round trips overlap), then the chain of FMAs
    float v[KMAX], a[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
        v[k] = xs[(lz + 1 + P.dz[k]) * PP + (y + 1 + P.dy[k]) * PX + j + 1 + P.dx[k]];
        const float* ak = ((SP.planes >> k) & 1u) ? coeffs + (size_t)k * n + p : &SP.cval[k];
        a[k] = *ak;
    }
    float ax = 0.0f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) ax += a[k] * v[k];
    return ax;
}

// whether 3d box b holds (z, y, j)
__device__ __forceinline__ bool in_box(const int* b, int z, int y, int j) {
    return b[0] <= z && z < b[1] && b[2] <= y && y < b[3] && b[4] <= j && j < b[5];
}

// r - sum_k t_k B_k[p] over the columns whose box holds (z, y, j), in column
// order (residual_rows' add_columns); wv: this warp's t
template <bool LR>
__device__ __forceinline__ float lowrank_term(const VisitParams& P, const int (*bt)[BOX_INTS],
                                              const float* __restrict__ B, const float* wv, int m,
                                              int z, int y, int j, int p, int n, float r) {
    for (int k = 0; k < m; ++k)
        if (in_box(BOX_OF(LR, bt, P.bbox, k), z, y, j))
            r += -1.0f * wv[k] * B[(size_t)k * n + p];
    return r;
}

// [lo, hi): the columns that the boxes holding row (z, y) span
__device__ __forceinline__ void box_span(const int (*box)[BOX_INTS], int m, int z, int y,
                                         int* lo, int* hi) {
    *lo = 1 << 30;
    *hi = 0;
    for (int k = 0; k < m; ++k)
        if (box[k][0] <= z && z < box[k][1] && box[k][2] <= y && y < box[k][3]) {
            *lo = min(*lo, box[k][4]);
            *hi = max(*hi, box[k][5]);
        }
}

// ------------------------------------------------------------------- kernel
// KMAX: the stencil's size, 7 (forms 10 / 11) or 27 (the 3x3x3 box and any
// other of up to 27 offsets, 12-15); a kernel each.  The sweep count (1 or 2)
// is read at run time.
template <int KMAX, bool DESCEND, bool STAMPS, bool LR = false>
__global__ void __launch_bounds__(SMEM_VISIT_MAX_THREADS)
smem_volume_kernel(const __grid_constant__ SmemVolumeParams SP, const int* __restrict__ tables,
                   float* x_all, const float* __restrict__ f_all, float* scr_all, float* fc_all,
                   const float* __restrict__ xc_all, const float* __restrict__ coeffs,
                   const float* __restrict__ ns, const float* __restrict__ B,
                   const float* __restrict__ Y0, const float* __restrict__ W0,
                   const float* __restrict__ Y1, const float* __restrict__ W1,
                   const float* __restrict__ xilr, const float* __restrict__ sroot,
                   const float* __restrict__ xi_all, unsigned long long* stamps,
                   const int* __restrict__ boxes0, const int* __restrict__ boxes1) {
    __shared__ float s_part[LANE_SLOTS];              // this slab's share of B^T x
    __shared__ float s_wv[32 * LANE_SLOTS];           // per warp: u, then t
    cg::cluster_group cluster = cg::this_cluster();
    const VisitParams& P = SP.v[0];  // what the directions share
    const int S = SP.S, PX = SP.PX, PP = SP.PP;
    const int rank = S > 1 ? (int)cluster.block_rank() : 0;
    const int chain = blockIdx.x / S;
    const int Z = P.Z, Y = P.Y, W = P.W, n2 = Y * W, n = Z * n2, m = P.m;
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5;
    unsigned long long* srow = STAMPS ? stamps + (size_t)blockIdx.x * SMEM_STAMP_WIDTH : nullptr;
    stamps_open<STAMPS>(srow);

    int z0, nz, lo_z0, lo_nz;
    slab_of(Z, S, rank, &z0, &nz);
    slab_of(Z, S, rank > 0 ? rank - 1 : 0, &lo_z0, &lo_nz);
    const int z1 = z0 + nz, first = z0 * n2, nrows = nz * Y;
    float* xs = smem_slab;                             // slab plane lz at padded plane lz + 1
    float* cs = xs + (SP.nz_max + 2) * PP;            // c, then r (c_shared), Y W a plane
    const bool csh = SP.c_shared != 0;
    float* x = x_all + (size_t)chain * n;
    const float* f = f_all + (P.f_batched ? (size_t)chain * n : 0);
    float* scr = scr_all + (size_t)chain * n;  // c, then r, where not in shared memory
    const float* nlr = P.noise_mode ? xilr + (size_t)chain * SP.ndir * m : nullptr;
    const float* xlo = S > 1 ? cluster.map_shared_rank(xs, rank > 0 ? rank - 1 : rank) : xs;
    const float* xhi = S > 1 ? cluster.map_shared_rank(xs, rank + 1 < S ? rank + 1 : rank) : xs;
    // the low-rank scratch (LR: after the slab and c's planes: the slab's
    // share, then per warp 2 m floats) and the boxes (LR: the device tables,
    // B's then each direction's Y's)
    float* lrs = cs + (csh ? (size_t)SP.nz_max * n2 : 0);
    float* spart = LR ? lrs : s_part;
    float* wv = LR ? lrs + m + (size_t)warp * 2 * m : s_wv + warp * LANE_SLOTS;
    const int(*bbx)[BOX_INTS] = reinterpret_cast<const int(*)[BOX_INTS]>(boxes0);

    // 1. the slab of x into its padded planes, the halo and the ghost planes
    //    zeroed; f's slab into c where c is in shared memory and no noise is
    //    drawn
    slab_load(xs, x + first, nz, Y, W, PX);
    if (csh && !P.noise_mode)
        for (int t = tid; t < nz * n2; t += nthreads) cp_async4(cs + t, f + first + t);
    if (!DESCEND) {  // the prolongation reads x; a descend's rhs does not: its copy
        cp_async_wait_all();  // lands while the rhs is drawn
        smem_sync<STAMPS>(cluster, S, true);
    }

    const int G4 = (W + 3) >> 2;
#pragma unroll 1
    for (int d = 0; d < SP.ndir; ++d) {
        const VisitParams& Pd = SP.v[d];
        const int(*ybx)[BOX_INTS] =
            reinterpret_cast<const int(*)[BOX_INTS]>(d ? boxes1 : boxes0) + m;
        // 2. the rhs (rhs_pass): ascend x += gamma P x_c (first direction,
        //    prolong_rows3's sum), then c = f + ns xi
        if (!DESCEND && d == 0) {
            const float* xc = xc_all + (size_t)chain * P.Zc * P.Yc * P.Wc;
            WARP_ROWS(lr, nrows) {
                const int lz = lr / Y, y = lr - lz * Y, z = z0 + lz;
                const int nzc = 2 - (z & 1), nyc = 2 - (y & 1);
                const int zb = (z >> 1) - (nzc - 1), yb = (y >> 1) - (nyc - 1);
                const float wz = (z & 1) ? 1.0f : 0.5f, wy = (y & 1) ? 1.0f : 0.5f;
                for (int j = lane; j < W; j += 32) {
                    const int nj = 2 - (j & 1), jb = (j >> 1) - (nj - 1);
                    const float wj = (j & 1) ? 1.0f : 0.5f;
                    float px = 0.0f;
                    for (int a = 0; a < nzc; ++a) {
                        const int Zc = zb + a;
                        if (Zc < 0 || Zc >= P.Zc) continue;
                        float plane = 0.0f;
                        for (int b = 0; b < nyc; ++b) {
                            const int Yc = yb + b;
                            if (Yc < 0 || Yc >= P.Yc) continue;
                            float row = 0.0f;
                            for (int c = 0; c < nj; ++c) {
                                const int Jc = jb + c;
                                if (Jc >= 0 && Jc < P.Wc)
                                    row += wj * xc[(Zc * P.Yc + Yc) * P.Wc + Jc];
                            }
                            plane += wy * row;
                        }
                        px += wz * plane;
                    }
                    float* xq = xs + ((lz + 1) * (Y + 2) + y + 1) * PX + j + 1;
                    *xq += P.gamma * px;
                }
            }
        }
        if (P.noise_mode) {
            const float* xi = P.noise_mode == 2 ? xi_all + ((size_t)d * P.C + chain) * n : nullptr;
            for (int t = tid; t < nrows * G4; t += nthreads) {
                const int lr = t / G4, g = t - lr * G4;
                const int i = z0 * Y + lr;  // the row z Y + y
                float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                if (P.noise_mode == 1)
                    philox_normals4((uint32_t)(i * G4 + g), (uint32_t)chain, Pd.seed, Pd.counter,
                                    z);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int j = 4 * g + q;
                    if (j >= W) break;
                    const int p = i * W + j;
                    const float zq = (P.noise_mode == 2) ? xi[p] : z[q];
                    const float c = f[p] + (P.ns_const ? P.ns_val : ns[p]) * zq;
                    if (csh)
                        cs[p - first] = c;
                    else
                        scr[p] = c;
                }
            }
        }
        if (DESCEND && d == 0) cp_async_wait_all();
        // every slab formed (and corrected by the previous direction) before
        // any block reads a neighbour's planes
        smem_sync<STAMPS>(cluster, S);

        // 3. the colour phases on the slab, from the table of (direction, rank)
        const int* head = tables + (size_t)(d * S + rank) * SMEM_HEAD_INTS;
        const float* cg_ = P.noise_mode ? scr : f;  // c in device memory
        const float omega = P.omega;
        const float dval = SP.cval[P.diag_index];
        for (int o = 0; o < P.n_order; ++o) {
            if (S > 1) ghost_copy(S, PX, PP, xs, xlo, xhi, rank, nz, lo_nz, Y, W);
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
                    const int pr = (int)(e & 0xffffu);
                    cv[u] = csh ? cs[pr] : cg_[first + pr];
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
                const int q = (int)(e >> 16), pr = (int)(e & 0xffffu);
                const int p = first + pr;
                const float cv = csh ? cs[pr] : cg_[p];
                const int lz = pr / n2, rem = pr - lz * n2, y = rem / W, j = rem - y * W;
                const float ax = edge_ax<KMAX>(SP, P, coeffs, xs, lz, y, j, p, n);
                const float dv = ((SP.planes >> P.diag_index) & 1u)
                                     ? __ldg(coeffs + (size_t)P.diag_index * n + p)
                                     : dval;
                xs[q] = xs[q] + omega * (cv - ax) / dv;
            }
            smem_sync<STAMPS>(cluster, S);  // the colour done on every slab
        }

        // 4. Woodbury: this slab's share of B^T x, one warp per column (lanes
        //    along its box's part in the slab, a fixed shuffle tree)
        if (m) {
            const int nwarps = nthreads >> 5;
            for (int k = warp; k < m; k += nwarps) {
                const int* bk = BOX_OF(LR, bbx, P.bbox, k);
                const int bz0 = max(bk[0], z0), bz1 = min(bk[1], z1);
                const int y0 = bk[2], bh = bk[3] - y0;
                const int j0 = bk[4], bw = bk[5] - j0;
                float acc = 0.0f;
                if (bz0 < bz1 && bh > 0 && bw > 0)
                    for (int qq = lane; qq < (bz1 - bz0) * bh * bw; qq += 32) {
                        const int row = qq / bw, j = j0 + qq - row * bw;
                        const int dz = row / bh, y = y0 + row - dz * bh, z = bz0 + dz;
                        acc += xs[((z - z0 + 1) * (Y + 2) + y + 1) * PX + j + 1] *
                               B[(size_t)k * n + (z * Y + y) * W + j];
                    }
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
                if (lane == 0) spart[k] = acc;
            }
            smem_sync<STAMPS>(cluster, S);  // every slab's share
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
            //    x -= sum_l u_l Y_l over the slab's rows, each point by its owner,
            //    the columns in order (the boxes overlap)
            const float* Yd = d ? Y1 : Y0;
            WARP_ROWS(lr, nrows) {
                const int lz = lr / Y, y = lr - lz * Y, z = z0 + lz;
                int lo, hi;
                box_span(LR ? ybx : Pd.ybox, m, z, y, &lo, &hi);
                for (int j = lo + lane; j < hi; j += 32) {
                    float* xq = xs + ((lz + 1) * (Y + 2) + y + 1) * PX + j + 1;
                    float v = *xq;
                    for (int k = 0; k < m; ++k)
                        if (in_box(BOX_OF(LR, ybx, Pd.ybox, k), z, y, j))
                            v += -1.0f * wv[k] * Yd[(size_t)k * n + (z * Y + y) * W + j];
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
    // every slab corrected (and, with m > 0, every share read) before the
    // residual reads the neighbours' planes or a block leaves
    smem_sync<STAMPS>(cluster, S);
    //    the slab back to device memory, once
    slab_store(xs, x + first, nz, Y, W, PX);

    if (DESCEND) {
        // 5. r = f - A x - sum_k t_k B_k over the slab (c's place), the slab's
        //    points over all threads, SMEM_POINTS a thread at once (a warp
        //    per row of 31 or 63 points left most of its chains idle); a point
        //    within the margin of a face takes edge_ax, one inside the
        //    columns' boxes the low-rank term
        if (S > 1) ghost_copy(S, PX, PP, xs, xlo, xhi, rank, nz, lo_nz, Y, W);
        float* rs = csh ? cs - first : scr;  // r[p] for p in the slab
        const int mg = SP.margin, npts = nz * n2;
        int ub[BOX_INTS] = {1 << 30, 0, 1 << 30, 0, 1 << 30, 0};  // the boxes' union
        for (int k = 0; k < m; ++k)
            for (int a = 0; a < BOX_INTS; a += 2) {
                ub[a] = min(ub[a], BOX_OF(LR, bbx, P.bbox, k)[a]);
                ub[a + 1] = max(ub[a + 1], BOX_OF(LR, bbx, P.bbox, k)[a + 1]);
            }
        for (int t = tid; t < npts; t += SMEM_POINTS * nthreads) {
            int e[SMEM_POINTS], q[SMEM_POINTS];
            float fv[SMEM_POINTS], ax[SMEM_POINTS];
#pragma unroll
            for (int u = 0; u < SMEM_POINTS; ++u) {
                const int tu = t + u * nthreads;
                e[u] = tu < npts ? tu : t;
                const int lz = e[u] / n2, rem = e[u] - lz * n2, y = rem / W;
                q[u] = ((lz + 1) * (Y + 2) + y + 1) * PX + rem - y * W + 1;
                fv[u] = f[first + e[u]];
                ax[u] = 0.0f;
            }
#pragma unroll
            for (int k = 0; k < KMAX; ++k)
#pragma unroll
                for (int u = 0; u < SMEM_POINTS; ++u)
                    ax[u] += SP.cval[k] * xs[q[u] + SP.soff[k]];
#pragma unroll
            for (int u = 0; u < SMEM_POINTS; ++u) {
                if (t + u * nthreads >= npts) break;
                const int lz = e[u] / n2, rem = e[u] - lz * n2, y = rem / W, j = rem - y * W;
                const int z = z0 + lz, p = first + e[u];
                const bool plain = z >= mg && z < Z - mg && y >= mg && y < Y - mg && j >= mg &&
                                   j < W - mg;
                float r = fv[u] - (plain ? ax[u]
                                         : edge_ax<KMAX>(SP, P, coeffs, xs, lz, y, j, p, n));
                if (in_box(ub, z, y, j)) r = lowrank_term<LR>(P, bbx, B, wv, m, z, y, j, p, n, r);
                rs[p] = r;
            }
        }
        smem_sync<STAMPS>(cluster, S);  // every slab's residual
        // 6. f_c[Kz, I, J] = sum_{c, a, b} w_c w_a w_b r[2Kz+c, 2I+a, 2J+b],
        //    w = {0.5, 1, 0.5} (restrict_rows3's sum), for the coarse planes
        //    whose centre plane 2Kz+1 lies in this slab
        const float* rlo = csh && S > 1 ? cluster.map_shared_rank(cs, rank > 0 ? rank - 1 : rank)
                                        : cs;
        const float* rhi =
            csh && S > 1 ? cluster.map_shared_rank(cs, rank + 1 < S ? rank + 1 : rank) : cs;
        const int Zc = P.Zc, Yc = P.Yc, Wc = P.Wc;
        float* fc = fc_all + (size_t)chain * Zc * Yc * Wc;
        const int K0 = z0 / 2, K1 = min(z1 / 2, Zc);
        WARP_ROWS(R, (K1 - K0) * Yc) {
            const int Kz = K0 + R / Yc, I = R - (R / Yc) * Yc;
            const float* pl[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const int z = 2 * Kz + c;
                pl[c] = z >= Z ? nullptr
                        : !csh   ? scr + (size_t)z * n2
                        : z < z0 ? rlo + (z - lo_z0) * n2
                        : z >= z1 ? rhi + (z - z1) * n2
                                  : cs + (z - z0) * n2;
            }
            for (int J = lane; J < Wc; J += 32) {
                float v[3][3][3];
#pragma unroll
                for (int c = 0; c < 3; ++c)
#pragma unroll
                    for (int a = 0; a < 3; ++a)
#pragma unroll
                        for (int b = 0; b < 3; ++b) {
                            const int i = 2 * I + a, j = 2 * J + b;
                            v[c][a][b] = (pl[c] != nullptr && i < Y && j < W) ? pl[c][i * W + j]
                                                                              : 0.0f;
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
                fc[(Kz * Yc + I) * Wc + J] = acc;
            }
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
    if (kmax == 7)
        return lr ? (descend ? (const void*)smem_volume_kernel<7, true, ST, true>
                             : (const void*)smem_volume_kernel<7, false, ST, true>)
                  : (descend ? (const void*)smem_volume_kernel<7, true, ST>
                             : (const void*)smem_volume_kernel<7, false, ST>);
    if (kmax == 27)
        return lr ? (descend ? (const void*)smem_volume_kernel<27, true, ST, true>
                             : (const void*)smem_volume_kernel<27, false, ST, true>)
                  : (descend ? (const void*)smem_volume_kernel<27, true, ST>
                             : (const void*)smem_volume_kernel<27, false, ST>);
    return nullptr;
}

// ------------------------------------------------------------ C entry points
extern "C" int mgmc_smem3d_params_size() { return (int)sizeof(SmemVolumeParams); }

extern "C" int mgmc_smem3d_stamp_width() { return SMEM_STAMP_WIDTH; }

extern "C" int mgmc_smem3d_stamps_build() { return SMEM_VISIT_STAMPS_BUILD; }

extern "C" int mgmc_smem3d_head_ints() { return SMEM_HEAD_INTS; }

extern "C" int mgmc_smem3d_max_threads() { return SMEM_VISIT_MAX_THREADS; }

// Dynamic shared memory of one block (bytes): the widest slab of x, padded
// planes of PP floats with a ghost plane a side, and with c_shared its planes
// of c and r.  -1 where the level does not split so: S outside 1 .. 16, more
// blocks than planes, a padded plane smaller than (Y + 2)(W + 2).
extern "C" int mgmc_smem3d_smem_bytes(int Z, int Y, int W, int S, int PP, int c_shared) {
    if (S < 1 || S > SMEM_MAX_CLUSTER || Z < 1 || Y < 1 || W < 1 || Z / S < 1 ||
        PP < (Y + 2) * (W + 2))
        return -1;
    const int nz = planes_of_widest(Z, S);
    const long long floats =
        (long long)(nz + 2) * PP + (c_shared ? (long long)nz * Y * W : 0);
    return floats * 4 > 0x7FFFFFFF ? -1 : (int)(floats * 4);
}

// the largest static shared memory of the library's kernels (bytes), or -1
extern "C" int mgmc_smem3d_static_smem() {
    int most = 0;
    const int sizes[2] = {7, 27};
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
extern "C" int mgmc_smem3d_kernel_attributes(int descend, int kmax, int* out) {
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
extern "C" int mgmc_smem3d_blocks_per_sm(int descend, int kmax, int threads, int bytes) {
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
extern "C" int mgmc_smem3d_max_active(int descend, int kmax, int S, int threads, int bytes,
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

static int launch(int descend, const SmemVolumeParams* SP, void** args, int kmax, int threads,
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
        P->H != P->Z * P->Y || P->Zc != P->Z / 2 || P->Yc != P->Y / 2 || P->Wc != P->W / 2 ||
        (two && SP->v[1].n_order != P->n_order) || SP->PX != P->W + 2 ||
        SP->PP != (P->Y + 2) * SP->PX ||
        bytes != mgmc_smem3d_smem_bytes(P->Z, P->Y, P->W, SP->S, SP->PP, SP->c_shared) +
                     4 * lowrank_scratch_floats(P->m, threads) ||
        SP->nz_max != planes_of_widest(P->Z, SP->S))
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

// tables: the launch's heads and entries (mgmc_visit_smem3d.py::visit_tables);
// scratch: a field per chain (c and r where they are not in shared memory);
// Y0, W0 the first direction's Woodbury factors, Y1, W1 the second's (null
// with one direction); xilr (C, ndir m) the low-rank normals as drawn, sroot
// Sigma^1/2; xi (ndir, C, Z, Y, W) where noise_mode is 2; stamps (C S,
// SMEM_STAMP_WIDTH) in the stamps build, else null; boxes0, boxes1 each
// direction's box table (B's boxes, then its Y's; read where m > LANE_SLOTS).
extern "C" int mgmc_smem3d_descend(const SmemVolumeParams* SP, const int* tables, float* x,
                                   const float* f, float* scratch, float* fc, const float* coeffs,
                                   const float* ns, const float* B, const float* Y0,
                                   const float* W0, const float* Y1, const float* W1,
                                   const float* xilr, const float* sroot, const float* xi,
                                   int kmax, int threads, int bytes, void* stamps,
                                   const int* boxes0, const int* boxes1, void* stream) {
    SmemVolumeParams Pc = *SP;
    const float* xc = nullptr;
    unsigned long long* st = static_cast<unsigned long long*>(stamps);
    void* args[] = {&Pc, &tables, &x, &f, &scratch, &fc, &xc, &coeffs, &ns, &B, &Y0, &W0,
                    &Y1, &W1, &xilr, &sroot, &xi, &st, &boxes0, &boxes1};
    return launch(1, SP, args, kmax, threads, bytes, st != nullptr, boxes0, boxes1,
                  (cudaStream_t)stream);
}

extern "C" int mgmc_smem3d_ascend(const SmemVolumeParams* SP, const int* tables, float* x,
                                  const float* f, float* scratch, const float* xc,
                                  const float* coeffs, const float* ns, const float* B,
                                  const float* Y0, const float* W0, const float* Y1,
                                  const float* W1, const float* xilr, const float* sroot,
                                  const float* xi, int kmax, int threads, int bytes, void* stamps,
                                  const int* boxes0, const int* boxes1, void* stream) {
    SmemVolumeParams Pc = *SP;
    float* fc = nullptr;
    unsigned long long* st = static_cast<unsigned long long*>(stamps);
    void* args[] = {&Pc, &tables, &x, &f, &scratch, &fc, &xc, &coeffs, &ns, &B, &Y0, &W0,
                    &Y1, &W1, &xilr, &sroot, &xi, &st, &boxes0, &boxes1};
    return launch(0, SP, args, kmax, threads, bytes, st != nullptr, boxes0, boxes1,
                  (cudaStream_t)stream);
}
