// Fused MGMC level-visit kernels for NVIDIA Hopper (sm_90a), float32, 2d:
// the row-wavefront ("stream") design.
//
// Replaces, like mgmc_visit.cu, the Pallas kernels descend_visit and
// ascend_visit of multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py, and
// computes what the phase kernels of mgmc_visit.cu compute (the passes of
// level_passes.cuh):
//
//   descend:  c   = f + sqrt(D(2-w)/w) xi                        (Gibbs rhs)
//             x  <- colour-ordered SOR sweep(c, x)
//             x  <- x - sum_l u_l Y_l,  u = W (B^T x - Sigma^1/2 n)   (Woodbury)
//             r   = f - A_stencil x - sum_k t_k B_k,  t = u + Sigma^-1/2 n
//             f_c = R r                                          (full weighting)
//   ascend:   x  <- x + gamma P x_c,  then c, sweep, Woodbury (post direction)
//
// with n the sweep's low-rank normals, which enter the correction and not the
// rhs (level_passes.cuh).  One directed sweep per visit (SOR): a two-sweep
// level takes the phase or the split kernels.
//
// Why another design.  The phase kernels keep the field in global memory and
// run whole-field passes between barriers: about ten passes over a 260 KB
// field per descend visit, and at 256 chains (133 MB with the scratch field)
// most of them reach HBM.  Here each chain's field streams through the block
// twice (descend) or once (ascend), and nothing but x, f_c and the few
// Woodbury points is written.
//
// Pass 1, the sweep as a wavefront of row blocks.  One thread block per
// chain.  The rows are taken STREAM_ROWS at a time (a "row block"); with a
// reach-1 stencil, colour phase o on row block b needs the phases before o
// done on the neighbouring rows and no later phase run there yet.  At step s
// the block runs phase o on row block s - lag[o], for every o at once, and one
// barrier ends the step.  The host computes the least lags for which the
// phases of one step touch no common point (wavefront_lags in
// ops/kernels/mgmc_visit.py: two colours give lags 0, 2; the 4-colour 9-point
// levels 0, 2, 4, 6).  Every point is updated by the arithmetic of
// sweep_colours (level_passes.cuh) from the same values, so the result is the
// colour-ordered SOR sweep, and under the same Philox stream the field of
// the phase kernels (a neighbour outside the field adds c * 0 here where the
// phase kernel skips it: the same value).
//   The rows live in a ring in shared memory: x and c = f + noise.  Within a
// step the block's two halves work side by side: the first half sweeps (each
// thread a point in each row of its colour phase's row block, all loads
// before the divisions); the second half forms row block s + 2, one Philox
// point group per thread (c = f + ns xi; ascend:
// x += gamma P x_c first), four points read and written as one vector.  All
// threads write back row block s - max_lag - 1, final since the step before,
// coalesced (adding its share of B^T x, inside the bounding boxes, to per-warp
// partial sums), and issue the 4-byte cp.async loads of x, f and the coarse
// rows of row block s + 3 + STREAM_PREFETCH (a row of 255 floats starts at
// 1020 i bytes in global memory: wider copies would need another pitch of the
// field), which the step waits for before its barrier STREAM_PREFETCH steps
// later.  c is never written to memory.
// Woodbury.  After the last row: B^T x from the partial sums in a fixed order,
// u = W (B^T x - Sigma^1/2 n), x -= u_l Y_l on the Y bounding boxes in global memory, one
// column after the other: each point's columns in column order, as
// woodbury_pass (level_passes.cuh).
// Pass 2 (descend only).  The corrected x streams through the block again in
// tiles of STREAM_TILE coarse rows, with f, double-buffered by cp.async: the
// residual rows 2I .. 2I+2 of coarse row I are formed in shared memory
// (r = f - A x, then the low-rank term, as residual_pass), and f_c is written.
//
// Bound.  By bytes a descend visit must read x and f once and write x and f_c
// once per chain (it reads x twice: pass 2 re-reads the corrected field, which
// at 256 chains no longer sits in L2).  Measured on an H100 (PERF.md) it is
// bound by the issue of instructions instead: per point the Philox draw (a
// quarter of a four-normal group), the stencil, an IEEE division and the
// ring's bookkeeping, with few warps per SM (one block per chain).  No
// atomics, fixed reduction orders: equal seeds and counters give bitwise
// equal fields.  Noise addressing is that of rhs_pass: group g of row i has
// the Philox counter word i * ceil(W / 4) + g.
//
// Measurements: at most STREAM_MAX_LOWRANK (32), a thread per entry of the
// low-rank vectors and a bit per column in each row's mask; the host
// (mgmc_visit.py::visit_route) sends a level of more to the phase kernels, and
// the launch refuses one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "visit_phases.cuh"

#define STREAM_ROWS 4        // rows per row block (a multiple of 2)
#define STREAM_PREFETCH 1    // steps between a load's issue and the wait for it
#define STREAM_TILE 4        // coarse rows per tile of pass 2
#define STREAM_COL0 4        // column of point j = 0 in a row of shared memory
#define MAX_STREAM_THREADS 256
// the most measurements the kernels take: one bit of a row's column mask each
#define STREAM_MAX_LOWRANK LANE_SLOTS

struct StreamParams {
    VisitParams v;
    int lag[MAX_COLORS];  // phase o runs on row block s - lag[o] at step s
    int max_lag;
};

// Where everything lies in dynamic shared memory (floats).  A row of the
// rings and tiles holds the field's row at columns STREAM_COL0 .. + W - 1,
// zeros at the columns beside it (so that the stencils read without bounds
// checks), and starts 16-byte aligned (so that a Philox point group of four
// points is one vector access).  The rings grow with W and the lags: at 1023^2
// (5-point) or 511^2 (4 colours) they exceed a block's shared memory, and the
// host, which mirrors this layout, sends such a level to the phase kernels.
struct StreamLayout {
    int pitch;     // floats per row of a ring or tile
    int nring;     // rows of the x ring (the c ring has as many): a power of 2
    int rows;      // rows of the ring and tile area, all with zero edge columns
    int xc_pitch, xc_rows;  // the coarse rows of a row block (ascend)
    int c_off, zero_off, xc_off, mask_off, part_off, nwarps, floats;
};

#define XTILE_ROWS (2 * STREAM_TILE + 3)
#define RTILE_ROWS (2 * STREAM_TILE + 1)

__host__ __device__ inline int stream_pitch(int w) { return (w + STREAM_COL0 + 4) & ~3; }

__host__ __device__ inline StreamLayout stream_layout(const StreamParams& S, int ascend,
                                                      int threads) {
    StreamLayout L;
    L.pitch = stream_pitch(S.v.W);
    // live row blocks at step s: s - max_lag - 1 (written back) .. s + 3 + PREFETCH
    L.nring = STREAM_ROWS;
    while (L.nring < (S.max_lag + STREAM_PREFETCH + 5) * STREAM_ROWS) L.nring *= 2;
    L.rows = 2 * L.nring;  // pass 2 reuses the rings: x tiles and r (= f) tiles, two of each
    if (!ascend && 2 * (XTILE_ROWS + RTILE_ROWS) > L.rows) L.rows = 2 * (XTILE_ROWS + RTILE_ROWS);
    L.c_off = L.nring * L.pitch;
    L.zero_off = L.rows * L.pitch;  // a row of zeros: the rows above and below the field
    int used = L.zero_off + L.pitch;
    L.xc_pitch = stream_pitch(S.v.Wc);
    L.xc_rows = STREAM_ROWS / 2 + 2;
    L.xc_off = used;
    if (ascend) used += (STREAM_PREFETCH + 2) * L.xc_rows * L.xc_pitch;
    L.nwarps = threads / 32;
    L.mask_off = used;  // per row: the bounding boxes of B that hold it (bit k)
    used += S.v.H;
    L.part_off = used;
    used += S.v.m * L.nwarps;
    L.floats = used;
    return L;
}

// ------------------------------------------------------------ cp.async, 4 B
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// (A_stencil x)[i, j]: `above`, `here`, `below` point at point 0 of x's rows
// i-1, i, i+1 (a row of zeros outside the field, zeros beside it), so every
// offset is read and the ones outside the field add c * 0.  The offsets in
// order, as stencil_at; KMAX offsets, those past P.K with coefficient 0;
// constant coefficients are read from the parameter block, the others from
// their planes.
template <int KMAX, bool CONST>
__device__ __forceinline__ float stencil_rows(const VisitParams& P,
                                              const float* __restrict__ coeffs,
                                              const float* above, const float* here,
                                              const float* below, int j, int n, int p) {
    float ax = 0.0f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
        const bool live = k < P.K;
        const int dy = live ? P.dy[k] : 0, dx = live ? P.dx[k] : 0;
        const float* row = dy < 0 ? above : (dy > 0 ? below : here);
        float ck = live ? P.coeff_val[k] : 0.0f;
        if (!CONST && live && !P.coeff_const[k]) ck = __ldg(coeffs + (size_t)k * n + p);
        ax += ck * row[j + dx];
    }
    return ax;
}

template <bool CONST>
__device__ __forceinline__ float diag_at(const VisitParams& P, float diag,
                                         const float* __restrict__ coeffs, int n, int p) {
    if (CONST || P.coeff_const[P.diag_index]) return diag;
    return __ldg(coeffs + (size_t)P.diag_index * n + p);
}

// ------------------------------------------------------------------- kernel
// Two blocks of MAX_STREAM_THREADS on an SM where the registers allow it (the
// 5-point levels with constant coefficients: the flagship's 256 chains in one wave)
template <bool DESCEND, int KMAX, bool CONST>
__global__ void __launch_bounds__(MAX_STREAM_THREADS, CONST ? 2 : 1)
stream_visit_kernel(const __grid_constant__ StreamParams S, float* x_all,
                    const float* __restrict__ f_all, float* fc_all,
                    const float* __restrict__ xc_all, const float* __restrict__ coeffs,
                    const float* __restrict__ ns, const float* __restrict__ B,
                    const float* __restrict__ Y, const float* __restrict__ Wm,
                    const float* __restrict__ xilr, const float* __restrict__ sroot,
                    const float* __restrict__ xi_all) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    __shared__ float s_btx[STREAM_MAX_LOWRANK];
    __shared__ float s_lr[STREAM_MAX_LOWRANK];
    __shared__ float s_u[STREAM_MAX_LOWRANK];
    __shared__ int s_j0[MAX_COLORS * MAX_COLORS];

    const VisitParams& P = S.v;
    const StreamLayout L = stream_layout(S, !DESCEND, blockDim.x);
    const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31, warp = tid >> 5;
    const int chain = blockIdx.x;
    const int H = P.H, W = P.W, n = H * W, pitch = L.pitch, rmask = L.nring - 1;
    const int Hc = P.Hc, Wc = P.Wc, xcp = L.xc_pitch;
    float* x = x_all + (size_t)chain * n;
    const float* f = f_all + (P.f_batched ? (size_t)chain * n : 0);
    const float* xi = xi_all ? xi_all + (size_t)chain * n : nullptr;
    const float* xcg = DESCEND ? nullptr : xc_all + (size_t)chain * Hc * Wc;
    // point 0 of ring row `slot` (x and c), of the zero row, of a coarse buffer row
    float* xr = smem + STREAM_COL0;
    float* cr = smem + L.c_off + STREAM_COL0;
    const float* zrow = smem + L.zero_off + STREAM_COL0;
    float* xcb = smem + L.xc_off + STREAM_COL0;
    int* s_mask = reinterpret_cast<int*>(smem + L.mask_off);
    float* part = smem + L.part_off;
    const int xcbuf = L.xc_rows * xcp;
    const int Gw = (W + 3) >> 2;
    const int nblocks = (H + STREAM_ROWS - 1) / STREAM_ROWS;
    const float diag = P.coeff_val[P.diag_index];

    // ------------------------------------------------------------ set-up
    for (int r = tid; r < L.rows; r += nth) {  // the zero columns beside every row
        smem[r * pitch + STREAM_COL0 - 1] = 0.0f;
        for (int j = W; j < pitch - STREAM_COL0; ++j) smem[r * pitch + STREAM_COL0 + j] = 0.0f;
    }
    for (int j = tid; j < pitch; j += nth) smem[L.zero_off + j] = 0.0f;
    if (!DESCEND)
        for (int r = tid; r < (STREAM_PREFETCH + 2) * L.xc_rows; r += nth) {
            xcb[r * xcp - 1] = 0.0f;
            for (int J = Wc; J < xcp - STREAM_COL0; ++J) xcb[r * xcp + J] = 0.0f;
        }
    // first column of colour order[o] in a row i with i % K == rm (-1: none)
    for (int q = tid; q < P.n_colors * P.n_order; q += nth) {
        const int rm = q / P.n_order, o = q % P.n_order;
        const int base = (P.w0 * rm) % P.n_colors;
        int j0 = -1;
        for (int jj = 0; jj < P.jstride; ++jj)
            if ((base + P.w1 * jj) % P.n_colors == P.order[o]) { j0 = jj; break; }
        s_j0[rm * MAX_COLORS + o] = j0;
    }
    for (int i = tid; i < H; i += nth) {
        int mk = 0;
        for (int k = 0; k < P.m; ++k)
            if (i >= P.bbox[k][0] && i < P.bbox[k][1]) mk |= 1 << k;
        s_mask[i] = mk;
    }
    for (int q = tid; q < P.m * L.nwarps; q += nth) part[q] = 0.0f;
    if (P.noise_mode && tid < P.m) s_lr[tid] = xilr[(size_t)chain * P.m + tid];
    // The threads' roles within a step: the first half sweeps, the second half
    // forms the row block that enters the ring (the Philox chains), so that the
    // two run side by side; all of them load and write back.
    const int nsw = nth >> 1, nfm = nth - nsw, ftid = tid - nsw;
    // a forming thread's first Philox point group of a row block: (row, group)
    const int g_rr0 = ftid / Gw, g_g0 = ftid % Gw;

    // loads of step t: x and f of row block t + 3 + PREFETCH, and the coarse rows
    // that row block will interpolate from; consecutive threads, consecutive words
    auto issue = [&](int t) {
        const int b = t + 3 + STREAM_PREFETCH;
        if (b >= 0 && b < nblocks) {
            const int r0 = b * STREAM_ROWS, rows = min(STREAM_ROWS, H - r0);
            for (int i = r0; i < r0 + rows; ++i) {
                const int slot = (i & rmask) * pitch;
                for (int j = tid; j < W; j += nth) {
                    cp_async4(xr + slot + j, x + i * W + j);
                    cp_async4(cr + slot + j, f + i * W + j);
                }
            }
            if (!DESCEND) {
                const int lo = max((r0 - 1) >> 1, 0), hi = min(Hc - 1, (r0 + rows - 1) >> 1);
                float* buf = xcb + (b % (STREAM_PREFETCH + 2)) * xcbuf;
                for (int I = lo; I <= hi; ++I)
                    for (int J = tid; J < Wc; J += nth)
                        cp_async4(buf + (I - lo) * xcp + J, xcg + I * Wc + J);
            }
        }
        cp_async_commit();
    };

    // Point group g of row i gets its final c (and, ascending, x += gamma P x_c):
    // the arithmetic of rhs_pass (level_passes.cuh), point for point; four
    // points read and written as one vector (the points past the row's end
    // stay zero).  z: the group's normals; lo, buf: the row block's coarse rows.
    auto form_group = [&](int i, int g, const float* z, int lo, const float* buf) {
        const int slot = (i & rmask) * pitch + 4 * g;
        float4* xv = reinterpret_cast<float4*>(xr + slot);
        float4* cv = reinterpret_cast<float4*>(cr + slot);
        float xs[4], cs[4];
        {
            const float4 a = *xv, c = *cv;
            xs[0] = a.x; xs[1] = a.y; xs[2] = a.z; xs[3] = a.w;
            cs[0] = c.x; cs[1] = c.y; cs[2] = c.z; cs[3] = c.w;
        }
        float ca[3], cb[3];  // coarse columns 2g-1 .. 2g+1 of the rows P x_c reads
        if (!DESCEND) {
            // odd fine i takes coarse row (i-1)/2 with weight 1, even i the
            // coarse rows i/2 - 1 and i/2 with 0.5 each (a zero row outside)
            const int Ia = (i - 1) >> 1;
            const float* ra = (Ia >= 0) ? buf + (Ia - lo) * xcp : zrow;
            const float* rb = (Ia + 1 < Hc) ? buf + (Ia + 1 - lo) * xcp : zrow;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
                ca[d] = ra[2 * g - 1 + d];
                cb[d] = rb[2 * g - 1 + d];
            }
        }
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
            const int j = 4 * g + q4;
            if (j >= W) {
                xs[q4] = cs[q4] = 0.0f;
                continue;
            }
            const int p = i * W + j;
            if (!DESCEND) {
                const int d = (q4 + 1) >> 1;  // coarse column (j - 1) >> 1 = 2g - 1 + d
                float px;
                if (i & 1) {
                    float row = 0.0f;
                    if (j & 1) row += 1.0f * ca[d];
                    else { row += 0.5f * ca[d]; row += 0.5f * ca[d + 1]; }
                    px = 0.0f;
                    px += 1.0f * row;
                } else {
                    float ra = 0.0f, rb = 0.0f;
                    if (j & 1) { ra += 1.0f * ca[d]; rb += 1.0f * cb[d]; }
                    else {
                        ra += 0.5f * ca[d]; ra += 0.5f * ca[d + 1];
                        rb += 0.5f * cb[d]; rb += 0.5f * cb[d + 1];
                    }
                    px = 0.0f;
                    px += 0.5f * ra;
                    px += 0.5f * rb;
                }
                xs[q4] = xs[q4] + P.gamma * px;
            }
            if (P.noise_mode) {
                const float zq = (P.noise_mode == 2) ? xi[p] : z[q4];
                cs[q4] = cs[q4] + (P.ns_const ? P.ns_val : ns[p]) * zq;
            }
        }
        if (!DESCEND) *xv = make_float4(xs[0], xs[1], xs[2], xs[3]);
        *cv = make_float4(cs[0], cs[1], cs[2], cs[3]);
    };

    // row block b: a forming thread takes the groups ftid, ftid + nfm, ... two at
    // a time, their Philox chains side by side
    auto form = [&](int b) {
        if (ftid < 0) return;
        const int r0 = b * STREAM_ROWS, total = min(STREAM_ROWS, H - r0) * Gw;
        const int lo = max((r0 - 1) >> 1, 0);
        const float* buf = xcb + (b % (STREAM_PREFETCH + 2)) * xcbuf;
        int rr = g_rr0, g = g_g0;
        for (int q = ftid; q < total; q += 2 * nfm) {
            int rr2 = rr, g2 = g + nfm;
            for (; g2 >= Gw; g2 -= Gw) ++rr2;
            const bool second = q + nfm < total;
            const int i = r0 + rr, i2 = second ? r0 + rr2 : i, gb = second ? g2 : g;
            float z[4] = {0.0f, 0.0f, 0.0f, 0.0f}, z2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (P.noise_mode == 1) {
                philox_normals4((uint32_t)(i * Gw + g), (uint32_t)chain, P.seed, P.counter, z);
                philox_normals4((uint32_t)(i2 * Gw + gb), (uint32_t)chain, P.seed, P.counter, z2);
            }
            form_group(i, g, z, lo, buf);
            if (second) form_group(i2, gb, z2, lo, buf);
            for (g = g2 + nfm, rr = rr2; g >= Gw; g -= Gw) ++rr;
        }
    };

    // row block b is final: store it and add its share of B^T x to the
    // per-warp sums (every warp runs the shuffles: the loop bounds are uniform)
    auto write_back = [&](int b) {
        const int r0 = b * STREAM_ROWS, rows = min(STREAM_ROWS, H - r0);
        int mk = 0;
        for (int i = r0; i < r0 + rows; ++i) {
            mk |= s_mask[i];
            const float* row = xr + (i & rmask) * pitch;
            for (int j = tid; j < W; j += nth) x[i * W + j] = row[j];
        }
        for (int bits = mk; bits; bits &= bits - 1) {
            const int k = __ffs(bits) - 1;
            const int i0 = max(P.bbox[k][0], r0), i1 = min(P.bbox[k][1], r0 + rows);
            const int j0 = P.bbox[k][2], bw = P.bbox[k][3] - j0;
            float acc = 0.0f;
            for (int q = tid; q < (i1 - i0) * bw; q += nth) {
                const int i = i0 + q / bw, j = j0 + q % bw;
                acc += xr[(i & rmask) * pitch + j] * B[(size_t)k * n + i * W + j];
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
            if (lane == 0) part[k * L.nwarps + warp] += acc;
        }
    };

    // the sweep: each sweeping thread belongs to one colour phase and updates,
    // per round, one point in each row of that phase's row block
    const int tp = nsw / P.n_order;  // threads per phase
    const int my_o = tid < nsw ? tid / tp : MAX_COLORS, my_t = tid % tp;
    int my_lag = 0, my_colour_ok = 0;
#pragma unroll
    for (int o = 0; o < MAX_COLORS; ++o)
        if (o == my_o && o < P.n_order) { my_lag = S.lag[o]; my_colour_ok = 1; }
    const int jt0 = P.jstride * my_t, jstep = P.jstride * tp;
    int rm = 0;  // (first row of this thread's block) % K, from the block 0 on
    auto sweep_step = [&](int s) {
        const int b = s - my_lag;
        if (!my_colour_ok || b < 0 || b >= nblocks) return;
        const int r0 = b * STREAM_ROWS;
        int j0[STREAM_ROWS];  // the row's first point of this colour (-1: none)
#pragma unroll
        for (int rr = 0; rr < STREAM_ROWS; ++rr) {
            j0[rr] = (r0 + rr < H) ? s_j0[rm * MAX_COLORS + my_o] : -1;
            if (++rm == P.n_colors) rm = 0;
        }
        // x's rows r0 - 1 .. r0 + STREAM_ROWS (the zero row outside the field);
        // the block's own rows are consecutive in the ring
        const int slot0 = (r0 & rmask) * pitch;
        const float* rowp[STREAM_ROWS + 2];
        rowp[0] = r0 > 0 ? xr + ((r0 - 1) & rmask) * pitch : zrow;
#pragma unroll
        for (int rr = 0; rr < STREAM_ROWS; ++rr)
            rowp[rr + 1] = r0 + rr < H ? xr + slot0 + rr * pitch : zrow;
        rowp[STREAM_ROWS + 1] =
            r0 + STREAM_ROWS < H ? xr + ((r0 + STREAM_ROWS) & rmask) * pitch : zrow;
        for (int jt = jt0;; jt += jstep) {
            // every load and product of the round first, then the divisions
            float num[STREAM_ROWS], old[STREAM_ROWS], dg[STREAM_ROWS];
            bool any = false;
#pragma unroll
            for (int rr = 0; rr < STREAM_ROWS; ++rr) {
                const int j = j0[rr] + jt;
                const bool live = j0[rr] >= 0 && j < W;
                any |= live;
                const int jc = live ? j : 0;
                const int p = min(r0 + rr, H - 1) * W + jc;  // a point of the field
                const float ax = stencil_rows<KMAX, CONST>(P, coeffs, rowp[rr], rowp[rr + 1],
                                                           rowp[rr + 2], jc, n, p);
                dg[rr] = diag_at<CONST>(P, diag, coeffs, n, p);
                old[rr] = rowp[rr + 1][jc];
                num[rr] = P.omega * (cr[slot0 + rr * pitch + jc] - ax);
            }
            if (!any) break;
#pragma unroll
            for (int rr = 0; rr < STREAM_ROWS; ++rr) {
                const int j = j0[rr] + jt;
                const float v = old[rr] + num[rr] / dg[rr];
                if (j0[rr] >= 0 && j < W) xr[slot0 + rr * pitch + j] = v;
            }
        }
    };

    // ---------------------------------------------------------- pass 1
    // step s: form row block s + 2, write back s - max_lag - 1, issue the loads
    // of block s + 3 + PREFETCH, sweep, wait for block s + 3's loads, barrier
    __syncthreads();  // the zero columns before any load lands beside them
    for (int t = -3 - STREAM_PREFETCH; t <= -3; ++t) issue(t);
    cp_async_wait<0>();
    __syncthreads();  // blocks 0 .. PREFETCH; s_j0, s_mask, part, s_lr
    const int last = nblocks - 1 + S.max_lag;
    int written = 0;
    for (int s = -2; s <= last; ++s) {
        if (s + 2 < nblocks) form(s + 2);
        const int wb = s - S.max_lag - 1;
        if (wb >= 0 && wb < nblocks) {
            write_back(wb);
            written = wb + 1;
        }
        issue(s);
        sweep_step(s);
        cp_async_wait<STREAM_PREFETCH>();
        __syncthreads();
    }
    for (int b = written; b < nblocks; ++b) write_back(b);
    cp_async_wait<0>();
    __syncthreads();

    // ---------------------------------------------------------- Woodbury
    if (P.m) {
        if (tid < P.m) {
            float v = 0.0f;
            for (int w = 0; w < L.nwarps; ++w) v += part[tid * L.nwarps + w];
            // B^T x - Sigma^1/2 n (woodbury_pass)
            s_btx[tid] = v - sroot[tid] * (P.noise_mode ? s_lr[tid] : 0.0f);
        }
        __syncthreads();
        if (tid < P.m) {
            const int l = tid;
            float u = 0.0f;
            for (int k = 0; k < P.m; ++k) u += Wm[l * P.m + k] * s_btx[k];
            s_u[l] = u;
        }
        __syncthreads();
        for (int l = 0; l < P.m; ++l) {
            const int i0 = P.ybox[l][0], j0 = P.ybox[l][2];
            const int bh = P.ybox[l][1] - i0, bw = P.ybox[l][3] - j0;
            for (int q = tid; q < bh * bw; q += nth) {
                const int p = (i0 + q / bw) * W + j0 + q % bw;
                x[p] -= s_u[l] * Y[(size_t)l * n + p];
            }
            __syncthreads();
        }
        if (DESCEND) {  // t = u + Sigma^-1/2 n = Sigma^-1 B^T x, as level_descend
            if (tid < P.m)
                s_lr[tid] = s_u[tid] + (P.noise_mode ? s_lr[tid] : 0.0f) / sroot[tid];
            __syncthreads();
        }
    }
    if (!DESCEND) return;

    // ---------------------------------------------------------- pass 2
    // tile t: coarse rows I0 .. I0 + TILE - 1, residual rows 2 I0 .. 2 I0 + 2 TILE,
    // x rows 2 I0 - 1 .. 2 I0 + 2 TILE + 1; rows outside the field are zeros
    float* fc = fc_all + (size_t)chain * Hc * Wc;
    const int ntiles = (Hc + STREAM_TILE - 1) / STREAM_TILE;
    auto xtile = [&](int b) { return smem + b * XTILE_ROWS * pitch + STREAM_COL0; };
    auto rtile = [&](int b) {
        return smem + (2 * XTILE_ROWS + b * RTILE_ROWS) * pitch + STREAM_COL0;
    };
    auto issue_tile = [&](int t) {
        const int I0 = t * STREAM_TILE;
        float* xt = xtile(t & 1);
        float* rt = rtile(t & 1);
        for (int a = 0; a < XTILE_ROWS; ++a) {
            const int i = 2 * I0 - 1 + a;
            const bool in = i >= 0 && i < H;
            for (int j = tid; j < W; j += nth) {
                if (in) cp_async4(xt + a * pitch + j, x + i * W + j);
                else xt[a * pitch + j] = 0.0f;
            }
        }
        for (int a = 0; a < RTILE_ROWS; ++a) {
            const int i = 2 * I0 + a;
            for (int j = tid; j < W; j += nth) {
                if (i < H) cp_async4(rt + a * pitch + j, f + i * W + j);
                else rt[a * pitch + j] = 0.0f;
            }
        }
        cp_async_commit();
    };
    if (ntiles == 0) return;
    issue_tile(0);
    const int fc_I0 = tid / Wc, fc_J0 = tid % Wc;
    for (int t = 0; t < ntiles; ++t) {
        cp_async_wait<0>();
        __syncthreads();  // tile t has landed; tile t - 1's buffers are free
        if (t + 1 < ntiles) issue_tile(t + 1);
        const int I0 = t * STREAM_TILE, nI = min(STREAM_TILE, Hc - I0);
        const float* xt = xtile(t & 1);
        float* rt = rtile(t & 1);
        // r = f - A x (in place over f), then - sum_k t_k B_k point by point;
        // a thread's points of the tile's rows computed before any is stored
        const int nr = min(2 * nI + 1, H - 2 * I0);
        const int a0 = tid < nsw ? 0 : (RTILE_ROWS + 1) / 2;
        for (int j = tid < nsw ? tid : ftid; j < W; j += nsw) {
            constexpr int NA = (RTILE_ROWS + 1) / 2;  // rows a0 .. a0 + NA - 1
            float rv[NA];
#pragma unroll
            for (int q = 0; q < NA; ++q) {
                const int a = min(a0 + q, RTILE_ROWS - 1);
                const int p = min(2 * I0 + a, H - 1) * W + j;
                rv[q] = rt[a * pitch + j] -
                        stencil_rows<KMAX, CONST>(P, coeffs, xt + a * pitch, xt + (a + 1) * pitch,
                                                  xt + (a + 2) * pitch, j, n, p);
            }
#pragma unroll
            for (int q = 0; q < NA; ++q) {
                const int a = a0 + q, i = 2 * I0 + a;
                if (a >= nr) break;
                float v = rv[q];
                for (int bits = s_mask[i]; bits; bits &= bits - 1) {
                    const int k = __ffs(bits) - 1;
                    if (j >= P.bbox[k][2] && j < P.bbox[k][3])
                        v += -1.0f * s_lr[k] * B[(size_t)k * n + i * W + j];
                }
                rt[a * pitch + j] = v;
            }
        }
        __syncthreads();
        // f_c[I, J] = sum_{a, b} w_a w_b r[2I+1+a, 2J+1+b], w = {0.5, 1, 0.5}
        // (zeros outside the field)
        int Io = fc_I0, J = fc_J0;
        for (int q = tid; q < nI * Wc; q += nth) {
            const float* r3 = rt + 2 * Io * pitch + 2 * J;  // r[2I, 2J] of the tile
            float acc = 0.0f;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                float row = 0.0f;
                row += 0.5f * r3[a * pitch];
                row += 1.0f * r3[a * pitch + 1];
                row += 0.5f * r3[a * pitch + 2];
                acc += (a == 1 ? 1.0f : 0.5f) * row;
            }
            fc[(I0 + Io) * Wc + J] = acc;
            for (J += nth; J >= Wc; J -= Wc) ++Io;
        }
    }
}

// ------------------------------------------------------------ C entry points
extern "C" int mgmc_stream_params_size() { return (int)sizeof(StreamParams); }

// Dynamic shared memory of a launch (bytes), for the host's mirror
// (mgmc_visit.py::stream_smem_bytes), which decides the route before any launch.
extern "C" int mgmc_stream_smem_bytes(const StreamParams* S, int ascend, int threads) {
    return (int)sizeof(float) * stream_layout(*S, ascend, threads).floats;
}

// The largest static shared memory of the kernel's instantiations (bytes), or
// -1 if the runtime cannot say.
extern "C" int mgmc_stream_static_smem_bytes() {
    const void* kernels[] = {
        (const void*)stream_visit_kernel<true, 5, true>,
        (const void*)stream_visit_kernel<true, 5, false>,
        (const void*)stream_visit_kernel<true, MAX_OFFSETS, true>,
        (const void*)stream_visit_kernel<true, MAX_OFFSETS, false>,
        (const void*)stream_visit_kernel<false, 5, true>,
        (const void*)stream_visit_kernel<false, 5, false>,
        (const void*)stream_visit_kernel<false, MAX_OFFSETS, true>,
        (const void*)stream_visit_kernel<false, MAX_OFFSETS, false>};
    int most = 0;
    for (const void* k : kernels) {
        cudaFuncAttributes a;
        if (cudaFuncGetAttributes(&a, k) != cudaSuccess) {
            cudaGetLastError();
            return -1;
        }
        most = a.sharedSizeBytes > (size_t)most ? (int)a.sharedSizeBytes : most;
    }
    return most;
}

template <bool DESCEND, int KMAX, bool CONST>
static int launch_stream(const StreamParams* S, int threads, int bytes, cudaStream_t stream,
                         float* x, const float* f, float* fc, const float* xc,
                         const float* coeffs, const float* ns, const float* B, const float* Y,
                         const float* Wm, const float* xilr, const float* sroot,
                         const float* xi) {
    auto kernel = stream_visit_kernel<DESCEND, KMAX, CONST>;
    static int granted = 48 * 1024;  // per instantiation: what the kernel may use
    if (bytes > granted) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             bytes);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
        granted = bytes;
    }
    kernel<<<S->v.C, threads, bytes, stream>>>(*S, x, f, fc, xc, coeffs, ns, B, Y, Wm, xilr,
                                               sroot, xi);
    return (int)cudaGetLastError();
}

// the instantiation for the level: 5 or 9 offsets, all coefficient planes
// constant (in registers) or not
template <bool DESCEND>
static int dispatch(const StreamParams* S, int threads, cudaStream_t stream, float* x,
                    const float* f, float* fc, const float* xc, const float* coeffs,
                    const float* ns, const float* B, const float* Y, const float* Wm,
                    const float* xilr, const float* sroot, const float* xi) {
    const VisitParams& P = S->v;
    if (threads < 64 || threads > MAX_STREAM_THREADS || threads % 64 || threads / 2 < P.n_order ||
        P.K < 1 || P.K > MAX_OFFSETS || P.m < 0 || P.m > STREAM_MAX_LOWRANK)
        return (int)cudaErrorInvalidValue;
    bool all_const = true;
    for (int k = 0; k < P.K; ++k) all_const = all_const && P.coeff_const[k];
    const int bytes = (int)sizeof(float) * stream_layout(*S, !DESCEND, threads).floats;
#define STREAM_LAUNCH(KM, CO)                                                              \
    return launch_stream<DESCEND, KM, CO>(S, threads, bytes, stream, x, f, fc, xc, coeffs, \
                                          ns, B, Y, Wm, xilr, sroot, xi)
    if (P.K <= 5) {
        if (all_const) STREAM_LAUNCH(5, true);
        STREAM_LAUNCH(5, false);
    }
    if (all_const) STREAM_LAUNCH(MAX_OFFSETS, true);
    STREAM_LAUNCH(MAX_OFFSETS, false);
#undef STREAM_LAUNCH
}

extern "C" int mgmc_stream_descend(const StreamParams* S, float* x, const float* f, float* fc,
                                   const float* coeffs, const float* ns, const float* B,
                                   const float* Y, const float* Wm, const float* xilr,
                                   const float* sroot, const float* xi, int threads,
                                   void* stream) {
    return dispatch<true>(S, threads, (cudaStream_t)stream, x, f, fc, nullptr, coeffs, ns, B, Y,
                          Wm, xilr, sroot, xi);
}

extern "C" int mgmc_stream_ascend(const StreamParams* S, float* x, const float* f,
                                  const float* xc, const float* coeffs, const float* ns,
                                  const float* B, const float* Y, const float* Wm,
                                  const float* xilr, const float* sroot, const float* xi,
                                  int threads, void* stream) {
    return dispatch<false>(S, threads, (cudaStream_t)stream, x, f, nullptr, xc, coeffs, ns, B,
                           Y, Wm, xilr, sroot, xi);
}
