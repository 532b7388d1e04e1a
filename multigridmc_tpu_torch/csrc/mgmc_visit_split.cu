// Fused MGMC level-visit kernels for few chains, NVIDIA Hopper (sm_90a),
// float32, 2d: each chain's level split over a thread-block cluster, its bands
// in shared memory (the "split" route).
//
// Replace, like mgmc_visit.cu and mgmc_visit_stream.cu, the Pallas kernels
// descend_visit and ascend_visit of
// multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py, and compute what
// level_descend / level_ascend of level_passes.cuh compute, from the same
// parameter block (VisitParams, one per sweep direction: SplitParams) and the
// same noise modes (0 off, 1 in-kernel Philox, 2 xi read from memory), with one
// directed sweep (SOR) or two, forward then backward (SSOR), each d with fresh
// noise xi_d, n_d:
//
//   descend:  c   = f + sqrt(D(2-w)/w) xi_d                       (Gibbs rhs)
//             x  <- colour-ordered SOR sweep(c, x)
//             x  <- x - sum_l u_l Y_l,  u = W (B^T x - Sigma^1/2 n_d)   (Woodbury)
//             r   = f - A_stencil x - sum_k t_k B_k,  t = u + Sigma^-1/2 n_d
//             f_c = R r                          (full weighting; after the last d)
//   ascend:   x  <- x + gamma P x_c,  then per direction c, sweep, Woodbury
//
// Why a third design.  The phase kernels run one block per chain: at one
// chain (the drivers' time series) 131 of the 132 SMs are idle, and the block
// walks whole-field passes from L2 with a block barrier after each - some
// 0.16-0.21 ms per visit at 255^2 whatever the chain count up to 64 (their
// design before the passes of level_passes.cuh), which is latency, against a
// byte bound under a microsecond.  The stream kernels
// (one block per chain as well) pay off only where many chains fill the card.
//
// Design: the band scheme of sor_sweep_cluster.cu carried over to the whole
// visit.  A chain is split over a cluster of S blocks (S = 2 .. 16, the
// cluster dimension of the launch; 16 needs
// cudaFuncAttributeNonPortableClusterSizeAllowed).  Block k of the cluster owns
// the band of rows band_of(H, S, k), one contiguous span of the chain's field:
//   1. it copies its band of x into dynamic shared memory once (4-byte
//      cp.async: rows of 255 floats start only 4-byte aligned) and forms the
//      rhs c in a scratch band beside it, by Philox point groups with the
//      counter layout of rhs_pass (group i * ceil(W / 4) + g, then chain, then
//      launch counter, key seed ^ PHILOX_KEY_MIX; a group lies in one row, so
//      in one band: the same normals as the other two routes); the ascend
//      adds gamma P x_c to its band first (x_c read from global memory); the
//      low-rank noise enters the Woodbury correction (level_passes.cuh);
//   2. it runs every colour phase on its band: a neighbour row outside the
//      band (the reach is 1) is read from the neighbouring rank's shared
//      memory (cluster.map_shared_rank); cluster.sync() stands between the
//      phases and is the only synchronisation between blocks;
//   3. Woodbury: one warp per column k sums <B_k, x> over band and bbox[k];
//      after a cluster.sync() every block reads the S partial vectors in rank
//      order and sums them in that order, then forms u = W (B^T x - Sigma^1/2
//      n) itself, so every block holds the same u bit for bit, without
//      atomics; it patches x -= u_l Y_l over band and ybox[l], column after
//      column as woodbury_pass (each point has one owner, so the order of its
//      updates is kept).  A second direction repeats 1-3 on the band in
//      shared memory (its rhs, a cluster.sync(), its colour phases and its
//      correction); after the last the band goes back to global memory once,
//      coalesced;
//   4. descend: after a cluster.sync() the residual r = f - A x (halo rows of
//      x from the neighbours) replaces c in the scratch band, with its
//      low-rank term t = u + Sigma^-1/2 n of the last direction; after another, the
//      restriction: coarse row I belongs to the block that owns fine row
//      2I + 1, whose rows 2I and 2I + 2 may lie in the neighbouring bands and
//      are read there;
//   5. a last cluster.sync() before any block exits: no block leaves while
//      another still reads its shared memory.
// Cluster barriers per visit: per direction n_order + 1 (one fewer without
// measurements), a descend 2 more, and the last: descend n_order + 4, ascend
// n_order + 2 with one direction, 2 n_order + 5 and 2 n_order + 3 with two.  Each point does the arithmetic of
// level_passes.cuh on the same values, in the same order; only B^T x is summed
// in another order (per band, then over the bands), so under one Philox stream
// the routes agree to float32 rounding.
//
// Measurements.  The low-rank vectors (each band's share of B^T x, every
// rank's, B^T x - Sigma^1/2 n, the normals, u and t) are the block's: up to
// LANE_SLOTS (32) entries in static shared memory, a thread an entry, the
// boxes in the parameter block.  A level of more takes the kernels compiled
// with LR: the vectors after the bands in dynamic shared memory, (S + 4) m
// floats (mgmc_split_smem_bytes), the block's threads taking the entries in
// turn and its warps the rows of u = W v, lanes along a row; the boxes from
// the level's device tables (boxes0, boxes1: B's, then the direction's Y's).
//
// The host (ops/kernels/mgmc_visit.py, visit_route) takes this route for few
// chains where the bands fit a block's shared memory (mgmc_split_smem_bytes;
// split_smem_bytes is the host's mirror) and the cluster schedules
// (mgmc_split_max_active), with the cluster size of least wave-counted cost.
//
// Bound: as mgmc_visit.cu, bytes (per chain x read and written, f read, f_c
// written or x_c read): under a microsecond at one chain of 255^2, so a visit
// of one chain is latency - the band's load, the Philox draws, the cluster
// barriers and their distributed shared-memory reads, the write.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "visit_phases.cuh"

namespace cg = cooperative_groups;

#define MAX_CLUSTER 16
// the sweep directions of a launch: one (SOR) or two (SSOR)
#define MAX_DIRS 2
// the first-point table before the bands: j0 of (direction, order index, row
// colour base)
#define SPLIT_TABLE_INTS (MAX_DIRS * MAX_COLORS * MAX_COLORS)

// A launch's parameter blocks, one per sweep direction: the same level, each
// with its colour order, its Y boxes and its Philox counter.
struct SplitParams {
    VisitParams v[MAX_DIRS];
    int ndir;
};

// rows of the widest band of an H-row field over S blocks
__host__ __device__ inline int split_band_rows(int H, int S) { return (H + S - 1) / S; }

// first row and number of rows of rank k: the first H % S ranks take one more
__device__ __forceinline__ void band_of(int H, int S, int k, int* u0, int* nb) {
    const int base = H / S, rem = H % S;
    *nb = base + (k < rem ? 1 : 0);
    *u0 = k * base + (k < rem ? k : rem);
}

// ------------------------------------------------------------ cp.async, 4 B
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// ------------------------------------------------------------------ helpers
// Row i of a field held in bands: this block's [u0, u1), the lower
// neighbour's band from row lo0, the upper neighbour's from row u1.
__device__ __forceinline__ const float* band_row(int i, int u0, int u1, int lo0, int W,
                                                 const float* own, const float* lo,
                                                 const float* hi) {
    return i < u0 ? lo + (i - lo0) * W : (i >= u1 ? hi + (i - u1) * W : own + (i - u0) * W);
}

// (A_stencil x)[i, j] with x in bands, zero-Dirichlet, accumulated in offset
// order (stencil_at of visit_phases.cuh)
__device__ __forceinline__ float band_stencil(const VisitParams& P,
                                              const float* __restrict__ coeffs, int i, int j,
                                              int n, int p, int u0, int u1, int lo0,
                                              const float* own, const float* lo,
                                              const float* hi) {
    float ax = 0.0f;
    for (int k = 0; k < P.K; ++k) {
        const int ii = i + P.dy[k], jj = j + P.dx[k];
        if (ii >= 0 && ii < P.H && jj >= 0 && jj < P.W)
            ax += coeff_at(P, coeffs, k, n, p) * band_row(ii, u0, u1, lo0, P.W, own, lo, hi)[jj];
    }
    return ax;
}

// dst[p - u0 W] += sign * s_coef[k] * F_k[p] over box k and the band's rows
// [u0, u1), one column after the other (the boxes may overlap, so a block
// barrier stands before every column that meets the band); ends with a barrier
__device__ void band_lowrank(const VisitParams& P, const int (*box)[4],
                             const float* __restrict__ F, const float* s_coef, float sign,
                             float* dst, int u0, int u1) {
    const int n = P.H * P.W, first = u0 * P.W;
    for (int k = 0; k < P.m; ++k) {
        const int i0 = max(box[k][0], u0), i1 = min(box[k][1], u1);
        const int j0 = box[k][2], bw = box[k][3] - j0;
        if (i0 >= i1 || bw <= 0) continue;  // the same answer for the whole block
        __syncthreads();
        for (int q = threadIdx.x; q < (i1 - i0) * bw; q += blockDim.x) {
            const int p = (i0 + q / bw) * P.W + j0 + q % bw;
            dst[p - first] += sign * s_coef[k] * F[(size_t)k * n + p];
        }
    }
    __syncthreads();
}

// ------------------------------------------------------------------- kernel
// NDIR: the sweeps of a visit (1 SOR, 2 SSOR), a kernel each, so that a
// one-sweep visit compiles to straight-line phases.  LR: a level of more than
// LANE_SLOTS measurements.
template <bool DESCEND, int NDIR, bool LR>
__global__ void __launch_bounds__(MAX_THREADS)
split_visit_kernel(const __grid_constant__ SplitParams SP, float* x_all,
                   const float* __restrict__ f_all, float* fc_all,
                   const float* __restrict__ xc_all, const float* __restrict__ coeffs,
                   const float* __restrict__ ns, const float* __restrict__ B,
                   const float* __restrict__ Y0, const float* __restrict__ W0,
                   const float* __restrict__ Y1, const float* __restrict__ W1,
                   const float* __restrict__ xilr, const float* __restrict__ sroot,
                   const float* __restrict__ xi_all, const int* __restrict__ boxes0,
                   const int* __restrict__ boxes1) {
    extern __shared__ __align__(16) float smem[];
    __shared__ float s_part[LANE_SLOTS];               // this band's share of B^T x
    __shared__ float s_all[MAX_CLUSTER * LANE_SLOTS];  // every rank's share, rank by rank
    __shared__ float s_btx[LANE_SLOTS];
    __shared__ float s_lr[LANE_SLOTS];
    __shared__ float s_u[LANE_SLOTS];
    cg::cluster_group cluster = cg::this_cluster();
    const VisitParams& P = SP.v[0];  // what the directions share
    constexpr int ndir = NDIR;
    const int S = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int chain = blockIdx.x / S;
    const int H = P.H, W = P.W, n = H * W, m = P.m;
    const int tid = threadIdx.x, nthreads = blockDim.x;

    int u0, nb, lo0, lo_nb;
    band_of(H, S, rank, &u0, &nb);
    band_of(H, S, rank > 0 ? rank - 1 : rank, &lo0, &lo_nb);
    const int u1 = u0 + nb;
    const int first = u0 * W, count = nb * W;

    int* j0tab = reinterpret_cast<int*>(smem);
    float* xs = smem + SPLIT_TABLE_INTS;
    float* cs = xs + split_band_rows(H, S) * W;  // c, then (descend) r
    // the low-rank vectors (LR: after the bands) and the boxes (LR: the
    // device tables, B's then each direction's Y's)
    float* lrs = cs + split_band_rows(H, S) * W;
    float* part = LR ? lrs : s_part;
    float* all = LR ? lrs + m : s_all;
    float* btx = LR ? lrs + (S + 1) * m : s_btx;
    float* lrv = LR ? lrs + (S + 2) * m : s_lr;
    float* uv = LR ? lrs + (S + 3) * m : s_u;
    const int(*bbx)[BOX_INTS] = reinterpret_cast<const int(*)[BOX_INTS]>(boxes0);

    float* x = x_all + (size_t)chain * n;
    const float* f = f_all + (P.f_batched ? (size_t)chain * n : 0);
    const float* nlr = P.noise_mode ? xilr + (size_t)chain * ndir * m : nullptr;

    // 1. the band of x into shared memory; the table of first points
    for (int i = tid; i < count; i += nthreads) cp_async4(xs + i, x + first + i);
    cp_async_commit();
    if (tid < ndir * P.n_order * P.n_colors) {
        const int d = tid / (P.n_order * P.n_colors), q = tid - d * P.n_order * P.n_colors;
        const int o = q / P.n_colors, base = q - o * P.n_colors;
        const int ci = SP.v[d].order[o];
        int j0 = -1;
        for (int jj = 0; jj < P.jstride; ++jj)
            if ((base + P.w1 * jj) % P.n_colors == ci) { j0 = jj; break; }
        j0tab[(d * MAX_COLORS + o) * MAX_COLORS + base] = j0;
    }
    cp_async_wait_all();

    const float* xlo = cluster.map_shared_rank(xs, rank > 0 ? rank - 1 : rank);
    const float* xhi = cluster.map_shared_rank(xs, rank + 1 < S ? rank + 1 : rank);
    const int G4 = (W + 3) >> 2;
    const int s = P.jstride;
    const int Gs = (W + s - 1) / s;  // candidate points of a colour per row
#pragma unroll 1
    for (int d = 0; d < ndir; ++d) {
        const VisitParams& Pd = SP.v[d];
        const float* xi = P.noise_mode == 2 ? xi_all + ((size_t)d * P.C + chain) * n : nullptr;
        // the direction's low-rank normals (the last direction's lrv and uv
        // were read before the previous barrier)
        if constexpr (LR) {
            if (P.noise_mode)
                for (int t = tid; t < m; t += nthreads) lrv[t] = nlr[(size_t)d * m + t];
        } else if (P.noise_mode && tid < m) {
            s_lr[tid] = nlr[(size_t)d * m + tid];
        }
        __syncthreads();

        //    the rhs (rhs_pass): ascend x += gamma P x_c (first direction), then
        //    c = f + ns xi
        const float* xc = (DESCEND || d > 0) ? nullptr : xc_all + (size_t)chain * P.Hc * P.Wc;
        for (int t = tid; t < nb * G4; t += nthreads) {
            const int lr = t / G4, g = t - lr * G4;
            const int i = u0 + lr;
            float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (P.noise_mode == 1)
                philox_normals4((uint32_t)(i * G4 + g), (uint32_t)chain, Pd.seed, Pd.counter, z);
            // (P x_c)[i, j]: an odd fine index 2I+1 takes coarse I with weight 1,
            // an even one its two coarse neighbours with 0.5 each
            const int nI = (i & 1) ? 1 : 2, Ia = (i >> 1) - (nI - 1);
            const float wi = (i & 1) ? 1.0f : 0.5f;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int j = 4 * g + q;
                if (j >= W) break;
                const int p = i * W + j;
                if (xc != nullptr) {
                    const int nJ = (j & 1) ? 1 : 2, Ja = (j >> 1) - (nJ - 1);
                    const float wj = (j & 1) ? 1.0f : 0.5f;
                    float px = 0.0f;
                    for (int a = 0; a < nI; ++a) {
                        const int I = Ia + a;
                        if (I < 0 || I >= P.Hc) continue;
                        float row = 0.0f;
                        for (int b = 0; b < nJ; ++b) {
                            const int J = Ja + b;
                            if (J < 0 || J >= P.Wc) continue;
                            row += wj * xc[I * P.Wc + J];
                        }
                        px += wi * row;
                    }
                    xs[p - first] = xs[p - first] + P.gamma * px;
                }
                float c = f[p];
                if (P.noise_mode) {
                    const float zq = (P.noise_mode == 2) ? xi[p] : z[q];
                    c = f[p] + (P.ns_const ? P.ns_val : ns[p]) * zq;
                }
                cs[p - first] = c;
            }
        }
        // every band formed (and corrected by the previous direction), and every
        // block of the cluster running, before any block reads a neighbour's
        // shared memory
        cluster.sync();

        // 2. the colour phases on the band (sweep_colours)
        for (int o = 0; o < P.n_order; ++o) {
            if (o) cluster.sync();  // the phase before done on every band
            for (int t = tid; t < nb * Gs; t += nthreads) {
                const int lr = t / Gs, kk = t - lr * Gs;
                const int i = u0 + lr;
                const int j0 = j0tab[(d * MAX_COLORS + o) * MAX_COLORS + (P.w0 * i) % P.n_colors];
                const int j = j0 + s * kk;
                if (j0 < 0 || j >= W) continue;  // no point of the colour here
                const int p = i * W + j;
                const float ax = band_stencil(P, coeffs, i, j, n, p, u0, u1, lo0, xs, xlo, xhi);
                const float diag = coeff_at(P, coeffs, P.diag_index, n, p);
                xs[p - first] = xs[p - first] + P.omega * (cs[p - first] - ax) / diag;
            }
        }
        __syncthreads();  // this band's last phase done

        // 3. Woodbury
        if (m) {
            const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
            for (int k = warp; k < m; k += nwarps) {
                const int i0 = max(BOX_OF(LR, bbx, P.bbox, k)[0], u0);
                const int i1 = min(BOX_OF(LR, bbx, P.bbox, k)[1], u1);
                const int j0 = BOX_OF(LR, bbx, P.bbox, k)[2];
                const int bw = BOX_OF(LR, bbx, P.bbox, k)[3] - j0;
                float acc = 0.0f;
                if (i0 < i1 && bw > 0) {
                    for (int q = lane; q < (i1 - i0) * bw; q += 32) {
                        const int p = (i0 + q / bw) * W + j0 + q % bw;
                        acc += xs[p - first] * B[(size_t)k * n + p];
                    }
                }
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
                if (lane == 0) part[k] = acc;
            }
            cluster.sync();  // every band's share of B^T x
            for (int t = tid; t < S * m; t += nthreads) {
                const int r = t / m;
                all[t] = cluster.map_shared_rank(part, r)[t - r * m];
            }
            __syncthreads();
            const float* Wd = d ? W1 : W0;
            if constexpr (LR) {
                for (int t = tid; t < m; t += nthreads) {
                    // the shares in rank order: the same sum in every block
                    float v = 0.0f;
                    for (int r = 0; r < S; ++r) v += all[r * m + t];
                    // B^T x - Sigma^1/2 n (woodbury_pass)
                    btx[t] = v - sroot[t] * (P.noise_mode ? lrv[t] : 0.0f);
                }
                __syncthreads();
                // u = W (...), a warp a row in turn (band_lowrank's first
                // barrier publishes it)
                for (int r = warp; r < m; r += nwarps) {
                    float acc = 0.0f;
                    for (int k = lane; k < m; k += 32) acc += Wd[(size_t)r * m + k] * btx[k];
                    acc = warp_total(acc);
                    if (lane == 0) uv[r] = acc;
                }
            } else {
                if (tid < m) {  // the shares in rank order: the same sum in every block
                    float v = 0.0f;
                    for (int r = 0; r < S; ++r) v += s_all[r * m + tid];
                    // B^T x - Sigma^1/2 n (woodbury_pass)
                    s_btx[tid] = v - sroot[tid] * (P.noise_mode ? s_lr[tid] : 0.0f);
                }
                __syncthreads();
                if (tid < m) {
                    float u = 0.0f;
                    for (int k = 0; k < m; ++k) u += Wd[tid * m + k] * s_btx[k];
                    s_u[tid] = u;
                }
            }
            const int(*ybx)[BOX_INTS] =
                reinterpret_cast<const int(*)[BOX_INTS]>(d ? boxes1 : boxes0) + m;
            band_lowrank(Pd, LR ? ybx : Pd.ybox, d ? Y1 : Y0, uv, -1.0f, xs, u0, u1);
            if constexpr (LR) {
                if (DESCEND && d == ndir - 1)
                    for (int t = tid; t < m; t += nthreads)
                        lrv[t] = uv[t] + (P.noise_mode ? lrv[t] : 0.0f) / sroot[t];
            } else if (DESCEND && d == ndir - 1 && tid < m) {
                // t = u + Sigma^-1/2 n = Sigma^-1 B^T x of the corrected x, for the
                // residual
                s_lr[tid] = s_u[tid] + (P.noise_mode ? s_lr[tid] : 0.0f) / sroot[tid];
            }
        }
    }
    //    the band back to global memory, once
    for (int i = tid; i < count; i += nthreads) x[first + i] = xs[i];

    // 4. residual and restriction
    if (DESCEND) {
        cluster.sync();  // every band's corrected x
        for (int t = tid; t < count; t += nthreads) {
            const int lr = t / W, j = t - lr * W;
            const int i = u0 + lr, p = first + t;
            cs[t] = f[p] - band_stencil(P, coeffs, i, j, n, p, u0, u1, lo0, xs, xlo, xhi);
        }
        if (m) band_lowrank(P, LR ? bbx : P.bbox, B, lrv, -1.0f, cs, u0, u1);
        cluster.sync();  // every band's residual
        const float* rlo = cluster.map_shared_rank(cs, rank > 0 ? rank - 1 : rank);
        const float* rhi = cluster.map_shared_rank(cs, rank + 1 < S ? rank + 1 : rank);
        // f_c[I, J] = sum_{a, b} w_a w_b r[2I+1+a, 2J+1+b], w = {0.5, 1, 0.5}, for
        // the coarse rows whose centre row 2I+1 lies in this band
        float* fc = fc_all + (size_t)chain * P.Hc * P.Wc;
        const int I0 = u0 / 2, I1 = min(u1 / 2, P.Hc);
        for (int t = tid; t < (I1 - I0) * P.Wc; t += nthreads) {
            const int dI = t / P.Wc, J = t - dI * P.Wc, I = I0 + dI;
            float acc = 0.0f;
            for (int a = -1; a <= 1; ++a) {
                const int i = 2 * I + 1 + a;
                if (i < 0 || i >= H) continue;
                const float* rrow = band_row(i, u0, u1, lo0, W, cs, rlo, rhi);
                float row = 0.0f;
                for (int b = -1; b <= 1; ++b) {
                    const int j = 2 * J + 1 + b;
                    if (j < 0 || j >= W) continue;
                    row += (b ? 0.5f : 1.0f) * rrow[j];
                }
                acc += (a ? 0.5f : 1.0f) * row;
            }
            fc[I * P.Wc + J] = acc;
        }
    }
    // 5. no block leaves while another still reads its shared memory
    cluster.sync();
}

// ------------------------------------------------------------ host helpers
template <bool DESCEND, int NDIR, bool LR>
static cudaError_t configure(int bytes) {
    auto kernel = split_visit_kernel<DESCEND, NDIR, LR>;
    static int granted = 0;
    if (granted == 0) {
        cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return e;
        granted = 48 * 1024;
    }
    if (bytes > granted) {
        cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return e;
        granted = bytes;
    }
    return cudaSuccess;
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
extern "C" int mgmc_split_params_size() { return (int)sizeof(SplitParams); }

// Dynamic shared memory of one block of a split launch (bytes): the
// first-point table, then the widest band of x, then the scratch band of c
// and r, then for m > LANE_SLOTS measurements the (S + 4) m floats of the
// low-rank vectors.  -1 where the level cannot be split so: S outside 2 .. 16
// or more ranks than rows.
extern "C" int mgmc_split_smem_bytes(int H, int W, int S, int m) {
    if (S < 2 || S > MAX_CLUSTER || H < 1 || W < 1 || S > H || m < 0) return -1;
    const long long floats = SPLIT_TABLE_INTS + 2LL * split_band_rows(H, S) * W +
                             (m > LANE_SLOTS ? (long long)(S + 4) * m : 0);
    return floats * 4 > 0x7FFFFFFF ? -1 : (int)(floats * 4);
}

// The largest static shared memory of the kernels (bytes), or -1 if the
// runtime cannot say.
extern "C" int mgmc_split_static_smem_bytes() {
    const void* kernels[] = {(const void*)split_visit_kernel<true, 1, false>,
                             (const void*)split_visit_kernel<false, 1, false>,
                             (const void*)split_visit_kernel<true, 2, false>,
                             (const void*)split_visit_kernel<false, 2, false>,
                             (const void*)split_visit_kernel<true, 1, true>,
                             (const void*)split_visit_kernel<false, 1, true>,
                             (const void*)split_visit_kernel<true, 2, true>,
                             (const void*)split_visit_kernel<false, 2, true>};
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

template <bool DESCEND, int NDIR>
static cudaError_t max_active(int S, int threads, int bytes, int* clusters) {
    cudaError_t e = configure<DESCEND, NDIR, false>(bytes);
    if (e == cudaSuccess) {
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr[1];
        cluster_config(&cfg, attr, S, S, threads, bytes, 0);
        e = cudaOccupancyMaxActiveClusters(clusters, split_visit_kernel<DESCEND, NDIR, false>,
                                           &cfg);
    }
    return e;
}

// How many clusters of S blocks of `threads` threads and `bytes` of dynamic
// shared memory the card can hold at once (cudaOccupancyMaxActiveClusters) for
// the descend (descend != 0) or the ascend kernel, the fewer of its one- and
// two-sweep forms: 0 means such a cluster never schedules.  Returns the CUDA
// error.
extern "C" int mgmc_split_max_active(int descend, int S, int threads, int bytes, int* clusters) {
    *clusters = 0;
    int one = 0, two = 0;
    cudaError_t e = descend ? max_active<true, 1>(S, threads, bytes, &one)
                            : max_active<false, 1>(S, threads, bytes, &one);
    if (e == cudaSuccess)
        e = descend ? max_active<true, 2>(S, threads, bytes, &two)
                    : max_active<false, 2>(S, threads, bytes, &two);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    *clusters = one < two ? one : two;
    return (int)e;
}

template <bool DESCEND>
static int launch(const SplitParams* SP, float* x, const float* f, float* fc, const float* xc,
                  const float* coeffs, const float* ns, const float* B, const float* Y0,
                  const float* W0, const float* Y1, const float* W1, const float* xilr,
                  const float* sroot, const float* xi, const int* boxes0, const int* boxes1,
                  int S, int threads, cudaStream_t stream) {
    const VisitParams* P = &SP->v[0];
    const int bytes = mgmc_split_smem_bytes(P->H, P->W, S, P->m);
    const bool lr = P->m > LANE_SLOTS;
    bool reach1 = true;
    for (int k = 0; k < P->K && k < MAX_OFFSETS; ++k)
        reach1 = reach1 && P->dy[k] >= -1 && P->dy[k] <= 1 && P->dx[k] >= -1 && P->dx[k] <= 1;
    const bool two = SP->ndir == 2;
    if (bytes < 0 || threads < 64 || threads > MAX_THREADS || threads % 32 || SP->ndir < 1 ||
        SP->ndir > MAX_DIRS || SP->ndir * P->n_order * P->n_colors > threads ||
        P->n_colors > MAX_COLORS || P->C < 1 || P->K < 1 || P->K > MAX_OFFSETS || !reach1 ||
        P->m < 0 || P->Hc != P->H / 2 || P->Wc != P->W / 2 ||
        (P->m && (sroot == nullptr || (two && (Y1 == nullptr || W1 == nullptr)))) ||
        (lr && (boxes0 == nullptr || (two && boxes1 == nullptr))) ||
        (two && SP->v[1].n_order != P->n_order))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = lr ? (two ? configure<DESCEND, 2, true>(bytes)
                              : configure<DESCEND, 1, true>(bytes))
                       : (two ? configure<DESCEND, 2, false>(bytes)
                              : configure<DESCEND, 1, false>(bytes));
    if (e == cudaSuccess) {
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr[1];
        cluster_config(&cfg, attr, P->C * S, S, threads, bytes, stream);
        SplitParams Pc = *SP;
        void* args[] = {&Pc, &x, &f, &fc, &xc, &coeffs, &ns, &B, &Y0, &W0, &Y1, &W1, &xilr,
                        &sroot, &xi, &boxes0, &boxes1};
        const void* kernel =
            lr ? (two ? (const void*)split_visit_kernel<DESCEND, 2, true>
                      : (const void*)split_visit_kernel<DESCEND, 1, true>)
               : (two ? (const void*)split_visit_kernel<DESCEND, 2, false>
                      : (const void*)split_visit_kernel<DESCEND, 1, false>);
        e = cudaLaunchKernelExC(&cfg, kernel, args);
    }
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    return (int)cudaGetLastError();
}

// Y0, W0: the first direction's Woodbury factors, Y1, W1 the second's (null
// with one direction); xilr (C, ndir m) the low-rank normals as drawn, sroot
// Sigma^1/2; xi (ndir, C, H, W) where noise_mode is 2; boxes0, boxes1 each
// direction's box table (B's boxes, then its Y's; read where m > LANE_SLOTS).
extern "C" int mgmc_split_descend(const SplitParams* P, float* x, const float* f, float* fc,
                                  const float* coeffs, const float* ns, const float* B,
                                  const float* Y0, const float* W0, const float* Y1,
                                  const float* W1, const float* xilr, const float* sroot,
                                  const float* xi, const int* boxes0, const int* boxes1, int S,
                                  int threads, void* stream) {
    return launch<true>(P, x, f, fc, nullptr, coeffs, ns, B, Y0, W0, Y1, W1, xilr, sroot, xi,
                        boxes0, boxes1, S, threads, (cudaStream_t)stream);
}

extern "C" int mgmc_split_ascend(const SplitParams* P, float* x, const float* f,
                                 const float* xc, const float* coeffs, const float* ns,
                                 const float* B, const float* Y0, const float* W0,
                                 const float* Y1, const float* W1, const float* xilr,
                                 const float* sroot, const float* xi, const int* boxes0,
                                 const int* boxes1, int S, int threads, void* stream) {
    return launch<false>(P, x, f, nullptr, xc, coeffs, ns, B, Y0, W0, Y1, W1, xilr, sroot, xi,
                         boxes0, boxes1, S, threads, (cudaStream_t)stream);
}
