// The MGMC coarse subtree as ONE kernel launch, for NVIDIA Hopper (sm_90a),
// float32, 2d.
//
// Replaces the Pallas kernel subtree_sample of
// multigridmc_tpu/ops/kernels/mgmc_subtree_pallas.py.  One launch runs, for
// all chains, the whole cycle below the finest level of an MGMC hierarchy:
//
//   sample(l):                               # sub-levels l = 0 .. NL-1
//       x_l = 0
//       repeat `cycle` times:
//           descend visit of level l         (forward Gibbs sweep, Woodbury,
//                                             residual, restriction -> f_{l+1})
//           sample(l + 1)
//           ascend visit of level l          (x_l += gamma P x_{l+1}, backward
//                                             Gibbs sweep, Woodbury)
//   sample(NL):  x = Linv^T (xi + Linv f)    (coarsest level, exact sample)
//
// Design.  One thread block per chain, as the level-visit kernels; the visits
// ARE the bodies of those kernels (visit_phases.cuh).  The recursion is
// flattened by the host into a schedule of (operation, level) pairs that the
// block walks, with __syncthreads() between operations, so the host launches
// once per step where the composed path launches once per visit and several
// times per coarse sample.  Each level's x, rhs scratch and f are fields of
// this chain; where a field lies is decided by the host and handed over as a
// location: dynamic shared memory (the small levels, where the granted size
// allows), a global workspace that the L2 holds, or, for the finest
// sub-level, the launch's own f and x tensors.  The arithmetic is the same.
// The per-level parameter block (stencil, colours, bounding boxes) is copied
// into shared memory when the block moves to that level.
//
// The coarse sample is two nc x nc matrix-vector products per chain against
// the inverse Cholesky factor (Linv and its transpose, both row major, shared
// by all chains and resident in L2): one warp per output, lanes along the
// row, a shuffle tree, only the triangle that is nonzero.
//
// Bound: by bytes the launch must read f and write x of the finest sub-level
// once per chain; everything else is meant to stay on the chip.  The work is
// latency: a visit of a 31^2 level is some twenty barrier-separated phases of
// 961 points.
//
// Noise.  Mode 0 off.  Mode 1: the generator of philox.cuh; every draw of the
// launch (the field of one sweep, the m low-rank scalars of one sweep, the
// normals of one coarse sample) has its own launch counter `counter + d`, d
// counting the draws in schedule order, so no two draws share a stream; a
// draw of k scalars uses the point groups 0 .. ceil(k / 4) - 1.  With
// `record` set the normals used are also written to xi_all.  Mode 2: all
// normals are read from xi_all, (C, K) with K normals per chain laid out in
// draw order (per sweep the field then the m scalars, per coarse sample nc),
// which is the order in which the plain version consumes them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "visit_phases.cuh"

#define MAX_SUB_LEVELS 8

#define OP_DESCEND 0
#define OP_DESCEND_ZERO 1  // zero the level's x first: entry of sample(l)
#define OP_COARSE 2
#define OP_ASCEND 3

#define LOC_SHARED 0     // dynamic shared memory, offset in floats
#define LOC_WORKSPACE 1  // this chain's slice of the global workspace, offset in floats
#define LOC_LAUNCH 2     // the launch's own tensor (f or x of the finest sub-level)

struct FieldLoc {
    int where;
    int pad;
    long long off;
};

struct SubLevel {
    const float* coeffs;
    const float* ns;
    const float* B;
    const float* Y[2];   // pre, post direction
    const float* Wm[2];
    const float* sinv;
    const float* G;
    const float* lrscale;  // Sigma^-1/2
    FieldLoc x, scr, f;
    int n;
    int pad;
};

struct SubtreeParams {
    int C, NL, n_sched, noise_mode, nc, record;
    long long ws_stride;  // floats of workspace per chain
    long long xi_stride;  // normals per chain in xi_all
    unsigned long long seed;
    unsigned long long counter;
    SubLevel lv[MAX_SUB_LEVELS];
    FieldLoc cx, cscr, cf;  // the coarsest level's vectors
};

extern __shared__ float dyn_smem[];

__device__ __forceinline__ float* locate(const FieldLoc& L, float* ws, float* launch) {
    if (L.where == LOC_SHARED) return dyn_smem + L.off;
    if (L.where == LOC_WORKSPACE) return ws + L.off;
    return launch;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// x = Linv^T (xi + Linv f) for one chain; g holds xi, then xi + Linv f.
// Ends with a barrier.
__device__ void coarse_sample(const SubtreeParams& S, int chain, const float* __restrict__ Linv,
                              const float* __restrict__ LinvT, const float* f, float* g,
                              float* x, float* xi, long long cur, unsigned long long draw) {
    const int nc = S.nc;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    if (S.noise_mode == 1) {
        for (int q4 = threadIdx.x; q4 < (nc + 3) >> 2; q4 += blockDim.x) {
            float z[4];
            philox_normals4((uint32_t)q4, (uint32_t)chain, S.seed, S.counter + draw, z);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int j = 4 * q4 + q;
                if (j >= nc) break;
                g[j] = z[q];
                if (S.record) xi[cur + j] = z[q];
            }
        }
    } else {
        for (int j = threadIdx.x; j < nc; j += blockDim.x)
            g[j] = (S.noise_mode == 2) ? xi[cur + j] : 0.0f;
    }
    __syncthreads();
    // g[i] += sum_{j <= i} Linv[i, j] f[j]
    for (int i = warp; i < nc; i += nwarps) {
        float acc = 0.0f;
        for (int j = lane; j <= i; j += 32) acc += Linv[(size_t)i * nc + j] * f[j];
        acc = warp_sum(acc);
        if (lane == 0) g[i] = g[i] + acc;
    }
    __syncthreads();
    // x[j] = sum_{i >= j} Linv[i, j] g[i], read from the transpose's row j
    for (int j = warp; j < nc; j += nwarps) {
        float acc = 0.0f;
        for (int i = j + lane; i < nc; i += 32) acc += LinvT[(size_t)j * nc + i] * g[i];
        acc = warp_sum(acc);
        if (lane == 0) x[j] = acc;
    }
    __syncthreads();
}

__global__ void __launch_bounds__(MAX_THREADS)
mgmc_subtree_kernel(const __grid_constant__ SubtreeParams S, const VisitParams* __restrict__ plans,
                    const int* __restrict__ sched, const float* __restrict__ Linv,
                    const float* __restrict__ LinvT, const float* f_all, float* x_all,
                    float* ws_all, float* xi_all) {
    __shared__ VisitParams sP;
    __shared__ float s_red[33];
    __shared__ float s_btx[MAX_LOWRANK];
    __shared__ float s_lr[MAX_LOWRANK];
    __shared__ float s_u[MAX_LOWRANK];
    const int chain = blockIdx.x;
    const int n0 = S.lv[0].n;
    float* ws = ws_all + (size_t)chain * S.ws_stride;
    float* f_launch = const_cast<float*>(f_all) + (size_t)chain * n0;  // only read
    float* x_launch = x_all + (size_t)chain * n0;
    float* xi = xi_all ? xi_all + (size_t)chain * S.xi_stride : nullptr;
    long long cur = 0;            // normals this chain has consumed
    unsigned long long draw = 0;  // draws of the launch so far

    if (S.lv[0].f.where != LOC_LAUNCH) {
        float* f0 = locate(S.lv[0].f, ws, nullptr);
        for (int p = threadIdx.x; p < n0; p += blockDim.x) f0[p] = f_launch[p];
        __syncthreads();
    }

    for (int s = 0; s < S.n_sched; ++s) {
        const int op = sched[2 * s], li = sched[2 * s + 1];
        if (op == OP_COARSE) {
            coarse_sample(S, chain, Linv, LinvT, locate(S.cf, ws, nullptr),
                          locate(S.cscr, ws, nullptr), locate(S.cx, ws, nullptr), xi, cur, draw);
            if (S.noise_mode) { cur += S.nc; draw += 1; }
            continue;
        }
        const SubLevel& L = S.lv[li];
        const int dir = (op == OP_ASCEND) ? 1 : 0;
        {   // this level's parameter block, then this visit's stream
            const int* src = reinterpret_cast<const int*>(plans + 2 * li + dir);
            int* dst = reinterpret_cast<int*>(&sP);
            for (int q = threadIdx.x; q < (int)(sizeof(VisitParams) / sizeof(int)); q += blockDim.x)
                dst[q] = src[q];
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            sP.noise_mode = S.noise_mode;
            sP.seed = S.seed;
            sP.counter = S.counter + draw;
        }
        const int n = L.n, m = sP.m;
        float* x = locate(L.x, ws, x_launch);
        float* scr = locate(L.scr, ws, nullptr);
        const float* f = locate(L.f, ws, f_launch);
        if (op == OP_DESCEND_ZERO)
            for (int p = threadIdx.x; p < n; p += blockDim.x) x[p] = 0.0f;
        if (S.noise_mode && threadIdx.x < m) {  // the m low-rank normals of this sweep
            float z;
            if (S.noise_mode == 1) {
                float z4[4];
                philox_normals4((uint32_t)(threadIdx.x >> 2), (uint32_t)chain, S.seed,
                                S.counter + draw + 1, z4);
                const int q = threadIdx.x & 3;
                z = q == 0 ? z4[0] : (q == 1 ? z4[1] : (q == 2 ? z4[2] : z4[3]));
                if (S.record) xi[cur + n + threadIdx.x] = z;
            } else {
                z = xi[cur + n + threadIdx.x];
            }
            s_lr[threadIdx.x] = L.lrscale[threadIdx.x] * z;
        }
        __syncthreads();
        const float* xi_in = (S.noise_mode == 2) ? xi + cur : nullptr;
        float* xi_rec = (S.noise_mode == 1 && S.record) ? xi + cur : nullptr;
        const bool last = li + 1 == S.NL;
        if (dir == 0) {
            float* fc = locate(last ? S.cf : S.lv[li + 1].f, ws, nullptr);
            descend_body(sP, chain, x, f, scr, fc, L.coeffs, L.ns, L.B, L.Y[0], L.Wm[0], L.sinv,
                         L.G, xi_in, xi_rec, s_red, s_btx, s_lr, s_u);
        } else {
            const float* xc = locate(last ? S.cx : S.lv[li + 1].x, ws, nullptr);
            ascend_body(sP, chain, x, f, scr, xc, L.coeffs, L.ns, L.B, L.Y[1], L.Wm[1], xi_in,
                        xi_rec, s_red, s_btx, s_lr, s_u);
        }
        __syncthreads();
        if (S.noise_mode) { cur += n + m; draw += m ? 2 : 1; }
    }

    if (S.lv[0].x.where != LOC_LAUNCH) {
        const float* x0 = locate(S.lv[0].x, ws, nullptr);
        for (int p = threadIdx.x; p < n0; p += blockDim.x) x_launch[p] = x0[p];
    }
}

// ------------------------------------------------------------ C entry points
extern "C" int mgmc_subtree_params_size() { return (int)sizeof(SubtreeParams); }

extern "C" int mgmc_subtree_visit_params_size() { return (int)sizeof(VisitParams); }

extern "C" int mgmc_subtree_sample(const SubtreeParams* S, const VisitParams* plans,
                                   const int* sched, const float* Linv, const float* LinvT,
                                   const float* f, float* x, float* ws, float* xi, int threads,
                                   int smem_bytes, void* stream) {
    if (smem_bytes > 48 * 1024) {  // above what needs no opt-in
        cudaError_t e = cudaFuncSetAttribute(
            mgmc_subtree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
    }
    mgmc_subtree_kernel<<<S->C, threads, smem_bytes, (cudaStream_t)stream>>>(
        *S, plans, sched, Linv, LinvT, f, x, ws, xi);
    return (int)cudaGetLastError();
}
