// Fused MGMC level-visit kernels for NVIDIA Hopper (sm_90a), float32, 2d and
// (a build of its own) 3d: the phase route.
//
// Replaces the Pallas kernels descend_visit / ascend_visit of
// multigridmc_tpu/ops/kernels/mgmc_visit_pallas.py.  One launch is one visit
// of one multigrid level for all chains, with one directed sweep (SOR) or two,
// forward then backward (SSOR), each d with fresh noise xi_d, n_d:
//
//   descend:  c   = f + sqrt(D(2-w)/w) xi_d                      (Gibbs rhs)
//             x  <- colour-ordered SOR sweep(c, x)
//             x  <- x - sum_l u_l Y_l,  u = W (B^T x - Sigma^1/2 n_d)   (Woodbury:
//                   B_bar = Y W with Y = M^-1 B, W = (Sigma + B^T Y)^-1)
//             r   = f - A_stencil x - sum_k t_k B_k,  t = u + Sigma^-1/2 n_d
//             f_c = R r                                (full weighting; after
//                                                       the last direction)
//   ascend:   x  <- x + gamma P x_c                    (d-linear interpolation)
//             per direction c, sweep, Woodbury as above (post directions)
//
// The low-rank noise enters the correction, not the rhs (level_passes.cuh):
// the same x' as the TPU kernel's rhs term B Sigma^-1/2 n, and t is Sigma^-1
// B^T x' exactly, where the TPU kernel's Gram form (I - G) B^T x is not.
//
// Design.  The colour phases are Gauss-Seidel: phase c must see what phase
// c-1 wrote everywhere in that chain's field, so a field cannot be tiled over
// blocks with stale halos, and a 255^2 float32 field (260 KB) does not fit a
// block's shared memory.  Hence one thread block per chain, the fields in
// device memory, whole-field passes with a barrier between them: the passes of
// level_passes.cuh, which the subtree kernel runs too.  Each low-rank term is
// one pass, the stencil is held in registers, the colour rows are spread over
// all warps, and a lane has several points' loads in flight.
//
// Tables.  The host makes one level's tables for one sweep direction
// (mgmc_visit.py::phase_tables: B inside its boxes, each direction's Y inside
// its boxes, the boxes and the columns they span in each row, each
// direction's W and colour rows, Sigma^1/2) and uploads them once.  Where they
// and the kernel's static share fit the block's share of shared memory, each
// block copies them into its dynamic shared memory at entry; the first pass
// (the rhs, which reads no table) runs meanwhile, and its barrier publishes
// the copy.  Otherwise (a level with dense B columns, say) every pass reads
// them from the tensor.  A two-sweep launch holds both directions' tables.
//
// Measurements.  A level of up to LANE_SLOTS (32) keeps its low-rank
// vectors in the static shared memory below, one entry a lane; a level of
// more takes the kernels compiled with LR, which keep them in dynamic shared
// memory after the tables (or at its start, where the tables stay in device
// memory), lowrank_scratch_floats of visit_phases.cuh: the block's B^T x -
// Sigma^1/2 n, then per warp its u (then t) and its n, each lane holding
// entries lane, lane + 32, ...  Each warp forms u = W v itself (m^2 / 32
// multiply-adds a lane) and the correction adds m columns' terms where the
// boxes meet a point, so a visit's time grows with m.  A kernel each (LR or
// not), so that the kernels of up to 32 keep their code and registers.
//
// Block size.  Chosen by the host from the chain count
// (mgmc_visit.py::phase_threads): 1024 threads while the chains fit one wave
// of one block per SM, 512 (two blocks per SM) above.  __launch_bounds__(1024)
// caps a thread at 64 registers, what two blocks of 512 leave it too.  One
// kernel per stencil form (level_passes.cuh: 5-point, the raster 3x3 box, any
// other of up to 9 offsets, each with or without coefficient planes), picked
// by the host (mgmc_visit.py::stencil_form), so that each form's passes get
// the registers to themselves.
//
// Bound: by bytes, per chain f (unless shared), x and x_c read and x and f_c
// written once.  What the kernels pay on top of that is the passes' traffic
// to the L2 and device memory (the scratch of the rhs and the residual, x read
// by each colour) and, on the L2-resident levels, its latency.
//
// Field noise: the generator of philox.cuh: Philox4x32-10, counter = (point
// group, chain, launch counter lo, hi), key = seed ^ PHILOX_KEY_MIX; each call
// yields four normals for four consecutive points of a row (group g of row i
// has the number i * ceil(W / 4) + g), the stream and the split kernels'
// addressing, so the three routes agree under one stream.  noise_mode 2 reads
// xi from a tensor instead, so that a kernel and its plain PyTorch version can
// be fed the same noise; direction d of a two-sweep launch takes the counter
// + d (its xi at xi + d C n).  The m low-rank normals per direction come in
// as drawn (xilr, (C, ndir m)).  No atomics and a fixed reduction tree, so two launches
// with the same seed and counter are bitwise equal.
//
// STAMPS: the measurement build, a library of its own (PHASE_STAMPS_BUILD),
// taken only where the host passes a stamps tensor, (C, PHASE_STAMP_WIDTH)
// int64: per block the timer (ns) at entry and after each barrier (one per
// pass), at exit, then the barriers passed and the SM it ran on.
//
// Reach 2: the squared shifted-Laplace prior's 13-point diamond and the 5x5
// box of its Galerkin levels (9 colours) take a library of their own, this
// source built with -DVISIT_REACH=2 (common.py::PHASE_REACH2_FLAGS): a
// parameter block of 25 offsets and 9 colours and the reach-2 forms of
// level_passes.cuh (WIDE_FORM0 ..), whose stencils drop the terms that leave
// the field two rows and two columns deep, so that the reach-1 kernels keep
// their parameter block, registers and stamps as they are.  A thread holds
// the box's 25 operands and coefficients, so its kernels are bounded to 512
// threads a block (128 registers a thread).  The split and stream kernels
// take reach-1 stencils only; the host sends a reach-2 level here where the
// smem kernels (mgmc_visit_smem.cu) do not take it.
//
// 3d: the 7-point and 27-point levels of a 3d lattice take a library of their
// own, this source built with -DVISIT_DIM=3 (common.py::PHASE_DIM3_FLAGS): a
// parameter block of 27 offsets with the z extents, offsets and colour weight
// (visit_phases.cuh), and the 3d passes and forms of level_passes.cuh
// (DIM3_FORM0 ..).  A field (Z, Y, W) is stored row major as on the host, so a
// pass that goes row by row takes its Z Y rows as it takes a 2d field's, the
// Philox groups included (group g of row z Y + y has the number (z Y + y)
// ceil(W / 4) + g, as the 3d sweeps number theirs); the transfers are 3d and
// the measurement columns 3d boxes.  A thread holds the 27 operands and
// coefficients of the box, so its kernels are bounded to 512 threads a block,
// as the reach-2 build's.  The split and stream kernels take 2d levels only;
// the host sends a 3d level here at every chain count.

#ifndef VISIT_REACH
#define VISIT_REACH 1
#endif
#ifndef VISIT_DIM
#define VISIT_DIM 2
#endif
#if VISIT_DIM == 3
#if VISIT_REACH != 1
#error "the 3d build takes reach-1 stencils"
#endif
#define MAX_OFFSETS 27
#elif VISIT_DIM != 2
#error "VISIT_DIM is 2 or 3"
#endif
#if VISIT_REACH == 2
#define MAX_OFFSETS 25
#define MAX_COLORS 9
#elif VISIT_REACH != 1
#error "VISIT_REACH is 1 or 2"
#endif

#include <cuda_runtime.h>
#include <stdint.h>

#include "level_passes.cuh"

// the stencil forms of this build (level_passes.cuh) and the block size its
// kernels are bounded to
#if VISIT_REACH == 2
#define PHASE_FORM0 WIDE_FORM0
#define PHASE_FORMS WIDE_FORMS
#define PHASE_MAX_THREADS 512
#elif VISIT_DIM == 3
#define PHASE_FORM0 DIM3_FORM0
#define PHASE_FORMS DIM3_FORMS
#define PHASE_MAX_THREADS 512
#else
#define PHASE_FORM0 0
#define PHASE_FORMS STENCIL_FORMS
#define PHASE_MAX_THREADS MAX_THREADS
#endif

// the timer at entry, after each barrier of up to two directions (the rhs,
// each colour, B^T x, Woodbury) and the descend's residual and restriction,
// at exit, the barriers passed, the SM
#define PHASE_STAMP_WIDTH (1 + 2 * (MAX_COLORS + 3) + 2 + 3)

// 1: this library is the stamps build (mgmc_visit.py builds the source a
// second time with -DPHASE_STAMPS_BUILD=1, beside the production library, so
// that each holds the kernels of one build)
#ifndef PHASE_STAMPS_BUILD
#define PHASE_STAMPS_BUILD 0
#endif

// the sweep directions a launch may hold: one (SOR) or two (SSOR)
#define MAX_DIRS 2

// Word offsets of one level's tables for the launch's sweep directions
// (mgmc_visit.py::phase_tables): B's and Sigma^1/2 shared, the rest per
// direction.
struct PhaseTables {
    int bval, boff, sroot, bbox, bspan;
    int ndir;  // 1 or 2
    int yval[MAX_DIRS], yoff[MAX_DIRS], wm[MAX_DIRS], ybox[MAX_DIRS], yspan[MAX_DIRS];
    int rows[MAX_DIRS];
    int words;   // a multiple of 4
    int shared;  // 1: each block copies them into its dynamic shared memory
};

extern __shared__ __align__(16) float phase_smem[];

// direction d's tables at t
__device__ __forceinline__ LevelTables tables_at(const PhaseTables& L, const float* t, int d) {
    return {t + L.bval,
            reinterpret_cast<const int*>(t + L.boff),
            t + L.yval[d],
            reinterpret_cast<const int*>(t + L.yoff[d]),
            t + L.wm[d],
            t + L.sroot,
            reinterpret_cast<const int(*)[BOX_INTS]>(t + L.bbox),
            reinterpret_cast<const int(*)[BOX_INTS]>(t + L.ybox[d]),
            reinterpret_cast<const int*>(t + L.bspan),
            reinterpret_cast<const int*>(t + L.yspan[d]),
            reinterpret_cast<const int*>(t + L.rows[d])};
}

// An LR kernel's low-rank scratch: the dynamic shared memory after the tables
// (visit_phases.cuh), the block's vector, then two m-vectors a warp.
__device__ __forceinline__ float* phase_scratch(const VisitParams& P, const PhaseTables& L) {
    return phase_smem + (L.shared ? L.words : 0);
}

// The block's start: the stamps opened (STAMPS), the tables copied into shared
// memory where they lie there (no barrier: the first pass reads no table),
// this warp's first m low-rank normals into its slot.  Returns the chain's
// normals of the later directions.
template <bool STAMPS, bool LR>
__device__ __forceinline__ const float* phase_start(const VisitParams& P, const PhaseTables& L,
                                                    const int4* __restrict__ tables, int chain,
                                                    const float* __restrict__ xilr, float* wv,
                                                    unsigned long long* srow) {
    stamps_open<STAMPS>(srow);
    if (L.shared) {
        int4* dst = reinterpret_cast<int4*>(phase_smem);
        for (int q = threadIdx.x; q < L.words / 4; q += blockDim.x) dst[q] = tables[q];
    }
    const float* nlr = P.noise_mode ? xilr + (size_t)chain * L.ndir * P.m : nullptr;
    if constexpr (LR) {
        float* nv = normals_of<LR>(wv, P.m);
        if (P.noise_mode)
            for (int k = threadIdx.x & 31; k < P.m; k += 32) nv[k] = nlr[k];
    } else {
        const int lane = threadIdx.x & 31;
        if (P.noise_mode && lane < P.m) wv[lane] = nlr[lane];
    }
    __syncwarp();
    return nlr ? nlr + P.m : nullptr;
}

template <bool STAMPS>
__device__ __forceinline__ void phase_exit(unsigned long long* srow) {
    stamps_close<STAMPS>(srow, PHASE_STAMP_WIDTH);
}

// The sweeps a visit makes (1 SOR, 2 SSOR): a kernel each (NDIR 1, 2), so that
// a one-sweep visit runs the straight-line passes (a loop over a run-time count
// cost the 31^3 27-point visit 20-25% on an H100), except in the reach-2 build,
// whose forms spill either way and whose 13-point descend took 1.36x as long
// compiled per count: one kernel there (NDIR 0, the count at run time; PERF.md
// section 6).
#if VISIT_REACH == 2
#define PHASE_NDIR_RUNTIME 1
#else
#define PHASE_NDIR_RUNTIME 0
#endif

// FORM: the stencil's form (level_passes.cuh, STENCIL_DISPATCH), one kernel
// each, so that the registers of one form's passes are allocated for it alone.
// LR: a level of more than LANE_SLOTS measurements.
template <int FORM, bool STAMPS, int NDIR, bool LR>
__global__ void __launch_bounds__(PHASE_MAX_THREADS)
descend_kernel(const __grid_constant__ VisitParams P, const __grid_constant__ PhaseTables L,
               const int4* __restrict__ tables, float* x_all, const float* __restrict__ f_all,
               float* scr_all, float* fc_all, const float* __restrict__ coeffs,
               const float* __restrict__ ns, const float* __restrict__ xilr,
               const float* __restrict__ xi_all, unsigned long long* stamps) {
    __shared__ float s_btx[LANE_SLOTS];
    __shared__ float s_wv[32 * LANE_SLOTS];  // one slot of m scalars per warp
    __shared__ float s_stage[32 * 128];      // each warp's rhs stores, staged
    const int chain = blockIdx.x;
    const int n = P.H * P.W, nc = P.Hc * P.Wc;
    unsigned long long* srow = STAMPS ? stamps + (size_t)chain * PHASE_STAMP_WIDTH : nullptr;
    float* lr = LR ? phase_scratch(P, L) : nullptr;
    float* btx = LR ? lr : s_btx;
    float* wv = LR ? lr + P.m + (size_t)(threadIdx.x >> 5) * 2 * P.m
                   : s_wv + (threadIdx.x >> 5) * LANE_SLOTS;
    const float* nlr = phase_start<STAMPS, LR>(P, L, tables, chain, xilr, wv, srow);
    // where the passes after the first read the tables
    const float* t = L.shared ? phase_smem : reinterpret_cast<const float*>(tables);
    const auto dir_tables = [&](int d) { return tables_at(L, t, d); };
    level_descend<FORM, STAMPS, NDIR, decltype(dir_tables), false, LR>(P, dir_tables, L.ndir, chain, P.noise_mode, P.seed,
                                      P.counter, false, true, x_all + (size_t)chain * n,
                                      f_all + (P.f_batched ? (size_t)chain * n : 0),
                                      scr_all + (size_t)chain * n, fc_all + (size_t)chain * nc,
                                      coeffs, ns,
                                      xi_all ? xi_all + (size_t)chain * n : nullptr,
                                      (size_t)P.C * n, nlr, nullptr, wv, btx,
                                      s_stage + (threadIdx.x >> 5) * 128);
    phase_exit<STAMPS>(srow);
}

template <int FORM, bool STAMPS, int NDIR, bool LR>
__global__ void __launch_bounds__(PHASE_MAX_THREADS)
ascend_kernel(const __grid_constant__ VisitParams P, const __grid_constant__ PhaseTables L,
              const int4* __restrict__ tables, float* x_all, const float* __restrict__ f_all,
              float* scr_all, const float* __restrict__ xc_all, const float* __restrict__ coeffs,
              const float* __restrict__ ns, const float* __restrict__ xilr,
              const float* __restrict__ xi_all, unsigned long long* stamps) {
    __shared__ float s_btx[LANE_SLOTS];
    __shared__ float s_wv[32 * LANE_SLOTS];
    __shared__ float s_stage[32 * 128];
    const int chain = blockIdx.x;
    const int n = P.H * P.W, nc = P.Hc * P.Wc;
    unsigned long long* srow = STAMPS ? stamps + (size_t)chain * PHASE_STAMP_WIDTH : nullptr;
    float* lr = LR ? phase_scratch(P, L) : nullptr;
    float* btx = LR ? lr : s_btx;
    float* wv = LR ? lr + P.m + (size_t)(threadIdx.x >> 5) * 2 * P.m
                   : s_wv + (threadIdx.x >> 5) * LANE_SLOTS;
    const float* nlr = phase_start<STAMPS, LR>(P, L, tables, chain, xilr, wv, srow);
    // where the passes after the first read the tables
    const float* t = L.shared ? phase_smem : reinterpret_cast<const float*>(tables);
    const auto dir_tables = [&](int d) { return tables_at(L, t, d); };
    level_ascend<FORM, STAMPS, NDIR, decltype(dir_tables), false, LR>(P, dir_tables, L.ndir, chain, P.noise_mode, P.seed,
                                     P.counter, x_all + (size_t)chain * n,
                                     f_all + (P.f_batched ? (size_t)chain * n : 0),
                                     scr_all + (size_t)chain * n, xc_all + (size_t)chain * nc,
                                     coeffs, ns,
                                     xi_all ? xi_all + (size_t)chain * n : nullptr,
                                     (size_t)P.C * n, nlr, nullptr, wv, btx,
                                     s_stage + (threadIdx.x >> 5) * 128);
    phase_exit<STAMPS>(srow);
}

// the kernel of a direction, a stencil form, a sweep count (1 or 2) and
// whether the level has more than LANE_SLOTS measurements (lr) in this
// library's build; null for another form or count
static const void* phase_kernel(int descend, int form, int ndir, bool lr) {
    constexpr bool S = PHASE_STAMPS_BUILD;
    if (ndir < 1 || ndir > MAX_DIRS) return nullptr;
#if PHASE_NDIR_RUNTIME
#define DIR_KERNEL(F, N, LR) \
    (descend ? (const void*)descend_kernel<F, S, N, LR> : (const void*)ascend_kernel<F, S, N, LR>)
#define FORM_KERNEL(F) (lr ? DIR_KERNEL(F, 0, true) : DIR_KERNEL(F, 0, false))
#else
#define DIR_KERNEL(F, N, LR) \
    (descend ? (const void*)descend_kernel<F, S, N, LR> : (const void*)ascend_kernel<F, S, N, LR>)
#define FORM_KERNEL(F)                                                                  \
    (ndir == 1 ? (lr ? DIR_KERNEL(F, 1, true) : DIR_KERNEL(F, 1, false))               \
               : (lr ? DIR_KERNEL(F, 2, true) : DIR_KERNEL(F, 2, false)))
#endif
    switch (form) {
#if VISIT_REACH == 2
        case 6: return FORM_KERNEL(6);
        case 7: return FORM_KERNEL(7);
        case 8: return FORM_KERNEL(8);
        case 9: return FORM_KERNEL(9);
#elif VISIT_DIM == 3
        case 10: return FORM_KERNEL(10);
        case 11: return FORM_KERNEL(11);
        case 12: return FORM_KERNEL(12);
        case 13: return FORM_KERNEL(13);
        case 14: return FORM_KERNEL(14);
        case 15: return FORM_KERNEL(15);
#else
        case 0: return FORM_KERNEL(0);
        case 1: return FORM_KERNEL(1);
        case 2: return FORM_KERNEL(2);
        case 3: return FORM_KERNEL(3);
        case 4: return FORM_KERNEL(4);
        case 5: return FORM_KERNEL(5);
#endif
        default: return nullptr;
    }
#undef FORM_KERNEL
#undef DIR_KERNEL
}

// ------------------------------------------------------------ C entry points
extern "C" int mgmc_visit_params_size() { return (int)sizeof(VisitParams); }

extern "C" int mgmc_visit_tables_size() { return (int)sizeof(PhaseTables); }

extern "C" int mgmc_visit_stamp_width() { return PHASE_STAMP_WIDTH; }

extern "C" int mgmc_visit_stencil_forms() { return PHASE_FORMS; }

extern "C" int mgmc_visit_first_form() { return PHASE_FORM0; }

extern "C" int mgmc_visit_reach() { return VISIT_REACH; }

extern "C" int mgmc_visit_dim() { return VISIT_DIM; }

extern "C" int mgmc_visit_max_threads() { return PHASE_MAX_THREADS; }

extern "C" int mgmc_visit_stamps_build() { return PHASE_STAMPS_BUILD; }

// the largest static shared memory (bytes) of the library's kernels, or -1
extern "C" int mgmc_visit_static_smem() {
    size_t most = 0;
    for (int form = PHASE_FORM0; form < PHASE_FORM0 + PHASE_FORMS; ++form)
        for (int descend = 0; descend < 2; ++descend)
            for (int ndir = 1; ndir <= MAX_DIRS; ++ndir)
                for (int lr = 0; lr < 2; ++lr) {
                    cudaFuncAttributes a;
                    if (cudaFuncGetAttributes(&a, phase_kernel(descend, form, ndir, lr)) !=
                        cudaSuccess) {
                        cudaGetLastError();
                        return -1;
                    }
                    most = a.sharedSizeBytes > most ? a.sharedSizeBytes : most;
                }
    return (int)most;
}

// registers per thread, local (spill) bytes per thread and static shared bytes
// of the kernel of `descend` (1) or the ascend (0), a stencil form and a sweep
// count, of up to LANE_SLOTS measurements; 0 or an error
extern "C" int mgmc_visit_kernel_attributes(int descend, int form, int ndir, int* out) {
    const void* fn = phase_kernel(descend, form, ndir, false);
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

// the kernels' static shared memory at most (s_btx, s_wv, s_stage, the
// barrier count and the stamps pointer; mgmc_visit.py::PHASE_STATIC_SMEM)
#define PHASE_STATIC_BOUND (4 * (LANE_SLOTS + 32 * LANE_SLOTS + 32 * 128) + 16)

// Whether a launch with `smem_bytes` of dynamic shared memory must opt in to
// it: where the dynamic and the static share together exceed the 48 KiB a
// block gets without asking (the tables of a 15^3 level, 46,400 bytes beside
// the 3d build's 20,608 static, do).
static bool needs_opt_in(int smem_bytes) {
    return smem_bytes > 0 && smem_bytes + PHASE_STATIC_BOUND > 48 * 1024;
}

// blocks of `threads` with `smem_bytes` of dynamic shared memory that one SM
// holds at once (the kernel of a direction, a form and a sweep count, of up
// to LANE_SLOTS measurements), or -1
extern "C" int mgmc_visit_blocks_per_sm(int descend, int form, int ndir, int threads,
                                        int smem_bytes) {
    const void* fn = phase_kernel(descend, form, ndir, false);
    if (fn == nullptr) return -1;
    if (needs_opt_in(smem_bytes) &&
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes) !=
            cudaSuccess) {
        cudaGetLastError();
        return -1;
    }
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem_bytes) !=
        cudaSuccess) {
        cudaGetLastError();
        return -1;
    }
    return blocks;
}

// one launch of the kernel of (descend, form) with the arguments args; a
// stamps tensor goes to the stamps build only.  The dynamic shared memory must
// hold the tables where they are copied there and the low-rank scratch of a
// level of more than LANE_SLOTS measurements (visit_phases.cuh).
static int launch(int descend, int form, bool stamps, const VisitParams* P, const PhaseTables* L,
                  int threads, int smem_bytes, void** args, void* stream) {
    const void* fn = phase_kernel(descend, form, L->ndir, P->m > LANE_SLOTS);
    const long long need = 4LL * ((L->shared ? L->words : 0) +
                                  (long long)lowrank_scratch_floats(P->m, threads));
    if (fn == nullptr || stamps != (bool)PHASE_STAMPS_BUILD || threads > PHASE_MAX_THREADS ||
        P->m < 0 || smem_bytes < need)
        return (int)cudaErrorInvalidValue;
    if (needs_opt_in(smem_bytes)) {
        cudaError_t e =
            cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
    }
    cudaError_t e = cudaLaunchKernel(fn, dim3(P->C), dim3(threads), args, (size_t)smem_bytes,
                                     (cudaStream_t)stream);
    if (e != cudaSuccess) cudaGetLastError();
    return (int)e;
}

extern "C" int mgmc_descend_visit(const VisitParams* P, const PhaseTables* L, const void* tables,
                                  float* x, const float* f, float* scratch, float* fc,
                                  const float* coeffs, const float* ns, const float* xilr,
                                  const float* xi, int form, int threads, int smem_bytes,
                                  void* stamps, void* stream) {
    const int4* tab = static_cast<const int4*>(tables);
    unsigned long long* st = static_cast<unsigned long long*>(stamps);
    void* args[] = {(void*)P, (void*)L, &tab, &x, &f, &scratch, &fc, &coeffs, &ns, &xilr, &xi,
                    &st};
    return launch(1, form, st != nullptr, P, L, threads, smem_bytes, args, stream);
}

extern "C" int mgmc_ascend_visit(const VisitParams* P, const PhaseTables* L, const void* tables,
                                 float* x, const float* f, float* scratch, const float* xc,
                                 const float* coeffs, const float* ns, const float* xilr,
                                 const float* xi, int form, int threads, int smem_bytes,
                                 void* stamps, void* stream) {
    const int4* tab = static_cast<const int4*>(tables);
    unsigned long long* st = static_cast<unsigned long long*>(stamps);
    void* args[] = {(void*)P, (void*)L, &tab, &x, &f, &scratch, &xc, &coeffs, &ns, &xilr, &xi,
                    &st};
    return launch(0, form, st != nullptr, P, L, threads, smem_bytes, args, stream);
}
