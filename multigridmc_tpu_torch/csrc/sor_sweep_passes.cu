// Colour-ordered SOR and Gibbs sweep kernels for NVIDIA Hopper (sm_90a),
// float32, the one-block route built on the passes of level_passes.cuh: 2d
// stencils of reach 1 with at most 9 offsets, and, in this source's reach-2
// (-DVISIT_REACH=2) and 3d (-DVISIT_DIM=3) builds, the reach-2 and 3d
// 27-point fields too large for sor_sweep_smem.cu (255^2 and 127^2 reach 2,
// 31^3 27-point).
//
// Replace the Pallas kernels sweep_batched_v2 / gibbs_sweep_batched_v2 of
// multigridmc_tpu/ops/kernels/sor_pallas_v2.py (and, through the raw-array
// entry points of ops/kernels/sor_sweep.py, the four kernels of
// sor_pallas.py) for every 2d stencil the flagship's levels and the drivers
// give them; sor_sweep.cu keeps 3d fields and wider stencils.  One launch is
// one sweep of all chains, in place:
//
//   passes_sweep_kernel:  for colour ci in order:
//                             x[p] += omega (b[p] - (A_stencil x)[p]) / diag[p]
//                         on the points p of colour ci
//   passes_gibbs_kernel:  c = f + sqrt(diag (2-omega)/omega) xi into a scratch
//                         packed by colour (xi drawn in the kernel or read
//                         from a tensor), then the same sweep on c
//
// Design.  One thread block per chain, the fields in device memory, a barrier
// after the rhs pass and after each colour, as sor_sweep.cu; what differs is
// the body, the passes that the phase visit kernels and the subtree kernel
// run (level_passes.cuh) with no low-rank term (VisitParams with m = 0):
//
// * the sweep is sweep_colours: the stencil in registers (each offset an
//   address offset, each constant coefficient read once), LANE_POINTS points
//   a lane with all their loads in flight before any sum, the terms added in
//   offset order with out-of-field terms skipped, as sor_sweep.cu adds them
//   (so the routes agree to rounding);
// * a colour's rows are shared over all warps, from a rows table the host
//   builds for the sweep's order (mgmc_visit.colour_rows): an SSOR backward
//   sweep is another table;
// * the Gibbs rhs is rhs_packed: each group's f loaded before its draw, the
//   Philox numbering of sor_sweep.cu (group g of row r is r * ceil(X / 4) +
//   g, with chain and launch counter), c stored packed by colour
//   (packed_index), so that each colour reads whole sectors of it (on an
//   NVIDIA H100 at 256 chains of 255^2 the colours take 58 and 49 us against
//   73 and 68 with c a field; the first colour run in the rhs pass itself,
//   its later colours' c packed, took 121 us for the two and lost, PERF.md);
// * one kernel per stencil form (STENCIL_DISPATCH), chosen by the host, so
//   that each form's passes get the registers to themselves; the block size
//   by chain count (sor_sweep.py::sweep_threads).
//
// Bound: by bytes, per chain b or f (unless shared) and x read and x written
// once.  On top of that the kernels move the rhs scratch (written once, each
// colour's part read once) and x once per colour; at 256 chains of 255^2 the
// chains' fields exceed the 50 MB L2, so each colour reads x (and b at every
// other point) from device memory, near the card's memory rate for that
// traffic.
//
// The reach-2 and 3d builds take the stencil forms the phase kernels' builds
// of the same flags take (level_passes.cuh: 6-9 at reach 2, 10-15 in 3d, one
// kernel each), the parameter block of those builds (25 offsets and 9
// colours; 27 offsets and the z extents) and their colour rows (3d: (z, y)
// residue pairs); their kernels are bounded to 512 threads (a reach-2 or
// 27-offset stencil's operands fill a thread's registers), and they have no
// stamps build.  The host launches the 3d build for stencils of more than 7
// offsets only (a 7-point 63^3 sweep at 32 chains took 0.74 ms a launch here
// at 1024 threads, 0.86 at 512, against sor_sweep.cu's 0.64, on an H100:
// PERF.md).
//
// SWEEP_STAMPS_BUILD: the measurement build, a library of its own, taken only
// where the host passes a stamps tensor, (C, SWEEP_STAMP_WIDTH) int64, laid out
// as sor_sweep.cu's (both in block_stamps.cuh): the timer at entry, after the rhs
// pass and after each colour, at exit, the barriers passed, the SM.

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

#if VISIT_REACH == 2
#define PASSES_FORM0 WIDE_FORM0
#define PASSES_FORMS WIDE_FORMS
#define PASSES_MAX_THREADS 512
#elif VISIT_DIM == 3
#define PASSES_FORM0 DIM3_FORM0
#define PASSES_FORMS DIM3_FORMS
#define PASSES_MAX_THREADS 512
#else
#define PASSES_FORM0 0
#define PASSES_FORMS STENCIL_FORMS
#define PASSES_MAX_THREADS MAX_THREADS
#endif
#if SWEEP_STAMPS_BUILD && (VISIT_REACH != 1 || VISIT_DIM != 2)
#error "only the reach-1 2d build has a stamps build"
#endif

// the rows table is all a sweep reads of a level's tables
__device__ __forceinline__ LevelTables rows_only(const int* rows) {
    LevelTables T = {};
    T.rows = rows;
    return T;
}

template <int FORM, bool STAMPS>
__global__ void __launch_bounds__(PASSES_MAX_THREADS)
passes_sweep_kernel(const __grid_constant__ VisitParams P, const int* __restrict__ rows,
                    float* x_all, const float* __restrict__ b_all,
                    const float* __restrict__ coeffs, unsigned long long* stamps) {
    const int chain = blockIdx.x;
    const size_t n = (size_t)P.H * P.W;
    unsigned long long* srow = STAMPS ? stamps + (size_t)chain * SWEEP_STAMP_WIDTH : nullptr;
    stamps_open<STAMPS>(srow);
    level_sweep<FORM, STAMPS>(P, rows_only(rows), coeffs, b_all + (P.f_batched ? chain * n : 0),
                              x_all + chain * n);
    stamps_close<STAMPS>(srow, SWEEP_STAMP_WIDTH);
}

template <int FORM, bool STAMPS>
__global__ void __launch_bounds__(PASSES_MAX_THREADS)
passes_gibbs_kernel(const __grid_constant__ VisitParams P, const int* __restrict__ rows,
                    float* x_all, const float* __restrict__ f_all, float* scr_all,
                    const float* __restrict__ coeffs, const float* __restrict__ ns,
                    const float* __restrict__ xi_all, unsigned long long* stamps) {
    const int chain = blockIdx.x;
    const size_t n = (size_t)P.H * P.W;
    unsigned long long* srow = STAMPS ? stamps + (size_t)chain * SWEEP_STAMP_WIDTH : nullptr;
    stamps_open<STAMPS>(srow);
    const int s = P.jstride;
    float* cpk = scr_all + (size_t)chain * P.n_colors * P.H * ((P.W + s - 1) / s);
    rhs_packed<STAMPS>(P, chain, f_all + (P.f_batched ? chain * n : 0), ns,
                       P.noise_mode == 2 ? xi_all + chain * n : nullptr, cpk);
    level_sweep<FORM, STAMPS, true>(P, rows_only(rows), coeffs, cpk, x_all + chain * n);
    stamps_close<STAMPS>(srow, SWEEP_STAMP_WIDTH);
}

// the kernel of (gibbs, form) in this library's build; null for another form
static const void* passes_kernel(int gibbs, int form) {
    constexpr bool S = SWEEP_STAMPS_BUILD;
#define FORM_KERNEL(F) \
    (gibbs ? (const void*)passes_gibbs_kernel<F, S> : (const void*)passes_sweep_kernel<F, S>)
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
}

// ------------------------------------------------------------ C entry points
extern "C" int sor_passes_params_size() { return (int)sizeof(VisitParams); }

extern "C" int sor_passes_stamp_width() { return SWEEP_STAMP_WIDTH; }

extern "C" int sor_passes_stencil_forms() { return PASSES_FORMS; }

extern "C" int sor_passes_first_form() { return PASSES_FORM0; }

extern "C" int sor_passes_reach() { return VISIT_REACH; }

extern "C" int sor_passes_dim() { return VISIT_DIM; }

extern "C" int sor_passes_max_threads() { return PASSES_MAX_THREADS; }

extern "C" int sor_passes_stamps_build() { return SWEEP_STAMPS_BUILD; }

// registers per thread, local (spill) bytes per thread and static shared bytes
// of the kernel of (gibbs, form); 0 or an error
extern "C" int sor_passes_kernel_attributes(int gibbs, int form, int* out) {
    const void* fn = passes_kernel(gibbs, form);
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

// blocks of `threads` that one SM holds at once (the kernel of (gibbs, form)),
// or -1
extern "C" int sor_passes_blocks_per_sm(int gibbs, int form, int threads) {
    const void* fn = passes_kernel(gibbs, form);
    int blocks = 0;
    if (fn == nullptr ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, 0) != cudaSuccess) {
        cudaGetLastError();
        return -1;
    }
    return blocks;
}

// one launch of the kernel of (gibbs, form); a stamps tensor goes to the
// stamps build only
static int launch(int gibbs, int form, bool stamps, int C, int threads, void** args,
                  void* stream) {
    const void* fn = passes_kernel(gibbs, form);
    if (fn == nullptr || stamps != (bool)SWEEP_STAMPS_BUILD || threads > PASSES_MAX_THREADS)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaLaunchKernel(fn, dim3(C), dim3(threads), args, 0, (cudaStream_t)stream);
    if (e != cudaSuccess) cudaGetLastError();
    return (int)e;
}

extern "C" int sor_passes_sweep(const VisitParams* P, const int* rows, float* x, const float* b,
                                const float* coeffs, int form, int threads, void* stamps,
                                void* stream) {
    unsigned long long* st = static_cast<unsigned long long*>(stamps);
    void* args[] = {(void*)P, &rows, &x, &b, &coeffs, &st};
    return launch(0, form, st != nullptr, P->C, threads, args, stream);
}

// scratch: the packed rhs, n_colors * H * ceil(W / jstride) floats a chain
extern "C" int sor_passes_gibbs_sweep(const VisitParams* P, const int* rows, float* x,
                                      const float* f, float* scratch, const float* coeffs,
                                      const float* ns, const float* xi, int form, int threads,
                                      void* stamps, void* stream) {
    unsigned long long* st = static_cast<unsigned long long*>(stamps);
    void* args[] = {(void*)P, &rows, &x, &f, &scratch, &coeffs, &ns, &xi, &st};
    return launch(1, form, st != nullptr, P->C, threads, args, stream);
}
