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
//           descend visit of level l         (forward Gibbs sweep, Woodbury
//                                             with the sweep's low-rank noise,
//                                             residual, restriction -> f_{l+1})
//           sample(l + 1)
//           ascend visit of level l          (x_l += gamma P x_{l+1}, backward
//                                             Gibbs sweep, Woodbury)
//   sample(NL):  x = Linv^T (xi + Linv f)    (coarsest level, exact sample)
//
// Design.  One thread block per chain.  The recursion is flattened by the
// host into a schedule of (operation, level) pairs that the block walks, so
// the host launches once per step where the composed path launches once per
// visit and several times per coarse sample.  The visits are the passes of
// level_passes.cuh, which the phase visit kernels (mgmc_visit.cu) run too:
// each low-rank term in one pass, the stencil in registers and the sweep's
// rows balanced over the warps.  Each level's x, rhs scratch and f are fields of this chain;
// where a field lies is decided by the host and handed over as a location:
// dynamic shared memory (the small levels, where the granted size allows), a
// global workspace that the L2 holds, or, for the finest sub-level, the
// launch's own f and x tensors.  The arithmetic is the same.
//
// Tables.  At launch start the block copies the host-made tables
// (mgmc_subtree.py::launch_tables) into the front of its dynamic shared
// memory: every sub-level's VisitParams of both directions, B and both
// directions' Y inside their bounding boxes, W and Sigma^1/2,
// the rows that hold each colour of each sweep, and one slot of m floats per
// warp.  No operation reads a parameter or a low-rank value from device
// memory after that.
//
// Measurements.  Sub-levels of up to LANE_SLOTS (32) take the kernel above.
// Sub-levels of more take an instance of their own (WIDE): each warp's slot
// is 2 m floats and the block's m-vector follows the slots
// (visit_phases.cuh: each lane holds entries lane, lane + 32, ...); each
// level's boxes (m x BOX_INTS: B's, then each direction's Y's) are staged
// right after its Sigma^1/2; and where the tables do not fit a block's shared
// memory (each sub-level's two W are m^2 floats, 256 KiB each at m = 256)
// they stay in the launch's table tensor, read there by every pass, and only
// the slots and the vector lie at the front of shared memory (the host says
// so with warp_vec = 0: in shared memory the slots follow the tables).
//
// The coarse sample is two nc x nc matrix-vector products per chain against
// the inverse Cholesky factor (Linv and its transpose, both row major, shared
// by all chains and resident in L2): a thread per output, only the triangle
// that is nonzero, each product reading the layout in which a warp's loads
// are consecutive.
//
// Bound: by bytes the launch must read f and write x of the finest sub-level
// once per chain; everything else is meant to stay on the chip.  What the
// kernel pays is the instructions it executes per point on 32 warps of an SM
// (two blocks of 512 threads) and, on the finest sub-level, whose fields lie
// in device memory, the L2's latency.  Barriers: the table copy 1, a descend
// n_order + 5, an ascend n_order + 3 (each 2 fewer where m = 0), a coarse
// sample 2.
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
//
// Reach 2: the squared shifted-Laplace prior's sub-levels (the 25-point 5x5
// box of its Galerkin levels, or a reach-2 stencil of at most 13 offsets, up
// to 9 colours) take a library of their own, this source built with
// -DVISIT_REACH=2 as the phase kernels' reach-2 build is: the parameter block
// of 25 offsets and 9 colours in the tables, and the reach-2 forms of
// level_passes.cuh (WIDE_FORM0 ..), the level's form found by the host
// (SubLevel::form), so the reach-1 build keeps its kernel as it is.  Its
// sweeps take the colours' point lists (sweep_points of level_passes.cuh):
// at 9 colours a row holds 3 or 4 points of a colour, so a warp per row kept
// 28 of its 32 lanes idle, and every point read its 25 coefficient planes;
// from the lists all threads take a colour's points, and the interior points
// (all but the edge) take the level's interior values held as coeff_val (on
// an H100 at 256 chains the launch took 4.27 ms with the row sweeps and one
// block of 512 threads an SM, 2.37 with the lists, 1.82 with the lists and
// two blocks of 256 an SM, which the host launches at reach 2
// (mgmc_subtree.py::REACH2_THREADS; PERF.md).  A thread
// holds the box's 25 operands and coefficients: the production kernel is
// bounded to SUBTREE_THREADS = 512 threads a block (128 registers a thread);
// an instance bounded to 1024 (64 registers) serves launches of 1024 threads,
// which only the block-size measurement makes.  Each reach-2 instance is a
// library of its own (SUBTREE_PART: 0 the production kernel, 1 its stamps
// build, 2 the 1024-thread instance), so that the three compile in parallel;
// the reach-1 library holds all of its instances.

#ifndef VISIT_REACH
#define VISIT_REACH 1
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

// the block size the production kernel is bounded to
#if VISIT_REACH == 2
#define SUBTREE_THREADS 512
#else
#define SUBTREE_THREADS MAX_THREADS
#endif

// the instances this library holds (see the head of the file)
#ifndef SUBTREE_PART
#define SUBTREE_PART 0
#endif
#if VISIT_REACH == 2
#define HAS_PRODUCTION (SUBTREE_PART == 0)
#define HAS_STAMPED (SUBTREE_PART == 1)
#define HAS_WIDE_BLOCK (SUBTREE_PART == 2)
#elif SUBTREE_PART != 0
#error "the reach-1 build is one library"
#else
#define HAS_PRODUCTION 1
#define HAS_STAMPED 1
#define HAS_WIDE_BLOCK 0  // its production kernel takes 1024 threads
#endif

#define MAX_SUB_LEVELS 8

#define OP_DESCEND 0
#define OP_DESCEND_ZERO 1  // zero the level's x first: entry of sample(l)
#define OP_COARSE 2
#define OP_ASCEND 3

#define LOC_SHARED 0     // dynamic shared memory after the tables, offset in floats
#define LOC_WORKSPACE 1  // this chain's slice of the global workspace, offset in floats
#define LOC_LAUNCH 2     // the launch's own tensor (f or x of the finest sub-level)

struct FieldLoc {
    int where;
    int pad;
    long long off;
};

// Per sub-level: the planes read per point, where its fields lie, and where
// its tables lie in shared memory (word offsets from the start of the staged
// tables; direction 0 the pre / descend sweep, 1 the post / ascend sweep).
// At reach 2 also the colours' point lists of each direction (PointTables:
// the entries at pts[dir] of the launch's point table in device memory; their
// starts and interior counts at phead[dir] of the staged tables) and the
// stencil form (level_passes.cuh).
struct SubLevel {
    const float* coeffs;
    const float* ns;
    FieldLoc x, scr, f;
    int n;
    int plan[2];  // VisitParams
    int bval, boff;
    int yval[2], yoff[2];
    int wm[2];
    int sroot;    // Sigma^1/2
    int rows[2];  // the colours' rows of each direction's sweep
    long long pts[2];
    int phead[2];
    int form, pad;
};

struct SubtreeParams {
    int C, NL, n_sched, noise_mode, nc, record;
    long long ws_stride;  // floats of workspace per chain
    long long xi_stride;  // normals per chain in xi_all
    unsigned long long seed;
    unsigned long long counter;
    SubLevel lv[MAX_SUB_LEVELS];
    FieldLoc cx, cscr, cf;  // the coarsest level's vectors
    int table_words;        // staged tables at the start of dynamic shared memory (a multiple of 4)
    int warp_vec;           // word offset of the warps' slots (32 of warp_stride words)
    int warp_stride;
    int pass_width;         // words a block of pass_stamps
    // null, or (C, n_sched + 1 + STAMP_EXTRA), written by thread 0 of each
    // block: the %globaltimer (ns) before the first operation and after each,
    // then at kernel entry (before the table copy), at exit, the barriers the
    // block passed and the SM it ran on
    unsigned long long* stamps;
    // null, or (C, pass_width) in the stamps build: the timer at kernel entry,
    // then after each barrier the block passes (every pass of every operation)
    unsigned long long* pass_stamps;
};

#define STAMP_EXTRA 4

extern __shared__ __align__(16) float dyn_smem[];

__device__ __forceinline__ float* locate(const SubtreeParams& S, const FieldLoc& L, float* ws,
                                         float* launch) {
    if (L.where == LOC_SHARED) return dyn_smem + S.table_words + L.off;
    if (L.where == LOC_WORKSPACE) return ws + L.off;
    return launch;
}

// thread 0 writes v into its block's stamps
__device__ __forceinline__ void stamp_value(const SubtreeParams& S, int chain, int slot,
                                            unsigned long long v) {
    if (threadIdx.x == 0) S.stamps[(size_t)chain * (S.n_sched + 1 + STAMP_EXTRA) + slot] = v;
}

__device__ __forceinline__ void stamp(const SubtreeParams& S, int chain, int slot) {
    if (threadIdx.x == 0) stamp_value(S, chain, slot, global_timer());
}

// The level's tables of direction dir, staged at t (the WIDE instance: in
// shared or device memory; the boxes after Sigma^1/2), else in shared memory
// with the boxes in the parameter block.
template <bool WIDE>
__device__ __forceinline__ LevelTables level_tables(const float* t, const SubLevel& L, int dir) {
    const VisitParams& P = *reinterpret_cast<const VisitParams*>(t + L.plan[dir]);
    const int(*bbox)[BOX_INTS] = P.bbox;
    const int(*ybox)[BOX_INTS] = P.ybox;
    if constexpr (WIDE) {
        const int* boxes = reinterpret_cast<const int*>(t + L.sroot + P.m);
        bbox = reinterpret_cast<const int(*)[BOX_INTS]>(boxes);
        ybox = reinterpret_cast<const int(*)[BOX_INTS]>(boxes + (1 + dir) * P.m * BOX_INTS);
    }
    return {t + L.bval, reinterpret_cast<const int*>(t + L.boff), t + L.yval[dir],
            reinterpret_cast<const int*>(t + L.yoff[dir]), t + L.wm[dir], t + L.sroot,
            bbox, ybox, nullptr, nullptr,
            reinterpret_cast<const int*>(t + L.rows[dir])};
}

// x = Linv^T (xi + Linv f) for one chain; g takes xi + Linv f.  A thread per
// output, its loop along the other index reading the factor where the lanes'
// outputs lie side by side: g[i] from the transpose's row j (Linv[i, j] for
// consecutive i), x[j] from the factor's row i, only the triangle that is
// nonzero, loads unrolled ahead of their sums (a warp per output row with a
// shuffle tree waited on the L2 once per row: 18-21 us a sample on an H100,
// PERF.md).  The normal of row i is the generator's group i / 4, element
// i % 4, drawn by the thread of row i.  Two barriers.
template <bool COUNT>
__device__ void coarse_sample(const SubtreeParams& S, int chain, const float* __restrict__ Linv,
                              const float* __restrict__ LinvT, const float* f, float* g,
                              float* x, float* xi, long long cur, unsigned long long draw) {
    const int nc = S.nc;
    for (int i = threadIdx.x; i < nc; i += blockDim.x) {
        float z = 0.0f;
        if (S.noise_mode == 1) {
            float z4[4];
            philox_normals4((uint32_t)(i >> 2), (uint32_t)chain, S.seed, S.counter + draw, z4);
            const int q = i & 3;
            z = q == 0 ? z4[0] : (q == 1 ? z4[1] : (q == 2 ? z4[2] : z4[3]));
            if (S.record) xi[cur + i] = z;
        } else if (S.noise_mode == 2) {
            z = xi[cur + i];
        }
        // g[i] = z_i + sum_{j <= i} Linv[i, j] f[j]
        float acc = 0.0f;
#pragma unroll 8
        for (int j = 0; j <= i; ++j) acc += LinvT[(size_t)j * nc + i] * f[j];
        g[i] = z + acc;
    }
    block_sync<COUNT>();
    // x[j] = sum_{i >= j} Linv[i, j] g[i]
    for (int j = threadIdx.x; j < nc; j += blockDim.x) {
        float acc = 0.0f;
#pragma unroll 8
        for (int i = j; i < nc; ++i) acc += Linv[(size_t)i * nc + j] * g[i];
        x[j] = acc;
    }
    block_sync<COUNT>();
}

#if VISIT_REACH == 2
// CALL(FORM) for the level's reach-2 form (level_passes.cuh: 6 / 7 a stencil
// of at most 13 offsets, 8 / 9 the 5x5 box in raster order; the odd ones read
// a coefficient plane per point), which the host found
// (mgmc_visit.py::stencil_form), each form compiled in
#define LEVEL_FORM(L, CALL)                        \
    switch ((L).form) {                            \
        case WIDE_FORM0: CALL(WIDE_FORM0); break;  \
        case WIDE_FORM0 + 1: CALL(WIDE_FORM0 + 1); break; \
        case WIDE_FORM0 + 2: CALL(WIDE_FORM0 + 2); break; \
        default: CALL(WIDE_FORM0 + 3); break;      \
    }
#else
// the reach-1 passes find the level's form themselves (STENCIL_DISPATCH)
#define LEVEL_FORM(L, CALL) CALL(-1)
#endif

// STAMPS: the measurement build, which writes the stamps (S.stamps not null)
// and counts the barriers; production launches take the other one.  BOUND:
// the block size the instance is compiled for (SUBTREE_THREADS; at reach 2
// also 1024).  WIDE: sub-levels of more than LANE_SLOTS measurements.
template <bool STAMPS, int BOUND, bool WIDE>
__global__ void __launch_bounds__(BOUND)
mgmc_subtree_kernel(const __grid_constant__ SubtreeParams S, const int4* __restrict__ tables,
                    const int* __restrict__ sched, const float* __restrict__ Linv,
                    const float* __restrict__ LinvT, const float* f_all, float* x_all,
                    float* ws_all, float* xi_all, const int* __restrict__ points) {
    __shared__ float s_btx[LANE_SLOTS];
    const int chain = blockIdx.x;
    const int n0 = S.lv[0].n;
    float* ws = ws_all + (size_t)chain * S.ws_stride;
    float* f_launch = const_cast<float*>(f_all) + (size_t)chain * n0;  // only read
    float* x_launch = x_all + (size_t)chain * n0;
    float* xi = xi_all ? xi_all + (size_t)chain * S.xi_stride : nullptr;
    float* wv = dyn_smem + S.warp_vec + (threadIdx.x >> 5) * S.warp_stride;  // this warp's slot
    // the block's m-vector, and where the passes read the tables
    float* btx = WIDE ? dyn_smem + S.warp_vec + 32 * S.warp_stride : s_btx;
    const bool copied = !WIDE || S.warp_vec > 0;
    const float* t = copied ? dyn_smem : reinterpret_cast<const float*>(tables);
    long long cur = 0;            // normals this chain has consumed
    unsigned long long draw = 0;  // draws of the launch so far
    if (STAMPS) {
        stamp(S, chain, S.n_sched + 1);
        if (threadIdx.x == 0) {
            pass_sync_count = 0;
            // per operation in S.stamps; per pass where S.pass_stamps is set
            pass_stamp_row = S.pass_stamps ? S.pass_stamps + (size_t)chain * S.pass_width
                                           : nullptr;
            if (pass_stamp_row != nullptr) pass_stamp_row[0] = global_timer();
        }
    }

    // the launch's tables, once
    int4* tab = reinterpret_cast<int4*>(dyn_smem);
    for (int q = threadIdx.x; copied && q < S.table_words / 4; q += blockDim.x) tab[q] = tables[q];
    if (S.lv[0].f.where != LOC_LAUNCH) {
        float* f0 = locate(S, S.lv[0].f, ws, nullptr);
        for (int p = threadIdx.x; p < n0; p += blockDim.x) f0[p] = f_launch[p];
    }
    block_sync<STAMPS>();
    if (STAMPS) stamp(S, chain, 0);

    for (int s = 0; s < S.n_sched; ++s) {
        const int op = sched[2 * s], li = sched[2 * s + 1];
        if (op == OP_COARSE) {
            coarse_sample<STAMPS>(S, chain, Linv, LinvT, locate(S, S.cf, ws, nullptr),
                          locate(S, S.cscr, ws, nullptr), locate(S, S.cx, ws, nullptr), xi, cur,
                          draw);
            if (S.noise_mode) { cur += S.nc; draw += 1; }
            if (STAMPS) stamp(S, chain, s + 1);
            continue;
        }
        const SubLevel& L = S.lv[li];
        const int dir = (op == OP_ASCEND) ? 1 : 0;
        const VisitParams& P = *reinterpret_cast<const VisitParams*>(t + L.plan[dir]);
        const LevelTables T = level_tables<WIDE>(t, L, dir);
        const int n = L.n, m = P.m;
        float* x = locate(S, L.x, ws, x_launch);
        float* scr = locate(S, L.scr, ws, nullptr);
        const float* f = locate(S, L.f, ws, f_launch);
        const float* xi_in = (S.noise_mode == 2) ? xi + cur : nullptr;
        float* xi_rec = (S.noise_mode == 1 && S.record) ? xi + cur : nullptr;
        if (S.noise_mode && m)  // the m low-rank normals of this sweep, after its field
            lowrank_normals<WIDE>(m, chain, S.noise_mode, S.seed, S.counter + draw + 1,
                            xi_in ? xi_in + n : nullptr, xi_rec ? xi_rec + n : nullptr, wv);
        const bool last = li + 1 == S.NL;
        const auto one_direction = [&](int) { return T; };
        using OneDirection = decltype(one_direction);
#if VISIT_REACH == 2
        // the sweep from the colours' point lists
        const int* head = reinterpret_cast<const int*>(t + L.phead[dir]);
        const PointTables Q = {points + L.pts[dir], head, head + P.n_order + 1};
#define POINT_SWEEP true
#else
        const PointTables Q = {};
#define POINT_SWEEP false
#endif
        if (dir == 0) {
            float* fc = locate(S, last ? S.cf : S.lv[li + 1].f, ws, nullptr);
#define DESCEND(FORM)                                                                         \
    level_descend<FORM, STAMPS, 1, OneDirection, POINT_SWEEP, WIDE>(                          \
        P, one_direction, 1, chain, S.noise_mode, S.seed, S.counter + draw,                   \
        op == OP_DESCEND_ZERO, false, x, f, scr, fc, L.coeffs, L.ns, xi_in, 0, nullptr,       \
        xi_rec, wv, btx, nullptr, &Q)
            LEVEL_FORM(L, DESCEND);
#undef DESCEND
        } else {
            const float* xc = locate(S, last ? S.cx : S.lv[li + 1].x, ws, nullptr);
#define ASCEND(FORM)                                                                          \
    level_ascend<FORM, STAMPS, 1, OneDirection, POINT_SWEEP, WIDE>(                           \
        P, one_direction, 1, chain, S.noise_mode, S.seed, S.counter + draw, x, f, scr, xc,    \
        L.coeffs, L.ns, xi_in, 0, nullptr, xi_rec, wv, btx, nullptr, &Q)
            LEVEL_FORM(L, ASCEND);
#undef ASCEND
        }
#undef POINT_SWEEP
        if (S.noise_mode) { cur += n + m; draw += m ? 2 : 1; }
        if (STAMPS) stamp(S, chain, s + 1);
    }

    if (S.lv[0].x.where != LOC_LAUNCH) {
        const float* x0 = locate(S, S.lv[0].x, ws, nullptr);
        for (int p = threadIdx.x; p < n0; p += blockDim.x) x_launch[p] = x0[p];
    }
    if (STAMPS) {
        unsigned sm;
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
        stamp(S, chain, S.n_sched + 2);
        stamp_value(S, chain, S.n_sched + 3, pass_sync_count);
        stamp_value(S, chain, S.n_sched + 4, sm);
    }
}

// ------------------------------------------------------------ C entry points
// the production instance, its stamps build, and at reach 2 the instance for
// 1024 threads, each null where this library does not hold it
// each of up to LANE_SLOTS measurements (m32) and of more (wide)
#if HAS_PRODUCTION
#define PRODUCTION(W) mgmc_subtree_kernel<false, SUBTREE_THREADS, W>
#else
#define PRODUCTION(W) nullptr
#endif
#if HAS_STAMPED
#define STAMPED(W) mgmc_subtree_kernel<true, SUBTREE_THREADS, W>
#else
#define STAMPED(W) nullptr
#endif
#if HAS_WIDE_BLOCK
#define WIDE_BLOCK(W) mgmc_subtree_kernel<false, MAX_THREADS, W>
#else
#define WIDE_BLOCK(W) nullptr
#endif

typedef void (*SubtreeKernelFn)(const SubtreeParams, const int4*, const int*, const float*,
                                const float*, const float*, float*, float*, float*, const int*);

// the instance a launch of `threads` takes, of sub-levels of more than
// LANE_SLOTS measurements (wide) or not, or null where this library does not
// hold it (the stamps build only at up to SUBTREE_THREADS)
static SubtreeKernelFn instance(bool stamps, int threads, bool wide) {
    if (threads < 1 || threads > MAX_THREADS) return nullptr;
    if (threads <= SUBTREE_THREADS)
        return stamps ? (wide ? STAMPED(true) : STAMPED(false))
                      : (wide ? PRODUCTION(true) : PRODUCTION(false));
    return stamps ? nullptr : (wide ? WIDE_BLOCK(true) : WIDE_BLOCK(false));
}

extern "C" int mgmc_subtree_params_size() { return (int)sizeof(SubtreeParams); }

extern "C" int mgmc_subtree_visit_params_size() { return (int)sizeof(VisitParams); }

extern "C" int mgmc_subtree_reach() { return VISIT_REACH; }

extern "C" int mgmc_subtree_part() { return SUBTREE_PART; }

// the block size the production kernel is bounded to
extern "C" int mgmc_subtree_max_threads() { return SUBTREE_THREADS; }

// the static shared memory in bytes of the largest instance held, or -1
extern "C" int mgmc_subtree_static_smem() {
    int most = 0;
    const SubtreeKernelFn held[] = {PRODUCTION(false), STAMPED(false), WIDE_BLOCK(false),
                                    PRODUCTION(true), STAMPED(true), WIDE_BLOCK(true)};
    for (SubtreeKernelFn fn : held) {
        if (fn == nullptr) continue;
        cudaFuncAttributes a;
        if (cudaFuncGetAttributes(&a, fn) != cudaSuccess) {
            cudaGetLastError();
            return -1;
        }
        most = a.sharedSizeBytes > (size_t)most ? (int)a.sharedSizeBytes : most;
    }
    return most;
}

// registers per thread and local (spilled) bytes per thread of the production
// instance (which 0), the stamps build (1) or the 1024-thread instance (2), of
// up to LANE_SLOTS measurements; -1 where this library does not hold it or
// the query fails
extern "C" int mgmc_subtree_attributes(int which, int* regs, int* local_bytes) {
    SubtreeKernelFn fn =
        which == 0 ? PRODUCTION(false) : (which == 1 ? STAMPED(false) : WIDE_BLOCK(false));
    cudaFuncAttributes a;
    if (fn == nullptr || cudaFuncGetAttributes(&a, fn) != cudaSuccess) {
        cudaGetLastError();
        return -1;
    }
    *regs = a.numRegs;
    *local_bytes = (int)a.localSizeBytes;
    return 0;
}

// the static shared memory the host keeps for the kernels at most
// (mgmc_subtree.py::STATIC_SMEM_RESERVE; mgmc_subtree_static_smem reports
// what they declare)
#define SUBTREE_STATIC_BOUND 4096

// Whether a launch with `smem_bytes` of dynamic shared memory must opt in to
// it: where the dynamic and the static share together exceed the 48 KiB a
// block gets without asking.
static bool needs_opt_in(int smem_bytes) {
    return smem_bytes > 0 && smem_bytes + SUBTREE_STATIC_BOUND > 48 * 1024;
}

// blocks of `threads` with `smem_bytes` of dynamic shared memory that one SM
// holds at once in the production build (of up to LANE_SLOTS measurements),
// or -1
extern "C" int mgmc_subtree_blocks_per_sm(int threads, int smem_bytes) {
    SubtreeKernelFn fn = instance(false, threads, false);
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

// points: the colours' point lists of the reach-2 sub-levels (null where
// none has them); wide: a sub-level has more than LANE_SLOTS measurements
extern "C" int mgmc_subtree_sample(const SubtreeParams* S, const void* tables, const int* sched,
                                   const float* Linv, const float* LinvT, const float* f, float* x,
                                   float* ws, float* xi, const int* points, int threads,
                                   int smem_bytes, int wide, void* stream) {
    SubtreeKernelFn fn = instance(S->stamps != nullptr, threads, wide != 0);
    if (fn == nullptr) return (int)cudaErrorInvalidConfiguration;
    if (needs_opt_in(smem_bytes)) {
        cudaError_t e =
            cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
    }
    fn<<<S->C, threads, smem_bytes, (cudaStream_t)stream>>>(
        *S, static_cast<const int4*>(tables), sched, Linv, LinvT, f, x, ws, xi, points);
    return (int)cudaGetLastError();
}
