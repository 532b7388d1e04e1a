// Colour-ordered SOR and Gibbs sweep kernels for NVIDIA Hopper (sm_90a),
// float32, for 3d stencils of reach 1 and at most 7 offsets on fields whose
// chain does not fit one block's shared memory: each chain's field in slabs
// of whole z-planes over a thread-block cluster.
//
// Replace the Pallas kernels sweep_batched_v2 / gibbs_sweep_batched_v2 of
// multigridmc_tpu/ops/kernels/sor_pallas_v2.py in their 3d 7-point form on
// such fields (ops/kernels/sor_sweep.py::sweep_body names the body "smem3d":
// the 64^3 posterior's 63^3 level, a 32^3 lattice's 31^3).  One launch is one
// sweep of all chains, in place:
//
//   smem3d_sweep_kernel<false>:  for colour ci in order:
//                                    x[p] += omega (b[p] - (A_stencil x)[p]) / diag[p]
//                                on the points p of colour ci
//   smem3d_sweep_kernel<true>:   the same sweep on c = f + sqrt(diag (2-omega)/omega) xi,
//                                xi ~ N(0, 1) drawn in the kernel (or read from a tensor)
//
// Why.  sor_sweep.cu, which took these fields before, runs one block per
// chain over the field in device memory: at 32 chains 100 of an H100's 132
// SMs idle, every colour reads the seven neighbours of a point through the L2
// with a bounds test on each, and every row recomputes a division and a
// modulo.  Here, as in the 3d visits (mgmc_visit_smem3d.cu; slab3d.cuh holds
// what the two share):
//
// * Residency.  A cluster of S blocks (1 to 16; above 8 the cluster is not
//   portable) holds one chain: block k its slab of z-planes [z0, z1) (slab_of)
//   in dynamic shared memory, each plane padded with a zero row and column a
//   side, and a ghost plane a side (zero at the field's z faces).  x is copied
//   in once with cp.async and written back once.  The rhs sits beside it where
//   the host says it fits (c_shared): the deterministic kernel copies b's slab
//   in, the Gibbs kernel forms c = f + ns xi there during the copy-in.
//   Elsewhere the deterministic kernel reads b where a point is updated (each
//   point once a sweep) and the Gibbs kernel writes c to the chain's scratch
//   field in the copy-in pass and reads it there.
// * Across a cut.  After each cluster barrier (the copy-in's, each colour's)
//   every block copies its neighbours' edge planes from their shared memory
//   (cluster.map_shared_rank) into its ghost planes, then a block barrier:
//   every point then reads its own shared memory, and a point next to a cut
//   is an interior point like any other.  During colour c only colour-c points
//   change and no colour-c point reads another, so the copy taken after the
//   barrier that ends colour c - 1 holds every value colour c reads.
// * Colours.  Each thread takes its points from the tables of the 3d visits
//   (mgmc_visit_smem3d.py::visit_tables, the sweep's one order): colour after
//   colour, first the interior points, whose every coefficient is the level's
//   interior value (the scalars cval, no bounds test, SWEEP3D_POINTS of them a
//   thread in flight), then the edge points (the coefficient planes that vary
//   read from device memory, a neighbour beyond the field reads the zero
//   halo), each part dealt round the 32 banks.
// * The diagonal enters as its reciprocal (a scalar for the interior points,
//   the host's reciprocal plane for edge points whose diagonal varies) with
//   one FMA correction: the correctly rounded quotient of sor_sweep.cu's
//   division, as in sor_sweep_smem.cu.  The terms are added in offset order,
//   as sor_sweep.cu adds them (a neighbour in the halo adds +-0), so the
//   bodies agree to rounding.
// * Noise: the generator of philox.cuh with sor_sweep.cu's numbering, group g
//   of row r = z Y + y is r ceil(X / 4) + g, with the chain and the launch
//   counter, so the bodies agree under one stream; noise_mode 2 reads xi.
//
// Barriers (smem_sync; the stamps build counts and stamps each): the copy-in
// (and the Gibbs rhs), then each colour; each a cluster barrier (a block's
// where S is 1).  A ghost copy's block barrier belongs to the colour it opens
// and is not counted.  The last colour's barrier also keeps every block alive
// until no neighbour reads its planes.
//
// Bound: by bytes, per chain x read and written and b (unless shared) read
// once; the coefficient planes that vary, the tables and the reciprocal plane
// stay in the L2 for all chains.  What the design spends on top: the ghost
// planes, two planes of shared memory a block and colour, and with c not in
// shared memory the Gibbs kernel's scratch field (written and read once).
//
// SWEEP_STAMPS_BUILD: the measurement build, a library of its own, taken only
// where the host passes a stamps tensor, (C S, SWEEP3D_STAMP_WIDTH) int64,
// per block (block_stamps.cuh): the timer at entry and after each barrier, at
// exit, the barriers passed, the SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_stamps.cuh"
#include "philox.cuh"
#include "slab3d.cuh"

// the stencil size the kernels are compiled for: a stencil of fewer offsets
// is padded by the host with zero coefficients at the centre (each adds +-0)
#define SWEEP3D_KMAX 7
#define SWEEP3D_MAX_CLUSTER 16
#define SWEEP3D_MAX_THREADS 1024
// colours of the tables' heads: the layout of mgmc_visit_smem3d.py's tables,
// per rank the n_order + 1 starts of the colours' entries, then from word
// SWEEP3D_MAX_COLORS + 1 on each colour's interior points
#define SWEEP3D_MAX_COLORS 8
#define SWEEP3D_HEAD_INTS (2 * SWEEP3D_MAX_COLORS + 1)
// interior points a thread carries at once: as many FMA chains in flight
#define SWEEP3D_POINTS 4
// the timer at entry, after the copy-in and up to SWEEP3D_MAX_COLORS colours,
// at exit, the barriers passed, the SM
#define SWEEP3D_STAMP_WIDTH (2 + SWEEP3D_MAX_COLORS + 3)

struct Smem3dSweepParams {
    int C, Z, Y, X;           // chains and the field's extents, slowest axis first
    int S;                    // blocks a chain (the cluster's size)
    int PX;                   // a padded row: X + 2
    int PP;                   // a padded plane: (Y + 2) PX
    int nz_max;               // planes of the widest slab
    int c_shared;             // 1: the rhs in shared memory beside x
    int K, diag_index;
    int soff[SWEEP3D_KMAX];   // offset k in the padded slab: dz PP + dy PX + dx (0 from K on)
    float cval[SWEEP3D_KMAX]; // the interior coefficients (0 from K on)
    float rdiag;              // 1 / cval[diag_index]
    unsigned planes;          // bit k: coefficient k varies (the edge points read its plane)
    int n_order;
    float omega;
    int noise_mode;  // 0 off, 1 in-kernel Philox, 2 xi read from a tensor
    int ns_const;
    float ns_val;
    int b_batched;
    unsigned long long seed;
    unsigned long long counter;
};

extern __shared__ __align__(16) float smem_slab[];

// omega (c - ax) / d from the reciprocal rd and one correction (the
// product's residual is exact in an FMA): the correctly rounded quotient
__device__ __forceinline__ float sor_step(float omega, float c, float ax, float d, float rd) {
    const float num = omega * (c - ax);
    const float q0 = num * rd;
    return fmaf(fmaf(-q0, d, num), rd, q0);
}

// ------------------------------------------------------------------- kernel
template <bool GIBBS, bool STAMPS>
__global__ void __launch_bounds__(SWEEP3D_MAX_THREADS)
smem3d_sweep_kernel(const __grid_constant__ Smem3dSweepParams P, const int* __restrict__ tables,
                    float* x_all, const float* __restrict__ b_all, float* scr_all,
                    const float* __restrict__ coeffs, const float* __restrict__ rdiag,
                    const float* __restrict__ ns, const float* __restrict__ xi_all,
                    unsigned long long* stamps) {
    cg::cluster_group cluster = cg::this_cluster();
    const int S = P.S, PX = P.PX, PP = P.PP;
    const int rank = S > 1 ? (int)cluster.block_rank() : 0;
    const int chain = blockIdx.x / S;
    const int Y = P.Y, X = P.X, n2 = Y * X, n = P.Z * n2;
    const int tid = threadIdx.x, nthreads = blockDim.x;
    unsigned long long* srow =
        STAMPS ? stamps + (size_t)blockIdx.x * SWEEP3D_STAMP_WIDTH : nullptr;
    stamps_open<STAMPS>(srow);

    int z0, nz, lo_z0, lo_nz;
    slab_of(P.Z, S, rank, &z0, &nz);
    slab_of(P.Z, S, rank > 0 ? rank - 1 : 0, &lo_z0, &lo_nz);
    const int first = z0 * n2;
    float* xs = smem_slab;                  // slab plane lz at padded plane lz + 1
    float* cs = xs + (P.nz_max + 2) * PP;   // the rhs (c_shared), Y X a plane
    const bool csh = P.c_shared != 0;
    float* x = x_all + (size_t)chain * n;
    const float* b = b_all + (P.b_batched ? (size_t)chain * n : 0);
    // the rhs in device memory where it is not in shared memory: b itself, or
    // the Gibbs kernel's c in the chain's scratch field
    float* scr = GIBBS && !csh ? scr_all + (size_t)chain * n : nullptr;
    const float* cg_ = GIBBS ? scr : b;
    const float* xlo = S > 1 ? cluster.map_shared_rank(xs, rank > 0 ? rank - 1 : rank) : xs;
    const float* xhi = S > 1 ? cluster.map_shared_rank(xs, rank + 1 < S ? rank + 1 : rank) : xs;

    // 1. the slab of x into its padded planes (in flight while the rhs is
    //    formed), the halo and the ghost planes zeroed; the rhs
    slab_load(xs, x + first, nz, Y, X, PX);
    if (!GIBBS) {
        if (csh)
            for (int t = tid; t < nz * n2; t += nthreads) cp_async4(cs + t, b + first + t);
    } else {
        // c = f + ns xi by point groups (four consecutive points of a row),
        // each group's f loaded before its draw
        const float* xi = P.noise_mode == 2 ? xi_all + (size_t)chain * n : nullptr;
        const int G4 = (X + 3) >> 2;
        for (int t = tid; t < nz * Y * G4; t += nthreads) {
            const int lr = t / G4, g = t - lr * G4;
            const int i = z0 * Y + lr;  // the row z Y + y
            float fv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) fv[q] = 4 * g + q < X ? b[i * X + 4 * g + q] : 0.0f;
            float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (P.noise_mode == 1)
                philox_normals4((uint32_t)(i * G4 + g), (uint32_t)chain, P.seed, P.counter, z);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int j = 4 * g + q;
                if (j >= X) break;
                const int p = i * X + j;
                const float zq = P.noise_mode == 2 ? xi[p] : z[q];
                const float c = fv[q] + (P.ns_const ? P.ns_val : ns[p]) * zq;
                if (csh)
                    cs[p - first] = c;
                else
                    scr[p] = c;
            }
        }
    }
    cp_async_wait_all();
    // every slab loaded before any block reads a neighbour's planes
    smem_sync<STAMPS>(cluster, S);

    // 2. the colour phases on the slab, from the table of this rank
    const int* head = tables + (size_t)rank * SWEEP3D_HEAD_INTS;
    const float omega = P.omega;
    const float dval = P.cval[P.diag_index], rval = P.rdiag;
    const bool dplane = (P.planes >> P.diag_index) & 1u;
    for (int o = 0; o < P.n_order; ++o) {
        if (S > 1) ghost_copy(S, PX, PP, xs, xlo, xhi, rank, nz, lo_nz, Y, X);
        const int e0 = __ldg(head + o), count = __ldg(head + o + 1) - e0;
        const int plain = __ldg(head + SWEEP3D_MAX_COLORS + 1 + o);
        //    the interior points, SWEEP3D_POINTS a thread at once: their
        //    entries and rhs first, then as many FMA chains side by side (each
        //    in offset order)
        for (int t = tid; t < plain; t += SWEEP3D_POINTS * nthreads) {
            int q[SWEEP3D_POINTS];
            float cv[SWEEP3D_POINTS], ax[SWEEP3D_POINTS];
#pragma unroll
            for (int u = 0; u < SWEEP3D_POINTS; ++u) {
                const int tu = t + u * nthreads;
                const unsigned e = (unsigned)__ldg(tables + e0 + (tu < plain ? tu : t));
                q[u] = (int)(e >> 16);
                const int pr = (int)(e & 0xffffu);
                cv[u] = csh ? cs[pr] : cg_[first + pr];
                ax[u] = 0.0f;
            }
#pragma unroll
            for (int k = 0; k < SWEEP3D_KMAX; ++k)
#pragma unroll
                for (int u = 0; u < SWEEP3D_POINTS; ++u) ax[u] += P.cval[k] * xs[q[u] + P.soff[k]];
#pragma unroll
            for (int u = 0; u < SWEEP3D_POINTS; ++u)
                if (t + u * nthreads < plain)
                    xs[q[u]] = xs[q[u]] + sor_step(omega, cv[u], ax[u], dval, rval);
        }
        //    the edge points, one a thread at once: every operand and
        //    coefficient first (a plane in the L2: the round trips overlap),
        //    then the chain of FMAs
        for (int t = plain + tid; t < count; t += nthreads) {
            const unsigned e = (unsigned)__ldg(tables + e0 + t);
            const int q = (int)(e >> 16), pr = (int)(e & 0xffffu);
            const int p = first + pr;
            const float cv = csh ? cs[pr] : cg_[p];
            float v[SWEEP3D_KMAX], a[SWEEP3D_KMAX];
#pragma unroll
            for (int k = 0; k < SWEEP3D_KMAX; ++k) {
                v[k] = xs[q + P.soff[k]];
                a[k] = ((P.planes >> k) & 1u) ? __ldg(coeffs + (size_t)k * n + p) : P.cval[k];
            }
            float ax = 0.0f;
#pragma unroll
            for (int k = 0; k < SWEEP3D_KMAX; ++k) ax += a[k] * v[k];
            const float d = dplane ? __ldg(coeffs + (size_t)P.diag_index * n + p) : dval;
            const float rd = dplane ? __ldg(rdiag + p) : rval;
            xs[q] = xs[q] + sor_step(omega, cv, ax, d, rd);
        }
        // the colour done on every slab (and, after the last, no neighbour
        // reads this block's planes any more)
        smem_sync<STAMPS>(cluster, S);
    }
    // 3. the slab back to device memory, once
    slab_store(xs, x + first, nz, Y, X, PX);
    stamps_close<STAMPS>(srow, SWEEP3D_STAMP_WIDTH);
}

// the kernel of (gibbs) in this library's build
static const void* sweep3d_kernel(int gibbs) {
    constexpr bool ST = SWEEP_STAMPS_BUILD;
    return gibbs ? (const void*)smem3d_sweep_kernel<true, ST>
                 : (const void*)smem3d_sweep_kernel<false, ST>;
}

// ------------------------------------------------------------ C entry points
extern "C" int sor_smem3d_params_size() { return (int)sizeof(Smem3dSweepParams); }

extern "C" int sor_smem3d_stamp_width() { return SWEEP3D_STAMP_WIDTH; }

extern "C" int sor_smem3d_stamps_build() { return SWEEP_STAMPS_BUILD; }

extern "C" int sor_smem3d_head_ints() { return SWEEP3D_HEAD_INTS; }

extern "C" int sor_smem3d_max_threads() { return SWEEP3D_MAX_THREADS; }

extern "C" int sor_smem3d_kmax() { return SWEEP3D_KMAX; }

// Dynamic shared memory of one block (bytes): the widest slab of x in padded
// planes of PP floats with a ghost plane a side and, with c_shared, its
// planes of the rhs; the layout of mgmc_visit_smem3d.cu's blocks.  -1 where
// the field does not split so: S outside 1 .. 16, more blocks than planes, a
// padded plane smaller than (Y + 2)(X + 2).
extern "C" int sor_smem3d_smem_bytes(int Z, int Y, int X, int S, int PP, int c_shared) {
    if (S < 1 || S > SWEEP3D_MAX_CLUSTER || Z < 1 || Y < 1 || X < 1 || Z / S < 1 ||
        PP < (Y + 2) * (X + 2))
        return -1;
    const int nz = planes_of_widest(Z, S);
    const long long floats =
        (long long)(nz + 2) * PP + (c_shared ? (long long)nz * Y * X : 0);
    return floats * 4 > 0x7FFFFFFF ? -1 : (int)(floats * 4);
}

// the largest static shared memory of the library's kernels (bytes), or -1
extern "C" int sor_smem3d_static_smem() {
    int most = 0;
    for (int gibbs = 0; gibbs < 2; ++gibbs) {
        cudaFuncAttributes a;
        if (cudaFuncGetAttributes(&a, sweep3d_kernel(gibbs)) != cudaSuccess) {
            cudaGetLastError();
            return -1;
        }
        most = a.sharedSizeBytes > (size_t)most ? (int)a.sharedSizeBytes : most;
    }
    return most;
}

// registers per thread, local (spill) bytes per thread and static shared
// bytes of the kernel of (gibbs); 0 or an error
extern "C" int sor_smem3d_kernel_attributes(int gibbs, int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, sweep3d_kernel(gibbs));
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
// (gibbs) that one SM holds at once, or -1
extern "C" int sor_smem3d_blocks_per_sm(int gibbs, int threads, int bytes) {
    const void* fn = sweep3d_kernel(gibbs);
    int blocks = 0;
    if (configure(fn, bytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, bytes) !=
            cudaSuccess) {
        cudaGetLastError();
        return -1;
    }
    return blocks;
}

// How many clusters of S blocks of `threads` threads and `bytes` of dynamic
// shared memory of the kernel of (gibbs) the card holds at once
// (cudaOccupancyMaxActiveClusters): 0 means such a cluster never schedules.
// Returns the CUDA error.
extern "C" int sor_smem3d_max_active(int gibbs, int S, int threads, int bytes, int* clusters) {
    *clusters = 0;
    const void* fn = sweep3d_kernel(gibbs);
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

static int launch(int gibbs, const Smem3dSweepParams* P, void** args, int threads, int bytes,
                  bool stamps, cudaStream_t stream) {
    const void* fn = sweep3d_kernel(gibbs);
    if (stamps != (bool)SWEEP_STAMPS_BUILD || threads < 32 || threads > SWEEP3D_MAX_THREADS ||
        threads % 32 || P->C < 1 || P->K < 1 || P->K > SWEEP3D_KMAX || P->diag_index < 0 ||
        P->diag_index >= P->K || P->n_order < 1 || P->n_order > SWEEP3D_MAX_COLORS ||
        (gibbs != 0) != (P->noise_mode != 0) || P->noise_mode < 0 || P->noise_mode > 2 ||
        P->PX != P->X + 2 || P->PP != (P->Y + 2) * P->PX ||
        bytes != sor_smem3d_smem_bytes(P->Z, P->Y, P->X, P->S, P->PP, P->c_shared) ||
        P->nz_max != planes_of_widest(P->Z, P->S))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = configure(fn, bytes);
    if (e == cudaSuccess) {
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr[1];
        cluster_config(&cfg, attr, P->C * P->S, P->S, threads, bytes, stream);
        e = cudaLaunchKernelExC(&cfg, fn, args);
    }
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    return (int)cudaGetLastError();
}

// tables: the heads and entries of mgmc_visit_smem3d.py::visit_tables for
// the sweep's order and P->S; rdiag the reciprocal of the diagonal plane;
// stamps (C S, SWEEP3D_STAMP_WIDTH) in the stamps build, else null
extern "C" int sor_smem3d_sweep(const Smem3dSweepParams* P, const int* tables, float* x,
                                const float* b, const float* coeffs, const float* rdiag,
                                int threads, int bytes, void* stamps, void* stream) {
    Smem3dSweepParams Pc = *P;
    float* scratch = nullptr;
    const float *ns = nullptr, *xi = nullptr;
    unsigned long long* st = static_cast<unsigned long long*>(stamps);
    void* args[] = {&Pc, &tables, &x, &b, &scratch, &coeffs, &rdiag, &ns, &xi, &st};
    return launch(0, P, args, threads, bytes, st != nullptr, (cudaStream_t)stream);
}

// scratch: a field per chain, the rhs where it is not in shared memory (may
// be null with c_shared); xi (C, Z, Y, X) where noise_mode is 2
extern "C" int sor_smem3d_gibbs_sweep(const Smem3dSweepParams* P, const int* tables, float* x,
                                      const float* f, float* scratch, const float* coeffs,
                                      const float* rdiag, const float* ns, const float* xi,
                                      int threads, int bytes, void* stamps, void* stream) {
    if (!P->c_shared && scratch == nullptr) return (int)cudaErrorInvalidValue;
    Smem3dSweepParams Pc = *P;
    unsigned long long* st = static_cast<unsigned long long*>(stamps);
    void* args[] = {&Pc, &tables, &x, &f, &scratch, &coeffs, &rdiag, &ns, &xi, &st};
    return launch(1, P, args, threads, bytes, st != nullptr, (cudaStream_t)stream);
}
