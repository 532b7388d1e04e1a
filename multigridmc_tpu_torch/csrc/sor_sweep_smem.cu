// Colour-ordered SOR and Gibbs sweep kernels for NVIDIA Hopper (sm_90a),
// float32, for the fields whose chain fits a block's shared memory: 2d
// stencils of reach 2 (at most 13 offsets, or the 5x5 box) and 3d stencils of
// reach 1 (at most 7 offsets, or up to 27), the shapes of the distillation
// set-up of the squared shifted-Laplace (63^2, 31^2, 25-point, 9 colours) and
// 3d (15^3, 27-point, 8 colours) hierarchies.
//
// Replace the Pallas kernels sweep_batched_v2 / gibbs_sweep_batched_v2 of
// multigridmc_tpu/ops/kernels/sor_pallas_v2.py for those shapes
// (ops/kernels/sor_sweep.py::sweep_body names the body).  One launch is one
// sweep of all chains, in place:
//
//   smem_sweep_kernel:  for colour ci in order:
//                           x[p] += omega (b[p] - (A_stencil x)[p]) / diag[p]
//                       on the points p of colour ci
//   smem_gibbs_kernel:  the same sweep on c = f + sqrt(diag (2-omega)/omega) xi,
//                       xi ~ N(0, 1) drawn in the kernel (or read from a tensor)
//
// Design.  One thread block per chain, whose fields stay in shared memory for
// the whole sweep: x with a zero halo of the stencil's reach around it (so no
// term tests a bound: a neighbour outside the field reads 0 and adds +0, where
// the other bodies skip it), the rhs (b, or c formed there) and the table
// below.  The block copies x, b and the table in once with cp.async (4 bytes a
// thread, coalesced, the halo zeroed beside), runs every colour phase on
// shared memory with a barrier after each, and writes x back once.  A colour's points are spread over all
// threads of the block from a table the host builds once per (shape, order,
// coefficients) (sor_sweep.py::smem_tables): per point its padded index and
// its field index in one word, colour after colour in the sweep's order, and
// within a colour first the points whose every coefficient in the field is
// the level's interior value (they take the coefficients as scalars of the
// parameter block) and then the rest (they read the coefficient planes that
// vary, which the L2 holds for all chains), each part dealt round the
// shared-memory banks
// so that a warp's points fall on distinct banks (a colour's points in
// storage order put several rows of a warp on one bank: 4.4 wavefronts a warp
// on 63^2 at 9 colours), the padded rows up to 8 columns wider where that
// spreads them further.  The diagonal enters as its reciprocal,
// computed once per plan (a scalar, and a plane for the points that read
// planes), with one FMA correction, which gives the correctly rounded
// quotient of sor_sweep.cu's division.  The terms are added in offset order,
// as sor_sweep.cu adds them (a neighbour in the halo adds +-0), so the bodies
// agree to rounding.  The stencil's size is compiled in
// (smem_kmax: 13 or 25 in 2d, 7 or 27 in 3d), one kernel each.
//
// Gibbs noise: the generator of philox.cuh with sor_sweep.cu's numbering,
// group g of row r (r = z * Y + y) is r * ceil(X / 4) + g, with the chain and
// the launch counter, so the bodies agree under one stream; noise_mode 2
// reads xi from a tensor.
//
// Bound: by bytes, per chain x read and written and b (unless shared) read
// once; that is all the kernel moves to and from device memory, apart from the
// edge points' coefficient planes and the table, which stay in the L2 and L1
// for all chains.  A 63^2 chain with a halo of 2 takes some 34 KB of shared
// memory, so several blocks share an SM and one block's copies overlap
// another's colour phases.
//
// SWEEP_STAMPS_BUILD: the measurement build, a library of its own, taken only
// where the host passes a stamps tensor, (C, SWEEP_STAMP_WIDTH) int64 as
// sor_sweep.cu's (block_stamps.cuh): the timer at entry, after the copy-in
// (and the Gibbs rhs) and after each colour phase, at exit, then the barriers
// passed and the SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_stamps.cuh"
#include "philox.cuh"
#include "sor_sweep.cuh"

// the largest block the kernels are compiled for (the host takes up to 256
// threads where the chains take more than one wave, up to 512 where they fit
// one: sor_sweep.py::smem_threads); two blocks of it an SM
#define SMEM_MAX_THREADS 512
#define SMEM_MIN_BLOCKS 2

struct SmemSweepParams {
    int C, Z, Y, X;        // chains and the field's extents, slowest axis first; Z = 1 in 2d
    int RZ, R;             // the halo along z (0 in 2d) and along y and x
    int PZ, PY, PX;        // the padded extents: Z + 2 RZ, Y + 2 R, X + 2 R (+ up to 8)
    int K, diag_index;
    int soff[MAX_OFFSETS];    // offset k in the padded field: (dz PY + dy) PX + dx
    float cval[MAX_OFFSETS];  // the interior coefficients, which the table's first points take
    float rdiag;              // 1 / cval[diag_index]
    unsigned planes;          // bit k: coefficient k varies in space (the other points read it)
    int n_order;
    int start[MAX_COLORS + 1];  // colour o of the order: table[start[o] .. start[o + 1])
    int plain[MAX_COLORS];      // of which the first plain[o] take cval, the rest the planes
    float omega;
    int noise_mode;  // 0 off, 1 in-kernel Philox, 2 xi read from a tensor
    int ns_const;
    float ns_val;
    int b_batched;
    unsigned long long seed;
    unsigned long long counter;
};

extern __shared__ __align__(16) float smem_fields[];

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The padded field's cells in turn over the block's threads, (zq, yq, xq)
// stepped without a division: x's points are copied in (cp.async), the halo
// zeroed.
__device__ __forceinline__ void load_padded(const SmemSweepParams& P, const float* __restrict__ x,
                                            float* sx) {
    const int np = P.PZ * P.PY * P.PX, bd = blockDim.x;
    const int step_x = bd % P.PX, step_r = bd / P.PX;
    int xq = threadIdx.x % P.PX, rq = threadIdx.x / P.PX;
    int yq = rq % P.PY, zq = rq / P.PY;
    for (int u = threadIdx.x; u < np; u += bd) {
        const int z = zq - P.RZ, y = yq - P.R, j = xq - P.R;
        if (z >= 0 && z < P.Z && y >= 0 && y < P.Y && j >= 0 && j < P.X)
            cp_async4(sx + u, x + (z * P.Y + y) * P.X + j);
        else
            sx[u] = 0.0f;
        xq += step_x;
        int carry = 0;
        if (xq >= P.PX) {
            xq -= P.PX;
            carry = 1;
        }
        yq += step_r + carry;
        while (yq >= P.PY) {
            yq -= P.PY;
            ++zq;
        }
    }
}

// x's points back from the padded field, coalesced, (z, y, j) stepped
// likewise.
__device__ __forceinline__ void store_padded(const SmemSweepParams& P, const float* sx,
                                             float* __restrict__ x) {
    const int n = P.Z * P.Y * P.X, bd = blockDim.x;
    const int step_x = bd % P.X, step_r = bd / P.X;
    int j = threadIdx.x % P.X, r = threadIdx.x / P.X;
    int y = r % P.Y, z = r / P.Y;
    for (int p = threadIdx.x; p < n; p += bd) {
        x[p] = sx[((z + P.RZ) * P.PY + y + P.R) * P.PX + j + P.R];
        j += step_x;
        int carry = 0;
        if (j >= P.X) {
            j -= P.X;
            carry = 1;
        }
        y += step_r + carry;
        while (y >= P.Y) {
            y -= P.Y;
            ++z;
        }
    }
}

// c = f + ns xi into sc: the point groups (four consecutive points of a row)
// over the block's threads, each group's f loaded before its draw.
__device__ __forceinline__ void gibbs_rhs(const SmemSweepParams& P, int chain,
                                          const float* __restrict__ f,
                                          const float* __restrict__ ns,
                                          const float* __restrict__ xi, float* sc) {
    const int X = P.X, G = (X + 3) >> 2, NG = P.Z * P.Y * G, bd = blockDim.x;
    const int di = bd / G, dg = bd - di * G;
    int i = threadIdx.x / G, g = threadIdx.x - i * G;
    for (int q4 = threadIdx.x; q4 < NG; q4 += bd) {
        float fv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) fv[q] = 4 * g + q < X ? f[i * X + 4 * g + q] : 0.0f;
        float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (P.noise_mode == 1) philox_normals4((uint32_t)q4, (uint32_t)chain, P.seed, P.counter, z);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int j = 4 * g + q, p = i * X + j;
            if (j >= X) break;
            const float zq = P.noise_mode == 2 ? xi[p] : z[q];
            sc[p] = fv[q] + (P.ns_const ? P.ns_val : ns[p]) * zq;
        }
        i += di;
        g += dg;
        if (g >= G) {
            g -= G;
            ++i;
        }
    }
}

// Every colour phase of the sweep on the block's shared memory: sx the padded
// x, sc the rhs, table the block's copy of the table.  A thread takes the
// colour's table entries t, t + blockDim, ...: entry (q << 16) | p, q the
// point's padded index, p its field index.  Ends with a barrier.
template <int KMAX, bool STAMPS>
__device__ __forceinline__ void smem_colours(const SmemSweepParams& P, const int* table,
                                             const float* __restrict__ coeffs,
                                             const float* __restrict__ rdiag, float* sx,
                                             const float* sc) {
    const int n = P.Z * P.Y * P.X;
    const float omega = P.omega;
    for (int o = 0; o < P.n_order; ++o) {
        const int first = P.start[o], count = P.start[o + 1] - first, plain = P.plain[o];
        for (int t = threadIdx.x; t < count; t += blockDim.x) {
            const int e = table[first + t];
            const int q = e >> 16, p = e & 0xffff;
            float ax = 0.0f, d, rd;
            if (t < plain) {
#pragma unroll
                for (int k = 0; k < KMAX; ++k)
                    if (k < P.K) ax += P.cval[k] * sx[q + P.soff[k]];
                d = P.cval[P.diag_index];
                rd = P.rdiag;
            } else {
                float a[KMAX];
#pragma unroll
                for (int k = 0; k < KMAX; ++k)
                    a[k] = (k < P.K && ((P.planes >> k) & 1u)) ? __ldg(coeffs + (size_t)k * n + p)
                                                              : P.cval[k];
#pragma unroll
                for (int k = 0; k < KMAX; ++k)
                    if (k < P.K) ax += a[k] * sx[q + P.soff[k]];
                const bool dplane = (P.planes >> P.diag_index) & 1u;
                d = dplane ? __ldg(coeffs + (size_t)P.diag_index * n + p) : P.cval[P.diag_index];
                rd = dplane ? __ldg(rdiag + p) : P.rdiag;
            }
            // omega (c - ax) / d from the reciprocal and one correction (the
            // product's residual is exact in an FMA): the correctly rounded
            // quotient, which sor_sweep.cu's division gives
            const float num = omega * (sc[p] - ax);
            const float q0 = num * rd;
            sx[q] = sx[q] + fmaf(fmaf(-q0, d, num), rd, q0);
        }
        block_sync<STAMPS>();
    }
}

// ------------------------------------------------------------------- kernels
template <int KMAX, bool STAMPS>
__global__ void __launch_bounds__(SMEM_MAX_THREADS, SMEM_MIN_BLOCKS)
smem_sweep_kernel(const __grid_constant__ SmemSweepParams P, const int* __restrict__ table,
                  float* x_all, const float* __restrict__ b_all,
                  const float* __restrict__ coeffs, const float* __restrict__ rdiag,
                  unsigned long long* stamps) {
    const int chain = blockIdx.x;
    const int n = P.Z * P.Y * P.X;
    float* sx = smem_fields;
    float* sc = smem_fields + P.PZ * P.PY * P.PX;
    int* stab = reinterpret_cast<int*>(sc + n);
    unsigned long long* srow = STAMPS ? stamps + (size_t)chain * SWEEP_STAMP_WIDTH : nullptr;
    stamps_open<STAMPS>(srow);
    float* x = x_all + (size_t)chain * n;
    const float* b = b_all + (P.b_batched ? (size_t)chain * n : 0);
    load_padded(P, x, sx);
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        cp_async4(sc + p, b + p);
        cp_async4(reinterpret_cast<float*>(stab + p), reinterpret_cast<const float*>(table + p));
    }
    cp_async_wait_all();
    block_sync<STAMPS>();
    smem_colours<KMAX, STAMPS>(P, stab, coeffs, rdiag, sx, sc);
    store_padded(P, sx, x);
    stamps_close<STAMPS>(srow, SWEEP_STAMP_WIDTH);
}

template <int KMAX, bool STAMPS>
__global__ void __launch_bounds__(SMEM_MAX_THREADS, SMEM_MIN_BLOCKS)
smem_gibbs_kernel(const __grid_constant__ SmemSweepParams P, const int* __restrict__ table,
                  float* x_all, const float* __restrict__ f_all,
                  const float* __restrict__ coeffs, const float* __restrict__ rdiag,
                  const float* __restrict__ ns, const float* __restrict__ xi_all,
                  unsigned long long* stamps) {
    const int chain = blockIdx.x;
    const int n = P.Z * P.Y * P.X;
    float* sx = smem_fields;
    float* sc = smem_fields + P.PZ * P.PY * P.PX;
    int* stab = reinterpret_cast<int*>(sc + n);
    unsigned long long* srow = STAMPS ? stamps + (size_t)chain * SWEEP_STAMP_WIDTH : nullptr;
    stamps_open<STAMPS>(srow);
    float* x = x_all + (size_t)chain * n;
    load_padded(P, x, sx);  // in flight while the rhs is drawn
    for (int p = threadIdx.x; p < n; p += blockDim.x)
        cp_async4(reinterpret_cast<float*>(stab + p), reinterpret_cast<const float*>(table + p));
    gibbs_rhs(P, chain, f_all + (P.b_batched ? (size_t)chain * n : 0), ns,
              P.noise_mode == 2 ? xi_all + (size_t)chain * n : nullptr, sc);
    cp_async_wait_all();
    block_sync<STAMPS>();
    smem_colours<KMAX, STAMPS>(P, stab, coeffs, rdiag, sx, sc);
    store_padded(P, sx, x);
    stamps_close<STAMPS>(srow, SWEEP_STAMP_WIDTH);
}

// the kernel of (gibbs, kmax), or null
static const void* smem_kernel(int gibbs, int kmax) {
    constexpr bool S = SWEEP_STAMPS_BUILD;
#define KMAX_KERNEL(KM) \
    (gibbs ? (const void*)smem_gibbs_kernel<KM, S> : (const void*)smem_sweep_kernel<KM, S>)
    switch (kmax) {
        case 7: return KMAX_KERNEL(7);
        case 13: return KMAX_KERNEL(13);
        case 25: return KMAX_KERNEL(25);
        case 27: return KMAX_KERNEL(27);
        default: return nullptr;
    }
#undef KMAX_KERNEL
}

// ------------------------------------------------------------ C entry points
extern "C" int sor_smem_params_size() { return (int)sizeof(SmemSweepParams); }

extern "C" int sor_smem_stamp_width() { return SWEEP_STAMP_WIDTH; }

extern "C" int sor_smem_stamps_build() { return SWEEP_STAMPS_BUILD; }

extern "C" int sor_smem_max_threads() { return SMEM_MAX_THREADS; }

// registers per thread, local (spill) bytes per thread and static shared
// bytes of the kernel of (gibbs, kmax); 0 or an error
extern "C" int sor_smem_kernel_attributes(int gibbs, int kmax, int* out) {
    const void* fn = smem_kernel(gibbs, kmax);
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

// the kernels' static shared memory at most (the stamps build's barrier count
// and stamps pointer; sor_sweep.py::SMEM_STATIC_SMEM, sor_smem_static_smem
// reports what they declare)
#define SMEM_STATIC_BOUND 16

// Whether a launch with `smem_bytes` of dynamic shared memory must opt in to
// it: where the dynamic and the static share together exceed the 48 KiB a
// block gets without asking.
static bool needs_opt_in(int smem_bytes) {
    return smem_bytes > 0 && smem_bytes + SMEM_STATIC_BOUND > 48 * 1024;
}

// the largest static shared memory of the library's kernels (bytes), or -1
extern "C" int sor_smem_static_smem() {
    int most = 0;
    const int sizes[4] = {7, 13, 25, 27};
    for (int gibbs = 0; gibbs < 2; ++gibbs)
        for (int kmax : sizes) {
            cudaFuncAttributes a;
            if (cudaFuncGetAttributes(&a, smem_kernel(gibbs, kmax)) != cudaSuccess) {
                cudaGetLastError();
                return -1;
            }
            most = a.sharedSizeBytes > (size_t)most ? (int)a.sharedSizeBytes : most;
        }
    return most;
}

static cudaError_t allow_bytes(const void* fn, int smem_bytes) {
    if (!needs_opt_in(smem_bytes)) return cudaSuccess;
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

// blocks of `threads` with `smem_bytes` of dynamic shared memory that one SM
// holds at once (the kernel of (gibbs, kmax)), or -1
extern "C" int sor_smem_blocks_per_sm(int gibbs, int kmax, int threads, int smem_bytes) {
    const void* fn = smem_kernel(gibbs, kmax);
    int blocks = 0;
    if (fn == nullptr || allow_bytes(fn, smem_bytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem_bytes) !=
            cudaSuccess) {
        cudaGetLastError();
        return -1;
    }
    return blocks;
}

static int launch(int gibbs, int kmax, bool stamps, int C, int threads, int smem_bytes,
                  void** args, void* stream) {
    const void* fn = smem_kernel(gibbs, kmax);
    if (fn == nullptr || stamps != (bool)SWEEP_STAMPS_BUILD || threads > SMEM_MAX_THREADS)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_bytes(fn, smem_bytes);
    if (e == cudaSuccess)
        e = cudaLaunchKernel(fn, dim3(C), dim3(threads), args, smem_bytes, (cudaStream_t)stream);
    if (e != cudaSuccess) cudaGetLastError();
    return (int)e;
}

// smem_bytes: 4 (PZ PY PX + 2 Z Y X), the padded x, the rhs and the table
extern "C" int sor_smem_sweep(const SmemSweepParams* P, const int* table, float* x,
                              const float* b, const float* coeffs, const float* rdiag, int kmax,
                              int threads, int smem_bytes, void* stamps, void* stream) {
    unsigned long long* st = static_cast<unsigned long long*>(stamps);
    void* args[] = {(void*)P, &table, &x, &b, &coeffs, &rdiag, &st};
    return launch(0, kmax, st != nullptr, P->C, threads, smem_bytes, args, stream);
}

extern "C" int sor_smem_gibbs_sweep(const SmemSweepParams* P, const int* table, float* x,
                                    const float* f, const float* coeffs, const float* rdiag,
                                    const float* ns, const float* xi, int kmax, int threads,
                                    int smem_bytes, void* stamps, void* stream) {
    unsigned long long* st = static_cast<unsigned long long*>(stamps);
    void* args[] = {(void*)P, &table, &x, &f, &coeffs, &rdiag, &ns, &xi, &st};
    return launch(1, kmax, st != nullptr, P->C, threads, smem_bytes, args, stream);
}
