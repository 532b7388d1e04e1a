// What the two implementations of the colour-ordered sweep share
// (sor_sweep.cu: one thread block per chain; sor_sweep_cluster.cu: each chain
// split over a thread-block cluster): the parameter block, mirrored by
// SweepParams in ops/kernels/sor_sweep.py, and the coefficient read.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_OFFSETS 27
#define MAX_COLORS 9
#define MAX_THREADS 1024

struct SweepParams {
    int C, Z, Y, X;  // chains and the field's extents, slowest axis first; Z = 1 in 2d
    int K, diag_index;
    int dz[MAX_OFFSETS];
    int dy[MAX_OFFSETS];
    int dx[MAX_OFFSETS];
    int coeff_const[MAX_OFFSETS];
    float coeff_val[MAX_OFFSETS];
    int n_colors, wz, wy, wx, jstride;
    int n_order;
    int order[MAX_COLORS];
    float omega;
    int noise_mode;  // 0 off, 1 in-kernel Philox, 2 xi read from a tensor
    int ns_const;
    float ns_val;
    int b_batched;
    unsigned long long seed;
    unsigned long long counter;
};

__device__ __forceinline__ float coeff_at(const SweepParams& P, const float* __restrict__ coeffs,
                                          int k, int n, int p) {
    return P.coeff_const[k] ? P.coeff_val[k] : coeffs[(size_t)k * n + p];
}
