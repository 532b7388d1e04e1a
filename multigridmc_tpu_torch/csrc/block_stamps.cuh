// The block barrier of the port's one-block-per-chain kernels, with the
// count and the timer stamps of their measurement builds: the passes of
// level_passes.cuh (the phase visit kernels, the subtree kernel, the sweep
// kernels of sor_sweep_passes.cu) and the colour phases of sor_sweep.cu.

#pragma once

#include <cuda_runtime.h>

// Barriers this block has passed, counted by thread 0 where COUNT is set (a
// kernel's stamps build, which zeroes it at launch start and reports it); in
// that build thread 0 also writes the card's timer into
// pass_stamp_row[count] after each barrier where pass_stamp_row is not null.
__shared__ unsigned pass_sync_count;
__shared__ unsigned long long* pass_stamp_row;

__device__ __forceinline__ unsigned long long global_timer() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

template <bool COUNT>
__device__ __forceinline__ void block_sync() {
    __syncthreads();
    if (COUNT && threadIdx.x == 0) {
        ++pass_sync_count;
        if (pass_stamp_row != nullptr) pass_stamp_row[pass_sync_count] = global_timer();
    }
}

// A stamps row of a one-block sweep or visit: the timer at entry (word 0),
// after each barrier (words 1, 2, ...), at exit (word width - 3), then the
// barriers passed and the SM the block ran on.
// The stamps row of the one-block sweeps (sor_sweep.cu, sor_sweep_passes.cu):
// the timer at entry, after up to 1 + MAX_COLORS barriers (the Gibbs rhs pass,
// each colour) and at exit, the barriers passed, the SM.
#define SWEEP_STAMP_WIDTH (2 + MAX_COLORS + 3)

// 1: the sweep library is its stamps build (sor_sweep.py builds each sweep
// source a second time with -DSWEEP_STAMPS_BUILD=1)
#ifndef SWEEP_STAMPS_BUILD
#define SWEEP_STAMPS_BUILD 0
#endif

template <bool STAMPS>
__device__ __forceinline__ void stamps_open(unsigned long long* srow) {
    if (STAMPS && threadIdx.x == 0) {
        srow[0] = global_timer();
        pass_sync_count = 0;
        pass_stamp_row = srow;
    }
}

template <bool STAMPS>
__device__ __forceinline__ void stamps_close(unsigned long long* srow, int width) {
    if (STAMPS && threadIdx.x == 0) {
        unsigned sm;
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
        srow[width - 3] = global_timer();
        srow[width - 2] = pass_sync_count;
        srow[width - 1] = sm;
    }
}
