// Counter-based normal generator shared by the CUDA kernels of the port
// (mgmc_visit.cu, sor_sweep.cu): Philox4x32-10 and Box-Muller.
//
// One call of philox_normals4 yields the four normals of one POINT GROUP: four
// consecutive points of one row of a chain's field.  The Philox counter is
// (point group, chain, launch counter lo, launch counter hi), the key is
// seed XOR PHILOX_KEY_MIX (lo, hi).  Philox is a bijection of the counter for a
// fixed key, so no two launches, chains or groups share a stream.  The host
// reference of the same generator is philox_normals_reference
// (ops/kernels/common.py).
//
// Why the mix: torch's CUDA generator seeded with `seed` runs the same
// Philox4x32-10 under the key `seed`, with the counter (offset / 4, 0, thread,
// 0).  Under that key the kernels' counter (group g, chain 0, launch L, 0)
// would be torch's draw at offset 4g from thread L: the one-chain series would
// reuse, as field noise, the normals that torch drew for the same run.  The
// fixed mix gives the kernels a key of their own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// "MGMC_KEY" in ASCII; PHILOX_KEY_MIX in ops/kernels/common.py
#define PHILOX_KEY_MIX 0x4D474D435F4B4559ULL

__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                              uint32_t c3, uint32_t k0, uint32_t k1,
                                              uint32_t out[4]) {
    const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
    const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
        uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
        uint32_t n0 = hi1 ^ c1 ^ k0;
        uint32_t n2 = hi0 ^ c3 ^ k1;
        c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
        k0 += W0; k1 += W1;
    }
    out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

// two uniforms -> two normals; u1 in (0, 1], u2 in [0, 1)
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float* z0, float* z1) {
    const float S = 1.0f / 16777216.0f;
    float u1 = (float)((a >> 8) + 1u) * S;
    float u2 = (float)(b >> 8) * S;
    float r = sqrtf(-2.0f * logf(u1));
    float s, c;
    sincospif(2.0f * u2, &s, &c);
    *z0 = r * c;
    *z1 = r * s;
}

// the four normals of point group `group` of chain `chain` in the launch
// (seed, counter): cosine, sine, cosine, sine branch of two Box-Muller pairs
__device__ __forceinline__ void philox_normals4(uint32_t group, uint32_t chain,
                                                unsigned long long seed,
                                                unsigned long long counter, float z[4]) {
    const unsigned long long key = seed ^ PHILOX_KEY_MIX;
    uint32_t r[4];
    philox4x32_10(group, chain, (uint32_t)counter, (uint32_t)(counter >> 32), (uint32_t)key,
                  (uint32_t)(key >> 32), r);
    box_muller(r[0], r[1], &z[0], &z[1]);
    box_muller(r[2], r[3], &z[2], &z[3]);
}
