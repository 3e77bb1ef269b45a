// Helpers shared by the port's CUDA sources: the hash constants and gram
// hash of qat_zstd_plugin_tpu.ops.glue_kernels._hash_tile, and the launch
// shape of the one-thread-per-element kernels.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kC1 = 2654435761u;
constexpr uint32_t kC2 = 2246822519u;
constexpr uint32_t kC3 = 3266489917u;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t be_word(const uint8_t* b) {
    return (uint32_t(b[0]) << 24) | (uint32_t(b[1]) << 16) |
           (uint32_t(b[2]) << 8) | uint32_t(b[3]);
}

// hbits-bit hash of the width-byte gram at b (glue_kernels._hash_tile).
__device__ __forceinline__ uint32_t gram_hash(const uint8_t* b, int width,
                                              int hbits) {
    const uint32_t w0 = be_word(b);
    uint32_t h;
    if (width == 4) {
        h = w0 * kC1;
    } else if (width == 5) {
        h = (w0 * kC1) ^ ((uint32_t(b[4]) * kC2) << 11);
    } else if (width == 6) {
        h = (w0 * kC1) ^ (((uint32_t(b[4]) << 8) | uint32_t(b[5])) * kC2);
    } else {  // 8
        h = (w0 * kC1) ^ (be_word(b + 4) * kC2 * kC3);
    }
    return h >> (32 - hbits);
}

constexpr int kThreads = 256;

inline unsigned blocks_for(long long total) {
    return unsigned((total + kThreads - 1) / kThreads);
}

}  // namespace
