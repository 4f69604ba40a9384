// Shared helpers for the zest_tpu_torch kernels (plain C interface, no
// PyTorch headers: every entry point takes raw device pointers and the
// caller's stream, and returns cudaGetLastError() after its launch).
#pragma once

#include <cuda_runtime.h>

#define ZT_API extern "C" __attribute__((visibility("default")))

namespace zt {

inline unsigned int blocks_for(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

// PyTorch's align_corners=True unnormalization, written as it writes it, so
// a kernel and F.grid_sample see the same coordinate for the same grid value.
__device__ __forceinline__ float unnormalize(float g, int size) {
  return ((g + 1.f) / 2.f) * (size - 1);
}

// Keep a coordinate inside [-2, size + 1] before flooring: every tap outside
// the image gets weight 0 under zeros padding, so the clamp changes no
// result, and it keeps the float -> int conversion defined for far-out (or
// NaN) coordinates.
__device__ __forceinline__ float clamp_far(float v, int size) {
  return fminf(fmaxf(v, -2.f), static_cast<float>(size + 1));
}

}  // namespace zt
