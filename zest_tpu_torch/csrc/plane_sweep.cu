// Plane-sweep homography warp, forward.
//
// Replaces the TPU kernel zest_tpu/kernels/plane_sweep.py:_pallas_warp_fwd
// (pallas_call at :239, reached from homo_warp_fast_cm). The TPU form builds
// banded two-hot interpolation matrices so the MXU can do the gather; a GPU
// gathers natively, so here each thread owns one (depth plane, output pixel)
// and reads its four bilinear taps directly.
//
// Semantics: src [C, h, w] channel-major (the wrapper transposes the
// [h, w, C] features, 1.3 MB at the flagship); grid [D, Hp, Wp, 2]
// normalized (x, y) from ops/homography.homography_grid; out [D, C, Hp*Wp]
// channel-major. Zeros padding, align_corners=True — F.grid_sample's.
//
// What bounds it on an H100: memory. At the flagship shapes (src 35x72x128,
// D=128, Hp*Wp=21120) it writes 378 MB and reads the 1.3 MB source through
// L1/L2 many times over. Per channel, a warp's 32 threads are 32 neighbouring
// output pixels: their stores are one coalesced row, and their tap reads fall
// on neighbouring source pixels of one channel plane. Its arithmetic is a few
// FMAs per byte stored.
#include "common.cuh"

namespace {

__global__ void plane_sweep_warp_kernel(const float* __restrict__ src,
                                        const float* __restrict__ grid,
                                        float* __restrict__ out, int D, int h,
                                        int w, int C, int P) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= static_cast<long long>(D) * P) return;
  const int d = static_cast<int>(idx / P);
  const int p = static_cast<int>(idx - static_cast<long long>(d) * P);

  const float x = zt::clamp_far(zt::unnormalize(grid[2 * idx], w), w);
  const float y = zt::clamp_far(zt::unnormalize(grid[2 * idx + 1], h), h);
  const float x0f = floorf(x), y0f = floorf(y);
  const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
  const int x1 = x0 + 1, y1 = y0 + 1;
  const float fx = x - x0f, fy = y - y0f;

  const bool vx0 = x0 >= 0 && x0 < w, vx1 = x1 >= 0 && x1 < w;
  const bool vy0 = y0 >= 0 && y0 < h, vy1 = y1 >= 0 && y1 < h;
  // zeros padding: an out-of-bounds tap has weight 0 (and is never read)
  const float w00 = (vy0 && vx0) ? (1.f - fy) * (1.f - fx) : 0.f;
  const float w01 = (vy0 && vx1) ? (1.f - fy) * fx : 0.f;
  const float w10 = (vy1 && vx0) ? fy * (1.f - fx) : 0.f;
  const float w11 = (vy1 && vx1) ? fy * fx : 0.f;
  const int i00 = (vy0 ? y0 : 0) * w + (vx0 ? x0 : 0);
  const int i01 = (vy0 ? y0 : 0) * w + (vx1 ? x1 : 0);
  const int i10 = (vy1 ? y1 : 0) * w + (vx0 ? x0 : 0);
  const int i11 = (vy1 ? y1 : 0) * w + (vx1 ? x1 : 0);

  const long long plane = static_cast<long long>(h) * w;
  float* o = out + static_cast<long long>(d) * C * P + p;
  for (int c = 0; c < C; ++c) {
    const float* s = src + c * plane;
    o[static_cast<long long>(c) * P] = w00 * __ldg(s + i00) +
                                       w01 * __ldg(s + i01) +
                                       w10 * __ldg(s + i10) +
                                       w11 * __ldg(s + i11);
  }
}

}  // namespace

ZT_API int zt_plane_sweep_warp(const float* src, const float* grid, float* out,
                               int D, int h, int w, int C, int P,
                               void* stream) {
  constexpr int kThreads = 256;
  const long long n = static_cast<long long>(D) * P;
  if (n > 0) {
    plane_sweep_warp_kernel<<<zt::blocks_for(n, kThreads), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        src, grid, out, D, h, w, C, P);
  }
  return static_cast<int>(cudaGetLastError());
}
