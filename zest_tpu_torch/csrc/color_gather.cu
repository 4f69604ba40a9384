// Source-view color gather at ray points, forward, all views in one launch.
//
// Replaces the TPU kernel zest_tpu/kernels/color_gather.py:_gather_pallas
// (pallas_call at :138, reached from gather_colors_banded). The TPU form
// packs 128 points into a row band and turns the gather into a banded
// two-hot matmul, with a runtime band check and an XLA fallback; a GPU
// gathers natively, so here each thread owns one (view, point) and reads its
// four bilinear taps directly.
//
// Semantics: images [V, H, W, 3] unnormalized, xy [V, N, 2] pixel coords;
// out [V, N, 3]. Border padding, align_corners=True: equal to
// F.grid_sample(padding_mode="border") at grid = xy / ((W-1)/2, (H-1)/2) - 1.
// The kernel normalizes and unnormalizes the coordinate the way that call
// does, so both see the same value.
//
// What bounds it on an H100: memory latency of the scattered tap reads. One
// 288x512x3 image is 1.8 MB and all 8 views fit in the 50 MB L2; each tap is
// 12 contiguous bytes. Reads of xy and stores of the output are coalesced.
#include "common.cuh"

namespace {

__device__ __forceinline__ float border(float v, int size) {
  return fminf(fmaxf(v, 0.f), static_cast<float>(size - 1));
}

__global__ void color_gather_kernel(const float* __restrict__ images,
                                    const float* __restrict__ xy,
                                    float* __restrict__ out, int V, long long N,
                                    int H, int W) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= V * N) return;
  const int v = static_cast<int>(i / N);
  const float gx = xy[2 * i] / ((W - 1) * 0.5f) - 1.f;
  const float gy = xy[2 * i + 1] / ((H - 1) * 0.5f) - 1.f;
  const float x = border(zt::unnormalize(gx, W), W);
  const float y = border(zt::unnormalize(gy, H), H);
  const float x0f = floorf(x), y0f = floorf(y);
  const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
  const float fx = x - x0f, fy = y - y0f;
  // after the border clamp a far tap can only fall off the last row/column,
  // where its weight is 0: clamping its index leaves the result unchanged
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);

  const float* img = images + static_cast<long long>(v) * H * W * 3;
  const float* s00 = img + (static_cast<long long>(y0) * W + x0) * 3;
  const float* s01 = img + (static_cast<long long>(y0) * W + x1) * 3;
  const float* s10 = img + (static_cast<long long>(y1) * W + x0) * 3;
  const float* s11 = img + (static_cast<long long>(y1) * W + x1) * 3;
  const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
  const float w10 = fy * (1.f - fx), w11 = fy * fx;
  float* o = out + 3 * i;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = w00 * __ldg(s00 + c) + w01 * __ldg(s01 + c) +
           w10 * __ldg(s10 + c) + w11 * __ldg(s11 + c);
  }
}

}  // namespace

ZT_API int zt_color_gather(const float* images, const float* xy, float* out,
                           int V, int N, int H, int W, void* stream) {
  constexpr int kThreads = 256;
  const long long n = static_cast<long long>(V) * N;
  if (n > 0) {
    color_gather_kernel<<<zt::blocks_for(n, kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        images, xy, out, V, static_cast<long long>(N), H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
