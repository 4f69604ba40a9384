// Trilinear encoding-volume lookup at ray points, forward.
//
// Replaces the TPU kernel zest_tpu/kernels/trilinear.py:_fwd_pallas
// (pallas_call at :279, reached from sample_volume_zbanded). The TPU form
// slices a z band per sample index and runs separable two-hot matmuls with a
// runtime band check and an XLA fallback; a GPU gathers natively, so here
// each thread owns one point and reads its 8 corners directly — no band, no
// fallback.
//
// Semantics: vol [D, Hv, Wv, 8] channels-last, ndc [n, 3] as (x, y, z) in
// [0, 1]; out [n, 8]. Equal to F.grid_sample(vol, ndc*2-1) with zeros padding
// and align_corners=True: the kernel forms ndc*2-1 and unnormalizes it the
// way PyTorch does, so both see the same coordinate.
//
// What bounds it on an H100: memory latency of the scattered corner reads.
// Each corner is 8 channels = 32 contiguous bytes, read as two float4 loads;
// the flagship volume (128x120x176x8 f32, 86 MB) is larger than the 50 MB L2,
// but neighbouring rays of a chunk hit neighbouring voxels, so most corner
// reads are L2 hits. The output (32 B per point) is stored as two float4.
#include "common.cuh"

namespace {

__global__ void trilinear_sample_kernel(const float4* __restrict__ vol,
                                        const float* __restrict__ ndc,
                                        float4* __restrict__ out, int n, int D,
                                        int Hv, int Wv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = zt::clamp_far(zt::unnormalize(ndc[3 * i] * 2.f - 1.f, Wv), Wv);
  const float y = zt::clamp_far(zt::unnormalize(ndc[3 * i + 1] * 2.f - 1.f, Hv), Hv);
  const float z = zt::clamp_far(zt::unnormalize(ndc[3 * i + 2] * 2.f - 1.f, D), D);
  const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
  const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f),
            z0 = static_cast<int>(z0f);
  const float fx = x - x0f, fy = y - y0f, fz = z - z0f;

  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 b = a;
  // corner order (z, y, x) = 000, 001, 010, 011, 100, ... as F.grid_sample
  // accumulates them
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    const int zi = z0 + dz, yi = y0 + dy, xi = x0 + dx;
    if (zi < 0 || zi >= D || yi < 0 || yi >= Hv || xi < 0 || xi >= Wv) continue;
    const float wgt = (dx ? fx : 1.f - fx) * (dy ? fy : 1.f - fy) *
                      (dz ? fz : 1.f - fz);
    const long long v = ((static_cast<long long>(zi) * Hv + yi) * Wv + xi) * 2;
    const float4 c0 = __ldg(vol + v), c1 = __ldg(vol + v + 1);
    a.x += c0.x * wgt; a.y += c0.y * wgt; a.z += c0.z * wgt; a.w += c0.w * wgt;
    b.x += c1.x * wgt; b.y += c1.y * wgt; b.z += c1.z * wgt; b.w += c1.w * wgt;
  }
  out[2 * static_cast<long long>(i)] = a;
  out[2 * static_cast<long long>(i) + 1] = b;
}

}  // namespace

ZT_API int zt_trilinear_sample(const float* vol, const float* ndc, float* out,
                               int n, int D, int Hv, int Wv, void* stream) {
  constexpr int kThreads = 256;
  if (n > 0) {
    trilinear_sample_kernel<<<zt::blocks_for(n, kThreads), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(vol), ndc,
        reinterpret_cast<float4*>(out), n, D, Hv, Wv);
  }
  return static_cast<int>(cudaGetLastError());
}
