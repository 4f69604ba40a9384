// Trilinear encoding-volume lookup at ray points: forward (K3), and its two
// gradients (K4 d/d volume, K5 d/d coordinates) further down.
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

// Shared by the three kernels: point i's unnormalized, clamped coordinate
// and its floor, formed exactly as the forward forms them.
struct Taps {
  int x0, y0, z0;
  float fx, fy, fz;
};

__device__ __forceinline__ Taps taps_of(const float* ndc, int i, int D, int Hv,
                                        int Wv) {
  const float x = zt::clamp_far(zt::unnormalize(ndc[3 * i] * 2.f - 1.f, Wv), Wv);
  const float y = zt::clamp_far(zt::unnormalize(ndc[3 * i + 1] * 2.f - 1.f, Hv), Hv);
  const float z = zt::clamp_far(zt::unnormalize(ndc[3 * i + 2] * 2.f - 1.f, D), D);
  const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
  return {static_cast<int>(x0f), static_cast<int>(y0f), static_cast<int>(z0f),
          x - x0f, y - y0f, z - z0f};
}

// K4: d_vol += g * (trilinear weight) at each in-range corner.
//
// Replaces zest_tpu/kernels/trilinear.py:_bwd_pallas (pallas_call at :303),
// the adjoint of the lookup in the volume. The TPU form accumulates banded
// per-sample mini-volumes with transposed two-hot matmuls and segment-adds
// them with a one-hot matmul; here each thread owns one point and scatters
// its 8-channel gradient times the 8 corner weights into the zeroed d_vol
// with atomicAdd (64 atomics per point, out-of-range corners skipped: zeros
// padding). What bounds it on an H100: the atomics in L2. d_vol (86 MB at
// the flagship) is written by the caller's zero fill and by the atomics;
// neighbouring points of one ray hit neighbouring voxels, so contention is
// low but the 32-byte corner rows are read-modify-written in L2.
__global__ void trilinear_grad_volume_kernel(const float4* __restrict__ g,
                                             const float* __restrict__ ndc,
                                             float* __restrict__ d_vol, int n,
                                             int D, int Hv, int Wv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Taps t = taps_of(ndc, i, D, Hv, Wv);
  const float4 g0 = __ldg(g + 2 * static_cast<long long>(i));
  const float4 g1 = __ldg(g + 2 * static_cast<long long>(i) + 1);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    const int zi = t.z0 + dz, yi = t.y0 + dy, xi = t.x0 + dx;
    if (zi < 0 || zi >= D || yi < 0 || yi >= Hv || xi < 0 || xi >= Wv) continue;
    const float wgt = (dx ? t.fx : 1.f - t.fx) * (dy ? t.fy : 1.f - t.fy) *
                      (dz ? t.fz : 1.f - t.fz);
    float* p = d_vol + ((static_cast<long long>(zi) * Hv + yi) * Wv + xi) * 8;
    atomicAdd(p, g0.x * wgt); atomicAdd(p + 1, g0.y * wgt);
    atomicAdd(p + 2, g0.z * wgt); atomicAdd(p + 3, g0.w * wgt);
    atomicAdd(p + 4, g1.x * wgt); atomicAdd(p + 5, g1.y * wgt);
    atomicAdd(p + 6, g1.z * wgt); atomicAdd(p + 7, g1.w * wgt);
  }
}

// K5: d_ndc = sum over in-range corners of (corner . g) times the derivative
// of the corner's weight, scaled by the unnormalization (size - 1).
//
// Replaces zest_tpu/kernels/trilinear.py:_coords_pallas (pallas_call at
// :353), which contracts derivative two-hot matrices against banded volume
// slices. Here each thread owns one point, reads its 8 corners as K3 does
// and forms d/d(x, y, z) of the blend, as F.grid_sample's grid gradient does
// (an out-of-range corner adds nothing), times d(coordinate)/d(ndc) = size - 1
// for ndc * 2 - 1 under align_corners=True. What bounds it on an H100: the
// latency of the scattered 32-byte corner reads, as in K3, plus the gradient
// read; it writes 12 bytes per point.
__global__ void trilinear_grad_coords_kernel(const float4* __restrict__ vol,
                                             const float* __restrict__ ndc,
                                             const float4* __restrict__ g,
                                             float* __restrict__ d_ndc, int n,
                                             int D, int Hv, int Wv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Taps t = taps_of(ndc, i, D, Hv, Wv);
  const float4 g0 = __ldg(g + 2 * static_cast<long long>(i));
  const float4 g1 = __ldg(g + 2 * static_cast<long long>(i) + 1);
  float gx = 0.f, gy = 0.f, gz = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    const int zi = t.z0 + dz, yi = t.y0 + dy, xi = t.x0 + dx;
    if (zi < 0 || zi >= D || yi < 0 || yi >= Hv || xi < 0 || xi >= Wv) continue;
    const long long v = ((static_cast<long long>(zi) * Hv + yi) * Wv + xi) * 2;
    const float4 c0 = __ldg(vol + v), c1 = __ldg(vol + v + 1);
    const float s = c0.x * g0.x + c0.y * g0.y + c0.z * g0.z + c0.w * g0.w +
                    c1.x * g1.x + c1.y * g1.y + c1.z * g1.z + c1.w * g1.w;
    const float wx = dx ? t.fx : 1.f - t.fx, sx = dx ? 1.f : -1.f;
    const float wy = dy ? t.fy : 1.f - t.fy, sy = dy ? 1.f : -1.f;
    const float wz = dz ? t.fz : 1.f - t.fz, sz = dz ? 1.f : -1.f;
    gx += s * sx * wy * wz;
    gy += s * wx * sy * wz;
    gz += s * wx * wy * sz;
  }
  d_ndc[3 * static_cast<long long>(i)] = gx * (Wv - 1);
  d_ndc[3 * static_cast<long long>(i) + 1] = gy * (Hv - 1);
  d_ndc[3 * static_cast<long long>(i) + 2] = gz * (D - 1);
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

ZT_API int zt_trilinear_grad_volume(const float* g, const float* ndc,
                                    float* d_vol, int n, int D, int Hv, int Wv,
                                    void* stream) {
  constexpr int kThreads = 256;
  if (n > 0) {
    trilinear_grad_volume_kernel<<<zt::blocks_for(n, kThreads), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(g), ndc, d_vol, n, D, Hv, Wv);
  }
  return static_cast<int>(cudaGetLastError());
}

ZT_API int zt_trilinear_grad_coords(const float* vol, const float* ndc,
                                    const float* g, float* d_ndc, int n, int D,
                                    int Hv, int Wv, void* stream) {
  constexpr int kThreads = 256;
  if (n > 0) {
    trilinear_grad_coords_kernel<<<zt::blocks_for(n, kThreads), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(vol), ndc,
        reinterpret_cast<const float4*>(g), d_ndc, n, D, Hv, Wv);
  }
  return static_cast<int>(cudaGetLastError());
}
