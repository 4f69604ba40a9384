// Trilinear encoding-volume lookup at ray points: forward (K3), and its two
// gradients (K4 d/d volume, K5 d/d coordinates) further down.
//
// Semantics: vol [D, Hv, Wv, C] channels-last, ndc [R, S, 3] (R rays of S
// samples) as (x, y, z) in [0, 1]; out [R, S, C]. Equal to
// F.grid_sample(vol, ndc*2-1) with zeros padding and align_corners=True:
// every kernel forms ndc*2-1 and unnormalizes it the way PyTorch does
// (taps_of), so both see the same coordinate. C is 8 (the encoding volume:
// a corner is 32 contiguous bytes, read or added as two float4) for all
// three; K3 also reads a volume with the source views' colours appended
// (use_color_volume: C = 8 + 4V, C / 4 float4 per corner), and K4 then
// takes the gradient of its first 8 channels.
#include <algorithm>
#include <utility>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Point (x, y, z)'s unnormalized, clamped coordinate and its floor, formed
// the same way by the three kernels.
struct Taps {
  int x0, y0, z0;
  float fx, fy, fz;
};

__device__ __forceinline__ Taps taps_of(float nx, float ny, float nz, int D,
                                        int Hv, int Wv) {
  const float x = zt::clamp_far(zt::unnormalize(nx * 2.f - 1.f, Wv), Wv);
  const float y = zt::clamp_far(zt::unnormalize(ny * 2.f - 1.f, Hv), Hv);
  const float z = zt::clamp_far(zt::unnormalize(nz * 2.f - 1.f, D), D);
  const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
  return {static_cast<int>(x0f), static_cast<int>(y0f), static_cast<int>(z0f),
          x - x0f, y - y0f, z - z0f};
}

// The trilinear weight of corner (dz, dy, dx) of a point with fractions
// (fx, fy, fz), multiplied in the order F.grid_sample multiplies it.
__device__ __forceinline__ float corner_weight(int dz, int dy, int dx, float fx,
                                              float fy, float fz) {
  return (dx ? fx : 1.f - fx) * (dy ? fy : 1.f - fy) * (dz ? fz : 1.f - fz);
}

__device__ __forceinline__ bool inside(int zi, int yi, int xi, int D, int Hv,
                                       int Wv) {
  return zi >= 0 && zi < D && yi >= 0 && yi < Hv && xi >= 0 && xi < Wv;
}

__device__ __forceinline__ long long cell_of(int zi, int yi, int xi, int Hv,
                                             int Wv) {
  return (static_cast<long long>(zi) * Hv + yi) * Wv + xi;
}

// K3: the lookup.
//
// Replaces the TPU kernel zest_tpu/kernels/trilinear.py:_fwd_pallas
// (pallas_call at :279, reached from sample_volume_zbanded). The TPU form
// slices a z band per sample index and runs separable two-hot matmuls with a
// runtime band check and an XLA fallback; a GPU gathers natively: no band,
// no fallback.
//
// Why the layout: with one thread per point in memory order, a warp held 32
// consecutive samples of one ray, whose corners lie on 32 different z
// planes (676 KB apart at the flagship), so each of a point's 16 16-byte
// corner loads touched 30.1 distinct 128-byte lines per warp instruction
// on the flagship eval chunk (tools/probe_trilinear.py, lines_per_load).
// Here a warp's lanes are 16 neighbouring rays at 2 consecutive samples,
// each ray's two samples in neighbouring lanes, and a block is two such
// warps side by side over two sample pairs: 32 rays x 4 samples. On an eval
// chunk, whose rays are consecutive pixels of one image row, a load then
// spans 2 z planes and 3.9 lines, while each thread still reads its point
// and writes its output in place (24 B and 64 B contiguous per ray and
// warp). On the training step's random rays the lanes buy no locality (28
// lines per load, 24 in memory order) and cost none either. Fewer planes
// per load at the price of staging the points and the output through
// shared memory (32 rays at one sample) measured slower (PERF.md §6). A
// point's arithmetic is taps_of, corner_weight and the same multiply-adds
// in (z, y, x) corner order as F.grid_sample's, so the output is its bit
// for bit.
//
// What bounds it on an H100: reading the points and writing the output,
// 0.044 ms of the eval chunk's 0.064 with no corner loaded, 1.5x their
// 0.028 ms at 3.35 TB/s; then the corner loads.
constexpr int kWarpRays = 16, kWarpSamples = 2;              // a warp's lanes
constexpr int kBlockRays = 2 * kWarpRays, kBlockSamples = 2 * kWarpSamples;
constexpr int kSampleThreads = kBlockRays * kBlockSamples;   // one point each

__global__ void __launch_bounds__(kSampleThreads)
trilinear_sample_kernel(const float4* __restrict__ vol,
                        const float* __restrict__ ndc, float4* __restrict__ out,
                        int R, int S, long long n, int D, int Hv, int Wv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r = static_cast<long long>(blockIdx.x) * kBlockRays +
                      (warp & 1) * kWarpRays + lane / kWarpSamples;
  const int s = blockIdx.y * kBlockSamples + (warp >> 1) * kWarpSamples +
                lane % kWarpSamples;
  const long long i = r * S + s;
  if (r >= R || s >= S || i >= n) return;
  const Taps t = taps_of(ndc[3 * i], ndc[3 * i + 1], ndc[3 * i + 2], D, Hv, Wv);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 b = a;
  // corner order (z, y, x) = 000, 001, 010, 011, 100, ... as F.grid_sample
  // accumulates them
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    const int zi = t.z0 + dz, yi = t.y0 + dy, xi = t.x0 + dx;
    if (!inside(zi, yi, xi, D, Hv, Wv)) continue;
    const float wgt = corner_weight(dz, dy, dx, t.fx, t.fy, t.fz);
    const long long v = cell_of(zi, yi, xi, Hv, Wv) * 2;
    const float4 c0 = __ldg(vol + v), c1 = __ldg(vol + v + 1);
    a.x += c0.x * wgt; a.y += c0.y * wgt; a.z += c0.z * wgt; a.w += c0.w * wgt;
    b.x += c1.x * wgt; b.y += c1.y * wgt; b.z += c1.z * wgt; b.w += c1.w * wgt;
  }
  out[2 * i] = a;
  out[2 * i + 1] = b;
}

// K3 on the colour volume (use_color_volume: C = 8 + 4V channels, Q = C / 4
// float4 per corner; the same lookup, zest_tpu's _fwd_pallas takes any C).
//
// Why the layout: with a thread per point, as above, its Q output stores
// land 16 Q bytes apart across a warp's lanes, and at Q = 10 that took
// 0.393 ms per flagship eval chunk against a 0.115 ms bound. Here a thread
// owns one float4 of one point (point t / Q, quad t % Q): a point's Q
// threads are neighbouring lanes, so each corner load is one contiguous
// 16 Q-byte run of the cell's row and each store instruction writes 512
// contiguous bytes; every thread repeats its point's taps_of (a few
// flops): 0.300 ms (device time, PERF.md §6). A warp then holds ~3
// consecutive samples of one ray, on 3 z planes, which share no corner;
// blocks of 32 neighbouring rays at 2 samples, the rays fastest, so that a
// warp's points share corners as the 8-channel kernel's lanes do, measured
// slower (0.323 ms): their stores land in 160-byte runs 20 KB apart. The
// per-channel arithmetic and the corner order are the 8-channel kernel's,
// so the output is F.grid_sample's bit for bit.
//
// What bounds it on an H100: its output, 160 bytes per point at V = 8:
// 335.5 MB per eval chunk, 0.100 ms at 3.35 TB/s; then the corner loads,
// 1,280 bytes per point from L2.
constexpr int kMaxQuads = 12;                    // C up to 8 + 4 * 10

template <int Q>
__global__ void __launch_bounds__(kThreads)
trilinear_sample_wide_kernel(const float4* __restrict__ vol,
                             const float* __restrict__ ndc,
                             float4* __restrict__ out, long long n, int D,
                             int Hv, int Wv) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n * Q) return;
  const long long i = t / Q;
  const int q = static_cast<int>(t - i * Q);
  const Taps p = taps_of(ndc[3 * i], ndc[3 * i + 1], ndc[3 * i + 2], D, Hv, Wv);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    const int zi = p.z0 + dz, yi = p.y0 + dy, xi = p.x0 + dx;
    if (!inside(zi, yi, xi, D, Hv, Wv)) continue;
    const float wgt = corner_weight(dz, dy, dx, p.fx, p.fy, p.fz);
    const float4 c = __ldg(vol + cell_of(zi, yi, xi, Hv, Wv) * Q + q);
    acc.x += c.x * wgt; acc.y += c.y * wgt; acc.z += c.z * wgt; acc.w += c.w * wgt;
  }
  out[t] = acc;
}

// K4: d_vol += g * (trilinear weight) at each in-range corner.
//
// Replaces zest_tpu/kernels/trilinear.py:_bwd_pallas (pallas_call at :303),
// the adjoint of the lookup in the volume. The TPU form accumulates banded
// per-sample mini-volumes with transposed two-hot matmuls and segment-adds
// them with a one-hot matmul; here each thread owns one point (lanes are
// consecutive samples of a ray, as they lie in memory) and adds its
// 8-channel gradient times each in-range corner's weight into the zeroed
// d_vol (zeros padding: out-of-range corners add nothing).
//
// What bounds it on an H100: the atomics' transactions in L2, since a
// warp's 32 lanes add to ~24 distinct lines per corner. The one-point form
// issued 64 scalar atomicAdd per point: 0.570-0.582 ms on the flagship
// training step's three lookups, their zero fills included
// (tools/probe_trilinear.py). Here each corner is two 16-byte vector
// atomics (atomicAdd(float4*), red.global.add.v4.f32 on sm_90): 16 per
// point. And where a ray's next sample lies one z plane further (z0 + 1)
// and within one voxel in y and x, the common case at 128 samples over 128
// planes, the next sample's lower corners are this sample's upper corners:
// the next lane adds this lane's value to its own (one shuffle of the
// neighbour's cell, fractions and gradient) and this lane skips those
// atomics. Only the upper corners are handed on and only the lower ones
// receive, so no value moves twice. On the flagship step's rays a warp's
// 256 in-range corner taps fall in 131.8 distinct cells; the hand-on leaves
// 6.07 corners (12.1 vector atomics) per point of its 8 taps, and the three
// lookups take 0.211-0.225 ms. The rest of the coincidences (two samples in
// one plane, or two planes apart, as the jitter puts them) are left to the
// atomics. The caller's zero fill of d_vol (86.5 MB at the flagship) is
// part of the work.
//
// On the colour volume (use_color_volume) g has gq = C / 4 float4 per
// point and only its first two (the encoding volume's 8 channels) carry a
// gradient to a parameter: the colours are made from the input images. K4
// reads those two and writes the 8-channel d_vol as above, so its atomics
// stay 86.5 MB at the flagship where all 40 channels would be 432.5 MB.
__global__ void __launch_bounds__(kThreads)
trilinear_grad_volume_kernel(const float4* __restrict__ g,
                             const float* __restrict__ ndc,
                             float4* __restrict__ d_vol, int n, int gq, int D,
                             int Hv, int Wv) {
  constexpr unsigned kAll = 0xffffffffu;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool valid = i < n;
  Taps t{0, 0, 0, 0.f, 0.f, 0.f};
  float4 g0 = make_float4(0.f, 0.f, 0.f, 0.f), g1 = g0;
  if (valid) {
    t = taps_of(ndc[3 * i], ndc[3 * i + 1], ndc[3 * i + 2], D, Hv, Wv);
    g0 = __ldg(g + gq * i);
    g1 = __ldg(g + gq * i + 1);
  }
  // the neighbours' floor cells: is the previous (next) lane's point one z
  // plane below (above) this one, within one voxel in y and x?
  const int p_ok = __shfl_up_sync(kAll, static_cast<int>(valid), 1);
  const int pz = __shfl_up_sync(kAll, t.z0, 1), py = __shfl_up_sync(kAll, t.y0, 1),
            px = __shfl_up_sync(kAll, t.x0, 1);
  const int n_ok = __shfl_down_sync(kAll, static_cast<int>(valid), 1);
  const int nz = __shfl_down_sync(kAll, t.z0, 1), ny = __shfl_down_sync(kAll, t.y0, 1),
            nx = __shfl_down_sync(kAll, t.x0, 1);
  const bool from_prev = lane > 0 && valid && p_ok && pz + 1 == t.z0 &&
                         abs(t.y0 - py) <= 1 && abs(t.x0 - px) <= 1;
  const bool to_next = lane < 31 && valid && n_ok && t.z0 + 1 == nz &&
                       abs(ny - t.y0) <= 1 && abs(nx - t.x0) <= 1;
  // the previous point's fractions and gradient, where any lane takes them
  float pfx = 0.f, pfy = 0.f, pfz = 0.f;
  float4 pg0 = make_float4(0.f, 0.f, 0.f, 0.f), pg1 = pg0;
  if (__any_sync(kAll, from_prev)) {
    pfx = __shfl_up_sync(kAll, t.fx, 1);
    pfy = __shfl_up_sync(kAll, t.fy, 1);
    pfz = __shfl_up_sync(kAll, t.fz, 1);
    pg0.x = __shfl_up_sync(kAll, g0.x, 1); pg0.y = __shfl_up_sync(kAll, g0.y, 1);
    pg0.z = __shfl_up_sync(kAll, g0.z, 1); pg0.w = __shfl_up_sync(kAll, g0.w, 1);
    pg1.x = __shfl_up_sync(kAll, g1.x, 1); pg1.y = __shfl_up_sync(kAll, g1.y, 1);
    pg1.z = __shfl_up_sync(kAll, g1.z, 1); pg1.w = __shfl_up_sync(kAll, g1.w, 1);
  }
  if (!valid) return;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    const int zi = t.z0 + dz, yi = t.y0 + dy, xi = t.x0 + dx;
    if (!inside(zi, yi, xi, D, Hv, Wv)) continue;
    if (dz == 1 && to_next) {
      // the next point's lower corner (dy - (ny - y0), dx - (nx - x0)) is
      // this cell: the next lane adds it
      const unsigned ly = dy - (ny - t.y0), lx = dx - (nx - t.x0);
      if (ly <= 1u && lx <= 1u) continue;
    }
    const float wgt = corner_weight(dz, dy, dx, t.fx, t.fy, t.fz);
    float4 u0 = make_float4(g0.x * wgt, g0.y * wgt, g0.z * wgt, g0.w * wgt);
    float4 u1 = make_float4(g1.x * wgt, g1.y * wgt, g1.z * wgt, g1.w * wgt);
    if (dz == 0 && from_prev) {
      // this cell is the previous point's upper corner (uy, ux) if both are
      // 0 or 1
      const unsigned uy = t.y0 - py + dy, ux = t.x0 - px + dx;
      if (uy <= 1u && ux <= 1u) {
        const float pw = corner_weight(1, uy, ux, pfx, pfy, pfz);
        u0.x += pg0.x * pw; u0.y += pg0.y * pw; u0.z += pg0.z * pw; u0.w += pg0.w * pw;
        u1.x += pg1.x * pw; u1.y += pg1.y * pw; u1.z += pg1.z * pw; u1.w += pg1.w * pw;
      }
    }
    float4* p = d_vol + cell_of(zi, yi, xi, Hv, Wv) * 2;
    atomicAdd(p, u0);     // red.global.add.v4.f32 (sm_90)
    atomicAdd(p + 1, u1);
  }
}

// K5: d_ndc = sum over in-range corners of (corner . g) times the derivative
// of the corner's weight, scaled by the unnormalization (size - 1).
//
// Replaces zest_tpu/kernels/trilinear.py:_coords_pallas (pallas_call at
// :353), which contracts derivative two-hot matrices against banded volume
// slices. Here the blend's d/d(x, y, z) is taken as F.grid_sample's grid
// gradient takes it (an out-of-range corner adds nothing), times
// d(coordinate)/d(ndc) = size - 1 for ndc * 2 - 1 under align_corners=True.
//
// Why the layout: with one thread per point in memory order, a warp held 32
// consecutive samples of one ray, whose corners lie on 32 different z
// planes, and each thread issued 16 separate 16-byte corner loads: 13.1 L1
// line requests per point on the flagship training step's t+-1 points
// (tools/probe_trilinear.py, k5_lines). A point's two corners at x0 and
// x0 + 1 of one (z, y) are one 64-byte row of the [D, Hv, Wv, 8] volume,
// and a point has four such rows. Here kCoordLanes = 4 lanes share a point
// (a warp holds 8): lane j loads the float4 at byte 16 j of each row, which
// is corner dx = j >> 1's half j & 1 of the channels, masked by that
// corner's own range test, and dots it with the same half of g. Each lane
// sums its share of the three derivative sums over the four rows, and two
// xor shuffles add the four shares; lanes 0-2 write x, y and z, 12
// contiguous bytes per point. That is 4.2 line requests per point. Lanes of
// a point past n take part in the shuffles with zero shares. The grid holds
// as many blocks as stay resident, or fewer, each walking the same number
// of 64-point strides (a grid of one block per 64 points measured 5 %
// slower). taps_of and the weight products are the one-point form's; the
// sum over corners runs in another order (the twin's to 1e-5 of the
// largest, never bit for bit).
//
// What bounds it on an H100 (device time at the t+-1 points, PERF.md §6):
// 0.0275 -> 0.0217 ms against a bound of 0.011. The corner loads now take
// about 0.013 ms of it (0.024 in the one-point form): with every point
// moved outside the volume, so that no corner is loaded, it takes 0.0084
// ms against the one-point form's 0.0033, since a thread keeps a quarter
// of the points in flight. Handing a point's upper rows to the lanes of the
// point below by shuffles, 2 or 8 lanes per point, two points per pass,
// reading the next pass's coordinates a pass ahead, or one lane reading
// the coordinates of 32 points for four passes of 8 were all slower
// (0.0221-0.0313 ms).
constexpr int kCoordLanes = 4;                                // per point
constexpr int kCoordPoints = kThreads / kCoordLanes;          // per block

__global__ void __launch_bounds__(kThreads)
trilinear_grad_coords_kernel(const float4* __restrict__ vol,
                             const float* __restrict__ ndc,
                             const float4* __restrict__ g,
                             float* __restrict__ d_ndc, long long n, int D,
                             int Hv, int Wv) {
  constexpr unsigned kAll = 0xffffffffu;
  const int j = threadIdx.x % kCoordLanes;
  const int dx = j >> 1, half = j & 1;       // this lane's float4 of a row
  // a warp's first point bounds the loop, so all 32 lanes run every pass
  const long long warp_first =
      (static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31u)) /
      kCoordLanes;
  const long long stride = static_cast<long long>(gridDim.x) * kCoordPoints;
  for (long long first = warp_first; first < n; first += stride) {
    const long long i = first + (threadIdx.x & 31) / kCoordLanes;
    float gx = 0.f, gy = 0.f, gz = 0.f;
    if (i < n) {
      const Taps t = taps_of(ndc[3 * i], ndc[3 * i + 1], ndc[3 * i + 2], D, Hv,
                             Wv);
      const float4 gh = __ldg(g + 2 * i + half);
      const int xi = t.x0 + dx;
      const float wx = dx ? t.fx : 1.f - t.fx, sx = dx ? 1.f : -1.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {           // rows (z, y) = 00, 01, 10, 11
        const int dz = r >> 1, dy = r & 1;
        const int zi = t.z0 + dz, yi = t.y0 + dy;
        if (!inside(zi, yi, xi, D, Hv, Wv)) continue;
        const float4 c = __ldg(vol + cell_of(zi, yi, xi, Hv, Wv) * 2 + half);
        const float s = c.x * gh.x + c.y * gh.y + c.z * gh.z + c.w * gh.w;
        const float wy = dy ? t.fy : 1.f - t.fy, sy = dy ? 1.f : -1.f;
        const float wz = dz ? t.fz : 1.f - t.fz, sz = dz ? 1.f : -1.f;
        gx += s * sx * wy * wz;
        gy += s * wx * sy * wz;
        gz += s * wx * wy * sz;
      }
    }
    // the point's four shares
    for (int m = 1; m < kCoordLanes; m <<= 1) {
      gx += __shfl_xor_sync(kAll, gx, m);
      gy += __shfl_xor_sync(kAll, gy, m);
      gz += __shfl_xor_sync(kAll, gz, m);
    }
    if (i < n && j < 3)
      d_ndc[3 * i + j] = j == 0 ? gx * (Wv - 1) : j == 1 ? gy * (Hv - 1)
                                                         : gz * (D - 1);
  }
}

}  // namespace

template <int... Qs>
void launch_wide(int quads, std::integer_sequence<int, Qs...>,
                 cudaStream_t stream, const float* vol, const float* ndc,
                 float* out, long long n, int D, int Hv, int Wv) {
  ((quads == Qs + 3
        ? trilinear_sample_wide_kernel<Qs + 3>
              <<<zt::blocks_for(n * (Qs + 3), kThreads), kThreads, 0,
                 stream>>>(reinterpret_cast<const float4*>(vol), ndc,
                           reinterpret_cast<float4*>(out), n, D, Hv, Wv)
        : void()),
   ...);
}

// vol [D, Hv, Wv, C], ndc [R, S, 3] -> out [R, S, C]; C a multiple of 4
// from 8 to 4 * kMaxQuads; vol and out 16-byte aligned. Rays of one sample
// are taken as rows of 2 consecutive points (any grouping of the points
// gives the same output).
ZT_API int zt_trilinear_sample(const float* vol, const float* ndc, float* out,
                               int R, int S, int D, int Hv, int Wv, int C,
                               void* stream) {
  if (R < 0 || S < 0 || C % 4 || C < 8 || C > 4 * kMaxQuads)
    return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(R) * S;
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (S < kWarpSamples || S > 65535LL * kBlockSamples) {
    S = kWarpSamples;
    R = static_cast<int>((n + S - 1) / S);
  }
  if (n > 0 && C > 8) {
    launch_wide(C / 4, std::make_integer_sequence<int, kMaxQuads - 2>(),
                static_cast<cudaStream_t>(stream), vol, ndc, out, n, D, Hv,
                Wv);
  } else if (n > 0) {
    const dim3 grid(zt::blocks_for(R, kBlockRays), zt::blocks_for(S, kBlockSamples));
    trilinear_sample_kernel<<<grid, kSampleThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(vol), ndc,
        reinterpret_cast<float4*>(out), R, S, n, D, Hv, Wv);
  }
  return static_cast<int>(cudaGetLastError());
}

// g [n, gC] (its first 8 channels taken; gC a multiple of 4, >= 8), ndc
// [n, 3] -> d_vol [D, Hv, Wv, 8] added to
ZT_API int zt_trilinear_grad_volume(const float* g, const float* ndc,
                                    float* d_vol, int n, int gC, int D, int Hv,
                                    int Wv, void* stream) {
  if (gC % 4 || gC < 8) return cudaErrorInvalidValue;
  if (n > 0) {
    trilinear_grad_volume_kernel<<<zt::blocks_for(n, kThreads), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(g), ndc,
        reinterpret_cast<float4*>(d_vol), n, gC / 4, D, Hv, Wv);
  }
  return static_cast<int>(cudaGetLastError());
}

ZT_API int zt_trilinear_grad_coords(const float* vol, const float* ndc,
                                    const float* g, float* d_ndc, int n, int D,
                                    int Hv, int Wv, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n > 0) {
    // as many blocks as fit on the card at once, or fewer; each walks the
    // same number of strides of kCoordPoints points
    static int per_sm = 0;
    if (per_sm == 0) {
      const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, trilinear_grad_coords_kernel, kThreads, 0);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long needed = zt::blocks_for(n, kCoordPoints);
    const long long resident = std::max(1LL, static_cast<long long>(per_sm) * sms);
    const long long passes = (needed + resident - 1) / resident;
    trilinear_grad_coords_kernel<<<zt::blocks_for(needed, static_cast<int>(passes)),
                                   kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(vol), ndc,
        reinterpret_cast<const float4*>(g), d_ndc, n, D, Hv, Wv);
  }
  return static_cast<int>(cudaGetLastError());
}
