// Plane-sweep homography warp: forward (K1) and its adjoint in the source
// features (K2, further down).
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

// The bilinear taps of one grid value, as the forward forms them: the
// top-left tap (x0, y0), the fractions, and which of the 4 taps are inside.
struct Taps2 {
  int x0, y0;
  float fx, fy;
  bool vx0, vx1, vy0, vy1;
};

__device__ __forceinline__ Taps2 taps_at(const float2* grid, long long idx,
                                         int h, int w) {
  const float2 v = __ldg(grid + idx);
  const float x = zt::clamp_far(zt::unnormalize(v.x, w), w);
  const float y = zt::clamp_far(zt::unnormalize(v.y, h), h);
  const float x0f = floorf(x), y0f = floorf(y);
  Taps2 t;
  t.x0 = static_cast<int>(x0f);
  t.y0 = static_cast<int>(y0f);
  t.fx = x - x0f;
  t.fy = y - y0f;
  t.vx0 = t.x0 >= 0 && t.x0 < w;
  t.vx1 = t.x0 + 1 >= 0 && t.x0 + 1 < w;
  t.vy0 = t.y0 >= 0 && t.y0 < h;
  t.vy1 = t.y0 + 1 >= 0 && t.y0 + 1 < h;
  return t;
}

// K2: d_src[c, y, x] = sum over planes and output pixels of g times the
// bilinear weight of every tap that lands on (x, y).
//
// Replaces zest_tpu/kernels/plane_sweep.py:_pallas_warp_bwd (pallas_call at
// :261), which accumulates transposed band matmuls into one resident block
// over the sequential grid of planes. On the card the design rests on how
// little a pixel's taps move from plane to plane: a plane sweep's planes
// differ only in depth, so across all D planes an output pixel's source
// position shifts by the baseline's disparity range (at most ~3 source
// pixels for the flagship's views, where 97 % of consecutive planes keep
// the same top-left tap). So one thread owns one output pixel and a group of
// up to kBwdGroup channels, walks kBwdPlanes planes, and sums g times each
// of the 4 tap weights in registers for as long as the top-left tap stays
// where it is; when it moves, and at the end, it adds the 4 x group sums to
// d_src with global atomics (the taps inside the source, nonzero sums only).
// Neighbouring lanes own neighbouring pixels: each g load is one coalesced
// line per warp, and each atomic lands on neighbouring source pixels. A
// plane where no tap of the pixel is inside the source reads no g at all
// (about 55 % of the padded frustum at the flagship), and planes are taken
// in pairs so that both planes' loads are in flight together. Blocks of
// the same pixels and planes but another channel group launch next to each
// other and read the grid from L2. Any grid is exact; only the number of
// atomics depends on how far the taps move.
// What bounds it on an H100: reading g at the (plane, pixel) items that have
// a tap inside the source (D * C * Hp * Wp floats at most, 378 MB per source
// view at the flagship) and the grid once; d_src is 1.3 MB.
constexpr int kBwdThreads = 256;
constexpr int kBwdPlanes = 32;       // planes one thread walks
constexpr int kBwdGroup = 8;         // most channels one thread carries
constexpr int kNoTap = -(1 << 20);   // a tap origin no grid value gives

struct WarpBwdAcc {
  float s[4][kBwdGroup];             // tap (a, b) = (dy, dx) at s[2a + b]
  int x0, y0;                        // the top-left tap the sums belong to
};

// Adds the sums to d_src at the taps inside the source, and clears them.
__device__ __forceinline__ void flush_taps(WarpBwdAcc& acc, float* d_src,
                                           int c0, int nc, int h, int w) {
  const long long plane = static_cast<long long>(h) * w;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int y = acc.y0 + a, x = acc.x0 + b;
      const bool inside = y >= 0 && y < h && x >= 0 && x < w;
      float* dst = d_src + static_cast<long long>(c0) * plane +
                   static_cast<long long>(y) * w + x;
#pragma unroll
      for (int j = 0; j < kBwdGroup; ++j) {
        const float v = acc.s[2 * a + b][j];
        if (inside && j < nc && v != 0.f) atomicAdd(dst + j * plane, v);
        acc.s[2 * a + b][j] = 0.f;
      }
    }
  }
}

// One plane's contribution: g values gv of the group at taps t.
__device__ __forceinline__ void add_plane(WarpBwdAcc& acc, const Taps2& t,
                                          const float (&gv)[kBwdGroup],
                                          float* d_src, int c0, int nc, int h,
                                          int w) {
  if (t.x0 != acc.x0 || t.y0 != acc.y0) {
    flush_taps(acc, d_src, c0, nc, h, w);
    acc.x0 = t.x0;
    acc.y0 = t.y0;
  }
  const float wx[2] = {1.f - t.fx, t.fx}, wy[2] = {1.f - t.fy, t.fy};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float wt = wy[a] * wx[b];
#pragma unroll
      for (int j = 0; j < kBwdGroup; ++j)
        acc.s[2 * a + b][j] = fmaf(gv[j], wt, acc.s[2 * a + b][j]);
    }
  }
}

__device__ __forceinline__ bool any_inside(const Taps2& t) {
  return (t.vx0 || t.vx1) && (t.vy0 || t.vy1);
}

// the group's g values of one (plane, pixel) item, zero past the group
__device__ __forceinline__ void load_group(const float* gp, long long P, int nc,
                                           float (&gv)[kBwdGroup]) {
#pragma unroll
  for (int j = 0; j < kBwdGroup; ++j) gv[j] = j < nc ? __ldcs(gp + j * P) : 0.f;
}

__global__ void __launch_bounds__(kBwdThreads)
plane_sweep_warp_bwd_kernel(const float* __restrict__ g,
                            const float2* __restrict__ grid,
                            float* __restrict__ d_src, int D, int h, int w,
                            int C, int P, int group) {
  const int c0 = blockIdx.x * group;
  const int nc = min(group, C - c0);
  const int p = blockIdx.y * kBwdThreads + threadIdx.x;
  if (p >= P || nc <= 0) return;
  const int d0 = blockIdx.z * kBwdPlanes;
  const int d1 = min(d0 + kBwdPlanes, D);
  WarpBwdAcc acc;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int j = 0; j < kBwdGroup; ++j) acc.s[t][j] = 0.f;
  }
  acc.x0 = acc.y0 = kNoTap;
  for (int d = d0; d < d1; d += 2) {
    const bool two = d + 1 < d1;
    const long long item = static_cast<long long>(d) * P + p;
    const Taps2 ta = taps_at(grid, item, h, w);
    const Taps2 tb = taps_at(grid, two ? item + P : item, h, w);
    const bool ina = any_inside(ta), inb = two && any_inside(tb);
    const float* gp = g + (static_cast<long long>(d) * C + c0) * P + p;
    float ga[kBwdGroup], gb[kBwdGroup];
    load_group(gp, P, ina ? nc : 0, ga);
    load_group(gp + static_cast<long long>(C) * P, P, inb ? nc : 0, gb);
    if (ina) add_plane(acc, ta, ga, d_src, c0, nc, h, w);
    if (inb) add_plane(acc, tb, gb, d_src, c0, nc, h, w);
  }
  flush_taps(acc, d_src, c0, nc, h, w);
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

ZT_API int zt_plane_sweep_warp_backward(const float* g, const float* grid,
                                        float* d_src, int D, int h, int w,
                                        int C, int Hp, int Wp, void* stream) {
  if (D > 0 && Hp > 0 && Wp > 0 && C > 0) {
    const int P = Hp * Wp;
    // as few channel groups as kBwdGroup allows, balanced
    const int groups = (C + kBwdGroup - 1) / kBwdGroup;
    const int group = (C + groups - 1) / groups;
    const dim3 blocks(groups, zt::blocks_for(P, kBwdThreads),
                      (D + kBwdPlanes - 1) / kBwdPlanes);
    plane_sweep_warp_bwd_kernel<<<blocks, kBwdThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        g, reinterpret_cast<const float2*>(grid), d_src, D, h, w, C, P, group);
  }
  return static_cast<int>(cudaGetLastError());
}
