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

__device__ __forceinline__ Taps2 taps_at(const float* grid, long long idx, int h,
                                         int w) {
  const float x = zt::clamp_far(zt::unnormalize(grid[2 * idx], w), w);
  const float y = zt::clamp_far(zt::unnormalize(grid[2 * idx + 1], h), h);
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
// over the sequential grid of planes. Here a block takes one padded output
// row over kBwdPlanes planes. It first finds the bounding box of the source
// pixels its taps reach; where that box times a group of channels fits in
// shared memory, it scatters into a shared accumulator with shared-memory
// atomics and then adds the box to d_src with one global atomic per nonzero
// entry; otherwise it adds every tap to d_src directly. With the flagship's
// small baseline a row's taps over 16 planes fall on a few source rows, so
// the global atomics drop by roughly the number of taps per source pixel.
// What bounds it on an H100: reading g (D * C * Hp * Wp floats, 378 MB per
// source view at the flagship) once; d_src is 1.3 MB.
constexpr int kBwdThreads = 256;
constexpr int kBwdPlanes = 16;
constexpr int kBwdSmem = 12000;      // floats of the shared accumulator (< 48 KB)

__global__ void __launch_bounds__(kBwdThreads)
plane_sweep_warp_bwd_kernel(const float* __restrict__ g,
                            const float* __restrict__ grid,
                            float* __restrict__ d_src, int D, int h, int w,
                            int C, int Hp, int Wp) {
  __shared__ float acc[kBwdSmem];
  __shared__ int box[4];               // x min, x max, y min, y max
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int d0 = blockIdx.y * kBwdPlanes;
  const int d1 = d0 + kBwdPlanes < D ? d0 + kBwdPlanes : D;
  const long long P = static_cast<long long>(Hp) * Wp;
  const long long plane = static_cast<long long>(h) * w;
  if (tid == 0) {
    box[0] = w; box[1] = -1; box[2] = h; box[3] = -1;
  }
  __syncthreads();
  int xmn = w, xmx = -1, ymn = h, ymx = -1;
  for (int d = d0; d < d1; ++d) {
    for (int px = tid; px < Wp; px += kBwdThreads) {
      const Taps2 t = taps_at(grid, d * P + static_cast<long long>(row) * Wp + px,
                              h, w);
      if ((t.vx0 || t.vx1) && (t.vy0 || t.vy1)) {
        xmn = min(xmn, t.vx0 ? t.x0 : t.x0 + 1);
        xmx = max(xmx, t.vx1 ? t.x0 + 1 : t.x0);
        ymn = min(ymn, t.vy0 ? t.y0 : t.y0 + 1);
        ymx = max(ymx, t.vy1 ? t.y0 + 1 : t.y0);
      }
    }
  }
  if (xmx >= 0) {
    atomicMin(&box[0], xmn); atomicMax(&box[1], xmx);
    atomicMin(&box[2], ymn); atomicMax(&box[3], ymx);
  }
  __syncthreads();
  const int bx0 = box[0], by0 = box[2];
  const int bw = box[1] - bx0 + 1, bh = box[3] - by0 + 1;
  if (bw <= 0 || bh <= 0) return;     // no tap of this block is inside
  const int area = bw * bh;
  const int group = kBwdSmem / area;  // channels per shared pass
  const int step = group > 0 ? group : C;
  for (int c0 = 0; c0 < C; c0 += step) {
    const int c1 = c0 + step < C ? c0 + step : C;
    if (group > 0) {
      for (int k = tid; k < (c1 - c0) * area; k += kBwdThreads) acc[k] = 0.f;
      __syncthreads();
    }
    for (int d = d0; d < d1; ++d) {
      for (int px = tid; px < Wp; px += kBwdThreads) {
        const long long o = static_cast<long long>(row) * Wp + px;
        const Taps2 t = taps_at(grid, d * P + o, h, w);
        const int xs[2] = {t.x0, t.x0 + 1}, ys[2] = {t.y0, t.y0 + 1};
        const bool vx[2] = {t.vx0, t.vx1}, vy[2] = {t.vy0, t.vy1};
        const float wx[2] = {1.f - t.fx, t.fx}, wy[2] = {1.f - t.fy, t.fy};
        for (int c = c0; c < c1; ++c) {
          const float gv = __ldg(g + (static_cast<long long>(d) * C + c) * P + o);
          if (gv == 0.f) continue;
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            if (!vy[a]) continue;
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              if (!vx[b]) continue;
              const float v = gv * (wy[a] * wx[b]);
              if (group > 0)
                atomicAdd(&acc[(c - c0) * area + (ys[a] - by0) * bw + xs[b] - bx0], v);
              else
                atomicAdd(d_src + c * plane + static_cast<long long>(ys[a]) * w + xs[b], v);
            }
          }
        }
      }
    }
    if (group > 0) {
      __syncthreads();
      for (int k = tid; k < (c1 - c0) * area; k += kBwdThreads) {
        const float v = acc[k];
        if (v == 0.f) continue;
        const int c = c0 + k / area, r = k % area;
        atomicAdd(d_src + c * plane + static_cast<long long>(by0 + r / bw) * w +
                      bx0 + r % bw, v);
      }
      __syncthreads();
    }
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

ZT_API int zt_plane_sweep_warp_backward(const float* g, const float* grid,
                                        float* d_src, int D, int h, int w,
                                        int C, int Hp, int Wp, void* stream) {
  if (D > 0 && Hp > 0 && Wp > 0) {
    const dim3 blocks(Hp, (D + kBwdPlanes - 1) / kBwdPlanes);
    plane_sweep_warp_bwd_kernel<<<blocks, kBwdThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        g, grid, d_src, D, h, w, C, Hp, Wp);
  }
  return static_cast<int>(cudaGetLastError());
}
