// The time code folded into a field's biases (train_video), and its
// backward.
//
// Replaces the time code's share of the fused field on the TPU:
// zest_tpu/kernels/fused_mlp.py:_fwd_pallas (pallas_call at :376) and
// _bwd_pallas (:398) take the static field's points input as [pts(63),
// code(1024)] and multiply all 1,087 channels by the first layer's and the
// skip layer's weights at every point. The code is the same for every point
// of a call, so its share of those two layers is a per-call bias:
// [pts, s] @ W^T + b = pts @ W_pts^T + (b + s @ W_code^T), under v0's
// multiplicative conditioning too (it multiplies after the Linear). The
// field kernels then run with 63 point channels; these kernels form the
// folded biases c = b + s @ W_code^T once per call, and take their backward
// from the folded biases' gradient d_c (K7's bias gradient of those
// layers): d_s = d_c @ W_code, d_W_code = d_c (x) s.
//
// Layout: wc [rows, T] (the code columns of each folding layer's weight,
// layer after layer, W rows each), b and c [rows], s [T]. With bf16 set, s
// and wc are rounded to bf16 (nearest, ties to even) and summed in float32,
// as the field's bf16-operand mode rounds its operands; d_c is not rounded.
//
// What bounds them on an H100: the read of wc (2 x 256 x 1024 floats, 2.1
// MB, 0.6 us at 3.35 TB/s) and, for the backward, the write of d_wc; both
// are a few microseconds of launch and latency at these sizes.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGradRows = 16;     // rows of wc per backward block

template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// one warp per row: its lanes walk the row 32 channels apart, then a
// butterfly sums them
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
fold_codes_kernel(const float* __restrict__ s, const float* __restrict__ wc,
                  const float* __restrict__ b, float* __restrict__ c, int rows,
                  int T) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* w = wc + static_cast<long long>(row) * T;
  float acc = 0.f;
  for (int t = lane; t < T; t += 32)
    acc = fmaf(operand<kBf16>(__ldg(s + t)), operand<kBf16>(__ldg(w + t)), acc);
#pragma unroll
  for (int m = 16; m; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) c[row] = b[row] + acc;
}

// a thread per code channel t and block of kGradRows rows: d_wc of those
// rows at t, and their share of d_s[t] added to the zeroed d_s
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
fold_codes_grad_kernel(const float* __restrict__ s,
                       const float* __restrict__ wc,
                       const float* __restrict__ d_c, float* __restrict__ d_s,
                       float* __restrict__ d_wc, int rows, int T) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int r0 = blockIdx.y * kGradRows;
  if (t >= T) return;
  const float st = operand<kBf16>(__ldg(s + t));
  float acc = 0.f;
  const int r1 = min(r0 + kGradRows, rows);
  for (int r = r0; r < r1; ++r) {
    const long long i = static_cast<long long>(r) * T + t;
    const float g = __ldg(d_c + r);
    acc = fmaf(g, operand<kBf16>(__ldg(wc + i)), acc);
    d_wc[i] = g * st;
  }
  atomicAdd(d_s + t, acc);
}

}  // namespace

// s [T], wc [rows, T], b [rows] -> c [rows]
ZT_API int zt_fold_codes(const float* s, const float* wc, const float* b,
                         float* c, int rows, int T, int bf16, void* stream) {
  if (rows < 0 || T < 0) return cudaErrorInvalidValue;
  if (rows > 0) {
    const unsigned grid = zt::blocks_for(static_cast<long long>(rows) * 32,
                                         kThreads);
    auto kernel = bf16 ? fold_codes_kernel<true> : fold_codes_kernel<false>;
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        s, wc, b, c, rows, T);
  }
  return static_cast<int>(cudaGetLastError());
}

// s [T], wc [rows, T], d_c [rows] -> d_s [T] (zeroed by the caller; added
// to), d_wc [rows, T]
ZT_API int zt_fold_codes_grad(const float* s, const float* wc, const float* d_c,
                              float* d_s, float* d_wc, int rows, int T,
                              int bf16, void* stream) {
  if (rows < 0 || T < 0) return cudaErrorInvalidValue;
  if (rows > 0 && T > 0) {
    const dim3 grid(zt::blocks_for(T, kThreads),
                    zt::blocks_for(rows, kGradRows));
    auto kernel = bf16 ? fold_codes_grad_kernel<true>
                       : fold_codes_grad_kernel<false>;
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        s, wc, d_c, d_s, d_wc, rows, T);
  }
  return static_cast<int>(cudaGetLastError());
}
