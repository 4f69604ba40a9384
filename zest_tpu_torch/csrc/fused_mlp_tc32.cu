// Fused NeRF field, forward (K6), float32 mode on the tensor cores (3xTF32).
//
// Replaces the TPU kernel zest_tpu/kernels/fused_mlp.py:_fwd_pallas
// (pallas_call at :376; its per-tile math is _forward_tile) in its
// approx=False mode, "exact 6-pass f32" (Precision.HIGHEST on the TPU): the
// port's default precision 32. The bf16-operand mode is fused_mlp_tc.cu, on
// the same tile. The backward's float32 mode recomputes the forward on the
// CUDA cores (pass 1, fused_mlp.cu) and takes its weight gradients on the
// tensor cores as 3xTF32 too (pass 2, fused_mlp_tc32_bwd.cu).
//
// What it computes is the float32 twin's field (models/nerf.py, NeRFField
// with bf16=False):
//   cond = feats @ Wb + bb
//   h    = relu((h @ W_i + b_i) * cond)             i = 0 .. depth-1; the
//          layer after `skip` reads [pts, h] as one product over both parts
//   alpha = h @ Wa + ba;  static: sigmoid(h @ Ww + bw);
//          dynamic: tanh(h @ Ws + bs) (6), sigmoid(h @ Wp + bp) (2)
//   hv  = relu([h @ Wf + bf, views] @ Wv + bv)      (width / 2)
//   rgb = hv @ Wr + br
// Output row: [rgb(3), alpha(1), extras].
//
// 3xTF32. The conditioning, trunk, feature and views products (~603 K of
// the ~606 K multiply-adds per point at width 256) run on the tensor cores:
// each float32 operand x is split as big = tf32(x) and small = tf32(x -
// big), both rounded as cvt.rna.tf32.f32 rounds (split_tf32), and each k8
// step adds small_a big_b, big_a small_b and then big_a big_b into one
// float32 sum, three mma.sync.m16n8k8 TF32; small_a small_b (~2^-22 of the
// product) is dropped. That keeps ~22 bits of each operand, float32-class
// where one TF32 product keeps 11: CUTLASS's "3xTF32 fast accurate" GEMM.
// Biases, cond, the product with cond, the ReLU, h_last as the heads read
// it, hv and the heads (~2.7 K multiply-adds per point) stay float32 on the
// CUDA cores, as in the bf16 tile.
//
// Layout: fused_mlp_tc.cu's tile (fused_mlp_tc.cuh) with float operands. A
// block of 8 warps takes 64 points; each product's [64 x N] result stays in
// registers (cond too), h is [64][width + 4] float32 in shared memory, and
// the weights are one stream of K slices through the 3-slot cp.async ring.
// Shared memory holds every operand once, as plain float32: the split runs
// in registers after ldmatrix, whose 8x8 b16 matrix is an 8x4 block of
// 32-bit elements, lane l getting (row l / 4, column l % 4), the A and B
// fragments of m16n8k8 TF32. So a ring slice row is 32 floats (128 bytes,
// as the bf16 tile's 64 bf16), and every operand row is padded by 16 bytes,
// which keeps the 8 rows of an ldmatrix in distinct banks. At width 256 a
// block takes 229,376 bytes for the dynamic field: the ring 110,592, h
// 66,560, the inputs (each K part padded to a multiple of 8, the mma depth)
// 39,936, the head partials 12,288; a block may opt into 232,448.
//
// Weights: an operand pack per call, float32 [out][K] (K-contiguous, the B
// layout of mma .row.col; each K part zero padded to a multiple of 8, the
// matrices in the order the kernel runs them, mat_of), made from the float32
// [in][out] pack on the card by pack_tc32_kernel (one launch; its plain
// version is kernels/fused_mlp.py:pack_tc32_plain).
//
// What bounds it on an H100: the products, 5.1 TFLOP per flagship eval chunk
// (both fields, 2,097,152 points each), each taken three times: 15.3 TFLOP,
// 31 ms at the 494.7 TFLOP/s dense-TF32 rate. This kernel takes ~100 ms on
// an H100 SXM at 700 W (~153 TFLOP/s of TF32 products; PERF.md §6), 255
// registers at width 256 and no spills. A variant with one TF32 product per
// k8 step (16 mma per warp, not 48; not kept) was far from three times as
// fast: the tile's cost per k step (ldmatrix, the split, two warps per
// scheduler to hide the mma latency) is most of the time, at twice the
// steps of the bf16 tile, which takes k16. cvt.rna.tf32.f32 compiles to a
// longer sequence than the integer split (114 ms with it), and running the
// three terms tile by tile instead of term by term was slower.
//
// In a training step the backward's float32 mode (its pass 1, fused_mlp.cu,
// SIMT) recomputes this forward with FMA sums in another order, so its gradient
// is taken at activations that differ from the ones the loss saw by float32
// rounding noise (PERF.md §7); a ReLU input within that noise of zero can
// take the other branch there.
#include "fused_mlp_tc.cuh"

namespace {

constexpr int kQ = Operand<float>::kK;   // each K part padded to a multiple

__host__ __device__ inline size_t smem_bytes(int W, int Pp, int Fp, int Vp) {
  return sizeof(float) * (4 * kM * kRed + kM * (W + kPad<float>) +
                          kStages * W * kStride<float> +
                          kM * (Pp + Fp + Vp + 3 * kPad<float>));
}

template <int WIDTH>
__global__ void __launch_bounds__(kThreads, 1)
fused_nerf_tc32_kernel(const float* __restrict__ pts,
                       const float* __restrict__ feats,
                       const float* __restrict__ views,
                       TcParamsOf<float> prm, float* __restrict__ out,
                       long long n, int P, int F, int V, int depth, int skip,
                       int n_extra) {
  constexpr int W = WIDTH;
  constexpr int HS = W + kPad<float>;  // row stride of h
  const Geo g = make_geo(W, depth, skip, P, F, V, kQ);
  const int PS = g.Pp + kPad<float>, FS = g.Fp + kPad<float>,
            VS = g.Vp + kPad<float>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  float* hs = red + 4 * kM * kRed;
  float* xs = hs + kM * HS + kStages * W * kStride<float>;
  float* fs = xs + kM * PS;
  float* vs = fs + kM * FS;
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kM;

  RingOf<float> rg{hs + kM * HS, 0, 0, 0, 0};
  for (int s = 0; s < kStages - 1; ++s) fetch<W>(rg, prm.st, tid);
  load_tile(xs, PS, g.Pp, pts, P, row0, n, tid);
  load_tile(fs, FS, g.Fp, feats, F, row0, n, tid);
  load_tile(vs, VS, g.Vp, views, V, row0, n, tid);

  float cond[2][W / 32][4], accv[2][W / 64][4];
  forward_tile<W, W>(prm, g, rg, hs, xs, PS, fs, FS, vs, VS, red, cond, accv,
                     n_extra, tid, NoSave{});
  __syncthreads();                     // every partial is in red

  // the block's output rows are contiguous in out: coalesced stores
  const int out_ch = n_extra == 1 ? 5 : 12;
  const long long rows = n - row0 < kM ? n - row0 : kM;
  for (int e = tid; e < rows * out_ch; e += kThreads) {
    const int r = e / out_ch, c = e - r * out_ch;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) v += red[(q * kM + r) * kRed + c];
    out[row0 * out_ch + e] = head_out(prm, n_extra, c, v);
  }
}

// The operand pack from the float32 one: matrix blockIdx.y of the stream,
// its weight transposed to [rows][K], each part's padding columns zero.
__global__ void pack_tc32_kernel(const float* __restrict__ w,
                                 TcParamsOf<float> prm, Geo g, Moff moff,
                                 float* __restrict__ wt) {
  const Mat t = mat_of(g, blockIdx.y);
  const float* src = w + prm.off[t.slot];
  float* dst = wt + moff.m[blockIdx.y];
  const int len = t.rows * t.K;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < len;
       e += gridDim.x * blockDim.x)
    dst[e] = packed_weight(src, t, e);
}

template <int WIDTH>
int launch_tc32(const float* pts, const float* feats, const float* views,
                const TcParamsOf<float>& prm, float* out, long long n, int P,
                int F, int V, int depth, int skip, int n_extra,
                cudaStream_t stream) {
  const size_t smem =
      smem_bytes(WIDTH, pad_to(P, kQ), pad_to(F, kQ), pad_to(V, kQ));
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_nerf_tc32_kernel<WIDTH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks = static_cast<unsigned int>((n + kM - 1) / kM);
  fused_nerf_tc32_kernel<WIDTH><<<blocks, kThreads, smem, stream>>>(
      pts, feats, views, prm, out, n, P, F, V, depth, skip, n_extra);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The operand pack of K6's float32 mode, made on the card from the float32
// pack (wpack / offsets: fused_mlp.cu's layout) into wt, which holds
// zt_fused_nerf_pack_tc32_len floats: every matrix of the stream as
// nn.Linear stores it, [out][K], K's parts zero padded to multiples of 8,
// back to back (the plain version: kernels/fused_mlp.py:pack_tc32_plain).
ZT_API int zt_fused_nerf_pack_tc32(const float* wpack, const int* offsets,
                                   float* wt, int P, int F, int V, int width,
                                   int depth, int skip, void* stream) {
  TcParamsOf<float> prm;
  Geo g;
  if (!tc_params(prm, g, wpack, offsets, wt, P, F, V, width, depth, skip))
    return cudaErrorInvalidValue;
  Moff moff;
  mat_offsets(g, moff.m);
  pack_tc32_kernel<<<dim3(32, depth + 3), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(wpack, prm, g, moff,
                                                          wt);
  return static_cast<int>(cudaGetLastError());
}

// floats of the operand pack at these shapes
ZT_API int zt_fused_nerf_pack_tc32_len(int P, int F, int V, int width,
                                       int depth, int skip) {
  if (depth < 1 || depth > kMaxLayers) return -1;
  int moff[kMats + 1];
  mat_offsets(make_geo(width, depth, skip, P, F, V, kQ), moff);
  return moff[depth + 3];
}

// K6 in its float32 mode. wpack / offsets: the float32 pack and its slots
// (the biases and the heads are read from it); wt: the operand pack that
// zt_fused_nerf_pack_tc32 made from them.
ZT_API int zt_fused_nerf_forward_tc32(const float* pts, const float* feats,
                                      const float* views, const float* wpack,
                                      const int* offsets, const float* wt,
                                      float* out, int n, int P, int F, int V,
                                      int width, int depth, int skip,
                                      int n_extra, void* stream) {
  TcParamsOf<float> prm;
  Geo g;
  if (n_extra < 1 || n_extra > 2 ||
      !tc_params(prm, g, wpack, offsets, wt, P, F, V, width, depth, skip))
    return cudaErrorInvalidValue;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 64:
      return launch_tc32<64>(pts, feats, views, prm, out, n, P, F, V, depth,
                             skip, n_extra, st);
    case 128:
      return launch_tc32<128>(pts, feats, views, prm, out, n, P, F, V, depth,
                              skip, n_extra, st);
    default:
      return launch_tc32<256>(pts, feats, views, prm, out, n, P, F, V, depth,
                              skip, n_extra, st);
  }
}

// bytes of dynamic shared memory a block of the kernel takes at these shapes
ZT_API int zt_fused_nerf_forward_tc32_smem(int width, int P, int F, int V) {
  return static_cast<int>(
      smem_bytes(width, pad_to(P, kQ), pad_to(F, kQ), pad_to(V, kQ)));
}
