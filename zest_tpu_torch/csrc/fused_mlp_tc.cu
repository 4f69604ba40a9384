// Fused NeRF field, forward (K6), bf16-operand mode on the tensor cores.
//
// Replaces the TPU kernel zest_tpu/kernels/fused_mlp.py:_fwd_pallas
// (pallas_call at :376; its per-tile math is _forward_tile) in its
// approx=True mode, the port's precision 16. The float32 mode (3xTF32) is
// fused_mlp_tc32.cu, on the same tile; the backward's bf16 mode is
// fused_mlp_tc_bwd.cu.
//
// What it computes is the bf16 twin's field (models/nerf.py, _BF16Linear):
//   cond = feats @ Wb + bb                          (float32, kept float32)
//   h    = relu((h @ W_i + b_i) * cond)             i = 0 .. depth-1; the
//          layer after `skip` reads [pts, h] as one product over both parts
//   alpha = h @ Wa + ba;  the extras (n_extra, fused_mlp.cuh): none;
//          the blend sigmoid(h @ Ww + bw); or tanh(h @ Ws + bs) (6),
//          sigmoid(h @ Wp + bp) (2)
//   hv  = relu([h @ Wf + bf, views] @ Wv + bv)      (width / 2)
//   rgb = hv @ Wr + br
// The conditioning, trunk, feature and views products take bf16-rounded
// operands with float32 sums (mma.sync.m16n8k16 bf16 -> f32, each k16 step
// summed from zero and added by FADD: mma_bf16_step); biases, cond,
// the product with cond, h_last as the heads read it and hv stay float32,
// and the heads (alpha, blend / flow / probability, rgb: ~2.7 K
// multiply-adds per point against ~603 K in the products) run on the CUDA
// cores. Output row: [rgb(3), alpha(1), extras].
//
// Layout. A block of 8 warps takes 64 points. The bf16 operands live in
// shared memory: the inputs (pts, feats, views, each rounded once and zero
// padded to a multiple of 16 columns) and the activation h [64][width],
// every row padded by 8 bf16 so that ldmatrix reads 8 rows without a bank
// conflict. Each product's [64 x N] result stays in registers: warp w owns
// rows 32 (w % 2) .. +32 and N/4 columns from N/4 (w / 2), as 2 x N/32
// m16n8 tiles. That thread-to-element map is the same in every width-N
// layer, so cond stays in registers too (64 floats a thread at width 256;
// with the accumulators and two k16 steps of fragments, 255 registers and
// no spills). Once every warp has read h, the epilogue writes
// relu((acc + b) * cond) back into h as bf16; the last trunk layer's
// float32 output stays in the accumulators, and the heads are products of
// those registers: each thread sums its columns, 4 lanes add by shuffles,
// and the 4 column warps meet in a small shared buffer, from which the
// block writes its output rows (contiguous in out) with coalesced stores.
//
// Weights. One bf16 pack per call, made from the float32 pack on the card by
// round_pack_tc_kernel (one launch; its plain version is
// kernels/fused_mlp.py:pack_bf16_plain): every bf16-operand matrix as
// nn.Linear stores it, [out][K], each part of K (pts / h of the skip layer,
// feature / views of the views layer) zero padded to a multiple of 16, the
// matrices in the order the kernel runs them (mat_of). That is
// K-contiguous, the B layout of mma .row.col. The whole field's weights
// are ONE stream of K slices of 64 columns (kKS) that cp.async copies from
// L2 into a ring of kStages shared-memory slots, shared by the block's warps;
// the stream runs on across layers, so the next layer's first slices arrive
// while this one finishes and its epilogue runs. Within a slice, the next
// k16 step's fragments load while this one's mma run.
//
// What bounds it on an H100: the products are 5.31 TFLOP of bf16 operands
// per flagship eval chunk (both fields, 2,097,152 points each), 5.37 ms at
// the 989 TFLOP/s bf16 peak; this kernel took ~32 ms (~157 TFLOP/s; PERF.md
// §6) before its k16 steps were summed by FADD (mma_bf16_step), which
// costs ~18 % (and 20 bytes of spills at width 256). Measured on the card,
// not the limit: the L2 weight stream (1.2 MB per field per 64 points,
// ~39 GB per chunk; a fourth ring slot changed nothing), the input loads at a block's start and the barrier before each
// epilogue (both removed in trials, no change). What is left is the
// mma.sync loop itself: two warps per scheduler (one block of 8 warps per
// SM, by registers and ~180 KB of shared memory) and 24 KB of ldmatrix
// reads per k16 step of the block. wgmma reads its operands from shared
// memory without ldmatrix; a wgmma version of this tile was measured
// slower (PERF.md §6), so the design for it is later work.
//
// In a training step at precision 16 the backward (K7's bf16 mode,
// fused_mlp_tc_bwd.cu) recomputes this forward with the same device code
// (fused_mlp_tc.cuh) on the same bf16 pack, so the gradient is taken at the
// activations the loss saw, bit for bit.
#include "fused_mlp_tc.cuh"

namespace {

__host__ __device__ inline size_t smem_bytes(int W, int Pp, int Fp, int Vp) {
  return sizeof(float) * 4 * kM * kRed + sizeof(bf16) * kM * (W + 8) +
         sizeof(bf16) * kStages * W * kSS +
         sizeof(bf16) * kM * (Pp + Fp + Vp + 24);
}

template <int WIDTH>
__global__ void __launch_bounds__(kThreads, 1)
fused_nerf_tc_kernel(const float* __restrict__ pts,
                     const float* __restrict__ feats,
                     const float* __restrict__ views, TcParams prm,
                     float* __restrict__ out, long long n, int P, int F, int V,
                     int depth, int skip, int n_extra) {
  constexpr int W = WIDTH;
  constexpr int HS = W + 8;            // bf16 row stride of h
  const Geo g = make_geo(W, depth, skip, P, F, V);
  const int PS = g.Pp + 8, FS = g.Fp + 8, VS = g.Vp + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(red + 4 * kM * kRed);
  bf16* xs = hs + kM * HS + kStages * W * kSS;
  bf16* fs = xs + kM * PS;
  bf16* vs = fs + kM * FS;
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kM;

  Ring rg{hs + kM * HS, 0, 0, 0, 0};
  for (int s = 0; s < kStages - 1; ++s) fetch<W>(rg, prm.st, tid);
  load_tile(xs, PS, g.Pp, pts, P, row0, n, tid);
  load_tile(fs, FS, g.Fp, feats, F, row0, n, tid);
  load_tile(vs, VS, g.Vp, views, V, row0, n, tid);

  float cond[2][W / 32][4], accv[2][W / 64][4];
  forward_tile<W, W>(prm, g, rg, hs, xs, PS, fs, FS, vs, VS, red, cond, accv,
                     n_extra, tid, NoSave{});
  __syncthreads();                     // every partial is in red

  // the block's output rows are contiguous in out: coalesced stores
  const int out_ch = out_channels(n_extra);
  const long long rows = n - row0 < kM ? n - row0 : kM;
  for (int e = tid; e < rows * out_ch; e += kThreads) {
    const int r = e / out_ch, c = e - r * out_ch;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) v += red[(q * kM + r) * kRed + c];
    out[row0 * out_ch + e] = head_out(prm, n_extra, c, v);
  }
}

// The bf16 pack from the float32 one: matrix blockIdx.y of the stream, its
// weight [K1 + K2][rows] in the float32 pack, transposed to [rows][K] and
// rounded to bf16, each part's padding columns zero.
__global__ void round_pack_tc_kernel(const float* __restrict__ w, TcParams prm,
                                     Geo g, Moff moff, bf16* __restrict__ wb) {
  const Mat t = mat_of(g, blockIdx.y);
  const float* src = w + prm.off[t.slot];
  bf16* dst = wb + moff.m[blockIdx.y];
  const int len = t.rows * t.K;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < len;
       e += gridDim.x * blockDim.x)
    dst[e] = __float2bfloat16_rn(packed_weight(src, t, e));
}

template <int WIDTH>
int launch_tc(const float* pts, const float* feats, const float* views,
              const TcParams& prm, float* out, long long n, int P, int F,
              int V, int depth, int skip, int n_extra, cudaStream_t stream) {
  const size_t smem = smem_bytes(WIDTH, pad16(P), pad16(F), pad16(V));
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_nerf_tc_kernel<WIDTH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks = static_cast<unsigned int>((n + kM - 1) / kM);
  fused_nerf_tc_kernel<WIDTH><<<blocks, kThreads, smem, stream>>>(
      pts, feats, views, prm, out, n, P, F, V, depth, skip, n_extra);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 pack of K6's bf16-operand mode, made on the card from the float32
// pack (wpack / offsets: fused_mlp.cuh's slots) into wbf16, which holds
// zt_fused_nerf_pack_tc_len elements: every matrix of the stream as
// nn.Linear stores it, [out][K], K's parts zero padded to multiples of 16,
// back to back (the plain version: kernels/fused_mlp.py:pack_bf16_plain).
ZT_API int zt_fused_nerf_pack_tc(const float* wpack, const int* offsets,
                                 void* wbf16, int P, int F, int V, int width,
                                 int depth, int skip, void* stream) {
  TcParams prm;
  Geo g;
  if (!tc_params(prm, g, wpack, offsets, wbf16, P, F, V, width, depth, skip))
    return cudaErrorInvalidValue;
  Moff moff;
  mat_offsets(g, moff.m);
  round_pack_tc_kernel<<<dim3(32, depth + 3), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      wpack, prm, g, moff, static_cast<bf16*>(wbf16));
  return static_cast<int>(cudaGetLastError());
}

// elements of the bf16 pack at these shapes
ZT_API int zt_fused_nerf_pack_tc_len(int P, int F, int V, int width,
                                     int depth, int skip) {
  if (depth < 1 || depth > kMaxLayers) return -1;
  int moff[kMats + 1];
  const Geo g = make_geo(width, depth, skip, P, F, V);
  mat_offsets(g, moff);
  return moff[depth + 3];
}

// K6 in its bf16-operand mode. wpack / offsets: the float32 pack and its
// slots (the biases and the heads are read from it); wbf16: the bf16 pack
// that zt_fused_nerf_pack_tc made from them.
ZT_API int zt_fused_nerf_forward_tc(const float* pts, const float* feats,
                                    const float* views, const float* wpack,
                                    const int* offsets, const void* wbf16,
                                    float* out, int n, int P, int F, int V,
                                    int width, int depth, int skip,
                                    int n_extra, void* stream) {
  TcParams prm;
  Geo g;
  if (!valid_extra(n_extra) ||
      !tc_params(prm, g, wpack, offsets, wbf16, P, F, V, width, depth, skip))
    return cudaErrorInvalidValue;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 64:
      return launch_tc<64>(pts, feats, views, prm, out, n, P, F, V, depth,
                           skip, n_extra, st);
    case 128:
      return launch_tc<128>(pts, feats, views, prm, out, n, P, F, V, depth,
                            skip, n_extra, st);
    default:
      return launch_tc<256>(pts, feats, views, prm, out, n, P, F, V, depth,
                            skip, n_extra, st);
  }
}

// bytes of dynamic shared memory a block of the kernel takes at these shapes
ZT_API int zt_fused_nerf_forward_tc_smem(int width, int P, int F, int V) {
  return static_cast<int>(smem_bytes(width, pad16(P), pad16(F), pad16(V)));
}
