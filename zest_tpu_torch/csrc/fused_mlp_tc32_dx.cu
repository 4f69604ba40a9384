// Fused NeRF field, backward (K7) in its float32 mode: pass 1's input
// gradients on the tensor cores as 3xTF32 (launch B), and the layout of the
// scratch that pass 1 leaves for pass 2.
//
// Replaces the input-gradient half of the TPU kernel
// zest_tpu/kernels/fused_mlp.py:_bwd_pallas (pallas_call at :398; its
// per-tile math is _bwd_kernel, :233) in its approx=False mode, exact
// float32 (Precision.HIGHEST on the TPU). K7 float32 is three launches per
// chunk of points, each one entry point that the wrapper
// (kernels/fused_mlp.py) calls:
//
//   launch A (recompute_tc32_kernel, zt_fused_nerf_recompute_tc32,
//     fused_mlp_tc32.cu): K6's own float32 tile on K6's operand pack, with a
//     Save that leaves cond, every z_i, the feature layer's output, hv and
//     the heads' pre-activation gradients g' in the scratch. It is K6's
//     forward bit for bit, so the gradient is taken at the activations the
//     loss saw.
//   launch B (input_grads_tc32_kernel, zt_fused_nerf_input_grads_tc32, this
//     file): from those values, the backward in reverse order to d_pts,
//     d_feats and d_views, leaving every layer's output gradient d_z, d_cond,
//     d_feature and d_hv in the scratch.
//   pass 2 (zt_fused_nerf_weight_grads_tc32, fused_mlp_tc32_bwd.cu): the
//     weight and bias gradients from the scratch.
//
// Launch B's tile is K6's (fused_mlp_tc.cuh): a block of 8 warps takes 64
// points, each warp a 32-row band of the block's [64 x N] product in
// registers, the weights one stream of K slices through the 3-slot cp.async
// ring, every product the 3xTF32 mma.sync loop of K6 float32 (`product`:
// each float32 operand split in registers into big + small TF32, three mma
// m16n8k8 per k8 step), except that each k8 step's three products are
// summed from zero and added into the accumulator by FADD
// (mma_3xtf32_step). The mma's own float32 sum drops low bits; chained over
// K = 256 it put each product ~5e-6 from float64, and the reverse pass
// compounds that over nine layers (a flagship pass's d_pts 4.9e-6 and
// pts_linears.0's weight gradient 1.1e-5 norm-wise from float64 at the same
// forward values, 8 to 15 times the float32 twin's distance; with the step
// sums 2.6e-7 and 7.4e-7, under the twin's). The step sums cost ~5 % of the
// launch (2.94 against 2.78 ms per 65,536-point chunk at width 256). The B
// operand of d_x = d_z @ W is [N = in][K =
// out], which is the float32 pack's own [in][out] layout, so the ring
// streams each matrix's rows straight from the float32 pack (bwd_mats, the
// order K7's bf16 pass 1 runs them): no operand pack. The A operand, d_z,
// is [64][W + 4] float32 in shared memory, rewritten once per layer. In
// reverse order:
//
//   d_hv = (g'_rgb @ Wr^T) where hv > 0 (float32 on the CUDA cores, hv read
//     back from the scratch);
//   d_views = d_hv @ Wv[views]^T, d_feature = d_hv @ Wv[feature]^T;
//   d_h = d_feature @ Wf^T + the alpha and extra heads' float32 terms;
//   trunk layer i from the last: d_a = d_h where z_i * cond > 0, d_cond +=
//     d_a * z_i, d_z = d_a * cond, then d_h = d_z @ W_i^T (at the skip
//     layer and layer 0 a narrow product into d_pts as well);
//   d_feats = d_cond @ Wb^T.
//
// d_h and d_cond stay in registers in the forward's thread-to-element map
// (the place K6 keeps cond); z_i and cond come back from the scratch
// (prefetched into L2 a product ahead). The narrow outputs (d_pts, d_feats,
// d_views, at most 96 columns) are products of 3 n8 tiles per warp of which
// only the real columns are written. The bias gradients are pass 2's.
//
// Shared memory per block (input_grads_smem): g' [64][12] (3,072 bytes), d_z
// [64][W + 4] and the ring, 3 slots of max(W, 96) rows of 36 floats:
// 61,952 bytes at width 64, 92,160 at 128, 180,224 at 256, whatever the
// inputs' widths. Registers (ptxas, sm_90a, CUDA 12.8): 223 at width 64 and
// 241 at 128, no spill; 255 at 256 with a 152-byte stack frame (232 bytes
// of spill stores, 216 of loads), one block per SM at every width.
//
// What bounds it on an H100: one pass of 3xTF32 products over every
// conditioning, trunk, feature and views weight per point (~1.2 MFLOP of
// float32 products per point at width 256, three TF32 products each, at the
// 494.7 TFLOP/s dense-TF32 rate), and ~21 KB of scratch per point read and
// written at width 256. It runs at ~74 TFLOP/s of TF32 products, half of
// K6's rate on the same tile (PERF.md §6): between the products every layer
// reads z_i and cond back (64 KB each per block) and writes d_z, and with
// one block per SM nothing else runs on the tensor cores meanwhile.
#include "fused_mlp_tc.cuh"

namespace {

constexpr int kQ = Operand<float>::kK;

// The chunk's scratch buffers that launch B reads (cond, z, hv, g') and
// writes (dz, d_cond, d_feature, d_hv), each [n][cols] float32 row-major
struct DxBufs {
  const float *cond, *z, *hv, *gh;
  float *dz, *dcond, *dfeat, *dhv;
};

__host__ __device__ inline int input_grads_smem(int W) {
  const int sr = W < kNarrow ? kNarrow : W;
  return 4 * (kM * kGS + kM * (W + kPad<float>) +
              kStages * sr * kStride<float>);
}

// x, an accumulator-shaped tile of columns n0 .., into hs [kM][HS] (the
// next product's A) and into rows < n of the scratch buffer dst [n][ld]
template <int NT>
__device__ __forceinline__ void store_tile(const float (&x)[2][NT][4],
                                           float* hs, int HS, float* dst,
                                           int ld, long long row0,
                                           long long n, int m0w, int n0,
                                           int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = m0w + 16 * mt + gq + 8 * hf, col = n0 + 8 * j + 2 * tq;
        const float2 v = make_float2(x[mt][j][2 * hf], x[mt][j][2 * hf + 1]);
        *reinterpret_cast<float2*>(hs + r * HS + col) = v;
        if (row0 + r < n)
          *reinterpret_cast<float2*>(dst + (row0 + r) * ld + col) = v;
      }
}

// columns col, col + 1 of row gr of a [n][ld] scratch buffer; zero past n
__device__ __forceinline__ float2 load_pair(const float* buf, int ld,
                                            long long gr, long long n,
                                            int col) {
  return gr < n ? *reinterpret_cast<const float2*>(buf + gr * ld + col)
                : make_float2(0.f, 0.f);
}

// acc = d_z @ W for the stream's next matrix (m, then advanced): d_z is
// hs [kM][HS], K columns; 3xTF32 with each k8 step summed apart
// (mma_3xtf32_step), since the reverse pass compounds every product's
// error layer by layer
template <int SR, int NT>
__device__ __forceinline__ void dx_product(float (&acc)[2][NT][4],
                                           RingOf<float>& rg,
                                           const StreamOf<float>& st, int& m,
                                           const float* hs, int HS, int K,
                                           int m0w, int n0, int tid) {
  product<SR, NT, float, true>(acc, rg, st, m++, hs, HS, K, nullptr, 0, m0w,
                               n0, tid);
}

// launch B on one chunk of n points (pointers already offset to the chunk)
template <int WIDTH>
__global__ void __launch_bounds__(kThreads, 1)
input_grads_tc32_kernel(TcParamsOf<float> prm, DxBufs b,
                        float* __restrict__ d_pts,
                        float* __restrict__ d_feats,
                        float* __restrict__ d_views, long long n, int P, int F,
                        int V, int depth, int skip, int n_extra) {
  constexpr int W = WIDTH;
  constexpr int HS = W + kPad<float>;  // row stride of d_z in shared memory
  constexpr int NT = W / 32;           // n8 tiles per warp, width-W products
  constexpr int NTV = NT / 2;          // the views layer's (width W / 2)
  constexpr int NN = kNarrowNT;
  constexpr int SR = W < kNarrow ? kNarrow : W;  // ring slot rows
  extern __shared__ __align__(16) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);
  float* hs = gs + kM * kGS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wn = warp >> 1, m0w = (warp & 1) * 32, gq = lane >> 2,
            tq = lane & 3;
  const int n0w = wn * (W / 4), n0v = wn * (W / 8), n0n = wn * (8 * NN);
  const long long row0 = static_cast<long long>(blockIdx.x) * kM;
  const long long rw = n * W;
  const StreamOf<float>& st = prm.st;
  const int out_ch = out_channels(n_extra);

  RingOf<float> rg{hs + kM * HS, 0, 0, 0, 0};
  for (int q = 0; q < kStages - 1; ++q) fetch<SR>(rg, st, tid);
  prefetch_rows<W>(b.cond, row0, tid);
  for (int e = tid; e < kM * out_ch; e += kThreads) {
    const int r = e / out_ch, c = e - r * out_ch;
    gs[r * kGS + c] = row0 + r < n ? b.gh[(row0 + r) * out_ch + c] : 0.f;
  }
  __syncthreads();                     // g' is in gs

  // d_hv = (g'_rgb @ Wr^T) where hv > 0, float32, in the views layer's
  // accumulator layout
  float accv[2][NTV][4];
  {
    const float* wr = prm.w + prm.off[kWr];
#pragma unroll
    for (int j = 0; j < NTV; ++j) {
      const int col = n0v + 8 * j + 2 * tq;
      float wv[2][3];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int o = 0; o < 3; ++o) wv[c][o] = __ldg(wr + 3 * (col + c) + o);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = m0w + 16 * mt + gq + 8 * hf;
          const float* gr = gs + r * kGS;
          const float2 h = load_pair(b.hv, W / 2, row0 + r, n, col);
          float* a = accv[mt][j] + 2 * hf;
          a[0] = h.x > 0.f ? gr[0] * wv[0][0] + gr[1] * wv[0][1] +
                                 gr[2] * wv[0][2]
                           : 0.f;
          a[1] = h.y > 0.f ? gr[0] * wv[1][0] + gr[1] * wv[1][1] +
                                 gr[2] * wv[1][2]
                           : 0.f;
        }
    }
  }
  store_tile(accv, hs, HS, b.dhv, W / 2, row0, n, m0w, n0v, lane);

  int m = 0;                           // the stream's next matrix
  {                                    // d_views = d_hv @ Wv[views]^T
    float accn[2][NN][4];
    dx_product<SR>(accn, rg, st, m, hs, HS, W / 2, m0w, n0n, tid);
    store_narrow(accn, d_views, V, row0, n, m0w, n0n, lane, false);
  }
  // d_feature = d_hv @ Wv[feature]^T
  float acc[2][NT][4];
  dx_product<SR>(acc, rg, st, m, hs, HS, W / 2, m0w, n0w, tid);
  __syncthreads();                     // every warp has read d_hv
  store_tile(acc, hs, HS, b.dfeat, W, row0, n, m0w, n0w, lane);

  // d_h of the trunk output: d_feature @ Wf^T, then the heads' float32 part
  prefetch_rows<W>(b.z + (depth - 1) * rw, row0, tid);
  dx_product<SR>(acc, rg, st, m, hs, HS, W, m0w, n0w, tid);
  if (n_extra == 0)
    add_head_grads<NT, 1>(acc, prm, 0, gs, m0w, n0w, lane);
  else if (n_extra == 1)
    add_head_grads<NT, 2>(acc, prm, 1, gs, m0w, n0w, lane);
  else
    add_head_grads<NT, 9>(acc, prm, 2, gs, m0w, n0w, lane);

  // the trunk, last layer first: d_a = d_h where z * cond > 0; d_cond +=
  // d_a * z; d_z = d_a * cond; then d_h (or d_pts) = d_z @ W_i^T
  float dc[2][NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dc[mt][j][e] = 0.f;
  const bool skip_pts = skip + 1 > 0 && skip + 1 < depth;
  for (int i = depth - 1; i >= 0; --i) {
    const float* zi = b.z + i * rw;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0w + 8 * j + 2 * tq;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const long long gr = row0 + m0w + 16 * mt + gq + 8 * hf;
          const float2 z = load_pair(zi, W, gr, n, col);
          const float2 c = load_pair(b.cond, W, gr, n, col);
          float* a = acc[mt][j] + 2 * hf;
          float* d = dc[mt][j] + 2 * hf;
          const float da0 = z.x * c.x > 0.f ? a[0] : 0.f;
          const float da1 = z.y * c.y > 0.f ? a[1] : 0.f;
          d[0] = fmaf(da0, z.x, d[0]);
          d[1] = fmaf(da1, z.y, d[1]);
          a[0] = da0 * c.x;
          a[1] = da1 * c.y;
        }
    }
    __syncthreads();                   // every warp has read hs
    store_tile(acc, hs, HS, b.dz + i * rw, W, row0, n, m0w, n0w, lane);
    if (i > 0) prefetch_rows<W>(b.z + (i - 1) * rw, row0, tid);
    if (i == 0 || i == skip + 1) {     // the pts part: d_pts
      float accn[2][NN][4];
      dx_product<SR>(accn, rg, st, m, hs, HS, W, m0w, n0n, tid);
      store_narrow(accn, d_pts, P, row0, n, m0w, n0n, lane,
                   i == 0 && skip_pts);
    }
    if (i > 0)
      dx_product<SR>(acc, rg, st, m, hs, HS, W, m0w, n0w, tid);
  }

  // d_cond to the scratch, then d_feats = d_cond @ Wb^T
  __syncthreads();                     // every warp has read d_z
  store_tile(dc, hs, HS, b.dcond, W, row0, n, m0w, n0w, lane);
  {
    float accn[2][NN][4];
    dx_product<SR>(accn, rg, st, m, hs, HS, W, m0w, n0n, tid);
    store_narrow(accn, d_feats, F, row0, n, m0w, n0n, lane, false);
  }
  cp_async_wait<0>();
}

// launch B's weight stream: bwd_mats' matrices, each a run of rows of the
// float32 pack wpack ([in][out], K = out); false if the shapes are not the
// kernel's or the pack is not 16-byte aligned (the ring copies 16 bytes)
bool dx_params(TcParamsOf<float>& prm, const float* wpack, const int* offsets,
               int P, int F, int V, int width, int depth, int skip) {
  if (P > kNarrow || F > kNarrow || V > kNarrow || depth < 1 ||
      depth > kMaxLayers || (width != 64 && width != 128 && width != 256) ||
      reinterpret_cast<uintptr_t>(wpack) % 16 != 0)
    return false;
  fill_params(prm, wpack, offsets);
  BMat mats[kStreamMax];
  const int count = bwd_mats(make_geo(width, depth, skip, P, F, V, kQ), mats);
  for (int i = 0; i < count; ++i) {
    const BMat& t = mats[i];
    if (offsets[t.slot] % 4 != 0) return false;
    prm.st.src[i] = wpack + offsets[t.slot] + t.r0 * t.K;
    prm.st.rows[i] = t.rows;
    prm.st.K[i] = t.K;
  }
  prm.st.n = count;
  return true;
}

template <int WIDTH>
int launch_dx(const TcParamsOf<float>& prm, const DxBufs& b, float* d_pts,
              float* d_feats, float* d_views, long long n, int P, int F,
              int V, int depth, int skip, int n_extra, cudaStream_t stream) {
  const int smem = input_grads_smem(WIDTH);
  cudaError_t e = cudaFuncSetAttribute(
      input_grads_tc32_kernel<WIDTH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned int blocks = static_cast<unsigned int>((n + kM - 1) / kM);
  input_grads_tc32_kernel<WIDTH><<<blocks, kThreads, smem, stream>>>(
      prm, b, d_pts, d_feats, d_views, n, P, F, V, depth, skip, n_extra);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The scratch of one chunk: every buffer [rows][cols] float32 row-major,
// back to back: cond [rows][W], z [depth][rows][W], feat [rows][W], hv
// [rows][W / 2], dz [depth][rows][W], d_cond [rows][W], d_feature [rows][W],
// d_hv [rows][W / 2], g' [rows][out_ch]. Launch A writes the first four and
// g', launch B reads cond, z, hv and g' and writes the rest, pass 2 reads
// them all.

constexpr int kNumBufs = 9;

bool valid(int width, int depth, int n_extra) {
  return depth >= 1 && depth <= kMaxLayers && valid_extra(n_extra) &&
         (width == 64 || width == 128 || width == 256);
}

long long scratch_floats(long long rows, int W, int depth, int out_ch) {
  return rows * (static_cast<long long>(W) * (2 * depth + 5) + out_ch);
}

void buffer_offsets(long long* at, long long rows, int W,
                    int depth) {
  const long long rw = rows * W;
  const long long len[kNumBufs - 1] = {rw, depth * rw, rw, rw / 2, depth * rw,
                                       rw, rw, rw / 2};
  at[0] = 0;
  for (int b = 1; b < kNumBufs; ++b) at[b] = at[b - 1] + len[b - 1];
}

}  // namespace

// The floats of scratch that K7's float32 mode needs for n points in chunks
// of `chunk`: one chunk's buffers.
ZT_API int zt_fused_nerf_backward_scratch(int n, int chunk, int P, int F,
                                          int V, int width, int depth,
                                          int skip, int n_extra,
                                          long long* floats) {
  if (!valid(width, depth, n_extra) || chunk < 1)
    return cudaErrorInvalidValue;
  const long long rows = n < chunk ? (n > 1 ? n : 1) : chunk;
  *floats = scratch_floats(rows, width, depth, out_channels(n_extra));
  return 0;
}

// Where a chunk of `rows` points lies in the scratch: at[b] is the first
// float of buffer b (cond, z, feat, hv, dz, d_cond, d_feature, d_hv, g';
// their shapes as above).
ZT_API int zt_fused_nerf_backward_layout(int rows, int P, int F, int V,
                                         int width, int depth, int skip,
                                         int n_extra, long long* at) {
  if (!valid(width, depth, n_extra) || rows < 0) return cudaErrorInvalidValue;
  buffer_offsets(at, rows, width, depth);
  return 0;
}

// K7 float32's input gradients (pass 1, launch B) on one chunk of n points,
// after launch A (zt_fused_nerf_recompute_tc32) has left cond, z, hv and g'
// in the chunk's scratch buffers (zt_fused_nerf_backward_layout): d_pts
// [n][P], d_feats [n][F], d_views [n][V] are written, and dz [depth][n][W],
// d_cond, d_feature [n][W] and d_hv [n][W / 2] to the scratch for pass 2.
// wpack / offsets: the float32 pack, whose [in][out] weights are the
// products' B operands, and its slots.
ZT_API int zt_fused_nerf_input_grads_tc32(
    const float* wpack, const int* offsets, const float* cond, const float* z,
    const float* hv, const float* gh, float* dz, float* dcond, float* dfeat,
    float* dhv, float* d_pts, float* d_feats, float* d_views, int n, int P,
    int F, int V, int width, int depth, int skip, int n_extra, void* stream) {
  TcParamsOf<float> prm;
  if (!valid(width, depth, n_extra) ||
      !dx_params(prm, wpack, offsets, P, F, V, width, depth, skip))
    return cudaErrorInvalidValue;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const DxBufs b{cond, z, hv, gh, dz, dcond, dfeat, dhv};
  auto st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 64:
      return launch_dx<64>(prm, b, d_pts, d_feats, d_views, n, P, F, V, depth,
                           skip, n_extra, st);
    case 128:
      return launch_dx<128>(prm, b, d_pts, d_feats, d_views, n, P, F, V,
                            depth, skip, n_extra, st);
    default:
      return launch_dx<256>(prm, b, d_pts, d_feats, d_views, n, P, F, V,
                            depth, skip, n_extra, st);
  }
}

// bytes of dynamic shared memory a block of launch B takes at this width
ZT_API int zt_fused_nerf_input_grads_tc32_smem(int width) {
  return input_grads_smem(width);
}
