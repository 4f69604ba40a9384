// Fused NeRF field, backward (K7), bf16-operand mode on the tensor cores.
//
// Replaces the TPU kernel zest_tpu/kernels/fused_mlp.py:_bwd_pallas
// (pallas_call at :398; its per-tile math is _bwd_kernel, :233-355) in its
// approx=True mode, the port's precision 16. The float32 mode is
// fused_mlp_tc32.cu and fused_mlp_tc32_dx.cu (pass 1) and
// fused_mlp_tc32_bwd.cu (pass 2), all 3xTF32.
//
// What it computes is the gradient of the bf16 twin's field (models/nerf.py,
// _BF16Linear): every product of the conditioning, the trunk, the feature
// and the views layers takes bf16-rounded operands with float32 sums, in the
// forward, in the input gradients d_x = d_z @ W (d_z rounded) and in the
// weight gradients dW = X^T d_z (both rounded). cond, the biases, z_i, a_i =
// z_i * cond and its ReLU mask, h_last as the heads read it, hv, the running
// d_h and d_cond, and every bias gradient (the sum of the float32 d_z over
// the points) stay float32; the heads (alpha, blend / flow / probability,
// rgb) keep float32 operands on the CUDA cores.
//
// Two passes per chunk of points, as the Hopper blocks run in parallel where
// the TPU's grid carried the weight gradients from step to step:
//
//   pass 1 (fused_nerf_bwd_tc_kernel), per block of 64 points: the forward
//     again with K6's device code (fused_mlp_tc.cuh) on K6's bf16 pack, so
//     every activation equals K6's bit for bit (an optional output pointer
//     receives the recomputed rows, for the tests); then the backward on the
//     same tile and thread-to-element map. The input-gradient products are
//     the same mma.sync loop: B is W read [in][out], the float32 pack's own
//     layout, from a second bf16 pack (the backward pack, round_pack_bwd_tc_
//     kernel, one launch; its plain version is kernels/fused_mlp.py:
//     pack_bf16_bwd_plain), streamed through the same ring after the
//     forward's matrices. The narrow outputs (d_pts, d_feats, d_views; at
//     most 96 columns) are products of 3 n8 tiles per warp, of which only the
//     real columns are written. cond and the accumulators (d_h) stay in
//     registers; d_cond, float32 [64][width], takes the shared memory that
//     the forward's inputs and head partials held; z_i (float32) goes to the
//     scratch in the forward and comes back in the reverse loop. Each layer's
//     bias gradient is the block's column sum of its float32 d_z (shuffles,
//     then one float2 atomic per column pair and row band into d_pack).
//     Pass 1 writes pass 2's operands as bf16: the inputs, every trunk
//     layer's output h_i, the feature layer's output and every d_z.
//   pass 2 (wgrad_tc_kernel): dW = X^T d_z of every bf16-operand matrix in
//     ONE launch per chunk: a block takes a 128 x 128 tile of one matrix's
//     weight gradient over a split of the chunk's points, with both operands
//     read [points][features] by ldmatrix.trans from a cp.async ring, and
//     adds its float32 tile into d_pack with float2 atomics. The heads' weight
//     gradients keep float32 operands (head_grads_kernel, fused_mlp_tc.cuh:
//     h_last and hv read once per chunk, one thread per input column).
//
// What bounds it on an H100: the bf16 products, 3 passes over every weight
// per point (~1.2 MFLOP per point at width 256): 2.2 ms at the 989 TFLOP/s
// bf16 peak for a flagship 16-bit training step's 569,344 points. The scratch
// is ~20 KB per point written once and read once (~3.4 ms at 3.35 TB/s if
// none of it were hidden). Pass 1 runs K6's forward tile, whose mma.sync loop
// reaches ~157 TFLOP/s (fused_mlp_tc.cu), twice over: once for the forward
// and once for the input gradients, with an epilogue per layer that reads z_i
// back and adds the column sums. PERF.md §6 gives the measured times.
#include "fused_mlp_tc.cuh"

namespace {

// A chunk's scratch, R rows (its points rounded up to the 64-point tile),
// each buffer [R][cols] row-major; z, h and dz hold depth of them.
struct BwdScratch {
  float* z;                            // [depth][R][W] trunk z_i, pass 1 only
  float* cond;                         // [R][W], written only when asked
  float* hlast;                        // [R][W] h_last as the heads read it
  float* hv;                           // [R][W / 2]
  float* gh;                           // [R][out_ch] heads' output gradients
  bf16* xin;                           // [R][Pp] pts, rounded
  bf16* fin;                           // [R][Fp]
  bf16* vin;                           // [R][Vp]
  bf16* h;                             // [depth][R][W] layer i's output
  bf16* feat;                          // [R][W] the feature layer's output
  bf16* dz;                            // [depth][R][W]
  bf16* dbias;                         // [R][W] d_cond
  bf16* dfeat;                         // [R][W]
  bf16* dhv;                           // [R][W / 2]
  long long R;
};

// the buffers at base (none if base is null); returns the bytes they take
long long carve(BwdScratch& s, void* base, long long R, const Geo& g,
                int out_ch) {
  const long long W = g.W, rw = R * W;
  char* p = static_cast<char*>(base);
  long long at = 0;
  auto take = [&](long long bytes) {
    void* q = p == nullptr ? nullptr : p + at;
    at += (bytes + 255) / 256 * 256;
    return q;
  };
  s.R = R;
  s.z = static_cast<float*>(take(4 * g.depth * rw));
  s.cond = static_cast<float*>(take(4 * rw));
  s.hlast = static_cast<float*>(take(4 * rw));
  s.hv = static_cast<float*>(take(4 * rw / 2));
  s.gh = static_cast<float*>(take(4 * R * out_ch));
  s.xin = static_cast<bf16*>(take(2 * R * g.Pp));
  s.fin = static_cast<bf16*>(take(2 * R * g.Fp));
  s.vin = static_cast<bf16*>(take(2 * R * g.Vp));
  s.h = static_cast<bf16*>(take(2 * g.depth * rw));
  s.feat = static_cast<bf16*>(take(2 * rw));
  s.dz = static_cast<bf16*>(take(2 * g.depth * rw));
  s.dbias = static_cast<bf16*>(take(2 * rw));
  s.dfeat = static_cast<bf16*>(take(2 * rw));
  s.dhv = static_cast<bf16*>(take(2 * rw / 2));
  return at;
}

// each backward matrix's first element in the backward pack; returns the
// pack's length (every matrix is rows * K with K a multiple of 32, so each
// starts on a 64-byte boundary)
int bwd_offsets(const Geo& g, BMat (&m)[kStreamMax], int (&boff)[kStreamMax],
                int& count) {
  count = bwd_mats(g, m);
  int cur = 0;
  for (int i = 0; i < count; ++i) {
    boff[i] = cur;
    cur += m[i].rows * m[i].K;
  }
  return cur;
}

struct BwdPack {
  int src[kStreamMax];                 // first float of the run in the pack
  int dst[kStreamMax];
  int len[kStreamMax];
};

// the backward pack from the float32 one: matrix blockIdx.y, a contiguous
// run of the float32 pack rounded to bf16
__global__ void round_pack_bwd_tc_kernel(const float* __restrict__ w,
                                         BwdPack bp, bf16* __restrict__ wbt) {
  const float* src = w + bp.src[blockIdx.y];
  bf16* dst = wbt + bp.dst[blockIdx.y];
  const int len = bp.len[blockIdx.y];
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < len;
       e += gridDim.x * blockDim.x)
    dst[e] = __float2bfloat16_rn(__ldg(src + e));
}

// what pass 1's forward keeps for the backward and for pass 2, at row r of
// the block (row0 + r of the chunk)
struct SaveScratch {
  const BwdScratch& s;
  long long row0;
  int W, depth;
  __device__ void cond(int, int, float, float) const {}  // kept in registers
  __device__ void trunk(int i, int r, int col, float z0, float z1, float a0,
                        float a1, __nv_bfloat162 hb) const {
    const long long e = (row0 + r) * W + col, layer = i * s.R * W;
    *reinterpret_cast<float2*>(s.z + layer + e) = make_float2(z0, z1);
    *reinterpret_cast<__nv_bfloat162*>(s.h + layer + e) = hb;
    if (i == depth - 1)
      *reinterpret_cast<float2*>(s.hlast + e) = make_float2(a0, a1);
  }
  __device__ void feature(int r, int col, __nv_bfloat162 fb) const {
    *reinterpret_cast<__nv_bfloat162*>(s.feat + (row0 + r) * W + col) = fb;
  }
  __device__ void hv(int r, int col, float v0, float v1) const {
    *reinterpret_cast<float2*>(s.hv + (row0 + r) * (W / 2) + col) =
        make_float2(v0, v1);
  }
};

// load_tile (bf16), and the same rounded, padded rows to save [R][Kp] at
// row0
__device__ __forceinline__ void load_bf16_save(bf16* dst, int ld, int Kp,
                                               const float* __restrict__ src,
                                               int K, long long row0,
                                               long long n, bf16* save,
                                               int tid) {
#pragma unroll 4
  for (int e = tid; e < kM * Kp; e += kThreads) {
    const int r = e / Kp, k = e - r * Kp;
    const long long gr = row0 + r;
    const float v = k < K && gr < n ? __ldg(src + gr * K + k) : 0.f;
    const bf16 b = __float2bfloat16_rn(v);
    dst[r * ld + k] = b;
    save[row0 * Kp + e] = b;
  }
}

// The column sums of an accumulator-shaped tile x (the thread's 4 rows, then
// the 8 lanes of a column pair by shuffles) added into dst[n0 + col]: one
// float2 atomic per column pair and row band.
template <int NT>
__device__ __forceinline__ void add_col_sums(const float (&x)[2][NT][4],
                                             float* dst, int n0, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float v[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      v[c] = (x[0][j][c] + x[0][j][2 + c]) + (x[1][j][c] + x[1][j][2 + c]);
      v[c] += __shfl_xor_sync(0xffffffffu, v[c], 4);
      v[c] += __shfl_xor_sync(0xffffffffu, v[c], 8);
      v[c] += __shfl_xor_sync(0xffffffffu, v[c], 16);
    }
    if (gq == 0)
      atomicAdd(reinterpret_cast<float2*>(dst + n0 + 8 * j + 2 * tq),
                make_float2(v[0], v[1]));
  }
}

// x rounded to bf16 into hs [kM][HS] (the next product's A) and into the
// scratch buffer save [R][ld] at row0
template <int NT>
__device__ __forceinline__ void store_bf16(const float (&x)[2][NT][4],
                                           bf16* hs, int HS, bf16* save,
                                           int ld, long long row0, int m0w,
                                           int n0, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = m0w + 16 * mt + gq + 8 * hf, col = n0 + 8 * j + 2 * tq;
        const __nv_bfloat162 b =
            __floats2bfloat162_rn(x[mt][j][2 * hf], x[mt][j][2 * hf + 1]);
        *reinterpret_cast<__nv_bfloat162*>(hs + r * HS + col) = b;
        *reinterpret_cast<__nv_bfloat162*>(save + (row0 + r) * ld + col) = b;
      }
}

// pass 1's shared memory: the forward's head partials and inputs, then the
// backward's d_cond [kM][W + 8] float32, share the first region; then the
// heads' g', h (the A operand of every product) and the weight ring
__host__ __device__ inline int union_bytes(int W, int Pp, int Fp, int Vp) {
  const int fwd = 4 * 4 * kM * kRed + 2 * kM * (Pp + Fp + Vp + 24);
  const int bwd = 4 * kM * (W + 8);
  return fwd > bwd ? fwd : bwd;
}

__host__ __device__ inline int bwd_smem_bytes(int W, int Pp, int Fp, int Vp) {
  const int sr = W < kNarrow ? kNarrow : W;
  return union_bytes(W, Pp, Fp, Vp) + 4 * kM * kGS + 2 * kM * (W + 8) +
         2 * kStages * sr * kSS;
}

// pass 1 on one chunk of n points (pointers already offset to the chunk);
// out, if not null, receives the recomputed output rows, and keep_cond
// writes cond to the scratch (with z_i, the feature layer's output and hv
// there, the forward values a plain backward can be evaluated at)
template <int WIDTH>
__global__ void __launch_bounds__(kThreads, 1)
fused_nerf_bwd_tc_kernel(const float* __restrict__ pts,
                         const float* __restrict__ feats,
                         const float* __restrict__ views,
                         const float* __restrict__ g, TcParams prm,
                         BwdScratch s, float* __restrict__ d_pts,
                         float* __restrict__ d_feats,
                         float* __restrict__ d_views, float* d_pack,
                         float* __restrict__ out, long long n, int P, int F,
                         int V, int depth, int skip, int n_extra,
                         bool keep_cond) {
  constexpr int W = WIDTH;
  constexpr int HS = W + 8;            // bf16 row stride of hs
  constexpr int DS = W + 8;            // float row stride of d_cond
  constexpr int NT = W / 32;
  constexpr int NTV = NT / 2;
  constexpr int NN = kNarrowNT;
  constexpr int SR = W < kNarrow ? kNarrow : W;  // ring slot rows
  const Geo geo = make_geo(W, depth, skip, P, F, V);
  const int PS = geo.Pp + 8, FS = geo.Fp + 8, VS = geo.Vp + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  bf16* xs = reinterpret_cast<bf16*>(red + 4 * kM * kRed);
  bf16* fs = xs + kM * PS;
  bf16* vs = fs + kM * FS;
  float* dcond = reinterpret_cast<float*>(smem);
  float* gs = reinterpret_cast<float*>(
      smem + union_bytes(W, geo.Pp, geo.Fp, geo.Vp));
  bf16* hs = reinterpret_cast<bf16*>(gs + kM * kGS);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wn = warp >> 1, m0w = (warp & 1) * 32, gq = lane >> 2,
            tq = lane & 3;
  const int n0w = wn * (W / 4), n0v = wn * (W / 8), n0n = wn * (8 * NN);
  const long long row0 = static_cast<long long>(blockIdx.x) * kM;
  const float* w = prm.w;
  const Stream& st = prm.st;
  const int out_ch = out_channels(n_extra);

  // ---- the forward, as K6 runs it, keeping what the backward reads ----
  Ring rg{hs + kM * HS, 0, 0, 0, 0};
  for (int q = 0; q < kStages - 1; ++q) fetch<SR>(rg, st, tid);
  load_bf16_save(xs, PS, geo.Pp, pts, P, row0, n, s.xin, tid);
  load_bf16_save(fs, FS, geo.Fp, feats, F, row0, n, s.fin, tid);
  load_bf16_save(vs, VS, geo.Vp, views, V, row0, n, s.vin, tid);
  float cond[2][NT][4], accv[2][NTV][4];
  forward_tile<W, SR>(prm, geo, rg, hs, xs, PS, fs, FS, vs, VS, red, cond,
                      accv, n_extra, tid, SaveScratch{s, row0, W, depth});
  __syncthreads();                     // every partial is in red
  if (keep_cond) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(
              s.cond + (row0 + m0w + 16 * mt + gq + 8 * hf) * W + n0w +
              8 * j + 2 * tq) =
              make_float2(cond[mt][j][2 * hf], cond[mt][j][2 * hf + 1]);
  }

  // the output rows (K6's), and the heads' pre-activation gradients g': rgb
  // and alpha as given, the blend and probability through their sigmoid,
  // the flow through its tanh; zero on the rows past n
  for (int e = tid; e < kM * out_ch; e += kThreads) {
    const int r = e / out_ch, c = e - r * out_ch;
    const long long gr = row0 + r;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) v += red[(q * kM + r) * kRed + c];
    const float o = head_out(prm, n_extra, c, v);
    if (out != nullptr && gr < n) out[gr * out_ch + c] = o;
    float gv = gr < n ? __ldg(g + gr * out_ch + c) : 0.f;
    if (c >= 4) gv *= (n_extra == 1 || c >= 10) ? o * (1.f - o) : 1.f - o * o;
    gs[r * kGS + c] = gv;
    s.gh[gr * out_ch + c] = gv;
  }
  __syncthreads();                     // g' is in gs; h is free

  // ---- backward ----
  // d_hv = (g'_rgb @ Wr^T) where hv > 0, float32, in accv's layout
  {
    const float* wr = w + prm.off[kWr];
#pragma unroll
    for (int j = 0; j < NTV; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = n0v + 8 * j + 2 * tq + c;
        const float w0 = __ldg(wr + 3 * k), w1 = __ldg(wr + 3 * k + 1),
                    w2 = __ldg(wr + 3 * k + 2);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float* gr = gs + (m0w + 16 * mt + gq + 8 * hf) * kGS;
            float& a = accv[mt][j][2 * hf + c];
            a = a > 0.f ? gr[0] * w0 + gr[1] * w1 + gr[2] * w2 : 0.f;
          }
      }
  }
  add_col_sums(accv, d_pack + prm.off[kBv], n0v, lane);
  store_bf16(accv, hs, HS, s.dhv, W / 2, row0, m0w, n0v, lane);

  int m = depth + 3;                   // the backward's first stream matrix
  {                                    // d_views = d_hv @ Wv[views]^T
    float accn[2][NN][4];
    product<SR, NN>(accn, rg, st, m++, hs, HS, W / 2, nullptr, 0, m0w, n0n,
                    tid);
    store_narrow(accn, d_views, V, row0, n, m0w, n0n, lane, false);
  }
  // d_feature = d_hv @ Wv[feature]^T
  float acc[2][NT][4];
  product<SR, NT>(acc, rg, st, m++, hs, HS, W / 2, nullptr, 0, m0w, n0w, tid);
  add_col_sums(acc, d_pack + prm.off[kBf], n0w, lane);
  __syncthreads();                     // every warp has read h (d_hv)
  store_bf16(acc, hs, HS, s.dfeat, W, row0, m0w, n0w, lane);

  // d_h of the trunk output: d_feature @ Wf^T, then the heads' float32 part
  prefetch_rows<W>(s.z + (depth - 1) * s.R * W, row0, tid);
  product<SR, NT>(acc, rg, st, m++, hs, HS, W, nullptr, 0, m0w, n0w, tid);
  if (n_extra == 0)
    add_head_grads<NT, 1>(acc, prm, 0, gs, m0w, n0w, lane);
  else if (n_extra == 1)
    add_head_grads<NT, 2>(acc, prm, 1, gs, m0w, n0w, lane);
  else
    add_head_grads<NT, 9>(acc, prm, 2, gs, m0w, n0w, lane);

  // the trunk, last layer first: d_a = d_h where z * cond > 0; d_cond +=
  // d_a * z; d_z = d_a * cond; then d_h (or d_pts) = d_z @ W_i^T
  const bool skip_pts = skip + 1 > 0 && skip + 1 < depth;
  for (int i = depth - 1; i >= 0; --i) {
    const float* zi = s.z + i * s.R * W;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0w + 8 * j + 2 * tq;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = m0w + 16 * mt + gq + 8 * hf;
          const float2 z =
              *reinterpret_cast<const float2*>(zi + (row0 + r) * W + col);
          float2* dc = reinterpret_cast<float2*>(dcond + r * DS + col);
          const float c0 = cond[mt][j][2 * hf], c1 = cond[mt][j][2 * hf + 1];
          float* a = acc[mt][j] + 2 * hf;
          const float da0 = z.x * c0 > 0.f ? a[0] : 0.f;
          const float da1 = z.y * c1 > 0.f ? a[1] : 0.f;
          if (i == depth - 1) {
            *dc = make_float2(da0 * z.x, da1 * z.y);
          } else {
            const float2 d = *dc;
            *dc = make_float2(fmaf(da0, z.x, d.x), fmaf(da1, z.y, d.y));
          }
          a[0] = da0 * c0;
          a[1] = da1 * c1;
        }
    }
    add_col_sums(acc, d_pack + prm.off[kLayer0 + 2 * i + 1], n0w, lane);
    __syncthreads();                   // every warp has read h
    store_bf16(acc, hs, HS, s.dz + i * s.R * W, W, row0, m0w, n0w, lane);
    if (i > 0) prefetch_rows<W>(s.z + (i - 1) * s.R * W, row0, tid);
    if (i == 0 || i == skip + 1) {     // the pts part: d_pts
      float accn[2][NN][4];
      product<SR, NN>(accn, rg, st, m++, hs, HS, W, nullptr, 0, m0w, n0n,
                      tid);
      store_narrow(accn, d_pts, P, row0, n, m0w, n0n, lane,
                   i == 0 && skip_pts);
    }
    if (i > 0)
      product<SR, NT>(acc, rg, st, m++, hs, HS, W, nullptr, 0, m0w, n0w, tid);
  }

  // d_cond: its column sums (the conditioning's bias gradient), then d_feats
  // = d_cond @ Wb^T
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = m0w + 16 * mt + gq + 8 * hf;
        const float2 d = *reinterpret_cast<const float2*>(
            dcond + r * DS + n0w + 8 * j + 2 * tq);
        acc[mt][j][2 * hf] = d.x;
        acc[mt][j][2 * hf + 1] = d.y;
      }
  add_col_sums(acc, d_pack + prm.off[kBb], n0w, lane);
  __syncthreads();                     // every warp has read h
  store_bf16(acc, hs, HS, s.dbias, W, row0, m0w, n0w, lane);
  {
    float accn[2][NN][4];
    product<SR, NN>(accn, rg, st, m++, hs, HS, W, nullptr, 0, m0w, n0n, tid);
    store_narrow(accn, d_feats, F, row0, n, m0w, n0n, lane, false);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Pass 2: dW = X^T d_z on the tensor cores.

constexpr int kBM = 128;               // tile rows (the layer's inputs)
constexpr int kBN = 128;               // tile columns (its outputs)
constexpr int kBK = 32;                // points per stage
constexpr int kP2Stages = 3;
constexpr int kTS = kBM + 8;           // bf16 row stride of a stage's tile
constexpr int kMaxJobs = kMaxLayers + 6;
constexpr int kP2Smem = 2 * kP2Stages * kBK * kTS * 2;

// One weight gradient: C [M][N] (at c_off in d_pack, row stride N) += A^T B,
// A [points][lda] and B [points][ldb] bf16 in the scratch (M <= lda, N <=
// ldb, both strides multiples of 8); its tiles are tile0 .. tile0 + tiles_m
// * tiles_n - 1 of the launch.
struct WJob {
  const bf16* a;
  const bf16* b;
  int lda, ldb, M, N, c_off, tiles_n, tile0;
};

struct WJobs {
  WJob j[kMaxJobs];
  int n;
};

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// Block (tile, split): the tile's kBM x kBN outputs over the points k0 ..
// k1 - 1. 8 warps of 64 x 32 outputs (4 m16 x 4 n8 tiles). Both operands
// are [points][features] in memory, so ldmatrix.trans gives A (row-major
// M x K) and B (col-major K x N) fragments; columns past lda / ldb are not
// copied, and only the rows < M and columns < N of the tile are added.
__global__ void __launch_bounds__(256)
wgrad_tc_kernel(WJobs jobs, float* d_pack, long long K, long long split) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + kP2Stages * kBK * kTS;
  int jb = 0;
  while (jb + 1 < jobs.n && static_cast<int>(blockIdx.x) >= jobs.j[jb + 1].tile0)
    ++jb;
  const WJob& jd = jobs.j[jb];
  const int t = blockIdx.x - jd.tile0;
  const int m0 = (t / jd.tiles_n) * kBM, n0 = (t % jd.tiles_n) * kBN;
  const long long k0 = blockIdx.y * split;
  const long long k1 = k0 + split < K ? k0 + split : K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp & 1, wn = warp >> 1, gq = lane >> 2, tq = lane & 3;
  const int lq = lane >> 3, lr = lane & 7;

  auto load = [&](int stage, long long kb) {
    for (int c = tid; c < kBK * (kBM / 8); c += 256) {
      const int row = c / (kBM / 8), ch = c % (kBM / 8);
      const int ma = m0 + 8 * ch, nb = n0 + 8 * ch;
      if (ma < jd.lda)
        cp_async16(as + (stage * kBK + row) * kTS + 8 * ch,
                   jd.a + (kb + row) * jd.lda + ma);
      if (nb < jd.ldb)
        cp_async16(bs + (stage * kBK + row) * kTS + 8 * ch,
                   jd.b + (kb + row) * jd.ldb + nb);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kP2Stages - 1; ++s) {
    if (k0 + s * kBK < k1) load(s, k0 + s * kBK);
    cp_async_commit();
  }
  int it = 0;
  for (long long kb = k0; kb < k1; kb += kBK, ++it) {
    cp_async_wait<kP2Stages - 2>();
    __syncthreads();                   // stage it landed; stage it-1 is free
    const long long kn = kb + (kP2Stages - 1) * kBK;
    if (kn < k1) load((it + kP2Stages - 1) % kP2Stages, kn);
    cp_async_commit();
    const bf16* a_st = as + (it % kP2Stages) * kBK * kTS;
    const bf16* b_st = bs + (it % kP2Stages) * kBK * kTS;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4_t(a[i], a_st + (kk + lr + 8 * (lq >> 1)) * kTS + wm * 64 +
                            16 * i + 8 * (lq & 1));
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldsm_x4_t(b[p], b_st + (kk + lr + 8 * (lq & 1)) * kTS + wn * 32 +
                            16 * p + 8 * (lq >> 1));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma_bf16_step(acc[i][2 * p], a[i], b[p][0], b[p][1]);
          mma_bf16_step(acc[i][2 * p + 1], a[i], b[p][2], b[p][3]);
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int mm = m0 + wm * 64 + 16 * i + gq + 8 * hf;
        const int nn = n0 + wn * 32 + 8 * j + 2 * tq;
        if (mm < jd.M && nn < jd.N)
          atomicAdd(reinterpret_cast<float2*>(
                        d_pack + jd.c_off + static_cast<long long>(mm) * jd.N +
                        nn),
                    make_float2(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]));
      }
}

// pass 2's jobs for a chunk's scratch; returns the tile count
int wgrad_jobs(WJobs& jobs, const BwdScratch& s, const Geo& g,
               const int* off) {
  const int W = g.W;
  const long long rw = s.R * W;
  int tiles = 0;
  jobs.n = 0;
  auto add = [&](const bf16* a, int lda, const bf16* b, int ldb, int M, int N,
                 int c_off) {
    const int tn = (N + kBN - 1) / kBN, tm = (M + kBM - 1) / kBM;
    jobs.j[jobs.n++] = WJob{a, b, lda, ldb, M, N, c_off, tn, tiles};
    tiles += tm * tn;
  };
  add(s.fin, g.Fp, s.dbias, W, g.F, W, off[kWb]);
  for (int i = 0; i < g.depth; ++i) {
    const int wo = off[kLayer0 + 2 * i];
    const bf16* dz = s.dz + i * rw;
    if (i == 0) {
      add(s.xin, g.Pp, dz, W, g.P, W, wo);
    } else if (i == g.skip + 1) {
      add(s.xin, g.Pp, dz, W, g.P, W, wo);
      add(s.h + (i - 1) * rw, W, dz, W, W, W, wo + g.P * W);
    } else {
      add(s.h + (i - 1) * rw, W, dz, W, W, W, wo);
    }
  }
  add(s.h + (g.depth - 1) * rw, W, s.dfeat, W, W, W, off[kWf]);
  add(s.feat, W, s.dhv, W / 2, W, W / 2, off[kWv]);
  add(s.vin, g.Vp, s.dhv, W / 2, g.V, W / 2, off[kWv] + W * (W / 2));
  return tiles;
}

// the forward's and the backward's matrices as one stream; false if the
// shapes are not the kernels'
bool bwd_params(TcParams& prm, Geo& g, const float* wpack, const int* offsets,
                const void* wbf16, const void* wbt, int P, int F, int V,
                int width, int depth, int skip) {
  if (P > kNarrow || F > kNarrow || V > kNarrow) return false;
  g = make_geo(width, depth, skip, P, F, V);
  fill_params(prm, wpack, offsets);
  if (!forward_stream(prm.st, g, static_cast<const bf16*>(wbf16)))
    return false;
  BMat mats[kStreamMax];
  int boff[kStreamMax], count;
  bwd_offsets(g, mats, boff, count);
  for (int i = 0; i < count; ++i) {
    const int m = prm.st.n + i;
    prm.st.src[m] = static_cast<const bf16*>(wbt) + boff[i];
    prm.st.rows[m] = mats[i].rows;
    prm.st.K[m] = mats[i].K;
  }
  prm.st.n += count;
  return true;
}

long long chunk_rows(long long n, long long chunk) {
  const long long rows = n < chunk ? n : chunk;
  return (rows + kM - 1) / kM * kM;
}

template <int WIDTH>
int launch_bwd_tc(const float* pts, const float* feats, const float* views,
                  const float* g, const TcParams& prm, const Geo& geo,
                  void* scratch, long long chunk, float* d_pts,
                  float* d_feats, float* d_views, float* d_pack, float* out,
                  long long n, int n_extra, bool keep, cudaStream_t stream) {
  const int P = geo.P, F = geo.F, V = geo.V, out_ch = out_channels(n_extra);
  const int smem = bwd_smem_bytes(WIDTH, geo.Pp, geo.Fp, geo.Vp);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fused_nerf_bwd_tc_kernel<WIDTH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wgrad_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kP2Smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  BwdScratch s;
  carve(s, scratch, chunk_rows(n, chunk), geo, out_ch);
  for (long long c0 = 0; c0 < n; c0 += chunk) {
    const long long rows = n - c0 < chunk ? n - c0 : chunk;
    const unsigned int blocks = static_cast<unsigned int>((rows + kM - 1) / kM);
    fused_nerf_bwd_tc_kernel<WIDTH><<<blocks, kThreads, smem, stream>>>(
        pts + c0 * P, feats + c0 * F, views + c0 * V, g + c0 * out_ch, prm, s,
        d_pts + c0 * P, d_feats + c0 * F, d_views + c0 * V, d_pack,
        out == nullptr ? nullptr : out + c0 * out_ch, rows, P, F, V,
        geo.depth, geo.skip, n_extra, keep);
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    // pass 2 over the blocks' rows (those past `rows` carry zero d_z): about
    // four blocks per SM, each split a multiple of the 64-point tile
    const long long K = static_cast<long long>(blocks) * kM;
    WJobs jobs;
    const int tiles = wgrad_jobs(jobs, s, geo, prm.off);
    long long splits = (4 * 132 + tiles - 1) / tiles;
    if (splits > blocks) splits = blocks;
    const long long split = ((K + splits - 1) / splits + kM - 1) / kM * kM;
    splits = (K + split - 1) / split;
    wgrad_tc_kernel<<<dim3(tiles, static_cast<unsigned int>(splits)), 256,
                      kP2Smem, stream>>>(jobs, d_pack, K, split);
    err = static_cast<int>(cudaGetLastError());
    if (err == 0)
      err = head_grads(s.hlast, nullptr, s.hv, s.gh, prm.off, d_pack, K,
                       WIDTH, n_extra, stream);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// The backward pack of K7's bf16-operand mode, made on the card from the
// float32 pack into wbt (zt_fused_nerf_pack_bwd_tc_len elements): every
// matrix of bwd_mats, [in rows][out] as the float32 pack stores it, rounded
// to bf16, back to back (the plain version:
// kernels/fused_mlp.py:pack_bf16_bwd_plain).
ZT_API int zt_fused_nerf_pack_bwd_tc(const float* wpack, const int* offsets,
                                     void* wbt, int P, int F, int V,
                                     int width, int depth, int skip,
                                     void* stream) {
  if (depth < 1 || depth > kMaxLayers) return cudaErrorInvalidValue;
  const Geo g = make_geo(width, depth, skip, P, F, V);
  BMat mats[kStreamMax];
  int boff[kStreamMax], count;
  bwd_offsets(g, mats, boff, count);
  BwdPack bp;
  for (int i = 0; i < count; ++i) {
    bp.src[i] = offsets[mats[i].slot] + mats[i].r0 * mats[i].K;
    bp.dst[i] = boff[i];
    bp.len[i] = mats[i].rows * mats[i].K;
  }
  round_pack_bwd_tc_kernel<<<dim3(32, count), 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      wpack, bp, static_cast<bf16*>(wbt));
  return static_cast<int>(cudaGetLastError());
}

// elements of the backward pack at these shapes
ZT_API int zt_fused_nerf_pack_bwd_tc_len(int P, int F, int V, int width,
                                         int depth, int skip) {
  if (depth < 1 || depth > kMaxLayers) return -1;
  const Geo g = make_geo(width, depth, skip, P, F, V);
  BMat mats[kStreamMax];
  int boff[kStreamMax], count;
  return bwd_offsets(g, mats, boff, count);
}

// bytes of scratch that zt_fused_nerf_backward_tc needs for n points in
// chunks of `chunk`
ZT_API int zt_fused_nerf_backward_tc_scratch(int n, int chunk, int P, int F,
                                             int V, int width, int depth,
                                             int skip, int n_extra,
                                             long long* bytes) {
  if (depth < 1 || depth > kMaxLayers || !valid_extra(n_extra) ||
      chunk < 1)
    return cudaErrorInvalidValue;
  BwdScratch s;
  *bytes = carve(s, nullptr, chunk_rows(n > 1 ? n : 1, chunk),
                 make_geo(width, depth, skip, P, F, V), out_channels(n_extra));
  return 0;
}

// the scratch's layout for n points in chunks of `chunk`: at[0] its rows
// R, then the byte offsets of z [depth][R][W], cond [R][W], hv [R][W / 2]
// (float32) and the feature layer's output [R][W] (bf16)
ZT_API int zt_fused_nerf_backward_tc_layout(int n, int chunk, int P, int F,
                                            int V, int width, int depth,
                                            int skip, int n_extra,
                                            long long* at) {
  if (depth < 1 || depth > kMaxLayers || !valid_extra(n_extra) ||
      chunk < 1)
    return cudaErrorInvalidValue;
  BwdScratch s;
  carve(s, reinterpret_cast<void*>(256), chunk_rows(n > 1 ? n : 1, chunk),
        make_geo(width, depth, skip, P, F, V), out_channels(n_extra));
  const char* base = reinterpret_cast<const char*>(256);
  at[0] = s.R;
  at[1] = reinterpret_cast<const char*>(s.z) - base;
  at[2] = reinterpret_cast<const char*>(s.cond) - base;
  at[3] = reinterpret_cast<const char*>(s.hv) - base;
  at[4] = reinterpret_cast<const char*>(s.feat) - base;
  return 0;
}

// K7 in its bf16-operand mode. wpack / offsets: the float32 pack (biases and
// heads); wbf16: K6's bf16 pack of it (zt_fused_nerf_pack_tc), wbt: the
// backward pack (zt_fused_nerf_pack_bwd_tc). d_pts [n][P], d_feats [n][F],
// d_views [n][V] are written; d_pack (the float32 pack's layout) must be
// zeroed by the caller: the weight gradients are added into it. out, if not
// null, receives pass 1's recomputed output rows [n][out_ch]; keep != 0
// leaves the forward's values in the scratch (zt_fused_nerf_backward_tc_
// layout; the last chunk's).
ZT_API int zt_fused_nerf_backward_tc(
    const float* pts, const float* feats, const float* views, const float* g,
    const float* wpack, const int* offsets, const void* wbf16,
    const void* wbt, void* scratch, long long scratch_bytes, int chunk,
    float* d_pts, float* d_feats, float* d_views, float* d_pack, float* out,
    int keep, int n, int P, int F, int V, int width, int depth, int skip,
    int n_extra, void* stream) {
  TcParams prm;
  Geo geo;
  if (!valid_extra(n_extra) || chunk < 1 ||
      !bwd_params(prm, geo, wpack, offsets, wbf16, wbt, P, F, V, width, depth,
                  skip))
    return cudaErrorInvalidValue;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  BwdScratch s;
  if (scratch_bytes < carve(s, nullptr, chunk_rows(n, chunk), geo,
                            out_channels(n_extra)))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 64:
      return launch_bwd_tc<64>(pts, feats, views, g, prm, geo, scratch, chunk,
                               d_pts, d_feats, d_views, d_pack, out, n,
                               n_extra, keep != 0, st);
    case 128:
      return launch_bwd_tc<128>(pts, feats, views, g, prm, geo, scratch, chunk,
                                d_pts, d_feats, d_views, d_pack, out, n,
                                n_extra, keep != 0, st);
    default:
      return launch_bwd_tc<256>(pts, feats, views, g, prm, geo, scratch, chunk,
                                d_pts, d_feats, d_views, d_pack, out, n,
                                n_extra, keep != 0, st);
  }
}

// bytes of dynamic shared memory a block of pass 1 takes at these shapes
ZT_API int zt_fused_nerf_backward_tc_smem(int width, int P, int F, int V) {
  return bwd_smem_bytes(width, pad16(P), pad16(F), pad16(V));
}
