// Fused NeRF field (v0, multiplicative conditioning), backward (K7) in its
// float32 mode, on the CUDA cores (SIMT).
//
// The field (zest_tpu/kernels/fused_mlp.py:_forward_tile, the forward K6):
//   cond = feats @ Wb + bb
//   h    = relu((h @ W_i + b_i) * cond)         i = 0 .. depth-1, where the
//          layer after `skip` reads [pts, h] as a split product
//   alpha = h @ Wa + ba
//   static:  blend = sigmoid(h @ Ww + bw)
//   dynamic: sf = tanh(h @ Ws + bs) (6), prob = sigmoid(h @ Wp + bp) (2)
//   hv  = relu([h @ Wf + bf, views] @ Wv + bv)   (width / 2)
//   rgb = hv @ Wr + br
// Output row: [rgb(3), alpha(1), extras].
//
// K6 runs on the tensor cores in both modes (fused_mlp_tc32.cu at float32,
// 3xTF32; fused_mlp_tc.cu with bf16 operands), and so does K7's bf16 mode
// (fused_mlp_tc_bwd.cu). This file's kernels are K7's float32 mode.
//
// Layout of pass 1 below: a block of 4 warps takes 32 points; each warp owns
// 8 of them and keeps their activations and conditioning in shared memory,
// with the warp's inputs beside them. A warp only ever reads its own rows,
// so __syncwarp is the only barrier. Every product is an FMA loop: lane l
// computes the width/32 consecutive columns l*width/32 ... of its 8 rows,
// reading them from W[k] as float4 loads (one coalesced 1 KB row per warp at
// width 256, L1/L2-resident) and broadcasting h[r][k] from shared memory.
// Weights are [in][out] row-major in one packed buffer whose matrices start
// on 16-byte boundaries. Eight rows per warp (rather than four) halve the
// weight loads per FMA, and a k loop unrolled 16 deep keeps enough of them in
// flight to cover L2 latency.
#include "common.cuh"
#include "fused_mlp.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;                       // points per warp
constexpr int kTile = kWarps * kRows;          // points per block

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// N consecutive floats at p (16-byte aligned when N % 4 == 0, 8 when N == 2)
// with as few load / store instructions as the width allows
template <int N, bool kGlobal>
__device__ __forceinline__ void load_cols(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4* p4 = reinterpret_cast<const float4*>(p) + q;
      const float4 t = kGlobal ? __ldg(p4) : *p4;
      v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z; v[4 * q + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2* p2 = reinterpret_cast<const float2*>(p);
    const float2 t = kGlobal ? __ldg(p2) : *p2;
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = kGlobal ? __ldg(p + j) : p[j];
  }
}

template <int N>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = v[j];
  }
}

// acc[r][j] += sum_k x[r * ldx + k] * W[k * ldw + lane * NC + j]: each lane
// owns NC consecutive columns, read as vector loads
template <int NC>
__device__ __forceinline__ void dense(float (&acc)[kRows][NC],
                                      const float* x, int ldx, int K,
                                      const float* __restrict__ W, int ldw,
                                      int lane) {
  const float* wcol = W + lane * NC;
#pragma unroll 16
  for (int k = 0; k < K; ++k) {
    float xv[kRows], wv[NC];
#pragma unroll
    for (int r = 0; r < kRows; ++r) xv[r] = x[r * ldx + k];
    load_cols<NC, true>(wv, wcol + static_cast<long long>(k) * ldw);
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r][j] = fmaf(xv[r], wv[j], acc[r][j]);
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[kRows][NC]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
}

// sum_k x[k] * W[k * ldw + col], reduced across the warp (every lane gets it)
__device__ __forceinline__ float warp_dot(const float* x, int K,
                                          const float* __restrict__ W, int ldw,
                                          int col, int lane) {
  float s = 0.f;
  for (int k = lane; k < K; k += 32)
    s = fmaf(x[k], __ldg(W + static_cast<long long>(k) * ldw + col), s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          long long row0, int ch, long long n,
                                          int lane) {
  for (int t = lane; t < kRows * ch; t += 32) {
    const int r = t / ch;
    const long long g = row0 + r;
    dst[t] = g < n ? src[g * ch + (t - r * ch)] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Backward (K7), float32.
//
// Replaces zest_tpu/kernels/fused_mlp.py:_bwd_pallas (pallas_call at :398).
// The TPU kernel recomputes the forward per tile and sums every dW across
// sequential grid steps in resident output refs. Blocks on Hopper run in
// parallel, so the weight gradients take a second pass:
//
//   pass 1 (fused_nerf_bwd_kernel): per 32-point tile, the forward again,
//     then the backward to d_pts, d_feats, d_views. Every product input that
//     the weight gradients need (conditioning, the trunk's pre-activations
//     z_i, the feature and views-layer outputs) and every layer's output
//     gradient d_z goes to a scratch buffer in device memory.
//   pass 2 (wgrad_kernel): dW = X^T dZ and db = sum dZ per layer, a tiled
//     float32 reduction over the points, split along the points into blocks
//     of kSplit rows whose partial tiles are added with atomics into d_pack
//     (which the caller zeroes). The trunk inputs h_{i-1} = relu(z_{i-1} *
//     cond) are formed while the tile loads.
//
// The input-gradient products of pass 1 read the weights untransposed
// ([out][in], the "transposed pack" that transpose_pack_kernel builds from
// the forward pack at the start of every backward call, into the head of the
// scratch buffer), so a lane's columns are again consecutive floats of one
// row. The narrow outputs (d_pts, d_feats, d_views: <= 96 columns) use a lane
// per column. Points are processed in chunks of `chunk` rows so the scratch
// (W * (2 * depth + 5) + out_ch floats per point) stays bounded.
//
// What bounds it on an H100: float32 FMA issue: pass 1 does the forward's
// products plus the same again for d_h (~2.4 MFLOP per point at width 256),
// pass 2 the weight products (~1.2 MFLOP per point).
// The scratch adds ~43 KB of traffic per point (written once, read once),
// ~4 ms per flagship step at the HBM rate against ~30 ms of FMA work at peak.

constexpr int kGS = 16;         // smem row stride of g / d_heads (<= 12 used)
constexpr int kES = 8;          // smem row stride of the extra heads' values
constexpr int kNarrow = 3;      // columns per lane of a narrow product (<= 96)

// slots of the transposed pack: weights only, [out][in] row-major; layer
// skip+1 holds its h part there and its pts part at kTSkipP, the views layer
// is split likewise
enum TSlot {
  kTWb = 0, kTLayer0 = 1, kTSkipP = kTLayer0 + kMaxLayers, kTWa, kTWf,
  kTWvF, kTWvV, kTWr, kTWx1, kTWx2, kNumTSlots
};

struct BParams {
  const float* w;                // forward pack ([in][out] + biases)
  const float* wt;               // transposed pack
  int off[kNumSlots];
  int toff[kNumTSlots];
};

// one matrix of the transposed pack: src [rows][cols] row-major at w + src
// becomes [cols][rows] at wt + dst
struct TPart {
  int src, rows, cols, dst;
};

struct TParts {
  TPart p[kNumTSlots];
  int n;
};

// The transposed pack's parts from the forward pack's offsets (prm.off) and
// the field's shapes; fills prm.toff and returns the pack's length in floats.
// Every part starts on a multiple of 4 floats, as the float4 loads need.
int tpack_layout(BParams& prm, TParts& t, int P, int F, int V, int W,
                 int depth, int skip, int n_extra) {
  int cur = 0;
  t.n = 0;
  auto add = [&](int tslot, int src, int rows, int cols) {
    prm.toff[tslot] = cur;
    t.p[t.n++] = {src, rows, cols, cur};
    cur += (rows * cols + 3) / 4 * 4;
  };
  for (int s = 0; s < kNumTSlots; ++s) prm.toff[s] = 0;
  const int* off = prm.off;
  add(kTWb, off[kWb], F, W);
  for (int i = 0; i < depth; ++i) {
    const int wo = off[kLayer0 + 2 * i];
    if (i == 0) {
      add(kTLayer0, wo, P, W);
    } else if (i == skip + 1) {        // [pts, h] @ W: the two row blocks
      add(kTSkipP, wo, P, W);
      add(kTLayer0 + i, wo + P * W, W, W);
    } else {
      add(kTLayer0 + i, wo, W, W);
    }
  }
  add(kTWa, off[kWa], W, 1);
  add(kTWf, off[kWf], W, W);
  add(kTWvF, off[kWv], W, W / 2);
  add(kTWvV, off[kWv] + W * (W / 2), V, W / 2);
  add(kTWr, off[kWr], W / 2, 3);
  add(kTWx1, off[kWx1], W, n_extra == 1 ? 1 : 6);
  if (n_extra == 2) add(kTWx2, off[kWx2], W, 2);
  return cur;
}

// writes are coalesced: consecutive threads take consecutive floats of wt
__global__ void transpose_pack_kernel(const float* __restrict__ w,
                                      float* __restrict__ wt, TParts t) {
  const TPart q = t.p[blockIdx.y];
  const int total = q.rows * q.cols;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int c = e / q.rows, r = e - c * q.rows;
    wt[q.dst + e] = w[q.src + r * q.cols + c];
  }
}

// per-chunk scratch, each [rows][cols] row-major (z and dz: depth of them)
struct Scratch {
  float *cond, *z, *feat, *hv, *dz, *dbias, *dfeat, *dhv, *gh;
  long long rows;
};

__host__ __device__ inline long long scratch_floats(long long rows, int W,
                                                    int depth, int out_ch) {
  return rows * (static_cast<long long>(W) * (2 * depth + 5) + out_ch);
}

inline Scratch carve(float* base, long long rows, int W, int depth) {
  Scratch s;
  s.rows = rows;
  const long long rw = rows * W;
  s.cond = base;
  s.z = s.cond + rw;
  s.feat = s.z + depth * rw;
  s.hv = s.feat + rw;
  s.dz = s.hv + rw / 2;
  s.dbias = s.dz + depth * rw;
  s.dfeat = s.dbias + rw;
  s.dhv = s.dfeat + rw;
  s.gh = s.dhv + rw / 2;
  return s;
}

template <int NC>
__device__ __forceinline__ void add_bias(float (&acc)[kRows][NC],
                                         const float* __restrict__ b, int lane) {
  float bv[NC];
  load_cols<NC, true>(bv, b + lane * NC);
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] += bv[j];
}

template <int NC>
__device__ __forceinline__ void store_sm(float* sm, int ld,
                                         const float (&acc)[kRows][NC], int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) store_cols(sm + r * ld + lane * NC, acc[r]);
}

// rows row0.. of a [n][ld] global buffer; rows >= n are not written
template <int NC>
__device__ __forceinline__ void store_gl(float* gl, long long ld,
                                         const float (&acc)[kRows][NC],
                                         long long row0, long long n, int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (row0 + r < n) store_cols(gl + (row0 + r) * ld + lane * NC, acc[r]);
}

// acc[r][q] += sum_k x[r * ldx + k] * W[k * ldw + lane + 32 q], q < kNarrow:
// a product with at most 32 * kNarrow output columns, one column per lane
__device__ __forceinline__ void dense_narrow(float (&acc)[kRows][kNarrow],
                                             const float* x, int ldx, int K,
                                             const float* __restrict__ W,
                                             int ldw, int ncols, int lane) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float xv[kRows], wv[kNarrow];
#pragma unroll
    for (int r = 0; r < kRows; ++r) xv[r] = x[r * ldx + k];
#pragma unroll
    for (int q = 0; q < kNarrow; ++q) {
      const int c = lane + 32 * q;
      wv[q] = c < ncols ? __ldg(W + static_cast<long long>(k) * ldw + c) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kNarrow; ++q)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r][q] = fmaf(xv[r], wv[q], acc[r][q]);
  }
}

__device__ __forceinline__ void store_narrow(float* out, int ncols,
                                             const float (&acc)[kRows][kNarrow],
                                             long long row0, long long n,
                                             int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row0 + r >= n) continue;
#pragma unroll
    for (int q = 0; q < kNarrow; ++q) {
      const int c = lane + 32 * q;
      if (c < ncols) out[(row0 + r) * ncols + c] = acc[r][q];
    }
  }
}

__device__ __forceinline__ void zero_narrow(float (&acc)[kRows][kNarrow]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int q = 0; q < kNarrow; ++q) acc[r][q] = 0.f;
}

// pass 1: one chunk of n points (pointers already offset to the chunk)
template <int WIDTH>
__global__ void __launch_bounds__(kWarps * 32)
fused_nerf_bwd_kernel(const float* __restrict__ pts,
                      const float* __restrict__ feats,
                      const float* __restrict__ views,
                      const float* __restrict__ g, BParams prm, Scratch s,
                      float* __restrict__ d_pts, float* __restrict__ d_feats,
                      float* __restrict__ d_views, long long n, int P, int F,
                      int V, int depth, int skip, int n_extra) {
  constexpr int NC = WIDTH / 32;
  constexpr int NCV = WIDTH / 64;
  constexpr int W = WIDTH;
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* A = smem + warp * kRows * (2 * W + P + F + V + kGS + kES);
  float* B = A + kRows * W;
  float* xin = B + kRows * W;
  float* fin = xin + kRows * P;
  float* vin = fin + kRows * F;
  float* gs = vin + kRows * V;
  float* es = gs + kRows * kGS;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTile + warp * kRows;
  if (row0 >= n) return;
  const float* w = prm.w;
  const float* wt = prm.wt;
  const int out_ch = n_extra == 1 ? 5 : 12;
  const long long rw = s.rows * W;

  load_rows(xin, pts, row0, P, n, lane);
  load_rows(fin, feats, row0, F, n, lane);
  load_rows(vin, views, row0, V, n, lane);
  for (int t = lane; t < kRows * out_ch; t += 32) {
    const int r = t / out_ch, c = t - r * out_ch;
    gs[r * kGS + c] = row0 + r < n ? g[(row0 + r) * out_ch + c] : 0.f;
  }
  __syncwarp();

  // ---- forward again, saving what the weight gradients read ----
  float acc[kRows][NC];
  zero(acc);
  dense<NC>(acc, fin, F, F, w + prm.off[kWb], W, lane);
  add_bias(acc, w + prm.off[kBb], lane);
  store_sm(B, W, acc, lane);                     // cond
  store_gl(s.cond, W, acc, row0, n, lane);
  __syncwarp();

  for (int i = 0; i < depth; ++i) {
    const float* Wi = w + prm.off[kLayer0 + 2 * i];
    zero(acc);
    if (i == 0) {
      dense<NC>(acc, xin, P, P, Wi, W, lane);
    } else if (i == skip + 1) {
      dense<NC>(acc, xin, P, P, Wi, W, lane);
      dense<NC>(acc, A, W, W, Wi + static_cast<long long>(P) * W, W, lane);
    } else {
      dense<NC>(acc, A, W, W, Wi, W, lane);
    }
    __syncwarp();                                // every lane has read h
    add_bias(acc, w + prm.off[kLayer0 + 2 * i + 1], lane);
    store_gl(s.z + i * rw, W, acc, row0, n, lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float c[NC];
      load_cols<NC, false>(c, B + r * W + lane * NC);
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = fmaxf(acc[r][j] * c[j], 0.f);
    }
    store_sm(A, W, acc, lane);
    __syncwarp();
  }

  // the extra heads' activations, for their derivatives
  for (int r = 0; r < kRows; ++r) {
    const float* hr = A + r * W;
    if (n_extra == 1) {
      const float v = warp_dot(hr, W, w + prm.off[kWx1], 1, 0, lane) +
                      w[prm.off[kBx1]];
      if (lane == 0) es[r * kES] = sigmoidf(v);
    } else {
      for (int o = 0; o < 6; ++o) {
        const float v = warp_dot(hr, W, w + prm.off[kWx1], 6, o, lane) +
                        w[prm.off[kBx1] + o];
        if (lane == 0) es[r * kES + o] = tanhf(v);
      }
      for (int o = 0; o < 2; ++o) {
        const float v = warp_dot(hr, W, w + prm.off[kWx2], 2, o, lane) +
                        w[prm.off[kBx2] + o];
        if (lane == 0) es[r * kES + 6 + o] = sigmoidf(v);
      }
    }
  }

  // feature layer into B (cond is in the scratch from here on)
  zero(acc);
  dense<NC>(acc, A, W, W, w + prm.off[kWf], W, lane);
  add_bias(acc, w + prm.off[kBf], lane);
  store_sm(B, W, acc, lane);
  store_gl(s.feat, W, acc, row0, n, lane);
  __syncwarp();

  // views layer: hv = relu([feature, views] @ Wv + bv) into A
  float accv[kRows][NCV];
  zero(accv);
  dense<NCV>(accv, B, W, W, w + prm.off[kWv], W / 2, lane);
  dense<NCV>(accv, vin, V, V, w + prm.off[kWv] + static_cast<long long>(W) * (W / 2),
        W / 2, lane);
  add_bias(accv, w + prm.off[kBv], lane);
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < NCV; ++j) accv[r][j] = fmaxf(accv[r][j], 0.f);
  store_sm(A, W, accv, lane);
  store_gl(s.hv, W / 2, accv, row0, n, lane);
  __syncwarp();

  // ---- backward ----
  // the heads' pre-activation gradients: rgb and alpha as given, the blend
  // and probability through their sigmoid, the flow through its tanh
  for (int t = lane; t < kRows * out_ch; t += 32) {
    const int r = t / out_ch, c = t - r * out_ch;
    float v = gs[r * kGS + c];
    if (c >= 4) {
      const float e = es[r * kES + c - 4];
      v *= (n_extra == 1 || c >= 10) ? e * (1.f - e) : 1.f - e * e;
      gs[r * kGS + c] = v;
    }
    if (row0 + r < n) s.gh[(row0 + r) * out_ch + c] = v;
  }
  __syncwarp();

  // d_hv = (d_rgb @ Wr^T) masked by hv > 0, into A over hv
  zero(accv);
  dense(accv, gs, kGS, 3, wt + prm.toff[kTWr], W / 2, lane);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float hv[NCV];
    load_cols<NCV, false>(hv, A + r * W + lane * NCV);
#pragma unroll
    for (int j = 0; j < NCV; ++j) accv[r][j] = hv[j] > 0.f ? accv[r][j] : 0.f;
  }
  store_sm(A, W, accv, lane);
  store_gl(s.dhv, W / 2, accv, row0, n, lane);
  __syncwarp();

  float accn[kRows][kNarrow];
  zero_narrow(accn);
  dense_narrow(accn, A, W, W / 2, wt + prm.toff[kTWvV], V, V, lane);
  store_narrow(d_views, V, accn, row0, n, lane);

  // d_feature = d_hv @ Wv_feature^T into B
  zero(acc);
  dense<NC>(acc, A, W, W / 2, wt + prm.toff[kTWvF], W, lane);
  store_sm(B, W, acc, lane);
  store_gl(s.dfeat, W, acc, row0, n, lane);
  __syncwarp();

  // d_h of the trunk output: feature, alpha and the extra heads
  zero(acc);
  dense<NC>(acc, B, W, W, wt + prm.toff[kTWf], W, lane);
  dense(acc, gs + 3, kGS, 1, wt + prm.toff[kTWa], W, lane);
  if (n_extra == 1) {
    dense(acc, gs + 4, kGS, 1, wt + prm.toff[kTWx1], W, lane);
  } else {
    dense(acc, gs + 4, kGS, 6, wt + prm.toff[kTWx1], W, lane);
    dense(acc, gs + 10, kGS, 2, wt + prm.toff[kTWx2], W, lane);
  }
  __syncwarp();                                  // B is read: d_bias from here

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float zr[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) zr[j] = 0.f;
    store_cols(B + r * W + lane * NC, zr);
  }
  float accp[kRows][kNarrow];
  zero_narrow(accp);

  for (int i = depth - 1; i >= 0; --i) {
    const float* zi = s.z + i * rw;
    // d_a = d_h where a = z * cond > 0; d_bias += d_a * z; d_z = d_a * cond
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float z[NC], c[NC], db[NC];
      if (row0 + r < n) {
        load_cols<NC, false>(z, zi + (row0 + r) * W + lane * NC);
        load_cols<NC, false>(c, s.cond + (row0 + r) * W + lane * NC);
      } else {
#pragma unroll
        for (int j = 0; j < NC; ++j) z[j] = c[j] = 0.f;
      }
      load_cols<NC, false>(db, B + r * W + lane * NC);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float da = z[j] * c[j] > 0.f ? acc[r][j] : 0.f;
        db[j] = fmaf(da, z[j], db[j]);
        acc[r][j] = da * c[j];
      }
      store_cols(B + r * W + lane * NC, db);
    }
    store_sm(A, W, acc, lane);
    store_gl(s.dz + i * rw, W, acc, row0, n, lane);
    __syncwarp();
    if (i == 0) {
      dense_narrow(accp, A, W, W, wt + prm.toff[kTLayer0], P, P, lane);
    } else {
      if (i == skip + 1)
        dense_narrow(accp, A, W, W, wt + prm.toff[kTSkipP], P, P, lane);
      zero(acc);
      dense<NC>(acc, A, W, W, wt + prm.toff[kTLayer0 + i], W, lane);
    }
    __syncwarp();                                // A is read before rewriting
  }
  store_narrow(d_pts, P, accp, row0, n, lane);

  // d_bias: to the scratch, and d_feats = d_bias @ Wb^T
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row0 + r >= n) continue;
    float db[NC];
    load_cols<NC, false>(db, B + r * W + lane * NC);
    store_cols(s.dbias + (row0 + r) * W + lane * NC, db);
  }
  zero_narrow(accn);
  dense_narrow(accn, B, W, W, wt + prm.toff[kTWb], F, F, lane);
  store_narrow(d_feats, F, accn, row0, n, lane);
}

// pass 2: C[m][n] += sum_k A'[k][m] * B[k][n] over this block's kSplit rows,
// A' = relu(A * S) when S is given (S has A's layout), else A; and, when db
// is given, db[n] += sum_k B[k][n] (the blocks of the first row of tiles).
constexpr int kGT = 64;         // output tile (kGT x kGT), 4x4 per thread
constexpr int kGK = 16;         // rows per shared-memory stage
constexpr int kSplit = 1024;    // rows per block

__global__ void __launch_bounds__(256)
wgrad_kernel(const float* __restrict__ Am, int lda, const float* __restrict__ S,
             const float* __restrict__ Bm, int ldb, float* C, int ldc,
             float* db, int M, int N, long long K) {
  __shared__ float As[kGK][kGT];
  __shared__ float Bs[kGK][kGT];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kGT, n0 = blockIdx.x * kGT;
  const long long k0 = static_cast<long long>(blockIdx.z) * kSplit;
  const long long k1 = k0 + kSplit < K ? k0 + kSplit : K;
  const bool do_db = db != nullptr && blockIdx.y == 0 && ty == 0;
  float acc[4][4] = {};
  float colsum[4] = {};
  for (long long kb = k0; kb < k1; kb += kGK) {
    for (int t = tid; t < kGK * kGT; t += 256) {
      const int kk = t / kGT, c = t - kk * kGT;
      const long long k = kb + kk;
      float a = 0.f, b = 0.f;
      if (k < k1 && m0 + c < M) {
        a = Am[k * lda + m0 + c];
        if (S != nullptr) a = fmaxf(a * S[k * lda + m0 + c], 0.f);
      }
      if (k < k1 && n0 + c < N) b = Bm[k * ldb + n0 + c];
      As[kk][c] = a;
      Bs[kk][c] = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      if (do_db) {
#pragma unroll
        for (int j = 0; j < 4; ++j) colsum[j] += b[j];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx * 4 + j;
      if (nn < N) atomicAdd(C + static_cast<long long>(m) * ldc + nn, acc[i][j]);
    }
  }
  if (do_db) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx * 4 + j;
      if (nn < N) atomicAdd(db + nn, colsum[j]);
    }
  }
}

int wgrad(const float* A, int lda, const float* S, const float* B, int ldb,
          float* C, int ldc, float* db, int M, int N, long long K,
          cudaStream_t stream) {
  const dim3 grid((N + kGT - 1) / kGT, (M + kGT - 1) / kGT,
                  static_cast<unsigned int>((K + kSplit - 1) / kSplit));
  wgrad_kernel<<<grid, 256, 0, stream>>>(A, lda, S, B, ldb, C, ldc, db, M, N,
                                         K);
  return static_cast<int>(cudaGetLastError());
}

// the weight-gradient products of one chunk of `rows` points
int weight_grads(const float* pts, const float* feats, const float* views,
                 const Scratch& s, const BParams& prm, float* d_pack,
                 long long rows, int P, int F, int V, int W, int depth,
                 int skip, int n_extra, cudaStream_t st) {
  const int out_ch = n_extra == 1 ? 5 : 12;
  const long long rw = rows * W;
  const float* h_last = s.z + (depth - 1) * rw;
  float* d = d_pack;
  const int* off = prm.off;
  int err = 0;
  auto run = [&](const float* A, int lda, const float* S, const float* Bm,
                 int ldb, int c_off, int d_off, int M, int N) {
    if (err == 0)
      err = wgrad(A, lda, S, Bm, ldb, d + c_off, N, d_off < 0 ? nullptr : d + d_off,
                  M, N, rows, st);
  };
  run(feats, F, nullptr, s.dbias, W, off[kWb], off[kBb], F, W);
  for (int i = 0; i < depth; ++i) {
    const int wo = off[kLayer0 + 2 * i], bo = off[kLayer0 + 2 * i + 1];
    const float* dz = s.dz + i * rw;
    if (i == 0) {
      run(pts, P, nullptr, dz, W, wo, bo, P, W);
    } else {
      const float* z_prev = s.z + (i - 1) * rw;
      int h_off = wo;
      if (i == skip + 1) {
        run(pts, P, nullptr, dz, W, wo, -1, P, W);
        h_off = wo + P * W;
      }
      run(z_prev, W, s.cond, dz, W, h_off, bo, W, W);
    }
  }
  run(h_last, W, s.cond, s.gh + 3, out_ch, off[kWa], off[kBa], W, 1);
  if (n_extra == 1) {
    run(h_last, W, s.cond, s.gh + 4, out_ch, off[kWx1], off[kBx1], W, 1);
  } else {
    run(h_last, W, s.cond, s.gh + 4, out_ch, off[kWx1], off[kBx1], W, 6);
    run(h_last, W, s.cond, s.gh + 10, out_ch, off[kWx2], off[kBx2], W, 2);
  }
  run(h_last, W, s.cond, s.dfeat, W, off[kWf], off[kBf], W, W);
  run(s.feat, W, nullptr, s.dhv, W / 2, off[kWv], off[kBv], W, W / 2);
  run(views, V, nullptr, s.dhv, W / 2, off[kWv] + W * (W / 2), -1, V, W / 2);
  run(s.hv, W / 2, nullptr, s.gh, out_ch, off[kWr], off[kBr], W / 2, 3);
  return err;
}

// prm.wt and prm.toff are set here: the transposed pack goes to the head of
// scratch (tlen floats, from tpack_layout), the per-chunk buffers after it
template <int WIDTH>
int launch_bwd(const float* pts, const float* feats, const float* views,
               const float* g, BParams& prm, const TParts& parts, int tlen,
               float* scratch, long long chunk, float* d_pts, float* d_feats,
               float* d_views, float* d_pack, long long n, int P, int F, int V,
               int depth, int skip, int n_extra, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * kTile * (2 * WIDTH + P + F + V + kGS + kES);
  cudaError_t e = cudaFuncSetAttribute(
      fused_nerf_bwd_kernel<WIDTH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  float* tpack = scratch;
  scratch += tlen;
  prm.wt = tpack;
  transpose_pack_kernel<<<dim3(32, parts.n), 256, 0, stream>>>(prm.w, tpack,
                                                               parts);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  const int out_ch = n_extra == 1 ? 5 : 12;
  for (long long c0 = 0; c0 < n; c0 += chunk) {
    const long long rows = n - c0 < chunk ? n - c0 : chunk;
    const Scratch s = carve(scratch, rows, WIDTH, depth);
    const unsigned int blocks = static_cast<unsigned int>((rows + kTile - 1) / kTile);
    fused_nerf_bwd_kernel<WIDTH><<<blocks, kWarps * 32, smem, stream>>>(
        pts + c0 * P, feats + c0 * F, views + c0 * V, g + c0 * out_ch, prm, s,
        d_pts + c0 * P, d_feats + c0 * F, d_views + c0 * V, rows, P, F, V,
        depth, skip, n_extra);
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    err = weight_grads(pts + c0 * P, feats + c0 * F, views + c0 * V, s, prm,
                       d_pack, rows, P, F, V, WIDTH, depth, skip, n_extra,
                       stream);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// The floats of scratch that zt_fused_nerf_backward needs for n points in
// chunks of `chunk`: the transposed pack, then one chunk's buffers.
ZT_API int zt_fused_nerf_backward_scratch(int n, int chunk, int P, int F,
                                          int V, int width, int depth,
                                          int skip, int n_extra,
                                          long long* floats) {
  if (depth < 1 || depth > kMaxLayers || n_extra < 1 || n_extra > 2 ||
      chunk < 1)
    return cudaErrorInvalidValue;
  BParams prm = {};
  TParts parts;
  const long long rows = n < chunk ? (n > 1 ? n : 1) : chunk;
  *floats = tpack_layout(prm, parts, P, F, V, width, depth, skip, n_extra) +
            scratch_floats(rows, width, depth, n_extra == 1 ? 5 : 12);
  return 0;
}

// K7 in its float32 mode (the bf16-operand mode: fused_mlp_tc_bwd.cu).
// d_pts [n][P], d_feats [n][F], d_views [n][V] are written; d_pack (the
// forward pack's layout) must be zeroed by the caller: the weight gradients
// are added into it. scratch holds zt_fused_nerf_backward_scratch floats.
ZT_API int zt_fused_nerf_backward(const float* pts, const float* feats,
                                  const float* views, const float* g,
                                  const float* wpack, const int* offsets,
                                  float* scratch, long long scratch_len,
                                  int chunk, float* d_pts, float* d_feats,
                                  float* d_views, float* d_pack, int n, int P,
                                  int F, int V, int width, int depth, int skip,
                                  int n_extra, void* stream) {
  if (depth < 1 || depth > kMaxLayers || n_extra < 1 || n_extra > 2 ||
      chunk < 1 || P > 32 * kNarrow || F > 32 * kNarrow || V > 32 * kNarrow)
    return cudaErrorInvalidValue;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long rows = n < chunk ? n : chunk;
  BParams prm;
  prm.w = wpack;
  for (int s = 0; s < kNumSlots; ++s) prm.off[s] = offsets[s];
  TParts parts;
  const int tlen = tpack_layout(prm, parts, P, F, V, width, depth, skip,
                                n_extra);
  if (scratch_len <
      tlen + scratch_floats(rows, width, depth, n_extra == 1 ? 5 : 12))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 64:
      return launch_bwd<64>(pts, feats, views, g, prm, parts, tlen, scratch,
                            rows, d_pts, d_feats, d_views, d_pack, n, P, F, V,
                            depth, skip, n_extra, st);
    case 128:
      return launch_bwd<128>(pts, feats, views, g, prm, parts, tlen, scratch,
                             rows, d_pts, d_feats, d_views, d_pack, n, P, F, V,
                             depth, skip, n_extra, st);
    case 256:
      return launch_bwd<256>(pts, feats, views, g, prm, parts, tlen, scratch,
                             rows, d_pts, d_feats, d_views, d_pack, n, P, F, V,
                             depth, skip, n_extra, st);
    default:
      return cudaErrorInvalidValue;
  }
}
