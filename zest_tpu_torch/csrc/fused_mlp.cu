// Fused NeRF field (v0, multiplicative conditioning), forward.
//
// Replaces the TPU kernel zest_tpu/kernels/fused_mlp.py:_fwd_pallas
// (pallas_call at :376, reached from fused_nerf_apply). One launch evaluates a
// whole field on a tile of points:
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
// Layout: a block of 4 warps takes 32 points; each warp owns 8 of them and
// keeps their activations h and conditioning cond (then the feature layer)
// in shared memory, with the warp's inputs beside them. A warp only ever
// reads its own rows, so __syncwarp is the only barrier. Every product is an
// FMA loop in this kernel: lane l computes the width/32 consecutive columns
// l*width/32 ... of its 8 rows, reading them from W[k] as float4 loads (one
// coalesced 1 KB row per warp at width 256, L1/L2-resident) and broadcasting
// h[r][k] from shared memory. Weights are [in][out] row-major in one packed
// buffer whose matrices start on 16-byte boundaries.
//
// What bounds it on an H100: float32 FMA issue and the loads that feed it.
// At width 256 a field is ~0.6 M multiply-adds per point (2.1 M points per
// 16384-ray chunk), and per k a lane issues 8 shared and 2 float4 global
// loads for 64 FMAs. The ~2.4 MB of weights stay in the 50 MB L2; every
// 32-point tile streams them again. Shared memory per block is
// 32 * (2*width + P + F + V) floats (~83 KB at the flagship), so the launch
// opts in above 48 KB and two blocks fit on an SM. Eight rows per warp (rather
// than four) halve the weight loads per FMA, and a k loop unrolled 16 deep
// keeps enough of them in flight to cover L2 latency (on the card: 4 -> 16
// took a field from 12.6 to 11.3 ms on 262,144 points); at width 256 that
// takes ~135 registers and no spills. Tensor-core (mma / wgmma) tiles are
// later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;                       // points per warp
constexpr int kTile = kWarps * kRows;          // points per block
constexpr int kMaxLayers = 16;

// slots of the offsets table (floats into the packed weight buffer); the
// Python wrapper (kernels/fused_mlp.py) fills the same slots
enum Slot {
  kWb = 0, kBb = 1, kLayer0 = 2,               // layer i: W at 2+2i, b at 3+2i
  kWa = kLayer0 + 2 * kMaxLayers, kBa, kWf, kBf, kWv, kBv, kWr, kBr,
  kWx1, kBx1, kWx2, kBx2, kNumSlots
};

struct Params {
  const float* w;
  int off[kNumSlots];
};

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

// out rows (row stride ld) = act(acc + b [* scale rows]), lane's columns
template <int NC, bool kScale, bool kRelu>
__device__ __forceinline__ void epilogue(float* out, int ld,
                                         const float (&acc)[kRows][NC],
                                         const float* __restrict__ b,
                                         const float* scale, int lane) {
  float bv[NC];
  load_cols<NC, true>(bv, b + lane * NC);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float o[NC], sv[NC];
    if constexpr (kScale) load_cols<NC, false>(sv, scale + r * ld + lane * NC);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      o[j] = acc[r][j] + bv[j];
      if constexpr (kScale) o[j] *= sv[j];
      if constexpr (kRelu) o[j] = fmaxf(o[j], 0.f);
    }
    store_cols(out + r * ld + lane * NC, o);
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

template <int WIDTH>
__global__ void __launch_bounds__(kWarps * 32)
fused_nerf_kernel(const float* __restrict__ pts, const float* __restrict__ feats,
                  const float* __restrict__ views, Params prm,
                  float* __restrict__ out, long long n, int P, int F, int V,
                  int depth, int skip, int n_extra) {
  constexpr int NC = WIDTH / 32;       // trunk columns per lane
  constexpr int NCV = WIDTH / 64;      // views-layer columns per lane
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* h = smem + warp * kRows * (2 * WIDTH + P + F + V);
  float* cond = h + kRows * WIDTH;
  float* xin = cond + kRows * WIDTH;
  float* fin = xin + kRows * P;
  float* vin = fin + kRows * F;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTile + warp * kRows;
  if (row0 >= n) return;               // whole warp idle: no barrier to skip
  const float* w = prm.w;

  load_rows(xin, pts, row0, P, n, lane);
  load_rows(fin, feats, row0, F, n, lane);
  load_rows(vin, views, row0, V, n, lane);
  __syncwarp();

  float acc[kRows][NC];
  zero(acc);
  dense(acc, fin, F, F, w + prm.off[kWb], WIDTH, lane);
  epilogue<NC, false, false>(cond, WIDTH, acc, w + prm.off[kBb], nullptr, lane);
  __syncwarp();

  for (int i = 0; i < depth; ++i) {
    const float* Wi = w + prm.off[kLayer0 + 2 * i];
    const float* bi = w + prm.off[kLayer0 + 2 * i + 1];
    zero(acc);
    if (i == 0) {
      dense(acc, xin, P, P, Wi, WIDTH, lane);
    } else if (i == skip + 1) {        // input is [pts, h]
      dense(acc, xin, P, P, Wi, WIDTH, lane);
      dense(acc, h, WIDTH, WIDTH, Wi + static_cast<long long>(P) * WIDTH,
            WIDTH, lane);
    } else {
      dense(acc, h, WIDTH, WIDTH, Wi, WIDTH, lane);
    }
    __syncwarp();                      // every lane has read h
    epilogue<NC, true, true>(h, WIDTH, acc, bi, cond, lane);
    __syncwarp();
  }

  // alpha and the extra heads read the trunk output h
  const int out_ch = n_extra == 1 ? 5 : 12;
  for (int r = 0; r < kRows; ++r) {
    const long long g = row0 + r;
    const float* hr = h + r * WIDTH;
    const float alpha = warp_dot(hr, WIDTH, w + prm.off[kWa], 1, 0, lane) +
                        w[prm.off[kBa]];
    if (lane == 0 && g < n) out[g * out_ch + 3] = alpha;
    if (n_extra == 1) {
      const float v = warp_dot(hr, WIDTH, w + prm.off[kWx1], 1, 0, lane) +
                      w[prm.off[kBx1]];
      if (lane == 0 && g < n) out[g * out_ch + 4] = sigmoidf(v);
    } else if (n_extra == 2) {
      for (int o = 0; o < 6; ++o) {
        const float v = warp_dot(hr, WIDTH, w + prm.off[kWx1], 6, o, lane) +
                        w[prm.off[kBx1] + o];
        if (lane == 0 && g < n) out[g * out_ch + 4 + o] = tanhf(v);
      }
      for (int o = 0; o < 2; ++o) {
        const float v = warp_dot(hr, WIDTH, w + prm.off[kWx2], 2, o, lane) +
                        w[prm.off[kBx2] + o];
        if (lane == 0 && g < n) out[g * out_ch + 10 + o] = sigmoidf(v);
      }
    }
  }

  // feature layer (no activation) into the cond buffer, which is free now
  zero(acc);
  dense(acc, h, WIDTH, WIDTH, w + prm.off[kWf], WIDTH, lane);
  epilogue<NC, false, false>(cond, WIDTH, acc, w + prm.off[kBf], nullptr, lane);
  __syncwarp();

  // views layer: [feature, views] -> width/2, relu, into h
  float accv[kRows][NCV];
  zero(accv);
  const float* Wv = w + prm.off[kWv];
  dense(accv, cond, WIDTH, WIDTH, Wv, WIDTH / 2, lane);
  dense(accv, vin, V, V, Wv + static_cast<long long>(WIDTH) * (WIDTH / 2),
        WIDTH / 2, lane);
  __syncwarp();
  epilogue<NCV, false, true>(h, WIDTH, accv, w + prm.off[kBv], nullptr, lane);
  __syncwarp();

  for (int r = 0; r < kRows; ++r) {
    const long long g = row0 + r;
    for (int o = 0; o < 3; ++o) {
      const float v = warp_dot(h + r * WIDTH, WIDTH / 2, w + prm.off[kWr], 3,
                               o, lane) + w[prm.off[kBr] + o];
      if (lane == 0 && g < n) out[g * out_ch + o] = v;
    }
  }
}

template <int WIDTH>
int launch(const float* pts, const float* feats, const float* views,
           const Params& prm, float* out, long long n, int P, int F, int V,
           int depth, int skip, int n_extra, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kTile * (2 * WIDTH + P + F + V);
  cudaError_t err = cudaFuncSetAttribute(
      fused_nerf_kernel<WIDTH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks = static_cast<unsigned int>((n + kTile - 1) / kTile);
  fused_nerf_kernel<WIDTH><<<blocks, kWarps * 32, smem, stream>>>(
      pts, feats, views, prm, out, n, P, F, V, depth, skip, n_extra);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

ZT_API int zt_fused_nerf_forward(const float* pts, const float* feats,
                                 const float* views, const float* wpack,
                                 const int* offsets, float* out, int n, int P,
                                 int F, int V, int width, int depth, int skip,
                                 int n_extra, void* stream) {
  if (depth < 1 || depth > kMaxLayers || n_extra < 1 || n_extra > 2)
    return cudaErrorInvalidValue;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  Params prm;
  prm.w = wpack;
  for (int s = 0; s < kNumSlots; ++s) prm.off[s] = offsets[s];
  auto st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 64:
      return launch<64>(pts, feats, views, prm, out, n, P, F, V, depth, skip,
                        n_extra, st);
    case 128:
      return launch<128>(pts, feats, views, prm, out, n, P, F, V, depth, skip,
                         n_extra, st);
    case 256:
      return launch<256>(pts, feats, views, prm, out, n, P, F, V, depth, skip,
                         n_extra, st);
    default:
      return cudaErrorInvalidValue;
  }
}
