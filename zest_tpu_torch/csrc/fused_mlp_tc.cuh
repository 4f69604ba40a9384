// The fused field's tensor-core tile, shared by K6's bf16-operand mode
// (fused_mlp_tc.cu), K7's (fused_mlp_tc_bwd.cu) and K6's float32 mode
// (fused_mlp_tc32.cu): the weight stream, the mma.sync products and the
// forward of a 64-point block, for an operand type T: bf16 (mma m16n8k16) or
// float (3xTF32: three mma m16n8k8 TF32 products per k8 step). K6 and K7 in
// the bf16 mode run the same instruction sequence from this header, so K7's
// recompute of the forward gives K6's activations bit for bit. The design is
// described in fused_mlp_tc.cu's header note, the float32 mode's in
// fused_mlp_tc32.cu's.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "fused_mlp.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMats = kMaxLayers + 3;  // cond, trunk, feature, views
// matrices of a stream: K7 runs the forward's, then the backward's (views
// in two parts, feature, the trunk with the skip layer in two, cond)
constexpr int kStreamMax = 2 * kMaxLayers + 8;

constexpr int kM = 64;                 // points per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKS = 64;                // K columns per bf16 weight slice
constexpr int kStages = 3;             // weight ring slots
constexpr int kSS = kKS + 8;           // bf16 row stride of a slot
constexpr int kRed = 12;               // output columns of the head partials
constexpr int kSmemLimit = 232448;

// What differs between the operand types: the mma depth (each K part is
// zero padded to a multiple of it), the pair an epilogue stores into h, and
// how an input is rounded to the operand.
template <typename T>
struct Operand;

template <>
struct Operand<bf16> {
  using Pair = __nv_bfloat162;
  static constexpr int kK = 16;
  __device__ static Pair pair(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  __device__ static bf16 of(float v) { return __float2bfloat16_rn(v); }
};

template <>
struct Operand<float> {
  using Pair = float2;
  static constexpr int kK = 8;
  __device__ static Pair pair(float a, float b) { return make_float2(a, b); }
  __device__ static float of(float v) { return v; }
};

// A slice row of the weight ring is 128 bytes (kKS = 64 bf16, or 32 floats)
// in a slot row of 144: 8 rows that ldmatrix reads fall in distinct banks,
// as do the rows of every other operand, padded by 16 bytes too.
template <typename T>
constexpr int kCols = 128 / sizeof(T);
template <typename T>
constexpr int kPad = 16 / sizeof(T);   // elements in 16 bytes
template <typename T>
constexpr int kStride = kCols<T> + kPad<T>;
// T itself, in a parameter from which T is not deduced (a null pointer)
template <typename T>
using Same = typename std::enable_if<true, T>::type;
static_assert(kCols<bf16> == kKS && kStride<bf16> == kSS, "bf16 ring");

// The weight stream: every matrix a block multiplies by, in the order it
// runs them, each [rows][K] of T, K-contiguous (the B layout of mma
// .row.col), K a multiple of the mma depth
template <typename T>
struct StreamOf {
  const T* src[kStreamMax];
  int rows[kStreamMax];
  int K[kStreamMax];
  int n;
};
using Stream = StreamOf<bf16>;

template <typename T>
struct TcParamsOf {
  const float* w;                      // float32 pack: biases and heads
  int off[kNumSlots];
  StreamOf<T> st;
};
using TcParams = TcParamsOf<bf16>;

__host__ __device__ inline int pad_to(int k, int q) {
  return (k + q - 1) / q * q;
}
__host__ __device__ inline int pad16(int k) { return pad_to(k, 16); }

// shapes of the field, and P, F, V padded to multiples of the mma depth q
// (16 for bf16 operands, 8 for float32)
struct Geo {
  int W, depth, skip, P, F, V, Pp, Fp, Vp;
};

__host__ __device__ inline Geo make_geo(int W, int depth, int skip, int P,
                                        int F, int V, int q = 16) {
  return Geo{W, depth, skip, P, F, V, pad_to(P, q), pad_to(F, q),
             pad_to(V, q)};
}

// Matrix m of the forward (0 the conditioning, 1 .. depth the trunk, depth +
// 1 the feature layer, depth + 2 the views layer): its rows (outputs), its
// weight's slot in the float32 pack, and its K as one or two parts, each zero
// padded to a multiple of the mma depth on its own: K1 real columns of K1p,
// then K2 (the skip layer's [pts, h], the views layer's [feature, views]); K
// is the padded whole, the row stride of the matrix in the operand pack.
struct Mat {
  int rows, slot, K1, K1p, K2, K;
};

__host__ __device__ __forceinline__ Mat mat_of(const Geo& g, int m) {
  if (m == 0) return Mat{g.W, kWb, g.F, g.Fp, 0, g.Fp};
  if (m <= g.depth) {
    const int i = m - 1, slot = kLayer0 + 2 * i;
    if (i == 0) return Mat{g.W, slot, g.P, g.Pp, 0, g.Pp};
    if (i == g.skip + 1) return Mat{g.W, slot, g.P, g.Pp, g.W, g.Pp + g.W};
    return Mat{g.W, slot, g.W, g.W, 0, g.W};
  }
  if (m == g.depth + 1) return Mat{g.W, kWf, g.W, g.W, 0, g.W};
  return Mat{g.W / 2, kWv, g.W, g.W, g.V, g.W + g.Vp};
}

// each forward matrix's first element in the operand pack (back to back,
// stream order); moff[depth + 3] is the pack's length
inline void mat_offsets(const Geo& g, int (&moff)[kMats + 1]) {
  moff[0] = 0;
  for (int m = 0; m < g.depth + 3; ++m) {
    const Mat t = mat_of(g, m);
    moff[m + 1] = moff[m] + t.rows * t.K;
  }
}

// the forward's matrices as the first depth + 3 of a stream, from the
// operand pack wb; false if the shapes are not the kernels'
template <typename T>
inline bool forward_stream(StreamOf<T>& st, const Geo& g, const T* wb) {
  if (g.depth < 1 || g.depth > kMaxLayers ||
      (g.W != 64 && g.W != 128 && g.W != 256))
    return false;
  int moff[kMats + 1];
  mat_offsets(g, moff);
  for (int m = 0; m < g.depth + 3; ++m) {
    const Mat t = mat_of(g, m);
    st.src[m] = wb + moff[m];
    st.rows[m] = t.rows;
    st.K[m] = t.K;
  }
  st.n = g.depth + 3;
  return true;
}

template <typename T>
inline void fill_params(TcParamsOf<T>& prm, const float* wpack,
                        const int* offsets) {
  prm.w = wpack;
  for (int s = 0; s < kNumSlots; ++s) prm.off[s] = offsets[s];
}

// the params of a K6 launch on the operand pack wops, made with the mma
// depth of T; false if the shapes are not the kernels'
template <typename T>
bool tc_params(TcParamsOf<T>& prm, Geo& g, const float* wpack,
               const int* offsets, const void* wops, int P, int F, int V,
               int width, int depth, int skip) {
  g = make_geo(width, depth, skip, P, F, V, Operand<T>::kK);
  fill_params(prm, wpack, offsets);
  return forward_stream(prm.st, g, static_cast<const T*>(wops));
}

struct Moff {
  int m[kMats + 1];
};

// Element e of matrix t's operand pack, [rows][K]: its weight in the float32
// pack's [K1 + K2][rows] at src, transposed, zero in each part's padding
// columns. The pack kernels run one thread per element of the operand pack
// (its writes coalesced, its reads a column of the float32 weight, from L2).
__device__ __forceinline__ float packed_weight(const float* __restrict__ src,
                                               const Mat& t, int e) {
  const int o = e / t.K, c = e - o * t.K;
  const bool first = c < t.K1p;
  const int k = first ? c : c - t.K1p;
  const bool real = k < (first ? t.K1 : t.K2);
  return real ? __ldg(src + (first ? k : t.K1 + k) * t.rows + o) : 0.f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x8, row) * b (8x8, col), TF32 operands, float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small, both TF32: big = tf32(x), small = tf32(x - big), each
// rounded to nearest with ties away from zero, as cvt.rna.tf32.f32 rounds;
// the two keep ~22 bits of x's significand. The .tf32 operands of mma
// ignore the low 13 bits, so adding half of their place to the magnitude
// bits rounds: 4 integer and float instructions per element, where
// cvt.rna.tf32.f32 compiles to a longer sequence on sm_90a (PERF.md §6).
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& big,
                                           uint32_t& small) {
  big = x + 0x1000u;
  const float rest = __uint_as_float(x) - __uint_as_float(big & 0xffffe000u);
  small = __float_as_uint(rest) + 0x1000u;
}

// The weight stream: the producer cursor (matrix pm, column pk, slice pt)
// and the consumer's slice ct. Every fetch commits one cp.async group,
// empty once the stream has ended, so wait_group counts stay exact.
template <typename T>
struct RingOf {
  T* base;                             // kStages slots of [SR][kStride<T>]
  int pm, pk, pt, ct;
};
using Ring = RingOf<bf16>;

// Thread tid copies 16-byte chunk tid % 8 of rows tid / 8, tid / 8 + 32, ...
// of the slice (a slice row is 128 bytes, 8 chunks); a slice narrower than
// kCols<T> (the end of a matrix whose K is no multiple of it) leaves the
// chunks past its width unread. A slot holds SR rows.
template <int SR, typename T>
__device__ __forceinline__ void fetch(RingOf<T>& rg, const StreamOf<T>& st,
                                      int tid) {
  static_assert(kThreads % 8 == 0, "8 chunks of 16 bytes per slice row");
  constexpr int C = kPad<T>, S = kStride<T>;
  if (rg.pm < st.n) {
    const int rows = st.rows[rg.pm], K = st.K[rg.pm];
    const int q = tid & 7;
    if (C * q < K - rg.pk) {
      T* slot = rg.base + (rg.pt % kStages) * SR * S + C * q;
      const T* src = st.src[rg.pm] + rg.pk + C * q;
      for (int r = tid >> 3; r < rows; r += kThreads / 8)
        cp_async16(slot + r * S, src + static_cast<long long>(r) * K);
    }
    rg.pk += kCols<T>;
    if (rg.pk >= K) {
      rg.pk = 0;
      ++rg.pm;
    }
  }
  cp_async_commit();
  ++rg.pt;
}

// one mma step's fragments (k16 of bf16, k8 of float): A for the warp's 2
// m16 tiles, B for its NT n8 tiles (ldmatrix .x4 covers two n8 tiles, .x2 an
// odd last one). An 8x8 b16 matrix of ldmatrix is 8x4 32-bit elements, lane
// l getting (row l / 4, column l % 4): the A and B layouts of both mma.
template <int NT>
struct Frags {
  uint32_t a[2][4];
  uint32_t b[(NT + 1) / 2][4];
};

// A's columns k < K1 come from a1 (row stride lda1), the rest from a2 at
// k - K1; B [N][kStride<T>] is the ring slot, column kk the slice's
template <int NT, typename T>
__device__ __forceinline__ void load_frags(Frags<NT>& f, const T* a1,
                                           int lda1, int K1, const T* a2,
                                           int lda2, int k, const T* slot,
                                           int kk, int m0w, int n0w,
                                           int lane) {
  constexpr int C = kPad<T>, S = kStride<T>;
  const T* ap = k < K1 ? a1 + k : a2 + (k - K1);
  const int lda = k < K1 ? lda1 : lda2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    ldsm_x4(f.a[mt], ap + (m0w + mt * 16 + (lane & 15)) * lda +
                         (lane >> 4) * C);
#pragma unroll
  for (int np = 0; np < NT / 2; ++np)
    ldsm_x4(f.b[np], slot + (n0w + np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                S + kk + ((lane >> 3) & 1) * C);
  if constexpr (NT % 2 == 1) {
    uint32_t b[2];
    ldsm_x2(b, slot + (n0w + (NT - 1) * 8 + (lane & 7)) * S + kk +
                   ((lane >> 3) & 1) * C);
    f.b[NT / 2][0] = b[0];
    f.b[NT / 2][1] = b[1];
  }
}

// 3xTF32: every float32 operand split into big + small, and per output tile
// the small cross terms first, then big x big, into one float32 sum (small
// x small, ~2^-22 of the product, is dropped). The three terms of a tile
// depend on each other through the sum, so each runs over every tile before
// the next.
template <int NT>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[2][NT][4],
                                           const Frags<NT>& f) {
  uint32_t ab[2][4], as[2][4], bb[NT][2], bs[NT][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(f.a[mt][e], ab[mt][e], as[mt][e]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      split_tf32(f.b[j / 2][2 * (j % 2) + e], bb[j][e], bs[j][e]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      mma_tf32(acc[mt][j], as[mt], bb[j][0], bb[j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      mma_tf32(acc[mt][j], ab[mt], bs[j][0], bs[j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      mma_tf32(acc[mt][j], ab[mt], bb[j][0], bb[j][1]);
}

// bf16: one mma m16n8k16 per tile
template <int NT>
__device__ __forceinline__ void mma_bf16_frags(float (&acc)[2][NT][4],
                                               const Frags<NT>& f) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      mma_bf16(acc[mt][2 * np], f.a[mt], f.b[np][0], f.b[np][1]);
      mma_bf16(acc[mt][2 * np + 1], f.a[mt], f.b[np][2], f.b[np][3]);
    }
  if constexpr (NT % 2 == 1) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      mma_bf16(acc[mt][NT - 1], f.a[mt], f.b[NT / 2][0], f.b[NT / 2][1]);
  }
}

template <typename T, int NT>
__device__ __forceinline__ void mma_frags(float (&acc)[2][NT][4],
                                          const Frags<NT>& f) {
  if constexpr (std::is_same_v<T, float>)
    mma_3xtf32(acc, f);
  else
    mma_bf16_frags(acc, f);
}

// acc = A @ B^T for matrix m of the stream, B [N][K] from the ring, A as in
// load_frags. The warp's tile: rows m0w .. m0w + 31, columns n0w .. n0w +
// 8 NT - 1. Within a slice the next mma step's fragments load while this
// one's mma run.
template <int SR, int NT, typename T>
__device__ __forceinline__ void product(float (&acc)[2][NT][4],
                                        RingOf<T>& rg, const StreamOf<T>& st,
                                        int m, const T* a1, int lda1, int K1,
                                        const Same<T>* a2, int lda2, int m0w,
                                        int n0w, int tid) {
  constexpr int D = Operand<T>::kK, S = kStride<T>;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  const int K = st.K[m];
  const int lane = tid & 31;
  for (int k0 = 0; k0 < K; k0 += kCols<T>) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                   // slice ct landed; slot ct-1 is free
    fetch<SR>(rg, st, tid);
    const T* slot = rg.base + (rg.ct % kStages) * SR * S;
    ++rg.ct;
    const int steps = min(kCols<T>, K - k0) / D;
    Frags<NT> f[2];
    load_frags(f[0], a1, lda1, K1, a2, lda2, k0, slot, 0, m0w, n0w, lane);
#pragma unroll
    for (int s = 0; s < kCols<T> / D; ++s) {
      if (s >= steps) break;
      if (s + 1 < steps)
        load_frags(f[(s + 1) & 1], a1, lda1, K1, a2, lda2, k0 + D * (s + 1),
                   slot, D * (s + 1), m0w, n0w, lane);
      mma_frags<T>(acc, f[s & 1]);
    }
  }
}

// the block's rows of src [n][K] (contiguous in src), as operands of type T
// (bf16: rounded), into dst [kM][ld]; columns K .. Kp - 1 and rows past n
// are zero
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, int Kp,
                                          const float* __restrict__ src,
                                          int K, long long row0, long long n,
                                          int tid) {
#pragma unroll 4
  for (int e = tid; e < kM * Kp; e += kThreads) {
    const int r = e / Kp, k = e - r * Kp;
    const long long gr = row0 + r;
    const float v = k < K && gr < n ? __ldg(src + gr * K + k) : 0.f;
    dst[r * ld + k] = Operand<T>::of(v);
  }
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// The heads. Output column c of a point: rgb 0..2, alpha 3, the extras 4..
// (static: the blend; dynamic: 6 flow, 2 probability). Head o (alpha first,
// then the extras) writes column 3 + o; its weight for input k:
template <typename Prm>
__device__ __forceinline__ float head_weight(const Prm& prm, int n_extra,
                                             int o, int k) {
  const float* w = prm.w;
  if (o == 0) return __ldg(w + prm.off[kWa] + k);
  if (n_extra == 1) return __ldg(w + prm.off[kWx1] + k);
  if (o <= 6) return __ldg(w + prm.off[kWx1] + 6 * k + (o - 1));
  return __ldg(w + prm.off[kWx2] + 2 * k + (o - 7));
}

// output column c from its summed product v: bias and activation
template <typename Prm>
__device__ __forceinline__ float head_out(const Prm& prm, int n_extra, int c,
                                          float v) {
  const float* w = prm.w;
  if (c < 3) return v + w[prm.off[kBr] + c];
  if (c == 3) return v + w[prm.off[kBa]];
  if (n_extra == 1) return sigmoidf(v + w[prm.off[kBx1]]);
  if (c < 10) return tanhf(v + w[prm.off[kBx1] + c - 4]);
  return sigmoidf(v + w[prm.off[kBx2] + c - 10]);
}

// Partial head products of the thread's 4 rows over its 2 NT columns of x
// (an accumulator-shaped float32 tile), summed over the 4 lanes that share
// the rows, into red[wn][row][col0 + o] for o < NH; weight(o, k) gives the
// head weights. The 4 warps of a row band (wn) add up at the end.
template <int NT, int NH, typename Weight>
__device__ __forceinline__ void head_partials(const float (&x)[2][NT][4],
                                              Weight weight, float* red,
                                              int col0, int m0w, int n0w,
                                              int wn, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  float p[2][2][NH];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int o = 0; o < NH; ++o) p[mt][hf][o] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int k = n0w + 8 * j + 2 * tq + c;
#pragma unroll
      for (int o = 0; o < NH; ++o) {
        const float wv = weight(o, k);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            p[mt][hf][o] = fmaf(x[mt][j][2 * hf + c], wv, p[mt][hf][o]);
      }
    }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int o = 0; o < NH; ++o) {
        float v = p[mt][hf][o];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tq == 0)
          red[(wn * kM + m0w + 16 * mt + gq + 8 * hf) * kRed + col0 + o] = v;
      }
}

// What a forward tile hands on besides its output, at each thread's
// accumulator elements (row r of the block, columns col, col + 1): K6 keeps
// nothing (this type); K7 writes them to its scratch.
struct NoSave {
  // trunk layer i: z = h @ W_i + b_i, a = relu(z * cond), hb = a as stored
  // in h (Operand<T>::Pair)
  template <typename Pair>
  __device__ void trunk(int, int, int, float, float, float, float,
                        Pair) const {}
  template <typename Pair>
  __device__ void feature(int, int, Pair) const {}
  __device__ void hv(int, int, float, float) const {}
};

// The forward of the block's 64 points: cond (float32, left in registers),
// the trunk, the alpha and extra heads' partials into red, the feature and
// views layers (hv left in accv) and the rgb head's partials. The inputs are
// in xs / fs / vs (row strides PS / FS / VS); h is hs, its row stride W +
// kPad<T>. The caller has started the ring (kStages - 1 fetches) and waits
// for the partials with a __syncthreads.
template <int W, int SR, typename T, typename Save>
__device__ __forceinline__ void forward_tile(
    const TcParamsOf<T>& prm, const Geo& g, RingOf<T>& rg, T* hs, const T* xs,
    int PS, const T* fs, int FS, const T* vs, int VS, float* red,
    float (&cond)[2][W / 32][4], float (&accv)[2][W / 64][4], int n_extra,
    int tid, const Save& save) {
  using Pair = typename Operand<T>::Pair;
  constexpr int HS = W + kPad<T>;      // row stride of h
  constexpr int NT = W / 32;           // n8 tiles per warp, width-W products
  constexpr int NTV = NT / 2;          // the views layer's (width W / 2)
  const StreamOf<T>& st = prm.st;
  const float* w = prm.w;
  const int depth = g.depth, skip = g.skip;
  // the thread's accumulator elements acc[mt][j][e]: row m0w + 16 mt + gq +
  // 8 (e / 2), column n0w + 8 j + 2 tq + e % 2; the same in every width-W
  // layer, so cond stays in registers
  const int warp = tid / 32, lane = tid % 32;
  const int wn = warp >> 1, m0w = (warp & 1) * 32, gq = lane >> 2,
            tq = lane & 3;
  const int n0w = wn * (W / 4);
  float acc[2][NT][4];

  // conditioning: cond = feats @ Wb + bb, float32
  product<SR, NT>(cond, rg, st, 0, fs, FS, g.Fp, nullptr, 0, m0w, n0w, tid);
  {
    const float* b = w + prm.off[kBb];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(
          b + n0w + 8 * j + 2 * tq));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          cond[mt][j][2 * hf] += bb.x;
          cond[mt][j][2 * hf + 1] += bb.y;
        }
    }
  }

  // trunk: h = relu((h @ W_i + b_i) * cond), as T into h; the last layer's
  // float32 output stays in acc for the heads
  for (int i = 0; i < depth; ++i) {
    if (i == 0 || i == skip + 1)
      product<SR, NT>(acc, rg, st, 1 + i, xs, PS, g.Pp, hs, HS, m0w, n0w,
                      tid);
    else
      product<SR, NT>(acc, rg, st, 1 + i, hs, HS, W, nullptr, 0, m0w, n0w,
                      tid);
    __syncthreads();                   // every warp has read h
    const float* b = w + prm.off[kLayer0 + 2 * i + 1];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0w + 8 * j + 2 * tq;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b + col));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = m0w + 16 * mt + gq + 8 * hf;
          float* a = acc[mt][j] + 2 * hf;
          const float z0 = a[0] + bb.x, z1 = a[1] + bb.y;
          a[0] = fmaxf(z0 * cond[mt][j][2 * hf], 0.f);
          a[1] = fmaxf(z1 * cond[mt][j][2 * hf + 1], 0.f);
          const Pair hb = Operand<T>::pair(a[0], a[1]);
          *reinterpret_cast<Pair*>(hs + r * HS + col) = hb;
          save.trunk(i, r, col, z0, z1, a[0], a[1], hb);
        }
    }
  }

  // alpha and the extra heads from h_last (float32, in acc)
  if (n_extra == 1)
    head_partials<NT, 2>(
        acc, [&](int o, int k) { return head_weight(prm, 1, o, k); }, red, 3,
        m0w, n0w, wn, lane);
  else
    head_partials<NT, 9>(
        acc, [&](int o, int k) { return head_weight(prm, 2, o, k); }, red, 3,
        m0w, n0w, wn, lane);

  // feature layer (no activation), as T into h
  product<SR, NT>(acc, rg, st, depth + 1, hs, HS, W, nullptr, 0, m0w, n0w,
                  tid);
  __syncthreads();                     // every warp has read h
  {
    const float* b = w + prm.off[kBf];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0w + 8 * j + 2 * tq;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b + col));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = m0w + 16 * mt + gq + 8 * hf;
          const Pair fb = Operand<T>::pair(acc[mt][j][2 * hf] + bb.x,
                                           acc[mt][j][2 * hf + 1] + bb.y);
          *reinterpret_cast<Pair*>(hs + r * HS + col) = fb;
          save.feature(r, col, fb);
        }
    }
  }

  // views layer: hv = relu([feature, views] @ Wv + bv), float32 in accv,
  // then the rgb head's partials
  const int n0v = wn * (W / 8);
  product<SR, NTV>(accv, rg, st, depth + 2, hs, HS, W, vs, VS, m0w, n0v,
                   tid);
  {
    const float* b = w + prm.off[kBv];
#pragma unroll
    for (int j = 0; j < NTV; ++j) {
      const int col = n0v + 8 * j + 2 * tq;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b + col));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          accv[mt][j][2 * hf] = fmaxf(accv[mt][j][2 * hf] + bb.x, 0.f);
          accv[mt][j][2 * hf + 1] = fmaxf(accv[mt][j][2 * hf + 1] + bb.y, 0.f);
          save.hv(m0w + 16 * mt + gq + 8 * hf, col, accv[mt][j][2 * hf],
                  accv[mt][j][2 * hf + 1]);
        }
    }
  }
  const float* wr = w + prm.off[kWr];
  head_partials<NTV, 3>(
      accv, [&](int o, int k) { return __ldg(wr + 3 * k + o); }, red, 0, m0w,
      n0v, wn, lane);
}

// ---------------------------------------------------------------------------
// K7's heads' weight and bias gradients, float32 operands, for both
// tensor-core pass 2s (fused_mlp_tc_bwd.cu, fused_mlp_tc32_bwd.cu): dW[k][o]
// = sum_p x[p][k] g'[p][o] with x = h_last for the alpha and extra heads and
// x = hv for rgb, and db[o] = sum_p g'[p][o]. h_last is read as it is, or,
// where cond is given, rebuilt from z_last as relu(z_last * cond) with the
// forward's own multiply and max (the float32 scratch keeps z and cond).
// Thread k owns input column k (the block is W threads), reading x row by
// row (coalesced) over the block's kHeadSpan points, g' staged in shared
// memory; one atomic per weight and block into d_pack. NH: the alpha and
// extra heads (2 static, 9 dynamic).
constexpr int kHeadSpan = 64;
constexpr int kHeadTile = 64;

struct HeadSlots {
  int wa, wx1, wx2, wr, ba, bx1, bx2, br;
};

template <int NH>
__global__ void __launch_bounds__(256)
head_grads_kernel(const float* __restrict__ hlast,
                  const float* __restrict__ cond, const float* __restrict__ hv,
                  const float* __restrict__ gh, float* d_pack, HeadSlots hd,
                  long long K) {
  constexpr int out_ch = NH == 2 ? 5 : 12;
  __shared__ float gt[kHeadTile][out_ch];
  const int k = threadIdx.x, W = blockDim.x;
  const long long p0 = static_cast<long long>(blockIdx.x) * kHeadSpan;
  const long long p1 = p0 + kHeadSpan < K ? p0 + kHeadSpan : K;
  float acc[NH] = {}, accr[3] = {}, bsum = 0.f;
  for (long long pt = p0; pt < p1; pt += kHeadTile) {
    const int rows = static_cast<int>(p1 - pt < kHeadTile ? p1 - pt : kHeadTile);
    __syncthreads();                   // the last tile is read
    for (int e = k; e < rows * out_ch; e += W)
      gt[e / out_ch][e % out_ch] = gh[pt * out_ch + e];
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < rows; ++q) {
      const long long e = (pt + q) * W + k;
      const float x = cond == nullptr
                          ? hlast[e]
                          : fmaxf(__fmul_rn(hlast[e], cond[e]), 0.f);
#pragma unroll
      for (int o = 0; o < NH; ++o) acc[o] = fmaf(x, gt[q][3 + o], acc[o]);
      if (k < W / 2) {
        const float v = hv[(pt + q) * (W / 2) + k];
#pragma unroll
        for (int o = 0; o < 3; ++o) accr[o] = fmaf(v, gt[q][o], accr[o]);
      }
      if (k < out_ch) bsum += gt[q][k];
    }
  }
  atomicAdd(d_pack + hd.wa + k, acc[0]);
  if constexpr (NH == 2) {
    atomicAdd(d_pack + hd.wx1 + k, acc[1]);
  } else {
#pragma unroll
    for (int o = 0; o < 6; ++o) atomicAdd(d_pack + hd.wx1 + 6 * k + o, acc[1 + o]);
#pragma unroll
    for (int o = 0; o < 2; ++o) atomicAdd(d_pack + hd.wx2 + 2 * k + o, acc[7 + o]);
  }
  if (k < W / 2) {
#pragma unroll
    for (int o = 0; o < 3; ++o) atomicAdd(d_pack + hd.wr + 3 * k + o, accr[o]);
  }
  if (k < out_ch) {
    const int b = k < 3 ? hd.br + k : k == 3 ? hd.ba
                  : k < 10 || NH == 2 ? hd.bx1 + k - 4 : hd.bx2 + k - 10;
    atomicAdd(d_pack + b, bsum);
  }
}

// The heads' gradients over K points into d_pack (off: the float32 pack's
// offsets): hlast [K][W] is h_last, or z_last where cond [K][W] is given;
// hv [K][W / 2]; gh [K][out_ch] the heads' pre-activation gradients g'.
inline int head_grads(const float* hlast, const float* cond, const float* hv,
                      const float* gh, const int* off, float* d_pack,
                      long long K, int W, int n_extra, cudaStream_t st) {
  const HeadSlots hd{off[kWa], off[kWx1], off[kWx2], off[kWr],
                     off[kBa], off[kBx1], off[kBx2], off[kBr]};
  const unsigned int blocks =
      static_cast<unsigned int>((K + kHeadSpan - 1) / kHeadSpan);
  if (n_extra == 1)
    head_grads_kernel<2><<<blocks, W, 0, st>>>(hlast, cond, hv, gh, d_pack,
                                               hd, K);
  else
    head_grads_kernel<9><<<blocks, W, 0, st>>>(hlast, cond, hv, gh, d_pack,
                                               hd, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
