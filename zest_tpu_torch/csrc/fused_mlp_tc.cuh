// The fused field's tensor-core tile, shared by K6's bf16-operand mode
// (fused_mlp_tc.cu) and K7's (fused_mlp_tc_bwd.cu): the weight stream, the
// mma.sync products and the forward of a 64-point block. Both kernels run the
// same instruction sequence from this header, so K7's recompute of the
// forward gives K6's activations bit for bit. The design is described in
// fused_mlp_tc.cu's header note.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

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
constexpr int kKS = 64;                // K columns per weight slice
constexpr int kStages = 3;             // weight ring slots
constexpr int kSS = kKS + 8;           // bf16 row stride of a slot
constexpr int kRed = 12;               // output columns of the head partials
constexpr int kSmemLimit = 232448;

// The weight stream: every matrix a block multiplies by, in the order it
// runs them, each [rows][K] bf16, K-contiguous (the B layout of mma
// .row.col), K a multiple of 16
struct Stream {
  const bf16* src[kStreamMax];
  int rows[kStreamMax];
  int K[kStreamMax];
  int n;
};

struct TcParams {
  const float* w;                      // float32 pack: biases and heads
  int off[kNumSlots];
  Stream st;
};

__host__ __device__ inline int pad16(int k) { return (k + 15) / 16 * 16; }

// shapes of the field, and P, F, V padded to multiples of 16
struct Geo {
  int W, depth, skip, P, F, V, Pp, Fp, Vp;
};

__host__ __device__ inline Geo make_geo(int W, int depth, int skip, int P,
                                        int F, int V) {
  return Geo{W, depth, skip, P, F, V, pad16(P), pad16(F), pad16(V)};
}

// Matrix m of the forward (0 the conditioning, 1 .. depth the trunk, depth +
// 1 the feature layer, depth + 2 the views layer): its rows (outputs), its
// weight's slot in the float32 pack, and its K as one or two parts, each zero
// padded to a multiple of 16 on its own: K1 real columns of K1p, then K2
// (the skip layer's [pts, h], the views layer's [feature, views]); K is the
// padded whole, the row stride of the matrix in the bf16 pack.
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

// each forward matrix's first element in the bf16 pack (back to back,
// stream order); moff[depth + 3] is the pack's length
inline void mat_offsets(const Geo& g, int (&moff)[kMats + 1]) {
  moff[0] = 0;
  for (int m = 0; m < g.depth + 3; ++m) {
    const Mat t = mat_of(g, m);
    moff[m + 1] = moff[m] + t.rows * t.K;
  }
}

// the forward's matrices as the first depth + 3 of a stream, from the bf16
// pack wb; false if the shapes are not the kernels'
inline bool forward_stream(Stream& st, const Geo& g, const bf16* wb) {
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

inline void fill_params(TcParams& prm, const float* wpack, const int* offsets) {
  prm.w = wpack;
  for (int s = 0; s < kNumSlots; ++s) prm.off[s] = offsets[s];
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
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

// The weight stream: the producer cursor (matrix pm, column pk, slice pt)
// and the consumer's slice ct. Every fetch commits one cp.async group,
// empty once the stream has ended, so wait_group counts stay exact.
struct Ring {
  bf16* base;                          // kStages slots of [SR][kSS]
  int pm, pk, pt, ct;
};

// Thread tid copies 16-byte chunk tid % 8 of rows tid / 8, tid / 8 + 32, ...
// of the slice (a slice row is kKS = 64 bf16, 8 chunks); a slice narrower
// than kKS (the end of a matrix whose K is no multiple of kKS) leaves the
// chunks past its width unread. A slot holds SR rows.
template <int SR>
__device__ __forceinline__ void fetch(Ring& rg, const Stream& st, int tid) {
  static_assert(kKS == 64 && kThreads % 8 == 0, "8 chunks of 8 bf16 per row");
  if (rg.pm < st.n) {
    const int rows = st.rows[rg.pm], K = st.K[rg.pm];
    const int q = tid & 7;
    if (8 * q < K - rg.pk) {
      bf16* slot = rg.base + (rg.pt % kStages) * SR * kSS + 8 * q;
      const bf16* src = st.src[rg.pm] + rg.pk + 8 * q;
      for (int r = tid >> 3; r < rows; r += kThreads / 8)
        cp_async16(slot + r * kSS, src + static_cast<long long>(r) * K);
    }
    rg.pk += kKS;
    if (rg.pk >= K) {
      rg.pk = 0;
      ++rg.pm;
    }
  }
  cp_async_commit();
  ++rg.pt;
}

// one k16 step's fragments: A for the warp's 2 m16 tiles, B for its NT n8
// tiles (ldmatrix .x4 covers two n8 tiles, .x2 an odd last one)
template <int NT>
struct Frags {
  uint32_t a[2][4];
  uint32_t b[(NT + 1) / 2][4];
};

// A's columns k < K1 come from a1 (row stride lda1), the rest from a2 at
// k - K1; B [N][kSS] is the ring slot, column kk the slice's
template <int NT>
__device__ __forceinline__ void load_frags(Frags<NT>& f, const bf16* a1,
                                           int lda1, int K1, const bf16* a2,
                                           int lda2, int k, const bf16* slot,
                                           int kk, int m0w, int n0w,
                                           int lane) {
  const bf16* ap = k < K1 ? a1 + k : a2 + (k - K1);
  const int lda = k < K1 ? lda1 : lda2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    ldsm_x4(f.a[mt], ap + (m0w + mt * 16 + (lane & 15)) * lda +
                         (lane >> 4) * 8);
#pragma unroll
  for (int np = 0; np < NT / 2; ++np)
    ldsm_x4(f.b[np], slot + (n0w + np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                kSS + kk + ((lane >> 3) & 1) * 8);
  if constexpr (NT % 2 == 1) {
    uint32_t b[2];
    ldsm_x2(b, slot + (n0w + (NT - 1) * 8 + (lane & 7)) * kSS + kk +
                   ((lane >> 3) & 1) * 8);
    f.b[NT / 2][0] = b[0];
    f.b[NT / 2][1] = b[1];
  }
}

template <int NT>
__device__ __forceinline__ void mma_frags(float (&acc)[2][NT][4],
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

// acc = A @ B^T for matrix m of the stream, B [N][K] from the ring, A as in
// load_frags. The warp's tile: rows m0w .. m0w + 31, columns n0w .. n0w +
// 8 NT - 1. Within a slice the next k16 step's fragments load while this
// one's mma run.
template <int SR, int NT>
__device__ __forceinline__ void product(float (&acc)[2][NT][4], Ring& rg,
                                        const Stream& st, int m,
                                        const bf16* a1, int lda1, int K1,
                                        const bf16* a2, int lda2, int m0w,
                                        int n0w, int tid) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  const int K = st.K[m];
  const int lane = tid & 31;
  for (int k0 = 0; k0 < K; k0 += kKS) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                   // slice ct landed; slot ct-1 is free
    fetch<SR>(rg, st, tid);
    const bf16* slot = rg.base + (rg.ct % kStages) * SR * kSS;
    ++rg.ct;
    const int steps = min(kKS, K - k0) / 16;
    Frags<NT> f[2];
    load_frags(f[0], a1, lda1, K1, a2, lda2, k0, slot, 0, m0w, n0w, lane);
#pragma unroll
    for (int s = 0; s < kKS / 16; ++s) {
      if (s >= steps) break;
      if (s + 1 < steps)
        load_frags(f[(s + 1) & 1], a1, lda1, K1, a2, lda2, k0 + 16 * (s + 1),
                   slot, 16 * (s + 1), m0w, n0w, lane);
      mma_frags(acc, f[s & 1]);
    }
  }
}

// the block's rows of src [n][K] (contiguous in src), rounded to bf16, into
// dst [kM][ld]; columns K .. Kp - 1 and rows past n are zero
__device__ __forceinline__ void load_bf16(bf16* dst, int ld, int Kp,
                                          const float* __restrict__ src,
                                          int K, long long row0, long long n,
                                          int tid) {
#pragma unroll 4
  for (int e = tid; e < kM * Kp; e += kThreads) {
    const int r = e / Kp, k = e - r * Kp;
    const long long gr = row0 + r;
    const float v = k < K && gr < n ? __ldg(src + gr * K + k) : 0.f;
    dst[r * ld + k] = __float2bfloat16_rn(v);
  }
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// The heads. Output column c of a point: rgb 0..2, alpha 3, the extras 4..
// (static: the blend; dynamic: 6 flow, 2 probability). Head o (alpha first,
// then the extras) writes column 3 + o; its weight for input k:
__device__ __forceinline__ float head_weight(const TcParams& prm, int n_extra,
                                             int o, int k) {
  const float* w = prm.w;
  if (o == 0) return __ldg(w + prm.off[kWa] + k);
  if (n_extra == 1) return __ldg(w + prm.off[kWx1] + k);
  if (o <= 6) return __ldg(w + prm.off[kWx1] + 6 * k + (o - 1));
  return __ldg(w + prm.off[kWx2] + 2 * k + (o - 7));
}

// output column c from its summed product v: bias and activation
__device__ __forceinline__ float head_out(const TcParams& prm, int n_extra,
                                          int c, float v) {
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
  // trunk layer i: z = h @ W_i + b_i, a = relu(z * cond), hb = a in bf16
  __device__ void trunk(int, int, int, float, float, float, float,
                        __nv_bfloat162) const {}
  __device__ void feature(int, int, __nv_bfloat162) const {}
  __device__ void hv(int, int, float, float) const {}
};

// The forward of the block's 64 points: cond (float32, left in registers),
// the trunk, the alpha and extra heads' partials into red, the feature and
// views layers (hv left in accv) and the rgb head's partials. The inputs are
// in xs / fs / vs (row strides PS / FS / VS); h is hs. The caller has
// started the ring (kStages - 1 fetches) and waits for the partials with a
// __syncthreads.
template <int W, int SR, typename Save>
__device__ __forceinline__ void forward_tile(
    const TcParams& prm, const Geo& g, Ring& rg, bf16* hs, const bf16* xs,
    int PS, const bf16* fs, int FS, const bf16* vs, int VS, float* red,
    float (&cond)[2][W / 32][4], float (&accv)[2][W / 64][4], int n_extra,
    int tid, const Save& save) {
  constexpr int HS = W + 8;            // bf16 row stride of h
  constexpr int NT = W / 32;           // n8 tiles per warp, width-W products
  constexpr int NTV = NT / 2;          // the views layer's (width W / 2)
  const Stream& st = prm.st;
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

  // trunk: h = relu((h @ W_i + b_i) * cond), bf16 into h; the last layer's
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
          const __nv_bfloat162 hb = __floats2bfloat162_rn(a[0], a[1]);
          *reinterpret_cast<__nv_bfloat162*>(hs + r * HS + col) = hb;
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

  // feature layer (no activation), bf16 into h
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
          const __nv_bfloat162 fb = __floats2bfloat162_rn(
              acc[mt][j][2 * hf] + bb.x, acc[mt][j][2 * hf + 1] + bb.y);
          *reinterpret_cast<__nv_bfloat162*>(hs + r * HS + col) = fb;
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

}  // namespace
