// Fused NeRF field, forward (K6), bf16-operand mode on the tensor cores.
//
// Replaces the TPU kernel zest_tpu/kernels/fused_mlp.py:_fwd_pallas
// (pallas_call at :376; its per-tile math is _forward_tile) in its
// approx=True mode, the port's precision 16. The float32 mode stays the SIMT
// kernel of fused_mlp.cu, and so does the backward (K7) in both modes.
//
// What it computes is the bf16 twin's field (models/nerf.py, _BF16Linear):
//   cond = feats @ Wb + bb                          (float32, kept float32)
//   h    = relu((h @ W_i + b_i) * cond)             i = 0 .. depth-1; the
//          layer after `skip` reads [pts, h] as one product over both parts
//   alpha = h @ Wa + ba;  static: sigmoid(h @ Ww + bw);
//          dynamic: tanh(h @ Ws + bs) (6), sigmoid(h @ Wp + bp) (2)
//   hv  = relu([h @ Wf + bf, views] @ Wv + bv)      (width / 2)
//   rgb = hv @ Wr + br
// The conditioning, trunk, feature and views products take bf16-rounded
// operands with float32 sums (mma.sync.m16n8k16 bf16 -> f32); biases, cond,
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
// the 989 TFLOP/s bf16 peak; this kernel takes ~32 ms (~157 TFLOP/s; PERF.md
// §6). Measured on the card, not the limit: the L2 weight stream (1.2 MB
// per field per 64 points, ~39 GB per chunk; a fourth ring slot changed
// nothing), the input loads at a block's start and the barrier before each
// epilogue (both removed in trials, no change). What is left is the
// mma.sync loop itself: two warps per scheduler (one block of 8 warps per
// SM, by registers and ~180 KB of shared memory) and 24 KB of ldmatrix
// reads per k16 step of the block. wgmma reads its operands from shared
// memory without ldmatrix; a wgmma version of this tile was measured
// slower (PERF.md §6), so the design for it is later work.
//
// In a training step at precision 16 the backward (K7, fused_mlp.cu) still
// recomputes this forward with its SIMT kernel, whose float32 sums run in
// another order. Where the two sums of an activation round to different
// bf16 values (or fall on either side of a ReLU), the gradient is taken at
// an activation one bf16 step away from the one the loss saw. Both are
// within the twin's tolerance of the bf16 field; a K7 on this tile (same
// pack, same sums) removes the mismatch.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "fused_mlp.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMats = kMaxLayers + 3;  // cond, trunk, feature, views

constexpr int kM = 64;                 // points per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKS = 64;                // K columns per weight slice
constexpr int kStages = 3;             // weight ring slots
constexpr int kSS = kKS + 8;           // bf16 row stride of a slot
constexpr int kRed = 12;               // output columns of the head partials
constexpr int kSmemLimit = 232448;

struct TcParams {
  const float* w;                      // float32 pack: biases and heads
  int off[kNumSlots];
  const bf16* wb;                      // bf16 pack, [out][K_pad] per matrix
  int moff[kMats + 1];                 // each matrix's offset, stream order
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

__host__ __device__ inline size_t smem_bytes(int W, int Pp, int Fp, int Vp) {
  return sizeof(float) * 4 * kM * kRed + sizeof(bf16) * kM * (W + 8) +
         sizeof(bf16) * kStages * W * kSS +
         sizeof(bf16) * kM * (Pp + Fp + Vp + 24);
}

// Matrix m of the stream (0 the conditioning, 1 .. depth the trunk, depth +
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

// each matrix's first element in the bf16 pack (back to back, stream
// order); moff[depth + 3] is the pack's length
inline void mat_offsets(const Geo& g, int (&moff)[kMats + 1]) {
  moff[0] = 0;
  for (int m = 0; m < g.depth + 3; ++m) {
    const Mat t = mat_of(g, m);
    moff[m + 1] = moff[m] + t.rows * t.K;
  }
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
  bf16* base;                          // kStages slots of [W][kSS]
  int pm, pk, pt, ct;
};

// Thread tid copies 16-byte chunk tid % 8 of rows tid / 8, tid / 8 + 32, ...
// of the slice (a slice row is kKS = 64 bf16, 8 chunks); a slice narrower
// than kKS (the end of a matrix whose K is no multiple of kKS) leaves the
// chunks past its width unread.
template <int W>
__device__ __forceinline__ void fetch(Ring& rg, const TcParams& prm,
                                      const Geo& g, int tid) {
  static_assert(kKS == 64 && kThreads % 8 == 0, "8 chunks of 8 bf16 per row");
  if (rg.pm < g.depth + 3) {
    const Mat t = mat_of(g, rg.pm);
    const int rows = t.rows, K = t.K;
    const int q = tid & 7;
    if (8 * q < K - rg.pk) {
      bf16* slot = rg.base + (rg.pt % kStages) * W * kSS + 8 * q;
      const bf16* src = prm.wb + prm.moff[rg.pm] + rg.pk + 8 * q;
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
template <int W, int NT>
__device__ __forceinline__ void product(float (&acc)[2][NT][4], Ring& rg,
                                        const TcParams& prm, const Geo& g,
                                        int m, const bf16* a1, int lda1,
                                        int K1, const bf16* a2, int lda2,
                                        int m0w, int n0w, int tid) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  const int K = mat_of(g, m).K;
  const int lane = tid & 31;
  for (int k0 = 0; k0 < K; k0 += kKS) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                   // slice ct landed; slot ct-1 is free
    fetch<W>(rg, prm, g, tid);
    const bf16* slot = rg.base + (rg.ct % kStages) * W * kSS;
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

template <int WIDTH>
__global__ void __launch_bounds__(kThreads, 1)
fused_nerf_tc_kernel(const float* __restrict__ pts,
                     const float* __restrict__ feats,
                     const float* __restrict__ views, TcParams prm,
                     float* __restrict__ out, long long n, int P, int F, int V,
                     int depth, int skip, int n_extra) {
  constexpr int W = WIDTH;
  constexpr int HS = W + 8;            // bf16 row stride of h
  constexpr int NT = W / 32;           // n8 tiles per warp, width-W products
  constexpr int NTV = NT / 2;          // the views layer's (width W / 2)
  const Geo g = make_geo(W, depth, skip, P, F, V);
  const int PS = g.Pp + 8, FS = g.Fp + 8, VS = g.Vp + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(red + 4 * kM * kRed);
  bf16* xs = hs + kM * HS + kStages * W * kSS;
  bf16* fs = xs + kM * PS;
  bf16* vs = fs + kM * FS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * kM;
  const float* w = prm.w;

  Ring rg{hs + kM * HS, 0, 0, 0, 0};
  for (int s = 0; s < kStages - 1; ++s) fetch<W>(rg, prm, g, tid);
  load_bf16(xs, PS, g.Pp, pts, P, row0, n, tid);
  load_bf16(fs, FS, g.Fp, feats, F, row0, n, tid);
  load_bf16(vs, VS, g.Vp, views, V, row0, n, tid);

  // the thread's accumulator elements acc[mt][j][e]: row m0w + 16 mt + gq +
  // 8 (e / 2), column n0w + 8 j + 2 tq + e % 2; the same in every width-W
  // layer, so cond stays in registers
  const int wn = warp >> 1, m0w = (warp & 1) * 32, gq = lane >> 2,
            tq = lane & 3;
  const int n0w = wn * (W / 4);
  float acc[2][NT][4], cond[2][NT][4];

  // conditioning: cond = feats @ Wb + bb, float32
  product<W, NT>(cond, rg, prm, g, 0, fs, FS, g.Fp, nullptr, 0, m0w, n0w, tid);
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
      product<W, NT>(acc, rg, prm, g, 1 + i, xs, PS, g.Pp, hs, HS, m0w, n0w,
                     tid);
    else
      product<W, NT>(acc, rg, prm, g, 1 + i, hs, HS, W, nullptr, 0, m0w, n0w,
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
          a[0] = fmaxf((a[0] + bb.x) * cond[mt][j][2 * hf], 0.f);
          a[1] = fmaxf((a[1] + bb.y) * cond[mt][j][2 * hf + 1], 0.f);
          *reinterpret_cast<__nv_bfloat162*>(hs + r * HS + col) =
              __floats2bfloat162_rn(a[0], a[1]);
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
  product<W, NT>(acc, rg, prm, g, depth + 1, hs, HS, W, nullptr, 0, m0w, n0w,
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
          *reinterpret_cast<__nv_bfloat162*>(hs + r * HS + col) =
              __floats2bfloat162_rn(acc[mt][j][2 * hf] + bb.x,
                                    acc[mt][j][2 * hf + 1] + bb.y);
        }
    }
  }

  // views layer: hv = relu([feature, views] @ Wv + bv), float32 in accv,
  // then the rgb head's partials
  const int n0v = wn * (W / 8);
  float accv[2][NTV][4];
  product<W, NTV>(accv, rg, prm, g, depth + 2, hs, HS, W, vs, VS, m0w, n0v,
                  tid);
  {
    const float* b = w + prm.off[kBv];
#pragma unroll
    for (int j = 0; j < NTV; ++j) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(
          b + n0v + 8 * j + 2 * tq));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          accv[mt][j][2 * hf] = fmaxf(accv[mt][j][2 * hf] + bb.x, 0.f);
          accv[mt][j][2 * hf + 1] = fmaxf(accv[mt][j][2 * hf + 1] + bb.y, 0.f);
        }
    }
  }
  const float* wr = w + prm.off[kWr];
  head_partials<NTV, 3>(
      accv, [&](int o, int k) { return __ldg(wr + 3 * k + o); }, red, 0, m0w,
      n0v, wn, lane);
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

// The bf16 pack from the float32 one: matrix blockIdx.y of the stream, its
// weight [K1 + K2][rows] in the float32 pack, transposed to [rows][K] and
// rounded to bf16, each part's padding columns zero. One thread per element
// of the bf16 pack (its writes coalesced, its reads a column of the float32
// weight, from L2).
__global__ void round_pack_tc_kernel(const float* __restrict__ w, TcParams prm,
                                     Geo g, bf16* __restrict__ wb) {
  const Mat t = mat_of(g, blockIdx.y);
  const float* src = w + prm.off[t.slot];
  bf16* dst = wb + prm.moff[blockIdx.y];
  const int len = t.rows * t.K;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < len;
       e += gridDim.x * blockDim.x) {
    const int o = e / t.K, c = e - o * t.K;
    const bool first = c < t.K1p;
    const int k = first ? c : c - t.K1p;
    const bool real = k < (first ? t.K1 : t.K2);
    dst[e] = __float2bfloat16_rn(
        real ? __ldg(src + (first ? k : t.K1 + k) * t.rows + o) : 0.f);
  }
}

// the slots and matrix offsets of a launch; false if the shapes are not the
// kernel's
bool tc_params(TcParams& prm, Geo& g, const float* wpack, const int* offsets,
               const void* wbf16, int P, int F, int V, int width, int depth,
               int skip) {
  if (depth < 1 || depth > kMaxLayers ||
      (width != 64 && width != 128 && width != 256))
    return false;
  g = make_geo(width, depth, skip, P, F, V);
  prm.w = wpack;
  for (int s = 0; s < kNumSlots; ++s) prm.off[s] = offsets[s];
  prm.wb = static_cast<const bf16*>(wbf16);
  mat_offsets(g, prm.moff);
  return true;
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
// pack (wpack / offsets: fused_mlp.cu's layout) into wbf16, which holds
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
  round_pack_tc_kernel<<<dim3(32, depth + 3), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      wpack, prm, g, static_cast<bf16*>(wbf16));
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
  if (n_extra < 1 || n_extra > 2 ||
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
