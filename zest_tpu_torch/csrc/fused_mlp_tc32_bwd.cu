// Fused NeRF field, backward (K7) in its float32 mode: pass 2, the weight
// gradients, on the tensor cores as 3xTF32.
//
// Replaces the weight-gradient sums of the TPU kernel
// zest_tpu/kernels/fused_mlp.py:_bwd_pallas (pallas_call at :398; _bwd_kernel
// adds every dW at :260) in its approx=False mode, exact float32
// (Precision.HIGHEST on the TPU). The TPU kernel carries the sums from one
// sequential grid step to the next; Hopper's blocks run in parallel, so pass
// 1 (fused_mlp.cu, SIMT) leaves each chunk's product inputs and output
// gradients in a scratch buffer, and this pass takes, for one chunk:
//
//   dWb = feats^T d_cond, dW_0 = pts^T dz_0 (and pts^T dz at layer skip+1),
//   dW_i = relu(z_{i-1} * cond)^T dz_i, dWf = h_last^T d_feature,
//   dWv = [feature, views]^T d_hv, and each bias gradient, the float32
//   column sum of its dz
//
// in ONE launch (wgrad_tc32_kernel), and the heads' weight gradients with
// float32 operands on the CUDA cores (head_grads_kernel, fused_mlp_tc.cuh),
// each adding into d_pack.
//
// The products: every operand is split in registers into big = tf32(x) and
// small = tf32(x - big) (split_tf32, fused_mlp_tc.cuh: the rounding of
// cvt.rna.tf32.f32 by integer add and mask), and per k8 step small x big,
// big x small, then big x big go into one float32 accumulator with mma.sync
// m16n8k8 TF32. That keeps ~22 bits of each operand, float32-class; one TF32
// product keeps ~11. The trunk's inputs relu(z_{i-1} * cond) are rebuilt in
// shared memory once the copy has landed, with pass 1's own multiply and
// max, so they equal the activations pass 1 differentiated at bit for bit.
//
// Layout: a block takes a 128 x 128 tile of one matrix's dW over a split of
// the chunk's points (split-K): 8 warps of 64 x 32 outputs (4 m16 x 4 n8
// tiles). Both operands lie [points][features] in the scratch, K = points,
// and stay so in a 2-stage cp.async ring of 64 points. ldmatrix .trans moves
// 16-bit elements only, so the TF32 fragments are 32-bit shared loads: lane
// l reads (k = l % 4, m = l / 4) of A and (k = l % 4, n = l / 4) of B, and a
// row stride of 136 floats (8 mod 32 words) puts the 32 reads in 32 distinct
// banks. The copy zero-fills rows past the split and columns past the
// matrix; rows of 16 unaligned bytes (pts, views: 63 and 27 floats) go by
// 4-byte copies. Each stage's mma sum is added into a second accumulator
// by FADD, and the tile into d_pack with float2 atomics, in an order that
// changes from run to run.
//
// What bounds it on an H100: the TF32 products, three per multiply-add: a
// flagship float32 training step's 569,344 points take ~0.69 TFLOP of
// float32 products, 4.2 ms of TF32 work at the 494.7 TFLOP/s dense peak;
// reading the operands once (~20 KB per point) takes ~3.4 ms at 3.35 TB/s.
// PERF.md §6 gives the measured time.
#include "fused_mlp_tc.cuh"

namespace {

constexpr int kTM = 128;               // tile rows (the layer's inputs)
constexpr int kTN = 128;               // tile columns (its outputs)
constexpr int kTK = 64;                // points per stage
constexpr int kRing = 2;               // stages
constexpr int kTS = kTM + 8;           // float row stride of a staged tile
constexpr int kStage = kTK * kTS;      // floats of one operand's stage
// A, the ReLU's second factor S (trunk and feature layers) and B
constexpr int kWgradSmem = 3 * kRing * kStage * 4;
constexpr int kTargetBlocks = 4 * 132;  // ~4 blocks per SM over a launch
static_assert(kTM == kTN, "A and B stages share one shape");
static_assert(kTS % 32 == 8, "conflict-free 32-bit fragment reads");

// One weight gradient: C [M][N] (at c_off in d_pack, row stride N) += X^T B
// over the points, X = a, or relu(a * s) where s is given (s has a's
// layout); a [points][lda] (M <= lda), b [points][ldb] (N <= ldb, rows of
// 16 bytes). b_off >= 0: the bias gradient, B's column sums, at b_off.
// avec: a's rows are 16-byte aligned. Its tiles are tile0 .. tile0 +
// tiles_m * tiles_n - 1 of the launch.
struct Job {
  const float* a;
  const float* s;
  const float* b;
  int lda, ldb, M, N, c_off, b_off, avec, tiles_n, tile0;
};

constexpr int kMaxJobs = kMaxLayers + 6;

struct Jobs {
  Job j[kMaxJobs];
  int n;
};

// 16 (4) bytes from src into shared dst, or zeros where bytes is 0 (src is
// then not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// One stage's products into acc: per k8 step of points, the warp's 4 m16 x
// 4 n8 tiles, small x big, big x small, then big x big, each over every
// tile. kAll: every tile holds outputs; else only i < mts and j < nts (the
// edge of a matrix), a branch per mma that the full tiles do without.
template <bool kAll>
__device__ __forceinline__ void stage_products(float (&acc)[4][4][4],
                                               const float* a_st,
                                               const float* b_st, int wm,
                                               int wn, int lane, int mts,
                                               int nts) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kTK; kk += 8) {
    uint32_t ab[4][4], as[4][4], bb[4][2], bs[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* p = a_st + (kk + tq) * kTS + 64 * wm + 16 * i + gq;
      const float v[4] = {p[0], p[8], p[4 * kTS], p[4 * kTS + 8]};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(__float_as_uint(v[e]), ab[i][e], as[i][e]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* p = b_st + (kk + tq) * kTS + 32 * wn + 8 * j + gq;
      split_tf32(__float_as_uint(p[0]), bb[j][0], bs[j][0]);
      split_tf32(__float_as_uint(p[4 * kTS]), bb[j][1], bs[j][1]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (kAll || (i < mts && j < nts))
          mma_tf32(acc[i][j], as[i], bb[j][0], bb[j][1]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (kAll || (i < mts && j < nts))
          mma_tf32(acc[i][j], ab[i], bs[j][0], bs[j][1]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (kAll || (i < mts && j < nts))
          mma_tf32(acc[i][j], ab[i], bb[j][0], bb[j][1]);
  }
}

// Block (tile, split): the tile's outputs over the points k0 .. k1 - 1.
__global__ void __launch_bounds__(256, 1)
wgrad_tc32_kernel(const __grid_constant__ Jobs jobs, float* d_pack,
                  long long K, long long split) {
  extern __shared__ __align__(16) float sm[];
  float* as = sm;
  float* ss = as + kRing * kStage;
  float* bs = ss + kRing * kStage;
  int jb = 0;
  while (jb + 1 < jobs.n && static_cast<int>(blockIdx.x) >= jobs.j[jb + 1].tile0)
    ++jb;
  const Job& jd = jobs.j[jb];
  const int t = blockIdx.x - jd.tile0;
  const int m0 = (t / jd.tiles_n) * kTM, n0 = (t % jd.tiles_n) * kTN;
  const long long k0 = blockIdx.y * split;
  const long long k1 = k0 + split < K ? k0 + split : K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp & 1, wn = warp >> 1, gq = lane >> 2, tq = lane & 3;
  const bool relu = jd.s != nullptr;
  const bool bias = jd.b_off >= 0 && m0 == 0;
  // the warp's m16 and n8 tiles that hold outputs (warp-uniform)
  const int rm = jd.M - m0 - 64 * wm, rn = jd.N - n0 - 32 * wn;
  const int mts = rm <= 0 ? 0 : rm >= 64 ? 4 : (rm + 15) / 16;
  const int nts = rn <= 0 ? 0 : rn >= 32 ? 4 : (rn + 7) / 8;

  // stage `stage` of the ring: the points kb .. kb + kTK - 1. Thread tid
  // copies the 16-byte chunk tid % 32 of rows tid / 32 + 8 q of each
  // operand, so its columns are the same in every stage
  static_assert(256 / (kTM / 4) == 8, "8 rows per pass of the block");
  const int ch = tid % (kTM / 4), row0 = tid / (kTM / 4);
  const int ca = m0 + 4 * ch, cb = n0 + 4 * ch;
  auto load = [&](int stage, long long kb) {
    const int at = stage * kStage + row0 * kTS + 4 * ch;
    const long long k = kb + row0;
    long long ea = k * jd.lda + ca, eb = k * jd.ldb + cb;
#pragma unroll
    for (int q = 0; q < kTK / 8; ++q) {
      const bool in = k + 8 * q < k1;
      const int o = at + 8 * q * kTS;
      if (jd.avec) {
        const bool ok = in && ca < jd.M;
        cp_async16_zfill(as + o, ok ? jd.a + ea : jd.a, ok ? 16 : 0);
        if (relu)
          cp_async16_zfill(ss + o, ok ? jd.s + ea : jd.s, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = in && ca + e < jd.M;
          cp_async4_zfill(as + o + e, ok ? jd.a + ea + e : jd.a, ok ? 4 : 0);
        }
      }
      const bool ok = in && cb < jd.N;
      cp_async16_zfill(bs + o, ok ? jd.b + eb : jd.b, ok ? 16 : 0);
      ea += 8 * jd.lda;
      eb += 8 * jd.ldb;
    }
  };

  float acc[4][4][4], sum[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = sum[i][j][e] = 0.f;
  float bsum = 0.f;                    // column tid % kTN, half tid / kTN

#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (k0 + s * kTK < k1) load(s, k0 + s * kTK);
    cp_async_commit();
  }
  int it = 0;
  for (long long kb = k0; kb < k1; kb += kTK, ++it) {
    cp_async_wait<kRing - 2>();
    __syncthreads();                   // stage it landed; stage it-1 is free
    const long long kn = kb + (kRing - 1) * kTK;
    if (kn < k1) load((it + kRing - 1) % kRing, kn);
    cp_async_commit();
    float* a_st = as + (it % kRing) * kStage;
    const float* b_st = bs + (it % kRing) * kStage;
    if (relu) {                        // A = relu(z * cond), as pass 1 forms it
      const float* s_st = ss + (it % kRing) * kStage;
      for (int c = tid; c < kTK * (kTM / 4); c += 256) {
        const int at = (c / (kTM / 4)) * kTS + 4 * (c % (kTM / 4));
        float4 v = *reinterpret_cast<float4*>(a_st + at);
        const float4 w = *reinterpret_cast<const float4*>(s_st + at);
        v.x = fmaxf(__fmul_rn(v.x, w.x), 0.f);
        v.y = fmaxf(__fmul_rn(v.y, w.y), 0.f);
        v.z = fmaxf(__fmul_rn(v.z, w.z), 0.f);
        v.w = fmaxf(__fmul_rn(v.w, w.w), 0.f);
        *reinterpret_cast<float4*>(a_st + at) = v;
      }
      __syncthreads();
    }
    if (bias) {
      const float* col = b_st + (tid / kTN) * (kTK / 2) * kTS + tid % kTN;
#pragma unroll
      for (int r = 0; r < kTK / 2; ++r) bsum += col[r * kTS];
    }
    // an mma's float32 sum drops low bits that FADD would round: chained
    // over a split's thousands of mma it moved the weight gradients ~3e-5
    // norm-wise from float64 (PERF.md §6), so each stage's sum (24 mma
    // deep) is added into sum by FADD
    if (mts == 4 && nts == 4)
      stage_products<true>(acc, a_st, b_st, wm, wn, lane, mts, nts);
    else
      stage_products<false>(acc, a_st, b_st, wm, wn, lane, mts, nts);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum[i][j][e] += acc[i][j][e];
          acc[i][j][e] = 0.f;
        }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int mm = m0 + 64 * wm + 16 * i + gq + 8 * hf;
        const int nn = n0 + 32 * wn + 8 * j + 2 * tq;
        if (mm < jd.M && nn < jd.N)
          atomicAdd(reinterpret_cast<float2*>(
                        d_pack + jd.c_off + static_cast<long long>(mm) * jd.N +
                        nn),
                    make_float2(sum[i][j][2 * hf], sum[i][j][2 * hf + 1]));
      }
  if (bias && n0 + tid % kTN < jd.N)
    atomicAdd(d_pack + jd.b_off + n0 + tid % kTN, bsum);
}

// The jobs of one chunk of n points. The scratch buffers are pass 1's
// (fused_mlp.cu, carve): cond, z [depth][n][W], the feature layer's output
// feat, dz [depth][n][W], d_cond, d_feature [n][W], d_hv [n][W / 2].
struct Operands {
  const float *pts, *feats, *views, *cond, *z, *feat, *dz, *dcond, *dfeat,
      *dhv;
};

// Returns the launch's tiles, or 0 if an operand that the kernel copies in
// 16-byte pieces (b, and a where s is given) has rows that are not 16-byte
// aligned.
int make_jobs(Jobs& jobs, const Operands& o, const int* off, long long n,
              int P, int F, int V, int W, int depth, int skip) {
  const long long rw = n * W;
  int tiles = 0;
  bool ok = true;
  jobs.n = 0;
  auto aligned = [](const float* p, int ld) {
    return ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  auto add = [&](const float* a, int lda, const float* s, const float* b,
                 int ldb, int M, int N, int c_off, int b_off) {
    const int tm = (M + kTM - 1) / kTM, tn = (N + kTN - 1) / kTN;
    const bool avec = aligned(a, lda);
    ok = ok && aligned(b, ldb) && (s == nullptr || (avec && aligned(s, lda)));
    jobs.j[jobs.n++] = Job{a, s, b, lda, ldb, M, N, c_off, b_off,
                           avec ? 1 : 0, tn, tiles};
    tiles += tm * tn;
  };
  add(o.feats, F, nullptr, o.dcond, W, F, W, off[kWb], off[kBb]);
  for (int i = 0; i < depth; ++i) {
    const int wo = off[kLayer0 + 2 * i], bo = off[kLayer0 + 2 * i + 1];
    const float* dz = o.dz + i * rw;
    if (i == 0) {
      add(o.pts, P, nullptr, dz, W, P, W, wo, bo);
    } else {
      int h_off = wo;
      if (i == skip + 1) {             // [pts, h] @ W: the pts rows first
        add(o.pts, P, nullptr, dz, W, P, W, wo, -1);
        h_off = wo + P * W;
      }
      add(o.z + (i - 1) * rw, W, o.cond, dz, W, W, W, h_off, bo);
    }
  }
  add(o.z + (depth - 1) * rw, W, o.cond, o.dfeat, W, W, W, off[kWf], off[kBf]);
  add(o.feat, W, nullptr, o.dhv, W / 2, W, W / 2, off[kWv], off[kBv]);
  add(o.views, V, nullptr, o.dhv, W / 2, V, W / 2, off[kWv] + W * (W / 2), -1);
  return ok ? tiles : 0;
}

}  // namespace

// K7 float32's pass 2 on one chunk of n points, after pass 1
// (zt_fused_nerf_backward) has left its scratch: pts [n][P], feats [n][F],
// views [n][V] are the chunk's inputs, cond .. gh its scratch buffers
// (zt_fused_nerf_backward_layout; hv [n][W / 2], gh [n][out_ch] the heads'
// pre-activation gradients). Every weight and bias gradient is added into
// d_pack (the float32 pack's layout; offsets: its table).
ZT_API int zt_fused_nerf_weight_grads_tc32(
    const float* pts, const float* feats, const float* views,
    const float* cond, const float* z, const float* feat, const float* hv,
    const float* dz, const float* dcond, const float* dfeat, const float* dhv,
    const float* gh, const int* offsets, float* d_pack, int n, int P, int F,
    int V, int width, int depth, int skip, int n_extra, void* stream) {
  if (depth < 1 || depth > kMaxLayers || n_extra < 1 || n_extra > 2 ||
      (width != 64 && width != 128 && width != 256))
    return cudaErrorInvalidValue;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t e = cudaFuncSetAttribute(
      wgrad_tc32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWgradSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Jobs jobs;
  const int tiles = make_jobs(
      jobs, Operands{pts, feats, views, cond, z, feat, dz, dcond, dfeat, dhv},
      offsets, n, P, F, V, width, depth, skip);
  if (tiles == 0) return cudaErrorInvalidValue;
  // about kTargetBlocks blocks, each split a multiple of the stage
  const long long K = n;
  const long long stages = (K + kTK - 1) / kTK;
  long long splits = kTargetBlocks / tiles;
  if (splits < 1) splits = 1;
  if (splits > stages) splits = stages;
  const long long split = ((K + splits - 1) / splits + kTK - 1) / kTK * kTK;
  splits = (K + split - 1) / split;
  auto st = static_cast<cudaStream_t>(stream);
  wgrad_tc32_kernel<<<dim3(tiles, static_cast<unsigned int>(splits)), 256,
                      kWgradSmem, st>>>(jobs, d_pack, K, split);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return head_grads(z + static_cast<long long>(depth - 1) * n * width, cond, hv,
                    gh, offsets, d_pack, K, width, n_extra, st);
}
