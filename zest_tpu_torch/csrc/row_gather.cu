// Row gather (K9) and its adjoint, the row scatter-add.
//
// Replaces the TPU kernel zest_tpu/kernels/dma_gather.py:_dma_gather_rows
// (pallas_call at :69, reached from take_rows): out[i] = tab[idx[i]] for a
// table of rows whose width is a multiple of 16 bytes. On the TPU the scalar
// core issues one async DMA per row and keeps a window of 16 in flight,
// because XLA's row gather there waits on each row in turn. A GPU gathers with
// plain loads: here one thread copies one 16-byte chunk of an output row
// (a bf16 row of 8 channels is one chunk, a float32 row two) with a uint4
// load and a uint4 store, and takes kChunks chunks kThreads apart, all loads
// issued before any store, so every thread keeps kChunks reads in flight and
// the SM's many resident warps cover the latency of the rest.
//
// The adjoint (the TPU package does it in XLA, dma_gather.py:107-111):
// acc[idx[i]] += g[i] in float32; the caller zeroes acc and rounds it to the
// table's type once. One thread adds one quad (4 consecutive values of a
// row: 8 bytes of bf16, 16 of float32) with one 16-byte vector atomic,
// Hopper's red.global.add.v4.f32, so a warp's 32 lanes cover 16 whole rows
// of 8 channels (one full 32-byte sector of acc each) per instruction, where
// one scalar atomic per value covered 32 rows a float at a time: 4x fewer
// atomic operations at L2 and 8x fewer instructions. A quad whose 4 values
// are zero adds nothing: on the main path a corner outside the volume
// carries a zero row onto a clamped edge row, and is skipped. Each thread
// loads its kQuads quads and their indices before its first atomic.
//
// What bounds both on an H100: bytes, at random rows. The gather reads the
// distinct rows the indices touch (each read is a 32-byte sector, of which a
// bf16 row uses 16), reads the indices and writes the output once; the
// scatter-add reads g and the indices and adds into the rows they touch. An
// index outside [0, m) reads nothing: its output row is zero and its
// gradient is dropped (the wrappers' callers clamp every index into range).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 4;       // chunks per thread

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const uint4* __restrict__ tab, const int* __restrict__ idx,
                  uint4* __restrict__ out, long long n_chunks, long long m,
                  int row_chunks) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kThreads * kChunks + threadIdx.x;
  uint4 v[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const long long c = base + static_cast<long long>(j) * kThreads;
    v[j] = make_uint4(0u, 0u, 0u, 0u);
    if (c < n_chunks) {
      const long long i = c / row_chunks;
      const long long r = __ldg(idx + i);
      if (r >= 0 && r < m) v[j] = __ldg(tab + r * row_chunks + (c - i * row_chunks));
    }
  }
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const long long c = base + static_cast<long long>(j) * kThreads;
    if (c < n_chunks) out[c] = v[j];
  }
}

// one quad of g as 4 floats: 4 bf16 (8 bytes) or 4 float32 (16 bytes), read
// once, so with the streaming hint
template <typename T>
struct Quad;

template <>
struct Quad<__nv_bfloat16> {
  using Raw = uint2;
  __device__ static float4 load(const Raw* p) {
    const uint2 u = __ldcs(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

template <>
struct Quad<float> {
  using Raw = float4;
  __device__ static float4 load(const Raw* p) { return __ldcs(p); }
};

constexpr int kQuads = 4;        // quads per thread of the scatter-add

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_scatter_add_kernel(const typename Quad<T>::Raw* __restrict__ g,
                       const int* __restrict__ idx, float4* __restrict__ acc,
                       long long n_quads, long long m, int row_quads) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kThreads * kQuads + threadIdx.x;
  long long dst[kQuads];
  float4 v[kQuads];
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const long long q = base + static_cast<long long>(j) * kThreads;
    dst[j] = -1;
    v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q < n_quads) {
      const long long i = q / row_quads;
      const long long r = __ldg(idx + i);
      v[j] = Quad<T>::load(g + q);
      if (r >= 0 && r < m) dst[j] = r * row_quads + (q - i * row_quads);
    }
  }
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const float4 u = v[j];
    if (dst[j] >= 0 && (u.x != 0.f || u.y != 0.f || u.z != 0.f || u.w != 0.f))
      atomicAdd(acc + dst[j], u);     // red.global.add.v4.f32 (sm_90)
  }
}

}  // namespace

// out [n][row_bytes] = tab [m][row_bytes] at rows idx [n]; row_bytes % 16 == 0
// and both tables 16-byte aligned
ZT_API int zt_row_gather(const void* tab, const int* idx, void* out, long long n,
                         long long m, int row_bytes, void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || n < 0 || m < 0)
    return cudaErrorInvalidValue;
  const int row_chunks = row_bytes / 16;
  const long long n_chunks = n * row_chunks;
  if (n_chunks > 0) {
    row_gather_kernel<<<zt::blocks_for(n_chunks, kThreads * kChunks), kThreads,
                        0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(tab), idx, static_cast<uint4*>(out),
        n_chunks, m, row_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// acc [m][cw] float32 += g [n][cw] at rows idx [n]; g holds bf16 (elem_bytes
// 2) or float32 (4) values, cw * elem_bytes % 16 == 0; acc is zeroed by the
// caller and 16-byte aligned
ZT_API int zt_row_scatter_add(const void* g, const int* idx, float* acc,
                              long long n, long long m, int cw, int elem_bytes,
                              void* stream) {
  if (cw <= 0 || (elem_bytes != 2 && elem_bytes != 4) ||
      (cw * elem_bytes) % 16 != 0 || n < 0 || m < 0)
    return cudaErrorInvalidValue;
  const int row_quads = cw / 4;
  const long long n_quads = n * row_quads;
  if (n_quads > 0) {
    const unsigned int blocks = zt::blocks_for(n_quads, kThreads * kQuads);
    auto st = static_cast<cudaStream_t>(stream);
    float4* acc4 = reinterpret_cast<float4*>(acc);
    if (elem_bytes == 2) {
      row_scatter_add_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
          static_cast<const uint2*>(g), idx, acc4, n_quads, m, row_quads);
    } else {
      row_scatter_add_kernel<float><<<blocks, kThreads, 0, st>>>(
          static_cast<const float4*>(g), idx, acc4, n_quads, m, row_quads);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
