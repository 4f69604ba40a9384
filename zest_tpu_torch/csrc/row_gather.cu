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
// acc[idx[i]] += g[i] in float32 with atomicAdd, one thread per 16-byte chunk
// of g; the caller zeroes acc and rounds it to the table's type once.
//
// What bounds both on an H100: bytes, at random rows. The gather reads the
// distinct rows the indices touch (each read is a 32-byte sector, of which a
// bf16 row uses 16), reads the indices and writes the output once. An index
// outside [0, m) reads nothing: its output row is zero and its gradient is
// dropped (the wrappers' callers clamp every index into range).
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

// the float values of one 16-byte chunk: 8 bf16 or 4 float32
template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kVals = 8;
  __device__ static void unpack(const uint4& u, float (&f)[kVals]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 t = __bfloat1622float2(h[q]);
      f[2 * q] = t.x;
      f[2 * q + 1] = t.y;
    }
  }
};

template <>
struct Chunk<float> {
  static constexpr int kVals = 4;
  __device__ static void unpack(const uint4& u, float (&f)[kVals]) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_scatter_add_kernel(const uint4* __restrict__ g, const int* __restrict__ idx,
                       float* __restrict__ acc, long long n_chunks, long long m,
                       int row_chunks) {
  constexpr int kVals = Chunk<T>::kVals;
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= n_chunks) return;
  const long long i = c / row_chunks;
  const long long r = __ldg(idx + i);
  if (r < 0 || r >= m) return;
  float f[kVals];
  Chunk<T>::unpack(__ldg(g + c), f);
  float* dst = acc + (r * row_chunks + (c - i * row_chunks)) * kVals;
#pragma unroll
  for (int q = 0; q < kVals; ++q) atomicAdd(dst + q, f[q]);
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
// caller
ZT_API int zt_row_scatter_add(const void* g, const int* idx, float* acc,
                              long long n, long long m, int cw, int elem_bytes,
                              void* stream) {
  if (cw <= 0 || (elem_bytes != 2 && elem_bytes != 4) ||
      (cw * elem_bytes) % 16 != 0 || n < 0 || m < 0)
    return cudaErrorInvalidValue;
  const int row_chunks = cw * elem_bytes / 16;
  const long long n_chunks = n * row_chunks;
  if (n_chunks > 0) {
    const unsigned int blocks = zt::blocks_for(n_chunks, kThreads);
    auto st = static_cast<cudaStream_t>(stream);
    const uint4* g4 = static_cast<const uint4*>(g);
    if (elem_bytes == 2) {
      row_scatter_add_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
          g4, idx, acc, n_chunks, m, row_chunks);
    } else {
      row_scatter_add_kernel<float><<<blocks, kThreads, 0, st>>>(
          g4, idx, acc, n_chunks, m, row_chunks);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
