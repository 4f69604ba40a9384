// The fused field's float32 weight pack: the slots of its offsets table
// (floats into the pack), shared by the tensor-core kernels
// fused_mlp_tc32.cu (K6 float32, K7 float32's recompute), fused_mlp_tc32_dx.cu
// and fused_mlp_tc32_bwd.cu (K7 float32's input and weight gradients),
// fused_mlp_tc.cu (K6 bf16) and fused_mlp_tc_bwd.cu (K7 bf16), which read
// weights, biases and heads from it. The Python wrapper
// (kernels/fused_mlp.py) fills the same slots.
#pragma once

namespace {

constexpr int kMaxLayers = 16;

enum Slot {
  kWb = 0, kBb = 1, kLayer0 = 2,               // layer i: W at 2+2i, b at 3+2i
  kWa = kLayer0 + 2 * kMaxLayers, kBa, kWf, kBf, kWv, kBv, kWr, kBr,
  kWx1, kBx1, kWx2, kBx2, kNumSlots
};

// A field's extra heads after rgb and alpha, n_extra: 0 none (the static
// field of a system without scene flow), 1 the blend (kWx1), 2 the 6 flow
// (kWx1) and 2 probability (kWx2) outputs. The output row is [rgb(3),
// alpha(1), extras], out_channels(n_extra) wide.
__host__ __device__ constexpr bool valid_extra(int n_extra) {
  return n_extra >= 0 && n_extra <= 2;
}
__host__ __device__ constexpr int out_channels(int n_extra) {
  return n_extra == 0 ? 4 : n_extra == 1 ? 5 : 12;
}

}  // namespace
