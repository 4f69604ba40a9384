"""The port's profiling scripts and its quality gate: their interval and
grouping arithmetic, their refusal to run without a CUDA device, and their
--precision flag."""
import pytest
import torch

from zest_tpu_torch.tools import (probe_wgrad, profile_eval, profile_train,
                                  quality_gate)


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 12), (20, 25)], 17.0),       # overlap, then a gap
    ([(20, 25), (0, 10), (2, 3)], 15.0),        # unsorted, nested
])
def test_busy_union(intervals, busy):
    assert profile_eval.busy_union_us(intervals) == busy


@pytest.mark.parametrize("name,group", [
    ("void fused_nerf_kernel<256>(float const*)", "K6 fused field"),
    ("trilinear_sample_kernel", "K3 volume lookup"),
    ("color_gather_kernel", "K8 color gather"),
    ("plane_sweep_warp_kernel", "K1 warp"),
    ("sm90_xmma_fprop_implicit_gemm_cudnn", "cuDNN conv / deconv + batch norm"),
    ("sm90_xmma_dgrad_implicit_gemm_f32f32", "cuDNN conv / deconv + batch norm"),
    ("ampere_sgemm_128x64_nn", "cuBLAS gemm"),
    ("void at::native::CatArrayBatchedCopy<float>", "torch.cat copies"),
    ("void at::native::scatter_gather_elementwise_kernel",
     profile_eval.OTHER),
    ("(anonymous namespace)::round_pack_tc_kernel(float const*, TcParams)",
     "K6 bf16 weight pack"),
    ("(anonymous namespace)::pack_tc32_kernel(float const*, "
     "TcParamsOf<float>)", "K6 float32 weight pack"),
])
def test_kernel_groups(name, group):
    assert profile_eval.group_of(name) == group


def test_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_eval.main() == 2


@pytest.mark.parametrize("name,group", [
    ("void row_gather_kernel(uint4 const*, int const*)", "K9 row gather"),
    ("void row_scatter_add_kernel<__nv_bfloat16>(uint4 const*)",
     "K9 row gather backward (scatter-add)"),
    ("round_pack_kernel(float*, RParts)", "K6 / K7 bf16 weight rounding"),
    ("(anonymous namespace)::round_pack_tc_kernel(float const*, TcParams)",
     "K6 / K7 bf16 weight rounding"),
    ("void fused_nerf_bwd_kernel<256, true>(float const*)",
     "K7 field backward, pass 1"),
    ("void fused_nerf_kernel<256, true>(float const*)", "K6 fused field"),
    ("void (anonymous namespace)::fused_nerf_bwd_tc_kernel<256>(float const*)",
     "K7 field backward, pass 1"),
    ("(anonymous namespace)::wgrad_tc_kernel(WJobs, float*, long long)",
     "K7 field backward, pass 2 (weights)"),
    ("(anonymous namespace)::wgrad_tc32_kernel(Jobs, float*, long long, "
     "long long)", "K7 field backward, pass 2 (weights)"),
    ("void (anonymous namespace)::head_grads_kernel<9>(float const*)",
     "K7 field backward, pass 2 (weights)"),
    ("(anonymous namespace)::round_pack_bwd_tc_kernel(float const*, BwdPack)",
     "K6 / K7 bf16 weight rounding"),
    ("(anonymous namespace)::pack_tc32_kernel(float const*, "
     "TcParamsOf<float>)", "K6 float32 weight pack"),
])
def test_train_kernel_groups(name, group):
    assert profile_eval.group_of(name, profile_train.GROUPS) == group


@pytest.mark.parametrize("tool", [profile_eval, profile_train, quality_gate])
def test_tools_refuse_without_cuda_at_either_precision(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["--precision", "16"]) == 2
    assert tool.main() == 2


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::fused_nerf_tc_kernel<256>(float const*)",
    "void (anonymous namespace)::fused_nerf_tc32_kernel<256>(float const*)"])
@pytest.mark.parametrize("groups", [profile_eval.GROUPS, profile_train.GROUPS])
def test_tensor_core_field_kernel_is_k6(groups, name):
    assert profile_eval.group_of(name, groups) == "K6 fused field"



def test_probe_wgrad_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_wgrad.main() == 2
    assert probe_wgrad.main(["--points", "1000"]) == 2
