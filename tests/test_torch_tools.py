"""The port's profiling script: its interval and grouping arithmetic, and its
refusal to run without a CUDA device."""
import pytest
import torch

from zest_tpu_torch.tools import profile_eval


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
])
def test_kernel_groups(name, group):
    assert profile_eval.group_of(name) == group


def test_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_eval.main() == 2
