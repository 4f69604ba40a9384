"""The dynamic-volume ablation at precision 16 (``presets.SMALL_DY_VOL_16``:
the dynamic field's bf16-operand kernels' twin, bf16 encoder, the warped
lookups as a bf16 row gather; the static field a plain float32 MLP, as
zest_tpu keeps it) against zest_tpu's at ``precision=16`` on the CPU: the
eval maps and the step-0 training step, within twice zest_tpu's own 16- vs
32-bit difference, computed here (``test_torch_ablation_mvsnerf.py``'s
tolerances).
"""
import numpy as np
import pytest

# _few_threads: its module-scoped autouse fixture applies here too
from test_torch_ablation_mvsnerf import (Family, _few_threads,
                                         check_p16_eval, check_p16_step)

from zest_tpu_torch import presets
from zest_tpu_torch.render import EVAL_KEYS


@pytest.fixture(scope="module")
def dy_vol():
    return Family(presets.SMALL_DY_VOL)


@pytest.fixture(scope="module")
def dy_vol16(dy_vol):
    return Family(presets.SMALL_DY_VOL_16, dy_vol.params)


def test_dy_vol_p16_keeps_the_plain_field_float32(dy_vol16):
    system = dy_vol16.system
    assert system.bf16 and system.nerf_dynamic.bf16
    assert not system.nerf_static.bf16 and not system.nerf_static.use_mvs


def test_dy_vol_p16_eval_matches_zest_tpu(dy_vol, dy_vol16):
    ref16, out16 = dy_vol16.eval()
    ref32, out32 = dy_vol.eval()
    check_p16_eval(ref16, out16, ref32, EVAL_KEYS)
    assert float(np.abs(out16["rgb_map_ref"] - out32["rgb_map_ref"]).max()) > 0


def test_dy_vol_p16_train_step_matches_zest_tpu(dy_vol, dy_vol16):
    check_p16_step(dy_vol16.step(0), dy_vol.step(0))
