"""The dynamic-volume ablation (``presets.SMALL_DY_VOL``: the static field a
plain MLP with no conditioning; the dynamic field fused on its volume, 12
outputs; the scene-flow bundle, 24 + 8 rays) in zest_tpu_torch against
zest_tpu's on the CPU: the eval maps, ``validate``, the wander path's maps,
and the training step in both phases, with the helpers and tolerances of
``test_torch_ablation_mvsnerf.py``. Precision 16:
``test_torch_ablation_dy_vol16.py``.
"""
import pytest

# _few_threads: its module-scoped autouse fixture applies here too
from test_torch_ablation_mvsnerf import (Family, _few_threads, check_eval,
                                         check_grads, check_logs, check_path,
                                         check_updated, check_validate)

from zest_tpu_torch import presets
from zest_tpu_torch.render import EVAL_KEYS


@pytest.fixture(scope="module")
def dy_vol():
    return Family(presets.SMALL_DY_VOL)


def test_dy_vol_system_fuses_the_dynamic_field_alone(dy_vol):
    system = dy_vol.system
    assert [n for n, _ in system.named_children()] == [
        "nerf_static", "nerf_dynamic", "enc_dy"]
    assert not system.nerf_static.use_mvs
    assert system.nerf_dynamic.use_mvs and system.nerf_dynamic.out_ch == 12
    assert dy_vol.batch["images"].shape[0] == 1 and "nb_imgs" in dy_vol.batch


def test_dy_vol_eval_matches_zest_tpu(dy_vol):
    check_eval(*dy_vol.eval(), EVAL_KEYS)


def test_dy_vol_validate_matches_zest_tpu(dy_vol, tmp_path):
    check_validate(*dy_vol.validate(tmp_path))


def test_dy_vol_wander_path_matches_zest_tpu(dy_vol):
    check_path(*dy_vol.path(), EVAL_KEYS)


@pytest.mark.parametrize("step", [0, 2001])
def test_dy_vol_train_step_matches_zest_tpu(dy_vol, step):
    r = dy_vol.step(step)
    check_logs(r)
    check_grads(r)
    check_updated(r)
