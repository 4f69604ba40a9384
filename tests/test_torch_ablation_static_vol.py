"""The static-volume ablation (``presets.SMALL_STATIC_VOL``: the static
field fused on its volume, 5 outputs; the dynamic field a plain MLP with no
conditioning; the scene-flow bundle, 24 + 8 rays) in zest_tpu_torch
against zest_tpu's on the CPU: the eval maps, ``validate``, the wander
path's maps, and the training step in both phases, with the helpers and
tolerances of ``test_torch_ablation_mvsnerf.py``.
"""
import pytest

# _few_threads: its module-scoped autouse fixture applies here too
from test_torch_ablation_mvsnerf import (Family, _few_threads, check_eval,
                                         check_grads, check_logs, check_path,
                                         check_updated, check_validate)

from zest_tpu_torch import presets
from zest_tpu_torch.render import EVAL_KEYS

@pytest.fixture(scope="module")
def static_vol():
    return Family(presets.SMALL_STATIC_VOL)


def test_static_vol_system_fuses_the_static_field_alone(static_vol):
    system = static_vol.system
    assert [n for n, _ in system.named_children()] == [
        "nerf_static", "nerf_dynamic", "enc_static"]
    assert system.nerf_static.use_mvs and system.nerf_static.out_ch == 5
    assert not system.nerf_dynamic.use_mvs
    assert "nb_imgs" not in static_vol.psample


def test_static_vol_eval_matches_zest_tpu(static_vol):
    check_eval(*static_vol.eval(), EVAL_KEYS)


def test_static_vol_validate_matches_zest_tpu(static_vol, tmp_path):
    check_validate(*static_vol.validate(tmp_path))


def test_static_vol_wander_path_matches_zest_tpu(static_vol):
    check_path(*static_vol.path(), EVAL_KEYS)


@pytest.mark.parametrize("step", [0, 2001])
def test_static_vol_train_step_matches_zest_tpu(static_vol, step):
    r = static_vol.step(step)
    check_logs(r)
    check_grads(r)
    check_updated(r)
