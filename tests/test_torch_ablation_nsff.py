"""NSFF without volumes (``presets.SMALL_NSFF``: both fields plain MLPs with
no conditioning, the scene-flow bundle, 24 + 8 rays, pad 0) in
zest_tpu_torch against zest_tpu's on the CPU: the eval maps, ``validate``,
the wander path's maps, and the training step in both phases (step 0: the
motion-mask rays; step 2001: the chain pass), with the helpers and
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
def nsff():
    return Family(presets.SMALL_NSFF)


def test_nsff_system_has_two_plain_fields(nsff):
    system = nsff.system
    assert [n for n, _ in system.named_children()] == ["nerf_static",
                                                       "nerf_dynamic"]
    for field in (system.nerf_static, system.nerf_dynamic):
        assert not field.use_mvs and not field.bf16
        assert not hasattr(field, "pts_bias")
    assert (system.nerf_static.out_ch, system.nerf_dynamic.out_ch) == (5, 12)
    assert set(nsff.tparams) == set(system.state_dict())
    assert "nb_imgs" not in nsff.psample
    assert nsff.batch["images"].shape[0] == 1


def test_nsff_eval_matches_zest_tpu(nsff):
    check_eval(*nsff.eval(), EVAL_KEYS)


def test_nsff_validate_matches_zest_tpu(nsff, tmp_path):
    check_validate(*nsff.validate(tmp_path))


def test_nsff_wander_path_matches_zest_tpu(nsff):
    # no keyframes and no neighbours: every reference is the target camera,
    # which the path moves, so the maps are the same from each pose
    check_path(*nsff.path(), EVAL_KEYS, moves=False)


@pytest.mark.parametrize("step", [0, 2001])
def test_nsff_train_step_matches_zest_tpu(nsff, step):
    r = nsff.step(step)
    check_logs(r)
    check_grads(r)
    check_updated(r)
