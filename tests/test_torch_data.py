"""zest_tpu_torch's own config and synthetic scene against zest_tpu's.

The port carries these host-side modules itself so that it never imports the
JAX package; here they are held to the originals. The scene is compared
exactly (same NumPy operations on the same numbers), key by key, on every key
the eval step reads.
"""
import dataclasses

import numpy as np
import pytest

from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset

from zest_tpu_torch import SyntheticDataset, ZestConfig, presets


def test_config_fields_and_defaults_match_zest_tpu():
    ref = {f.name: f.default for f in dataclasses.fields(JZestConfig)}
    for f in dataclasses.fields(ZestConfig):
        assert f.name in ref, f.name
        assert f.default == ref[f.name], f.name


@pytest.mark.parametrize("preset", [presets.SMALL, presets.FLAGSHIP,
                                    dict(train_sceneflow=False, num_input=5)])
def test_config_derived_widths_match_zest_tpu(preset):
    cfg, ref = ZestConfig(**preset), JZestConfig(**preset)
    assert (cfg.feat_dim, cfg.feat_dim_dy) == (ref.feat_dim, ref.feat_dim_dy)
    for k, v in preset.items():
        assert getattr(cfg, k) == getattr(ref, k) == v, k


@pytest.mark.parametrize("scene,frame", [
    (presets.SMALL_SCENE, presets.TARGET_FRAME),
    (presets.SMALL_SCENE, 0),                      # neighbours clamp at 0
    (dict(img_h=24, img_w=40, num_keyframes=4), 9),  # derived frame count
    (presets.FLAGSHIP_SCENE, presets.TARGET_FRAME),
])
def test_synthetic_scene_matches_zest_tpu(scene, frame):
    out = SyntheticDataset(**scene)[frame]
    ref = JSyntheticDataset(**scene, use_mvs=True, use_mvs_dy=True)[frame]
    assert len(SyntheticDataset(**scene)) == len(JSyntheticDataset(**scene))
    for k, v in out.items():
        assert v.dtype == ref[k].dtype and v.shape == ref[k].shape, k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
