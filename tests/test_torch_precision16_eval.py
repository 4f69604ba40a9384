"""The full-image eval step of zest_tpu_torch at 16-bit precision
(``presets.SMALL_16``) against zest_tpu's at ``precision=16`` on the CPU,
with the same weights (both fields' alpha bias raised by 1) and the same
numpy sample; and the 16-bit presets.

Tolerance: twice zest_tpu's own difference between its 16- and 32-bit eval
of the same map (``SPREAD``, measured once and rounded up to two digits, so
this file compiles zest_tpu's eval only at 16 bits), plus 1e-5: both
packages round the encoders, the volumes and the images to bf16, but at
other places. The port's 16-bit maps differ from its 32-bit ones: the bf16
path is taken.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from zest_tpu.system import ZestSystem as JZestSystem

from zest_tpu_torch import ZestConfig, presets
from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.system import EVAL_KEYS, ZestSystem, to_batch

# zest_tpu's max |16-bit - 32-bit| of each eval map at this file's inputs
SPREAD = dict(rgb_map=1.6e-04, depth_map=6.3e-04, rgb_map_ref=1.4e-04,
              depth_map_ref=4.4e-04, rgb_map_ref_dy=1.7e-04,
              depth_map_ref_dy=1.1e-03, weights_map_dd=3.1e-04)


def test_p16_eval_step_matches_zest_tpu():
    sample = JSyntheticDataset(**presets.SMALL_SCENE)[presets.TARGET_FRAME]
    jbatch = {k: jnp.asarray(v) for k, v in sample.items()}
    jsys = JZestSystem(JZestConfig(**presets.SMALL_16))
    params = jax.tree.map(np.asarray, jax.jit(jsys.init_params)(
        jax.random.PRNGKey(0), jbatch))
    for field in ("nerf_static", "nerf_dynamic"):
        alpha = params[field]["params"]["alpha_linear"]
        alpha["bias"] = alpha["bias"] + 1.0
    ref = jsys.make_eval_step()(params, jbatch)
    tparams, batch = from_jax_params(params), to_batch(sample, "cpu")
    out = ZestSystem(ZestConfig(**presets.SMALL_16)).make_eval_step()(
        tparams, batch)
    out32 = ZestSystem(ZestConfig(**presets.SMALL)).make_eval_step()(
        tparams, batch)
    assert set(out) == set(EVAL_KEYS) == set(ref) == set(SPREAD)
    for k in EVAL_KEYS:
        r = np.asarray(ref[k])
        assert out[k].shape == r.shape and r.shape[:2] == (32, 64), k
        err = float(np.abs(out[k].numpy() - r).max())
        assert err <= 2 * SPREAD[k] + 1e-5, (k, err)
        assert float((out[k] - out32[k]).abs().max()) > 0.0, k
    assert float(np.std(np.asarray(ref["rgb_map_ref"]))) > 1e-3


@pytest.mark.parametrize("name,base", [("SMALL_16", "SMALL"),
                                       ("SMALL_TRAIN_16", "SMALL_TRAIN"),
                                       ("FLAGSHIP_16", "FLAGSHIP"),
                                       ("FLAGSHIP_TRAIN_16", "FLAGSHIP_TRAIN")])
def test_p16_presets_are_the_float32_ones_at_16_bits(name, base):
    p16, p32 = getattr(presets, name), getattr(presets, base)
    assert p16 == dict(p32, precision=16)
    system = ZestSystem(ZestConfig(**p16))
    assert system.bf16 and system.nerf_static.bf16 and system.nerf_dynamic.bf16
    assert system.enc_static.dtype == system.enc_dy.dtype
    assert not ZestSystem(ZestConfig(**p32)).bf16
