"""The whole eval step of zest_tpu_torch against zest_tpu's on the CPU, at a
small size with the real topology (3 keyframes, 32x64 images, depth-8 fields
with the skip after layer 4, multires 10 / 4).

Both packages get the same weights (``convert.from_jax_params``) and the same
numpy sample of the synthetic scene. At random init σ is often ≤ 0 everywhere, which renders
exactly 0; the alpha bias of both fields is raised by 1 in both packages so
the compared maps carry signal (their spread is asserted).

Tolerance: rtol 1e-4, atol 1e-5 — each map composites 16 samples of two
fields whose outputs agree to ~1e-6.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from zest_tpu.system import ZestSystem as JZestSystem

from zest_tpu_torch import ZestConfig, presets
from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.system import EVAL_KEYS, ZestSystem, to_batch

REPO = Path(__file__).resolve().parents[1]
# eval_chunk 1500 over 2048 rays: the last chunk is padded and cut back
CFG = presets.SMALL


def test_eval_step_matches_zest_tpu():
    sample = JSyntheticDataset(**presets.SMALL_SCENE)[presets.TARGET_FRAME]
    jbatch = {k: jnp.asarray(v) for k, v in sample.items()}
    jsys = JZestSystem(JZestConfig(**CFG))
    params = jax.tree.map(np.asarray, jax.jit(jsys.init_params)(
        jax.random.PRNGKey(0), jbatch))
    for field in ("nerf_static", "nerf_dynamic"):
        alpha = params[field]["params"]["alpha_linear"]
        alpha["bias"] = alpha["bias"] + 1.0
    ref = jsys.make_eval_step()(params, jbatch)

    out = ZestSystem(ZestConfig(**CFG)).make_eval_step()(
        from_jax_params(params), to_batch(sample, "cpu"))
    assert set(out) == set(EVAL_KEYS) == set(ref)
    for k in EVAL_KEYS:
        r = np.asarray(ref[k])
        assert out[k].shape == r.shape and r.shape[:2] == (32, 64), k
        np.testing.assert_allclose(out[k].numpy(), r, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for k in ("rgb_map", "rgb_map_ref"):
        assert float(np.std(np.asarray(ref[k]))) > 1e-3, k


def test_port_imports_no_jax():
    """The port runs its eval step in a fresh interpreter without JAX and
    without the JAX package ``zest_tpu``."""
    script = textwrap.dedent("""
        import sys
        import torch
        from zest_tpu_torch import presets
        _, system, batch, params = presets.build(
            presets.SMALL, presets.SMALL_SCENE, "cpu")
        maps = system.make_eval_step()(params, batch)
        assert maps["rgb_map_ref"].shape == (32, 64, 3)
        assert all(bool(torch.isfinite(v).all()) for v in maps.values())
        banned = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "zest_tpu")]
        assert not banned, banned
        print("no-jax-ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no-jax-ok" in proc.stdout


def test_init_params_covers_the_state_dict():
    system = ZestSystem(ZestConfig(**CFG))
    a = system.init_params(torch.Generator().manual_seed(0))
    b = system.init_params(torch.Generator().manual_seed(0))
    sd = system.state_dict()
    assert set(a) == set(sd)
    for k, v in a.items():
        assert v.shape == sd[k].shape, k
        assert torch.equal(v, b[k]), k
    w = a["nerf_static.pts_linears.1.weight"]
    bound = 1.0 / 64 ** 0.5
    assert float(w.abs().max()) <= bound and float(w.std()) > bound / 3
    assert torch.equal(a["enc_static.feature.conv0.0.bn.weight"],
                       torch.ones(8))
    assert torch.equal(a["enc_dy.feature.toplayer.bias"], torch.zeros(32))


@pytest.mark.parametrize("change", [dict(train_sceneflow=False),
                                    dict(precision=16),
                                    dict(use_mvs_dy=False)])
def test_configs_outside_the_port_raise(change):
    with pytest.raises(NotImplementedError):
        ZestSystem(ZestConfig(**{**CFG, **change}))
