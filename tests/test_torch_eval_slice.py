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

from test_torch_ablation_mvsnerf import zest_tpu_shapes

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
    """The port runs its eval step and one training step in a fresh
    interpreter without JAX and without the JAX package ``zest_tpu``; its
    training loop, checkpoints, path rendering, config parser, command-line
    modules, metrics, quality gate, real-data loaders and scene fixtures,
    ray sharding, encoder dumps and observability hooks import neither."""
    script = textwrap.dedent("""
        import sys
        import torch
        from zest_tpu_torch import (checkpoint, cli, config, fine_tune,
                                    metrics, presets, render_paths,
                                    render_spiral, sampling, test, train,
                                    train_loop)
        from zest_tpu_torch.data import (common, dtu, llff, native_io,
                                         neural3dvideo, nsff, pfm, pose_utils)
        from zest_tpu_torch.tools import scene_fixtures
        from zest_tpu_torch.tools import quality_gate
        from zest_tpu_torch.utils import introspect, observability, visualize
        from zest_tpu_torch import parallel
        from zest_tpu_torch.parallel import dryrun, mesh
        from zest_tpu_torch.system import TrainState, phase_for_step
        assert config.config_parser(["--netwidth", "96"]).netwidth == 96
        _, system, batch, params = presets.build(
            presets.SMALL, presets.SMALL_SCENE, "cpu")
        maps = system.make_eval_step()(params, batch)
        assert maps["rgb_map_ref"].shape == (32, 64, 3)
        assert all(bool(torch.isfinite(v).all()) for v in maps.values())
        cfg, system, batch, params = presets.build(
            presets.SMALL_TRAIN, presets.SMALL_SCENE, "cpu")
        opt = system.make_optimizer(presets.STEPS_PER_EPOCH)
        phase = phase_for_step(cfg, 0)
        draws = sampling.sample_draws(torch.Generator().manual_seed(0), cfg,
                                      32, 64, int(batch["motion_count"]),
                                      phase.extra_samples)
        state, logs = system.make_train_step(opt)(
            TrainState(params, opt.init(params), 0), batch, draws, phase)
        assert state.step == 1
        assert all(bool(torch.isfinite(v)) for v in logs.values())
        assert any(bool((state.params[k] != params[k]).any()) for k in params)
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


@pytest.mark.parametrize("change", [dict(net_type="v2"),
                                    dict(use_color_volume=True),
                                    dict(train_video=True),
                                    dict(precision=8)])
def test_configs_outside_the_port_raise(change):
    """Another precision is outside the port and raises. The three model
    options, outside it before they were ported, build the parameters of
    zest_tpu's system for the small configuration: names and shapes
    through ``convert``."""
    config = {**CFG, **change}
    if "precision" in change:
        with pytest.raises(NotImplementedError):
            ZestSystem(ZestConfig(**config))
        return
    sample = JSyntheticDataset(**presets.SMALL_SCENE)[presets.TARGET_FRAME]
    system = ZestSystem(ZestConfig(**config))
    assert {k: tuple(v.shape) for k, v in system.state_dict().items()} == \
        zest_tpu_shapes(config, sample)
