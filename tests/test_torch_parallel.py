"""Ray sharding over a process group (``zest_tpu_torch.parallel``) on the
CPU: two spawned ranks joined by gloo against the port's one-process step,
and against zest_tpu's single-device step, on ``tests/test_sharding.py``'s
small configurations (both fields, without volumes and with both).

- the loss: rtol 1e-5 of the one-process step's. Each rank renders half the
  rays and both take the loss over all of them (``gather_rays``), so it
  differs only where a field's matmul sums its rows in another order;
- every gradient leaf: within 1e-4 of the leaf's largest gradient. The
  ranks' shares are summed over the ranks (``sum_over_ranks``), so the sums
  over rays run in another order;
- the no-volume case's logs: rtol 2e-4 of zest_tpu's single-device step on
  the same weights and draws, ``test_mesh_step_matches_single_device``'s
  tolerance;
- a split eval image: rtol 1e-5, atol 1e-6 of the one-process image;
- a ray count that does not divide the ranks warns and runs whole on every
  rank: the one-process results, exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from zest_tpu.system import TrainState as JTrainState
from zest_tpu.system import ZestSystem as JZestSystem
from zest_tpu.system import phase_for_step as jphase_for_step

from test_torch_train_step import jax_draws

from test_torch_ablation_mvsnerf import _few_threads  # noqa: F401
from zest_tpu_torch import ZestConfig, sampling
from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.data.synthetic import SyntheticDataset
from zest_tpu_torch.parallel import Mesh, dryrun, make_mesh, shard_rays
from zest_tpu_torch.system import ZestSystem, phase_for_step, to_batch

N_RANKS = 2
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
JAX_RTOL = 2e-4
KEY = jax.random.PRNGKey(5)


def sharding_config(volumes: bool, batch_size: int = 64) -> dict:
    """``tests/test_sharding.py``'s ``_setup`` configuration."""
    return dict(train_sceneflow=True, use_mvs=volumes, use_mvs_dy=volumes,
                pad=4 if volumes else 0, num_keyframes=3, netdepth=4,
                netwidth=32, multires=4, multires_views=2, N_samples=16,
                batch_size=batch_size, num_extra_samples=0,
                use_motion_mask=False, decay_iteration=1,
                with_chain_loss=False, pts_embedder=True, dir_embedder=True,
                use_viewdirs=True, num_epochs=10, eval_chunk=500)


def scene(volumes: bool) -> dict:
    if volumes:
        return dict(img_h=32, img_w=64, num_frames=9, num_keyframes=3,
                    use_mvs=True, use_mvs_dy=True)
    return dict(img_h=24, img_w=32, num_frames=8, num_keyframes=3,
                use_mvs=False, use_mvs_dy=False)


def one_process(cfg, batch, params, draws, phase):
    system = ZestSystem(cfg)
    loss, logs, grads = system.loss_and_grads(params, batch, draws, phase, 0)
    return dict(loss=loss, logs=logs, grads=grads,
                maps=system.make_eval_step()(params, batch))


def check_split(ref, ranks, exact=False):
    for got in ranks:
        if exact:
            assert torch.equal(got["loss"], ref["loss"])
        torch.testing.assert_close(got["loss"], ref["loss"], rtol=LOSS_RTOL,
                                   atol=0.0)
        assert set(got["grads"]) == set(ref["grads"])
        for k, g in ref["grads"].items():
            scale = float(g.abs().max())
            err = float((got["grads"][k] - g).abs().max())
            assert err <= GRAD_TOL * max(scale, 1e-12), (k, err, scale)
        for k, m in ref["maps"].items():
            torch.testing.assert_close(got["maps"][k], m, rtol=1e-5,
                                       atol=1e-6, msg=k)
    # every rank holds the same result
    for k in ranks[0]["grads"]:
        assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k]), k
    assert torch.equal(ranks[0]["loss"], ranks[1]["loss"])


@pytest.fixture(scope="module")
def split_runs(tmp_path_factory):
    """The three cases' inputs, their one-process results, zest_tpu's logs
    of the no-volume case and the two ranks' results (one spawn)."""
    tmp = tmp_path_factory.mktemp("split")
    cases = {}

    # no volumes: zest_tpu's weights and draws, and its step's logs
    raw = sharding_config(False)
    sample = JSyntheticDataset(**scene(False))[3]
    jbatch = {k: jnp.asarray(v) for k, v in sample.items()}
    jsys = JZestSystem(JZestConfig(**raw))
    jparams = jax.tree.map(np.asarray, jax.jit(jsys.init_params)(
        jax.random.PRNGKey(0), jbatch))
    opt = jsys.make_optimizer(8)
    _, jlogs = jsys.make_train_step(opt)(
        JTrainState(jparams, opt.init(jparams), jnp.asarray(0)), jbatch, KEY,
        jphase_for_step(JZestConfig(**raw), 0))
    cfg = ZestConfig(**raw)
    phase = phase_for_step(cfg, 0)
    draws = jax_draws(cfg, KEY, 0, phase, 24, 32, int(sample["motion_count"]))
    cases["plain"] = (cfg, to_batch(sample, "cpu"), from_jax_params(jparams),
                      draws, phase)

    # both volumes: the port's seeded weights and draws
    cfg = ZestConfig(**sharding_config(True))
    batch = to_batch(SyntheticDataset(**scene(True))[3], "cpu")
    system = ZestSystem(cfg)
    params = system.init_params(torch.Generator().manual_seed(0))
    phase = phase_for_step(cfg, 0)
    cases["volumes"] = (cfg, batch, params, sampling.sample_draws(
        torch.Generator().manual_seed(3), cfg, 32, 64,
        int(batch["motion_count"]), phase.extra_samples), phase)

    # 63 rays do not split over two ranks
    cfg = ZestConfig(**sharding_config(False, batch_size=63))
    c, batch, params, _, phase = cases["plain"]
    cases["odd"] = (cfg, batch, params, sampling.sample_draws(
        torch.Generator().manual_seed(4), cfg, 24, 32,
        int(batch["motion_count"]), phase.extra_samples), phase)

    paths, refs = [], {}
    for name, (cfg, batch, params, draws, phase) in cases.items():
        paths.append(tmp / f"{name}.pt")
        dryrun.save_inputs(paths[-1], cfg, batch, params, draws, phase, 0)
        refs[name] = one_process(cfg, batch, params, draws, phase)
    # the ranks sum at the thread count of the one-process step
    ranks = dryrun.run_ranks(N_RANKS, dryrun.split_step, paths,
                             threads=torch.get_num_threads())
    return refs, {name: [r[i] for r in ranks] for i, name in enumerate(cases)}, \
        {k: float(v) for k, v in jlogs.items()}


def test_split_step_matches_one_process(split_runs):
    refs, ranks, _ = split_runs
    for name in ("plain", "volumes"):
        check_split(refs[name], ranks[name])
        assert not any(r["warnings"] for r in ranks[name])


def test_split_step_logs_match_zest_tpu(split_runs):
    refs, ranks, jlogs = split_runs
    for got in [refs["plain"]] + ranks["plain"]:
        assert set(got["logs"]) == set(jlogs)
        for k, v in jlogs.items():
            np.testing.assert_allclose(float(got["logs"][k]), v,
                                       rtol=JAX_RTOL, err_msg=k)


def test_ray_count_not_dividing_warns_and_matches(split_runs):
    refs, ranks, _ = split_runs
    check_split(refs["odd"], ranks["odd"], exact=True)
    for r in ranks["odd"]:
        assert any("REPLICATED" in w for w in r["warnings"])


def test_mesh_helpers_without_a_group():
    x = torch.arange(6.0)
    assert shard_rays(x, None) is x
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh()
    system = ZestSystem(ZestConfig(**sharding_config(False)))
    assert system.mesh is None and system._chunk(24, 32) == 500
    system.mesh = Mesh(None, 0, 3)
    assert system._chunk(24, 32) == 498
    cfg = dataclasses.replace(system.cfg, eval_chunk=2)
    system.cfg = cfg
    assert system._chunk(24, 32) == 3


def test_dryrun_multichip():
    loss = dryrun.dryrun_multichip(N_RANKS, "cpu")
    assert np.isfinite(loss)


def test_dryrun_cli_refuses_without_a_card(monkeypatch, capsys):
    """``python -m zest_tpu_torch.parallel.dryrun N`` runs its ranks on the
    card; without one it exits 2 unless given ``--device cpu``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(dryrun, "dryrun_multichip",
                        lambda n, device: ran.append((n, device)))
    assert dryrun.main(["2"]) == 2
    assert "no CUDA device" in capsys.readouterr().err and not ran
    assert dryrun.main(["3", "--device", "cpu"]) == 0
    assert ran == [(3, "cpu")]
