"""The port's training loop, validation, metric log and quality gate against
zest_tpu's on the CPU, at ``presets.SMALL`` / ``SMALL_TRAIN``.

- ``validate``: both packages render the same 2 frames of ``SMALL_SCENE``
  with the same weights (``convert.from_jax_params``, alpha bias raised by 1
  so the images carry signal). val_loss agrees to 1e-4 relative, val_SSIM
  to 1e-4 of its range's bound, max(1, |SSIM|) (at random weights SSIM is
  ~0.07, and its variance terms cancel: 1e-5 in the maps moves it by
  ~1e-5), val_PSNR to 1e-3 dB (the eval maps agree to rtol 1e-4, atol 1e-5,
  ``test_torch_eval_slice.py``), the dumped PNGs within 1 LSB away from
  the border rows. validate takes the first frames, 0 and 1, and their
  cameras share the y translation of keyframes 0 and 8 (``_pose``: 0.03
  cos(2 pi f / 9)), so the rays of the top and bottom rows project onto
  the edge of those views' strict in-bounds mask, a tie that the two
  packages' rounding breaks differently: there the maps differ by more
  (rows 0 and H - 1 only, asserted).
- ``run_training``'s schedule: frame order, phase and learning rate of each
  step over the first 3 passes, against zest_tpu's own loop and
  ``make_optimizer``, with each package's step replaced by one that records
  them (the steps themselves are held by ``test_torch_train_step.py`` and
  ``test_torch_precision16_step.py``). The learning rate is read from one
  Adam update of a probe weight with a constant gradient 0.5:
  -update = lr * 0.5 / (0.5 + 1e-8). optax corrects Adam's bias in float32,
  where 1 - 0.999^k carries ~1e-5 of relative error, so the rates agree to
  rtol 1e-4; an epoch off by one would move them by several per cent.
- The port's gate holds zest_tpu's gate configuration and floors, read from
  ``tools/quality_gate.py`` with ``ast`` (that file imports JAX at its top).
"""
import ast
import csv
import dataclasses
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from zest_tpu import train_loop as jloop
from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from zest_tpu.system import ZestSystem as JZestSystem

from test_torch_ablation_mvsnerf import (_few_threads,  # noqa: F401
                                         zest_tpu_shapes)

from zest_tpu_torch import ZestConfig, presets, sampling, train_loop
from zest_tpu_torch.checkpoint import restore_path
from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.data.pipeline import epoch_order, prefetch_to_device
from zest_tpu_torch.data.synthetic import SyntheticDataset
from zest_tpu_torch.system import ZestSystem
from zest_tpu_torch.tools import quality_gate

REPO = Path(__file__).resolve().parents[1]
VAL_KEYS = ["val_loss", "val_PSNR", "val_SSIM"]


def _reference_weights(cfg):
    sample = JSyntheticDataset(**presets.SMALL_SCENE)[0]
    jbatch = {k: jnp.asarray(v) for k, v in sample.items()}
    params = jax.tree.map(np.asarray, jax.jit(JZestSystem(cfg).init_params)(
        jax.random.PRNGKey(0), jbatch))
    for field in ("nerf_static", "nerf_dynamic"):
        alpha = params[field]["params"]["alpha_linear"]
        alpha["bias"] = alpha["bias"] + 1.0
    return params


def test_validate_matches_zest_tpu(tmp_path):
    jcfg = JZestConfig(**presets.SMALL)
    jparams = _reference_weights(jcfg)
    jsys = JZestSystem(jcfg)
    ref = jloop.validate(jcfg, jsys, jsys.make_eval_step(), jparams,
                         JSyntheticDataset(**presets.SMALL_SCENE),
                         tmp_path / "ref", 7, max_images=2)

    cfg = ZestConfig(**presets.SMALL)
    system = ZestSystem(cfg)
    out = train_loop.validate(cfg, system, system.make_eval_step(),
                              from_jax_params(jparams),
                              SyntheticDataset(**presets.SMALL_SCENE),
                              tmp_path / "port", 7, max_images=2)
    assert list(out) == list(ref) == VAL_KEYS
    np.testing.assert_allclose(out["val_loss"], ref["val_loss"], rtol=1e-4)
    assert abs(out["val_SSIM"] - ref["val_SSIM"]) <= \
        1e-4 * max(1.0, abs(ref["val_SSIM"]))
    assert abs(out["val_PSNR"] - ref["val_PSNR"]) < 1e-3
    assert 5.0 < out["val_PSNR"] < 60.0

    names = sorted(p.name for p in (tmp_path / "ref" / "val_images").iterdir())
    assert names == sorted(p.name for p in
                           (tmp_path / "port" / "val_images").iterdir())
    assert len(names) == 6 and names[0] == "00000007_00_depth.png"
    for name in names:
        got = np.asarray(Image.open(tmp_path / "port" / "val_images" / name),
                         np.int16)
        want = np.asarray(Image.open(tmp_path / "ref" / "val_images" / name),
                          np.int16)
        assert got.shape == want.shape == (32, 64, 3), name
        assert int(np.abs(got - want)[1:-1].max()) <= 1, name


def test_metric_logger_rewrites_header_for_new_keys(tmp_path):
    rows = [(1, {"train_loss": 0.5, "train_PSNR": 12.0}),
            (2, {"val_loss": 0.25, "val_PSNR": 14.0}),
            (3, {"train_loss": 0.375, "train_PSNR": 13.0})]
    for tag, logger in (("port", train_loop.MetricLogger(tmp_path / "port")),
                        ("ref", jloop.MetricLogger(tmp_path / "ref"))):
        for step, scalars in rows:
            logger.log(step, scalars)
        logger.close()
    text = (tmp_path / "port" / "metrics.csv").read_text()
    assert text == (tmp_path / "ref" / "metrics.csv").read_text()
    with open(tmp_path / "port" / "metrics.csv", newline="") as f:
        reader = csv.DictReader(f)
        assert reader.fieldnames == ["step", "train_loss", "train_PSNR",
                                     "val_loss", "val_PSNR"]
        got = list(reader)
    assert got[0]["val_loss"] == "" and got[1]["val_PSNR"] == "14.0"
    assert got[2]["train_loss"] == "0.375"

    # a second logger on the same directory keeps the earlier rows
    logger = train_loop.MetricLogger(tmp_path / "port")
    logger.log(4, {"train_loss": 0.125})
    logger.close()
    with open(tmp_path / "port" / "metrics.csv", newline="") as f:
        assert [r["step"] for r in csv.DictReader(f)] == ["1", "2", "3", "4"]


def _probe_lr(update_w) -> float:
    return -float(update_w) * (0.5 + 1e-8) / 0.5


def _reference_schedule(monkeypatch, tmp_path, kw, n_steps):
    """(frame, phase, lr) of each step of zest_tpu's run_training."""
    records = []

    def make_train_step(self, optimizer):
        probe = {"w": jnp.zeros(1)}
        opt_state = [optimizer.init(probe)]

        def step(state, batch, rng, phase):
            upd, opt_state[0] = optimizer.update({"w": jnp.full(1, 0.5)},
                                                 opt_state[0], probe)
            records.append((int(batch["time"]), tuple(phase),
                            _probe_lr(upd["w"][0])))
            zero = jnp.zeros(())
            return (state._replace(step=state.step + 1),
                    {"train_loss": zero, "train_PSNR": zero})
        return step

    monkeypatch.setattr(JZestSystem, "init_params",
                        lambda self, key, batch: {"w": jnp.zeros(1)})
    monkeypatch.setattr(JZestSystem, "make_train_step", make_train_step)
    jloop.run_training(JZestConfig(**kw, save_dir=str(tmp_path / "ref")),
                       max_steps=n_steps, quiet=True, datasets={
                           "train": JSyntheticDataset(**presets.SMALL_SCENE)})
    return records


def _port_schedule(monkeypatch, tmp_path, kw, n_steps):
    """(frame, phase, lr) of each step of the port's run_training, and the
    first step's draws."""
    records, draws0 = [], []

    def make_train_step(self, optimizer):
        probe = {"w": torch.zeros(1)}
        opt_state = [optimizer.init(probe)]

        def step(state, batch, draws, phase):
            new, opt_state[0] = optimizer.update({"w": torch.full((1,), 0.5)},
                                                 opt_state[0], probe)
            records.append((int(batch["time"]), tuple(phase),
                            _probe_lr(new["w"][0])))
            draws0.append(draws)
            zero = torch.zeros(())
            return (state._replace(step=state.step + 1),
                    {"train_loss": zero, "train_PSNR": zero})
        return step

    monkeypatch.setattr(ZestSystem, "make_train_step", make_train_step)
    train_loop.run_training(ZestConfig(**kw, save_dir=str(tmp_path / "port")),
                            {"train": SyntheticDataset(**presets.SMALL_SCENE)},
                            max_steps=n_steps, quiet=True, device="cpu")
    return records, draws0[0]


@pytest.mark.parametrize("decay,seed", [(1, 3), (0, -1)])
def test_run_training_schedule_matches_zest_tpu(monkeypatch, tmp_path, decay,
                                                seed):
    n_frames = len(SyntheticDataset(**presets.SMALL_SCENE))
    n_steps = 3 * n_frames
    # decay 0: the chain pass from step 1 on; epochs of 4 steps move the
    # cosine learning rate within the first pass
    kw = dict(presets.SMALL_TRAIN, decay_iteration=decay, seed_everything=seed,
              steps_per_epoch=4, num_epochs=5, log_every=5, expname="sched")
    ref = _reference_schedule(monkeypatch, tmp_path, kw, n_steps)
    got, draws = _port_schedule(monkeypatch, tmp_path, kw, n_steps)
    assert len(got) == len(ref) == n_steps
    assert [r[:2] for r in got] == [r[:2] for r in ref]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in ref],
                               rtol=1e-4)
    frames = [r[0] for r in got]
    for p in range(3):              # each pass visits every frame once
        assert sorted(frames[p * n_frames:(p + 1) * n_frames]) == \
            list(range(n_frames))
    assert frames[:n_frames] != frames[n_frames:2 * n_frames]
    lrs = [r[2] for r in got]
    assert lrs[0] > lrs[4] > lrs[8] > lrs[19] > lrs[20] == lrs[n_steps - 1]
    # the steps draw from one generator seeded with the run's seed
    cfg = ZestConfig(**kw)
    first = sampling.sample_draws(
        torch.Generator().manual_seed(max(seed, 0)), cfg, cfg.img_h, cfg.img_w,
        int(SyntheticDataset(**presets.SMALL_SCENE)[0]["motion_count"]),
        got[0][1][0])
    for a, b in zip(draws, first):
        assert (a is None and b is None) or torch.equal(a, b)


def test_run_training_writes_metrics_with_validation(tmp_path):
    cfg = ZestConfig(**presets.SMALL_TRAIN, save_dir=str(tmp_path),
                     expname="run", log_every=1, N_vis=1, seed_everything=0)
    ds = {"train": SyntheticDataset(**presets.SMALL_SCENE),
          "val": SyntheticDataset(**presets.SMALL_SCENE)}
    state, system = train_loop.run_training(cfg, ds, max_steps=3, quiet=True,
                                            device="cpu")
    assert state.step == 3 and state.opt_state["count"] == 3
    assert isinstance(system, ZestSystem)
    with open(tmp_path / "run" / "metrics.csv", newline="") as f:
        reader = csv.DictReader(f)
        header = reader.fieldnames
        rows = list(reader)
    # the step's logs (held to zest_tpu's keys by test_torch_train_step.py)
    # then the loop's own, in the reference's order
    assert header[0] == "step" and header[-4:] == ["steps_per_sec", *VAL_KEYS]
    assert {"train_loss", "train_PSNR", "sceneflow_loss"} <= set(header)
    assert [r["step"] for r in rows] == ["1", "2", "3", "3"]
    for r in rows[:3]:
        assert math.isfinite(float(r["train_loss"])) and r["val_loss"] == ""
    assert all(math.isfinite(float(rows[3][k])) for k in VAL_KEYS)
    assert rows[3]["train_loss"] == ""
    # the same rows through zest_tpu's logger give the same file
    ref = jloop.MetricLogger(tmp_path / "ref")
    for r in rows:
        ref.log(int(r["step"]), {k: v for k, v in r.items()
                                 if k != "step" and v != ""})
    ref.close()
    assert (tmp_path / "ref" / "metrics.csv").read_text() == \
        (tmp_path / "run" / "metrics.csv").read_text()
    assert len(list((tmp_path / "run" / "val_images").glob("*.png"))) == 12


@pytest.mark.parametrize("change,name", [
    (dict(dataset_name="synthetic", train_video=True), "train_video"),
    (dict(train_video=True), "train_video"),
    (dict(use_color_volume=True), "use_color_volume"),
    (dict(precision=8), "precision=8"),
    (dict(dataset_name="synthetic", net_type="v2"), "net_type='v2'"),
])
def test_run_training_refuses_what_it_does_not_port(tmp_path, change, name):
    """What the system does not port (another precision) is refused, also
    when the loop builds its datasets from the config (``datasets=None``);
    so is ``train_video`` on a scene without ``keyframe_id`` (the synthetic
    one), by name before the first step, where zest_tpu's step fails on
    the missing key. The two other model options, refused before they were
    ported, train a step here, and the checkpoint holds zest_tpu's
    parameter names and shapes."""
    config = dict(presets.SMALL_TRAIN, save_dir=str(tmp_path),
                  expname="refused", **change)
    cfg = ZestConfig(**config)
    datasets = None if "dataset_name" in change else {
        "train": SyntheticDataset(**presets.SMALL_SCENE)}
    if "precision" in change:
        with pytest.raises(NotImplementedError, match=name):
            train_loop.run_training(cfg, datasets, max_steps=1, device="cpu")
        return
    if "train_video" in change:
        with pytest.raises(ValueError, match="train_video.*keyframe_id"):
            train_loop.run_training(cfg, datasets, max_steps=1, device="cpu")
        assert not (tmp_path / "refused" / "ckpts" / "last").exists()
        return
    # one step, without the validation pass a built val split would add
    state, _ = train_loop.run_training(
        cfg, {"train": SyntheticDataset(**presets.SMALL_SCENE)}, max_steps=1,
        device="cpu", quiet=True)
    assert state.step == 1
    sample = JSyntheticDataset(**presets.SMALL_SCENE)[presets.TARGET_FRAME]
    saved = restore_path(tmp_path / "refused" / "ckpts" / "last").params
    assert {k: tuple(v.shape) for k, v in saved.items()} == \
        zest_tpu_shapes(config, sample)


def test_validate_refuses_lpips(tmp_path):
    """LPIPS weights that do not load are an error, not a metric quietly
    dropped (LPIPS itself: tests/test_torch_svs_*.py)."""
    cfg = ZestConfig(**presets.SMALL, lpips_weights=str(tmp_path / "no.npz"))
    system = ZestSystem(cfg)
    params = {"w": torch.zeros(1)}
    with pytest.raises(RuntimeError, match="lpips_weights"):
        train_loop.validate(cfg, system, system.make_eval_step(), params, [],
                            tmp_path, 0)


def test_prefetch_order_and_worker_errors():
    ds = SyntheticDataset(**presets.SMALL_SCENE)
    order = list(epoch_order(len(ds), 2, seed=5))
    rng = np.random.default_rng(5)
    assert order == list(rng.permutation(len(ds))) + \
        list(rng.permutation(len(ds)))
    got = [int(b["time"]) for b in prefetch_to_device(ds, iter(order), "cpu")]
    assert got == order
    batch = next(prefetch_to_device(ds, iter([4]), "cpu"))
    assert torch.equal(batch["images"], torch.from_numpy(ds[4]["images"]))

    def broken():
        yield 0
        raise ValueError("bad index")
    with pytest.raises(ValueError, match="bad index"):
        list(prefetch_to_device(ds, broken(), "cpu"))

    # closing early stops the worker
    frames = prefetch_to_device(ds, iter(range(len(ds))), "cpu", buffer_size=1)
    next(frames)
    frames.close()


def _reference_gate():
    """(ZestConfig keywords, PSNR_THRESHOLDS) of tools/quality_gate.py."""
    tree = ast.parse((REPO / "tools" / "quality_gate.py").read_text())
    kw = thresholds = None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "ZestConfig"):
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords}
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "PSNR_THRESHOLDS"):
            thresholds = ast.literal_eval(node.value)
    return kw, thresholds


def test_gate_holds_the_reference_configuration():
    kw, thresholds = _reference_gate()
    assert quality_gate.PSNR_THRESHOLDS == thresholds == {2000: 28.0}
    # paths: the port's run directory lies in the working tree
    other = {"save_dir", "expname"}
    assert {k: v for k, v in quality_gate.CONFIG.items() if k not in other} \
        == {k: v for k, v in kw.items() if k not in other}
    assert set(kw) == set(quality_gate.CONFIG)
    # use_viewdirs: a field of both configs, read by neither package
    assert kw["use_viewdirs"] and "use_viewdirs" in {
        f.name for f in dataclasses.fields(ZestConfig)}
    assert not [p for pkg in ("zest_tpu", "zest_tpu_torch")
                for p in (REPO / pkg).rglob("*.py")
                if "cfg.use_viewdirs" in p.read_text()]
    assert quality_gate.SCENE == dict(presets.FLAGSHIP_SCENE)
    assert quality_gate.VAL_IMAGES == 2
    # the gate's configuration is bench.py's flagship step at precision 16
    cfg = ZestConfig(**quality_gate.CONFIG)
    for k, v in presets.FLAGSHIP_TRAIN_16.items():
        if k != "eval_chunk":
            assert getattr(cfg, k) == v, k


def test_gate_main_on_cpu_prints_the_reference_keys(monkeypatch, tmp_path,
                                                    capsys):
    monkeypatch.setattr(quality_gate, "CONFIG", dict(
        quality_gate.CONFIG, **presets.SMALL_TRAIN,
        save_dir=str(tmp_path), log_every=1))
    monkeypatch.setattr(quality_gate, "SCENE", presets.SMALL_SCENE)
    assert quality_gate.main(["2", "--device", "cpu", "--seed", "1"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert list(out) == ["steps", "val_PSNR", "val_SSIM", "threshold",
                         "train_s", "passed"]
    assert out["steps"] == 2 and out["threshold"] is None and out["passed"]
    assert math.isfinite(out["val_PSNR"]) and math.isfinite(out["val_SSIM"])
    run = tmp_path / "qgate_p16_seed1"
    with open(run / "metrics.csv", newline="") as f:
        assert [r["step"] for r in csv.DictReader(f)] == ["1", "2"]
    assert len(list((run / "qgate_images").glob("*.png"))) == 6
