"""The port's config parser, checkpoints, resume and command-line modules,
against zest_tpu's where zest_tpu has them, on the CPU.

- ``config_parser`` on each of the 89 files of ``configs/config_files/``
  with one command-line override: the same ``dataclasses.asdict`` as
  zest_tpu's (the port-owned counterpart of
  ``tests/test_data.py::test_config_parses_all_reference_configs``).
- ``CheckpointManager``: a round trip, and a retention sequence whose
  ``scores.json`` and kept names equal zest_tpu's.
- ``run_training``'s checkpoints and resume: with both packages' steps and
  validations replaced by recorders (as in ``test_torch_train_loop.py``),
  a run and its resumed continuation take the same steps and frames and
  leave the same checkpoint names, scores and ``last`` step as zest_tpu's.
  With the port's real steps, a resumed run starts at the saved step from
  the saved weights and Adam state.
- ``python -m zest_tpu_torch.{train,test,fine_tune,render_spiral}``: each
  exits with 2 without a CUDA device unless ``--device cpu``; the workflow
  train -> test --ckpt -> render_spiral --render_path wander -> fine_tune
  at ``--device cpu`` on the small scene.
"""
import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu import config as jconfig
from zest_tpu import train_loop as jloop
from zest_tpu.checkpoint import CheckpointManager as JCheckpointManager
from zest_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from zest_tpu.system import ZestSystem as JZestSystem

from zest_tpu_torch import (ZestConfig, config, fine_tune, presets,
                            render_spiral, train, train_loop)
from zest_tpu_torch import test as test_cli
from zest_tpu_torch.checkpoint import CheckpointManager
from zest_tpu_torch.data.synthetic import SyntheticDataset
from zest_tpu_torch.system import TrainState, ZestSystem
from zest_tpu_torch.tools import quality_gate

REPO = Path(__file__).resolve().parents[1]
# the README's toy configuration on the CPU: 32x64, 3 keyframes, depth-4
# fields of width 32, 8 samples, 2 steps
TOY = REPO / "configs" / "toy_synthetic_mvs.txt"
CONFIG_FILES = sorted((REPO / "configs" / "config_files").glob("*.txt"))
# one command-line override per file, in turn, and the value it sets: a
# flag over a value the file sets (netwidth, lrate, use_mvs, expname) or over
# a default
OVERRIDES = [(["--netwidth", "96"], 96), (["--lrate", "1e-3"], 1e-3),
             (["--use_mvs", "False"], False), (["--expname", "o"], "o"),
             (["--with_chain_loss"], True),
             (["--ckpt", "runs/x/ckpts/last"], "runs/x/ckpts/last"),
             (["--N_samples", "64"], 64), (["--precision", "16"], 16),
             (["--render_path", "wander"], "wander")]
LOSSES = [3.0, 1.0, 2.0, 0.5, 4.0, 0.1, 5.0]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests: the suite runs in
    several processes at once, and torch's small ops on oversubscribed
    thread pools run tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_config_fields_types_and_defaults_equal_zest_tpu():
    def fields(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]
    assert fields(ZestConfig) == fields(jconfig.ZestConfig)
    assert len(CONFIG_FILES) == 89


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.stem)
def test_config_parser_matches_zest_tpu(path):
    assert config.parse_config_file(path) == jconfig.parse_config_file(path)
    override, value = OVERRIDES[CONFIG_FILES.index(path) % len(OVERRIDES)]
    cmd = ["--config", str(path), *override]
    got, want = config.config_parser(cmd), jconfig.config_parser(cmd)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert getattr(got, override[0][2:]) == value
    assert got.config == str(path)
    # a string command parses as the list does; replace keeps the type
    assert config.config_parser(" ".join(cmd)) == got
    assert got.replace(expname="r") == dataclasses.replace(got, expname="r")


def test_synthetic_gate_config_file_is_the_gate():
    """``configs/synthetic_gate.txt``, the file the README's workflow on the
    card trains, tests and renders with, holds the quality gate's
    configuration on the synthetic scene."""
    cfg = config.config_parser(["--config", str(REPO / "configs" /
                                                "synthetic_gate.txt")])
    assert cfg.dataset_name == "synthetic" and cfg.save_dir == "runs"
    for k, v in quality_gate.CONFIG.items():
        if k not in ("save_dir", "expname"):
            assert getattr(cfg, k) == v, k


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"a.weight": torch.rand(3, 4, generator=g),
              "a.bias": torch.rand(4, generator=g)}
    return TrainState(params, {"mu": {k: v * 0.5 for k, v in params.items()},
                               "nu": {k: v * v for k, v in params.items()},
                               "count": 7}, 7)


def test_checkpoint_roundtrip_and_retention_match_zest_tpu(tmp_path):
    cfg = ZestConfig(**presets.SMALL)
    mgr = CheckpointManager(tmp_path / "port", cfg)
    assert not mgr.has_last()
    state = _state()
    mgr.save_last(state)
    assert mgr.has_last()
    got = mgr.restore("last", map_location=torch.device("cpu"))
    assert got.step == 7 and got.opt_state["count"] == 7
    for tree_got, tree_want in ((got.params, state.params),
                                (got.opt_state["mu"], state.opt_state["mu"]),
                                (got.opt_state["nu"], state.opt_state["nu"])):
        assert list(tree_got) == list(tree_want)
        for k in tree_want:
            assert torch.equal(tree_got[k], tree_want[k]), k
    assert CheckpointManager.load_config(tmp_path / "port") == cfg
    with pytest.raises(FileNotFoundError):
        mgr.restore("step00000001-val0.100")

    jstate = ({"w": jnp.arange(6.0).reshape(2, 3)}, {"m": jnp.zeros(3)},
              jnp.asarray(7))
    jmgr = JCheckpointManager(tmp_path / "ref", jconfig.ZestConfig())
    for i, loss in enumerate(LOSSES):
        mgr.save_topk(state, loss, step=i)
        jmgr.save_topk(jstate, loss, step=i)
    scores = json.loads((tmp_path / "port" / "scores.json").read_text())
    assert scores == json.loads((tmp_path / "ref" / "scores.json").read_text())
    assert sorted(scores.values()) == sorted(LOSSES)[:5]

    def kept(d):
        return sorted(p.name for p in d.iterdir() if p.name.startswith("step"))
    assert kept(tmp_path / "port") == kept(tmp_path / "ref") == sorted(scores)


class Frames:
    """The frames ``idx`` of a dataset, in that order."""

    def __init__(self, ds, idx):
        self.ds, self.idx = ds, list(idx)

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.ds[self.idx[i]]


def _fake_validate(calls):
    def validate(cfg, system, eval_fn, params, val_ds, save_dir, step,
                 max_images=None, tag="val"):
        calls.append(step)
        return {"val_loss": LOSSES[len(calls) % len(LOSSES)],
                "val_PSNR": 20.0, "val_SSIM": 0.5}
    return validate


def _reference_run(monkeypatch, tmp_path, kw, steps):
    """zest_tpu's run_training with recorder steps and validations, run to
    each of ``steps`` in turn: ([(step, frame)], [validation steps])."""
    records, calls = [], []

    def make_train_step(self, optimizer):
        def step(state, batch, rng, phase):
            records.append((int(state.step), int(batch["time"])))
            zero = jnp.zeros(())
            return (state._replace(step=state.step + 1),
                    {"train_loss": zero, "train_PSNR": zero})
        return step

    monkeypatch.setattr(JZestSystem, "init_params",
                        lambda self, key, batch: {"w": jnp.zeros(1)})
    monkeypatch.setattr(JZestSystem, "make_train_step", make_train_step)
    monkeypatch.setattr(jloop, "validate", _fake_validate(calls))
    ds = Frames(JSyntheticDataset(**presets.SMALL_SCENE), [3, 2])
    for n in steps:
        jloop.run_training(jconfig.ZestConfig(**kw, save_dir=str(tmp_path)),
                           max_steps=n, quiet=True,
                           datasets={"train": ds, "val": ds})
    return records, calls


def _port_run(monkeypatch, tmp_path, kw, steps):
    records, calls = [], []

    def make_train_step(self, optimizer):
        def step(state, batch, draws, phase):
            records.append((state.step, int(batch["time"])))
            zero = torch.zeros(())
            return (state._replace(step=state.step + 1),
                    {"train_loss": zero, "train_PSNR": zero})
        return step

    monkeypatch.setattr(ZestSystem, "make_train_step", make_train_step)
    monkeypatch.setattr(train_loop, "validate", _fake_validate(calls))
    ds = Frames(SyntheticDataset(**presets.SMALL_SCENE), [3, 2])
    for n in steps:
        train_loop.run_training(ZestConfig(**kw, save_dir=str(tmp_path)),
                                {"train": ds, "val": ds}, max_steps=n,
                                quiet=True, device="cpu")
    return records, calls


def test_resume_and_checkpoints_follow_zest_tpu(monkeypatch, tmp_path):
    # passes of 2 frames, a validation after each: 7 then 8 more top-k saves
    kw = dict(presets.SMALL_TRAIN, expname="resume", N_vis=1, num_epochs=2,
              steps_per_epoch=2, log_every=100, seed_everything=4)
    ref = _reference_run(monkeypatch, tmp_path / "ref", kw, (13, 28))
    got = _port_run(monkeypatch, tmp_path / "port", kw, (13, 28))
    assert got == ref
    records, calls = got
    assert [s for s, _ in records] == list(range(28))
    assert calls == [2, 4, 6, 8, 10, 12, 13, 15, 17, 19, 21, 23, 25, 27, 28]

    ckpts = [tmp_path / t / "resume" / "ckpts" for t in ("port", "ref")]
    scores = [json.loads((d / "scores.json").read_text()) for d in ckpts]
    assert scores[0] == scores[1] and len(scores[0]) == 5
    names = [sorted(p.name for p in d.iterdir()
                    if p.name.startswith("step")) for d in ckpts]
    assert names[0] == names[1] == sorted(scores[0])
    last = CheckpointManager(ckpts[0]).restore("last")
    probe = {"w": jnp.zeros(1)}
    opt = JZestSystem(jconfig.ZestConfig(**kw)).make_optimizer(2)
    jlast = JCheckpointManager(ckpts[1]).restore(
        "last", (probe, opt.init(probe), jnp.asarray(0)))
    assert last.step == int(jlast[2]) == 28


def test_run_training_resumes_the_saved_state(monkeypatch, tmp_path):
    toy = config.config_parser(["--config", str(TOY)])
    kw = dict(dataclasses.asdict(toy), save_dir=str(tmp_path), expname="run",
              log_every=1)
    ds = {"train": SyntheticDataset(**presets.SMALL_SCENE),
          "val": Frames(SyntheticDataset(**presets.SMALL_SCENE), [3])}
    first, _ = train_loop.run_training(ZestConfig(**kw), ds, max_steps=2,
                                       quiet=True, device="cpu")
    ckpts = tmp_path / "run" / "ckpts"
    saved = CheckpointManager(ckpts).restore("last")
    assert saved.step == 2 and saved.opt_state["count"] == 2
    for k, v in first.params.items():
        assert torch.equal(saved.params[k], v), k

    seen = []
    make_train_step = ZestSystem.make_train_step

    def recording(self, optimizer):
        step_fn = make_train_step(self, optimizer)

        def step(state, *args):
            seen.append(state)
            return step_fn(state, *args)
        return step

    monkeypatch.setattr(ZestSystem, "make_train_step", recording)
    final, _ = train_loop.run_training(ZestConfig(**kw), ds, max_steps=4,
                                       quiet=True, device="cpu")
    assert [s.step for s in seen] == [2, 3] and final.step == 4
    resumed = seen[0]
    assert resumed.opt_state["count"] == 2
    for k in saved.params:
        assert torch.equal(resumed.params[k], saved.params[k]), k
        for m in ("mu", "nu"):
            assert torch.equal(resumed.opt_state[m][k],
                               saved.opt_state[m][k]), (m, k)
    assert any(not torch.equal(final.params[k], saved.params[k])
               for k in saved.params)
    last = CheckpointManager(ckpts).restore("last")
    assert last.step == 4 and last.opt_state["count"] == 4
    scores = json.loads((ckpts / "scores.json").read_text())
    assert [n[:12] for n in sorted(scores)] == ["step00000002",
                                                "step00000004"]
    assert all((ckpts / n).is_file() for n in scores)
    # an explicit --ckpt that does not fit the config is refused
    with pytest.raises(ValueError, match="does not fit"):
        train_loop.run_training(
            ZestConfig(**dict(kw, netwidth=64, expname="other",
                              ckpt=str(ckpts / "last"))),
            ds, max_steps=5, device="cpu")


@pytest.mark.parametrize("module", [train, test_cli, fine_tune, render_spiral])
def test_cli_exits_2_without_cuda(monkeypatch, capsys, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert module.main(["--dataset_name", "synthetic"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_workflow_on_cpu(tmp_path, capsys):
    # the README's commands on the toy configuration; 4 epochs, a
    # validation every 2, so that these few steps validate nothing
    run = tmp_path / "cli"
    base = ["--config", str(TOY), "--save_dir", str(tmp_path), "--expname",
            "cli", "--num_epochs", "4", "--N_vis", "2", "--device", "cpu"]
    assert train.main(base) == 0
    last = str(run / "ckpts" / "last")
    assert CheckpointManager(run / "ckpts").restore("last").step == 2
    assert CheckpointManager.load_config(run / "ckpts").dataset_name == \
        "synthetic"

    assert test_cli.main([*base, "--ckpt", last]) == 0
    metrics = (run / "test_metrics.txt").read_text().splitlines()
    assert [m.split(": ")[0] for m in metrics] == ["PSNR", "SSIM"]
    assert np.isfinite(float(metrics[0].split(": ")[1]))

    path = ["--frame_range", "3", "3", "--n_poses", "2"]
    assert render_spiral.main([*base, "--ckpt", last, "--render_path",
                               "wander", *path]) == 0
    frame = run / "render_wanderpath_frame3"
    assert sorted(p.name for p in frame.iterdir()) == [
        "depth_map_blend_00.png", "depth_map_blend_01.png",
        "rgb_map_blend_00.png", "rgb_map_blend_01.png"]
    assert test_cli.main([*base, "--ckpt", last, "--render_wanderpath",
                          "--frame_range", "4", "4", "--n_poses", "1"]) == 0
    assert len(list((run / "render_wanderpath_frame4").iterdir())) == 2
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "frame": 4, "poses": 1, "out": str(run / "render_wanderpath_frame4")}
    # the synthetic scene has no LLFF cameras to put a spiral around
    with pytest.raises(ValueError, match="spiral"):
        render_spiral.main([*base, "--render_path", "spiral"])

    # fine-tuning warm-starts from --ckpt at its step, extra rays off
    assert fine_tune.main([*base, "--ckpt", last, "--max_train_steps",
                           "3"]) == 0
    tuned = CheckpointManager(run / "ckpts").restore("last")
    assert tuned.step == 3
    assert CheckpointManager.load_config(run / "ckpts").num_extra_samples == 0
