"""zest_tpu_torch's auxiliary modules against zest_tpu's on the CPU: the W&B
sink of ``MetricLogger``, ``utils.observability`` and the ``vis_cnn``
encoder dumps of ``utils.introspect``.

- The W&B sink: both packages' loggers run against one stand-in ``wandb``
  module (no package, no network) and must make the same calls, exactly.
- ``StepTimer`` and ``feat2viz``: equal outputs on the same inputs.
- The encoder dumps: the same weights (``convert.from_jax_params``) and the
  same synthetic views (3 of 32x64, pad 4) through zest_tpu's encoder with
  ``capture_intermediates`` (jitted) and the port's hooks, the same names
  and files. FeatureNet's activations at rtol 1e-4, atol 1e-5 (they differ
  by at most 1.2e-5 at values up to 5.7); CostRegNet's and the volume at
  rtol = atol = 1e-4, ``tests/test_torch_encoder.py``'s tolerance for the
  encoder: convolutions of up to 41 x 27 products summed in another order
  on each side, through ten layers of BatchNorm, differ by up to 6.0e-5 at
  values up to 10 (2.2e-5 beyond rtol 1e-4, atol 1e-5 near zero).
"""
import csv
import json
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu import train_loop as jloop
from zest_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from zest_tpu.models.mvsnet import MVSEncoder as JMVSEncoder
from zest_tpu.utils import introspect as jintrospect
from zest_tpu.utils import observability as jobs

from test_torch_ablation_mvsnerf import _few_threads  # noqa: F401
from zest_tpu_torch import train_loop
from zest_tpu_torch.config import config_parser
from zest_tpu_torch.convert import from_jax_params
from zest_tpu_torch.models import MVSEncoder
from zest_tpu_torch.utils import introspect, observability

PAD = 4
DUMP_TOL = {"2cnn_vis": dict(rtol=1e-4, atol=1e-5),
            "3cnn_vis": dict(rtol=1e-4, atol=1e-4)}
# zest_tpu names that have no counterpart here because they are TPU
# workarounds: none. Its Conv3dZ2D (the 3D conv as z-shifted 2D convs) and
# its transposed conv's phase split are written inside one Flax module each,
# so they capture no intermediate of their own.
TPU_ONLY: dict = {}


# --------------------------------------------------------------------------
# the W&B sink
# --------------------------------------------------------------------------

def fake_wandb(calls: list, ids=("run0001", "run0002"), fail=False):
    """A stand-in ``wandb`` module recording every call into ``calls``."""
    mod = types.ModuleType("wandb")
    fresh = iter(ids)
    mod.util = types.SimpleNamespace(generate_id=lambda: next(fresh))

    class Run:
        def log(self, scalars, step=None):
            calls.append(("log", dict(scalars), step))

        def finish(self):
            calls.append(("finish",))

    def init(**kwargs):
        calls.append(("init", kwargs))
        if fail:
            raise RuntimeError("no network")
        return Run()

    mod.init = init
    return mod


def _drive(logger_cls, run_dir):
    """A run of two log rows, then a resumed run of one."""
    logger = logger_cls(run_dir, "exp_a")
    logger.log(10, {"train_loss": 0.5, "train_PSNR": np.float32(21.25)})
    logger.log(20, {"val_loss": 0.25, "val_PSNR": 24.5})
    logger.close()
    id_after_first = (run_dir / "wandb_id.txt").read_text()
    logger = logger_cls(run_dir, "exp_a")
    logger.log(30, {"train_loss": 0.125})
    logger.close()
    return id_after_first


def test_wandb_sink_matches_zest_tpu(tmp_path, monkeypatch):
    got = {}
    for tag, cls in (("port", train_loop.MetricLogger),
                     ("ref", jloop.MetricLogger)):
        calls = []
        monkeypatch.setitem(sys.modules, "wandb", fake_wandb(calls))
        first_id = _drive(cls, tmp_path / tag)
        got[tag] = (calls, first_id,
                    (tmp_path / tag / "metrics.csv").read_text())
    assert got["port"] == got["ref"]
    calls, first_id, _ = got["port"]
    assert first_id == "run0001"
    inits = [c[1] for c in calls if c[0] == "init"]
    # the resumed run continues the same W&B run
    assert inits == [dict(project="SVS", name="exp_a", id="run0001",
                          resume="allow")] * 2
    assert [c for c in calls if c[0] == "log"] == [
        ("log", {"train_loss": 0.5, "train_PSNR": 21.25}, 10),
        ("log", {"val_loss": 0.25, "val_PSNR": 24.5}, 20),
        ("log", {"train_loss": 0.125}, 30)]
    assert [c[0] for c in calls].count("finish") == 2


def test_wandb_sink_dormant_without_wandb(tmp_path, monkeypatch):
    """An init that raises, and no ``expname``: the CSV alone, intact."""
    for tag, cls in (("port", train_loop.MetricLogger),
                     ("ref", jloop.MetricLogger)):
        calls = []
        monkeypatch.setitem(sys.modules, "wandb", fake_wandb(calls, fail=True))
        logger = cls(tmp_path / tag, "exp_b")
        logger.log(1, {"train_loss": 2.0})
        logger.log(2, {"train_loss": 1.0, "val_PSNR": 9.0})
        logger.close()
        assert [c[0] for c in calls] == ["init"]
        quiet = cls(tmp_path / f"{tag}_no_exp")
        quiet.close()
        assert [c[0] for c in calls] == ["init"]
        with open(tmp_path / tag / "metrics.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        assert rows == [{"step": "1", "train_loss": "2.0", "val_PSNR": ""},
                        {"step": "2", "train_loss": "1.0", "val_PSNR": "9.0"}]
    assert ((tmp_path / "port" / "metrics.csv").read_text()
            == (tmp_path / "ref" / "metrics.csv").read_text())


# --------------------------------------------------------------------------
# observability
# --------------------------------------------------------------------------

def test_step_timer_matches_zest_tpu(monkeypatch):
    out = {}
    for tag, cls in (("port", observability.StepTimer),
                     ("ref", jobs.StepTimer)):
        clock = iter([0.0] + [0.5 * i for i in range(1, 40)])
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = cls(window=4)
        out[tag] = [timer.tick(n) for n in (1, 2, 1, 3, 1, 1, 4, 2)]
        monkeypatch.undo()
    assert out["port"] == out["ref"]
    assert sum(r is not None for r in out["port"]) == 3


def test_profile_trace_anomaly_and_memory(tmp_path):
    with observability.profile_trace(str(tmp_path / "trace")) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert prof.key_averages()

    x = torch.zeros(3, requires_grad=True)
    try:
        observability.enable_anomaly_detection()
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="SqrtBackward0.*nan"):
            (torch.sqrt(x) * 0.0).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert observability.device_memory_stats() == {"cpu": None}
    observability.enable_shape_tracing()
    assert observability.logger.name == "zest_tpu_torch"


# --------------------------------------------------------------------------
# vis_cnn: the encoder dumps
# --------------------------------------------------------------------------

def test_feat2viz_matches_zest_tpu():
    feat = np.random.default_rng(0).normal(size=(2, 8, 12, 6)).astype(np.float32)
    got = introspect.feat2viz(feat)
    np.testing.assert_array_equal(got, jintrospect.feat2viz(feat))
    assert got.shape == (2, 8, 12, 3) and got.min() >= 0 and got.max() <= 1


def _seeded_tree(shapes, seed=0):
    """zest_tpu's encoder variables of ``shapes`` filled from a seed: conv
    kernels N(0, 1) / sqrt(fan_in), BatchNorm scales 1 + N(0, 0.1), biases
    N(0, 0.1); the first cost-volume conv's 7 padding channels 0."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "kernel" in name:
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
            if "cost_reg_2']['conv0']" in name:
                v[..., 41:, :] = 0.0
        elif "scale" in name:
            v = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            v = 0.1 * rng.normal(size=shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_captures(inter) -> dict:
    """zest_tpu's captured intermediates by the names its
    ``dump_encoder_activations`` saves them under."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if k == "__call__":
                if prefix and not isinstance(v[0], (tuple, list, dict)):
                    out[prefix] = np.asarray(v[0])
            elif isinstance(v, dict):
                walk(v, f"{prefix}.{k}" if prefix else k)
    walk(inter, "")
    return out


def _expected_files(captures: dict) -> set:
    """The files zest_tpu's dump writes for these captures."""
    files = {"cost_vol/tensors/volume_feat.npy"}
    for name, arr in captures.items():
        sub = "2cnn_vis" if name.startswith("feature") else "3cnn_vis"
        files.add(f"{sub}/tensors/{name}.npy")
        if (arr.ndim == 4 and min(arr.shape[1:3]) > 1) or arr.ndim == 5:
            files.add(f"{sub}/feat2viz/{name}.png")
    return files


def _tree(root) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


def test_encoder_dumps_match_zest_tpu(tmp_path):
    sample = JSyntheticDataset(img_h=32, img_w=64, num_frames=9,
                               num_keyframes=3)[3]
    imgs, pms = sample["images"][:-1], sample["proj_mats"][:-1]
    nf = sample["near_fars"][0]
    assert imgs.shape == (3, 32, 64, 3)
    enc = JMVSEncoder()
    shapes = jax.eval_shape(lambda: enc.init(
        jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(pms),
        jnp.asarray(nf), pad=PAD))
    variables = _seeded_tree(shapes)
    (vol, _, _), inter = jax.jit(lambda v, i, p, n: enc.apply(
        v, i, p, n, pad=PAD, capture_intermediates=True,
        mutable=["intermediates"]))(variables, jnp.asarray(imgs),
                                    jnp.asarray(pms), jnp.asarray(nf))
    ref = _jax_captures(inter["intermediates"])

    sd = from_jax_params({"enc_static": variables})
    encoder = MVSEncoder()
    encoder.load_state_dict({k[len("enc_static."):]: v for k, v in sd.items()})
    captured = introspect.dump_encoder_activations(
        encoder, torch.from_numpy(imgs), torch.from_numpy(pms),
        torch.from_numpy(nf), PAD, tmp_path)

    assert set(ref) - set(TPU_ONLY) == set(captured)
    assert _tree(tmp_path) == _expected_files(
        {k: v for k, v in ref.items() if k not in TPU_ONLY})
    for name in captured:
        sub = "2cnn_vis" if name.startswith("feature") else "3cnn_vis"
        got = np.load(tmp_path / sub / "tensors" / f"{name}.npy")
        assert got.shape == ref[name].shape == captured[name], name
        np.testing.assert_allclose(got, ref[name], err_msg=name,
                                   **DUMP_TOL[sub])
    np.testing.assert_allclose(
        np.load(tmp_path / "cost_vol" / "tensors" / "volume_feat.npy"),
        np.asarray(vol), **DUMP_TOL["3cnn_vis"])
    # channels-last layouts of both dimensionalities, 8 channels out
    assert ref["feature.conv1_2.bn"].shape == (3, 16, 32, 16)
    assert ref["cost_reg_2.conv7"].shape[-1] == 32
    assert ref["cost_reg_2"].shape == (1, 128, 16, 24, 8)


def test_run_test_vis_cnn_toy_config(tmp_path):
    """``run_test`` with ``vis_cnn`` on the toy volume config: the dumps of
    the first test sample's source views under ``save_test``, then the
    metrics as without it."""
    cfg = config_parser([
        "--config", "configs/toy_synthetic_mvs.txt", "--save_dir",
        str(tmp_path / "runs"), "--save_test", str(tmp_path / "vis"),
        "--vis_cnn", "True"])
    with pytest.warns(UserWarning, match="without --ckpt"):
        out = train_loop.run_test(cfg, quiet=True, device="cpu")
    assert np.isfinite(out["val_PSNR"])
    files = _tree(tmp_path / "vis")
    assert "cost_vol/tensors/volume_feat.npy" in files
    names = {f.split("/")[-1][:-4] for f in files if f.endswith(".npy")}
    assert {"feature", "feature.toplayer", "feature.conv0_0.conv",
            "feature.conv2_2.bn", "cost_reg_2", "cost_reg_2.conv0.conv",
            "cost_reg_2.conv6.bn", "cost_reg_2.conv11",
            "cost_reg_2.conv11.bn"} <= names
    assert len(names - {"volume_feat"}) == 8 * 3 + 2 + 7 * 3 + 3 * 2 + 1
    vol = np.load(tmp_path / "vis" / "cost_vol" / "tensors" / "volume_feat.npy")
    assert vol.shape == (128, 16, 24, 8) and np.isfinite(vol).all()
