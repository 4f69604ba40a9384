"""``train_video``'s learnable time codes of zest_tpu_torch against zest_tpu's
on the CPU.

- The fold of the code into the biases (``kernels.time_codes``): its plain
  twin and its backward against autograd of b + s @ W_code^T in float64,
  in the bf16-operand mode against the same products of rounded operands;
  the field with a code (``NeRFField(code_dim=...)``) folded
  (``fused_mlp.folded_field``, and ``pack_weights(field, code)``, the
  operands the kernels read, with its gradients) against the field on the
  concatenated input, in float64 and at float32.
- MVSNeRF's field and encoder with the time codes (``presets.SMALL_VIDEO``:
  32 code channels) on a Neural 3D Video scene written by
  ``tools.scene_fixtures.write_n3dv_scene``, one sample through both
  packages' ``build_datasets`` at downSample 0.1 (96x64): the eval image,
  the path (the target camera at other cameras' poses) and the training
  step, whose time codes' gradient and 10x learning rate reach the
  parameters after the step; at precision 16 the same.
- ``convert`` carries the codes, a checkpoint restores them and ``python -m
  zest_tpu_torch.train`` resumes a video run from it.
- ``keyframe_id`` outside the 40 codes: zest_tpu's gather clamps it to the
  last code, the port raises by name; a batch without one (the synthetic
  scene) raises by name.

Tolerances: those of ``test_torch_ablation_mvsnerf.py``'s docstring; the
fold in float64 1e-12, at float32 1e-5 of each quantity's largest.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.train_loop import build_datasets as jbuild_datasets
from test_torch_ablation_mvsnerf import (Family, _few_threads,  # noqa: F401
                                         check_grads, check_logs,
                                         check_p16_eval, check_p16_step,
                                         check_updated)

from zest_tpu_torch import ZestConfig, presets, train
from zest_tpu_torch.checkpoint import restore_path
from zest_tpu_torch.config import config_parser
from zest_tpu_torch.kernels import fused_mlp
from zest_tpu_torch.kernels.time_codes import (fold_codes,
                                               fold_codes_grad_plain,
                                               fold_codes_plain)
from zest_tpu_torch.models.nerf import NeRFField, append_code, round_bf16
from zest_tpu_torch.system import N_TIME_CODES, Optimizer, ZestSystem
from zest_tpu_torch.train_loop import build_datasets

SCENE = "coffee_martini"
FRAME = 2           # the test split's sample of camera 0, frame 2: code 2


def _field(dtype, code_dim=32, bf16=False, seed=0):
    torch.manual_seed(seed)
    return NeRFField(8, 64, 63, 27, 20, sceneflow=False, bf16=bf16,
                     code_dim=code_dim).to(dtype)


def _inputs(dtype, n=200, seed=1, code_dim=32):
    g = torch.Generator().manual_seed(seed)
    pts, feats, views = (torch.randn((n, c), generator=g, dtype=dtype)
                         for c in (63, 20, 27))
    return pts, feats, views, torch.rand(code_dim, generator=g, dtype=dtype)


@pytest.mark.parametrize("bf16", [False, True])
def test_fold_twin_and_its_backward_match_autograd(bf16):
    g = torch.Generator().manual_seed(2)
    code = torch.rand(48, generator=g, dtype=torch.float64)
    wc = torch.randn((2, 16, 48), generator=g, dtype=torch.float64)
    b = torch.randn((2, 16), generator=g, dtype=torch.float64)
    d_c = torch.randn((2, 16), generator=g, dtype=torch.float64)
    rnd = round_bf16 if bf16 else (lambda t: t)
    got = fold_codes_plain(code, wc, b, bf16)
    assert torch.allclose(got, b + rnd(wc) @ rnd(code), rtol=0, atol=1e-12)
    # the backward, through the autograd Function: d_code = d_c @ W_code,
    # d_wc = d_c (x) s, d_b = d_c; at float32 autograd of the sum itself,
    # in the bf16-operand mode the same products of the rounded operands
    leaves = [t.clone().requires_grad_(True) for t in (code, wc, b)]
    fold_codes(*leaves, bf16).backward(d_c)
    if bf16:
        want = (torch.einsum("lo,lot->t", d_c, rnd(wc)),
                d_c[..., None] * rnd(code), d_c)
    else:
        ref = [t.clone().requires_grad_(True) for t in (code, wc, b)]
        (ref[2] + ref[1] @ ref[0]).backward(d_c)
        want = [t.grad for t in ref]
    for leaf, w in zip(leaves, want):
        assert torch.allclose(leaf.grad, w, rtol=0, atol=1e-12)
    for a, w in zip(fold_codes_grad_plain(code, wc, d_c, bf16), want):
        assert torch.allclose(a, w, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_folded_field_equals_the_field_on_the_concatenated_input(dtype, tol):
    field = _field(dtype)
    pts, feats, views, code = _inputs(dtype)
    wide = field(append_code(pts, code), feats, views)
    narrow = fused_mlp.folded_field(field, code)
    assert narrow.in_ch_pts == 63 and narrow.code_dim == 0
    assert narrow.pts_linears[0].in_features == 63
    assert narrow.pts_linears[5].in_features == 64 + 63
    with torch.no_grad():
        out = narrow(pts, feats, views)
        wide = wide.detach()
    assert float((out - wide).abs().max()) <= tol * float(wide.abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_pack_with_the_fold_carries_the_gradients(dtype, tol):
    """The operands the kernels read (``pack_weights(field, code)``: the
    code's columns dropped, the folded biases) evaluated as a field and
    differentiated through the pack: every input, the code and every leaf
    of the wide field against autograd of the field on the concatenated
    input."""
    field = _field(dtype)
    narrow = fused_mlp.folded_field(field, _inputs(dtype)[3])
    pts, feats, views, code = (t.requires_grad_(True) for t in _inputs(dtype))
    gen = torch.Generator().manual_seed(3)
    g = torch.randn((pts.shape[0], 4), generator=gen, dtype=dtype)
    pack, offsets = fused_mlp.pack_weights(field, code)
    weights = {}
    for name, t in fused_mlp.pack_leaves(narrow, pack, offsets):
        weights[name] = t.T if name.endswith("weight") else t
    out = torch.func.functional_call(narrow, weights, (pts, feats, views))
    got = torch.autograd.grad(out, [pts, feats, views, code,
                                    *field.parameters()], g)
    wide = field(append_code(pts, code), feats, views)
    ref = torch.autograd.grad(wide, [pts, feats, views, code,
                                     *field.parameters()], g)
    err = float((out - wide).detach().abs().max())
    assert err <= tol * float(wide.detach().abs().max())
    names = ["pts", "feats", "views", "code"] + [n for n, _ in
                                                 field.named_parameters()]
    for name, a, b in zip(names, got, ref):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()), name


@pytest.fixture(scope="module")
def n3dv(tmp_path_factory):
    """A Neural 3D Video scene of 6 cameras and 4 frames, and the config
    fields that read it."""
    from zest_tpu_torch.tools import scene_fixtures as sf
    root = tmp_path_factory.mktemp("n3dv")
    sf.write_n3dv_scene(root, SCENE, n_cams=6, n_frames=4, size=(192, 128))
    return dict(datadir=str(root), finetune_scene=SCENE)


def _samples(config):
    """Sample FRAME of the test split through both packages'
    ``build_datasets``, key for key equal."""
    ref = jbuild_datasets(JZestConfig(**config), ("test",))["test"][FRAME]
    got = build_datasets(ZestConfig(**config), ("test",))["test"][FRAME]
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    return ref, got


@pytest.fixture(scope="module")
def video(n3dv):
    config = dict(presets.SMALL_VIDEO, **n3dv)
    return Family(config, samples=_samples(config))


@pytest.fixture(scope="module")
def video16(video, n3dv):
    config = dict(presets.SMALL_VIDEO_16, **n3dv)
    return Family(config, video.params, samples=(video.sample,
                                                 video.psample))


def test_video_sample_and_parameters(video):
    assert int(video.sample["keyframe_id"]) == FRAME
    assert video.batch["keyframe_id"].dtype == torch.int32
    assert video.batch["images"].shape == (4, 64, 96, 3)
    system = video.system
    assert system.time_codes.shape == (N_TIME_CODES, 32)
    assert system.nerf_static.pts_linears[0].in_features == 63 + 32
    # convert carries the codes, which the seeded init draws like zest_tpu's
    assert set(video.tparams) == set(system.state_dict())
    codes = video.tparams["time_codes"]
    assert torch.equal(codes, torch.as_tensor(video.params["time_codes"]))
    assert 0.0 < float(codes.std()) < 0.01 / 32 ** 0.5 * 2


def test_video_eval_matches_zest_tpu(video):
    check_eval_shape(*video.eval())


def check_eval_shape(ref, out):
    assert set(out) == set(ref) == {"rgb_map", "depth_map"}
    for k in ref:
        assert out[k].shape == ref[k].shape and ref[k].shape[:2] == (64, 96)
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert float(np.std(ref["rgb_map"])) > 1e-3


def test_video_path_matches_zest_tpu(video):
    """The path step with the target camera at its own pose and at two
    poses moved towards source cameras 0 and 1 (a third of the way: a
    source camera's own pose puts rays on its pixels' borders, where the
    strict in-bounds mask flips with rounding) against zest_tpu's eval step
    at each (its path step renders each pose as its eval does)."""
    s = video.sample
    c2ws = [s["c2ws"][-1]]
    for v in (0, 1):
        c2w = s["c2ws"][-1].copy()
        c2w[:3, 3] += (s["c2ws"][v][:3, 3] - c2w[:3, 3]) / 3
        c2ws.append(c2w)
    c2ws = np.stack(c2ws).astype(np.float32)
    w2cs = np.linalg.inv(c2ws).astype(np.float32)
    ref = [video.jeval(video.params, dict(
        video.jbatch, c2ws=video.jbatch["c2ws"].at[-1].set(c2w),
        w2cs=video.jbatch["w2cs"].at[-1].set(w2c)))
        for c2w, w2c in zip(c2ws, w2cs)]
    out = video.system.make_eval_path_step()(
        video.tparams, video.batch, torch.from_numpy(c2ws),
        torch.from_numpy(w2cs))
    for k in ("rgb_map", "depth_map"):
        np.testing.assert_allclose(out[k].numpy(),
                                   np.stack([np.asarray(r[k]) for r in ref]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_video_train_step_matches_zest_tpu(video):
    r = video.step(0)
    check_logs(r)
    check_grads(r)
    check_updated(r)
    # the code's gradient reaches its own row only; the row moves as
    # zest_tpu's does, and 10x as far as at the main rate (epoch 0: the
    # cosine is 1, so the rates are lrate and lrate * 10)
    g = r["grads"]["time_codes"]
    assert float(g[FRAME].abs().max()) > 0.0
    assert float(g.abs().sum()) == float(g[FRAME].abs().sum())
    params = r["params"]["time_codes"]
    moved = (r["new"]["time_codes"] - params).numpy()
    np.testing.assert_allclose(
        moved, (r["jnew"]["time_codes"] - params).numpy(), rtol=1e-3,
        atol=1e-7)
    main = Optimizer(video.system.make_optimizer(
        presets.STEPS_PER_EPOCH).lr_fn)
    with torch.no_grad():
        plain = main.update(r["grads"], main.init(r["params"]),
                            r["params"])[0]["time_codes"]
    np.testing.assert_allclose(moved, 10 * (plain - params).numpy(),
                               rtol=1e-4, atol=1e-9)
    assert np.abs(moved[FRAME]).max() > 0 == np.abs(moved[FRAME + 1]).max()


def test_video_p16_eval_and_step_match_zest_tpu(video, video16):
    ref16, out16 = video16.eval()
    ref32, _ = video.eval()
    check_p16_eval(ref16, out16, ref32, ("rgb_map", "depth_map"))
    check_p16_step(video16.step(0), video.step(0))


def test_keyframe_id_out_of_range_raises_where_zest_tpu_clamps(video):
    codes = jnp.asarray(video.params["time_codes"])
    np.testing.assert_array_equal(np.asarray(codes[45]), np.asarray(codes[39]))
    system = video.system
    for kid in (N_TIME_CODES, 45, -1):
        batch = dict(video.batch, keyframe_id=torch.tensor(kid, dtype=torch.int32))
        with pytest.raises(ValueError, match=f"keyframe_id {kid}.*40 time codes"):
            system.make_eval_step()(video.tparams, batch)
    batch = {k: v for k, v in video.batch.items() if k != "keyframe_id"}
    with pytest.raises(ValueError, match="keyframe_id"):
        system.make_eval_step()(video.tparams, batch)


def test_train_cli_resumes_a_video_run(tmp_path, n3dv):
    """``python -m zest_tpu_torch.train --train_video True`` on the scene at
    --device cpu: 2 steps, then 3 from ``ckpts/last``; the checkpoint holds
    the codes, and only the rows of the frames trained on moved."""
    base = ["--config", str(Path(__file__).resolve().parents[1] / "configs"
                            / "config_files" / "config_mvsnerf_nsff_cross1.txt"),
            "--dataset_name", "neural3Dvideo", "--datadir", n3dv["datadir"],
            "--finetune_scene", SCENE, "--train_video", "True",
            "--time_code_dim", "32", "--imgScale_train", "0.1",
            "--imgScale_test", "0.1", "--num_input", "3", "--netwidth", "64",
            "--N_samples", "16", "--batch_size", "32", "--pad", "4",
            "--save_dir", str(tmp_path), "--expname", "video",
            "--log_every", "1", "--num_epochs", "100", "--device", "cpu"]
    assert train.main(base + ["--max_train_steps", "2"]) == 0
    last = tmp_path / "video" / "ckpts" / "last"
    first = restore_path(last)
    assert first.step == 2 and first.params["time_codes"].shape == (40, 32)
    assert train.main(base + ["--max_train_steps", "3"]) == 0
    state = restore_path(last)
    assert state.step == 3
    system = ZestSystem(config_parser(base))
    init = system.init_params(torch.Generator().manual_seed(0))["time_codes"]
    rows = (state.params["time_codes"] != init).any(-1)
    assert 0 < int(rows.sum()) <= 3 and not bool(rows[4:].any())
    assert not torch.equal(state.params["time_codes"],
                           first.params["time_codes"])
