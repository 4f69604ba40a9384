"""The reference's PyTorch-Lightning ``.ckpt`` → zest_tpu_torch's state dict
(``convert.convert_checkpoint``) against zest_tpu's converter followed by
``from_jax_params``, on the CPU.

The reference state dicts are made from a seed in the reference's names
and layouts (as ``tests/test_convert_full.py`` makes them), with and without
scene flow and with ``time_codes``, InPlaceABN's running statistics
included (both converters drop them), and saved as Lightning saves them,
the hyper-parameters pickled beside the state dict. The two conversions
must agree key for key and bit for bit; the converted weights then give
the port's eval maps within ``tests/test_torch_eval_slice.py``'s tolerance
of zest_tpu's on the same weights (rtol 1e-4, atol 1e-5).
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zest_tpu import convert as jconvert
from zest_tpu.config import ZestConfig as JZestConfig
from zest_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from zest_tpu.system import ZestSystem as JZestSystem

from test_convert_full import _fake_mvsnet, _fake_nerf

from zest_tpu_torch import ZestConfig
from zest_tpu_torch.convert import convert_checkpoint, from_jax_params
from zest_tpu_torch.system import EVAL_KEYS, STATIC_EVAL_KEYS, ZestSystem, to_batch

WIDTH = 32
TOY = dict(pad=4, num_keyframes=3, netdepth=8, netwidth=WIDTH, multires=4,
           multires_views=2, N_samples=8, batch_size=16, img_h=32, img_w=64,
           pts_embedder=True, dir_embedder=True, use_viewdirs=True)
CASES = {
    "sceneflow": dict(TOY, train_sceneflow=True, use_mvs=True,
                      use_mvs_dy=True),
    "static": dict(TOY, train_sceneflow=False, use_mvs=True, use_mvs_dy=False,
                   num_input=3),
    "time_codes": dict(TOY, train_sceneflow=False, use_mvs=True,
                       use_mvs_dy=False, num_input=3, train_video=True,
                       time_code_dim=16),
}


class Scaled:
    """A numpy generator whose normals are scaled by ``scale``, so that the
    fake weights' activations stay O(1) through eight layers."""

    def __init__(self, seed, scale):
        self.rng, self.scale = np.random.default_rng(seed), scale

    def normal(self, size):
        return self.rng.normal(size=size) * self.scale


def reference_state_dict(case: str, rng) -> dict:
    """A reference ``MVSNeRFSystem`` state dict of ``case``, from rng."""
    cfg = ZestConfig(**CASES[case])
    in_pts = 3 * (2 * cfg.multires + 1)
    in_views = 3 * (2 * cfg.multires_views + 1)
    sd = {}
    if cfg.train_sceneflow:
        _fake_nerf(sd, "nerf_static.nerf", in_pts, cfg.feat_dim, in_views,
                   WIDTH, 8, rng, static=True)
        _fake_nerf(sd, "nerf_dynamic.nerf", 4 * (2 * cfg.multires + 1),
                   cfg.feat_dim_dy, in_views, WIDTH, 8, rng, static=False)
        _fake_mvsnet(sd, "encoding_net_dy", rng)
    else:
        code = cfg.time_code_dim if cfg.train_video else 0
        _fake_nerf(sd, "nerf_coarse.nerf", in_pts + code, cfg.feat_dim,
                   in_views, WIDTH, 8, rng, static=True)
        # the static field of a system without scene flow has no blend head
        del sd["nerf_coarse.nerf.w_linear.weight"]
        del sd["nerf_coarse.nerf.w_linear.bias"]
    _fake_mvsnet(sd, "encoding_net", rng)
    if cfg.train_video:
        sd["time_codes"] = rng.normal(size=(40, cfg.time_code_dim)).astype(
            np.float32)
    for k in [k for k in sd if k.endswith(".bn.weight")]:
        sd[k.replace(".weight", ".running_mean")] = np.zeros_like(sd[k])
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}


def save_lightning(path, sd) -> None:
    torch.save({"epoch": 3, "global_step": 1200, "pytorch-lightning_version":
                "1.5.10", "state_dict": sd,
                "hyper_parameters": argparse.Namespace(expname="ref", lrate=5e-4)},
               path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_checkpoint_matches_zest_tpu(tmp_path, case):
    path = tmp_path / "ref.ckpt"
    save_lightning(path, reference_state_dict(case, np.random.default_rng(0)))
    # the weights-only unpickler refuses the pickled hyper-parameters
    with pytest.raises(Exception, match="Weights only load failed"):
        torch.load(path, weights_only=True)

    got = convert_checkpoint(path, ZestConfig(**CASES[case]))
    want = from_jax_params(jconvert.convert_checkpoint(
        path, JZestConfig(**CASES[case])))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert got[k].is_contiguous(), k
        assert torch.equal(got[k], want[k]), k
    # the port's system takes it whole
    ZestSystem(ZestConfig(**CASES[case])).load_state_dict(got, strict=True)
    assert not any("running" in k for k in got)


def test_converted_checkpoint_eval_matches_zest_tpu(tmp_path):
    case = "sceneflow"
    path = tmp_path / "ref.ckpt"
    sd = reference_state_dict(case, Scaled(1, 0.1))
    for field in ("nerf_static", "nerf_dynamic"):
        # raise σ so the maps carry signal
        sd[f"{field}.nerf.alpha_linear.bias"] += 1.0
    save_lightning(path, sd)
    sample = JSyntheticDataset(img_h=32, img_w=64, num_frames=9,
                               num_keyframes=3)[3]
    jcfg = JZestConfig(**CASES[case])
    ref = JZestSystem(jcfg).make_eval_step()(
        jax.tree.map(jnp.asarray, jconvert.convert_checkpoint(path, jcfg)),
        {k: jnp.asarray(v) for k, v in sample.items()})

    system = ZestSystem(ZestConfig(**CASES[case]))
    system.load_state_dict(convert_checkpoint(path, system.cfg), strict=True)
    out = system.make_eval_step()(dict(system.state_dict()),
                                  to_batch(sample, "cpu"))
    assert set(out) == set(EVAL_KEYS) and set(STATIC_EVAL_KEYS) < set(out)
    for k in EVAL_KEYS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("rgb_map", "rgb_map_ref"):
        assert float(out[k].std()) > 1e-3, k
