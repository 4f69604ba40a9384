"""``ZestSystem``: the model stack and its full-image eval step (counterpart of
``zest_tpu.system``, eval path only).

``make_eval_step()(params, batch)`` builds the static and dynamic encoding
volumes once, then renders the target view in fixed-size ray chunks with a
plain Python loop. ``params`` is a state dict (from ``init_params`` or
``convert.from_jax_params``) applied with ``torch.func.functional_call``;
``batch`` is a dataset sample as tensors on one device (``to_batch``). On a
CUDA device every kernel of the path is the port's own: the plane-sweep warp,
the volume lookup, the color gather and the fused field.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from . import render, sampling
from .data.synthetic import IMAGENET_MEAN, IMAGENET_STD
from .geometry import normalize_frame_idx
from .kernels.fused_mlp import fused_nerf_forward
from .kernels.trilinear import sample_volume
from .models import MVSEncoder, NeRFField
from .models.embedding import embedding_out_channels
from .models.feature_net import BatchNormAct


EVAL_KEYS = ("rgb_map", "depth_map", "rgb_map_ref", "depth_map_ref",
             "rgb_map_ref_dy", "depth_map_ref_dy", "weights_map_dd")


def unpreprocess(imgs):
    """Invert the ImageNet normalization. imgs [..., 3]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=imgs.dtype, device=imgs.device)
    std = torch.tensor(IMAGENET_STD, dtype=imgs.dtype, device=imgs.device)
    return imgs * std + mean


def to_batch(sample: dict, device) -> dict:
    """A dataset sample (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in sample.items()}


def _check_supported(cfg) -> None:
    """The port covers the two-field, two-volume, float32 eval path."""
    unsupported = {
        "train_sceneflow=False": not cfg.train_sceneflow,
        "use_mvs=False": not cfg.use_mvs,
        "use_mvs_dy=False": not cfg.use_mvs_dy,
        f"net_type={cfg.net_type!r}": cfg.net_type != "v0",
        "train_video": cfg.train_video,
        "use_color_volume": cfg.use_color_volume,
        f"precision={cfg.precision}": cfg.precision != 32 or cfg.bf16,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"zest_tpu_torch does not port {bad} yet")


class ZestSystem(nn.Module):
    """Builds the fields and encoders for a config; exposes the eval step."""

    def __init__(self, cfg):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        multires = cfg.multires if cfg.pts_embedder else 0
        multires_views = cfg.multires_views if cfg.dir_embedder else 0
        in_ch_views = embedding_out_channels(cfg.dir_dim, multires_views)
        self.nerf_static = NeRFField(
            cfg.netdepth, cfg.netwidth, embedding_out_channels(cfg.pts_dim, multires),
            in_ch_views, cfg.feat_dim, static=True)
        self.nerf_dynamic = NeRFField(
            cfg.netdepth, cfg.netwidth,
            embedding_out_channels(cfg.pts_dim + 1, multires), in_ch_views,
            cfg.feat_dim_dy, static=False)
        self.enc_static = MVSEncoder()
        # the neighbour proj_mats of the dynamic volume are identity
        self.enc_dy = MVSEncoder(identity_src_warp=True)
        self.multires, self.multires_views = multires, multires_views

    def init_params(self, generator: torch.Generator) -> dict:
        """Fresh weights drawn with ``generator``, in the distributions of
        ``zest_tpu/models/init.py`` (PyTorch's defaults): weights and Linear
        biases U(±1/sqrt(fan_in)), conv biases 0, BatchNorm scale 1, shift 0.
        fan_in is counted on this port's layers, so the first cost-volume
        conv has 41 input channels where the TPU package pads to 48."""
        params = {}
        dev = generator.device
        for name, p in self.named_parameters():
            mod_name, _, leaf = name.rpartition(".")
            mod = self.get_submodule(mod_name)
            if isinstance(mod, BatchNormAct):
                params[name] = (torch.ones if leaf == "weight" else torch.zeros)(
                    p.shape, device=dev)
                continue
            if isinstance(mod, nn.Linear):
                fan_in = mod.in_features
            elif isinstance(mod, (nn.Conv2d, nn.Conv3d)):
                if leaf == "bias":
                    params[name] = torch.zeros(p.shape, device=dev)
                    continue
                fan_in = p.shape[1] * math.prod(p.shape[2:])
            elif isinstance(mod, nn.ConvTranspose3d):
                fan_in = p.shape[0] * math.prod(p.shape[2:])
            else:
                raise TypeError(f"no initializer for {name} ({type(mod)})")
            bound = 1.0 / math.sqrt(fan_in)
            params[name] = (torch.rand(p.shape, generator=generator, device=dev)
                            * 2.0 - 1.0) * bound
        return params

    # ------------------------------------------------------------------
    def render_models(self, batch) -> render.RenderModels:
        """Builds the static and the dynamic encoding volume and binds them,
        the fields and the kernels into the callables ``render_rays`` takes."""
        cfg = self.cfg
        near_far = batch["near_fars"][0]
        static_vol, _, _ = self.enc_static(batch["images"][:-1],
                                           batch["proj_mats"][:-1], near_far,
                                           pad=cfg.pad)
        dyn_vol, _, _ = self.enc_dy(batch["nb_imgs"], batch["nb_proj_mats"],
                                    near_far, pad=cfg.pad)
        src_imgs = unpreprocess(batch["images"][:-1])
        nb_imgs_un = unpreprocess(batch["nb_imgs"])

        def static_feats(pts_world, ndc):
            # poses cut to the source views, as the reference indexes them
            col = render.build_color_features(pts_world, src_imgs,
                                              batch["w2cs"][:-1],
                                              batch["intrinsics"][:-1])
            return torch.cat([sample_volume(static_vol, ndc), col], -1)

        return render.RenderModels(
            static_fn=lambda p, f, v: fused_nerf_forward(self.nerf_static,
                                                         p, f, v),
            dynamic_fn=lambda p, f, v: fused_nerf_forward(self.nerf_dynamic,
                                                          p, f, v),
            static_feats=static_feats,
            dynamic_vol=lambda ndc: sample_volume(dyn_vol, ndc),
            dynamic_col=lambda pts: render.build_color_features(
                pts, nb_imgs_un, batch["nb_w2cs"], batch["nb_intr"]),
            multires=self.multires, multires_views=self.multires_views)

    def _chunk(self, H, W) -> int:
        return min(self.cfg.eval_chunk or self.cfg.chunk, H * W)

    def chunk_rays(self, batch, idx: int, imgs_un=None) -> sampling.RayBatch:
        """The idx-th chunk of the target (last) view's rays, the last chunk
        padded by repeats of the last pixel. ``imgs_un`` is
        ``unpreprocess(batch["images"])`` when the caller has it."""
        cfg = self.cfg
        _, H, W, _ = batch["images"].shape
        if imgs_un is None:
            imgs_un = unpreprocess(batch["images"])
        xs, ys = sampling.sample_pixels_grid(H, W, self._chunk(H, W), idx,
                                             device=imgs_un.device)
        return sampling.build_rays(
            xs, ys, images=imgs_un, depths=batch["depths"], w2cs=batch["w2cs"],
            c2ws=batch["c2ws"], intrinsics=batch["intrinsics"],
            near_fars=batch["near_fars"], n_samples=cfg.N_samples, pad=cfg.pad)

    def render_kwargs(self, batch) -> dict:
        """The reference poses and time ``render_rays`` takes for this batch."""
        return dict(im_w2c_ref=batch["w2cs"][0], nb_w2c_ref=batch["nb_w2cs"][0],
                    ref_frame_idx=normalize_frame_idx(batch["time"],
                                                      batch["total_frames"]),
                    white_bkgd=self.cfg.white_bkgd)

    def forward(self, batch):
        """Full-image eval of the batch's target view -> dict of [H, W, ...],
        rendered in chunks of ``eval_chunk`` rays."""
        _, H, W, _ = batch["images"].shape
        models = self.render_models(batch)
        imgs_un = unpreprocess(batch["images"])
        kwargs = self.render_kwargs(batch)
        outs = [render.render_rays(models, self.chunk_rays(batch, idx, imgs_un),
                                   **kwargs)
                for idx in range(-(-(H * W) // self._chunk(H, W)))]
        return {k: torch.cat([o[k] for o in outs])[:H * W]
                .reshape(H, W, *outs[0][k].shape[1:]) for k in EVAL_KEYS}

    def make_eval_step(self):
        """Returns eval_step(params, batch) → maps of [H, W, ...]."""

        def eval_step(params, batch):
            with torch.no_grad():
                return torch.func.functional_call(self, params, (batch,))

        return eval_step
