"""``ZestSystem``: the model stack, its full-image eval step and its training
step (counterpart of ``zest_tpu.system``).

``make_eval_step()(params, batch)`` builds the config's encoding volumes
once, then renders the target view in fixed-size ray chunks with a plain
Python loop. ``make_eval_path_step()(params, batch, path_c2ws, path_w2cs)``
builds them once and renders the target view from each of P camera poses.
``make_train_step(optimizer)(state, batch, draws, phase)`` builds the
volumes, renders the step's rays (random pixels, square patches or GRAF's
patch) through the fields (with scene flow the t±1 and chain passes
included), takes the scene-flow loss bundle (without it the render MSE)
plus the patch regularizers the config switches on, and its gradients, and
applies Adam with global-norm clipping and a cosine learning rate
(``MultiSteps`` accumulates ``acc_grad`` steps' gradients). The
configurations: both fields (``train_sceneflow``) or the static one alone
(MVSNeRF's), each with its volume or without (NSFF's plain fields, the
one-volume ablations), v0 or v2 fields (``net_type``), the colour volume
(``use_color_volume``) and the learnable time codes (``train_video``); the
adversarial (SVS) step around it is ``system_gan.GanSystem``'s.
``params`` is a state dict (from ``init_params`` or
``convert.from_jax_params``) applied with ``torch.func.functional_call``;
``batch`` is a dataset sample as tensors on one device (``to_batch``);
``draws`` are the step's random numbers (``sampling.sample_draws``). With
``mesh`` set (``parallel.make_mesh``) the ranks of a process group split
each step's rays and each eval chunk's (``render_split``): every rank
renders its shard, gathers the others', takes the loss over all rays and
sums the gradients over the ranks; ranks that hold different draws are
refused. On a
CUDA device every kernel of both paths is the port's own: the plane-sweep
warp, the volume lookup, the color gather and the fused field, and on the
training path the backward of the warp, the lookup and the field, and with
time codes their fold into the field's biases; a field without a volume or
of net_type v2 is plain PyTorch, as it is ``zest_tpu``'s Flax module.
Callers on the card turn TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``) for float32 results.

``cfg.precision == 16`` (or ``cfg.bf16``) is ``zest_tpu``'s 16-bit path: bf16
encoders (convolutions, BatchNorm application, cost volume), the fields'
bf16-operand mode, the unwarped volume lookups and the color gather on
bf16-rounded volumes and images, and the flow-warped lookups (t±1, the
chain) as a row gather of a bf16 volume (``ops.grid_sample.
grid_sample_3d_rows``). Parameters and the encoding volumes stay float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from . import render, sampling
from .data.common import IMAGENET_MEAN, IMAGENET_STD
from .geometry import normalize_frame_idx
from .losses import (distortion_loss, get_disparity_smoothness,
                     sceneflow_losses, total_variation_loss)
from .render import EVAL_KEYS, STATIC_EVAL_KEYS
from .kernels.fused_mlp import fused_nerf_forward
from .kernels.trilinear import sample_volume
from .models import MVSEncoder, NeRFField
from .models.embedding import embedding_out_channels
from .models.feature_net import BatchNormAct
from .models.nerf import append_code, round_bf16
from .ops.grid_sample import grid_sample_3d_rows
from .parallel.mesh import (check_replicated, gather_rays, shard_rays,
                             sum_over_ranks)


def unpreprocess(imgs):
    """Invert the ImageNet normalization. imgs [..., 3]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=imgs.dtype, device=imgs.device)
    std = torch.tensor(IMAGENET_STD, dtype=imgs.dtype, device=imgs.device)
    return imgs * std + mean


def to_batch(sample: dict, device) -> dict:
    """A dataset sample (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in sample.items()}


class Phase(NamedTuple):
    """The flags that change a training step's graph, from the host step."""
    extra_samples: bool = False   # motion-mask extra rays (step < decay * 1000)
    chain_5frames: bool = False   # the chain pass (step > decay * 2000)


def phase_for_step(cfg, step: int) -> Phase:
    decay = cfg.decay_iteration_clamped
    return Phase(
        extra_samples=bool(cfg.use_motion_mask and step < decay * 1000),
        chain_5frames=bool(cfg.with_chain_loss and step > decay * 1000 * 2))


class TrainState(NamedTuple):
    params: dict                  # name -> tensor, the state dict's layout
    opt_state: dict               # "mu", "nu": dicts like params; "count": int
    step: int


class Optimizer:
    """Global-norm clip at 1.0, then Adam (0.9, 0.999, eps 1e-8) at the
    learning rate ``lr_fn(count)`` of the updates already made: optax's
    ``chain(clip_by_global_norm(1.0), adam(schedule))`` written out; with
    ``clip=False`` optax's ``adam(schedule)`` alone. ``leaf_lr`` maps a
    leaf's name to a schedule of its own (optax's ``multi_transform`` of
    Adams after the clip, which runs over every leaf)."""
    B1, B2, EPS, MAX_NORM = 0.9, 0.999, 1e-8, 1.0

    def __init__(self, lr_fn, clip: bool = True, leaf_lr: dict = None):
        self.lr_fn = lr_fn
        self.clip = clip
        self.leaf_lr = leaf_lr or {}

    def init(self, params: dict) -> dict:
        return {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()},
                "count": 0}

    def update(self, grads: dict, opt_state: dict, params: dict):
        """Returns (new params, new optimizer state)."""
        b1, b2 = self.B1, self.B2
        if self.clip:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            keep = g_norm < self.MAX_NORM
        count = opt_state["count"] + 1
        lrs = {k: fn(opt_state["count"]) for k, fn in self.leaf_lr.items()}
        lr = self.lr_fn(opt_state["count"])
        c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        mu, nu, new = {}, {}, {}
        for k, p in params.items():
            # optax divides by the norm only when it reaches MAX_NORM
            g = grads[k] if not self.clip else torch.where(
                keep, grads[k], grads[k] / g_norm * self.MAX_NORM)
            mu[k] = (1.0 - b1) * g + b1 * opt_state["mu"][k]
            nu[k] = (1.0 - b2) * g * g + b2 * opt_state["nu"][k]
            new[k] = p - lrs.get(k, lr) * ((mu[k] / c1) /
                                           (torch.sqrt(nu[k] / c2) + self.EPS))
        return new, {"mu": mu, "nu": nu, "count": count}


class MultiSteps:
    """Gradient accumulation, optax's ``MultiSteps(inner, k)``: each call
    folds the gradient into a running mean (acc + (g - acc) / (n + 1)); the
    k-th call hands the mean to ``inner`` and starts a new one, the others
    leave the parameters as they are. ``inner``'s learning rate therefore
    counts optimizer steps, one per k calls."""

    def __init__(self, inner: Optimizer, k: int):
        self.inner, self.k = inner, k

    def init(self, params: dict) -> dict:
        return {"inner": self.inner.init(params), "mini_step": 0,
                "acc": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(self, grads: dict, opt_state: dict, params: dict):
        n = opt_state["mini_step"]
        acc = {k: a + (grads[k] - a) / (n + 1)
               for k, a in opt_state["acc"].items()}
        if n + 1 < self.k:
            return params, dict(opt_state, mini_step=n + 1, acc=acc)
        new, inner = self.inner.update(acc, opt_state["inner"], params)
        return new, {"inner": inner, "mini_step": 0,
                     "acc": {k: torch.zeros_like(v) for k, v in acc.items()}}


N_TIME_CODES = 40   # learnable time codes of train_video (the reference's)


def _check_supported(cfg) -> None:
    """The port covers the eval and training paths of fields with view
    directions, v0 or v2 (``net_type``), with or without scene flow
    (``train_sceneflow``: the static field alone, or both fields), with
    each field's volume or without it (``use_mvs``, ``use_mvs_dy``), the
    colour volume (``use_color_volume``), the learnable time codes
    (``train_video``), patches and GRAF's patch (``patch_size``,
    ``gan_type``), the depth, smoothness and distortion regularizers, at
    32- and 16-bit precision; the GAN branch itself is
    ``system_gan.GanSystem``. It refuses by name any other precision (a v2
    field without its volume, which ``zest_tpu`` cannot run either, is
    refused by ``NeRFField``)."""
    if cfg.precision not in (16, 32):
        raise NotImplementedError(
            f"zest_tpu_torch does not port precision={cfg.precision}")


class ZestSystem(nn.Module):
    """Builds the fields and encoders for a config; exposes the eval step
    (its forward) and the training step.

    As ``zest_tpu`` builds them: the static field (its extra head, the
    blend, only with scene flow), the dynamic field only with scene flow,
    each conditioned on its volume when the config has it, and an encoder
    per volume (``enc_static`` with ``use_mvs``, ``enc_dy`` with
    ``use_mvs_dy``), and with ``train_video`` the [N_TIME_CODES,
    time_code_dim] ``time_codes``. A conditioned v0 field runs the fused
    kernels; one without a volume, or of net_type v2, is the plain module,
    float32 at either precision (``zest_tpu``'s Flax field). The static
    field of ``train_video`` reads the embedded points and then the time
    code (its ``code_dim``)."""

    def __init__(self, cfg):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.bf16 = cfg.precision == 16 or cfg.bf16
        enc_dtype = torch.bfloat16 if self.bf16 else torch.float32
        multires = cfg.multires if cfg.pts_embedder else 0
        multires_views = cfg.multires_views if cfg.dir_embedder else 0
        in_ch_views = embedding_out_channels(cfg.dir_dim, multires_views)
        sceneflow = cfg.train_sceneflow
        v0 = cfg.net_type == "v0"
        code_dim = int(cfg.time_code_dim) if cfg.train_video else 0
        self.nerf_static = NeRFField(
            cfg.netdepth, cfg.netwidth, embedding_out_channels(cfg.pts_dim, multires),
            in_ch_views, cfg.feat_dim, static=True, sceneflow=sceneflow,
            use_mvs=cfg.use_mvs, bf16=self.bf16 and cfg.use_mvs and v0,
            net_type=cfg.net_type, code_dim=code_dim)
        self.nerf_dynamic = self.enc_static = self.enc_dy = None
        if sceneflow:
            self.nerf_dynamic = NeRFField(
                cfg.netdepth, cfg.netwidth,
                embedding_out_channels(cfg.pts_dim + 1, multires), in_ch_views,
                cfg.feat_dim_dy, static=False, use_mvs=cfg.use_mvs_dy,
                bf16=self.bf16 and cfg.use_mvs_dy and v0,
                net_type=cfg.net_type)
        if cfg.train_video:
            self.time_codes = nn.Parameter(torch.zeros(N_TIME_CODES, code_dim))
        if cfg.use_mvs:
            self.enc_static = MVSEncoder(dtype=enc_dtype)
        if cfg.use_mvs_dy:
            # the neighbour proj_mats of the dynamic volume are identity
            self.enc_dy = MVSEncoder(identity_src_warp=True, dtype=enc_dtype)
        self.multires, self.multires_views = multires, multires_views
        self.eval_keys = EVAL_KEYS if sceneflow else STATIC_EVAL_KEYS
        # a process group's ranks split the rays (parallel.make_mesh)
        self.mesh = None

    def init_params(self, generator: torch.Generator) -> dict:
        """Fresh weights drawn with ``generator``, in the distributions of
        ``zest_tpu/models/init.py`` (PyTorch's defaults): weights and Linear
        biases U(±1/sqrt(fan_in)), conv biases 0, BatchNorm scale 1, shift 0.
        fan_in is counted on this port's layers, so the first cost-volume
        conv has 41 input channels where the TPU package pads to 48. The
        time codes, drawn last, are N(0, 1) * 0.01 / sqrt(time_code_dim), as
        ``zest_tpu``'s."""
        params = {}
        dev = generator.device
        for name, p in self.named_parameters():
            if name == "time_codes":
                continue
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
        if self.cfg.train_video:
            shape = self.time_codes.shape
            params["time_codes"] = torch.randn(
                shape, generator=generator, device=dev) * (0.01 / shape[1] ** 0.5)
        return params

    def time_code(self, batch):
        """sigmoid(time_codes[keyframe_id]) [time_code_dim], the static
        field's time code for this batch. A batch without ``keyframe_id``
        (only the Neural 3D Video loader gives one) or with one outside the
        N_TIME_CODES codes is an error: ``zest_tpu``'s gather would clamp it
        to the last code, the reference's index would raise."""
        if "keyframe_id" not in batch:
            raise ValueError("train_video reads the batch's keyframe_id, "
                             "which only the Neural 3D Video loader "
                             "(dataset_name neural3Dvideo) gives")
        kid = int(batch["keyframe_id"])
        if not 0 <= kid < N_TIME_CODES:
            raise ValueError(f"keyframe_id {kid} is outside the "
                             f"{N_TIME_CODES} time codes of train_video "
                             f"(zest_tpu would clamp it to code "
                             f"{min(max(kid, 0), N_TIME_CODES - 1)})")
        return torch.sigmoid(self.time_codes[kid])

    # ------------------------------------------------------------------
    def render_models(self, batch) -> render.RenderModels:
        """Builds the encoding volumes the config has and binds them, the
        fields and the kernels into the callables ``render_rays`` takes: a
        conditioned field through the fused kernels, one without a volume
        as the plain module with no features.

        At 16-bit precision the unwarped lookups read the volume rounded to
        bf16 (each call rounds it, and its gradient, again), the color gather
        reads bf16-rounded images, and the warped lookups take
        ``grid_sample_3d_rows`` on the volume cast to bf16. The rounding is
        ``zest_tpu``'s; the float32 weights of its MXU-formed interpolations
        stay float32 here.

        With ``use_color_volume`` the static features are one lookup of the
        colour volume (``render.append_color_volume``, from the float32
        images, built once here), rounded whole to bf16 at 16-bit
        precision; the gradient reaches its first 8 channels, the encoding
        volume's. With ``train_video`` the static field takes the batch's
        time code (``time_code``): the fused field folds it into its biases,
        the plain one reads it after the embedded points."""
        cfg = self.cfg
        near_far = batch["near_fars"][0]
        rnd = round_bf16 if self.bf16 else (lambda t: t)

        def field_fn(field, code=None):
            if field.fused:
                return lambda p, f, v: fused_nerf_forward(field, p, f, v, code)
            if code is None:
                return field
            return lambda p, f, v: field(append_code(p, code), f, v)

        static_feats = None
        if self.enc_static is not None:
            static_vol, _, _ = self.enc_static(
                batch["images"][:-1], batch["proj_mats"][:-1], near_far,
                pad=cfg.pad)
        if self.enc_static is not None and cfg.use_color_volume:
            lead = rnd(static_vol)
            combined = rnd(render.append_color_volume(
                static_vol.detach(), unpreprocess(batch["images"][:-1]),
                batch["w2cs"], batch["intrinsics"], near_far, cfg.pad))

            def static_feats(pts_world, ndc):
                return sample_volume(combined, ndc, lead)
        elif self.enc_static is not None:
            src_imgs = rnd(unpreprocess(batch["images"][:-1]))

            def static_feats(pts_world, ndc):
                # poses cut to the source views, as the reference indexes them
                col = render.build_color_features(pts_world, src_imgs,
                                                  batch["w2cs"][:-1],
                                                  batch["intrinsics"][:-1])
                return torch.cat([sample_volume(rnd(static_vol), ndc), col],
                                 -1)

        dynamic = {}
        if self.enc_dy is not None:
            dyn_vol, _, _ = self.enc_dy(batch["nb_imgs"], batch["nb_proj_mats"],
                                        near_far, pad=cfg.pad)
            nb_imgs_un = rnd(unpreprocess(batch["nb_imgs"]))
            dynamic = dict(
                dynamic_vol=lambda ndc: sample_volume(rnd(dyn_vol), ndc),
                dynamic_col=lambda pts: render.build_color_features(
                    pts, nb_imgs_un, batch["nb_w2cs"], batch["nb_intr"]))
            if self.bf16:
                dynamic["dynamic_vol_warped"] = lambda ndc: grid_sample_3d_rows(
                    dyn_vol.to(torch.bfloat16), ndc * 2.0 - 1.0)

        code = self.time_code(batch) if cfg.train_video else None
        return render.RenderModels(
            static_fn=field_fn(self.nerf_static, code),
            dynamic_fn=(None if self.nerf_dynamic is None
                        else field_fn(self.nerf_dynamic)),
            static_feats=static_feats, multires=self.multires,
            multires_views=self.multires_views, **dynamic)

    def _chunk(self, H, W) -> int:
        chunk = min(self.cfg.eval_chunk or self.cfg.chunk, H * W)
        if self.mesh is not None:
            # a whole shard for every rank, rounded as zest_tpu rounds it
            chunk = max(chunk // self.mesh.size * self.mesh.size,
                        self.mesh.size)
        return chunk

    def render_split(self, render_fn, rays: sampling.RayBatch,
                     draws: sampling.Draws = None) -> dict:
        """``render_fn(rays, draws)``, a dict of per-ray outputs. With
        ``mesh`` it runs on this rank's contiguous shard of the rays (and of
        the draws' per-ray density noise) and every output is gathered
        from all ranks, so each rank returns all rays' outputs, with a
        gradient to its own shard only; a ray count that does not divide
        the mesh warns and runs whole on every rank."""
        mesh = self.mesh
        if mesh is None:
            return render_fn(rays, draws)
        local = rays._replace(**{k: shard_rays(v, mesh)
                                 for k, v in rays._asdict().items()
                                 if v is not None and k != "t_vals"})
        if draws is not None:
            draws = draws._replace(**{
                k: shard_rays(getattr(draws, k), mesh)
                for k in sampling.NOISE_FIELDS if getattr(draws, k) is not None})
        out = render_fn(local, draws)
        if not mesh.splits(rays.pts.shape[0]):
            return out
        return {k: gather_rays(v, mesh) for k, v in out.items()}

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

    def render_kwargs(self, batch, w2cs=None) -> dict:
        """The reference poses and time ``render_rays`` takes for this batch
        (slot 0 of ``w2cs``, the batch's by default)."""
        w2cs = batch["w2cs"] if w2cs is None else w2cs
        nb_w2cs = batch.get("nb_w2cs")   # no neighbours: views unrotated
        return dict(im_w2c_ref=w2cs[0],
                    nb_w2c_ref=None if nb_w2cs is None else nb_w2cs[0],
                    ref_frame_idx=normalize_frame_idx(
                        batch.get("time", 0.0), batch.get("total_frames", 1.0)),
                    white_bkgd=self.cfg.white_bkgd)

    def eval_image(self, models, batch, imgs_un, c2ws, w2cs):
        """The full image of the target camera, the last slot of ``c2ws`` /
        ``w2cs``, rendered with ``models`` in chunks of ``eval_chunk`` rays
        -> dict of [H, W, ...]. The models (the volumes, the color
        conditioning) read only the source views, so a new target pose needs
        no new models."""
        _, H, W, _ = batch["images"].shape
        pose_batch = dict(batch, c2ws=c2ws, w2cs=w2cs)
        kwargs = self.render_kwargs(batch, w2cs)
        outs = [self.render_split(
                    lambda rays, _: render.render_rays(models, rays, **kwargs),
                    self.chunk_rays(pose_batch, idx, imgs_un))
                for idx in range(-(-(H * W) // self._chunk(H, W)))]
        return {k: torch.cat([o[k] for o in outs])[:H * W]
                .reshape(H, W, *outs[0][k].shape[1:]) for k in self.eval_keys}

    def forward(self, batch, path_c2ws=None, path_w2cs=None):
        """The full-image eval of the batch's target view -> dict of
        [H, W, ...]; given ``path_c2ws`` / ``path_w2cs`` [P, 4, 4], that of
        the target camera put at each of the P poses in turn -> dict of
        [P, H, W, ...]. The volumes are built once either way."""
        models = self.render_models(batch)
        imgs_un = unpreprocess(batch["images"])
        c2ws, w2cs = batch["c2ws"], batch["w2cs"]
        if path_c2ws is None:
            return self.eval_image(models, batch, imgs_un, c2ws, w2cs)
        maps = [self.eval_image(models, batch, imgs_un,
                                torch.cat([c2ws[:-1], c2w[None]]),
                                torch.cat([w2cs[:-1], w2c[None]]))
                for c2w, w2c in zip(path_c2ws, path_w2cs)]
        return {k: torch.stack([m[k] for m in maps]) for k in self.eval_keys}

    def make_eval_step(self):
        """Returns eval_step(params, batch) → maps of [H, W, ...]."""

        def eval_step(params, batch):
            with torch.no_grad():
                return torch.func.functional_call(self, params, (batch,))

        return eval_step

    def make_eval_path_step(self):
        """Returns eval_path_step(params, batch, path_c2ws [P, 4, 4],
        path_w2cs [P, 4, 4]) → maps of [P, H, W, ...]: the batch's encoding
        volumes and render models built once, then the full image from each
        pose in turn (a bullet-time path)."""

        def eval_path_step(params, batch, path_c2ws, path_w2cs):
            with torch.no_grad():
                return torch.func.functional_call(
                    self, params, (batch, path_c2ws, path_w2cs))

        return eval_path_step

    # ------------------------------------------------------------------
    def make_optimizer(self, steps_per_epoch: int) -> Optimizer:
        """Adam (0.9, 0.999) after a global-norm clip at 1.0, its learning
        rate cosine-annealed per epoch from ``lrate`` down to 1e-7; the time
        codes of ``train_video`` on the same cosine from ``lrate * 10``."""
        cfg = self.cfg
        eps_min = 1e-7

        def schedule(base_lr):
            def lr_fn(count: int) -> float:
                epoch = min(count // max(steps_per_epoch, 1), cfg.num_epochs)
                return eps_min + (base_lr - eps_min) * 0.5 * (
                    1.0 + math.cos(math.pi * epoch / cfg.num_epochs))
            return lr_fn

        leaf_lr = ({"time_codes": schedule(cfg.lrate * 10)}
                   if cfg.train_video else None)
        return Optimizer(schedule(cfg.lrate), leaf_lr=leaf_lr)

    def train_rays(self, batch, draws: sampling.Draws, phase: Phase):
        """The step's rays: the draws' pixels (random ones, square patches
        or GRAF's patch, ``sampling.sample_pixels``), plus the motion-mask
        pixels in the extra-samples phase of a scene-flow system, with the
        draws' depth jitter."""
        cfg = self.cfg
        xs, ys = draws.xs, draws.ys
        if phase.extra_samples and cfg.train_sceneflow:
            hx, hy = sampling.sample_motion_pixels(batch["motion_coords"],
                                                   draws.motion_idx)
            xs, ys = torch.cat([xs, hx]), torch.cat([ys, hy])
        return sampling.build_rays(
            xs, ys, images=unpreprocess(batch["images"]),
            depths=batch["depths"], w2cs=batch["w2cs"], c2ws=batch["c2ws"],
            intrinsics=batch["intrinsics"], near_fars=batch["near_fars"],
            n_samples=cfg.N_samples, pad=cfg.pad, jitter=draws.jitter,
            flow_fwd=batch.get("flow_fwd"), flow_bwd=batch.get("flow_bwd"),
            mask_fwd=batch.get("mask_fwd"), mask_bwd=batch.get("mask_bwd"))

    def forward_train(self, batch, draws: sampling.Draws, phase: Phase,
                      step: int):
        """One training forward: the volumes, the step's rays and the
        training render. Returns (results, rays). With ``mesh`` every rank
        must hold the same draws and step (``RanksDisagree`` otherwise)."""
        if self.mesh is not None:
            check_replicated(dict(draws._asdict(), step=torch.tensor(
                float(step), device=draws.jitter.device)), self.mesh, "draws")
        models = self.render_models(batch)
        rays = self.train_rays(batch, draws, phase)
        kwargs = self.render_kwargs(batch)
        results = self.render_split(
            lambda rays, draws: render.render_rays_train(
                models, rays, draws, **kwargs,
                num_frames=batch.get("total_frames", 1.0),
                # the two-frame chain alternates every step, t-2 first
                chain_bwd=step % 2 == 0, chain_5frames=phase.chain_5frames,
                raw_noise_std=self.cfg.raw_noise_std), rays, draws)
        return results, rays

    def regularizers(self, results, rays) -> dict:
        """The patch regularizers the config switches on, each times its
        lambda: ``tv_depth_loss`` (total variation of each patch's depth),
        ``depth_smooth_loss`` (its image-weighted smoothness) and
        ``distortion_loss``. The depth and the RGB are the static render's,
        reshaped to [patches, P, P, ...]."""
        cfg = self.cfg
        P = cfg.patch_size
        depth = results["depth_map"][..., None]
        out = {}
        if cfg.with_depth_loss_reg:
            out["tv_depth_loss"] = cfg.lambda_depth_reg * \
                total_variation_loss(depth.reshape(-1, P, P))
        if cfg.with_depth_smoothness:
            out["depth_smooth_loss"] = cfg.lambda_depth_smooth * \
                get_disparity_smoothness(depth.reshape(-1, P, P, 1),
                                         results["rgb_map"].reshape(-1, P, P, 3))
        if cfg.with_distortion_loss:
            out["distortion_loss"] = cfg.lambda_distortion * \
                distortion_loss(results["weights"], rays.t_vals)
        return out

    def compute_losses(self, results, rays, batch, step: int, phase: Phase):
        """The scene-flow loss bundle, or without scene flow the static
        render's MSE (``render_loss``), plus the regularizers
        (``regularizers``) times their lambda once more, as the reference
        double-scales them → (train_loss, logs), with the logs of
        ``zest_tpu.system.ZestSystem.compute_losses``."""
        cfg = self.cfg
        regs = self.regularizers(results, rays)
        if not cfg.train_sceneflow:
            total = torch.mean((results["rgb_map"] - rays.color_gt) ** 2)
            logs = {"render_loss": total, **regs}
        else:
            _, H, W, _ = batch["images"].shape
            total, sf_logs = sceneflow_losses(
                cfg, results, rays, step=step, frame_t=batch["time"],
                total_frames=batch["total_frames"], H=H, W=W,
                focal=batch["intrinsics"][-1, 0, 0],
                fnb_w2cs=batch["fnb_w2cs"], chain_bwd=step % 2 == 0,
                chain_5frames=phase.chain_5frames)
            logs = {**regs, **sf_logs, "sceneflow_loss": total}
        lam = {"tv_depth_loss": cfg.lambda_depth_reg,
               "depth_smooth_loss": cfg.lambda_depth_smooth,
               "distortion_loss": cfg.lambda_distortion}
        for k, v in regs.items():
            total = total + lam[k] * v
        logs["train_loss"] = total
        mse = torch.mean((results["rgb_map"] - rays.color_gt) ** 2)
        logs["train_PSNR"] = -10.0 * torch.log10(mse)
        return total, logs

    def loss_and_grads(self, params: dict, batch, draws: sampling.Draws,
                       phase: Phase, step: int):
        """(train_loss, logs, grads) of one step at ``params``; grads has
        params' keys. The logs are detached. With ``mesh`` (the rays split
        over its ranks) the gradients are summed over the ranks: every rank
        returns the whole step's."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            total, logs = torch.func.functional_call(
                _TrainLoss(self), {f"system.{k}": v for k, v in leaves.items()},
                (batch, draws, phase, step))
            grads = torch.autograd.grad(total, list(leaves.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        if self.mesh is not None and self.mesh.splits(draws.jitter.shape[0]):
            grads = sum_over_ranks(grads, self.mesh)
        return total.detach(), {k: v.detach() for k, v in logs.items()}, grads

    def make_train_step(self, optimizer: Optimizer):
        """Returns train_step(state, batch, draws, phase) → (new state,
        logs): one step's loss and gradients at state.params, then the
        optimizer's update."""

        def train_step(state: TrainState, batch, draws: sampling.Draws,
                       phase: Phase):
            _, logs, grads = self.loss_and_grads(state.params, batch, draws,
                                                 phase, state.step)
            with torch.no_grad():
                params, opt_state = optimizer.update(grads, state.opt_state,
                                                     state.params)
            return TrainState(params, opt_state, state.step + 1), logs

        return train_step


class _TrainLoss(nn.Module):
    """A training step's (loss, logs) as a module's forward, so that
    ``functional_call`` binds the step's parameters (keys ``system.*``)."""

    def __init__(self, system: ZestSystem):
        super().__init__()
        self.system = system

    def forward(self, batch, draws: sampling.Draws, phase: Phase, step: int):
        results, rays = self.system.forward_train(batch, draws, phase, step)
        return self.system.compute_losses(results, rays, batch, step, phase)
