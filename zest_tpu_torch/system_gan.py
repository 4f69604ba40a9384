"""The adversarial (SVS) training step (counterpart of
``zest_tpu.system_gan``): one step updates the generator, then the image
discriminator, then the depth discriminator when the config has one.

- The generator's loss: lambda_adv adv(D(fake), 1), the feature matching of
  ``getIntermFeat``, the depth discriminator's adv(DD(depth), 1), the
  depth reconstruction (elementwise), lambda_rec MSE, and the regularizers
  and the perceptual loss each times its lambda once (the non-GAN branch
  double-scales them: ``system.ZestSystem.compute_losses``). The
  discriminators run at the step's discriminator parameters and
  spectral state; their new spectral state is dropped and they get no
  gradient.
- The discriminator's loss, on the same forward's detached outputs:
  (adv(D(fake), 0) + adv(D(real), 1)) / 2, the fake patch first; its call
  advances GRAF's spectral ``u`` and the real patch's call starts from that
  ``u``, so ``u`` advances twice per step.
- adv: binary cross-entropy on clipped outputs for ``gan_loss="naive"``,
  else least squares.
- Optimizers: the generator's is the system's (clip, Adam, cosine); the
  discriminators' Adam (lrate_disc) has no clip and a cosine stepped once
  per epoch down to 1e-7; the depth discriminator has its own state on the
  same schedule.

The discriminators and LPIPS run in float32 at either precision.

With ``system.mesh`` (``parallel.make_mesh``) the ranks of a process group
split the step's rays, as ``zest_tpu``'s GSPMD splits them over a mesh:
each rank renders its shard and gathers every rank's outputs
(``ZestSystem.render_split``), so the generator's loss, LPIPS and the
discriminators see whole patches, identically on every rank; the
generator's gradients are the ranks' shares summed (``sum_over_ranks``)
before the clip and Adam. Every rank takes the discriminators' steps on
the same gathered patches, and rank 0's gradients and spectral state
stand for all (``replicate_all``), so that the ranks' discriminators stay
equal bit for bit. A ray count that does not divide the ranks warns and
runs whole on every rank (``shard_rays``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from . import sampling
from .losses import abs_
from .models.discriminators import (NLayerDiscriminator, SpectralConv,
                                    build_discriminator, spectral_state)
from .models.lpips import load_lpips
from .parallel.mesh import replicate_all, sum_over_ranks
from .system import Optimizer, Phase, ZestSystem


class GanTrainState(NamedTuple):
    params: dict                  # the generator's (fields and encoders)
    disc_params: dict
    depth_disc_params: dict       # empty without ``with_depth_loss``
    opt_state: dict
    disc_opt_state: dict
    depth_disc_opt_state: dict
    disc_vars: dict               # GRAF's spectral ``u``s, by buffer name
    step: int

    def to(self, device) -> "GanTrainState":
        def move(x):
            if isinstance(x, dict):
                return {k: move(v) for k, v in x.items()}
            return x.to(device) if isinstance(x, torch.Tensor) else x
        return GanTrainState(*(move(x) for x in self))


def adversarial_loss(cfg, pred, target_ones: bool):
    target = torch.ones_like(pred) if target_ones else torch.zeros_like(pred)
    if cfg.gan_loss == "naive":
        p = torch.clamp(pred, 1e-7, 1 - 1e-7)
        return -torch.mean(target * torch.log(p)
                           + (1 - target) * torch.log(1 - p))
    return torch.mean((pred - target) ** 2)


def adversarial_conditioning(cfg, preds, deltas=None) -> float:
    """How far differences ``deltas`` in the discriminator outputs ``preds``
    (lists of tensors; 1e-6 each when None) move ``adversarial_loss``'s
    gradient, relative to that gradient: 0 for the least-squares loss; for
    the naive one, whose gradient is 1/p (or 1/(1 - p)) between its clips,
    the largest delta / min(p, 1 - p) over the outputs it does not clip.
    Holds a gradient that reads the loss on two evaluations that round
    differently."""
    if cfg.gan_loss != "naive":
        return 0.0
    worst = 0.0
    for i, pred in enumerate(preds):
        p = pred.detach().reshape(-1)
        d = (torch.full_like(p, 1e-6) if deltas is None
             else deltas[i].detach().reshape(-1).to(p.device))
        kept = (p > 1e-7) & (p < 1 - 1e-7)
        if kept.any():
            rel = d[kept] / torch.minimum(p[kept], 1 - p[kept])
            worst = max(worst, float(rel.max()))
    return worst


def apply_disc(disc: nn.Module, params: dict, spectral: dict, x):
    """``disc(x)`` at ``params`` and the spectral state ``spectral`` ->
    (its output, the spectral state after the call; ``spectral`` as it is
    without spectral norm)."""
    out = torch.func.functional_call(disc, {**params, **spectral}, (x,))
    return out, (spectral_state(disc) if spectral else spectral)


def init_disc(disc: nn.Module, generator: torch.Generator) -> tuple:
    """(parameters, buffers) of ``disc`` drawn with ``generator`` in
    ``zest_tpu``'s distributions: weights and Linear biases
    U(+-1/sqrt(fan_in)), conv biases 0, BatchNorm 1 and 0; the spectral
    ``u`` standard normal."""
    dev = generator.device
    params = {}
    for name, p in disc.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        mod = disc.get_submodule(mod_name)
        if isinstance(mod, (nn.Conv2d, SpectralConv)) and leaf == "bias" or \
                not isinstance(mod, (nn.Linear, nn.Conv2d, SpectralConv)):
            fill = torch.ones if leaf == "weight" else torch.zeros
            params[name] = fill(p.shape, device=dev)
            continue
        fan_in = mod.weight.shape[1] * math.prod(mod.weight.shape[2:])
        bound = 1.0 / math.sqrt(fan_in)
        params[name] = (torch.rand(p.shape, generator=generator, device=dev)
                        * 2.0 - 1.0) * bound
    buffers = {name: torch.randn(b.shape, generator=generator, device=dev)
               for name, b in disc.named_buffers()}
    return params, buffers


class _TrainForward(nn.Module):
    """``forward_train`` as a module's forward, so that ``functional_call``
    binds the generator's parameters (keys ``system.*``)."""

    def __init__(self, system: ZestSystem):
        super().__init__()
        self.system = system

    def forward(self, batch, draws, phase, step):
        return self.system.forward_train(batch, draws, phase, step)


class GanSystem(nn.Module):
    """``ZestSystem`` with the discriminator of ``gan_type``, the depth
    discriminator (PatchGAN on depth) with ``with_depth_loss``, and LPIPS
    with ``with_perceptual_loss``, which refuses to train without
    ``lpips_weights``."""

    def __init__(self, system: ZestSystem):
        super().__init__()
        self.system = system
        self.cfg = cfg = system.cfg
        self.disc = build_discriminator(cfg)
        self.depth_disc = (NLayerDiscriminator(cfg.patch_size, 1, 64, 3)
                           if cfg.with_depth_loss else None)
        self.lpips = None
        if cfg.with_perceptual_loss:
            if not cfg.lpips_weights:
                raise RuntimeError(
                    "--with_perceptual_loss set but --lpips_weights missing: "
                    "refusing to train without the perceptual term (give a "
                    "local LPIPS .npz, models/lpips.py)")
            self.lpips = load_lpips(cfg.lpips_weights)

    def init(self, generator: torch.Generator,
             steps_per_epoch: int = 1) -> GanTrainState:
        """Fresh generator and discriminator weights and optimizer states,
        drawn with ``generator`` on its device."""
        params = self.system.init_params(generator)
        disc_params, disc_vars = init_disc(self.disc, generator)
        depth = ({} if self.depth_disc is None
                 else init_disc(self.depth_disc, generator)[0])
        opt = self.system.make_optimizer(steps_per_epoch)
        d_opt = self.make_disc_optimizer(steps_per_epoch)
        return GanTrainState(
            params, disc_params, depth, opt.init(params),
            d_opt.init(disc_params),
            {} if self.depth_disc is None else d_opt.init(depth),
            disc_vars, 0)

    def make_disc_optimizer(self, steps_per_epoch: int = 1) -> Optimizer:
        """Adam (0.9, 0.999) at ``lrate_disc``, no clip, cosine-annealed
        once per epoch down to 1e-7."""
        cfg = self.cfg
        eps_min = 1e-7

        def lr_fn(count: int) -> float:
            epoch = min(count // max(steps_per_epoch, 1), cfg.num_epochs)
            return eps_min + (cfg.lrate_disc - eps_min) * 0.5 * (
                1.0 + math.cos(math.pi * epoch / cfg.num_epochs))

        return Optimizer(lr_fn, clip=False)

    # ------------------------------------------------------------------
    def _patch_rays(self, n_rays: int) -> int:
        P = self.cfg.patch_size
        return P * P if P > 0 else n_rays

    def generator_loss(self, results, rays, state: GanTrainState):
        """(G_loss, logs) of the training render ``results``."""
        cfg = self.cfg
        rgb_pred, rgb_gt = results["rgb_map"].float(), rays.color_gt
        depth_pred = results["depth_map"][..., None].float()
        ppx = self._patch_rays(rgb_pred.shape[0])
        d_fake, _ = apply_disc(self.disc, state.disc_params, state.disc_vars,
                               rgb_pred.reshape(-1, ppx, 3))
        if cfg.getIntermFeat:
            interm_fake, d_fake = d_fake[:-1], d_fake[-1]
        g_fake_loss = cfg.lambda_adv * adversarial_loss(cfg, d_fake, True)
        g_feat_loss = 0.0
        if cfg.getIntermFeat:
            d_real, _ = apply_disc(self.disc, state.disc_params,
                                   state.disc_vars, rgb_gt.reshape(-1, ppx, 3))
            for ff, fr in zip(interm_fake, d_real[:-1]):
                g_feat_loss = g_feat_loss + torch.mean(abs_(ff - fr))
        g_depth_fake_loss = 0.0
        if self.depth_disc is not None:
            dd, _ = apply_disc(self.depth_disc, state.depth_disc_params, {},
                               depth_pred.reshape(-1, ppx, 1))
            g_depth_fake_loss = adversarial_loss(cfg, dd, True)
        rec_depth_loss = 0.0
        if cfg.with_depth_loss_rec:
            # elementwise ([R, 1] against [R, 1]): the reference broadcasts
            # [R, 1] - [R] to [R, R]
            rec_depth_loss = torch.mean((depth_pred
                                         - rays.depth_gt[..., None]) ** 2)
        g_rec_loss = cfg.lambda_rec * torch.mean((rgb_pred - rgb_gt) ** 2)
        regs = sum(self.system.regularizers(results, rays).values(), 0.0)
        perc_loss = 0.0
        if self.lpips is not None:
            P = cfg.patch_size
            pp = rgb_pred.reshape(-1, P, P, 3)
            gp = rgb_gt.reshape(-1, P, P, 3)
            perc = sum(self.lpips(a, b) for a, b in zip(pp, gp))
            perc_loss = cfg.lambda_perc * perc / pp.shape[0]
        total = (g_fake_loss + g_feat_loss + g_depth_fake_loss
                 + rec_depth_loss + g_rec_loss + regs + perc_loss)
        return total, {"G_fake_loss": g_fake_loss, "G_rec_loss": g_rec_loss,
                       "G_loss": total}

    def generator_update(self, state: GanTrainState, batch, draws, phase,
                         optimizer: Optimizer):
        """The generator's step: (new params, new optimizer state, logs,
        the render's detached (rgb_pred, rgb_gt, depth_pred, depth_gt)).
        With ``system.mesh`` the outputs are every rank's, and the
        gradients are summed over the ranks before the update."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        with torch.enable_grad():
            results, rays = torch.func.functional_call(
                _TrainForward(self.system),
                {f"system.{k}": v for k, v in leaves.items()},
                (batch, draws, phase, state.step))
            total, logs = self.generator_loss(results, rays, state)
            grads = torch.autograd.grad(total, list(leaves.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        mesh = self.system.mesh
        if mesh is not None and mesh.splits(draws.jitter.shape[0]):
            grads = sum_over_ranks(grads, mesh)
        with torch.no_grad():
            params, opt_state = optimizer.update(grads, state.opt_state,
                                                 state.params)
        outs = (results["rgb_map"].float(), rays.color_gt,
                results["depth_map"][..., None].float(), rays.depth_gt)
        return (params, opt_state, {k: v.detach() for k, v in logs.items()},
                tuple(t.detach() for t in outs))

    def _disc_grads(self, disc, params: dict, spectral: dict, fake, real,
                    interm: bool = False):
        """(loss, its fake and real terms, the spectral state after both
        calls, the gradients by name) of a discriminator's step; with
        ``interm`` the outputs are feature lists, the last one judged.
        With ``system.mesh`` the gradients and the spectral state are rank
        0's on every rank."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            d_fake, vars1 = apply_disc(disc, leaves, spectral, fake)
            d_real, vars2 = apply_disc(disc, leaves, vars1, real)
            if interm:
                d_fake, d_real = d_fake[-1], d_real[-1]
            l_fake = adversarial_loss(self.cfg, d_fake, False)
            l_real = adversarial_loss(self.cfg, d_real, True)
            loss = (l_fake + l_real) / 2.0
            grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves, grads))
        if self.system.mesh is not None:
            shared = replicate_all(
                {**{f"grad.{k}": g for k, g in grads.items()},
                 **{f"spectral.{k}": u for k, u in vars2.items()}},
                self.system.mesh)
            grads = {k: shared[f"grad.{k}"] for k in grads}
            vars2 = {k: shared[f"spectral.{k}"] for k in vars2}
        return (loss.detach(), l_fake.detach(), l_real.detach(), vars2, grads)

    def discriminator_update(self, state: GanTrainState, outs,
                             disc_optimizer: Optimizer):
        """The image discriminator's step on the generator step's detached
        outputs ``outs``: (new params, new optimizer state, new spectral
        state, logs)."""
        rgb_pred, rgb_gt = outs[:2]
        ppx = self._patch_rays(rgb_pred.shape[0])
        loss, l_fake, l_real, new_vars, grads = self._disc_grads(
            self.disc, state.disc_params, state.disc_vars,
            rgb_pred.reshape(-1, ppx, 3), rgb_gt.reshape(-1, ppx, 3),
            self.cfg.getIntermFeat)
        with torch.no_grad():
            params, opt_state = disc_optimizer.update(
                grads, state.disc_opt_state, state.disc_params)
        return params, opt_state, new_vars, {
            "D_loss": loss, "D_fake_loss": l_fake, "D_real_loss": l_real}

    def depth_discriminator_update(self, state: GanTrainState, outs,
                                   disc_optimizer: Optimizer):
        """The depth discriminator's step: (new params, new optimizer state,
        logs)."""
        depth_pred, depth_gt = outs[2:]
        ppx = self._patch_rays(depth_pred.shape[0])
        loss, _, _, _, grads = self._disc_grads(
            self.depth_disc, state.depth_disc_params, {},
            depth_pred.reshape(-1, ppx, 1), depth_gt.reshape(-1, ppx, 1))
        with torch.no_grad():
            params, opt_state = disc_optimizer.update(
                grads, state.depth_disc_opt_state, state.depth_disc_params)
        return params, opt_state, {"D_depth_loss": loss}

    def make_train_step(self, optimizer: Optimizer,
                        disc_optimizer: Optimizer):
        """Returns train_step(state, batch, draws, phase) -> (new state,
        logs): the generator's update, then the discriminators'."""

        def train_step(state: GanTrainState, batch, draws: sampling.Draws,
                       phase: Phase):
            params, opt_state, logs, outs = self.generator_update(
                state, batch, draws, phase, optimizer)
            disc_params, disc_opt, disc_vars, d_logs = \
                self.discriminator_update(state, outs, disc_optimizer)
            logs.update(d_logs)
            depth_params = state.depth_disc_params
            depth_opt = state.depth_disc_opt_state
            if self.depth_disc is not None:
                depth_params, depth_opt, dd_logs = \
                    self.depth_discriminator_update(state, outs,
                                                    disc_optimizer)
                logs.update(dd_logs)
            logs["train_loss"] = logs["G_loss"]
            rgb_pred, rgb_gt = outs[:2]
            logs["train_PSNR"] = -10.0 * torch.log10(
                torch.mean((rgb_pred - rgb_gt) ** 2))
            return GanTrainState(params, disc_params, depth_params, opt_state,
                                 disc_opt, depth_opt, disc_vars,
                                 state.step + 1), logs

        return train_step
