"""Driver: 3inFusion's training step, as ``Thre3inFusionModel.train`` drives
it.

Set-up makes the inputs from the seed (the blob scene at the traffic's size
as the trained scene, serialized density ++ features and normalized per
channel group by the program, and the UNet's weights: one normal draw on
the card, scaled by each kernel's fan-in, loaded into the program's UNet and
the reference's alike), builds the program's model (the CLI's UNet and
cosine diffusion) and Adam, and takes the judged steps through the window's
own feed. A unit is one ``train_step`` on a batch of random crops (the
program's ``crop_batch`` at offsets drawn from the seed) with uniform
timesteps and Gaussian noise: closed loop.

``correct`` compares the judged steps with the plain reference
(``reference/unet_plain.py``), which recomputes the normalization, the
crops and the forward process from the same seed's grid, offsets,
timesteps and noise, one crop at a time.
"""
from __future__ import annotations

import math

import torch

import training
from reference import scene
from reference import unet_plain as ref


def crop_side(size: int, ratio: float, levels: int) -> int:
    """The crop side holding ``ratio`` of a size^3 grid's voxels, rounded down
    to the UNet's granularity 2^(levels - 1)."""
    side = min(int(math.ceil((float(size) ** 3 * ratio) ** (1.0 / 3.0))), size)
    g = 2 ** (levels - 1)
    return max((side // g) * g, g)


def seeded_weights(seed: int, model: torch.nn.Module, device) -> dict:
    """A state dict for ``model``'s parameter names and shapes: kernels
    normal / sqrt(fan-in) from one draw on the device, biases zero, norm
    scales one."""
    named = list(model.named_parameters())
    total = sum(p.numel() for _, p in named)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, p in named:
        n = p.numel()
        if p.dim() >= 2:
            out[name] = flat[at:at + n].view(p.shape) / math.sqrt(n // p.shape[0])
        elif name.endswith("norm.weight"):
            out[name] = torch.ones(p.shape, device=device)
        else:
            out[name] = torch.zeros(p.shape, device=device)
        at += n
    return out


class Driver:
    frames_per_unit = 1

    def __init__(self, ctx):
        from thr3ed_atom_tpu_torch.diffusion.gaussian_diffusion import (
            GaussianDiffusion,
            LossType,
            ModelMeanType,
            ModelVarType,
            get_named_beta_schedule,
        )
        from thr3ed_atom_tpu_torch.diffusion.model import (
            Thre3inFusionModel,
            crop_batch,
            normalize_grid,
            strict_f32,
        )
        from thr3ed_atom_tpu_torch.diffusion.unet import UNetModel

        self.ctx = ctx
        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.cfg, self.tr, self.dev = cfg, tr, dev
        self._crop_batch = crop_batch
        strict_f32()
        size = int(tr["scene_size"])
        levels = len(cfg["channel_mult"])
        self.side = crop_side(size, cfg["crop_ratio"], levels)
        self.batch = int(cfg["batch_size"])
        self.steps = int(cfg["num_timesteps"])

        # inputs from the seed
        d0, f0 = scene.blob_scene(size, ctx.seed, dev, 3 * (cfg["sh_degree"] + 1) ** 2)
        self.raw = torch.cat([d0, f0], dim=-1)  # [W, D, H, 1 + F]
        del d0, f0
        channels = self.raw.shape[-1]
        self.ref_shape = dict(channels=channels, base=cfg["model_channels"],
                              mult=tuple(cfg["channel_mult"]),
                              num_res_blocks=cfg["num_res_blocks"], heads=cfg["num_heads"])
        with torch.device("meta"):
            template = ref.UNet(**self.ref_shape)
        self.weights_seed = ctx.seed
        weights = seeded_weights(ctx.seed, template, dev)
        self.gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)

        # the program's model and optimizer
        with torch.device(dev):
            unet = UNetModel(
                in_channels=channels, model_channels=cfg["model_channels"],
                out_channels=channels, num_res_blocks=cfg["num_res_blocks"],
                attention_resolutions=(), use_bottleneck_attn=True,
                channel_mult=tuple(cfg["channel_mult"]), conv_resample=True, dims=3,
                num_classes=None, use_checkpoint=cfg["use_checkpoint"],
                num_heads=cfg["num_heads"], num_head_channels=-1,
                use_scale_shift_norm=True, resblock_updown=False)
        unet.load_state_dict(weights)
        del weights
        diffusion = GaussianDiffusion(
            betas=get_named_beta_schedule(cfg["beta_schedule"], self.steps),
            model_mean_type=ModelMeanType.EPSILON, model_var_type=ModelVarType.FIXED_SMALL,
            loss_type=LossType.MSE, rescale_timesteps=False)
        self.model = Thre3inFusionModel(unet=unet, diffusion=diffusion, device=dev)
        self.grid, _, _ = normalize_grid(self.raw)
        self.optimizer = torch.optim.Adam(self.model.unet.parameters(), lr=cfg["learning_rate"],
                                          betas=(0.9, 0.999), eps=1e-8)
        self.losses = []
        self.judged = []
        self.prog = self._judged_steps()
        self.losses = []

    # ------------------------------------------------------------------ feed

    def _feed(self):
        """(crop offsets [B, 3], timesteps [B], noise [B, s, s, s, C]) of a step."""
        size = self.raw.shape[0]
        offsets = torch.randint(0, max(size - self.side, 1), (self.batch, 3), generator=self.gen,
                                device=self.dev)
        t = torch.randint(0, self.steps, (self.batch,), generator=self.gen, device=self.dev)
        noise = torch.randn((self.batch, self.side, self.side, self.side, self.raw.shape[-1]),
                            generator=self.gen, device=self.dev)
        return offsets, t, noise

    def _step(self, offsets, t, noise):
        if self.ctx.fault == "half_batch":
            h = self.batch // 2
            offsets, t, noise = offsets[:h], t[:h], noise[:h]
        restore = (training.freeze_step(self.optimizer, list(self.model.unet.parameters()))
                   if self.ctx.fault == "frozen" else None)
        batch = self._crop_batch(self.grid, offsets, (self.side,) * 3)
        loss = self.model.train_step(self.optimizer, batch, t, noise)
        if restore is not None:
            restore()
        return loss

    def _judged_steps(self):
        params = [p for _, p in sorted(self.model.unet.named_parameters())]
        start = [p.detach().clone() for p in params]
        losses, grad = [], None
        for i in range(int(self.tr["judged_steps"])):
            offsets, t, noise = self._feed()
            self.judged.append((offsets.cpu(), t.cpu(), noise.cpu()))
            losses.append(float(self._step(offsets, t, noise)))
            if i == 0:
                grad = training.first_moment_norms(self.optimizer, params)
        return {"losses": losses, "grad": grad,
                "change": training.change_norms(params, start, self.dev)}

    # ---------------------------------------------------------------- window

    def run_unit(self):
        self.losses.append(self._step(*self._feed()))

    def close_window(self):
        values = [float(v) for v in self.losses]
        return len(values), sum(not math.isfinite(v) for v in values)

    def release(self):
        del self.model, self.optimizer, self.grid, self.losses
        if self.dev.startswith("cuda"):
            torch.cuda.empty_cache()

    # --------------------------------------------------------------- judge

    def reference_readings(self, dt=torch.float32):
        with torch.device(self.dev):
            unet = ref.UNet(**self.ref_shape)
        unet.load_state_dict(seeded_weights(self.weights_seed, unet, self.dev))
        unet = unet.to(dt)
        params = [p for _, p in sorted(unet.named_parameters())]
        start = [p.detach().float().clone() for p in params]
        schedule = ref.cosine_schedule(self.steps)
        grid = ref.normalize(self.raw)
        state, losses, grad = {}, [], None
        for i, (offsets, t, noise) in enumerate(self.judged):
            x0 = ref.crops(grid, offsets.tolist(), self.side)
            t = t.to(self.dev)
            total, sums = 0.0, None
            for b in range(x0.shape[0]):  # one crop at a time: the batch mean's terms
                loss, grads = ref.loss_and_grads(unet, params, x0[b:b + 1], t[b:b + 1],
                                                 noise[b:b + 1].to(self.dev), schedule, dt)
                total += loss / x0.shape[0]
                sums = grads if sums is None else [s + g for s, g in zip(sums, grads)]
            grads = [s / x0.shape[0] for s in sums]
            losses.append(total)
            if i == 0:
                grad = training.norms(grads)
            ref.adam_update(params, grads, state, self.cfg["learning_rate"])
        change = [float((p.detach().float() - s).double().norm()) for p, s in zip(params, start)]
        return {"losses": losses, "grad": grad, "change": change}

    def judge(self):
        prog = self.reference_readings(torch.bfloat16) if self.ctx.fault == "control" else self.prog
        return training.checks(prog, self.reference_readings(), self.ctx.limits)
