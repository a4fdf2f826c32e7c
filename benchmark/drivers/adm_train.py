"""Driver: ADM's UNet trained on 3-D crops through 3inFusion's
``Thre3inFusionModel.train_step``, in fp16 under its dynamic loss scale.

Set-up makes the inputs from the seed (the blob scene at the traffic's
size, serialized density ++ features and normalized per channel group by
the program, and the UNet's weights: one normal draw on the card, scaled by
each kernel's fan-in, as ``diffusion_train``'s driver draws them, loaded
into the program's UNet and the reference's alike), builds the program's
model (ADM's UNet, the cosine 1000-step LEARNED_RANGE / RESCALED_MSE
diffusion, the EMA) and Adam (AdamW with weight decay 0), and runs warm
steps until the loss scale has skipped none in its last
``clean_warm_steps``. The judged steps follow at once, once. A unit is
one ``train_step`` on a batch of random crops (the program's ``crop_batch``
at offsets drawn from the seed) with uniform timesteps, Gaussian noise and
dropout: closed loop.

``correct`` compares the judged steps with the plain reference
(``reference/adm_plain.py``) one crop at a time. Both start from the state
the program's warm-up left: its master weights, Adam moments, step count
and EMA; the reference takes the program's loss scale and dropout masks
(recorded by wrapping the program's ``dropout`` during the judged steps).
Compared: the loss gap; ``grad_gap``, the norm of the difference of the
whole first unscaled gradient over the reference's norm (fp16's round-off
against bf16's); ``grad_median_gap``, the median leaf's gap of its norms
by leaf (``leaves``, ``training``'s rule); the change's norms by leaf; the
EMA's change by leaf; and a judged step the program skipped. The gradient
is not judged by its worst leaf: fp16 loses much of the q and k gradient of
the attention blocks at ds 2 and 4 (read to standard error), and the worst
of the other leaves spreads over seeds from 0.008 to 0.05. Each logit's
gradient, P ~ 1 / N times dO . v over N tokens (32,768 at ds 2, 4,096 at
ds 4), is rounded to fp16 before the sum over keys and falls under fp16's
smallest subnormal, in the flash backward as in ADM's own fp16
``QKVAttention`` (``tests/test_torch_adm.py``, the ``gpu`` case on 32,768
tokens). Faults for ``readings.py``: ``control`` (the program's UNet in
bf16 in place of fp16), ``half_batch``, ``frozen``, ``ema_rate`` (the EMA
at 0.999; all from the judged steps on).
"""
from __future__ import annotations

import math
import statistics
import sys

import torch

import harness
import training
from reference import adm_plain as ref
from reference import scene

_base = harness.load_driver("diffusion_train")
seeded_weights = _base.seeded_weights
crop_side = _base.crop_side


def leaf_names(named):
    """The names of ``leaves``' entries, a qkv projection's thirds as
    ``<name>:q``, ``:k`` and ``:v``."""
    out = []
    for name, _ in named:
        out.extend([f"{name}:{part}" for part in "qkv"] if name.split(".")[-2] == "qkv"
                   else [name])
    return out


def leaves(named, tensors):
    """The tensors by leaf, each attention block's qkv projection taken as
    its q, k and v thirds: softmax ignores a shift common to all keys, so
    the k bias's gradient is zero but for round-off, which Adam scales to
    full-size steps; as a leaf of its own it falls under the round-off rule
    of ``training.gaps``."""
    out = []
    for (name, _), t in zip(named, tensors):
        out.extend(torch.chunk(t, 3, dim=0) if name.split(".")[-2] == "qkv" else [t])
    return out


class _MaskRecorder:
    """The program's ``dropout`` as it computes it, keeping the masks of the
    first ``count`` calls (one forward; a recomputed block redraws them)."""

    def __init__(self, count: int):
        self.count, self.masks = count, []

    def __call__(self, h, p):
        out, mask = torch.native_dropout(h, p, True)
        if len(self.masks) < self.count:
            self.masks.append(mask.cpu())
        return out


class Driver:
    frames_per_unit = 1

    def __init__(self, ctx):
        from thr3ed_atom_tpu_torch.diffusion import unet as unet_module
        from thr3ed_atom_tpu_torch.diffusion.gaussian_diffusion import (
            GaussianDiffusion,
            LossType,
            ModelMeanType,
            ModelVarType,
            get_named_beta_schedule,
        )
        from thr3ed_atom_tpu_torch.diffusion.model import (
            FP16_SCALE_GROWTH,
            INITIAL_LG_LOSS_SCALE,
            Thre3inFusionModel,
            crop_batch,
            normalize_grid,
            strict_f32,
        )

        self.ctx = ctx
        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.cfg, self.tr, self.dev = cfg, tr, dev
        self._unet_module, self._crop_batch = unet_module, crop_batch
        strict_f32()
        size = int(tr["scene_size"])
        self.side = crop_side(size, cfg["crop_ratio"], len(cfg["channel_mult"]))
        self.batch = int(cfg["batch_size"])
        self.steps = int(cfg["num_timesteps"])

        # inputs from the seed
        d0, f0 = scene.blob_scene(size, ctx.seed, dev, 3 * (cfg["sh_degree"] + 1) ** 2)
        self.raw = torch.cat([d0, f0], dim=-1)  # [W, D, H, 1 + F]
        del d0, f0
        channels = self.raw.shape[-1]
        self.ref_shape = dict(
            channels=channels, base=cfg["model_channels"], mult=tuple(cfg["channel_mult"]),
            num_res_blocks=cfg["num_res_blocks"],
            attention_ds=tuple(cfg["attention_resolutions"]),
            head_channels=cfg["num_head_channels"], groups=cfg["norm_groups"],
            dropout=cfg["dropout"], out_channels=2 * channels)
        if (cfg["initial_lg_loss_scale"], cfg["fp16_scale_growth"]) != (
                INITIAL_LG_LOSS_SCALE, FP16_SCALE_GROWTH):
            raise ValueError("the configuration's loss scale is not the program's")
        with torch.device("meta"):
            shape = ref.UNet(**self.ref_shape)
        ds_of = {f"{n}.qkv.": m.ds for n, m in shape.named_modules()
                 if isinstance(m, ref.Attention)}
        self.names = leaf_names(sorted(shape.named_parameters()))
        # the downsample factor of each attention block's q and k thirds, None elsewhere
        self.qk_ds = [next((ds for at, ds in ds_of.items() if n.startswith(at)), None)
                      if n[-2:] in (":q", ":k") else None for n in self.names]
        self.gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)

        # the program's model and optimizer
        with torch.device(dev):
            unet = unet_module.UNetModel(
                in_channels=channels, model_channels=cfg["model_channels"],
                out_channels=2 * channels, num_res_blocks=cfg["num_res_blocks"],
                attention_resolutions=tuple(cfg["attention_resolutions"]),
                use_bottleneck_attn=True, channel_mult=tuple(cfg["channel_mult"]),
                dims=3, num_classes=None, use_checkpoint=cfg["use_checkpoint"],
                num_heads=1, num_head_channels=cfg["num_head_channels"],
                use_scale_shift_norm=cfg["use_scale_shift_norm"],
                resblock_updown=cfg["resblock_updown"], dropout=cfg["dropout"],
                norm_groups=cfg["norm_groups"], use_fp16=cfg["use_fp16"])
        unet.load_state_dict(seeded_weights(ctx.seed, unet, dev))
        if ctx.fault == "control":
            unet.compute_dtype = torch.bfloat16
        self.blocks = sum(isinstance(m, unet_module.ResBlock) for m in unet.modules())
        diffusion = GaussianDiffusion(
            betas=get_named_beta_schedule(cfg["noise_schedule"], self.steps),
            model_mean_type=ModelMeanType.EPSILON, model_var_type=ModelVarType.LEARNED_RANGE,
            loss_type=LossType.RESCALED_MSE, rescale_timesteps=False)
        self.model = Thre3inFusionModel(unet=unet, diffusion=diffusion, device=dev,
                                        ema_rate=cfg["ema_rate"])
        self.grid, _, _ = normalize_grid(self.raw)
        self.optimizer = torch.optim.Adam(self.model.unet.parameters(), lr=cfg["learning_rate"],
                                          betas=(0.9, 0.999), eps=1e-8)
        self.losses = []
        self.warm_steps = 0
        self.warm_steps = self._warm_up()
        self.judged = []
        self.prog = self._judged_pair()
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
        fault = self.ctx.fault if self.warm_steps else ""  # faults act after the warm-up
        if fault == "half_batch":
            h = self.batch // 2
            offsets, t, noise = offsets[:h], t[:h], noise[:h]
        restore = self._freeze() if fault == "frozen" else None
        batch = self._crop_batch(self.grid, offsets, (self.side,) * 3)
        loss = self.model.train_step(self.optimizer, batch, t, noise)
        if restore is not None:
            restore()
        return loss

    def _freeze(self):
        """``training.freeze_step`` with the snapshot on the host (a copy of
        the weights and moments on the card does not fit beside the step)."""
        params = list(self.model.unet.parameters())
        saved = [(p.detach().to("cpu", copy=True),
                  {k: v.to("cpu", copy=True) for k, v in self.optimizer.state[p].items()})
                 for p in params]

        def restore():
            with torch.no_grad():
                for p, (value, state) in zip(params, saved):
                    p.copy_(value)
                    for k, v in state.items():
                        self.optimizer.state[p][k].copy_(v)
        return restore

    def _warm_up(self) -> int:
        """Steps until the last ``clean_warm_steps`` skipped none."""
        clean, most = int(self.tr["clean_warm_steps"]), int(self.tr["max_warm_steps"])
        skipped = []
        while len(skipped) < clean or any(skipped[-clean:]):
            if len(skipped) == most:
                raise RuntimeError(f"the loss scale skipped steps in each {clean} of {most} "
                                   f"warm steps (lg_loss_scale {self.model.lg_loss_scale})")
            self._step(*self._feed())
            skipped.append(not self.model.took_step)
        return len(skipped)

    def _judged_pair(self):
        named = sorted(self.model.unet.named_parameters())
        params = [p for _, p in named]
        state = [self.optimizer.state[p] for p in params]
        at = {id(p): i for i, p in enumerate(self.model.unet.parameters())}
        ema = [self.model.ema[at[id(p)]] for p in params]
        self.start = {  # copies on the host, whatever the device
            "params": {n: p.detach().to("cpu", copy=True) for n, p in named},
            "exp_avg": [s["exp_avg"].to("cpu", copy=True) for s in state],
            "exp_avg_sq": [s["exp_avg_sq"].to("cpu", copy=True) for s in state],
            "step": int(state[0]["step"]),
            "ema": [e.to("cpu", copy=True) for e in ema],
        }
        if self.ctx.fault == "ema_rate":
            self.model.ema_rate = 0.999
        losses, grad, skipped = [], None, 0
        for i in range(int(self.tr["judged_steps"])):
            offsets, t, noise = self._feed()
            lg = self.model.lg_loss_scale
            scale = 1.0 if lg is None else 2.0 ** lg
            recorder, own = _MaskRecorder(self.blocks), self._unet_module.dropout
            self._unet_module.dropout = recorder
            try:
                losses.append(float(self._step(offsets, t, noise)))
            finally:
                self._unet_module.dropout = own
            self.judged.append((offsets.cpu(), t.cpu(), noise.cpu(), scale, recorder.masks))
            skipped += not self.model.took_step
            if i == 0:
                grads = leaves(named, [p.grad for p in params])
                grad = training.norms(grads)
                self.qk_zero = {}  # the share of zero elements by downsample factor
                for g, ds in zip(grads, self.qk_ds):
                    if ds is not None:
                        self.qk_zero.setdefault(ds, []).append(float((g == 0).double().mean()))
                del grads
                self.first_grad = [p.grad.to("cpu", copy=True) for p in params]
        start = [self.start["params"][n] for n, _ in named]
        change = [p.detach() - s.to(self.dev) for p, s in zip(params, start)]
        ema_change = [e - s.to(self.dev) for e, s in zip(ema, self.start["ema"])]
        return {"losses": losses, "grad": grad, "skipped": skipped,
                "change": training.norms(leaves(named, change)),
                "ema": training.norms(leaves(named, ema_change))}

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

    def reference_readings(self):
        """The judged steps in f32, one crop at a time, from the program's
        state before them."""
        ref.strict_f32()
        dev = self.dev
        with torch.device(dev):
            unet = ref.UNet(**self.ref_shape)
        unet.load_state_dict(self.start["params"])
        params = [p for _, p in sorted(unet.named_parameters())]
        exp_avg = [m.to(dev) for m in self.start["exp_avg"]]
        exp_avg_sq = [v.to(dev) for v in self.start["exp_avg_sq"]]
        ema = [e.to(dev, copy=True) for e in self.start["ema"]]
        step = self.start["step"]
        start = [p.detach().clone() for p in params]
        schedule = ref.Schedule(self.steps)
        grid = ref.normalize(self.raw)
        named = sorted(unet.named_parameters())
        losses, grad = [], None
        for i, (offsets, t, noise, scale, masks) in enumerate(self.judged):
            x0 = ref.crops(grid, offsets.tolist(), self.side)
            t = t.to(dev)
            total, sums = 0.0, None
            for b in range(self.batch):
                # a half-batch fault recorded masks of half the crops: reuse them
                crop_masks = [m[b % m.shape[0]:][:1].to(dev) for m in masks]
                loss, grads = ref.loss_and_grads(unet, params, x0[b:b + 1], t[b:b + 1],
                                                 noise[b:b + 1].to(dev), schedule, crop_masks,
                                                 weight=scale / self.batch)
                total += loss / self.batch
                sums = grads if sums is None else [s + g for s, g in zip(sums, grads)]
                del grads, crop_masks
            grads = [s * (1.0 / scale) for s in sums]
            del sums
            losses.append(total)
            if i == 0:
                grad = training.norms(leaves(named, grads))
                diff = sum(float((g - h.to(dev)).double().norm()) ** 2
                           for g, h in zip(grads, self.first_grad))
                grad_error = math.sqrt(diff) / math.sqrt(sum(x * x for x in grad))
            step += 1
            ref.adam_step(params, grads, exp_avg, exp_avg_sq, step, self.cfg["learning_rate"])
            ref.ema_update(ema, params, self.cfg["ema_rate"])
            del grads
        change = [p.detach() - s for p, s in zip(params, start)]
        ema_change = [e - s.to(dev) for e, s in zip(ema, self.start["ema"])]
        return {"losses": losses, "grad": grad, "grad_error": grad_error,
                "change": training.norms(leaves(named, change)),
                "ema": training.norms(leaves(named, ema_change))}

    def judge(self):
        prog, want = self.prog, self.reference_readings()
        moved = [g >= training.ROUNDOFF_LEAF * statistics.median(want["grad"])
                 for g in want["grad"]]
        scale = statistics.median(want["grad"])
        leaf = [abs(p - r) / max(r, scale, 1e-30) for p, r in zip(prog["grad"], want["grad"])]
        gaps = dict(training.gaps(prog, want), grad_gap=want["grad_error"],
                    grad_median_gap=statistics.median(leaf),
                    ema_gap=training._leaf_gap(prog["ema"], want["ema"], moved),
                    skipped_steps=float(prog["skipped"]))
        self._report(leaf)
        return [(name, gaps[name], float(limit)) for name, limit in self.ctx.limits.items()]

    def _report(self, leaf):
        """To standard error, the first gradient's gaps by leaf: the
        attention blocks' q and k thirds by downsample factor (worst gap,
        share of zero elements) and the three worst of the other leaves."""
        for ds in sorted(self.qk_zero):
            worst = max(g for g, d in zip(leaf, self.qk_ds) if d == ds)
            zero = self.qk_zero[ds]
            print(f"adm_train: q and k at ds {ds}: worst leaf gap {worst:.4g}, zero elements "
                  f"{min(zero):.4f}..{max(zero):.4f}", file=sys.stderr)
        top = sorted((g, n) for g, n, d in zip(leaf, self.names, self.qk_ds) if d is None)[-3:]
        print("adm_train: first gradient, worst leaves but q and k: "
              + ", ".join(f"{n} {g:.4g}" for g, n in reversed(top)), file=sys.stderr)
