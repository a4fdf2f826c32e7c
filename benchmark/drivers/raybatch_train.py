"""Driver: the ray-batch training step of one stage through the fast
two-phase renderer (``--render_procedure fast``), as ``modules/trainer.py``
drives it.

Set-up makes the stage's inputs from the seed (``stage.py``), builds the
stage's objects (``make_gnomonic_optimizer``, the trainer's optimizer for
every procedure, and ``TrainStepStatics`` with the CLI's render config) and
takes the judged steps. A unit is one ``ray_batch_train_step`` on a batch of
(image, pixel) pairs drawn uniformly over the stage's views and pixels, with
the samples' jitter, all drawn from the seed's generator: closed loop.

``correct`` compares the judged steps with the plain reference
(``reference/raybatch_plain.py``: direct trilinear taps, no packed tables)
from the same start grid, pixels and jitter. The control is the program's
own lower-precision path, bf16 feature tables (``fast_bf16_features``).
"""
from __future__ import annotations

import math
import time

import torch

import harness
import stage
import training
from reference import raybatch_plain as ref
from reference.gnomonic_plain import adam_update


class Driver:
    frames_per_unit = 1

    def __init__(self, ctx):
        from thr3ed_atom_tpu_torch.modules.trainer import (
            RayBatchDraws,
            TrainStepStatics,
            make_gnomonic_optimizer,
            ray_batch_train_step,
        )
        from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
        from thr3ed_atom_tpu_torch.utils.camera import CameraBounds

        self.ctx = ctx
        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.cfg, self.tr, self.dev = cfg, tr, dev
        self._step_fn, self._draws = ray_batch_train_step, RayBatchDraws
        self.inputs = stage.make(cfg, tr, ctx.seed, dev)
        t = time.perf_counter()
        size = self.inputs.size
        self.grid = stage.program_grid(self.inputs)
        self.params = (self.grid.densities, self.grid.features)
        self.optimizer, self.scheduler = make_gnomonic_optimizer(
            self.grid, stage.stage_lr(cfg), cfg["lr_decay_steps_per_stage"],
            cfg["lr_decay_gamma_per_stage"])
        render_config = SHVoxGridRenderConfig(
            num_samples_per_ray=cfg["train_num_samples_per_ray"],
            camera_bounds=CameraBounds(tr["near"], tr["far"]), white_bkgd=cfg["white_bkgd"],
            perturb_sampled_points=cfg["perturb_sampled_points"], fast_topk=cfg["fast_topk"],
            fast_bf16_features=ctx.fault == "control", fast_pack_features=True)
        self.statics = TrainStepStatics(
            render_config=render_config, image_height=size, image_width=size,
            focal=self.inputs.focal, ray_batch_size=int(cfg["ray_batch_size"]),
            apply_diffuse_render_regularization=cfg["apply_diffuse_render_regularization"],
            render_procedure=tr["render_procedure"])
        self.poses = torch.as_tensor(self.inputs.poses).to(dev)
        self.gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        self.losses, self.judged = [], []
        self.prog = self._judged_steps()
        harness.log("judged steps", t)
        self.losses = []

    def _feed(self, distinct=False):
        """(image indices, pixel indices, jitter [B, S]) of the next step,
        uniform over the views and pixels (``distinct``: no pair twice)."""
        B, S = int(self.cfg["ray_batch_size"]), int(self.cfg["train_num_samples_per_ray"])
        n, hw = len(self.inputs.poses), self.inputs.size ** 2
        if distinct:
            pairs = torch.randperm(n * hw, generator=self.gen, device=self.dev)[:B]
            img, pix = pairs // hw, pairs % hw
        else:
            img = torch.randint(0, n, (B,), generator=self.gen, device=self.dev)
            pix = torch.randint(0, hw, (B,), generator=self.gen, device=self.dev)
        return img, pix, torch.rand((B, S), generator=self.gen, device=self.dev)

    def _step(self, img, pix, t_rand):
        if self.ctx.fault == "half_batch":
            h = img.shape[0] // 2
            img, pix, t_rand = img[:h], pix[:h], t_rand[:h]
        restore = training.freeze_step(self.optimizer, self.params) if self.ctx.fault == "frozen" \
            else None
        metrics = self._step_fn(self.statics, self.optimizer, self.grid, self.inputs.images,
                                self.poses, draws=self._draws(img, pix, {"t_rand": t_rand}),
                                scheduler=self.scheduler)
        if restore is not None:
            restore()
        return metrics

    def _judged_steps(self):
        losses, grad = [], None
        for i in range(int(self.tr["judged_steps"])):
            img, pix, t_rand = self._feed(distinct=True)
            self.judged.append((img, pix, t_rand))
            losses.append(float(self._step(img, pix, t_rand)["total_loss"]))
            if i == 0:
                grad = training.first_moment_norms(self.optimizer, self.params)
        return {"losses": losses, "grad": grad,
                "change": training.change_norms(self.params, self.inputs.start, self.dev)}

    def run_unit(self):
        self.losses.append(self._step(*self._feed())["total_loss"])

    def close_window(self):
        values = [float(v) for v in self.losses]
        return len(values), sum(not math.isfinite(v) for v in values)

    def release(self):
        del self.grid, self.params, self.optimizer, self.scheduler, self.losses
        if self.dev.startswith("cuda"):
            torch.cuda.empty_cache()

    def judge(self):
        cfg, tr, inp = self.cfg, self.tr, self.inputs
        params = [t.to(self.dev).clone() for t in inp.start]
        state, losses, grad = {}, [], None
        extent = float(cfg["grid_world_size"][0])
        for i, (img, pix, t_rand) in enumerate(self.judged):
            loss, grads = ref.step_gradient(
                params[0], params[1], inp.density_scale, extent, inp.images, self.poses,
                inp.size, inp.size, inp.focal, img, pix, tr["near"], tr["far"], t_rand,
                int(cfg["fast_topk"]))
            losses.append(loss)
            if i == 0:
                grad = training.norms(grads)
            with torch.no_grad():
                adam_update(params, grads, state, stage.stage_lr(cfg))
        want = {"losses": losses, "grad": grad,
                "change": training.change_norms(params, inp.start, self.dev)}
        return training.checks(self.prog, want, self.ctx.limits)
