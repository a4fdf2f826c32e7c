"""Driver: the gnomonic whole-pose training step of one stage, as
``modules/trainer.py`` drives it.

Set-up makes the stage's inputs from the seed (``stage.py``), builds the
stage's objects (``make_gnomonic_optimizer`` with the staircase schedule,
the views' variant buckets from ``_pose_buckets``,
``make_gnomonic_train_statics`` per variant) and takes the judged steps and
one step of every other variant through the window's own feed. A unit is one
``gnomonic_train_step_multi`` on the poses-per-step views of a variant drawn
as the trainer draws them, with the phase jitter drawn from the seed's
generator: closed loop, each step after the last.

``correct`` compares the judged steps with the plain reference
(``reference/gnomonic_plain.py``) from the same start grid, views and
phases.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

import harness
import stage
import training
from reference import gnomonic_plain as ref


class Driver:
    frames_per_unit = 1

    def __init__(self, ctx):
        from thr3ed_atom_tpu_torch.modules.trainer import _pose_buckets, make_gnomonic_optimizer
        from thr3ed_atom_tpu_torch.rendering.gnomonic_train import (
            gnomonic_train_step_multi,
            make_gnomonic_train_statics,
        )

        self.ctx = ctx
        cfg, dev = ctx.config, ctx.device
        self.cfg, self.tr, self.dev = cfg, ctx.traffic, dev
        self._step_fn = gnomonic_train_step_multi
        self._make_statics = make_gnomonic_train_statics
        self.k = int(cfg["poses_per_step"])
        self.inputs = stage.make(cfg, ctx.traffic, ctx.seed, dev)
        size = self.inputs.size
        t = time.perf_counter()
        self.grid = stage.program_grid(self.inputs)
        self.params = (self.grid.densities, self.grid.features)
        self.optimizer, self.scheduler = make_gnomonic_optimizer(
            self.grid, stage.stage_lr(cfg), cfg["lr_decay_steps_per_stage"],
            cfg["lr_decay_gamma_per_stage"])
        self.buckets, self.weights = _pose_buckets(self.inputs.poses, size, size,
                                                   self.inputs.focal)
        self.variants = list(self.buckets)
        self.statics = {}
        self.picker = np.random.default_rng(ctx.seed + int(cfg["stage"]))
        self.gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        self.losses = []

        # the judged steps, then one step of every variant not yet run
        self.judged = []
        self.prog = self._judged_steps()
        t = harness.log("judged steps", t)
        for variant in self.variants:
            if variant not in self.statics:
                self._step(*self._feed(variant))
        self.losses = []
        harness.log(f"warm steps ({len(self.variants)} variants)", t)

    # ------------------------------------------------------------------ feed

    def _tstat(self, variant):
        if variant not in self.statics:
            cfg, size = self.cfg, self.inputs.size
            self.statics[variant] = self._make_statics(
                self.grid, variant[0], variant[1], image_height=size, image_width=size,
                white_bkgd=cfg["white_bkgd"],
                apply_diffuse_render_regularization=cfg["apply_diffuse_render_regularization"],
                pos_per_cell=cfg["gnomonic_pos_per_cell"], supersample=cfg["gnomonic_supersample"],
                warp_order=cfg["gnomonic_warp_order"], qb=cfg["gnomonic_qb"],
                warp_swap=variant[2])
        return self.statics[variant]

    def _feed(self, variant=None, distinct=False):
        """(variant, view indices, phases [k, 2]) of the next step: the variant
        by the buckets' weights and the views from its bucket (``distinct``:
        without repeats, from a bucket that holds k views), as the trainer's
        picker draws them; the phases from the seed's generator."""
        if variant is None:
            while True:
                variant = self.variants[int(self.picker.choice(len(self.variants), p=self.weights))]
                if not distinct or len(self.buckets[variant]) >= self.k:
                    break
        idx = np.asarray(self.picker.choice(self.buckets[variant], size=self.k,
                                            replace=not distinct))
        phases = None
        if self.cfg["perturb_sampled_points"]:
            phases = torch.rand((self.k, 2), generator=self.gen, device=self.dev) - 0.5
        return variant, idx, phases

    def _step(self, variant, idx, phases):
        if self.ctx.fault == "half_batch":
            idx, phases = idx[: self.k // 2], None if phases is None else phases[: self.k // 2]
        restore = training.freeze_step(self.optimizer, self.params) if self.ctx.fault == "frozen" \
            else None
        poses = self.inputs.poses
        metrics = self._step_fn(
            self._tstat(variant), self.optimizer, self.grid,
            self.inputs.images[torch.as_tensor(idx, device=self.dev)], poses[idx, :, :3],
            poses[idx, :, 3], self.inputs.focal,
            phases=None if phases is None else list(phases), scheduler=self.scheduler)
        if restore is not None:
            restore()
        return metrics

    def _judged_steps(self):
        """Run the judged steps through the feed; return the program's readings."""
        losses, grad = [], None
        for i in range(int(self.tr["judged_steps"])):
            variant, idx, phases = self._feed(distinct=True)
            self.judged.append((variant, idx, None if phases is None else phases.cpu()))
            losses.append(float(self._step(variant, idx, phases)["total_loss"]))
            if i == 0:
                grad = training.first_moment_norms(self.optimizer, self.params)
        return {"losses": losses, "grad": grad,
                "change": training.change_norms(self.params, self.inputs.start, self.dev)}

    # ---------------------------------------------------------------- window

    def run_unit(self):
        self.losses.append(self._step(*self._feed())["total_loss"])

    def close_window(self):
        values = [float(v) for v in self.losses]
        return len(values), sum(not math.isfinite(v) for v in values)

    def release(self):
        del self.grid, self.params, self.optimizer, self.scheduler, self.statics, self.losses
        if self.dev.startswith("cuda"):
            torch.cuda.empty_cache()

    # --------------------------------------------------------------- judge

    def reference_readings(self, dt=torch.float32):
        """The judged steps through the plain reference in precision ``dt``."""
        cfg, inp = self.cfg, self.inputs
        params = [t.to(self.dev).to(dt).clone() for t in inp.start]
        grid = ref.Grid(params[0], params[1], inp.voxel_size, inp.density_scale)
        state, losses, grad = {}, [], None
        for i, (variant, idx, phases) in enumerate(self.judged):
            loss, grads = ref.step_gradient(
                grid, inp.images[torch.as_tensor(idx, device=self.dev)], inp.poses[idx, :, :3],
                inp.poses[idx, :, 3], inp.focal,
                [None] * len(idx) if phases is None else list(phases.to(self.dev)),
                cfg["gnomonic_supersample"], cfg["apply_diffuse_render_regularization"], dt)
            losses.append(loss)
            if i == 0:
                grad = training.norms(grads)
            with torch.no_grad():
                # the staircase holds the stage's rate through the judged steps
                ref.adam_update(params, grads, state, stage.stage_lr(cfg))
            del grads
        return {"losses": losses, "grad": grad,
                "change": training.change_norms(params, inp.start, self.dev)}

    def judge(self):
        prog = self.reference_readings(torch.bfloat16) if self.ctx.fault == "control" else self.prog
        return training.checks(prog, self.reference_readings(), self.ctx.limits)
