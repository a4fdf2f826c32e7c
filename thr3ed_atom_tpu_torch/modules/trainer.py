"""The trainer's optimizer for the gnomonic whole-pose step.

Counterpart of the optimizer part of thr3ed_atom_tpu/modules/trainer.py: each
stage trains the grid with Adam (b1 0.9, b2 0.999, eps 1e-8) at the stage's
learning rate ``learning_rate * stagewise_lr_decay_gamma ** (stage - 1)``,
decayed in steps: ``lr * lr_decay_gamma_per_stage ** (count //
lr_decay_steps_per_stage)`` after ``count`` optimizer steps (optax's
exponential_decay with staircase=True). The step takes at least
``_GN_MIN_POSES_PER_STEP`` views of one march variant
(rendering/gnomonic_train.py gnomonic_train_step_multi).

The stage loop itself (variant buckets, trilinear growth between stages,
checkpoints with the Adam moments, summaries and held-out tests) is not ported
yet: ``train_sh_vox_grid_vol_mod_with_posed_images`` raises.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid

# minimum training views averaged per whole-pose step (the JAX trainer's
# measured floor: single-view steps at lr 0.03 thrash the grid)
_GN_MIN_POSES_PER_STEP = 4


def staircase_exponential_decay(transition_steps: int,
                                decay_rate: float) -> Callable[[int], float]:
    """Multiplier of the base learning rate after ``count`` steps:
    ``decay_rate ** (count // transition_steps)`` (constant 1 when
    ``transition_steps`` <= 0, as optax)."""
    if transition_steps <= 0:
        return lambda count: 1.0
    return lambda count: decay_rate ** (count // transition_steps)


def make_gnomonic_optimizer(
    grid: VoxelGrid,
    learning_rate: float = 0.03,
    lr_decay_steps_per_stage: int = 1000,
    lr_decay_gamma_per_stage: float = 0.1,
) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam over the grid's densities and features with the staircase decay;
    step the scheduler once after every optimizer step (the train steps do
    when given it), as optax counts updates."""
    optimizer = torch.optim.Adam([grid.densities, grid.features], lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer,
        staircase_exponential_decay(lr_decay_steps_per_stage, lr_decay_gamma_per_stage),
    )
    return optimizer, scheduler


def train_sh_vox_grid_vol_mod_with_posed_images(*args, **kwargs):
    """The coarse-to-fine stage loop is not ported yet."""
    raise NotImplementedError(
        "the stage loop of train_sh_vox_grid_vol_mod_with_posed_images "
        "(variant buckets, trilinear growth, checkpoints with Adam moments), "
        "like data/dataset.py and apps/train_sh_voxel_grid.py, is not ported "
        "yet (ROADMAP.md, 'Modules to port', item 5); take "
        "steps with rendering.gnomonic_train.gnomonic_train_step_multi and "
        "make_gnomonic_optimizer"
    )
