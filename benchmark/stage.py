"""The inputs of a training stage of the relu-field recipe, made from the
seed, shared by the trainers' drivers: the blob scene at the traffic's size,
its views rendered by the plain volume renderer, and the scene grown to the
configuration's grid as the stage's start (densities over the relu field's
density scale, so the activated grid is the scene's)."""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

import harness
from reference import scene, volume_plain


class StageInputs(NamedTuple):
    poses: np.ndarray  # [N, 3, 4] f32
    images: torch.Tensor  # [N, H, W, 3] on the device
    densities: torch.Tensor  # [G, G, G, 1] the start grid, on the device
    features: torch.Tensor  # [G, G, G, F]
    start: tuple  # host copies of (densities, features)
    density_scale: float
    voxel_size: float
    focal: float
    size: int


def make(config, traffic, seed: int, device) -> StageInputs:
    t = time.perf_counter()
    size = int(traffic["view_size"])
    focal = float(traffic["view_focal"])
    extent = float(config["grid_world_size"][0])
    G = int(config["grid_dims"][0])
    d0, f0 = scene.blob_scene(traffic["scene_size"], seed, device,
                              3 * (config["sh_degree"] + 1) ** 2)
    poses = scene.training_poses(traffic["num_views"], traffic["view_radius"], seed)
    images = volume_plain.render_views(d0, f0, extent, poses, size, size, focal,
                                       traffic["near"], traffic["far"], traffic["target_samples"])
    dens, feats = scene.grow(d0, f0, G)
    scale = float(config["expected_density_scale"])
    dens = dens / scale
    start = (dens.cpu().clone(), feats.cpu().clone())
    harness.log("inputs (scene, targets, start grid)", t)
    return StageInputs(poses, images, dens, feats, start, scale, extent / G, focal, size)


def program_grid(inputs: StageInputs):
    """The program's VoxelGrid of the stage's start (a relu field)."""
    from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid, VoxelSize

    return VoxelGrid(inputs.densities.clone(), inputs.features.clone(),
                     voxel_size=VoxelSize(*(inputs.voxel_size,) * 3),
                     density_preactivation="identity", density_postactivation="relu",
                     expected_density_scale=inputs.density_scale)


def stage_lr(config) -> float:
    return config["learning_rate"] * config["stagewise_lr_decay_gamma"] ** (config["stage"] - 1)
