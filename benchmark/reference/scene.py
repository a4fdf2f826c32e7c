"""The benchmark's inputs made from ``--seed``: the blob scene, camera poses
and the target images. Plain PyTorch and NumPy; nothing of the program.

The scene is the repository's synthetic blob scene (six soft density blobs
with random colours and mild view dependence, "converged": empty space at -1
under identity pre- and relu post-activation), rewritten in PyTorch so that
it is made on the device in a few calls. The seed draws the blobs' centres,
colours and view-dependent coefficients; the radii are fixed (the mean of
the original draw's range, spread evenly) so that every seed asks the same
work of an occupancy skip within a few percent.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
NUM_BLOBS = 6
BLOB_RADII = (0.09, 0.10, 0.11, 0.13, 0.14, 0.15)
SCENE_EXTENT = 3.0  # world size of the grid's cube


def blob_scene(grid_size: int, seed: int, device, num_features: int = 27
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Densities [G, G, G, 1] (activated: relu of them is the density) and
    SH features [G, G, G, F] (degree 2, ``F`` = 27) of the seeded blob scene."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    centres = (torch.rand(NUM_BLOBS, 3, generator=gen) * 0.56 - 0.28).to(F32)
    colours = (torch.rand(NUM_BLOBS, 3, generator=gen) * 6.0 - 3.0).to(F32)
    view = (torch.rand(NUM_BLOBS, 3, 3, generator=gen) - 0.5).to(F32)
    ncoeff = num_features // 3
    axis = (torch.arange(grid_size, dtype=F32, device=device) - (grid_size - 1) / 2) / grid_size
    coords = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), dim=-1)
    dens = torch.zeros((grid_size,) * 3, dtype=F32, device=device)
    feats = torch.zeros((grid_size,) * 3 + (num_features,), dtype=F32, device=device)
    for b in range(NUM_BLOBS):
        dist = torch.linalg.norm(coords - centres[b].to(device), dim=-1)
        blob = torch.exp(-((dist / BLOB_RADII[b]) ** 2) * 4.0)
        dens += 8.0 * blob
        for c in range(3):
            feats[..., c * ncoeff] += float(colours[b, c]) * blob
            if ncoeff > 1:
                feats[..., c * ncoeff + 1:c * ncoeff + 4] += view[b, c].to(device) * blob[..., None]
    dens = torch.where(dens > 0.05, dens, torch.full_like(dens, -1.0))
    return dens[..., None], feats


def grow(densities: torch.Tensor, features: torch.Tensor, size: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinear resize of (features ++ densities) to ``size``^3 at the
    half-texel sample positions (a stage's growth)."""
    unified = torch.cat([features, densities], dim=-1).permute(3, 0, 1, 2)[None]
    out = F.interpolate(unified, size=(size,) * 3, mode="trilinear", align_corners=False)
    out = out[0].permute(1, 2, 3, 0).contiguous()
    return out[..., -1:].contiguous(), out[..., :-1].contiguous()


def pose_spherical(yaw_deg: float, pitch_deg: float, radius: float) -> np.ndarray:
    """Camera-to-world [3, 4] (OpenGL camera: looks down -z): translate along
    z by ``radius``, rotate by the pitch about x, then by the yaw about z."""
    def rot_x(a):
        return np.array([[1, 0, 0, 0], [0, math.cos(a), -math.sin(a), 0],
                         [0, math.sin(a), math.cos(a), 0], [0, 0, 0, 1]], np.float64)

    def rot_z(a):
        return np.array([[math.cos(a), -math.sin(a), 0, 0], [math.sin(a), math.cos(a), 0, 0],
                         [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)

    c2w = np.eye(4)
    c2w[2, 3] = radius
    c2w = rot_x(pitch_deg / 180.0 * math.pi) @ c2w
    c2w = rot_z(yaw_deg / 180.0 * math.pi) @ c2w
    return c2w[:3].astype(np.float32)


def training_poses(num: int, radius: float, seed: int) -> np.ndarray:
    """``num`` views [num, 3, 4] on the upper hemisphere: yaws evenly spaced
    from a seeded start, pitches cycling through -15 .. -65 degrees, so every
    seed has the same spread of views in another orientation."""
    start = float(np.random.default_rng(int(seed)).uniform(0.0, 360.0 / num))
    pitches = (-15.0, -32.0, -48.0, -65.0)
    return np.stack([pose_spherical(start + i * 360.0 / num, pitches[i % len(pitches)], radius)
                     for i in range(num)])


def orbit_poses(num_frames: int, pitch: float, radius: float) -> List[np.ndarray]:
    """The render CLI's thre360 path: yaws ``linspace(0, 360, num_frames)``
    without the last (the video loops), at one pitch and radius."""
    return [pose_spherical(yaw, pitch, radius)
            for yaw in np.linspace(0.0, 360.0, num_frames)[:-1]]
