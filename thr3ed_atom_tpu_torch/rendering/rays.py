"""Ray utilities: pinhole ray casting, flattening and collation, NDC
reprojection, the draw of a ray / pixel batch without replacement, and the
reshaping of chunked render outputs (counterpart of
thr3ed_atom_tpu/rendering/rays.py). Rays are cast on the device named by the
caller (None: the CUDA card).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from thr3ed_atom_tpu_torch.models.voxels import resolve_device
from thr3ed_atom_tpu_torch.rendering.gnomonic import _strict_f32
from thr3ed_atom_tpu_torch.rendering.interface import Rays, RenderOut
from thr3ed_atom_tpu_torch.utils.camera import CameraIntrinsics, CameraPose
from thr3ed_atom_tpu_torch.utils.constants import NUM_COORD_DIMENSIONS

F32 = torch.float32


def pose_to_tensors(pose: CameraPose, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """CameraPose (numpy or tensors) -> (rotation [3, 3], translation [3]) f32."""
    rotation = torch.as_tensor(np.asarray(pose.rotation, np.float32)
                               if not torch.is_tensor(pose.rotation) else pose.rotation,
                               dtype=F32).to(device).reshape(3, 3)
    translation = torch.as_tensor(np.asarray(pose.translation, np.float32)
                                  if not torch.is_tensor(pose.translation)
                                  else pose.translation, dtype=F32).to(device).reshape(3)
    return rotation, translation


def cast_rays(camera_intrinsics: CameraIntrinsics, pose: CameraPose, device=None) -> Rays:
    """Pinhole rays through the pixel centres, [H, W, 3] origins and
    directions in f32: camera-space directions [(x - W/2)/f, -(y - H/2)/f, -1]
    rotated into world space in true f32 (TF32 off: the JAX package's
    Precision.HIGHEST) by a product, whose FMA chain rounds as the JAX
    package's dot does."""
    dev = resolve_device(device)
    rotation, translation = pose_to_tensors(pose, dev)
    height, width, focal = camera_intrinsics
    focal = torch.tensor(float(focal), dtype=F32, device=dev)  # true division
    x = torch.arange(width, dtype=F32, device=dev) + 0.5
    y = torch.arange(height, dtype=F32, device=dev) + 0.5
    y_grid, x_grid = torch.meshgrid(y, x, indexing="ij")  # [H, W]
    dirs = ((x_grid - width * 0.5) / focal, -(y_grid - height * 0.5) / focal,
            -torch.ones_like(x_grid))
    _strict_f32()
    rays_d = torch.einsum("ij,hwj->hwi", rotation, torch.stack(dirs, dim=-1))
    rays_o = translation.expand(rays_d.shape)
    return Rays(origins=rays_o, directions=rays_d)


def cast_rays_batch(camera_intrinsics: CameraIntrinsics, poses, device=None) -> Rays:
    """Ray casting for a batch of [B, 3, 4] poses -> Rays [B, H, W, 3]."""
    rays = [cast_rays(camera_intrinsics,
                      CameraPose(rotation=pose[:, :3], translation=pose[:, 3:]), device)
            for pose in poses]
    return Rays(origins=torch.stack([r.origins for r in rays]),
                directions=torch.stack([r.directions for r in rays]))


def flatten_rays(rays: Rays) -> Rays:
    return Rays(
        origins=rays.origins.reshape(-1, NUM_COORD_DIMENSIONS),
        directions=rays.directions.reshape(-1, NUM_COORD_DIMENSIONS),
    )


def collate_rays(rays_list: Sequence[Rays]) -> Rays:
    return Rays(
        origins=torch.cat([r.origins for r in rays_list], dim=0),
        directions=torch.cat([r.directions for r in rays_list], dim=0),
    )


def compute_expected_density_scale_for_relu_field_grid(
    grid_world_size: Tuple[float, float, float]
) -> float:
    """Heuristic density scale for ReLU-field grids."""
    diagonal_norm = float(np.sqrt(np.sum([extent**2 for extent in grid_world_size])))
    percent_density_scale, constant_grid_norm = 100.0, float(np.sqrt(3.0**3))
    return ((constant_grid_norm * percent_density_scale) / diagonal_norm) / NUM_COORD_DIMENSIONS


def ndcize_rays(rays: Rays, camera_intrinsics: CameraIntrinsics) -> Rays:
    """Reproject rays into normalized device coordinates."""
    height, width, focal = camera_intrinsics
    near = 1.0
    rays_o, rays_d = rays.origins, rays.directions

    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (width / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (height / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = (-1.0 / (width / (2.0 * focal))
          * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]))
    d1 = (-1.0 / (height / (2.0 * focal))
          * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]))
    d2 = -2.0 * near / rays_o[..., 2]

    return Rays(origins=torch.stack([o0, o1, o2], dim=-1),
                directions=torch.stack([d0, d1, d2], dim=-1))


def sample_random_rays_and_pixels_synchronously(
    rays: Rays,
    pixels: torch.Tensor,
    sample_size: int,
    generator: Optional[torch.Generator] = None,
    *,
    idx: Optional[torch.Tensor] = None,
) -> Tuple[Rays, torch.Tensor]:
    """``sample_size`` (ray, pixel) pairs drawn without replacement from
    flat ``rays`` [N, 3] and ``pixels`` [N, C]: the indices ``idx``
    [sample_size], or the head of a permutation drawn from ``generator``."""
    if idx is None:
        assert generator is not None, "drawing the batch requires a generator or idx"
        idx = torch.randperm(pixels.shape[0], generator=generator,
                             device=generator.device)[:sample_size]
    idx = idx.to(pixels.device)
    return Rays(origins=rays.origins[idx], directions=rays.directions[idx]), pixels[idx]


def collate_rendered_output(rendered_chunks: Sequence[RenderOut]) -> RenderOut:
    """Concatenate per-chunk RenderOuts along the ray axis."""
    first = rendered_chunks[0]
    return RenderOut(
        colour=torch.cat([c.colour for c in rendered_chunks], dim=0),
        depth=torch.cat([c.depth for c in rendered_chunks], dim=0),
        extra={k: torch.cat([c.extra[k] for c in rendered_chunks], dim=0)
               for k in first.extra},
    )


def reshape_rendered_output(rendered_output: RenderOut,
                            camera_intrinsics: CameraIntrinsics) -> RenderOut:
    """Flat [H*W, .] -> [H, W, .]."""
    shape = (camera_intrinsics.height, camera_intrinsics.width, -1)
    return RenderOut(colour=rendered_output.colour.reshape(shape),
                     depth=rendered_output.depth.reshape(shape),
                     extra={k: v.reshape(shape) for k, v in rendered_output.extra.items()})
