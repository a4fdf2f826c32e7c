"""Camera types and camera/imaging math.

Pure numpy on the host side (poses are tiny); the renderer converts what it needs to
torch tensors at its call boundary. A copy of thr3ed_atom_tpu/utils/camera.py, kept
separate so that this package imports nothing of the JAX package.

Parity: reference thre3d_atom/utils/imaging_utils.py (CameraIntrinsics:17, CameraPose:23,
CameraBounds:28, adjust_dynamic_range:42, postprocess_depth_map:93,
scale_camera_intrinsics:130, pose_spherical:185, get_thre360_animation_poses:199,
get_thre360_spiral_animation_poses:211).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from thr3ed_atom_tpu_torch.utils.constants import NUM_COLOUR_CHANNELS


class CameraIntrinsics(NamedTuple):
    height: int
    width: int
    focal: float


class CameraPose(NamedTuple):
    rotation: np.ndarray  # [3, 3]
    translation: np.ndarray  # [3, 1]


class CameraBounds(NamedTuple):
    near: float
    far: float


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0.0, 1.0)).astype(np.uint8)


def adjust_dynamic_range(
    data,
    drange_in: Tuple[float, float],
    drange_out: Tuple[float, float],
    slack: bool = False,
):
    """Remap ``data`` from range ``drange_in`` to ``drange_out``.

    With ``slack=True`` the affine map is applied without clipping (used for the voxel-grid
    point normalization, reference imaging_utils.py:57-63); otherwise the output is clipped
    to ``drange_out`` (reference imaging_utils.py:64-70). Works on numpy arrays and torch tensors.
    """
    if drange_in == drange_out:
        return data
    if slack:
        scale = (np.float32(drange_out[1]) - np.float32(drange_out[0])) / (
            np.float32(drange_in[1]) - np.float32(drange_in[0])
        )
        bias = np.float32(drange_out[0]) - np.float32(drange_in[0]) * scale
        return data * scale + bias
    old_min, old_max = np.float32(drange_in[0]), np.float32(drange_in[1])
    new_min, new_max = np.float32(drange_out[0]), np.float32(drange_out[1])
    data = ((data - old_min) / (old_max - old_min)) * (new_max - new_min) + new_min
    return data.clip(drange_out[0], drange_out[1])


# matplotlib's "magma" colormap at 17 evenly spaced points (entries 0, 16, ...,
# 255 of its 256), interpolated linearly: within 4/255 of matplotlib's
# 1024-entry table, so the port draws depth maps without matplotlib
_MAGMA_ANCHORS = np.array([
    [0.0015, 0.0005, 0.0139], [0.0396, 0.0311, 0.1335], [0.1131, 0.0655, 0.2768],
    [0.2117, 0.062, 0.4186], [0.3167, 0.0717, 0.4854], [0.4147, 0.1104, 0.5047],
    [0.5128, 0.1482, 0.5076], [0.6136, 0.1818, 0.4985], [0.7164, 0.215, 0.4753],
    [0.8109, 0.2529, 0.4393], [0.8996, 0.3146, 0.391], [0.9585, 0.4113, 0.36],
    [0.9857, 0.5281, 0.3794], [0.9958, 0.6463, 0.4414], [0.997, 0.7624, 0.5288],
    [0.9928, 0.8772, 0.6331], [0.9871, 0.9914, 0.7495],
], dtype=np.float64)


def magma(values: np.ndarray) -> np.ndarray:
    """RGB in [0, 1] of the magma colormap at ``values`` in [0, 1] (clipped)."""
    t = np.clip(np.asarray(values, np.float64), 0.0, 1.0)
    xp = np.round(np.linspace(0.0, 255.0, len(_MAGMA_ANCHORS))) / 255.0
    return np.stack([np.interp(t, xp, _MAGMA_ANCHORS[:, k]) for k in range(3)], axis=-1)


def postprocess_depth_map(
    depth_map: np.ndarray, acc_map: Optional[np.ndarray] = None
) -> np.ndarray:
    """Magma-colormapped depth visualization, optionally composited over white using the
    accumulation map."""
    if acc_map is not None:
        fg_depth_map = depth_map * acc_map
        depth_min, depth_max = depth_map.min(), fg_depth_map.max()
    else:
        depth_min, depth_max = depth_map.min(), depth_map.max()

    if depth_map.ndim == 3 and depth_map.shape[-1] == 1:
        depth_map = np.squeeze(depth_map, axis=-1)

    depth_map = adjust_dynamic_range(
        depth_map, drange_in=(depth_min, depth_max), drange_out=(0, 1), slack=True
    )

    coloured = magma(depth_map)[..., :NUM_COLOUR_CHANNELS]

    if acc_map is not None:
        composite_nr = (coloured * acc_map) + ((1.0 - acc_map) ** 2)
        composite_dr = acc_map + ((1.0 - acc_map) ** 2)
        return to8b(composite_nr / composite_dr)
    return to8b(coloured)


def scale_camera_intrinsics(
    camera_intrinsics: CameraIntrinsics, scale_factor: float = 1.0
) -> CameraIntrinsics:
    """Height/width get ceil'ed to ints, focal scales as float (reference imaging_utils.py:130-138)."""
    return CameraIntrinsics(
        height=int(np.ceil(camera_intrinsics.height * scale_factor)),
        width=int(np.ceil(camera_intrinsics.width * scale_factor)),
        focal=camera_intrinsics.focal * scale_factor,
    )


def downsample_camera_intrinsics(
    camera_intrinsics: CameraIntrinsics, downsample_factor: float = 1.0
) -> CameraIntrinsics:
    """Integer-truncating division used by the dataset layer (reference data/datasets.py:263-264)."""
    return CameraIntrinsics(
        height=int(camera_intrinsics.height / downsample_factor),
        width=int(camera_intrinsics.width / downsample_factor),
        focal=camera_intrinsics.focal / downsample_factor,
    )


def get_2d_coordinates(
    height: int, width: int, drange: Tuple[float, float] = (-1.0, 1.0)
) -> np.ndarray:
    """[H, W, 2] grid of normalized (row, col) coordinates (reference
    imaging_utils.py:74-85)."""
    range_a, range_b = drange
    rows = np.linspace(range_a, range_b, height, dtype=np.float32)
    cols = np.linspace(range_a, range_b, width, dtype=np.float32)
    grid_rows, grid_cols = np.meshgrid(rows, cols, indexing="ij")
    return np.stack([grid_rows, grid_cols], axis=-1)


# ---------------------------------------------------------------------------------
# Camera extrinsics (spherical orbit poses)
# ---------------------------------------------------------------------------------


def _translate_z(z: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = z
    return m


def _rotate_pitch(pitch: float) -> np.ndarray:
    c, s = np.cos(pitch), np.sin(pitch)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def _rotate_yaw(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m


def pose_spherical(yaw: float, pitch: float, radius: float) -> CameraPose:
    """Camera-to-world pose: translate along z by ``radius``, rotate by pitch then yaw
    (degrees). Parity: reference imaging_utils.py:185-191."""
    c2w = _translate_z(radius)
    c2w = _rotate_pitch(pitch / 180.0 * np.pi) @ c2w
    c2w = _rotate_yaw(yaw / 180.0 * np.pi) @ c2w
    return CameraPose(rotation=c2w[:3, :3], translation=c2w[:3, 3:])


def get_thre360_animation_poses(
    hemispherical_radius: float, camera_pitch: float, num_poses: int
) -> Sequence[CameraPose]:
    """Full-circle orbit at fixed pitch; the final pose is dropped so the video loops
    smoothly (reference imaging_utils.py:199-208)."""
    return [
        pose_spherical(yaw, camera_pitch, hemispherical_radius)
        for yaw in np.linspace(0, 360, num_poses)[:-1]
    ]


def get_thre360_spiral_animation_poses(
    horizontal_radius_range: Tuple[float, float],
    vertical_camera_height: float,
    num_rounds: int,
    num_poses: int,
) -> Sequence[CameraPose]:
    """Spiral with growing horizontal radius at a fixed camera height
    (reference imaging_utils.py:211-234)."""
    horizontal_radii = np.linspace(*horizontal_radius_range, num_poses)[:-1]
    hemispherical_radii = [
        np.sqrt(r**2 + vertical_camera_height**2) for r in horizontal_radii
    ]
    yaws = np.linspace(0, 360 * num_rounds, num_poses)[:-1]
    pitches = [
        math.atan(r / vertical_camera_height) * 180 / math.pi for r in horizontal_radii
    ]
    return [
        pose_spherical(yaw, pitch, radius)
        for (yaw, pitch, radius) in zip(yaws, pitches, hemispherical_radii)
    ]
