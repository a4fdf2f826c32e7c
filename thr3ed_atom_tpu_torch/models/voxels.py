"""Dense SH-feature voxel grid as a ``torch.nn.Module``.

Counterpart of thr3ed_atom_tpu/models/voxels.py: the trainable tensors
``densities`` [X, Y, Z, 1] and ``features`` [X, Y, Z, F] are parameters; the
voxel size, grid location and activation names are plain attributes.
Activations are registry names, never pickled callables, so checkpoints are
arrays + JSON in the JAX package's format and load in either package.

The tensors are created without gradients, so serving builds no autograd
graph; ``trainable()`` enables them for the duration of a train step.

Conventions (shared with the JAX package): x = width, y = depth, z = height;
AABB = grid_dims * voxel_size centred at grid_location; the density
preactivation applies to ``densities * expected_density_scale`` on the whole
grid before interpolation, the postactivation after. Calling the grid on
world points [N, 3] interpolates it (``forward``, the exact renderer's point
lookup: ops/grid_sample.py, torch grid_sample's align_corners=False
semantics).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from thr3ed_atom_tpu_torch.ops.grid_sample import trilinear_grid_sample
from thr3ed_atom_tpu_torch.utils.camera import adjust_dynamic_range
from thr3ed_atom_tpu_torch.utils.constants import CONFIG_DICT, STATE_DICT, THRE3D_REPR


class VoxelSize(NamedTuple):
    """Edge lengths of a single voxel along x, y, z (anisotropic voxels allowed)."""

    x_size: float = 1.0
    y_size: float = 1.0
    z_size: float = 1.0


class VoxelGridLocation(NamedTuple):
    """World-coordinate location of the grid's center; the grid is axis aligned."""

    x_coord: float = 0.0
    y_coord: float = 0.0
    z_coord: float = 0.0


class AxisAlignedBoundingBox(NamedTuple):
    x_range: Tuple[float, float]
    y_range: Tuple[float, float]
    z_range: Tuple[float, float]


# registry of activation functions by name — checkpoints store the name
ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "identity": lambda x: x,
    "abs": torch.abs,
    "relu": F.relu,
    "softplus": F.softplus,
    "sigmoid": torch.sigmoid,
}


# registry of radiance transfer functions by name (empty, as in the JAX
# package): (interpolated features [N, F], viewdirs [N, 3]) -> radiance-space
# features. ``None`` keeps the raw SH features, evaluated in the point
# processor; an unknown name fails its lookup in ``forward``, as in the JAX
# package
RADIANCE_TRANSFER_FUNCTIONS: Dict[str, Callable] = {}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card."""
    return torch.device("cuda" if device is None else device)


class VoxelGrid(nn.Module):
    def __init__(
        self,
        densities: torch.Tensor,
        features: torch.Tensor,
        voxel_size: VoxelSize = VoxelSize(),
        grid_location: VoxelGridLocation = VoxelGridLocation(),
        density_preactivation: str = "abs",
        density_postactivation: str = "identity",
        feature_preactivation: str = "identity",
        feature_postactivation: str = "identity",
        expected_density_scale: float = 1.0,
        radiance_transfer_function: Optional[str] = None,
    ) -> None:
        super().__init__()
        if densities.shape[:3] != features.shape[:3] or densities.shape[-1] != 1:
            raise ValueError(
                f"densities {tuple(densities.shape)} must be [X, Y, Z, 1] over "
                f"the features' [X, Y, Z, F] {tuple(features.shape)}"
            )
        for name in (density_preactivation, density_postactivation,
                     feature_preactivation, feature_postactivation):
            if name not in ACTIVATIONS:
                raise ValueError(f"unknown activation '{name}'")
        self.densities = nn.Parameter(densities, requires_grad=False)
        self.features = nn.Parameter(features, requires_grad=False)
        self.voxel_size = VoxelSize(*voxel_size)
        self.grid_location = VoxelGridLocation(*grid_location)
        self.density_preactivation = density_preactivation
        self.density_postactivation = density_postactivation
        self.feature_preactivation = feature_preactivation
        self.feature_postactivation = feature_postactivation
        self.expected_density_scale = float(expected_density_scale)
        self.radiance_transfer_function = radiance_transfer_function

    # ------------------------------------------------------------------ properties

    @property
    def grid_dims(self) -> Tuple[int, int, int]:
        return tuple(self.features.shape[:3])

    @property
    def num_features(self) -> int:
        return self.features.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.features.device

    @property
    def aabb(self) -> AxisAlignedBoundingBox:
        dims, vs, loc = self.grid_dims, self.voxel_size, self.grid_location
        half = [(dims[i] * vs[i]) / 2 for i in range(3)]
        return AxisAlignedBoundingBox(
            x_range=(loc.x_coord - half[0], loc.x_coord + half[0]),
            y_range=(loc.y_coord - half[1], loc.y_coord + half[1]),
            z_range=(loc.z_coord - half[2], loc.z_coord + half[2]),
        )

    # ------------------------------------------------------------------ geometry

    def normalize_points(self, points: torch.Tensor) -> torch.Tensor:
        """World coordinates -> [-1, 1]^3 grid coordinates (un-clipped affine map)."""
        return torch.stack([
            adjust_dynamic_range(points[..., axis], drange_in=axis_range,
                                 drange_out=(-1.0, 1.0), slack=True)
            for axis, axis_range in enumerate(self.aabb)
        ], dim=-1)

    def test_inside_volume(self, points: torch.Tensor) -> torch.Tensor:
        """Strict-inequality AABB membership test; [..., 3] -> [..., 1] bool."""
        aabb = self.aabb
        return (
            (points[..., 0:1] > aabb.x_range[0])
            & (points[..., 0:1] < aabb.x_range[1])
            & (points[..., 1:2] > aabb.y_range[0])
            & (points[..., 1:2] < aabb.y_range[1])
            & (points[..., 2:3] > aabb.z_range[0])
            & (points[..., 2:3] < aabb.z_range[1])
        )

    def get_bounding_volume_vertices(self) -> torch.Tensor:
        """The AABB's eight corners [8, 3] (x slowest, z fastest) on the grid's device."""
        (x_min, x_max), (y_min, y_max), (z_min, z_max) = self.aabb
        return torch.tensor(
            [[x, y, z] for x in (x_min, x_max) for y in (y_min, y_max) for z in (z_min, z_max)],
            dtype=torch.float32, device=self.device,
        )

    def forward(self, points: torch.Tensor,
                viewdirs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Interpolated [N, F + 1] (features ++ density) at world-space
        ``points`` [N, 3]: one trilinear gather over the concatenated
        pre-activated grids, then the post-activations (and the radiance
        transfer function, if the grid names one and ``viewdirs`` are
        given). Differentiable in the grid's tensors."""
        pre_densities, pre_features = self.activated_grids()
        unified = torch.cat([pre_features, pre_densities], dim=-1)
        interpolated = trilinear_grid_sample(unified, self.normalize_points(points))
        interp_features, interp_densities = interpolated[..., :-1], interpolated[..., -1:]
        interp_densities = ACTIVATIONS[self.density_postactivation](interp_densities)
        interp_features = ACTIVATIONS[self.feature_postactivation](interp_features)
        if self.radiance_transfer_function is not None and viewdirs is not None:
            interp_features = RADIANCE_TRANSFER_FUNCTIONS[
                self.radiance_transfer_function](interp_features, viewdirs)
        return torch.cat([interp_features, interp_densities], dim=-1)

    @contextlib.contextmanager
    def trainable(self) -> Iterator["VoxelGrid"]:
        """Gradients on ``densities`` and ``features`` for the duration (a
        train step); their previous setting is restored on exit."""
        params = (self.densities, self.features)
        before = [t.requires_grad for t in params]
        for t in params:
            t.requires_grad_(True)
        try:
            yield self
        finally:
            for t, flag in zip(params, before):
                t.requires_grad_(flag)

    def activated_grids(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pre-activated (density, feature) grids ready for interpolation."""
        pre_densities = ACTIVATIONS[self.density_preactivation](
            self.densities * self.expected_density_scale
        )
        pre_features = ACTIVATIONS[self.feature_preactivation](self.features)
        return pre_densities, pre_features

    # ------------------------------------------------------------------ config / io

    def get_config_dict(self) -> Dict[str, Any]:
        return {
            "grid_location": tuple(self.grid_location),
            "density_preactivation": self.density_preactivation,
            "density_postactivation": self.density_postactivation,
            "feature_preactivation": self.feature_preactivation,
            "feature_postactivation": self.feature_postactivation,
            "expected_density_scale": self.expected_density_scale,
            "radiance_transfer_function": self.radiance_transfer_function,
        }

    def get_save_config_dict(self) -> Dict[str, Any]:
        config = self.get_config_dict()
        config["voxel_size"] = tuple(self.voxel_size)
        return config


def create_voxel_grid(
    generator: torch.Generator,
    grid_dims: Tuple[int, int, int],
    num_features: int,
    voxel_size: VoxelSize,
    minval: float = -1.0,
    maxval: float = 1.0,
    **config,
) -> VoxelGrid:
    """Uniform(minval, maxval)-initialized grid on ``generator``'s device
    (densities drawn first, then features). The JAX package draws from its
    key; the values differ, the distribution is the same."""
    dev = generator.device

    def uniform(shape):
        return torch.rand(shape, generator=generator, device=dev) * (maxval - minval) + minval

    densities = uniform((*grid_dims, 1))
    features = uniform((*grid_dims, num_features))
    return VoxelGrid(densities=densities, features=features, voxel_size=voxel_size, **config)


def scale_voxel_grid_with_required_output_size(
    voxel_grid: VoxelGrid, output_size: Tuple[int, int, int], mode: str = "trilinear"
) -> VoxelGrid:
    """Trilinear resize of the (features ++ densities) grid to ``output_size``
    (``F.interpolate(align_corners=False)``: the half-texel sample positions
    of the JAX package's ``jax.image.resize``, which it equals on an upscale);
    the voxel size rescales so the world-space AABB is kept. A new grid on the
    same device, with the same configuration."""
    assert mode == "trilinear", "only trilinear grid scaling is supported"
    with torch.no_grad():
        unified = torch.cat([voxel_grid.features, voxel_grid.densities], dim=-1)
        resized = F.interpolate(unified.permute(3, 0, 1, 2)[None], size=tuple(output_size),
                                mode="trilinear", align_corners=False)
        resized = resized[0].permute(1, 2, 3, 0).contiguous()
    dims, old = voxel_grid.grid_dims, voxel_grid.voxel_size
    new_voxel_size = VoxelSize(
        (old.x_size * dims[0]) / output_size[0],
        (old.y_size * dims[1]) / output_size[1],
        (old.z_size * dims[2]) / output_size[2],
    )
    config = voxel_grid.get_config_dict()
    config["grid_location"] = VoxelGridLocation(*config["grid_location"])
    return VoxelGrid(
        densities=resized[..., -1:].contiguous(),
        features=resized[..., :-1].contiguous(),
        voxel_size=new_voxel_size,
        **config,
    )


def voxel_grid_from_numpy(
    densities: np.ndarray,
    features: np.ndarray,
    config_dict: Dict[str, Any],
    device=None,
) -> VoxelGrid:
    """A VoxelGrid on ``device`` (None: the CUDA card) from numpy arrays and a
    ``get_save_config_dict()`` — e.g. the JAX package's grid carried across."""
    config = dict(config_dict)
    voxel_size = VoxelSize(*config.pop("voxel_size"))
    grid_location = VoxelGridLocation(*config.pop("grid_location"))
    dev = resolve_device(device)
    return VoxelGrid(
        densities=torch.as_tensor(np.asarray(densities, np.float32)).to(dev),
        features=torch.as_tensor(np.asarray(features, np.float32)).to(dev),
        voxel_size=voxel_size,
        grid_location=grid_location,
        **config,
    )


def create_voxel_grid_from_saved_info_dict(saved_info: Dict[str, Any],
                                           device=None) -> VoxelGrid:
    """Rebuild a VoxelGrid from a checkpoint dict of arrays + config (no pickle)."""
    state = saved_info[THRE3D_REPR][STATE_DICT]
    return voxel_grid_from_numpy(
        state["densities"], state["features"],
        saved_info[THRE3D_REPR][CONFIG_DICT], device,
    )
