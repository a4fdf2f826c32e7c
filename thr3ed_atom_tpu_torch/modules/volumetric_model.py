"""VolumetricModel: a voxel grid + a named render procedure + its config.

Counterpart of thr3ed_atom_tpu/modules/volumetric_model.py. The default
procedure is the JAX package's, the exact renderer ``render_sh_voxel_grid``:
``render_rays`` renders flat rays through the procedure, and ``render``
casts a pose's rays and renders them in chunks of
``parallel_rays_chunk_size``. A procedure with a ``prepare`` hook (fast,
hierarchical: the cell-packed tables) has its per-grid tables built once and
cached until the grid's tensors change (``_get_prepared``). The
pose-structured procedures (gnomonic, bricked, planes) render whole poses
through their ``render_image`` / ``render_poses``. Checkpoints keep the JAX
package's format: <path>.npz holds the arrays, <path>.json the grid config,
the render procedure's registry name and the render config; no pickles.
Either package loads the other's.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from thr3ed_atom_tpu_torch.models.voxels import (
    VoxelGrid,
    create_voxel_grid_from_saved_info_dict,
    resolve_device,
)
from thr3ed_atom_tpu_torch.rendering.interface import Rays, RenderOut
from thr3ed_atom_tpu_torch.rendering.rays import (
    cast_rays,
    collate_rendered_output,
    flatten_rays,
    reshape_rendered_output,
)
from thr3ed_atom_tpu_torch.rendering.renderer import (
    SHVoxGridRenderConfig,
    get_render_procedure,
)
from thr3ed_atom_tpu_torch.utils.camera import CameraBounds, CameraIntrinsics, CameraPose
from thr3ed_atom_tpu_torch.utils.constants import (
    CONFIG_DICT,
    EXTRA_INFO,
    RENDER_CONFIG,
    RENDER_PROCEDURE,
    STATE_DICT,
    THRE3D_REPR,
)


class VolumetricModel:
    """Owns (voxel grid, render procedure name, render config) on one device.

    ``device=None`` means the CUDA card; the grid is moved there."""

    def __init__(
        self,
        thre3d_repr: VoxelGrid,
        render_procedure: str = "render_sh_voxel_grid",
        render_config: Optional[SHVoxGridRenderConfig] = None,
        device=None,
    ) -> None:
        get_render_procedure(render_procedure)  # raises for unknown procedures
        self.device = resolve_device(device)
        self._thre3d_repr = thre3d_repr.to(self.device)
        self._render_procedure_name = render_procedure
        self._render_config = render_config
        self._image_render_cache: dict = {}
        self._prepared_cache: Optional[tuple] = None

    @property
    def thre3d_repr(self) -> VoxelGrid:
        return self._thre3d_repr

    @thre3d_repr.setter
    def thre3d_repr(self, grid: VoxelGrid) -> None:
        """Adopt ``grid`` (moved to the model's device); drops the render caches."""
        self._thre3d_repr = grid.to(self.device)
        self.drop_prepared_cache()

    @property
    def render_procedure(self):
        return get_render_procedure(self._render_procedure_name)

    @property
    def render_procedure_name(self) -> str:
        return self._render_procedure_name

    @property
    def render_config(self) -> SHVoxGridRenderConfig:
        return self._render_config

    def _config(self, overrides) -> SHVoxGridRenderConfig:
        overrides = dict(overrides)
        overrides.setdefault("perturb_sampled_points", False)
        return self._render_config.replace(**overrides)

    def _get_prepared(self, config):
        """The procedure's per-grid precomputation (the fast and hierarchical
        procedures' packed tables) for ``config``, cached across render calls;
        None for a procedure without a ``prepare`` hook, and while gradients
        flow into the grid (a differentiable render packs its own tables).
        The cache holds while the grid's tensors are the same objects at the
        same version counters: an in-place update (an optimizer step) bumps
        a counter and invalidates it, as does a new grid or
        ``drop_prepared_cache``."""
        prepare = getattr(self.render_procedure, "prepare", None)
        grid = self._thre3d_repr
        if prepare is None or (torch.is_grad_enabled() and (
                grid.densities.requires_grad or grid.features.requires_grad)):
            return None
        stamp = (grid.densities._version, grid.features._version,
                 config.fast_bf16_features, config.fast_pack_features)
        cache = self._prepared_cache
        if (cache is not None and cache[0] is grid.densities and cache[1] is grid.features
                and cache[2] == stamp):
            return cache[3]
        self._prepared_cache = None  # free the old tables before packing new ones
        with torch.no_grad():
            prepared = prepare(grid, config)
        self._prepared_cache = (grid.densities, grid.features, stamp, prepared)
        return prepared

    def _call_procedure(self, rays: Rays, config, generator) -> RenderOut:
        prepared = self._get_prepared(config)
        if prepared is None:
            return self.render_procedure(self._thre3d_repr, rays, config, generator)
        return self.render_procedure(self._thre3d_repr, rays, config, generator,
                                     prepared=prepared)

    def render_rays(self, rays: Rays, generator: Optional[torch.Generator] = None,
                    **config_overrides) -> RenderOut:
        """Render of flat rays [N, 3] (on the model's device) through the
        procedure, with optional per-call config overrides, differentiable
        while the grid is ``trainable()``; ``generator`` draws the jitter and
        the density noise."""
        config = (self._render_config.replace(**config_overrides) if config_overrides
                  else self._render_config)
        return self._call_procedure(rays, config, generator)

    def render(self, camera_pose: CameraPose, camera_intrinsics: CameraIntrinsics,
               parallel_rays_chunk_size: Optional[int] = None,
               generator: Optional[torch.Generator] = None,
               **config_overrides) -> RenderOut:
        """Full-image render of one pose: outputs [H, W, .] on the model's
        device. Deterministic by default (no jitter): pass overrides and a
        ``generator`` to change that. A procedure without ``render_image``
        renders the pose's rays in chunks of ``parallel_rays_chunk_size``
        (default: the config's), each chunk drawing from ``generator`` in
        turn, with the procedure's prepared tables built once for all
        chunks."""
        config = self._config(config_overrides)
        image_fn = getattr(self.render_procedure, "render_image", None)
        if image_fn is not None:
            return image_fn(self._thre3d_repr, camera_pose, camera_intrinsics, config,
                            cache=self._image_render_cache)
        chunk_size = (parallel_rays_chunk_size if parallel_rays_chunk_size is not None
                      else config.parallel_rays_chunk_size)
        flat_rays = flatten_rays(cast_rays(camera_intrinsics, camera_pose, self.device))
        chunks = [self._call_procedure(flat_rays[start:start + chunk_size], config, generator)
                  for start in range(0, len(flat_rays), chunk_size)]
        return reshape_rendered_output(collate_rendered_output(chunks), camera_intrinsics)

    def render_poses(self, camera_poses, camera_intrinsics: CameraIntrinsics,
                     generator: Optional[torch.Generator] = None,
                     **config_overrides) -> RenderOut:
        """Render a sequence of poses; every output gains a leading pose axis.
        A procedure without ``render_poses`` renders pose by pose."""
        poses_fn = getattr(self.render_procedure, "render_poses", None)
        if poses_fn is not None:
            return poses_fn(self._thre3d_repr, list(camera_poses), camera_intrinsics,
                            self._config(config_overrides), cache=self._image_render_cache)
        outs = [self.render(pose, camera_intrinsics, generator=generator, **config_overrides)
                for pose in camera_poses]
        return RenderOut(
            colour=torch.stack([o.colour for o in outs]),
            depth=torch.stack([o.depth for o in outs]),
            extra={k: torch.stack([o.extra[k] for o in outs]) for k in outs[0].extra},
        )

    def drop_prepared_cache(self) -> None:
        """Free the cached per-grid tables: the packed tables of the fast and
        hierarchical procedures and the repacked grids of every march
        variant (at 256^3 the packed f32 feature table alone is 14.7 GB; the
        trainer drops them after each feedback render and held-out test)."""
        self._prepared_cache = None
        self._image_render_cache.clear()

    # ------------------------------------------------------------------ io

    def get_save_info(self, extra_info: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
        grid = self._thre3d_repr
        info = {
            THRE3D_REPR: {
                STATE_DICT: {
                    "densities": grid.densities.detach().cpu().numpy(),
                    "features": grid.features.detach().cpu().numpy(),
                },
                CONFIG_DICT: grid.get_save_config_dict(),
            },
            RENDER_PROCEDURE: self._render_procedure_name,
            RENDER_CONFIG: _render_config_to_jsonable(self._render_config),
        }
        if extra_info is not None:
            info[EXTRA_INFO] = extra_info
        return info

    def save(self, path: Path, extra_info: Optional[Dict[str, Any]] = None) -> None:
        save_model(self, path, extra_info)


def _render_config_to_jsonable(config: SHVoxGridRenderConfig) -> Dict[str, Any]:
    d = dataclasses.asdict(config)
    d["camera_bounds"] = [config.camera_bounds.near, config.camera_bounds.far]
    return d


def _render_config_from_jsonable(d: Dict[str, Any]) -> SHVoxGridRenderConfig:
    d = dict(d)
    d["camera_bounds"] = CameraBounds(*[float(v) for v in d["camera_bounds"]])
    return SHVoxGridRenderConfig(**d)


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def save_model(vol_mod: VolumetricModel, path: Path,
               extra_info: Optional[Dict[str, Any]] = None) -> None:
    """Write <path>.npz (arrays) + <path>.json (config). No pickles anywhere."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    info = vol_mod.get_save_info(extra_info)
    np.savez(str(path.with_suffix(".npz")), **info[THRE3D_REPR][STATE_DICT])
    meta = {
        THRE3D_REPR: {CONFIG_DICT: info[THRE3D_REPR][CONFIG_DICT]},
        RENDER_PROCEDURE: info[RENDER_PROCEDURE],
        RENDER_CONFIG: info[RENDER_CONFIG],
        EXTRA_INFO: _jsonable(info.get(EXTRA_INFO, {})),
    }
    with open(path.with_suffix(".json"), "w") as f:
        json.dump(meta, f, indent=2)


def create_volumetric_model_from_saved_model(
    model_path: Path, device=None,
) -> Tuple[VolumetricModel, Dict[str, Any]]:
    """Rebuild a VolumetricModel on ``device`` (None: the CUDA card) from
    <path>.npz + <path>.json, as written by either package."""
    model_path = Path(model_path)
    with open(model_path.with_suffix(".json")) as f:
        meta = json.load(f)
    with np.load(str(model_path.with_suffix(".npz"))) as arrays:
        state = {k: arrays[k] for k in arrays.files}
    saved_info = {
        THRE3D_REPR: {STATE_DICT: state, CONFIG_DICT: meta[THRE3D_REPR][CONFIG_DICT]}
    }
    thre3d_repr = create_voxel_grid_from_saved_info_dict(saved_info, device)
    vol_mod = VolumetricModel(
        thre3d_repr=thre3d_repr,
        render_procedure=meta[RENDER_PROCEDURE],
        render_config=_render_config_from_jsonable(meta[RENDER_CONFIG]),
        device=device,
    )
    return vol_mod, meta.get(EXTRA_INFO, {})
