"""Render configuration, the exact renderer and the registry of render
procedures.

Counterpart of thr3ed_atom_tpu/rendering/renderer.py. ``SHVoxGridRenderConfig``
carries every field of the JAX package's config, so a checkpoint's JSON written
by either package loads in the other. ``render_sh_voxel_grid`` is the exact
ray marcher (the JAX package's default procedure and the oracle of its
quality gates): sampler -> SH point processor -> accumulator over flat rays.
``RENDER_PROCEDURES`` holds every procedure of the JAX package: the exact
renderer, the two-phase top-K renderer (rendering/fast_renderer.py), the
hierarchical one (rendering/hierarchical.py), the gnomonic shear-warp
renderer, the bricked slab-march renderer and the plane-march renderer. A
procedure with a ``prepare`` hook (the fast and hierarchical ones: their
cell-packed tables) has that per-grid work hoisted out of the chunk loop and
cached by ``VolumetricModel``.
"""
import dataclasses
from functools import partial
from typing import Optional

import torch

from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid
from thr3ed_atom_tpu_torch.rendering.accumulate import (
    DENSITY2OCCUPANCY,
    TONE_MAPS,
    accumulate_radiance_density_on_rays,
)
from thr3ed_atom_tpu_torch.rendering.bricked import render_sh_voxel_grid_bricked
from thr3ed_atom_tpu_torch.rendering.fast_renderer import (
    prepare_for_config,
    render_sh_voxel_grid_fast,
)
from thr3ed_atom_tpu_torch.rendering.gnomonic import render_sh_voxel_grid_gnomonic
from thr3ed_atom_tpu_torch.rendering.hierarchical import render_sh_voxel_grid_hierarchical
from thr3ed_atom_tpu_torch.rendering.interface import Rays, RenderOut, render
from thr3ed_atom_tpu_torch.rendering.planes import render_sh_voxel_grid_planes
from thr3ed_atom_tpu_torch.rendering.process import process_points_with_sh_voxel_grid
from thr3ed_atom_tpu_torch.rendering.sample import (
    sample_aabb_bound_uniform_points_on_rays,
    sample_uniform_points_on_rays,
)
from thr3ed_atom_tpu_torch.utils.camera import CameraBounds


@dataclasses.dataclass(frozen=True)
class SHVoxGridRenderConfig:
    """Static render configuration, field for field the JAX package's, so
    that checkpoints round-trip."""

    # probing config:
    num_samples_per_ray: int
    camera_bounds: CameraBounds
    perturb_sampled_points: bool = True
    optimized_sampling: bool = False

    # accumulation config (registry names, not callables):
    density2occupancy: str = "pb"
    radiance_hdr_tone_map: str = "sigmoid"
    stochastic_density_noise_std: float = 0.0
    white_bkgd: bool = False

    # misc render-mode config:
    render_diffuse: bool = False
    render_num_samples_per_ray: int = 1024
    parallel_rays_chunk_size: int = 32768

    # two-phase (fast) renderer: samples shaded a ray, the feature table in
    # bf16, and cell-packed feature rows (False: the raw grid, eight taps)
    fast_topk: int = 64
    fast_bf16_features: bool = False
    # also emit the diffuse (degree-0 SH) colour in extra["diffuse_colour"]
    also_render_diffuse: bool = False
    fast_pack_features: bool = True

    # bricked (slab-march) renderer (rendering/bricked.py): per-tile early-exit
    # transmittance threshold (0 disables), the occupancy skip's per-sample
    # alpha threshold (0 disables; training always uses 0), the pixel tile
    # edge (8 or 16; 0 = 16 up to 160 vertices a side, else 8) and K samples
    # per cell along the march axis (divides 4; 0 = about 256 samples across
    # the grid). The plane-march renderer (rendering/planes.py) reads the
    # first three (its AUTO tile edge: 16 up to 128 vertices a side) and its
    # positions per cell (1, 2, 4 or 8; 0 = about 256 positions across the grid)
    bricked_exit_eps: float = 1e-4
    bricked_occupancy_alpha_thresh: float = 1e-4
    bricked_tile_px: int = 0
    bricked_axis_supersample: int = 0
    planes_pos_per_cell: int = 0

    # gnomonic shear-warp renderer (rendering/gnomonic.py): positions per cell
    # (0 = AUTO: ~256 positions across the grid, 32^3 -> 8, 128^3 -> 2,
    # 256^3 -> 1) and the texel grid's supersampling over the output image
    gnomonic_pos_per_cell: int = 0
    gnomonic_supersample: float = 1.25
    # final projective warp interpolation: 3 = separable Catmull-Rom (default),
    # 5 = prefiltered cubic B-spline, 1 = bilinear
    gnomonic_warp_order: int = 3
    # warp implementation: "matmul" (two-pass scanline warp,
    # rendering/warp_matmul.py), "gather" (per-pixel tap gathers) or "auto"
    # (= matmul)
    gnomonic_warp_impl: str = "auto"
    # early-exit threshold on transmittance (0 disables; the CUDA kernel exits
    # per texel tile, the JAX kernel per 128 x 128 block)
    gnomonic_exit_eps: float = 1e-4
    # q-block width of the occupancy flags (texels, multiple of 128) of the
    # fused pipeline; 0 selects the v2 stripe pipeline (whole-height stripes)
    gnomonic_qb: int = 128

    def replace(self, **overrides) -> "SHVoxGridRenderConfig":
        return dataclasses.replace(self, **overrides)


def render_sh_voxel_grid(
    voxel_grid: VoxelGrid,
    rays: Rays,
    render_config: SHVoxGridRenderConfig,
    generator: Optional[torch.Generator] = None,
    *,
    t_rand: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> RenderOut:
    """The exact renderer: sampler (AABB-bound with ``optimized_sampling``)
    -> SH point processor -> accumulator over flat rays [N, 3], on the
    grid's device, differentiable in the grid. Randomness is injected: the
    stratified jitter's uniforms ``t_rand`` [N, S] and the density noise's
    standard normals ``noise`` [N, S], or ``generator`` to draw them from
    (jitter first, then noise)."""
    if render_config.optimized_sampling:
        sampler_function = partial(
            sample_aabb_bound_uniform_points_on_rays,
            aabb=voxel_grid.aabb,
            generator=generator,
            perturb=render_config.perturb_sampled_points,
            t_rand=t_rand,
        )
    else:
        sampler_function = partial(
            sample_uniform_points_on_rays,
            generator=generator,
            perturb=render_config.perturb_sampled_points,
            t_rand=t_rand,
        )
    point_processor_function = partial(
        process_points_with_sh_voxel_grid,
        voxel_grid=voxel_grid,
        render_diffuse=render_config.render_diffuse,
    )
    accumulator_function = partial(
        accumulate_radiance_density_on_rays,
        generator=generator,
        stochastic_density_noise_std=render_config.stochastic_density_noise_std,
        density2occupancy=DENSITY2OCCUPANCY[render_config.density2occupancy],
        radiance_hdr_tone_map=TONE_MAPS[render_config.radiance_hdr_tone_map],
        white_bkgd=render_config.white_bkgd,
        extra_debug_info=False,
        noise=noise,
    )
    return render(
        rays,
        camera_bounds=render_config.camera_bounds,
        num_samples=render_config.num_samples_per_ray,
        sampler_fn=sampler_function,
        point_processor_fn=point_processor_function,
        accumulator_fn=accumulator_function,
    )


# the per-grid precomputation (the cell-packed tables) of the procedures
# that have one: (grid, config) -> prepared, passed as ``prepared=``
render_sh_voxel_grid_fast.prepare = prepare_for_config
render_sh_voxel_grid_hierarchical.prepare = prepare_for_config

RENDER_PROCEDURES = {
    "render_sh_voxel_grid": render_sh_voxel_grid,
    "render_sh_voxel_grid_fast": render_sh_voxel_grid_fast,
    "render_sh_voxel_grid_hierarchical": render_sh_voxel_grid_hierarchical,
    "render_sh_voxel_grid_gnomonic": render_sh_voxel_grid_gnomonic,
    "render_sh_voxel_grid_bricked": render_sh_voxel_grid_bricked,
    "render_sh_voxel_grid_planes": render_sh_voxel_grid_planes,
}


def get_render_procedure(name: str):
    if name in RENDER_PROCEDURES:
        return RENDER_PROCEDURES[name]
    raise ValueError(f"unknown render procedure '{name}'")
