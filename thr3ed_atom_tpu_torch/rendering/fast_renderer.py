"""The two-phase top-K renderer (counterpart of
thr3ed_atom_tpu/rendering/fast_renderer.py), the JAX package's default
ray-batch training procedure:

  phase 1: one 8-wide row a sample from the cell-packed density table ->
           alphas -> transmittance weights for all S samples of a ray;
           depth, disparity and acc use all of them and are exact;
  select:  the K samples of largest weight a ray (ties: the lower sample
           index first, as jax.lax.top_k);
  phase 2: one 8F-wide row a selected sample from the cell-packed feature
           table -> SH evaluation and tone map -> weighted sum. Colour drops
           only the weight outside the top K.

Otherwise the exact renderer's semantics (rendering/renderer.py): samplers,
activations, the strict AABB mask, the INFINITY tail, the white background,
the density noise. Randomness is injected as in the exact renderer: the
stratified jitter's uniforms ``t_rand`` [N, S] and the density noise's
standard normals ``noise`` [N, S], or a ``torch.Generator`` to draw them
from (jitter first, then noise). Plain PyTorch ops on the grid's device,
differentiable in the grid's tensors; the JAX package has no Pallas kernel
here.
"""
from typing import Optional, Tuple

import torch

from thr3ed_atom_tpu_torch.models.voxels import ACTIVATIONS, VoxelGrid
from thr3ed_atom_tpu_torch.ops.grid_sample import trilinear_grid_sample
from thr3ed_atom_tpu_torch.ops.packed_grid import (
    _cell_and_weights,
    pack_grid_cells,
    packed_weighted_sum,
)
from thr3ed_atom_tpu_torch.ops.sh import evaluate_spherical_harmonics
from thr3ed_atom_tpu_torch.rendering.accumulate import DENSITY2OCCUPANCY, TONE_MAPS
from thr3ed_atom_tpu_torch.rendering.interface import Rays, RenderOut
from thr3ed_atom_tpu_torch.rendering.sample import (
    sample_aabb_bound_uniform_points_on_rays,
    sample_uniform_points_on_rays,
)
from thr3ed_atom_tpu_torch.utils.constants import (
    EXTRA_ACCUMULATED_WEIGHTS,
    EXTRA_DIFFUSE_COLOUR,
    EXTRA_DISPARITY,
    INFINITY,
    NUM_COLOUR_CHANNELS,
    ZERO_PLUS,
)
from thr3ed_atom_tpu_torch.utils.logging import log


def prepare_packed_tables(voxel_grid: VoxelGrid, feature_dtype: Optional[torch.dtype] = None,
                          pack_features: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (density, features) tables of ``voxel_grid``: the cell-packed
    density table [cells, 8] and the cell-packed feature table [cells, 8F]
    (``pack_features=False``: the activated [W, D, H, F] grid, sampled by
    eight taps a selected sample), the features cast to ``feature_dtype``
    (``torch.bfloat16`` halves phase 2's rows). Built once, they serve every
    ray chunk of a grid (``render_sh_voxel_grid_fast(..., prepared=...)``)."""
    pre_densities, pre_features = voxel_grid.activated_grids()
    if feature_dtype is not None:
        pre_features = pre_features.to(feature_dtype)
    features = pack_grid_cells(pre_features) if pack_features else pre_features
    return pack_grid_cells(pre_densities), features


def prepare_for_config(voxel_grid: VoxelGrid, config) -> Tuple[torch.Tensor, torch.Tensor]:
    """``prepare_packed_tables`` with the config's table choices
    (``fast_bf16_features``, ``fast_pack_features``)."""
    return prepare_packed_tables(
        voxel_grid, feature_dtype=torch.bfloat16 if config.fast_bf16_features else None,
        pack_features=config.fast_pack_features)


def render_sh_voxel_grid_fast(
    voxel_grid: VoxelGrid,
    rays: Rays,
    render_config,
    generator: Optional[torch.Generator] = None,
    prepared=None,
    *,
    t_rand: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> RenderOut:
    """Two-phase render of flat rays [N, 3] with ``render_config``'s
    sampler (AABB-bound with ``optimized_sampling``), ``fast_topk`` and
    table modes; ``prepared`` = ``prepare_packed_tables``' result, else the
    tables are built here (differentiably)."""
    config = render_config
    if config.optimized_sampling:
        sampled = sample_aabb_bound_uniform_points_on_rays(
            rays, config.camera_bounds, config.num_samples_per_ray, aabb=voxel_grid.aabb,
            generator=generator, perturb=config.perturb_sampled_points, t_rand=t_rand)
    else:
        sampled = sample_uniform_points_on_rays(
            rays, config.camera_bounds, config.num_samples_per_ray, generator=generator,
            perturb=config.perturb_sampled_points, t_rand=t_rand)
    if prepared is None:
        prepared = prepare_for_config(voxel_grid, config)
    packed_density, features_table = prepared
    return shade_samples(voxel_grid, rays, sampled.depths, config, packed_density,
                         features_table, generator=generator, noise=noise)


def density_at_samples(voxel_grid: VoxelGrid, packed_density: torch.Tensor,
                       flat_points: torch.Tensor) -> torch.Tensor:
    """Post-activated densities [M] at world points [M, 3] from the packed
    density table (one 8-wide row a point), zero outside the strict AABB."""
    cells, weights, _ = _cell_and_weights(voxel_grid.normalize_points(flat_points),
                                          voxel_grid.grid_dims)
    rows = packed_density.index_select(0, cells)  # [M, 8]
    density = ACTIVATIONS[voxel_grid.density_postactivation](torch.sum(rows * weights, dim=-1))
    inside = voxel_grid.test_inside_volume(flat_points)[:, 0]
    return torch.where(inside, density, 0.0)


def _interval_deltas(depths: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """Sample intervals [N, S] with an INFINITY tail, in world units."""
    deltas = depths[..., 1:] - depths[..., :-1]
    inf_delta = torch.full((depths.shape[0], 1), INFINITY, dtype=deltas.dtype,
                           device=deltas.device)
    return torch.cat([deltas, inf_delta], dim=-1) * torch.linalg.vector_norm(
        directions, dim=-1, keepdim=True)


def transmittance_weights(alpha: torch.Tensor) -> torch.Tensor:
    """alpha * exclusive-cumprod(1 - alpha) along the last axis."""
    transmittance = torch.cumprod(1.0 - alpha, dim=-1)
    exclusive = torch.cat([torch.ones_like(transmittance[..., :1]), transmittance[..., :-1]],
                          dim=-1)
    return alpha * exclusive


def _clip01(alpha: torch.Tensor) -> torch.Tensor:
    """jnp.clip(alpha, 0, 1) as max then min, whose gradient splits as JAX's."""
    return torch.minimum(torch.maximum(alpha, alpha.new_zeros(())), alpha.new_ones(()))


def top_k_stable(weights: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest weights a ray and their sample indices, largest
    first, equal weights in ascending index (jax.lax.top_k's order; rays
    that miss the box have all-zero weights). torch.topk promises no order
    among ties, so a stable descending sort cut to ``k``."""
    values, idx = torch.sort(weights, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def shade_samples(
    voxel_grid: VoxelGrid,
    rays: Rays,
    depths: torch.Tensor,
    config,
    packed_density: torch.Tensor,
    packed_features: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> RenderOut:
    """Two-phase shading of given sorted sample depths [N, S] (shared by
    the fast and hierarchical procedures): the density pass over all S
    samples -> exact weights, depth, disparity and acc -> the top-K feature
    fetch and SH shading -> the composited RenderOut. The density noise's
    normals [N, S] are ``noise``, or drawn from ``generator``."""
    num_rays, num_samples = depths.shape
    dims = voxel_grid.grid_dims
    flat_points = (rays.origins[:, None, :] + rays.directions[:, None, :] * depths[..., None]
                   ).reshape(-1, 3)

    # ---- phase 1: density over all samples
    raw_density = density_at_samples(voxel_grid, packed_density, flat_points)
    raw_density = raw_density.reshape(num_rays, num_samples)
    deltas = _interval_deltas(depths, rays.directions)
    if config.stochastic_density_noise_std > 0.0:
        if noise is None:
            assert generator is not None, "density noise requires a generator or noise"
            noise = torch.randn(raw_density.shape, generator=generator,
                                dtype=raw_density.dtype, device=raw_density.device)
        raw_density = raw_density + noise * config.stochastic_density_noise_std
    alpha = _clip01(DENSITY2OCCUPANCY[config.density2occupancy](raw_density, deltas))
    weights = transmittance_weights(alpha)  # [N, S], exact

    acc_render = torch.sum(weights, dim=-1, keepdim=True)
    depth_render = torch.sum(depths * weights, dim=-1, keepdim=True)
    disparity_render = 1.0 / torch.clamp_min(
        depth_render / torch.clamp_min(acc_render, ZERO_PLUS), ZERO_PLUS)

    # ---- select the top K samples a ray
    k = min(config.fast_topk, num_samples)
    top_weights, top_idx = top_k_stable(weights, k)
    top_depths = torch.gather(depths, -1, top_idx)  # [N, K]

    # ---- phase 2: features of the selected samples, their cells and
    # weights recomputed from the depths
    top_points = (rays.origins[:, None, :] + rays.directions[:, None, :] * top_depths[..., None]
                  ).reshape(-1, 3)
    top_normalized = voxel_grid.normalize_points(top_points)
    top_inside = voxel_grid.test_inside_volume(top_points)[:, 0].reshape(num_rays, k)
    num_features = voxel_grid.num_features
    if packed_features.dim() == 2:  # cell-packed [cells, 8F]: one row a sample
        sel_cells, sel_weights, _ = _cell_and_weights(top_normalized, dims)
        rows = packed_features.index_select(0, sel_cells).reshape(-1, 8, num_features)
        sh_coeffs = packed_weighted_sum(sel_weights, rows.to(sel_weights.dtype))
    else:  # the raw [W, D, H, F] grid: eight corner taps a sample
        sh_coeffs = trilinear_grid_sample(packed_features.to(torch.float32), top_normalized)
    sh_coeffs = ACTIVATIONS[voxel_grid.feature_postactivation](sh_coeffs)
    sh_coeffs = sh_coeffs.reshape(num_rays, k, NUM_COLOUR_CHANNELS, -1)
    if config.render_diffuse:
        sh_coeffs = sh_coeffs[..., :1]
        sh_degree = 0
    else:
        sh_degree = int(round(sh_coeffs.shape[-1] ** 0.5)) - 1

    viewdirs = rays.directions / torch.linalg.vector_norm(rays.directions, dim=-1,
                                                          keepdim=True)
    tone_map = TONE_MAPS[config.radiance_hdr_tone_map]

    def composite(degree, coeffs):
        colour = tone_map(evaluate_spherical_harmonics(degree, coeffs, viewdirs[:, None, :]))
        # samples outside the box have weight 0 already; the exact renderer
        # also zeroes their radiance
        colour = torch.where(top_inside[..., None], colour, 0.0)
        out = torch.sum(colour * top_weights[..., None], dim=-2)  # [N, 3]
        return out + (1.0 - acc_render) if config.white_bkgd else out

    extra = {EXTRA_DISPARITY: disparity_render, EXTRA_ACCUMULATED_WEIGHTS: acc_render}
    colour_render = composite(sh_degree, sh_coeffs)
    if config.also_render_diffuse and not config.render_diffuse:
        # the degree-0 truncation of the same coefficients and weights
        extra[EXTRA_DIFFUSE_COLOUR] = composite(0, sh_coeffs[..., :1])
    return RenderOut(colour=colour_render, depth=depth_render, extra=extra)


class FlatRaysToFast:
    """Base of the pose-structured procedures' registry objects (gnomonic,
    bricked, planes): whole poses go through their ``render_image`` /
    ``render_poses``; a flat ray batch called on the object is routed to
    ``render_sh_voxel_grid_fast``, which shares the grid's activation and
    SH conventions, and the switch is logged once per class (the JAX
    package's routing). ``prepared`` is ignored: these procedures have no
    ``prepare`` hook, so the fast renderer packs its own tables."""

    name = ""
    pipeline = ""  # what renders the class's whole poses
    _warned_flat_rays = False

    def __call__(self, voxel_grid, rays, render_config, generator=None, prepared=None,
                 **draws) -> RenderOut:
        cls = type(self)
        if not cls._warned_flat_rays:
            log.info(f"{self.name}: flat ray batch requested; the {self.pipeline} is "
                     "pose-structured, routing these rays through render_sh_voxel_grid_fast "
                     f"(whole-pose renders keep the {self.pipeline})")
            cls._warned_flat_rays = True
        return render_sh_voxel_grid_fast(voxel_grid, rays, render_config, generator, **draws)
