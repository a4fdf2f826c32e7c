"""Point processor of the exact renderer: trilinear SH-voxel-grid lookup,
SH evaluation and AABB masking (counterpart of
thr3ed_atom_tpu/rendering/process.py)."""
import torch

from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid
from thr3ed_atom_tpu_torch.ops.sh import evaluate_spherical_harmonics
from thr3ed_atom_tpu_torch.rendering.interface import (
    ProcessedPointsOnRays,
    Rays,
    SampledPointsOnRays,
)
from thr3ed_atom_tpu_torch.utils.constants import INFINITY, NUM_COLOUR_CHANNELS


def process_points_with_sh_voxel_grid(
    sampled_points: SampledPointsOnRays,
    rays: Rays,
    voxel_grid: VoxelGrid,
    render_diffuse: bool = False,
) -> ProcessedPointsOnRays:
    """[N, S, 3] sampled points -> [N, S, 4] (raw RGB radiance ++ raw
    density). The SH degree is sqrt(F / 3) - 1; the diffuse variant keeps
    the degree-0 coefficient. Points outside the grid's AABB get radiance
    -INFINITY (sigmoid -> 0) and density 0."""
    num_rays, num_samples, num_coords = sampled_points.points.shape
    flat_points = sampled_points.points.reshape(-1, num_coords)

    interpolated = voxel_grid(flat_points)
    sh_coeffs, raw_densities = interpolated[..., :-1], interpolated[..., -1:]

    viewdirs = rays.directions / torch.linalg.vector_norm(rays.directions, dim=-1,
                                                          keepdim=True)
    viewdirs_tiled = viewdirs[:, None, :].expand(num_rays, num_samples,
                                                 num_coords).reshape(-1, num_coords)

    sh_coeffs = sh_coeffs.reshape(sh_coeffs.shape[0], NUM_COLOUR_CHANNELS, -1)
    if render_diffuse:
        sh_coeffs = sh_coeffs[..., :1]
        sh_degree = 0
    else:
        sh_degree = int(round(sh_coeffs.shape[-1] ** 0.5)) - 1
    raw_radiance = evaluate_spherical_harmonics(sh_degree, sh_coeffs, viewdirs_tiled)

    inside_mask = voxel_grid.test_inside_volume(flat_points)
    filtered_radiance = torch.where(inside_mask, raw_radiance, -INFINITY)
    filtered_densities = torch.where(inside_mask, raw_densities, 0.0)
    processed = torch.cat([filtered_radiance, filtered_densities], dim=-1)
    return ProcessedPointsOnRays(processed.reshape(num_rays, num_samples, -1),
                                 sampled_points.depths)
