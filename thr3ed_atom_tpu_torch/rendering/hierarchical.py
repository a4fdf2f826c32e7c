"""Hierarchical (coarse-to-fine) importance sampling along rays (counterpart
of thr3ed_atom_tpu/rendering/hierarchical.py).

A coarse density-only pass at S_c uniform samples guides an inverse-CDF draw
of S_f fine samples, which go where the transmittance weight lies; the
sorted union is shaded by the fast renderer's two-phase machinery
(rendering/fast_renderer.py ``shade_samples``). ``num_samples_per_ray`` is
the whole budget: S_c = max(S // 2, 8), S_f = max(S - S_c, 8).

Each draw can be given: the coarse jitter's uniforms ``t_rand`` [N, S_c],
the fine uniforms ``u`` [N, S_f] and the density noise's normals ``noise``
[N, S_c + S_f]; or a ``torch.Generator`` draws them, in that order.
"""
from typing import Optional

import torch

from thr3ed_atom_tpu_torch.rendering.accumulate import DENSITY2OCCUPANCY
from thr3ed_atom_tpu_torch.rendering.fast_renderer import (
    _clip01,
    _interval_deltas,
    density_at_samples,
    prepare_for_config,
    shade_samples,
    transmittance_weights,
)
from thr3ed_atom_tpu_torch.rendering.interface import Rays, RenderOut
from thr3ed_atom_tpu_torch.rendering.sample import (
    ray_aabb_intersection,
    sample_uniform_points_on_rays,
    uniform_t_vals,
)
from thr3ed_atom_tpu_torch.utils.constants import ZERO_PLUS

U_MAX = 1.0 - 1e-6  # the fine uniforms' cap


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    deterministic: bool = False,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-CDF sampling of ``num_samples`` depths a ray from bin edges
    ``bins`` [N, B+1] (ascending) and unnormalized bin weights ``weights``
    [N, B] (the classic NeRF sample_pdf). ``deterministic``: the uniforms
    are linspace(0, 1 - 1e-6, n) as the JAX package's jitted linspace
    rounds it; else ``u`` [N, n], or U[0, 1 - 1e-6) draws from
    ``generator``. Returns [N, n], unsorted."""
    weights = weights + 1e-5  # no degenerate pdf on empty rays
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [N, B+1]

    num_rays = bins.shape[0]
    if deterministic:
        u = uniform_t_vals(num_samples, bins) * torch.tensor(U_MAX, dtype=bins.dtype,
                                                             device=bins.device)
        u = u.expand(num_rays, num_samples)
    elif u is None:
        assert generator is not None, "stochastic pdf sampling requires a generator or u"
        u = torch.rand((num_rays, num_samples), generator=generator, dtype=bins.dtype,
                       device=bins.device) * U_MAX

    # the bin whose cdf straddles u, per ray
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(idx - 1, 0, cdf.shape[-1] - 2)
    above = torch.clamp(idx, 1, cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = torch.clamp_min(cdf_above - cdf_below, ZERO_PLUS)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def hierarchical_budget(num_samples_per_ray: int):
    """(coarse, fine) sample counts of a ``num_samples_per_ray`` budget."""
    num_coarse = max(num_samples_per_ray // 2, 8)
    return num_coarse, max(num_samples_per_ray - num_coarse, 8)


def render_sh_voxel_grid_hierarchical(
    voxel_grid,
    rays: Rays,
    render_config,
    generator: Optional[torch.Generator] = None,
    prepared=None,
    *,
    t_rand: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> RenderOut:
    """Coarse density march -> importance-resampled fine depths -> two-phase
    shading of the sorted union. Other config semantics follow
    render_sh_voxel_grid_fast; the fine depths do not depend on the grid
    (the coarse weights are detached)."""
    config = render_config
    num_coarse, num_fine = hierarchical_budget(config.num_samples_per_ray)
    if prepared is None:
        prepared = prepare_for_config(voxel_grid, config)
    packed_density, packed_features = prepared

    # per-ray bounds (AABB-clipped with optimized sampling)
    if config.optimized_sampling:
        bounds, _ = ray_aabb_intersection(rays, config.camera_bounds, voxel_grid.aabb)
    else:
        bounds = config.camera_bounds

    # ---- coarse pass: densities only, no noise
    z_coarse = sample_uniform_points_on_rays(
        rays, bounds, num_coarse, generator=generator,
        perturb=config.perturb_sampled_points, t_rand=t_rand).depths
    density_coarse = density_at_samples(voxel_grid, packed_density,
                                         (rays.origins[:, None, :] + rays.directions[:, None, :]
                                          * z_coarse[..., None]).reshape(-1, 3)
                                         ).reshape(z_coarse.shape)
    alpha = _clip01(DENSITY2OCCUPANCY[config.density2occupancy](
        density_coarse, _interval_deltas(z_coarse, rays.directions)))
    weights_coarse = transmittance_weights(alpha)

    # ---- fine pass
    mids = 0.5 * (z_coarse[:, 1:] + z_coarse[:, :-1])
    bins = torch.cat([z_coarse[:, :1], mids, z_coarse[:, -1:]], dim=-1)
    z_fine = sample_pdf(bins, weights_coarse.detach(), num_fine,
                        deterministic=not config.perturb_sampled_points,
                        generator=generator, u=u)
    z_all = torch.sort(torch.cat([z_coarse, z_fine], dim=-1), dim=-1).values

    return shade_samples(voxel_grid, rays, z_all, config, packed_density, packed_features,
                         generator=generator, noise=noise)
