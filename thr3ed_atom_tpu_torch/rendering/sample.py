"""Ray samplers: uniform depth sampling (stratified jitter, disparity
spacing) and its AABB-clipped variant, with the slab-test
``ray_aabb_intersection`` (counterpart of thr3ed_atom_tpu/rendering/sample.py).

The stratified jitter is injected: ``t_rand`` [N, S] uniforms in [0, 1), or a
``torch.Generator`` to draw them from.
"""
from typing import Optional, Tuple, Union

import torch

from thr3ed_atom_tpu_torch.models.voxels import AxisAlignedBoundingBox
from thr3ed_atom_tpu_torch.rendering.interface import Rays, SampledPointsOnRays
from thr3ed_atom_tpu_torch.utils.camera import CameraBounds
from thr3ed_atom_tpu_torch.utils.constants import ZERO_PLUS


def _broadcast_bounds(bounds: Union[CameraBounds, torch.Tensor], num_rays: int,
                      like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """CameraBounds (scalars) or per-ray [N, 2] -> (near [N, 1], far [N, 1])."""
    if isinstance(bounds, CameraBounds):
        near = torch.full((num_rays, 1), bounds.near, dtype=like.dtype, device=like.device)
        far = torch.full((num_rays, 1), bounds.far, dtype=like.dtype, device=like.device)
        return near, far
    return bounds[:, :1], bounds[:, 1:]


def uniform_t_vals(num_samples: int, like: torch.Tensor) -> torch.Tensor:
    """[1, S] of linspace(0, 1, S) as the JAX package's jitted ``jnp.linspace``
    rounds it: i times the f32 reciprocal of (S - 1), the last exactly 1."""
    i = torch.arange(num_samples, dtype=like.dtype, device=like.device)
    if num_samples > 1:
        recip = torch.tensor(1.0, dtype=like.dtype) / torch.tensor(num_samples - 1.0,
                                                                  dtype=like.dtype)
        i = i * recip.to(like.device)
        i[-1] = 1.0
    return i[None, :]


def sample_uniform_points_on_rays(
    rays: Rays,
    bounds: Union[CameraBounds, torch.Tensor],
    num_samples: int,
    generator: Optional[torch.Generator] = None,
    perturb: bool = True,
    linear_disparity_sampling: bool = False,
    t_rand: Optional[torch.Tensor] = None,
) -> SampledPointsOnRays:
    """z = lerp(near, far, linspace(0, 1, S)), optionally spaced in inverse
    depth, optionally jittered within the midpoint intervals by ``t_rand``
    (drawn from ``generator`` when not given)."""
    rays_o = rays.origins.reshape(-1, rays.origins.shape[-1])
    rays_d = rays.directions.reshape(-1, rays.directions.shape[-1])
    num_rays = rays_o.shape[0]
    near, far = _broadcast_bounds(bounds, num_rays, rays_o)

    t_vals = uniform_t_vals(num_samples, rays_o)
    if linear_disparity_sampling:
        z_vals = 1.0 / (1.0 / (near + ZERO_PLUS) * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        z_vals = near * (1.0 - t_vals) + far * t_vals

    if perturb:
        if t_rand is None:
            assert generator is not None, "perturbed sampling requires a generator or t_rand"
            t_rand = torch.rand((num_rays, num_samples), generator=generator,
                                dtype=rays_o.dtype, device=rays_o.device)
        mid_points = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper_points = torch.cat([mid_points, z_vals[..., -1:]], dim=-1)
        lower_points = torch.cat([z_vals[..., :1], mid_points], dim=-1)
        z_vals = lower_points + (upper_points - lower_points) * t_rand
    else:
        z_vals = z_vals.expand(num_rays, num_samples)

    sampled_points = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[:, :, None]
    return SampledPointsOnRays(sampled_points, z_vals)


def ray_aabb_intersection(rays: Rays, bounds: CameraBounds,
                          aabb: AxisAlignedBoundingBox) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray [N, 2] (near, far) from the slab test, and whether each ray
    meets the box; rays that miss it keep the scene bounds; negative entries
    are clipped at 0."""
    origins, directions = rays.origins, rays.directions
    kw = dict(dtype=origins.dtype, device=origins.device)
    box_lo = torch.tensor([aabb.x_range[0], aabb.y_range[0], aabb.z_range[0]], **kw)
    box_hi = torch.tensor([aabb.x_range[1], aabb.y_range[1], aabb.z_range[1]], **kw)
    # the reference guards the division with an additive epsilon, not a signed one
    inv_d = 1.0 / (directions + ZERO_PLUS)
    t_a = (box_lo[None, :] - origins) * inv_d  # [N, 3]
    t_b = (box_hi[None, :] - origins) * inv_d
    t_near = torch.amax(torch.minimum(t_a, t_b), dim=-1, keepdim=True)  # latest entry
    t_far = torch.amin(torch.maximum(t_a, t_b), dim=-1, keepdim=True)  # earliest exit
    intersecting = t_near <= t_far
    orig_bounds = torch.tensor([bounds.near, bounds.far], **kw)[None, :].expand(
        origins.shape[0], 2)
    final_bounds = torch.where(intersecting, torch.cat([t_near, t_far], dim=-1), orig_bounds)
    return torch.clamp_min(final_bounds, 0.0), intersecting


def sample_aabb_bound_uniform_points_on_rays(
    rays: Rays,
    bounds: CameraBounds,
    num_samples: int,
    aabb: AxisAlignedBoundingBox,
    generator: Optional[torch.Generator] = None,
    perturb: bool = True,
    t_rand: Optional[torch.Tensor] = None,
) -> SampledPointsOnRays:
    """Uniform sampling between each ray's entry into and exit from ``aabb``."""
    per_ray_bounds, _ = ray_aabb_intersection(rays, bounds, aabb)
    return sample_uniform_points_on_rays(rays, bounds=per_ray_bounds, num_samples=num_samples,
                                         generator=generator, perturb=perturb, t_rand=t_rand)
