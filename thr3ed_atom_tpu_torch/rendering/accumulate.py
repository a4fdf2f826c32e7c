"""Alpha compositing of the exact renderer: density -> occupancy ->
transmittance-weighted sums (counterpart of
thr3ed_atom_tpu/rendering/accumulate.py). The stochastic density noise is
injected: ``noise`` [N, S] standard normals, or a ``torch.Generator`` to draw
them from."""
from typing import Callable, Dict, Optional

import torch

from thr3ed_atom_tpu_torch.rendering.interface import ProcessedPointsOnRays, Rays, RenderOut
from thr3ed_atom_tpu_torch.utils.constants import (
    EXTRA_ACCUMULATED_WEIGHTS,
    EXTRA_DISPARITY,
    EXTRA_POINT_DENSITIES,
    EXTRA_POINT_DEPTHS,
    EXTRA_POINT_OCCUPANCIES,
    EXTRA_POINT_WEIGHTS,
    EXTRA_SAMPLE_INTERVALS,
    INFINITY,
    ZERO_PLUS,
)


def density2occupancy_pb(densities: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Physically based occupancy alpha = 1 - exp(-density * delta)."""
    return 1.0 - torch.exp(-(densities * deltas))


# registries, so render configs name the transfer functions (no pickles)
DENSITY2OCCUPANCY: Dict[str, Callable] = {"pb": density2occupancy_pb}
TONE_MAPS: Dict[str, Callable] = {
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}


def accumulate_radiance_density_on_rays(
    processed_points: ProcessedPointsOnRays,
    rays: Rays,
    generator: Optional[torch.Generator] = None,
    stochastic_density_noise_std: float = 0.0,
    density2occupancy: Callable = density2occupancy_pb,
    radiance_hdr_tone_map: Callable = torch.sigmoid,
    white_bkgd: bool = True,
    extra_debug_info: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> RenderOut:
    raw_radiance = processed_points.points[..., :-1]  # [N, S, C]
    raw_density = processed_points.points[..., -1]  # [N, S]
    depths = processed_points.depths  # [N, S]

    # sample intervals with an INFINITY tail, in world units (times |ray dir|)
    deltas = depths[..., 1:] - depths[..., :-1]
    inf_delta = torch.full((*deltas.shape[:-1], 1), INFINITY, dtype=deltas.dtype,
                           device=deltas.device)
    deltas = torch.cat([deltas, inf_delta], dim=-1)
    deltas = deltas * torch.linalg.vector_norm(rays.directions, dim=-1, keepdim=True)

    if stochastic_density_noise_std > 0.0:
        if noise is None:
            assert generator is not None, "density noise requires a generator or noise"
            noise = torch.randn(raw_density.shape, generator=generator,
                                dtype=raw_density.dtype, device=raw_density.device)
        raw_density = raw_density + noise * stochastic_density_noise_std

    # clipped into [0, 1]: a no-op without noise; with it, keeps negative
    # noised densities from driving alpha to -inf through the INFINITY tail.
    # max/min as jnp.clip computes it, so the gradient splits at alpha = 0
    # (empty space) as the reference's does
    alpha = density2occupancy(raw_density, deltas)
    alpha = torch.minimum(torch.maximum(alpha, alpha.new_zeros(())), alpha.new_ones(()))

    # weights = alpha * exclusive-cumprod(1 - alpha)
    transmittance = torch.cumprod(1.0 - alpha, dim=-1)
    exclusive_transmittance = torch.cat(
        [torch.ones_like(transmittance[..., :1]), transmittance[..., :-1]], dim=-1)
    weights = alpha * exclusive_transmittance

    colour = radiance_hdr_tone_map(raw_radiance)
    colour_render = torch.sum(colour * weights[..., None], dim=-2)  # [N, C]
    acc_render = torch.sum(weights, dim=-1, keepdim=True)  # [N, 1]
    if white_bkgd:
        colour_render = colour_render + (1.0 - acc_render)

    depth_render = torch.sum(depths * weights, dim=-1, keepdim=True)
    # fully empty rays (acc == 0) saturate to the maximum disparity, no NaN
    disparity_render = 1.0 / torch.clamp_min(
        depth_render / torch.clamp_min(acc_render, ZERO_PLUS), ZERO_PLUS)

    extra = {EXTRA_DISPARITY: disparity_render, EXTRA_ACCUMULATED_WEIGHTS: acc_render}
    if extra_debug_info:
        extra.update({
            EXTRA_POINT_DENSITIES: raw_density,
            EXTRA_POINT_OCCUPANCIES: alpha,
            EXTRA_POINT_WEIGHTS: weights,
            EXTRA_POINT_DEPTHS: depths,
            EXTRA_SAMPLE_INTERVALS: deltas,
        })
    return RenderOut(colour=colour_render, depth=depth_render, extra=extra)
