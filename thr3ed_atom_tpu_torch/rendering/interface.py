"""Render types and the three-stage render composition (counterpart of
thr3ed_atom_tpu/rendering/interface.py): ``Rays``, ``RenderOut``, the sampled
and processed points, and ``render`` (sampler -> point processor ->
accumulator), the seam where the exact renderer's stages plug in.
Randomness is injected into the stages (a ``torch.Generator`` or explicit
draws), never taken from global state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Union

import torch

from thr3ed_atom_tpu_torch.utils.camera import CameraBounds
from thr3ed_atom_tpu_torch.utils.constants import NUM_COORD_DIMENSIONS


@dataclasses.dataclass(frozen=True)
class Rays:
    """A bundle of rays: origins [N, 3], directions [N, 3] (or [..., 3])."""

    origins: torch.Tensor
    directions: torch.Tensor

    def __post_init__(self):
        assert self.origins.shape[-1] == NUM_COORD_DIMENSIONS
        assert self.directions.shape[-1] == NUM_COORD_DIMENSIONS

    def __len__(self) -> int:
        return self.origins.shape[0]

    def __getitem__(self, item) -> "Rays":
        return Rays(origins=self.origins[item], directions=self.directions[item])


@dataclasses.dataclass(frozen=True)
class RenderOut:
    """Render output: colour [..., 3], depth [..., 1], plus named extras."""

    colour: torch.Tensor
    depth: torch.Tensor
    extra: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


class SampledPointsOnRays(NamedTuple):
    points: torch.Tensor  # [N, S, 3]
    depths: torch.Tensor  # [N, S]


class ProcessedPointsOnRays(NamedTuple):
    points: torch.Tensor  # [N, S, C + 1] (radiance ++ density)
    depths: torch.Tensor  # [N, S]


RaySamplerFunction = Callable[..., SampledPointsOnRays]
PointProcessorFunction = Callable[..., ProcessedPointsOnRays]
AccumulatorFunction = Callable[..., RenderOut]


def render(
    rays: Rays,
    camera_bounds: Union[CameraBounds, torch.Tensor],
    num_samples: int,
    sampler_fn: RaySamplerFunction,
    point_processor_fn: PointProcessorFunction,
    accumulator_fn: AccumulatorFunction,
) -> RenderOut:
    """Compose the three stages over flat [N, 3] rays."""
    assert rays.origins.ndim == 2, "render() requires flat [N, 3] rays"
    sampled_points = sampler_fn(rays, camera_bounds, num_samples)
    processed_points = point_processor_fn(sampled_points, rays)
    return accumulator_fn(processed_points, rays)
