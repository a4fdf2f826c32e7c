"""Render output container (counterpart of thr3ed_atom_tpu/rendering/interface.py
``RenderOut``)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class RenderOut:
    """Render output: colour [..., 3], depth [..., 1], plus named extras."""

    colour: torch.Tensor
    depth: torch.Tensor
    extra: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
