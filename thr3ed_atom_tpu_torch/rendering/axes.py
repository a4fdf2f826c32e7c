"""March-axis helpers shared by the gnomonic renderer and the warp (counterparts
of thr3ed_atom_tpu/rendering/bricked.py ``_uv_axes`` and
``dominant_axis_for_pose``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _uv_axes(axis: int) -> Tuple[int, int]:
    others = [0, 1, 2]
    others.remove(axis)
    return others[0], others[1]


def dominant_axis_for_pose(rotation: np.ndarray) -> Tuple[int, bool]:
    """March axis + flip from the camera's forward direction (-R[:, 2] in the
    OpenGL-style camera convention)."""
    forward = -np.asarray(rotation).reshape(3, 3)[:, 2]
    axis = int(np.argmax(np.abs(forward)))
    return axis, bool(forward[axis] < 0.0)
