"""Cell-packed corner tables for trilinear sampling (counterpart of
thr3ed_atom_tpu/ops/packed_grid.py).

The grid is zero-padded by one voxel on every side (grid_sample's
``padding_mode='zeros'`` border), and for every cell origin (i, j, k) of the
padded grid one row holds the cell's 8 corner values [2, 2, 2, C] flattened.
A sample at the continuous voxel coordinate t (``align_corners=False``) lies
in cell floor(t); its value is the 8-wide weighted sum of that row with the
trilinear weights. Samples whose cell lies outside [-1, size - 1] (wholly
outside the zero border) get zero weights: the same values as
ops/grid_sample.py's eight clamped taps, from one gathered row a sample.
"""
from typing import Tuple

import torch
import torch.nn.functional as F


def pack_grid_cells(volume: torch.Tensor) -> torch.Tensor:
    """[W, D, H, C] vertex grid -> [(W+1)*(D+1)*(H+1), 8*C] cell-packed table.

    Row r is cell (i, j, k) of the zero-padded grid (origin offset by +1),
    its corners in (dx, dy, dz) C-order: c000, c001, c010, c011, c100, c101,
    c110, c111, each a C-vector. Differentiable (slices and a stack)."""
    W, D, H, C = volume.shape
    padded = F.pad(volume, (0, 0, 1, 1, 1, 1, 1, 1))
    corners = [padded[dx:dx + W + 1, dy:dy + D + 1, dz:dz + H + 1]
               for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    return torch.stack(corners, dim=-2).reshape((W + 1) * (D + 1) * (H + 1), 8 * C)


def _cell_and_weights(coords: torch.Tensor, dims: Tuple[int, int, int]
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalized [-1, 1] coords [N, 3] -> (flat cell row index [N] int64,
    trilinear weights [N, 8] in the table's corner order, validity mask
    [N])."""
    W, D, H = dims
    sizes = torch.tensor([W, D, H], dtype=coords.dtype, device=coords.device)
    t = ((coords + 1.0) * sizes - 1.0) * 0.5  # continuous voxel index per axis
    t0 = torch.floor(t)
    f = t - t0
    t0 = t0.long()

    # a sample only touches real data when its cell origin is within [-1, size - 1]
    upper = torch.tensor([W - 1, D - 1, H - 1], device=coords.device)
    valid = torch.all((t0 >= -1) & (t0 <= upper), dim=-1)
    cell = torch.minimum(torch.clamp_min(t0 + 1, 0), upper + 1)  # padded-grid origin
    flat_cell = (cell[:, 0] * (D + 1) + cell[:, 1]) * (H + 1) + cell[:, 2]

    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    wx = torch.stack([1.0 - fx, fx], dim=-1)  # [N, 2]
    wy = torch.stack([1.0 - fy, fy], dim=-1)
    wz = torch.stack([1.0 - fz, fz], dim=-1)
    # corner order (dx, dy, dz) C-order, as pack_grid_cells
    weights = (wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
               ).reshape(-1, 8)
    weights = weights * valid[:, None].to(weights.dtype)
    return flat_cell, weights, valid


def packed_weighted_sum(weights: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The 8-wide weighted sum ``weights`` [N, 8] . ``rows`` [N, 8, C] ->
    [N, C] in true f32 (a multiply and a sum: no TF32 product), the JAX
    package's einsum at Precision.HIGHEST."""
    return torch.sum(weights[:, :, None] * rows, dim=1)


def packed_trilinear_sample(packed: torch.Tensor, coords: torch.Tensor,
                            dims: Tuple[int, int, int]) -> torch.Tensor:
    """Sample a cell-packed table ``packed`` [(W+1)(D+1)(H+1), 8C] at
    normalized ``coords`` [N, 3] -> [N, C]: one gathered row a sample;
    the values of ops.grid_sample.trilinear_grid_sample on the original
    [W, D, H, C] grid ``dims`` = (W, D, H)."""
    C = packed.shape[-1] // 8
    flat_cell, weights, _ = _cell_and_weights(coords, dims)
    rows = packed.index_select(0, flat_cell).reshape(-1, 8, C)
    return packed_weighted_sum(weights, rows.to(weights.dtype))
