"""Trilinear interpolation into a dense voxel grid (counterpart of
thr3ed_atom_tpu/ops/grid_sample.py): ``torch.grid_sample``'s semantics with
``align_corners=False`` and ``padding_mode='zeros'`` under the reference's
z, y, x permute, i.e. a normalized point (x, y, z) in [-1, 1]^3 indexes the
grid's (width x, depth y, height z) axes directly. Eight clamped taps, each
weighted zero outside the grid; the gradient to the volume is autograd's
index-add of the taps.
"""
import torch


def _unnormalize(coords: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] -> continuous voxel index, align_corners=False."""
    return ((coords + 1.0) * size - 1.0) * 0.5


def trilinear_grid_sample(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``volume`` [W, D, H, C] at normalized ``coords`` [N, 3] -> [N, C];
    taps outside the grid contribute zero."""
    W, D, H, C = volume.shape
    ix = _unnormalize(coords[:, 0], W)
    iy = _unnormalize(coords[:, 1], D)
    iz = _unnormalize(coords[:, 2], H)
    ix0, iy0, iz0 = torch.floor(ix), torch.floor(iy), torch.floor(iz)
    fx, fy, fz = ix - ix0, iy - iy0, iz - iz0
    ix0, iy0, iz0 = ix0.long(), iy0.long(), iz0.long()
    flat = volume.reshape(-1, C)

    def tap(dx, dy, dz):
        x, y, z = ix0 + dx, iy0 + dy, iz0 + dz
        valid = (x >= 0) & (x < W) & (y >= 0) & (y < D) & (z >= 0) & (z < H)
        idx = (x.clamp(0, W - 1) * D + y.clamp(0, D - 1)) * H + z.clamp(0, H - 1)
        vals = flat[idx]
        wx = fx if dx == 1 else (1.0 - fx)
        wy = fy if dy == 1 else (1.0 - fy)
        wz = fz if dz == 1 else (1.0 - fz)
        w = (wx * wy * wz) * valid.to(vals.dtype)
        return vals * w[:, None]

    out = tap(0, 0, 0)
    for dx, dy, dz in [(0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 0, 1), (1, 1, 0),
                       (1, 1, 1)]:
        out = out + tap(dx, dy, dz)
    return out
