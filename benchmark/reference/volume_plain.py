"""A plain ray-marching volume renderer of an SH relu-field grid, used to
make the benchmark's target images: uniform samples between the near and
far planes, trilinear lookups (``F.grid_sample``, half-texel voxel centres),
relu density, sigmoid of the degree-2 SH colour along the view direction,
alpha compositing onto white."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reference.gnomonic_plain import sh_rows

F32 = torch.float32


@torch.no_grad()
def render_views(densities: torch.Tensor, features: torch.Tensor, extent: float,
                 poses: np.ndarray, height: int, width: int, focal: float,
                 near: float, far: float, samples: int, rows_per_chunk: int = 50) -> torch.Tensor:
    """[N, H, W, 3] f32 colours of ``poses`` [N, 3, 4], quantized to 8 bits
    as a dataset's PNGs are."""
    dev = features.device
    ncoeff = features.shape[-1] // 3
    vol = torch.cat([features, densities], -1).permute(3, 2, 1, 0)[None]  # [1, C, Z, Y, X]
    t = near + (torch.arange(samples, dtype=F32, device=dev) + 0.5) * ((far - near) / samples)
    delta = (far - near) / samples
    out = torch.empty((len(poses), height, width, 3), dtype=F32, device=dev)
    px = torch.arange(width, dtype=F32, device=dev) + 0.5
    for n, pose in enumerate(poses):
        rot = torch.as_tensor(pose[:, :3], dtype=F32, device=dev)
        org = torch.as_tensor(pose[:, 3], dtype=F32, device=dev)
        for r0 in range(0, height, rows_per_chunk):
            py = torch.arange(r0, min(height, r0 + rows_per_chunk), dtype=F32, device=dev) + 0.5
            cam = torch.stack(torch.broadcast_tensors(
                ((px[None, :] - width / 2) / focal), (-(py[:, None] - height / 2) / focal),
                -torch.ones((), device=dev)), dim=-1)  # [h, W, 3]
            dirs = cam @ rot.T
            pts = org + dirs[..., None, :] * t[:, None]  # [h, W, S, 3]
            grid = pts / (extent / 2)  # normalized to [-1, 1] over the cube
            vals = F.grid_sample(vol, grid[None], mode="bilinear", padding_mode="zeros",
                                 align_corners=False)[0]  # [C, h, W, S]
            sigma = torch.relu(vals[-1])
            unit = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
            basis = sh_rows(unit[..., 0], unit[..., 1], unit[..., 2], ncoeff)  # [nc, h, W]
            rgb = torch.stack([torch.sigmoid((vals[c * ncoeff:(c + 1) * ncoeff]
                                              * basis[..., None]).sum(0)) for c in range(3)], -1)
            alpha = 1.0 - torch.exp(-sigma * delta * torch.linalg.norm(dirs, dim=-1)[..., None])
            trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                             1.0 - alpha[..., :-1] + 1e-10], -1), -1)
            w = alpha * trans
            colour = (w[..., None] * rgb).sum(-2) + (1.0 - w.sum(-1))[..., None]
            out[n, r0:r0 + py.shape[0]] = colour
    return torch.round(out.clamp(0.0, 1.0) * 255.0) / 255.0
