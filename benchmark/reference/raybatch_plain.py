"""Plain PyTorch reference of the ray-batch training step through the
two-phase top-K renderer: pinhole rays through the batch's pixel centres,
uniform samples between the near and far planes jittered within their
intervals, relu-field densities at every sample by eight trilinear taps of
the grid (zero outside the strict box), exact transmittance weights, the K
samples of largest weight a ray (equal weights by ascending index), their
SH features by eight taps, sigmoid of the degree-2 (and, for the diffuse
term, degree-0) colour, white background, L1 losses; the gradient is
autograd's. No packed tables, nothing of the program."""
from __future__ import annotations

import torch

from reference.gnomonic_plain import C0, C1, C2

INFINITY = 1e10


def rays(poses: torch.Tensor, height: int, width: int, focal: float, img_idx, pix_idx):
    """Origins and directions [B, 3] of the (image, pixel) pairs."""
    py, px = pix_idx // width, pix_idx % width
    x = px.float() + 0.5
    y = py.float() + 0.5
    cam = torch.stack([(x - width * 0.5) / focal, -(y - height * 0.5) / focal,
                       -torch.ones_like(x)], dim=-1)
    pose = poses[img_idx]
    return pose[:, :, 3], torch.einsum("bij,bj->bi", pose[:, :, :3], cam)


def trilinear(volume: torch.Tensor, points: torch.Tensor, extent: float) -> torch.Tensor:
    """``volume`` [X, Y, Z, C] at world points [N, 3] of a cube of side
    ``extent`` centred at the origin (voxel centres at half-voxel offsets);
    taps outside the grid weigh zero."""
    dims = volume.shape[:3]
    flat = volume.reshape(-1, volume.shape[-1])
    t = [((points[:, a] * (2.0 / extent) + 1.0) * dims[a] - 1.0) * 0.5 for a in range(3)]
    t0 = [torch.floor(v) for v in t]
    f = [v - v0 for v, v0 in zip(t, t0)]
    i0 = [v0.long() for v0 in t0]
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = [i0[0] + dx, i0[1] + dy, i0[2] + dz]
                ok = torch.ones_like(idx[0], dtype=torch.bool)
                for a in range(3):
                    ok = ok & (idx[a] >= 0) & (idx[a] < dims[a])
                lin = ((idx[0].clamp(0, dims[0] - 1) * dims[1] + idx[1].clamp(0, dims[1] - 1))
                       * dims[2] + idx[2].clamp(0, dims[2] - 1))
                w = ((f[0] if dx else 1.0 - f[0]) * (f[1] if dy else 1.0 - f[1])
                     * (f[2] if dz else 1.0 - f[2]))
                out = out + (w * ok.to(w.dtype))[:, None] * flat[lin]
    return out


def sh2(coeffs: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Degree-2 SH of unit directions ``d`` [..., 3]: coeffs [..., 3, 9] -> [..., 3]."""
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    return (C0 * coeffs[..., 0] - C1 * y * coeffs[..., 1] + C1 * z * coeffs[..., 2]
            - C1 * x * coeffs[..., 3] + C2[0] * x * y * coeffs[..., 4]
            + C2[1] * y * z * coeffs[..., 5]
            + C2[2] * (2.0 * z * z - x * x - y * y) * coeffs[..., 6]
            + C2[3] * x * z * coeffs[..., 7] + C2[4] * (x * x - y * y) * coeffs[..., 8])


def render(densities, features, density_scale: float, extent: float, origins, dirs,
           near: float, far: float, t_rand: torch.Tensor, top_k: int):
    """(colour, diffuse colour) [B, 3] over a white background."""
    B, S = t_rand.shape
    t = torch.arange(S, dtype=torch.float32, device=origins.device) / (S - 1)
    z = near * (1.0 - t) + far * t
    mid = 0.5 * (z[1:] + z[:-1])
    upper = torch.cat([mid, z[-1:]])
    lower = torch.cat([z[:1], mid])
    z = lower + (upper - lower) * t_rand  # [B, S]
    pts = (origins[:, None, :] + dirs[:, None, :] * z[..., None]).reshape(-1, 3)
    half = extent / 2
    inside = ((pts > -half) & (pts < half)).all(-1)
    sigma = torch.relu(trilinear(densities * density_scale, pts, extent)[:, 0])
    sigma = torch.where(inside, sigma, 0.0).reshape(B, S)
    deltas = torch.cat([z[:, 1:] - z[:, :-1], torch.full((B, 1), INFINITY, device=z.device)], -1)
    deltas = deltas * torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    alpha = torch.clamp(1.0 - torch.exp(-(sigma * deltas)), 0.0, 1.0)
    trans = torch.cumprod(1.0 - alpha, -1)
    weights = alpha * torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    acc = weights.sum(-1, keepdim=True)
    top_w, top_i = torch.sort(weights, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :top_k], top_i[:, :top_k]
    top_z = torch.gather(z, -1, top_i)
    top_pts = (origins[:, None, :] + dirs[:, None, :] * top_z[..., None]).reshape(-1, 3)
    top_in = ((top_pts > -half) & (top_pts < half)).all(-1).reshape(B, top_k, 1)
    coeffs = trilinear(features, top_pts, extent).reshape(B, top_k, 3, -1)
    unit = (dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True))[:, None, :]
    colour = torch.where(top_in, torch.sigmoid(sh2(coeffs, unit)), 0.0)
    diffuse = torch.where(top_in, torch.sigmoid(C0 * coeffs[..., 0]), 0.0)
    white = 1.0 - acc
    return ((colour * top_w[..., None]).sum(1) + white,
            (diffuse * top_w[..., None]).sum(1) + white)


def step_gradient(densities, features, density_scale, extent, images, poses, height, width,
                  focal, img_idx, pix_idx, near, far, t_rand, top_k):
    """The batch's specular plus diffuse L1 and its gradient with respect to
    (densities, features)."""
    dens = densities.detach().clone().requires_grad_(True)
    feats = features.detach().clone().requires_grad_(True)
    o, d = rays(poses, height, width, focal, img_idx, pix_idx)
    pixels = images[img_idx, pix_idx // width, pix_idx % width]
    colour, diffuse = render(dens, feats, density_scale, extent, o, d, near, far, t_rand, top_k)
    loss = torch.mean(torch.abs(colour - pixels)) + torch.mean(torch.abs(diffuse - pixels))
    loss.backward()
    return float(loss.detach()), [dens.grad, feats.grad]
