"""Plain PyTorch reference of 3inFusion's training step: the timestep-
conditioned 3-D UNet (scale-shift GroupNorm residual blocks, SAME-padded
convolutions, strided-convolution downsampling, nearest upsampling with a
convolution, one attention block at the bottleneck), the cosine-schedule
forward process and the epsilon MSE loss, and Adam. It follows the
published guided-diffusion UNet with flax's GroupNorm epsilon and
attention scaling; parameter names match the port's module tree, so one
state dict made from the seed loads into both. No checkpointing, no
custom autograd, nothing of the program. ``dt`` is the compute precision
(float32; bfloat16 is the control).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

GROUP_NORM_EPS = 1e-6


def group_norm(x, weight, bias, groups_max=16):
    channels = x.shape[1]
    groups = min(groups_max, channels)
    while channels % groups:
        groups -= 1
    return F.group_norm(x.float(), groups, weight.float(), bias.float(), GROUP_NORM_EPS).to(x.dtype)


class Norm(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias)


class Conv(nn.Module):
    """3-D convolution with XLA's SAME padding (the odd pad goes high)."""

    def __init__(self, cin, cout, kernel=3, stride=1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        pads = []
        for size in reversed(x.shape[2:]):
            out = -(-size // self.stride)
            total = max((out - 1) * self.stride + self.kernel - size, 0)
            pads += [total // 2, total - total // 2]
        return F.conv3d(F.pad(x, pads), self.weight, self.bias, self.stride)


class ResBlock(nn.Module):
    def __init__(self, cin, cout, emb):
        super().__init__()
        self.in_norm = Norm(cin)
        self.in_conv = Conv(cin, cout)
        self.emb_dense = nn.Linear(emb, 2 * cout)
        self.out_norm = Norm(cout)
        self.out_conv = Conv(cout, cout)
        self.skip = Conv(cin, cout, kernel=1) if cin != cout else None

    def forward(self, x, emb):
        h = self.in_conv(F.silu(self.in_norm(x)))
        e = self.emb_dense(F.silu(emb))[..., None, None, None]
        scale, shift = torch.chunk(e, 2, dim=1)
        h = self.out_conv(F.silu(self.out_norm(h) * (1.0 + scale) + shift))
        return (x if self.skip is None else self.skip(x)) + h


class Downsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv(ch, ch, stride=2)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv(ch, ch)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Attention(nn.Module):
    def __init__(self, ch, heads):
        super().__init__()
        self.heads = heads
        self.norm = Norm(ch)
        self.qkv = nn.Linear(ch, 3 * ch)
        self.proj = nn.Linear(ch, ch)

    def forward(self, x):
        b, c = x.shape[:2]
        h = self.norm(x).reshape(b, c, -1).transpose(1, 2)
        q, k, v = torch.chunk(self.qkv(h), 3, dim=-1)
        d = c // self.heads
        scale = float(np.float32(1.0) / np.sqrt(np.sqrt(np.float32(d))))
        q, k, v = (t.reshape(b, -1, self.heads, d).transpose(1, 2) for t in (q, k, v))
        w = torch.softmax(torch.matmul(q * scale, (k * scale).transpose(-1, -2)).float(), -1)
        out = torch.matmul(w.to(q.dtype), v).transpose(1, 2).reshape(b, -1, c)
        return x + self.proj(out).transpose(1, 2).reshape(x.shape)


class Step(nn.Module):
    def __init__(self, *layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, h, emb):
        for layer in self.layers:
            h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
        return h


class UNet(nn.Module):
    """[B, X, Y, Z, C] channels-last in and out, as the port's UNet."""

    def __init__(self, channels, base, mult=(1, 2, 4, 8), num_res_blocks=1, heads=4):
        super().__init__()
        self.base = base
        emb = 4 * base
        self.time_embed = nn.ModuleList([nn.Linear(base, emb), nn.Linear(emb, emb)])
        self.conv_in = Conv(channels, base)
        ch, skips = base, [base]
        self.input_blocks = nn.ModuleList()
        for level, m in enumerate(mult):
            for _ in range(num_res_blocks):
                self.input_blocks.append(Step(ResBlock(ch, m * base, emb)))
                ch = m * base
                skips.append(ch)
            if level != len(mult) - 1:
                self.input_blocks.append(Step(Downsample(ch)))
                skips.append(ch)
        self.middle_block = Step(ResBlock(ch, ch, emb), Attention(ch, heads), ResBlock(ch, ch, emb))
        self.output_blocks = nn.ModuleList()
        for level, m in reversed(list(enumerate(mult))):
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + skips.pop(), m * base, emb)]
                ch = m * base
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                self.output_blocks.append(Step(*layers))
        self.out_norm = Norm(ch)
        self.conv_out = Conv(ch, channels)

    def forward(self, x, t):
        half = self.base // 2
        freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32,
                                                          device=x.device) / half)
        args = t[:, None].float() * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1).to(x.dtype)
        emb = self.time_embed[1](F.silu(self.time_embed[0](emb)))
        h = self.conv_in(x.movedim(-1, 1))
        hs = [h]
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb)
        return self.conv_out(F.silu(self.out_norm(h))).movedim(1, -1)


def cosine_schedule(steps: int) -> np.ndarray:
    """sqrt(alpha_bar) and sqrt(1 - alpha_bar) of the cosine schedule (f64)."""
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = np.array([min(1 - alpha_bar((i + 1) / steps) / alpha_bar(i / steps), 0.999)
                      for i in range(steps)], np.float64)
    ac = np.cumprod(1.0 - betas)
    return np.sqrt(ac), np.sqrt(1.0 - ac)


def normalize(grid: torch.Tensor) -> torch.Tensor:
    """[..., 1 + F] -> density and features each mapped to [-1, 1] by its range."""
    out = []
    for part in (grid[..., :1], grid[..., 1:]):
        lo, hi = part.min(), part.max()
        out.append((part - lo) / torch.clamp_min(hi - lo, 1e-12))
    return torch.cat(out, -1) * 2.0 - 1.0


def crops(grid: torch.Tensor, offsets: Sequence[Sequence[int]], side: int) -> torch.Tensor:
    return torch.stack([grid[a:a + side, b:b + side, c:c + side] for a, b, c in offsets])


def loss_and_grads(unet: UNet, params, x0, t, noise, schedule, dt=torch.float32):
    """The mean epsilon-MSE over the batch and its gradient with respect to
    each of ``params``."""
    sa, s1 = (torch.as_tensor(a, dtype=torch.float32).to(x0.device)[t] for a in schedule)
    shape = (-1,) + (1,) * (x0.dim() - 1)
    x_t = (sa.reshape(shape) * x0 + s1.reshape(shape) * noise).to(dt)
    out = unet(x_t, t)
    loss = ((noise.to(dt) - out).float() ** 2).reshape(x0.shape[0], -1).mean(-1).mean()
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), list(grads)


def adam_update(params: List[torch.Tensor], grads, state: Dict, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    state["t"] = state.get("t", 0) + 1
    t = state["t"]
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(params, grads)):
            m = state.setdefault(("m", i), torch.zeros_like(p))
            s = state.setdefault(("v", i), torch.zeros_like(p))
            m.lerp_(g, 1 - b1)
            s.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (s.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
            p.addcdiv_(m, denom, value=-(lr / (1 - b1 ** t)))
