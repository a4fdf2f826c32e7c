"""Plain PyTorch reference of ADM's UNet (Dhariwal & Nichol, "Diffusion
Models Beat GANs on Image Synthesis", arXiv:2105.05233; guided-diffusion's
``unet.py`` at its ImageNet 64x64 flags) lifted to 3-D crops, its
learned-range hybrid loss (Nichol & Dhariwal, "Improved Denoising Diffusion
Probabilistic Models", arXiv:2102.09672: MSE on epsilon plus the VLB with
the mean frozen, RESCALED_MSE), Adam and the EMA of the weights.

Residual blocks: GroupNorm, SiLU, resampling inside the block
(``resblock_updown``: 2x average pooling down, nearest 2x up, applied to
the block's input and its skip path alike), a 3^3 convolution, FiLM
scale-shift of the second GroupNorm by the time embedding, SiLU, dropout, a
3^3 convolution, and a 1^3 convolution on the skip path where the width
changes. Attention: GroupNorm, one qkv projection split into q, k and v and
then each into heads of ``head_channels`` (``use_new_attention_order``),
q and k each scaled by head_dim ** -0.25, softmax, an output projection,
residual; computed one crop at a time in query blocks, each recomputed in
the backward (``torch.utils.checkpoint``), so no [N, N] logits of all
32,768 tokens are held at once.

Everything runs in ``dt`` (float32; TF32 off for products and cuDNN) with no
fused kernel. Departures from ADM, which the program shares: GroupNorm's
epsilon is flax's 1e-6 (ADM: torch's 1e-5), the group count is the largest
<= ``norm_groups`` that divides the width, the VLB term clips the frozen
x_0 prediction to [-1, 1] (ADM's training loss does not), the timestep
embedding is [cos, sin], and the 3-D lift resamples every spatial axis.
Dropout takes the program's masks (``masks``: one boolean tensor a residual
block, in call order, for this crop). Parameter names are the program's
module tree, so one state dict loads into both. Nothing of the program is
imported.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

GROUP_NORM_EPS = 1e-6


def strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _groups(channels: int, most: int) -> int:
    g = min(most, channels)
    while channels % g:
        g -= 1
    return g


class Norm(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.groups = _groups(channels, groups)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, GROUP_NORM_EPS)


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, padding=self.weight.shape[-1] // 2)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb: int, groups: int, p: float, up=False,
                 down=False):
        super().__init__()
        self.p, self.up, self.down = p, up, down
        self.in_norm = Norm(cin, groups)
        self.in_conv = Conv(cin, cout)
        self.emb_dense = nn.Linear(emb, 2 * cout)
        self.out_norm = Norm(cout, groups)
        self.out_conv = Conv(cout, cout)
        self.skip = Conv(cin, cout, kernel=1) if cin != cout else None

    def forward(self, x, emb, masks):
        h = F.silu(self.in_norm(x))
        if self.up:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        elif self.down:
            h, x = F.avg_pool3d(h, 2), F.avg_pool3d(x, 2)
        h = self.in_conv(h)
        scale, shift = torch.chunk(self.emb_dense(F.silu(emb))[..., None, None, None], 2, dim=1)
        h = F.silu(self.out_norm(h) * (1.0 + scale) + shift)
        if masks is not None and self.p:
            h = h * next(masks).to(h.dtype) * (1.0 / (1.0 - self.p))
        h = self.out_conv(h)
        return (x if self.skip is None else self.skip(x)) + h


def _attend_block(q, k, v):
    """softmax(q k^T) v of one query block ([heads, n, d] q, [heads, N, d] k, v)."""
    return torch.matmul(torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1), v)


class Attention(nn.Module):
    """The block at downsample factor ``ds``."""
    QUERY_BLOCK = 2048

    def __init__(self, ch: int, head_channels: int, groups: int, ds: int):
        super().__init__()
        self.heads, self.ds = ch // head_channels, ds
        self.norm = Norm(ch, groups)
        self.qkv = nn.Linear(ch, 3 * ch)
        self.proj = nn.Linear(ch, ch)

    def forward(self, x):
        b, c = x.shape[:2]
        h = self.norm(x).reshape(b, c, -1).transpose(1, 2)  # [B, N, C]
        d = c // self.heads
        scale = d ** -0.25
        q, k, v = (t.reshape(b, -1, self.heads, d).transpose(1, 2)
                   for t in torch.chunk(self.qkv(h), 3, dim=-1))
        q, k = q * scale, k * scale
        outs = []
        for i in range(b):  # a crop at a time, query blocks recomputed in the backward
            n = q.shape[2]
            parts = [checkpoint(_attend_block, q[i, :, s:s + self.QUERY_BLOCK], k[i], v[i],
                                use_reentrant=False) if torch.is_grad_enabled() else
                     _attend_block(q[i, :, s:s + self.QUERY_BLOCK], k[i], v[i])
                     for s in range(0, n, self.QUERY_BLOCK)]
            outs.append(torch.cat(parts, dim=1))
        out = torch.stack(outs).transpose(1, 2).reshape(b, -1, c)
        return x + self.proj(out).transpose(1, 2).reshape(x.shape)


class Step(nn.Module):
    def __init__(self, *layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, h, emb, masks):
        for layer in self.layers:
            h = layer(h, emb, masks) if isinstance(layer, ResBlock) else layer(h)
        return h


class UNet(nn.Module):
    """[B, X, Y, Z, C] channels-last in, [B, X, Y, Z, out] out (out = 2 C:
    epsilon and the variance interpolation)."""

    def __init__(self, channels: int, base: int, mult: Sequence[int], num_res_blocks: int,
                 attention_ds: Sequence[int], head_channels: int, groups: int, dropout: float,
                 out_channels: Optional[int] = None):
        super().__init__()
        self.base = base
        emb = 4 * base
        self.time_embed = nn.ModuleList([nn.Linear(base, emb), nn.Linear(emb, emb)])
        self.conv_in = Conv(channels, base)

        def res(cin, cout, **kw):
            return ResBlock(cin, cout, emb, groups, dropout, **kw)

        def attn(ch):
            return Attention(ch, head_channels, groups, ds)

        ch, ds, skips = base, 1, [base]
        self.input_blocks = nn.ModuleList()
        for level, m in enumerate(mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, m * base)]
                ch = m * base
                if ds in attention_ds:
                    layers.append(attn(ch))
                self.input_blocks.append(Step(*layers))
                skips.append(ch)
            if level != len(mult) - 1:
                self.input_blocks.append(Step(res(ch, ch, down=True)))
                skips.append(ch)
                ds *= 2
        self.middle_block = Step(res(ch, ch), attn(ch), res(ch, ch))
        self.output_blocks = nn.ModuleList()
        for level, m in reversed(list(enumerate(mult))):
            for i in range(num_res_blocks + 1):
                layers = [res(ch + skips.pop(), m * base)]
                ch = m * base
                if ds in attention_ds:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(res(ch, ch, up=True))
                    ds //= 2
                self.output_blocks.append(Step(*layers))
        self.out_norm = Norm(ch, groups)
        self.conv_out = Conv(ch, out_channels or 2 * channels)

    def forward(self, x, t, masks: Optional[List[torch.Tensor]] = None):
        half = self.base // 2
        freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32,
                                                          device=x.device) / half)
        args = t[:, None].float() * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1).to(x.dtype)
        emb = self.time_embed[1](F.silu(self.time_embed[0](emb)))
        it = iter(masks) if masks is not None else None
        h = self.conv_in(x.movedim(-1, 1))
        hs = [h]
        for block in self.input_blocks:
            h = block(h, emb, it)
            hs.append(h)
        h = self.middle_block(h, emb, it)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, it)
        return self.conv_out(F.silu(self.out_norm(h))).movedim(1, -1)


# --------------------------------------------------------------- the diffusion


class Schedule:
    """The cosine schedule's tables (float64), indexed as f32 at a timestep."""

    def __init__(self, steps: int):
        def alpha_bar(s):
            return math.cos((s + 0.008) / 1.008 * math.pi / 2) ** 2

        betas = np.array([min(1 - alpha_bar((i + 1) / steps) / alpha_bar(i / steps), 0.999)
                          for i in range(steps)], np.float64)
        ac = np.cumprod(1.0 - betas)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        self.steps = steps
        self.tables = {
            "sqrt_ac": np.sqrt(ac), "sqrt_1mac": np.sqrt(1.0 - ac),
            "sqrt_recip_ac": np.sqrt(1.0 / ac), "sqrt_recipm1_ac": np.sqrt(1.0 / ac - 1),
            "coef1": betas * np.sqrt(ac_prev) / (1.0 - ac),
            "coef2": (1.0 - ac_prev) * np.sqrt(1.0 - betas) / (1.0 - ac),
            "min_log": np.log(np.append(post_var[1], post_var[1:])),
            "max_log": np.log(betas),
        }

    def at(self, name: str, t: torch.Tensor, dims: int) -> torch.Tensor:
        table = torch.as_tensor(self.tables[name], dtype=torch.float32).to(t.device)
        return table[t].reshape(-1, *([1] * (dims - 1)))


def _normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def _std_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _decoder_log_likelihood(x, mean, log_scale):
    """log p(x) of a Gaussian discretized to 255 bins on [-1, 1]."""
    inv = torch.exp(-log_scale)
    cdf_plus = _std_normal_cdf(inv * (x - mean + 1.0 / 255.0))
    cdf_min = _std_normal_cdf(inv * (x - mean - 1.0 / 255.0))
    log_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_plus, torch.where(x > 0.999, log_one_minus_min, log_delta))


def hybrid_loss(unet: UNet, x0, t, noise, schedule: Schedule, masks=None):
    """Per-crop L_hybrid: mean (epsilon - prediction)^2 plus the VLB term
    (bits per dim; the decoder NLL at t = 0) with the mean frozen and the
    log-variance interpolated between the clipped posterior's and beta's,
    times steps / 1000."""
    dims = x0.dim()
    x_t = schedule.at("sqrt_ac", t, dims) * x0 + schedule.at("sqrt_1mac", t, dims) * noise
    eps, var_values = torch.chunk(unet(x_t, t, masks), 2, dim=-1)
    mse = ((noise - eps) ** 2).reshape(x0.shape[0], -1).mean(-1)

    true_mean = schedule.at("coef1", t, dims) * x0 + schedule.at("coef2", t, dims) * x_t
    min_log, max_log = schedule.at("min_log", t, dims), schedule.at("max_log", t, dims)
    frac = (var_values + 1) / 2
    log_var = frac * max_log + (1 - frac) * min_log
    pred_x0 = (schedule.at("sqrt_recip_ac", t, dims) * x_t
               - schedule.at("sqrt_recipm1_ac", t, dims) * eps.detach()).clamp(-1.0, 1.0)
    mean = schedule.at("coef1", t, dims) * pred_x0 + schedule.at("coef2", t, dims) * x_t
    kl = _normal_kl(true_mean, min_log, mean, log_var).reshape(x0.shape[0], -1).mean(-1)
    nll = -_decoder_log_likelihood(x0, mean, 0.5 * log_var).reshape(x0.shape[0], -1).mean(-1)
    vb = torch.where(t == 0, nll, kl) / math.log(2.0) * (schedule.steps / 1000.0)
    return mse + vb


def loss_and_grads(unet: UNet, params, x0, t, noise, schedule: Schedule, masks=None,
                   weight: float = 1.0):
    """(the crops' summed hybrid loss, the gradient of ``weight`` x it with
    respect to each of ``params``)."""
    loss = hybrid_loss(unet, x0, t, noise, schedule, masks).sum()
    grads = torch.autograd.grad(loss * weight, params)
    return float(loss.detach()), list(grads)


# ------------------------------------------------------------- the optimizer


def adam_step(params, grads, exp_avg, exp_avg_sq, step: int, lr: float, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam step (AdamW with weight decay 0) as ``step``-th step, on the
    given moments, in place."""
    with torch.no_grad():
        for p, g, m, s in zip(params, grads, exp_avg, exp_avg_sq):
            m.lerp_(g, 1 - b1)
            s.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (s.sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
            p.addcdiv_(m, denom, value=-(lr / (1 - b1 ** step)))


def ema_update(ema, params, rate: float) -> None:
    """ema <- ema * rate + params * (1 - rate), in place."""
    with torch.no_grad():
        for e, p in zip(ema, params):
            e.mul_(rate).add_(p, alpha=1 - rate)


def crops(grid: torch.Tensor, offsets: Sequence[Sequence[int]], side: int) -> torch.Tensor:
    return torch.stack([grid[a:a + side, b:b + side, c:c + side] for a, b, c in offsets])


def normalize(grid: torch.Tensor) -> torch.Tensor:
    """[..., 1 + F] -> density and features each mapped to [-1, 1] by its range."""
    out = []
    for part in (grid[..., :1], grid[..., 1:]):
        lo, hi = part.min(), part.max()
        out.append((part - lo) / torch.clamp_min(hi - lo, 1e-12))
    return torch.cat(out, -1) * 2.0 - 1.0
