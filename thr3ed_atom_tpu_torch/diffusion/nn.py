"""Diffusion building blocks (counterpart of thr3ed_atom_tpu/diffusion/nn.py).

The modules here take channels-FIRST activations ([B, C, *spatial], cuDNN's
layout); the UNet permutes once at its boundary, where activations are
channels-last as in the JAX package. Each module with parameters names them
as flax does (``flax_tree``: a nested dict of (tensor, layout) leaves), so
``diffusion/unet.py`` can carry a flax parameter tree across both ways.
Initialisation is flax's: lecun-normal kernels (a normal truncated at two
standard deviations, scaled to unit variance over fan-in), zero biases, unit
GroupNorm scales; ``zero_init`` convs start at zero.
"""
import math
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# flax's GroupNorm epsilon (torch's default is 1e-5)
GROUP_NORM_EPS = 1e-6
# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated at +-2 standard deviations with
    variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
        weight.mul_(std)
    return weight


class _FastVarianceGroupNorm(torch.autograd.Function):
    """flax's GroupNorm on a channels-first f32 tensor: the statistics as
    E[x] and max(E[x^2] - E[x]^2, 0) (``use_fast_variance``; in a group of a
    few elements they round differently from a two-pass variance), the
    output as (x - mean) * (rsqrt(var + eps) * scale) + bias. The backward is
    ATen's group-norm backward on these statistics, so only x, mean and
    rstd are kept, as F.group_norm keeps them."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups: int):
        batch, channels = x.shape[:2]
        xg = x.reshape(batch, groups, -1)
        mean = xg.mean(dim=-1)
        # E[x^2] a sample at a time: a temporary of one sample, not of the batch
        mean2 = torch.stack([(xb * xb).mean(dim=-1) for xb in xg])
        rstd = torch.rsqrt(torch.clamp(mean2 - mean * mean, min=0.0) + GROUP_NORM_EPS)
        per_channel = (batch, channels) + (1,) * (x.dim() - 2)
        mean_c = mean.repeat_interleave(channels // groups, dim=1).reshape(per_channel)
        mul = (rstd.repeat_interleave(channels // groups, dim=1)
               * weight[None]).reshape(per_channel)
        out = torch.addcmul(bias.reshape(1, channels, *per_channel[2:]), x - mean_c, mul)
        ctx.save_for_backward(x, mean, rstd, weight)
        ctx.groups = groups
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, mean, rstd, weight = ctx.saved_tensors
        batch, channels = x.shape[:2]
        dx, dw, db = torch.ops.aten.native_group_norm_backward(
            grad_out.contiguous(), x, mean, rstd, weight, batch, channels,
            x[0, 0].numel(), ctx.groups, list(ctx.needs_input_grad[:3]))
        return dx, dw, db, None


class GroupNorm32(nn.Module):
    """GroupNorm computed in float32 whatever the activation dtype, with the
    largest group count <= ``num_groups`` that divides the width (skip
    concatenations give widths such as 24, 96 and 384), flax's epsilon and
    flax's fast-variance statistics."""

    def __init__(self, channels: int, num_groups: int = 16):
        super().__init__()
        groups = min(num_groups, channels)
        while channels % groups:
            groups -= 1
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _FastVarianceGroupNorm.apply(x.float().contiguous(), self.weight, self.bias,
                                           self.groups)
        return out.to(x.dtype)

    def flax_tree(self) -> Dict:
        return {"GroupNorm_0": {"scale": (self.weight, "vector"),
                                "bias": (self.bias, "vector")}}


def same_padding(size: int, kernel: int, stride: int) -> Sequence[int]:
    """XLA's SAME padding of one axis as (low, high): the output has
    ceil(size / stride) positions and the odd pad goes high (stride 2,
    kernel 3 on an even axis pads (0, 1), not (1, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvNd(nn.Module):
    """An N-D convolution with XLA's SAME padding (channels-first)."""

    def __init__(self, dims: int, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, zero_init: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dims, self.kernel, self.stride = dims, kernel, stride
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, *(kernel,) * dims))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        if not zero_init:
            lecun_normal_(self.weight, in_channels * kernel ** dims, generator)
        self._conv = (F.conv1d, F.conv2d, F.conv3d)[dims - 1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = [same_padding(s, self.kernel, self.stride) for s in x.shape[2:]]
        if self.stride == 1 and all(lo == hi for lo, hi in pads):
            return self._conv(x, self.weight, self.bias, 1, [lo for lo, _ in pads])
        # F.pad lists the last axis first
        x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        return self._conv(x, self.weight, self.bias, self.stride)

    def flax_tree(self) -> Dict:
        return {"kernel": (self.weight, "conv"), "bias": (self.bias, "vector")}


def conv_nd(dims: int, in_channels: int, out_channels: int, kernel: int = 3,
            stride: int = 1, zero_init: bool = False,
            generator: Optional[torch.Generator] = None) -> ConvNd:
    """1/2/3-D convolution factory (SAME padding, channels-first)."""
    return ConvNd(dims, in_channels, out_channels, kernel, stride, zero_init, generator)


class Dense(nn.Linear):
    """flax's Dense: lecun-normal kernel, zero bias (or all zero)."""

    def __init__(self, in_features: int, out_features: int, zero_init: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features)
        with torch.no_grad():
            self.bias.zero_()
            self.weight.zero_()
        if not zero_init:
            lecun_normal_(self.weight, in_features, generator)

    def reset_parameters(self) -> None:
        """Leave torch's default init (and the global generator) alone."""

    def flax_tree(self) -> Dict:
        return {"kernel": (self.weight, "dense"), "bias": (self.bias, "vector")}


def avg_pool_nd(x: torch.Tensor, dims: int, window: int = 2) -> torch.Tensor:
    """1/2/3-D average pooling with stride == window (channels-first; VALID)."""
    return (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[dims - 1](x, window, window)


def mean_flat(tensor: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dimensions."""
    return tensor.reshape(tensor.shape[0], -1).mean(dim=-1)


def update_ema(ema_params: Mapping[str, torch.Tensor], new_params: Mapping[str, torch.Tensor],
               rate: float = 0.99) -> Dict[str, torch.Tensor]:
    """Polyak averaging over parameter dicts: ema <- ema * rate + new * (1 - rate)."""
    return {k: e * rate + new_params[k] * (1.0 - rate) for k, e in ema_params.items()}


def scale_module_params(params: Mapping[str, torch.Tensor], scale: float
                        ) -> Dict[str, torch.Tensor]:
    """Scale every parameter of a parameter dict (counterpart of scale_module)."""
    return {k: p * scale for k, p in params.items()}


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000
                       ) -> torch.Tensor:
    """Sinusoidal timestep embeddings: [N] -> [N, dim] (f32)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps[:, None].float() * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding
