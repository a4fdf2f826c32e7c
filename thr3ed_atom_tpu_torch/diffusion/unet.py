"""Timestep-conditioned UNet over 1/2/3 spatial dims (counterpart of
thr3ed_atom_tpu/diffusion/unet.py).

``UNetModel`` and ``AttentionPool2d`` take and return channels-LAST
activations ([B, *spatial, C]), as the JAX package's modules and its
checkpoints do; inside, the UNet permutes once to channels-first for cuDNN
and its blocks (``ResBlock``, ``Upsample``, ``Downsample``,
``AttentionBlock``) work channels-first. ``use_checkpoint`` recomputes each
ResBlock in the backward (``torch.utils.checkpoint``, the JAX package's
``nn.remat``). Attention splits qkv into q, k and v along channels and then
each into (heads, head_dim), scales q and k by head_dim ** -0.25 and takes
the softmax in f32, as the JAX package does (``_attention``); a
half-precision UNet takes ``fused_attention`` instead.

``use_fp16`` splits the precision as ADM's ``convert_to_fp16`` does (Dhariwal
& Nichol, guided-diffusion ``unet.py``): the input, middle and output blocks
(their convolutions, attention's qkv and proj and its products) run in
``compute_dtype`` (float16) on the f32 parameters rounded per call, so the
parameters are the f32 master weights; GroupNorm computes in f32 and rounds
its output, and the time embedding, each block's ``emb_dense`` and the
output head (``out_norm``, ``conv_out``) stay f32. ``norm_groups`` is
GroupNorm's group count (ADM: 32; the JAX package: 16). Dropout acts only
with ``deterministic=False`` (training), through the module function
``dropout``; under ``use_checkpoint`` the recomputed block redraws the same
mask (``torch.utils.checkpoint`` restores the RNG state).

Parameters carry across from and to the JAX package's flax tree:
``flax_params(unet)`` builds the tree (nested dicts of numpy, flax's names:
``ResBlock_N`` or, with ``use_checkpoint``, ``CheckpointResBlock_N``,
numbered in call order; conv kernels [k..., in, out], Dense kernels [in,
out]) and ``load_flax_params(unet, tree)`` reads one; ``flax_leaves`` /
``flax_unflatten`` order the leaves as ``jax.tree_util`` does (keys sorted as
strings at every level, so ``ResBlock_10`` sorts before ``ResBlock_2``).
"""
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.checkpoint import checkpoint

from thr3ed_atom_tpu_torch.diffusion.nn import (
    Dense,
    GroupNorm32,
    avg_pool_nd,
    conv_nd,
    timestep_embedding,
)
from thr3ed_atom_tpu_torch.utils.profiling import span

# the SDPA kernels that hold no [N, N] logits
_FUSED_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]


def _qk_scale(head_dim: int) -> float:
    """1 / sqrt(sqrt(head_dim)) rounded through f32 as the JAX package rounds it."""
    return float(np.float32(1.0) / np.sqrt(np.sqrt(np.float32(head_dim))))


def dropout(h: torch.Tensor, p: float) -> torch.Tensor:
    """Training dropout of a ResBlock (``F.dropout``: on CUDA one
    ``native_dropout`` kernel that scales the kept values by 1 / (1 - p))."""
    return F.dropout(h, p, training=True)


class ResBlock(nn.Module):
    """Residual block with timestep conditioning (optionally FiLM scale-shift)
    and optional up/down resampling built in (channels-first)."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int, dims: int = 2,
                 use_scale_shift_norm: bool = False, up: bool = False, down: bool = False,
                 dropout: float = 0.0, use_checkpoint: bool = False,
                 generator: Optional[torch.Generator] = None, norm_groups: int = 16):
        super().__init__()
        self.dims, self.up, self.down = dims, up, down
        self.use_scale_shift_norm = use_scale_shift_norm
        self.dropout = dropout
        self.use_checkpoint = use_checkpoint
        self.in_norm = GroupNorm32(in_channels, norm_groups)
        self.in_conv = conv_nd(dims, in_channels, out_channels, generator=generator)
        self.emb_dense = Dense(emb_channels,
                               2 * out_channels if use_scale_shift_norm else out_channels,
                               generator=generator)
        self.out_norm = GroupNorm32(out_channels, norm_groups)
        self.out_conv = conv_nd(dims, out_channels, out_channels, zero_init=True)
        self.skip = (conv_nd(dims, in_channels, out_channels, kernel=1, generator=generator)
                     if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(self._forward, x, emb, deterministic, use_reentrant=False)
        return self._forward(x, emb, deterministic)

    def _forward(self, x: torch.Tensor, emb: torch.Tensor, deterministic: bool
                 ) -> torch.Tensor:
        h = F.silu(self.in_norm(x))
        if self.up:
            h, x = _resample(h, self.dims), _resample(x, self.dims)
        elif self.down:
            h, x = avg_pool_nd(h, self.dims), avg_pool_nd(x, self.dims)
        h = self.in_conv(h)

        emb_out = self.emb_dense(F.silu(emb)).to(h.dtype)
        emb_out = emb_out.reshape(*emb_out.shape, *([1] * self.dims))
        if self.use_scale_shift_norm:
            scale, shift = torch.chunk(emb_out, 2, dim=1)
            h = F.silu(self.out_norm(h) * (1.0 + scale) + shift)
        else:
            h = F.silu(self.out_norm(h + emb_out))
        if self.dropout and not deterministic:
            h = dropout(h, self.dropout)
        h = self.out_conv(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h

    def flax_tree(self) -> Dict:
        tree = {"GroupNorm32_0": self.in_norm.flax_tree(), "Conv_0": self.in_conv.flax_tree(),
                "Dense_0": self.emb_dense.flax_tree(),
                "GroupNorm32_1": self.out_norm.flax_tree(), "Conv_1": self.out_conv.flax_tree()}
        if self.skip is not None:
            tree["Conv_2"] = self.skip.flax_tree()
        return tree


def _resample(x: torch.Tensor, dims: int) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling over the spatial dims (channels-first)."""
    return F.interpolate(x, scale_factor=(2.0,) * dims, mode="nearest")


class Upsample(nn.Module):
    def __init__(self, channels: int, dims: int = 2, use_conv: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dims = dims
        self.conv = conv_nd(dims, channels, channels, generator=generator) if use_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _resample(x, self.dims)
        return self.conv(x) if self.conv is not None else x

    def flax_tree(self) -> Dict:
        return {} if self.conv is None else {"Conv_0": self.conv.flax_tree()}


class Downsample(nn.Module):
    """A stride-2 SAME convolution (pads (0, 1) on an even axis) or 2x average pooling."""

    def __init__(self, channels: int, dims: int = 2, use_conv: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dims = dims
        self.conv = (conv_nd(dims, channels, channels, stride=2, generator=generator)
                     if use_conv else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) if self.conv is not None else avg_pool_nd(x, self.dims)

    def flax_tree(self) -> Dict:
        return {} if self.conv is None else {"Conv_0": self.conv.flax_tree()}


def _attention(q, k, v, heads: int) -> torch.Tensor:
    """[B, N, C] q, k, v -> [B, N, C]: each split into (heads, head_dim),
    softmax(q k^T) v per head with q and k scaled by head_dim ** -0.25 and
    the softmax in f32."""
    batch, _, channels = q.shape
    head_dim = channels // heads
    scale = _qk_scale(head_dim)
    q, k, v = (t.reshape(batch, -1, heads, head_dim).transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(q * scale, (k * scale).transpose(-1, -2))
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.matmul(weights, v).transpose(1, 2).reshape(batch, -1, channels)


def fused_attention(q, k, v, heads: int) -> torch.Tensor:
    """``_attention`` in one fused kernel that never holds the [N, N]
    logits: ``F.scaled_dot_product_attention`` restricted to its flash and
    memory-efficient kernels (on CUDA in fp16 / bf16 with heads of 64, the
    flash kernel). It departs from ADM's half-precision ``QKVAttention``:
    the scale 1 / sqrt(head_dim) is applied once, in f32, to the logits,
    where ADM scales q and k by head_dim ** -0.25 each in fp16; and the
    softmax's statistics stay f32 throughout, where ADM rounds the logits
    to fp16 before its f32 softmax."""
    batch, _, channels = q.shape
    head_dim = channels // heads
    q, k, v = (t.reshape(batch, -1, heads, head_dim).transpose(1, 2) for t in (q, k, v))
    with sdpa_kernel(_FUSED_BACKENDS):
        out = F.scaled_dot_product_attention(q, k, v)
    return out.transpose(1, 2).reshape(batch, -1, channels)


class AttentionBlock(nn.Module):
    """Multi-head self-attention over flattened spatial positions
    (channels-first): ``_attention`` in f32, ``fused_attention`` in a half
    precision."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1,
                 generator: Optional[torch.Generator] = None, norm_groups: int = 16):
        super().__init__()
        if num_head_channels == -1:
            self.heads = num_heads
        else:
            if channels % num_head_channels:
                raise ValueError(f"{channels} channels do not split into heads of "
                                 f"{num_head_channels}")
            self.heads = channels // num_head_channels
        self.norm = GroupNorm32(channels, norm_groups)
        self.qkv = Dense(channels, 3 * channels, generator=generator)
        self.proj = Dense(channels, channels, zero_init=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, channels = x.shape[:2]
        h = self.norm(x).reshape(batch, channels, -1).transpose(1, 2)  # [B, N, C]
        q, k, v = torch.chunk(self.qkv(h), 3, dim=-1)
        if h.dtype == torch.float32:
            a = _attention(q, k, v, self.heads)
        else:
            with span("attention"):
                a = fused_attention(q, k, v, self.heads)
        out = self.proj(a)
        return x + out.transpose(1, 2).reshape(x.shape)

    def flax_tree(self) -> Dict:
        return {"GroupNorm32_0": self.norm.flax_tree(), "Dense_0": self.qkv.flax_tree(),
                "Dense_1": self.proj.flax_tree()}


class AttentionPool2d(nn.Module):
    """Attention-based global pooling over 2-D feature maps (channels-last
    [B, h, w, C] in, [B, output_dim] out): a learned positional embedding and
    QKV attention where the query is the mean token. ``spatial`` is (h, w),
    which flax reads from the input at init."""

    def __init__(self, spatial: Tuple[int, int], channels: int, embed_dim: int,
                 output_dim: Optional[int] = None, num_heads: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        h, w = spatial
        self.positional_embedding = nn.Parameter(torch.empty(h * w + 1, channels))
        with torch.no_grad():
            self.positional_embedding.normal_(0.0, 1.0 / channels ** 0.5, generator=generator)
        self.qkv = Dense(channels, 3 * embed_dim, generator=generator)
        self.proj = Dense(embed_dim, output_dim or embed_dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, h, w, channels = x.shape
        tokens = x.reshape(batch, h * w, channels)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding[None]
        q, k, v = torch.chunk(self.qkv(tokens), 3, dim=-1)
        return self.proj(_attention(q, k, v, self.num_heads))[:, 0]

    def flax_tree(self) -> Dict:
        return {"positional_embedding": (self.positional_embedding, "vector"),
                "Dense_0": self.qkv.flax_tree(), "Dense_1": self.proj.flax_tree()}


def count_flops_attn(batch: int, spatial, channels: int) -> int:
    """FLOPs of a QKV attention block over flattened ``spatial`` positions."""
    num_spatial = int(np.prod(spatial))
    # two products: [B, N, C] @ [B, C, N] and [B, N, N] @ [B, N, C]
    return 2 * batch * (num_spatial ** 2) * channels


class _Step(nn.Module):
    """One step of the UNet's down or up path: its layers in call order."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, h: torch.Tensor, emb: torch.Tensor, deterministic: bool
                ) -> torch.Tensor:
        for layer in self.layers:
            h = layer(h, emb, deterministic) if isinstance(layer, ResBlock) else layer(h)
        return h


class UNetModel(nn.Module):
    """The full UNet. The arguments are the JAX package's (``attention_resolutions``
    lists the downsample factors at which attention blocks are inserted);
    ``generator`` seeds the flax-style initialisation; ``norm_groups`` and
    ``use_fp16`` as the module's docstring says."""

    def __init__(
        self,
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int,
        attention_resolutions: Sequence[int] = (),
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        dims: int = 2,
        num_classes: Optional[int] = None,
        use_checkpoint: bool = False,
        num_heads: int = 1,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = False,
        use_bottleneck_attn: bool = True,
        conv_resample: bool = True,
        resblock_updown: bool = False,
        dropout: float = 0.0,
        generator: Optional[torch.Generator] = None,
        norm_groups: int = 16,
        use_fp16: bool = False,
    ):
        super().__init__()
        self.in_channels, self.model_channels = in_channels, model_channels
        self.out_channels, self.num_res_blocks = out_channels, num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.dims, self.num_classes = dims, num_classes
        self.use_checkpoint, self.num_heads = use_checkpoint, num_heads
        self.num_head_channels = num_head_channels
        self.use_scale_shift_norm = use_scale_shift_norm
        self.use_bottleneck_attn = use_bottleneck_attn
        self.conv_resample, self.resblock_updown = conv_resample, resblock_updown
        self.dropout = dropout
        self.norm_groups, self.use_fp16 = norm_groups, use_fp16
        self.compute_dtype = torch.float16 if use_fp16 else torch.float32

        # flax's names: one counter a module type, in call order
        counters: Dict[str, int] = {}
        self._flax_names: List[Tuple[str, nn.Module]] = []

        def named(kind: str, module: nn.Module) -> nn.Module:
            if kind == "ResBlock" and use_checkpoint:
                kind = "CheckpointResBlock"
            n = counters.get(kind, 0)
            counters[kind] = n + 1
            self._flax_names.append((f"{kind}_{n}", module))
            return module

        gen = generator
        emb_dim = model_channels * 4

        def res(cin, cout, **kw):
            return named("ResBlock", ResBlock(
                cin, cout, emb_dim, dims, use_scale_shift_norm, dropout=dropout,
                use_checkpoint=use_checkpoint, generator=gen, norm_groups=norm_groups, **kw))

        def attn(ch):
            return named("AttentionBlock", AttentionBlock(ch, num_heads, num_head_channels, gen,
                                                          norm_groups))

        self.time_embed = nn.ModuleList([named("Dense", Dense(model_channels, emb_dim,
                                                              generator=gen)),
                                         named("Dense", Dense(emb_dim, emb_dim, generator=gen))])
        self.label_emb = None
        if num_classes is not None:
            self.label_emb = named("Embed", nn.Embedding(num_classes, emb_dim))
            with torch.no_grad():  # flax's default: variance 1 / features
                self.label_emb.weight.normal_(0.0, emb_dim ** -0.5, generator=gen)

        self.conv_in = named("Conv", conv_nd(dims, in_channels, model_channels, generator=gen))
        ch, ds = model_channels, 1
        skip_channels = [ch]
        self.input_blocks = nn.ModuleList()
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * model_channels)]
                ch = mult * model_channels
                if ds in self.attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(_Step(*layers))
                skip_channels.append(ch)
            if level != len(channel_mult) - 1:
                down = (res(ch, ch, down=True) if resblock_updown else
                        named("Downsample", Downsample(ch, dims, conv_resample, gen)))
                self.input_blocks.append(_Step(down))
                skip_channels.append(ch)
                ds *= 2

        middle = [res(ch, ch)]
        if use_bottleneck_attn:
            middle.append(attn(ch))
        middle.append(res(ch, ch))
        self.middle_block = _Step(*middle)

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [res(ch + skip_channels.pop(), mult * model_channels)]
                ch = mult * model_channels
                if ds in self.attention_resolutions:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(res(ch, ch, up=True) if resblock_updown else
                                  named("Upsample", Upsample(ch, dims, conv_resample, gen)))
                    ds //= 2
                self.output_blocks.append(_Step(*layers))

        self.out_norm = named("GroupNorm32", GroupNorm32(ch, norm_groups))
        self.conv_out = named("Conv", conv_nd(dims, ch, out_channels, zero_init=True))

    def config(self) -> Dict[str, Any]:
        """The constructor's arguments (without the generator; ``norm_groups``
        and ``use_fp16``, which the JAX package's UNet lacks, only where they
        are not the default)."""
        extra = {k: v for k, v, default in (("norm_groups", self.norm_groups, 16),
                                            ("use_fp16", self.use_fp16, False)) if v != default}
        return dict(
            in_channels=self.in_channels, model_channels=self.model_channels,
            out_channels=self.out_channels, num_res_blocks=self.num_res_blocks,
            attention_resolutions=self.attention_resolutions, channel_mult=self.channel_mult,
            dims=self.dims, num_classes=self.num_classes, use_checkpoint=self.use_checkpoint,
            num_heads=self.num_heads, num_head_channels=self.num_head_channels,
            use_scale_shift_norm=self.use_scale_shift_norm,
            use_bottleneck_attn=self.use_bottleneck_attn, conv_resample=self.conv_resample,
            resblock_updown=self.resblock_updown, dropout=self.dropout, **extra)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None, deterministic: bool = True
                ) -> torch.Tensor:
        """[B, *spatial, in_channels] -> [B, *spatial, out_channels]; dropout
        runs only with ``deterministic=False``, as in the JAX package."""
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("must specify y iff the model is class-conditional")
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed[1](F.silu(self.time_embed[0](emb)))
        if self.label_emb is not None:
            emb = emb + self.label_emb(y)

        last = x.dim() - 1
        h = self.conv_in(x.movedim(last, 1).contiguous().to(self.compute_dtype))
        skips = [h]
        for block in self.input_blocks:
            h = block(h, emb, deterministic)
            skips.append(h)
        h = self.middle_block(h, emb, deterministic)
        for block in self.output_blocks:
            h = block(torch.cat([h, skips.pop()], dim=1), emb, deterministic)
        h = self.conv_out(F.silu(self.out_norm(h.to(x.dtype))))
        return h.movedim(1, last)

    def flax_tree(self) -> Dict:
        tree = {}
        for name, module in self._flax_names:
            if isinstance(module, nn.Embedding):
                tree[name] = {"embedding": (module.weight, "vector")}
            elif module.flax_tree():  # flax leaves a module without parameters out
                tree[name] = module.flax_tree()
        return tree


# ------------------------------------------------------------- flax parameter trees


def _to_flax(tensor: torch.Tensor, layout: str) -> np.ndarray:
    a = tensor.detach().cpu().numpy()
    if layout == "conv":  # [out, in, k...] -> [k..., in, out]
        return np.ascontiguousarray(a.transpose(*range(2, a.ndim), 1, 0))
    if layout == "dense":  # [out, in] -> [in, out]
        return np.ascontiguousarray(a.T)
    return a.copy()


def _from_flax(array: np.ndarray, layout: str) -> np.ndarray:
    a = np.asarray(array, dtype=np.float32)
    if layout == "conv":  # [k..., in, out] -> [out, in, k...]
        return np.ascontiguousarray(a.transpose(a.ndim - 1, a.ndim - 2, *range(a.ndim - 2)))
    if layout == "dense":
        return np.ascontiguousarray(a.T)
    return a


def _map_tree(tree: Dict, fn) -> Dict:
    return {k: _map_tree(v, fn) if isinstance(v, dict) else fn(*v) for k, v in tree.items()}


def flax_params(module: nn.Module) -> Dict[str, Any]:
    """The module's parameters as the JAX package's flax variables
    ({"params": {...}}, numpy leaves in flax's layouts)."""
    return {"params": _map_tree(module.flax_tree(), _to_flax)}


def load_flax_params(module: nn.Module, variables: Dict[str, Any]) -> None:
    """Copy a flax parameter tree (with or without its "params" level) into
    the module; names and shapes must match exactly."""
    tree = variables.get("params", variables)
    mine = module.flax_tree()

    def walk(theirs, ours, path):
        if set(theirs) != set(ours):
            raise ValueError(f"flax tree at {path or '/'}: names {sorted(theirs)} "
                             f"!= the module's {sorted(ours)}")
        for k, v in ours.items():
            if isinstance(v, dict):
                walk(theirs[k], v, f"{path}/{k}")
                continue
            tensor, layout = v
            value = torch.from_numpy(np.array(_from_flax(theirs[k], layout)))
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f"{path}/{k}: shape {tuple(np.shape(theirs[k]))} does not "
                                 f"fit {tuple(tensor.shape)} ({layout})")
            with torch.no_grad():
                tensor.copy_(value)

    walk(tree, mine, "")


def flax_leaves(tree: Dict[str, Any]) -> List[Any]:
    """The leaves in jax.tree_util's order: keys sorted as strings at every level."""
    out: List[Any] = []
    for key in sorted(tree):
        value = tree[key]
        out.extend(flax_leaves(value) if isinstance(value, dict) else [value])
    return out


def flax_unflatten(template: Dict[str, Any], leaves: Sequence[Any]) -> Dict[str, Any]:
    """Inverse of ``flax_leaves`` on ``template``'s structure."""
    it = iter(leaves)

    def build(node):
        return {k: build(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
