"""LPIPS (Learned Perceptual Image Patch Similarity) in PyTorch.

Counterpart of thr3ed_atom_tpu/utils/lpips.py (Zhang et al. 2018): VGG16 conv
features at relu{1_2, 2_2, 3_3, 4_3, 5_3}, per-channel unit normalization,
non-negative 1x1 linear heads, spatial and layer averaging.

Weights, in this order:
  1. an npz of converted official weights (tools/convert_lpips_weights.py,
     run offline), named by ``THR3ED_LPIPS_WEIGHTS`` or ``weights_path``;
     nothing is downloaded;
  2. otherwise the seeded He-initialized VGG with uniform heads
     (``random_lpips_weights``, numpy seed 1889, the JAX package's arrays draw
     for draw), reported as ``lpips_rand_vgg`` so that it is never taken for
     calibrated LPIPS.

The convolutions run in true f32 (cuDNN's TF32 off), as the JAX package runs
them at Precision.HIGHEST: the scores are a metric.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from thr3ed_atom_tpu_torch.models.voxels import resolve_device

# VGG16 feature config: channels per conv layer, 'M' = 2x2 max pool
_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512)
# indices (into the conv sequence) after which LPIPS taps features
_TAP_AFTER_CONV = (1, 3, 6, 9, 12)  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3

# input normalization of the official LPIPS (images scaled to [-1, 1])
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_ENV_WEIGHTS = "THR3ED_LPIPS_WEIGHTS"
_FALLBACK_SEED = 1889


def random_lpips_weights(seed: int = _FALLBACK_SEED) -> Dict[str, np.ndarray]:
    """Deterministic He-initialized VGG (HWIO kernels) + uniform linear heads,
    the calibration-free fallback."""
    rng = np.random.default_rng(seed)
    weights: Dict[str, np.ndarray] = {}
    in_ch = 3
    conv_i = 0
    for item in _VGG_CFG:
        if item == "M":
            continue
        fan_in = in_ch * 9
        weights[f"conv{conv_i}_w"] = (
            rng.standard_normal((3, 3, in_ch, item)) * np.sqrt(2.0 / fan_in)
        ).astype(np.float32)
        weights[f"conv{conv_i}_b"] = np.zeros((item,), np.float32)
        in_ch = item
        conv_i += 1
    for tap_i, conv_idx in enumerate(_TAP_AFTER_CONV):
        ch = [c for c in _VGG_CFG if c != "M"][conv_idx]
        weights[f"lin{tap_i}_w"] = np.full((ch,), 1.0 / ch, np.float32)
    weights["calibrated"] = np.zeros((), np.float32)  # marker: 0 = random fallback
    return weights


def load_lpips_weights(weights_path: Optional[os.PathLike] = None, device=None
                       ) -> Tuple[Dict[str, torch.Tensor], bool]:
    """(weights on ``device`` (None: the CUDA card), calibrated?): the npz
    if there is one, else the seeded random fallback. Conv kernels stay
    HWIO, as in the npz; ``lpips`` transposes them."""
    path = weights_path or os.environ.get(_ENV_WEIGHTS)
    if path and Path(path).exists():
        with np.load(str(path)) as npz:
            arrays = dict(npz)
        arrays.setdefault("calibrated", np.ones((), np.float32))
    else:
        arrays = random_lpips_weights()
    dev = resolve_device(device)
    weights = {k: torch.as_tensor(np.asarray(v, np.float32)).to(dev) for k, v in arrays.items()}
    return weights, bool(arrays["calibrated"])


def _vgg_taps(weights, x):
    """x [N, H, W, 3] in [-1, 1] -> the tapped feature maps [N, C, h, w]
    (post-relu)."""
    shift = torch.as_tensor(_SHIFT, device=x.device)
    scale = torch.as_tensor(_SCALE, device=x.device)
    x = ((x - shift) / scale).permute(0, 3, 1, 2)
    taps = []
    conv_i = 0
    for item in _VGG_CFG:
        if item == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        w = weights[f"conv{conv_i}_w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        x = F.relu(F.conv2d(x, w, weights[f"conv{conv_i}_b"], padding=1))
        if conv_i in _TAP_AFTER_CONV:
            taps.append(x)
        conv_i += 1
    return taps


@torch.no_grad()
def lpips(weights: Dict[str, torch.Tensor], img_a: torch.Tensor,
          img_b: torch.Tensor) -> torch.Tensor:
    """Perceptual distance between [N, H, W, 3] images in [0, 1] -> [N]."""
    torch.backends.cudnn.allow_tf32 = False  # true f32 convolutions
    taps_a = _vgg_taps(weights, img_a * 2.0 - 1.0)
    taps_b = _vgg_taps(weights, img_b * 2.0 - 1.0)
    total = 0.0
    for i, (fa, fb) in enumerate(zip(taps_a, taps_b)):
        na = fa / torch.sqrt(torch.sum(fa ** 2, dim=1, keepdim=True) + 1e-10)
        nb = fb / torch.sqrt(torch.sum(fb ** 2, dim=1, keepdim=True) + 1e-10)
        diff = (na - nb) ** 2
        lin = weights[f"lin{i}_w"][None, :, None, None]
        total = total + torch.mean(torch.sum(diff * lin, dim=1), dim=(1, 2))
    return total


class LPIPSMetric:
    """The metric with its weights loaded once, on ``device`` (None: the
    CUDA card), as the tester uses it."""

    def __init__(self, weights_path: Optional[os.PathLike] = None, device=None) -> None:
        self.device = resolve_device(device)
        self.weights, self.calibrated = load_lpips_weights(weights_path, self.device)

    @property
    def name(self) -> str:
        return "lpips_vgg" if self.calibrated else "lpips_rand_vgg"

    def __call__(self, img_a, img_b) -> float:
        """Mean LPIPS of [N, H, W, 3] (or one [H, W, 3]) image pairs given as
        tensors or numpy arrays, in [0, 1]."""
        a, b = (torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                                dtype=torch.float32).to(self.device) for x in (img_a, img_b))
        if a.ndim == 3:
            a, b = a[None], b[None]
        return float(torch.mean(lpips(self.weights, a, b)))
