"""Closed-form cell integrals of the linear density model (K1a).

``relu_trap_plain`` is the PyTorch version of the TPU kernels' device function
``_relu_trap`` (thr3ed_atom_tpu/ops/pallas/plane_march.py:83); the CUDA
``__device__`` version is csrc/relu_trap.cuh, which the composite kernel calls.
``relu_trap`` runs the device function through its elementwise test entry
(csrc/relu_trap.cu) on a CUDA tensor and the plain version on a CPU tensor.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from thr3ed_atom_tpu_torch import kernels

Quad = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def relu_trap_plain(a: torch.Tensor, b: torch.Tensor, relu_sigma: bool) -> Quad:
    """(integ, tbar, dIda, dIdb) for ``I = int_0^1 act(a + (b - a) t) dt`` with
    act = relu (``relu_sigma``) or identity: the mean density, its emission
    centroid and its endpoint derivatives. Operation for operation the JAX
    reference, including the factored form that avoids cancellation."""
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    # a 0-d tensor divisor: on CUDA, x / <python number> multiplies by the f32
    # reciprocal, which rounds differently from the division the reference
    # (and the CUDA device function) performs
    three = torch.full((), 3.0, dtype=a.dtype, device=a.device)
    if not relu_sigma:
        # identity post-activation: the grid is pre-activated non-negative
        mean = 0.5 * (a + b)
        integ = torch.maximum(mean, zero)
        num = a * 0.5 + (b - a) / three
        tbar = torch.clamp(num / torch.clamp_min(integ, 1e-9), 0.0, 1.0)
        half = torch.where(mean > 0.0, 0.5, 0.0).to(a.dtype)
        return integ, tbar, half, half

    p = torch.maximum(a, zero)
    q = torch.maximum(b, zero)
    s = a - b
    both = torch.abs(s) <= 1e-6
    safe = torch.where(both, torch.ones_like(s), s)
    # factored form (p+q)/2 * (p-q)/s: when both endpoints are positive p-q == s
    # exactly, so the ratio is exactly 1 and no cancellation occurs
    integ = torch.where(both, 0.5 * (p + q), 0.5 * (p + q) * (p - q) / safe)
    ts = torch.clamp(a / safe, 0.0, 1.0)  # zero crossing of the linear model

    def F(t):  # int_0^t (a + (b - a) t') t' dt'
        return a * t * t * 0.5 + (b - a) * t * t * t / three

    pos_a, pos_b = a > 0.0, b > 0.0
    F1 = F(1.0)
    Fts = F(ts)
    num = torch.where(pos_a & pos_b, F1, torch.where(pos_a, Fts, F1 - Fts))
    num = torch.where(pos_a | pos_b, num, zero)
    tbar = torch.clamp(num / torch.clamp_min(integ, 1e-9), 0.0, 1.0)

    # dI/da = int (1 - t) over the active range, dI/db = int t over it
    om = 1.0 - ts
    dIda = torch.where(
        pos_a & pos_b, 0.5,
        torch.where(pos_a, ts - 0.5 * ts * ts,
                    torch.where(pos_b, 0.5 * om * om, zero)),
    )
    dIdb = torch.where(
        pos_a & pos_b, 0.5,
        torch.where(pos_a, 0.5 * ts * ts,
                    torch.where(pos_b, 0.5 * (1.0 - ts * ts), zero)),
    )
    return integ, tbar, dIda, dIdb


def relu_trap(a: torch.Tensor, b: torch.Tensor, relu_sigma: bool) -> Quad:
    """relu_trap of same-shaped f32 tensors: the CUDA device function on a CUDA
    tensor (one launch of its test entry), the plain version on a CPU tensor."""
    if a.device.type == "cpu":
        return relu_trap_plain(a, b, relu_sigma)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"relu_trap: unsupported devices {a.device}, {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("relu_trap: float32 inputs required")
    if a.shape != b.shape or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("relu_trap: contiguous inputs of one shape required")
    out = torch.empty((4,) + tuple(a.shape), dtype=torch.float32, device=a.device)
    fn = kernels.bind("relu_trap", "relu_trap_eval",
                      [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
             int(bool(relu_sigma)), kernels.stream(a))
    kernels.check(err, "relu_trap_eval")
    relu_trap.launches += 1
    return out[0], out[1], out[2], out[3]


relu_trap.launches = 0
