"""The weighted one-hot row gather and its scatter-add adjoint: plain PyTorch
versions, the CUDA kernel wrappers and the differentiable
``weighted_onehot_gather``.

Counterpart of thr3ed_atom_tpu/ops/pallas/onehot_gather.py:

    out[n] = sum_k weights[n, k] * table[indices[n, k]]

for a table [B, C], indices [N, K] int32 and weights [N, K]; an index outside
[0, B) matches no row and contributes nothing (the reference builds a one-hot
weight matrix W [N, B], so such an index finds no column). K13
(``onehot_gather_forward``, csrc/onehot_gather.cu) computes W @ table; K14
(``onehot_scatter_add``, the same source) computes W^T @ g, the table's
cotangent. The weights' cotangent is K13 with unit weights, one index a row,
and a row dot, as the reference does. On a CPU tensor each wrapper runs its
plain version; on a CUDA tensor it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from thr3ed_atom_tpu_torch import kernels

F32 = torch.float32
MAX_K = 32  # indices per row the kernels take


def _check(what, indices, weights, B):
    if indices.dim() != 2 or indices.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what}: indices [N, K] int required")
    if tuple(weights.shape) != tuple(indices.shape):
        raise ValueError(f"{what}: weights must have the indices' shape [N, K]")
    if B <= 0:
        raise ValueError(f"{what}: an empty table")


def _masked(indices, B):
    """(in-range mask, indices clamped into the table)."""
    valid = (indices >= 0) & (indices < B)
    return valid, torch.where(valid, indices, 0).long()


def onehot_gather_plain(table, indices, weights) -> torch.Tensor:
    """Plain version of K13 (the reference form of
    tests/test_pallas_onehot_gather.py, with the out-of-range mask): the
    gathered rows, zero for an index outside [0, B), weighted and summed over
    k. [N, C] f32."""
    _check("onehot_gather_plain", indices, weights, table.shape[0])
    valid, idx = _masked(indices, table.shape[0])
    rows = torch.where(valid[..., None], table.to(F32)[idx], 0.0)
    return torch.einsum("nkc,nk->nc", rows, weights.to(F32))


def onehot_scatter_add_plain(indices, weights, g, B: int) -> torch.Tensor:
    """Plain version of K14: d_table [B, C] f32 with ``w[n, k] * g[n]`` added
    at row indices[n, k], by a masked ``index_put_(..., accumulate=True)``."""
    _check("onehot_scatter_add_plain", indices, weights, B)
    valid, idx = _masked(indices, B)
    vals = weights.to(F32)[..., None] * g.to(F32)[:, None, :]  # [N, K, C]
    out = torch.zeros((B, g.shape[-1]), dtype=F32, device=g.device)
    return out.index_put_((idx[valid],), vals[valid], accumulate=True)


def _lib(fn_name: str, n_ptr: int):
    return kernels.bind("onehot_gather", fn_name,
                        [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _cuda_rows(what, indices, weights, dev):
    N, K = indices.shape
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if K > MAX_K:
        raise ValueError(f"{what}: at most {MAX_K} indices a row, got {K}")
    return (indices.to(device=dev, dtype=torch.int32).contiguous(),
            weights.to(device=dev, dtype=F32).contiguous(), N, K)


def onehot_gather_forward(table, indices, weights) -> torch.Tensor:
    """K13: [N, C] f32 from table [B, C], indices [N, K], weights [N, K]. On a
    CUDA tensor one launch of csrc/onehot_gather.cu (a warp per sample row,
    its lanes over 128 channels: the row's distinct indices merged once with
    their weights summed in k order, then the rows added in ascending
    index); on a CPU tensor the plain version."""
    if table.device.type == "cpu":
        return onehot_gather_plain(table, indices, weights)
    _check("onehot_gather_forward", indices, weights, table.shape[0])
    dev = table.device
    idx, w, N, K = _cuda_rows("onehot_gather_forward", indices, weights, dev)
    tab = table.to(F32).contiguous()
    B, C = tab.shape
    out = torch.empty((N, C), dtype=F32, device=dev)
    err = _lib("onehot_gather_launch", 4)(tab.data_ptr(), idx.data_ptr(), w.data_ptr(),
                                          out.data_ptr(), N, K, B, C,
                                          kernels.stream(out))
    kernels.check(err, "onehot_gather")
    onehot_gather_forward.launches += 1
    return out


onehot_gather_forward.launches = 0


def onehot_scatter_add(indices, weights, g, B: int) -> torch.Tensor:
    """K14: d_table [B, C] f32 = W^T @ g for indices / weights [N, K] and
    g [N, C]. On a CUDA tensor one launch of csrc/onehot_gather.cu (a warp
    per sample row merges its indices once, its lanes add over channels into
    a shared-memory channel slice of d_table, flushed with f32 atomics; past
    B = 1600 straight into d_table; they add in no fixed order); on a CPU
    tensor the plain version."""
    if g.device.type == "cpu":
        return onehot_scatter_add_plain(indices, weights, g, B)
    _check("onehot_scatter_add", indices, weights, B)
    dev = g.device
    idx, w, N, K = _cuda_rows("onehot_scatter_add", indices, weights, dev)
    gf = g.to(F32).contiguous()
    if tuple(gf.shape[:1]) != (N,) or gf.dim() != 2:
        raise ValueError("onehot_scatter_add: g must be [N, C]")
    C = gf.shape[1]
    out = torch.zeros((B, C), dtype=F32, device=dev)
    err = _lib("onehot_scatter_add_launch", 4)(idx.data_ptr(), w.data_ptr(), gf.data_ptr(),
                                               out.data_ptr(), N, K, B, C,
                                               kernels.stream(out))
    kernels.check(err, "onehot_scatter_add")
    onehot_scatter_add.launches += 1
    return out


onehot_scatter_add.launches = 0


class _WeightedOnehotGather(torch.autograd.Function):
    """K13 forward; the table's cotangent by K14, the weights' by K13 with unit
    weights (the rows each index names) and a row dot, as the reference's
    custom VJP; both cast to their input's dtype."""

    @staticmethod
    def forward(ctx, table, indices, weights, plain):
        ctx.save_for_backward(table, indices, weights)
        ctx.plain = plain
        return (onehot_gather_plain if plain else onehot_gather_forward)(
            table, indices, weights)

    @staticmethod
    def backward(ctx, g):
        table, indices, weights = ctx.saved_tensors
        N, K = indices.shape
        B, C = table.shape
        gather = onehot_gather_plain if ctx.plain else onehot_gather_forward
        scatter = onehot_scatter_add_plain if ctx.plain else onehot_scatter_add
        d_table = scatter(indices, weights, g, B).to(table.dtype)
        rows = gather(table, indices.reshape(N * K, 1),
                      torch.ones((N * K, 1), dtype=weights.dtype, device=weights.device))
        d_weights = torch.einsum("nkc,nc->nk", rows.reshape(N, K, C), g.to(F32))
        return d_table, None, d_weights.to(weights.dtype), None


def weighted_onehot_gather(table, indices, weights, plain: bool = False) -> torch.Tensor:
    """Differentiable gather-reduce: [B, C] table, [N, K] int indices, [N, K]
    weights -> [N, C] f32; gradients flow to ``table`` and ``weights``.
    ``plain`` runs both directions through the plain versions."""
    return _WeightedOnehotGather.apply(table, indices, weights, bool(plain))


def onehot_gather(table, indices, plain: bool = False) -> torch.Tensor:
    """Plain row gather [B, C] x [N] -> [N, C] through the weighted gather."""
    ones = torch.ones((indices.shape[0], 1), dtype=table.dtype, device=table.device)
    return weighted_onehot_gather(table, indices[:, None], ones, plain=plain)
