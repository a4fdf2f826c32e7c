"""Differentiable gnomonic pipeline: the whole-pose training step of the port.

Counterpart of thr3ed_atom_tpu/rendering/gnomonic_train.py. One pose's loss
runs the serving path's stages with the training operands; in the fused (v3)
pipeline (``qb`` > 0): repack -> geometry with the materialized SH basis and norm
(and a sub-texel phase jitter) -> occupancy -> the fused composite (CUDA
kernel csrc/composite_fused.cu, training branch) -> the two-pass warp (CUDA
kernel csrc/resample_rows.cu) -> L1 loss on the pixels (specular + diffuse).

The backward is not autograd of the forward. The composite is a
``torch.autograd.Function`` whose backward is the reference's replay VJP
(csrc/composite_backward_fused.cu): it marches again, rebuilds T and the
running prefix, forms dL/d(integral) in the division-free suffix form and
routes it to the cell's endpoints, with the emission centroid held constant
(the reference's convention), then folds each position's cotangent through
the SH basis and both tents into per-position slice cotangents; the
position -> vertex fold of the interior lerp follows in PyTorch. The warp's
resample is a ``torch.autograd.Function`` whose backward is the adjoint
resample (csrc/resample_rows_adjoint.cu). On CPU tensors every kernel's plain
PyTorch version runs instead; ``plain=True`` selects the plain versions on
any device (a reference for checking the kernels on the card).

``qb=0`` trains through the v2 stripe pipeline instead: the interleaved
position stack, the u-resample as a bf16 matmul (its gradient autograd's), the
stripe composite (csrc/composite_stripe.cu) and its replay VJP with respect to
the u-resampled stack (csrc/composite_stripe_backward.cu). ``fused=False``
with ``qb`` > 0 runs the same pipeline on a q-block grain (K6, K8: flags per
[128, qb] texel block, the fold summed per q-block), as the JAX package's.

The warp is either form (``warp_impl``: the scanline warp, or the gather
warp, whose gradient is autograd's index-add) at order 1, 3 or 5.

``gnomonic_train_step_mesh`` is the pose-parallel step over a
``torch.distributed`` group (one process a device): each rank differentiates
its own views, the gradient is all-reduced, and every rank takes the same
Adam step.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from thr3ed_atom_tpu_torch import kernels
from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid
from thr3ed_atom_tpu_torch.ops.relu_trap import relu_trap_plain
from thr3ed_atom_tpu_torch.rendering.axes import _uv_axes
from thr3ed_atom_tpu_torch.rendering.gnomonic import (
    CUDA_EXIT_TILE,
    GnomonicStatics,
    _bf16r,
    _check_stripe_operands,
    _counter_ptr,
    _num_positions,
    _position_values,
    _qb_blocks,
    _sprows,
    _stripe_values,
    _strict_f32,
    _texel_flags,
    _vertex_stack,
    _warp_to_camera,
    composite_positions,
    composite_positions_fused,
    composite_positions_fused_plain,
    composite_positions_plain,
    composite_positions_qb_plain,
    effective_supersample,
    gnomonic_frame,
    gnomonic_geometry,
    gnomonic_occupancy,
    gnomonic_occupancy_lite,
    repack_position_slices,
    resample_u,
    statics_for_grid,
)
from thr3ed_atom_tpu_torch.utils.constants import EXTRA_DIFFUSE_COLOUR
from thr3ed_atom_tpu_torch.utils.metrics import mse2psnr

F32 = torch.float32

# above this repacked-slice size the multi-pose step feeds the poses bf16
# slices (the renderer rounds them to bf16 anyway); the k-pose cotangent sum
# stays f32 either way
_BF16_SLICES_BYTES = 512 * 1024 * 1024

# ------------------------------------------------------- replay backward (K3)


def _tent_matrix(coord: torch.Tensor, n: int) -> torch.Tensor:
    """[len(coord), n] bf16-rounded tent weights max(0, 1 - |coord - k|)."""
    k = torch.arange(n, dtype=F32, device=coord.device)
    return _bf16r(torch.clamp_min(1.0 - torch.abs(coord[:, None] - k[None, :]), 0.0))


def _fold_tents(dvals: torch.Tensor, g_row: torch.Tensor, nu: int, nv: int):
    """One position's cotangent [used, Pn, Qn] (bf16 values) through both
    tents: the f32 q-sum rounded to bf16, then the f32 p-sum rounded to bf16.
    Returns [nu, used, nv] f32 of bf16 values."""
    used, Pn, Qn = dvals.shape
    dev = dvals.device
    _, _, bu, ku, bv, kv = g_row[:6]
    Wv = _tent_matrix(bv + kv * torch.arange(Qn, dtype=F32, device=dev), nv)
    Wu = _tent_matrix(bu + ku * torch.arange(Pn, dtype=F32, device=dev), nu)
    dt1 = _bf16r(torch.matmul(dvals, Wv))  # [used, Pn, nv]
    return _bf16r(torch.einsum("pu,cpv->ucv", Wu, dt1))


def _replay_vjp_plain(values, flush, geom, ybasis, norm, gaux, occupancy,
                      statics: GnomonicStatics, Pn: int, Qn: int, Pb: int) -> None:
    """The replay VJP of a composite, step by step as the kernels run it, on
    the whole frame. ``values(j)`` gives position j's (sig, rgb, dif, live) as
    the forward computed them; ``flush(j, dvals)`` receives position j's
    cotangent [used, Pn, Qn] per channel (bf16 values, zero where its block
    is not needed).

    ``gaux`` [SROWS + 2, Pn, Qn] is the state cotangent, S_total = sum over
    rows >= 1 of cotangent x state, and the final transmittance. Per step j =
    0 .. NP: replay position j, composite cell (j-1, j) again, form dinteg =
    delta * ((1 - alpha) T inner - suffix) and route it to both endpoints with
    dI/da, dI/db; position j-1's cotangent (its pending b-side plus cell j's
    a-side) folds through the SH basis and rounds to bf16. Masks are ``where``
    selections applied after the products."""
    NP = geom.shape[0]
    nc = statics.ncoeff
    SROWS = _sprows(statics.with_diffuse)
    cell_live, pos_needed = occupancy[0], occupancy[1]
    yb, nm = ybasis, norm
    g_T, g_acc, g_dep = gaux[0], gaux[4], gaux[5]
    g_col = [gaux[1 + c] for c in range(3)]
    g_dif = [gaux[6 + c] for c in range(3)] if statics.with_diffuse else []
    S_total, T_fin = gaux[SROWS], gaux[SROWS + 1]

    zeros = torch.zeros((Pn, Qn), dtype=F32, device=geom.device)
    T, S = torch.ones_like(zeros), zeros
    prev_sig = prev_live = zeros
    prev_rgb, prev_dif = [zeros] * 3, [zeros] * 3
    pend_sig, pend_rgb, pend_dif = zeros, [zeros] * 3, [zeros] * 3
    for j in range(NP + 1):
        d_a = d_b = zeros
        a_rgb = b_rgb = a_dif = b_dif = [zeros] * 3
        if j < NP:
            replay = _texel_flags(pos_needed, j, Pb, Qn)
            sig, rgb, dif_j, live = values(j)
        if 0 < j < NP:
            cell = replay & _texel_flags(cell_live, j, Pb, Qn)
            s_j, cell_step = geom[j, 0], geom[j, 1]
            integ_raw, tbar, dIda, dIdb = relu_trap_plain(prev_sig, sig,
                                                          statics.relu_sigma)
            live_pair = prev_live * live
            integ = integ_raw * live_pair
            delta = cell_step * nm
            e = torch.exp(-integ * delta)
            alpha = 1.0 - e
            w = alpha * T
            s_mid = (s_j - cell_step + tbar * cell_step) * nm
            tb1 = 1.0 - tbar
            mids = [torch.sigmoid(tb1 * prev_rgb[c] + tbar * rgb[c]) for c in range(3)]
            inner = g_acc + g_dep * s_mid
            for c in range(3):
                inner = inner + g_col[c] * mids[c]
            if statics.with_diffuse:
                dmids = [torch.sigmoid(tb1 * prev_dif[c] + tbar * dif_j[c])
                         for c in range(3)]
                for c in range(3):
                    inner = inner + g_dif[c] * dmids[c]
            S_prefix = S + inner * w
            suffix = (S_total - S_prefix) + g_T * T_fin
            dinteg = delta * (e * T * inner - suffix) * live_pair

            def m(x, cell=cell):
                return torch.where(cell, x, 0.0)

            d_a, d_b = m(dinteg * dIda), m(dinteg * dIdb)
            dm = [g_col[c] * w * mids[c] * (1.0 - mids[c]) for c in range(3)]
            a_rgb = [m(tb1 * dm[c]) for c in range(3)]
            b_rgb = [m(tbar * dm[c]) for c in range(3)]
            if statics.with_diffuse:
                ddm = [g_dif[c] * w * dmids[c] * (1.0 - dmids[c]) for c in range(3)]
                a_dif = [m(tb1 * ddm[c]) for c in range(3)]
                b_dif = [m(tbar * ddm[c]) for c in range(3)]
            T = torch.where(cell, T * (1.0 - alpha), T)
            S = torch.where(cell, S_prefix, S)
        if j > 0:
            dsig = pend_sig + d_a
            drgb = [pend_rgb[c] + a_rgb[c] for c in range(3)]
            ddif = [pend_dif[c] + a_dif[c] for c in range(3)]
            rows = []
            for ch in range(3 * nc):
                c, k = divmod(ch, nc)
                blk = yb[k] * drgb[c]
                if statics.with_diffuse and k == 0:
                    blk = blk + yb[0] * ddif[c]
                rows.append(blk)
            rows.append(dsig)
            needed = _texel_flags(pos_needed, j - 1, Pb, Qn)
            flush(j - 1, torch.where(needed, _bf16r(torch.stack(rows)), 0.0))
        pend_sig, pend_rgb, pend_dif = d_b, b_rgb, b_dif
        if j < NP:
            prev_sig = torch.where(replay, sig, prev_sig)
            prev_rgb = [torch.where(replay, rgb[c], prev_rgb[c]) for c in range(3)]
            prev_dif = [torch.where(replay, dif_j[c], prev_dif[c]) for c in range(3)]
            prev_live = torch.where(replay, live, prev_live)


def composite_backward_fused_plain(slices, ybasis, norm, geom, gaux, occupancy,
                                   statics: GnomonicStatics, Pn: int, Qn: int,
                                   PB: int, Pb: int) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel
    thr3ed_atom_tpu/rendering/gnomonic_train.py _composite_backward_fused:
    the replay VJP of the fused composite (``_replay_vjp_plain``; autograd of
    the forward would differentiate the emission centroid and give a
    different gradient), each position's bf16 cotangent folded through its v-
    and u-tents (``_fold_tents``). Returns per-position dslices
    [NP, nu, C, nv] bf16, zero for dead positions and pad channels."""
    nvert, nu, C, nv = slices.shape
    NP = _num_positions(statics)
    used = 3 * statics.ncoeff + 1
    dpos = torch.zeros((NP, nu, C, nv), dtype=F32, device=slices.device)
    slices_u = slices[:, :, :used, :]

    def flush(j, dvals):
        dpos[j, :, :used, :] = _fold_tents(dvals, geom[j], nu, nv)

    _replay_vjp_plain(lambda j: _position_values(slices_u, geom, j, statics, ybasis),
                      flush, geom, ybasis, norm, gaux, occupancy, statics, Pn, Qn, Pb)
    return dpos.to(torch.bfloat16)


def _backward_fn():
    return kernels.bind("composite_backward_fused", "composite_backward_fused_launch",
                        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 14 + [ctypes.c_void_p])


def fold_records(pos_needed: torch.Tensor, statics: GnomonicStatics, Pb: int,
                 Qb: int) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """The replay backward's v-fold output, sized by the occupancy flags
    ``pos_needed`` [PB, QB, NP]: dense bf16 dt1 rows [Pb, 3 ncoeff + 1, nv]
    per (u-block, position) with a needed q-block, and an f32 edge record
    [3 ncoeff + 1, TP, 4] per (``CUDA_EXIT_TILE`` tile, needed position).
    Returns (d_off [PB, NP] int64 and s_off [PB, QB, NP] int64, the element
    offsets of each slot, -1 where none; the dt1 and edge element counts,
    read on the host)."""
    TP, TQ = CUDA_EXIT_TILE
    nv = statics.dims[_uv_axes(statics.axis)[1]]
    used = 3 * statics.ncoeff + 1
    needed = pos_needed > 0

    def offsets(flags, size):
        sizes = flags.to(torch.int64).reshape(-1) * size
        off = torch.where(flags.reshape(-1), torch.cumsum(sizes, 0) - sizes, -1)
        return off.reshape(flags.shape).contiguous(), sizes.sum()

    d_off, n_dt1 = offsets(needed.any(dim=1), Pb * used * nv)
    s_off, n_edge = offsets(needed, (Pb // TP) * (Qb // TQ) * used * TP * 4)
    n_dt1, n_edge = torch.stack([n_dt1, n_edge]).tolist()
    return d_off, s_off, n_dt1, n_edge


def dvals_slots(pos_needed: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The replay backward's compact cotangent buffer: one slot per needed
    (u-block, q-block, position) of ``pos_needed`` [PB, QB, NP]. Returns the
    slot table (same shape, int32, -1 where not needed) and the slot count
    (read on the host)."""
    flat = (pos_needed.reshape(-1) > 0).to(torch.int32)
    slot = torch.cumsum(flat, 0, dtype=torch.int32) - 1
    slot = torch.where(flat > 0, slot, -1).to(torch.int32)
    return slot.reshape(pos_needed.shape).contiguous(), int(flat.sum())


def composite_backward_fused(slices, ybasis, norm, geom, gaux, occupancy,
                             statics: GnomonicStatics, Pn: int, Qn: int,
                             PB: int, Pb: int, direct_tiles=None) -> torch.Tensor:
    """The replay VJP of the fused composite (see
    ``composite_backward_fused_plain``): per-position dslices
    [NP, nu, C, nv] bf16. On a CUDA tensor one launch of
    csrc/composite_backward_fused.cu (a march over texel tiles that folds
    each position's cotangent through its v-tents, then a tensor-core fold
    through the u-tents); on a CPU tensor the plain version. The march's
    v-fold output takes ``fold_records`` scratch (bf16 dt1 rows, f32 edge
    records); ``direct_tiles`` (a one-element int32 CUDA tensor) counts the tiles that
    gathered a position's footprint directly."""
    if slices.device.type == "cpu":
        return composite_backward_fused_plain(slices, ybasis, norm, geom, gaux,
                                              occupancy, statics, Pn, Qn, PB, Pb)
    if slices.device.type != "cuda":
        raise ValueError(f"composite_backward_fused: unsupported device {slices.device}")
    dev = slices.device
    nvert, nu, C, nv = slices.shape
    NP = _num_positions(statics)
    QB, Qb = _qb_blocks(statics, Qn)
    SROWS = _sprows(statics.with_diffuse)
    vert = _vertex_stack(slices, statics, Pn, Qn, PB, Pb, "composite_backward_fused")
    if (ybasis.shape != (statics.ncoeff, Pn, Qn) or norm.shape != (Pn, Qn)
            or gaux.shape != (SROWS + 2, Pn, Qn) or geom.shape != (NP, 8)):
        raise ValueError("composite_backward_fused: operand shapes")
    cell_live, pos_needed, _ = occupancy
    flags = [fl.to(device=dev, dtype=torch.int32).contiguous()
             for fl in (cell_live, pos_needed)]
    if any(fl.shape != (PB, QB, NP) for fl in flags):
        raise ValueError("composite_backward_fused: flags shape")
    ops = [t.to(F32).contiguous() for t in (geom, ybasis, norm, gaux)]
    d_off, s_off, n_dt1, n_edge = fold_records(flags[1], statics, Pb, Qb)
    dt1 = torch.empty((max(n_dt1, 1),), dtype=torch.bfloat16, device=dev)
    edge = torch.empty((max(n_edge, 1),), dtype=F32, device=dev)
    dsl = torch.empty((NP, nu, C, nv), dtype=torch.bfloat16, device=dev)
    err = _backward_fn()(
        vert.data_ptr(), ops[0].data_ptr(), flags[0].data_ptr(), flags[1].data_ptr(),
        d_off.data_ptr(), s_off.data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(),
        ops[3].data_ptr(), dt1.data_ptr(), edge.data_ptr(), dsl.data_ptr(),
        _counter_ptr(direct_tiles, dev),
        statics.ncoeff, int(statics.with_diffuse), int(statics.relu_sigma),
        NP, statics.pos_per_cell, nvert, nu, nv, C, Pn, Qn, Pb, Qb, QB, kernels.stream(dsl),
    )
    kernels.check(err, "composite_backward_fused")
    composite_backward_fused.launches += 1
    return dsl


composite_backward_fused.launches = 0


def composite_backward_fused_stage(statics: GnomonicStatics) -> Tuple[int, int]:
    """The stage that Stage::fit gives the march of a launch of
    composite_backward_fused on ``statics`` on the current card: (records of
    a ring stage, t1 lines); (0, 0) is no stage. Launches nothing."""
    fn = kernels.bind("composite_backward_fused", "composite_backward_fused_stage",
                      [ctypes.c_int] * 2 + [ctypes.c_void_p])
    out = (ctypes.c_int * 2)()
    kernels.check(fn(statics.ncoeff, _num_positions(statics),
                     ctypes.cast(out, ctypes.c_void_p)), "composite_backward_fused_stage")
    return out[0], out[1]


def position_to_vertex_cotangent(dpos: torch.Tensor, nvert: int, P: int) -> torch.Tensor:
    """The interior lerp's adjoint: position j = (1 - f) vertex[j // P] +
    f vertex[min(j // P + 1, nvert - 1)] with f = (j % P) / P, so the vertex
    cotangent is the f32 sum of the bf16 per-position cotangents weighted by
    the (bf16-exact) lerp weights, rounded to bf16 (the reference's einsum in
    _cpf_bwd, here as P-term sums instead of a [nvert, NP] matmul)."""
    if P == 1:
        return dpos
    d = dpos.to(F32)
    main = d[:-1].reshape((nvert - 1, P) + tuple(d.shape[1:]))  # j = v P + k
    f = (torch.arange(P, dtype=F32, device=d.device) / P).reshape(
        (1, P) + (1,) * (d.dim() - 1))
    out = torch.zeros((nvert,) + tuple(d.shape[1:]), dtype=F32, device=d.device)
    out[:-1] += ((1.0 - f) * main).sum(1)
    out[1:] += (f * main).sum(1)
    out[-1] += d[-1]
    return out.to(torch.bfloat16)


class _CompositeFusedDiff(torch.autograd.Function):
    """composite_positions_fused with the replay VJP with respect to the
    slices (the only grid-dependent input)."""

    @staticmethod
    def forward(ctx, slices, ybasis, norm, geom, cell_live, pos_needed, pos_any,
                statics, Pn, Qn, PB, Pb, plain):
        occupancy = (cell_live, pos_needed, pos_any)
        forward = composite_positions_fused_plain if plain else composite_positions_fused
        state = forward(slices, ybasis, norm, geom, statics, Pn, Qn, PB, Pb, occupancy)
        ctx.save_for_backward(slices, ybasis, norm, geom, cell_live, pos_needed,
                              pos_any, state)
        ctx.meta = (statics, Pn, Qn, PB, Pb, plain)
        return state

    @staticmethod
    def backward(ctx, gstate):
        slices, ybasis, norm, geom, cell_live, pos_needed, pos_any, state = ctx.saved_tensors
        statics, Pn, Qn, PB, Pb, plain = ctx.meta
        S_total = torch.sum(gstate[1:] * state[1:], dim=0)
        gaux = torch.cat([gstate, S_total[None], state[0:1]], dim=0)
        backward = composite_backward_fused_plain if plain else composite_backward_fused
        dpos = backward(slices, ybasis, norm, geom, gaux,
                        (cell_live, pos_needed, pos_any), statics, Pn, Qn, PB, Pb)
        dslices = position_to_vertex_cotangent(dpos, slices.shape[0],
                                               statics.pos_per_cell)
        return (dslices,) + (None,) * 12


def composite_positions_fused_diff(slices, ybasis, norm, geom, cell_live,
                                   pos_needed, pos_any, statics: GnomonicStatics,
                                   Pn: int, Qn: int, PB: int, Pb: int,
                                   plain: bool = False) -> torch.Tensor:
    """The fused composite (training operands ybasis / norm), differentiable
    in ``slices`` through the replay VJP. ``plain`` runs both directions
    through the plain versions."""
    return _CompositeFusedDiff.apply(slices, ybasis, norm, geom, cell_live,
                                     pos_needed, pos_any, statics, Pn, Qn, PB,
                                     Pb, plain)


# ------------------------------------- stripe replay backwards (K7, K8)


def composite_backward_plain(t1, rvt, ybasis, live_u, live_v, norm, geom, gaux,
                             occupancy, statics: GnomonicStatics, Pn: int, Qn: int,
                             PB: int, Pb: int) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel
    thr3ed_atom_tpu/rendering/gnomonic_train.py _composite_backward (QB = 1):
    the replay VJP of the stripe composite (``_replay_vjp_plain`` with the
    stripe values), each position's bf16 cotangent folded through its
    v-tents, dt1[j] = bf16(dvals @ RvT[j]^T) with f32 sums. Returns dt1
    [NP, C, Pn, nv] bf16, zero for dead blocks and pad channels."""
    NP, C, _, nv = t1.shape
    used = 3 * statics.ncoeff + 1
    dt1 = torch.zeros((NP, C, Pn, nv), dtype=torch.bfloat16, device=t1.device)

    def flush(j, dvals):
        dt1[j, :used] = torch.matmul(dvals, rvt[j].to(F32).T).to(torch.bfloat16)

    _replay_vjp_plain(
        lambda j: _stripe_values(t1, rvt, ybasis, live_u, live_v, j, statics.ncoeff),
        flush, geom, ybasis, norm, gaux, occupancy, statics, Pn, Qn, Pb)
    return dt1


def composite_backward_qb_plain(t1, rvt, ybasis, live_u, live_v, norm, geom, gaux,
                                occupancy, statics: GnomonicStatics, Pn: int, Qn: int,
                                PB: int, Pb: int) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel
    thr3ed_atom_tpu/rendering/gnomonic_train.py _composite_backward_qb (QB =
    Qn / qb > 1): ``composite_backward_plain``'s replay under [PB, QB, NP]
    flags, and the v-fold in the reference's association: each q-block's
    partial dvals[:, :, block] @ RvT[j, :, block]^T sums in f32, the partials
    add in ascending q-block order in f32, and dt1 rounds to bf16 once."""
    NP, C, _, nv = t1.shape
    QB, Qb = _qb_blocks(statics, Qn)
    used = 3 * statics.ncoeff + 1
    dt1 = torch.zeros((NP, C, Pn, nv), dtype=torch.bfloat16, device=t1.device)

    def flush(j, dvals):
        rv = rvt[j].to(F32).T  # [Qn, nv]
        acc = torch.matmul(dvals[..., :Qb], rv[:Qb])
        for b in range(1, QB):
            acc = acc + torch.matmul(dvals[..., b * Qb:(b + 1) * Qb], rv[b * Qb:(b + 1) * Qb])
        dt1[j, :used] = acc.to(torch.bfloat16)

    _replay_vjp_plain(
        lambda j: _stripe_values(t1, rvt, ybasis, live_u, live_v, j, statics.ncoeff),
        flush, geom, ybasis, norm, gaux, occupancy, statics, Pn, Qn, Pb)
    return dt1


def _stripe_backward_fn():
    return kernels.bind("composite_stripe_backward", "composite_stripe_backward_launch",
                        [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 15
                        + [ctypes.c_int] * 11 + [ctypes.c_void_p])


def _stripe_band_fn():
    return kernels.bind("composite_stripe_backward", "composite_stripe_band_launch",
                        [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 11
                        + [ctypes.c_int] * 15 + [ctypes.c_longlong, ctypes.c_void_p])


class BandPlan(NamedTuple):
    """The band kernel's launch (K7, and K8 with q-block flags): clusters of
    ``S`` CTAs of ``R`` texel rows by ``Qc`` columns (``threads`` = R Qc,
    one a texel) span a row band's q extent;
    ``staged``: t1's band rows go through a shared-memory ring; ``smem``:
    the CTA's shared-memory bytes."""
    S: int
    R: int
    Qc: int
    threads: int
    staged: bool
    smem: int


BAND_ROW_THREADS = 256  # texels of a CTA over several rows (Qn <= 256)
BAND_MAX_THREADS = 512  # the kernel's launch bound: texels of a CTA over one row
BAND_MAX_CLUSTER = 8  # the portable cluster size
BAND_MAX_QBLOCKS = 32  # a position's q-block flags are the bits of one 32-bit word
SMEM_OPTIN = 232_448  # shared memory a block may opt in to on an H100 (227 KB)


def stripe_band_plan(Qn: int, Pb: int, NP: int, used: int, nv: int,
                     t1_aligned: bool = True, QB: int = 1) -> Optional[BandPlan]:
    """The launch plan of the band kernel (csrc/composite_stripe_backward.cu,
    whose ``band_layout`` lays out the same bytes) for K7 (QB = 1) and K8
    (QB q-blocks; the plan depends on the blocks only through the limit of
    32, the bits of the flag words: a q-block may straddle two CTAs of a
    cluster, whose fold restarts its partials on q-block boundaries): a
    frame of Qn <= 256
    columns takes R = 256 / Qn rows a CTA; a wider one CTAs of one row and up
    to 512 columns (one CTA up to Qn = 512; past that a cluster of S =
    ceil(Qn / 512) CTAs of Qc columns, a multiple of 32, the last CTA's
    surplus columns idle), or up to 256 columns where 512 do not fit the
    shared memory. None where no plan fits: past Qn = 4096 (a cluster of 8
    CTAs of 512 columns), past 32 q-blocks, or where the position tables
    fill the shared memory. Shared memory: the taps ring (5 x Qc float4),
    the liveness ring (3 x [Qc + R, padded to 4] f32), the t1 ring (3 x
    [used, R, nv] bf16, only where t1's rows are 16-byte aligned and it
    fits), the per-position tables (32 NP bytes: geometry, and the cell and
    position flags of every q-block as the bits of two words), the column
    ranges (4 x 2 nv int,
    padded to 16 bytes) and the flushed cotangents (2 x [R, Qc, CS] bf16, CS
    the used channels rounded up to an odd number of 8-channel groups)."""
    if QB > BAND_MAX_QBLOCKS:
        return None
    cs = 8 * (-(-used // 8) | 1)  # a texel's cotangent stride: odd 8-channel groups
    for width in (BAND_MAX_THREADS, BAND_ROW_THREADS):
        if Qn <= BAND_ROW_THREADS:
            S, R, Qc = 1, max(1, BAND_ROW_THREADS // Qn), Qn
            while Pb % R:
                R //= 2
        else:
            S = -(-Qn // width)
            R, Qc = 1, 32 * -(-Qn // (32 * S))
            S = -(-Qn // Qc)
        rest = (80 * Qc + 12 * -(-(Qc + R) // 4) * 4 + 32 * NP + -(-32 * nv // 16) * 16
                + 4 * R * Qc * cs)
        if S <= BAND_MAX_CLUSTER and rest <= SMEM_OPTIN:
            ring = 6 * used * R * nv
            staged = t1_aligned and nv % 8 == 0 and rest + ring <= SMEM_OPTIN
            return BandPlan(S, R, Qc, R * Qc, staged, rest + (ring if staged else 0))
    return None


def _launch_stripe_backward(what, t1, rvt, ybasis, live_u, live_v, norm, geom, gaux,
                            occupancy, statics: GnomonicStatics, Pn, Qn, PB, Pb):
    """One call of csrc/composite_stripe_backward.cu: the band kernel (K7
    for QB = 1, K8 for QB > 1) wherever ``stripe_band_plan`` gives a plan,
    else the three launches (Qn > 4096, more than 32 q-blocks, or position
    tables that fill shared memory). A failed launch raises. Returns dt1
    [NP, C, Pn, nv] bf16."""
    if t1.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t1.device}")
    ops = _check_stripe_operands(what, t1, rvt, ybasis, live_u, live_v, norm, geom,
                                 occupancy, statics, Pn, Qn, PB, Pb)
    if gaux.shape != (_sprows(statics.with_diffuse) + 2, Pn, Qn):
        raise ValueError(f"{what}: gaux shape")
    gaux = gaux.to(F32).contiguous()
    QB, Qb = _qb_blocks(statics, Qn)
    t1, rvt, yb, lu, lv, nm, geom, cl, pn = ops
    NP, C, _, nv = t1.shape
    aligned = t1.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t1.stride()[:3])
    plan = stripe_band_plan(Qn, Pb, NP, 3 * statics.ncoeff + 1, nv, aligned, QB)
    if plan is None:  # a frame past the band kernel's reach
        return stripe_backward_three_launch(ops, gaux, statics, Pn, Qn, Pb, QB, Qb)
    if lv.data_ptr() % 16:  # the kernel copies live_v rows in 16-byte pieces
        lv = lv.clone()
    taps = torch.empty((NP, Qn, 4), dtype=F32, device=t1.device)
    dt1 = torch.empty((NP, C, Pn, nv), dtype=torch.bfloat16, device=t1.device)
    err = _stripe_band_fn()(
        t1.data_ptr(), *t1.stride()[:3], rvt.data_ptr(), taps.data_ptr(), lu.data_ptr(),
        lv.data_ptr(), geom.data_ptr(), cl.data_ptr(), pn.data_ptr(), yb.data_ptr(),
        nm.data_ptr(), gaux.data_ptr(), dt1.data_ptr(), statics.ncoeff,
        int(statics.with_diffuse), int(statics.relu_sigma), NP, C, nv, Pn, Qn, Pb, QB, Qb,
        plan.S, plan.R, plan.Qc, int(plan.staged), plan.smem, kernels.stream(dt1))
    kernels.check(err, "composite_stripe_band")
    return dt1


def stripe_backward_three_launch(ops, gaux, statics: GnomonicStatics, Pn, Qn, Pb, QB, Qb):
    """The three launches of csrc/composite_stripe_backward.cu on the
    checked operands ``ops`` of ``_check_stripe_operands`` and the f32
    ``gaux``: the column taps with each row's column range, the march into a
    compact cotangent buffer of ``dvals_slots`` slots of [3 ncoeff + 1, Pb,
    Qb] bf16, the fold. The design K7 (QB = 1) and K8 ran before the band
    kernel (chip_smoke.py and the GPU tests hold the two bit-equal), and
    their path on a frame that no band plan serves. Returns dt1."""
    t1, rvt, yb, lu, lv, nm, geom, cl, pn = ops
    NP, C, _, nv = t1.shape
    dev = t1.device
    slot, n_slots = dvals_slots(pn)
    dvals = torch.empty((max(n_slots, 1), 3 * statics.ncoeff + 1, Pb, Qb),
                        dtype=torch.bfloat16, device=dev)
    taps = torch.empty((NP, Qn, 4), dtype=F32, device=dev)
    q_lo = torch.full((NP, nv), 2 ** 31 - 1, dtype=torch.int32, device=dev)
    q_hi = torch.full((NP, nv), -1, dtype=torch.int32, device=dev)
    dt1 = torch.empty((NP, C, Pn, nv), dtype=torch.bfloat16, device=dev)
    err = _stripe_backward_fn()(
        t1.data_ptr(), *t1.stride()[:3], rvt.data_ptr(), taps.data_ptr(),
        q_lo.data_ptr(), q_hi.data_ptr(), lu.data_ptr(), lv.data_ptr(),
        geom.data_ptr(), cl.data_ptr(), pn.data_ptr(), slot.data_ptr(), yb.data_ptr(),
        nm.data_ptr(), gaux.data_ptr(), dvals.data_ptr(), dt1.data_ptr(), statics.ncoeff,
        int(statics.with_diffuse), int(statics.relu_sigma), NP, C, nv, Pn, Qn, Pb, QB, Qb,
        kernels.stream(dt1))
    kernels.check(err, "composite_stripe_backward")
    return dt1


def composite_backward(t1, rvt, ybasis, live_u, live_v, norm, geom, gaux, occupancy,
                       statics: GnomonicStatics, Pn: int, Qn: int, PB: int,
                       Pb: int) -> torch.Tensor:
    """The replay VJP of the stripe composite (see
    ``composite_backward_plain``): dt1 [NP, C, Pn, nv] bf16. With QB > 1
    q-blocks this is ``composite_backward_qb`` (K8); else, on a CUDA tensor,
    one call of csrc/composite_stripe_backward.cu (K7: the column taps, then
    one band kernel, ``stripe_band_plan``: clusters of CTAs spanning a row
    band's q extent replay it and fold each position's cotangent through
    its v-tents in shared memory; past the plan's reach, Qn > 4096, the
    three launches of ``stripe_backward_three_launch``), on a CPU tensor
    the plain version."""
    if _qb_blocks(statics, Qn)[0] > 1:
        return composite_backward_qb(t1, rvt, ybasis, live_u, live_v, norm, geom, gaux,
                                     occupancy, statics, Pn, Qn, PB, Pb)
    if t1.device.type == "cpu":
        return composite_backward_plain(t1, rvt, ybasis, live_u, live_v, norm, geom,
                                        gaux, occupancy, statics, Pn, Qn, PB, Pb)
    dt1 = _launch_stripe_backward("composite_backward", t1, rvt, ybasis, live_u, live_v,
                                  norm, geom, gaux, occupancy, statics, Pn, Qn, PB, Pb)
    composite_backward.launches += 1
    return dt1


composite_backward.launches = 0


def composite_backward_qb(t1, rvt, ybasis, live_u, live_v, norm, geom, gaux, occupancy,
                          statics: GnomonicStatics, Pn: int, Qn: int, PB: int,
                          Pb: int) -> torch.Tensor:
    """The q-split replay VJP (K8): as ``composite_backward`` with [PB, QB, NP]
    flags, the fold summing per q-block partials (see
    ``composite_backward_qb_plain``). On a CUDA tensor one call of
    csrc/composite_stripe_backward.cu with the q-block grain: the column
    taps, then K7's band kernel under the q-blocks' flags, each texel's
    replay under its own block's, the fold adding per-q-block partials in
    ascending block order (past the plan's reach, Qn > 4096 or more than 32
    q-blocks, the three launches of ``stripe_backward_three_launch``); on a
    CPU tensor the plain version."""
    if t1.device.type == "cpu":
        return composite_backward_qb_plain(t1, rvt, ybasis, live_u, live_v, norm, geom,
                                           gaux, occupancy, statics, Pn, Qn, PB, Pb)
    dt1 = _launch_stripe_backward("composite_backward_qb", t1, rvt, ybasis, live_u,
                                  live_v, norm, geom, gaux, occupancy, statics, Pn, Qn,
                                  PB, Pb)
    composite_backward_qb.launches += 1
    return dt1


composite_backward_qb.launches = 0


class _CompositeStripeDiff(torch.autograd.Function):
    """composite_positions with the replay VJP with respect to t1 (the only
    grid-dependent input; the rest is pose geometry). The q-split grain
    (QB > 1) runs K6 / K8, else K5 / K7."""

    @staticmethod
    def forward(ctx, t1, rvt, ybasis, live_u, live_v, norm, geom, cell_live,
                pos_needed, statics, Pn, Qn, PB, Pb, plain):
        occupancy = (cell_live, pos_needed)
        qsplit = _qb_blocks(statics, Qn)[0] > 1
        if plain:
            forward = composite_positions_qb_plain if qsplit else composite_positions_plain
        else:
            forward = composite_positions
        state = forward(t1, rvt, ybasis, live_u, live_v, norm, geom, statics, Pn, Qn,
                        PB, Pb, occupancy)
        ctx.save_for_backward(t1, rvt, ybasis, live_u, live_v, norm, geom, cell_live,
                              pos_needed, state)
        ctx.meta = (statics, Pn, Qn, PB, Pb, plain, qsplit)
        return state

    @staticmethod
    def backward(ctx, gstate):
        (t1, rvt, ybasis, live_u, live_v, norm, geom, cell_live, pos_needed,
         state) = ctx.saved_tensors
        statics, Pn, Qn, PB, Pb, plain, qsplit = ctx.meta
        S_total = torch.sum(gstate[1:] * state[1:], dim=0)
        gaux = torch.cat([gstate, S_total[None], state[0:1]], dim=0)
        if plain:
            backward = composite_backward_qb_plain if qsplit else composite_backward_plain
        else:
            backward = composite_backward
        dt1 = backward(t1, rvt, ybasis, live_u, live_v, norm, geom, gaux,
                       (cell_live, pos_needed), statics, Pn, Qn, PB, Pb)
        return (dt1,) + (None,) * 14


def composite_positions_diff(t1, rvt, ybasis, live_u, live_v, norm, geom, cell_live,
                             pos_needed, statics: GnomonicStatics, Pn: int, Qn: int,
                             PB: int, Pb: int, plain: bool = False) -> torch.Tensor:
    """The stripe composite, differentiable in ``t1`` through the replay VJP
    (the gradient of the u-resample that made t1 is autograd's). ``plain``
    runs both directions through the plain versions."""
    return _CompositeStripeDiff.apply(t1, rvt, ybasis, live_u, live_v, norm, geom,
                                      cell_live, pos_needed, statics, Pn, Qn, PB, Pb,
                                      plain)


# ----------------------------------------------------------------- train step


class GnomonicTrainStatics(NamedTuple):
    """Constants of one march variant's train step. ``frame`` is the serving
    frame (``gnomonic_frame``) for both pipelines: the TPU plans
    (``_fused_train_blocking``, ``_p_blocking_train``) size their blocking to
    VMEM budgets and the fused one needs nv % 128 == 0, but the CUDA kernels
    keep no frame-resident state, so every frame and grid takes Pb = 128, the
    occupancy grain (the plan the TPU picks wherever its budget fits; the
    texel grid Pn x Qn is the same under every plan)."""

    statics: GnomonicStatics
    height: int
    width: int
    supersample: float
    white_bkgd: bool
    apply_diffuse_render_regularization: bool
    frame: Tuple[int, int, int, int]  # Pn, Qn, PB, Pb
    warp_order: int = 3
    # "matmul" (the two-pass scanline warp) or "gather" (the per-pixel
    # gather warp, differentiated through index-add)
    warp_impl: str = "matmul"
    # the matmul warp's pass order, a per-pose decision (warp_swap_for_pose):
    # the steps take the views of one (axis, flip, swap) bucket
    warp_swap: bool = False
    # the fused (v3) pipeline (qb > 0), or the v2 stripe pipeline (qb = 0)
    fused: bool = True


def make_gnomonic_train_statics(
    voxel_grid: VoxelGrid,
    axis: int,
    flip: bool,
    *,
    image_height: int,
    image_width: int,
    white_bkgd: bool,
    apply_diffuse_render_regularization: bool = True,
    pos_per_cell: int = 0,
    supersample: float = 1.25,
    warp_order: int = 3,
    qb: int = 128,
    warp_impl: str = "auto",
    warp_swap: bool = False,
    fused: Optional[bool] = None,
) -> GnomonicTrainStatics:
    """The train step's constants for march variant (axis, flip): the fused
    pipeline for ``qb`` > 0, the v2 stripe pipeline for ``qb`` = 0
    (``fused=None`` chooses so; ``fused=True`` with ``qb=0`` is refused).
    ``fused=False`` with ``qb`` > 0 selects the v2 pipeline with the q-split
    kernels K6 / K8 (QB = Qn / qb q-blocks; one block, K5 / K7, where qb does
    not split Qn), as the JAX package's ``fused=False``."""
    if fused and qb == 0:
        raise ValueError("fused gnomonic training needs qb > 0 (qb=0 is the v2 "
                         "stripe pipeline, K5/K7)")
    if warp_impl not in ("auto", "matmul", "gather"):
        raise ValueError(f"gnomonic_warp_impl must be 'auto', 'matmul' or 'gather', "
                         f"got '{warp_impl}'")
    statics = statics_for_grid(
        voxel_grid, axis, flip,
        with_diffuse=apply_diffuse_render_regularization,
        pos_per_cell=pos_per_cell, qb=qb,
    )
    supersample = effective_supersample(float(supersample), statics,
                                        image_height, image_width)
    return GnomonicTrainStatics(
        statics=statics,
        height=int(image_height),
        width=int(image_width),
        supersample=float(supersample),
        white_bkgd=bool(white_bkgd),
        apply_diffuse_render_regularization=bool(apply_diffuse_render_regularization),
        frame=gnomonic_frame(None, image_height, image_width, None, supersample,
                             statics),
        warp_order=int(warp_order),
        warp_impl="matmul" if warp_impl == "auto" else str(warp_impl),
        warp_swap=bool(warp_swap),
        fused=qb > 0 if fused is None else bool(fused),
    )


def draw_phase(generator: torch.Generator) -> torch.Tensor:
    """Two uniforms in [-0.5, 0.5) from ``generator``: one pose's sub-texel
    phase (the reference draws them with jax.random.uniform from its key)."""
    return torch.rand(2, generator=generator, device=generator.device) - 0.5


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                           dtype=F32).to(dev)


def render_pose_from_slices(slices, rotation, origin, focal,
                            tstat: GnomonicTrainStatics,
                            generator: Optional[torch.Generator] = None,
                            phase=None, plain: bool = False):
    """Differentiable whole-pose render from repacked slices (bf16 or f32; f32
    is rounded to bf16 here, as the repack rounds), repacked with
    ``vertex_only=tstat.fused``: the fused pipeline reads the vertex stack,
    the v2 pipeline every position. ``generator`` draws the pose's sub-texel
    phase jitter (``draw_phase``); ``phase`` gives it directly. Returns the
    warped RenderOut (colour [H, W, 3], extra)."""
    statics = tstat.statics
    Pn, Qn, PB, Pb = tstat.frame
    dev = slices.device
    if phase is None and generator is not None:
        phase = draw_phase(generator)
    slices = slices.to(torch.bfloat16)
    rot, org, foc = _f32(rotation, dev), _f32(origin, dev), _f32(focal, dev)
    with torch.no_grad():
        geo = gnomonic_geometry(rot, org, statics, tstat.height, tstat.width,
                                foc, tstat.supersample, phase=phase,
                                lite=tstat.fused, skip_basis=False)
        if tstat.fused:
            QB, Qb = _qb_blocks(statics, Qn)
            occupancy = gnomonic_occupancy_lite(slices.detach(), geo.geom, statics,
                                                Pn, Qn, PB, Pb, QB, Qb)
        else:
            occupancy = gnomonic_occupancy(slices.detach(), geo.Ru, statics, PB, Pb,
                                           RvT=geo.RvT, QB=_qb_blocks(statics, Qn)[0])
    if tstat.fused:
        state = composite_positions_fused_diff(
            slices, geo.ybasis, geo.norm, geo.geom, *occupancy, statics, Pn, Qn,
            PB, Pb, plain=plain,
        )
    else:
        t1 = resample_u(slices, geo.Ru)
        state = composite_positions_diff(
            t1, geo.RvT, geo.ybasis, geo.live_u, geo.live_v, geo.norm, geo.geom,
            *occupancy, statics, Pn, Qn, PB, Pb, plain=plain,
        )
    return _warp_to_camera(
        state, geo.xr, geo.yr, rot, statics, tstat.height, tstat.width, foc,
        tstat.supersample, tstat.white_bkgd, warp_order=tstat.warp_order,
        warp_impl=tstat.warp_impl, warp_swap=tstat.warp_swap, plain=plain,
    )


def render_pose_diff(voxel_grid: VoxelGrid, rotation, origin, focal,
                     tstat: GnomonicTrainStatics,
                     generator: Optional[torch.Generator] = None, phase=None,
                     plain: bool = False):
    """Differentiable whole-pose render of the grid (repack +
    ``render_pose_from_slices``)."""
    slices = repack_position_slices(voxel_grid, tstat.statics, vertex_only=tstat.fused)
    return render_pose_from_slices(slices, rotation, origin, focal, tstat,
                                   generator=generator, phase=phase, plain=plain)


def _pose_loss_from_slices(tstat: GnomonicTrainStatics, slices, image, rotation,
                           origin, focal, generator=None, phase=None,
                           plain: bool = False):
    """Whole-pose objective on repacked slices: specular L1 plus, with the
    diffuse regularization, diffuse L1 (the reference trainer's objective).
    Returns (total, metrics) with 0-d tensors."""
    out = render_pose_from_slices(slices, rotation, origin, focal, tstat,
                                  generator=generator, phase=phase, plain=plain)
    image = _f32(image, slices.device)
    colour = out.colour
    specular_loss = torch.mean(torch.abs(colour - image))
    specular_mse = torch.mean((colour - image) ** 2)
    total = specular_loss
    aux = {
        "specular_loss": specular_loss,
        "specular_psnr": mse2psnr(specular_mse),
    }
    if tstat.apply_diffuse_render_regularization:
        diffuse = out.extra[EXTRA_DIFFUSE_COLOUR]
        diffuse_loss = torch.mean(torch.abs(diffuse - image))
        diffuse_mse = torch.mean((diffuse - image) ** 2)
        total = total + diffuse_loss
        aux["diffuse_loss"] = diffuse_loss
        aux["diffuse_psnr"] = mse2psnr(diffuse_mse)
    aux["total_loss"] = total
    return total, aux


def _pose_loss(tstat: GnomonicTrainStatics, grid: VoxelGrid, image, rotation,
               origin, focal, generator=None, phase=None, plain: bool = False):
    """Whole-pose objective on the grid (repack + ``_pose_loss_from_slices``)."""
    slices = repack_position_slices(grid, tstat.statics, vertex_only=tstat.fused)
    return _pose_loss_from_slices(tstat, slices, image, rotation, origin, focal,
                                  generator=generator, phase=phase, plain=plain)


def _step(optimizer, scheduler):
    optimizer.step()
    if scheduler is not None:
        scheduler.step()


def gnomonic_train_step(tstat: GnomonicTrainStatics, optimizer: torch.optim.Optimizer,
                        grid: VoxelGrid, image, rotation, origin, focal,
                        generator: Optional[torch.Generator] = None, *,
                        phase=None, scheduler=None, plain: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """One whole-pose optimization step: the loss's gradient with respect to
    the grid's densities and features, then ``optimizer.step()`` (and
    ``scheduler.step()``) in place. ``generator`` jitters the frame's phase.
    Returns the metrics (0-d tensors)."""
    _strict_f32()
    optimizer.zero_grad(set_to_none=True)
    with grid.trainable():
        loss, aux = _pose_loss(tstat, grid, image, rotation, origin, focal,
                               generator=generator, phase=phase, plain=plain)
        loss.backward()
        _step(optimizer, scheduler)
    return {k: v.detach() for k, v in aux.items()}


def _multi_pose_grads(tstat: GnomonicTrainStatics, grid: VoxelGrid, images,
                      rotations, origins, focal, phases: Sequence,
                      plain: bool = False) -> Dict[str, torch.Tensor]:
    """Averaged gradient of k whole-pose losses into ``grid``'s ``.grad``,
    with the repack hoisted: one f32 repack, each pose's loss differentiated
    with respect to the slices (rounded to bf16 inside the render), the
    per-pose slice cotangents summed in f32, and one repack backward of the
    mean. Above ``_BF16_SLICES_BYTES`` of f32 slices (the vertex stack, or
    the v2 pipeline's stack of every position) the poses read bf16 slices.
    Each pose's graph is freed before the next. Returns the averaged
    metrics."""
    k = len(phases)
    slices_f32 = repack_position_slices(grid, tstat.statics, round_output=False,
                                        vertex_only=tstat.fused)
    big = slices_f32.numel() * slices_f32.element_size() > _BF16_SLICES_BYTES
    leaf = slices_f32.detach()
    if big:
        leaf = leaf.to(torch.bfloat16)
    leaf.requires_grad_(True)
    dsl_sum = torch.zeros_like(slices_f32, dtype=F32)
    sums: Dict[str, torch.Tensor] = {}
    for i in range(k):
        loss, aux = _pose_loss_from_slices(tstat, leaf, images[i], rotations[i],
                                           origins[i], focal, phase=phases[i],
                                           plain=plain)
        (dsl,) = torch.autograd.grad(loss, leaf)
        dsl_sum += dsl.to(F32)
        for name, v in aux.items():
            sums[name] = sums[name] + v.detach() if name in sums else v.detach()
    slices_f32.backward(dsl_sum / k)
    return {name: v / k for name, v in sums.items()}


def gnomonic_train_step_multi(tstat: GnomonicTrainStatics,
                              optimizer: torch.optim.Optimizer, grid: VoxelGrid,
                              images, rotations, origins, focal,
                              generator: Optional[torch.Generator] = None, *,
                              phases=None, scheduler=None, plain: bool = False
                              ) -> Dict[str, torch.Tensor]:
    """One optimization step on the averaged gradient of k whole-pose losses
    (``images`` [k, H, W, 3], ``rotations`` [k, 3, 3], ``origins`` [k, 3], all
    of one march variant), the trainer's step. ``generator`` draws each
    pose's phase jitter in turn (``phases`` [k, 2] gives them directly). The
    optimizer (and scheduler) step in place; returns the averaged metrics."""
    _strict_f32()
    k = len(images)
    if phases is None:
        phases = [None if generator is None else draw_phase(generator)
                  for _ in range(k)]
    optimizer.zero_grad(set_to_none=True)
    with grid.trainable():
        metrics = _multi_pose_grads(tstat, grid, images, rotations, origins,
                                    focal, phases, plain=plain)
        _step(optimizer, scheduler)
    return metrics


def _metric_names(tstat: GnomonicTrainStatics) -> Tuple[str, ...]:
    """The keys of a whole-pose step's metrics, in a fixed order."""
    names = ["specular_loss", "specular_psnr"]
    if tstat.apply_diffuse_render_regularization:
        names += ["diffuse_loss", "diffuse_psnr"]
    return tuple(names + ["total_loss"])


def gnomonic_train_step_mesh(tstat: GnomonicTrainStatics,
                             optimizer: torch.optim.Optimizer, n_dev: int,
                             grid: VoxelGrid, images, rotations, origins, focal, *,
                             phases=None, scheduler=None) -> Dict[str, torch.Tensor]:
    """The pose-parallel step over ``n_dev`` ranks of the default group:
    rank r < n_dev passes its own k views (``images`` [k, H, W, 3],
    ``rotations`` [k, 3, 3], ``origins`` [k, 3], all of one march variant,
    the same on every rank), accumulates their averaged gradient as
    ``gnomonic_train_step_multi`` does (the hoisted repack), and the grid
    gradient and the metrics are all-reduced and divided by n_dev, so one
    step averages n_dev * k whole-pose gradients; then the same Adam step on
    every rank, which keeps the replicated grids bit-identical. A rank at or
    beyond n_dev (a mesh narrower than the world) adds zeros and is not
    counted in the average. ``phases`` [k, 2] are this rank's phase jitter
    (the trainer draws every rank's alike and hands each its own; the JAX
    package folds its key with the rank); None renders without jitter.
    Raises without a process group or when the world has fewer than n_dev
    ranks. Returns the averaged metrics."""
    import torch.distributed as dist

    from thr3ed_atom_tpu_torch.parallel.mesh import all_reduce_

    _strict_f32()
    if not dist.is_initialized():
        raise RuntimeError("gnomonic_train_step_mesh needs an initialized process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world < n_dev:
        raise RuntimeError(f"gnomonic_train_step_mesh: {n_dev} ranks asked, the world has {world}")
    active = rank < n_dev
    if active and phases is None:
        phases = [None] * len(images)
    optimizer.zero_grad(set_to_none=True)
    names = _metric_names(tstat)
    with grid.trainable():
        if active:
            metrics = _multi_pose_grads(tstat, grid, images, rotations, origins, focal,
                                        phases)
        else:
            metrics = {}
        for p in (grid.densities, grid.features):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        zero = torch.zeros((), dtype=F32, device=grid.device)
        stacked = torch.stack([metrics.get(name, zero).to(F32) for name in names])
        all_reduce_([grid.densities.grad, grid.features.grad, stacked])
        n = torch.full((), float(n_dev), dtype=F32, device=grid.device)
        for p in (grid.densities, grid.features):
            p.grad.div_(n)
        stacked = stacked / n
        _step(optimizer, scheduler)
    return {name: stacked[i] for i, name in enumerate(names)}
