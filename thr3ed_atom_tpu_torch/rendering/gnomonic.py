"""Gnomonic shear-warp renderer: the serving path of the port.

Counterpart of thr3ed_atom_tpu/rendering/gnomonic.py. Per pose, in the fused
(v3) pipeline (``qb`` > 0, the default):

  1. the pose's dominant march axis selects a "virtual axis-aligned camera"
     whose texel (p, q) is the ray ``D = g*e_axis + x_p*e_u + y_q*e_v``; every
     such ray crosses march position j at in-plane grid coordinates that are
     affine in (p, q): ``U = bu + ku*p``, ``V = bv + kv*q``
     (``gnomonic_geometry``);
  2. ``repack_position_slices`` turns the grid into bf16 vertex slices along
     the march axis, once per march variant (cached);
  3. ``gnomonic_occupancy_lite`` flags the (128 x qb texel block, position)
     pairs whose cells can hold density — a lossless skip rule;
  4. ``composite_positions_fused`` (CUDA kernel csrc/composite_fused.cu)
     lerps interior positions, resamples each slice to the texels with the
     two tents (bf16 where the reference rounds), folds the SH basis and
     composites front to back with the relu-trapezoid cell integral;
  5. ``warp_state_matmul`` (rendering/warp_matmul.py, CUDA kernel
     csrc/resample_rows.cu) resamples the composited texel image to the
     camera's pixels in two scanline passes.

``gnomonic_qb=0`` selects the v2 stripe pipeline instead (whole-height
stripes): the repack interleaves the interior positions (one bf16 stack of
every position), ``gnomonic_geometry(lite=False)`` builds the per-position
tents ``Ru`` / ``RvT`` and liveness, ``resample_u`` u-resamples the stack with
a bf16 matmul (t1), ``gnomonic_occupancy`` flags (128-row block, position)
pairs, and ``composite_positions`` (CUDA kernel csrc/composite_stripe.cu)
v-resamples t1 through the tents, folds the SH basis and composites; the same
warp follows. Both pipelines use one texel frame (Pb = 128).

The training path (rendering/gnomonic_train.py) runs the same stages with the
materialized SH basis and norm (``gnomonic_geometry(skip_basis=False)``) as
operands of the composite, and a sub-texel phase shift of the frame. Its
``fused=False`` with qb > 0 runs the v2 pipeline on a q-block grain: [PB, QB,
NP] flags (``gnomonic_occupancy(..., RvT=, QB=)``) and
``composite_positions_qb`` (K6: csrc/composite_stripe.cu with QB > 1).

The warp takes order 1 (bilinear), 3 (Catmull-Rom, the default) or 5 (the
prefiltered cubic B-spline: ``bspline_prefilter``, the reference's IIR
prefilter as one product with its [n, n] matrix), in two forms:
``gnomonic_warp_impl`` "matmul" (= "auto") or "gather", the per-pixel
gather warp (``_warp_gather``). Flat ray batches through the procedure
object go to the fast two-phase renderer (rendering/fast_renderer.py), as
the JAX package routes them.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from thr3ed_atom_tpu_torch import kernels
from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid
from thr3ed_atom_tpu_torch.ops.relu_trap import relu_trap_plain
from thr3ed_atom_tpu_torch.ops.sh import C0 as _C0, C1 as _C1, C2 as _C2, C3 as _C3
from thr3ed_atom_tpu_torch.rendering.axes import _uv_axes, dominant_axis_for_pose
from thr3ed_atom_tpu_torch.rendering.fast_renderer import FlatRaysToFast
from thr3ed_atom_tpu_torch.rendering.interface import RenderOut
from thr3ed_atom_tpu_torch.utils.constants import (
    EXTRA_ACCUMULATED_WEIGHTS,
    EXTRA_DIFFUSE_COLOUR,
    EXTRA_DISPARITY,
    ZERO_PLUS,
)

F32 = torch.float32

# the CUDA composite's texel tile (p rows x q columns): one thread per texel,
# the grain of its early exit and of its staged vertex footprints
# (csrc/gnomonic_march.cuh TP, TQ)
CUDA_EXIT_TILE = (8, 32)


class GnomonicStatics(NamedTuple):
    """Per-variant constants of one gnomonic render program."""

    dims: Tuple[int, int, int]
    aabb: Tuple[Tuple[float, float], Tuple[float, float], Tuple[float, float]]
    axis: int
    flip: bool
    ncoeff: int
    relu_sigma: bool
    with_diffuse: bool
    pos_per_cell: int
    # early exit: a texel tile stops marching once every texel's
    # transmittance is at most this (0 disables)
    exit_eps: float = 0.0
    # q-block width of the occupancy flags, in texels (multiple of 128); 0
    # selects the v2 stripe pipeline (whole-height stripes)
    qb: int = 128


def statics_for_grid(
    voxel_grid: VoxelGrid,
    axis: int,
    flip: bool,
    *,
    with_diffuse: bool = False,
    pos_per_cell: int = 0,
    exit_eps: float = 0.0,
    qb: int = 128,
) -> GnomonicStatics:
    num_features = voxel_grid.num_features
    if num_features % 3 != 0:
        raise ValueError("SH feature count must be 3 * (degree + 1)^2")
    ncoeff = num_features // 3
    if ncoeff not in (1, 4, 9, 16):
        raise ValueError("gnomonic renderer supports SH degree <= 3")
    post = voxel_grid.density_postactivation
    if post not in ("identity", "relu"):
        raise ValueError(
            f"gnomonic renderer supports identity/relu density postactivation, got {post}"
        )
    if voxel_grid.feature_postactivation != "identity":
        raise ValueError("gnomonic renderer needs an identity feature postactivation")
    if qb < 0 or qb % 128 != 0:
        raise ValueError("gnomonic qb must be 0 or a positive multiple of 128")
    dims = voxel_grid.grid_dims
    if pos_per_cell == 0:
        # AUTO: ~256 positions across the grid (32^3 -> 8, 128^3 -> 2, 256^3 -> 1)
        n_cells = dims[axis] - 1
        pos_per_cell = max(1, min(8, 2 ** round(math.log2(max(1.0, 256 / n_cells)))))
    if pos_per_cell not in (1, 2, 4, 8):
        raise ValueError(f"pos_per_cell must be 1, 2, 4 or 8, got {pos_per_cell}")
    return GnomonicStatics(
        dims=tuple(dims),
        aabb=tuple((float(lo), float(hi)) for (lo, hi) in voxel_grid.aabb),
        axis=axis,
        flip=bool(flip),
        ncoeff=int(ncoeff),
        relu_sigma=(post == "relu"),
        with_diffuse=bool(with_diffuse),
        pos_per_cell=int(pos_per_cell),
        exit_eps=float(exit_eps),
        qb=int(qb),
    )


def _num_positions(statics: GnomonicStatics) -> int:
    return (statics.dims[statics.axis] - 1) * statics.pos_per_cell + 1


def _padded_channels(statics: GnomonicStatics) -> int:
    nf = 3 * statics.ncoeff + 1
    return -(-nf // 8) * 8  # 4 -> 8, 13 -> 16, 28 -> 32


def _sprows(with_diffuse: bool) -> int:
    # state rows: [T, colR, colG, colB, acc, dep, (difR, difG, difB)]
    return 9 if with_diffuse else 6


# ------------------------------------------------------------------ grid repack


def repack_position_slices(voxel_grid: VoxelGrid, statics: GnomonicStatics,
                           round_output: bool = True,
                           vertex_only: bool = True) -> torch.Tensor:
    """The vertex slices [nvert, nu, C, nv] front to back along the march axis
    (pre-activated, C = 3*ncoeff + 1 padded to a multiple of 8), bf16 unless
    ``round_output`` is False. The fused composite lerps interior quadrature
    positions itself, so only the vertex stack exists; its storage is
    channel-last: a permuted view of a contiguous [nvert, nu, nv, C] tensor,
    the layout the CUDA composite gathers from (one 16-byte load per 8
    channels).

    ``vertex_only=False`` (the v2 stripe pipeline) returns every position
    [NP, nu, C, nv], contiguous: the interior ones lerped from the two
    neighbouring vertex slices in f32, rounded once at the end. The values are
    the JAX package's either way."""
    axis = statics.axis
    u_ax, v_ax = _uv_axes(axis)
    pre_densities, pre_features = voxel_grid.activated_grids()
    unified = torch.cat([pre_features, pre_densities], dim=-1)
    C = _padded_channels(statics)
    unified = F.pad(unified, (0, C - unified.shape[-1]))
    out_dtype = torch.bfloat16 if round_output else F32
    if not vertex_only:
        slices = unified.permute(axis, u_ax, 3, v_ax)  # [nvert, nu, C, nv]
        if statics.flip:
            slices = torch.flip(slices, dims=(0,))
        P = statics.pos_per_cell
        if P > 1:
            lo, hi = slices[:-1], slices[1:]
            subs = [lo] + [(1.0 - k / P) * lo + (k / P) * hi for k in range(1, P)]
            inter = torch.stack(subs, dim=1).reshape((-1,) + tuple(slices.shape[1:]))
            slices = torch.cat([inter, slices[-1:]], dim=0)
        return slices.to(out_dtype).contiguous()
    slices = unified.permute(axis, u_ax, v_ax, 3)  # [nvert, nu, nv, C]
    if statics.flip:
        slices = torch.flip(slices, dims=(0,))
    # one copy into contiguous [nvert, nu, nv, C]; a same-dtype .to() would
    # return the permuted view itself
    if slices.dtype == out_dtype:
        slices = slices.contiguous()
    else:
        slices = slices.to(out_dtype, memory_format=torch.contiguous_format)
    return slices.permute(0, 1, 3, 2)


# ------------------------------------------------------------------ geometry


def frame_rounding(height: int, width: int, supersample: float,
                   statics: GnomonicStatics):
    """Texel-grid rounding (128-multiples in u and v) and channel padding:
    (Pn_raw, Qn, nv, C)."""
    Pn_raw = -(-int(math.ceil(width * supersample)) // 128) * 128
    Qn = -(-int(math.ceil(height * supersample)) // 128) * 128
    _, v_ax = _uv_axes(statics.axis)
    nv = statics.dims[v_ax]
    C = _padded_channels(statics)
    return Pn_raw, Qn, nv, C


def gnomonic_frame(rotation, height: int, width: int, focal: float,
                   supersample: float, statics: GnomonicStatics):
    """(Pn, Qn, PB, Pb): the texel grid and its u-blocking into Pb = 128 rows
    (the grain of the occupancy flags)."""
    del rotation, focal
    Pn_raw, Qn, _, _ = frame_rounding(height, width, supersample, statics)
    Pb = 128
    PB = -(-Pn_raw // Pb)
    return PB * Pb, Qn, PB, Pb


def _qb_blocks(statics: GnomonicStatics, Qn: int) -> Tuple[int, int]:
    """(QB, Qb): QB q-blocks of Qb texels (one block when qb does not divide Qn)."""
    qb = statics.qb
    if qb <= 0 or Qn <= qb or Qn % qb != 0:
        return 1, Qn
    return Qn // qb, qb


def _corner_ranges(rotation, height, width, focal, statics):
    """Gnomonic (x, y) ranges of the image corners."""
    axis, (u_ax, v_ax) = statics.axis, _uv_axes(statics.axis)
    g = -1.0 if statics.flip else 1.0
    dev = rotation.device
    cx = torch.tensor([0.0, width, 0.0, width], dtype=F32, device=dev)
    cy = torch.tensor([0.0, 0.0, height, height], dtype=F32, device=dev)
    dirs_cam = torch.stack(
        [(cx - width / 2) / focal, -(cy - height / 2) / focal,
         -torch.ones(4, dtype=F32, device=dev)], dim=-1,
    )
    d = torch.matmul(dirs_cam, rotation.T)
    x_c = g * d[:, u_ax] / d[:, axis]
    y_c = g * d[:, v_ax] / d[:, axis]
    return (x_c.min(), x_c.max()), (y_c.min(), y_c.max())


class GnomonicGeometry(NamedTuple):
    """Per-pose operands of the march."""

    geom: torch.Tensor  # [NP, 8] f32: s_j, cell_step, bu, ku, bv, kv, 0, 0
    xr: Tuple[torch.Tensor, torch.Tensor]  # gnomonic x range of the frame
    yr: Tuple[torch.Tensor, torch.Tensor]
    ybasis: Optional[torch.Tensor] = None  # [ncoeff, Pn, Qn] f32 (skip_basis=False)
    norm: Optional[torch.Tensor] = None  # [Pn, Qn] f32 (skip_basis=False)
    # the v2 stripe pipeline's per-position tents and liveness (lite=False)
    Ru: Optional[torch.Tensor] = None  # [NP, Pn, nu] bf16 u-axis tent weights
    RvT: Optional[torch.Tensor] = None  # [NP, nv, Qn] bf16 v-axis tent weights
    live_u: Optional[torch.Tensor] = None  # [NP, Pn, 1] f32
    live_v: Optional[torch.Tensor] = None  # [NP, 1, Qn] f32


def gnomonic_geometry(
    rotation, origin, statics: GnomonicStatics, height: int, width: int,
    focal, supersample: float, phase=None, lite: bool = True,
    skip_basis: bool = True,
) -> GnomonicGeometry:
    """The affine texel -> grid coefficients of every position and the frame's
    ranges. ``rotation`` [3, 3], ``origin`` [3] and ``focal`` (0-d) are f32
    tensors on the render device; arithmetic follows the JAX reference's
    order in f32. ``phase`` (two numbers in [-0.5, 0.5], texel units) shifts
    the whole texel frame sub-texel, which the warp compensates exactly (the
    training path's jitter); ``skip_basis=False`` also materializes the SH
    basis and norm of every texel direction (the training operands), and
    ``lite=False`` the v2 pipeline's per-position tents and liveness from
    ``U = a_u + (s_j su) xs`` (the reference's v2 formula, which rounds
    differently from the fused kernels' ``bu + ku p``)."""
    axis = statics.axis
    u_ax, v_ax = _uv_axes(axis)
    g = -1.0 if statics.flip else 1.0
    P = statics.pos_per_cell
    aabb, dims = statics.aabb, statics.dims
    NP = _num_positions(statics)
    dev = rotation.device
    Pn, Qn, _PB, _Pb = gnomonic_frame(None, height, width, focal, supersample,
                                      statics)
    lo_a, hi_a = aabb[axis]
    cell_a = (hi_a - lo_a) / dims[axis]
    su = dims[u_ax] / (aabb[u_ax][1] - aabb[u_ax][0])
    sv = dims[v_ax] / (aabb[v_ax][1] - aabb[v_ax][0])

    (x0, x1), (y0, y1) = _corner_ranges(rotation, height, width, focal, statics)
    mx = _div(x1 - x0, Pn)
    my = _div(y1 - y0, Qn)
    x0, x1 = x0 - mx, x1 + mx
    y0, y1 = y0 - my, y1 + my
    if phase is not None:
        dxt = mx * torch.as_tensor(phase[0], dtype=F32, device=dev)
        dyt = my * torch.as_tensor(phase[1], dtype=F32, device=dev)
        x0, x1 = x0 + dxt, x1 + dxt
        y0, y1 = y0 + dyt, y1 + dyt

    ybasis = norm = None
    xs = x0 + _div((x1 - x0) * torch.arange(Pn, dtype=F32, device=dev), Pn - 1)
    ys = y0 + _div((y1 - y0) * torch.arange(Qn, dtype=F32, device=dev), Qn - 1)
    if not skip_basis:
        norm = torch.sqrt(1.0 + xs[:, None] ** 2 + ys[None, :] ** 2)
        comp = [None, None, None]
        comp[u_ax] = xs[:, None] / norm
        comp[v_ax] = ys[None, :].expand(Pn, Qn) / norm
        comp[axis] = g / norm
        ybasis = _ybasis_rows(comp[0], comp[1], comp[2], statics.ncoeff)

    j = torch.arange(NP, dtype=F32, device=dev)
    c_j = (NP - 1 - j) / P if statics.flip else j / P
    w_j = lo_a + (c_j + 0.5) * cell_a
    s_j = (w_j - origin[axis]) / g

    a_u = (origin[u_ax] - aabb[u_ax][0]) * su - 0.5
    a_v = (origin[v_ax] - aabb[v_ax][0]) * sv - 0.5
    tents = {}
    if not lite:
        nu, nv = dims[u_ax], dims[v_ax]
        U = a_u + (s_j[:, None] * su) * xs[None, :]  # [NP, Pn]
        V = a_v + (s_j[:, None] * sv) * ys[None, :]  # [NP, Qn]

        def tent(pos, n):
            idx = torch.arange(n, dtype=F32, device=dev)
            return torch.clamp_min(1.0 - torch.abs(pos[..., None] - idx), 0.0)

        tents = dict(
            Ru=tent(U, nu).to(torch.bfloat16),
            RvT=tent(V, nv).transpose(1, 2).to(torch.bfloat16).contiguous(),
            live_u=((U >= -0.5) & (U <= nu - 0.5) & (s_j[:, None] > 0.0)).to(F32)[..., None],
            live_v=((V >= -0.5) & (V <= nv - 0.5)).to(F32)[:, None, :],
        )
    cell_step = torch.full((NP,), cell_a / P, dtype=F32, device=dev)
    bu = a_u + (s_j * su) * x0
    ku = (s_j * su) * _div(x1 - x0, Pn - 1)
    bv = a_v + (s_j * sv) * y0
    kv = (s_j * sv) * _div(y1 - y0, Qn - 1)
    zeros = torch.zeros_like(s_j)
    geom = torch.stack([s_j, cell_step, bu, ku, bv, kv, zeros, zeros], dim=-1)
    return GnomonicGeometry(geom=geom, xr=(x0, x1), yr=(y0, y1),
                            ybasis=ybasis, norm=norm, **tents)


def resample_u(slices: torch.Tensor, Ru: torch.Tensor) -> torch.Tensor:
    """The v2 pipeline's u-resample of every position, t1 [NP, C, Pn, nv]
    bf16: one bf16 matmul per position (f32 sums rounded once, as the
    reference's preferred_element_type=bf16 einsum; on the card
    ``_strict_f32`` keeps cuBLAS from rounding partial sums to bf16). Its
    gradient is autograd's, the transposed matmul."""
    return torch.einsum("jpu,jucv->jcpv", Ru, slices.to(torch.bfloat16))


def use_fused_composite(statics: GnomonicStatics) -> bool:
    """The fused (v3) pipeline serves ``qb`` > 0, the v2 stripe pipeline
    ``qb`` = 0. The CUDA kernels have no lane rule (on the TPU the JAX package
    also sends grids with nv % 128 != 0 to v2). Callers repack with
    ``vertex_only=`` this value."""
    return statics.qb > 0


def gnomonic_occupancy(slices, Ru, statics: GnomonicStatics, PB: int, Pb: int,
                       RvT=None, QB: int = 1):
    """The v2 pipeline's exact-zero skip flags per (u-block[, q-block],
    position): (cell_live, pos_needed), both [PB, NP] int32 for the stripe
    kernel (QB = 1) or [PB, QB, NP] for the q-split kernel (pass the v-tents
    ``RvT`` and ``QB``). A block is live at position j when a tent tap of one
    of its texel rows reaches a grid column u (and, q-split, a tap of one of
    its texel columns a grid row v) that holds a positive density (the
    reference's rule; every grain is lossless). ``slices`` is the position
    stack [NP, nu, C, nv]."""
    NP = slices.shape[0]
    sig = slices[:, :, 3 * statics.ncoeff, :]  # [NP, nu, nv] pre-relu density
    sup = (Ru > 0).to(F32).reshape(NP, PB, Pb, -1).sum(dim=2)  # [NP, PB, nu]
    if QB == 1:
        col_live = (sig.amax(dim=-1) > 0.0).to(F32)  # [NP, nu]
        slab_live = (torch.einsum("jbu,ju->jb", sup, col_live) > 0.0).to(torch.int32)
    else:
        nv = sig.shape[-1]
        Qb = RvT.shape[-1] // QB
        sup_v = (RvT > 0).to(F32).reshape(NP, nv, QB, Qb).sum(dim=3)  # [NP, nv, QB]
        uq = torch.einsum("juv,jvq->juq", (sig > 0.0).to(F32), sup_v)  # [NP, nu, QB]
        slab_live = (torch.einsum("jbu,juq->jbq", sup, uq) > 0.0).to(torch.int32)
    zero = torch.zeros((1,) + tuple(slab_live.shape[1:]), dtype=torch.int32,
                       device=slab_live.device)
    prev_l = torch.cat([zero, slab_live[:-1]], 0)
    next_l = torch.cat([slab_live[1:], zero], 0)
    perm = (1, 0) if QB == 1 else (1, 2, 0)
    cell_live = (prev_l | slab_live).permute(*perm).contiguous()
    pos_needed = (prev_l | slab_live | next_l).permute(*perm).contiguous()
    return cell_live, pos_needed


def gnomonic_occupancy_lite(slices, geom, statics: GnomonicStatics, Pn: int,
                            Qn: int, PB: int, Pb: int, QB: int, Qb: int):
    """Exact-zero skip flags from the affine geom scalars: a (u-block, q-block,
    position) is live iff some density > 0 lies inside the rectangle of grid
    columns the block's tent taps can reach. Returns (cell_live, pos_needed,
    pos_any): [PB, QB, NP], [PB, QB, NP], [PB, NP] int32.

    ``slices`` is the vertex stack [nvert, nu, C, nv]; an interior position's
    density sign is bounded by the union of its two endpoint planes."""
    NP = _num_positions(statics)
    nu, nv = slices.shape[1], slices.shape[3]
    P = statics.pos_per_cell
    dev = geom.device
    sigv = slices[:, :, 3 * statics.ncoeff, :]  # [nvert, nu, nv] pre-relu
    sigv_pos = (sigv > 0.0).to(F32)
    if P == 1:
        sig_pos = sigv_pos
    else:
        idx = np.arange(NP)
        ia = torch.as_tensor(idx // P, device=dev)
        ib = torch.as_tensor(np.minimum(idx // P + 1, slices.shape[0] - 1), device=dev)
        interior = torch.as_tensor((idx % P) > 0, dtype=F32, device=dev)[:, None, None]
        sig_pos = torch.maximum(sigv_pos[ia], interior * sigv_pos[ib])
    bu, ku = geom[:, 2], geom[:, 3]
    bv, kv = geom[:, 4], geom[:, 5]

    def interval_mask(b, k, n_blocks, blk, n_idx):
        # [NP, n_blocks, n_idx] mask of indices within the blocks' tent reach
        p0 = torch.arange(n_blocks, dtype=F32, device=dev) * blk
        p1 = p0 + (blk - 1)
        e0 = b[:, None] + k[:, None] * p0[None, :]
        e1 = b[:, None] + k[:, None] * p1[None, :]
        lo = torch.minimum(e0, e1) - 1.0
        hi = torch.maximum(e0, e1) + 1.0
        idx_f = torch.arange(n_idx, dtype=F32, device=dev)
        return ((idx_f[None, None, :] >= lo[..., None])
                & (idx_f[None, None, :] <= hi[..., None])).to(F32)

    umask = interval_mask(bu, ku, PB, Pb, nu)  # [NP, PB, nu]
    vmask = interval_mask(bv, kv, QB, Qb, nv)  # [NP, QB, nv]
    uq = torch.einsum("juv,jqv->juq", sig_pos, vmask)
    slab_live = (torch.einsum("jbu,juq->jbq", umask, uq) > 0.0).to(torch.int32)
    zero = torch.zeros((1, PB, QB), dtype=torch.int32, device=dev)
    prev_l = torch.cat([zero, slab_live[:-1]], 0)
    next_l = torch.cat([slab_live[1:], zero], 0)
    cell_live = (prev_l | slab_live).permute(1, 2, 0).contiguous()
    pos_needed = (prev_l | slab_live | next_l).permute(1, 2, 0).contiguous()
    pos_any = (pos_needed.sum(dim=1) > 0).to(torch.int32)  # [PB, NP]
    return cell_live, pos_needed, pos_any


def _ybasis_rows(x_, y_, z_, ncoeff):
    """SH basis values of the texel directions, stacked [ncoeff, Pn, Qn]."""
    rows = [_C0 * torch.ones_like(x_)]
    if ncoeff > 1:
        rows += [-_C1 * y_, _C1 * z_, -_C1 * x_]
    if ncoeff > 4:
        rows += [
            _C2[0] * x_ * y_,
            _C2[1] * y_ * z_,
            _C2[2] * (2.0 * z_ * z_ - x_ * x_ - y_ * y_),
            _C2[3] * x_ * z_,
            _C2[4] * (x_ * x_ - y_ * y_),
        ]
    if ncoeff > 9:
        xx, yy, zz = x_ * x_, y_ * y_, z_ * z_
        rows += [
            _C3[0] * y_ * (3.0 * xx - yy),
            _C3[1] * x_ * y_ * z_,
            _C3[2] * y_ * (4.0 * zz - xx - yy),
            _C3[3] * z_ * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x_ * (4.0 * zz - xx - yy),
            _C3[5] * z_ * (xx - yy),
            _C3[6] * x_ * (xx - 3.0 * yy),
        ]
    return torch.stack(rows, dim=0)


# ------------------------------------------------------------ fused composite


def _div(x: torch.Tensor, n) -> torch.Tensor:
    """x / n with a true f32 division: on CUDA, x / <python number> multiplies
    by the f32 reciprocal, which rounds differently from the reference."""
    return x / torch.full((), float(n), dtype=x.dtype, device=x.device)


def _bf16r(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(F32)


def _tent_taps(pos: torch.Tensor, n: int):
    """The two non-zero taps of the tent max(0, 1 - |pos - k|) over k in [0, n):
    clamped indices and bf16-rounded weights, zero where the tap lies outside."""
    k0 = torch.floor(pos)
    k1 = k0 + 1.0
    w0 = _bf16r(torch.clamp_min(1.0 - torch.abs(pos - k0), 0.0))
    w1 = _bf16r(torch.clamp_min(1.0 - torch.abs(pos - k1), 0.0))
    w0 = torch.where((k0 >= 0) & (k0 <= n - 1), w0, 0.0)
    w1 = torch.where((k1 >= 0) & (k1 <= n - 1), w1, 0.0)
    i0 = k0.clamp(0, n - 1).long()
    i1 = k1.clamp(0, n - 1).long()
    return i0, i1, w0, w1


def _texel_basis_plain(ybasis, norm, xr, yr, statics: GnomonicStatics, Pn: int,
                       Qn: int, dev):
    """(yb [ncoeff, Pn, Qn], nm [Pn, Qn]): the materialized operands, or built
    from the frame ranges as the kernel's serving branch builds them."""
    if ybasis is not None and norm is not None:
        return ybasis, norm
    if xr is None or yr is None:
        raise ValueError("the composite needs ybasis and norm, or xr and yr")
    u_ax, v_ax = _uv_axes(statics.axis)
    g = -1.0 if statics.flip else 1.0
    x0, x1 = xr
    y0, y1 = yr
    pf = torch.arange(Pn, dtype=F32, device=dev)
    qf = torch.arange(Qn, dtype=F32, device=dev)
    xs = (x0 + pf * _div(x1 - x0, Pn - 1))[:, None].expand(Pn, Qn)
    ys = (y0 + qf * _div(y1 - y0, Qn - 1))[None, :].expand(Pn, Qn)
    nm = torch.sqrt(1.0 + xs * xs + ys * ys)
    comp = [None, None, None]
    comp[u_ax] = xs / nm
    comp[v_ax] = ys / nm
    comp[statics.axis] = g / nm
    return _ybasis_rows(comp[0], comp[1], comp[2], statics.ncoeff), nm


def _position_values(slices_u, geom, j: int, statics: GnomonicStatics, yb):
    """Position j's values over the whole frame, as csrc/gnomonic_march.cuh
    computes them per texel: (sig, rgb [3], dif [3], live), each [Pn, Qn].
    ``slices_u`` is the vertex stack's used channels [nvert, nu, used, nv]."""
    nvert, nu, _, nv = slices_u.shape
    P = statics.pos_per_cell
    nc = statics.ncoeff
    Pn, Qn = yb.shape[1:]
    dev = slices_u.device
    pf = torch.arange(Pn, dtype=F32, device=dev)
    qf = torch.arange(Qn, dtype=F32, device=dev)
    s_j, _, bu, ku, bv, kv = geom[j, :6]
    U = bu + ku * pf  # [Pn]
    V = bv + kv * qf  # [Qn]
    live = (((U >= -0.5) & (U <= nu - 0.5) & (s_j > 0.0))[:, None]
            & ((V >= -0.5) & (V <= nv - 0.5))[None, :]).to(F32)

    ia = min(j // P, nvert - 1)
    sl = slices_u[ia].to(F32)  # [nu, used, nv]
    if P > 1:
        f = (j % P) * (1.0 / P)
        ib = min(j // P + 1, nvert - 1)
        sl = _bf16r((1.0 - f) * sl + f * slices_u[ib].to(F32))
    u0, u1, wu0, wu1 = _tent_taps(U, nu)
    t1 = _bf16r(wu0[:, None, None] * sl[u0] + wu1[:, None, None] * sl[u1])
    v0, v1, wv0, wv1 = _tent_taps(V, nv)
    val = wv0 * t1[:, :, v0] + wv1 * t1[:, :, v1]  # [Pn, used, Qn]
    val = val.permute(1, 0, 2)

    sig = val[3 * nc]
    rgb = []
    for c in range(3):
        a = yb[0] * val[c * nc]
        for k in range(1, nc):
            a = a + yb[k] * val[c * nc + k]
        rgb.append(a)
    dif = [yb[0] * val[c * nc] for c in range(3)]
    return sig, rgb, dif, live


def _flag_blocks(flags, Pb: int, Qb: int):
    """[PB, QB] block flags -> [Pn, Qn] bool per texel."""
    return (flags > 0).repeat_interleave(Pb, 0).repeat_interleave(Qb, 1)


def _texel_flags(flags, j: int, Pb: int, Qn: int):
    """Position j's block flags -- [PB, QB, NP] (fused) or [PB, NP] (stripe)
    -- as a [Pn, Qn] bool mask."""
    fl = flags[..., j]
    if fl.dim() == 1:
        fl = fl[:, None]
    return _flag_blocks(fl, Pb, Qn // fl.shape[1])


def _march_plain(values, geom, nm, occupancy, statics: GnomonicStatics, Pn: int,
                 Qn: int, Pb: int, exit_tile, return_work: bool):
    """The front-to-back march of the plain composites over the whole frame:
    ``values(j)`` gives position j's (sig, rgb [3], dif [3], live), each
    [Pn, Qn]; flags gate the work per block, the early exit per
    ``exit_tile`` (rows, cols) tile. Returns the state [SROWS, Pn, Qn] (and
    the marched mask [NP, Pn, Qn] with ``return_work``)."""
    NP = geom.shape[0]
    cell_live, pos_needed = occupancy[0], occupancy[1]
    dev = geom.device
    ep, eq = exit_tile
    zeros = torch.zeros((Pn, Qn), dtype=F32, device=dev)
    T = torch.ones((Pn, Qn), dtype=F32, device=dev)
    col = [zeros] * 3
    dif = [zeros] * 3
    acc = dep = zeros
    prev_sig = prev_live = zeros
    prev_rgb = [zeros] * 3
    prev_dif = [zeros] * 3
    marched = []
    for j in range(NP):
        work = _texel_flags(pos_needed, j, Pb, Qn)
        if statics.exit_eps > 0.0:
            tmax = T.reshape(Pn // ep, ep, Qn // eq, eq).amax(dim=(1, 3))
            running = tmax > statics.exit_eps
            work = work & running.repeat_interleave(ep, 0).repeat_interleave(eq, 1)
        if return_work:
            marched.append(work)
        s_j, cell_step = geom[j, 0], geom[j, 1]
        sig, rgb, dif_j, live = values(j)

        if j > 0:
            upd = work & _texel_flags(cell_live, j, Pb, Qn)
            integ, tbar, _, _ = relu_trap_plain(prev_sig, sig, statics.relu_sigma)
            integ = integ * (prev_live * live)
            delta = cell_step * nm
            alpha = 1.0 - torch.exp(-integ * delta)
            w = alpha * T
            s_mid = (s_j - cell_step + tbar * cell_step) * nm
            tb1 = 1.0 - tbar
            col = [torch.where(upd, col[c] + torch.sigmoid(
                tb1 * prev_rgb[c] + tbar * rgb[c]) * w, col[c]) for c in range(3)]
            acc = torch.where(upd, acc + w, acc)
            dep = torch.where(upd, dep + w * s_mid, dep)
            if statics.with_diffuse:
                dif = [torch.where(upd, dif[c] + torch.sigmoid(
                    tb1 * prev_dif[c] + tbar * dif_j[c]) * w, dif[c])
                    for c in range(3)]
            T = torch.where(upd, T * (1.0 - alpha), T)

        prev_sig = torch.where(work, sig, prev_sig)
        prev_rgb = [torch.where(work, rgb[c], prev_rgb[c]) for c in range(3)]
        prev_dif = [torch.where(work, dif_j[c], prev_dif[c]) for c in range(3)]
        prev_live = torch.where(work, live, prev_live)

    rows = [T, *col, acc, dep] + (dif if statics.with_diffuse else [])
    state = torch.stack(rows, dim=0)
    return (state, torch.stack(marched)) if return_work else state


def composite_positions_fused_plain(slices, ybasis, norm, geom, statics, Pn,
                                    Qn, PB, Pb, occupancy, xr=None, yr=None,
                                    exit_tile=None, return_work=False):
    """Plain PyTorch version of the fused composite (the TPU kernel
    thr3ed_atom_tpu/rendering/gnomonic.py composite_positions_fused). Marches
    the whole frame position by position with the reference's roundings: the
    lerped slice, the u-tent and the u-resample round to bf16, the v-resample
    sums in f32; both tents have two taps, so the gather form equals the
    reference's tent matmuls exactly. The SH basis and norm are the
    ``ybasis`` [ncoeff, Pn, Qn] / ``norm`` [Pn, Qn] operands (training), or
    are built from the frame ranges ``xr`` / ``yr`` (serving).

    ``exit_tile`` (rows, cols) is the early exit's grain: the JAX kernel's
    (Pb, Qb) by default, ``CUDA_EXIT_TILE`` to reproduce the CUDA kernel.
    ``return_work`` also returns which (position, texel) pairs were marched,
    a [NP, Pn, Qn] bool tensor.
    Returns the state [SROWS, Pn, Qn] f32."""
    _, Qb = _qb_blocks(statics, Qn)
    yb, nm = _texel_basis_plain(ybasis, norm, xr, yr, statics, Pn, Qn, slices.device)
    slices_u = slices[:, :, :3 * statics.ncoeff + 1, :]
    return _march_plain(lambda j: _position_values(slices_u, geom, j, statics, yb),
                        geom, nm, occupancy, statics, Pn, Qn, Pb,
                        exit_tile or (Pb, Qb), return_work)


def _vertex_stack(slices, statics: GnomonicStatics, Pn: int, Qn: int, PB: int,
                  Pb: int, what: str) -> torch.Tensor:
    """The [nvert, nu, nv, C] storage of ``slices`` that the CUDA composites
    gather from, after checking what they need of it and of the frame: bf16,
    channel-last storage (as ``repack_position_slices`` returns it), the padded
    channel count, 16-byte alignment, and texel tiles inside the flag blocks."""
    vert = slices.permute(0, 1, 3, 2)
    if slices.dtype != torch.bfloat16 or not vert.is_contiguous():
        raise ValueError(f"{what}: bf16 slices with channel-last storage required "
                         "(repack_position_slices returns them so)")
    if slices.shape[2] != _padded_channels(statics) or vert.data_ptr() % 16 != 0:
        raise ValueError(f"{what}: slices channels/alignment")
    QB, Qb = _qb_blocks(statics, Qn)
    TP, TQ = CUDA_EXIT_TILE
    if PB * Pb != Pn or QB * Qb != Qn or Pb % TP or Qb % TQ:
        raise ValueError(f"{what}: frame {Pn}x{Qn} blocks {Pb}x{Qb}")
    return vert


def _counter_ptr(counter, dev):
    """The device pointer of a one-element int32 counter on ``dev`` (None: no
    counter)."""
    if counter is None:
        return None
    if counter.dtype != torch.int32 or counter.numel() != 1 or counter.device != dev:
        raise ValueError("direct_tiles: a one-element int32 tensor on the slices' device")
    return counter.data_ptr()


def _composite_lib():
    return kernels.bind("composite_fused", "composite_fused_launch",
                        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 18
                        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def composite_positions_fused(slices, ybasis, norm, geom, statics, Pn, Qn,
                              PB, Pb, occupancy, xr=None, yr=None, direct_tiles=None):
    """The fused composite: vertex slices in, composited state [SROWS, Pn, Qn]
    f32 out. On a CUDA tensor one launch of csrc/composite_fused.cu; on a CPU
    tensor ``composite_positions_fused_plain``. The SH basis and norm come
    from the ``ybasis`` / ``norm`` operands (the training branch) or are built
    in the kernel from the frame ranges ``xr`` / ``yr`` (serving).

    ``slices`` [nvert, nu, C, nv] bf16 must have channel-last storage (as
    ``repack_position_slices`` returns it); occupancy = (cell_live,
    pos_needed, pos_any) from ``gnomonic_occupancy_lite``. The kernel exits
    early per ``CUDA_EXIT_TILE`` texel tile, and stages each tile's vertex
    footprint in shared memory; a tile whose footprint exceeds the stage
    (a far-zoomed frame) gathers it directly and, when ``direct_tiles`` (a
    one-element int32 CUDA tensor) is given, adds one to it."""
    if slices.device.type == "cpu":
        return composite_positions_fused_plain(
            slices, ybasis, norm, geom, statics, Pn, Qn, PB, Pb, occupancy,
            xr=xr, yr=yr,
        )
    operands = ybasis is not None and norm is not None
    if not operands and (xr is None or yr is None):
        raise ValueError("composite_positions_fused: pass ybasis and norm, or xr and yr")
    if slices.device.type != "cuda":
        raise ValueError(f"composite_positions_fused: unsupported device {slices.device}")
    dev = slices.device
    nvert, nu, C, nv = slices.shape
    NP = _num_positions(statics)
    QB, Qb = _qb_blocks(statics, Qn)
    vert = _vertex_stack(slices, statics, Pn, Qn, PB, Pb, "composite_positions_fused")
    cell_live, pos_needed, _ = occupancy
    flags = []
    for fl in (cell_live, pos_needed):
        if fl.shape != (PB, QB, NP) or fl.device != dev:
            raise ValueError(f"composite_positions_fused: flags {tuple(fl.shape)}")
        flags.append(fl.to(torch.int32).contiguous())
    if geom.shape != (NP, 8) or geom.device != dev:
        raise ValueError(f"composite_positions_fused: geom {tuple(geom.shape)}")
    geom = geom.to(F32).contiguous()
    if operands:
        # the training branch: basis and norm read from the operands, as the
        # replay backward reads them
        if ybasis.shape != (statics.ncoeff, Pn, Qn) or norm.shape != (Pn, Qn):
            raise ValueError("composite_positions_fused: ybasis/norm shapes")
        ybasis = ybasis.to(F32).contiguous()
        norm = norm.to(F32).contiguous()
        ptrs = (None, ybasis.data_ptr(), norm.data_ptr())
    else:
        (x0, x1), (y0, y1) = xr, yr
        zero = torch.zeros((), dtype=F32, device=dev)
        fs = torch.stack([x0, _div(x1 - x0, Pn - 1), y0, _div(y1 - y0, Qn - 1),
                          zero, zero, zero, zero]).to(F32).contiguous()
        ptrs = (fs.data_ptr(), None, None)
    out = torch.empty((_sprows(statics.with_diffuse), Pn, Qn), dtype=F32, device=dev)
    u_ax, v_ax = _uv_axes(statics.axis)
    fn = _composite_lib()
    err = fn(
        vert.data_ptr(), geom.data_ptr(), flags[0].data_ptr(),
        flags[1].data_ptr(), *ptrs, out.data_ptr(), _counter_ptr(direct_tiles, dev),
        statics.ncoeff, int(statics.with_diffuse), int(statics.relu_sigma),
        NP, statics.pos_per_cell, nvert, nu, nv, C, Pn, Qn, Pb, Qb, PB, QB,
        u_ax, v_ax, statics.axis,
        -1.0 if statics.flip else 1.0, float(statics.exit_eps), kernels.stream(out),
    )
    kernels.check(err, "composite_fused")
    composite_positions_fused.launches += 1
    return out


composite_positions_fused.launches = 0


def composite_fused_stage(statics: GnomonicStatics, operands: bool) -> Tuple[int, int]:
    """The stage that Stage::fit gives a launch of composite_positions_fused
    on ``statics`` on the current card (``operands``: the training branch):
    (records of a ring stage, t1 lines); (0, 0) is no stage, every tile
    gathering directly. Launches nothing."""
    fn = kernels.bind("composite_fused", "composite_fused_stage",
                      [ctypes.c_int] * 3 + [ctypes.c_void_p])
    out = (ctypes.c_int * 2)()
    kernels.check(fn(statics.ncoeff, int(operands), _num_positions(statics),
                     ctypes.cast(out, ctypes.c_void_p)), "composite_fused_stage")
    return out[0], out[1]


# ----------------------------------------------------------- stripe composite


def _stripe_values(t1, rvt, yb, live_u, live_v, j: int, ncoeff: int):
    """Position j's values over the whole frame from the u-resampled stack, as
    the reference's kernel computes them: vals = t1[j] @ RvT[j] (bf16 values,
    f32 products and sums), sigma, the SH fold, band 0, and the liveness
    live_u * live_v."""
    nc = ncoeff
    vals = torch.matmul(t1[j, :3 * nc + 1].to(F32), rvt[j].to(F32))  # [used, Pn, Qn]
    rgb = []
    for c in range(3):
        a = yb[0] * vals[c * nc]
        for k in range(1, nc):
            a = a + yb[k] * vals[c * nc + k]
        rgb.append(a)
    dif = [yb[0] * vals[c * nc] for c in range(3)]
    return vals[3 * nc], rgb, dif, live_u[j] * live_v[j]


def composite_positions_plain(t1, rvt, ybasis, live_u, live_v, norm, geom,
                              statics: GnomonicStatics, Pn: int, Qn: int, PB: int,
                              Pb: int, occupancy, exit_tile=None, return_work=False):
    """Plain PyTorch version of the stripe composite (the TPU kernel
    thr3ed_atom_tpu/rendering/gnomonic.py composite_positions, QB = 1): per
    position the dense product t1[j] @ RvT[j] with f32 sums, the SH fold
    with the ``ybasis`` / ``norm`` operands and the front-to-back composite,
    gated by the [PB, NP] flags of ``occupancy`` = (cell_live, pos_needed).

    t1 [NP, C, Pn, nv] bf16, rvt [NP, nv, Qn] bf16, live_u [NP, Pn, 1],
    live_v [NP, 1, Qn]. ``exit_tile`` is the early exit's grain: the JAX
    kernel's whole (Pb, Qn) stripe by default, ``CUDA_EXIT_TILE`` to
    reproduce the CUDA kernel. Returns the state [SROWS, Pn, Qn] f32 (and the
    marched mask with ``return_work``)."""
    return _march_plain(
        lambda j: _stripe_values(t1, rvt, ybasis, live_u, live_v, j, statics.ncoeff),
        geom, norm, occupancy, statics, Pn, Qn, Pb, exit_tile or (Pb, Qn), return_work)


def composite_positions_qb_plain(t1, rvt, ybasis, live_u, live_v, norm, geom,
                                 statics: GnomonicStatics, Pn: int, Qn: int, PB: int,
                                 Pb: int, occupancy, exit_tile=None, return_work=False):
    """Plain PyTorch version of the q-split stripe composite (the TPU kernel
    thr3ed_atom_tpu/rendering/gnomonic.py _composite_positions_qb, QB =
    Qn / qb > 1): ``composite_positions_plain``'s march gated by [PB, QB, NP]
    flags, each [Pb, Qb] block exiting early on its own transmittance (the
    default ``exit_tile``; ``CUDA_EXIT_TILE`` reproduces the CUDA kernel)."""
    _, Qb = _qb_blocks(statics, Qn)
    return _march_plain(
        lambda j: _stripe_values(t1, rvt, ybasis, live_u, live_v, j, statics.ncoeff),
        geom, norm, occupancy, statics, Pn, Qn, Pb, exit_tile or (Pb, Qb), return_work)


def _check_stripe_operands(what, t1, rvt, ybasis, live_u, live_v, norm, geom,
                           occupancy, statics: GnomonicStatics, Pn, Qn, PB, Pb):
    """The operands of the CUDA stripe kernels, checked and made contiguous f32
    / int32 where the kernels read them so: (t1, rvt, ybasis, live_u, live_v,
    norm, geom, cell_live, pos_needed). The flags are [PB, NP] (QB = 1) or
    [PB, QB, NP]."""
    NP, C, _, nv = t1.shape
    dev = t1.device
    QB, Qb = _qb_blocks(statics, Qn)
    if t1.dtype != torch.bfloat16 or t1.shape[2] != Pn or t1.stride(3) != 1:
        raise ValueError(f"{what}: t1 [NP, C, Pn, nv] bf16 with unit v stride required")
    if rvt.dtype != torch.bfloat16 or rvt.shape != (NP, nv, Qn):
        raise ValueError(f"{what}: rvt [NP, nv, Qn] bf16 required")
    if (C != _padded_channels(statics) or NP != _num_positions(statics)
            or PB * Pb != Pn or Pb % CUDA_EXIT_TILE[0] or Qb % CUDA_EXIT_TILE[1]):
        raise ValueError(f"{what}: t1 {tuple(t1.shape)}, frame {Pn}x{Qn} blocks {PB}x{Pb}")
    if (ybasis.shape != (statics.ncoeff, Pn, Qn) or norm.shape != (Pn, Qn)
            or live_u.shape != (NP, Pn, 1) or live_v.shape != (NP, 1, Qn)
            or geom.shape != (NP, 8)):
        raise ValueError(f"{what}: operand shapes")
    flags = tuple(fl.to(device=dev, dtype=torch.int32).contiguous() for fl in occupancy[:2])
    want = (PB, NP) if QB == 1 else (PB, QB, NP)
    if any(tuple(fl.shape) != want for fl in flags):
        raise ValueError(f"{what}: flags must be {list(want)}")
    ops = tuple(x.to(device=dev, dtype=F32).contiguous()
                for x in (ybasis, live_u, live_v, norm, geom))
    return (t1, rvt.contiguous()) + ops + flags


def _stripe_lib():
    return kernels.bind("composite_stripe", "composite_stripe_launch",
                        [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 10
                        + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])


def _launch_stripe(what, t1, rvt, ybasis, live_u, live_v, norm, geom,
                   statics: GnomonicStatics, Pn, Qn, PB, Pb, occupancy):
    """One call of csrc/composite_stripe.cu (K5 for QB = 1, K6 for QB > 1)."""
    if t1.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t1.device}")
    t1, rvt, yb, lu, lv, nm, geom, cl, pn = _check_stripe_operands(
        what, t1, rvt, ybasis, live_u, live_v, norm, geom, occupancy,
        statics, Pn, Qn, PB, Pb)
    NP, _, _, nv = t1.shape
    QB, Qb = _qb_blocks(statics, Qn)
    dev = t1.device
    taps = torch.empty((NP, Qn, 4), dtype=F32, device=dev)
    out = torch.empty((_sprows(statics.with_diffuse), Pn, Qn), dtype=F32, device=dev)
    err = _stripe_lib()(
        t1.data_ptr(), *t1.stride()[:3], rvt.data_ptr(), taps.data_ptr(),
        lu.data_ptr(), lv.data_ptr(), geom.data_ptr(), cl.data_ptr(), pn.data_ptr(),
        yb.data_ptr(), nm.data_ptr(), out.data_ptr(),
        statics.ncoeff, int(statics.with_diffuse), int(statics.relu_sigma),
        NP, nv, Pn, Qn, Pb, QB, Qb, float(statics.exit_eps), kernels.stream(out),
    )
    kernels.check(err, "composite_stripe")
    return out


def composite_positions(t1, rvt, ybasis, live_u, live_v, norm, geom,
                        statics: GnomonicStatics, Pn: int, Qn: int, PB: int, Pb: int,
                        occupancy):
    """The stripe composite: the u-resampled stack in, the state
    [SROWS, Pn, Qn] f32 out. With ``statics.qb`` splitting Qn into QB > 1
    q-blocks this is ``composite_positions_qb`` (K6); else, on a CUDA
    tensor, one call of csrc/composite_stripe.cu (K5: the column taps of
    ``rvt``, then the march), on a CPU tensor ``composite_positions_plain``.
    The kernel exits early per ``CUDA_EXIT_TILE`` tile. Operands as
    ``composite_positions_plain``."""
    if _qb_blocks(statics, Qn)[0] > 1:
        return composite_positions_qb(t1, rvt, ybasis, live_u, live_v, norm, geom,
                                      statics, Pn, Qn, PB, Pb, occupancy)
    if t1.device.type == "cpu":
        return composite_positions_plain(t1, rvt, ybasis, live_u, live_v, norm, geom,
                                         statics, Pn, Qn, PB, Pb, occupancy)
    out = _launch_stripe("composite_positions", t1, rvt, ybasis, live_u, live_v, norm,
                         geom, statics, Pn, Qn, PB, Pb, occupancy)
    composite_positions.launches += 1
    return out


composite_positions.launches = 0


def composite_positions_qb(t1, rvt, ybasis, live_u, live_v, norm, geom,
                           statics: GnomonicStatics, Pn: int, Qn: int, PB: int, Pb: int,
                           occupancy):
    """The q-split stripe composite (K6): as ``composite_positions`` with
    [PB, QB, NP] flags from ``gnomonic_occupancy(..., RvT=, QB=)``. On a CUDA
    tensor one call of csrc/composite_stripe.cu with the q-block grain; on a
    CPU tensor ``composite_positions_qb_plain``."""
    if t1.device.type == "cpu":
        return composite_positions_qb_plain(t1, rvt, ybasis, live_u, live_v, norm, geom,
                                            statics, Pn, Qn, PB, Pb, occupancy)
    out = _launch_stripe("composite_positions_qb", t1, rvt, ybasis, live_u, live_v, norm,
                         geom, statics, Pn, Qn, PB, Pb, occupancy)
    composite_positions_qb.launches += 1
    return out


composite_positions_qb.launches = 0


# ------------------------------------------------------------------ pipeline


DEFAULT_SUPERSAMPLE = 1.25

# texel-density floor: the warp's reconstruction error on voxel-sharp content
# is set by texels per voxel, not texels per pixel; the floor engages only when
# the image is small relative to the grid, capped to bound the texel cost
_TEXELS_PER_VOXEL_FLOOR = 2.5
_SUPERSAMPLE_CAP = 4.0


def effective_supersample(config_ss: float, statics: GnomonicStatics,
                          height: int, width: int) -> float:
    u_ax, v_ax = _uv_axes(statics.axis)
    nmax = max(statics.dims[u_ax], statics.dims[v_ax])
    floor = _TEXELS_PER_VOXEL_FLOOR * nmax / max(1, min(height, width))
    return float(max(config_ss, min(_SUPERSAMPLE_CAP, floor)))


_BSPLINE_POLE = -0.26794919243112270647  # sqrt(3) - 2
_BSPLINE_CAUSAL_TERMS = 30  # the causal start's truncated geometric sum


def bspline_prefilter_axis0_plain(a: torch.Tensor) -> torch.Tensor:
    """Exact cubic-B-spline interpolation prefilter along axis 0 (causal +
    anticausal first-order recursions, Unser 1999), row by row in f32 in the
    order of the JAX package's ``_bspline_prefilter_axis0`` (its lax.scan).
    The plain version of ``bspline_prefilter_axis0``: ~2n small ops a call."""
    z = _BSPLINE_POLE
    n = a.shape[0]
    lam = (1.0 - z) * (1.0 - 1.0 / z)
    a = a * lam
    # causal init: truncated geometric sum of the first rows
    w = z ** torch.arange(min(n, _BSPLINE_CAUSAL_TERMS), dtype=F32, device=a.device)
    c = torch.tensordot(w, a[: w.shape[0]], dims=([0], [0]))
    cplus = [c]
    for i in range(1, n):
        c = a[i] + z * c
        cplus.append(c)
    # anticausal init (Unser/Thevenaz): c-[N-1] = z/(z^2-1) * (z*c+[N-2] + c+[N-1])
    c = (z / (z * z - 1.0)) * (z * cplus[-2] + cplus[-1])
    cminus = [c]
    for i in range(n - 2, -1, -1):
        c = z * (c - cplus[i])
        cminus.append(c)
    return torch.stack(cminus[::-1])


def _bspline_prefilter_matrix64(n: int) -> np.ndarray:
    """The prefilter's [n, n] matrix (it is linear and depends on n only):
    the recursion of ``bspline_prefilter_axis0_plain`` run on the identity
    in float64, the truncated causal start included."""
    z = _BSPLINE_POLE
    a = np.eye(n) * ((1.0 - z) * (1.0 - 1.0 / z))
    k = min(n, _BSPLINE_CAUSAL_TERMS)
    cplus = np.empty_like(a)
    cplus[0] = (z ** np.arange(k)) @ a[:k]
    for i in range(1, n):
        cplus[i] = a[i] + z * cplus[i - 1]
    out = np.empty_like(a)
    out[-1] = (z / (z * z - 1.0)) * (z * cplus[-2] + cplus[-1])
    for i in range(n - 2, -1, -1):
        out[i] = z * (out[i + 1] - cplus[i])
    return out


def bspline_prefilter_matrix(n: int, device) -> torch.Tensor:
    """``_bspline_prefilter_matrix64(n)`` as f32 on ``device``, built once
    per (n, device): a frame has two line lengths."""
    return _prefilter_matrix_f32(n, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _prefilter_matrix_f32(n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_bspline_prefilter_matrix64(n).astype(np.float32)).to(device)


_F32_TINY = float(np.finfo(np.float32).tiny)


def flush_subnormals(c: torch.Tensor) -> torch.Tensor:
    """Values below the smallest normal f32 set to zero, as the reference's
    XLA flushes subnormals (TPU and CPU); the gradient passes unchanged.
    Applied to the B-spline coefficients and to the order-5 reconstruction
    before the hull clamp: deep in empty space both decay below it, and
    there the reference's y = lo = hi = 0 is a tie whose gradient splits,
    where a subnormal y would send all of it to one bound."""
    return c + torch.where(torch.abs(c) < _F32_TINY, -c, 0.0).detach()


def bspline_prefilter_axis0(a: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """The B-spline prefilter along axis 0 as one f32 product with its
    matrix (TF32 off: ``_strict_f32``), so autograd gives the exact VJP
    (M^T g); ``plain`` runs the row recursion instead. The JAX package
    computes it outside any Pallas kernel, as this product is. Subnormal
    outputs flush to zero (``flush_subnormals``)."""
    if plain:
        return flush_subnormals(bspline_prefilter_axis0_plain(a))
    m = bspline_prefilter_matrix(a.shape[0], a.device)
    return flush_subnormals((m @ a.reshape(a.shape[0], -1)).reshape(a.shape))


def bspline_prefilter(img: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Separable B-spline coefficient transform of [Pn, Qn, C]."""
    img = bspline_prefilter_axis0(img, plain)
    return bspline_prefilter_axis0(img.transpose(0, 1), plain).transpose(0, 1)


def _clip_to_hull(y, lo, hi):
    """``jnp.clip(y, lo, hi)`` as the reference computes it: min/max, not
    torch.clamp with tensor bounds, so the gradient splits at ties (y = lo
    = hi -> 1/4, 3/8, 3/8) as the reference's does; ties fill empty space."""
    return torch.minimum(torch.maximum(y, lo), hi)


def _bspline_weights(t):
    t2 = t * t
    t3 = t2 * t
    six = torch.full((), 6.0, dtype=t.dtype, device=t.device)  # true division
    return ((1.0 - 3.0 * t + 3.0 * t2 - t3) / six, (4.0 - 6.0 * t2 + 3.0 * t3) / six,
            (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / six, t3 / six)


def _catmull_rom_weights(t):
    t2 = t * t
    t3 = t2 * t
    return (-0.5 * t3 + t2 - 0.5 * t, 1.5 * t3 - 2.5 * t2 + 1.0,
            -1.5 * t3 + 2.0 * t2 + 0.5 * t, 0.5 * t3 - 0.5 * t2)


def _warp_gather(state, xr, yr, rotation, statics: GnomonicStatics, height: int,
                 width: int, focal, Pn: int, Qn: int, warp_order: int,
                 plain: bool = False):
    """The per-pixel gather warp (the JAX package's ``_warp_to_camera``
    gather branch): each pixel's ray meets the texel plane at (p, q), and
    the 2 x 2 (order 1) or 4 x 4 (orders 3, 5) texels around it are taken
    by indexing, so the gradient reaches ``state`` through index-add.
    Orders 3 and 5 clip to the hull of the four bilinear taps. Returns
    ([H, W, nch] channels colour, acc, depth (, diffuse), |pixel dirs|)."""
    if warp_order not in (1, 3, 5):
        raise ValueError(
            f"gnomonic_warp_order must be 1 (bilinear), 3 (Catmull-Rom) or "
            f"5 (prefiltered B-spline); got {warp_order}"
        )
    axis = statics.axis
    u_ax, v_ax = _uv_axes(axis)
    g = -1.0 if statics.flip else 1.0
    x0, x1 = xr
    y0, y1 = yr
    nch = 8 if statics.with_diffuse else 5
    dev = state.device
    src = state[1:1 + nch].permute(1, 2, 0)  # [Pn, Qn, nch]
    px = torch.arange(width, dtype=F32, device=dev) + 0.5
    py = torch.arange(height, dtype=F32, device=dev) + 0.5
    gy, gx = torch.meshgrid(py, px, indexing="ij")
    dirs_cam = ((gx - width / 2) / focal, -(gy - height / 2) / focal, -torch.ones_like(gx))
    # the rotation in true f32 (the reference's Precision.HIGHEST; TF32 is
    # off, ``_strict_f32``): a product, so that the FMA chain rounds as the
    # reference's dot does
    d = torch.einsum("ij,hwj->hwi", rotation, torch.stack(dirs_cam, dim=-1))
    x = g * d[..., u_ax] / d[..., axis]
    y = g * d[..., v_ax] / d[..., axis]
    p = (x - x0) / (x1 - x0) * (Pn - 1)
    q = (y - y0) / (y1 - y0) * (Qn - 1)
    p0 = torch.clamp(torch.floor(p), 0, Pn - 2)
    q0 = torch.clamp(torch.floor(q), 0, Qn - 2)
    fp = p - p0
    fq = q - q0
    p0, q0 = p0.long(), q0.long()
    flat = src.reshape(Pn * Qn, nch)

    def gat(dp, dq, table=flat):
        # clamped taps (the bicubic stencil reaches 1 texel outside the frame)
        pi = torch.clamp(p0 + dp, 0, Pn - 1)
        qi = torch.clamp(q0 + dq, 0, Qn - 1)
        return table[pi * Qn + qi]

    if warp_order == 1:
        out = (gat(0, 0) * ((1 - fp) * (1 - fq))[..., None]
               + gat(1, 0) * (fp * (1 - fq))[..., None]
               + gat(0, 1) * ((1 - fp) * fq)[..., None]
               + gat(1, 1) * (fp * fq)[..., None])
    else:
        if warp_order == 5:
            # prefiltered cubic B-spline interpolation: the coefficients of
            # the texel image, reconstructed with the smooth B-spline basis
            table = bspline_prefilter(src, plain).reshape(Pn * Qn, nch)
            wps, wqs = _bspline_weights(fp), _bspline_weights(fq)
        else:  # separable Catmull-Rom
            table = flat
            wps, wqs = _catmull_rom_weights(fp), _catmull_rom_weights(fq)
        out = 0.0
        for ip, wp in enumerate(wps):
            row = 0.0
            for iq, wq in enumerate(wqs):
                row = row + gat(ip - 1, iq - 1, table) * wq[..., None]
            out = out + row * wp[..., None]
        # clip to the bilinear tap hull: no ringing, empty stays exactly empty
        c00, c10, c01, c11 = gat(0, 0), gat(1, 0), gat(0, 1), gat(1, 1)
        lo = torch.minimum(torch.minimum(c00, c10), torch.minimum(c01, c11))
        hi = torch.maximum(torch.maximum(c00, c10), torch.maximum(c01, c11))
        if warp_order == 5:  # the B-spline's subnormal tails in empty space
            out = flush_subnormals(out)
        out = _clip_to_hull(out, lo, hi)
    # depth in world units -> reference convention (units of the pinhole dir)
    return out, torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))


def _finalize_warped(out, dnorm, statics: GnomonicStatics, white_bkgd: bool):
    """Post-warp channel unpacking: colour, acc, depth (, diffuse)."""
    colour = out[..., 0:3]
    acc = out[..., 3:4]
    depth = out[..., 4:5] / dnorm
    if white_bkgd:
        colour = colour + (1.0 - acc)
    disparity = 1.0 / torch.clamp_min(depth / torch.clamp_min(acc, ZERO_PLUS),
                                      ZERO_PLUS)
    extra = {
        EXTRA_DISPARITY: disparity,
        EXTRA_ACCUMULATED_WEIGHTS: acc,
    }
    if statics.with_diffuse:
        diffuse = out[..., 5:8]
        if white_bkgd:
            diffuse = diffuse + (1.0 - acc)
        extra[EXTRA_DIFFUSE_COLOUR] = diffuse
    return RenderOut(colour=colour, depth=depth, extra=extra)


def _warp_to_camera(state, xr, yr, rotation, statics: GnomonicStatics,
                    height: int, width: int, focal, supersample: float,
                    white_bkgd: bool, warp_order: int = 3,
                    warp_impl: str = "matmul", warp_swap: bool = False,
                    plain: bool = False) -> RenderOut:
    """Resample the composited state [SROWS, Pn, Qn] to the camera's pixels
    (differentiable in ``state``): ``warp_impl`` "matmul", the two-pass
    scanline warp, or "gather", the per-pixel gather warp. ``plain`` runs
    the kernels' (and the prefilter's) plain versions."""
    Pn, Qn, _PB, _Pb = gnomonic_frame(None, height, width, focal, supersample,
                                      statics)
    if warp_impl == "gather":
        out, dnorm = _warp_gather(state, xr, yr, rotation, statics, height, width,
                                  focal, Pn, Qn, int(warp_order), plain=plain)
        return _finalize_warped(out, dnorm, statics, white_bkgd)
    if warp_impl != "matmul":
        raise ValueError(f"gnomonic_warp_impl must be 'auto', 'matmul' or 'gather', "
                         f"got '{warp_impl}'")
    from thr3ed_atom_tpu_torch.rendering.warp_matmul import warp_state_matmul

    out = warp_state_matmul(state, xr, yr, rotation, statics, height, width,
                            focal, Pn, Qn, int(warp_order), bool(warp_swap),
                            plain=plain)
    # |R @ dirs_cam| = |dirs_cam| (R orthonormal) — no pixel-dir field
    dev = state.device
    px = torch.arange(width, dtype=F32, device=dev) + 0.5
    py = torch.arange(height, dtype=F32, device=dev) + 0.5
    cx = (px[None, :] - width / 2) / focal
    cy = -(py[:, None] - height / 2) / focal
    dnorm = torch.sqrt(1.0 + cx * cx + cy * cy)[..., None]
    return _finalize_warped(out, dnorm, statics, white_bkgd)


def _strict_f32() -> None:
    """True f32 on the geometry, occupancy and warp paths: TF32 keeps ~3
    decimal digits, which quantizes texel positions and caps image quality;
    and bf16 matmuls that sum in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the v2 pipeline's bf16 u-resample: f32 sums rounded once, as the
    # reference's (cuBLAS may otherwise round partial sums to bf16)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _variant_statics(voxel_grid, axis, flip, config) -> GnomonicStatics:
    want_diffuse = bool(getattr(config, "also_render_diffuse", False)
                        or getattr(config, "render_diffuse", False))
    return statics_for_grid(
        voxel_grid, axis, flip,
        with_diffuse=want_diffuse,
        pos_per_cell=getattr(config, "gnomonic_pos_per_cell", 0),
        exit_eps=float(getattr(config, "gnomonic_exit_eps", 0.0)),
        qb=int(getattr(config, "gnomonic_qb", 128)),
    )


def _cached_slices(voxel_grid, statics, cache):
    """The variant's slices (the vertex stack, or every position for the v2
    pipeline), from ``cache`` while the grid's tensors are unchanged (same
    storage, same version counter)."""
    stamp = tuple((t.data_ptr(), t._version)
                  for t in (voxel_grid.densities, voxel_grid.features))
    vertex = use_fused_composite(statics)
    key = ("gnomonic", statics.axis, statics.flip, statics.pos_per_cell, vertex)
    if cache is not None:
        entry = cache.get(key)
        if entry is not None and entry[0] == stamp:
            return entry[1]
    slices = repack_position_slices(voxel_grid, statics, vertex_only=vertex)
    if cache is not None:
        cache[key] = (stamp, slices)
    return slices


def _march_gnomonic(slices, rot, origin, statics: GnomonicStatics, height: int,
                    width: int, focal, supersample: float, plain: bool = False):
    """The march of one pose through the variant's pipeline: (state
    [SROWS, Pn, Qn], x range, y range). ``slices`` are the vertex stack
    (fused) or every position (v2)."""
    Pn, Qn, PB, Pb = gnomonic_frame(None, height, width, focal, supersample, statics)
    if use_fused_composite(statics):
        QB, Qb = _qb_blocks(statics, Qn)
        geo = gnomonic_geometry(rot, origin, statics, height, width, focal, supersample)
        occupancy = gnomonic_occupancy_lite(slices, geo.geom, statics, Pn, Qn, PB,
                                            Pb, QB, Qb)
        composite = composite_positions_fused_plain if plain else composite_positions_fused
        state = composite(slices, None, None, geo.geom, statics, Pn, Qn, PB, Pb,
                          occupancy, xr=geo.xr, yr=geo.yr)
        return state, geo.xr, geo.yr
    geo = gnomonic_geometry(rot, origin, statics, height, width, focal, supersample,
                            lite=False, skip_basis=False)
    t1 = resample_u(slices, geo.Ru)
    occupancy = gnomonic_occupancy(slices, geo.Ru, statics, PB, Pb)
    composite = composite_positions_plain if plain else composite_positions
    state = composite(t1, geo.RvT, geo.ybasis, geo.live_u, geo.live_v, geo.norm,
                      geo.geom, statics, Pn, Qn, PB, Pb, occupancy)
    return state, geo.xr, geo.yr


@torch.no_grad()
def render_image_gnomonic(voxel_grid: VoxelGrid, camera_pose, camera_intrinsics,
                          config, cache: Optional[dict] = None,
                          plain: bool = False) -> RenderOut:
    """Full-image render of one pose through the gnomonic pipeline, on the
    grid's device. Outputs are [H, W, .]. ``plain`` runs the kernels' plain
    PyTorch versions instead (a reference for checking the kernels on the
    card); ``cache`` keeps each march variant's vertex slices."""
    from thr3ed_atom_tpu_torch.rendering.warp_matmul import warp_swap_for_pose

    _strict_f32()
    rotation = np.asarray(camera_pose.rotation, np.float32).reshape(3, 3)
    origin = np.asarray(camera_pose.translation, np.float32).reshape(3)
    axis, flip = dominant_axis_for_pose(rotation)
    statics = _variant_statics(voxel_grid, axis, flip, config)
    slices = _cached_slices(voxel_grid, statics, cache)

    dev = voxel_grid.device
    height, width = int(camera_intrinsics.height), int(camera_intrinsics.width)
    focal_f = float(camera_intrinsics.focal)
    supersample = effective_supersample(
        float(getattr(config, "gnomonic_supersample", DEFAULT_SUPERSAMPLE)),
        statics, height, width,
    )
    rot = torch.as_tensor(rotation).to(dev)
    focal = torch.tensor(focal_f, dtype=F32, device=dev)
    state, xr, yr = _march_gnomonic(slices, rot, torch.as_tensor(origin).to(dev),
                                    statics, height, width, focal, supersample, plain)
    warp_impl = str(getattr(config, "gnomonic_warp_impl", "auto"))
    swap = warp_swap_for_pose(rotation, axis, flip, height, width, focal_f)
    return _warp_to_camera(
        state, xr, yr, rot, statics, height, width, focal, supersample,
        bool(config.white_bkgd),
        warp_order=int(getattr(config, "gnomonic_warp_order", 3)),
        warp_impl="matmul" if warp_impl == "auto" else warp_impl,
        warp_swap=swap, plain=plain,
    )


@torch.no_grad()
def render_poses_gnomonic(voxel_grid: VoxelGrid, camera_poses, camera_intrinsics,
                          config, cache: Optional[dict] = None,
                          plain: bool = False) -> RenderOut:
    """Render a sequence of poses; every output gains a leading pose axis.
    Poses of one march variant share one repack of the grid."""
    cache = {} if cache is None else cache
    outs = [render_image_gnomonic(voxel_grid, pose, camera_intrinsics, config,
                                  cache=cache, plain=plain)
            for pose in camera_poses]
    return RenderOut(
        colour=torch.stack([o.colour for o in outs]),
        depth=torch.stack([o.depth for o in outs]),
        extra={k: torch.stack([o.extra[k] for o in outs]) for k in outs[0].extra},
    )


class _GnomonicProcedure(FlatRaysToFast):
    """RENDER_PROCEDURES entry: the gnomonic renderer is pose-structured, so
    VolumetricModel renders whole poses through ``render_image`` /
    ``render_poses``; flat ray batches go to the fast renderer."""

    name = "render_sh_voxel_grid_gnomonic"
    pipeline = "shear-warp pipeline"
    render_image = staticmethod(render_image_gnomonic)
    render_poses = staticmethod(render_poses_gnomonic)


render_sh_voxel_grid_gnomonic = _GnomonicProcedure()
