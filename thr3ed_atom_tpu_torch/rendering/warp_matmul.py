"""Two-pass scanline projective warp of the composited gnomonic image.

Counterpart of thr3ed_atom_tpu/rendering/warp_matmul.py (Catmull & Smith
1980): a homography maps image rows to lines in texel space, so pass A
resamples each texel column along q at the lines' positions and pass B
resamples each resulting row along p at the pixels' (projective) positions.
Each pass is a 1-D resample per scanline, ``resample_rows``: on a CUDA tensor
one launch of csrc/resample_rows.cu, on a CPU tensor ``resample_rows_plain``.
The kernel support is at most 4 texels, so the kernel gathers the band
instead of building the TPU kernel's banded weight matrix. All arithmetic is
f32 (the reference runs these products at Precision.HIGHEST).

``resample_rows`` is differentiable in X (a ``torch.autograd.Function``): its
backward is the adjoint resample ``resample_rows_adjoint`` (csrc/
resample_rows_adjoint.cu on a CUDA tensor, ``resample_rows_adjoint_plain`` on
a CPU one), so the whole warp carries the training loss's cotangent back to
the composited state. The ringing clamp stays a PyTorch min/max, whose
gradient splits at ties as the reference's ``jnp.clip`` does. Order 5
resamples each line's B-spline coefficients (``prefilter_last_axis``, an f32
product with the prefilter's matrix) and clips to the line's own taps.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from thr3ed_atom_tpu_torch import kernels
from thr3ed_atom_tpu_torch.rendering.axes import _uv_axes
from thr3ed_atom_tpu_torch.rendering.gnomonic import (
    _clip_to_hull,
    bspline_prefilter_axis0,
    bspline_prefilter_matrix,
    flush_subnormals,
)

F32 = torch.float32


def _kernel_weights(t: torch.Tensor, order: int) -> torch.Tensor:
    """1-D reconstruction kernel K(t); support <= 2 texels each side."""
    at = torch.abs(t)
    if order == 1:
        return torch.clamp_min(1.0 - at, 0.0)
    if order == 3:  # Catmull-Rom
        inner = (1.5 * at - 2.5) * at * at + 1.0
        outer = ((-0.5 * at + 2.5) * at - 4.0) * at + 2.0
        return torch.where(at < 1.0, inner, torch.where(at < 2.0, outer, 0.0))
    if order == 5:  # cubic B-spline (positions must be prefiltered coeffs)
        six = torch.full((), 6.0, dtype=t.dtype, device=t.device)  # true division
        inner = (4.0 - 6.0 * at * at + 3.0 * at * at * at) / six
        o2 = 2.0 - at
        outer = o2 * o2 * o2 / six
        return torch.where(at < 1.0, inner, torch.where(at < 2.0, outer, 0.0))
    raise ValueError(f"unsupported warp order {order}")


def resample_rows_plain(X: torch.Tensor, pos: torch.Tensor, order: int,
                        taps: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel
    thr3ed_atom_tpu/rendering/warp_matmul.py _resample_call (forward):
    ``Y[i, :, n] = sum_k K(k - pos[i, n]) X[i, :, k]`` over the four taps
    floor(pos) - 1 .. floor(pos) + 2 (the whole support), summed in that order;
    taps outside [0, K) weigh zero. ``taps`` adds planes 1 and 2, the values
    at floor(pos) and floor(pos) + 1 (zero outside). X [NB, CH, K] f32, pos
    [NB, 1, N] f32 -> [NB, CH, N] (``taps``: [NB, 3, CH, N])."""
    NB, CH, K = X.shape
    p = pos[:, 0, :]  # [NB, N]
    k0 = torch.floor(p)
    out = torch.zeros((NB, CH, p.shape[1]), dtype=F32, device=X.device)

    def tap(k):
        idx = k.clamp(0, K - 1).long()[:, None, :].expand(NB, CH, -1)
        val = torch.gather(X, 2, idx)
        return torch.where(((k >= 0) & (k <= K - 1))[:, None, :], val, 0.0)

    for d in (-1.0, 0.0, 1.0, 2.0):
        k = k0 + d
        w = _kernel_weights(k - p, order)
        w = torch.where((k >= 0) & (k <= K - 1), w, 0.0)
        out = out + w[:, None, :] * tap(k)
    if not taps:
        return out
    return torch.stack([out, tap(k0), tap(k0 + 1.0)], dim=1)


def resample_rows_adjoint_plain(dY: torch.Tensor, pos: torch.Tensor, order: int,
                                K: int, taps: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel
    thr3ed_atom_tpu/rendering/warp_matmul.py _resample_call (adjoint=True),
    the adjoint of ``resample_rows_plain``: ``dX[i, :, k] = sum_n
    K(k - pos[i, n]) dY[i, :, n]`` over the same four taps (zero outside
    [0, K)), plus with ``taps`` the planes dY[:, 1] and dY[:, 2] added at
    floor(pos) and floor(pos) + 1. dY [NB, CH, N] (``taps``: [NB, 3, CH, N])
    f32, pos [NB, 1, N] f32 -> dX [NB, CH, K] in dY's dtype (a float64 dY
    gives the sums in float64, with the f32 weights)."""
    g0 = dY[:, 0] if taps else dY
    NB, CH, N = g0.shape
    p = pos[:, 0, :]  # [NB, N]
    k0 = torch.floor(p)
    dX = torch.zeros((NB, CH, K), dtype=dY.dtype, device=dY.device)

    def scatter(k, val):
        ok = ((k >= 0) & (k <= K - 1))[:, None, :]
        idx = k.clamp(0, K - 1).long()[:, None, :].expand(NB, CH, N)
        dX.scatter_add_(2, idx, torch.where(ok, val, 0.0))

    for d in (-1.0, 0.0, 1.0, 2.0):
        k = k0 + d
        scatter(k, _kernel_weights(k - p, order)[:, None, :] * g0)
    if taps:
        scatter(k0, dY[:, 1])
        scatter(k0 + 1.0, dY[:, 2])
    return dX


# (X or dY, pos, out, NB, CH, K, N, order, taps, stream)
_ROWS_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _check_rows(name, t, pos, order):
    """The kernels' contract, one cheap test each: contiguous float32 CUDA
    tensors on one device, CH = 8 channels (``t``'s second-last axis),
    order 1, 3 or 5."""
    if not (t.is_cuda and t.dtype is F32 and pos.dtype is F32 and t.is_contiguous()
            and pos.is_contiguous() and pos.get_device() == t.get_device()):
        raise ValueError(f"{name}: contiguous float32 CUDA tensors on one device required, "
                         f"got {t.dtype} {t.device}, {pos.dtype} {pos.device}")
    if t.shape[-2] != 8:
        raise ValueError(f"{name}: the kernel takes CH = 8 channels, got {t.shape[-2]}")
    if order not in (1, 3, 5):
        raise ValueError(f"unsupported warp order {order}")


def _resample_rows_forward(X: torch.Tensor, pos: torch.Tensor, order: int,
                           taps: bool) -> torch.Tensor:
    if X.device.type == "cpu":
        return resample_rows_plain(X, pos, order, taps)
    _check_rows("resample_rows", X, pos, order)
    NB, CH, K = X.shape
    N = pos.shape[-1]
    if pos.shape != (NB, 1, N):
        raise ValueError(f"resample_rows: X {tuple(X.shape)}, pos {tuple(pos.shape)}")
    out = torch.empty((NB, 3, CH, N) if taps else (NB, CH, N), dtype=F32, device=X.device)
    err = kernels.bind("resample_rows", "resample_rows_launch", _ROWS_ARGS)(
        X.data_ptr(), pos.data_ptr(), out.data_ptr(), NB, CH, K, N, order, int(taps),
        kernels.stream(X))
    kernels.check(err, "resample_rows")
    resample_rows.launches += 1
    return out


def resample_rows_adjoint(dY: torch.Tensor, pos: torch.Tensor, order: int,
                          K: int, taps: bool = False) -> torch.Tensor:
    """The adjoint resample (see ``resample_rows_adjoint_plain``): one launch
    of csrc/resample_rows_adjoint.cu on a CUDA tensor (a monotone row is
    gathered per texel, any other row scattered with shared-memory atomics),
    the plain version on a CPU one."""
    if dY.device.type == "cpu":
        return resample_rows_adjoint_plain(dY, pos, order, K, taps)
    _check_rows("resample_rows_adjoint", dY, pos, order)
    NB = dY.shape[0]
    CH, N = dY.shape[-2], dY.shape[-1]
    if dY.shape != ((NB, 3, CH, N) if taps else (NB, CH, N)) or pos.shape != (NB, 1, N):
        raise ValueError(f"resample_rows_adjoint: dY {tuple(dY.shape)}, pos {tuple(pos.shape)}")
    dX = torch.empty((NB, CH, K), dtype=F32, device=dY.device)
    err = kernels.bind("resample_rows_adjoint", "resample_rows_adjoint_launch", _ROWS_ARGS)(
        dY.data_ptr(), pos.data_ptr(), dX.data_ptr(), NB, CH, K, N, order, int(taps),
        kernels.stream(dY))
    kernels.check(err, "resample_rows_adjoint")
    resample_rows_adjoint.launches += 1
    return dX


resample_rows_adjoint.launches = 0


class _ResampleRows(torch.autograd.Function):
    """resample_rows with its adjoint as the backward (the reference's custom
    VJP, warp_matmul.py _resample_fwd / _resample_bwd); ``plain`` runs both
    directions through the plain versions."""

    @staticmethod
    def forward(ctx, X, pos, order, taps, plain):
        ctx.save_for_backward(pos)
        ctx.meta = (X.shape[2], order, taps, plain)
        if plain:
            return resample_rows_plain(X, pos, order, taps)
        return _resample_rows_forward(X, pos, order, taps)

    @staticmethod
    def backward(ctx, dY):
        (pos,) = ctx.saved_tensors
        K, order, taps, plain = ctx.meta
        adjoint = resample_rows_adjoint_plain if plain else resample_rows_adjoint
        return adjoint(dY.contiguous(), pos, order, K, taps), None, None, None, None


def resample_rows(X: torch.Tensor, pos: torch.Tensor, order: int,
                  taps: bool = False, plain: bool = False) -> torch.Tensor:
    """Row-batched 1-D resample (see ``resample_rows_plain``): one launch of
    csrc/resample_rows.cu on a CUDA tensor, the plain version on a CPU one
    (or with ``plain``). Differentiable in X; the backward is
    ``resample_rows_adjoint``."""
    if torch.is_grad_enabled() and X.requires_grad:
        return _ResampleRows.apply(X, pos, order, taps, plain)
    if plain:
        return resample_rows_plain(X, pos, order, taps)
    return _resample_rows_forward(X, pos, order, taps)


resample_rows.launches = 0


def resample_rows_clamped(X, pos, order: int, plain: bool = False):
    """resample_rows + the ringing clamp: the interpolant is clipped to the
    hull of its two central taps, so empty regions stay exactly empty."""
    y3 = resample_rows(X, pos, order, True, plain=plain)
    y, t0, t1 = y3[:, 0], y3[:, 1], y3[:, 2]
    return _clip_to_hull(y, torch.minimum(t0, t1), torch.maximum(t0, t1))


def resample_rows_bspline(X, pos, plain: bool = False):
    """Order 5 with its hull clamp: the row-prefiltered coefficients of X
    resampled with the cubic B-spline, clipped to the hull of X's own two
    central taps (an order-1 pass with ``taps``), as the reference's
    order-5 branch does."""
    y = flush_subnormals(resample_rows(prefilter_last_axis(X, plain), pos, 5, plain=plain))
    t3 = resample_rows(X, pos, 1, True, plain=plain)
    t0, t1 = t3[:, 1], t3[:, 2]
    return _clip_to_hull(y, torch.minimum(t0, t1), torch.maximum(t0, t1))


def prefilter_last_axis(x: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """The B-spline prefilter along the last axis (the reference's
    ``_prefilter_last_axis``): x @ M^T with the line's [n, n] prefilter
    matrix, f32, differentiable, subnormals flushed; ``plain`` runs the row
    recursion."""
    if plain:
        return bspline_prefilter_axis0(x.movedim(-1, 0), plain=True).movedim(0, -1)
    return flush_subnormals(x @ bspline_prefilter_matrix(x.shape[-1], x.device).t())


# ------------------------------------------------------------------ geometry


def _homography_coeffs(rotation, statics, xr, yr, Pn: int, Qn: int, focal):
    """Coefficient triples of p, q and the shared denominator as affine
    functions of the camera-plane coordinates (cx, cy):
    p = (P0 cx + P1 cy + P2) / (D0 cx + D1 cy + D2), q likewise."""
    axis = statics.axis
    u_ax, v_ax = _uv_axes(axis)
    g = -1.0 if statics.flip else 1.0
    x0, x1 = xr
    y0, y1 = yr
    sp = (Pn - 1) / (x1 - x0)
    sq = (Qn - 1) / (y1 - y0)
    Ru = [rotation[u_ax, 0], rotation[u_ax, 1], -rotation[u_ax, 2]]
    Rv = [rotation[v_ax, 0], rotation[v_ax, 1], -rotation[v_ax, 2]]
    Ra = [rotation[axis, 0], rotation[axis, 1], -rotation[axis, 2]]
    P = [sp * (g * Ru[i] - x0 * Ra[i]) for i in range(3)]
    Q = [sq * (g * Rv[i] - y0 * Ra[i]) for i in range(3)]
    return P, Q, Ra


def _row_coeffs(P, Q, D, H: int, W: int, Hp: int, focal):
    """Per-image-row coefficients: positions along row r as a projective
    function of the column c, plus the (alpha, beta) line parameters of the
    row's image in (p, q) texel space. Rows r >= H are padding."""
    r = torch.arange(Hp, dtype=F32, device=focal.device)
    cy = -(r + 0.5 - H / 2) / focal
    inv_f = 1.0 / focal
    cx_off = (0.5 - W / 2) / focal

    def affine(T):
        # T0*cx + T1*cy + T2 with cx = c*inv_f + cx_off -> (a*c + b) per row
        return T[0] * inv_f, T[0] * cx_off + T[1] * cy + T[2]

    pa, pb = affine(P)
    qa, qb = affine(Q)
    da, db = affine(D)
    pa = pa.expand(Hp)
    qa = qa.expand(Hp)
    da = da.expand(Hp)

    def at(a, b, c):
        return a * c + b

    eps = 1e-20
    den0 = at(da, db, 0.0)
    den1 = at(da, db, float(W - 1))
    p0 = at(pa, pb, 0.0) / den0
    p1 = at(pa, pb, float(W - 1)) / den1
    q0 = at(qa, qb, 0.0) / den0
    q1 = at(qa, qb, float(W - 1)) / den1
    dp = p1 - p0
    dq = q1 - q0
    beta_q = dq / torch.where(torch.abs(dp) < eps, eps, dp)  # q = a + b*p
    alpha_q = q0 - beta_q * p0
    beta_p = dp / torch.where(torch.abs(dq) < eps, eps, dq)  # p = a + b*q
    alpha_p = p0 - beta_p * q0
    return (pa, pb, qa, qb, da, db), (alpha_q, beta_q), (alpha_p, beta_p)


def _clip_range(order: int, n: int) -> Tuple[float, float]:
    # keep the kernel's support fully inside [0, n-1]
    return (0.0, n - 1.0) if order == 1 else (1.0, n - 2.0)


def _finite_clip(x, lo, hi):
    return torch.nan_to_num(x, nan=lo, posinf=hi, neginf=lo).clamp(lo, hi)


def warp_swap_for_pose(rotation: np.ndarray, axis: int, flip: bool,
                       height: int, width: int, focal: float) -> bool:
    """True when image rows run more along the q texel axis than p (a strongly
    rolled camera): the two passes then swap axes to keep pass A's line
    parametrization well-conditioned. Host-side, float64."""
    u_ax, v_ax = _uv_axes(axis)
    g = -1.0 if flip else 1.0
    R = np.asarray(rotation, np.float64).reshape(3, 3)

    def xy(cx, cy):
        d = R @ np.array([cx, cy, -1.0])
        return g * d[u_ax] / d[axis], g * d[v_ax] / d[axis]

    cy_mid = 0.0
    x0, y0 = xy((0.5 - width / 2) / focal, cy_mid)
    x1, y1 = xy((width - 0.5 - width / 2) / focal, cy_mid)
    return bool(abs(y1 - y0) > abs(x1 - x0))


# ------------------------------------------------------------------ pipeline


def warp_state_matmul(state, xr, yr, rotation, statics, height: int, width: int,
                      focal, Pn: int, Qn: int, warp_order: int, swap: bool,
                      plain: bool = False):
    """Two-pass warp of the composited state [SROWS, Pn, Qn] to the camera's
    pixels. Returns [H, W, 8] f32 (colour rgb, acc, depth[, diffuse rgb],
    zero-padded). ``plain`` resamples with the plain versions on any device.
    Differentiable in ``state``."""
    if warp_order not in (1, 3, 5):
        raise ValueError(f"gnomonic_warp_order must be 1, 3 or 5, got {warp_order}")
    nch = 8 if statics.with_diffuse else 5
    CH = 8
    Hp = -(-height // 128) * 128
    Wp = -(-width // 128) * 128
    dev = state.device
    src = state[1:1 + nch]
    if nch < CH:
        src = torch.cat([src, torch.zeros((CH - nch,) + src.shape[1:],
                                          dtype=F32, device=dev)], dim=0)

    P, Q, D = _homography_coeffs(rotation, statics, xr, yr, Pn, Qn, focal)
    (pa, pb, qa, qb, da, db), (alpha_q, beta_q), (alpha_p, beta_p) = (
        _row_coeffs(P, Q, D, height, width, Hp, focal)
    )
    carr = torch.arange(Wp, dtype=F32, device=dev)
    den = da[:, None] * carr[None, :] + db[:, None]
    den = torch.where(torch.abs(den) < 1e-20, 1e-20, den)

    if not swap:
        # pass A: along q for each texel column p; pass B: along p per row
        K2 = Pn
        first = src.permute(1, 0, 2).contiguous()  # [Pn, CH, Qn]
        lo1, hi1 = _clip_range(warp_order, Qn)
        line_pos = _finite_clip(
            alpha_q[None, :]
            + beta_q[None, :] * torch.arange(Pn, dtype=F32, device=dev)[:, None],
            lo1, hi1,
        ).reshape(Pn, 1, Hp)
        lo2, hi2 = _clip_range(warp_order, Pn)
        pix_pos = _finite_clip(
            (pa[:, None] * carr[None, :] + pb[:, None]) / den, lo2, hi2
        ).reshape(Hp, 1, Wp)
    else:
        K2 = Qn
        first = src.permute(2, 0, 1).contiguous()  # [Qn, CH, Pn]
        lo1, hi1 = _clip_range(warp_order, Pn)
        line_pos = _finite_clip(
            alpha_p[None, :]
            + beta_p[None, :] * torch.arange(Qn, dtype=F32, device=dev)[:, None],
            lo1, hi1,
        ).reshape(Qn, 1, Hp)
        lo2, hi2 = _clip_range(warp_order, Qn)
        pix_pos = _finite_clip(
            (qa[:, None] * carr[None, :] + qb[:, None]) / den, lo2, hi2
        ).reshape(Hp, 1, Wp)

    def one_pass(X, pos):
        # orders 3 / 5 clip each pass's interpolant to its central-tap hull
        # (order 5: the reconstruction from the prefiltered line against the
        # line's own taps); the second pass prefilters the zero-padded line,
        # as the reference does: no tap reaches the pad, but the anticausal
        # start reads the padded end
        if warp_order == 5:
            return resample_rows_bspline(X, pos.contiguous(), plain=plain)
        if warp_order == 3:
            return resample_rows_clamped(X, pos.contiguous(), 3, plain=plain)
        return resample_rows(X, pos.contiguous(), 1, plain=plain)

    inter = one_pass(first, line_pos)
    inter = inter.permute(2, 1, 0)  # [Hp, CH, lineN]
    K2p = -(-K2 // 128) * 128
    if K2p != K2:
        inter = torch.cat([inter, torch.zeros((Hp, CH, K2p - K2), dtype=F32,
                                              device=dev)], dim=2)
    out = one_pass(inter.contiguous(), pix_pos)
    return out.permute(0, 2, 1)[:height, :width, :]
