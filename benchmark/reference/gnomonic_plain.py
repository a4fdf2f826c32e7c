"""Plain PyTorch reference of the gnomonic shear-warp render and its training
loss, written for the benchmark: a frozen copy of the arithmetic of the
port's plain versions (the vertex repack, the affine geometry with the
sub-texel phase, the lossless occupancy flags, the front-to-back march with
the relu-trapezoid cell integral, the two-pass Catmull-Rom scanline warp,
L1 losses), with no kernel, no cache and no import of the program.

The gradient is autograd's, with the two conventions the renderer's own
replay backward follows: the cell integral's endpoint derivatives are the
closed forms (``_ReluTrap``), and the emission centroid ``tbar`` is held
constant. ``dt`` is the precision of the grid values, the march, the warp
and the loss (float32; bfloat16 is the control); positions are float32.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

F32 = torch.float32
BF16 = torch.bfloat16
C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
SUPERSAMPLE_FLOOR = 2.5  # texels per voxel
SUPERSAMPLE_CAP = 4.0
PB_ROWS = 128  # the frame's row blocking (the occupancy grain)


class Grid(NamedTuple):
    """A relu-field SH grid: raw densities [X, Y, Z, 1] and features
    [X, Y, Z, F], identity pre-activation times ``density_scale``, relu
    post-activation, identity features, centred at the origin."""

    densities: torch.Tensor
    features: torch.Tensor
    voxel_size: float
    density_scale: float

    @property
    def dims(self) -> Tuple[int, int, int]:
        return tuple(self.features.shape[:3])

    @property
    def aabb(self):
        return tuple((-(d * self.voxel_size) / 2, (d * self.voxel_size) / 2) for d in self.dims)


class Variant(NamedTuple):
    dims: Tuple[int, int, int]
    aabb: tuple
    axis: int
    flip: bool
    ncoeff: int
    P: int  # positions per cell
    qb: int
    with_diffuse: bool


def uv_axes(axis: int) -> Tuple[int, int]:
    others = [a for a in range(3) if a != axis]
    return others[0], others[1]


def dominant_axis(rotation: np.ndarray) -> Tuple[int, bool]:
    forward = -np.asarray(rotation, np.float64).reshape(3, 3)[:, 2]
    axis = int(np.argmax(np.abs(forward)))
    return axis, bool(forward[axis] < 0.0)


def warp_swap(rotation: np.ndarray, axis: int, flip: bool, height: int, width: int,
              focal: float) -> bool:
    """True when image rows run more along the q texel axis than along p."""
    u_ax, v_ax = uv_axes(axis)
    g = -1.0 if flip else 1.0
    R = np.asarray(rotation, np.float64).reshape(3, 3)

    def xy(cx):
        d = R @ np.array([cx, 0.0, -1.0])
        return g * d[u_ax] / d[axis], g * d[v_ax] / d[axis]

    x0, y0 = xy((0.5 - width / 2) / focal)
    x1, y1 = xy((width - 0.5 - width / 2) / focal)
    return bool(abs(y1 - y0) > abs(x1 - x0))


def variant_for(grid: Grid, rotation, with_diffuse: bool, qb: int = 128) -> Variant:
    axis, flip = dominant_axis(rotation)
    n_cells = grid.dims[axis] - 1
    P = max(1, min(8, 2 ** round(math.log2(max(1.0, 256 / n_cells)))))
    return Variant(grid.dims, grid.aabb, axis, flip, grid.features.shape[-1] // 3, P, qb,
                   with_diffuse)


def supersample_for(v: Variant, config_ss: float, height: int, width: int) -> float:
    u_ax, v_ax = uv_axes(v.axis)
    floor = SUPERSAMPLE_FLOOR * max(v.dims[u_ax], v.dims[v_ax]) / max(1, min(height, width))
    return float(max(config_ss, min(SUPERSAMPLE_CAP, floor)))


def frame(height: int, width: int, ss: float) -> Tuple[int, int]:
    """(Pn, Qn): the texel grid, 128-multiples."""
    Pn = -(-int(math.ceil(width * ss)) // 128) * 128
    Qn = -(-int(math.ceil(height * ss)) // 128) * 128
    return Pn, Qn


def num_positions(v: Variant) -> int:
    return (v.dims[v.axis] - 1) * v.P + 1


def _div(x: torch.Tensor, n) -> torch.Tensor:
    return x / torch.full((), float(n), dtype=x.dtype, device=x.device)


def vertex_stack(grid: Grid, v: Variant) -> torch.Tensor:
    """The activated grid's vertex slices front to back along the march axis:
    [nvert, nu, nv, C] f32 (C = 3 ncoeff + 1: features, then density)."""
    u_ax, v_ax = uv_axes(v.axis)
    unified = torch.cat([grid.features, grid.densities * grid.density_scale], dim=-1)
    slices = unified.permute(v.axis, u_ax, v_ax, 3)
    if v.flip:
        slices = torch.flip(slices, dims=(0,))
    return slices


# ------------------------------------------------------------------ geometry


def geometry(rotation: torch.Tensor, origin: torch.Tensor, v: Variant, height: int,
             width: int, focal: torch.Tensor, ss: float, phase=None, basis: bool = True):
    """(geom [NP, 6]: s_j, cell_step, bu, ku, bv, kv; xr; yr; ybasis [ncoeff, Pn,
    Qn]; norm [Pn, Qn]) in f32, in the renderer's order of operations."""
    axis = v.axis
    u_ax, v_ax = uv_axes(axis)
    g = -1.0 if v.flip else 1.0
    aabb, dims, P = v.aabb, v.dims, v.P
    NP = num_positions(v)
    dev = rotation.device
    Pn, Qn = frame(height, width, ss)
    lo_a, hi_a = aabb[axis]
    cell_a = (hi_a - lo_a) / dims[axis]
    su = dims[u_ax] / (aabb[u_ax][1] - aabb[u_ax][0])
    sv = dims[v_ax] / (aabb[v_ax][1] - aabb[v_ax][0])

    cx = torch.tensor([0.0, width, 0.0, width], dtype=F32, device=dev)
    cy = torch.tensor([0.0, 0.0, height, height], dtype=F32, device=dev)
    dirs = torch.stack([(cx - width / 2) / focal, -(cy - height / 2) / focal,
                        -torch.ones(4, dtype=F32, device=dev)], dim=-1)
    d = torch.matmul(dirs, rotation.T)
    x_c = g * d[:, u_ax] / d[:, axis]
    y_c = g * d[:, v_ax] / d[:, axis]
    x0, x1, y0, y1 = x_c.min(), x_c.max(), y_c.min(), y_c.max()
    mx = _div(x1 - x0, Pn)
    my = _div(y1 - y0, Qn)
    x0, x1 = x0 - mx, x1 + mx
    y0, y1 = y0 - my, y1 + my
    if phase is not None:
        dxt = mx * torch.as_tensor(phase[0], dtype=F32, device=dev)
        dyt = my * torch.as_tensor(phase[1], dtype=F32, device=dev)
        x0, x1 = x0 + dxt, x1 + dxt
        y0, y1 = y0 + dyt, y1 + dyt

    xs = x0 + _div((x1 - x0) * torch.arange(Pn, dtype=F32, device=dev), Pn - 1)
    ys = y0 + _div((y1 - y0) * torch.arange(Qn, dtype=F32, device=dev), Qn - 1)
    if basis:
        norm = torch.sqrt(1.0 + xs[:, None] ** 2 + ys[None, :] ** 2)
    else:  # the serving frame builds them from the ranges
        pf = torch.arange(Pn, dtype=F32, device=dev)
        qf = torch.arange(Qn, dtype=F32, device=dev)
        xs = (x0 + pf * _div(x1 - x0, Pn - 1))
        ys = (y0 + qf * _div(y1 - y0, Qn - 1))
        norm = torch.sqrt(1.0 + xs[:, None] * xs[:, None] + ys[None, :] * ys[None, :])
    comp = [None, None, None]
    comp[u_ax] = xs[:, None] / norm
    comp[v_ax] = ys[None, :].expand(Pn, Qn) / norm
    comp[axis] = g / norm
    ybasis = sh_rows(comp[0], comp[1], comp[2], v.ncoeff)

    j = torch.arange(NP, dtype=F32, device=dev)
    c_j = (NP - 1 - j) / P if v.flip else j / P
    w_j = lo_a + (c_j + 0.5) * cell_a
    s_j = (w_j - origin[axis]) / g
    a_u = (origin[u_ax] - aabb[u_ax][0]) * su - 0.5
    a_v = (origin[v_ax] - aabb[v_ax][0]) * sv - 0.5
    cell_step = torch.full((NP,), cell_a / P, dtype=F32, device=dev)
    bu = a_u + (s_j * su) * x0
    ku = (s_j * su) * _div(x1 - x0, Pn - 1)
    bv = a_v + (s_j * sv) * y0
    kv = (s_j * sv) * _div(y1 - y0, Qn - 1)
    geom = torch.stack([s_j, cell_step, bu, ku, bv, kv], dim=-1)
    return geom, (x0, x1), (y0, y1), ybasis, norm


def sh_rows(x_, y_, z_, ncoeff: int) -> torch.Tensor:
    rows = [C0 * torch.ones_like(x_)]
    if ncoeff > 1:
        rows += [-C1 * y_, C1 * z_, -C1 * x_]
    if ncoeff > 4:
        rows += [C2[0] * x_ * y_, C2[1] * y_ * z_, C2[2] * (2.0 * z_ * z_ - x_ * x_ - y_ * y_),
                 C2[3] * x_ * z_, C2[4] * (x_ * x_ - y_ * y_)]
    if ncoeff > 9:
        raise ValueError("the reference covers SH degree <= 2")
    return torch.stack(rows, dim=0)


@torch.no_grad()
def occupancy(sigv: torch.Tensor, geom: torch.Tensor, v: Variant, Pn: int, Qn: int):
    """Lossless skip flags per (128-row block, q-block, position) from the
    vertex densities ``sigv`` [nvert, nu, nv]: (cell_live, pos_needed)
    [NP, PB, QB] bool, Pb, Qb. A block is live at a position when a density
    > 0 lies within the reach of its tent taps."""
    NP = num_positions(v)
    nu, nv = sigv.shape[1], sigv.shape[2]
    P, dev = v.P, geom.device
    PB, Pb = Pn // PB_ROWS, PB_ROWS
    QB, Qb = (Qn // v.qb, v.qb) if v.qb > 0 and Qn > v.qb and Qn % v.qb == 0 else (1, Qn)
    sigv_pos = (sigv > 0.0).to(F32)
    if P == 1:
        sig_pos = sigv_pos
    else:
        idx = np.arange(NP)
        ia = torch.as_tensor(idx // P, device=dev)
        ib = torch.as_tensor(np.minimum(idx // P + 1, sigv.shape[0] - 1), device=dev)
        interior = torch.as_tensor((idx % P) > 0, dtype=F32, device=dev)[:, None, None]
        sig_pos = torch.maximum(sigv_pos[ia], interior * sigv_pos[ib])

    def reach(b, k, n_blocks, blk, n_idx):
        p0 = torch.arange(n_blocks, dtype=F32, device=dev) * blk
        e0 = b[:, None] + k[:, None] * p0[None, :]
        e1 = b[:, None] + k[:, None] * (p0 + (blk - 1))[None, :]
        lo = torch.minimum(e0, e1) - 1.0
        hi = torch.maximum(e0, e1) + 1.0
        idx_f = torch.arange(n_idx, dtype=F32, device=dev)
        return ((idx_f >= lo[..., None]) & (idx_f <= hi[..., None])).to(F32)

    umask = reach(geom[:, 2], geom[:, 3], PB, Pb, nu)
    vmask = reach(geom[:, 4], geom[:, 5], QB, Qb, nv)
    uq = torch.einsum("juv,jqv->juq", sig_pos, vmask)
    live = torch.einsum("jbu,juq->jbq", umask, uq) > 0.0  # [NP, PB, QB]
    zero = torch.zeros((1, PB, QB), dtype=torch.bool, device=dev)
    prev = torch.cat([zero, live[:-1]], 0)
    nxt = torch.cat([live[1:], zero], 0)
    return (prev | live), (prev | live | nxt), Pb, Qb


# -------------------------------------------------------------------- march


class _ReluTrap(torch.autograd.Function):
    """The mean of relu over a cell whose density is linear between ``a`` and
    ``b``, with the closed-form endpoint derivatives as its gradient."""

    @staticmethod
    def forward(ctx, a, b):
        integ, tbar, dida, didb = relu_trap(a, b)
        ctx.save_for_backward(dida, didb)
        ctx.mark_non_differentiable(tbar)
        return integ, tbar

    @staticmethod
    def backward(ctx, g_integ, g_tbar):
        dida, didb = ctx.saved_tensors
        return g_integ * dida, g_integ * didb


def relu_trap(a: torch.Tensor, b: torch.Tensor):
    """(integ, tbar, dI/da, dI/db) of I = int_0^1 relu(a + (b - a) t) dt, in the
    factored form that avoids cancellation."""
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    three = torch.full((), 3.0, dtype=a.dtype, device=a.device)
    p = torch.maximum(a, zero)
    q = torch.maximum(b, zero)
    s = a - b
    both = torch.abs(s) <= 1e-6
    safe = torch.where(both, torch.ones_like(s), s)
    integ = torch.where(both, 0.5 * (p + q), 0.5 * (p + q) * (p - q) / safe)
    ts = torch.clamp(a / safe, 0.0, 1.0)

    def antider(t):
        return a * t * t * 0.5 + (b - a) * t * t * t / three

    pos_a, pos_b = a > 0.0, b > 0.0
    F1 = antider(1.0)
    Fts = antider(ts)
    num = torch.where(pos_a & pos_b, F1, torch.where(pos_a, Fts, F1 - Fts))
    num = torch.where(pos_a | pos_b, num, zero)
    tbar = torch.clamp(num / torch.clamp_min(integ, 1e-9), 0.0, 1.0)
    om = 1.0 - ts
    half = torch.full((), 0.5, dtype=a.dtype, device=a.device)
    dida = torch.where(pos_a & pos_b, half, torch.where(
        pos_a, ts - 0.5 * ts * ts, torch.where(pos_b, 0.5 * om * om, zero)))
    didb = torch.where(pos_a & pos_b, half, torch.where(
        pos_a, 0.5 * ts * ts, torch.where(pos_b, 0.5 * (1.0 - ts * ts), zero)))
    return integ, tbar, dida, didb


def _round(x: torch.Tensor, dt) -> torch.Tensor:
    """The renderer's bf16 roundings (a no-op when the computation is bf16)."""
    return x.to(BF16).to(dt)


def _taps(pos: torch.Tensor, n: int, dt):
    k0 = torch.floor(pos)
    k1 = k0 + 1.0
    w0 = _round(torch.clamp_min(1.0 - torch.abs(pos - k0), 0.0), dt)
    w1 = _round(torch.clamp_min(1.0 - torch.abs(pos - k1), 0.0), dt)
    w0 = torch.where((k0 >= 0) & (k0 <= n - 1), w0, torch.zeros((), dtype=dt, device=pos.device))
    w1 = torch.where((k1 >= 0) & (k1 <= n - 1), w1, torch.zeros((), dtype=dt, device=pos.device))
    return k0.clamp(0, n - 1).long(), k1.clamp(0, n - 1).long(), w0, w1


def march(verts: Sequence[torch.Tensor], geom, ybasis, norm, flags, v: Variant,
          Pn: int, Qn: int, dt=F32) -> torch.Tensor:
    """Front-to-back march of the whole texel frame. ``verts`` holds each
    vertex slice [nu, nv, C] (bf16 values). Returns the state [6 or 9, Pn,
    Qn]: T, colour, accumulated weight, depth (, diffuse colour)."""
    cell_live, pos_needed, Pb, Qb = flags
    NP = geom.shape[0]
    nu, nv = verts[0].shape[0], verts[0].shape[1]
    nc, P, dev = v.ncoeff, v.P, geom.device
    used = 3 * nc + 1
    yb = ybasis.to(dt)
    nm = norm.to(dt)
    pf = torch.arange(Pn, dtype=F32, device=dev)
    qf = torch.arange(Qn, dtype=F32, device=dev)

    def values(j):
        s_j, _, bu, ku, bv, kv = geom[j]
        U = bu + ku * pf
        V = bv + kv * qf
        live = (((U >= -0.5) & (U <= nu - 0.5) & (s_j > 0.0))[:, None]
                & ((V >= -0.5) & (V <= nv - 0.5))[None, :]).to(dt)
        ia = min(j // P, len(verts) - 1)
        sl = verts[ia][..., :used].to(dt)  # [nu, nv, used]
        if P > 1:
            f = (j % P) * (1.0 / P)
            sl = _round((1.0 - f) * sl + f * verts[min(j // P + 1, len(verts) - 1)][..., :used]
                        .to(dt), dt)
        u0, u1, wu0, wu1 = _taps(U, nu, dt)
        t1 = _round(wu0[:, None, None] * sl[u0] + wu1[:, None, None] * sl[u1], dt)
        v0, v1, wv0, wv1 = _taps(V, nv, dt)
        val = wv0[None, :, None] * t1[:, v0] + wv1[None, :, None] * t1[:, v1]  # [Pn, Qn, used]
        sig = val[..., 3 * nc]
        rgb = []
        for c in range(3):
            a = yb[0] * val[..., c * nc]
            for k in range(1, nc):
                a = a + yb[k] * val[..., c * nc + k]
            rgb.append(a)
        dif = [yb[0] * val[..., c * nc] for c in range(3)]
        return sig, rgb, dif, live

    def texels(fl, j):
        return fl[j].repeat_interleave(Pb, 0).repeat_interleave(Qb, 1)

    zeros = torch.zeros((Pn, Qn), dtype=dt, device=dev)
    T = torch.ones((Pn, Qn), dtype=dt, device=dev)
    col, dif = [zeros] * 3, [zeros] * 3
    acc = dep = zeros
    prev_sig = prev_live = zeros
    prev_rgb, prev_dif = [zeros] * 3, [zeros] * 3
    for j in range(NP):
        work = texels(pos_needed, j)
        if not bool(pos_needed[j].any()):
            continue
        s_j, cell_step = geom[j, 0], geom[j, 1]
        sig, rgb, dif_j, live = values(j)
        if j > 0:
            upd = work & texels(cell_live, j)
            integ, tbar = _ReluTrap.apply(prev_sig, sig)
            integ = integ * (prev_live * live)
            delta = cell_step * nm
            alpha = 1.0 - torch.exp(-integ * delta)
            w = alpha * T
            s_mid = (s_j - cell_step + tbar * cell_step) * nm
            tb1 = 1.0 - tbar
            col = [torch.where(upd, col[c] + torch.sigmoid(tb1 * prev_rgb[c] + tbar * rgb[c]) * w,
                               col[c]) for c in range(3)]
            acc = torch.where(upd, acc + w, acc)
            dep = torch.where(upd, dep + w * s_mid, dep)
            if v.with_diffuse:
                dif = [torch.where(upd, dif[c] + torch.sigmoid(
                    tb1 * prev_dif[c] + tbar * dif_j[c]) * w, dif[c]) for c in range(3)]
            T = torch.where(upd, T * (1.0 - alpha), T)
        prev_sig = torch.where(work, sig, prev_sig)
        prev_rgb = [torch.where(work, rgb[c], prev_rgb[c]) for c in range(3)]
        prev_dif = [torch.where(work, dif_j[c], prev_dif[c]) for c in range(3)]
        prev_live = torch.where(work, live, prev_live)
    rows = [T, *col, acc, dep] + (dif if v.with_diffuse else [])
    return torch.stack(rows, dim=0)


# --------------------------------------------------------------------- warp


def _catmull_rom(t: torch.Tensor) -> torch.Tensor:
    at = torch.abs(t)
    inner = (1.5 * at - 2.5) * at * at + 1.0
    outer = ((-0.5 * at + 2.5) * at - 4.0) * at + 2.0
    return torch.where(at < 1.0, inner, torch.where(at < 2.0, outer, 0.0))


def resample(X: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Catmull-Rom resample of each row of X [NB, CH, K] at pos [NB, N] over
    the four taps, clipped to the hull of the two central taps."""
    NB, CH, K = X.shape
    k0 = torch.floor(pos)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)

    def tap(k):
        idx = k.clamp(0, K - 1).long()[:, None, :].expand(NB, CH, -1)
        return torch.where(((k >= 0) & (k <= K - 1))[:, None, :], torch.gather(X, 2, idx), zero)

    out = torch.zeros((NB, CH, pos.shape[1]), dtype=X.dtype, device=X.device)
    for d in (-1.0, 0.0, 1.0, 2.0):
        k = k0 + d
        w = torch.where((k >= 0) & (k <= K - 1), _catmull_rom(k - pos), 0.0).to(X.dtype)
        out = out + w[:, None, :] * tap(k)
    t0, t1 = tap(k0), tap(k0 + 1.0)
    return torch.minimum(torch.maximum(out, torch.minimum(t0, t1)), torch.maximum(t0, t1))


def _finite_clip(x, lo, hi):
    return torch.nan_to_num(x, nan=lo, posinf=hi, neginf=lo).clamp(lo, hi)


def warp(state: torch.Tensor, xr, yr, rotation: torch.Tensor, v: Variant, height: int,
         width: int, focal: torch.Tensor, Pn: int, Qn: int, swap: bool) -> Dict[str, torch.Tensor]:
    """The composited state to the camera's pixels through the two-pass
    projective warp: colour, accumulated weight, depth (, diffuse), white
    background composited."""
    axis = v.axis
    u_ax, v_ax = uv_axes(axis)
    g = -1.0 if v.flip else 1.0
    dev, dt = state.device, state.dtype
    nch = 8 if v.with_diffuse else 5
    Hp = -(-height // 128) * 128
    Wp = -(-width // 128) * 128
    src = state[1:1 + nch]
    if nch < 8:
        src = torch.cat([src, torch.zeros((8 - nch,) + src.shape[1:], dtype=dt, device=dev)])
    x0, x1 = xr
    y0, y1 = yr
    sp = (Pn - 1) / (x1 - x0)
    sq = (Qn - 1) / (y1 - y0)
    Ru = [rotation[u_ax, 0], rotation[u_ax, 1], -rotation[u_ax, 2]]
    Rv = [rotation[v_ax, 0], rotation[v_ax, 1], -rotation[v_ax, 2]]
    Ra = [rotation[axis, 0], rotation[axis, 1], -rotation[axis, 2]]
    Pc = [sp * (g * Ru[i] - x0 * Ra[i]) for i in range(3)]
    Qc = [sq * (g * Rv[i] - y0 * Ra[i]) for i in range(3)]

    r = torch.arange(Hp, dtype=F32, device=dev)
    cy = -(r + 0.5 - height / 2) / focal
    inv_f = 1.0 / focal
    cx_off = (0.5 - width / 2) / focal

    def affine(T):
        return T[0] * inv_f, T[0] * cx_off + T[1] * cy + T[2]

    pa, pb = affine(Pc)
    qa, qb = affine(Qc)
    da, db = affine(Ra)
    pa, qa, da = pa.expand(Hp), qa.expand(Hp), da.expand(Hp)
    eps = 1e-20
    den0 = da * 0.0 + db
    den1 = da * float(width - 1) + db
    p0 = (pa * 0.0 + pb) / den0
    p1 = (pa * float(width - 1) + pb) / den1
    q0 = (qa * 0.0 + qb) / den0
    q1 = (qa * float(width - 1) + qb) / den1
    dp, dq = p1 - p0, q1 - q0
    beta_q = dq / torch.where(torch.abs(dp) < eps, eps, dp)
    alpha_q = q0 - beta_q * p0
    beta_p = dp / torch.where(torch.abs(dq) < eps, eps, dq)
    alpha_p = p0 - beta_p * q0
    carr = torch.arange(Wp, dtype=F32, device=dev)
    den = da[:, None] * carr[None, :] + db[:, None]
    den = torch.where(torch.abs(den) < 1e-20, 1e-20, den)
    if not swap:
        K2, first = Pn, src.permute(1, 0, 2).contiguous()
        line_pos = _finite_clip(alpha_q[None, :] + beta_q[None, :]
                                * torch.arange(Pn, dtype=F32, device=dev)[:, None], 1.0, Qn - 2.0)
        pix_pos = _finite_clip((pa[:, None] * carr[None, :] + pb[:, None]) / den, 1.0, Pn - 2.0)
    else:
        K2, first = Qn, src.permute(2, 0, 1).contiguous()
        line_pos = _finite_clip(alpha_p[None, :] + beta_p[None, :]
                                * torch.arange(Qn, dtype=F32, device=dev)[:, None], 1.0, Pn - 2.0)
        pix_pos = _finite_clip((qa[:, None] * carr[None, :] + qb[:, None]) / den, 1.0, Qn - 2.0)
    inter = resample(first, line_pos).permute(2, 1, 0)  # [Hp, CH, K2]
    K2p = -(-K2 // 128) * 128
    if K2p != K2:
        inter = torch.cat([inter, torch.zeros((Hp, 8, K2p - K2), dtype=dt, device=dev)], dim=2)
    out = resample(inter.contiguous(), pix_pos).permute(0, 2, 1)[:height, :width, :]

    px = torch.arange(width, dtype=F32, device=dev) + 0.5
    py = torch.arange(height, dtype=F32, device=dev) + 0.5
    cxp = (px[None, :] - width / 2) / focal
    cyp = -(py[:, None] - height / 2) / focal
    dnorm = torch.sqrt(1.0 + cxp * cxp + cyp * cyp)[..., None].to(dt)
    acc = out[..., 3:4]
    res = {"colour": out[..., 0:3] + (1.0 - acc), "acc": acc, "depth": out[..., 4:5] / dnorm}
    if v.with_diffuse:
        res["diffuse"] = out[..., 5:8] + (1.0 - acc)
    return res


# ------------------------------------------------------------------ entries


def render_view(verts: Sequence[torch.Tensor], v: Variant, rotation: np.ndarray,
                origin: np.ndarray, focal: float, height: int, width: int,
                config_ss: float, phase=None, basis: bool = True, dt=F32):
    """One pose's render from the vertex slices (each [nu, nv, C], bf16 values)."""
    dev = verts[0].device
    ss = supersample_for(v, config_ss, height, width)
    Pn, Qn = frame(height, width, ss)
    rot = torch.as_tensor(np.asarray(rotation, np.float32)).to(dev)
    org = torch.as_tensor(np.asarray(origin, np.float32)).to(dev)
    foc = torch.tensor(float(focal), dtype=F32, device=dev)
    with torch.no_grad():
        geom, xr, yr, yb, nm = geometry(rot, org, v, height, width, foc, ss, phase, basis)
        sigv = torch.stack([t.detach()[..., 3 * v.ncoeff] for t in verts])
        flags = occupancy(sigv, geom, v, Pn, Qn)
    state = march(verts, geom, yb, nm, flags, v, Pn, Qn, dt)
    swap = warp_swap(rotation, v.axis, v.flip, height, width, float(focal))
    return warp(state, xr, yr, rot, v, height, width, foc, Pn, Qn, swap)


def view_loss(out: Dict[str, torch.Tensor], image: torch.Tensor) -> torch.Tensor:
    """Specular L1 plus, with the diffuse output, diffuse L1."""
    image = image.to(out["colour"].dtype)
    loss = torch.mean(torch.abs(out["colour"] - image))
    if "diffuse" in out:
        loss = loss + torch.mean(torch.abs(out["diffuse"] - image))
    return loss


def step_gradient(grid: Grid, images, rotations, origins, focal: float, phases,
                  config_ss: float, with_diffuse: bool = True, dt=F32):
    """The mean over the views (all of one march variant) of the whole-pose
    loss, and its gradient with respect to (densities, features). Returns
    (loss, [grad_densities, grad_features])."""
    dens = grid.densities.detach().to(dt).requires_grad_(True)
    feats = grid.features.detach().to(dt).requires_grad_(True)
    g = Grid(dens, feats, grid.voxel_size, grid.density_scale)
    v = variant_for(grid, rotations[0], with_diffuse)
    stack = vertex_stack(g, v)
    leaf = stack.detach().requires_grad_(True)
    verts = leaf.to(BF16).unbind(0)
    k = len(images)
    total = 0.0
    for i in range(k):
        h, w = images[i].shape[:2]
        out = render_view(verts, v, rotations[i], origins[i], focal, h, w, config_ss,
                          phase=phases[i], dt=dt)
        loss = view_loss(out, images[i])
        loss.backward(retain_graph=i + 1 < k)
        total = total + float(loss.detach())
        del out, loss
    stack.backward(leaf.grad / k)
    return total / k, [dens.grad, feats.grad]


def adam_update(params, grads, state, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> None:
    """One Adam step in place (torch.optim.Adam's formula, bias-corrected)."""
    state["t"] = state.get("t", 0) + 1
    t = state["t"]
    for i, (p, g) in enumerate(zip(params, grads)):
        m = state.setdefault(("m", i), torch.zeros_like(p))
        s = state.setdefault(("v", i), torch.zeros_like(p))
        m.lerp_(g, 1 - b1)
        s.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (s.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
        p.addcdiv_(m, denom, value=-(lr / (1 - b1 ** t)))


@torch.no_grad()
def render_frame(grid: Grid, rotation, origin, focal: float, height: int, width: int,
                 config_ss: float, dt=F32) -> Dict[str, torch.Tensor]:
    """A serving frame (no phase, no diffuse output): colour, depth, acc."""
    g = Grid(grid.densities.to(dt), grid.features.to(dt), grid.voxel_size, grid.density_scale)
    v = variant_for(grid, rotation, with_diffuse=False)
    verts = vertex_stack(g, v).to(BF16).unbind(0)
    return render_view(verts, v, rotation, origin, focal, height, width, config_ss,
                       basis=False, dt=dt)
