"""The plane-march kernels of the planes renderer: constants, plain PyTorch
versions, the CUDA kernel wrappers and the differentiable ``plane_march``.

Counterpart of thr3ed_atom_tpu/ops/pallas/plane_march.py. The scene grid is
repacked per march variant as ``[XG, U_pad, V_pad, GS * 32]`` bf16: lane block
k of group g holds march position ``g * (GS - 1) + k`` (3 * ncoeff SH
features, the density, zero pad), so consecutive groups share one position.
Rays come in tiles of R = tile_px^2 with a 48-lane record each (the ``L_*``
lanes); a per-tile table lists the tile's (group, patch origin u0 / v0,
position subrange) entries front to back. For each entry a ray samples its
GS = 8 positions bilinearly at ``u = au + bu * j - u0``, ``v = av + bv * j -
v0`` (j the global position) with bf16 tents over the [PU, PV] patch anchored
at (u0, v0) (taps outside the patch weigh nothing; a dead position
interpolates to 0), folds the SH basis, and composites the GS - 1 cells
between consecutive live positions: the closed-form integral of the relu'd
(or identity) linear density between them (relu_trap, K1a), the sigmoid of
the raw colours lerped to the density centroid tbar, depth at the centroid,
``alpha = 1 - exp(-I * delta)``. A tile stops after an entry once every ray's
transmittance is at most ``exit_eps``.

K11 (``plane_march_render``, csrc/plane_march.cu) renders; K12
(``plane_march_grad``, csrc/plane_march_backward.cu) replays the march from the
forward totals and accumulates the repacked grid's cotangent, with tbar held
constant (the reference's convention), summing each position step's taps by
patch cell first (``plane_backward_plan`` sizes its buckets). On a CPU tensor
each wrapper runs its plain version; on a CUDA tensor it launches its kernel
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from thr3ed_atom_tpu_torch import kernels
from thr3ed_atom_tpu_torch.ops import slab_march as slab
from thr3ed_atom_tpu_torch.ops.relu_trap import relu_trap_plain
from thr3ed_atom_tpu_torch.ops.slab_march import _bf16r, _Entry, _entry_meta, _interp, _lib

F32 = torch.float32
BF16 = torch.bfloat16

GS = 8  # positions per group -> GS - 1 cells per entry
STRIDE = GS - 1  # group step: groups overlap by one position
LANES_PER_POS = 32  # 27 SH features + 1 density + 4 pad (SH degree <= 2)
LAN = GS * LANES_PER_POS  # 256 lanes per patch row
PU = 16  # patch extent (vertices) along u
PV = 24  # patch extent along v (patch origins are 8-aligned)

# per-ray feature lanes ([T, R, RAY_LANES] f32)
L_AU, L_BU, L_AV, L_BV, L_AT, L_BT, L_JMIN, L_JMAX, L_DELTA = range(9)
L_Y0 = 16  # 32 lanes of SH basis values Y_{c % ncoeff}(viewdir) start here
RAY_LANES = L_Y0 + LANES_PER_POS  # 48, as the slab march's


def _check(what, tables, counts, rays, grid, ncoeff):
    slab._check(what, tables, counts, rays, grid, ncoeff, LAN, (PU, PV))


class _Position:
    """Position k of one table entry of every tile: its sample (``ent``: taps,
    liveness) and raw fold, each [T, R]: the density lane, the SH-folded rgb
    over lanes c < 3 ncoeff in ascending c, the band-0 (diffuse) colour."""

    def __init__(self, rays, grid_rows, meta, k: int, shape, running, goff, ncoeff):
        xg, u0, v0, jlo, jhi = meta
        self.ent = _Entry(rays, xg, u0, v0, jlo, jhi, k, shape, running, stride=STRIDE,
                          patch=(PU, PV), goff=goff)
        self.live = self.ent.live
        nf = 3 * ncoeff
        ch = _interp(grid_rows, self.ent, k, nf + 1)
        chy = ch[..., :nf] * rays[..., L_Y0:L_Y0 + nf]
        self.rgb, self.dif = [], []
        for c in range(3):
            a = chy[..., c * ncoeff]
            self.dif.append(a)
            for j in range(1, ncoeff):
                a = a + chy[..., c * ncoeff + j]
            self.rgb.append(a)
        self.sigma = ch[..., nf]


class _Cell:
    """The cell between positions ``a`` and ``b`` (cell ``c`` of an entry whose
    first global position is ``base`` [T, 1]): composited only when both are
    live; the closed-form integral (zeroed on a dead cell), the opacity, the
    emitted colours at the density centroid and the centroid's depth."""

    def __init__(self, a: _Position, b: _Position, rays, base, c: int, relu_sigma: bool,
                 with_diffuse: bool):
        integ, self.tbar, self.dIda, self.dIdb = relu_trap_plain(a.sigma, b.sigma, relu_sigma)
        self.live = a.live & b.live
        integ = torch.where(self.live, integ, 0.0)
        self.alpha = torch.clamp(1.0 - torch.exp(-integ * rays[..., L_DELTA]), 0.0, 1.0)
        tb = self.tbar
        self.mid = [torch.sigmoid((1.0 - tb) * a.rgb[j] + tb * b.rgb[j]) for j in range(3)]
        self.dmid = ([torch.sigmoid((1.0 - tb) * a.dif[j] + tb * b.dif[j]) for j in range(3)]
                     if with_diffuse else None)
        self.s_dep = rays[..., L_AT] + rays[..., L_BT] * ((base + float(c)) + tb)


def _march_setup(tables, counts, rays, grid):
    T, G, _ = tables.shape
    R = rays.shape[1]
    XG, U, V, _ = grid.shape
    dev = rays.device
    grid_rows = grid.reshape(XG * U * V, GS, LANES_PER_POS)
    cnt = counts[:, 0].to(dev)
    n_iter = min(int(cnt.max()) if T else 0, G)
    zeros = torch.zeros((T, R), dtype=F32, device=dev)
    return (XG, U, V), grid_rows, cnt, n_iter, zeros


def _entry(rays, grid_rows, tables, i, shape, running, goff, ncoeff, relu_sigma,
           with_diffuse):
    meta = _entry_meta(tables, i)
    base = (meta[0] * STRIDE).to(F32)[:, None]
    pos = [_Position(rays, grid_rows, meta, k, shape, running, goff, ncoeff)
           for k in range(GS)]
    cells = [_Cell(pos[c], pos[c + 1], rays, base, c, relu_sigma, with_diffuse)
             for c in range(STRIDE)]
    return pos, cells


def plane_march_render_plain(tables, counts, rays, grid, *, ncoeff: int,
                             relu_sigma: bool = False, exit_eps: float = 1e-4,
                             with_diffuse: bool = False, group_offset: int = 0,
                             return_work: bool = False):
    """Plain PyTorch version of the TPU kernel
    thr3ed_atom_tpu/ops/pallas/plane_march.py plane_march_render: every tile's
    march, entry by entry, vectorized over tiles and rays. Per entry and
    position the bf16 tents of the sample (f32 ``u - uq`` rounded to bf16,
    ``1 - |du|`` rounded, the product ``wu * wv`` rounded) weigh the patch's
    taps, whose exact bf16 products sum in ascending patch row; the colour
    folds in ascending lane; per entry the cells' contributions sum from zero
    and are then added to the state; a tile stops before an entry once its
    max transmittance is at most ``exit_eps``. Returns [T, R, 8] f32: rgb, acc,
    depth, diffuse rgb (zero without ``with_diffuse``); with ``return_work``
    also the work the march did, (live positions marched, position records
    read: a bool mask over the grid's [XG * U * V * GS] 32-lane blocks)."""
    _check("plane_march_render_plain", tables, counts, rays, grid, ncoeff)
    shape, grid_rows, cnt, n_iter, zeros = _march_setup(tables, counts, rays, grid)
    dev = rays.device
    trans = torch.ones_like(zeros)
    state = [zeros] * 8
    running = torch.ones(tables.shape[0], dtype=torch.bool, device=dev)
    n_pos = 0
    touched = (torch.zeros(grid_rows.shape[0] * GS, dtype=torch.bool, device=dev)
               if return_work else None)
    for i in range(n_iter):
        running = running & (i < cnt) & (trans.amax(dim=1) > exit_eps)
        if not bool(running.any()):
            break
        pos, cells = _entry(rays, grid_rows, tables, i, shape, running, group_offset, ncoeff,
                            relu_sigma, with_diffuse)
        if return_work:
            for k, p in enumerate(pos):
                n_pos += int(p.live.sum())
                touched[(p.ent.rows * GS + k)[p.ent.w > 0.0]] = True
        acc = [zeros] * 8
        T_cur = trans
        for cell in cells:
            w = cell.alpha * T_cur
            for c in range(3):
                acc[c] = acc[c] + cell.mid[c] * w
            acc[3] = acc[3] + w
            acc[4] = acc[4] + w * cell.s_dep
            if with_diffuse:
                for c in range(3):
                    acc[5 + c] = acc[5 + c] + cell.dmid[c] * w
            T_cur = T_cur * (1.0 - cell.alpha)
        run = running[:, None]
        state = [torch.where(run, s + a, s) for s, a in zip(state, acc)]
        trans = torch.where(run, T_cur, trans)
    out = torch.stack(state, dim=-1)
    return (out, (n_pos, touched)) if return_work else out


def plane_march_grad_plain(tables, counts, rays, grid, fwd_out, gout, *, ncoeff: int,
                           relu_sigma: bool = False, exit_eps: float = 1e-4,
                           with_diffuse: bool = False, group_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel
    thr3ed_atom_tpu/ops/pallas/plane_march.py _backward_impl: the replay VJP
    of the plane march with respect to the repacked grid. The march is
    replayed as ``plane_march_render_plain`` runs it, carrying the
    transmittance and the prefix sums P of the cells' contributions across
    all cells and entries; with the forward totals ``fwd_out`` the suffix S =
    totals - P gives, per live cell,
    ``dI = delta * ((1 - alpha) T <g, x> - <g, S>)``, split onto its two
    positions by dI/da and dI/db; the colour cotangents pass the sigmoid and
    lerp back with (1 - tbar, tbar), tbar held constant. Position k takes the
    shares of cells k and k - 1; its channel cotangents, rounded to bf16, times
    the taps' bf16 weights are added into an f32 grid cotangent. Returns
    [XG, U, V, 256] f32 (the caller casts to the grid's bf16, as JAX)."""
    _check("plane_march_grad_plain", tables, counts, rays, grid, ncoeff)
    shape, grid_rows, cnt, n_iter, zeros = _march_setup(tables, counts, rays, grid)
    dev = rays.device
    nf, nused = 3 * ncoeff, 3 * ncoeff + 1
    dgrid = torch.zeros((grid_rows.shape[0] * GS, LANES_PER_POS), dtype=F32, device=dev)
    tot = fwd_out.to(F32)
    g = gout.to(F32)
    delta = rays[..., L_DELTA]
    yb = rays[..., L_Y0:L_Y0 + nf]
    trans = torch.ones_like(zeros)
    P = [zeros] * 8
    running = torch.ones(tables.shape[0], dtype=torch.bool, device=dev)
    for i in range(n_iter):
        running = running & (i < cnt) & (trans.amax(dim=1) > exit_eps)
        if not bool(running.any()):
            break
        pos, cells = _entry(rays, grid_rows, tables, i, shape, running, group_offset, ncoeff,
                            relu_sigma, with_diffuse)
        T_cur = trans
        d_a, d_b, rgb_a, rgb_b, dif_a, dif_b = [], [], [], [], [], []
        for cell in cells:
            w = cell.alpha * T_cur
            contrib = [cell.mid[c] * w for c in range(3)] + [w, w * cell.s_dep]
            contrib += [cell.dmid[c] * w for c in range(3)] if with_diffuse else [zeros] * 3
            P = [p + x for p, x in zip(P, contrib)]
            S = [tot[..., k] - P[k] for k in range(8)]
            mid = cell.mid
            inner = (((g[..., 0] * mid[0] + g[..., 1] * mid[1]) + g[..., 2] * mid[2])
                     + g[..., 3]) + g[..., 4] * cell.s_dep
            suff = (((g[..., 0] * S[0] + g[..., 1] * S[1]) + g[..., 2] * S[2])
                    + g[..., 3] * S[3]) + g[..., 4] * S[4]
            if with_diffuse:
                dmid = cell.dmid
                inner = inner + ((g[..., 5] * dmid[0] + g[..., 6] * dmid[1])
                                 + g[..., 7] * dmid[2])
                suff = suff + ((g[..., 5] * S[5] + g[..., 6] * S[6]) + g[..., 7] * S[7])
            dinteg = delta * ((1.0 - cell.alpha) * T_cur * inner - suff)
            dinteg = torch.where(cell.live, dinteg, 0.0)
            d_a.append(dinteg * cell.dIda)
            d_b.append(dinteg * cell.dIdb)
            dm = [g[..., c] * w * mid[c] * (1.0 - mid[c]) for c in range(3)]
            rgb_a.append([(1.0 - cell.tbar) * x for x in dm])
            rgb_b.append([cell.tbar * x for x in dm])
            if with_diffuse:
                dd = [g[..., 5 + c] * w * cell.dmid[c] * (1.0 - cell.dmid[c]) for c in range(3)]
                dif_a.append([(1.0 - cell.tbar) * x for x in dd])
                dif_b.append([cell.tbar * x for x in dd])
            T_cur = T_cur * (1.0 - cell.alpha)
        zero3 = [zeros] * 3
        for k, p in enumerate(pos):
            # position k: cell k's a-share plus cell k - 1's b-share
            ka, kb = k < STRIDE, k > 0
            d_sig = (d_a[k] if ka else zeros) + (d_b[k - 1] if kb else zeros)
            d_rgb = [x + y for x, y in zip(rgb_a[k] if ka else zero3,
                                           rgb_b[k - 1] if kb else zero3)]
            if with_diffuse:
                d_dif = [x + y for x, y in zip(dif_a[k] if ka else zero3,
                                               dif_b[k - 1] if kb else zero3)]
            cols = []
            for chn in range(nf):
                c, j = divmod(chn, ncoeff)
                d = d_rgb[c]
                if with_diffuse and j == 0:
                    d = d + d_dif[c]
                cols.append(d * yb[..., chn])
            cols.append(d_sig)
            d_int = _bf16r(torch.stack(cols, -1))  # [T, R, nused]
            vals = p.ent.w[..., None] * d_int[..., None, :]  # [T, R, 4, nused]
            idx = (p.ent.rows * GS + k).reshape(-1)
            src = torch.zeros((idx.numel(), LANES_PER_POS), dtype=F32, device=dev)
            src[:, :nused] = vals.reshape(-1, nused)
            dgrid.index_add_(0, idx, src)
        trans = torch.where(running[:, None], T_cur, trans)
    return dgrid.reshape(tuple(grid.shape[:3]) + (LAN,))


def _cuda_operands(what, tables, counts, rays, grid, ncoeff):
    return slab._cuda_operands(what, tables, counts, rays, grid, ncoeff, LAN, (PU, PV))


def plane_march_render(tables, counts, rays, grid, *, ncoeff: int, relu_sigma: bool = False,
                       exit_eps: float = 1e-4, with_diffuse: bool = False,
                       group_offset: int = 0) -> torch.Tensor:
    """The plane-march render (K11): [T, R, 8] f32 from tables [T, G, 4] int32
    (global group indices; ``group_offset`` rebases them onto ``grid``),
    counts [T, 1], rays [T, R, 48] f32 and the repacked grid [XG, U, V, 256]
    bf16. On a CUDA tensor one launch of csrc/plane_march.cu (a block per
    tile, a group of lanes per ray: ``slab_march.march_launch_shape``); on a
    CPU tensor ``plane_march_render_plain``."""
    if grid.device.type == "cpu":
        return plane_march_render_plain(tables, counts, rays, grid, ncoeff=ncoeff,
                                        relu_sigma=relu_sigma, exit_eps=exit_eps,
                                        with_diffuse=with_diffuse, group_offset=group_offset)
    (tab, cnt, rays, grid), dev = _cuda_operands("plane_march_render", tables, counts,
                                                 rays, grid, ncoeff)
    T, G, _ = tab.shape
    XG, U, V, _ = grid.shape
    out = torch.empty((T, rays.shape[1], 8), dtype=F32, device=dev)
    err = _lib("plane_march", "plane_march_launch", 5, 10)(
        tab.data_ptr(), cnt.data_ptr(), rays.data_ptr(), grid.data_ptr(), out.data_ptr(),
        T, G, rays.shape[1], XG, U, V, ncoeff, int(relu_sigma), int(with_diffuse),
        int(group_offset), float(exit_eps), kernels.stream(out))
    kernels.check(err, "plane_march")
    plane_march_render.launches += 1
    return out


plane_march_render.launches = 0


def plane_backward_plan(R: int, ncoeff: int) -> slab.SlabBackwardPlan:
    """K12's buckets for tiles of R rays: ``slab.slab_backward_plan`` on the
    planes patch [PU, PV] = [16, 24]: 2 R cells, at most the 17 x 25 = 425
    cells a patch's taps have corners in, so no box of a 256-ray tile's
    position step exceeds the buckets."""
    return slab.slab_backward_plan(R, ncoeff, (PU, PV))


def plane_backward_launch_shape(R: int, ncoeff: int, relu_sigma: bool = False,
                                with_diffuse: bool = False):
    """K12's launch at tiles of R rays on the current card, with
    ``plane_backward_plan``'s shared memory: (ptxas's registers a thread, the
    blocks an SM holds by cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    threads a block)."""
    plan = plane_backward_plan(R, ncoeff)
    out = (ctypes.c_int * 3)()
    err = kernels.bind("plane_march_backward", "plane_march_backward_occupancy",
                       [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p])(
        R, ncoeff, int(relu_sigma), int(with_diffuse), plan.smem, ctypes.addressof(out))
    kernels.check(err, "plane_march_backward_occupancy")
    return tuple(out)


def plane_march_grad(tables, counts, rays, grid, fwd_out, gout, *, ncoeff: int,
                     relu_sigma: bool = False, exit_eps: float = 1e-4,
                     with_diffuse: bool = False, group_offset: int = 0, stats=None,
                     dgrid=None) -> torch.Tensor:
    """The replay VJP of the plane march (K12): the grid cotangent
    [XG, U, V, 256] f32 (see ``plane_march_grad_plain``). On a CUDA tensor one
    launch of csrc/plane_march_backward.cu, which sums each position step's
    tap products over the tile's rays by patch cell in shared memory and
    adds the sums into the cotangent with f32 atomics (tiles run in no order
    on the card, so the sums round in another order than the plain
    version's); on a CPU tensor the plain version. ``stats`` (a
    four-element int64 CUDA tensor) gets added to it: the tap products, the
    global atomics, and the steps summed in shared memory and added
    directly. ``dgrid`` (a contiguous [XG, U, V, 256] f32 tensor on the
    grid's device) is the cotangent to add into and return instead of a
    zeroed one: the kernel's time apart from the zeroing's."""
    slab._grad_buffers("plane_march_grad", grid, LAN, stats, dgrid)
    if grid.device.type == "cpu":
        g = plane_march_grad_plain(tables, counts, rays, grid, fwd_out, gout,
                                   ncoeff=ncoeff, relu_sigma=relu_sigma,
                                   exit_eps=exit_eps, with_diffuse=with_diffuse,
                                   group_offset=group_offset)
        return g if dgrid is None else dgrid.add_(g)
    (tab, cnt, rays, grid), dev = _cuda_operands("plane_march_grad", tables, counts, rays,
                                                 grid, ncoeff)
    T, G, _ = tab.shape
    R = rays.shape[1]
    XG, U, V, _ = grid.shape
    fwd = fwd_out.to(device=dev, dtype=F32).contiguous()
    g = gout.to(device=dev, dtype=F32).contiguous()
    if tuple(fwd.shape) != (T, R, 8) or tuple(g.shape) != (T, R, 8):
        raise ValueError("plane_march_grad: fwd_out and gout must be [T, R, 8]")
    plan = plane_backward_plan(R, ncoeff)
    if dgrid is None:
        dgrid = torch.zeros((XG, U, V, LAN), dtype=F32, device=dev)
    err = kernels.bind("plane_march_backward", "plane_march_backward_launch",
                       [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                       + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])(
        tab.data_ptr(), cnt.data_ptr(), rays.data_ptr(), grid.data_ptr(), fwd.data_ptr(),
        g.data_ptr(), dgrid.data_ptr(), None if stats is None else stats.data_ptr(),
        T, G, R, XG, U, V, ncoeff, int(relu_sigma), int(with_diffuse), int(group_offset),
        plan.cells, plan.smem, float(exit_eps), kernels.stream(dgrid))
    kernels.check(err, "plane_march_backward")
    plane_march_grad.launches += 1
    return dgrid


plane_march_grad.launches = 0


class _PlaneMarch(torch.autograd.Function):
    """plane_march_render with the replay VJP with respect to the grid; the
    tables, counts and rays are sampling geometry (no gradient)."""

    @staticmethod
    def forward(ctx, tables, counts, rays, grid, ncoeff, relu_sigma, exit_eps, with_diffuse,
                group_offset, plain):
        kw = dict(ncoeff=ncoeff, relu_sigma=relu_sigma, exit_eps=exit_eps,
                  with_diffuse=with_diffuse, group_offset=group_offset)
        out = (plane_march_render_plain if plain else plane_march_render)(
            tables, counts, rays, grid, **kw)
        ctx.save_for_backward(tables, counts, rays, grid, out)
        ctx.kw, ctx.plain = kw, plain
        return out

    @staticmethod
    def backward(ctx, gout):
        tables, counts, rays, grid, out = ctx.saved_tensors
        grad = plane_march_grad_plain if ctx.plain else plane_march_grad
        dgrid = grad(tables, counts, rays, grid, out, gout, **ctx.kw)
        # the reference's VJP returns the cotangent in the grid's dtype (bf16)
        return (None, None, None, dgrid.to(grid.dtype)) + (None,) * 6


def plane_march(tables, counts, rays, grid, *, ncoeff: int, relu_sigma: bool = False,
                exit_eps: float = 1e-4, with_diffuse: bool = False, group_offset: int = 0,
                plain: bool = False) -> torch.Tensor:
    """Differentiable plane-march render: gradients flow to ``grid`` (the
    repacked bf16 position grid) through the replay VJP (K12); ``plain`` runs
    both directions through the plain versions."""
    return _PlaneMarch.apply(tables, counts, rays, grid, int(ncoeff), bool(relu_sigma),
                             float(exit_eps), bool(with_diffuse), int(group_offset),
                             bool(plain))
