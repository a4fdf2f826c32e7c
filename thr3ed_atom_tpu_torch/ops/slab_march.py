"""The slab-march kernels of the bricked renderer: constants, plain PyTorch
versions, the CUDA kernel wrappers and the differentiable ``slab_march``.

Counterpart of thr3ed_atom_tpu/ops/pallas/slab_march.py. The scene grid is
repacked per march variant as ``[XG, U_pad, V_pad, GS * 32]`` bf16 (lane block
b of group g holds slab g * GS + b: 3 * ncoeff SH features, the density, zero
pad); rays come in tiles of R = tile_px^2 with a 48-lane record each (the
``L_*`` lanes); a per-tile table lists the tile's (group, patch origin u0 /
v0, slab subrange) entries front to back. For each entry and each live slab a
ray samples the slab bilinearly at ``u = au + bu * j - u0``, ``v = av + bv * j
- v0`` with bf16 tents over the [PU, PV] patch anchored at (u0, v0) (taps
outside the patch weigh nothing), folds the SH basis, and composites with
``alpha = 1 - exp(-sigma * delta)``; a tile stops after an entry once every
ray's transmittance is at most ``exit_eps``.

K9 (``slab_march_render``, csrc/slab_march.cu) renders; K10
(``slab_march_grad``, csrc/slab_march_backward.cu) replays the march from the
forward totals and accumulates the repacked grid's cotangent. On a CPU tensor
each wrapper runs its plain version; on a CUDA tensor it launches its kernel
or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from thr3ed_atom_tpu_torch import kernels

F32 = torch.float32
BF16 = torch.bfloat16

GS = 4  # slabs per group: one patch serves GS slab crossings
LANES_PER_SLAB = 32  # 27 SH features + 1 density + 4 pad (SH degree <= 2)
LAN = GS * LANES_PER_SLAB  # 128 lanes per patch row
PU = 24  # patch extent (vertices) along u
PV = 32  # patch extent along v (patch origins are 8-aligned)

# per-ray feature lanes ([T, R, RAY_LANES] f32)
RAY_LANES = 48
L_AU, L_BU, L_AV, L_BV, L_AT, L_BT, L_JMIN, L_JMAX, L_DELTA = range(9)
L_Y0 = 16  # 32 lanes of SH basis values Y_{c % ncoeff}(viewdir) start here


def _bf16r(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF16).to(F32)


def _check(what, tables, counts, rays, grid, ncoeff, lan=LAN, patch=(PU, PV)):
    """Validate a march's operands; the plane march passes its own grid row
    width ``lan`` and ``patch``."""
    T, G, four = tables.shape
    R = rays.shape[1]
    if four != 4 or tables.dtype != torch.int32:
        raise ValueError(f"{what}: tables [T, G, 4] int32 required")
    if tuple(counts.shape) != (T, 1):
        raise ValueError(f"{what}: counts [T, 1] required")
    if tuple(rays.shape) != (T, R, RAY_LANES) or rays.dtype != F32:
        raise ValueError(f"{what}: rays [T, R, {RAY_LANES}] f32 required")
    if grid.dim() != 4 or grid.shape[-1] != lan or grid.dtype != BF16:
        raise ValueError(f"{what}: grid [XG, U, V, {lan}] bf16 required")
    if grid.shape[1] < patch[0] or grid.shape[2] < patch[1]:
        raise ValueError(f"{what}: grid smaller than a patch")
    if ncoeff not in (1, 4, 9):
        raise ValueError(f"{what}: ncoeff must be 1, 4 or 9 (SH degree <= 2)")


class _Entry:
    """One table entry of every tile, at slab b: the ray's sample point and
    its bilinear taps over the patch (plain versions). ``live`` [T, R];
    ``rows`` [T, R, 4] indices into the grid's [XG * U * V] rows; ``w``
    [T, R, 4] the bf16 tap weights (in f32), zero for a dead sample or a tap
    outside the patch, in ascending patch row (u-major, then v). The plane
    march (ops/plane_march.py) samples its positions the same way on its own
    group ``stride`` and ``patch``; ``goff`` rebases the tables' group index
    onto the grid operand."""

    def __init__(self, rays, xg, u0, v0, jlo, jhi, b: int, shape, running, stride: int = GS,
                 patch=(PU, PV), goff: int = 0):
        XG, U, V = shape
        jg = (xg.to(F32) * stride + float(b))[:, None]  # [T, 1] global slab index
        self.jg = jg
        u = rays[..., L_AU] + rays[..., L_BU] * jg - u0.to(F32)[:, None]
        v = rays[..., L_AV] + rays[..., L_BV] * jg - v0.to(F32)[:, None]
        live = (jg >= rays[..., L_JMIN]) & (jg <= rays[..., L_JMAX])
        live = live & ((jlo <= b) & (b <= jhi) & running)[:, None]
        self.live = live

        def taps(c, n):
            k0 = torch.floor(c)
            ks, ws = [], []
            for k in (k0, k0 + 1.0):
                du = _bf16r(c - k)
                w = torch.clamp_min(_bf16r(1.0 - torch.abs(du)), 0.0)
                inside = (k >= 0.0) & (k <= float(n - 1))
                ws.append(torch.where(inside, w, 0.0))
                ks.append(torch.where(inside, k, 0.0).long())
            return ks, ws

        (ku0, ku1), (wu0, wu1) = taps(u, patch[0])
        (kv0, kv1), (wv0, wv1) = taps(v, patch[1])
        wu0, wu1 = (torch.where(live, w, 0.0) for w in (wu0, wu1))
        # a tile past its count may hold a padding entry (group 0) below the
        # offset: its taps weigh nothing, its rows only need to be in range
        base = ((((xg.long() - goff).clamp_min(0)) * U + u0.long()) * V
                + v0.long())[:, None]
        rows, ws = [], []
        for ku, wu in ((ku0, wu0), (ku1, wu1)):
            for kv, wv in ((kv0, wv0), (kv1, wv1)):
                rows.append(base + ku * V + kv)
                ws.append(_bf16r(wu * wv))
        self.rows = torch.stack(rows, -1)
        self.w = torch.stack(ws, -1)


def _entry_meta(tables, i: int):
    e = tables[:, i]
    xg, u0, v0, jpack = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    return xg, u0, v0, jpack // 256, jpack % 256


def _interp(grid_rows, ent: _Entry, b: int, nused: int) -> torch.Tensor:
    """[T, R, nused] f32: the sample's channels, the taps' exact bf16
    products summed in ascending patch row (the dot's order)."""
    vals = grid_rows[ent.rows, b, :nused].to(F32)  # [T, R, 4, nused]
    w = ent.w[..., None]
    ch = w[..., 0, :] * vals[..., 0, :]
    for t in range(1, 4):
        ch = ch + w[..., t, :] * vals[..., t, :]
    return ch


def _shade(ch, rays, ncoeff: int, relu_sigma: bool):
    """(rgb [3], dif [3], sigma_raw, sigma, alpha, chy) of a sample from its
    channels ``ch`` [T, R, nused]: the SH fold over lanes c < 3 ncoeff in
    ascending c, the band-0 (diffuse) lanes, the density post-activation and
    the opacity."""
    nf = 3 * ncoeff
    chy = ch[..., :nf] * rays[..., L_Y0:L_Y0 + nf]
    rgb, dif = [], []
    for c in range(3):
        a = chy[..., c * ncoeff]
        dif.append(torch.sigmoid(a))
        for k in range(1, ncoeff):
            a = a + chy[..., c * ncoeff + k]
        rgb.append(torch.sigmoid(a))
    sigma_raw = ch[..., nf]
    sigma = torch.clamp_min(sigma_raw, 0.0) if relu_sigma else sigma_raw
    alpha = torch.clamp(1.0 - torch.exp(-sigma * rays[..., L_DELTA]), 0.0, 1.0)
    return rgb, dif, sigma_raw, sigma, alpha, chy


def slab_march_render_plain(tables, counts, rays, grid, *, ncoeff: int,
                            relu_sigma: bool = False, exit_eps: float = 1e-4,
                            with_diffuse: bool = False, group_offset: int = 0,
                            return_work: bool = False):
    """Plain PyTorch version of the TPU kernel
    thr3ed_atom_tpu/ops/pallas/slab_march.py slab_march_render: every tile's
    march, entry by entry, vectorized over tiles and rays. Per entry and slab
    the bf16 tents of the sample (f32 ``u - uq`` rounded to bf16, ``1 - |du|``
    rounded, the product ``wu * wv`` rounded) weigh the patch's taps, whose
    exact bf16 products sum in ascending patch row; the colour folds in
    ascending lane; per entry the slabs' contributions sum from zero and are
    then added to the state; a tile stops before an entry once its max
    transmittance is at most ``exit_eps``. The tables hold global group
    indices and ``grid`` the groups ``[group_offset, group_offset + XG)`` (a
    depth segment of the grid). Returns [T, R, 8] f32: rgb, acc,
    depth, diffuse rgb (zero without ``with_diffuse``); with ``return_work``
    also the work the march did, (live samples marched, slab records read: a
    bool mask over the grid's [XG * U * V * GS] 32-lane blocks)."""
    _check("slab_march_render_plain", tables, counts, rays, grid, ncoeff)
    T, G, _ = tables.shape
    R = rays.shape[1]
    XG, U, V, _ = grid.shape
    dev = rays.device
    nused = 3 * ncoeff + 1
    grid_rows = grid.reshape(XG * U * V, GS, LANES_PER_SLAB)
    cnt = counts[:, 0].to(dev)
    zeros = torch.zeros((T, R), dtype=F32, device=dev)
    trans = torch.ones((T, R), dtype=F32, device=dev)
    state = [zeros] * 8
    running = torch.ones(T, dtype=torch.bool, device=dev)
    n_iter = int(cnt.max()) if T else 0
    n_samples = 0
    touched = torch.zeros(XG * U * V * GS, dtype=torch.bool, device=dev) if return_work else None
    for i in range(min(n_iter, G)):
        running = running & (i < cnt) & (trans.amax(dim=1) > exit_eps)
        if not bool(running.any()):
            break
        xg, u0, v0, jlo, jhi = _entry_meta(tables, i)
        acc = [zeros] * 8
        T_cur = trans
        for b in range(GS):
            ent = _Entry(rays, xg, u0, v0, jlo, jhi, b, (XG, U, V), running,
                         goff=group_offset)
            if return_work:
                n_samples += int(ent.live.sum())
                touched[(ent.rows * GS + b)[ent.w > 0.0]] = True
            ch = _interp(grid_rows, ent, b, nused)
            rgb, dif, _, _, alpha, _ = _shade(ch, rays, ncoeff, relu_sigma)
            w = alpha * T_cur
            s_dep = rays[..., L_AT] + rays[..., L_BT] * ent.jg
            for c in range(3):
                acc[c] = acc[c] + rgb[c] * w
            acc[3] = acc[3] + w
            acc[4] = acc[4] + w * s_dep
            if with_diffuse:
                for c in range(3):
                    acc[5 + c] = acc[5 + c] + dif[c] * w
            T_cur = T_cur * (1.0 - alpha)
        run = running[:, None]
        state = [torch.where(run, s + a, s) for s, a in zip(state, acc)]
        trans = torch.where(run, T_cur, trans)
    out = torch.stack(state, dim=-1)
    return (out, (n_samples, touched)) if return_work else out


def slab_march_grad_plain(tables, counts, rays, grid, fwd_out, gout, *, ncoeff: int,
                          relu_sigma: bool = False, exit_eps: float = 1e-4,
                          with_diffuse: bool = False, group_offset: int = 0
                          ) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel
    thr3ed_atom_tpu/ops/pallas/slab_march.py _backward_impl: the replay VJP of
    the slab march with respect to the repacked grid. The march is replayed
    as ``slab_march_render_plain`` runs it, carrying the transmittance and
    the prefix sums P of the contributions; with the forward totals
    ``fwd_out`` the suffix S = totals - P gives, per sample,
    ``dsigma = delta * ((1 - alpha) T <g, x> - <g, S>)`` (zero where relu
    cuts or, identity, where sigma * delta < 0), the colour cotangents through
    the sigmoid and the SH basis, rounded to bf16, and their products with
    the taps' bf16 weights added into an f32 grid cotangent. Returns
    [XG, U, V, 128] f32 (the caller casts to the grid's bf16, as JAX), the
    cotangent of the groups ``[group_offset, group_offset + XG)`` that
    ``grid`` holds."""
    _check("slab_march_grad_plain", tables, counts, rays, grid, ncoeff)
    T, G, _ = tables.shape
    R = rays.shape[1]
    XG, U, V, _ = grid.shape
    dev = rays.device
    nf, nused = 3 * ncoeff, 3 * ncoeff + 1
    grid_rows = grid.reshape(XG * U * V, GS, LANES_PER_SLAB)
    dgrid = torch.zeros((XG * U * V * GS, LANES_PER_SLAB), dtype=F32, device=dev)
    tot = fwd_out.to(F32)
    g = gout.to(F32)
    cnt = counts[:, 0].to(dev)
    zeros = torch.zeros((T, R), dtype=F32, device=dev)
    trans = torch.ones((T, R), dtype=F32, device=dev)
    P = [zeros] * 8
    running = torch.ones(T, dtype=torch.bool, device=dev)
    n_iter = int(cnt.max()) if T else 0
    for i in range(min(n_iter, G)):
        running = running & (i < cnt) & (trans.amax(dim=1) > exit_eps)
        if not bool(running.any()):
            break
        xg, u0, v0, jlo, jhi = _entry_meta(tables, i)
        for b in range(GS):
            ent = _Entry(rays, xg, u0, v0, jlo, jhi, b, (XG, U, V), running,
                         goff=group_offset)
            ch = _interp(grid_rows, ent, b, nused)
            rgb, dif, sigma_raw, sigma, alpha, _ = _shade(ch, rays, ncoeff, relu_sigma)
            delta = rays[..., L_DELTA]
            w = alpha * trans
            s_dep = rays[..., L_AT] + rays[..., L_BT] * ent.jg
            contrib = [rgb[c] * w for c in range(3)] + [w, w * s_dep]
            contrib += [dif[c] * w for c in range(3)] if with_diffuse else [zeros] * 3
            live = ent.live
            P = [torch.where(live, p + x, p) for p, x in zip(P, contrib)]
            S = [tot[..., k] - P[k] for k in range(8)]
            inner = ((g[..., 0] * rgb[0] + g[..., 1] * rgb[1]) + g[..., 2] * rgb[2]
                     + g[..., 3]) + g[..., 4] * s_dep
            suff = (((g[..., 0] * S[0] + g[..., 1] * S[1]) + g[..., 2] * S[2])
                    + g[..., 3] * S[3]) + g[..., 4] * S[4]
            if with_diffuse:
                inner = inner + ((g[..., 5] * dif[0] + g[..., 6] * dif[1])
                                 + g[..., 7] * dif[2])
                suff = suff + ((g[..., 5] * S[5] + g[..., 6] * S[6]) + g[..., 7] * S[7])
            dsig = delta * ((1.0 - alpha) * trans * inner - suff)
            keep = sigma_raw > 0.0 if relu_sigma else sigma * delta >= 0.0
            dsig = torch.where(keep, dsig, 0.0)
            d_rgb = [g[..., c] * w * rgb[c] * (1.0 - rgb[c]) for c in range(3)]
            d_dif = ([g[..., 5 + c] * w * dif[c] * (1.0 - dif[c]) for c in range(3)]
                     if with_diffuse else None)
            yb = rays[..., L_Y0:L_Y0 + nf]
            cols = []
            for ch_i in range(nf):
                c, k = divmod(ch_i, ncoeff)
                d = d_rgb[c]
                if with_diffuse and k == 0:
                    d = d + d_dif[c]
                cols.append(d * yb[..., ch_i])
            cols.append(dsig)
            d_int = _bf16r(torch.stack(cols, -1))  # [T, R, nused]
            vals = ent.w[..., None] * d_int[..., None, :]  # [T, R, 4, nused]
            idx = (ent.rows * GS + b).reshape(-1)
            src = torch.zeros((idx.numel(), LANES_PER_SLAB), dtype=F32, device=dev)
            src[:, :nused] = vals.reshape(-1, nused)
            dgrid.index_add_(0, idx, src)
            trans = torch.where(live, trans * (1.0 - alpha), trans)
    return dgrid.reshape(XG, U, V, LAN)


def _lib(name: str, fn_name: str, n_ptr: int, n_int: int):
    return kernels.bind(name, fn_name, [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                        + [ctypes.c_float, ctypes.c_void_p])


def _cuda_operands(what, tables, counts, rays, grid, ncoeff, lan=LAN, patch=(PU, PV)):
    _check(what, tables, counts, rays, grid, ncoeff, lan, patch)
    dev = grid.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    R = rays.shape[1]
    if R not in (64, 256):
        raise ValueError(f"{what}: {R} rays per tile (tiles of 8 x 8 or 16 x 16 pixels)")
    ops = [x.to(dev).contiguous() for x in (tables, counts.to(torch.int32), rays, grid)]
    return ops, dev


def slab_march_render(tables, counts, rays, grid, *, ncoeff: int, relu_sigma: bool = False,
                      exit_eps: float = 1e-4, with_diffuse: bool = False,
                      group_offset: int = 0) -> torch.Tensor:
    """The slab-march render (K9): [T, R, 8] f32 from tables [T, G, 4] int32,
    counts [T, 1], rays [T, R, 48] f32 and the repacked grid
    [XG, U, V, 128] bf16 (global group indices in the tables; ``grid``
    holds the groups from ``group_offset`` on). On a CUDA tensor one launch of csrc/slab_march.cu
    (a block per tile, a group of lanes per ray: ``march_launch_shape``); on
    a CPU tensor ``slab_march_render_plain``."""
    if grid.device.type == "cpu":
        return slab_march_render_plain(tables, counts, rays, grid, ncoeff=ncoeff,
                                       relu_sigma=relu_sigma, exit_eps=exit_eps,
                                       with_diffuse=with_diffuse, group_offset=group_offset)
    (tab, cnt, rays, grid), dev = _cuda_operands("slab_march_render", tables, counts,
                                                 rays, grid, ncoeff)
    T, G, _ = tab.shape
    XG, U, V, _ = grid.shape
    out = torch.empty((T, rays.shape[1], 8), dtype=F32, device=dev)
    err = _lib("slab_march", "slab_march_launch", 5, 10)(
        tab.data_ptr(), cnt.data_ptr(), rays.data_ptr(), grid.data_ptr(), out.data_ptr(),
        T, G, rays.shape[1], XG, U, V, ncoeff, int(relu_sigma), int(with_diffuse),
        int(group_offset), float(exit_eps), kernels.stream(out))
    kernels.check(err, "slab_march")
    slab_march_render.launches += 1
    return out


slab_march_render.launches = 0


def march_launch_shape(lib: str, R: int, ncoeff: int, relu_sigma: bool = False,
                       with_diffuse: bool = False):
    """The launch of K9 (``lib="slab_march"``) or K11 (``"plane_march"``) on
    tiles of R rays, on the current card: (ptxas's registers a thread, the
    blocks an SM holds by cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    threads a block: R times the lanes a ray, 2 at SH degree 2)."""
    if lib not in ("slab_march", "plane_march"):
        raise ValueError(f"march_launch_shape: no launch shape for {lib!r}")
    out = (ctypes.c_int * 3)()
    err = kernels.bind(lib, f"{lib}_occupancy", [ctypes.c_int] * 4 + [ctypes.c_void_p])(
        R, ncoeff, int(relu_sigma), int(with_diffuse), ctypes.addressof(out))
    kernels.check(err, f"{lib}_occupancy")
    return tuple(out)


class SlabBackwardPlan(NamedTuple):
    """K10's launch (csrc/slab_march_backward.cu), or K12's
    (csrc/plane_march_backward.cu): a block of ``threads`` = R rays a tile,
    whose step sums go through ``cells`` patch cells of BACKWARD_BUCKET ray
    ids each, with each ray's ``ch`` channel cotangents (the used channels
    rounded up to 4), in ``smem`` bytes of shared memory."""
    cells: int
    ch: int
    threads: int
    smem: int


BACKWARD_BUCKET = 16  # ray ids a cell holds at a step (BUCKET of K10 and K12)


def slab_backward_plan(R: int, ncoeff: int, patch=(PU, PV)) -> SlabBackwardPlan:
    """K10's buckets for tiles of R rays (K12's on the planes ``patch``):
    2 R patch cells (a 16 x 16 tile's rays reach about 8 x 8 cells at a step
    at the CLI's and the serving 0.4 voxels a pixel; an 8 x 8 tile's about a
    quarter of that), at most the (PU + 1) x (PV + 1) cells a patch's taps
    have corners in. A step whose box of cells is larger adds its taps into
    the global cotangent directly. Shared memory: the rays' cotangents
    [R, ch] f32, their tap weights [R] float4, the cells' counts and buckets
    [cells, 1 + BUCKET] int."""
    ch = -(-(3 * ncoeff + 1) // 4) * 4
    cells = min(2 * R, (patch[0] + 1) * (patch[1] + 1))
    return SlabBackwardPlan(cells, ch, R, R * ch * 4 + R * 16 + cells * (1 + BACKWARD_BUCKET) * 4)


def _grad_buffers(what, grid, lan, stats, dgrid):
    """Check the replay backwards' (K10, K12) ``stats`` (a four-element int64
    tensor on the grid's device) and ``dgrid`` (a contiguous [XG, U, V, lan]
    f32 tensor there), either may be None; raises ValueError."""
    if dgrid is not None and (tuple(dgrid.shape) != (*grid.shape[:3], lan)
                              or dgrid.dtype != F32 or dgrid.device != grid.device
                              or not dgrid.is_contiguous()):
        raise ValueError(f"{what}: dgrid must be a contiguous "
                         f"{(*grid.shape[:3], lan)} f32 tensor on {grid.device}")
    if stats is not None and (stats.dtype != torch.int64 or stats.numel() != 4
                              or stats.device != grid.device):
        raise ValueError(f"{what}: stats must be a four-element int64 tensor on {grid.device}")


def slab_march_grad(tables, counts, rays, grid, fwd_out, gout, *, ncoeff: int,
                    relu_sigma: bool = False, exit_eps: float = 1e-4,
                    with_diffuse: bool = False, group_offset: int = 0, stats=None,
                    dgrid=None) -> torch.Tensor:
    """The replay VJP of the slab march (K10): the grid cotangent
    [XG, U, V, 128] f32 of the groups from ``group_offset`` on (see
    ``slab_march_grad_plain``). On a CUDA tensor one
    launch of csrc/slab_march_backward.cu, which sums each step's tap
    products over the tile's rays by patch cell in shared memory and adds
    the sums into the cotangent with f32 atomics (tiles run in no order on
    the card, so the sums round in another order than the plain
    version's); on a CPU tensor the plain version. ``stats`` (a
    four-element int64 CUDA tensor) gets added to it: the tap products, the
    global atomics, and the steps summed in shared memory and added
    directly. ``dgrid`` (a contiguous [XG, U, V, 128] f32 tensor on the
    grid's device) is the cotangent to add into and return instead of a
    zeroed one: the kernel's time apart from the zeroing's."""
    _grad_buffers("slab_march_grad", grid, LAN, stats, dgrid)
    if grid.device.type == "cpu":
        g = slab_march_grad_plain(tables, counts, rays, grid, fwd_out, gout,
                                  ncoeff=ncoeff, relu_sigma=relu_sigma,
                                  exit_eps=exit_eps, with_diffuse=with_diffuse,
                                  group_offset=group_offset)
        return g if dgrid is None else dgrid.add_(g)
    (tab, cnt, rays, grid), dev = _cuda_operands("slab_march_grad", tables, counts, rays,
                                                 grid, ncoeff)
    T, G, _ = tab.shape
    R = rays.shape[1]
    XG, U, V, _ = grid.shape
    fwd = fwd_out.to(device=dev, dtype=F32).contiguous()
    g = gout.to(device=dev, dtype=F32).contiguous()
    if tuple(fwd.shape) != (T, R, 8) or tuple(g.shape) != (T, R, 8):
        raise ValueError("slab_march_grad: fwd_out and gout must be [T, R, 8]")
    plan = slab_backward_plan(R, ncoeff)
    if dgrid is None:
        dgrid = torch.zeros((XG, U, V, LAN), dtype=F32, device=dev)
    err = kernels.bind("slab_march_backward", "slab_march_backward_launch",
                       [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                       + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])(
        tab.data_ptr(), cnt.data_ptr(), rays.data_ptr(), grid.data_ptr(), fwd.data_ptr(),
        g.data_ptr(), dgrid.data_ptr(), None if stats is None else stats.data_ptr(),
        T, G, R, XG, U, V, ncoeff, int(relu_sigma), int(with_diffuse), int(group_offset),
        plan.cells, plan.smem, float(exit_eps), kernels.stream(dgrid))
    kernels.check(err, "slab_march_backward")
    slab_march_grad.launches += 1
    return dgrid


slab_march_grad.launches = 0


class _SlabMarch(torch.autograd.Function):
    """slab_march_render with the replay VJP with respect to the grid; the
    tables, counts and rays are sampling geometry (no gradient)."""

    @staticmethod
    def forward(ctx, tables, counts, rays, grid, ncoeff, relu_sigma, exit_eps,
                with_diffuse, group_offset, plain):
        kw = dict(ncoeff=ncoeff, relu_sigma=relu_sigma, exit_eps=exit_eps,
                  with_diffuse=with_diffuse, group_offset=group_offset)
        out = (slab_march_render_plain if plain else slab_march_render)(
            tables, counts, rays, grid, **kw)
        ctx.save_for_backward(tables, counts, rays, grid, out)
        ctx.kw, ctx.plain = kw, plain
        return out

    @staticmethod
    def backward(ctx, gout):
        tables, counts, rays, grid, out = ctx.saved_tensors
        grad = slab_march_grad_plain if ctx.plain else slab_march_grad
        dgrid = grad(tables, counts, rays, grid, out, gout, **ctx.kw)
        # the reference's VJP returns the cotangent in the grid's dtype (bf16)
        return (None, None, None, dgrid.to(grid.dtype)) + (None,) * 6


def slab_march(tables, counts, rays, grid, *, ncoeff: int, relu_sigma: bool = False,
               exit_eps: float = 1e-4, with_diffuse: bool = False, group_offset: int = 0,
               plain: bool = False) -> torch.Tensor:
    """Differentiable slab-march render: gradients flow to ``grid`` (the
    repacked bf16 slab grid, or a depth segment of it: the groups from
    ``group_offset`` on, the tables' indices being global) through the replay
    VJP (K10); ``plain`` runs both directions through the plain versions."""
    return _SlabMarch.apply(tables, counts, rays, grid, int(ncoeff), bool(relu_sigma),
                            float(exit_eps), bool(with_diffuse), int(group_offset),
                            bool(plain))
