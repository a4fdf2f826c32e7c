"""Bricked (slab-march) render procedure: the pose-level orchestration of the
slab-march kernels (ops/slab_march.py).

Counterpart of thr3ed_atom_tpu/rendering/bricked.py. Per pose:

  1. the pose's dominant axis picks the march variant (axis, flip);
     ``prepare_bricked_grid`` repacks the grid into front-to-back slabs
     ``[XG, U_pad, V_pad, GS * 32]`` bf16 (the lerp between adjacent vertex
     planes first, written in bf16; K sub-samples per cell interleaved) and
     builds the dilated occupancy mip ``[XG, U8, V8]``, once per variant
     (cached while the grid is unchanged);
  2. ``compute_ray_features`` gives each ray of a 16 x 16 (or 8 x 8) pixel
     tile its 48-lane record: affine slab-march coefficients, the live slab
     range, the step length and the SH basis of its direction;
  3. ``build_tables`` lists per tile the occupied (group, patch origin, slab
     subrange) entries front to back, splitting a group whose footprint
     overflows the [PU, PV] patch into halves and single slabs;
  4. ``slab_march_render`` (K9, csrc/slab_march.cu) renders every tile in one
     launch; the tiles are cropped back to the image, with the white
     background and disparity.

Flat ray batches through the procedure object go to the fast two-phase
renderer (rendering/fast_renderer.py), as the JAX package routes them.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid
from thr3ed_atom_tpu_torch.ops.slab_march import (
    GS,
    L_Y0,
    LAN,
    LANES_PER_SLAB,
    PU,
    PV,
    slab_march_render,
    slab_march_render_plain,
)
from thr3ed_atom_tpu_torch.rendering.axes import _uv_axes, dominant_axis_for_pose
from thr3ed_atom_tpu_torch.rendering.gnomonic import _div, _ybasis_rows
from thr3ed_atom_tpu_torch.rendering.fast_renderer import FlatRaysToFast
from thr3ed_atom_tpu_torch.rendering.interface import RenderOut
from thr3ed_atom_tpu_torch.utils.constants import (
    EXTRA_ACCUMULATED_WEIGHTS,
    EXTRA_BRICKED_TAP_OVERFLOW,
    EXTRA_DIFFUSE_COLOUR,
    EXTRA_DISPARITY,
    ZERO_PLUS,
)

F32 = torch.float32


class BrickedStatics(NamedTuple):
    """Constants of one bricked render variant."""

    dims: Tuple[int, int, int]  # grid vertex counts
    aabb: Tuple[Tuple[float, float], Tuple[float, float], Tuple[float, float]]
    axis: int  # dominant world axis the slabs march along
    flip: bool  # True when the pose looks toward decreasing `axis`
    ncoeff: int  # SH coefficients per colour
    relu_sigma: bool  # density post-activation is relu (else identity)
    exit_eps: float  # early-exit transmittance threshold
    occ_sigma_thresh: float  # occupancy-mip density threshold for group skipping
    with_diffuse: bool
    tile_px: int  # pixel tile edge (rays per tile = tile_px^2)
    # K samples per cell along the march axis (divides GS)
    axis_supersample: int = 1


def _slab_geometry(statics: BrickedStatics):
    """Slab/patch geometry from the grid dims and the march axis: (u_ax, v_ax,
    num_slabs, num_groups, u_real, v_real, u_pad, v_pad, scales)."""
    dims, aabb, axis = statics.dims, statics.aabb, statics.axis
    u_ax, v_ax = _uv_axes(axis)
    num_slabs = (dims[axis] - 1) * statics.axis_supersample
    num_groups = -(-num_slabs // GS)
    u_real, v_real = dims[u_ax], dims[v_ax]
    u_pad = max(u_real, PU)
    v_pad = max(-(-v_real // 8) * 8, PV)
    scales = tuple(dims[i] / (aabb[i][1] - aabb[i][0]) for i in range(3))
    return u_ax, v_ax, num_slabs, num_groups, u_real, v_real, u_pad, v_pad, scales


def statics_for_grid(voxel_grid: VoxelGrid, axis: int, flip: bool, *,
                     exit_eps: float = 1e-4, occupancy_alpha_thresh: float = 1e-4,
                     with_diffuse: bool = False, tile_px: int = 0,
                     axis_supersample: int = 0) -> BrickedStatics:
    """The variant's statics; ``tile_px=0`` picks 16 (8 above 160 vertices a
    side), ``axis_supersample=0`` about 256 march samples across the grid
    (clamped to [1, GS]); the per-sample alpha threshold becomes a density
    threshold for the occupancy mip."""
    num_features = voxel_grid.num_features
    if num_features % 3 != 0:
        raise ValueError("SH feature count must be 3 * (degree + 1)^2")
    ncoeff = num_features // 3
    if ncoeff not in (1, 4, 9):
        raise ValueError("the bricked renderer supports SH degree <= 2 (32-lane slabs)")
    post = voxel_grid.density_postactivation
    if post not in ("identity", "relu"):
        raise ValueError(
            f"the bricked renderer supports identity/relu density postactivation, got {post}")
    if voxel_grid.feature_postactivation != "identity":
        raise ValueError("the bricked renderer needs an identity feature postactivation")
    aabb = voxel_grid.aabb
    dims = voxel_grid.grid_dims
    if axis_supersample == 0:
        axis_supersample = max(1, min(GS, round(256 / max(1, dims[axis] - 1))))
    if GS % axis_supersample:
        raise ValueError(f"axis_supersample must divide GS={GS}, got {axis_supersample}")
    cell_a = (aabb[axis][1] - aabb[axis][0]) / dims[axis] / axis_supersample
    occ_sigma_thresh = occupancy_alpha_thresh / (cell_a * math.sqrt(3.0))
    if tile_px == 0:
        tile_px = 16 if max(dims) <= 160 else 8
    if tile_px not in (8, 16):
        raise ValueError(f"tile_px must be 8 or 16, got {tile_px}")
    return BrickedStatics(
        dims=tuple(dims),
        aabb=tuple((float(lo), float(hi)) for (lo, hi) in aabb),
        axis=int(axis),
        flip=bool(flip),
        ncoeff=int(ncoeff),
        relu_sigma=(post == "relu"),
        exit_eps=float(exit_eps),
        occ_sigma_thresh=float(occ_sigma_thresh),
        with_diffuse=bool(with_diffuse),
        tile_px=int(tile_px),
        axis_supersample=int(axis_supersample),
    )


# -------------------------------------------------------------------- grid repacking


def repack_slab_grid(voxel_grid: VoxelGrid, statics: BrickedStatics, theta=0.5
                     ) -> torch.Tensor:
    """The (pre-activated) grid repacked into front-to-back slabs
    [XG, U_pad, V_pad, GS * 32] bf16, differentiable (autograd gives the
    repack's VJP). Sample j' of the march lerps adjacent vertex planes at
    fraction (k + theta) / K of cell c (flipped: (k + 1 - theta) / K, so that
    the flipped interleave lands on the same positions); ``theta`` in (0, 1),
    0.5 at cell centres, random per step in training. The lerp comes first,
    in the grid's layout, written in bf16; lane block b of group g holds slab
    g * GS + b (features, density, zero pad)."""
    (u_ax, v_ax, num_slabs, num_groups, _u_real, _v_real, u_pad, v_pad, _scales
     ) = _slab_geometry(statics)
    pre_densities, pre_features = voxel_grid.activated_grids()
    unified = torch.cat([pre_features, pre_densities], dim=-1)
    unified = F.pad(unified, (0, LANES_PER_SLAB - unified.shape[-1]))
    dev = unified.device
    theta = torch.as_tensor(theta, dtype=F32, device=dev)
    ssaa = statics.axis_supersample
    num_cells = num_slabs // ssaa
    lo = unified.narrow(statics.axis, 0, num_cells)
    hi = unified.narrow(statics.axis, 1, num_cells)
    subs = []
    for k in range(ssaa):
        frac = (k + (1.0 - theta if statics.flip else theta)) / ssaa
        sub = ((1.0 - frac) * lo + frac * hi).to(torch.bfloat16)
        if statics.flip:
            sub = torch.flip(sub, dims=(statics.axis,))
        subs.append(sub.permute(statics.axis, u_ax, v_ax, 3))
    if ssaa == 1:
        slabs = subs[0]
    else:
        if statics.flip:
            subs = subs[::-1]
        slabs = torch.stack(subs, dim=1).reshape((num_cells * ssaa,) + tuple(subs[0].shape[1:]))
    s_pad = num_groups * GS
    slabs = F.pad(slabs, (0, 0, 0, v_pad - slabs.shape[2], 0, u_pad - slabs.shape[1],
                          0, s_pad - num_slabs))
    return (slabs.reshape(num_groups, GS, u_pad, v_pad, LANES_PER_SLAB)
            .permute(0, 2, 3, 1, 4)
            .reshape(num_groups, u_pad, v_pad, LAN))


def occupancy_mip(voxel_grid: VoxelGrid, statics: BrickedStatics) -> torch.Tensor:
    """Dilated occupancy mip [XG, U8, V8]: the max pre-activated density over
    each (slab group, 8 x 8 vertex block), over the group's vertex planes
    (one plane of overlap, so it bounds every theta), dilated forward by the
    taps a patch anchored in the block can reach."""
    (u_ax, v_ax, num_slabs, num_groups, _u_real, _v_real, u_pad, v_pad, _scales
     ) = _slab_geometry(statics)
    gs_c = GS // statics.axis_supersample
    pre_densities, _ = voxel_grid.activated_grids()
    dens = pre_densities[..., 0].permute(statics.axis, u_ax, v_ax)
    if statics.flip:
        dens = torch.flip(dens, dims=(0,))
    u8 = -(-u_pad // 8)
    v8 = -(-v_pad // 8)
    a_pad = num_groups * gs_c + 1
    dens = F.pad(dens, (0, v8 * 8 - dens.shape[2], 0, u8 * 8 - dens.shape[1],
                        0, a_pad - dens.shape[0]))
    main = dens[:-1].reshape(num_groups, gs_c, u8, 8, v8, 8).amax(dim=(1, 3, 5))
    extra = dens[gs_c::gs_c].reshape(num_groups, 1, u8, 8, v8, 8).amax(dim=(1, 3, 5))
    occ = torch.maximum(main, extra)
    du = PU // 8 + 1
    dv = PV // 8
    occ_p = F.pad(occ, (0, dv - 1, 0, du - 1), value=-math.inf)
    return torch.stack([occ_p[:, i:i + u8, j:j + v8]
                        for i in range(du) for j in range(dv)]).amax(dim=0)


def prepare_bricked_grid(voxel_grid: VoxelGrid, statics: BrickedStatics):
    """(repacked slab grid at theta = 0.5, dilated occupancy mip): the per-variant
    precomputation of the render path."""
    return repack_slab_grid(voxel_grid, statics), occupancy_mip(voxel_grid, statics)


# -------------------------------------------------------------------- ray features


def _guard(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(x) < 1e-12, 1e-12, x)


def compute_ray_features(origins: torch.Tensor, directions: torch.Tensor,
                         statics: BrickedStatics, theta=0.5) -> torch.Tensor:
    """Per-ray records [T, R, 48] f32 of ``origins`` / ``directions`` [T, R, 3]
    in repack space: sample j of the march (at vertex coordinate (j + theta)
    / K, flipped (num_slabs - j - theta) / K, along the axis) lies at depth
    ``at + bts j`` and in-plane vertex coordinates ``au + bu j``, ``av + bv j``;
    jmin / jmax bound the samples inside the grid and in front of the camera
    (none for a ray marching against the repack); the step length; the SH
    basis of the direction on lanes c < 3 ncoeff (Y_{c % ncoeff})."""
    (u_ax, v_ax, num_slabs, _num_groups, u_real, v_real, _u_pad, _v_pad, scales
     ) = _slab_geometry(statics)
    theta = torch.as_tensor(theta, dtype=F32, device=origins.device)
    ssaa = statics.axis_supersample
    inv_scale = 1.0 / scales[statics.axis]
    frac = _div(num_slabs - theta, ssaa) if statics.flip else _div(theta, ssaa)
    w0 = statics.aabb[statics.axis][0] + (frac + 0.5) * inv_scale
    return ray_records(origins, directions, statics, (u_ax, v_ax, u_real, v_real, scales),
                       w0, inv_scale / ssaa, num_slabs - 1)


def ray_records(origins, directions, statics, geometry, w0, step: float, j_last: int):
    """The 48-lane ray records of a march along ``statics.axis`` whose sample
    j sits at world coordinate ``w0 +- j * step`` along the axis (minus when
    ``statics.flip``) and whose last sample is ``j_last``; ``geometry`` =
    (u_ax, v_ax, u_real, v_real, scales). Shared by the slab and plane
    marches, which differ in where their samples sit."""
    u_ax, v_ax, u_real, v_real, scales = geometry
    axis = statics.axis
    lo = [statics.aabb[i][0] for i in range(3)]
    dev = origins.device
    o_a = origins[..., axis]
    d_a = _guard(directions[..., axis])
    # a true division: torch computes <python number> / tensor as a reciprocal
    # times the number
    ds = torch.full((), step, dtype=F32, device=dev) / d_a
    bts = -ds if statics.flip else ds
    at = (w0 - o_a) / d_a
    forwardish = bts > 0.0

    def affine(ax):
        scale = scales[ax]
        a0 = (origins[..., ax] - lo[ax]) * scale - 0.5 + at * directions[..., ax] * scale
        b0 = bts * directions[..., ax] * scale
        return a0, b0

    au, bu = affine(u_ax)
    av, bv = affine(v_ax)

    def interval(a0, b0, n_real):
        b_safe = _guard(b0)
        e0 = (-0.5 - a0) / b_safe
        e1 = (n_real - 0.5 - a0) / b_safe
        return torch.minimum(e0, e1), torch.maximum(e0, e1)

    lo_u, hi_u = interval(au, bu, u_real)
    lo_v, hi_v = interval(av, bv, v_real)
    lo_s = -at / _guard(bts)
    jminf = torch.maximum(torch.maximum(lo_u, lo_v), torch.clamp_min(lo_s, 0.0))
    jmaxf = torch.clamp_max(torch.minimum(hi_u, hi_v), float(j_last))
    jmaxf = torch.where(forwardish, jmaxf, -1.0)
    jminf = torch.where(forwardish, jminf, 0.0)

    norm = torch.linalg.vector_norm(directions, dim=-1)
    delta_w = bts * norm
    unit = directions / norm[..., None]
    ybasis = torch.movedim(
        _ybasis_rows(unit[..., 0], unit[..., 1], unit[..., 2], statics.ncoeff), 0, -1)
    ytile = ybasis.repeat(1, 1, 3)
    ytile = F.pad(ytile, (0, LANES_PER_SLAB - ytile.shape[-1]))
    head = torch.stack([au, bu, av, bv, at, bts, jminf, jmaxf, delta_w], dim=-1).to(F32)
    pad = torch.zeros(tuple(origins.shape[:2]) + (L_Y0 - 9,), dtype=F32, device=dev)
    return torch.cat([head, pad, ytile.to(F32)], dim=-1)


# -------------------------------------------------------------------- tables


# slab-subrange candidates per group for overflow splitting (GS = 4): a group
# whose footprint exceeds the patch splits front to back into halves, a half
# that still exceeds it into single slabs; the order key keeps every legal
# emission front to back
_SUB_RANGES = ((0, 3), (0, 1), (2, 3), (0, 0), (1, 1), (2, 2), (3, 3))
_SUB_ORDER = (0, 1, 4, 2, 3, 5, 6)
# footprints are bounded from a 4 x 4 lattice of a tile's rays plus this margin
_SPAN_MARGIN = 0.25


def _lattice_indices(tile_px: int):
    q = [0, tile_px // 3, (2 * tile_px) // 3, tile_px - 1]
    return [r * tile_px + c for r in q for c in q]


def build_tables(rays_feat: torch.Tensor, occ_dil: torch.Tensor, statics: BrickedStatics,
                 exact_spans: bool = False, group_range: Optional[Tuple[int, int]] = None):
    """Per-tile front-to-back traversal tables with overflow splitting:
    (tables [T, 4 G, 4] int32 = (global group, u0, v0, jlo * 256 + jhi),
    counts [T, 1] int32, overflow: a 0-d bool tensor on the device, True when
    even a single slab's footprint exceeds the patch). ``exact_spans`` bounds
    the footprints with every ray instead of the lattice. ``group_range`` =
    (g0, g1) restricts the tables to a depth segment: ``occ_dil`` is then the
    mip's slice of groups [g0, g1) and G = g1 - g0, while the entries keep
    global group indices (the slab march rebases them by ``group_offset``).
    Entries sort by a stable sort of the JAX package's keys, so the tables
    equal its tables."""
    (_u_ax, _v_ax, _num_slabs, total_groups, u_real, v_real, u_pad, v_pad, _scales
     ) = _slab_geometry(statics)
    g0, g1 = (0, total_groups) if group_range is None else map(int, group_range)
    num_groups = g1 - g0
    if not 0 <= g0 < g1 <= total_groups or occ_dil.shape[0] != num_groups:
        raise ValueError(f"occupancy mip {tuple(occ_dil.shape)} for groups [{g0}, {g1}) "
                         f"of {total_groups}")
    dev = rays_feat.device
    sel = rays_feat if exact_spans else rays_feat[:, _lattice_indices(statics.tile_px), :]
    au, bu, av, bv = (sel[..., k][..., None, None] for k in range(4))
    jminf = sel[..., 6][..., None, None]
    jmaxf = sel[..., 7][..., None, None]

    g_iota = (g0 + torch.arange(num_groups, dtype=F32, device=dev))[None, None, :, None]
    sub = torch.tensor(_SUB_RANGES, dtype=F32, device=dev)
    glo = g_iota * GS + sub[None, None, None, :, 0]  # [1, 1, G, C]
    ghi = g_iota * GS + sub[None, None, None, :, 1]
    live = (jminf <= ghi) & (jmaxf >= glo) & (jminf <= jmaxf)  # [T, B, G, C]
    j_a = torch.minimum(torch.maximum(glo, jminf), jmaxf)
    j_b = torch.minimum(torch.maximum(ghi, jminf), jmaxf)
    big = 1e9

    def span(a0, b0):
        ea = a0 + b0 * j_a
        eb = a0 + b0 * j_b
        lo_t = torch.where(live, torch.minimum(ea, eb), big).amin(dim=1)
        hi_t = torch.where(live, torch.maximum(ea, eb), -big).amax(dim=1)
        return lo_t - _SPAN_MARGIN, hi_t + _SPAN_MARGIN  # [T, G, C]

    ulo, uhi = span(au, bu)
    vlo, vhi = span(av, bv)
    any_live = live.any(dim=1)
    u0 = torch.clamp(torch.floor(ulo), 0.0, float(u_pad - PU)).to(torch.int32)
    v0 = torch.div(torch.clamp(torch.floor(vlo), 0.0, float(v_pad - PV)).to(torch.int32), 8,
                   rounding_mode="floor") * 8
    u0 = torch.where(any_live, u0, 0)
    v0 = torch.where(any_live, v0, 0)
    need_hi_u = torch.clamp_max(torch.floor(uhi) + 1.0, float(u_real - 1))
    need_hi_v = torch.clamp_max(torch.floor(vhi) + 1.0, float(v_real - 1))
    fits = ((need_hi_u <= u0.to(F32) + (PU - 1)) & (need_hi_v <= v0.to(F32) + (PV - 1)))
    g_idx = torch.arange(num_groups, device=dev)[None, :, None]
    occ_val = occ_dil[g_idx, (u0 // 8).long(), (v0 // 8).long()]
    occupied = occ_val > statics.occ_sigma_thresh

    f_full, f_h0, f_h1 = fits[..., 0], fits[..., 1], fits[..., 2]
    use = torch.stack([f_full, ~f_full & f_h0, ~f_full & f_h1, ~f_full & ~f_h0,
                       ~f_full & ~f_h0, ~f_full & ~f_h1, ~f_full & ~f_h1], dim=-1)
    active = use & any_live & occupied  # [T, G, C]
    overflow = (active[..., 3:] & ~fits[..., 3:]).any()

    num_tiles = active.shape[0]
    cand = num_groups * len(_SUB_RANGES)
    order_off = torch.tensor(_SUB_ORDER, dtype=torch.int32, device=dev)[None, None, :]
    key = torch.where(active, g_idx.to(torch.int32) * 8 + order_off,
                      8 * num_groups + 7).reshape(num_tiles, cand)
    order = torch.sort(key, dim=-1, stable=True).indices[:, :4 * num_groups]
    g_col = (g0 + g_idx.to(torch.int32)).expand(num_tiles, num_groups, len(_SUB_RANGES))
    jpack = torch.tensor([lo * 256 + hi for (lo, hi) in _SUB_RANGES], dtype=torch.int32,
                         device=dev)[None, None, :].expand_as(g_col)

    def pick(x):
        return torch.gather(x.reshape(num_tiles, cand), 1, order)

    tables = torch.stack([pick(g_col), pick(u0), pick(v0), pick(jpack)],
                         dim=-1).to(torch.int32).contiguous()
    counts = active.sum(dim=(1, 2), dtype=torch.int32)[:, None]
    return tables, counts, overflow


# -------------------------------------------------------------------- image renderer


def _tile_image_rays(height_pad: int, width_pad: int, focal: float, height: int,
                     width: int, rotation: torch.Tensor, translation: torch.Tensor,
                     tile_px: int):
    """Rays of a padded image in square pixel tiles: (origins, directions),
    each [tiles, tile_px^2, 3]. Pixel centres and focal are the real image's;
    the pad pixels are extra rays cropped after rendering."""
    dev = rotation.device
    x = torch.arange(width_pad, dtype=F32, device=dev) + 0.5
    y = torch.arange(height_pad, dtype=F32, device=dev) + 0.5
    yg, xg = torch.meshgrid(y, x, indexing="ij")
    dirs_cam = torch.stack([_div(xg - width * 0.5, focal), -_div(yg - height * 0.5, focal),
                            -torch.ones_like(xg)], dim=-1)
    r = rotation
    rays_d = (r[:, 0] * dirs_cam[..., 0:1] + r[:, 1] * dirs_cam[..., 1:2]
              + r[:, 2] * dirs_cam[..., 2:3])
    rays_o = translation.reshape(3).expand(rays_d.shape)
    th, tw = height_pad // tile_px, width_pad // tile_px

    def tile(a):
        return (a.reshape(th, tile_px, tw, tile_px, 3).permute(0, 2, 1, 3, 4)
                .reshape(th * tw, tile_px * tile_px, 3))

    return tile(rays_o), tile(rays_d)


def _untile(out: torch.Tensor, height_pad: int, width_pad: int, tile_px: int):
    th, tw = height_pad // tile_px, width_pad // tile_px
    c = out.shape[-1]
    return (out.reshape(th, tw, tile_px, tile_px, c).permute(0, 2, 1, 3, 4)
            .reshape(height_pad, width_pad, c))


def tile_operands(statics: BrickedStatics, height: int, width: int, focal: float,
                  occ_dil: torch.Tensor, rotation: torch.Tensor, translation: torch.Tensor):
    """One pose's slab-march operands for the image padded to whole tiles:
    (rays_feat [tiles, tile_px^2, 48], tables, counts, overflow)."""
    tp = statics.tile_px
    height_pad = -(-height // tp) * tp
    width_pad = -(-width // tp) * tp
    rays_o, rays_d = _tile_image_rays(height_pad, width_pad, focal, height, width,
                                      rotation, translation, tp)
    rays_feat = compute_ray_features(rays_o, rays_d, statics)
    tables, counts, overflow = build_tables(rays_feat, occ_dil, statics)
    return rays_feat, tables, counts, overflow


def _finalize(out, statics: BrickedStatics, height: int, width: int, white_bkgd: bool,
              overflow) -> RenderOut:
    tp = statics.tile_px
    img = _untile(out, -(-height // tp) * tp, -(-width // tp) * tp, tp)[:height, :width]
    colour = img[..., 0:3]
    acc = img[..., 3:4]
    depth = img[..., 4:5]
    if white_bkgd:
        colour = colour + (1.0 - acc)
    disparity = 1.0 / torch.clamp_min(depth / torch.clamp_min(acc, ZERO_PLUS), ZERO_PLUS)
    extra = {
        EXTRA_DISPARITY: disparity,
        EXTRA_ACCUMULATED_WEIGHTS: acc,
        # True when a single-slab entry's footprint exceeded the patch and taps
        # were dropped (a device tensor: reading it syncs)
        EXTRA_BRICKED_TAP_OVERFLOW: overflow,
    }
    if statics.with_diffuse:
        diffuse = img[..., 5:8]
        if white_bkgd:
            diffuse = diffuse + (1.0 - acc)
        extra[EXTRA_DIFFUSE_COLOUR] = diffuse
    return RenderOut(colour=colour, depth=depth, extra=extra)


def variant_statics(voxel_grid: VoxelGrid, axis: int, flip: bool, config) -> BrickedStatics:
    """The render config's bricked knobs for one march variant."""
    want_diffuse = bool(getattr(config, "also_render_diffuse", False)
                        or getattr(config, "render_diffuse", False))
    return statics_for_grid(
        voxel_grid, axis, flip,
        exit_eps=config.bricked_exit_eps,
        occupancy_alpha_thresh=config.bricked_occupancy_alpha_thresh,
        with_diffuse=want_diffuse,
        tile_px=getattr(config, "bricked_tile_px", 0),
        axis_supersample=getattr(config, "bricked_axis_supersample", 1),
    )


def per_grid(cache, key, voxel_grid: VoxelGrid, make):
    """``make()``, kept in ``cache`` under ``key`` while the grid's tensors are
    unchanged (same storage, same version counter)."""
    stamp = tuple((t.data_ptr(), t._version)
                  for t in (voxel_grid.densities, voxel_grid.features))
    if cache is not None:
        entry = cache.get(key)
        if entry is not None and entry[0] == stamp:
            return entry[1]
    value = make()
    if cache is not None:
        cache[key] = (stamp, value)
    return value


def _prepared(voxel_grid: VoxelGrid, statics: BrickedStatics, cache):
    """The variant's (repacked grid, occupancy mip), cached per grid."""
    key = ("bricked", statics.axis, statics.flip, statics.occ_sigma_thresh,
           statics.axis_supersample)
    return per_grid(cache, key, voxel_grid, lambda: prepare_bricked_grid(voxel_grid, statics))


def stack_renders(outs) -> RenderOut:
    """One RenderOut of per-pose renders, each output gaining a leading pose axis."""
    return RenderOut(
        colour=torch.stack([o.colour for o in outs]),
        depth=torch.stack([o.depth for o in outs]),
        extra={k: torch.stack([o.extra[k] for o in outs]) for k in outs[0].extra},
    )


@torch.no_grad()
def render_image_bricked(voxel_grid: VoxelGrid, camera_pose, camera_intrinsics, config,
                         cache: Optional[dict] = None, plain: bool = False) -> RenderOut:
    """Full-image render of one pose through the slab-march kernel (K9), on
    the grid's device: outputs [H, W, .]. The repacked grid of each march
    variant is kept in ``cache``; ``plain`` runs the kernel's plain version
    (a reference for checking the kernel on the card)."""
    rotation = np.asarray(camera_pose.rotation, np.float32).reshape(3, 3)
    axis, flip = dominant_axis_for_pose(rotation)
    statics = variant_statics(voxel_grid, axis, flip, config)
    repacked, occ_dil = _prepared(voxel_grid, statics, cache)
    dev = voxel_grid.device
    height, width = int(camera_intrinsics.height), int(camera_intrinsics.width)
    rays_feat, tables, counts, overflow = tile_operands(
        statics, height, width, float(camera_intrinsics.focal), occ_dil,
        torch.as_tensor(rotation).to(dev),
        torch.as_tensor(np.asarray(camera_pose.translation, np.float32).reshape(3)).to(dev))
    march = slab_march_render_plain if plain else slab_march_render
    out = march(tables, counts, rays_feat, repacked, ncoeff=statics.ncoeff,
                relu_sigma=statics.relu_sigma, exit_eps=statics.exit_eps,
                with_diffuse=statics.with_diffuse)
    return _finalize(out, statics, height, width, bool(config.white_bkgd), overflow)


@torch.no_grad()
def render_poses_bricked(voxel_grid: VoxelGrid, camera_poses, camera_intrinsics, config,
                         cache: Optional[dict] = None, plain: bool = False) -> RenderOut:
    """Render a sequence of poses, one ``render_image_bricked`` each (the JAX
    package's per-pose loop); every output gains a leading pose axis. Poses
    of one march variant share one repack."""
    cache = {} if cache is None else cache
    return stack_renders([render_image_bricked(voxel_grid, pose, camera_intrinsics, config,
                                               cache=cache, plain=plain)
                          for pose in camera_poses])


class _BrickedProcedure(FlatRaysToFast):
    """RENDER_PROCEDURES entry: the slab march is pose-structured, so
    VolumetricModel renders whole poses through ``render_image`` /
    ``render_poses``, and the tile-based trainer drives the kernel itself;
    flat ray batches go to the fast renderer."""

    name = "render_sh_voxel_grid_bricked"
    pipeline = "slab-march kernel"
    render_image = staticmethod(render_image_bricked)
    render_poses = staticmethod(render_poses_bricked)


render_sh_voxel_grid_bricked = _BrickedProcedure()
