"""Plane-march render procedure: the pose-level orchestration of the
plane-march kernels (ops/plane_march.py).

Counterpart of thr3ed_atom_tpu/rendering/planes.py. Per pose:

  1. the pose's dominant axis picks the march variant (axis, flip);
     ``prepare_plane_grid`` repacks the grid into front-to-back march
     positions at vertex coordinate k / P along the axis (the grid's vertex
     planes and P - 1 lerps per cell, written in bf16), grouped 8 to a group
     with one position of overlap, ``[XG, U_pad, V_pad, 8 * 32]`` bf16, and
     builds the dilated occupancy mip ``[XG, U8, V8]``, once per variant
     (cached while the grid is unchanged);
  2. ``compute_ray_features`` gives each ray of a 16 x 16 (or 8 x 8) pixel
     tile its 48-lane record: affine march coefficients, the live position
     range, the step length and the SH basis of its direction;
  3. ``build_tables`` lists per tile the occupied (group, patch origin,
     position subrange) entries front to back, splitting a group whose
     footprint overflows the [16, 24] patch into halves and single cells;
  4. ``plane_march_render`` (K11, csrc/plane_march.cu) renders every tile in
     one launch; the tiles are cropped back to the image, with the white
     background and disparity.

Flat ray batches through the procedure object go to the fast two-phase
renderer (rendering/fast_renderer.py), as the JAX package routes them.
``build_tables(..., group_range=(g0, g1))`` lists a depth segment's entries
only (global group indices), for K11's ``group_offset``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid
from thr3ed_atom_tpu_torch.ops.plane_march import (
    GS,
    LANES_PER_POS,
    PU,
    PV,
    STRIDE,
    plane_march_render,
    plane_march_render_plain,
)
from thr3ed_atom_tpu_torch.rendering.axes import _uv_axes, dominant_axis_for_pose
from thr3ed_atom_tpu_torch.rendering.bricked import (
    _SPAN_MARGIN,
    _finalize,
    _lattice_indices,
    _tile_image_rays,
    per_grid,
    ray_records,
    stack_renders,
)
from thr3ed_atom_tpu_torch.rendering.fast_renderer import FlatRaysToFast
from thr3ed_atom_tpu_torch.rendering.interface import RenderOut

F32 = torch.float32


class PlanesStatics(NamedTuple):
    """Constants of one plane-march render variant."""

    dims: Tuple[int, int, int]  # grid vertex counts
    aabb: Tuple[Tuple[float, float], Tuple[float, float], Tuple[float, float]]
    axis: int  # dominant world axis the march follows
    flip: bool  # True when the pose looks toward decreasing `axis`
    ncoeff: int  # SH coefficients per colour
    relu_sigma: bool  # density post-activation is relu (else identity)
    exit_eps: float  # early-exit transmittance threshold
    occ_sigma_thresh: float  # occupancy-mip density threshold for group skipping
    with_diffuse: bool
    tile_px: int  # pixel tile edge (rays per tile = tile_px^2)
    # positions per cell along the march axis (1 = vertex planes only, 2 =
    # planes + cell centres, the quality default)
    pos_per_cell: int = 2


def _geometry(statics: PlanesStatics):
    """Position/patch geometry from the grid dims and the march axis: (u_ax,
    v_ax, num_pos, num_groups, u_real, v_real, u_pad, v_pad, scales)."""
    dims, aabb, axis = statics.dims, statics.aabb, statics.axis
    u_ax, v_ax = _uv_axes(axis)
    num_pos = (dims[axis] - 1) * statics.pos_per_cell + 1
    num_groups = -(-(num_pos - 1) // STRIDE)
    u_real, v_real = dims[u_ax], dims[v_ax]
    u_pad = max(u_real, PU)
    v_pad = max(-(-v_real // 8) * 8, PV)
    scales = tuple(dims[i] / (aabb[i][1] - aabb[i][0]) for i in range(3))
    return u_ax, v_ax, num_pos, num_groups, u_real, v_real, u_pad, v_pad, scales


def statics_for_grid(voxel_grid: VoxelGrid, axis: int, flip: bool, *,
                     exit_eps: float = 1e-4, occupancy_alpha_thresh: float = 1e-4,
                     with_diffuse: bool = False, tile_px: int = 0,
                     pos_per_cell: int = 0) -> PlanesStatics:
    """The variant's statics; ``pos_per_cell=0`` picks about 256 positions
    across the grid (a power of 2 in [1, 8]: 32^3 -> 8, 128^3 -> 2, 256^3 ->
    1), ``tile_px=0`` 16 (8 above 128 vertices a side); the per-cell alpha
    threshold becomes a density threshold for the occupancy mip."""
    num_features = voxel_grid.num_features
    if num_features % 3 != 0:
        raise ValueError("SH feature count must be 3 * (degree + 1)^2")
    ncoeff = num_features // 3
    if ncoeff not in (1, 4, 9):
        raise ValueError("the plane-march renderer supports SH degree <= 2 (32 lanes)")
    post = voxel_grid.density_postactivation
    if post not in ("identity", "relu"):
        raise ValueError("the plane-march renderer supports identity/relu density "
                         f"postactivation, got {post}")
    if voxel_grid.feature_postactivation != "identity":
        raise ValueError("the plane-march renderer needs an identity feature postactivation")
    aabb = voxel_grid.aabb
    dims = voxel_grid.grid_dims
    n_cells = dims[axis] - 1
    if pos_per_cell == 0:
        pos_per_cell = max(1, min(8, 2 ** round(math.log2(max(1.0, 256 / n_cells)))))
    if pos_per_cell not in (1, 2, 4, 8):
        raise ValueError(f"pos_per_cell must be 1, 2, 4 or 8, got {pos_per_cell}")
    cell_a = (aabb[axis][1] - aabb[axis][0]) / dims[axis] / pos_per_cell
    occ_sigma_thresh = occupancy_alpha_thresh / (cell_a * math.sqrt(3.0))
    if tile_px == 0:
        tile_px = 16 if max(dims) <= 128 else 8
    if tile_px not in (8, 16):
        raise ValueError(f"tile_px must be 8 or 16, got {tile_px}")
    return PlanesStatics(
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
        pos_per_cell=int(pos_per_cell),
    )


# -------------------------------------------------------------------- grid repacking


def repack_plane_grid(voxel_grid: VoxelGrid, statics: PlanesStatics) -> torch.Tensor:
    """The (pre-activated) grid repacked into front-to-back position groups
    [XG, U_pad, V_pad, GS * 32] bf16, differentiable (autograd gives the
    repack's VJP). Position j sits at vertex coordinate j / P along the axis
    ((NP - 1 - j) / P flipped): the lerps between adjacent vertex planes come
    first, in the grid's layout, written in bf16 (fraction 0 or 1 takes the
    plane itself); flipped, the per-position arrays flip and the sub order
    reverses; the interleave, the last plane, the pads. Lane block k of group
    g holds position g * 7 + k, so boundary positions are stored twice and the
    repack's VJP sums both."""
    (u_ax, v_ax, num_pos, num_groups, _u, _v, u_pad, v_pad, _s) = _geometry(statics)
    P = statics.pos_per_cell
    pre_densities, pre_features = voxel_grid.activated_grids()
    unified = torch.cat([pre_features, pre_densities], dim=-1)
    unified = F.pad(unified, (0, LANES_PER_POS - unified.shape[-1]))
    axis = statics.axis
    n_planes = statics.dims[axis]
    order = (axis, u_ax, v_ax, 3)
    if P == 1:
        pos = unified.to(torch.bfloat16).permute(order)
        if statics.flip:
            pos = torch.flip(pos, dims=(0,))
    else:
        lo = unified.narrow(axis, 0, n_planes - 1)
        hi = unified.narrow(axis, 1, n_planes - 1)
        subs = []
        for k in range(P):
            frac = (P - k) / P if statics.flip else k / P
            if frac == 0.0:
                sub = lo.to(torch.bfloat16)
            elif frac == 1.0:
                sub = hi.to(torch.bfloat16)
            else:
                sub = ((1.0 - frac) * lo + frac * hi).to(torch.bfloat16)
            if statics.flip:
                sub = torch.flip(sub, dims=(axis,))
            subs.append(sub.permute(order))
        last = unified.narrow(axis, 0 if statics.flip else n_planes - 1, 1)
        last = last.to(torch.bfloat16).permute(order)
        inter = torch.stack(subs, dim=1).reshape(((n_planes - 1) * P,)
                                                 + tuple(subs[0].shape[1:]))
        pos = torch.cat([inter, last], dim=0)
    np_pad = num_groups * STRIDE + 1
    pos = F.pad(pos, (0, 0, 0, v_pad - pos.shape[2], 0, u_pad - pos.shape[1],
                      0, np_pad - num_pos))
    main = pos[:-1].reshape(num_groups, STRIDE, u_pad, v_pad, LANES_PER_POS)
    extra = pos[STRIDE::STRIDE][:, None]  # block GS - 1: the next group's first position
    return (torch.cat([main, extra], dim=1)
            .permute(0, 2, 3, 1, 4)
            .reshape(num_groups, u_pad, v_pad, GS * LANES_PER_POS))


def occupancy_mip(voxel_grid: VoxelGrid, statics: PlanesStatics) -> torch.Tensor:
    """Dilated occupancy mip [XG, U8, V8]: the max pre-activated density over
    each (group, 8 x 8 vertex block). A lerped position is bounded by the max
    of its two vertex planes, so the per-position bound interleaves the planes
    and their pairwise maxima; group g covers positions [7 g, 7 g + 7]. The
    mip is dilated forward by the taps a patch anchored in the block can
    reach."""
    (u_ax, v_ax, num_pos, num_groups, _u, _v, u_pad, v_pad, _s) = _geometry(statics)
    P = statics.pos_per_cell
    pre_densities, _ = voxel_grid.activated_grids()
    dens = pre_densities[..., 0].permute(statics.axis, u_ax, v_ax)
    if statics.flip:
        dens = torch.flip(dens, dims=(0,))
    if P == 1:
        posmax = dens
    else:
        pairmax = torch.maximum(dens[:-1], dens[1:])
        inter = torch.stack([dens[:-1]] + [pairmax] * (P - 1), dim=1)
        posmax = torch.cat([inter.reshape(((dens.shape[0] - 1) * P,) + tuple(dens.shape[1:])),
                            dens[-1:]], dim=0)
    u8 = -(-u_pad // 8)
    v8 = -(-v_pad // 8)
    np_pad = num_groups * STRIDE + 1
    posmax = F.pad(posmax, (0, v8 * 8 - posmax.shape[2], 0, u8 * 8 - posmax.shape[1],
                            0, np_pad - num_pos))
    main = posmax[:-1].reshape(num_groups, STRIDE, u8, 8, v8, 8).amax(dim=(1, 3, 5))
    extra = posmax[STRIDE::STRIDE].reshape(num_groups, 1, u8, 8, v8, 8).amax(dim=(1, 3, 5))
    occ = torch.maximum(main, extra)
    du = PU // 8 + 1
    dv = PV // 8
    occ_p = F.pad(occ, (0, dv - 1, 0, du - 1), value=-math.inf)
    return torch.stack([occ_p[:, i:i + u8, j:j + v8]
                        for i in range(du) for j in range(dv)]).amax(dim=0)


def prepare_plane_grid(voxel_grid: VoxelGrid, statics: PlanesStatics):
    """(repacked position grid, dilated occupancy mip): the per-variant
    precomputation of the render path."""
    return repack_plane_grid(voxel_grid, statics), occupancy_mip(voxel_grid, statics)


# -------------------------------------------------------------------- ray features


def compute_ray_features(origins: torch.Tensor, directions: torch.Tensor,
                         statics: PlanesStatics) -> torch.Tensor:
    """Per-ray records [T, R, 48] f32 of ``origins`` / ``directions`` [T, R, 3]
    in repack space: position j of the march (at vertex coordinate j / P,
    flipped (NP - 1 - j) / P, along the axis) lies at depth ``at + bts j`` and
    in-plane vertex coordinates ``au + bu j``, ``av + bv j``; jmin / jmax
    bound the positions inside the grid and in front of the camera (none for
    a ray marching against the repack); the world length of one position
    step; the SH basis of the direction on lanes c < 3 ncoeff."""
    (u_ax, v_ax, num_pos, _g, u_real, v_real, _up, _vp, scales) = _geometry(statics)
    P = statics.pos_per_cell
    inv_scale = 1.0 / scales[statics.axis]
    first = (num_pos - 1) / P if statics.flip else 0.0
    w0 = statics.aabb[statics.axis][0] + (first + 0.5) * inv_scale
    return ray_records(origins, directions, statics, (u_ax, v_ax, u_real, v_real, scales),
                       w0, inv_scale / P, num_pos - 1)


# -------------------------------------------------------------------- tables

# position-subrange candidates per group for overflow splitting: full (7
# cells), halves (4 + 3 cells), then single cells; subrange [lo, hi]
# composites cells lo..hi-1 (shared boundary positions keep the integral
# exact across splits). The order key keeps every legal emission front to back.
_SUB_RANGES = (
    (0, 7), (0, 4), (4, 7),
    (0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7),
)
_SUB_ORDER = (0, 1, 6, 2, 3, 4, 5, 7, 8, 9)
_MAX_ACTIVE = 7  # worst case: all single cells


def build_tables(rays_feat: torch.Tensor, occ_dil: torch.Tensor, statics: PlanesStatics,
                 exact_spans: bool = False, group_range: Optional[Tuple[int, int]] = None):
    """Per-tile front-to-back traversal tables with overflow splitting:
    (tables [T, 7 G, 4] int32 = (global group, u0, v0, jlo * 256 + jhi),
    counts [T, 1] int32, overflow: a 0-d bool tensor on the device, True only
    when even a single cell's footprint exceeds the patch). ``exact_spans``
    bounds the footprints with every ray instead of the lattice.
    ``group_range`` = (g0, g1) restricts the tables to a depth segment:
    ``occ_dil`` is the mip's slice of groups [g0, g1) and G = g1 - g0, the
    entries keep global group indices. Entries sort by a stable sort of the
    JAX package's keys, so the tables equal its tables."""
    (_u_ax, _v_ax, _np, total_groups, u_real, v_real, u_pad, v_pad, _s) = _geometry(statics)
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
    glo = g_iota * STRIDE + sub[None, None, None, :, 0]  # [1, 1, G, C]
    ghi = g_iota * STRIDE + sub[None, None, None, :, 1]
    # a subrange emits cells [glo, ghi - 1]; cell c is composited iff
    # positions c and c + 1 are both in [jmin, jmax]
    live = (jminf <= ghi - 1.0) & (jmaxf >= glo + 1.0) & (jminf <= jmaxf)
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
    in_h0 = ~f_full & ~f_h0
    in_h1 = ~f_full & ~f_h1
    use = torch.stack([f_full, ~f_full & f_h0, ~f_full & f_h1]
                      + [in_h0] * 4 + [in_h1] * 3, dim=-1)
    active = use & any_live & occupied  # [T, G, C]
    overflow = (active[..., 3:] & ~fits[..., 3:]).any()

    num_tiles = active.shape[0]
    n_sub = len(_SUB_RANGES)
    cand = num_groups * n_sub
    order_off = torch.tensor(_SUB_ORDER, dtype=torch.int32, device=dev)[None, None, :]
    key = torch.where(active, g_idx.to(torch.int32) * 16 + order_off,
                      16 * num_groups + 15).reshape(num_tiles, cand)
    order = torch.sort(key, dim=-1, stable=True).indices[:, :_MAX_ACTIVE * num_groups]
    g_col = (g0 + g_idx.to(torch.int32)).expand(num_tiles, num_groups, n_sub)
    jpack = torch.tensor([lo * 256 + hi for (lo, hi) in _SUB_RANGES], dtype=torch.int32,
                         device=dev)[None, None, :].expand_as(g_col)

    def pick(x):
        return torch.gather(x.reshape(num_tiles, cand), 1, order)

    tables = torch.stack([pick(g_col), pick(u0), pick(v0), pick(jpack)],
                         dim=-1).to(torch.int32).contiguous()
    counts = active.sum(dim=(1, 2), dtype=torch.int32)[:, None]
    return tables, counts, overflow


# -------------------------------------------------------------------- image renderer


def tile_operands(statics: PlanesStatics, height: int, width: int, focal: float,
                  occ_dil: torch.Tensor, rotation: torch.Tensor, translation: torch.Tensor):
    """One pose's plane-march operands for the image padded to whole tiles:
    (rays_feat [tiles, tile_px^2, 48], tables, counts, overflow)."""
    tp = statics.tile_px
    height_pad = -(-height // tp) * tp
    width_pad = -(-width // tp) * tp
    rays_o, rays_d = _tile_image_rays(height_pad, width_pad, focal, height, width,
                                      rotation, translation, tp)
    rays_feat = compute_ray_features(rays_o, rays_d, statics)
    tables, counts, overflow = build_tables(rays_feat, occ_dil, statics)
    return rays_feat, tables, counts, overflow


def variant_statics(voxel_grid: VoxelGrid, axis: int, flip: bool, config) -> PlanesStatics:
    """The render config's plane-march knobs for one march variant (the
    bricked renderer's exit, occupancy and tile knobs, and
    ``planes_pos_per_cell``)."""
    want_diffuse = bool(getattr(config, "also_render_diffuse", False)
                        or getattr(config, "render_diffuse", False))
    return statics_for_grid(
        voxel_grid, axis, flip,
        exit_eps=config.bricked_exit_eps,
        occupancy_alpha_thresh=config.bricked_occupancy_alpha_thresh,
        with_diffuse=want_diffuse,
        tile_px=getattr(config, "bricked_tile_px", 0),
        pos_per_cell=getattr(config, "planes_pos_per_cell", 0),
    )


def _prepared(voxel_grid: VoxelGrid, statics: PlanesStatics, cache):
    """The variant's (repacked grid, occupancy mip), cached per grid."""
    key = ("planes", statics.axis, statics.flip, statics.occ_sigma_thresh,
           statics.pos_per_cell)
    return per_grid(cache, key, voxel_grid, lambda: prepare_plane_grid(voxel_grid, statics))


@torch.no_grad()
def render_image_planes(voxel_grid: VoxelGrid, camera_pose, camera_intrinsics, config,
                        cache: Optional[dict] = None, plain: bool = False) -> RenderOut:
    """Full-image render of one pose through the plane-march kernel (K11), on
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
    march = plane_march_render_plain if plain else plane_march_render
    out = march(tables, counts, rays_feat, repacked, ncoeff=statics.ncoeff,
                relu_sigma=statics.relu_sigma, exit_eps=statics.exit_eps,
                with_diffuse=statics.with_diffuse)
    return _finalize(out, statics, height, width, bool(config.white_bkgd), overflow)


@torch.no_grad()
def render_poses_planes(voxel_grid: VoxelGrid, camera_poses, camera_intrinsics, config,
                        cache: Optional[dict] = None, plain: bool = False) -> RenderOut:
    """Render a sequence of poses, one ``render_image_planes`` each (the JAX
    package's per-pose loop); every output gains a leading pose axis. Poses
    of one march variant share one repack."""
    cache = {} if cache is None else cache
    return stack_renders([render_image_planes(voxel_grid, pose, camera_intrinsics, config,
                                              cache=cache, plain=plain)
                          for pose in camera_poses])


class _PlanesProcedure(FlatRaysToFast):
    """RENDER_PROCEDURES entry: the plane march is pose-structured, so
    VolumetricModel renders whole poses through ``render_image`` /
    ``render_poses``; flat ray batches go to the fast renderer."""

    name = "render_sh_voxel_grid_planes"
    pipeline = "plane-march kernel"
    render_image = staticmethod(render_image_planes)
    render_poses = staticmethod(render_poses_planes)


render_sh_voxel_grid_planes = _PlanesProcedure()
