"""Tile-based training step through the slab-march kernels (the bricked
procedure's train step).

Counterpart of thr3ed_atom_tpu/modules/bricked_trainer.py (single device).
The slab march needs pose-coherent square pixel tiles, so a step takes one
march variant (axis, flip; the trainer's host decision) and ``num_tiles``
tiles at random pixel offsets, each from a training view of that variant
(``pose_idx``, one per tile). A random slab offset theta ~ U(0.05, 0.95) per
step stratifies the samples along the march axis.

Gradients flow loss -> the slab march's replay VJP (K10, ops/slab_march.py;
its cotangent is cast to the repacked grid's bf16, as the reference's) ->
autograd of the repack (lerp, flip, interleave, pad) -> the grid's densities
and features. The tables and the occupancy mip are sampling geometry and
take no gradient; training uses no occupancy skipping (threshold 0: a skipped
entry gets no gradient, so an emptied region could never regrow).

The step's random draws (tile origins and theta) come from one helper,
``draw_tiles``, that reads a ``torch.Generator``; a caller may pass the draws
instead.

``bricked_train_step_mesh`` runs the step over a (``"data"`` tiles x
``"model"`` depth segments) mesh of ``torch.distributed`` ranks: each rank
marches its tiles through its segment of slab groups (K9 at the segment's
``group_offset``), the segments are gathered without a gradient and composited
front to back, and the gradient is all-reduced over the mesh.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid
from thr3ed_atom_tpu_torch.ops.slab_march import slab_march
from thr3ed_atom_tpu_torch.rendering.bricked import (
    BrickedStatics,
    _slab_geometry,
    build_tables,
    compute_ray_features,
    occupancy_mip,
    repack_slab_grid,
    statics_for_grid,
)
from thr3ed_atom_tpu_torch.rendering.gnomonic import _div, _strict_f32
from thr3ed_atom_tpu_torch.utils.metrics import mse2psnr

F32 = torch.float32


class BrickedTrainStatics(NamedTuple):
    """Constants of one march variant's train step."""

    bricked: BrickedStatics
    image_height: int
    image_width: int
    focal: float
    num_tiles: int  # tiles per step (rays = num_tiles * tile_px^2)
    white_bkgd: bool
    apply_diffuse_render_regularization: bool


def make_bricked_train_statics(
    voxel_grid: VoxelGrid,
    axis: int,
    flip: bool,
    *,
    image_height: int,
    image_width: int,
    focal: float,
    ray_batch_size: int,
    white_bkgd: bool,
    apply_diffuse_render_regularization: bool = True,
    exit_eps: float = 1e-4,
    occupancy_alpha_thresh: float = 0.0,
    tile_px: int = 0,
    axis_supersample: int = 0,
) -> BrickedTrainStatics:
    """The step's constants for march variant (axis, flip): ``ray_batch_size
    // tile_px^2`` tiles a step (at least one); occupancy skipping off by
    default (see the module's docstring)."""
    bricked = statics_for_grid(
        voxel_grid, axis, flip, exit_eps=exit_eps,
        occupancy_alpha_thresh=occupancy_alpha_thresh,
        with_diffuse=apply_diffuse_render_regularization, tile_px=tile_px,
        axis_supersample=axis_supersample,
    )
    num_tiles = max(1, ray_batch_size // bricked.tile_px ** 2)
    return BrickedTrainStatics(
        bricked=bricked,
        image_height=int(image_height),
        image_width=int(image_width),
        focal=float(focal),
        num_tiles=int(num_tiles),
        white_bkgd=bool(white_bkgd),
        apply_diffuse_render_regularization=bool(apply_diffuse_render_regularization),
    )


def draw_tiles(generator: torch.Generator, statics: BrickedTrainStatics
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step's random draws from ``generator``: the tiles' top rows ``ty``
    and left columns ``tx`` ([num_tiles] int64, uniform over the offsets
    that keep a tile inside the image) and theta (0-d f32, U(0.05, 0.95)).
    The reference draws them with jax.random from its step key."""
    tp, nt = statics.bricked.tile_px, statics.num_tiles
    if statics.image_height < tp or statics.image_width < tp:
        raise ValueError(f"images of {statics.image_height} x {statics.image_width} "
                         f"pixels hold no {tp} x {tp} tile")
    dev = generator.device
    ty = torch.randint(0, statics.image_height - tp + 1, (nt,), generator=generator,
                       device=dev)
    tx = torch.randint(0, statics.image_width - tp + 1, (nt,), generator=generator,
                       device=dev)
    theta = 0.05 + 0.9 * torch.rand((), generator=generator, device=dev)
    return ty, tx, theta


def sample_tiles(statics: BrickedTrainStatics, images: torch.Tensor, poses: torch.Tensor,
                 pose_idx: torch.Tensor, ty: torch.Tensor, tx: torch.Tensor):
    """The tiles at (ty, tx) of the views ``pose_idx`` ([num_tiles]):
    (rays_o, rays_d, pixels), each [num_tiles, tile_px^2, 3]. ``images``
    [N, H, W, 3], ``poses`` [N, 3, 4]; the ray through a pixel is the
    reference's (pixel centre, focal, camera looking down -z)."""
    tp, nt = statics.bricked.tile_px, statics.num_tiles
    height, width, focal = statics.image_height, statics.image_width, statics.focal
    dev = images.device
    pose_idx = pose_idx.to(dev).long().expand(nt)
    ty, tx = ty.to(dev).long(), tx.to(dev).long()
    d = torch.arange(tp, device=dev)
    py = (ty[:, None, None] + d[None, :, None]).expand(nt, tp, tp)
    px = (tx[:, None, None] + d[None, None, :]).expand(nt, tp, tp)
    pixels = images[pose_idx[:, None, None], py, px].reshape(nt, tp * tp, 3)
    xf = px.to(F32) + 0.5
    yf = py.to(F32) + 0.5
    dirs_cam = torch.stack([_div(xf - width * 0.5, focal), -_div(yf - height * 0.5, focal),
                            -torch.ones_like(xf)], dim=-1).reshape(nt, tp * tp, 3)
    pose = poses.to(device=dev, dtype=F32)[pose_idx]  # [nt, 3, 4]
    rot = pose[:, None, :, :3]  # [nt, 1, 3 (i), 3 (j)]
    rays_d = (rot[..., 0] * dirs_cam[..., 0:1] + rot[..., 1] * dirs_cam[..., 1:2]
              + rot[..., 2] * dirs_cam[..., 2:3])
    rays_o = pose[:, None, :, 3].expand(rays_d.shape)
    return rays_o, rays_d, pixels.to(F32)


def _objective(statics: BrickedTrainStatics, out: torch.Tensor, pixels: torch.Tensor):
    """Specular L1 plus, with the diffuse regularization, diffuse L1 (the
    reference trainer's objective); (total, metrics) as 0-d tensors."""
    colour, acc = out[..., 0:3], out[..., 3:4]
    if statics.white_bkgd:
        colour = colour + (1.0 - acc)
    specular_loss = torch.mean(torch.abs(colour - pixels))
    specular_mse = torch.mean((colour - pixels) ** 2)
    total = specular_loss
    aux = {"specular_loss": specular_loss, "specular_psnr": mse2psnr(specular_mse)}
    if statics.apply_diffuse_render_regularization:
        diffuse = out[..., 5:8]
        if statics.white_bkgd:
            diffuse = diffuse + (1.0 - acc)
        diffuse_loss = torch.mean(torch.abs(diffuse - pixels))
        diffuse_mse = torch.mean((diffuse - pixels) ** 2)
        total = total + diffuse_loss
        aux["diffuse_loss"] = diffuse_loss
        aux["diffuse_psnr"] = mse2psnr(diffuse_mse)
    aux["total_loss"] = total
    return total, aux


def tile_loss(statics: BrickedTrainStatics, grid: VoxelGrid, images, poses, pose_idx,
              draws, plain: bool = False):
    """The step's objective on the tiles and theta of ``draws`` = (ty, tx,
    theta), differentiable in the grid's tensors: (total, metrics)."""
    bst = statics.bricked
    ty, tx, theta = draws
    rays_o, rays_d, pixels = sample_tiles(statics, images, poses, pose_idx, ty, tx)
    theta = torch.as_tensor(theta, dtype=F32, device=rays_o.device)
    with torch.no_grad():
        rays_feat = compute_ray_features(rays_o, rays_d, bst, theta)
        occ = occupancy_mip(grid, bst)
        tables, counts, _ = build_tables(rays_feat, occ, bst)
    repacked = repack_slab_grid(grid, bst, theta)
    out = slab_march(tables, counts, rays_feat, repacked, ncoeff=bst.ncoeff,
                     relu_sigma=bst.relu_sigma, exit_eps=bst.exit_eps,
                     with_diffuse=bst.with_diffuse, plain=plain)
    return _objective(statics, out, pixels)


def bricked_train_step(statics: BrickedTrainStatics, optimizer: torch.optim.Optimizer,
                       grid: VoxelGrid, images: torch.Tensor, poses, pose_idx,
                       generator: Optional[torch.Generator] = None, *,
                       draws=None, scheduler=None, plain: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """One optimization step on ``statics.num_tiles`` tiles of the views
    ``pose_idx`` (one per tile, all of the statics' march variant): the
    objective's gradient with respect to the grid's densities and features,
    then ``optimizer.step()`` (and ``scheduler.step()``) in place. The tiles
    and theta come from ``draw_tiles(generator, statics)``, or are given as
    ``draws`` = (ty, tx, theta). ``plain`` runs the slab march's plain
    versions. Returns the metrics (0-d tensors)."""
    _strict_f32()
    if draws is None:
        draws = draw_tiles(generator, statics)
    dev = grid.device
    poses = torch.as_tensor(np.asarray(poses, np.float32) if not torch.is_tensor(poses)
                            else poses).to(dev)
    pose_idx = torch.as_tensor(np.asarray(pose_idx) if not torch.is_tensor(pose_idx)
                               else pose_idx).to(dev)
    optimizer.zero_grad(set_to_none=True)
    with grid.trainable():
        loss, aux = tile_loss(statics, grid, images, poses, pose_idx, draws, plain=plain)
        loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
    return {k: v.detach() for k, v in aux.items()}



# ------------------------------------------------------------------ multi-device step
#
# Layout (the JAX package's): "data" splits the tiles; "model" splits the
# march into DEPTH SEGMENTS of slab groups. Front-to-back compositing is
# associative, (C1, T1) o (C2, T2) = (C1 + T1 C2, T1 T2), and the march's acc
# output encodes T = 1 - acc, so each rank renders its contiguous group range
# for its tiles and the segments combine after one all_gather over "model".


def _combine_segments(parts) -> torch.Tensor:
    """[T, R, 8] per-segment composites, front to back -> [T, R, 8]."""
    out = parts[0]
    for seg in parts[1:]:
        t_front = 1.0 - out[..., 3:4]
        out = torch.cat([out[..., 0:3] + t_front * seg[..., 0:3],
                         out[..., 3:4] + t_front * seg[..., 3:4],
                         out[..., 4:5] + t_front * seg[..., 4:5],
                         out[..., 5:8] + t_front * seg[..., 5:8]], dim=-1)
    return out


def bricked_train_step_mesh(statics: BrickedTrainStatics, optimizer: torch.optim.Optimizer,
                            mesh_shape: Tuple[int, int], grid: VoxelGrid,
                            images: torch.Tensor, poses, pose_idx,
                            generator: Optional[torch.Generator] = None, *,
                            draws=None, scheduler=None) -> Dict[str, torch.Tensor]:
    """``bricked_train_step`` over a ``mesh_shape`` = (data_parallel,
    model_parallel) mesh of the first ranks of the default group (rank = d *
    model_parallel + m). Every rank draws the same tiles and theta (``draws``,
    else ``draw_tiles(generator, ...)``: the generators start alike) and
    takes its data shard of the tiles; rank (d, m) marches them through the
    slab groups [g0, g0 + G / model_parallel), g0 = m G / model_parallel, with
    tables of global group indices (``build_tables(..., group_range=)``) and
    K9 at ``group_offset`` g0, under a segment-local early exit at the
    statics' ``exit_eps`` (a segment cannot see the transmittance in front of
    it, but T = T_front T_local <= T_local, so the tail it drops is bounded by
    eps as on one device; exit_eps = 0 makes the step exact). The segments
    are all-gathered over "model" without a gradient and composited front to
    back, this rank's segment being the live tensor and the others
    constants, so each rank differentiates its own segment only. The grid
    gradient is then all-reduced over the world (a rank outside the mesh
    adds zeros), and every rank takes the same optimizer step. Returns
    {"total_loss", "specular_psnr"} as the JAX package's mesh step."""
    import torch.distributed as dist

    from thr3ed_atom_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        MODEL_AXIS,
        all_reduce_,
        make_grid_mesh,
    )

    _strict_f32()
    data_parallel, model_parallel = (int(x) for x in mesh_shape)
    mesh = make_grid_mesh(model_parallel, data_parallel * model_parallel)
    bst = statics.bricked
    num_groups = _slab_geometry(bst)[3]
    if num_groups % model_parallel:
        raise ValueError(f"slab groups ({num_groups}) must divide over model_parallel "
                         f"({model_parallel})")
    if statics.num_tiles % data_parallel:
        raise ValueError(f"{statics.num_tiles} tiles do not divide over data_parallel "
                         f"({data_parallel})")
    seg_groups = num_groups // model_parallel
    if draws is None:
        draws = draw_tiles(generator, statics)
    dev = grid.device
    poses = torch.as_tensor(np.asarray(poses, np.float32) if not torch.is_tensor(poses)
                            else poses).to(dev)
    pose_idx = torch.as_tensor(np.asarray(pose_idx) if not torch.is_tensor(pose_idx)
                               else pose_idx).to(dev)
    ty, tx, theta = draws
    n_total = float(statics.num_tiles * bst.tile_px ** 2 * 3)
    optimizer.zero_grad(set_to_none=True)
    with grid.trainable():
        if mesh.is_member:
            d, m = mesh.axis_index(DATA_AXIS), mesh.axis_index(MODEL_AXIS)
            rays_o, rays_d, pixels = sample_tiles(statics, images, poses, pose_idx, ty, tx)
            theta = torch.as_tensor(theta, dtype=F32, device=rays_o.device)
            tiles = torch.tensor_split(torch.arange(statics.num_tiles, device=dev),
                                       data_parallel)[d]
            g0 = m * seg_groups
            with torch.no_grad():
                rays_feat = compute_ray_features(rays_o, rays_d, bst, theta)[tiles]
                occ = occupancy_mip(grid, bst)[g0:g0 + seg_groups]
                tables, counts, _ = build_tables(rays_feat, occ, bst,
                                                 group_range=(g0, g0 + seg_groups))
            pixels = pixels[tiles]
            repacked = repack_slab_grid(grid, bst, theta)[g0:g0 + seg_groups]
            out_local = slab_march(tables, counts, rays_feat, repacked, ncoeff=bst.ncoeff,
                                   relu_sigma=bst.relu_sigma, exit_eps=bst.exit_eps,
                                   with_diffuse=bst.with_diffuse, group_offset=g0)
            parts = [torch.empty_like(out_local) for _ in range(model_parallel)]
            dist.all_gather(parts, out_local.detach().contiguous(),
                            group=mesh.group(MODEL_AXIS))
            parts[m] = out_local
            out = _combine_segments(parts)
            colour, acc = out[..., 0:3], out[..., 3:4]
            if statics.white_bkgd:
                colour = colour + (1.0 - acc)
            total = torch.sum(torch.abs(colour - pixels)) / n_total
            sq_sum = torch.sum((colour - pixels) ** 2).detach()
            if statics.apply_diffuse_render_regularization:
                diffuse = out[..., 5:8]
                if statics.white_bkgd:
                    diffuse = diffuse + (1.0 - acc)
                total = total + torch.sum(torch.abs(diffuse - pixels)) / n_total
            # Each rank differentiates only its own segment (the others are
            # gathered constants), so the sum over the mesh assembles the
            # segments' cotangents once each. The JAX package differentiates
            # through its all_gather, whose transpose sums model_parallel
            # identical cotangents into every segment, and divides its psum
            # by model_parallel; here no such factor arises.
            total.backward()
            sums = torch.stack([total.detach(), sq_sum])
        else:
            sums = torch.zeros(2, dtype=F32, device=dev)
        for p in (grid.densities, grid.features):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_([grid.densities.grad, grid.features.grad, sums])
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
    # every "model" rank of a data row holds the same combined loss
    sums = sums / torch.full((), float(model_parallel), dtype=F32, device=dev)
    return {"total_loss": sums[0],
            "specular_psnr": mse2psnr(sums[1] / torch.full((), n_total, dtype=F32,
                                                           device=dev))}
