"""Coarse-to-fine reconstruction trainer for SH voxel grids from posed images
(counterpart of thr3ed_atom_tpu/modules/trainer.py).

Each stage trains the grid with Adam (b1 0.9, b2 0.999, eps 1e-8) at the
stage's learning rate ``learning_rate * stagewise_lr_decay_gamma ** (stage -
1)``, decayed in steps: ``lr * lr_decay_gamma_per_stage ** (count //
lr_decay_steps_per_stage)`` after ``count`` optimizer steps (optax's
exponential_decay with staircase=True). A step takes at least
``_GN_MIN_POSES_PER_STEP`` whole views of one (march axis, flip, warp order)
bucket (rendering/gnomonic_train.py gnomonic_train_step_multi); with the
bricked procedure a step takes ``ray_batch_size // tile_px^2`` pixel tiles of
the views of one (march axis, flip) bucket (modules/bricked_trainer.py
bricked_train_step); every other procedure (the fast two-phase renderer,
the exact one, the hierarchical one; planes through its flat-ray route to
the fast renderer) takes a ray batch: ``ray_batch_size`` (image, pixel) pairs
drawn uniformly over the stage's views, rendered through the procedure
(``ray_batch_train_step``). Between stages the grid grows by trilinear
resize.

The loop is the JAX package's: the per-stage downsampled datasets, the
uniform(-1, 1) re-initialization at the smallest stage, resume from a
checkpoint with its Adam moments, the buckets and the pose picker
(``np.random.default_rng(seed + stage)``, the same ``choice`` calls in the same
order, so both packages train on the same views and, bricked, pick the same
view for every tile), summaries, feedback renders,
held-out tests, checkpoints. Checkpoints and ``<ckpt>_opt.npz`` keep the JAX
package's format (optax's state leaves ``leaf_0 .. leaf_5``), so either
package resumes from the other's. Summaries are JSON lines in
``training_logs/summaries.jsonl`` and a TensorBoard event file in
``training_logs/tensorboard/`` under the JAX package's scalar names.

``use_mesh`` trains over the ranks of a ``torch.distributed`` group, one
process a device (parallel/mesh.py): the gnomonic steps pose-parallel
(``gnomonic_train_step_mesh``), the bricked steps over tiles x depth
segments (``bricked_train_step_mesh``), the ray batches data-parallel
(``ray_batch_train_step`` with ``TrainStepStatics.use_mesh``, which also
splits the grid's x axis over a "model" axis with ``model_parallel`` > 1).
"""
from __future__ import annotations

import dataclasses
import json
import time
from datetime import timedelta
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from thr3ed_atom_tpu_torch.data.dataset import PosedImagesDataset
from thr3ed_atom_tpu_torch.data.png import write_png
from thr3ed_atom_tpu_torch.models.voxels import (
    VoxelGrid,
    scale_voxel_grid_with_required_output_size,
)
from thr3ed_atom_tpu_torch.modules.volumetric_model import (
    VolumetricModel,
    create_volumetric_model_from_saved_model,
)
from thr3ed_atom_tpu_torch.rendering.gnomonic import _strict_f32
from thr3ed_atom_tpu_torch.rendering.interface import Rays
from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig, get_render_procedure
from thr3ed_atom_tpu_torch.utils.camera import CameraPose, to8b
from thr3ed_atom_tpu_torch.utils.constants import (
    CAMERA_BOUNDS,
    CAMERA_INTRINSICS,
    EXTRA_DIFFUSE_COLOUR,
    HEMISPHERICAL_RADIUS,
)
from thr3ed_atom_tpu_torch.utils.logging import log
from thr3ed_atom_tpu_torch.utils.metrics import mse2psnr
from thr3ed_atom_tpu_torch.utils.misc import compute_thre3d_grid_sizes
from thr3ed_atom_tpu_torch.utils.profiling import ThroughputMeter

# minimum training views averaged per whole-pose step (the JAX trainer's
# measured floor: single-view steps at lr 0.03 thrash the grid)
_GN_MIN_POSES_PER_STEP = 4
_GNOMONIC = "render_sh_voxel_grid_gnomonic"
_BRICKED = "render_sh_voxel_grid_bricked"
_EXACT = "render_sh_voxel_grid"
F32 = torch.float32


def staircase_exponential_decay(transition_steps: int,
                                decay_rate: float) -> Callable[[int], float]:
    """Multiplier of the base learning rate after ``count`` steps:
    ``decay_rate ** (count // transition_steps)`` (constant 1 when
    ``transition_steps`` <= 0, as optax)."""
    if transition_steps <= 0:
        return lambda count: 1.0
    return lambda count: decay_rate ** (count // transition_steps)


def make_gnomonic_optimizer(
    grid: VoxelGrid,
    learning_rate: float = 0.03,
    lr_decay_steps_per_stage: int = 1000,
    lr_decay_gamma_per_stage: float = 0.1,
) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam over the grid's densities and features with the staircase decay;
    step the scheduler once after every optimizer step (the train steps do
    when given it), as optax counts updates."""
    optimizer = torch.optim.Adam([grid.densities, grid.features], lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer,
        staircase_exponential_decay(lr_decay_steps_per_stage, lr_decay_gamma_per_stage),
    )
    return optimizer, scheduler


# -------------------------------------------------------------------- ray-batch step


@dataclasses.dataclass(frozen=True)
class TrainStepStatics:
    """What the ray-batch step is built for: the render config, the stage's
    image size and focal, the batch size, the diffuse regularization and the
    procedure to differentiate through."""

    render_config: SHVoxGridRenderConfig
    image_height: int
    image_width: int
    focal: float
    ray_batch_size: int
    apply_diffuse_render_regularization: bool = True
    # the rays split over a "data" mesh axis; with model_parallel > 1 each
    # rank also keeps only its x slab of the grid (and of Adam's moments)
    # over a "model" axis; model_parallel > 1 requires use_mesh
    use_mesh: bool = False
    model_parallel: int = 1
    render_procedure: str = "render_sh_voxel_grid_fast"


class RayBatchDraws(NamedTuple):
    """One step's random draws: image and pixel indices [B] (int64), and
    optionally the renders' own draws as keyword arguments of the procedure
    (``t_rand``, ``noise``; hierarchical also ``u``) for the specular render
    and for the separate diffuse render; None lets a render draw from the
    step's generator."""

    img_idx: torch.Tensor
    pix_idx: torch.Tensor
    specular: Optional[Dict[str, torch.Tensor]] = None
    diffuse: Optional[Dict[str, torch.Tensor]] = None


def draw_ray_batch(generator: torch.Generator, statics: TrainStepStatics,
                   num_images: int) -> RayBatchDraws:
    """The step's (image, pixel) indices, uniform over ``num_images`` views
    of the stage and every pixel, from ``generator``; the renders draw
    their jitter and noise from the same generator afterwards. The JAX
    package draws them from its step key."""
    batch, dev = statics.ray_batch_size, generator.device
    img_idx = torch.randint(0, num_images, (batch,), generator=generator, device=dev)
    pix_idx = torch.randint(0, statics.image_height * statics.image_width, (batch,),
                            generator=generator, device=dev)
    return RayBatchDraws(img_idx, pix_idx)


def sample_ray_pixel_batch(images: torch.Tensor, poses: torch.Tensor,
                           statics: TrainStepStatics, img_idx: torch.Tensor,
                           pix_idx: torch.Tensor) -> Tuple[Rays, torch.Tensor]:
    """The rays and target pixels of the (image, pixel) pairs ``img_idx``,
    ``pix_idx`` ([B]): ``images`` [N, H, W, 3], ``poses`` [N, 3, 4] on one
    device. Pinhole directions through the pixel centres, the camera
    looking down -z, divided by the focal as the JAX package's jitted step
    divides by a constant (a product with its f32 reciprocal), rotated into
    world space in f32 (``rotate_f32``)."""
    height, width = statics.image_height, statics.image_width
    dev = images.device
    img_idx, pix_idx = img_idx.to(dev).long(), pix_idx.to(dev).long()
    py, px = pix_idx // width, pix_idx % width
    pixels = images[img_idx, py, px]  # [B, 3]
    inv_focal = (torch.tensor(1.0, dtype=F32) / torch.tensor(float(statics.focal), dtype=F32)
                 ).to(dev)
    x = px.to(F32) + 0.5
    y = py.to(F32) + 0.5
    dirs_cam = torch.stack([(x - width * 0.5) * inv_focal, -(y - height * 0.5) * inv_focal,
                            -torch.ones_like(x)], dim=-1)  # [B, 3]
    pose = poses.to(device=dev, dtype=F32)[img_idx]  # [B, 3, 4]
    return Rays(origins=pose[:, :, 3], directions=rotate_f32(pose[:, :, :3], dirs_cam)
                ), pixels.to(F32)


def rotate_f32(rotations: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """``rotations`` [B, 3, 3] times ``vectors`` [B, 3] in f32, rounded as
    the JAX package's f32 dot rounds a 3-term row: the fused multiply-add
    chain fma(r2, v2, fma(r1, v1, r0 v0)). Each f32 product is exact in f64,
    so the chain is f64 sums rounded to f32 after each term (the same
    digits on the CPU and the card)."""
    r, v = rotations.double(), vectors.double()[:, None, :]
    acc = (r[..., 0] * v[..., 0]).float()
    for j in (1, 2):
        acc = (acc.double() + r[..., j] * v[..., j]).float()
    return acc


def draw_render_draws(generator: torch.Generator, statics: TrainStepStatics,
                      batch: int) -> Tuple[Dict[str, torch.Tensor], Optional[Dict]]:
    """The renders' own draws for ``batch`` rays, drawn from ``generator`` in
    the order the procedure draws them (the specular render's, then the exact
    procedure's separate diffuse render's): the jitter's uniforms ``t_rand``
    (hierarchical: the coarse ``t_rand`` and the fine ``u``) with
    ``perturb_sampled_points``, and the density noise's normals ``noise``
    with ``stochastic_density_noise_std`` > 0. Returns (specular, diffuse or
    None); a mesh step draws the global batch's and shards them."""
    from thr3ed_atom_tpu_torch.rendering.hierarchical import hierarchical_budget

    cfg, dev = statics.render_config, generator.device
    samples = cfg.num_samples_per_ray
    hierarchical = statics.render_procedure == "render_sh_voxel_grid_hierarchical"

    def one() -> Dict[str, torch.Tensor]:
        out = {}
        if hierarchical:
            num_coarse, num_fine = hierarchical_budget(samples)
            if cfg.perturb_sampled_points:
                out["t_rand"] = torch.rand((batch, num_coarse), generator=generator,
                                           device=dev)
                out["u"] = torch.rand((batch, num_fine), generator=generator, device=dev)
            shape = (batch, num_coarse + num_fine)
        else:
            if cfg.perturb_sampled_points:
                out["t_rand"] = torch.rand((batch, samples), generator=generator, device=dev)
            shape = (batch, samples)
        if cfg.stochastic_density_noise_std > 0.0:
            out["noise"] = torch.randn(shape, generator=generator, device=dev)
        return out

    specular = one()
    separate = (statics.apply_diffuse_render_regularization
                and statics.render_procedure == _EXACT)
    return specular, (one() if separate else None)


def _ray_batch_colours(statics: TrainStepStatics, grid: VoxelGrid, images: torch.Tensor,
                       poses: torch.Tensor, draws: RayBatchDraws,
                       generator: Optional[torch.Generator] = None):
    """(pixels, specular colour, diffuse colour or None) of the batch of
    ``draws``, differentiable in the grid (see ``ray_batch_loss``)."""
    rays, pixels = sample_ray_pixel_batch(images, poses, statics, draws.img_idx,
                                          draws.pix_idx)
    procedure = get_render_procedure(statics.render_procedure)
    fuse_diffuse = (statics.apply_diffuse_render_regularization
                    and statics.render_procedure != _EXACT)
    specular_config = statics.render_config.replace(also_render_diffuse=fuse_diffuse)
    specular = procedure(grid, rays, specular_config, generator, **(draws.specular or {}))
    diffuse_colour = None
    if statics.apply_diffuse_render_regularization:
        if fuse_diffuse:
            diffuse_colour = specular.extra[EXTRA_DIFFUSE_COLOUR]
        else:
            diffuse_colour = procedure(grid, rays,
                                       statics.render_config.replace(render_diffuse=True),
                                       generator, **(draws.diffuse or {})).colour
    return pixels, specular.colour, diffuse_colour


def ray_batch_loss(statics: TrainStepStatics, grid: VoxelGrid, images: torch.Tensor,
                   poses: torch.Tensor, draws: RayBatchDraws,
                   generator: Optional[torch.Generator] = None):
    """The step's objective on the batch of ``draws``, differentiable in
    the grid: specular L1 plus, with the diffuse regularization, diffuse L1.
    The diffuse colour comes from the specular render's own samples, weights
    and gathered rows (``also_render_diffuse``), except through the exact
    procedure, which has no such output and renders a second time with
    ``render_diffuse``. Returns (total, metrics: the losses and their
    MSE-based PSNRs)."""
    pixels, specular_colour, diffuse_colour = _ray_batch_colours(
        statics, grid, images, poses, draws, generator)
    specular_loss = torch.mean(torch.abs(specular_colour - pixels))
    total = specular_loss
    aux = {"specular_loss": specular_loss,
           "specular_psnr": mse2psnr(torch.mean((specular_colour - pixels) ** 2))}
    if diffuse_colour is not None:
        diffuse_loss = torch.mean(torch.abs(diffuse_colour - pixels))
        total = total + diffuse_loss
        aux["diffuse_loss"] = diffuse_loss
        aux["diffuse_psnr"] = mse2psnr(torch.mean((diffuse_colour - pixels) ** 2))
    aux["total_loss"] = total
    return total, aux


def ray_batch_train_step(statics: TrainStepStatics, optimizer: torch.optim.Optimizer,
                         grid: VoxelGrid, images: torch.Tensor, poses: torch.Tensor,
                         generator: Optional[torch.Generator] = None, *,
                         draws: Optional[RayBatchDraws] = None, scheduler=None
                         ) -> Dict[str, torch.Tensor]:
    """One optimization step on a ray batch (the JAX package's
    ``_train_step``): the objective's gradient with respect to the grid's
    densities and features, then ``optimizer.step()`` (and
    ``scheduler.step()``) in place. The batch is ``draws``, else
    ``draw_ray_batch(generator, ...)``. With ``statics.use_mesh`` the step
    runs over a mesh of the default group's ranks (``_ray_batch_train_step_mesh``).
    Returns the metrics (0-d tensors)."""
    if statics.use_mesh:
        return _ray_batch_train_step_mesh(statics, optimizer, grid, images, poses, generator,
                                          draws=draws, scheduler=scheduler)
    if statics.model_parallel != 1:
        raise ValueError(f"model_parallel {statics.model_parallel} needs use_mesh")
    _strict_f32()
    if draws is None:
        draws = draw_ray_batch(generator, statics, images.shape[0])
    optimizer.zero_grad(set_to_none=True)
    with grid.trainable():
        loss, aux = ray_batch_loss(statics, grid, images, poses, draws, generator)
        loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
    return {k: v.detach() for k, v in aux.items()}


def _ray_batch_train_step_mesh(statics: TrainStepStatics, optimizer: torch.optim.Optimizer,
                               grid: VoxelGrid, images: torch.Tensor, poses: torch.Tensor,
                               generator: Optional[torch.Generator] = None, *,
                               draws: Optional[RayBatchDraws] = None, scheduler=None
                               ) -> Dict[str, torch.Tensor]:
    """``ray_batch_train_step`` over a mesh of the default group's ranks
    (``statics.use_mesh``): ("data",) of every rank, or ("data", "model")
    with ``statics.model_parallel`` > 1 (rank = d * model_parallel + m).
    Every rank draws the same global batch (``draws``, else
    ``draw_ray_batch`` and ``draw_render_draws`` from ``generator``: the
    generators start alike) and takes its contiguous "data" shard. The loss
    is the shard's sum over the global ray count, so the gradients summed
    over "data" are the global mean's. With model_parallel 1, ``grid`` is
    the replicated grid; with more, ``grid`` is this rank's x slab
    (``parallel.mesh.shard_grid_spatial``: the optimizer holds the slab and
    its moments), the forward all-gathers the slabs over "model" without a
    gradient, and the reduced gradient of the whole grid is cut back to the
    slab. Every rank then takes the same optimizer step on the same
    gradient. Returns the global batch's metrics."""
    from thr3ed_atom_tpu_torch.parallel import mesh as pm

    _strict_f32()
    mp = int(statics.model_parallel)
    mesh = pm.make_grid_mesh(mp) if mp > 1 else pm.make_data_mesh()
    if not mesh.is_member:
        raise RuntimeError("ray_batch_train_step: this rank is outside the mesh")
    if draws is None:
        draws = draw_ray_batch(generator, statics, images.shape[0])
        specular, diffuse = draw_render_draws(generator, statics, statics.ray_batch_size)
        draws = draws._replace(specular=specular, diffuse=diffuse)
    local = pm.shard_batch(mesh, draws)
    batch = int(draws.img_idx.shape[0])
    dev = grid.device
    n_total = torch.full((), float(batch * 3), dtype=F32, device=dev)
    optimizer.zero_grad(set_to_none=True)
    if mp > 1:
        full_x = grid.grid_dims[0] * mp
        if any(s.shape[0] != grid.grid_dims[0]
               for s in torch.tensor_split(torch.empty(full_x, 0), mp)):
            raise ValueError("ray_batch_train_step: the grid's x extent must divide "
                             f"over model_parallel {mp}")
        target = pm.gather_grid_spatial(mesh, grid, full_x)
    else:
        target = grid
    with target.trainable():
        pixels, spec, dif = _ray_batch_colours(statics, target, images, poses, local,
                                               generator)
        sums = [torch.sum(torch.abs(spec - pixels)), torch.sum((spec - pixels) ** 2)]
        if dif is not None:
            sums += [torch.sum(torch.abs(dif - pixels)), torch.sum((dif - pixels) ** 2)]
        total = sums[0] / n_total
        if dif is not None:
            total = total + sums[2] / n_total
        total.backward()
    grads = [target.densities.grad, target.features.grad]
    stacked = torch.stack([x.detach() for x in sums])
    pm.all_reduce_(grads + [stacked], group=mesh.group(pm.DATA_AXIS))
    with grid.trainable():
        if mp > 1:
            m = mesh.axis_index(pm.MODEL_AXIS)
            grid.densities.grad = torch.tensor_split(grads[0], mp)[m].clone()
            grid.features.grad = torch.tensor_split(grads[1], mp)[m].clone()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
    means = stacked / n_total
    metrics = {"specular_loss": means[0], "specular_psnr": mse2psnr(means[1])}
    total = means[0]
    if dif is not None:
        metrics["diffuse_loss"] = means[2]
        metrics["diffuse_psnr"] = mse2psnr(means[3])
        total = total + means[2]
    metrics["total_loss"] = total
    return metrics


# --------------------------------------------------------------- optimizer checkpoints


def _opt_state_path(model_path: Path) -> Path:
    # checkpoints are written from a suffix-less stem, but --resume_from is
    # usually given the model's ".npz" path: accept both spellings
    base = str(model_path)
    if base.endswith(".npz"):
        base = base[: -len(".npz")]
    return Path(base + "_opt.npz")


def _adam_count(optimizer: torch.optim.Adam) -> int:
    steps = {int(optimizer.state[p]["step"]) for g in optimizer.param_groups
             for p in g["params"] if p in optimizer.state}
    if len(steps) > 1:
        raise ValueError(f"Adam parameters at different steps {steps}")
    return steps.pop() if steps else 0


def save_optimizer_state(model_path: Path, optimizer: torch.optim.Adam, stage: int,
                         stage_iteration: int) -> None:
    """Adam moments + schedule count beside the model npz, in the leaf layout
    of the JAX package's optax ``adam(schedule)`` state over a VoxelGrid:
    leaf_0 the Adam count (int32), leaf_1 / leaf_2 the first moments of the
    densities / features, leaf_3 / leaf_4 the second moments, leaf_5 the
    schedule count (int32)."""
    params = optimizer.param_groups[0]["params"]  # densities, features
    count = _adam_count(optimizer)

    def moment(p, name):
        state = optimizer.state.get(p)
        if state is None:
            return np.zeros(tuple(p.shape), np.float32)
        return state[name].detach().cpu().numpy().astype(np.float32)

    leaves = [np.int32(count)]
    leaves += [moment(p, "exp_avg") for p in params]
    leaves += [moment(p, "exp_avg_sq") for p in params]
    leaves.append(np.int32(count))
    np.savez(
        str(_opt_state_path(model_path)),
        stage=np.int64(stage),
        stage_iteration=np.int64(stage_iteration),
        **{f"leaf_{i}": x for i, x in enumerate(leaves)},
    )


def load_optimizer_state(model_path: Path, optimizer: torch.optim.Adam,
                         scheduler=None) -> Optional[Tuple[int, int]]:
    """Load ``<model>_opt.npz`` (either package's) into ``optimizer`` (over
    densities, features) and set ``scheduler`` to its count. Returns (stage,
    stage_iteration), or None when the file is absent or its leaves do not
    match the parameters' shapes (nothing is changed then)."""
    path = _opt_state_path(model_path)
    if not path.exists():
        return None
    params = optimizer.param_groups[0]["params"]
    with np.load(str(path)) as data:
        shapes = [()] + [tuple(p.shape) for p in params] * 2 + [()]
        if any(f"leaf_{i}" not in data or data[f"leaf_{i}"].shape != s
               for i, s in enumerate(shapes)):
            return None
        leaves = [data[f"leaf_{i}"] for i in range(len(shapes))]
        stage, stage_iteration = int(data["stage"]), int(data["stage_iteration"])
    count = int(leaves[0])
    for i, p in enumerate(params):
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.as_tensor(leaves[1 + i], dtype=torch.float32).to(p.device),
            "exp_avg_sq": torch.as_tensor(leaves[1 + len(params) + i],
                                          dtype=torch.float32).to(p.device),
        }
    if scheduler is not None:
        _set_schedule_count(optimizer, scheduler, int(leaves[-1]))
    return stage, stage_iteration


def _set_schedule_count(optimizer, scheduler, count: int) -> None:
    """Put a LambdaLR at ``count`` steps (the learning rate of update count + 1)."""
    scheduler.last_epoch = count
    for group, fn in zip(optimizer.param_groups, scheduler.lr_lambdas):
        group["lr"] = group["initial_lr"] * fn(count)
    scheduler._last_lr = [g["lr"] for g in optimizer.param_groups]


# ----------------------------------------------------------------------- summaries


class SummaryLog:
    """Scalar summaries as JSON lines {"step", "name", "value"} and, with
    ``event_dir``, as a TensorBoard event file there (utils/tensorboard.py,
    where the JAX package's tensorboardX SummaryWriter writes its own); the
    names are the JAX package's."""

    def __init__(self, path: Path, event_dir: Optional[Path] = None):
        from thr3ed_atom_tpu_torch.utils.tensorboard import EventFileWriter

        self._path = Path(path)
        self._path.parent.mkdir(parents=True, exist_ok=True)
        self._events = None if event_dir is None else EventFileWriter(event_dir)

    def add_scalar(self, name: str, value: float, global_step: int) -> None:
        with open(self._path, "a") as f:
            f.write(json.dumps({"step": int(global_step), "name": name,
                                "value": float(value)}) + "\n")
        if self._events is not None:
            self._events.add_scalar(name, float(value), int(global_step))


# ------------------------------------------------------------------------- procedure


def _bricked_mesh_shape(b_statics, n_dev: int, model_parallel: int) -> Tuple[int, int]:
    """(data_parallel, model_parallel) for bricked_train_step_mesh over n_dev
    ranks (the JAX package's rule): tiles shard over "data", depth segments
    over "model". Pure tile parallelism is preferred (depth segments forfeit
    per-segment early exit and replicate the repack); an explicit
    model_parallel > 1 request is honoured first when divisibility allows.
    A shape may use fewer than n_dev ranks."""
    from thr3ed_atom_tpu_torch.rendering.bricked import _slab_geometry

    num_groups = _slab_geometry(b_statics.bricked)[3]
    num_tiles = b_statics.num_tiles
    if model_parallel > 1:
        dp = n_dev // model_parallel
        if dp >= 1 and num_groups % model_parallel == 0 and num_tiles % dp == 0:
            return dp, model_parallel
    # the most ranks; among equal totals the largest tile (data) axis
    for total in range(n_dev, 1, -1):
        for mp in range(1, total + 1):
            if total % mp or num_groups % mp:
                continue
            dp = total // mp
            if num_tiles % dp == 0:
                return dp, mp
    return 1, 1


def _pose_buckets(poses_np: np.ndarray, height: int, width: int, focal: float,
                  with_swap: bool = True):
    """{(axis, flip[, warp swap]): [view indices]} in first-seen order, and the
    buckets' weights (their share of the views). The bricked procedure's
    buckets are (axis, flip) only."""
    from thr3ed_atom_tpu_torch.rendering.gnomonic import dominant_axis_for_pose
    from thr3ed_atom_tpu_torch.rendering.warp_matmul import warp_swap_for_pose

    buckets = {}
    for i in range(len(poses_np)):
        rot = poses_np[i][:, :3]
        a, f = dominant_axis_for_pose(rot)
        key = (a, f, warp_swap_for_pose(rot, a, f, height, width, focal)) if with_swap \
            else (a, f)
        buckets.setdefault(key, []).append(i)
    weights = np.array([len(v) for v in buckets.values()], np.float64)
    return buckets, weights / weights.sum()


def train_sh_vox_grid_vol_mod_with_posed_images(
    vol_mod: VolumetricModel,
    train_dataset: PosedImagesDataset,
    output_dir: Path,
    test_dataset: Optional[PosedImagesDataset] = None,
    ray_batch_size: int = 32768,
    num_stages: int = 4,
    num_iterations_per_stage: int = 2000,
    scale_factor: float = 2.0,
    learning_rate: float = 0.03,
    lr_decay_gamma_per_stage: float = 0.1,
    lr_decay_steps_per_stage: int = 1000,
    stagewise_lr_decay_gamma: float = 0.9,
    render_feedback_pose: Optional[CameraPose] = None,
    save_freq: int = 1000,
    test_freq: int = 1000,
    feedback_freq: int = 100,
    summary_freq: int = 10,
    apply_diffuse_render_regularization: bool = True,
    use_mesh: bool = False,
    fast_debug_mode: bool = False,
    seed: int = 42,
    resume_from: Optional[Path] = None,
    gnomonic_poses_per_step: int = 0,
    mesh_devices: int = 0,
) -> VolumetricModel:
    """Coarse-to-fine training loop: per stage a fresh Adam at the stage's
    learning rate with the in-stage staircase decay, whole-pose gnomonic steps,
    tile-based bricked steps or ray-batch steps (every other procedure),
    periodic summaries / feedback renders / held-out tests / checkpoints;
    between stages 2x trilinear grid growth. Runs on ``vol_mod``'s device;
    ``seed`` drives the pose picker (numpy, as the JAX package) and a
    ``torch.Generator`` for the initial grid, the phase jitter, the bricked
    step's tiles and slab offset, and the ray batches and their renders'
    jitter and noise.

    ``use_mesh`` trains over the ranks of the default process group (one
    process a device; raises without one): the gnomonic procedure pose-
    parallel over ``min(world, mesh_devices or world)`` ranks, each
    accumulating ``ceil(floor / width)`` views so that a step still averages
    at least ``_GN_MIN_POSES_PER_STEP`` of them (every rank draws the same
    [width, k] views and phases and takes its row; ranks beyond the width add
    zeros); the bricked procedure over a (tiles x depth segments) mesh
    (``_bricked_mesh_shape``) when the world has more than one rank; the ray
    batches data-parallel over every rank. Rank 0 broadcasts the initial
    grid, every rank takes the same step, the replicas' bits are compared at
    every summary, and only rank 0 writes checkpoints, logs, feedback images
    and summaries."""
    from thr3ed_atom_tpu_torch.modules import bricked_trainer
    from thr3ed_atom_tpu_torch.modules.tester import (
        test_sh_vox_grid_vol_mod_with_posed_images,
    )
    from thr3ed_atom_tpu_torch.rendering.gnomonic_train import (
        draw_phase,
        gnomonic_train_step,
        gnomonic_train_step_multi,
        make_gnomonic_train_statics,
    )
    from thr3ed_atom_tpu_torch.visualizations.static import (
        visualize_camera_rays,
        visualize_sh_vox_grid_vol_mod_rendered_feedback,
    )

    bricked = vol_mod.render_procedure_name == _BRICKED
    ray_batch = vol_mod.render_procedure_name not in (_GNOMONIC, _BRICKED)
    world, rank = 1, 0
    if use_mesh:
        import torch.distributed as dist

        from thr3ed_atom_tpu_torch.parallel.mesh import replicas_agree, replicate
        from thr3ed_atom_tpu_torch.rendering.gnomonic_train import gnomonic_train_step_mesh

        if not dist.is_initialized():
            raise RuntimeError("use_mesh needs an initialized process group "
                               "(parallel.mesh.init_process_group, or torchrun)")
        world, rank = dist.get_world_size(), dist.get_rank()
    writer = rank == 0
    dev = vol_mod.device
    output_dir = Path(output_dir)
    model_dir = output_dir / "saved_models"
    logs_dir = output_dir / "training_logs"
    render_dir = logs_dir / "rendered_output"
    if writer:
        for directory in (model_dir, logs_dir, render_dir):
            directory.mkdir(exist_ok=True, parents=True)

    stagewise_voxel_grid_sizes = compute_thre3d_grid_sizes(
        final_required_resolution=vol_mod.thre3d_repr.grid_dims,
        num_stages=num_stages,
        scale_factor=scale_factor,
    )

    # per-stage downsampled datasets
    dataset_config = train_dataset.get_config_dict()
    base_downsample = dataset_config["downsample_factor"]
    stagewise_train_datasets = [train_dataset]
    for stage in range(1, num_stages):
        config = dict(dataset_config)
        config["downsample_factor"] = base_downsample * (scale_factor**stage)
        stagewise_train_datasets.insert(0, PosedImagesDataset(**config))

    generator = torch.Generator(device=dev).manual_seed(seed)
    start_stage = 1
    start_iteration = 1
    resume_opt_source: Optional[Path] = None
    if resume_from is not None:
        # the checkpointed grid and, where its _opt.npz exists, the Adam state
        # and the exact (stage, iteration); without it, the stage whose grid
        # size matches, from iteration 1 with a fresh optimizer
        resume_from = Path(resume_from)
        loaded, _ = create_volumetric_model_from_saved_model(resume_from, device=dev)
        vol_mod.thre3d_repr = loaded.thre3d_repr
        loaded_dims = loaded.thre3d_repr.grid_dims
        matches = [i for i, size in enumerate(stagewise_voxel_grid_sizes)
                   if tuple(size) == tuple(loaded_dims)]
        assert matches, (f"checkpoint grid {loaded_dims} matches no stage of the plan "
                         f"{stagewise_voxel_grid_sizes}")
        if _opt_state_path(resume_from).exists():
            with np.load(str(_opt_state_path(resume_from))) as saved:
                saved_stage = int(saved["stage"])
                saved_iter = int(saved["stage_iteration"])
            if saved_iter < num_iterations_per_stage:
                start_stage = saved_stage
                start_iteration = saved_iter + 1
                resume_opt_source = resume_from
            else:
                start_stage = saved_stage + 1
                if saved_stage < num_stages:
                    vol_mod.thre3d_repr = scale_voxel_grid_with_required_output_size(
                        vol_mod.thre3d_repr,
                        output_size=stagewise_voxel_grid_sizes[saved_stage],
                    )
        else:
            start_stage = matches[0] + 1
            log.warning(f"no optimizer state found at {_opt_state_path(resume_from)}; "
                        f"re-entering stage {start_stage} from iteration 1 with a "
                        "fresh optimizer")
        log.info(f"resuming from {resume_from} at stage {start_stage} "
                 f"iteration {start_iteration}")
    else:
        # downscale the grid to the smallest stage's size, re-init from uniform(-1, 1)
        small = scale_voxel_grid_with_required_output_size(
            vol_mod.thre3d_repr, output_size=stagewise_voxel_grid_sizes[0])
        with torch.no_grad():
            for t in (small.densities, small.features):
                t.copy_(torch.rand(t.shape, generator=generator, device=dev) * 2.0 - 1.0)
        vol_mod.thre3d_repr = small
    if use_mesh:
        # every rank starts from rank 0's grid (they draw it alike already)
        replicate(None, vol_mod.thre3d_repr)

    # feedback pose: the first test (or train) image's pose
    feedback_dataset = test_dataset if test_dataset is not None else train_dataset
    if render_feedback_pose is None:
        pose0 = feedback_dataset.poses[0]
        render_feedback_pose = CameraPose(rotation=pose0[:, :3], translation=pose0[:, 3:])
        if writer:
            write_png(render_dir / "1__real_log.png", to8b(feedback_dataset.images[0]))

    camera_bounds = train_dataset.camera_bounds
    camera_intrinsics = train_dataset.camera_intrinsics
    dataset_size = len(train_dataset) * camera_intrinsics.height * camera_intrinsics.width
    summaries = (SummaryLog(logs_dir / "summaries.jsonl", event_dir=logs_dir / "tensorboard")
                 if writer else None)
    if not fast_debug_mode and writer:
        visualize_camera_rays(train_dataset, output_dir, num_rays_per_image=1)

    log.info("beginning training")
    time_spent_actually_training = 0.0
    extra_info = {
        CAMERA_BOUNDS: list(camera_bounds),
        CAMERA_INTRINSICS: list(camera_intrinsics),
        HEMISPHERICAL_RADIUS: train_dataset.get_hemispherical_radius_estimate(),
    }
    render_config = vol_mod.render_config
    jitter = bool(render_config.perturb_sampled_points)

    for stage in range(start_stage, num_stages + 1):
        vol_mod.drop_prepared_cache()
        stage_dataset = stagewise_train_datasets[stage - 1]
        intr = stage_dataset.camera_intrinsics
        images = torch.as_tensor(stage_dataset.images).to(dev)
        poses_np = np.asarray(stage_dataset.poses)

        grid = vol_mod.thre3d_repr
        current_stage_lr = learning_rate * (stagewise_lr_decay_gamma ** (stage - 1))
        optimizer, scheduler = make_gnomonic_optimizer(
            grid, current_stage_lr, lr_decay_steps_per_stage, lr_decay_gamma_per_stage)
        if resume_opt_source is not None and stage == start_stage:
            if load_optimizer_state(resume_opt_source, optimizer, scheduler) is not None:
                log.info("restored optimizer state (Adam moments + schedule count)")
            else:
                log.info("optimizer checkpoint incompatible; starting a fresh Adam")

        # gnomonic: whole-pose steps over views of one (axis, flip, warp swap)
        # bucket; bricked: tiles of the views of one (axis, flip) bucket;
        # ray batches: pixels of every view, on the device with their poses
        if ray_batch:
            buckets, weights = {}, None
        else:
            buckets, weights = _pose_buckets(poses_np, intr.height, intr.width, intr.focal,
                                             with_swap=not bricked)
        variants = list(buckets)
        pose_picker = np.random.default_rng(seed + stage)
        tstats = {}
        pose_rays = intr.height * intr.width
        width = 1  # ranks of the gnomonic mesh
        if ray_batch:
            poses_per_step = 0
            poses_dev = torch.as_tensor(poses_np, dtype=torch.float32).to(dev)
            ray_statics = TrainStepStatics(
                render_config=render_config, image_height=intr.height, image_width=intr.width,
                focal=intr.focal, ray_batch_size=ray_batch_size,
                apply_diffuse_render_regularization=apply_diffuse_render_regularization,
                use_mesh=use_mesh, render_procedure=vol_mod.render_procedure_name)
        elif bricked:
            poses_per_step = 1
            poses_dev = torch.as_tensor(poses_np, dtype=torch.float32).to(dev)
        else:
            if gnomonic_poses_per_step > 0:
                poses_per_step = gnomonic_poses_per_step
            else:
                poses_per_step = max(_GN_MIN_POSES_PER_STEP, round(ray_batch_size / pose_rays))
            if use_mesh:
                # the floor composes with the mesh width: each rank takes
                # ceil(target / width) views, so a narrow mesh still averages
                # at least the floor's distinct views a step
                width = min(world, mesh_devices) if mesh_devices > 0 else world
                poses_per_step = -(-poses_per_step // width)
                if writer:
                    log.info(f"gnomonic mesh training over {width} ranks "
                             "(whole training views, pose-parallel)")
        rays_per_step = (ray_batch_size if bricked or ray_batch
                         else pose_rays * poses_per_step * width)
        if poses_per_step > 1 and writer:
            log.info(f"gnomonic whole-pose steps accumulate {poses_per_step} poses/step "
                     f"({pose_rays} rays/pose vs ray_batch_size {ray_batch_size})")
        if writer:
            log.info(f"training stage: {stage}   voxel grid resolution: {grid.grid_dims} "
                     f"training images resolution: [{intr.height} x {intr.width}]")
            log.info(f"current stage learning rate: {current_stage_lr}")

        rays_meter = ThroughputMeter(window=8)
        steps_since_sync = 0
        last_time = time.perf_counter()
        first = start_iteration if stage == start_stage else 1
        for stage_iteration in range(first, num_iterations_per_stage + 1):
            if not ray_batch:
                variant = variants[int(pose_picker.choice(len(variants), p=weights))]
                tstat = tstats.get(variant)
            if ray_batch:
                metrics = ray_batch_train_step(ray_statics, optimizer, grid, images, poses_dev,
                                               generator, scheduler=scheduler)
            elif bricked:
                if tstat is None:
                    # occupancy skipping stays off in training (the config's
                    # threshold is for renders)
                    tstat = tstats[variant] = bricked_trainer.make_bricked_train_statics(
                        grid, variant[0], variant[1],
                        image_height=intr.height, image_width=intr.width,
                        focal=intr.focal, ray_batch_size=ray_batch_size,
                        white_bkgd=render_config.white_bkgd,
                        apply_diffuse_render_regularization=(
                            apply_diffuse_render_regularization),
                        exit_eps=render_config.bricked_exit_eps,
                        tile_px=render_config.bricked_tile_px,
                        axis_supersample=render_config.bricked_axis_supersample,
                    )
                tile_pose_idx = torch.as_tensor(np.asarray(
                    pose_picker.choice(buckets[variant], size=tstat.num_tiles))).to(dev)
                if use_mesh and world > 1:
                    metrics = bricked_trainer.bricked_train_step_mesh(
                        tstat, optimizer, _bricked_mesh_shape(tstat, world, 1), grid,
                        images, poses_dev, tile_pose_idx, generator, scheduler=scheduler)
                else:
                    metrics = bricked_trainer.bricked_train_step(
                        tstat, optimizer, grid, images, poses_dev, tile_pose_idx, generator,
                        scheduler=scheduler)
            else:
                if tstat is None:
                    tstat = tstats[variant] = make_gnomonic_train_statics(
                        grid, variant[0], variant[1],
                        image_height=intr.height, image_width=intr.width,
                        white_bkgd=render_config.white_bkgd,
                        apply_diffuse_render_regularization=(
                            apply_diffuse_render_regularization),
                        pos_per_cell=render_config.gnomonic_pos_per_cell,
                        supersample=render_config.gnomonic_supersample,
                        warp_order=render_config.gnomonic_warp_order,
                        qb=render_config.gnomonic_qb,
                        warp_impl=render_config.gnomonic_warp_impl,
                        warp_swap=variant[2],
                    )
                bucket = buckets[variant]
                gen = generator if jitter else None
                if use_mesh:
                    # the same [width, k] views and phases on every rank; each
                    # takes its row (ranks beyond the width none)
                    idx = np.asarray(pose_picker.choice(bucket, size=(width, poses_per_step)))
                    phases = ([draw_phase(gen) for _ in range(width * poses_per_step)]
                              if jitter else [None] * (width * poses_per_step))
                    mine = idx[min(rank, width - 1)]
                    metrics = gnomonic_train_step_mesh(
                        tstat, optimizer, width, grid,
                        images[torch.as_tensor(mine, device=dev)], poses_np[mine, :, :3],
                        poses_np[mine, :, 3], intr.focal,
                        phases=phases[rank * poses_per_step:(rank + 1) * poses_per_step],
                        scheduler=scheduler)
                elif poses_per_step > 1:
                    idx = np.asarray(pose_picker.choice(bucket, size=poses_per_step))
                    metrics = gnomonic_train_step_multi(
                        tstat, optimizer, grid, images[torch.as_tensor(idx, device=dev)],
                        poses_np[idx, :, :3], poses_np[idx, :, 3], intr.focal, gen,
                        scheduler=scheduler)
                else:
                    p_i = int(pose_picker.choice(bucket))
                    metrics = gnomonic_train_step(
                        tstat, optimizer, grid, images[p_i], poses_np[p_i, :, :3],
                        poses_np[p_i, :, 3], intr.focal, gen, scheduler=scheduler)
            steps_since_sync += 1

            global_step = (stage - 1) * num_iterations_per_stage + stage_iteration
            is_edge = stage_iteration == 1 or stage_iteration == num_iterations_per_stage

            if use_mesh and (global_step % summary_freq == 0 or is_edge):
                if not replicas_agree([grid.densities, grid.features]):
                    raise RuntimeError(f"the ranks' grids differ after step {global_step}")
            if (global_step % summary_freq == 0 or is_edge) and writer:
                metrics_host = {k: float(v) for k, v in metrics.items()}  # syncs
                rays_meter.tick(rays_per_step * steps_since_sync)
                steps_since_sync = 0
                metrics_host["num_epochs"] = rays_per_step * global_step / dataset_size
                metrics_host["train_rays_per_sec"] = rays_meter.per_sec
                for name, value in metrics_host.items():
                    summaries.add_scalar(name, value, global_step=global_step)
                log.info(f"Stage: {stage} Global Iteration: {global_step} "
                         f"Stage Iteration: {stage_iteration} "
                         + " ".join(f"{k}: {v:.3f}" for k, v in metrics_host.items()))

            time_spent_actually_training += time.perf_counter() - last_time

            if (global_step % feedback_freq == 0 or is_edge) and not fast_debug_mode and writer:
                log.info("TIME CHECK: time spent actually training till now: "
                         f"{timedelta(seconds=time_spent_actually_training)}")
                visualize_sh_vox_grid_vol_mod_rendered_feedback(
                    vol_mod=vol_mod,
                    render_feedback_pose=render_feedback_pose,
                    camera_intrinsics=camera_intrinsics,
                    global_step=global_step,
                    feedback_logs_dir=render_dir,
                    training_time=time_spent_actually_training,
                    log_diffuse_rendered_version=apply_diffuse_render_regularization,
                    overridden_num_samples_per_ray=render_config.render_num_samples_per_ray,
                )
                vol_mod.drop_prepared_cache()

            if (test_dataset is not None and not fast_debug_mode and writer
                    and (global_step % test_freq == 0
                         or stage_iteration == num_iterations_per_stage)):
                test_sh_vox_grid_vol_mod_with_posed_images(
                    vol_mod=vol_mod, test_dataset=test_dataset,
                    tensorboard_writer=summaries, global_step=global_step)
                vol_mod.drop_prepared_cache()

            if (global_step % save_freq == 0 or is_edge) and writer:
                ckpt_path = model_dir / f"model_stage_{stage}_iter_{global_step}"
                vol_mod.save(ckpt_path, extra_info=extra_info)
                save_optimizer_state(ckpt_path, optimizer, stage, stage_iteration)

            last_time = time.perf_counter()

        del optimizer, scheduler, images
        if stage != num_stages:
            vol_mod.thre3d_repr = scale_voxel_grid_with_required_output_size(
                vol_mod.thre3d_repr, output_size=stagewise_voxel_grid_sizes[stage])

    if writer:
        vol_mod.save(model_dir / "model_final", extra_info=extra_info)
        log.info("Training complete")
        log.info("Total actual training time: "
                 f"{timedelta(seconds=time_spent_actually_training)}")
    return vol_mod
