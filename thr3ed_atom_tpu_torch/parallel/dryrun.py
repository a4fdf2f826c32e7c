"""A dry run of the three mesh training steps over spawned ranks.

Counterpart of ``dryrun_multichip`` in the JAX package's ``__graft_entry__.py``:
one step of each multi-device path on tiny shapes,

  * the ray-batch step over ("data", "model") with model_parallel 2 (an
    even world) and the fast renderer;
  * the bricked step over (tiles, depth segments) = (n / 2, 2);
  * the gnomonic step, one whole view a rank.

    python -c "from thr3ed_atom_tpu_torch.parallel.dryrun import dryrun_multichip; \\
        dryrun_multichip(4, device='cpu')"

``device=None`` puts rank r on ``cuda:r`` under NCCL (n cards); ``device="cpu"``
runs gloo on the CPU. Rank 0 prints one "OK" line a problem, with the loss
and the mesh's shape.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


def _problem(dev, grid_size=16, num_images=4, image_size=32, num_features=27):
    """A seeded relu grid, render config, images and poses (the JAX dry
    run's shapes)."""
    from thr3ed_atom_tpu_torch.models.voxels import VoxelSize, create_voxel_grid
    from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
    from thr3ed_atom_tpu_torch.utils.camera import CameraBounds, pose_spherical

    grid = create_voxel_grid(
        torch.Generator(device=dev).manual_seed(0), grid_dims=(grid_size,) * 3,
        num_features=num_features, voxel_size=VoxelSize(*(3.0 / grid_size,) * 3),
        density_preactivation="identity", density_postactivation="relu",
        expected_density_scale=10.0)
    config = SHVoxGridRenderConfig(num_samples_per_ray=32,
                                   camera_bounds=CameraBounds(2.0, 6.0), white_bkgd=True)
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.uniform(0, 1, (num_images, image_size, image_size, 3))
                             .astype(np.float32)).to(dev)
    poses = torch.as_tensor(np.stack([
        np.hstack(pose_spherical(yaw, -30.0, 4.0))
        for yaw in np.linspace(0, 270, num_images)]).astype(np.float32)).to(dev)
    return grid, config, images, poses, image_size


def run_dryrun_problems(dev: torch.device) -> Dict[str, object]:
    """One step of each mesh path on every rank of the default group (a
    collective call); returns {problem: (loss, mesh shape, replicas agree)}
    as this rank sees it."""
    from thr3ed_atom_tpu_torch.modules import bricked_trainer as bt
    from thr3ed_atom_tpu_torch.modules.trainer import (
        TrainStepStatics,
        ray_batch_train_step,
    )
    from thr3ed_atom_tpu_torch.parallel import mesh as pm
    from thr3ed_atom_tpu_torch.rendering import gnomonic_train as gt
    from thr3ed_atom_tpu_torch.rendering.gnomonic import dominant_axis_for_pose
    from thr3ed_atom_tpu_torch.utils.camera import pose_spherical

    n, rank = dist.get_world_size(), dist.get_rank()
    out: Dict[str, object] = {}

    def adam(params):
        return torch.optim.Adam(params, lr=0.01, betas=(0.9, 0.999), eps=1e-8)

    # the ray batch: "data" x "model" (the grid's x slabs)
    grid, config, images, poses, size = _problem(dev)
    mp = 2 if n % 2 == 0 and n > 1 else 1
    statics = TrainStepStatics(render_config=config, image_height=size, image_width=size,
                               focal=size * 1.1, ray_batch_size=64 * n, use_mesh=True,
                               model_parallel=mp)
    mesh = pm.make_grid_mesh(mp) if mp > 1 else pm.make_data_mesh()
    mine = pm.shard_grid_spatial(mesh, grid) if mp > 1 else grid
    metrics = ray_batch_train_step(
        statics, adam([mine.densities, mine.features]), mine, images, poses,
        torch.Generator(device=dev).manual_seed(0))
    agree = pm.replicas_agree([mine.densities, mine.features],
                              group=mesh.group(pm.DATA_AXIS))
    out["ray_batch"] = (float(metrics["total_loss"]), (n // mp, mp), agree)

    # the bricked step: tiles x depth segments
    b_grid, _, b_images, b_poses, b_size = _problem(dev, grid_size=17, image_size=32)
    axis, flip = dominant_axis_for_pose(b_poses[0, :, :3].cpu().numpy())
    b_mp = 2 if n % 2 == 0 and n > 1 else 1
    b_data = n // b_mp
    b_statics = bt.make_bricked_train_statics(
        b_grid, axis, flip, image_height=b_size, image_width=b_size, focal=b_size * 1.1,
        ray_batch_size=max(8, b_data) * 256, white_bkgd=True, exit_eps=0.0)
    metrics = bt.bricked_train_step_mesh(
        b_statics, adam([b_grid.densities, b_grid.features]), (b_data, b_mp), b_grid,
        b_images, b_poses, torch.zeros(b_statics.num_tiles, dtype=torch.long, device=dev),
        torch.Generator(device=dev).manual_seed(1))
    out["bricked"] = (float(metrics["total_loss"]), (b_data, b_mp),
                      pm.replicas_agree([b_grid.densities, b_grid.features]))

    # the gnomonic step: one whole view a rank
    g_grid, _, _, _, _ = _problem(dev, grid_size=10)
    g_size = 24
    g_poses = [pose_spherical(30.0 + 10.0 * i, -40.0, 4.0) for i in range(n)]
    g_axis, g_flip = dominant_axis_for_pose(np.asarray(g_poses[0].rotation).reshape(3, 3))
    g_images = np.random.default_rng(2).random((n, g_size, g_size, 3), dtype=np.float32)
    tstat = gt.make_gnomonic_train_statics(g_grid, g_axis, g_flip, image_height=g_size,
                                           image_width=g_size, white_bkgd=True,
                                           pos_per_cell=1)
    pose = g_poses[rank]
    metrics = gt.gnomonic_train_step_mesh(
        tstat, adam([g_grid.densities, g_grid.features]), n, g_grid,
        torch.as_tensor(g_images[rank:rank + 1]).to(dev),
        np.asarray(pose.rotation, np.float32).reshape(1, 3, 3),
        np.asarray(pose.translation, np.float32).reshape(1, 3), g_size * 1.1)
    out["gnomonic"] = (float(metrics["total_loss"]), (n,),
                       pm.replicas_agree([g_grid.densities, g_grid.features]))
    return out


def report(n: int, out: Dict[str, object]) -> str:
    """The three "OK" lines of the dry run (the JAX package's wording)."""
    loss, (dp, mp), _ = out["ray_batch"]
    lines = [f"dryrun_multichip({n}) OK: loss={loss:.4f} devices={n} "
             f"mesh=({dp} data x {mp} model)"]
    loss, (dp, mp), _ = out["bricked"]
    lines.append(f"dryrun_multichip({n}) bricked OK: loss={loss:.4f} "
                 f"mesh=({dp} tiles x {mp} depth-segments)")
    loss, _, _ = out["gnomonic"]
    lines.append(f"dryrun_multichip({n}) gnomonic OK: loss={loss:.4f} "
                 f"mesh=({n} poses data-parallel)")
    return "\n".join(lines)


def _rank_main(rank: int, n: int, device: Optional[str], store_path: str) -> None:
    if device is None:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{store_path}", rank=rank,
                            world_size=n)
    try:
        out = run_dryrun_problems(dev)
        if not all(v[2] for v in out.values()):
            raise RuntimeError(f"rank {rank}: the replicas differ after a step: {out}")
        if rank == 0:
            print(report(n, out), flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> None:
    """Spawn ``n_devices`` ranks and run one step of each mesh path (see the
    module's docstring); raises when a rank fails or the replicas differ.
    The ranks rendezvous through a file in a fresh temporary directory."""
    import torch.multiprocessing as mp

    if device is None and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA devices, have "
                           f"{torch.cuda.device_count()} (device='cpu' runs gloo)")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(n_devices, device, os.path.join(tmp, "pg")),
                 nprocs=n_devices, join=True)
