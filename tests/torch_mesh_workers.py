"""Rank functions of tests/test_torch_mesh.py's gloo worlds on the CPU.

A spawned rank imports this module, not the test's, so it imports torch and
the port only (no JAX). ``run_world`` spawns ``world`` ranks that rendezvous
through ``<tmp>/pg``, load the case the test wrote (``torch.save``), run the
named function on it and write what they saw to ``<tmp>/rank<r>.pt``.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def run_world(fn_name: str, world: int, case, tmp_path) -> list:
    """Spawn the world, run ``fn_name`` on ``case`` in every rank; returns
    the ranks' results in rank order."""
    import torch.multiprocessing as mp

    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(case, tmp / "case.pt")
    mp.spawn(_rank_main, args=(world, fn_name, str(tmp)), nprocs=world, join=True)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rank_main(rank: int, world: int, fn_name: str, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'pg')}",
                            rank=rank, world_size=world)
    try:
        case = torch.load(os.path.join(tmp, "case.pt"), weights_only=False)
        result = globals()[fn_name](rank, world, case)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _grid(spec):
    from thr3ed_atom_tpu_torch.models.voxels import voxel_grid_from_numpy

    d, f, config = spec  # copies: a CPU grid may share the arrays' memory
    return voxel_grid_from_numpy(d.copy(), f.copy(), config, device="cpu")


def _adam(grid, lr):
    from thr3ed_atom_tpu_torch.modules.trainer import make_gnomonic_optimizer

    return make_gnomonic_optimizer(grid, lr, 1000, 0.1)[0]


def _state(opt, grid):
    """What the test compares: Adam's first moments (0.1 g after one step),
    the gradients and the grid after the step, as numpy."""
    return {fld: dict(mu=opt.state[p]["exp_avg"].numpy().copy(), grad=p.grad.numpy().copy(),
                      value=p.detach().numpy().copy())
            for fld, p in (("densities", grid.densities), ("features", grid.features))}


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def gnomonic_case(rank, world, case):
    """The pose-parallel step at n_dev = world, k views a rank, this rank's
    phases fed."""
    from thr3ed_atom_tpu_torch.parallel.mesh import replicas_agree
    from thr3ed_atom_tpu_torch.rendering import gnomonic_train as gt

    grid = _grid(case["grid"])
    tstat = gt.make_gnomonic_train_statics(grid, *case["variant"], **case["statics"])
    opt = _adam(grid, case["lr"])
    m = gt.gnomonic_train_step_mesh(
        tstat, opt, world, grid, torch.from_numpy(case["images"][rank]),
        case["rotations"][rank], case["origins"][rank], case["focal"],
        phases=case["phases"][rank])
    return dict(metrics=_floats(m), state=_state(opt, grid),
                agree=replicas_agree([grid.densities, grid.features]))


def bricked_case(rank, world, case):
    """The bricked mesh step at each of ``case["shapes"]``, from the same grid
    and draws."""
    from thr3ed_atom_tpu_torch.modules import bricked_trainer as bt
    from thr3ed_atom_tpu_torch.parallel.mesh import replicas_agree

    out = {}
    for shape in case["shapes"]:
        grid = _grid(case["grid"])
        statics = bt.make_bricked_train_statics(grid, *case["variant"], **case["statics"])
        opt = _adam(grid, case["lr"])
        m = bt.bricked_train_step_mesh(
            statics, opt, shape, grid, torch.from_numpy(case["images"]), case["poses"],
            torch.from_numpy(case["pose_idx"]), draws=case["draws"])
        out[shape] = dict(metrics=_floats(m), state=_state(opt, grid),
                          agree=replicas_agree([grid.densities, grid.features]))
    return out


def ray_batch_case(rank, world, case):
    """The ray-batch mesh step at ``case["model_parallel"]``, fed the global
    draws; the grid (and its gradient) gathered back whole."""
    from thr3ed_atom_tpu_torch.modules import trainer
    from thr3ed_atom_tpu_torch.parallel import mesh as pm

    full = _grid(case["grid"])
    mp = case["model_parallel"]
    statics = trainer.TrainStepStatics(**case["statics"], use_mesh=True, model_parallel=mp)
    mesh = pm.make_grid_mesh(mp) if mp > 1 else pm.make_data_mesh()
    grid = pm.shard_grid_spatial(mesh, full) if mp > 1 else full
    opt, sched = trainer.make_gnomonic_optimizer(grid, *case["optimizer"])
    m = trainer.ray_batch_train_step(statics, opt, grid, torch.from_numpy(case["images"]),
                                     torch.from_numpy(case["poses"]),
                                     draws=case["draws"], scheduler=sched)
    state = {}
    for fld in ("densities", "features"):
        p = getattr(grid, fld)
        value, grad = p.detach(), p.grad
        if mp > 1:
            value = pm.gather_grid_spatial(mesh, value, full.grid_dims[0])
            grad = pm.gather_grid_spatial(mesh, grad, full.grid_dims[0])
        state[fld] = dict(value=value.numpy().copy(), grad=grad.numpy().copy())
    agree = pm.replicas_agree([grid.densities, grid.features], group=mesh.group(pm.DATA_AXIS))
    return dict(metrics=_floats(m), state=state, agree=agree,
                slab=tuple(grid.grid_dims))


def world2(rank, world, case):
    return {name: globals()[f"{name}_case"](rank, world, sub) for name, sub in case.items()}


def world4(rank, world, case):
    """The (2, 2) ray-batch case and a trainer run over a mesh narrower than
    the world."""
    return {"ray_batch": ray_batch_case(rank, world, case["ray_batch"]),
            "trainer": trainer_case(rank, world, case["trainer"])}


def trainer_case(rank, world, case):
    """train_sh_vox_grid_vol_mod_with_posed_images(use_mesh=True,
    mesh_devices=...) on the gnomonic procedure: the mesh step's calls as
    this rank saw them, the final grid and the files this rank wrote."""
    from thr3ed_atom_tpu_torch.data.dataset import PosedImagesDataset
    from thr3ed_atom_tpu_torch.modules import trainer
    from thr3ed_atom_tpu_torch.modules.volumetric_model import VolumetricModel
    from thr3ed_atom_tpu_torch.parallel.mesh import replicas_agree
    from thr3ed_atom_tpu_torch.rendering import gnomonic_train as gt
    from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
    from thr3ed_atom_tpu_torch.utils.camera import CameraBounds

    calls = []
    real = gt.gnomonic_train_step_mesh

    def counting(tstat, optimizer, n_dev, grid, images, *a, **kw):
        calls.append((n_dev, tuple(images.shape[:1]), len(kw["phases"])))
        return real(tstat, optimizer, n_dev, grid, images, *a, **kw)

    gt.gnomonic_train_step_mesh = counting
    try:
        data = Path(case["data"])
        model = VolumetricModel(
            _grid(case["grid"]), "render_sh_voxel_grid_gnomonic",
            SHVoxGridRenderConfig(num_samples_per_ray=16, camera_bounds=CameraBounds(1.5, 4.5),
                                  gnomonic_pos_per_cell=1), device="cpu")
        out = Path(case["out"]) / f"rank{rank}"  # what this rank writes, apart
        trainer.train_sh_vox_grid_vol_mod_with_posed_images(
            model, PosedImagesDataset(data / "train", data / "train_camera_params.json"),
            out, ray_batch_size=64, num_stages=1, num_iterations_per_stage=2,
            save_freq=1000, test_freq=1000, feedback_freq=1000, summary_freq=1,
            use_mesh=True, mesh_devices=case["mesh_devices"], fast_debug_mode=True)
    finally:
        gt.gnomonic_train_step_mesh = real
    grid = model.thre3d_repr
    return dict(calls=calls, agree=replicas_agree([grid.densities, grid.features]),
                densities=grid.densities.detach().numpy().copy(),
                wrote=sorted(str(p.relative_to(out)) for p in out.rglob("*")) if out.exists()
                else [], rank=rank, world=world, mean=float(np.mean(
                    grid.densities.detach().numpy())))
