"""The quality-gate battery on the CUDA card, one JSON artifact a run
(counterpart of the repository's tools/run_quality_gates.py: the same scene,
pose, gates, thresholds and JSON keys).

    python -m thr3ed_atom_tpu_torch.tools.run_quality_gates -o QUALITY_GATES.json

Every accelerated procedure is held against the exact renderer at 1024
samples a ray on the 128^3 converged blob scene (seed 3) at 400 x 400, pose
(45, -40): gnomonic at P = 1, 2, 4, bricked at K = 1, 2, 4, the bricked
occupancy skip and early exit against neither (lossless: > 60 dB), fast
top-32 / top-64 against the exact renderer at 512 samples, and gnomonic P = 2
on a sharp (voxel-noise) copy of the scene against that copy's own exact
render. ``main`` refuses to run without a card; the functions take
``device=`` (None: the card).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid
from thr3ed_atom_tpu_torch.modules.volumetric_model import VolumetricModel
from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
from thr3ed_atom_tpu_torch.tools.make_synthetic_dataset import make_blob_scene
from thr3ed_atom_tpu_torch.utils.camera import (
    CameraBounds,
    CameraIntrinsics,
    CameraPose,
    pose_spherical,
)

GRID_SIZE = 128
IMAGE_SIZE = 400
POSE = (45.0, -40.0)
EXACT = "render_sh_voxel_grid"
GNOMONIC = "render_sh_voxel_grid_gnomonic"
BRICKED = "render_sh_voxel_grid_bricked"
FAST = "render_sh_voxel_grid_fast"
# gate -> threshold (dB); each passes above its threshold
GATES = {
    "gnomonic_P1_vs_exact1024": 60.0,
    "gnomonic_P2_vs_exact1024": 73.0,
    "gnomonic_P4_vs_exact1024": 75.0,
    "bricked_K1_vs_exact1024": 60.0,
    "bricked_K2_vs_exact1024": 70.0,
    "bricked_K4_vs_exact1024": 75.0,
    "bricked_occupancy_neutrality": 60.0,
    "fast_top32_vs_exact512": 25.0,
    "fast_top64_vs_exact512": 31.0,
    "gnomonic_P2_sharp_scene": 30.0,
}
NOTES = {
    "gnomonic_P2_vs_exact1024": "the quality default carrying the headline bench; the "
    "gap to the gather warp is warp reconstruction, a speed/quality trade",
    "bricked_occupancy_neutrality": "on-vs-off, lossless rule (~120 dB)",
    "fast_top32_vs_exact512": "soft volumetric worst case; trained scenes are 1e-7-exact",
    "gnomonic_P2_sharp_scene": "voxel-scale white-noise worst case: march tent "
    "reconstruction, not warp",
}


def psnr(a, b) -> float:
    """PSNR (dB) of two f32 colour images in [0, 1], the mean square error
    taken in f32, unrounded (its floor of 1e-12 caps it at 120 dB)."""
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def render(grid: VoxelGrid, procedure: str, spp: int, poses: Sequence[CameraPose],
           intrinsics: CameraIntrinsics, device=None, **cfg) -> list:
    """Colour [H, W, 3] numpy renders of ``poses`` through ``procedure`` at
    ``spp`` samples a ray, bounds (2, 6), no jitter, white background."""
    config = SHVoxGridRenderConfig(num_samples_per_ray=spp,
                                   camera_bounds=CameraBounds(2.0, 6.0),
                                   perturb_sampled_points=False, white_bkgd=True, **cfg)
    model = VolumetricModel(grid, render_procedure=procedure, render_config=config,
                            device=device)
    with torch.no_grad():
        return [model.render(pose, intrinsics).colour.cpu().numpy() for pose in poses]


def sharp_scene(grid: VoxelGrid) -> VoxelGrid:
    """A copy of ``grid`` with voxel-scale white noise (numpy seed 11: N(0,
    1.2) on the densities, then N(0, 0.3) on the features, each cast to f32
    and added): the texture a trained relu field has."""
    rng = np.random.default_rng(11)
    noise_d = rng.normal(0, 1.2, tuple(grid.densities.shape)).astype(np.float32)
    noise_f = rng.normal(0, 0.3, tuple(grid.features.shape)).astype(np.float32)
    dev = grid.device
    return VoxelGrid(grid.densities.detach() + torch.from_numpy(noise_d).to(dev),
                     grid.features.detach() + torch.from_numpy(noise_f).to(dev),
                     voxel_size=grid.voxel_size, **grid.get_config_dict())


def min_psnr(images, references) -> float:
    return min(psnr(a, b) for a, b in zip(images, references))


def occupancy_neutrality_db(grid: VoxelGrid, poses, intrinsics, device=None,
                            on: Optional[list] = None) -> float:
    """The bricked render at K = 2 (``on``, rendered here when None) against
    the bricked render with occupancy skipping and early exit off (the
    config's K), the minimum over ``poses``."""
    if on is None:
        on = render(grid, BRICKED, 1024, poses, intrinsics, device,
                    bricked_axis_supersample=2)
    off = render(grid, BRICKED, 1024, poses, intrinsics, device,
                 bricked_occupancy_alpha_thresh=0.0, bricked_exit_eps=0.0)
    return min_psnr(on, off)


def sharp_scene_db(grid: VoxelGrid, poses, intrinsics, device=None) -> float:
    """Gnomonic P = 2 (qb = 128, the config's default) on ``sharp_scene(grid)``
    against that scene's own exact render at 1024 samples, the minimum over
    ``poses``."""
    sharp = sharp_scene(grid)
    exact = render(sharp, EXACT, 1024, poses, intrinsics, device,
                   parallel_rays_chunk_size=4096)
    gn = render(sharp, GNOMONIC, 1024, poses, intrinsics, device, gnomonic_pos_per_cell=2)
    return min_psnr(gn, exact)


def run_gates(grid_size: int = GRID_SIZE, image_size: int = IMAGE_SIZE, device=None,
              echo: Callable[[str], None] = print) -> dict:
    """Every gate of the battery on ``device`` (None: the card); returns the
    JSON artifact's dict."""
    t0 = time.perf_counter()
    dev = torch.device("cuda") if device is None else torch.device(device)
    scene = make_blob_scene(grid_size=grid_size, seed=3, converged=True, device=dev)
    intr = CameraIntrinsics(image_size, image_size, image_size * 1.1)
    pose = [pose_spherical(POSE[0], POSE[1], 4.0)]

    def one(grid, procedure, spp, **cfg):
        out = render(grid, procedure, spp, pose, intr, dev, **cfg)
        echo(f"# [{time.perf_counter() - t0:6.1f}s] {procedure} spp={spp} {cfg}")
        return out

    results = {
        "round_note": "the exact oracle is f32-exact on the card",
        "backend": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "scene": f"blob scene {grid_size}^3 seed=3 converged, "
        f"{image_size}x{image_size}, pose {POSE}",
        "gates": {},
    }
    gates = results["gates"]

    def gate(name, value):
        value = round(value, 2)
        threshold = GATES[name]
        gates[name] = {"dB": value, "gate": threshold, "pass": bool(value > threshold)}
        if name in NOTES:
            gates[name]["note"] = NOTES[name]
        echo(f"# GATE {name}: {value} dB (gate >{threshold}) "
             f"{'PASS' if value > threshold else 'FAIL'}")

    exact1024 = one(scene, EXACT, 1024, parallel_rays_chunk_size=4096)
    gn = {p: one(scene, GNOMONIC, 1024, gnomonic_pos_per_cell=p) for p in (1, 2, 4)}
    for p in (1, 2, 4):
        gate(f"gnomonic_P{p}_vs_exact1024", min_psnr(gn[p], exact1024))
    gates["gnomonic_monotone_P"] = {
        "pass": bool(gates["gnomonic_P2_vs_exact1024"]["dB"]
                     > gates["gnomonic_P1_vs_exact1024"]["dB"]
                     < gates["gnomonic_P4_vs_exact1024"]["dB"])
    }

    br = {k: one(scene, BRICKED, 1024, bricked_axis_supersample=k) for k in (1, 2, 4)}
    for k in (1, 2, 4):
        gate(f"bricked_K{k}_vs_exact1024", min_psnr(br[k], exact1024))
    gate("bricked_occupancy_neutrality",
         occupancy_neutrality_db(scene, pose, intr, dev, on=br[2]))

    exact512 = one(scene, EXACT, 512, parallel_rays_chunk_size=8192)
    fast32 = one(scene, FAST, 512, fast_topk=32)
    fast64 = one(scene, FAST, 512, fast_topk=64)
    gate("fast_top32_vs_exact512", min_psnr(fast32, exact512))
    gate("fast_top64_vs_exact512", min_psnr(fast64, exact512))

    gate("gnomonic_P2_sharp_scene", sharp_scene_db(scene, pose, intr, dev))

    results["wall_s"] = round(time.perf_counter() - t0, 1)
    results["all_pass"] = all(g.get("pass", True) for g in gates.values())
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m thr3ed_atom_tpu_torch.tools.run_quality_gates")
    ap.add_argument("-o", "--output", default="QUALITY_GATES.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("refusing to run the quality gates without a CUDA card: the gates hold "
              "the card's kernels", file=sys.stderr)
        return 2
    results = run_gates(echo=lambda line: print(line, flush=True))
    Path(args.output).write_text(json.dumps(results, indent=1) + "\n")
    print(json.dumps({"all_pass": results["all_pass"], "wall_s": results["wall_s"],
                      "output": args.output}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
