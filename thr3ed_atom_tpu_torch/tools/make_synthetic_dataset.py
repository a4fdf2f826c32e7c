"""Generate a synthetic posed-images dataset by rendering a procedural voxel
scene (counterpart of the repository's tools/make_synthetic_dataset.py, with
argparse for click and data/png.py for imageio).

    python -m thr3ed_atom_tpu_torch.tools.make_synthetic_dataset -o <output> ...

The scene is a cluster of coloured density blobs (``make_blob_scene``: the
same numpy draws in the same order as the JAX tool, so the arrays are
bit-equal). ``main`` renders ``--num_train`` and ``--num_test`` views of it
from poses drawn from ``np.random.default_rng(seed)`` and writes the trainers'
layout: ``<split>/r_<i>.png``, ``<split>_camera_params.json`` and the scene's
arrays as ``ground_truth_grid.npz``. It renders on the CUDA card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from thr3ed_atom_tpu_torch.data.png import write_png
from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid, voxel_grid_from_numpy
from thr3ed_atom_tpu_torch.modules.volumetric_model import VolumetricModel
from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
from thr3ed_atom_tpu_torch.utils.camera import (
    CameraBounds,
    CameraIntrinsics,
    pose_spherical,
    to8b,
)
from thr3ed_atom_tpu_torch.utils.constants import (
    BOUNDS,
    EXTRINSIC,
    FOCAL,
    HEIGHT,
    INTRINSIC,
    ROTATION,
    TRANSLATION,
    WIDTH,
)
from thr3ed_atom_tpu_torch.utils.logging import log

NEAR, FAR = 2.0, 6.0
PROCEDURES = ("render_sh_voxel_grid", "render_sh_voxel_grid_fast")


def blob_scene_arrays(grid_size: int = 64, seed: int = 3, num_blobs: int = 6,
                      converged: bool = False) -> Tuple[np.ndarray, np.ndarray, dict]:
    """The blob scene's densities [G, G, G, 1], features [G, G, G, 27] (f32)
    and its grid config (``get_save_config_dict`` keys): soft density blobs
    with random colours and mild view dependence.

    ``converged=True`` makes the raw densities look like a trained relu
    field's: empty space at -1 under identity pre- and relu post-activation
    instead of Gaussian tails that are > 0 everywhere."""
    rng = np.random.default_rng(seed)
    coords = (
        np.stack(np.meshgrid(*[np.arange(grid_size)] * 3, indexing="ij"), -1)
        - (grid_size - 1) / 2
    ) / grid_size  # [-0.5, 0.5]^3

    densities = np.zeros((grid_size,) * 3, dtype=np.float32)
    features = np.zeros((grid_size,) * 3 + (27,), dtype=np.float32)
    for _ in range(num_blobs):
        center = rng.uniform(-0.28, 0.28, size=3)
        radius = rng.uniform(0.08, 0.16)
        colour = rng.uniform(-3.0, 3.0, size=3)
        dist = np.linalg.norm(coords - center, axis=-1)
        blob = np.exp(-((dist / radius) ** 2) * 4.0).astype(np.float32)
        densities += 8.0 * blob
        for channel in range(3):
            features[..., channel * 9] += colour[channel] * blob
            # small degree-1 coefficients for view dependence
            features[..., channel * 9 + 1: channel * 9 + 4] += (
                rng.uniform(-0.5, 0.5, size=3).astype(np.float32) * blob[..., None]
            )

    config = dict(voxel_size=(3.0 / grid_size,) * 3, grid_location=(0.0, 0.0, 0.0),
                  density_preactivation="abs", density_postactivation="identity",
                  feature_preactivation="identity", feature_postactivation="identity",
                  expected_density_scale=1.0, radiance_transfer_function=None)
    if converged:
        densities = np.where(densities > 0.05, densities, -1.0).astype(np.float32)
        config.update(density_preactivation="identity", density_postactivation="relu")
    return densities[..., None], features, config


def make_blob_scene(grid_size: int = 64, seed: int = 3, num_blobs: int = 6,
                    converged: bool = False, device=None) -> VoxelGrid:
    """``blob_scene_arrays`` as a VoxelGrid on ``device`` (None: the CUDA card)."""
    densities, features, config = blob_scene_arrays(grid_size, seed, num_blobs, converged)
    return voxel_grid_from_numpy(densities, features, config, device=device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m thr3ed_atom_tpu_torch.tools.make_synthetic_dataset",
        description="Render a synthetic posed-images dataset of a procedural blob scene.")
    add = p.add_argument
    add("-o", "--output_path", required=True)
    add("--num_train", type=int, default=20)
    add("--num_test", type=int, default=4)
    add("--image_size", type=int, default=128)
    add("--grid_size", type=int, default=64)
    add("--seed", type=int, default=3)
    add("--gt_samples_per_ray", type=int, default=256,
        help="samples/ray for rendering the GT images; high values (1024+) approach "
             "the continuum so no trainer's quadrature is favoured")
    add("--render_procedure", choices=PROCEDURES, default="render_sh_voxel_grid_fast")
    return p


def main(argv: Optional[Sequence[str]] = None, device=None) -> int:
    """Parse ``argv`` (sys.argv[1:] when None) and write the dataset, rendered
    on ``device`` (None: the CUDA card; without one it refuses and returns 2)."""
    args = build_parser().parse_args(argv)
    if device is None and not torch.cuda.is_available():
        print("refusing to render the dataset without a CUDA card (pass device='cpu' "
              "from Python for a CPU run)", file=sys.stderr)
        return 2
    output_path = Path(args.output_path)
    grid = make_blob_scene(grid_size=args.grid_size, seed=args.seed, device=device)

    image_size = args.image_size
    focal = image_size * 1.1
    intrinsics = CameraIntrinsics(image_size, image_size, focal)
    config = SHVoxGridRenderConfig(
        num_samples_per_ray=args.gt_samples_per_ray,
        camera_bounds=CameraBounds(NEAR, FAR),
        perturb_sampled_points=False,
        white_bkgd=True,
        # the JAX tool's chunk: 1024-sample renders in larger chunks outgrow
        # one accelerator's memory
        parallel_rays_chunk_size=8192,
    )
    vol_mod = VolumetricModel(grid, render_procedure=args.render_procedure,
                              render_config=config, device=device)

    rng = np.random.default_rng(args.seed)
    for split, count in (("train", args.num_train), ("test", args.num_test)):
        img_dir = output_path / split
        img_dir.mkdir(parents=True, exist_ok=True)
        params = {}
        for i in range(count):
            yaw = rng.uniform(0.0, 360.0)
            pitch = rng.uniform(-70.0, -10.0)
            pose = pose_spherical(yaw, pitch, radius=4.0)
            with torch.no_grad():
                colour = vol_mod.render(pose, intrinsics).colour
            name = f"r_{i}.png"
            write_png(img_dir / name, to8b(colour.cpu().numpy()))
            params[name] = {
                INTRINSIC: {BOUNDS: [NEAR, FAR], HEIGHT: image_size, WIDTH: image_size,
                            FOCAL: focal},
                EXTRINSIC: {ROTATION: pose.rotation.tolist(),
                            TRANSLATION: pose.translation.tolist()},
            }
        with open(output_path / f"{split}_camera_params.json", "w") as f:
            json.dump(params, f, indent=2)
        log.info(f"wrote {count} {split} images to {img_dir}")

    np.savez(output_path / "ground_truth_grid.npz",
             densities=grid.densities.detach().cpu().numpy(),
             features=grid.features.detach().cpu().numpy())
    log.info(f"synthetic dataset complete at {output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
