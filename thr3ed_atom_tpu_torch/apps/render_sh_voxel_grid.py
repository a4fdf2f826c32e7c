"""Render CLI of the port: load a trained model, render a thre360 or spiral
camera path on the CUDA card, write a video.

    python -m thr3ed_atom_tpu_torch.apps.render_sh_voxel_grid -i <model> -o <out> ...

The JAX package's apps/render_sh_voxel_grid.py with the same option names and
defaults (argparse instead of click). It loads a checkpoint written by either
package (``<model>.npz`` / ``<model>.json``) with any of its procedures
(exact, fast, hierarchical, gnomonic, bricked, planes), renders the colour |
depth | inverted-acc panels of every pose and writes ``rendered_video.gif``
in the output directory: the GIF the JAX package writes when it has no
mp4 backend (the port has none). ``main(argv, device="cpu")`` runs on the
CPU through the kernels' plain versions (tests); without ``device``
everything runs on the card.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from thr3ed_atom_tpu_torch.modules.volumetric_model import (
    create_volumetric_model_from_saved_model,
)
from thr3ed_atom_tpu_torch.utils.camera import (
    CameraIntrinsics,
    get_thre360_animation_poses,
    get_thre360_spiral_animation_poses,
)
from thr3ed_atom_tpu_torch.utils.constants import CAMERA_INTRINSICS, HEMISPHERICAL_RADIUS
from thr3ed_atom_tpu_torch.visualizations.animations import (
    render_camera_path_for_volumetric_model,
)
from thr3ed_atom_tpu_torch.visualizations.video import write_video


def _at_least_one(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"{value} is smaller than the minimum 1")
    return value


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m thr3ed_atom_tpu_torch.apps.render_sh_voxel_grid",
        description="Render a camera path of a trained model (PyTorch/CUDA port).",
    )
    add = p.add_argument
    # required arguments
    add("-i", "--model_path", required=True,
        help="path to the trained (reconstructed) model (.npz/.json pair)")
    add("-o", "--output_path", required=True, help="path for saving rendered output")
    # render configuration
    add("--overridden_num_samples_per_ray", type=_at_least_one, default=512,
        help="overridden (increased) num_samples_per_ray for high-quality renders")
    add("--render_scale_factor", type=float, default=2.0,
        help="resolution scale factor for the render")
    add("--camera_path", choices=("thre360", "spiral"), default="thre360",
        help="which camera path to use for rendering the animation")
    # thre360 path
    add("--camera_pitch", type=float, default=60.0,
        help="pitch-angle value for the camera for 360 path animation")
    add("--num_frames", type=_at_least_one, default=180, help="number of frames in the video")
    # spiral path
    add("--vertical_camera_height", type=float, default=3.0,
        help="height at which the camera spiralling happens")
    add("--num_spiral_rounds", type=_at_least_one, default=2,
        help="number of rounds made while transitioning between spiral radii")
    # video
    add("--fps", type=_at_least_one, default=60, help="frames per second of the video")
    return p


def main(argv: Optional[Sequence[str]] = None, device=None) -> Path:
    """Parse ``argv`` (sys.argv[1:] when None), render on ``device`` (None:
    the CUDA card) and write the video. Returns the path written."""
    config = vars(build_parser().parse_args(argv))
    output_path = Path(config["output_path"])
    output_path.mkdir(exist_ok=True, parents=True)

    vol_mod, extra_info = create_volumetric_model_from_saved_model(
        Path(config["model_path"]), device=device)
    hemispherical_radius = extra_info[HEMISPHERICAL_RADIUS]
    height, width, focal = extra_info[CAMERA_INTRINSICS]
    camera_intrinsics = CameraIntrinsics(int(height), int(width), float(focal))

    if config["camera_path"] == "thre360":
        animation_poses = get_thre360_animation_poses(
            hemispherical_radius=hemispherical_radius,
            camera_pitch=config["camera_pitch"],
            num_poses=config["num_frames"],
        )
    else:
        animation_poses = get_thre360_spiral_animation_poses(
            horizontal_radius_range=(hemispherical_radius / 8.0, hemispherical_radius),
            vertical_camera_height=config["vertical_camera_height"],
            num_rounds=config["num_spiral_rounds"],
            num_poses=config["num_frames"],
        )

    animation_frames = render_camera_path_for_volumetric_model(
        vol_mod=vol_mod,
        camera_path=animation_poses,
        camera_intrinsics=camera_intrinsics,
        overridden_num_samples_per_ray=config["overridden_num_samples_per_ray"],
        render_scale_factor=config["render_scale_factor"],
    )
    return write_video(output_path / "rendered_video.mp4", animation_frames, fps=config["fps"])


if __name__ == "__main__":
    main()
