"""Static visualizations: the camera-rays plot and the training feedback
panels (counterpart of thr3ed_atom_tpu/visualizations/static.py), the panels
written as PNGs with data/png.py.

The camera-rays plot needs matplotlib and the panel's training-time stamp
PIL's ImageDraw: each is imported when drawn, and where it is missing (the
card's machine has neither) the plot is skipped and the stamp logged.
"""
from datetime import timedelta
from pathlib import Path
from typing import Optional

import numpy as np

from thr3ed_atom_tpu_torch.data.png import write_png
from thr3ed_atom_tpu_torch.modules.volumetric_model import VolumetricModel
from thr3ed_atom_tpu_torch.rendering.interface import RenderOut
from thr3ed_atom_tpu_torch.utils.camera import (
    CameraIntrinsics,
    CameraPose,
    postprocess_depth_map,
    to8b,
)
from thr3ed_atom_tpu_torch.utils.constants import (
    EXTRA_ACCUMULATED_WEIGHTS,
    NUM_COLOUR_CHANNELS,
)
from thr3ed_atom_tpu_torch.utils.logging import log


def visualize_camera_rays(dataset, output_dir: Path, num_rays_per_image: int = 30,
                          do_ndcize_rays: bool = False) -> None:
    """3D matplotlib plot of each view's rays through ``num_rays_per_image``
    pixels (drawn with numpy's global generator, as the JAX package draws
    them) from the camera to the far bound (1 after the NDC map), and the
    camera locations -> ``output_dir/casted_camera_rays.png``. Without
    matplotlib the plot is skipped, with a log line."""
    try:
        from matplotlib import pyplot as plt
    except ImportError:
        log.info("camera-rays visualization skipped: matplotlib is not installed")
        return
    import torch

    from thr3ed_atom_tpu_torch.rendering.interface import Rays
    from thr3ed_atom_tpu_torch.rendering.rays import ndcize_rays

    fig = plt.figure()
    fig.suptitle("Camera rays visualization")
    ax = fig.add_subplot(111, projection="3d")
    locations = []
    height, width, focal = dataset.camera_intrinsics
    for camera_param in dataset.camera_parameters.values():
        pose = dataset.extract_pose(camera_param)
        pix = np.random.randint(0, height * width, size=num_rays_per_image)
        px = (pix % width).astype(np.float32) + 0.5
        py = (pix // width).astype(np.float32) + 0.5
        cam_dirs = np.stack([(px - width * 0.5) / focal, -(py - height * 0.5) / focal,
                             -np.ones_like(px)], axis=-1)
        rotation = np.asarray(pose.rotation, np.float32).reshape(3, 3)
        translation = np.asarray(pose.translation, np.float32).reshape(3)
        directions = cam_dirs @ rotation.T
        origins = np.broadcast_to(translation, directions.shape).copy()
        if do_ndcize_rays:
            rays = ndcize_rays(Rays(origins=torch.from_numpy(origins),
                                    directions=torch.from_numpy(directions)),
                               dataset.camera_intrinsics)
            origins, directions = rays.origins.numpy(), rays.directions.numpy()
        locations.append(origins[0])
        far_plane = dataset.camera_bounds.far if not do_ndcize_rays else 1.0
        for point_a, point_b in zip(origins, origins + directions * far_plane):
            seg = np.stack([point_a, point_b])
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color="b")
    locations = np.stack(locations, axis=0)
    ax.scatter(locations[:, 0], locations[:, 1], locations[:, 2], color="m")
    plt.tight_layout()
    plt.savefig(Path(output_dir) / "casted_camera_rays.png", dpi=600)
    plt.close(fig)


def process_rendered_output_for_feedback_log(rendered_output: RenderOut,
                                             training_time: Optional[float] = None
                                             ) -> np.ndarray:
    """Side-by-side colour | magma depth | inverted acc panel, uint8, with the
    training time stamped at (10, 10) in black by PIL's ImageDraw where PIL
    imports (logged where it does not)."""
    colour_map = to8b(rendered_output.colour.detach().cpu().numpy())
    acc = rendered_output.extra[EXTRA_ACCUMULATED_WEIGHTS].detach().cpu().numpy()
    depth_map = postprocess_depth_map(
        rendered_output.depth.detach().cpu().numpy().squeeze(), acc_map=acc
    )
    acc_map = np.tile(to8b(1.0 - acc), (1, 1, NUM_COLOUR_CHANNELS))
    panel = np.concatenate([colour_map, depth_map, acc_map], axis=1)
    if training_time is not None:
        stamp = str(timedelta(seconds=training_time))
        try:
            from PIL import Image, ImageDraw
        except ImportError:
            log.info(f"feedback panel at training time {stamp} (no PIL: not stamped)")
            return panel
        image = Image.fromarray(panel)
        ImageDraw.Draw(image).text((10, 10), stamp, (0, 0, 0))
        panel = np.array(image)
    return panel


def visualize_sh_vox_grid_vol_mod_rendered_feedback(
    vol_mod: VolumetricModel,
    render_feedback_pose: CameraPose,
    camera_intrinsics: CameraIntrinsics,
    global_step: int,
    feedback_logs_dir: Path,
    training_time: Optional[float] = None,
    log_diffuse_rendered_version: bool = True,
    overridden_num_samples_per_ray: Optional[int] = None,
) -> None:
    """Specular (and, as the JAX package, a render with ``render_diffuse``
    set) full renders -> specular_<step>.png / diffuse_<step>.png."""
    num_samples = (overridden_num_samples_per_ray
                   if overridden_num_samples_per_ray is not None else 1024)
    log.info("rendering intermediate output for feedback")
    specular = vol_mod.render(render_feedback_pose, camera_intrinsics,
                              optimized_sampling=False, num_samples_per_ray=num_samples)
    write_png(Path(feedback_logs_dir) / f"specular_{global_step}.png",
              process_rendered_output_for_feedback_log(specular, training_time))
    if log_diffuse_rendered_version:
        diffuse = vol_mod.render(render_feedback_pose, camera_intrinsics,
                                 optimized_sampling=False, render_diffuse=True,
                                 num_samples_per_ray=num_samples)
        write_png(Path(feedback_logs_dir) / f"diffuse_{global_step}.png",
                  process_rendered_output_for_feedback_log(diffuse, training_time))
