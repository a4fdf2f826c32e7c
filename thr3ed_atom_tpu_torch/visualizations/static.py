"""Static visualizations: training feedback panels (counterpart of
thr3ed_atom_tpu/visualizations/static.py), written as PNGs with data/png.py.

The JAX package's training-time stamp drawn into the panel (PIL's ImageDraw)
is logged instead, and the camera-rays plot (matplotlib) is not ported.
"""
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
    """The JAX package's 3D plot of the camera rays needs matplotlib: not
    ported (ROADMAP.md, 'Modules to port', item 6). Logs so and returns."""
    log.info("camera-rays visualization (matplotlib) is not ported; skipped")


def process_rendered_output_for_feedback_log(rendered_output: RenderOut) -> np.ndarray:
    """Side-by-side colour | magma depth | inverted acc panel, uint8."""
    colour_map = to8b(rendered_output.colour.detach().cpu().numpy())
    acc = rendered_output.extra[EXTRA_ACCUMULATED_WEIGHTS].detach().cpu().numpy()
    depth_map = postprocess_depth_map(
        rendered_output.depth.detach().cpu().numpy().squeeze(), acc_map=acc
    )
    acc_map = np.tile(to8b(1.0 - acc), (1, 1, NUM_COLOUR_CHANNELS))
    return np.concatenate([colour_map, depth_map, acc_map], axis=1)


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
    log.info(f"rendering intermediate output for feedback (training time {training_time} s)")
    specular = vol_mod.render(render_feedback_pose, camera_intrinsics,
                              optimized_sampling=False, num_samples_per_ray=num_samples)
    write_png(Path(feedback_logs_dir) / f"specular_{global_step}.png",
              process_rendered_output_for_feedback_log(specular))
    if log_diffuse_rendered_version:
        diffuse = vol_mod.render(render_feedback_pose, camera_intrinsics,
                                 optimized_sampling=False, render_diffuse=True,
                                 num_samples_per_ray=num_samples)
        write_png(Path(feedback_logs_dir) / f"diffuse_{global_step}.png",
                  process_rendered_output_for_feedback_log(diffuse))
