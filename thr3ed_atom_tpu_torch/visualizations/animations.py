"""Camera-path animation renderer (counterpart of
thr3ed_atom_tpu/visualizations/animations.py): the stacked panel frames;
visualizations/video.py writes them as a video."""
from typing import Optional, Sequence

import numpy as np

from thr3ed_atom_tpu_torch.modules.volumetric_model import VolumetricModel
from thr3ed_atom_tpu_torch.utils.camera import (
    CameraIntrinsics,
    CameraPose,
    postprocess_depth_map,
    scale_camera_intrinsics,
    to8b,
)
from thr3ed_atom_tpu_torch.utils.constants import (
    EXTRA_ACCUMULATED_WEIGHTS,
    NUM_COLOUR_CHANNELS,
)
from thr3ed_atom_tpu_torch.utils.logging import log


def render_camera_path_for_volumetric_model(
    vol_mod: VolumetricModel,
    camera_path: Sequence[CameraPose],
    camera_intrinsics: CameraIntrinsics,
    render_scale_factor: Optional[float] = None,
    overridden_num_samples_per_ray: Optional[int] = None,
    verbose: bool = True,
) -> np.ndarray:
    """Per pose: deterministic full render -> colour | depth | inverted-acc
    panel; returns a stacked [T, H, W*3, 3] uint8 array."""
    if render_scale_factor is not None:
        camera_intrinsics = scale_camera_intrinsics(camera_intrinsics,
                                                    render_scale_factor)
    overrides = {}
    if overridden_num_samples_per_ray is not None:
        overrides["num_samples_per_ray"] = overridden_num_samples_per_ray

    if verbose:
        log.info(f"rendering camera path ({len(camera_path)} frames, batched)")
    rendered = vol_mod.render_poses(list(camera_path), camera_intrinsics, **overrides)
    colour = rendered.colour.cpu().numpy()
    acc = rendered.extra[EXTRA_ACCUMULATED_WEIGHTS].cpu().numpy()
    depth = rendered.depth.cpu().numpy()

    frames = []
    for i in range(len(camera_path)):
        colour_frame = to8b(colour[i])
        depth_frame = postprocess_depth_map(depth[i], acc_map=acc[i])
        acc_frame = to8b(1.0 - np.tile(acc[i], (1, 1, NUM_COLOUR_CHANNELS)))
        frames.append(np.concatenate([colour_frame, depth_frame, acc_frame], axis=1))
    return np.stack(frames)
