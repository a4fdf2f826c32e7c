"""Held-out evaluation: full-image renders and their PSNR (counterpart of
thr3ed_atom_tpu/modules/tester.py).

LPIPS is not computed yet: the JAX package's utils/lpips.py is not ported
(ROADMAP.md, 'Modules to port', item 11). The results leave the LPIPS keys
out rather than report a value that was not measured.
"""
from typing import Optional

import numpy as np

from thr3ed_atom_tpu_torch.data.dataset import PosedImagesDataset
from thr3ed_atom_tpu_torch.modules.volumetric_model import VolumetricModel
from thr3ed_atom_tpu_torch.utils.camera import CameraPose
from thr3ed_atom_tpu_torch.utils.logging import log
from thr3ed_atom_tpu_torch.utils.metrics import mse2psnr

TEST_SET_PSNR = "TEST_SET_PSNR"


def test_sh_vox_grid_vol_mod_with_posed_images(
    vol_mod: VolumetricModel,
    test_dataset: PosedImagesDataset,
    tensorboard_writer=None,
    global_step: Optional[int] = None,
) -> dict:
    """Render every test view at render_num_samples_per_ray and average the
    PSNR; ``tensorboard_writer`` is anything with ``add_scalar(name, value,
    global_step=...)`` (the trainer's summary log)."""
    log.info("Running heldout-set evaluation...")
    intrinsics = test_dataset.camera_intrinsics
    psnrs = []
    for index in range(len(test_dataset)):
        image, pose_arr = test_dataset[index]
        pose = CameraPose(rotation=pose_arr[:, :3], translation=pose_arr[:, 3:])
        rendered = vol_mod.render(
            pose,
            intrinsics,
            optimized_sampling=False,
            num_samples_per_ray=vol_mod.render_config.render_num_samples_per_ray,
        )
        colour = rendered.colour.detach().cpu().numpy()
        mse = float(np.mean((colour - image) ** 2))
        psnrs.append(mse2psnr(mse))
        log.info(f"test image {index}: psnr {psnrs[-1]:.3f}")

    results = {TEST_SET_PSNR: float(np.mean(psnrs))}
    log.info(f"heldout PSNR: {results[TEST_SET_PSNR]:.3f} (LPIPS not ported)")
    if tensorboard_writer is not None:
        for name, value in results.items():
            tensorboard_writer.add_scalar(name, value, global_step=global_step)
    return results
