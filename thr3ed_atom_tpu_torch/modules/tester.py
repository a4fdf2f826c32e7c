"""Held-out evaluation: full-image renders, their PSNR and LPIPS (counterpart
of thr3ed_atom_tpu/modules/tester.py).

LPIPS is always computed (utils/lpips.py): with converted official weights
when ``THR3ED_LPIPS_WEIGHTS`` names their npz, reported as
``TEST_SET_LPIPS``; otherwise with the seeded random-feature fallback,
reported as ``TEST_SET_LPIPS_RAND`` so that the two are never compared.
"""
from typing import Dict, Optional

import numpy as np
import torch

from thr3ed_atom_tpu_torch.data.dataset import PosedImagesDataset
from thr3ed_atom_tpu_torch.modules.volumetric_model import VolumetricModel
from thr3ed_atom_tpu_torch.utils.camera import CameraPose
from thr3ed_atom_tpu_torch.utils.logging import log
from thr3ed_atom_tpu_torch.utils.lpips import LPIPSMetric
from thr3ed_atom_tpu_torch.utils.metrics import mse2psnr

TEST_SET_PSNR = "TEST_SET_PSNR"
TEST_SET_LPIPS = "TEST_SET_LPIPS"
# the seeded random-feature fallback is not comparable with calibrated LPIPS,
# so it reports under its own key
TEST_SET_LPIPS_RAND = "TEST_SET_LPIPS_RAND"

_lpips_metrics: Dict[str, LPIPSMetric] = {}


def _get_lpips(device: torch.device) -> LPIPSMetric:
    """One LPIPSMetric a device, loaded on first use."""
    key = str(device)
    if key not in _lpips_metrics:
        _lpips_metrics[key] = LPIPSMetric(device=device)
        log.info(f"LPIPS metric initialized: {_lpips_metrics[key].name}")
    return _lpips_metrics[key]


def test_sh_vox_grid_vol_mod_with_posed_images(
    vol_mod: VolumetricModel,
    test_dataset: PosedImagesDataset,
    tensorboard_writer=None,
    global_step: Optional[int] = None,
) -> dict:
    """Render every test view at render_num_samples_per_ray (non-optimized
    sampling) and average the PSNR and LPIPS; ``tensorboard_writer`` is
    anything with ``add_scalar(name, value, global_step=...)`` (the
    trainer's summary log)."""
    log.info("Running heldout-set evaluation...")
    intrinsics = test_dataset.camera_intrinsics
    lpips_metric = _get_lpips(vol_mod.device)
    psnrs, lpips_scores = [], []
    for index in range(len(test_dataset)):
        image, pose_arr = test_dataset[index]
        pose = CameraPose(rotation=pose_arr[:, :3], translation=pose_arr[:, 3:])
        rendered = vol_mod.render(
            pose,
            intrinsics,
            optimized_sampling=False,
            num_samples_per_ray=vol_mod.render_config.render_num_samples_per_ray,
        )
        colour = rendered.colour.detach()
        mse = float(np.mean((colour.cpu().numpy() - image) ** 2))
        psnrs.append(mse2psnr(mse))
        lpips_scores.append(lpips_metric(colour, image))
        log.info(f"test image {index}: psnr {psnrs[-1]:.3f} "
                 f"{lpips_metric.name} {lpips_scores[-1]:.4f}")

    lpips_key = TEST_SET_LPIPS if lpips_metric.calibrated else TEST_SET_LPIPS_RAND
    results = {TEST_SET_PSNR: float(np.mean(psnrs)),
               lpips_key: float(np.mean(lpips_scores))}
    log.info(f"heldout PSNR: {results[TEST_SET_PSNR]:.3f}  "
             f"heldout LPIPS ({lpips_metric.name}): {results[lpips_key]:.4f}")
    if tensorboard_writer is not None:
        for name, value in results.items():
            tensorboard_writer.add_scalar(name, value, global_step=global_step)
    return results
