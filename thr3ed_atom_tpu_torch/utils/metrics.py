"""Quality metrics (counterpart of thr3ed_atom_tpu/utils/metrics.py)."""
from typing import Union

import numpy as np
import torch

from thr3ed_atom_tpu_torch.utils.constants import INFINITY


def mse2psnr(mse: Union[float, torch.Tensor]) -> Union[float, torch.Tensor]:
    """PSNR from a mean-squared error (pixels in [0, 1]); mse == 0 maps to INFINITY."""
    if isinstance(mse, torch.Tensor):
        return torch.where(mse == 0.0, torch.full_like(mse, INFINITY),
                           -10.0 * torch.log10(mse))
    return -10.0 * float(np.log10(mse)) if mse != 0 else INFINITY
