"""Timestep schedule samplers (counterpart of
thr3ed_atom_tpu/diffusion/timestep_sampler.py) with torch generators."""
from abc import ABC, abstractmethod
from typing import Optional, Tuple

import numpy as np
import torch


class ScheduleSampler(ABC):
    """A distribution over diffusion timesteps; unbiased importance sampling by
    default (weights reweight the loss so its mean is unchanged)."""

    @abstractmethod
    def weights(self) -> np.ndarray:
        """Positive per-timestep weights (need not be normalized)."""

    def probabilities(self, device=None) -> torch.Tensor:
        """The weights normalized in float64 and cast to f32."""
        w = np.asarray(self.weights(), dtype=np.float64)
        return torch.as_tensor(w / w.sum(), dtype=torch.float32, device=device)

    def sample(self, generator: Optional[torch.Generator], batch_size: int, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``batch_size`` timesteps drawn from the distribution and their
        importance weights 1 / (T p[t])."""
        if device is None and generator is not None:
            device = generator.device
        p = self.probabilities(device)
        indices = torch.multinomial(p, batch_size, replacement=True, generator=generator)
        weights = 1.0 / (len(p) * p[indices])
        return indices, weights


class UniformSampler(ScheduleSampler):
    def __init__(self, diffusion):
        self.diffusion = diffusion
        self._weights = np.ones([diffusion.num_timesteps])

    def weights(self) -> np.ndarray:
        return self._weights
