"""Gaussian diffusion likelihood helpers (counterpart of
thr3ed_atom_tpu/diffusion/losses.py): the OpenAI-lineage formulations as
tensor functions."""
import math

import torch


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL divergence between two diagonal Gaussians (natural log, per element).
    Any argument may be a Python number."""
    mean1, logvar1, mean2, logvar2 = (
        a if isinstance(a, torch.Tensor) else torch.tensor(float(a))
        for a in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (
        -1.0
        + logvar2
        - logvar1
        + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x):
    """Fast tanh-based approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3))))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a Gaussian discretized to 255 uniform bins on [-1, 1];
    x must be rescaled to [-1, 1] integers-bin centers."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered_x + 1.0 / 255.0)
    cdf_plus = approx_standard_normal_cdf(plus_in)
    min_in = inv_stdv * (centered_x - 1.0 / 255.0)
    cdf_min = approx_standard_normal_cdf(min_in)
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    cdf_delta = cdf_plus - cdf_min
    return torch.where(
        x < -0.999,
        log_cdf_plus,
        torch.where(x > 0.999, log_one_minus_cdf_min,
                    torch.log(torch.clamp(cdf_delta, min=1e-12))),
    )
