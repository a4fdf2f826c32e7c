"""Gaussian diffusion (DDPM + DDIM) in PyTorch (counterpart of
thr3ed_atom_tpu/diffusion/gaussian_diffusion.py).

The schedules are float64 numpy arrays, cast to f32 only where ``_extract``
indexes them (uploaded once per device). The reverse-process loops are
Python loops over the same descending timestep sequence as the JAX
package's ``lax.scan``, run without autograd. Every draw takes a
``torch.Generator`` or the noise itself (``noise=``, ``step_noise=``), so
a caller can feed the draws of another source, such as the JAX package's
keys. The model is a function ``model_fn(x, t) -> out`` on channels-last
tensors.
"""
import enum
import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from thr3ed_atom_tpu_torch.diffusion.losses import (
    discretized_gaussian_log_likelihood,
    normal_kl,
)
from thr3ed_atom_tpu_torch.diffusion.nn import mean_flat


# ------------------------------------------------------------------- beta schedules


def betas_for_alpha_bar(num_diffusion_timesteps, alpha_bar, max_beta=0.999):
    """Betas such that cumprod(1 - beta) follows ``alpha_bar``."""
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def get_named_beta_schedule(
    schedule_name: str,
    num_diffusion_timesteps: int,
    beta_start_unscaled: float = 0.0001,
    beta_end_unscaled: float = 0.02,
) -> np.ndarray:
    """'linear' (scaled to the timestep count) or 'cosine'."""
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(scale * beta_start_unscaled, scale * beta_end_unscaled,
                           num_diffusion_timesteps, dtype=np.float64)
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


# ------------------------------------------------------------------------ enums


class ModelMeanType(enum.Enum):
    PREVIOUS_X = enum.auto()  # model predicts x_{t-1}
    START_X = enum.auto()  # model predicts x_0
    EPSILON = enum.auto()  # model predicts the noise


class ModelVarType(enum.Enum):
    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


class LossType(enum.Enum):
    MSE = enum.auto()
    RESCALED_MSE = enum.auto()
    KL = enum.auto()
    RESCALED_KL = enum.auto()
    HUBER = enum.auto()

    def is_vb(self):
        return self in (LossType.KL, LossType.RESCALED_KL)


def _huber(x, y, delta: float = 1.0):
    """Smooth L1 (Huber) elementwise loss."""
    diff = torch.abs(x - y)
    return torch.where(diff < delta, 0.5 * diff ** 2, delta * (diff - 0.5 * delta))


def _draw(generator: Optional[torch.Generator], like: torch.Tensor) -> torch.Tensor:
    return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)


class GaussianDiffusion:
    """The diffusion process utilities; stateless apart from precomputed schedules."""

    def __init__(
        self,
        *,
        betas: np.ndarray,
        model_mean_type: ModelMeanType,
        model_var_type: ModelVarType,
        loss_type: LossType,
        rescale_timesteps: bool = False,
    ):
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        self.loss_type = loss_type
        self.rescale_timesteps = rescale_timesteps

        betas = np.array(betas, dtype=np.float64)
        if betas.ndim != 1 or not ((0 < betas).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        self.betas = betas
        self.num_timesteps = betas.shape[0]

        alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(alphas, axis=0)
        self.alphas_cumprod_prev = np.append(1.0, self.alphas_cumprod[:-1])
        self.alphas_cumprod_next = np.append(self.alphas_cumprod[1:], 0.0)

        self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - self.alphas_cumprod)
        self.log_one_minus_alphas_cumprod = np.log(1.0 - self.alphas_cumprod)
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod - 1)

        # posterior q(x_{t-1} | x_t, x_0)
        self.posterior_variance = (
            betas * (1.0 - self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod)
        )
        self.posterior_log_variance_clipped = np.log(
            np.append(self.posterior_variance[1], self.posterior_variance[1:])
        )
        self.posterior_mean_coef1 = (
            betas * np.sqrt(self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod)
        )
        self.posterior_mean_coef2 = (
            (1.0 - self.alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - self.alphas_cumprod)
        )

        # the arrays the JAX package derives inside its methods, in float64
        self._one_minus_alphas_cumprod = 1.0 - self.alphas_cumprod
        self._recip_posterior_mean_coef1 = 1.0 / self.posterior_mean_coef1
        self._coef2_over_coef1 = self.posterior_mean_coef2 / self.posterior_mean_coef1
        self._log_betas = np.log(self.betas)
        self._fixed_large_variance = np.append(self.posterior_variance[1], self.betas[1:])
        self._fixed_large_log_variance = np.log(self._fixed_large_variance)
        self._tables: Dict[tuple, torch.Tensor] = {}

    def _extract(self, arr: np.ndarray, timesteps: torch.Tensor, broadcast_shape
                 ) -> torch.Tensor:
        """Index a schedule array (one of this object's) at per-batch timesteps
        and broadcast over the rest; the f32 table is uploaded once per device."""
        key = (id(arr), timesteps.device)
        table = self._tables.get(key)
        if table is None:
            table = torch.as_tensor(arr, dtype=torch.float32).to(timesteps.device)
            self._tables[key] = table
        res = table[timesteps]
        return res.reshape(res.shape[0], *([1] * (len(broadcast_shape) - 1)))

    # ------------------------------------------------------------- forward process

    def q_mean_variance(self, x_start, t):
        mean = self._extract(self.sqrt_alphas_cumprod, t, x_start.shape) * x_start
        variance = self._extract(self._one_minus_alphas_cumprod, t, x_start.shape)
        log_variance = self._extract(self.log_one_minus_alphas_cumprod, t, x_start.shape)
        return mean, variance, log_variance

    def q_sample(self, x_start, t, noise):
        """Diffuse x_0 to x_t."""
        return (
            self._extract(self.sqrt_alphas_cumprod, t, x_start.shape) * x_start
            + self._extract(self.sqrt_one_minus_alphas_cumprod, t, x_start.shape) * noise
        )

    def q_posterior_mean_variance(self, x_start, x_t, t):
        posterior_mean = (
            self._extract(self.posterior_mean_coef1, t, x_t.shape) * x_start
            + self._extract(self.posterior_mean_coef2, t, x_t.shape) * x_t
        )
        posterior_variance = self._extract(self.posterior_variance, t, x_t.shape)
        posterior_log_variance = self._extract(self.posterior_log_variance_clipped, t,
                                               x_t.shape)
        return posterior_mean, posterior_variance, posterior_log_variance

    # ------------------------------------------------------------- reverse process

    def _scale_timesteps(self, t):
        if self.rescale_timesteps:
            return t.float() * (1000.0 / self.num_timesteps)
        return t

    def _predict_xstart_from_eps(self, x_t, t, eps):
        return (
            self._extract(self.sqrt_recip_alphas_cumprod, t, x_t.shape) * x_t
            - self._extract(self.sqrt_recipm1_alphas_cumprod, t, x_t.shape) * eps
        )

    def _predict_xstart_from_xprev(self, x_t, t, xprev):
        return (
            self._extract(self._recip_posterior_mean_coef1, t, x_t.shape) * xprev
            - self._extract(self._coef2_over_coef1, t, x_t.shape) * x_t
        )

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        return (
            self._extract(self.sqrt_recip_alphas_cumprod, t, x_t.shape) * x_t - pred_xstart
        ) / self._extract(self.sqrt_recipm1_alphas_cumprod, t, x_t.shape)

    def p_mean_variance(self, model_fn, x, t, clip_denoised: bool = True,
                        denoised_fn: Optional[Callable] = None):
        """Predict p(x_{t-1} | x_t): mean, variance, log-variance, pred x_0
        (with the learned-variance channel split)."""
        model_output = model_fn(x, self._scale_timesteps(t))

        if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            model_output, model_var_values = torch.chunk(model_output, 2, dim=-1)
            if self.model_var_type == ModelVarType.LEARNED:
                model_log_variance = model_var_values
                model_variance = torch.exp(model_log_variance)
            else:
                min_log = self._extract(self.posterior_log_variance_clipped, t, x.shape)
                max_log = self._extract(self._log_betas, t, x.shape)
                frac = (model_var_values + 1) / 2
                model_log_variance = frac * max_log + (1 - frac) * min_log
                model_variance = torch.exp(model_log_variance)
        elif self.model_var_type == ModelVarType.FIXED_LARGE:
            model_variance = self._extract(self._fixed_large_variance, t, x.shape)
            model_log_variance = self._extract(self._fixed_large_log_variance, t, x.shape)
        else:  # FIXED_SMALL
            model_variance = self._extract(self.posterior_variance, t, x.shape)
            model_log_variance = self._extract(self.posterior_log_variance_clipped, t,
                                               x.shape)

        def process_xstart(x0):
            if denoised_fn is not None:
                x0 = denoised_fn(x0)
            if clip_denoised:
                x0 = torch.clamp(x0, -1.0, 1.0)
            return x0

        if self.model_mean_type == ModelMeanType.PREVIOUS_X:
            pred_xstart = process_xstart(self._predict_xstart_from_xprev(x, t, model_output))
            model_mean = model_output
        elif self.model_mean_type == ModelMeanType.START_X:
            pred_xstart = process_xstart(model_output)
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        else:  # EPSILON
            pred_xstart = process_xstart(self._predict_xstart_from_eps(x, t, model_output))
            model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)

        return {
            "mean": model_mean,
            "variance": model_variance,
            "log_variance": model_log_variance,
            "pred_xstart": pred_xstart,
        }

    # --------------------------------------------------------- classifier guidance

    def condition_mean(self, cond_fn, p_mean_var, x, t):
        """Shift the reverse mean by variance * grad(log p(y | x))."""
        gradient = cond_fn(x, self._scale_timesteps(t))
        return p_mean_var["mean"] + p_mean_var["variance"] * gradient

    def condition_score(self, cond_fn, p_mean_var, x, t):
        """Condition the epsilon prediction with the classifier score."""
        alpha_bar = self._extract(self.alphas_cumprod, t, x.shape)
        eps = self._predict_eps_from_xstart(x, t, p_mean_var["pred_xstart"])
        eps = eps - torch.sqrt(1 - alpha_bar) * cond_fn(x, self._scale_timesteps(t))
        out = dict(p_mean_var)
        out["pred_xstart"] = self._predict_xstart_from_eps(x, t, eps)
        out["mean"], _, _ = self.q_posterior_mean_variance(out["pred_xstart"], x, t)
        return out

    # ------------------------------------------------------------------- sampling

    def p_sample(self, model_fn, x, t, generator: Optional[torch.Generator] = None,
                 clip_denoised=True, denoised_fn=None, cond_fn=None,
                 noise: Optional[torch.Tensor] = None):
        """One ancestral sampling step; ``noise`` (else a draw from
        ``generator``) is the step's standard normal."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn)
        if cond_fn is not None:
            out["mean"] = self.condition_mean(cond_fn, out, x, t)
        if noise is None:
            noise = _draw(generator, x)
        nonzero_mask = (t != 0).to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))
        sample = out["mean"] + nonzero_mask * torch.exp(0.5 * out["log_variance"]) * noise
        return sample, out["pred_xstart"]

    def _timestep_sequence(self, max_iter: Optional[int]) -> np.ndarray:
        """Descending timesteps, optionally subsampled to ``max_iter`` steps."""
        if max_iter is not None and max_iter < self.num_timesteps:
            indices = np.linspace(0, self.num_timesteps - 1, max_iter, dtype=np.int64)
        else:
            indices = np.arange(self.num_timesteps)
        return indices[::-1].copy()

    def _reverse_loop(self, step_fn, shape, generator, noise, step_noise, max_iter, device):
        if noise is None:
            if device is None and generator is not None:
                device = generator.device
            noise = torch.randn(tuple(shape), generator=generator, device=device)
        img = noise
        for i, t_scalar in enumerate(self._timestep_sequence(max_iter)):
            t = torch.full((shape[0],), int(t_scalar), dtype=torch.long, device=img.device)
            img, _ = step_fn(img, t, None if step_noise is None else step_noise[i])
        return img

    @torch.no_grad()
    def p_sample_loop(self, model_fn, shape: Sequence[int],
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None, clip_denoised=True,
                      denoised_fn=None, cond_fn=None, max_iter: Optional[int] = None,
                      step_noise: Optional[Sequence[torch.Tensor]] = None, device=None):
        """The whole reverse process: ``noise`` (else a draw) is x_T,
        ``step_noise[i]`` (else a draw) the i-th step's normal."""
        def step(img, t, z):
            return self.p_sample(model_fn, img, t, generator, clip_denoised, denoised_fn,
                                 cond_fn, noise=z)
        return self._reverse_loop(step, shape, generator, noise, step_noise, max_iter, device)

    def ddim_sample(self, model_fn, x, t, generator: Optional[torch.Generator] = None,
                    clip_denoised=True, denoised_fn=None, cond_fn=None, eta: float = 0.0,
                    noise: Optional[torch.Tensor] = None):
        """One DDIM step."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn)
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        alpha_bar = self._extract(self.alphas_cumprod, t, x.shape)
        alpha_bar_prev = self._extract(self.alphas_cumprod_prev, t, x.shape)
        sigma = (
            eta
            * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
            * torch.sqrt(1 - alpha_bar / alpha_bar_prev)
        )
        if noise is None:
            noise = _draw(generator, x)
        mean_pred = (
            out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
            + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps
        )
        nonzero_mask = (t != 0).to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))
        sample = mean_pred + nonzero_mask * sigma * noise
        return sample, out["pred_xstart"]

    def ddim_reverse_sample(self, model_fn, x, t, clip_denoised=True, denoised_fn=None,
                            eta: float = 0.0):
        """Deterministic encoding step x_t -> x_{t+1}."""
        if eta != 0.0:
            raise ValueError("reverse ODE only available for deterministic path")
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn)
        eps = (
            self._extract(self.sqrt_recip_alphas_cumprod, t, x.shape) * x
            - out["pred_xstart"]
        ) / self._extract(self.sqrt_recipm1_alphas_cumprod, t, x.shape)
        alpha_bar_next = self._extract(self.alphas_cumprod_next, t, x.shape)
        mean_pred = (
            out["pred_xstart"] * torch.sqrt(alpha_bar_next)
            + torch.sqrt(1 - alpha_bar_next) * eps
        )
        return mean_pred, out["pred_xstart"]

    @torch.no_grad()
    def ddim_sample_loop(self, model_fn, shape: Sequence[int],
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None, clip_denoised=True,
                         denoised_fn=None, cond_fn=None, eta: float = 0.0,
                         max_iter: Optional[int] = None,
                         step_noise: Optional[Sequence[torch.Tensor]] = None, device=None):
        """The whole DDIM sampling loop (draws as in ``p_sample_loop``)."""
        def step(img, t, z):
            return self.ddim_sample(model_fn, img, t, generator, clip_denoised, denoised_fn,
                                    cond_fn, eta, noise=z)
        return self._reverse_loop(step, shape, generator, noise, step_noise, max_iter, device)

    # --------------------------------------------------------------------- losses

    def _vb_terms_bpd(self, model_fn, x_start, x_t, t, clip_denoised=True):
        """Variational bound term at one timestep, in bits-per-dim."""
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model_fn, x_t, t, clip_denoised)
        kl = normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
        kl = mean_flat(kl) / np.log(2.0)
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"]
        )
        decoder_nll = mean_flat(decoder_nll) / np.log(2.0)
        output = torch.where(t == 0, decoder_nll, kl)
        return {"output": output, "pred_xstart": out["pred_xstart"]}

    def training_losses(self, model_fn, x_start, t, generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None):
        """Per-batch-element training losses; ``noise`` (else a draw from
        ``generator``) diffuses x_0 to x_t."""
        if noise is None:
            noise = _draw(generator, x_start)
        x_t = self.q_sample(x_start, t, noise)

        terms = {}
        if self.loss_type in (LossType.KL, LossType.RESCALED_KL):
            terms["loss"] = self._vb_terms_bpd(model_fn, x_start, x_t, t)["output"]
            if self.loss_type == LossType.RESCALED_KL:
                terms["loss"] = terms["loss"] * self.num_timesteps
        else:  # MSE / RESCALED_MSE / HUBER
            model_output = model_fn(x_t, self._scale_timesteps(t))

            if self.model_var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
                model_output, model_var_values = torch.chunk(model_output, 2, dim=-1)
                # learned-variance VLB term with a frozen mean
                frozen_out = torch.cat([model_output.detach(), model_var_values], dim=-1)
                terms["vb"] = self._vb_terms_bpd(lambda *_: frozen_out, x_start, x_t, t)[
                    "output"]
                if self.loss_type == LossType.RESCALED_MSE:
                    terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)

            if self.model_mean_type == ModelMeanType.PREVIOUS_X:
                target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
            elif self.model_mean_type == ModelMeanType.START_X:
                target = x_start
            else:
                target = noise

            if self.loss_type == LossType.HUBER:
                terms["mse"] = mean_flat(_huber(target, model_output))
            else:
                terms["mse"] = mean_flat((target - model_output) ** 2)
            terms["loss"] = terms["mse"] + terms.get("vb", 0.0)
        return terms

    def _prior_bpd(self, x_start):
        """KL(q(x_T | x_0) || N(0, I)) in bits-per-dim."""
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1, dtype=torch.long,
                       device=x_start.device)
        qt_mean, _, qt_log_variance = self.q_mean_variance(x_start, t)
        kl_prior = normal_kl(qt_mean, qt_log_variance, 0.0, 0.0)
        return mean_flat(kl_prior) / np.log(2.0)

    @torch.no_grad()
    def calc_bpd_loop(self, model_fn, x_start, generator: Optional[torch.Generator] = None,
                      clip_denoised=True, noise: Optional[Sequence[torch.Tensor]] = None):
        """Total bits-per-dim over all timesteps; ``noise[i]`` (else a draw)
        diffuses x_0 at the i-th timestep of the descending sequence."""
        batch = x_start.shape[0]
        vb, xstart_mse, mse = [], [], []
        for i, t_scalar in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((batch,), t_scalar, dtype=torch.long, device=x_start.device)
            z = _draw(generator, x_start) if noise is None else noise[i]
            x_t = self.q_sample(x_start, t, z)
            out = self._vb_terms_bpd(model_fn, x_start, x_t, t, clip_denoised)
            eps = self._predict_eps_from_xstart(x_t, t, out["pred_xstart"])
            vb.append(out["output"])
            xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
            mse.append(mean_flat((eps - z) ** 2))
        vb, xstart_mse, mse = (torch.stack(v) for v in (vb, xstart_mse, mse))
        prior_bpd = self._prior_bpd(x_start)
        return {
            "total_bpd": vb.sum(dim=0) + prior_bpd,
            "prior_bpd": prior_bpd,
            "vb": vb.T,
            "xstart_mse": xstart_mse.T,
            "mse": mse.T,
        }
