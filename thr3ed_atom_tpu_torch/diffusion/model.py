"""3inFusion: 3-D diffusion over voxel-grid crops of a reconstructed scene
(counterpart of thr3ed_atom_tpu/diffusion/model.py).

The training grid is channels-last ([W, D, H, 1 + F]: density ++ features),
normalized per channel group to [-1, 1]. A train step draws its crop
offsets, timesteps and noise in one function (``draw_train_step``, from the
step's generator; a caller may patch it with another source's draws), crops
the batch, and takes one Adam step (optax's b1, b2, eps) on the diffusion
loss. Sampling runs the reverse process one grid at a time and renders each
sampled grid through the scene's own render procedure into a mosaic GIF.
Checkpoints are the JAX package's: ``<path>.npz`` holds the flax parameter
leaves ``param_i`` in ``jax.tree_util`` order, ``<path>.json`` the UNet and
diffusion config and the normalization ranges; either package loads the
other's. The scalar ``loss`` goes to ``tensorboard_logs/summaries.jsonl``
and to a TensorBoard event file beside it (utils/tensorboard.py). The whole path runs in
true f32 (no TF32), as the JAX package's reference does, unless the UNet
computes in half precision (``UNetModel(use_fp16=True)``): the step then
trains as ADM's ``fp16_util.MixedPrecisionTrainer`` does (Dhariwal & Nichol,
guided-diffusion): the f32 parameters are the master weights, the loss is
scaled by 2 ** ``lg_loss_scale`` before the backward, the gradients'
norm is checked (one host sync), and a non-finite norm halves the scale and
skips the step; else the gradients are unscaled, Adam steps, the EMA (if
``ema_rate``) follows and the scale grows by ``FP16_SCALE_GROWTH`` in log2.
The scale starts at 2 ** ``INITIAL_LG_LOSS_SCALE``; both are ADM's.
Training runs the UNet with dropout on (``deterministic=False``); sampling
and the bits-per-dim loop stay deterministic. Spans (utils/profiling.py):
``t3.step`` around a train step, its phases ``t3.forward`` (UNet and loss),
``t3.backward`` and ``t3.optimizer`` (the loss scale's check, Adam, EMA),
and ``t3.skip`` once on each skipped step.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from thr3ed_atom_tpu_torch.diffusion.gaussian_diffusion import GaussianDiffusion
from thr3ed_atom_tpu_torch.diffusion.timestep_sampler import UniformSampler
from thr3ed_atom_tpu_torch.diffusion.unet import (
    UNetModel,
    flax_leaves,
    flax_params,
    flax_unflatten,
    load_flax_params,
)
from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid, VoxelSize, resolve_device
from thr3ed_atom_tpu_torch.modules.trainer import SummaryLog
from thr3ed_atom_tpu_torch.modules.volumetric_model import (
    VolumetricModel,
    create_volumetric_model_from_saved_model,
)
from thr3ed_atom_tpu_torch.rendering.rays import (
    compute_expected_density_scale_for_relu_field_grid,
)
from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
from thr3ed_atom_tpu_torch.utils.camera import (
    CameraBounds,
    CameraIntrinsics,
    get_thre360_animation_poses,
)
from thr3ed_atom_tpu_torch.utils.constants import CAMERA_INTRINSICS, HEMISPHERICAL_RADIUS
from thr3ed_atom_tpu_torch.utils.logging import log
from thr3ed_atom_tpu_torch.utils.profiling import span

# MixedPrecisionTrainer's loss scale: 2 ** 20 to start, + 1e-3 in log2 a step
INITIAL_LG_LOSS_SCALE = 20.0
FP16_SCALE_GROWTH = 1e-3


def strict_f32() -> None:
    """True f32 convolutions and products (no TF32): the reference is f32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def crop_offsets(generator: Optional[torch.Generator], dims: Sequence[int],
                 crop_size: Sequence[int], batch_size: int, device=None) -> torch.Tensor:
    """[B, 3] crop offsets, each axis drawn in [0, max(d - c, 1)) (the last
    offset is never drawn, as in the JAX package)."""
    if device is None and generator is not None:
        device = generator.device
    cols = [torch.randint(0, max(d - c, 1), (batch_size,), generator=generator, device=device)
            for d, c in zip(dims, crop_size)]
    return torch.stack(cols, dim=1)


def crop_batch(grid: torch.Tensor, offsets: torch.Tensor, crop_size: Sequence[int]
               ) -> torch.Tensor:
    """[W, D, H, C] and [B, 3] offsets -> [B, cw, cd, ch, C]; offsets are
    clamped into the grid as ``lax.dynamic_slice`` clamps them."""
    crops = []
    for offset in offsets.tolist():
        o = [min(max(int(v), 0), d - c) for v, d, c in zip(offset, grid.shape[:3], crop_size)]
        crops.append(grid[o[0]:o[0] + crop_size[0], o[1]:o[1] + crop_size[1],
                          o[2]:o[2] + crop_size[2]])
    return torch.stack(crops)


def random_crop_3d_batch(generator: Optional[torch.Generator], grid: torch.Tensor,
                         crop_size: Tuple[int, int, int], batch_size: int) -> torch.Tensor:
    """[W, D, H, C] -> [B, cw, cd, ch, C] random crops."""
    offsets = crop_offsets(generator, grid.shape[:3], crop_size, batch_size, grid.device)
    return crop_batch(grid, offsets, crop_size)


def normalize_grid(grid: torch.Tensor) -> Tuple[torch.Tensor, Tuple[float, float],
                                                Tuple[float, float]]:
    """[..., 1 + F] -> the grid normalized per channel group (density,
    features) to [-1, 1], and the two groups' (min, max)."""
    densities, features = grid[..., :1], grid[..., 1:]
    d_range = (float(densities.min()), float(densities.max()))
    f_range = (float(features.min()), float(features.max()))
    densities = (densities - d_range[0]) / max(d_range[1] - d_range[0], 1e-12)
    features = (features - f_range[0]) / max(f_range[1] - f_range[0], 1e-12)
    return torch.cat([densities, features], dim=-1) * 2.0 - 1.0, d_range, f_range


def training_crop_side(full_grid_size: Sequence[int], crop_ratio: float, levels: int) -> int:
    """The crop side holding ``crop_ratio`` of the grid's voxels, rounded down
    to the UNet's resolution granularity 2^(levels - 1) (spatial dims must
    divide by it for the skip concatenations to line up)."""
    crop_voxels = float(np.prod(full_grid_size)) * crop_ratio
    crop_size = int(np.ceil(crop_voxels ** (1.0 / 3.0)))
    crop_size = min(crop_size, *full_grid_size)
    granularity = 2 ** (levels - 1)
    return max((crop_size // granularity) * granularity, granularity)


class StepDraws(NamedTuple):
    """What one train step draws: crop offsets [B, 3], timesteps [B], noise
    [B, cw, cd, ch, C]."""

    offsets: torch.Tensor
    timesteps: torch.Tensor
    noise: torch.Tensor


def draw_train_step(generator: torch.Generator, grid_shape: Sequence[int],
                    crop_size: Sequence[int], batch_size: int,
                    timestep_p: torch.Tensor) -> StepDraws:
    """A train step's draws from its generator (on the generator's device)."""
    dev = generator.device
    offsets = crop_offsets(generator, grid_shape[:3], crop_size, batch_size, dev)
    timesteps = torch.multinomial(timestep_p.to(dev), batch_size, replacement=True,
                                  generator=generator)
    noise = torch.randn((batch_size, *crop_size, grid_shape[-1]), generator=generator,
                        device=dev)
    return StepDraws(offsets, timesteps, noise)


class Thre3inFusionModel:
    """UNet + diffusion over a scene's voxel grid on one device (None: the
    CUDA card); trains on random 3D crops and samples full grids that
    deserialize back into renderable VolumetricModels. ``ema_rate`` keeps an
    EMA of the parameters (None: none); a half-precision UNet trains under
    the dynamic loss scale, as the module says."""

    def __init__(self, unet: UNetModel, diffusion: GaussianDiffusion, device=None,
                 ema_rate: Optional[float] = None):
        self.device = resolve_device(device)
        self.unet = unet.to(self.device)
        self.diffusion = diffusion
        self._params_set = False
        self.ema_rate = ema_rate
        self.ema: Optional[List[torch.Tensor]] = None  # by unet.parameters()
        self.lg_loss_scale = INITIAL_LG_LOSS_SCALE if unet.use_fp16 else None
        self.took_step = True  # whether the last train step stepped

        self.density_scale_range: Tuple[float, float] = (1.0, 1.0)
        self.features_scale_range: Tuple[float, float] = (1.0, 1.0)

        # defaults, overwritten by train() from the loaded scene
        self.render_procedure_name = "render_sh_voxel_grid"
        self.render_config = SHVoxGridRenderConfig(
            num_samples_per_ray=256,
            camera_bounds=CameraBounds(near=4.5, far=19.5),
            white_bkgd=True,
        )
        self.voxel_size = VoxelSize(0.078125, 0.078125, 0.078125)
        self.hemispherical_radius = 12.0
        self.camera_pitch = 45.0
        self.camera_intrinsics = CameraIntrinsics(512, 512, 512.0)
        self.vox_grid_density_activations = {
            "density_preactivation": "identity",
            "density_postactivation": "softplus",
            "expected_density_scale": compute_expected_density_scale_for_relu_field_grid(
                (10.0, 10.0, 5.0)),
        }

    # ------------------------------------------------------------------ init/apply

    @property
    def params(self) -> Optional[Dict[str, Any]]:
        """The UNet's parameters as the JAX package's flax tree (numpy), or
        None before they were initialised, loaded or set."""
        return flax_params(self.unet) if self._params_set else None

    @params.setter
    def params(self, variables: Dict[str, Any]) -> None:
        load_flax_params(self.unet, variables)
        self._params_set = True

    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """Initialise the UNet as flax does, from ``generator``."""
        fresh = UNetModel(**self.unet.config(), generator=generator)
        self.unet.load_state_dict(fresh.state_dict())
        self._params_set = True

    def model_fn(self):
        """The diffusion's model function (x, t) -> output: the UNet itself."""
        return self.unet

    def _train_model_fn(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The model function of training: the UNet with dropout on."""
        return self.unet(x, t, deterministic=False)

    # ------------------------------------------------------------------ serialization

    @staticmethod
    def serialize_vol_mod_to_tensor_grid(vol_mod: VolumetricModel) -> torch.Tensor:
        """VoxelGrid -> [1, W, D, H, 1+F] channels-last."""
        grid = vol_mod.thre3d_repr
        return torch.cat([grid.densities.detach(), grid.features.detach()], dim=-1)[None]

    def deserialize_tensor_grid_to_vol_mod(self, grid: torch.Tensor) -> VolumetricModel:
        """[1, W, D, H, 1+F] -> renderable VolumetricModel on this model's device."""
        serialized = grid[0]
        voxel_grid = VoxelGrid(
            densities=serialized[..., :1].contiguous(),
            features=serialized[..., 1:].contiguous(),
            voxel_size=self.voxel_size,
            **self.vox_grid_density_activations,
        )
        return VolumetricModel(
            thre3d_repr=voxel_grid,
            render_procedure=self.render_procedure_name,
            render_config=self.render_config,
            device=self.device,
        )

    def scale_tensor_grids(self, grids: torch.Tensor) -> torch.Tensor:
        """Invert the per-channel-group [-1, 1] normalization."""
        grids = grids * 0.5 + 0.5
        densities, features = grids[..., :1], grids[..., 1:]
        d_lo, d_hi = self.density_scale_range
        f_lo, f_hi = self.features_scale_range
        densities = densities * (d_hi - d_lo) + d_lo
        features = features * (f_hi - f_lo) + f_lo
        return torch.cat([densities, features], dim=-1)

    # ------------------------------------------------------------------ sampling

    def sample(self, shape: Tuple[int, int, int], num_samples: int = 1,
               generator: Optional[torch.Generator] = None,
               max_iter: Optional[int] = None) -> torch.Tensor:
        """[num_samples, *shape, C] grids from the reverse process (x_T and
        every step's noise drawn from ``generator``; None: seed 0)."""
        strict_f32()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        full_shape = (num_samples, *shape, self.unet.in_channels)
        log.info(f"sampling {num_samples} grids from the diffusion model ...")
        return self.diffusion.p_sample_loop(self.model_fn(), full_shape, generator,
                                            clip_denoised=True, max_iter=max_iter,
                                            device=self.device)

    def visualize_samples_mosaic(
        self,
        shape: Tuple[int, int, int],
        num_samples: int,
        save_path: Path,
        num_frames: int = 120,
        fps: float = 60.0,
        generator: Optional[torch.Generator] = None,
        render_scale_factor: Optional[float] = 0.25,
        max_iter: Optional[int] = None,
    ) -> Path:
        """Sample grids -> per-sample thre360 videos -> a square mosaic GIF
        beside ``save_path``; returns the path written."""
        from thr3ed_atom_tpu_torch.visualizations.animations import (
            render_camera_path_for_volumetric_model,
        )
        from thr3ed_atom_tpu_torch.visualizations.video import write_video

        # one grid at a time: a batched reverse process over full-resolution
        # grids holds batch x the whole UNet's activations
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        samples = torch.cat([self.sample(shape, 1, generator=generator, max_iter=max_iter)
                             for _ in range(num_samples)])
        samples = self.scale_tensor_grids(samples)

        videos = []
        log.info("Rendering videos for each sample ...")
        for i in range(num_samples):
            vol_mod = self.deserialize_tensor_grid_to_vol_mod(samples[i:i + 1])
            camera_path = get_thre360_animation_poses(
                hemispherical_radius=self.hemispherical_radius,
                camera_pitch=self.camera_pitch,
                num_poses=num_frames,
            )
            videos.append(render_camera_path_for_volumetric_model(
                vol_mod, camera_path, self.camera_intrinsics,
                render_scale_factor=render_scale_factor, verbose=False))

        videos = np.stack(videos)  # [N, T, H, W3, 3]
        ncols = int(np.ceil(np.sqrt(num_samples)))
        nrows = int(np.ceil(num_samples / ncols))
        pad = ncols * nrows - num_samples
        if pad:
            videos = np.concatenate([videos, np.zeros((pad, *videos.shape[1:]), videos.dtype)])
        T, H, W, C = videos.shape[1:]
        mosaic = (videos.reshape(nrows, ncols, T, H, W, C)
                  .transpose(2, 0, 3, 1, 4, 5)
                  .reshape(T, nrows * H, ncols * W, C))
        return write_video(save_path, mosaic, fps=fps)

    # ------------------------------------------------------------------ io

    def save_model(self, save_path: Path) -> None:
        """Flat npz of the flax parameter leaves + JSON of the UNet/diffusion config."""
        save_path = Path(save_path)
        save_path.parent.mkdir(parents=True, exist_ok=True)
        leaves = flax_leaves(flax_params(self.unet))
        np.savez(save_path.with_suffix(".npz"),
                 **{f"param_{i}": leaf for i, leaf in enumerate(leaves)})
        unet = self.unet
        meta = {
            "unet_config": {
                "in_channels": unet.in_channels,
                "model_channels": unet.model_channels,
                "out_channels": unet.out_channels,
                "num_res_blocks": unet.num_res_blocks,
                "attention_resolutions": list(unet.attention_resolutions),
                "channel_mult": list(unet.channel_mult),
                "dims": unet.dims,
                "num_heads": unet.num_heads,
                "use_scale_shift_norm": unet.use_scale_shift_norm,
                "use_bottleneck_attn": unet.use_bottleneck_attn,
                "use_checkpoint": unet.use_checkpoint,
                # ADM's options where set (the JAX package's file has none of them)
                **{k: v for k, v, default in (
                    ("num_head_channels", unet.num_head_channels, -1),
                    ("resblock_updown", unet.resblock_updown, False),
                    ("dropout", unet.dropout, 0.0), ("norm_groups", unet.norm_groups, 16),
                    ("use_fp16", unet.use_fp16, False)) if v != default},
            },
            "num_timesteps": self.diffusion.num_timesteps,
            "density_scale_range": list(self.density_scale_range),
            "features_scale_range": list(self.features_scale_range),
            "voxel_size": list(self.voxel_size),
        }
        with open(save_path.with_suffix(".json"), "w") as f:
            json.dump(meta, f, indent=2)

    def load_params(self, save_path: Path) -> None:
        """Read the parameter leaves of ``<save_path>.npz`` (written by either
        package) into the UNet, in the order of its flax tree."""
        template = flax_params(self.unet)
        count = len(flax_leaves(template))
        with np.load(Path(save_path).with_suffix(".npz")) as arrays:
            if len(arrays.files) != count:
                raise ValueError(f"{save_path}: {len(arrays.files)} leaves, the UNet has {count}")
            leaves = [arrays[f"param_{i}"] for i in range(count)]
        self.params = flax_unflatten(template, leaves)

    # ------------------------------------------------------------------ training

    def train_step(self, optimizer: torch.optim.Optimizer, batch: torch.Tensor,
                   timesteps: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """One optimizer step on the mean diffusion loss of ``batch`` (a half-
        precision UNet's under the loss scale; ``took_step`` says whether it
        stepped); returns the loss. The unscaled gradients stay in ``.grad``
        until the next step."""
        with span("step"):
            optimizer.zero_grad(set_to_none=True)
            if self.ema_rate is not None and self.ema is None:
                self.ema = [p.detach().clone() for p in self.unet.parameters()]
            with span("forward"):
                terms = self.diffusion.training_losses(self._train_model_fn, batch, timesteps,
                                                       noise=noise)
                loss = terms["loss"].mean()
            with span("backward"):
                if self.lg_loss_scale is None:
                    loss.backward()
                else:
                    (loss * 2.0 ** self.lg_loss_scale).backward()
            with span("optimizer"):
                self.took_step = self._optimize(optimizer)
        return loss.detach()

    def _optimize(self, optimizer: torch.optim.Optimizer) -> bool:
        """MixedPrecisionTrainer.optimize's policy where a loss scale is kept,
        then the step and the EMA; False when the step was skipped."""
        if self.lg_loss_scale is not None:
            grads = [p.grad for p in self.unet.parameters() if p.grad is not None]
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            if not math.isfinite(float(norm)):  # the step's one host sync
                self.lg_loss_scale -= 1.0
                with span("skip"):
                    log.info(f"non-finite gradient: lg_loss_scale -> {self.lg_loss_scale}")
                return False
            torch._foreach_mul_(grads, 1.0 / 2.0 ** self.lg_loss_scale)
        optimizer.step()
        if self.ema is not None:
            params = [p.detach() for p in self.unet.parameters()]
            torch._foreach_mul_(self.ema, self.ema_rate)
            torch._foreach_add_(self.ema, params, alpha=1.0 - self.ema_rate)
        if self.lg_loss_scale is not None:
            self.lg_loss_scale += FP16_SCALE_GROWTH
        return True

    def save_ema(self, save_path: Path) -> None:
        """``save_model`` of the EMA's parameters (the UNet's own are put back)."""
        params = [p.detach() for p in self.unet.parameters()]
        own = [p.clone() for p in params]
        with torch.no_grad():
            torch._foreach_copy_(params, self.ema)
            try:
                self.save_model(save_path)
            finally:
                torch._foreach_copy_(params, own)

    def train(
        self,
        volume_model_path: Path,
        output_path: Path,
        crop_ratio: float = 0.95,
        num_iters: int = 100_000,
        batch_size: int = 8,
        learning_rate: float = 3e-4,
        loss_feedback_frequency: int = 50,
        sample_frequency: int = 500,
        save_frequency: int = 1000,
        seed: int = 42,
        visualization_samples: int = 9,
    ) -> "Thre3inFusionModel":
        """The crop-diffusion training loop."""
        strict_f32()
        output_path = Path(output_path)
        vol_mod, extra_info = create_volumetric_model_from_saved_model(volume_model_path,
                                                                       device=self.device)

        # adopt the scene's render setup
        self.render_config = vol_mod.render_config
        self.render_procedure_name = vol_mod.render_procedure_name
        self.voxel_size = vol_mod.thre3d_repr.voxel_size
        self.vox_grid_density_activations = {
            "density_preactivation": vol_mod.thre3d_repr.density_preactivation,
            "density_postactivation": vol_mod.thre3d_repr.density_postactivation,
            "expected_density_scale": vol_mod.thre3d_repr.expected_density_scale,
        }
        if HEMISPHERICAL_RADIUS in extra_info:
            self.hemispherical_radius = extra_info[HEMISPHERICAL_RADIUS]
        if CAMERA_INTRINSICS in extra_info:
            h, w, f = extra_info[CAMERA_INTRINSICS]
            self.camera_intrinsics = CameraIntrinsics(int(h), int(w), float(f))

        # normalize the grid per channel group to [-1, 1]
        training_grid, self.density_scale_range, self.features_scale_range = normalize_grid(
            self.serialize_vol_mod_to_tensor_grid(vol_mod)[0])  # [W, D, H, C]
        del vol_mod
        full_grid_size = tuple(training_grid.shape[:3])
        training_crop_size = (training_crop_side(full_grid_size, crop_ratio,
                                                 len(self.unet.channel_mult)),) * 3
        log.info(f"Full grid size: {full_grid_size}; crop size: {training_crop_size}")

        if not self._params_set:
            self.init_params(torch.Generator().manual_seed(seed))
        generator = torch.Generator(device=self.device).manual_seed(seed)

        optimizer = torch.optim.Adam(self.unet.parameters(), lr=learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)
        timestep_p = UniformSampler(self.diffusion).probabilities(self.device)

        model_dir = output_path / "saved_models"
        sample_dir = output_path / "generated_samples"
        tensorboard_dir = output_path / "tensorboard_logs"
        for directory in (model_dir, sample_dir, tensorboard_dir):
            directory.mkdir(parents=True, exist_ok=True)
        summaries = SummaryLog(tensorboard_dir / "summaries.jsonl", event_dir=tensorboard_dir)

        log.info("Training the 3inFusion model ...")
        for step in range(1, num_iters + 1):
            draws = draw_train_step(generator, tuple(training_grid.shape), training_crop_size,
                                    batch_size, timestep_p)
            batch = crop_batch(training_grid, draws.offsets, training_crop_size)
            loss = self.train_step(optimizer, batch, draws.timesteps, draws.noise)
            del batch, draws

            if step % loss_feedback_frequency == 0:
                loss_value = float(loss)
                summaries.add_scalar("loss", loss_value, step)
                log.info(f"Step {step}/{num_iters}: loss = {loss_value:.4f}")

            # save BEFORE sampling so a visualization failure never loses the model
            if step % save_frequency == 0:
                log.info("Saving the model ...")
                self.save_model(model_dir / f"model_{step}")
                if self.ema is not None:
                    self.save_ema(model_dir / f"ema_{step}")

            if step % sample_frequency == 0:
                log.info("Creating intermediate samples for visualization ...")
                try:
                    self.visualize_samples_mosaic(
                        shape=full_grid_size,
                        num_samples=visualization_samples,
                        save_path=sample_dir / f"samples_{step}.mp4",
                        num_frames=60,
                        fps=24,
                        generator=generator,
                    )
                except Exception as error:  # visualization is best-effort
                    log.info(f"sample visualization failed ({type(error).__name__}: {error}); "
                             "continuing training", exc_info=True)

        self.save_model(model_dir / "model_final")
        if self.ema is not None:
            self.save_ema(model_dir / "ema_final")
        return self
