"""3inFusion training CLI of the port: train the diffusion UNet on random 3-D
crops of a trained scene's voxel grid on the CUDA card.

    python -m thr3ed_atom_tpu_torch.apps.train_thre3infusion -i <model> -o <out> ...

The JAX package's apps/train_thre3infusion.py with the same option names and
defaults (argparse instead of click; a boolean option takes true/false, 1/0,
yes/no, on/off) and the same recipe: a 3-D UNet (channel mult (1, 2, 4, 8),
bottleneck attention, scale-shift norm), a EPSILON / FIXED_SMALL / MSE
diffusion. The UNet's input and output width is the scene's: density plus
every SH feature channel. Checkpoints (``saved_models/model_<step>``) load
in either package; the sample mosaics are GIFs (``generated_samples/``).
``main(argv, device="cpu")`` runs on the CPU (tests); without ``device``
everything runs on the card.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

from thr3ed_atom_tpu_torch.apps.train_sh_voxel_grid import str2bool
from thr3ed_atom_tpu_torch.diffusion.gaussian_diffusion import (
    GaussianDiffusion,
    LossType,
    ModelMeanType,
    ModelVarType,
    get_named_beta_schedule,
)
from thr3ed_atom_tpu_torch.diffusion.model import Thre3inFusionModel
from thr3ed_atom_tpu_torch.diffusion.unet import UNetModel
from thr3ed_atom_tpu_torch.modules.volumetric_model import (
    create_volumetric_model_from_saved_model,
)
from thr3ed_atom_tpu_torch.utils.logging import log


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m thr3ed_atom_tpu_torch.apps.train_thre3infusion",
        description="Train 3inFusion on crops of a trained scene (PyTorch/CUDA port).",
    )
    add = p.add_argument
    add("-i", "--model_path", required=True,
        help="path to the trained VolumetricModel checkpoint (.npz/.json pair)")
    add("-o", "--output_path", required=True, help="path for training output")
    add("--model_channels", type=int, default=32)
    add("--num_res_blocks", type=int, default=1)
    add("--num_heads", type=int, default=4)
    add("--num_timesteps", type=int, default=500)
    add("--beta_schedule", choices=("linear", "cosine"), default="cosine")
    add("--num_iters", type=int, default=100_000)
    add("--batch_size", type=int, default=32)
    add("--learning_rate", type=float, default=8e-5)
    add("--crop_ratio", type=float, default=0.8)
    add("--loss_feedback_frequency", type=int, default=50)
    add("--sample_frequency", type=int, default=5000)
    add("--save_frequency", type=int, default=5000)
    add("--use_checkpoint", type=str2bool, default=True,
        help="gradient checkpointing (torch.utils.checkpoint) in the UNet resblocks")
    add("--visualization_samples", type=int, default=9,
        help="number of grids sampled (sequentially) for the periodic mosaic video")
    return p


def main(argv: Optional[Sequence[str]] = None, device=None) -> Thre3inFusionModel:
    """Parse ``argv`` (sys.argv[1:] when None) and train on ``device`` (None:
    the CUDA card). Returns the trained model."""
    config = vars(build_parser().parse_args(argv))
    # the UNet's width adapts to the loaded scene: density + all SH feature channels
    vol_mod, _ = create_volumetric_model_from_saved_model(Path(config["model_path"]),
                                                          device="cpu")
    grid_channels = 1 + vol_mod.thre3d_repr.num_features
    del vol_mod
    log.info(f"scene grid has {grid_channels} channels (density + SH features)")

    unet = UNetModel(
        in_channels=grid_channels,
        model_channels=config["model_channels"],
        out_channels=grid_channels,
        num_res_blocks=config["num_res_blocks"],
        attention_resolutions=(),
        use_bottleneck_attn=True,
        channel_mult=(1, 2, 4, 8),
        conv_resample=True,
        dims=3,
        num_classes=None,
        use_checkpoint=config["use_checkpoint"],
        num_heads=config["num_heads"],
        num_head_channels=-1,
        use_scale_shift_norm=True,
        resblock_updown=False,
    )
    log.info("UNet model has been created ...")

    diffusion = GaussianDiffusion(
        betas=get_named_beta_schedule(
            schedule_name=config["beta_schedule"],
            num_diffusion_timesteps=config["num_timesteps"],
        ),
        model_mean_type=ModelMeanType.EPSILON,
        model_var_type=ModelVarType.FIXED_SMALL,
        loss_type=LossType.MSE,
        rescale_timesteps=False,
    )

    model = Thre3inFusionModel(unet=unet, diffusion=diffusion, device=device)
    return model.train(
        volume_model_path=Path(config["model_path"]),
        output_path=Path(config["output_path"]),
        num_iters=config["num_iters"],
        learning_rate=config["learning_rate"],
        crop_ratio=config["crop_ratio"],
        batch_size=config["batch_size"],
        loss_feedback_frequency=config["loss_feedback_frequency"],
        sample_frequency=config["sample_frequency"],
        save_frequency=config["save_frequency"],
        visualization_samples=config["visualization_samples"],
    )


if __name__ == "__main__":
    main()
