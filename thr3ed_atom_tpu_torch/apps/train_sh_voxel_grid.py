"""Training CLI of the port: reconstruct an SH voxel grid from posed images on
the CUDA card.

    python -m thr3ed_atom_tpu_torch.apps.train_sh_voxel_grid -d <data> -o <out> ...

The JAX package's apps/train_sh_voxel_grid.py with the same option names and
defaults (argparse instead of click; a boolean option takes true/false, 1/0,
yes/no, on/off). It reads the same dataset layout and writes checkpoints that
either package loads. ``main(argv, device="cpu")`` runs on the CPU through the
kernels' plain versions (tests); without ``device`` everything runs on the card.

Every procedure of the option trains here: the gnomonic default's
whole-pose steps, ``render_sh_voxel_grid_bricked``'s tile-based slab-march
steps, and ray-batch steps through ``render_sh_voxel_grid_fast``,
``render_sh_voxel_grid`` and ``render_sh_voxel_grid_hierarchical``. What a
kernel cannot take is routed as the JAX package routes it (softplus fields
and SH degree 4 to the fast renderer; ``resolve_render_procedure``).

``--use_mesh true`` trains over a ``torch.distributed`` group, one process a
card: launched by torchrun,

    torchrun --nproc_per_node N -m thr3ed_atom_tpu_torch.apps.train_sh_voxel_grid \
        -d <data> -o <out> --use_mesh true ...

each rank runs on ``cuda:LOCAL_RANK`` under NCCL (gloo with ``device="cpu"``);
launched without torchrun, the group has one rank. Only rank 0 writes.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

import torch

from thr3ed_atom_tpu_torch.data.dataset import PosedImagesDataset
from thr3ed_atom_tpu_torch.models.voxels import (
    VoxelGridLocation,
    VoxelSize,
    create_voxel_grid,
    resolve_device,
)
from thr3ed_atom_tpu_torch.modules.trainer import train_sh_vox_grid_vol_mod_with_posed_images
from thr3ed_atom_tpu_torch.modules.volumetric_model import VolumetricModel
from thr3ed_atom_tpu_torch.rendering.rays import (
    compute_expected_density_scale_for_relu_field_grid,
)
from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
from thr3ed_atom_tpu_torch.utils.constants import NUM_COLOUR_CHANNELS, SEED
from thr3ed_atom_tpu_torch.utils.logging import log
from thr3ed_atom_tpu_torch.utils.misc import log_config_to_disk
from thr3ed_atom_tpu_torch.utils.profiling import profile_trace

PROCEDURES = ("render_sh_voxel_grid_gnomonic", "render_sh_voxel_grid_bricked",
              "render_sh_voxel_grid_fast", "render_sh_voxel_grid",
              "render_sh_voxel_grid_hierarchical")


def resolve_render_procedure(render_procedure: str, sh_degree: int,
                             use_softplus_field: bool) -> str:
    """The procedure to train through, routed around the kernels' limits as
    the JAX package routes it: the march kernels take identity / relu
    density postactivations only, the slab march (bricked) SH degree <= 2
    and the gnomonic pipeline SH degree <= 3. Bricked with softplus fields
    goes to the fast renderer; bricked with SH degree > 2 goes to gnomonic;
    gnomonic with softplus fields or SH degree > 3 goes to the fast
    renderer. Each switch is logged."""
    if render_procedure == "render_sh_voxel_grid_bricked" and (
            sh_degree > 2 or use_softplus_field):
        if use_softplus_field:
            log.info("bricked renderer does not support softplus fields; "
                     "falling back to render_sh_voxel_grid_fast")
            return "render_sh_voxel_grid_fast"
        log.info("bricked renderer supports sh_degree <= 2; using the gnomonic "
                 "shear-warp procedure for sh_degree 3+")
        render_procedure = "render_sh_voxel_grid_gnomonic"
    if render_procedure == "render_sh_voxel_grid_gnomonic" and (
            sh_degree > 3 or use_softplus_field):
        reason = ("softplus fields" if use_softplus_field
                  else f"sh_degree {sh_degree} (supports <= 3)")
        log.info(f"gnomonic renderer does not support {reason}; "
                 "falling back to render_sh_voxel_grid_fast")
        return "render_sh_voxel_grid_fast"
    return render_procedure


def str2bool(text: str) -> bool:
    """click.BOOL's spellings."""
    value = str(text).strip().lower()
    if value in ("1", "true", "t", "yes", "y", "on"):
        return True
    if value in ("0", "false", "f", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"{text!r} is not a valid boolean")


def _at_least_one(text: str) -> float:
    value = float(text)
    if value < 1.0:
        raise argparse.ArgumentTypeError(f"{value} is smaller than the minimum 1.0")
    return value


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m thr3ed_atom_tpu_torch.apps.train_sh_voxel_grid",
        description="Reconstruct an SH voxel grid from posed images (PyTorch/CUDA port).",
    )
    add = p.add_argument
    # required arguments
    add("-d", "--data_path", required=True, help="path to the input dataset")
    add("-o", "--output_path", required=True, help="path for training output")
    # input dataset
    add("--separate_train_test_folders", type=str2bool, default=True)
    add("--data_downsample_factor", type=_at_least_one, default=2.0)
    # voxel grid
    add("--grid_dims", type=int, nargs=3, default=(256, 256, 256))
    add("--grid_location", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    add("--normalize_scene_scale", type=str2bool, default=False)
    add("--grid_world_size", type=float, nargs=3, default=(3.0, 3.0, 3.0))
    add("--sh_degree", type=int, default=2)
    add("--use_relu_field", type=str2bool, default=True)
    add("--use_softplus_field", type=str2bool, default=False)
    # rendering
    add("--render_num_samples_per_ray", type=int, default=1024)
    add("--parallel_rays_chunk_size", type=int, default=32768)
    add("--white_bkgd", type=str2bool, default=True)
    add("--render_procedure", choices=PROCEDURES, default="render_sh_voxel_grid_gnomonic")
    add("--gnomonic_pos_per_cell", type=int, default=0)
    add("--gnomonic_supersample", type=float, default=1.25)
    add("--gnomonic_warp_order", type=int, default=3)
    add("--gnomonic_qb", type=int, default=128,
        help="q-block width (multiple of 128) of the fused pipeline; 0 = the v2 "
             "stripe pipeline (whole-height stripes)")
    add("--gnomonic_poses_per_step", type=int, default=0)
    add("--fast_topk", type=int, default=64)
    add("--fast_bf16_features", type=str2bool, default=False)
    add("--fast_pack_features", type=str2bool, default=True)
    # training
    add("--ray_batch_size", type=int, default=16384)
    add("--train_num_samples_per_ray", type=int, default=512)
    add("--num_stages", type=int, default=4)
    add("--num_iterations_per_stage", type=int, default=7000)
    add("--scale_factor", type=float, default=2.0)
    add("--learning_rate", type=float, default=0.03)
    add("--lr_decay_steps_per_stage", type=int, default=3000)
    add("--lr_decay_gamma_per_stage", type=float, default=0.1)
    add("--stagewise_lr_decay_gamma", type=float, default=1.0)
    add("--apply_diffuse_render_regularization", type=str2bool, default=True)
    add("--use_mesh", type=str2bool, default=False)
    add("--resume_from", default=None)
    # frequencies
    add("--save_frequency", type=int, default=250)
    add("--test_frequency", type=int, default=250)
    add("--feedback_frequency", type=int, default=100)
    add("--summary_frequency", type=int, default=50)
    # miscellaneous modes (--verbose_rendering is taken as the click command
    # takes it; the gnomonic render, one pass per pose, reports no progress)
    add("--verbose_rendering", type=str2bool, default=False)
    add("--fast_debug_mode", type=str2bool, default=False)
    add("--profile_dir", default=None,
        help="write a torch.profiler Chrome trace of the training into this directory")
    return p


def main(argv: Optional[Sequence[str]] = None, device=None) -> VolumetricModel:
    """Parse ``argv`` (sys.argv[1:] when None) and train on ``device`` (None:
    the CUDA card). Returns the trained model."""
    config = vars(build_parser().parse_args(argv))
    config["grid_dims"] = tuple(config["grid_dims"])
    config["grid_location"] = tuple(config["grid_location"])
    config["grid_world_size"] = tuple(config["grid_world_size"])
    formed = False
    if config["use_mesh"]:
        from thr3ed_atom_tpu_torch.parallel.mesh import init_process_group, local_device

        dev = local_device(device)
        formed = init_process_group(device=dev)
    else:
        dev = resolve_device(device)
    try:
        return _train(config, dev)
    finally:
        if formed:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(config, dev: torch.device) -> VolumetricModel:
    data_path = Path(config["data_path"])
    output_path = Path(config["output_path"])
    render_procedure = resolve_render_procedure(
        config["render_procedure"], config["sh_degree"], config["use_softplus_field"])
    import torch.distributed as dist

    if not config["use_mesh"] or dist.get_rank() == 0:
        log.info("logging configuration file ...")
        log_config_to_disk(config, output_path)

    def dataset(images_dir, camera_params_json):
        return PosedImagesDataset(
            images_dir=images_dir,
            camera_params_json=camera_params_json,
            normalize_scene_scale=config["normalize_scene_scale"],
            downsample_factor=config["data_downsample_factor"],
            rgba_white_bkgd=config["white_bkgd"],
        )

    if config["separate_train_test_folders"]:
        train_dataset, test_dataset = (
            dataset(data_path / mode, data_path / f"{mode}_camera_params.json")
            for mode in ("train", "test"))
    else:
        train_dataset = dataset(data_path / "images", data_path / "camera_params.json")
        test_dataset = None

    # density activation mode (terminology from DVGO)
    if config["use_relu_field"]:
        activations = dict(
            density_preactivation="identity", density_postactivation="relu",
            expected_density_scale=compute_expected_density_scale_for_relu_field_grid(
                config["grid_world_size"]))
    elif config["use_softplus_field"]:
        activations = dict(
            density_preactivation="identity", density_postactivation="softplus",
            expected_density_scale=compute_expected_density_scale_for_relu_field_grid(
                config["grid_world_size"]))
    else:
        activations = dict(density_preactivation="abs", density_postactivation="identity",
                           expected_density_scale=1.0)

    grid_dims = config["grid_dims"]
    voxel_size = VoxelSize(
        *[extent / dim for extent, dim in zip(config["grid_world_size"], grid_dims)])
    voxel_grid = create_voxel_grid(
        torch.Generator(device=dev).manual_seed(SEED),
        grid_dims=grid_dims,
        num_features=NUM_COLOUR_CHANNELS * ((config["sh_degree"] + 1) ** 2),
        voxel_size=voxel_size,
        grid_location=VoxelGridLocation(*config["grid_location"]),
        **activations,
    )
    vol_mod = VolumetricModel(
        thre3d_repr=voxel_grid,
        render_procedure=render_procedure,
        render_config=SHVoxGridRenderConfig(
            num_samples_per_ray=config["train_num_samples_per_ray"],
            camera_bounds=train_dataset.camera_bounds,
            white_bkgd=config["white_bkgd"],
            render_num_samples_per_ray=config["render_num_samples_per_ray"],
            parallel_rays_chunk_size=config["parallel_rays_chunk_size"],
            fast_topk=config["fast_topk"],
            fast_bf16_features=config["fast_bf16_features"],
            fast_pack_features=config["fast_pack_features"],
            gnomonic_pos_per_cell=config["gnomonic_pos_per_cell"],
            gnomonic_supersample=config["gnomonic_supersample"],
            gnomonic_warp_order=config["gnomonic_warp_order"],
            gnomonic_qb=config["gnomonic_qb"],
        ),
        device=dev,
    )

    with profile_trace(config["profile_dir"]):
        return train_sh_vox_grid_vol_mod_with_posed_images(
            vol_mod=vol_mod,
            train_dataset=train_dataset,
            output_dir=output_path,
            test_dataset=test_dataset,
            ray_batch_size=config["ray_batch_size"],
            num_stages=config["num_stages"],
            num_iterations_per_stage=config["num_iterations_per_stage"],
            scale_factor=config["scale_factor"],
            learning_rate=config["learning_rate"],
            lr_decay_gamma_per_stage=config["lr_decay_gamma_per_stage"],
            lr_decay_steps_per_stage=config["lr_decay_steps_per_stage"],
            stagewise_lr_decay_gamma=config["stagewise_lr_decay_gamma"],
            save_freq=config["save_frequency"],
            test_freq=config["test_frequency"],
            feedback_freq=config["feedback_frequency"],
            summary_freq=config["summary_frequency"],
            apply_diffuse_render_regularization=config["apply_diffuse_render_regularization"],
            use_mesh=config["use_mesh"],
            fast_debug_mode=config["fast_debug_mode"],
            resume_from=config["resume_from"],
            gnomonic_poses_per_step=config["gnomonic_poses_per_step"],
        )


if __name__ == "__main__":
    main()
