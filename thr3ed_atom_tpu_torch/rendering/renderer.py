"""Render configuration and the registry of render procedures.

Counterpart of thr3ed_atom_tpu/rendering/renderer.py. ``SHVoxGridRenderConfig``
carries every field of the JAX package's config, so a checkpoint's JSON written
by either package loads in the other; the knobs of procedures that are not
ported yet are kept and ignored. ``RENDER_PROCEDURES`` holds the procedures
this port serves, the gnomonic shear-warp renderer, the bricked slab-march
renderer and the plane-march renderer; a checkpoint naming another one is
refused by ``get_render_procedure``.
"""
import dataclasses

from thr3ed_atom_tpu_torch.rendering.bricked import render_sh_voxel_grid_bricked
from thr3ed_atom_tpu_torch.rendering.gnomonic import render_sh_voxel_grid_gnomonic
from thr3ed_atom_tpu_torch.rendering.planes import render_sh_voxel_grid_planes
from thr3ed_atom_tpu_torch.utils.camera import CameraBounds


@dataclasses.dataclass(frozen=True)
class SHVoxGridRenderConfig:
    """Static render configuration, field for field the JAX package's. Only the
    fields read by the gnomonic, bricked and plane-march procedures act in this
    port; the rest are carried so that checkpoints round-trip."""

    # probing config:
    num_samples_per_ray: int
    camera_bounds: CameraBounds
    perturb_sampled_points: bool = True
    optimized_sampling: bool = False

    # accumulation config (registry names, not callables):
    density2occupancy: str = "pb"
    radiance_hdr_tone_map: str = "sigmoid"
    stochastic_density_noise_std: float = 0.0
    white_bkgd: bool = False

    # misc render-mode config:
    render_diffuse: bool = False
    render_num_samples_per_ray: int = 1024
    parallel_rays_chunk_size: int = 32768

    # two-phase (fast) renderer: not ported yet
    fast_topk: int = 64
    fast_bf16_features: bool = False
    # also emit the diffuse (degree-0 SH) colour in extra["diffuse_colour"]
    also_render_diffuse: bool = False
    fast_pack_features: bool = True

    # bricked (slab-march) renderer (rendering/bricked.py): per-tile early-exit
    # transmittance threshold (0 disables), the occupancy skip's per-sample
    # alpha threshold (0 disables; training always uses 0), the pixel tile
    # edge (8 or 16; 0 = 16 up to 160 vertices a side, else 8) and K samples
    # per cell along the march axis (divides 4; 0 = about 256 samples across
    # the grid). The plane-march renderer (rendering/planes.py) reads the
    # first three (its AUTO tile edge: 16 up to 128 vertices a side) and its
    # positions per cell (1, 2, 4 or 8; 0 = about 256 positions across the grid)
    bricked_exit_eps: float = 1e-4
    bricked_occupancy_alpha_thresh: float = 1e-4
    bricked_tile_px: int = 0
    bricked_axis_supersample: int = 0
    planes_pos_per_cell: int = 0

    # gnomonic shear-warp renderer (rendering/gnomonic.py): positions per cell
    # (0 = AUTO: ~256 positions across the grid, 32^3 -> 8, 128^3 -> 2,
    # 256^3 -> 1) and the texel grid's supersampling over the output image
    gnomonic_pos_per_cell: int = 0
    gnomonic_supersample: float = 1.25
    # final projective warp interpolation: 3 = separable Catmull-Rom (default),
    # 1 = bilinear; 5 (prefiltered B-spline) is not ported yet
    gnomonic_warp_order: int = 3
    # warp implementation: "matmul" (two-pass scanline warp,
    # rendering/warp_matmul.py) or "auto" (= matmul); "gather" is not ported yet
    gnomonic_warp_impl: str = "auto"
    # early-exit threshold on transmittance (0 disables; the CUDA kernel exits
    # per texel tile, the JAX kernel per 128 x 128 block)
    gnomonic_exit_eps: float = 1e-4
    # q-block width of the occupancy flags (texels, multiple of 128) of the
    # fused pipeline; 0 selects the v2 stripe pipeline (whole-height stripes)
    gnomonic_qb: int = 128

    def replace(self, **overrides) -> "SHVoxGridRenderConfig":
        return dataclasses.replace(self, **overrides)


RENDER_PROCEDURES = {
    "render_sh_voxel_grid_gnomonic": render_sh_voxel_grid_gnomonic,
    "render_sh_voxel_grid_bricked": render_sh_voxel_grid_bricked,
    "render_sh_voxel_grid_planes": render_sh_voxel_grid_planes,
}

# the JAX package's other procedures: not ported yet
_NOT_PORTED = (
    "render_sh_voxel_grid",
    "render_sh_voxel_grid_fast",
    "render_sh_voxel_grid_hierarchical",
)


def get_render_procedure(name: str):
    if name in RENDER_PROCEDURES:
        return RENDER_PROCEDURES[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"render procedure '{name}' is not ported yet (ROADMAP.md, "
            "'Modules to port', items 3 and 8); only "
            f"{sorted(RENDER_PROCEDURES)} are"
        )
    raise ValueError(f"unknown render procedure '{name}'")
