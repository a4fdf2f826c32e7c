"""The PyTorch port's serving slice end to end against the JAX package:
VolumetricModel.render_poses through the gnomonic procedure, checkpoints in
both directions, the camera-path panels, the warp options (order 5, the
gather warp) against the JAX model, and the other procedures: the exact,
fast and hierarchical renderers, and flat ray batches through the
pose-structured procedures, routed to the fast renderer."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thr3ed_atom_tpu.models.voxels import VoxelGrid as JaxVoxelGrid, VoxelSize
from thr3ed_atom_tpu.modules import volumetric_model as vm_jax
from thr3ed_atom_tpu.rendering.renderer import SHVoxGridRenderConfig as JaxConfig
from thr3ed_atom_tpu.utils.camera import CameraBounds as JaxBounds
from thr3ed_atom_tpu_torch.models.voxels import voxel_grid_from_numpy
from thr3ed_atom_tpu_torch.modules import volumetric_model as vm
from thr3ed_atom_tpu_torch.rendering import gnomonic as gn
from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
from thr3ed_atom_tpu_torch.rendering.warp_matmul import warp_swap_for_pose
from thr3ed_atom_tpu_torch.utils.camera import (
    CameraBounds,
    CameraIntrinsics,
    CameraPose,
    pose_spherical,
)
from thr3ed_atom_tpu_torch.visualizations.animations import (
    render_camera_path_for_volumetric_model,
)

H = W = 128
INTR = CameraIntrinsics(H, W, 140.0)
PROC = "render_sh_voxel_grid_gnomonic"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker processes
    at once, and PyTorch's idle OpenMP threads spinning in each of them starve
    the others (the plain path issues many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(size=16, seed=3):
    """Carved relu scene (density -1 outside a ball), numpy from a seed."""
    rng = np.random.default_rng(seed)
    densities = rng.uniform(-2.0, 4.0, (size,) * 3 + (1,)).astype(np.float32)
    coords = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing="ij"), -1)
    dist = np.linalg.norm(coords - (size - 1) / 2, axis=-1, keepdims=True)
    densities = np.where(dist < size / 4, densities, -1.0).astype(np.float32)
    features = (rng.normal(size=(size,) * 3 + (27,)) * 0.4).astype(np.float32)
    config = dict(voxel_size=(2.0 / size,) * 3, grid_location=(0.0, 0.0, 0.0),
                  density_preactivation="identity", density_postactivation="relu",
                  feature_preactivation="identity", feature_postactivation="identity",
                  expected_density_scale=1.0, radiance_transfer_function=None)
    return densities, features, config


def _models(**config_kw):
    d, f, config = _scene()
    kw = dict(num_samples_per_ray=32, white_bkgd=True, **config_kw)
    jgrid = JaxVoxelGrid(densities=jnp.asarray(d), features=jnp.asarray(f),
                         voxel_size=VoxelSize(*config["voxel_size"]),
                         density_preactivation="identity",
                         density_postactivation="relu")
    jmodel = vm_jax.VolumetricModel(
        jgrid, PROC, JaxConfig(camera_bounds=JaxBounds(1.0, 6.0), **kw))
    tmodel = vm.VolumetricModel(
        voxel_grid_from_numpy(d, f, config, device="cpu"), PROC,
        SHVoxGridRenderConfig(camera_bounds=CameraBounds(1.0, 6.0), **kw),
        device="cpu")
    return jmodel, tmodel


def _rolled(pose, roll_deg):
    c, s = np.cos(np.radians(roll_deg)), np.sin(np.radians(roll_deg))
    roll = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    return CameraPose(rotation=np.asarray(pose.rotation) @ roll,
                      translation=pose.translation)


def _poses():
    return [pose_spherical(140.0, -30.0, 3.5), pose_spherical(35.0, -70.0, 3.5),
            _rolled(pose_spherical(140.0, -30.0, 3.5), 75.0),
            pose_spherical(300.0, -10.0, 3.5)]


def test_render_poses_matches_jax():
    """The whole slice (repack, geometry, occupancy, composite, warp) through
    both packages' VolumetricModel.render_poses; poses span three march
    variants and one swapped warp. Bound: colour/acc 3e-3, depth 2e-2
    (tests/test_gnomonic.py's bound between the JAX package's own kernels);
    disparity is left out (1/depth amplifies the depth bound)."""
    poses = _poses()
    variants = {gn.dominant_axis_for_pose(np.asarray(p.rotation)) for p in poses}
    swaps = [warp_swap_for_pose(np.asarray(p.rotation), *gn.dominant_axis_for_pose(
        np.asarray(p.rotation)), H, W, INTR.focal) for p in poses]
    assert len(variants) >= 2 and any(swaps) and not all(swaps)
    jmodel, tmodel = _models()
    want = jmodel.render_poses(poses, INTR)
    got = tmodel.render_poses(poses, INTR)
    assert got.colour.shape == (len(poses), H, W, 3)
    gaps = {
        "colour": np.abs(got.colour.numpy() - np.asarray(want.colour)).max(),
        "acc": np.abs(got.extra["accumulated_weight"].numpy()
                      - np.asarray(want.extra["accumulated_weight"])).max(),
        "depth": np.abs(got.depth.numpy() - np.asarray(want.depth)).max(),
    }
    print(f"render_poses port vs JAX max-abs: {gaps}")
    assert gaps["colour"] < 3e-3 and gaps["acc"] < 3e-3 and gaps["depth"] < 2e-2
    assert float(got.extra["accumulated_weight"].max()) > 0.5
    assert np.isfinite(got.extra["disparity"].numpy()).all()


def test_checkpoints_load_in_both_directions(tmp_path):
    """A checkpoint written by either package loads in the other with equal
    arrays and config, and renders to the same image in the port."""
    jmodel, tmodel = _models(gnomonic_exit_eps=0.0)
    vm_jax.save_model(jmodel, tmp_path / "jax_model", {"hemispherical_radius": 4.0})
    loaded, extra = vm.create_volumetric_model_from_saved_model(
        tmp_path / "jax_model", device="cpu")
    assert extra == {"hemispherical_radius": 4.0}
    assert loaded.render_procedure_name == PROC
    np.testing.assert_array_equal(loaded.thre3d_repr.densities.numpy(),
                                  np.asarray(jmodel.thre3d_repr.densities))
    np.testing.assert_array_equal(loaded.thre3d_repr.features.numpy(),
                                  np.asarray(jmodel.thre3d_repr.features))
    assert dataclasses.asdict(loaded.render_config) == dataclasses.asdict(jmodel.render_config)
    assert loaded.thre3d_repr.get_save_config_dict() == jmodel.thre3d_repr.get_save_config_dict()
    pose = pose_spherical(140.0, -30.0, 3.5)
    intr = CameraIntrinsics(48, 48, 55.0)
    torch.testing.assert_close(loaded.render(pose, intr).colour,
                               tmodel.render(pose, intr).colour, rtol=0, atol=0)

    vm.save_model(tmodel, tmp_path / "torch_model", {"camera_intrinsics": [48, 48, 55.0]})
    back, extra = vm_jax.create_volumetric_model_from_saved_model(tmp_path / "torch_model")
    assert extra == {"camera_intrinsics": [48, 48, 55.0]}
    assert back.render_procedure_name == PROC
    np.testing.assert_array_equal(np.asarray(back.thre3d_repr.features),
                                  tmodel.thre3d_repr.features.numpy())
    assert dataclasses.asdict(back.render_config) == dataclasses.asdict(tmodel.render_config)
    assert back.thre3d_repr.get_save_config_dict() == tmodel.thre3d_repr.get_save_config_dict()


def test_camera_path_panels():
    _, tmodel = _models()
    poses = _poses()[:2]
    frames = render_camera_path_for_volumetric_model(
        tmodel, poses, CameraIntrinsics(32, 32, 35.0))
    assert frames.shape == (2, 32, 96, 3) and frames.dtype == np.uint8
    assert frames[:, :, :32].min() < 200  # the object shows in the colour panel


@pytest.mark.parametrize("override", [
    dict(gnomonic_warp_order=5), dict(gnomonic_warp_impl="gather"),
    dict(gnomonic_qb=0),
])
def test_outside_the_slice_raises(override):
    """The options that were once outside the slice now render. Warp order
    5 and the gather warp match the JAX model's render with the same
    override (colour / acc 3e-3, depth 2e-2, the render bounds);
    ``gnomonic_qb=0`` selects the v2 stripe pipeline: it renders within the
    same bounds of the fused render. An unknown warp form raises."""
    jmodel, tmodel = _models()
    pose, intr = pose_spherical(140.0, -30.0, 3.5), CameraIntrinsics(32, 32, 35.0)
    acc = "accumulated_weight"
    got = tmodel.render(pose, intr, **override)
    if "gnomonic_qb" in override:
        want = tmodel.render(pose, intr)
        want_acc, want_colour, want_depth = (want.extra[acc].numpy(), want.colour.numpy(),
                                             want.depth.numpy())
    else:
        want = jmodel.render(pose, intr, **override)
        want_acc, want_colour, want_depth = (np.asarray(want.extra[acc]),
                                             np.asarray(want.colour), np.asarray(want.depth))
    assert float(want_acc.max()) > 0.5  # the object is in view
    np.testing.assert_allclose(got.colour.numpy(), want_colour, rtol=0, atol=3e-3)
    np.testing.assert_allclose(got.extra[acc].numpy(), want_acc, rtol=0, atol=3e-3)
    np.testing.assert_allclose(got.depth.numpy(), want_depth, rtol=0, atol=2e-2)
    with pytest.raises(ValueError, match="gnomonic_warp_impl"):
        tmodel.render(pose, intr, gnomonic_warp_impl="scatter")


def test_other_procedures_and_flat_rays_raise():
    """Every procedure of the JAX package is ported and constructs: the
    exact, fast and hierarchical renderers render a pose (finite, the object
    in view); an unknown procedure raises. Flat ray batches through the
    gnomonic, bricked and planes procedures no longer raise: each equals the
    fast renderer's render of the same rays, where the JAX package routes
    them."""
    from thr3ed_atom_tpu_torch.rendering import rays as rays_mod
    from thr3ed_atom_tpu_torch.rendering.fast_renderer import render_sh_voxel_grid_fast

    _, tmodel = _models()
    pose, intr = pose_spherical(140.0, -30.0, 3.5), CameraIntrinsics(16, 16, 18.0)
    for name in ("render_sh_voxel_grid", "render_sh_voxel_grid_fast",
                 "render_sh_voxel_grid_hierarchical"):
        other = vm.VolumetricModel(tmodel.thre3d_repr, name, tmodel.render_config,
                                   device="cpu")
        assert other.render_procedure_name == name
        out = other.render(pose, intr)
        assert out.colour.shape == (16, 16, 3) and bool(torch.isfinite(out.colour).all())
        assert float(out.extra["accumulated_weight"].max()) > 0.5
    with pytest.raises(ValueError, match="unknown render procedure"):
        vm.VolumetricModel(tmodel.thre3d_repr, "render_sh_voxel_grid_nerf",
                           tmodel.render_config, device="cpu")
    flat = rays_mod.flatten_rays(rays_mod.cast_rays(intr, pose, device="cpu"))
    config = tmodel.render_config.replace(perturb_sampled_points=False)
    want = render_sh_voxel_grid_fast(tmodel.thre3d_repr, flat, config)
    for name in (PROC, "render_sh_voxel_grid_bricked", "render_sh_voxel_grid_planes"):
        other = vm.VolumetricModel(tmodel.thre3d_repr, name, config, device="cpu")
        got = other.render_procedure(other.thre3d_repr, flat, other.render_config)
        torch.testing.assert_close(got.colour, want.colour, rtol=0, atol=0)
        torch.testing.assert_close(got.depth, want.depth, rtol=0, atol=0)
