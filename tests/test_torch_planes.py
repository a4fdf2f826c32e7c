"""The PyTorch port's plane-march procedure against the JAX package: the
position repack and its gradient, the occupancy mip, the ray records, the
traversal tables, the whole-image render and the model facade with
checkpoints in both directions.

CPU tests at tests/test_planes.py's sizes (a 16^3 grid, SH degree 2, 32 x 32
images): the JAX side runs its Pallas kernel in interpret mode, the port its
plain versions. Grids are made from seeds with numpy and cross over
unchanged; each test states its tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gnomonic import _one_torch_thread  # noqa: F401
from test_torch_train_ops import _rel_stats
from thr3ed_atom_tpu.models.voxels import VoxelGrid as JaxVoxelGrid, VoxelSize
from thr3ed_atom_tpu.modules import volumetric_model as vm_jax
from thr3ed_atom_tpu.ops.pallas import plane_march as pm_jax
from thr3ed_atom_tpu.rendering import bricked as brj
from thr3ed_atom_tpu.rendering import planes as plj
from thr3ed_atom_tpu.rendering.renderer import SHVoxGridRenderConfig as JaxConfig
from thr3ed_atom_tpu.utils.camera import CameraBounds as JaxBounds
from thr3ed_atom_tpu.utils.camera import CameraIntrinsics as JaxIntrinsics
from thr3ed_atom_tpu_torch.models.voxels import voxel_grid_from_numpy
from thr3ed_atom_tpu_torch.modules import volumetric_model as vm
from thr3ed_atom_tpu_torch.ops import plane_march as pm
from thr3ed_atom_tpu_torch.rendering import planes as plt_
from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
from thr3ed_atom_tpu_torch.utils.camera import CameraBounds, CameraIntrinsics, pose_spherical

PROC = "render_sh_voxel_grid_planes"
GRID, IMG = 16, 32
ACC = "accumulated_weight"


def _grids(dims=(GRID,) * 3, post="identity", sparse=False, seed=0):
    """tests/test_planes.py's grid recipe from a numpy seed: uniform(-1, 1)
    densities and 27 features over a 3-unit cube, expected density scale 20,
    abs pre- / identity post-activation (or identity / relu); ``sparse``
    keeps the density inside a ball of radius GRID / 5 only. As JAX and
    torch grids."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1.0, 1.0, tuple(dims) + (1,)).astype(np.float32)
    f = rng.uniform(-1.0, 1.0, tuple(dims) + (27,)).astype(np.float32)
    if sparse:
        coords = np.stack(np.meshgrid(*[np.arange(n) for n in dims], indexing="ij"), -1)
        dist = np.linalg.norm(coords - (np.asarray(dims) - 1) / 2.0, axis=-1, keepdims=True)
        d = d * (dist < GRID / 5.0).astype(np.float32)
    pre = "abs" if post == "identity" else "identity"
    vs = tuple(3.0 / n for n in dims)
    config = dict(voxel_size=vs, grid_location=(0.0, 0.0, 0.0), density_preactivation=pre,
                  density_postactivation=post, feature_preactivation="identity",
                  feature_postactivation="identity", expected_density_scale=20.0,
                  radiance_transfer_function=None)
    jgrid = JaxVoxelGrid(densities=jnp.asarray(d), features=jnp.asarray(f),
                         voxel_size=VoxelSize(*vs), density_preactivation=pre,
                         density_postactivation=post, expected_density_scale=20.0)
    return jgrid, voxel_grid_from_numpy(d, f, config, device="cpu")


def _statics(jgrid, tgrid, axis, flip, **kw):
    sj = plj.statics_for_grid(jgrid, axis, flip, interpret=True, **kw)
    st = plt_.statics_for_grid(tgrid, axis, flip, **kw)
    assert tuple(sj._asdict()[k] for k in st._fields) == tuple(st)
    return sj, st


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("flip", [False, True])
def test_repack_and_occupancy_match_jax(P, flip):
    """repack_plane_grid (the lerps written in bf16, fraction 0 / 1 taking the
    plane, the flip with the reversed sub order, the interleave, the last
    plane, the pads, the group expansion with one position of overlap) and
    occupancy_mip on a 16 x 14 x 12 grid (u and v padded), for each march
    axis: array-equal."""
    jgrid, tgrid = _grids((16, 14, 12), post="relu")
    for axis in range(3):
        sj, st = _statics(jgrid, tgrid, axis, flip, pos_per_cell=P)
        want = _f32(plj.repack_plane_grid(jgrid, sj))
        got = plt_.repack_plane_grid(tgrid, st)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.float().numpy(), want)
        np.testing.assert_array_equal(plt_.occupancy_mip(tgrid, st).numpy(),
                                      np.asarray(plj.occupancy_mip(jgrid, sj)))


def _tile_rays(statics_j, pose, height, width, focal):
    """The JAX package's tiled rays of a pose (numpy)."""
    rot = jnp.asarray(np.asarray(pose.rotation, np.float32).reshape(3, 3))
    org = jnp.asarray(np.asarray(pose.translation, np.float32).reshape(3))
    tp = statics_j.tile_px
    hp, wp = -(-height // tp) * tp, -(-width // tp) * tp
    ro, rd = brj._tile_image_rays(hp, wp, focal, height, width, rot, org, tp)
    return np.asarray(ro), np.asarray(rd)


@pytest.mark.parametrize("yaw,pitch,P,sparse,exact,size", [
    (30.0, -35.0, 2, False, False, GRID), (120.0, -10.0, 1, False, True, GRID),
    (260.0, -60.0, 2, True, False, GRID), (46.0, -49.5, 1, False, False, 2 * GRID)])
def test_ray_features_and_tables_match_jax(yaw, pitch, P, sparse, exact, size):
    """compute_ray_features on the JAX package's tiled rays: every lane within
    rtol 1e-6 (atol 1e-6; the live range jmin / jmax, quotients of the
    affine coefficients, atol 1e-4). build_tables on the JAX package's ray
    records and occupancy mip: tables, counts and the overflow flag
    array-equal (footprint spans, the splitting into halves and single cells,
    the occupancy skip, a stable sort on the same keys). The sparse grid with
    the serving threshold must skip some groups; the diagonal pose on a 32^3
    grid (a tile's footprint wider than the patch) must split some."""
    jgrid, tgrid = _grids((size,) * 3, sparse=sparse)
    pose = pose_spherical(yaw, pitch, 4.0)
    axis, flip = plt_.dominant_axis_for_pose(np.asarray(pose.rotation))
    sj, st = _statics(jgrid, tgrid, axis, flip, pos_per_cell=P,
                      occupancy_alpha_thresh=1e-4 if sparse else 0.0)
    ro, rd = _tile_rays(sj, pose, IMG, IMG, IMG * 1.1)
    rf_j = plj.compute_ray_features(jnp.asarray(ro), jnp.asarray(rd), sj)
    want = np.asarray(rf_j)
    got = plt_.compute_ray_features(torch.from_numpy(ro), torch.from_numpy(rd), st).numpy()
    assert got.shape == want.shape == (4, 256, 48)
    for lane in range(48):
        atol = 1e-4 if lane in (6, 7) else 1e-6
        np.testing.assert_allclose(got[..., lane], want[..., lane], rtol=1e-6, atol=atol,
                                   err_msg=f"lane {lane}")
    occ = plj.occupancy_mip(jgrid, sj)
    tab_j, cnt_j, ovf_j = plj.build_tables(rf_j, occ, sj, exact_spans=exact)
    tab_t, cnt_t, ovf_t = plt_.build_tables(torch.from_numpy(want),
                                            torch.from_numpy(np.asarray(occ)), st,
                                            exact_spans=exact)
    assert tab_t.dtype == torch.int32 and cnt_t.dtype == torch.int32
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(tab_t.numpy(), np.asarray(tab_j))
    assert ovf_t.dim() == 0 and bool(ovf_t) == bool(ovf_j)
    tab = tab_t.numpy()
    live = np.arange(tab.shape[1])[None, :] < cnt_t.numpy()
    if sparse:
        assert cnt_t.sum() < len(tab) * plt_._geometry(st)[3]
    if size > GRID:
        assert (tab[..., 3][live] != 7).any()  # split entries


def _configs(**kw):
    common = dict(num_samples_per_ray=32, perturb_sampled_points=False,
                  bricked_occupancy_alpha_thresh=0.0, bricked_exit_eps=0.0,
                  planes_pos_per_cell=2)
    common.update(kw)
    return (JaxConfig(camera_bounds=JaxBounds(1.0, 8.0), **common),
            SHVoxGridRenderConfig(camera_bounds=CameraBounds(1.0, 8.0), **common))


def _render_gaps(got, want):
    return (np.abs(got.colour.numpy() - np.asarray(want.colour)).max(),
            np.abs(got.extra[ACC].numpy() - np.asarray(want.extra[ACC])).max(),
            np.abs(got.depth.numpy() - np.asarray(want.depth)).max())


@pytest.mark.parametrize("yaw,pitch", [(30.0, -35.0), (120.0, -10.0), (260.0, -60.0)])
@pytest.mark.parametrize("P", [1, 2])
def test_render_image_matches_jax(yaw, pitch, P):
    """render_image_planes (repack, mip, ray records, tables, the plane
    march's plain version, untiling) against the JAX package's (its kernel
    in interpret mode) at three poses and P = 1, 2. Bound: colour and acc
    3e-3, depth 2e-2 (the port's standing render bounds between the
    packages); the overflow flag equal; the object is hit."""
    jgrid, tgrid = _grids()
    jc, tc = _configs(planes_pos_per_cell=P)
    pose = pose_spherical(yaw, pitch, 4.0)
    want = plj.render_image_planes(jgrid, pose, JaxIntrinsics(IMG, IMG, IMG * 1.1), jc,
                                   interpret=True)
    got = plt_.render_image_planes(tgrid, pose, CameraIntrinsics(IMG, IMG, IMG * 1.1), tc)
    assert got.colour.shape == (IMG, IMG, 3)
    gaps = _render_gaps(got, want)
    print(f"planes render port vs JAX (P={P}): colour/acc/depth max-abs {gaps}")
    assert gaps[0] < 3e-3 and gaps[1] < 3e-3 and gaps[2] < 2e-2
    assert float(got.extra[ACC].max()) > 0.5
    assert bool(got.extra["bricked_tap_overflow"]) == bool(want.extra["bricked_tap_overflow"])


@pytest.mark.parametrize("case", ["relu_white_diffuse", "crop", "sparse_exit"])
def test_render_image_cases_match_jax(case):
    """The relu field with a white background and the diffuse output (75,
    -25), a 37 x 29 image that is no multiple of the tile (33, -20), and the
    sparse grid with the serving occupancy threshold and early exit (210,
    -45), against the JAX package's render: the same bounds as above."""
    if case == "relu_white_diffuse":
        (jgrid, tgrid), kw = _grids(post="relu"), dict(white_bkgd=True,
                                                       also_render_diffuse=True)
        pose, hw = pose_spherical(75.0, -25.0, 4.0), (IMG, IMG)
    elif case == "crop":
        (jgrid, tgrid), kw = _grids(), {}
        pose, hw = pose_spherical(33.0, -20.0, 4.0), (37, 29)
    else:
        (jgrid, tgrid), kw = _grids(sparse=True), dict(bricked_occupancy_alpha_thresh=1e-4,
                                                       bricked_exit_eps=1e-4)
        pose, hw = pose_spherical(210.0, -45.0, 4.0), (IMG, IMG)
    jc, tc = _configs(**kw)
    focal = 40.0 if case == "crop" else IMG * 1.1
    want = plj.render_image_planes(jgrid, pose, JaxIntrinsics(*hw, focal), jc, interpret=True)
    got = plt_.render_image_planes(tgrid, pose, CameraIntrinsics(*hw, focal), tc)
    assert got.colour.shape == hw + (3,)
    gaps = _render_gaps(got, want)
    print(f"planes render port vs JAX ({case}): colour/acc/depth max-abs {gaps}")
    assert gaps[0] < 3e-3 and gaps[1] < 3e-3 and gaps[2] < 2e-2
    if case == "relu_white_diffuse":
        gap = np.abs(got.extra["diffuse_colour"].numpy()
                     - np.asarray(want.extra["diffuse_colour"])).max()
        assert gap < 3e-3, gap


def test_repack_gradient_matches_jax():
    """The gradient of sum(out[..., :4]^2) through repack_plane_grid and the
    plane march's replay VJP (tests/test_planes.py:224-262: 16 x 16 rays of
    pose (120, -30) as one tile, P = 2, no exit, no occupancy skip) against
    the JAX package's: cosine > 0.99995 for the densities and the features
    (the VJP's bf16 roundings of d_interp and the repack's bf16 sums of the
    duplicated boundary positions can round differently where the f32
    values differ by an ulp); both finite and nonzero."""
    jgrid, tgrid = _grids()
    pose = pose_spherical(120.0, -30.0, 4.0)
    axis, flip = plt_.dominant_axis_for_pose(np.asarray(pose.rotation))
    sj, st = _statics(jgrid, tgrid, axis, flip, exit_eps=0.0, occupancy_alpha_thresh=0.0,
                      pos_per_cell=2)
    ro, rd = _tile_rays(sj, pose, 16, 16, 18.0)
    rf = plj.compute_ray_features(jnp.asarray(ro), jnp.asarray(rd), sj)
    tables, counts, _ = plj.build_tables(rf, plj.occupancy_mip(jgrid, sj), sj)
    kw = dict(ncoeff=9, relu_sigma=st.relu_sigma, exit_eps=0.0)

    def loss_j(densities, features):
        g = jgrid.__class__(densities=densities, features=features,
                            voxel_size=jgrid.voxel_size,
                            density_preactivation=jgrid.density_preactivation,
                            density_postactivation=jgrid.density_postactivation,
                            expected_density_scale=jgrid.expected_density_scale)
        out = pm_jax.plane_march(tables, counts, rf, plj.repack_plane_grid(g, sj),
                                 interpret=True, **kw)
        return jnp.sum(out[..., :4] ** 2)

    gd_j, gf_j = jax.grad(loss_j, argnums=(0, 1))(jgrid.densities, jgrid.features)
    tgrid.densities.requires_grad_(True)
    tgrid.features.requires_grad_(True)
    out = pm.plane_march(*(torch.from_numpy(np.asarray(x)) for x in (tables, counts, rf)),
                         plt_.repack_plane_grid(tgrid, st), plain=True, **kw)
    (out[..., :4] ** 2).sum().backward()
    for name, got, want in (("densities", tgrid.densities.grad, gd_j),
                            ("features", tgrid.features.grad, gf_j)):
        got, want = got.numpy(), np.asarray(want, np.float32)
        p999, cos = _rel_stats(got, want)
        print(f"planes repack gradient {name}: cosine {cos:.9f}, p999 {p999:.3g}")
        assert np.isfinite(got).all() and np.abs(got).max() > 0.0
        assert cos > 0.99995, (name, cos)


def test_volumetric_model_and_checkpoints_both_ways(tmp_path):
    """VolumetricModel with the planes procedure: render_poses (a per-pose
    loop sharing each variant's repack) equals render per pose and the JAX
    model's render within the render bound; a checkpoint the port writes
    loads in the JAX package with the procedure's name, and the reverse;
    flat ray batches through the procedure equal the fast renderer's."""
    jgrid, tgrid = _grids(post="relu")
    jc, tc = _configs(white_bkgd=True)
    tmodel = vm.VolumetricModel(tgrid, PROC, tc, device="cpu")
    poses = [pose_spherical(30.0, -35.0, 4.0), pose_spherical(35.0, -30.0, 4.0),
             pose_spherical(200.0, -70.0, 4.0)]
    intr = CameraIntrinsics(IMG, IMG, IMG * 1.1)
    out = tmodel.render_poses(poses, intr)
    assert out.colour.shape == (3, IMG, IMG, 3)
    assert len([k for k in tmodel._image_render_cache if k[0] == "planes"]) == 2
    one = tmodel.render(poses[2], intr)
    np.testing.assert_array_equal(out.colour[2].numpy(), one.colour.numpy())
    tmodel.save(tmp_path / "port_model")
    jmodel, _ = vm_jax.create_volumetric_model_from_saved_model(tmp_path / "port_model")
    assert jmodel.render_procedure_name == PROC
    want = jmodel.render(poses[0], JaxIntrinsics(IMG, IMG, IMG * 1.1))
    assert np.abs(out.colour[0].numpy() - np.asarray(want.colour)).max() < 3e-3
    vm_jax.VolumetricModel(jgrid, PROC, jc).save(tmp_path / "jax_model")
    loaded, _ = vm.create_volumetric_model_from_saved_model(tmp_path / "jax_model",
                                                            device="cpu")
    assert loaded.render_procedure_name == PROC
    again = loaded.render(poses[0], intr)
    np.testing.assert_array_equal(again.colour.numpy(), out.colour[0].numpy())
    # flat ray batches go to the fast renderer, as the JAX package routes them
    from thr3ed_atom_tpu_torch.rendering import rays as rays_mod
    from thr3ed_atom_tpu_torch.rendering.fast_renderer import render_sh_voxel_grid_fast

    flat = rays_mod.flatten_rays(rays_mod.cast_rays(intr, poses[0], device="cpu"))
    config = loaded.render_config.replace(perturb_sampled_points=False)
    torch.testing.assert_close(
        loaded.render_procedure(loaded.thre3d_repr, flat, config).colour,
        render_sh_voxel_grid_fast(loaded.thre3d_repr, flat, config).colour, rtol=0, atol=0)
