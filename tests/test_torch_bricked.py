"""The PyTorch port's bricked (slab-march) procedure against the JAX package:
the slab repack, the occupancy mip, the ray records, the traversal tables,
the whole-image render, the model facade and checkpoints, and the tile-based
train step with one Adam step.

CPU tests on tests/test_torch_gnomonic.py's carved relu scenes (SH degree 2,
12^3-32^3) and 32-48 pixel images: the JAX side runs its Pallas kernels in
interpret mode, the port its plain versions. Inputs are made from seeds with
numpy and cross over unchanged; each test states its tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_gnomonic import _grids, _one_torch_thread, _scene  # noqa: F401
from test_torch_train_ops import _rel_stats
from thr3ed_atom_tpu.models.voxels import VoxelGrid as JaxVoxelGrid, VoxelSize
from thr3ed_atom_tpu.modules import bricked_trainer as btj
from thr3ed_atom_tpu.modules import volumetric_model as vm_jax
from thr3ed_atom_tpu.rendering import bricked as brj
from thr3ed_atom_tpu.rendering.renderer import SHVoxGridRenderConfig as JaxConfig
from thr3ed_atom_tpu.utils.camera import CameraBounds as JaxBounds
from thr3ed_atom_tpu.utils.camera import CameraIntrinsics as JaxIntrinsics
from thr3ed_atom_tpu_torch.models.voxels import voxel_grid_from_numpy
from thr3ed_atom_tpu_torch.modules import bricked_trainer as btt
from thr3ed_atom_tpu_torch.modules import volumetric_model as vm
from thr3ed_atom_tpu_torch.modules.trainer import make_gnomonic_optimizer
from thr3ed_atom_tpu_torch.rendering import bricked as brt
from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
from thr3ed_atom_tpu_torch.utils.camera import CameraBounds, CameraIntrinsics, pose_spherical

PROC = "render_sh_voxel_grid_bricked"
RADIUS = 3.5
ACC = "accumulated_weight"


def _box_grids(dims, seed=5):
    """A relu scene of grid ``dims`` (not cubic: the repack pads u and v),
    density -1 outside a ball, numpy from a seed; as JAX and torch grids."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-2.0, 4.0, tuple(dims) + (1,)).astype(np.float32)
    coords = np.stack(np.meshgrid(*[np.arange(n) for n in dims], indexing="ij"), -1)
    dist = np.linalg.norm(coords - (np.asarray(dims) - 1) / 2, axis=-1, keepdims=True)
    d = np.where(dist < min(dims) / 3, d, -1.0).astype(np.float32)
    f = (rng.normal(size=tuple(dims) + (27,)) * 0.4).astype(np.float32)
    vs = tuple(2.0 / n for n in dims)
    config = dict(voxel_size=vs, grid_location=(0.0, 0.0, 0.0),
                  density_preactivation="identity", density_postactivation="relu",
                  feature_preactivation="identity", feature_postactivation="identity",
                  expected_density_scale=1.0, radiance_transfer_function=None)
    jgrid = JaxVoxelGrid(densities=jnp.asarray(d), features=jnp.asarray(f),
                         voxel_size=VoxelSize(*vs), density_preactivation="identity",
                         density_postactivation="relu")
    return jgrid, voxel_grid_from_numpy(d, f, config, device="cpu")


def _statics(jgrid, tgrid, axis, flip, **kw):
    sj = brj.statics_for_grid(jgrid, axis, flip, interpret=True, **kw)
    st = brt.statics_for_grid(tgrid, axis, flip, **kw)
    assert tuple(sj._asdict()[k] for k in st._fields) == tuple(st)
    return sj, st


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("flip", [False, True])
def test_repack_and_occupancy_match_jax(K, flip):
    """repack_slab_grid at theta = 0.37 (the lerp written in bf16, the flip,
    the K-way interleave, the pads) and occupancy_mip on a 12 x 14 x 16 grid,
    for each march axis. The mip (maxima) is equal; the repacked values are
    equal but where the two packages' f32 lerps differ by an ulp at a bf16
    rounding boundary (XLA may contract the lerp): those move by one bf16
    unit. Bound: at most 0.1% of the elements, each within one bf16 unit
    (2^-8 relative); measured: none differ."""
    jgrid, tgrid = _box_grids((12, 14, 16))
    for axis in range(3):
        sj, st = _statics(jgrid, tgrid, axis, flip, axis_supersample=K)
        want = _f32(brj.repack_slab_grid(jgrid, sj, jnp.float32(0.37)))
        got = brt.repack_slab_grid(tgrid, st, 0.37)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        got = got.float().numpy()
        off = got != want
        print(f"axis {axis} K={K} flip={flip}: repack {off.sum()} of {off.size} differ")
        assert off.mean() <= 1e-3
        assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -8 + 1e-30)
        np.testing.assert_array_equal(brt.occupancy_mip(tgrid, st).numpy(),
                                      np.asarray(brj.occupancy_mip(jgrid, sj)))


def _tile_rays(statics_j, pose, size, focal):
    """The JAX package's tiled rays of a pose (numpy) and their records."""
    rot = jnp.asarray(np.asarray(pose.rotation, np.float32).reshape(3, 3))
    org = jnp.asarray(np.asarray(pose.translation, np.float32).reshape(3))
    tp = statics_j.tile_px
    pad = -(-size // tp) * tp
    ro, rd = brj._tile_image_rays(pad, pad, focal, size, size, rot, org, tp)
    return np.asarray(ro), np.asarray(rd)


@pytest.mark.parametrize("yaw,pitch,theta,K", [(30.0, -35.0, 0.5, 1), (200.0, -70.0, 0.23, 2),
                                               (46.0, -49.5, 0.81, 4)])
def test_tile_rays_and_ray_features_match_jax(yaw, pitch, theta, K):
    """_tile_image_rays and compute_ray_features (affine coefficients, live
    slab range, step length, SH basis lanes) against the JAX package's on the
    same rays: within rtol 1e-5 / atol 1e-5 (f32 round-off of the norms and
    divisions; the live ranges jmin / jmax are quotients, atol 1e-4)."""
    jgrid, tgrid = _grids()
    pose = pose_spherical(yaw, pitch, RADIUS)
    axis, flip = brt.dominant_axis_for_pose(np.asarray(pose.rotation))
    sj, st = _statics(jgrid, tgrid, axis, flip, axis_supersample=K)
    ro, rd = _tile_rays(sj, pose, 40, 44.0)
    tro, trd = brt._tile_image_rays(
        48, 48, 44.0, 40, 40, torch.as_tensor(np.asarray(pose.rotation, np.float32)),
        torch.as_tensor(np.asarray(pose.translation, np.float32).reshape(3)), st.tile_px)
    np.testing.assert_allclose(trd.numpy(), rd, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tro.numpy(), ro)
    want = np.asarray(brj.compute_ray_features(jnp.asarray(ro), jnp.asarray(rd), sj,
                                               jnp.float32(theta)))
    got = brt.compute_ray_features(torch.from_numpy(ro), torch.from_numpy(rd), st,
                                   theta).numpy()
    assert got.shape == want.shape == (9, 256, 48)
    for lane in range(48):
        atol = 1e-4 if lane in (6, 7) else 1e-5
        np.testing.assert_allclose(got[..., lane], want[..., lane], rtol=1e-5, atol=atol,
                                   err_msg=f"lane {lane}")


@pytest.mark.parametrize("yaw,pitch,grid,sparse,exact", [(30.0, -35.0, 16, False, False),
                                                         (46.0, -49.5, 32, False, False),
                                                         (46.0, -49.5, 32, False, True),
                                                         (200.0, -45.0, 16, True, False)])
def test_build_tables_match_jax(yaw, pitch, grid, sparse, exact):
    """build_tables on the JAX package's ray records and occupancy mip:
    tables, counts and the overflow flag array-equal (the footprint spans,
    the overflow splitting into halves and single slabs, the occupancy skip
    and a stable sort on the same keys). The diagonal pose (46, -49.5) on a
    32^3 grid must split some groups (and overflows a single slab's patch);
    the sparse scene with the serving threshold must skip some."""
    jgrid, tgrid = _grids(size=grid, seed=4 if sparse else 3)
    pose = pose_spherical(yaw, pitch, RADIUS)
    axis, flip = brt.dominant_axis_for_pose(np.asarray(pose.rotation))
    thresh = 1e-4 if sparse else 0.0
    sj, st = _statics(jgrid, tgrid, axis, flip, occupancy_alpha_thresh=thresh,
                      axis_supersample=1)
    ro, rd = _tile_rays(sj, pose, 48, 52.8)
    rf = brj.compute_ray_features(jnp.asarray(ro), jnp.asarray(rd), sj)
    occ = brj.occupancy_mip(jgrid, sj)
    tab_j, cnt_j, ovf_j = brj.build_tables(rf, occ, sj, exact_spans=exact)
    tab_t, cnt_t, ovf_t = brt.build_tables(torch.from_numpy(np.asarray(rf)),
                                           torch.from_numpy(np.asarray(occ)), st,
                                           exact_spans=exact)
    assert tab_t.dtype == torch.int32 and cnt_t.dtype == torch.int32
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(tab_t.numpy(), np.asarray(tab_j))
    assert ovf_t.dim() == 0 and bool(ovf_t) == bool(ovf_j) == (grid == 32)
    tab = tab_t.numpy()
    live = np.arange(tab.shape[1])[None, :] < cnt_t.numpy()
    if grid == 32:
        assert (tab[..., 3][live] != 3).any()  # split entries
    if sparse:
        assert cnt_t.sum() < len(tab) * brt._slab_geometry(st)[3]


def _configs(**kw):
    common = dict(num_samples_per_ray=32, perturb_sampled_points=False, **kw)
    return (JaxConfig(camera_bounds=JaxBounds(1.0, 6.0), **common),
            SHVoxGridRenderConfig(camera_bounds=CameraBounds(1.0, 6.0), **common))


@pytest.mark.parametrize("yaw,pitch,size,config_kw", [
    (30.0, -35.0, 32, {}),
    (46.0, -49.5, 40, dict(bricked_axis_supersample=1)),
    (200.0, -70.0, 48, dict(white_bkgd=True, also_render_diffuse=True)),
    (120.0, -10.0, 40, dict(bricked_exit_eps=0.0, bricked_occupancy_alpha_thresh=0.0)),
])
def test_render_image_matches_jax(yaw, pitch, size, config_kw):
    """render_image_bricked (repack, mip, ray records, tables, the slab
    march's plain version, untiling, white background) against the JAX
    package's (its kernel in interpret mode) at 16^3. Bound: colour and acc
    3e-3, depth 2e-2 (tests/test_torch_gnomonic.py's bounds between the
    packages; measured <= 2.4e-4 / 7.9e-4, at the white-background pose,
    else <= 1e-7 / 4e-7); the overflow flag equal."""
    jgrid, tgrid = _grids()
    jc, tc = _configs(**config_kw)
    pose = pose_spherical(yaw, pitch, RADIUS)
    want = brj.render_image_bricked(jgrid, pose, JaxIntrinsics(size, size, size * 1.1), jc,
                                    interpret=True)
    got = brt.render_image_bricked(tgrid, pose, CameraIntrinsics(size, size, size * 1.1), tc)
    assert got.colour.shape == (size, size, 3)
    gaps = (np.abs(got.colour.numpy() - np.asarray(want.colour)).max(),
            np.abs(got.extra[ACC].numpy() - np.asarray(want.extra[ACC])).max(),
            np.abs(got.depth.numpy() - np.asarray(want.depth)).max())
    print(f"bricked render port vs JAX: colour/acc/depth max-abs {gaps}")
    assert gaps[0] < 3e-3 and gaps[1] < 3e-3 and gaps[2] < 2e-2
    assert float(got.extra[ACC].max()) > 0.5
    assert bool(got.extra["bricked_tap_overflow"]) == bool(want.extra["bricked_tap_overflow"])
    if "also_render_diffuse" in config_kw:
        np.testing.assert_allclose(got.extra["diffuse_colour"].numpy(),
                                   np.asarray(want.extra["diffuse_colour"]), atol=3e-3)


def test_volumetric_model_and_checkpoints_both_ways(tmp_path):
    """VolumetricModel with the bricked procedure: render_poses (a per-pose
    loop sharing each variant's repack) equals render per pose and the JAX
    model's render within the render bound; a checkpoint the port writes
    loads in the JAX package with the procedure's name, and the reverse."""
    d, f, config = _scene()
    jc, tc = _configs(white_bkgd=True)
    jgrid = JaxVoxelGrid(densities=jnp.asarray(d), features=jnp.asarray(f),
                         voxel_size=VoxelSize(*config["voxel_size"]),
                         density_preactivation="identity", density_postactivation="relu")
    tmodel = vm.VolumetricModel(voxel_grid_from_numpy(d, f, config, device="cpu"), PROC, tc,
                                device="cpu")
    poses = [pose_spherical(30.0, -35.0, RADIUS), pose_spherical(35.0, -30.0, RADIUS),
             pose_spherical(200.0, -70.0, RADIUS)]
    intr = CameraIntrinsics(32, 32, 35.2)
    out = tmodel.render_poses(poses, intr)
    assert out.colour.shape == (3, 32, 32, 3)
    keys = [k for k in tmodel._image_render_cache if k[0] == "bricked"]
    assert len(keys) == 2  # two march variants
    one = tmodel.render(poses[2], intr)
    np.testing.assert_array_equal(out.colour[2].numpy(), one.colour.numpy())
    tmodel.save(tmp_path / "port_model")
    jmodel, _ = vm_jax.create_volumetric_model_from_saved_model(tmp_path / "port_model")
    assert jmodel.render_procedure_name == PROC
    want = jmodel.render(poses[0], JaxIntrinsics(32, 32, 35.2))
    assert np.abs(out.colour[0].numpy() - np.asarray(want.colour)).max() < 3e-3
    vm_jax.VolumetricModel(jgrid, PROC, jc).save(tmp_path / "jax_model")
    loaded, _ = vm.create_volumetric_model_from_saved_model(tmp_path / "jax_model",
                                                            device="cpu")
    assert loaded.render_procedure_name == PROC
    again = loaded.render(poses[0], intr)
    np.testing.assert_allclose(again.colour.numpy() - (1.0 - again.extra[ACC].numpy()),
                               out.colour[0].numpy() - (1.0 - out.extra[ACC][0].numpy()),
                               atol=1e-6)


def _train_case(k_tiles=3, size=40):
    jgrid, tgrid = _grids()
    rng = np.random.default_rng(6)
    poses = [pose_spherical(30.0 + 6.0 * i, -35.0, RADIUS) for i in range(3)]
    P = np.stack([np.concatenate([np.asarray(p.rotation, np.float32).reshape(3, 3),
                                  np.asarray(p.translation, np.float32).reshape(3, 1)], 1)
                  for p in poses]).astype(np.float32)
    variants = {brt.dominant_axis_for_pose(p[:, :3]) for p in P}
    assert len(variants) == 1
    axis, flip = variants.pop()
    images = rng.random((3, size, size, 3), dtype=np.float32)
    kw = dict(image_height=size, image_width=size, focal=size * 1.1,
              ray_batch_size=k_tiles * 256, white_bkgd=True)
    sj = btj.make_bricked_train_statics(jgrid, axis, flip, interpret=True, **kw)
    st = btt.make_bricked_train_statics(tgrid, axis, flip, **kw)
    assert st.num_tiles == sj.num_tiles == k_tiles and st.bricked.axis_supersample == 4
    pose_idx = np.array([0, 2, 1], np.int32)[:k_tiles]
    return jgrid, tgrid, sj, st, images, P, pose_idx


def _jax_draws(key, statics_t):
    """The JAX step's tiles and theta from its key, as bricked_train_step
    draws them."""
    key_tiles, key_theta = jax.random.split(key)
    key_y, key_x = jax.random.split(key_tiles)
    tp, nt = statics_t.bricked.tile_px, statics_t.num_tiles
    ty = jax.random.randint(key_y, (nt,), 0, statics_t.image_height - tp + 1)
    tx = jax.random.randint(key_x, (nt,), 0, statics_t.image_width - tp + 1)
    theta = jax.random.uniform(key_theta, (), minval=0.05, maxval=0.95)
    return (torch.from_numpy(np.asarray(ty)).long(), torch.from_numpy(np.asarray(tx)).long(),
            torch.tensor(float(theta)))


def test_bricked_train_step_matches_jax():
    """One bricked_train_step (3 tiles of 16 x 16 from three views, diffuse
    regularization, white background, K = 4) fed the JAX step's tiles and
    theta, against the JAX package's step: the metrics within rtol 2e-5; the
    gradients (read from Adam's first moments after one step, mu = 0.1 g)
    within cosine > 0.99995 and p999 relative error < 0.12, the bounds of
    tests/test_gnomonic_train.py:603-628 (measured cosine 1 - 1e-7); after
    one Adam step the grids within 2 lr everywhere and 1e-4 on all but 1% of
    the elements. draw_tiles gives tiles inside the image and theta in
    [0.05, 0.95)."""
    lr = 0.03
    jgrid, tgrid, sj, st, images, P, pose_idx = _train_case()
    key = jax.random.PRNGKey(5)
    tx = optax.adam(lr, b1=0.9, b2=0.999)
    copy = lambda tree: jax.tree_util.tree_map(jnp.copy, tree)  # noqa: E731
    g_j, opt_j, m_j = btj.bricked_train_step(sj, tx, copy(jgrid), tx.init(jgrid),
                                             jnp.asarray(images), jnp.asarray(P),
                                             jnp.asarray(pose_idx), key)
    opt, _ = make_gnomonic_optimizer(tgrid, lr, 1000, 0.1)
    m_t = btt.bricked_train_step(st, opt, tgrid, torch.from_numpy(images), P,
                                 torch.from_numpy(pose_idx), draws=_jax_draws(key, st))
    for name in m_j:
        print(f"{name}: port {float(m_t[name]):.8f} JAX {float(m_j[name]):.8f}")
        np.testing.assert_allclose(float(m_t[name]), float(m_j[name]), rtol=2e-5)
    for fld in ("densities", "features"):
        param = getattr(tgrid, fld)
        p999, cos = _rel_stats(opt.state[param]["exp_avg"].numpy(),
                               np.asarray(getattr(opt_j[0].mu, fld)))
        new_t, new_j = param.detach().numpy(), np.asarray(getattr(g_j, fld))
        off = np.abs(new_t - new_j) > 1e-4
        print(f"bricked step {fld}: gradient p999 {p999:.3g}, cosine {cos:.9f}; "
              f"{off.mean():.2e} of the grid beyond 1e-4")
        assert p999 < 0.12 and cos > 0.99995, (fld, p999, cos)
        assert np.abs(new_t - new_j).max() <= 2 * lr + 1e-6 and off.mean() < 0.01
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        ty, tx_, theta = btt.draw_tiles(gen, st)
        assert ty.shape == tx_.shape == (st.num_tiles,)
        assert 0 <= int(ty.min()) and int(ty.max()) <= 40 - 16 and int(tx_.max()) <= 40 - 16
        assert 0.05 <= float(theta) < 0.95


def test_bricked_tile_loss_gradient_is_the_kernels_vjp():
    """The tile loss's gradient through the plain slab march equals, on the
    repacked grid, the replay VJP of slab_march_grad_plain with the loss's
    output cotangent cast to bf16 (the reference's VJP), and the step's
    tiles are the image's pixels at (ty, tx)."""
    _, tgrid, _, st, images, P, pose_idx = _train_case(k_tiles=2)
    ty, tx = torch.tensor([3, 20]), torch.tensor([17, 0])
    ro, rd, pix = btt.sample_tiles(st, torch.from_numpy(images), torch.from_numpy(P),
                                   torch.from_numpy(pose_idx), ty, tx)
    np.testing.assert_array_equal(pix[1].reshape(16, 16, 3).numpy(),
                                  images[pose_idx[1], 20:36, 0:16])
    assert torch.equal(ro[0, 0], torch.from_numpy(P[pose_idx[0], :, 3]))
    bst = st.bricked
    theta = torch.tensor(0.3)
    rf = brt.compute_ray_features(ro, rd, bst, theta)
    tables, counts, _ = brt.build_tables(rf, brt.occupancy_mip(tgrid, bst), bst)
    rep = brt.repack_slab_grid(tgrid, bst, theta).detach().requires_grad_(True)
    from thr3ed_atom_tpu_torch.ops import slab_march as sm
    kw = dict(ncoeff=bst.ncoeff, relu_sigma=bst.relu_sigma, exit_eps=bst.exit_eps,
              with_diffuse=bst.with_diffuse)
    out = sm.slab_march(tables, counts, rf, rep, plain=True, **kw)
    gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    (out * gout).sum().backward()
    want = sm.slab_march_grad_plain(tables, counts, rf, rep.detach(), out.detach(), gout, **kw)
    assert torch.equal(rep.grad, want.to(torch.bfloat16))
    assert float(want.abs().max()) > 0.0
