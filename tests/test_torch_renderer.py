"""The exact renderer of the PyTorch port (``render_sh_voxel_grid``, the JAX
package's default procedure and the oracle of its quality gates) against the
JAX package: rays, both samplers, the point processor, the accumulator with
each registry entry, trilinear sampling, SH evaluation, the voxel grid's
lookup, the procedure's outputs and grid gradients, and VolumetricModel's
chunked render, save / load and the render CLI for the procedure.

CPU tests at small sizes (12^3 grids, a few hundred rays). Inputs come from
numpy seeds; the jitter's uniforms and the density noise's normals are drawn
from the JAX key and given to the port. The JAX functions run op by op (no
jit), as the port's do; each test states its tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thr3ed_atom_tpu.models.voxels import VoxelGrid as JaxVoxelGrid, VoxelGridLocation, VoxelSize
from thr3ed_atom_tpu.modules import volumetric_model as vm_jax
from thr3ed_atom_tpu.ops.grid_sample import trilinear_grid_sample as jax_grid_sample
from thr3ed_atom_tpu.ops.sh import evaluate_spherical_harmonics as jax_sh
from thr3ed_atom_tpu.rendering import accumulate as acc_jax
from thr3ed_atom_tpu.rendering import interface as if_jax
from thr3ed_atom_tpu.rendering import process as proc_jax
from thr3ed_atom_tpu.rendering import rays as rays_jax
from thr3ed_atom_tpu.rendering import renderer as renderer_jax
from thr3ed_atom_tpu.rendering import sample as sample_jax
from thr3ed_atom_tpu.utils.camera import CameraBounds as JaxBounds
from thr3ed_atom_tpu.utils.camera import CameraIntrinsics as JaxIntrinsics
from thr3ed_atom_tpu_torch.apps import render_sh_voxel_grid as rcli
from thr3ed_atom_tpu_torch.models import voxels
from thr3ed_atom_tpu_torch.modules import volumetric_model as vm
from thr3ed_atom_tpu_torch.ops.grid_sample import trilinear_grid_sample
from thr3ed_atom_tpu_torch.ops.sh import evaluate_spherical_harmonics
from thr3ed_atom_tpu_torch.rendering import accumulate, process, rays, renderer, sample
from thr3ed_atom_tpu_torch.rendering.interface import (
    ProcessedPointsOnRays,
    Rays,
    SampledPointsOnRays,
)
from thr3ed_atom_tpu_torch.utils.camera import (
    CameraBounds,
    CameraIntrinsics,
    pose_spherical,
)

BOUNDS = (1.0, 6.0)
INTR = CameraIntrinsics(20, 24, 26.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def n_(x):
    return np.asarray(x)


def t(x):
    return torch.from_numpy(np.array(x))


def _scene(size=12, seed=3, ncoeff=9, relu=True):
    """A carved relu scene (density -1 outside a ball: empty space) or an
    abs-field scene, as numpy arrays and a grid config, from a seed."""
    rng = np.random.default_rng(seed)
    if relu:
        d = rng.uniform(-2.0, 6.0, (size,) * 3 + (1,)).astype(np.float32)
        coords = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing="ij"), -1)
        dist = np.linalg.norm(coords - (size - 1) / 2, axis=-1, keepdims=True)
        d = np.where(dist < size / 3, d, -1.0).astype(np.float32)
        acts = dict(density_preactivation="identity", density_postactivation="relu")
    else:
        d = rng.uniform(-3.0, 3.0, (size,) * 3 + (1,)).astype(np.float32)
        acts = dict(density_preactivation="abs", density_postactivation="identity")
    f = (rng.normal(size=(size,) * 3 + (3 * ncoeff,)) * 0.5).astype(np.float32)
    config = dict(voxel_size=(2.0 / size,) * 3, grid_location=(0.1, -0.05, 0.0),
                  feature_preactivation="identity", feature_postactivation="identity",
                  expected_density_scale=1.5, radiance_transfer_function=None, **acts)
    return d, f, config


def _grids(**kw):
    d, f, config = _scene(**kw)
    jgrid = JaxVoxelGrid(
        densities=jnp.asarray(d), features=jnp.asarray(f),
        voxel_size=VoxelSize(*config["voxel_size"]),
        grid_location=VoxelGridLocation(*config["grid_location"]),
        **{k: v for k, v in config.items() if k not in ("voxel_size", "grid_location")})
    return jgrid, voxels.voxel_grid_from_numpy(d, f, config, device="cpu")


def _flat_rays(n=300, seed=1):
    """Rays of one pose's image plus a few that miss the grid, numpy."""
    pose = pose_spherical(40.0, -30.0, 3.2)
    r = rays_jax.flatten_rays(rays_jax.cast_rays(JaxIntrinsics(*INTR), pose))
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(r), n, replace=False)
    o, d = np.array(r.origins)[idx], np.array(r.directions)[idx]
    d[:8] = -d[:8]  # rays pointing away: they miss the box
    return o.astype(np.float32), d.astype(np.float32)


def test_rays_match_jax():
    """cast_rays, cast_rays_batch, flatten / collate, ndcize_rays and the
    relu-field density scale: the directions equal to JAX's bit for bit
    (the same FMA chain; the vmapped batch within 1 ulp), the NDC rays
    within 1e-5 relative."""
    pose = pose_spherical(75.0, -20.0, 4.0)
    want = rays_jax.cast_rays(JaxIntrinsics(*INTR), pose)
    got = rays.cast_rays(INTR, pose, device="cpu")
    assert got.directions.shape == (20, 24, 3)
    np.testing.assert_array_equal(got.directions.numpy(), n_(want.directions))
    np.testing.assert_array_equal(got.origins.numpy(), n_(want.origins))
    poses = np.stack([np.concatenate([np.asarray(p.rotation), np.asarray(p.translation)], 1)
                      for p in (pose, pose_spherical(10.0, -50.0, 3.0))]).astype(np.float32)
    wb = rays_jax.cast_rays_batch(JaxIntrinsics(*INTR), jnp.asarray(poses))
    gb = rays.cast_rays_batch(INTR, poses, device="cpu")
    # the JAX batch is a vmap, whose batched dot rounds otherwise: 1 ulp
    np.testing.assert_allclose(gb.directions.numpy(), n_(wb.directions), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(gb.directions[0].numpy(), got.directions.numpy())
    flat = rays.flatten_rays(gb)
    assert flat.origins.shape == (2 * 20 * 24, 3) and len(flat) == 960
    both = rays.collate_rays([flat[:100], flat[100:]])
    np.testing.assert_array_equal(both.directions.numpy(), flat.directions.numpy())
    wn = rays_jax.ndcize_rays(rays_jax.flatten_rays(want), JaxIntrinsics(*INTR))
    gn_ = rays.ndcize_rays(rays.flatten_rays(got), INTR)
    np.testing.assert_allclose(gn_.origins.numpy(), n_(wn.origins), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gn_.directions.numpy(), n_(wn.directions), rtol=1e-5, atol=1e-6)
    assert rays.compute_expected_density_scale_for_relu_field_grid((3.0, 2.0, 2.5)) == \
        rays_jax.compute_expected_density_scale_for_relu_field_grid((3.0, 2.0, 2.5))


@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("perturb", [False, True])
def test_samplers_match_jax(optimized, perturb):
    """Uniform and AABB-bound sampling (and ray_aabb_intersection, whose
    misses keep the scene bounds), with the jitter's uniforms drawn from the
    JAX key: depths and points within 1e-6 relative; the linspace rounds as
    the JAX package's jitted one (t_vals equal). Linear-disparity sampling
    too."""
    jgrid, tgrid = _grids()
    o, d = _flat_rays()
    S = 48
    key = jax.random.PRNGKey(11)
    jr = if_jax.Rays(jnp.asarray(o), jnp.asarray(d))
    tr = Rays(t(o), t(d))
    t_rand = np.asarray(jax.random.uniform(key, (len(o), S)))
    if optimized:
        want = sample_jax.sample_aabb_bound_uniform_points_on_rays(
            jr, JaxBounds(*BOUNDS), S, jgrid.aabb, key=key, perturb=perturb)
        got = sample.sample_aabb_bound_uniform_points_on_rays(
            tr, CameraBounds(*BOUNDS), S, tgrid.aabb, perturb=perturb,
            t_rand=t(t_rand) if perturb else None)
        bj, hit_j = sample_jax.ray_aabb_intersection(jr, JaxBounds(*BOUNDS), jgrid.aabb)
        bt, hit_t = sample.ray_aabb_intersection(tr, CameraBounds(*BOUNDS), tgrid.aabb)
        np.testing.assert_array_equal(hit_t.numpy(), n_(hit_j))
        assert 0 < int(hit_t.sum()) < len(o)
        np.testing.assert_allclose(bt.numpy(), n_(bj), rtol=1e-6, atol=1e-6)
    else:
        want = sample_jax.sample_uniform_points_on_rays(jr, JaxBounds(*BOUNDS), S, key=key,
                                                        perturb=perturb)
        got = sample.sample_uniform_points_on_rays(tr, CameraBounds(*BOUNDS), S,
                                                   perturb=perturb,
                                                   t_rand=t(t_rand) if perturb else None)
    np.testing.assert_allclose(got.depths.numpy(), n_(want.depths), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.points.numpy(), n_(want.points), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(
        sample.uniform_t_vals(S, tr.origins).numpy()[0],
        n_(jnp.linspace(0.0, 1.0, S, dtype=jnp.float32)))
    wl = sample_jax.sample_uniform_points_on_rays(jr, JaxBounds(*BOUNDS), S, perturb=False,
                                                  linear_disparity_sampling=True)
    gl = sample.sample_uniform_points_on_rays(tr, CameraBounds(*BOUNDS), S, perturb=False,
                                              linear_disparity_sampling=True)
    np.testing.assert_allclose(gl.depths.numpy(), n_(wl.depths), rtol=1e-6)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_spherical_harmonics_match_jax(degree):
    """evaluate_spherical_harmonics at every degree: within 1e-6 relative."""
    rng = np.random.default_rng(degree)
    coeffs = rng.normal(size=(257, 3, (degree + 1) ** 2)).astype(np.float32)
    dirs = rng.normal(size=(257, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = n_(jax_sh(degree, jnp.asarray(coeffs), jnp.asarray(dirs)))
    got = evaluate_spherical_harmonics(degree, t(coeffs), t(dirs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_trilinear_grid_sample_and_grid_lookup_match_jax():
    """trilinear_grid_sample (points inside, on and beyond the border) and
    its gradient to the volume; the grid's normalize_points,
    test_inside_volume, bounding vertices and lookup; all within 1e-6."""
    rng = np.random.default_rng(5)
    vol = rng.normal(size=(7, 9, 6, 5)).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (400, 3)).astype(np.float32)
    coords[:6] = [[-1, -1, -1], [1, 1, 1], [1, -1, 0], [0, 0, 0], [-1.1, 0, 0], [0.99, 1, -1]]
    g = rng.normal(size=(400, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jax_grid_sample(v, jnp.asarray(coords)), jnp.asarray(vol))
    (gv_j,) = vjp(jnp.asarray(g))
    vt = t(vol).requires_grad_(True)
    got = trilinear_grid_sample(vt, t(coords))
    got.backward(t(g))
    np.testing.assert_allclose(got.detach().numpy(), n_(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vt.grad.numpy(), n_(gv_j), rtol=1e-6, atol=1e-6)

    jgrid, tgrid = _grids()
    pts = rng.uniform(-1.3, 1.3, (300, 3)).astype(np.float32)
    np.testing.assert_allclose(tgrid.normalize_points(t(pts)).numpy(),
                               n_(jgrid.normalize_points(jnp.asarray(pts))), rtol=1e-6)
    np.testing.assert_array_equal(tgrid.test_inside_volume(t(pts)).numpy(),
                                  n_(jgrid.test_inside_volume(jnp.asarray(pts))))
    np.testing.assert_array_equal(tgrid.get_bounding_volume_vertices().numpy(),
                                  n_(jgrid.get_bounding_volume_vertices()))
    np.testing.assert_allclose(tgrid(t(pts)).numpy(), n_(jgrid(jnp.asarray(pts))),
                               rtol=1e-6, atol=1e-6)
    assert voxels.RADIANCE_TRANSFER_FUNCTIONS == {}
    named = voxels.voxel_grid_from_numpy(
        *_scene()[:2], {**_scene()[2], "radiance_transfer_function": "mlp"}, device="cpu")
    with pytest.raises(KeyError, match="mlp"):  # the JAX package's own name check
        named(t(pts), t(pts))


@pytest.mark.parametrize("render_diffuse", [False, True])
def test_point_processor_matches_jax(render_diffuse):
    """process_points_with_sh_voxel_grid (specular and diffuse): radiance
    within 1e-5 relative, -INFINITY and density 0 outside the box, equal."""
    jgrid, tgrid = _grids()
    o, d = _flat_rays()
    jr, tr = if_jax.Rays(jnp.asarray(o), jnp.asarray(d)), Rays(t(o), t(d))
    pts = sample_jax.sample_uniform_points_on_rays(jr, JaxBounds(*BOUNDS), 32, perturb=False)
    want = proc_jax.process_points_with_sh_voxel_grid(pts, jr, jgrid, render_diffuse)
    got = process.process_points_with_sh_voxel_grid(
        SampledPointsOnRays(t(pts.points), t(pts.depths)), tr, tgrid, render_diffuse)
    assert got.points.shape == (len(o), 32, 4)
    np.testing.assert_allclose(got.points.numpy(), n_(want.points), rtol=1e-5, atol=1e-5)
    outside = n_(want.points)[..., -1] == 0.0
    assert outside.any() and (got.points.numpy()[..., 0][n_(want.points)[..., 0] < -1e9]
                              < -1e9).all()


@pytest.mark.parametrize("occupancy,tone_map,white,noise_std", [
    ("pb", "sigmoid", True, 0.0), ("pb", "identity", False, 0.0),
    ("pb", "sigmoid", True, 1.5), ("pb", "sigmoid", False, 1.5)])
def test_accumulator_matches_jax(occupancy, tone_map, white, noise_std):
    """accumulate_radiance_density_on_rays for each DENSITY2OCCUPANCY and
    TONE_MAPS entry, with and without the white background and with the
    density noise drawn from the JAX key (negative noised densities
    included): colour, acc, depth and disparity within 1e-5, the debug
    extras too; no NaN on empty rays."""
    assert sorted(accumulate.DENSITY2OCCUPANCY) == sorted(acc_jax.DENSITY2OCCUPANCY)
    assert sorted(accumulate.TONE_MAPS) == sorted(acc_jax.TONE_MAPS)
    rng = np.random.default_rng(9)
    N, S = 200, 40
    pts = rng.normal(size=(N, S, 4)).astype(np.float32)
    pts[..., -1] = np.maximum(rng.normal(1.0, 2.0, (N, S)), 0.0)
    pts[:10, :, -1] = 0.0  # empty rays
    depths = np.sort(rng.uniform(1.0, 6.0, (N, S)), axis=-1).astype(np.float32)
    dirs = rng.normal(size=(N, 3)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    kw = dict(stochastic_density_noise_std=noise_std, white_bkgd=white, extra_debug_info=True)
    want = acc_jax.accumulate_radiance_density_on_rays(
        if_jax.ProcessedPointsOnRays(jnp.asarray(pts), jnp.asarray(depths)),
        if_jax.Rays(jnp.zeros((N, 3)), jnp.asarray(dirs)), key=key,
        density2occupancy=acc_jax.DENSITY2OCCUPANCY[occupancy],
        radiance_hdr_tone_map=acc_jax.TONE_MAPS[tone_map], **kw)
    noise = t(np.asarray(jax.random.normal(key, (N, S)))) if noise_std > 0 else None
    got = accumulate.accumulate_radiance_density_on_rays(
        ProcessedPointsOnRays(t(pts), t(depths)), Rays(torch.zeros(N, 3), t(dirs)),
        density2occupancy=accumulate.DENSITY2OCCUPANCY[occupancy],
        radiance_hdr_tone_map=accumulate.TONE_MAPS[tone_map], noise=noise, **kw)
    for a, b in [(got.colour, want.colour), (got.depth, want.depth)] + [
            (got.extra[k], want.extra[k]) for k in want.extra]:
        np.testing.assert_allclose(a.numpy(), n_(b), rtol=1e-5, atol=1e-5)
    assert np.isfinite(got.extra["disparity"].numpy()).all()


def _render_pair(jgrid, tgrid, o, d, key, **cfg):
    S = 64
    jc = renderer_jax.SHVoxGridRenderConfig(num_samples_per_ray=S,
                                            camera_bounds=JaxBounds(*BOUNDS), **cfg)
    tc = renderer.SHVoxGridRenderConfig(num_samples_per_ray=S,
                                        camera_bounds=CameraBounds(*BOUNDS), **cfg)
    sample_key, noise_key = jax.random.split(key)
    draws = dict(t_rand=t(np.asarray(jax.random.uniform(sample_key, (len(o), S)))),
                 noise=t(np.asarray(jax.random.normal(noise_key, (len(o), S)))))
    return jc, tc, draws


@pytest.mark.parametrize("optimized,perturb,noise_std,diffuse,relu", [
    (False, False, 0.0, False, True), (True, False, 0.0, False, True),
    (False, True, 1.0, False, True), (True, True, 1.0, True, True),
    (False, False, 0.0, True, False)])
def test_render_sh_voxel_grid_and_its_gradient_match_jax(optimized, perturb, noise_std,
                                                        diffuse, relu):
    """render_sh_voxel_grid's colour, acc, depth and disparity (specular,
    or the diffuse render) against the JAX package's, with and without the
    jitter and the density noise (their draws taken from the JAX key as
    the JAX procedure splits it) and AABB-bound sampling on and off, on a
    relu scene with empty space and on an abs field: colour within 1e-5
    abs, the rest within 1e-5 (rtol and atol; disparity 1e-4 relative).
    The gradient of a seeded linear loss on colour, depth and acc with
    respect to the grid's densities and features: cosine > 0.99999."""
    jgrid, tgrid = _grids(relu=relu)
    o, d = _flat_rays()
    key = jax.random.PRNGKey(17)
    cfg = dict(optimized_sampling=optimized, perturb_sampled_points=perturb,
               stochastic_density_noise_std=noise_std, render_diffuse=diffuse,
               white_bkgd=True)
    jc, tc, draws = _render_pair(jgrid, tgrid, o, d, key, **cfg)
    rng = np.random.default_rng(4)
    gc, gd, ga = (rng.normal(size=(len(o), k)).astype(np.float32) for k in (3, 1, 1))
    jr = if_jax.Rays(jnp.asarray(o), jnp.asarray(d))

    def loss_j(grid):
        out = renderer_jax.render_sh_voxel_grid(grid, jr, jc, key)
        loss = jnp.sum(out.colour * gc) + jnp.sum(out.depth * gd) + jnp.sum(
            out.extra["accumulated_weight"] * ga)
        return loss, out

    (_, want), g_j = jax.value_and_grad(loss_j, has_aux=True)(jgrid)
    with tgrid.trainable():
        got = renderer.render_sh_voxel_grid(tgrid, Rays(t(o), t(d)), tc, **draws)
        (torch.sum(got.colour * t(gc)) + torch.sum(got.depth * t(gd))
         + torch.sum(got.extra["accumulated_weight"] * t(ga))).backward()
    np.testing.assert_allclose(got.colour.detach().numpy(), n_(want.colour), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.depth.detach().numpy(), n_(want.depth), rtol=1e-5, atol=1e-5)
    acc = "accumulated_weight"
    np.testing.assert_allclose(got.extra[acc].detach().numpy(), n_(want.extra[acc]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.extra["disparity"].detach().numpy(),
                               n_(want.extra["disparity"]), rtol=1e-4)
    acc_t = got.extra[acc].detach()
    assert float(acc_t.max()) > 0.5
    if noise_std == 0.0:  # noise lends the empty rays density
        assert float(acc_t.min()) < 1e-3
    for fld in ("densities", "features"):
        a = n_(getattr(g_j, fld)).ravel().astype(np.float64)
        b = getattr(tgrid, fld).grad.numpy().ravel().astype(np.float64)
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        print(f"{cfg}: {fld} gradient cosine {cos:.9f}, max-abs {np.abs(a - b).max():.3g} "
              f"of {np.abs(a).max():.3g}")
        assert cos > 0.99999, (fld, cos)


def _models(tmp_path=None, **cfg):
    jgrid, tgrid = _grids()
    kw = dict(num_samples_per_ray=48, white_bkgd=True, parallel_rays_chunk_size=128, **cfg)
    jmodel = vm_jax.VolumetricModel(jgrid, render_config=renderer_jax.SHVoxGridRenderConfig(
        camera_bounds=JaxBounds(*BOUNDS), **kw))
    tmodel = vm.VolumetricModel(tgrid, render_config=renderer.SHVoxGridRenderConfig(
        camera_bounds=CameraBounds(*BOUNDS), **kw), device="cpu")
    return jmodel, tmodel


def test_volumetric_model_render_is_chunk_invariant_and_matches_jax():
    """The port's VolumetricModel defaults to the exact renderer, as the
    JAX package's does. render() is the same image at any chunk size
    (bit for bit: rays are independent), within 1e-5 of the JAX model's
    render, and render_rays / render_poses agree with it; with a generator
    and jitter the image changes and stays finite."""
    jmodel, tmodel = _models()
    assert tmodel.render_procedure_name == "render_sh_voxel_grid"
    pose = pose_spherical(40.0, -30.0, 3.2)
    got = tmodel.render(pose, INTR)
    assert got.colour.shape == (20, 24, 3) and got.extra["disparity"].shape == (20, 24, 1)
    for chunk in (7, 480, 4096):
        other = tmodel.render(pose, INTR, parallel_rays_chunk_size=chunk)
        torch.testing.assert_close(other.colour, got.colour, rtol=0, atol=0)
        torch.testing.assert_close(other.depth, got.depth, rtol=0, atol=0)
    want = jmodel.render(pose, JaxIntrinsics(*INTR))
    np.testing.assert_allclose(got.colour.numpy(), n_(want.colour), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.depth.numpy(), n_(want.depth), rtol=1e-5, atol=1e-5)
    flat = rays.flatten_rays(rays.cast_rays(INTR, pose, device="cpu"))
    by_rays = tmodel.render_rays(flat, perturb_sampled_points=False)
    torch.testing.assert_close(by_rays.colour.reshape(20, 24, 3), got.colour, rtol=0, atol=0)
    both = tmodel.render_poses([pose, pose_spherical(200.0, -10.0, 3.5)], INTR)
    assert both.colour.shape == (2, 20, 24, 3)
    torch.testing.assert_close(both.colour[0], got.colour, rtol=0, atol=0)
    jittered = tmodel.render(pose, INTR, generator=torch.Generator().manual_seed(0),
                             perturb_sampled_points=True)
    assert not torch.equal(jittered.colour, got.colour)
    assert bool(torch.isfinite(jittered.colour).all())


def test_exact_model_save_load_and_render_cli(tmp_path):
    """A checkpoint with the exact procedure written by either package loads
    in the other, renders to the same image in the port, and renders
    through the port's render CLI (two frames into rendered_video.gif)."""
    jmodel, tmodel = _models()
    vm_jax.save_model(jmodel, tmp_path / "jax_model",
                      {"hemispherical_radius": 3.2, "camera_intrinsics": [16, 16, 18.0]})
    loaded, extra = vm.create_volumetric_model_from_saved_model(tmp_path / "jax_model",
                                                                device="cpu")
    assert loaded.render_procedure_name == "render_sh_voxel_grid"
    assert extra["camera_intrinsics"] == [16, 16, 18.0]
    pose = pose_spherical(40.0, -30.0, 3.2)
    torch.testing.assert_close(loaded.render(pose, INTR).colour,
                               tmodel.render(pose, INTR).colour, rtol=0, atol=0)
    vm.save_model(tmodel, tmp_path / "torch_model")
    back, _ = vm_jax.create_volumetric_model_from_saved_model(tmp_path / "torch_model")
    assert back.render_procedure_name == "render_sh_voxel_grid"
    np.testing.assert_array_equal(n_(back.thre3d_repr.densities),
                                  tmodel.thre3d_repr.densities.numpy())
    out = rcli.main(["-i", str(tmp_path / "jax_model"), "-o", str(tmp_path / "render"),
                     "--num_frames", "2", "--render_scale_factor", "1",
                     "--overridden_num_samples_per_ray", "32"], device="cpu")
    assert out.name == "rendered_video.gif" and out.stat().st_size > 0
