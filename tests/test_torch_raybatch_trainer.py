"""The PyTorch port's ray-batch training against the JAX package: the
(image, pixel) batch and its rays, the draw of rays and pixels without
replacement, one train step (losses, metrics and the grid after Adam)
through the fast, exact (two renders) and hierarchical procedures, the
stage loop through the fast procedure resumed from one JAX checkpoint, and
CPU CLI runs through the ray-batch procedures whose checkpoints the JAX
package loads, with the feedback render and the held-out test (PSNR and
LPIPS) through the fast renderer.

CPU tests at small sizes (8^3 -> 16^3 grids, 24 x 24 views, 256 rays of 32
samples a step). Inputs come from numpy seeds; the batch indices, the
jitter, the fine uniforms and the density noise are drawn from the JAX
step's key, split as the JAX step splits it, and given to the port. The
JAX step runs jitted, as its trainer runs it; each test states its
tolerance."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_trainer import SHARE_BOUND, _relu_config, _write_dataset
from thr3ed_atom_tpu.data.dataset import PosedImagesDataset as JaxDataset
from thr3ed_atom_tpu.models import voxels as vox_jax
from thr3ed_atom_tpu.modules import trainer as trainer_jax
from thr3ed_atom_tpu.modules import volumetric_model as vm_jax
from thr3ed_atom_tpu.rendering import interface as if_jax
from thr3ed_atom_tpu.rendering import rays as rays_jax
from thr3ed_atom_tpu.rendering.renderer import SHVoxGridRenderConfig as JaxConfig
from thr3ed_atom_tpu.utils.camera import CameraBounds as JaxBounds
from thr3ed_atom_tpu_torch.apps import train_sh_voxel_grid as cli
from thr3ed_atom_tpu_torch.data.dataset import PosedImagesDataset
from thr3ed_atom_tpu_torch.models import voxels as vox
from thr3ed_atom_tpu_torch.modules import trainer
from thr3ed_atom_tpu_torch.modules import volumetric_model as vm
from thr3ed_atom_tpu_torch.rendering import rays
from thr3ed_atom_tpu_torch.rendering.hierarchical import hierarchical_budget
from thr3ed_atom_tpu_torch.rendering.interface import Rays
from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
from thr3ed_atom_tpu_torch.utils.camera import CameraBounds

FAST = "render_sh_voxel_grid_fast"
EXACT = "render_sh_voxel_grid"
HIER = "render_sh_voxel_grid_hierarchical"
SIZE, FOCAL = 24, 30.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the suite runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def n_(x):
    return np.asarray(x)


def t(x):
    return torch.from_numpy(np.array(x))


def _views(n=5, size=SIZE, seed=0):
    """Images [n, size, size, 3] and poses [n, 3, 4] (orbit poses), numpy."""
    from thr3ed_atom_tpu_torch.utils.camera import pose_spherical

    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    poses = np.stack([np.concatenate([np.asarray(p.rotation), np.asarray(p.translation)], 1)
                      for p in (pose_spherical(30.0 + 50.0 * i, -30.0 - 5.0 * i, 3.0)
                                for i in range(n))]).astype(np.float32)
    return images, poses


def _render_draws(key, procedure, config, n):
    """A render's draws from ``key`` as the JAX procedure splits it: the
    jitter, the hierarchical procedure's fine uniforms, the noise."""
    S = config.num_samples_per_ray
    draws = {}
    if procedure == HIER:
        sc, sf = hierarchical_budget(S)
        coarse_key, fine_key, noise_key = jax.random.split(key, 3)
        shapes = dict(t_rand=(n, sc), noise=(n, sc + sf))
    else:
        coarse_key, noise_key = jax.random.split(key)
        shapes = dict(t_rand=(n, S), noise=(n, S))
    if config.perturb_sampled_points:
        draws["t_rand"] = t(n_(jax.random.uniform(coarse_key, shapes["t_rand"])))
        if procedure == HIER:
            draws["u"] = t(n_(jax.random.uniform(fine_key, (n, sf), maxval=1.0 - 1e-6)))
    if config.stochastic_density_noise_std > 0.0:
        draws["noise"] = t(n_(jax.random.normal(noise_key, shapes["noise"])))
    return draws


def _jax_step_draws(key, statics, num_images) -> trainer.RayBatchDraws:
    """The draws of the JAX package's _train_step from its step key."""
    key_batch, key_specular, key_diffuse = jax.random.split(key, 3)
    key_img, key_pix = jax.random.split(key_batch)
    B = statics.ray_batch_size
    img = jax.random.randint(key_img, (B,), 0, num_images)
    pix = jax.random.randint(key_pix, (B,), 0, statics.image_height * statics.image_width)
    config, procedure = statics.render_config, statics.render_procedure
    diffuse = None
    if procedure == EXACT and statics.apply_diffuse_render_regularization:
        diffuse = _render_draws(key_diffuse, procedure, config, B)
    return trainer.RayBatchDraws(t(n_(img)).long(), t(n_(pix)).long(),
                                 _render_draws(key_specular, procedure, config, B), diffuse)


def _jax_statics(statics):
    return trainer_jax.TrainStepStatics(
        render_config=JaxConfig(**{**statics.render_config.__dict__,
                                   "camera_bounds": JaxBounds(
                                       *statics.render_config.camera_bounds)}),
        image_height=statics.image_height, image_width=statics.image_width,
        focal=statics.focal, ray_batch_size=statics.ray_batch_size,
        apply_diffuse_render_regularization=statics.apply_diffuse_render_regularization,
        render_procedure=statics.render_procedure)


def _statics(procedure=FAST, B=256, **cfg):
    config = SHVoxGridRenderConfig(num_samples_per_ray=32, camera_bounds=CameraBounds(1.5, 4.5),
                                   white_bkgd=True, fast_topk=16, **cfg)
    return trainer.TrainStepStatics(render_config=config, image_height=SIZE, image_width=SIZE,
                                    focal=FOCAL, ray_batch_size=B, render_procedure=procedure)


# ------------------------------------------------------------------------ batches


def test_sample_ray_pixel_batch_matches_jax():
    """The (image, pixel) pairs the JAX key draws give the same target
    pixels and ray origins, and directions equal to the JAX package's
    jitted step's bit for bit (the focal's f32 reciprocal, then the FMA
    chain of its rotation product); the port's own draws are in range."""
    images, poses = _views()
    statics = _statics(B=512)
    key = jax.random.PRNGKey(5)
    draws = _jax_step_draws(key, statics, len(images))
    sample = jax.jit(trainer_jax._sample_ray_pixel_batch, static_argnums=3)
    jr, jp = sample(jax.random.split(key, 3)[0], jnp.asarray(images), jnp.asarray(poses),
                    _jax_statics(statics))
    r, p = trainer.sample_ray_pixel_batch(t(images), t(poses), statics, draws.img_idx,
                                          draws.pix_idx)
    np.testing.assert_array_equal(p.numpy(), n_(jp))
    np.testing.assert_array_equal(r.origins.numpy(), n_(jr.origins))
    np.testing.assert_array_equal(r.directions.numpy(), n_(jr.directions))
    own = trainer.draw_ray_batch(torch.Generator().manual_seed(0), statics, len(images))
    assert own.img_idx.shape == own.pix_idx.shape == (512,)
    assert int(own.img_idx.min()) >= 0 and int(own.img_idx.max()) < len(images)
    assert int(own.pix_idx.max()) < SIZE * SIZE and len(set(own.img_idx.tolist())) == 5


def test_sample_random_rays_and_pixels_synchronously_matches_jax():
    """The indices jax.random.choice draws without replacement select the
    same rays and pixels in the port; drawn from a generator they are
    distinct, in range, and pair each ray with its pixel."""
    rng = np.random.default_rng(1)
    o, d = (rng.normal(size=(300, 3)).astype(np.float32) for _ in range(2))
    px = np.arange(300 * 3, dtype=np.float32).reshape(300, 3)
    key = jax.random.PRNGKey(3)
    jrays, jpx = rays_jax.sample_random_rays_and_pixels_synchronously(
        key, if_jax.Rays(jnp.asarray(o), jnp.asarray(d)), jnp.asarray(px), 64)
    idx = t(n_(jax.random.choice(key, 300, shape=(64,), replace=False)))
    got, gpx = rays.sample_random_rays_and_pixels_synchronously(Rays(t(o), t(d)), t(px), 64,
                                                                 idx=idx)
    np.testing.assert_array_equal(gpx.numpy(), n_(jpx))
    np.testing.assert_array_equal(got.directions.numpy(), n_(jrays.directions))
    np.testing.assert_array_equal(got.origins.numpy(), n_(jrays.origins))
    own, opx = rays.sample_random_rays_and_pixels_synchronously(
        Rays(t(o), t(d)), t(px), 64, torch.Generator().manual_seed(0))
    rows = (opx[:, 0] / 3).long()
    assert len(set(rows.tolist())) == 64
    torch.testing.assert_close(own.origins, t(o)[rows], rtol=0, atol=0)


# ---------------------------------------------------------------------- one step


def _grid_pair(seed=7, size=8, sh=27):
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1, 1, (size, size, size, 1)).astype(np.float32)
    f = rng.uniform(-1, 1, (size, size, size, sh)).astype(np.float32)
    vs = 2.0 / size
    jgrid = vox_jax.VoxelGrid(densities=jnp.asarray(d), features=jnp.asarray(f),
                              voxel_size=vox_jax.VoxelSize(vs, vs, vs), **_relu_config())
    tgrid = vox.VoxelGrid(t(d), t(f), voxel_size=vox.VoxelSize(vs, vs, vs), **_relu_config())
    return jgrid, tgrid


@pytest.mark.parametrize("procedure,cfg", [
    (FAST, dict(perturb_sampled_points=True)),
    (FAST, dict(perturb_sampled_points=True, optimized_sampling=True,
                stochastic_density_noise_std=0.5)),
    (EXACT, dict(perturb_sampled_points=True)),
    (HIER, dict(perturb_sampled_points=True)),
], ids=["fast", "fast_optimized_noise", "exact_two_renders", "hierarchical"])
def test_train_step_matches_jax(procedure, cfg):
    """One ray-batch step (256 rays, 32 samples, top 16, diffuse
    regularization, Adam lr 0.03) from the same 8^3 relu grid against the
    JAX package's jitted _train_step, the port fed the JAX key's draws:
    every metric (specular / diffuse loss and PSNR, total) within rtol 2e-5;
    Adam's first update is lr g / (|g| + eps), which turns a gradient's
    relative error e into lr e eps / |g| (eps 1e-8), so the grid after the
    step is held where |g| > 1e-5: equal within 1e-6 there, and the share
    of all elements off by more than 1e-3 within 1% (measured: 0)."""
    images, poses = _views()
    statics = _statics(procedure, **cfg)
    jgrid, tgrid = _grid_pair()
    key = jax.random.PRNGKey(11)
    tx = optax.adam(optax.exponential_decay(0.03, 3000, 0.1, staircase=True), b1=0.9, b2=0.999)
    jgrid_copy = jax.tree_util.tree_map(jnp.copy, jgrid)
    jnew, _, jm = trainer_jax._train_step(_jax_statics(statics), tx, jgrid_copy,
                                          tx.init(jgrid_copy), jnp.asarray(images),
                                          jnp.asarray(poses), key)
    before = {fld: getattr(tgrid, fld).detach().clone() for fld in ("densities", "features")}
    opt, sched = trainer.make_gnomonic_optimizer(tgrid, 0.03, 3000, 0.1)
    m = trainer.ray_batch_train_step(statics, opt, tgrid, t(images), t(poses),
                                     draws=_jax_step_draws(key, statics, len(images)),
                                     scheduler=sched)
    assert sorted(m) == sorted(jm) == sorted(["specular_loss", "specular_psnr", "diffuse_loss",
                                              "diffuse_psnr", "total_loss"])
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-5, err_msg=k)
    for fld in ("densities", "features"):
        got = getattr(tgrid, fld).detach().numpy()
        want = n_(getattr(jnew, fld))
        grad = getattr(tgrid, fld).grad.numpy()
        strong = np.abs(grad) > 1e-5
        diff = np.abs(got - want)
        print(f"{procedure} {cfg}: {fld} {strong.mean():.3f} of elements above the noise "
              f"level, max diff there {diff[strong].max():.3g}; share off by > 1e-3 "
              f"{(diff > 1e-3).mean():.4f}")
        assert strong.any() and not np.allclose(got, before[fld].numpy())
        assert diff[strong].max() <= 1e-6 and (diff > 1e-3).mean() <= 0.01


# -------------------------------------------------------------------- stage loop


def _fast_checkpoint(path):
    """An 8^3 relu model with the fast procedure (32 samples, top 16,
    jitter) saved by the JAX package with a fresh Adam state at stage 1,
    iteration 0; the port's config of the same values."""
    jgrid, _ = _grid_pair()
    kw = dict(num_samples_per_ray=32, white_bkgd=True, fast_topk=16)
    config = JaxConfig(camera_bounds=JaxBounds(1.5, 4.5), **kw)
    vm_jax.VolumetricModel(jgrid, render_procedure=FAST, render_config=config).save(
        path, extra_info={})
    tx = optax.adam(optax.exponential_decay(0.03, 3000, 0.1, staircase=True), b1=0.9, b2=0.999)
    trainer_jax.save_optimizer_state(path, tx.init(jgrid), 1, 0)
    return config, SHVoxGridRenderConfig(camera_bounds=CameraBounds(1.5, 4.5), **kw)


def test_stage_loop_matches_jax(tmp_path, monkeypatch):
    """The port's stage loop through the fast procedure against the JAX
    package's, two stages (8^3 -> 16^3, 2 steps each, 256 rays of 32
    samples, jitter), both resumed from one checkpoint the JAX package
    wrote: each port step is fed the draws of the JAX step's key (recorded
    from the JAX loop), the losses within rtol 2e-5 at the first step and
    1e-3 after; the final grids within the bricked stage-loop test's bounds
    (the share of elements off by more than 1e-3 below 25% of the densities
    and 10% of the features, none off by more than 8 lr)."""
    data = _write_dataset(tmp_path / "data", n_test=1)
    ckpt = tmp_path / "start" / "model_stage_1_iter_0"
    jconfig, tconfig = _fast_checkpoint(ckpt)
    common = dict(num_stages=2, num_iterations_per_stage=2, save_freq=100, test_freq=100,
                  feedback_freq=100, summary_freq=100, fast_debug_mode=True,
                  resume_from=ckpt, learning_rate=0.03, lr_decay_steps_per_stage=3000,
                  stagewise_lr_decay_gamma=1.0, ray_batch_size=256)
    keys, jlosses, tlosses = [], [], []
    original_j, original_t = trainer_jax._train_step, trainer.ray_batch_train_step

    def step_j(statics, tx, grid, opt_state, images, poses, key):
        out = original_j(statics, tx, grid, opt_state, images, poses, key)
        keys.append(key)
        jlosses.append(float(out[2]["total_loss"]))
        return out

    def step_t(statics, optimizer, grid, images, poses, generator=None, **kw):
        draws = _jax_step_draws(keys[len(tlosses)], statics, images.shape[0])
        out = original_t(statics, optimizer, grid, images, poses, draws=draws, **kw)
        tlosses.append(float(out["total_loss"]))
        return out

    monkeypatch.setattr(trainer_jax, "_train_step", step_j)
    monkeypatch.setattr(trainer, "ray_batch_train_step", step_t)
    ds = dict(images_dir=data / "train", camera_params_json=data / "train_camera_params.json",
              rgba_white_bkgd=True)
    big = vox_jax.VoxelGrid(densities=jnp.zeros((16, 16, 16, 1)),
                            features=jnp.zeros((16, 16, 16, 27)),
                            voxel_size=vox_jax.VoxelSize(0.125, 0.125, 0.125), **_relu_config())
    jmodel = trainer_jax.train_sh_vox_grid_vol_mod_with_posed_images(
        vm_jax.VolumetricModel(big, render_procedure=FAST, render_config=jconfig),
        JaxDataset(**ds), tmp_path / "jax", **common)
    tbig = vox.VoxelGrid(torch.zeros(16, 16, 16, 1), torch.zeros(16, 16, 16, 27),
                         voxel_size=vox.VoxelSize(0.125, 0.125, 0.125), **_relu_config())
    tmodel = trainer.train_sh_vox_grid_vol_mod_with_posed_images(
        vm.VolumetricModel(tbig, FAST, tconfig, device="cpu"), PosedImagesDataset(**ds),
        tmp_path / "port", **common)
    assert len(jlosses) == len(tlosses) == 4
    for i, (lt, lj) in enumerate(zip(tlosses, jlosses)):
        print(f"fast step {i + 1}: loss port {lt:.8f} JAX {lj:.8f}")
        np.testing.assert_allclose(lt, lj, rtol=2e-5 if i == 0 else 1e-3)
    for fld in ("densities", "features"):
        got = getattr(tmodel.thre3d_repr, fld).detach().numpy()
        want = n_(getattr(jmodel.thre3d_repr, fld))
        diff = np.abs(got - want)
        print(f"final {fld}: {(diff > 1e-3).mean():.4f} of elements off by > 1e-3, "
              f"max {diff.max():.3g}")
        assert got.shape == want.shape == (16, 16, 16, got.shape[-1])
        assert (diff > 1e-3).mean() < SHARE_BOUND[fld] and diff.max() <= 8 * 0.03


# --------------------------------------------------------------------------- CLI


@pytest.mark.parametrize("extra,procedure,post", [
    (["--render_procedure", FAST, "--test_frequency", "2", "--feedback_frequency", "2"],
     FAST, "relu"),
    (["--use_relu_field", "false", "--use_softplus_field", "true"], FAST, "softplus"),
    (["--render_procedure", HIER], HIER, "relu"),
    (["--render_procedure", EXACT, "--train_num_samples_per_ray", "16"], EXACT, "relu"),
], ids=["fast", "softplus_to_fast", "hierarchical", "exact"])
def test_cli_ray_batch_runs_write_checkpoints_the_jax_package_loads(tmp_path, extra,
                                                                   procedure, post):
    """main([...], device="cpu") through the ray-batch procedures, two
    stages (8^3 -> 16^3) of two steps: the fast renderer (with feedback
    renders and a held-out test, PSNR and LPIPS, through it), a softplus
    field routed from the gnomonic default to the fast renderer, the
    hierarchical and the exact renderers. Each writes finite losses, the
    JAX package's checkpoint names with their _opt.npz, and a model_final
    that the JAX package loads with the procedure, the density activation
    and the same arrays."""
    data = _write_dataset(tmp_path / "data")
    out = tmp_path / "out"
    args = ["-d", str(data), "-o", str(out), "--grid_dims", "16", "16", "16",
            "--num_stages", "2", "--num_iterations_per_stage", "2",
            "--data_downsample_factor", "1", "--grid_world_size", "2", "2", "2",
            "--ray_batch_size", "256", "--train_num_samples_per_ray", "32",
            "--fast_topk", "16", "--render_num_samples_per_ray", "64",
            "--save_frequency", "2", "--summary_frequency", "1", "--test_frequency", "100",
            "--feedback_frequency", "100"] + extra
    model = cli.main(args, device="cpu")
    assert model.render_procedure_name == procedure
    assert model.thre3d_repr.density_postactivation == post
    saved = out / "saved_models"
    for name in ("model_stage_1_iter_2", "model_stage_2_iter_4"):
        assert (saved / f"{name}.npz").exists() and (saved / f"{name}_opt.npz").exists()
    summaries = [json.loads(line) for line in
                 (out / "training_logs" / "summaries.jsonl").read_text().splitlines()]
    losses = [s["value"] for s in summaries if s["name"] == "total_loss"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    rays_per_sec = [s["value"] for s in summaries if s["name"] == "train_rays_per_sec"]
    assert rays_per_sec and all(v >= 0 for v in rays_per_sec)
    names = {s["name"] for s in summaries}
    if procedure == FAST and post == "relu":
        assert {"TEST_SET_PSNR", "TEST_SET_LPIPS_RAND"} <= names or \
            {"TEST_SET_PSNR", "TEST_SET_LPIPS"} <= names
        for name in ("specular_2.png", "diffuse_4.png"):
            assert (out / "training_logs" / "rendered_output" / name).exists()
    jmodel, _ = vm_jax.create_volumetric_model_from_saved_model(saved / "model_final")
    assert jmodel.render_procedure_name == procedure
    assert jmodel.thre3d_repr.density_postactivation == post
    for fld in ("densities", "features"):
        np.testing.assert_array_equal(n_(getattr(jmodel.thre3d_repr, fld)),
                                      getattr(model.thre3d_repr, fld).detach().numpy())
