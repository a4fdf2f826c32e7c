"""The PyTorch port's 3inFusion model and training CLI against the JAX
package: crops at JAX's offsets, the grid (de)serialization and scaling,
checkpoints loading across the packages both ways (with and without
checkpointing's block names), three train() steps against JAX's train()
with the port's draws patched to the ones JAX's step keys make, a CPU run
of the CLI with a sample mosaic, and the CLI's options against click's.

CPU tests: a 16^3 scene (SH degree 0, 4 grid channels), a UNet of width 8,
8 or 10 diffusion steps; inputs are made from seeds with numpy. Losses:
rtol 1e-5."""
import importlib.util
import json
import logging
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thr3ed_atom_tpu.diffusion import gaussian_diffusion as gd_jax
from thr3ed_atom_tpu.diffusion import model as model_jax
from thr3ed_atom_tpu.diffusion.unet import UNetModel as JaxUNet
from thr3ed_atom_tpu.models.voxels import VoxelGrid as JaxVoxelGrid, VoxelSize
from thr3ed_atom_tpu.modules import volumetric_model as vm_jax
from thr3ed_atom_tpu.rendering.renderer import SHVoxGridRenderConfig as JaxConfig
from thr3ed_atom_tpu.utils.camera import CameraBounds as JaxBounds
from thr3ed_atom_tpu_torch.apps import train_sh_voxel_grid as train_cli
from thr3ed_atom_tpu_torch.apps import train_thre3infusion as cli
from thr3ed_atom_tpu_torch.diffusion import gaussian_diffusion as gd
from thr3ed_atom_tpu_torch.diffusion import model as tmodel
from thr3ed_atom_tpu_torch.diffusion import unet as tunet
from thr3ed_atom_tpu_torch.modules import volumetric_model as vm

REPO = Path(__file__).resolve().parent.parent
N = 16  # the scene's grid side
UNET = dict(in_channels=4, model_channels=8, out_channels=4, num_res_blocks=1,
            attention_resolutions=(), channel_mult=(1, 2), dims=3, num_heads=2,
            use_scale_shift_norm=True, use_bottleneck_attn=True)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the suite runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(path):
    """A 16^3 relu-field scene of SH degree 0 saved by the JAX package with the
    exact procedure and the CLI's extra info (radius, 32 x 32 intrinsics)."""
    rng = np.random.default_rng(0)
    d = rng.uniform(-1, 1, (N, N, N, 1)).astype(np.float32)
    f = rng.uniform(-1, 1, (N, N, N, 3)).astype(np.float32)
    grid = JaxVoxelGrid(densities=jnp.asarray(d), features=jnp.asarray(f),
                        voxel_size=VoxelSize(2.0 / N, 2.0 / N, 2.0 / N),
                        density_preactivation="identity", density_postactivation="relu")
    config = JaxConfig(num_samples_per_ray=16, camera_bounds=JaxBounds(1.0, 6.0),
                       white_bkgd=True, perturb_sampled_points=False)
    vm_jax.VolumetricModel(grid, "render_sh_voxel_grid", config).save(
        path, {"hemispherical_radius": 3.5, "camera_intrinsics": [32, 32, 35.2]})
    return path


def _diffusions(steps=8):
    betas = gd.get_named_beta_schedule("cosine", steps)
    kw = dict(betas=betas, rescale_timesteps=False)
    return (gd_jax.GaussianDiffusion(model_mean_type=gd_jax.ModelMeanType.EPSILON,
                                     model_var_type=gd_jax.ModelVarType.FIXED_SMALL,
                                     loss_type=gd_jax.LossType.MSE, **kw),
            gd.GaussianDiffusion(model_mean_type=gd.ModelMeanType.EPSILON,
                                 model_var_type=gd.ModelVarType.FIXED_SMALL,
                                 loss_type=gd.LossType.MSE, **kw))


def _params(cfg, seed=3):
    """A perturbed flax tree for ``cfg`` (the zero-initialised convs would
    hide a path otherwise)."""
    tree = tunet.flax_params(tunet.UNetModel(**cfg, generator=torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a + (rng.normal(size=a.shape) * 0.05).astype(np.float32), tree)


def _jax_template(unet, spatial):
    """JAX's load_params template without flax's (slow, eager) init: zeros of
    the tree jax.eval_shape gives; load_params only reads its structure."""
    shapes = jax.eval_shape(unet.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, *spatial, unet.in_channels), jnp.float32),
                            jax.ShapeDtypeStruct((1,), jnp.int32))
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def _jax_model(cfg, diffusion):
    model = model_jax.Thre3inFusionModel(unet=JaxUNet(**cfg), diffusion=diffusion)

    def init_params(key, spatial):
        model.params = _jax_template(model.unet, spatial)
        return model.params

    model.init_params = init_params
    return model


# ------------------------------------------------------------------ crops


def test_random_crop_at_jax_offsets():
    """Crops at the offsets JAX draws equal JAX's crops; the port's own draws
    stay in [0, max(d - c, 1)) on each axis (the last offset is never drawn)."""
    grid = np.arange(10 * 9 * 8 * 3, dtype=np.float32).reshape(10, 9, 8, 3)
    key = jax.random.PRNGKey(5)
    crop = (4, 5, 8)
    want = model_jax.random_crop_3d_batch(key, jnp.asarray(grid), crop, 6)
    maxvals = jnp.array([max(d - c, 1) for d, c in zip(grid.shape[:3], crop)], jnp.int32)
    offsets = jax.random.randint(key, (6, 3), 0, maxvals[None, :])
    got = tmodel.crop_batch(torch.from_numpy(grid), torch.from_numpy(np.array(offsets)), crop)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    gen = torch.Generator().manual_seed(0)
    offs = tmodel.crop_offsets(gen, grid.shape[:3], crop, 4096)
    assert offs.shape == (4096, 3)
    for axis, hi in enumerate((6, 4, 1)):
        assert set(offs[:, axis].tolist()) == set(range(hi))
    crops = tmodel.random_crop_3d_batch(torch.Generator().manual_seed(1),
                                        torch.from_numpy(grid), crop, 3)
    for c in crops:
        o = [int(v) for v in np.argwhere(grid[..., 0] == float(c[0, 0, 0, 0]))[0]]
        np.testing.assert_array_equal(c.numpy(), grid[o[0]:o[0] + 4, o[1]:o[1] + 5, o[2]:o[2] + 8])
    # dynamic_slice's clamp of an offset past the end
    np.testing.assert_array_equal(
        tmodel.crop_batch(torch.from_numpy(grid), torch.tensor([[9, 0, 0]]), crop)[0].numpy(),
        grid[6:10, 0:5, 0:8])


def test_draw_train_step():
    gen = torch.Generator().manual_seed(2)
    p = torch.full((8,), 1 / 8)
    draws = tmodel.draw_train_step(gen, (16, 16, 16, 4), (14, 14, 14), 5, p)
    assert draws.offsets.shape == (5, 3) and int(draws.offsets.max()) <= 1
    assert draws.timesteps.shape == (5,) and int(draws.timesteps.max()) < 8
    assert draws.noise.shape == (5, 14, 14, 14, 4)
    again = tmodel.draw_train_step(torch.Generator().manual_seed(2), (16, 16, 16, 4),
                                   (14, 14, 14), 5, p)
    for a, b in zip(draws, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------------ serialization


def test_serialize_deserialize_and_scale_equal_jax(tmp_path):
    path = _scene(tmp_path / "scene")
    jvol, _ = vm_jax.create_volumetric_model_from_saved_model(path)
    pvol, _ = vm.create_volumetric_model_from_saved_model(path, device="cpu")
    jd, pd = _diffusions()
    jm = model_jax.Thre3inFusionModel(unet=JaxUNet(**UNET), diffusion=jd)
    pm = tmodel.Thre3inFusionModel(tunet.UNetModel(**UNET), pd, device="cpu")
    want = model_jax.Thre3inFusionModel.serialize_vol_mod_to_tensor_grid(jvol)
    got = tmodel.Thre3inFusionModel.serialize_vol_mod_to_tensor_grid(pvol)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    for m in (jm, pm):
        m.density_scale_range = (-0.75, 2.5)
        m.features_scale_range = (-1.25, 0.5)
        m.voxel_size = VoxelSize(0.1, 0.2, 0.3)
    grids = np.random.default_rng(1).uniform(-1, 1, (2, N, N, N, 4)).astype(np.float32)
    np.testing.assert_allclose(pm.scale_tensor_grids(torch.from_numpy(grids)).numpy(),
                               np.asarray(jm.scale_tensor_grids(jnp.asarray(grids))),
                               rtol=1e-5, atol=1e-6)
    jout = jm.deserialize_tensor_grid_to_vol_mod(jnp.asarray(grids[:1]))
    pout = pm.deserialize_tensor_grid_to_vol_mod(torch.from_numpy(grids[:1]))
    assert pout.render_procedure_name == jout.render_procedure_name
    assert pout.render_config.num_samples_per_ray == jout.render_config.num_samples_per_ray
    jg, pg = jout.thre3d_repr, pout.thre3d_repr
    for fld in ("densities", "features"):
        np.testing.assert_array_equal(getattr(pg, fld).numpy(), np.asarray(getattr(jg, fld)))
    for fld in ("voxel_size", "density_preactivation", "density_postactivation",
                "expected_density_scale", "feature_preactivation"):
        assert tuple(np.atleast_1d(getattr(pg, fld))) == tuple(np.atleast_1d(getattr(jg, fld)))


# ------------------------------------------------------------------ checkpoints


@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_checkpoints_load_across_packages(tmp_path, use_checkpoint):
    """The port's save_model loads in JAX's load_params to equal leaves, and
    JAX's save_model loads in the port's; the JSON halves agree."""
    cfg = dict(UNET, use_checkpoint=use_checkpoint)
    params = _params(cfg)
    jd, pd = _diffusions()
    port = tmodel.Thre3inFusionModel(tunet.UNetModel(**cfg), pd, device="cpu")
    assert port.params is None
    port.params = params
    port.density_scale_range = (-1.0, 5.0)
    port.save_model(tmp_path / "port_ckpt")
    jax_model = _jax_model(cfg, jd)
    jax_model.load_params(tmp_path / "port_ckpt", spatial=(8, 8, 8))
    names = set(jax_model.params["params"])
    assert ("CheckpointResBlock_2" in names) == use_checkpoint
    for a, b in zip(jax.tree_util.tree_leaves(jax_model.params),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)

    jax_model.params = jax.tree_util.tree_map(lambda a: a * 2.0, params)
    jax_model.density_scale_range = (-1.0, 5.0)
    jax_model.save_model(tmp_path / "jax_ckpt")
    other = tmodel.Thre3inFusionModel(tunet.UNetModel(**cfg), pd, device="cpu")
    other.load_params(tmp_path / "jax_ckpt")
    for a, b in zip(jax.tree_util.tree_leaves(other.params),
                    jax.tree_util.tree_leaves(jax_model.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert (json.loads((tmp_path / "port_ckpt.json").read_text())
            == json.loads((tmp_path / "jax_ckpt.json").read_text()))
    wrong = tmodel.Thre3inFusionModel(tunet.UNetModel(**dict(cfg, num_res_blocks=2)), pd,
                                      device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        wrong.load_params(tmp_path / "jax_ckpt")


# ------------------------------------------------------------------ training


class _Scalars:
    """Stands in for tensorboardX's SummaryWriter in the JAX package's train()."""

    def __init__(self, *_args, **_kw):
        _Scalars.seen = []

    def add_scalar(self, name, value, step):
        _Scalars.seen.append((name, float(value), step))


def _jax_step_draws(seed, steps, grid_shape, crop, batch, diffusion):
    """The offsets, timesteps and noise of each step of JAX's train() with
    ``seed``: its key chain and train_step's splits and draws."""
    key = jax.random.PRNGKey(seed)
    key, _ = jax.random.split(key)
    p = np.ones(diffusion.num_timesteps) / diffusion.num_timesteps
    maxvals = jnp.array([max(d - c, 1) for d, c in zip(grid_shape[:3], crop)], jnp.int32)
    draws = []
    for _ in range(steps):
        key, step_key = jax.random.split(key)
        crop_key, t_key, noise_key = jax.random.split(step_key, 3)
        offsets = jax.random.randint(crop_key, (batch, 3), 0, maxvals[None, :])
        t = jax.random.choice(t_key, diffusion.num_timesteps, (batch,),
                              p=jnp.asarray(p, jnp.float32))
        noise = jax.random.normal(noise_key, (batch, *crop, grid_shape[-1]))
        draws.append(tmodel.StepDraws(*(torch.from_numpy(np.array(a))
                                        for a in (offsets, t, noise))))
    return draws


def test_train_steps_equal_jax(tmp_path, monkeypatch):
    """Three steps of train() in both packages from the same parameters on
    the same crops, timesteps and noise: the losses within rtol 1e-5 and
    the first step's gradients with cosine > 0.99999. The parameters are
    compared where the first gradient stands clear of the two packages'
    disagreement (|g| > 100 x its largest gap): Adam's first step moves a
    parameter by about lr whatever its gradient's size, so a gradient below
    the gap may step either way."""
    path = _scene(tmp_path / "scene")
    cfg = dict(UNET, use_checkpoint=True)
    params = _params(cfg)
    jd, pd = _diffusions()
    kw = dict(crop_ratio=0.8, num_iters=3, batch_size=2, learning_rate=1e-3,
              loss_feedback_frequency=1, sample_frequency=100, save_frequency=100, seed=42)
    crop = (14, 14, 14)  # ceil((0.8 * 16^3) ** (1/3)) = 15, down to a multiple of 2

    import tensorboardX
    monkeypatch.setattr(tensorboardX, "SummaryWriter", _Scalars)
    jax_model = _jax_model(cfg, jd)
    jax_model.params = params
    jax_model.train(path, tmp_path / "jax_run", **kw)
    jax_losses = [v for name, v, _ in _Scalars.seen if name == "loss"]

    draws = _jax_step_draws(42, 3, (N, N, N, 4), crop, 2, jd)
    queue = list(draws)

    def patched(generator, grid_shape, crop_size, batch_size, timestep_p):
        assert tuple(crop_size) == crop and batch_size == 2 and tuple(grid_shape) == (N, N, N, 4)
        return queue.pop(0)

    monkeypatch.setattr(tmodel, "draw_train_step", patched)
    port = tmodel.Thre3inFusionModel(tunet.UNetModel(**cfg), pd, device="cpu")
    port.params = params
    port.train(path, tmp_path / "port_run", **kw)
    assert not queue
    summaries = [json.loads(line) for line in
                 (tmp_path / "port_run" / "tensorboard_logs" / "summaries.jsonl")
                 .read_text().splitlines()]
    assert [s["step"] for s in summaries] == [1, 2, 3]
    np.testing.assert_allclose([s["value"] for s in summaries], jax_losses, rtol=1e-5)

    # the first step's gradient in both packages
    grid = tmodel.Thre3inFusionModel.serialize_vol_mod_to_tensor_grid(
        vm.create_volumetric_model_from_saved_model(path, device="cpu")[0])[0]
    norm, d_range, f_range = tmodel.normalize_grid(grid)
    assert (d_range, f_range) == (port.density_scale_range, port.features_scale_range)
    assert tmodel.training_crop_side((N, N, N), 0.8, 2) == crop[0]
    batch = tmodel.crop_batch(norm, draws[0].offsets, crop)
    ref = tmodel.Thre3inFusionModel(tunet.UNetModel(**cfg), pd, device="cpu")
    ref.params = params
    pd.training_losses(ref.model_fn(), batch, draws[0].timesteps,
                       noise=draws[0].noise)["loss"].mean().backward()
    got_g = tunet.flax_leaves(tunet._map_tree(
        ref.unet.flax_tree(), lambda tensor, layout: tunet._to_flax(tensor.grad, layout)))
    unet_j = JaxUNet(**cfg)

    def jax_loss(p):
        return jd.training_losses(lambda x, t: unet_j.apply(p, x, t), jnp.asarray(batch.numpy()),
                                  jnp.asarray(draws[0].timesteps.numpy()), None,
                                  noise=jnp.asarray(draws[0].noise.numpy()))["loss"].mean()

    want_g = [np.asarray(g) for g in jax.tree_util.tree_leaves(jax.jit(jax.grad(jax_loss))(params))]
    a = np.concatenate([g.ravel() for g in got_g])
    b = np.concatenate([g.ravel() for g in want_g])
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.99999
    gap = np.abs(a - b).max()
    clear = np.abs(b) > 100 * gap
    assert clear.mean() > 0.5
    got_p = np.concatenate([np.ravel(v) for v in jax.tree_util.tree_leaves(port.params)])
    want_p = np.concatenate([np.ravel(np.asarray(v))
                             for v in jax.tree_util.tree_leaves(jax_model.params)])
    np.testing.assert_allclose(got_p[clear], want_p[clear], rtol=1e-5, atol=1e-5)
    assert (tmp_path / "port_run" / "saved_models" / "model_final.npz").exists()


# ------------------------------------------------------------------ the CLI


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_train_thre3infusion",
                                                  REPO / "apps" / "train_thre3infusion.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["jax_train_thre3infusion"] = module
    spec.loader.exec_module(module)
    return module.main


def test_cli_options_match_click():
    """Every option of the JAX package's click command exists in the port's
    parser with the same spellings, default, requiredness and choices, and
    nothing more; the boolean takes click's spellings."""
    actions = {a.dest: a for a in cli.build_parser()._actions if a.dest != "help"}
    params = {p.name: p for p in _jax_cli().params}
    assert set(actions) == set(params)
    for name, p in params.items():
        a = actions[name]
        assert sorted(a.option_strings) == sorted(p.opts), name
        assert a.required == p.required, name
        assert a.default == (None if p.required else p.default), name
        if hasattr(p.type, "choices"):
            assert tuple(a.choices) == tuple(p.type.choices), name
        if p.type.name == "boolean":
            assert a.type is train_cli.str2bool, name
    assert cli.build_parser().parse_args(["-i", "m", "-o", "o", "--use_checkpoint",
                                          "off"]).use_checkpoint is False


def test_cli_run_on_the_cpu(tmp_path, caplog):
    """main([...], device="cpu") on a 16^3 scene at width 8 and 8 steps:
    checkpoints at every step and a final one that JAX's load_params reads,
    the loss summaries, and one sample mosaic GIF through the scene's own
    render procedure, with no visualization failure logged."""
    path = _scene(tmp_path / "scene")
    out = tmp_path / "run"
    caplog.set_level(logging.INFO)
    model = cli.main(["-i", str(path), "-o", str(out), "--model_channels", "8",
                      "--num_heads", "2", "--num_timesteps", "8", "--batch_size", "2",
                      "--num_iters", "2", "--sample_frequency", "2", "--save_frequency", "1",
                      "--loss_feedback_frequency", "1", "--visualization_samples", "1"],
                     device="cpu")
    assert "sample visualization failed" not in caplog.text
    assert model.unet.in_channels == 4 and model.unet.channel_mult == (1, 2, 4, 8)
    assert model.unet.use_checkpoint and model.render_procedure_name == "render_sh_voxel_grid"
    gif = out / "generated_samples" / "samples_2.gif"
    data = gif.read_bytes()
    assert data[:6] == b"GIF89a" and data[-1:] == b"\x3b"
    assert int.from_bytes(data[6:8], "little") == 24  # 8 x 8 colour | depth | acc panels
    saved = out / "saved_models"
    for name in ("model_1", "model_2", "model_final"):
        assert (saved / f"{name}.npz").exists() and (saved / f"{name}.json").exists()
    steps = [json.loads(line)["step"] for line in
             (out / "tensorboard_logs" / "summaries.jsonl").read_text().splitlines()]
    assert steps == [1, 2]
    meta = json.loads((saved / "model_final.json").read_text())
    assert meta["num_timesteps"] == 8 and meta["unet_config"]["use_checkpoint"] is True
    jd, _ = _diffusions()
    jax_model = _jax_model(model.unet.config(), jd)
    jax_model.load_params(saved / "model_final", spatial=(8, 8, 8))
    for a, b in zip(jax.tree_util.tree_leaves(jax_model.params),
                    jax.tree_util.tree_leaves(model.params)):
        np.testing.assert_array_equal(np.asarray(a), b)
