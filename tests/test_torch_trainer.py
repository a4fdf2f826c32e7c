"""The PyTorch port's training CLI and coarse-to-fine stage loop against the
JAX package: the stage plan, trilinear growth, Adam state files in both
directions, config.yml, the CLI's options, a whole CLI run whose checkpoints
the JAX package loads, and the stage loop itself resumed from one JAX
checkpoint in both packages (qb = 128, the fused pipeline, qb = 0, the v2
stripe pipeline, and the bricked procedure's tile-based steps), and a CLI
run through the bricked procedure.

CPU tests: the JAX side runs its Pallas kernels in interpret mode, the port
its plain versions; tiny grids (8^3 -> 16^3), 24 x 24 views, one march
position per cell. Inputs are made from seeds with numpy."""
import importlib.util
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from thr3ed_atom_tpu.models import voxels as vox_jax
from thr3ed_atom_tpu.modules import bricked_trainer as bt_jax
from thr3ed_atom_tpu.modules import trainer as trainer_jax
from thr3ed_atom_tpu.modules import volumetric_model as vm_jax
from thr3ed_atom_tpu.rendering import gnomonic_train as gt_jax
from thr3ed_atom_tpu.rendering.renderer import SHVoxGridRenderConfig as JaxConfig
from thr3ed_atom_tpu.utils import misc as misc_jax
from thr3ed_atom_tpu.utils.camera import CameraBounds as JaxBounds
from thr3ed_atom_tpu_torch.apps import train_sh_voxel_grid as cli
from thr3ed_atom_tpu_torch.data.dataset import PosedImagesDataset
from thr3ed_atom_tpu_torch.data.png import write_png
from thr3ed_atom_tpu_torch.models import voxels as vox
from thr3ed_atom_tpu_torch.modules import bricked_trainer as bt
from thr3ed_atom_tpu_torch.modules import trainer
from thr3ed_atom_tpu_torch.modules import volumetric_model as vm
from thr3ed_atom_tpu_torch.rendering import gnomonic_train as gt
from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
from thr3ed_atom_tpu_torch.utils import misc
from thr3ed_atom_tpu_torch.utils.camera import CameraBounds, pose_spherical

REPO = Path(__file__).resolve().parent.parent
SIZE, FOCAL = 24, 30.0
PROC = "render_sh_voxel_grid_gnomonic"
BRICKED = "render_sh_voxel_grid_bricked"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the suite runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_train_sh_voxel_grid",
                                                  REPO / "apps" / "train_sh_voxel_grid.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["jax_train_sh_voxel_grid"] = module
    spec.loader.exec_module(module)
    return module.main


def _write_dataset(root, n_train=6, n_test=2, seed=0, size=SIZE):
    """Views in the JAX package's on-disk layout (RGBA PNGs, camera JSON per
    split), ``size`` pixels a side; the training views share one march
    variant."""
    rng = np.random.default_rng(seed)
    for mode, n in (("train", n_train), ("test", n_test)):
        d = Path(root) / mode
        d.mkdir(parents=True)
        params = {}
        for i in range(n):
            name = f"r_{i}.png"
            img = rng.integers(0, 256, (size, size, 4)).astype(np.uint8)
            img[..., 3] = np.where(rng.random((size, size)) < 0.5, 255, img[..., 3])
            write_png(d / name, img)
            pose = pose_spherical(40.0 + 4.0 * i, -30.0 - 2.0 * i, 3.0)
            params[name] = {
                "intrinsic": {"bounds": [1.5, 4.5], "height": size, "width": size,
                              "focal": FOCAL * size / SIZE},
                "extrinsic": {
                    "rotation": np.asarray(pose.rotation, np.float32).reshape(3, 3).tolist(),
                    "translation": np.asarray(pose.translation,
                                              np.float32).reshape(3, 1).tolist(),
                },
            }
        (Path(root) / f"{mode}_camera_params.json").write_text(json.dumps(params))
    return Path(root)


@pytest.mark.parametrize("dims,stages,factor", [((256, 256, 256), 4, 2.0),
                                                ((100, 60, 33), 3, 2.0),
                                                ((128, 128, 96), 2, 1.5)])
def test_grid_sizes_match_jax(dims, stages, factor):
    """compute_thre3d_grid_sizes equals the JAX package's."""
    assert (list(misc.compute_thre3d_grid_sizes(dims, stages, factor))
            == list(misc_jax.compute_thre3d_grid_sizes(dims, stages, factor)))


def test_trilinear_growth_matches_jax():
    """scale_voxel_grid_with_required_output_size (F.interpolate, half-texel
    positions) against the JAX package's jax.image.resize on an upscale:
    values within 1e-6, the voxel size and configuration equal; the AABB is
    kept."""
    rng = np.random.default_rng(0)
    d = rng.uniform(-1, 1, (6, 7, 5, 1)).astype(np.float32)
    f = rng.uniform(-1, 1, (6, 7, 5, 12)).astype(np.float32)
    cfg = dict(voxel_size=(0.5, 0.4, 0.6), grid_location=(0.1, -0.2, 0.3),
               density_preactivation="identity", density_postactivation="relu",
               feature_preactivation="identity", feature_postactivation="identity",
               expected_density_scale=2.5, radiance_transfer_function=None)
    tgrid = vox.voxel_grid_from_numpy(d, f, cfg, device="cpu")
    jgrid = vox_jax.VoxelGrid(densities=jnp.asarray(d), features=jnp.asarray(f),
                              voxel_size=vox_jax.VoxelSize(*cfg["voxel_size"]),
                              grid_location=vox_jax.VoxelGridLocation(*cfg["grid_location"]),
                              density_preactivation="identity",
                              density_postactivation="relu", expected_density_scale=2.5)
    for size in ((12, 14, 10), (13, 7, 11)):
        got = vox.scale_voxel_grid_with_required_output_size(tgrid, size)
        want = vox_jax.scale_voxel_grid_with_required_output_size(jgrid, size)
        assert got.grid_dims == size
        for fld in ("densities", "features"):
            np.testing.assert_allclose(getattr(got, fld).numpy(),
                                       np.asarray(getattr(want, fld)), atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.voxel_size, want.voxel_size, rtol=1e-7)
        assert got.get_config_dict() == tgrid.get_config_dict()
        np.testing.assert_allclose(np.asarray(got.aabb), np.asarray(tgrid.aabb), rtol=1e-6)


def test_optimizer_state_files_both_ways(tmp_path):
    """_opt.npz in both directions: the port loads the Adam moments, count and
    schedule that optax wrote after three steps, and its next step equals
    optax's (rtol 1e-5); the JAX package's load_optimizer_state takes the
    file the port writes and finds the same leaves (rtol 1e-5: torch
    updates the moments with a lerp, optax with a multiply-add)."""
    rng = np.random.default_rng(1)
    d0 = rng.uniform(-1, 1, (4, 5, 6, 1)).astype(np.float32)
    f0 = rng.uniform(-1, 1, (4, 5, 6, 27)).astype(np.float32)
    grads = [(rng.normal(size=d0.shape).astype(np.float32),
              rng.normal(size=f0.shape).astype(np.float32)) for _ in range(4)]
    jgrid = vox_jax.VoxelGrid(densities=jnp.asarray(d0), features=jnp.asarray(f0),
                              voxel_size=vox_jax.VoxelSize(1.0, 1.0, 1.0))
    tx = optax.adam(optax.exponential_decay(0.03, 2, 0.1, staircase=True), b1=0.9, b2=0.999)
    state = tx.init(jgrid)
    for gd, gf in grads[:3]:
        g = jgrid.__class__(**{**jgrid.__dict__, "densities": jnp.asarray(gd),
                               "features": jnp.asarray(gf)})
        updates, state = tx.update(g, state, jgrid)
        jgrid = optax.apply_updates(jgrid, updates)
    ckpt = tmp_path / "model_stage_2_iter_7"
    trainer_jax.save_optimizer_state(ckpt, state, 2, 7)

    tgrid = vox.VoxelGrid(torch.from_numpy(np.asarray(jgrid.densities).copy()),
                          torch.from_numpy(np.asarray(jgrid.features).copy()))
    opt, sched = trainer.make_gnomonic_optimizer(tgrid, 0.03, 2, 0.1)
    assert trainer.load_optimizer_state(Path(str(ckpt) + ".npz"), opt, sched) == (2, 7)
    assert sched.get_last_lr()[0] == pytest.approx(0.003, rel=1e-6)
    gd, gf = grads[3]
    g = jgrid.__class__(**{**jgrid.__dict__, "densities": jnp.asarray(gd),
                           "features": jnp.asarray(gf)})
    updates, state = tx.update(g, state, jgrid)
    jgrid = optax.apply_updates(jgrid, updates)
    tgrid.densities.grad, tgrid.features.grad = torch.from_numpy(gd), torch.from_numpy(gf)
    opt.step()
    sched.step()
    for fld in ("densities", "features"):
        np.testing.assert_allclose(getattr(tgrid, fld).detach().numpy(),
                                   np.asarray(getattr(jgrid, fld)), rtol=1e-5, atol=1e-6)

    out = tmp_path / "port_ckpt"
    trainer.save_optimizer_state(out, opt, 3, 4)
    restored = trainer_jax.load_optimizer_state(out, tx.init(jgrid))
    assert restored is not None and restored[1:] == (3, 4)
    want = jax.tree_util.tree_leaves(state)
    got = jax.tree_util.tree_leaves(restored[0])
    assert [np.asarray(x).dtype for x in got] == [np.asarray(x).dtype for x in want]
    for a, b in zip(got, want):  # torch's moment update rounds as a lerp
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-7)
    # a file for other shapes is refused and changes nothing
    small = vox.VoxelGrid(torch.zeros(2, 2, 2, 1), torch.zeros(2, 2, 2, 27))
    opt2, _ = trainer.make_gnomonic_optimizer(small)
    assert trainer.load_optimizer_state(out, opt2) is None and not opt2.state


def test_config_yml_loads_with_yaml(tmp_path):
    """log_config_to_disk's emitter: yaml.safe_load reads the CLI's config back
    to the same dict (sequences as lists, paths as strings)."""
    config = vars(cli.build_parser().parse_args(["-d", str(tmp_path / "d x"), "-o", "o:1"]))
    config.update(learning_rate=1e-05, scale_factor=2.0, resume_from=None,
                  profile_dir="true", grid_dims=(64, 64, 32), path=tmp_path / "p",
                  empty=[], weird='a "quoted" #hash: x\n', big=1.5e300, neg=-0.0)
    misc.log_config_to_disk(config, tmp_path)
    loaded = yaml.safe_load((tmp_path / "config.yml").read_text())
    want = {k: (list(v) if isinstance(v, tuple) else str(v) if isinstance(v, Path) else v)
            for k, v in config.items()}
    assert loaded == want


def test_cli_options_match_click():
    """Every option of the JAX package's click command exists in the port's
    parser with the same spellings, default, arity, requiredness and
    choices, and nothing more; booleans take click's spellings."""
    actions = {a.dest: a for a in cli.build_parser()._actions if a.dest != "help"}
    params = {p.name: p for p in _jax_cli().params}
    assert set(actions) == set(params)
    for name, p in params.items():
        a = actions[name]
        assert sorted(a.option_strings) == sorted(p.opts), name
        assert a.required == p.required, name
        assert (a.nargs or 1) == p.nargs, name
        want = None if p.required else p.default  # click marks a missing default
        assert (tuple(a.default) if isinstance(a.default, (list, tuple)) else a.default) == (
            tuple(want) if isinstance(want, (list, tuple)) else want), name
        if hasattr(p.type, "choices"):
            assert tuple(a.choices) == tuple(p.type.choices), name
        if p.type.name == "boolean":
            assert a.type is cli.str2bool, name
    for text, value in (("true", True), ("False", False), ("1", True), ("off", False)):
        assert cli.str2bool(text) is value
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["-d", "x", "-o", "y", "--data_downsample_factor", "0.5"])


def test_cli_run_writes_checkpoints_the_jax_package_loads(tmp_path):
    """main([...], device="cpu"): a two-stage run (8^3 -> 16^3) writes
    config.yml, the JAX package's checkpoint names with their _opt.npz, the
    summaries under the JAX package's scalar names, feedback PNGs and a
    model_final that create_volumetric_model_from_saved_model of the JAX
    package loads with the same arrays; the fast renderer, SH degree 4 and
    softplus fields train through ray batches (the last two routed to the
    fast renderer, as the JAX CLI routes them) into checkpoints the JAX
    package loads; --use_mesh true, launched without torchrun, trains over a
    one-rank gloo group through the mesh step into the same model_final,
    bit for bit, and leaves no group behind."""
    data = _write_dataset(tmp_path / "data")
    out = tmp_path / "out"
    args = ["-d", str(data), "-o", str(out), "--grid_dims", "16", "16", "16",
            "--num_stages", "2", "--num_iterations_per_stage", "2",
            "--gnomonic_pos_per_cell", "1", "--data_downsample_factor", "1",
            "--grid_world_size", "2", "2", "2", "--gnomonic_poses_per_step", "2",
            "--save_frequency", "2", "--summary_frequency", "1", "--test_frequency", "4",
            "--feedback_frequency", "4"]
    model = cli.main(args, device="cpu")
    assert model.thre3d_repr.grid_dims == (16, 16, 16)
    assert model.thre3d_repr.device.type == "cpu"
    cfg = yaml.safe_load((out / "config.yml").read_text())
    assert cfg["grid_dims"] == [16, 16, 16] and cfg["gnomonic_qb"] == 128
    saved = out / "saved_models"
    for name in ("model_stage_1_iter_1", "model_stage_1_iter_2", "model_stage_2_iter_3",
                 "model_stage_2_iter_4", "model_final"):
        assert (saved / f"{name}.npz").exists() and (saved / f"{name}.json").exists()
        if name != "model_final":
            assert (saved / f"{name}_opt.npz").exists()
    names = {json.loads(line)["name"]
             for line in (out / "training_logs" / "summaries.jsonl").read_text().splitlines()}
    assert {"total_loss", "specular_loss", "diffuse_psnr", "num_epochs",
            "train_rays_per_sec", "TEST_SET_PSNR"} <= names
    renders = out / "training_logs" / "rendered_output"
    for name in ("1__real_log.png", "specular_1.png", "diffuse_4.png"):
        assert (renders / name).exists()
    jmodel, extra = vm_jax.create_volumetric_model_from_saved_model(saved / "model_final")
    for fld in ("densities", "features"):
        np.testing.assert_array_equal(np.asarray(getattr(jmodel.thre3d_repr, fld)),
                                      getattr(model.thre3d_repr, fld).detach().numpy())
    assert jmodel.render_config.gnomonic_qb == 128 and "hemispherical_radius" in extra
    # the fast renderer, SH degree 4 and softplus fields (both routed from the
    # gnomonic default to the fast renderer) train through ray batches
    ray_args = ["--ray_batch_size", "128", "--train_num_samples_per_ray", "16",
                "--fast_topk", "8", "--fast_debug_mode", "true"]
    for i, extra in enumerate((["--render_procedure", "render_sh_voxel_grid_fast"],
                               ["--sh_degree", "4"], ["--use_softplus_field", "true"])):
        run_args = args[:3] + [str(tmp_path / f"out_{i}")] + args[4:] + ray_args + extra
        fast_model = cli.main(run_args, device="cpu")
        assert fast_model.render_procedure_name == "render_sh_voxel_grid_fast"
        assert fast_model.thre3d_repr.grid_dims == (16, 16, 16)
        assert fast_model.thre3d_repr.num_features == (75 if "--sh_degree" in extra else 27)
        jfast, _ = vm_jax.create_volumetric_model_from_saved_model(
            tmp_path / f"out_{i}" / "saved_models" / "model_final")
        assert jfast.render_procedure_name == "render_sh_voxel_grid_fast"
    import torch.distributed as dist

    mesh_args = args[:3] + [str(tmp_path / "out_mesh")] + args[4:]
    mesh_model = cli.main(mesh_args + ["--use_mesh", "true"], device="cpu")
    assert not dist.is_initialized()
    for fld in ("densities", "features"):
        np.testing.assert_array_equal(getattr(mesh_model.thre3d_repr, fld).detach().numpy(),
                                      getattr(model.thre3d_repr, fld).detach().numpy())


def _relu_config():
    return dict(density_preactivation="identity", density_postactivation="relu",
                expected_density_scale=misc.compute_expected_density_scale_for_relu_field_grid(
                    (2.0, 2.0, 2.0)))


def _jax_checkpoint(path, qb, proc=PROC):
    """An 8^3 model (uniform(-1, 1) from a seed, the CLI's relu field) saved by
    the JAX package with a fresh Adam state at stage 1, iteration 0."""
    rng = np.random.default_rng(7)
    d = rng.uniform(-1, 1, (8, 8, 8, 1)).astype(np.float32)
    f = rng.uniform(-1, 1, (8, 8, 8, 27)).astype(np.float32)
    grid = vox_jax.VoxelGrid(densities=jnp.asarray(d), features=jnp.asarray(f),
                             voxel_size=vox_jax.VoxelSize(0.25, 0.25, 0.25), **_relu_config())
    config = JaxConfig(num_samples_per_ray=64, camera_bounds=JaxBounds(1.5, 4.5),
                       perturb_sampled_points=False, white_bkgd=True,
                       gnomonic_pos_per_cell=1, gnomonic_qb=qb)
    model = vm_jax.VolumetricModel(grid, render_procedure=proc, render_config=config)
    model.save(path, extra_info={})
    tx = optax.adam(optax.exponential_decay(0.03, 3000, 0.1, staircase=True), b1=0.9, b2=0.999)
    trainer_jax.save_optimizer_state(path, tx.init(grid), 1, 0)
    return config


SHARE_BOUND = {"densities": 0.25, "features": 0.10}


def _record(monkeypatch, module, calls, jax_side):
    """Wrap ``module.gnomonic_train_step_multi`` to record each step's
    rotations and loss."""
    original = module.gnomonic_train_step_multi

    def step(tstat, *args, **kw):
        out = original(tstat, *args, **kw)
        # (tx, grid, opt_state, images, rotations, ...) or (optimizer, grid,
        # images, rotations, ...)
        rotations = args[4] if jax_side else args[3]
        metrics = out[2] if jax_side else out
        calls.append((np.asarray(rotations), float(metrics["total_loss"]), tstat.fused))
        return out

    monkeypatch.setattr(module, "gnomonic_train_step_multi", step)


def _record_bricked(monkeypatch, calls, keys):
    """Wrap both packages' bricked_train_step to record each step's march
    variant, per-tile views and loss (and the JAX step's key in ``keys``);
    the port's draw_tiles returns the tiles and theta that the JAX step drew
    from the same step's key."""
    original_j, original_t = bt_jax.bricked_train_step, bt.bricked_train_step

    def step_j(statics, tx, grid, opt_state, images, poses, pose_idx, key):
        out = original_j(statics, tx, grid, opt_state, images, poses, pose_idx, key)
        keys.append(key)
        calls["jax"].append(((statics.bricked.axis, statics.bricked.flip),
                             np.asarray(pose_idx), float(out[2]["total_loss"])))
        return out

    def step_t(statics, optimizer, grid, images, poses, pose_idx, *args, **kw):
        out = original_t(statics, optimizer, grid, images, poses, pose_idx, *args, **kw)
        calls["port"].append(((statics.bricked.axis, statics.bricked.flip),
                              pose_idx.cpu().numpy(), float(out["total_loss"])))
        return out

    def draws(generator, statics):
        key_tiles, key_theta = jax.random.split(keys[len(calls["port"])])
        key_y, key_x = jax.random.split(key_tiles)
        tp, nt = statics.bricked.tile_px, statics.num_tiles
        ty = jax.random.randint(key_y, (nt,), 0, statics.image_height - tp + 1)
        tx = jax.random.randint(key_x, (nt,), 0, statics.image_width - tp + 1)
        theta = jax.random.uniform(key_theta, (), minval=0.05, maxval=0.95)
        return (torch.from_numpy(np.asarray(ty)).long(),
                torch.from_numpy(np.asarray(tx)).long(), torch.tensor(float(theta)))

    monkeypatch.setattr(bt_jax, "bricked_train_step", step_j)
    monkeypatch.setattr(bt, "bricked_train_step", step_t)
    monkeypatch.setattr(bt, "draw_tiles", draws)


@pytest.mark.parametrize("qb", [128, 0, "bricked"])
def test_stage_loop_matches_jax(tmp_path, monkeypatch, qb):
    """The port's stage loop against the JAX package's, two stages (8^3 ->
    16^3, 2 steps each), both resumed from one checkpoint the JAX package
    wrote (stage 1, iteration 0, fresh Adam), no phase jitter.

    Gnomonic (qb = 128, the fused pipeline; qb = 0, the v2 stripe pipeline;
    2 views a step, 24 x 24 views): the same views at every step (the pose
    picker's draws), the same pipeline, losses within rtol 2e-5 at the first
    step and 1e-3 after (measured 1.7e-5 at step 2 and 2.7e-5 at step 4: the
    grid gradients agree to cosine ~1 - 1e-8, but Adam's g / |g| turns
    noise-level gradient differences into full steps of lr on a few
    elements, 1% of the 8^3 densities after the first step). Final grids:
    the trilinear growth spreads each such element over its neighbours, so
    the share of elements off by more than 1e-3 is bounded by 25% of the
    densities and 10% of the features (measured 8.7% and 2.0%), and no
    element is off by more than 8 lr (lr 0.03, 4 steps; measured 0.104).

    Bricked (2 tiles of 16 x 16 a step from 32 x 32 views, 16 x 16 at the
    first stage): the same march variant and the same view for every tile at
    every step (the pose picker's draws), the port fed the tiles and theta
    the JAX step drew from its step key; losses and final grids within the
    same bounds (measured: losses rtol <= 4.4e-7; 1.6% of the densities off
    by more than 1e-3, max 0.0076)."""
    bricked = qb == "bricked"
    proc = BRICKED if bricked else PROC
    data = _write_dataset(tmp_path / "data", n_test=1, size=32 if bricked else SIZE)
    ckpt = tmp_path / "start" / "model_stage_1_iter_0"
    jconfig = _jax_checkpoint(ckpt, 128 if bricked else qb, proc)
    common = dict(num_stages=2, num_iterations_per_stage=2, save_freq=100, test_freq=100,
                  feedback_freq=100, summary_freq=100, fast_debug_mode=True,
                  resume_from=ckpt, gnomonic_poses_per_step=2, learning_rate=0.03,
                  lr_decay_steps_per_stage=3000, stagewise_lr_decay_gamma=1.0,
                  ray_batch_size=512)

    from thr3ed_atom_tpu.data.dataset import PosedImagesDataset as JaxDataset

    jcalls, tcalls = [], []
    bcalls, keys = {"jax": [], "port": []}, []
    if bricked:
        _record_bricked(monkeypatch, bcalls, keys)
    else:
        _record(monkeypatch, gt_jax, jcalls, True)
        _record(monkeypatch, gt, tcalls, False)
    ds = dict(images_dir=data / "train", camera_params_json=data / "train_camera_params.json",
              rgba_white_bkgd=True)
    big = vox_jax.VoxelGrid(densities=jnp.zeros((16, 16, 16, 1)),
                            features=jnp.zeros((16, 16, 16, 27)),
                            voxel_size=vox_jax.VoxelSize(0.125, 0.125, 0.125), **_relu_config())
    t0 = time.perf_counter()
    jmodel = trainer_jax.train_sh_vox_grid_vol_mod_with_posed_images(
        vm_jax.VolumetricModel(big, render_procedure=proc, render_config=jconfig),
        JaxDataset(**ds), tmp_path / "jax", **common)

    t1 = time.perf_counter()
    tbig = vox.VoxelGrid(torch.zeros(16, 16, 16, 1), torch.zeros(16, 16, 16, 27),
                         voxel_size=vox.VoxelSize(0.125, 0.125, 0.125), **_relu_config())
    tconfig = SHVoxGridRenderConfig(num_samples_per_ray=64, camera_bounds=CameraBounds(1.5, 4.5),
                                    perturb_sampled_points=False, white_bkgd=True,
                                    gnomonic_pos_per_cell=1,
                                    gnomonic_qb=128 if bricked else qb)
    tmodel = trainer.train_sh_vox_grid_vol_mod_with_posed_images(
        vm.VolumetricModel(tbig, proc, tconfig, device="cpu"), PosedImagesDataset(**ds),
        tmp_path / "port", **common)

    print(f"JAX {t1 - t0:.1f} s, port {time.perf_counter() - t1:.1f} s")
    if bricked:
        assert len(bcalls["jax"]) == len(bcalls["port"]) == 4
        for i, ((vj, pj, lj), (vt, pt, lt)) in enumerate(zip(bcalls["jax"], bcalls["port"])):
            assert vt == vj
            np.testing.assert_array_equal(pt, pj)
            assert len(pt) == 2
            print(f"bricked step {i + 1}: loss port {lt:.8f} JAX {lj:.8f}")
            np.testing.assert_allclose(lt, lj, rtol=2e-5 if i == 0 else 1e-3)
    else:
        assert len(jcalls) == len(tcalls) == 4
        for i, ((rj, lj, fj), (rt, lt, ft)) in enumerate(zip(jcalls, tcalls)):
            np.testing.assert_array_equal(rt, rj)
            assert fj == ft == (qb > 0)
            print(f"qb={qb} step {i + 1}: loss port {lt:.8f} JAX {lj:.8f}")
            np.testing.assert_allclose(lt, lj, rtol=2e-5 if i == 0 else 1e-3)
    for fld in ("densities", "features"):
        got = getattr(tmodel.thre3d_repr, fld).detach().numpy()
        want = np.asarray(getattr(jmodel.thre3d_repr, fld))
        diff = np.abs(got - want)
        print(f"qb={qb} final {fld}: {(diff > 1e-3).mean():.4f} of elements off by > 1e-3, "
              f"max {diff.max():.3g}")
        assert got.shape == want.shape == (16, 16, 16, got.shape[-1])
        assert (diff > 1e-3).mean() < SHARE_BOUND[fld] and diff.max() <= 8 * 0.03


def test_bricked_cli_run_writes_checkpoints_the_jax_package_loads(tmp_path):
    """main([..., "--render_procedure", "render_sh_voxel_grid_bricked"],
    device="cpu"): two stages (8^3 -> 16^3) of tile-based steps on 32 x 32
    views (2 tiles a step), feedback renders and a held-out test through the
    bricked render, checkpoints that the JAX package loads with the bricked
    procedure and the same arrays; SH degree 3 is routed to the gnomonic
    procedure and softplus fields to the fast renderer, as the JAX CLI
    routes them."""
    data = _write_dataset(tmp_path / "data", size=32)
    out = tmp_path / "out"
    args = ["-d", str(data), "-o", str(out), "--grid_dims", "16", "16", "16",
            "--num_stages", "2", "--num_iterations_per_stage", "2",
            "--data_downsample_factor", "1", "--grid_world_size", "2", "2", "2",
            "--ray_batch_size", "512", "--save_frequency", "2", "--summary_frequency", "1",
            "--test_frequency", "4", "--feedback_frequency", "4",
            "--render_procedure", BRICKED]
    model = cli.main(args, device="cpu")
    assert model.render_procedure_name == BRICKED and model.thre3d_repr.grid_dims == (16,) * 3
    saved = out / "saved_models"
    for name in ("model_stage_1_iter_2", "model_stage_2_iter_4"):
        assert (saved / f"{name}_opt.npz").exists()
    summaries = [json.loads(line) for line in
                 (out / "training_logs" / "summaries.jsonl").read_text().splitlines()]
    losses = [s["value"] for s in summaries if s["name"] == "total_loss"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert any(s["name"] == "TEST_SET_PSNR" for s in summaries)
    assert (out / "training_logs" / "rendered_output" / "diffuse_4.png").exists()
    jmodel, _ = vm_jax.create_volumetric_model_from_saved_model(saved / "model_final")
    assert jmodel.render_procedure_name == BRICKED
    for fld in ("densities", "features"):
        np.testing.assert_array_equal(np.asarray(getattr(jmodel.thre3d_repr, fld)),
                                      getattr(model.thre3d_repr, fld).detach().numpy())
    assert cli.resolve_render_procedure(BRICKED, 3, False) == PROC
    assert cli.resolve_render_procedure(BRICKED, 2, False) == BRICKED
    assert cli.resolve_render_procedure(BRICKED, 2, True) == "render_sh_voxel_grid_fast"
