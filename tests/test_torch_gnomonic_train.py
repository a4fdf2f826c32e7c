"""The PyTorch port's gnomonic train step against the JAX package: the
whole-pose loss and its grid gradient with phase jitter, one multi-pose Adam
step with the staircase decay, and the occupancy gating's losslessness.

CPU tests on tests/test_torch_gnomonic.py's carved 16^3 relu scene (SH degree
2) at 64 x 64 pixels, P = 2, the diffuse regularization on, the Catmull-Rom
matmul warp and white background: the JAX side runs its Pallas kernels in
interpret mode, the port its plain versions. Grids cross over with
voxel_grid_from_numpy from the same numpy arrays; the phase jitter's two
numbers come from the JAX key and go to both packages."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_gnomonic import _grids, _one_torch_thread, _pose_arrays  # noqa: F401
from test_torch_train_ops import _rel_stats, t
from thr3ed_atom_tpu.rendering import gnomonic_train as gt_jax
from thr3ed_atom_tpu_torch.modules import trainer
from thr3ed_atom_tpu_torch.rendering import gnomonic as gn
from thr3ed_atom_tpu_torch.rendering import gnomonic_train as gt
from thr3ed_atom_tpu_torch.utils.metrics import mse2psnr

H = W = 64
FOCAL = 70.0


def _statics(jgrid, tgrid, rot, P=2):
    axis, flip = gn.dominant_axis_for_pose(rot)
    kw = dict(image_height=H, image_width=W, white_bkgd=True,
              apply_diffuse_render_regularization=True, pos_per_cell=P, qb=128)
    tj = gt_jax.make_gnomonic_train_statics(jgrid, axis, flip, interpret=True,
                                            fused=True, **kw)
    tt = gt.make_gnomonic_train_statics(tgrid, axis, flip, **kw)
    assert tj.fused and tt.frame == tj.frame and tt.supersample == tj.supersample
    return tj, tt


def _target(seed=0, k=None):
    rng = np.random.default_rng(seed)
    shape = (H, W, 3) if k is None else (k, H, W, 3)
    return rng.random(shape, dtype=np.float32)


def _phase(key):
    return tuple(float(x) for x in jax.random.uniform(key, (2,), minval=-0.5, maxval=0.5))


def _grad_stats(tgrid, jgrads):
    out = {}
    for fld in ("densities", "features"):
        out[fld] = _rel_stats(getattr(tgrid, fld).grad.numpy(),
                              np.asarray(getattr(jgrads, fld)))
    return out


def test_pose_loss_and_grid_gradient_match_jax():
    """The whole-pose loss (specular + diffuse L1) with phase jitter: value
    within rtol 2e-5 of the JAX package's, and its gradient with respect to
    the grid within cosine > 0.99995 and p999 relative error < 0.12 with
    tests/test_gnomonic_train.py's denominator (its bound between the JAX
    package's own fused and v2 kernels, whose bf16 schedules differ as the
    two packages' tent-sum orders do here)."""
    jgrid, tgrid = _grids()
    _, rot, org = _pose_arrays(140.0, -30.0)
    tj, tt = _statics(jgrid, tgrid, rot)
    image = _target()
    key = jax.random.PRNGKey(4)
    (loss_j, aux_j), g_j = jax.value_and_grad(
        functools.partial(gt_jax._pose_loss, tj), has_aux=True)(
        jgrid, jnp.asarray(image), jnp.asarray(rot), jnp.asarray(org),
        jnp.float32(FOCAL), key)
    with tgrid.trainable():
        loss_t, aux_t = gt._pose_loss(tt, tgrid, t(image), rot, org, FOCAL,
                                      phase=_phase(key))
        loss_t.backward()
    print(f"pose loss: port {loss_t.item():.8f} JAX {float(loss_j):.8f}")
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=2e-5)
    for name in aux_j:
        np.testing.assert_allclose(aux_t[name].item(), float(aux_j[name]), rtol=2e-5)
    for fld, (p999, cos) in _grad_stats(tgrid, g_j).items():
        print(f"grid gradient {fld}: p999 rel {p999:.3g}, cosine {cos:.8f}")
        assert p999 < 0.12 and cos > 0.99995, (fld, p999, cos)
    assert not tgrid.densities.requires_grad  # serving stays gradient-free


def test_multi_pose_adam_step_matches_jax():
    """One gnomonic_train_step_multi (k = 3 views of one variant, jittered)
    with torch.optim.Adam and the staircase LambdaLR against the JAX step
    with optax.adam on exponential_decay(staircase=True), from the same grid.
    Adam's first moment after one step is 0.1 x the averaged gradient on both
    sides: cosine > 0.99995 and p999 < 0.12 as the single-pose gradient.
    The metrics agree within rtol 2e-5. The updated grids agree to 2 lr
    everywhere (a first Adam step moves each voxel by about lr times the
    sign of its gradient), and within 1e-4 on all but 1% of the elements."""
    k, lr = 3, 0.03
    jgrid, tgrid = _grids()
    poses = [_pose_arrays(140.0 + 8.0 * i, -30.0) for i in range(k)]
    rots = np.stack([p[1] for p in poses])
    orgs = np.stack([p[2] for p in poses])
    assert len({gn.dominant_axis_for_pose(r) for r in rots}) == 1
    tj, tt = _statics(jgrid, tgrid, rots[0])
    images = _target(1, k)
    key = jax.random.PRNGKey(9)
    tx = optax.adam(optax.exponential_decay(lr, transition_steps=1, decay_rate=0.1,
                                            staircase=True), b1=0.9, b2=0.999)
    copy = lambda tree: jax.tree_util.tree_map(jnp.copy, tree)  # noqa: E731
    g_j, opt_j, m_j = gt_jax.gnomonic_train_step_multi(
        tj, tx, copy(jgrid), tx.init(jgrid), jnp.asarray(images), jnp.asarray(rots),
        jnp.asarray(orgs), jnp.float32(FOCAL), key)
    phases = [_phase(kk) for kk in jax.random.split(key, k)]
    d0, f0 = tgrid.densities.detach().clone(), tgrid.features.detach().clone()
    opt, sched = trainer.make_gnomonic_optimizer(tgrid, lr, 1, 0.1)
    m_t = gt.gnomonic_train_step_multi(tt, opt, tgrid, t(images), rots, orgs, FOCAL,
                                       phases=phases, scheduler=sched)
    assert sched.get_last_lr() == [pytest.approx(lr * 0.1)]
    for name in m_j:
        np.testing.assert_allclose(float(m_t[name]), float(m_j[name]), rtol=2e-5)
    mu_j = opt_j[0].mu
    for fld in ("densities", "features"):
        param = getattr(tgrid, fld)
        p999, cos = _rel_stats(opt.state[param]["exp_avg"].numpy(),
                               np.asarray(getattr(mu_j, fld)))
        new_t, new_j = param.detach().numpy(), np.asarray(getattr(g_j, fld))
        moved = np.abs(new_t - (d0 if fld == "densities" else f0).numpy()).max()
        off = np.abs(new_t - new_j) > 1e-4
        print(f"multi step {fld}: moment p999 rel {p999:.3g}, cosine {cos:.8f}; "
              f"grids max-abs {np.abs(new_t - new_j).max():.3g}, {off.mean():.2e} beyond 1e-4")
        assert p999 < 0.12 and cos > 0.99995, (fld, p999, cos)
        assert np.abs(new_t - new_j).max() <= 2 * lr + 1e-6 and off.mean() < 0.01
        assert moved > 0.5 * lr  # the step moved the grid
    assert not tgrid.features.requires_grad


def test_occupancy_gating_is_exactly_lossless():
    """The occupancy flags gate the forward and the replay backward without
    changing the gradient: equal, element for element, to the gradient with
    every block live."""
    _, tgrid = _grids()
    _, rot, org = _pose_arrays(70.0, -30.0)
    axis, flip = gn.dominant_axis_for_pose(rot)
    tt = gt.make_gnomonic_train_statics(tgrid, axis, flip, image_height=H, image_width=W,
                                        white_bkgd=True, pos_per_cell=2)
    image = t(_target(2))

    def grads():
        tgrid.densities.grad = tgrid.features.grad = None
        with tgrid.trainable():
            loss, _ = gt._pose_loss(tt, tgrid, image, rot, org, FOCAL, phase=(0.1, -0.2))
            loss.backward()
        return tgrid.densities.grad.clone(), tgrid.features.grad.clone()

    gated = grads()
    live = gn.gnomonic_occupancy_lite
    try:
        def all_live(slices, geom, statics, Pn, Qn, PB, Pb, QB, Qb):
            flags = live(slices, geom, statics, Pn, Qn, PB, Pb, QB, Qb)
            assert 0 < int(flags[1].sum()) < flags[1].numel()  # gating happens
            return tuple(torch.ones_like(f) for f in flags)

        gt.gnomonic_occupancy_lite = all_live
        dense = grads()
    finally:
        gt.gnomonic_occupancy_lite = live
    for a, b in zip(gated, dense):
        assert float(b.abs().max()) > 0.0
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_single_pose_step_equals_multi_step_of_one():
    """gnomonic_train_step (repack inside the loss, gradient straight to the
    grid) and gnomonic_train_step_multi with k = 1 (hoisted f32 repack, slice
    cotangent, one repack backward) give the same gradient, loss and Adam
    step, element for element; a phase drawn from a generator is the same
    one both times."""
    results = []
    _, rot, org = _pose_arrays(140.0, -30.0)
    axis, flip = gn.dominant_axis_for_pose(rot)
    image = t(_target(3))
    for multi in (False, True):
        _, tgrid = _grids()
        tt = gt.make_gnomonic_train_statics(tgrid, axis, flip, image_height=H,
                                            image_width=W, white_bkgd=True, pos_per_cell=2)
        opt, sched = trainer.make_gnomonic_optimizer(tgrid, 0.03)
        gen = torch.Generator().manual_seed(6)
        if multi:
            m = gt.gnomonic_train_step_multi(tt, opt, tgrid, image[None], rot[None],
                                             org[None], FOCAL, gen, scheduler=sched)
        else:
            m = gt.gnomonic_train_step(tt, opt, tgrid, image, rot, org, FOCAL, gen,
                                       scheduler=sched)
        results.append((m["total_loss"], tgrid.densities.grad, tgrid.features.grad,
                        tgrid.densities.detach(), tgrid.features.detach()))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(results[0][1].abs().max()) > 0.0


def test_staircase_adam_matches_optax():
    """make_gnomonic_optimizer against optax.adam on exponential_decay(
    staircase=True): the same learning rate at every step and the same
    parameters over 7 steps of seeded gradients (rtol 1e-5, atol 1e-6: the two
    order Adam's f32 operations differently)."""
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(4, 4, 4, 1)).astype(np.float32)
    f0 = rng.normal(size=(4, 4, 4, 3)).astype(np.float32)
    grads = [(rng.normal(size=x0.shape).astype(np.float32),
              rng.normal(size=f0.shape).astype(np.float32)) for _ in range(7)]
    sched_j = optax.exponential_decay(0.03, transition_steps=3, decay_rate=0.1, staircase=True)
    tx = optax.adam(sched_j, b1=0.9, b2=0.999)
    params = (jnp.asarray(x0), jnp.asarray(f0))
    state = tx.init(params)
    from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid

    grid = VoxelGrid(torch.from_numpy(x0.copy()), torch.from_numpy(f0.copy()))
    opt, sched = trainer.make_gnomonic_optimizer(grid, 0.03, 3, 0.1)
    for step, (gd, gf) in enumerate(grads):
        assert sched.get_last_lr()[0] == pytest.approx(float(sched_j(step)), rel=1e-6)
        updates, state = tx.update((jnp.asarray(gd), jnp.asarray(gf)), state, params)
        params = optax.apply_updates(params, updates)
        grid.densities.grad, grid.features.grad = torch.from_numpy(gd), torch.from_numpy(gf)
        opt.step()
        sched.step()
    for got, want in ((grid.densities, params[0]), (grid.features, params[1])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_out_of_slice_paths_raise_and_psnr(tmp_path):
    """What the port cannot run raises, naming it: fused=True with qb = 0,
    an unknown warp form (the gather warp is ported), the mesh step and the
    stage loop on a device mesh (through any procedure) without a process
    group (no fallback to one device), and image files other than 8-bit
    PNGs; the stage loop through the fast renderer trains
    (ray batches: one stage of two steps writes its checkpoints); fused=False
    with qb > 0 is the v2 pipeline with the q-split kernels (K6 / K8);
    mse2psnr matches the reference's definition."""
    _, tgrid = _grids()
    kw = dict(image_height=H, image_width=W, white_bkgd=True)
    ts = gt.make_gnomonic_train_statics(tgrid, 0, False, **kw, fused=False)
    assert not ts.fused and ts.statics.qb == 128
    with pytest.raises(ValueError, match="qb=0 is the v2"):
        gt.make_gnomonic_train_statics(tgrid, 0, False, **kw, qb=0, fused=True)
    assert gt.make_gnomonic_train_statics(tgrid, 0, False, **kw,
                                          warp_impl="gather").warp_impl == "gather"
    with pytest.raises(ValueError, match="gnomonic_warp_impl"):
        gt.make_gnomonic_train_statics(tgrid, 0, False, **kw, warp_impl="scatter")
    assert not gt.make_gnomonic_train_statics(tgrid, 0, False, **kw, qb=0).fused
    with pytest.raises(RuntimeError, match="process group"):
        gt.gnomonic_train_step_mesh(ts, None, 2, tgrid, [], [], [], 1.0)

    class OtherProcedure:
        render_procedure_name = "render_sh_voxel_grid_fast"

    for name in ("render_sh_voxel_grid_fast", "render_sh_voxel_grid_gnomonic"):
        OtherProcedure.render_procedure_name = name
        with pytest.raises(RuntimeError, match="process group"):
            trainer.train_sh_vox_grid_vol_mod_with_posed_images(OtherProcedure(), None,
                                                                 tmp_path, use_mesh=True)
    from test_torch_trainer import _write_dataset
    from thr3ed_atom_tpu_torch.data.dataset import PosedImagesDataset
    from thr3ed_atom_tpu_torch.modules.volumetric_model import VolumetricModel
    from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
    from thr3ed_atom_tpu_torch.utils.camera import CameraBounds

    data = _write_dataset(tmp_path / "data", n_train=2, n_test=1, size=16)
    fast_model = VolumetricModel(
        tgrid, "render_sh_voxel_grid_fast",
        SHVoxGridRenderConfig(num_samples_per_ray=16, camera_bounds=CameraBounds(1.5, 4.5),
                              fast_topk=8), device="cpu")
    trained = trainer.train_sh_vox_grid_vol_mod_with_posed_images(
        fast_model, PosedImagesDataset(data / "train", data / "train_camera_params.json"),
        tmp_path / "out", ray_batch_size=64, num_stages=1, num_iterations_per_stage=2,
        fast_debug_mode=True)
    assert trained.render_procedure_name == "render_sh_voxel_grid_fast"
    assert (tmp_path / "out" / "saved_models" / "model_stage_1_iter_2_opt.npz").exists()
    from thr3ed_atom_tpu_torch.data.png import read_png

    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a png")
    with pytest.raises(ValueError, match="x.jpg"):
        read_png(tmp_path / "x.jpg")
    assert float(mse2psnr(torch.tensor(0.01))) == pytest.approx(20.0)
    assert float(mse2psnr(torch.tensor(0.0))) == 1e10 and mse2psnr(0.001) == pytest.approx(30.0)
