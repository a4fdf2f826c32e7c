"""The gnomonic warp's options in the PyTorch port against the JAX package:
the B-spline prefilter (warp order 5), the matmul warp at order 5, the
per-pixel gather warp at orders 1, 3 and 5, their gradients with respect to
the composited state, the renders through every (warp_impl, warp_order), and
the train step's grid gradient through order 5 and through the gather warp.

CPU tests: the JAX side runs its Pallas kernels in interpret mode, the port
its plain versions (the prefilter as its matrix product unless a test says
otherwise). Inputs are made from numpy seeds and cross over unchanged; each
test states its tolerance. tests/test_torch_kernels.py holds the prefilter's
matrix form and the gather warp on a card against the CPU."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gnomonic import FOCAL, H, SS, W, _grids, _one_torch_thread, _pose_arrays  # noqa: F401
from test_torch_train_ops import _rel_stats, _train_variant, t
from thr3ed_atom_tpu.models.voxels import VoxelGrid as JaxVoxelGrid, VoxelSize
from thr3ed_atom_tpu.rendering import gnomonic as gn_jax
from thr3ed_atom_tpu.rendering import gnomonic_train as gt_jax
from thr3ed_atom_tpu.rendering.renderer import SHVoxGridRenderConfig as JaxConfig
from thr3ed_atom_tpu.utils.camera import CameraBounds as JaxBounds
from thr3ed_atom_tpu_torch.models.voxels import voxel_grid_from_numpy
from thr3ed_atom_tpu_torch.rendering import gnomonic as gn
from thr3ed_atom_tpu_torch.rendering import gnomonic_train as gt
from thr3ed_atom_tpu_torch.rendering import warp_matmul as wm
from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
from thr3ed_atom_tpu_torch.utils.camera import CameraBounds, CameraIntrinsics, pose_spherical

WARPS = [("matmul", 1), ("matmul", 3), ("matmul", 5), ("gather", 1), ("gather", 3),
         ("gather", 5)]


@pytest.mark.parametrize("n", [2, 3, 29, 30, 31, 128, 130])
@pytest.mark.parametrize("padded", [False, True])
def test_prefilter_matches_jax(n, padded):
    """The prefilter along axis 0 on values in [0, 1] (the composited
    state's colour and acc), with a zero-padded tail as the warp's second
    pass has: the matrix form within 1e-6 abs of the plain recursion and
    within 1e-5 of JAX's ``_bspline_prefilter_axis0``; the recursion within
    1e-6 of JAX's (the same operations in the same order). On N(0, 1)
    values both forms stay within 4e-7 x the largest value of the float64
    product (f32 sums; a few ulp)."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.0, 1.0, (n, 8, 3)).astype(np.float32)
    if padded:
        a[-(-n // 3):] = 0.0
    want = np.asarray(gn_jax._bspline_prefilter_axis0(jnp.asarray(a)))
    plain = gn.bspline_prefilter_axis0(t(a), plain=True).numpy()
    matrix = gn.bspline_prefilter_axis0(t(a)).numpy()
    assert matrix.shape == plain.shape == want.shape
    assert np.abs(matrix - plain).max() <= 1e-6
    assert np.abs(matrix - want).max() <= 1e-5
    assert np.abs(plain - want).max() <= 1e-6
    g = rng.normal(size=(n, 16)).astype(np.float32)
    exact = gn._bspline_prefilter_matrix64(n) @ g.astype(np.float64)
    scale = np.abs(exact).max()
    for form in (gn.bspline_prefilter_axis0(t(g)), gn.bspline_prefilter_axis0(t(g), plain=True)):
        assert np.abs(form.numpy() - exact).max() <= 4e-7 * scale
    # the last axis (the matmul warp's lines) is the same transform
    line = wm.prefilter_last_axis(t(np.moveaxis(a, 0, -1).copy())).numpy()
    np.testing.assert_array_equal(np.moveaxis(line, -1, 0), matrix)


def test_prefilter_gradient_is_the_transposed_matrix():
    """Autograd of the matrix form gives M^T g, within 1e-5 of jax.vjp of
    JAX's recursion (its scan's adjoint), and of the plain recursion's
    autograd within 1e-6."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0.0, 1.0, (130, 8)).astype(np.float32)
    g = rng.normal(size=(130, 8)).astype(np.float32)
    _, vjp = jax.vjp(gn_jax._bspline_prefilter_axis0, jnp.asarray(a))
    (want,) = vjp(jnp.asarray(g))
    grads = []
    for plain in (False, True):
        x = t(a).requires_grad_(True)
        gn.bspline_prefilter_axis0(x, plain=plain).backward(t(g))
        grads.append(x.grad.numpy())
    np.testing.assert_allclose(grads[0], np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(grads[0], grads[1], rtol=0, atol=1e-6)


def _warp_case(impl, order, swap):
    jgrid, tgrid = _grids()
    _, rot, org = _pose_arrays(140.0, -30.0)
    sj, st = _train_variant(jgrid, tgrid, rot, 1, True)
    Pn, Qn, _, _ = gn_jax.gnomonic_frame(None, H, W, FOCAL, SS, sj)
    geo = gn_jax.gnomonic_geometry(jnp.asarray(rot), jnp.asarray(org), sj, H, W,
                                   jnp.float32(FOCAL), SS, lite=True, skip_basis=True)
    rng = np.random.default_rng(5)
    state = rng.uniform(0.0, 1.0, (9, Pn, Qn)).astype(np.float32)
    state[:, : Pn // 3] = 0.0
    state[:, :, Qn // 2:] = 0.0
    g_out = rng.normal(size=(H, W, 8)).astype(np.float32)

    def channels(out, xp):
        return xp.concatenate([out.colour, out.extra["accumulated_weight"], out.depth,
                               out.extra["diffuse_colour"]], -1)

    # the function op by op (its Pallas kernels compiled), as the port runs
    # it: under jit XLA rounds the texel positions otherwise (~1 ulp at 256
    # texels, 3e-5 on this random state)
    fj = lambda s: channels(gn_jax._warp_to_camera.__wrapped__(  # noqa: E731
        s, geo.xr, geo.yr, jnp.asarray(rot), sj, H, W, jnp.float32(FOCAL), SS, True,
        warp_order=order, warp_impl=impl, warp_swap=swap), jnp)
    out_j, vjp = jax.vjp(fj, jnp.asarray(state))
    (g_j,) = vjp(jnp.asarray(g_out))
    s_t = t(state).requires_grad_(True)
    out_t = channels(gn._warp_to_camera(
        s_t, tuple(map(t, geo.xr)), tuple(map(t, geo.yr)), t(rot), st, H, W,
        torch.tensor(FOCAL), SS, True, warp_order=order, warp_impl=impl, warp_swap=swap),
        torch)
    out_t.backward(t(g_out))
    return np.asarray(out_j), out_t.detach().numpy(), np.asarray(g_j), s_t.grad.numpy(), Pn


@pytest.mark.parametrize("impl,order,swap", [("matmul", 5, False), ("matmul", 5, True),
                                             ("gather", 1, False), ("gather", 3, False),
                                             ("gather", 5, False)])
def test_warp_and_its_gradient_match_jax(impl, order, swap):
    """The warp of one composited state (white background, diffuse rows)
    against the JAX package's ``_warp_to_camera`` run op by op, and its
    gradient with respect to the state against jax.vjp, on a source with
    empty rows and columns, so that the hull clamps meet ties (y = lo = hi
    = 0) under a non-zero cotangent. Outputs within 1e-5 (rtol and atol).
    Orders 1 and 3: the gradient within rtol / atol 1e-5 everywhere but
    1e-4 of the elements, cosine > 0.99999. Order 5: where the B-spline's
    tails decay through the smallest normal f32 (~67 texels into empty
    space) the reference's XLA flushes partial sums that the port's
    sums keep, so a band of y = +-1e-38 pixels takes the other side of the
    tie, and its cotangent goes to the coefficients instead of the taps:
    at most 3% of the elements beyond 1e-5, none beyond 0.2 of the
    largest, cosine > 0.9999. torch.clamp instead of the min/max form puts
    a quarter of the elements off, cosine 0.88-0.92, on this state."""
    out_j, out_t, g_j, g_t, Pn = _warp_case(impl, order, swap)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)
    scale = np.abs(g_j).max()
    off = np.abs(g_t - g_j) > 1e-5 + 1e-5 * np.abs(g_j)
    _, cos = _rel_stats(g_t, g_j)
    print(f"{impl} order {order} swap {swap}: warp gradient vs JAX max-abs "
          f"{np.abs(g_t - g_j).max():.3g} (scale {scale:.3g}), {int(off.sum())} of "
          f"{off.size} beyond 1e-5, cosine {cos:.9f}")
    if order == 5:
        assert off.mean() < 3e-2 and np.abs(g_t - g_j).max() < 0.2 * scale and cos > 0.9999
    else:
        assert off.mean() < 1e-4 and cos > 0.99999
    assert float(np.abs(g_j[1:, : Pn // 3]).max()) > 0.0  # ties carry gradient


def _small_grids():
    """tests/test_gnomonic.py's test_bspline_warp_close_to_catmull_rom scene
    from a numpy seed: a 12^3 relu grid carved to a ball of radius 2.5
    voxels (density -1 outside)."""
    rng = np.random.default_rng(7)
    d = rng.uniform(-2.0, 4.0, (12, 12, 12, 1)).astype(np.float32)
    coords = np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"), -1)
    dist = np.linalg.norm(coords - 5.5, axis=-1, keepdims=True)
    d = np.where(dist < 2.5, d, -1.0).astype(np.float32)
    f = (rng.normal(size=(12, 12, 12, 27)) * 0.4).astype(np.float32)
    config = dict(voxel_size=(2.0 / 12,) * 3, grid_location=(0.0, 0.0, 0.0),
                  density_preactivation="identity", density_postactivation="relu",
                  feature_preactivation="identity", feature_postactivation="identity",
                  expected_density_scale=1.0, radiance_transfer_function=None)
    jgrid = JaxVoxelGrid(densities=jnp.asarray(d), features=jnp.asarray(f),
                         voxel_size=VoxelSize(*config["voxel_size"]),
                         density_preactivation="identity", density_postactivation="relu")
    return jgrid, voxel_grid_from_numpy(d, f, config, device="cpu")


@pytest.mark.parametrize("impl,order", WARPS)
def test_render_through_every_warp_matches_jax(impl, order):
    """render_image_gnomonic for every (warp_impl, warp_order) against the
    JAX package's, at test_bspline_warp_close_to_catmull_rom's 12^3 grid,
    48 x 48 image and pose: colour / acc within 3e-3, depth 2e-2 (the port's
    order-3 render bounds). Both leave the same pixels empty (acc exactly
    0), and the white-background identity (colour exactly 1 there) holds
    at the same pixels: at all of them but for the gather warp at order 3,
    whose Catmull-Rom taps carry colour where acc rounds to 0 (2 pixels,
    in JAX's render too). Orders 3 and 5 stay within 0.05 of each other
    (the JAX test's bound)."""
    jgrid, tgrid = _small_grids()
    pose = pose_spherical(70.0, -25.0, 3.5)
    intr = CameraIntrinsics(48, 48, 52.0)
    kw = dict(num_samples_per_ray=32, white_bkgd=True, gnomonic_warp_order=order,
              gnomonic_warp_impl=impl)
    want = gn_jax.render_image_gnomonic(
        jgrid, pose, intr, JaxConfig(camera_bounds=JaxBounds(1.0, 6.0), **kw), interpret=True)
    cfg = SHVoxGridRenderConfig(camera_bounds=CameraBounds(1.0, 6.0), **kw)
    got = gn.render_image_gnomonic(tgrid, pose, intr, cfg)
    acc_t = got.extra["accumulated_weight"].numpy()
    gaps = dict(colour=np.abs(got.colour.numpy() - np.asarray(want.colour)).max(),
                acc=np.abs(acc_t - np.asarray(want.extra["accumulated_weight"])).max(),
                depth=np.abs(got.depth.numpy() - np.asarray(want.depth)).max())
    print(f"{impl} order {order}: port vs JAX max-abs {gaps}")
    assert gaps["colour"] < 3e-3 and gaps["acc"] < 3e-3 and gaps["depth"] < 2e-2
    colour = got.colour.numpy()
    empty = acc_t[..., 0] == 0.0
    assert empty.any() and float(acc_t.max()) > 0.5
    np.testing.assert_array_equal(empty, np.asarray(want.extra["accumulated_weight"])[..., 0] == 0)
    white = np.all(colour[empty] == 1.0, axis=-1)
    np.testing.assert_array_equal(white, np.all(np.asarray(want.colour)[empty] == 1.0, axis=-1))
    assert white.all() or (impl, order) == ("gather", 3)
    if order == 5:
        cr = gn.render_image_gnomonic(tgrid, pose, intr, cfg.replace(gnomonic_warp_order=3))
        assert np.abs(cr.colour.numpy() - colour).max() < 0.05


@pytest.mark.parametrize("impl,order", [("matmul", 5), ("gather", 5)])
def test_train_step_gradient_through_the_warp_options_matches_jax(impl, order):
    """The whole-pose loss with phase jitter and its grid gradient through
    order 5 (matmul) and through the gather warp (order 5: prefilter, 16
    gathers and the hull clamp), on the carved scene, whose empty space
    puts the clamps on ties: loss within rtol 2e-5 of JAX's, gradient
    cosine > 0.99999 and p999 relative error < 0.12
    (tests/test_torch_gnomonic_train.py's p999 bound for the Catmull-Rom
    warp)."""
    jgrid, tgrid = _grids()
    _, rot, org = _pose_arrays(140.0, -30.0)
    h = w = 64
    focal = 70.0
    axis, flip = gn.dominant_axis_for_pose(rot)
    kw = dict(image_height=h, image_width=w, white_bkgd=True,
              apply_diffuse_render_regularization=True, pos_per_cell=2, qb=128,
              warp_order=order, warp_impl=impl)
    tj = gt_jax.make_gnomonic_train_statics(jgrid, axis, flip, interpret=True, fused=True, **kw)
    tt = gt.make_gnomonic_train_statics(tgrid, axis, flip, **kw)
    assert tt.warp_impl == tj.warp_impl == impl and tt.warp_order == order
    image = np.random.default_rng(0).random((h, w, 3), dtype=np.float32)
    key = jax.random.PRNGKey(4)
    (loss_j, _), g_j = jax.value_and_grad(
        functools.partial(gt_jax._pose_loss, tj), has_aux=True)(
        jgrid, jnp.asarray(image), jnp.asarray(rot), jnp.asarray(org), jnp.float32(focal), key)
    phase = tuple(float(x) for x in jax.random.uniform(key, (2,), minval=-0.5, maxval=0.5))
    with tgrid.trainable():
        loss_t, _ = gt._pose_loss(tt, tgrid, t(image), rot, org, focal, phase=phase)
        loss_t.backward()
    print(f"{impl} order {order}: pose loss port {loss_t.item():.8f} JAX {float(loss_j):.8f}")
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=2e-5)
    for fld in ("densities", "features"):
        p999, cos = _rel_stats(getattr(tgrid, fld).grad.numpy(), np.asarray(getattr(g_j, fld)))
        print(f"grid gradient {fld}: p999 rel {p999:.3g}, cosine {cos:.8f}")
        assert p999 < 0.12 and cos > 0.99999, (fld, p999, cos)


def test_gather_and_order_5_train_statics():
    """The train statics take the gather warp ("auto" is the matmul warp),
    and refuse a warp form that does not exist."""
    _, tgrid = _grids()
    kw = dict(image_height=64, image_width=64, white_bkgd=True)
    assert gt.make_gnomonic_train_statics(tgrid, 0, False, **kw).warp_impl == "matmul"
    ts = gt.make_gnomonic_train_statics(tgrid, 0, False, **kw, warp_impl="gather",
                                        warp_order=5)
    assert (ts.warp_impl, ts.warp_order) == ("gather", 5)
    with pytest.raises(ValueError, match="gnomonic_warp_impl"):
        gt.make_gnomonic_train_statics(tgrid, 0, False, **kw, warp_impl="scatter")


def test_training_cli_takes_warp_order_5(tmp_path):
    """The training CLI with ``--gnomonic_warp_order 5`` on the CPU: a
    two-stage run (8^3 -> 16^3, 2 steps a stage) trains through order 5
    (finite losses), saves the order in the model's render config, and its
    held-out test reports PSNR and LPIPS under the JAX package's keys."""
    import json

    from test_torch_trainer import _write_dataset
    from thr3ed_atom_tpu_torch.apps import train_sh_voxel_grid as cli

    data = _write_dataset(tmp_path / "data")
    out = tmp_path / "out"
    model = cli.main(["-d", str(data), "-o", str(out), "--grid_dims", "16", "16", "16",
                      "--num_stages", "2", "--num_iterations_per_stage", "2",
                      "--gnomonic_pos_per_cell", "1", "--data_downsample_factor", "1",
                      "--grid_world_size", "2", "2", "2", "--gnomonic_poses_per_step", "2",
                      "--gnomonic_warp_order", "5", "--summary_frequency", "1",
                      "--test_frequency", "4", "--save_frequency", "4",
                      "--feedback_frequency", "4"], device="cpu")
    assert model.render_config.gnomonic_warp_order == 5
    summaries = [json.loads(line) for line in
                 (out / "training_logs" / "summaries.jsonl").read_text().splitlines()]
    losses = [s["value"] for s in summaries if s["name"] == "total_loss"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    names = {s["name"] for s in summaries}
    assert {"TEST_SET_PSNR", "TEST_SET_LPIPS_RAND"} <= names
