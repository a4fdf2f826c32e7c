"""The PyTorch port's v2 stripe pipeline (``gnomonic_qb=0``) against the JAX
package: the interleaved repack, the per-position tents and liveness, the
u-resample, the whole-stripe occupancy, the stripe composite (K5) and its
replay backward (K7), render_poses, the whole-pose loss and its gradient, one
multi-pose Adam step, and the port's v2 against its fused pipeline; and the
q-split form (``fused=False`` with qb = 128): its occupancy, composite (K6),
replay backward (K8) and train step.

CPU tests on tests/test_torch_gnomonic.py's carved 16^3 relu scene (SH degree
2): the JAX side runs its Pallas kernels in interpret mode, the port its plain
versions. Inputs are made from seeds with numpy and cross over unchanged; each
test states its tolerance. tests/test_torch_kernels.py holds the CUDA kernels
against the same plain versions on a card."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_gnomonic import FOCAL, H, SS, W, _grids, _one_torch_thread, _pose_arrays  # noqa: F401
from test_torch_train_ops import _rel_stats, t
from test_torch_volumetric_model import INTR, _models, _poses
from thr3ed_atom_tpu.rendering import gnomonic as gn_jax
from thr3ed_atom_tpu.rendering import gnomonic_train as gt_jax
from thr3ed_atom_tpu_torch.modules import trainer
from thr3ed_atom_tpu_torch.rendering import gnomonic as gn
from thr3ed_atom_tpu_torch.rendering import gnomonic_train as gt

SMALL, SMALL_FOCAL = 32, 35.0  # the loss and step tests' views


def _v2_variant(jgrid, tgrid, rot, P, diffuse=False, exit_eps=0.0):
    axis, flip = gn.dominant_axis_for_pose(rot)
    sj = gn_jax.statics_for_grid(jgrid, axis, flip, with_diffuse=diffuse, pos_per_cell=P,
                                 exit_eps=exit_eps, interpret=True, qb=0)
    st = gn.statics_for_grid(tgrid, axis, flip, with_diffuse=diffuse, pos_per_cell=P,
                             exit_eps=exit_eps, qb=0)
    return sj, st


def _jax_v2_operands(jgrid, sj, rot, org, Pn, Qn, phase=None):
    slices = gn_jax.repack_position_slices(jgrid, sj, True, False)
    geo = gn_jax.gnomonic_geometry(
        jnp.asarray(rot), jnp.asarray(org), sj, H, W, jnp.float32(FOCAL), SS,
        frame=(Pn, Qn), phase=None if phase is None else tuple(map(jnp.float32, phase)))
    return slices, geo


def _bf16(x):
    """A JAX bf16 array as a torch bf16 tensor (through f32, exact)."""
    return t(jnp.asarray(x, jnp.float32)).to(torch.bfloat16)


def _geo_ops(geo):
    """The JAX geometry's stripe operands as torch tensors."""
    return (_bf16(geo.RvT),) + tuple(t(x) for x in (geo.ybasis, geo.live_u, geo.live_v,
                                                    geo.norm, geo.geom))


@pytest.mark.parametrize("yaw,pitch", [(140.0, -30.0), (35.0, -70.0)])
def test_v2_operands_match_jax(yaw, pitch):
    """The frame equals the JAX package's v2 render and train frames; the
    interleaved repack is bitwise equal (P = 1, 2); the tents Ru / RvT and
    the liveness from the v2 formula are equal, but for tent weights that an
    f32 ulp of the geometry (frame ranges within rtol 1e-6) moves across a
    bf16 rounding boundary: those flip by one bf16 ulp, are counted, and must
    stay under 1% of the weights (3 of 6444 and 19 of 5928 measured). The
    u-resample t1 is bitwise equal on shared operands; the whole-stripe
    occupancy equals the JAX package's at the port's PB."""
    jgrid, tgrid = _grids()
    _, rot, org = _pose_arrays(yaw, pitch)
    for P in (1, 2):
        sj, st = _v2_variant(jgrid, tgrid, rot, P)
        Pn, Qn, PB, Pb = gn.gnomonic_frame(None, H, W, FOCAL, SS, st)
        assert (Pn, Qn, Pb) == (256, 256, 128)
        assert gn_jax.gnomonic_frame(None, H, W, FOCAL, SS, sj)[:2] == (Pn, Qn)
        assert gt_jax.gnomonic_frame_train(H, W, SS, sj)[:2] == (Pn, Qn)
        s_j, geo_j = _jax_v2_operands(jgrid, sj, rot, org, Pn, Qn)
        s_t = gn.repack_position_slices(tgrid, st, vertex_only=False)
        assert s_t.shape == (gn._num_positions(st), 16, 32, 16) and s_t.is_contiguous()
        np.testing.assert_array_equal(s_t.float().numpy(),
                                      np.asarray(s_j.astype(jnp.float32)))
        geo_t = gn.gnomonic_geometry(t(rot), t(org), st, H, W, torch.tensor(FOCAL), SS,
                                     lite=False, skip_basis=False)
        flips = 0
        for name in ("Ru", "RvT"):
            got = getattr(geo_t, name).float().numpy()
            want = np.asarray(getattr(geo_j, name).astype(jnp.float32))
            assert got.shape == want.shape
            flips += int((got != want).sum())
            np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -8)
        weights = int((geo_t.Ru.float() > 0).sum() + (geo_t.RvT.float() > 0).sum())
        print(f"P={P}: tent weights {weights}, bf16 flips vs JAX {flips}")
        assert flips <= 1e-2 * weights
        for name in ("live_u", "live_v"):
            np.testing.assert_array_equal(getattr(geo_t, name).numpy(),
                                          np.asarray(getattr(geo_j, name)))
        t1_j = np.asarray(gn_jax.resample_u(s_j, geo_j.Ru).astype(jnp.float32))
        t1_t = gn.resample_u(s_t, _bf16(geo_j.Ru))
        assert t1_t.dtype == torch.bfloat16 and t1_t.shape == (s_t.shape[0], 32, Pn, 16)
        np.testing.assert_array_equal(t1_t.float().numpy(), t1_j)
        occ_j = gn_jax.gnomonic_occupancy(s_j, geo_j.Ru, sj, PB, Pb)
        occ_t = gn.gnomonic_occupancy(s_t, geo_t.Ru, st, PB, Pb)
        for a, b in zip(occ_t, occ_j):
            assert a.shape == (PB, gn._num_positions(st))
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert 0 < int(occ_t[1].sum()) < occ_t[1].numel()  # some skipping happens


@pytest.mark.parametrize("n,size", [(64, 200), (128, 400), (128, 800)])
@pytest.mark.parametrize("qb", [0, 128])
def test_frame_matches_jax_at_cli_shapes(n, size, qb):
    """The port's one texel frame equals the JAX package's render frame and
    train frame (Pn, Qn) at the training CLI's shapes (64^3 at 200 x 200,
    128^3 at 400 x 400, and the 800 x 800 dataset renders), for both
    pipelines, every march axis, P = 2 and 4, with and without the diffuse
    rows; statics are the 16^3 grid's with the grid size replaced."""
    jgrid, tgrid = _grids()
    for axis in range(3):
        for P, diffuse in ((2, True), (4, False)):
            kw = dict(with_diffuse=diffuse, pos_per_cell=P, qb=qb)
            sj = gn_jax.statics_for_grid(jgrid, axis, False, interpret=True, **kw)
            st = gn.statics_for_grid(tgrid, axis, False, **kw)
            sj, st = sj._replace(dims=(n,) * 3), st._replace(dims=(n,) * 3)
            ss = gn.effective_supersample(1.25, st, size, size)
            assert ss == gn_jax.effective_supersample(1.25, sj, size, size)
            Pn, Qn, PB, Pb = gn.gnomonic_frame(None, size, size, None, ss, st)
            assert (PB * Pb, Pb) == (Pn, 128)
            assert gn_jax.gnomonic_frame(None, size, size, None, ss, sj)[:2] == (Pn, Qn)
            assert gt_jax.gnomonic_frame_train(size, size, ss, sj)[:2] == (Pn, Qn)


def _stripe_case(P, diffuse, exit_eps, yaw=140.0, pitch=-30.0):
    jgrid, tgrid = _grids()
    _, rot, org = _pose_arrays(yaw, pitch)
    sj, st = _v2_variant(jgrid, tgrid, rot, P, diffuse, exit_eps)
    Pn, Qn, PB, Pb = gn.gnomonic_frame(None, H, W, FOCAL, SS, st)
    s_j, geo_j = _jax_v2_operands(jgrid, sj, rot, org, Pn, Qn, phase=(0.3125, -0.4375))
    t1_j = gn_jax.resample_u(s_j, geo_j.Ru)
    occ_j = gn_jax.gnomonic_occupancy(s_j, geo_j.Ru, sj, PB, Pb)
    return sj, st, (Pn, Qn, PB, Pb), t1_j, geo_j, occ_j


@pytest.mark.parametrize("P,diffuse,exit_eps", [(1, True, 0.0), (2, False, 0.0),
                                                (2, True, 1e-4)])
def test_stripe_composite_plain_matches_jax(P, diffuse, exit_eps):
    """composite_positions_plain against the JAX package's composite_positions
    (K5's TPU kernel in interpret mode) on shared operands: t1, the tents,
    basis, liveness and the [PB, NP] flags at Pb = 128, with the early exit
    at the JAX grain (a 128 x Qn stripe). The resample is the same dense
    product with exact products; what remains is f32 round-off of
    exp / sigmoid. Bound: state max-abs <= 3e-6."""
    sj, st, (Pn, Qn, PB, Pb), t1_j, geo_j, occ_j = _stripe_case(P, diffuse, exit_eps)
    want = np.asarray(gn_jax.composite_positions(
        t1_j, geo_j.RvT, geo_j.ybasis, geo_j.live_u, geo_j.live_v, geo_j.norm,
        geo_j.geom, sj, Pn, Qn, PB, Pb, occupancy=occ_j))
    rvt, yb, lu, lv, nm, geom = _geo_ops(geo_j)
    got = gn.composite_positions(_bf16(t1_j), rvt,
                                 yb, lu, lv, nm, geom, st, Pn, Qn, PB, Pb,
                                 tuple(map(t, occ_j))).numpy()
    assert got.shape == want.shape == (9 if diffuse else 6, Pn, Qn)
    gap = np.abs(got - want).max()
    print(f"stripe composite plain vs JAX: max-abs {gap:.3g}")
    assert gap <= 3e-6
    assert float(want[4].max()) > 0.5  # the scene is really hit


@pytest.mark.parametrize("P,diffuse", [(1, True), (2, False)])
def test_stripe_backward_plain_matches_jax(P, diffuse):
    """composite_backward_plain against the JAX package's _composite_backward
    (K7's TPU kernel in interpret mode) on shared operands and a seeded state
    cotangent. The replay is the same; the v-fold's f32 sums run in another
    order before the bf16 rounding of dt1. Bound: p999 relative error < 0.05
    with tests/test_gnomonic_train.py's denominator, cosine > 0.9999 (the
    fused backward's bound, tests/test_torch_train_ops.py)."""
    sj, st, (Pn, Qn, PB, Pb), t1_j, geo_j, occ_j = _stripe_case(P, diffuse, 0.0)
    state = gn_jax.composite_positions(
        t1_j, geo_j.RvT, geo_j.ybasis, geo_j.live_u, geo_j.live_v, geo_j.norm,
        geo_j.geom, sj, Pn, Qn, PB, Pb, occupancy=occ_j)
    gstate = np.random.default_rng(5).normal(size=state.shape).astype(np.float32)
    S_total = jnp.sum(gstate[1:] * state[1:], axis=0)
    gaux = jnp.concatenate([jnp.asarray(gstate), S_total[None], state[0:1]], axis=0)
    want = np.asarray(gt_jax._composite_backward(
        t1_j, geo_j.RvT, geo_j.ybasis, geo_j.live_u, geo_j.live_v, geo_j.norm,
        geo_j.geom, gaux, occ_j, sj, Pn, Qn, PB, Pb).astype(jnp.float32))
    rvt, yb, lu, lv, nm, geom = _geo_ops(geo_j)
    got = gt.composite_backward(_bf16(t1_j), rvt, yb,
                                lu, lv, nm, geom, t(gaux), tuple(map(t, occ_j)), st, Pn,
                                Qn, PB, Pb)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    used = 3 * st.ncoeff + 1
    assert not got[:, used:].any()
    p999, cos = _rel_stats(got.float().numpy(), want)
    print(f"stripe backward plain vs JAX: p999 rel {p999:.3g}, cosine {cos:.9f}")
    assert p999 < 0.05 and cos > 0.9999 and np.abs(want).max() > 0


def test_render_poses_qb0_matches_jax():
    """VolumetricModel.render_poses with gnomonic_qb=0 in both packages (the
    JAX package's v2 path, its stripe kernel in interpret mode); poses span
    three march variants and one swapped warp. Bound: colour/acc 3e-3, depth
    2e-2 (tests/test_gnomonic.py's bound between the JAX package's own
    kernels). The v2 render also stays within that bound of the port's fused
    render."""
    poses = _poses()
    jmodel, tmodel = _models(gnomonic_qb=0)
    want = jmodel.render_poses(poses, INTR)
    got = tmodel.render_poses(poses, INTR)
    fused = tmodel.render_poses(poses, INTR, gnomonic_qb=128)
    for ref, name in ((want, "JAX"), (fused, "port fused")):
        ref_c, ref_a, ref_d = (np.asarray(x) for x in (
            ref.colour, ref.extra["accumulated_weight"], ref.depth))
        gaps = (np.abs(got.colour.numpy() - ref_c).max(),
                np.abs(got.extra["accumulated_weight"].numpy() - ref_a).max(),
                np.abs(got.depth.numpy() - ref_d).max())
        print(f"render_poses qb=0 vs {name}: colour/acc/depth max-abs {gaps}")
        assert gaps[0] < 3e-3 and gaps[1] < 3e-3 and gaps[2] < 2e-2
    assert float(got.extra["accumulated_weight"].max()) > 0.5


def _small_statics(jgrid, tgrid, rot, qb=0):
    axis, flip = gn.dominant_axis_for_pose(rot)
    kw = dict(image_height=SMALL, image_width=SMALL, white_bkgd=True,
              apply_diffuse_render_regularization=True, pos_per_cell=2, qb=qb)
    tj = gt_jax.make_gnomonic_train_statics(jgrid, axis, flip, interpret=True,
                                            fused=qb > 0, **kw)
    tt = gt.make_gnomonic_train_statics(tgrid, axis, flip, **kw)
    assert tj.fused == tt.fused == (qb > 0)
    assert tt.frame[:2] == tj.frame[:2] and tt.supersample == tj.supersample
    return tj, tt


def _targets(seed, k=None):
    rng = np.random.default_rng(seed)
    shape = (SMALL, SMALL, 3) if k is None else (k, SMALL, SMALL, 3)
    return rng.random(shape, dtype=np.float32)


def _phase(key):
    return tuple(float(x) for x in jax.random.uniform(key, (2,), minval=-0.5, maxval=0.5))


def test_v2_pose_loss_and_grid_gradient_match_jax():
    """The v2 whole-pose loss (specular + diffuse L1, phase jitter) at 32 x 32
    pixels: within rtol 2e-5 of the JAX package's; its gradient with respect
    to the grid (autograd through the u-resample, the replay VJP for the
    composite): cosine > 0.99995 and p999 relative error < 0.12, the JAX
    package's bound between its own kernels."""
    jgrid, tgrid = _grids()
    _, rot, org = _pose_arrays(140.0, -30.0)
    tj, tt = _small_statics(jgrid, tgrid, rot)
    image = _targets(0)
    key = jax.random.PRNGKey(4)
    (loss_j, aux_j), g_j = jax.value_and_grad(
        functools.partial(gt_jax._pose_loss, tj), has_aux=True)(
        jgrid, jnp.asarray(image), jnp.asarray(rot), jnp.asarray(org),
        jnp.float32(SMALL_FOCAL), key)
    with tgrid.trainable():
        loss_t, aux_t = gt._pose_loss(tt, tgrid, t(image), rot, org, SMALL_FOCAL,
                                      phase=_phase(key))
        loss_t.backward()
    print(f"v2 pose loss: port {loss_t.item():.8f} JAX {float(loss_j):.8f}")
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=2e-5)
    for name in aux_j:
        np.testing.assert_allclose(aux_t[name].item(), float(aux_j[name]), rtol=2e-5)
    for fld in ("densities", "features"):
        p999, cos = _rel_stats(getattr(tgrid, fld).grad.numpy(),
                               np.asarray(getattr(g_j, fld)))
        print(f"v2 grid gradient {fld}: p999 rel {p999:.3g}, cosine {cos:.8f}")
        assert p999 < 0.12 and cos > 0.99995, (fld, p999, cos)


def test_v2_multi_pose_adam_step_matches_jax():
    """One gnomonic_train_step_multi with qb=0 (k = 3 jittered views of one
    variant, Adam with the staircase decay) against the JAX step: metrics
    within rtol 2e-5; Adam's first moments cosine > 0.99995 and p999 < 0.12;
    the updated grids within 2 lr everywhere and 1e-4 on all but 1% of the
    elements (as the fused step's test)."""
    k, lr = 3, 0.03
    jgrid, tgrid = _grids()
    poses = [_pose_arrays(140.0 + 8.0 * i, -30.0) for i in range(k)]
    rots = np.stack([p[1] for p in poses])
    orgs = np.stack([p[2] for p in poses])
    assert len({gn.dominant_axis_for_pose(r) for r in rots}) == 1
    tj, tt = _small_statics(jgrid, tgrid, rots[0])
    images = _targets(1, k)
    key = jax.random.PRNGKey(9)
    tx = optax.adam(optax.exponential_decay(lr, transition_steps=1, decay_rate=0.1,
                                            staircase=True), b1=0.9, b2=0.999)
    copy = lambda tree: jax.tree_util.tree_map(jnp.copy, tree)  # noqa: E731
    g_j, opt_j, m_j = gt_jax.gnomonic_train_step_multi(
        tj, tx, copy(jgrid), tx.init(jgrid), jnp.asarray(images), jnp.asarray(rots),
        jnp.asarray(orgs), jnp.float32(SMALL_FOCAL), key)
    phases = [_phase(kk) for kk in jax.random.split(key, k)]
    opt, sched = trainer.make_gnomonic_optimizer(tgrid, lr, 1, 0.1)
    m_t = gt.gnomonic_train_step_multi(tt, opt, tgrid, t(images), rots, orgs,
                                       SMALL_FOCAL, phases=phases, scheduler=sched)
    for name in m_j:
        np.testing.assert_allclose(float(m_t[name]), float(m_j[name]), rtol=2e-5)
    for fld in ("densities", "features"):
        param = getattr(tgrid, fld)
        p999, cos = _rel_stats(opt.state[param]["exp_avg"].numpy(),
                               np.asarray(getattr(opt_j[0].mu, fld)))
        new_t, new_j = param.detach().numpy(), np.asarray(getattr(g_j, fld))
        off = np.abs(new_t - new_j) > 1e-4
        print(f"v2 multi step {fld}: moment p999 {p999:.3g}, cosine {cos:.8f}; "
              f"{off.mean():.2e} of the grid beyond 1e-4")
        assert p999 < 0.12 and cos > 0.99995, (fld, p999, cos)
        assert np.abs(new_t - new_j).max() <= 2 * lr + 1e-6 and off.mean() < 0.01


def test_v2_against_fused_within_jax_cross_kernel_bounds():
    """The port's v2 and fused pipelines on one pose: the losses within rtol
    2e-5, and the gradients within the JAX package's bounds between its own
    two kernels (tests/test_gnomonic_train.py: cosine > 0.99995, p999 < 0.12)
    once the v2 stack is rounded as the fused kernel rounds (bf16 vertices,
    f32 lerp, one bf16 rounding), as that test does."""
    _, tgrid = _grids()
    _, rot, org = _pose_arrays(40.0, -35.0)
    axis, flip = gn.dominant_axis_for_pose(rot)
    kw = dict(image_height=SMALL, image_width=SMALL, white_bkgd=True,
              apply_diffuse_render_regularization=True, pos_per_cell=2)
    ts_v2 = gt.make_gnomonic_train_statics(tgrid, axis, flip, qb=0, **kw)
    ts_f = gt.make_gnomonic_train_statics(tgrid, axis, flip, qb=128, **kw)
    assert ts_f.fused and not ts_v2.fused and ts_f.frame == ts_v2.frame
    P = ts_f.statics.pos_per_cell
    image = t(_targets(2))

    def loss(ts, match_rounding=False):
        if match_rounding:
            sv = gn.repack_position_slices(tgrid, ts.statics).float()  # [nvert, nu, C, nv]
            lo, hi = sv[:-1], sv[1:]
            subs = [lo] + [(1.0 - k / P) * lo + (k / P) * hi for k in range(1, P)]
            inter = torch.stack(subs, dim=1).reshape((-1,) + tuple(sv.shape[1:]))
            slices = torch.cat([inter, sv[-1:]], dim=0).to(torch.bfloat16)
        else:
            slices = gn.repack_position_slices(tgrid, ts.statics, vertex_only=ts.fused)
        return gt._pose_loss_from_slices(ts, slices, image, rot, org, SMALL_FOCAL)[0]

    l_v2, l_f = float(loss(ts_v2)), float(loss(ts_f))
    print(f"port v2 loss {l_v2:.8f}, fused loss {l_f:.8f}")
    np.testing.assert_allclose(l_v2, l_f, rtol=2e-5)
    grads = []
    for ts, match in ((ts_v2, True), (ts_f, False)):
        tgrid.densities.grad = tgrid.features.grad = None
        with tgrid.trainable():
            loss(ts, match).backward()
        grads.append((tgrid.densities.grad.clone(), tgrid.features.grad.clone()))
    for (a, b), fld in zip(zip(*grads), ("densities", "features")):
        p999, cos = _rel_stats(b.numpy(), a.numpy())
        print(f"port v2 vs fused gradient {fld}: p999 rel {p999:.3g}, cosine {cos:.8f}")
        assert p999 < 0.12 and cos > 0.99995, (fld, p999, cos)


def _qsplit_case(diffuse, exit_eps, yaw=140.0, pitch=-30.0):
    """The stripe operands of a pose at qb = 128 (Qn = 256: two q-blocks) and
    the [PB, QB, NP] flags of the JAX package's q-split occupancy."""
    jgrid, tgrid = _grids()
    _, rot, org = _pose_arrays(yaw, pitch)
    axis, flip = gn.dominant_axis_for_pose(rot)
    sj = gn_jax.statics_for_grid(jgrid, axis, flip, with_diffuse=diffuse, pos_per_cell=2,
                                 exit_eps=exit_eps, interpret=True, qb=128)
    st = gn.statics_for_grid(tgrid, axis, flip, with_diffuse=diffuse, pos_per_cell=2,
                             exit_eps=exit_eps, qb=128)
    Pn, Qn, PB, Pb = gn.gnomonic_frame(None, H, W, FOCAL, SS, st)
    QB, Qb = gn._qb_blocks(st, Qn)
    assert (QB, Qb) == (2, 128)
    s_j, geo_j = _jax_v2_operands(jgrid, sj, rot, org, Pn, Qn, phase=(0.3125, -0.4375))
    t1_j = gn_jax.resample_u(s_j, geo_j.Ru)
    occ_j = gn_jax.gnomonic_occupancy(s_j, geo_j.Ru, sj, PB, Pb, RvT=geo_j.RvT, QB=QB)
    occ_t = gn.gnomonic_occupancy(_bf16(s_j), _bf16(geo_j.Ru), st, PB, Pb,
                                  RvT=_bf16(geo_j.RvT), QB=QB)
    for a, b in zip(occ_t, occ_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert occ_t[0].shape == (PB, QB, gn._num_positions(st))
    return sj, st, (Pn, Qn, PB, Pb), t1_j, geo_j, occ_j


@pytest.mark.parametrize("diffuse,exit_eps", [(True, 0.0), (False, 1e-4)])
def test_qsplit_composite_plain_matches_jax(diffuse, exit_eps):
    """composite_positions with two q-blocks (qb = 128: the q-split composite
    K6, here its plain version) against the JAX package's
    _composite_positions_qb (interpret mode) on shared operands and the
    [PB, QB, NP] flags (the port's q-split occupancy equal to the JAX
    package's); the early exit per [Pb, Qb] block as the JAX kernel's.
    Bound: state max-abs <= 3e-6 (K5's bound; measured 4.8e-7)."""
    sj, st, (Pn, Qn, PB, Pb), t1_j, geo_j, occ_j = _qsplit_case(diffuse, exit_eps)
    want = np.asarray(gn_jax.composite_positions(
        t1_j, geo_j.RvT, geo_j.ybasis, geo_j.live_u, geo_j.live_v, geo_j.norm,
        geo_j.geom, sj, Pn, Qn, PB, Pb, occupancy=occ_j))
    rvt, yb, lu, lv, nm, geom = _geo_ops(geo_j)
    args = (_bf16(t1_j), rvt, yb, lu, lv, nm, geom, st, Pn, Qn, PB, Pb,
            tuple(map(t, occ_j)))
    before = gn.composite_positions_qb.launches
    got = gn.composite_positions(*args).numpy()
    assert gn.composite_positions_qb.launches == before  # CPU: the plain version
    gap = np.abs(got - want).max()
    print(f"q-split composite plain vs JAX: max-abs {gap:.3g}")
    assert gap <= 3e-6 and float(want[4].max()) > 0.5
    np.testing.assert_array_equal(got, gn.composite_positions_qb_plain(*args).numpy())


def test_qsplit_backward_plain_matches_jax():
    """composite_backward with two q-blocks (the q-split replay VJP K8, its
    plain version: per q-block f32 partials of the v-fold, added in q-block
    order and rounded to bf16 once) against the JAX package's
    _composite_backward_qb (interpret mode) on a seeded state cotangent.
    Bound: p999 relative error < 0.05 and cosine > 0.9999 (K7's bounds;
    measured: bit-equal)."""
    sj, st, (Pn, Qn, PB, Pb), t1_j, geo_j, occ_j = _qsplit_case(True, 0.0)
    state = gn_jax.composite_positions(
        t1_j, geo_j.RvT, geo_j.ybasis, geo_j.live_u, geo_j.live_v, geo_j.norm,
        geo_j.geom, sj, Pn, Qn, PB, Pb, occupancy=occ_j)
    gstate = np.random.default_rng(6).normal(size=state.shape).astype(np.float32)
    S_total = jnp.sum(gstate[1:] * state[1:], axis=0)
    gaux = jnp.concatenate([jnp.asarray(gstate), S_total[None], state[0:1]], axis=0)
    want = np.asarray(gt_jax._composite_backward(
        t1_j, geo_j.RvT, geo_j.ybasis, geo_j.live_u, geo_j.live_v, geo_j.norm,
        geo_j.geom, gaux, occ_j, sj, Pn, Qn, PB, Pb).astype(jnp.float32))
    rvt, yb, lu, lv, nm, geom = _geo_ops(geo_j)
    got = gt.composite_backward(_bf16(t1_j), rvt, yb, lu, lv, nm, geom, t(gaux),
                                tuple(map(t, occ_j)), st, Pn, Qn, PB, Pb)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert not got[:, 3 * st.ncoeff + 1:].any()
    p999, cos = _rel_stats(got.float().numpy(), want)
    print(f"q-split backward plain vs JAX: p999 rel {p999:.3g}, cosine {cos:.9f}")
    assert p999 < 0.05 and cos > 0.9999 and np.abs(want).max() > 0


def test_qsplit_train_step_matches_jax():
    """One gnomonic_train_step_multi with fused=False and qb = 128 (k = 2
    jittered views, 110 x 110 pixels, so Qn = 256: the q-split pipeline K6 /
    K8, here through their plain versions) against the JAX package's step
    with make_gnomonic_train_statics(fused=False): metrics within rtol 2e-5;
    Adam's first moments (0.1 of the gradient) cosine > 0.99995 and p999 <
    0.12 (measured 0.9999895 / 0.035 for the densities); the updated grids
    within 2 lr everywhere and 1e-4 on all but 1% of the elements."""
    k, lr, size, focal = 2, 0.03, 110, 120.0
    jgrid, tgrid = _grids()
    poses = [_pose_arrays(140.0 + 8.0 * i, -30.0) for i in range(k)]
    rots = np.stack([p[1] for p in poses])
    orgs = np.stack([p[2] for p in poses])
    axis, flip = gn.dominant_axis_for_pose(rots[0])
    kw = dict(image_height=size, image_width=size, white_bkgd=True,
              apply_diffuse_render_regularization=True, pos_per_cell=2, qb=128)
    tj = gt_jax.make_gnomonic_train_statics(jgrid, axis, flip, interpret=True, fused=False,
                                            **kw)
    tt = gt.make_gnomonic_train_statics(tgrid, axis, flip, fused=False, **kw)
    assert not tj.fused and not tt.fused and tt.frame[:2] == tj.frame[:2] == (256, 256)
    assert gn._qb_blocks(tt.statics, tt.frame[1])[0] == 2
    images = np.random.default_rng(3).random((k, size, size, 3), dtype=np.float32)
    key = jax.random.PRNGKey(12)
    tx = optax.adam(optax.exponential_decay(lr, transition_steps=1, decay_rate=0.1,
                                            staircase=True), b1=0.9, b2=0.999)
    copy = lambda tree: jax.tree_util.tree_map(jnp.copy, tree)  # noqa: E731
    g_j, opt_j, m_j = gt_jax.gnomonic_train_step_multi(
        tj, tx, copy(jgrid), tx.init(jgrid), jnp.asarray(images), jnp.asarray(rots),
        jnp.asarray(orgs), jnp.float32(focal), key)
    phases = [_phase(kk) for kk in jax.random.split(key, k)]
    opt, sched = trainer.make_gnomonic_optimizer(tgrid, lr, 1, 0.1)
    m_t = gt.gnomonic_train_step_multi(tt, opt, tgrid, t(images), rots, orgs, focal,
                                       phases=phases, scheduler=sched)
    for name in m_j:
        print(f"q-split step {name}: port {float(m_t[name]):.8f} JAX {float(m_j[name]):.8f}")
        np.testing.assert_allclose(float(m_t[name]), float(m_j[name]), rtol=2e-5)
    for fld in ("densities", "features"):
        param = getattr(tgrid, fld)
        p999, cos = _rel_stats(opt.state[param]["exp_avg"].numpy(),
                               np.asarray(getattr(opt_j[0].mu, fld)))
        new_t, new_j = param.detach().numpy(), np.asarray(getattr(g_j, fld))
        off = np.abs(new_t - new_j) > 1e-4
        print(f"q-split step {fld}: moment p999 {p999:.3g}, cosine {cos:.8f}; "
              f"{off.mean():.2e} of the grid beyond 1e-4")
        assert p999 < 0.12 and cos > 0.99995, (fld, p999, cos)
        assert np.abs(new_t - new_j).max() <= 2 * lr + 1e-6 and off.mean() < 0.01
