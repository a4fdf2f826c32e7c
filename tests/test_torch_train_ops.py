"""The PyTorch port's training operators against the JAX package: the training
geometry (SH basis, norm, phase jitter), the composite's operand branch (K1),
the warp resample's VJP (K4) and the clamped warp's gradient, and the
composite's replay VJP (K3).

CPU tests run the port's plain versions against the JAX functions (Pallas in
interpret mode) on tests/test_torch_gnomonic.py's carved 16^3 relu scene with
128 x 128 images, a 256 x 256 texel frame (two q-blocks). Every input is made
from a seed with numpy and crosses over unchanged; each test states its
tolerance. tests/test_torch_kernels.py holds the CUDA kernels against the same
plain versions on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gnomonic import FOCAL, H, SS, W, _grids, _one_torch_thread, _pose_arrays  # noqa: F401
from thr3ed_atom_tpu.rendering import gnomonic as gn_jax
from thr3ed_atom_tpu.rendering import gnomonic_train as gt_jax
from thr3ed_atom_tpu.rendering import warp_matmul as wm_jax
from thr3ed_atom_tpu_torch.rendering import gnomonic as gn
from thr3ed_atom_tpu_torch.rendering import gnomonic_train as gt
from thr3ed_atom_tpu_torch.rendering import warp_matmul as wm

PHASE = (0.3125, -0.4375)


def t(x):
    return torch.from_numpy(np.array(x))


def _train_variant(jgrid, tgrid, rot, P, diffuse):
    axis, flip = gn.dominant_axis_for_pose(rot)
    sj = gn_jax.statics_for_grid(jgrid, axis, flip, with_diffuse=diffuse,
                                 pos_per_cell=P, interpret=True, qb=128)
    st = gn.statics_for_grid(tgrid, axis, flip, with_diffuse=diffuse,
                             pos_per_cell=P, qb=128)
    return sj, st


def _jax_train_operands(jgrid, sj, rot, org, phase=PHASE):
    Pn, Qn, PB, Pb = gn_jax.gnomonic_frame(None, H, W, FOCAL, SS, sj)
    QB, Qb = gn_jax._qb_blocks(sj, Qn)
    slices = gn_jax.repack_position_slices(jgrid, sj, True, True)
    geo = gn_jax.gnomonic_geometry(jnp.asarray(rot), jnp.asarray(org), sj, H, W,
                                   jnp.float32(FOCAL), SS, frame=(Pn, Qn),
                                   phase=tuple(jnp.float32(p) for p in phase),
                                   lite=True)
    occ = gn_jax.gnomonic_occupancy_lite(slices, geo.geom, sj, Pn, Qn, PB, Pb, QB, Qb)
    return (Pn, Qn, PB, Pb), slices, geo, occ


def _rel_stats(got, want):
    """(p999 relative error with tests/test_gnomonic_train.py's denominator,
    cosine)."""
    a = np.asarray(want, np.float64).ravel()
    b = np.asarray(got, np.float64).ravel()
    denom = np.maximum(np.abs(a), 1e-2 * np.abs(a).max() + 1e-8)
    rel = np.abs(a - b) / denom
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))
    return float(np.quantile(rel, 0.999)), cos


@pytest.mark.parametrize("yaw,pitch,phase", [(140.0, -30.0, PHASE), (35.0, -70.0, (-0.5, 0.5))])
def test_training_geometry_matches_jax(yaw, pitch, phase):
    """gnomonic_geometry(skip_basis=False) with a phase shift: geom, frame
    ranges, SH basis and norm within rtol 2e-6 of the JAX package's."""
    jgrid, tgrid = _grids()
    _, rot, org = _pose_arrays(yaw, pitch)
    sj, st = _train_variant(jgrid, tgrid, rot, 2, True)
    (Pn, Qn, _, _), _, geo_j, _ = _jax_train_operands(jgrid, sj, rot, org, phase)
    geo_t = gn.gnomonic_geometry(t(rot), t(org), st, H, W, torch.tensor(FOCAL), SS,
                                 phase=phase, skip_basis=False)
    assert geo_t.ybasis.shape == (st.ncoeff, Pn, Qn) and geo_t.norm.shape == (Pn, Qn)
    for got, want in ((geo_t.geom, geo_j.geom), (geo_t.ybasis, geo_j.ybasis),
                      (geo_t.norm, geo_j.norm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)
    for a, b in zip(geo_t.xr + geo_t.yr, geo_j.xr + geo_j.yr):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-7)
    unshifted = gn.gnomonic_geometry(t(rot), t(org), st, H, W, torch.tensor(FOCAL), SS)
    assert float(unshifted.xr[0]) != float(geo_t.xr[0])  # the phase moved the frame


@pytest.mark.parametrize("P,diffuse", [(1, True), (2, False)])
def test_composite_operand_branch_matches_jax(P, diffuse):
    """The composite with materialized ybasis / norm operands (the training
    branch) against the JAX fused kernel's operand branch in interpret mode,
    on the same slices, geometry and flags. Bound as the serving branch's
    test: colour/acc/T 3e-3, depth 2e-2; the gap is printed."""
    jgrid, tgrid = _grids()
    _, rot, org = _pose_arrays(140.0, -30.0)
    sj, st = _train_variant(jgrid, tgrid, rot, P, diffuse)
    (Pn, Qn, PB, Pb), s_j, geo_j, occ_j = _jax_train_operands(jgrid, sj, rot, org)
    want = np.asarray(gn_jax.composite_positions_fused(
        s_j, geo_j.ybasis, geo_j.norm, geo_j.geom, sj, Pn, Qn, PB, Pb, occ_j))
    got = gn.composite_positions_fused(
        gn.repack_position_slices(tgrid, st), t(geo_j.ybasis), t(geo_j.norm),
        t(geo_j.geom), st, Pn, Qn, PB, Pb, tuple(map(t, occ_j))).numpy()
    assert got.shape == want.shape == (9 if diffuse else 6, Pn, Qn)
    gap = np.abs(got - want).max(axis=(1, 2))
    print(f"operand-branch composite vs JAX max-abs per row: {gap}")
    assert gap[:5].max() < 3e-3 and gap[5] < 2e-2 and gap[6:].max(initial=0.0) < 3e-3
    assert float(want[4].max()) > 0.5


def _resample_case(seed, order, NB=16, K=256, N=256):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(NB, 8, K)).astype(np.float32)
    X[:, :, : K // 4] = 0.0
    lo, hi = wm._clip_range(order, K)
    pos = rng.uniform(lo - 3, hi + 3, (NB, 1, N)).astype(np.float32)
    pos[:, :, :16] = lo  # a clipped run: many outputs on one tap
    pos[:, :, 16:24] = np.arange(8, dtype=np.float32) + 2.0  # integer positions
    return X, np.clip(pos, lo, hi).astype(np.float32)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("taps", [False, True])
def test_resample_rows_vjp_matches_jax(order, taps):
    """resample_rows' backward (the adjoint resample) against jax.vjp of the
    JAX package's custom-VJP resample (its adjoint Pallas kernel in interpret
    mode), on a seeded cotangent: rtol 1e-5 (atol 1e-5 on the cotangent's
    scale). The forward agrees too."""
    X, pos = _resample_case(11, order)
    rng = np.random.default_rng(12)
    shape = (16, 3, 8, 256) if taps else (16, 8, 256)
    dY = rng.normal(size=shape).astype(np.float32)
    y_j, vjp = jax.vjp(lambda x: wm_jax.resample_rows(x, jnp.asarray(pos), order, True, taps),
                       jnp.asarray(X))
    (dX_j,) = vjp(jnp.asarray(dY))
    X_t = t(X).requires_grad_(True)
    y_t = wm.resample_rows(X_t, t(pos), order, taps)
    y_t.backward(t(dY))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(X_t.grad.numpy(), np.asarray(dX_j), rtol=1e-5, atol=1e-5)
    direct = wm.resample_rows_adjoint_plain(t(dY), t(pos), order, 256, taps)
    np.testing.assert_array_equal(direct.numpy(), X_t.grad.numpy())


def test_clamp_gradient_splits_ties_like_jax():
    """At y = t0 = t1 the ringing clamp's gradient splits (1/4, 3/8, 3/8) as
    the reference's jnp.clip does (torch.clamp with tensor bounds gives
    (1, 0, 0)); away from ties it passes through the active operand."""
    vals = [(0.0, 0.0, 0.0), (0.5, 0.25, 0.75), (2.0, 0.25, 0.75), (-1.0, 0.5, 0.25)]
    for y, a, b in vals:
        gj = jax.grad(lambda y_, a_, b_: jnp.clip(y_, jnp.minimum(a_, b_), jnp.maximum(a_, b_)),
                      argnums=(0, 1, 2))(y, a, b)
        yt, at, bt = (torch.tensor(v, requires_grad=True) for v in (y, a, b))
        torch.minimum(torch.maximum(yt, torch.minimum(at, bt)), torch.maximum(at, bt)).backward()
        assert (float(yt.grad), float(at.grad), float(bt.grad)) == tuple(float(g) for g in gj)


@pytest.mark.parametrize("swap", [False, True])
def test_clamped_warp_gradient_matches_jax(swap):
    """The Catmull-Rom matmul warp's gradient with respect to the composited
    state, through both clamped passes, against jax.vjp of the JAX package's
    warp_state_matmul (interpret mode) for both pass orders. The source has
    empty rows and columns, so the clamp meets ties (y = t0 = t1 = 0) where
    the cotangent is non-zero. The outputs agree within rtol 1e-5, atol
    1e-5. The gradient is discontinuous where an interpolant sits within f32
    round-off of a clamp bound (the two packages sum the taps in different
    orders), so: at most 1e-4 of its elements outside rtol 1e-5 / atol 1e-5,
    none beyond 1e-2 of the largest, and cosine > 0.999999."""
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
    fj = lambda s: wm_jax.warp_state_matmul(  # noqa: E731
        s, geo.xr, geo.yr, jnp.asarray(rot), sj, H, W, jnp.float32(FOCAL), Pn, Qn, 3,
        swap, True)
    out_j, vjp = jax.vjp(fj, jnp.asarray(state))
    (g_j,) = vjp(jnp.asarray(g_out))
    s_t = t(state).requires_grad_(True)
    out_t = wm.warp_state_matmul(s_t, tuple(map(t, geo.xr)), tuple(map(t, geo.yr)), t(rot),
                                 st, H, W, torch.tensor(FOCAL), Pn, Qn, 3, swap)
    out_t.backward(t(g_out))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    g_j, g_t = np.asarray(g_j), s_t.grad.numpy()
    scale = np.abs(g_j).max()
    off = np.abs(g_t - g_j) > 1e-5 + 1e-5 * np.abs(g_j)
    _, cos = _rel_stats(g_t, g_j)
    print(f"clamped warp gradient vs JAX: max-abs {np.abs(g_t - g_j).max():.3g} "
          f"(scale {scale:.3g}), {int(off.sum())} of {off.size} elements beyond "
          f"1e-5, cosine {cos:.9f}")
    assert off.mean() < 1e-4 and np.abs(g_t - g_j).max() < 1e-2 * scale and cos > 0.999999
    assert float(np.abs(g_j[1:, : Pn // 3]).max()) > 0.0  # ties carry gradient


@pytest.mark.parametrize("P,diffuse", [(1, False), (2, True)])
def test_composite_replay_vjp_matches_jax(P, diffuse):
    """The composite's replay VJP (plain version of K3 and the position ->
    vertex fold) against jax.vjp of the JAX package's
    composite_positions_fused_diff (the fused backward kernel in interpret
    mode) over two q-blocks, with a seeded state cotangent. Both round the
    cotangent to bf16 at the same three points and differ in the order of
    the tent sums only. Bounds: cosine > 0.9999 and p999 relative error
    < 0.05 (tests/test_gnomonic_train.py's bf16 tolerance for a replay VJP);
    the state is held at 3e-3."""
    jgrid, tgrid = _grids()
    _, rot, org = _pose_arrays(140.0, -30.0)
    sj, st = _train_variant(jgrid, tgrid, rot, P, diffuse)
    (Pn, Qn, PB, Pb), s_j, geo_j, occ_j = _jax_train_operands(jgrid, sj, rot, org)
    assert gn._qb_blocks(st, Qn)[0] == 2
    rng = np.random.default_rng(21)
    gstate = rng.normal(size=(9 if diffuse else 6, Pn, Qn)).astype(np.float32)
    state_j, vjp = jax.vjp(
        lambda s: gt_jax.composite_positions_fused_diff(
            s, geo_j.ybasis, geo_j.norm, geo_j.geom, *occ_j, sj, Pn, Qn, PB, Pb), s_j)
    (ds_j,) = vjp(jnp.asarray(gstate))
    s_t = gn.repack_position_slices(tgrid, st).requires_grad_(True)
    state_t = gt.composite_positions_fused_diff(
        s_t, t(geo_j.ybasis), t(geo_j.norm), t(geo_j.geom), *map(t, occ_j), st, Pn, Qn,
        PB, Pb)
    state_t.backward(t(gstate))
    assert np.abs(state_t.detach().numpy() - np.asarray(state_j)).max() < 3e-3
    got = s_t.grad.float().numpy()
    want = np.asarray(ds_j.astype(jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    p999, cos = _rel_stats(got, want)
    print(f"replay VJP vs JAX (P={P}, diffuse={diffuse}): p999 rel {p999:.3g}, "
          f"cosine {cos:.8f}, max-abs {np.abs(got - want).max():.3g} "
          f"(scale {np.abs(want).max():.3g})")
    assert cos > 0.9999 and p999 < 0.05, (cos, p999)
    assert np.abs(want).max() > 0.0
    C = gn._padded_channels(st)
    assert not got[:, :, 3 * st.ncoeff + 1:C].any()  # pad channels stay zero
