"""The PyTorch port's small ops against the JAX package: relu_trap (K1a), the
scanline resample (K2) and the two-pass warp. The port's plain versions run
against the JAX functions (Pallas in interpret mode) on the CPU; inputs are
made with numpy from a seed. tests/test_torch_kernels.py holds the CUDA
kernels against the same plain versions on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thr3ed_atom_tpu.ops.pallas.plane_march import _relu_trap
from thr3ed_atom_tpu.rendering import warp_matmul as wm_jax
from thr3ed_atom_tpu_torch.ops.relu_trap import relu_trap_plain
from thr3ed_atom_tpu_torch.rendering import warp_matmul as wm
from thr3ed_atom_tpu_torch.utils.camera import pose_spherical


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker processes
    at once, and PyTorch's idle OpenMP threads spinning in each of them starve
    the others (the plain path issues many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trap_pairs(n=100_000, seed=0):
    """Seeded (a, b) pairs: generic, near-equal endpoints, zero crossings in
    both directions, both negative, and exact ties."""
    rng = np.random.default_rng(seed)
    k = n // 5
    a = rng.uniform(-4, 4, n).astype(np.float32)
    b = rng.uniform(-4, 4, n).astype(np.float32)
    b[:k] = a[:k] + rng.uniform(-2e-6, 2e-6, k).astype(np.float32)  # near-equal
    a[k:2 * k] = np.abs(a[k:2 * k])  # a > 0 > b: head
    b[k:2 * k] = -np.abs(b[k:2 * k])
    a[2 * k:3 * k] = -np.abs(a[2 * k:3 * k])  # a < 0 < b: tail
    b[2 * k:3 * k] = np.abs(b[2 * k:3 * k])
    a[3 * k:4 * k] = -np.abs(a[3 * k:4 * k])  # both negative
    b[3 * k:4 * k] = -np.abs(b[3 * k:4 * k])
    b[4 * k:4 * k + 100] = a[4 * k:4 * k + 100]  # exact ties
    return a, b


@pytest.mark.parametrize("relu", [True, False])
def test_relu_trap_plain_matches_jax(relu):
    """Same f32 operations in the same order: rtol 1e-6 (f32 ulp scale)."""
    a, b = _trap_pairs()
    if not relu:  # identity post-activation sees non-negative grids
        a, b = np.abs(a), np.abs(b)
    want = _relu_trap(jnp.asarray(a), jnp.asarray(b), relu)
    got = relu_trap_plain(torch.from_numpy(a), torch.from_numpy(b), relu)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def _resample_inputs(seed, NB=8, CH=8, K=256, N=128, order=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(NB, CH, K)).astype(np.float32)
    X[:, :, : K // 4] = 0.0  # a zero source region, as the composited background
    lo, hi = wm._clip_range(order, K)
    pos = rng.uniform(lo - 3, hi + 3, (NB, 1, N)).astype(np.float32)
    pos[:, :, :8] = np.arange(8, dtype=np.float32) + 2.0  # integer positions
    pos = np.clip(pos, lo, hi)
    return X, pos


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("taps", [False, True])
def test_resample_rows_plain_matches_jax(order, taps):
    """The gather form sums the four taps in order where the TPU kernel runs a
    banded f32 matmul: atol 1e-5 covers the different summation order."""
    X, pos = _resample_inputs(1 + order + 2 * taps, order=order)
    want = np.asarray(wm_jax.resample_rows(jnp.asarray(X), jnp.asarray(pos),
                                           order, True, taps))
    got = wm.resample_rows(torch.from_numpy(X), torch.from_numpy(pos), order, taps)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if order == 3:
        want_c = np.asarray(wm_jax.resample_rows_clamped(
            jnp.asarray(X), jnp.asarray(pos), 3, True))
        got_c = wm.resample_rows_clamped(torch.from_numpy(X), torch.from_numpy(pos), 3)
        np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=1e-5)


class _Statics:  # the statics fields the warp reads
    def __init__(self, axis, flip, with_diffuse=False):
        self.axis, self.flip, self.with_diffuse, self.interpret = (
            axis, flip, with_diffuse, True)


@pytest.mark.parametrize("roll,order", [(0.0, 3), (75.0, 3), (0.0, 1), (75.0, 1)])
def test_warp_state_matmul_matches_jax(roll, order):
    """Both warps (swap False and True — the 75 degree roll swaps the passes)
    on one seeded state: atol 1e-5 per the resample tolerance."""
    from thr3ed_atom_tpu.rendering.bricked import dominant_axis_for_pose

    H = W = 96
    focal, Pn, Qn = 105.0, 128, 128
    pose = pose_spherical(40.0, -35.0, 4.0)
    rot = np.asarray(pose.rotation, np.float64).reshape(3, 3)
    c, s = np.cos(np.radians(roll)), np.sin(np.radians(roll))
    rot = (rot @ np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])).astype(np.float32)
    axis, flip = dominant_axis_for_pose(rot)
    swap = wm.warp_swap_for_pose(rot, axis, flip, H, W, focal)
    assert swap == wm_jax.warp_swap_for_pose(rot, axis, flip, H, W, focal)
    assert swap == (roll == 75.0)
    rng = np.random.default_rng(5)
    state = rng.uniform(0, 1, (6, Pn, Qn)).astype(np.float32)
    xr = (np.float32(-0.7), np.float32(0.75))
    yr = (np.float32(-0.72), np.float32(0.69))
    st = _Statics(axis, flip)
    want = np.asarray(wm_jax.warp_state_matmul(
        jnp.asarray(state), tuple(map(jnp.asarray, xr)), tuple(map(jnp.asarray, yr)),
        jnp.asarray(rot), st, H, W, jnp.float32(focal), Pn, Qn, order, swap, True))
    t = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    got = wm.warp_state_matmul(
        torch.from_numpy(state), (t(xr[0]), t(xr[1])), (t(yr[0]), t(yr[1])),
        torch.from_numpy(rot), st, H, W, t(focal), Pn, Qn, order, swap)
    assert got.shape == want.shape == (H, W, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_warp_swap_for_pose_matches_jax():
    from thr3ed_atom_tpu.rendering.bricked import dominant_axis_for_pose

    rng = np.random.default_rng(11)
    for _ in range(50):
        pose = pose_spherical(rng.uniform(0, 360), rng.uniform(-90, 0), 4.0)
        rot = np.asarray(pose.rotation).reshape(3, 3)
        roll = np.radians(rng.uniform(-90, 90))
        c, s = np.cos(roll), np.sin(roll)
        rot = rot @ np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        axis, flip = dominant_axis_for_pose(rot)
        args = (rot, axis, flip, 300, 400, 330.0)
        assert wm.warp_swap_for_pose(*args) == wm_jax.warp_swap_for_pose(*args)
