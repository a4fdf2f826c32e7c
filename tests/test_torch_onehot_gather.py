"""The PyTorch port's weighted one-hot gather (K13) and its scatter-add adjoint
(K14) against the JAX package's, through their plain PyTorch versions.

CPU tests at tests/test_pallas_onehot_gather.py's shapes and tolerances: the
same seeded table, indices and weights (numpy) go through
thr3ed_atom_tpu.ops.pallas.onehot_gather (its Pallas kernels in interpret
mode) and thr3ed_atom_tpu_torch.ops.onehot_gather's plain versions.
tests/test_torch_kernels.py holds the CUDA kernels against the same plain
versions on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_gnomonic import _one_torch_thread  # noqa: F401
from thr3ed_atom_tpu.ops.pallas import onehot_gather as og_jax
from thr3ed_atom_tpu_torch.ops import onehot_gather as og


@pytest.fixture(autouse=True)
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(B, C, N, K, seed=0, out_of_range=False):
    """Seeded table [B, C], indices [N, K] in [0, B) and weights [N, K];
    ``out_of_range`` sets some indices to -1, B and B + 7."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((B, C)).astype(np.float32)
    idx = rng.integers(0, B, (N, K)).astype(np.int32)
    w = rng.standard_normal((N, K)).astype(np.float32)
    if out_of_range:
        idx[::7, 0] = -1
        idx[3::11, -1] = B
        idx[5::13, K // 2] = B + 7
    return table, idx, w


@pytest.mark.parametrize("B,C,N,K", [(128, 128, 300, 8), (256, 128, 1024, 4),
                                     (128, 256, 64, 1)])
def test_forward_matches_jax(B, C, N, K):
    """weighted_onehot_gather's plain forward against the JAX package's
    (K13's TPU kernel in interpret mode). Bound: atol 1e-4, the JAX test's
    (f32 sums in another order)."""
    table, idx, w = _inputs(B, C, N, K)
    want = np.asarray(og_jax.weighted_onehot_gather(jnp.asarray(table), jnp.asarray(idx),
                                                    jnp.asarray(w)))
    got = og.weighted_onehot_gather(torch.from_numpy(table), torch.from_numpy(idx),
                                    torch.from_numpy(w), plain=True)
    assert got.dtype == torch.float32 and got.shape == (N, C)
    print(f"onehot gather plain vs JAX: max-abs {np.abs(got.numpy() - want).max():.3g}")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # the wrapper on a CPU tensor is the plain version
    torch.testing.assert_close(og.onehot_gather_forward(*map(torch.from_numpy, (table, idx, w))),
                               got, rtol=0, atol=0)


def test_plain_gather_matches_jax():
    """onehot_gather (unit weights, one index a row) equals the JAX package's
    and the plain row lookup, atol 1e-5."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((128, 128)).astype(np.float32)
    idx = rng.integers(0, 128, 77).astype(np.int32)
    want = np.asarray(og_jax.onehot_gather(jnp.asarray(table), jnp.asarray(idx)))
    got = og.onehot_gather(torch.from_numpy(table), torch.from_numpy(idx), plain=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, table[idx], atol=1e-5)


def test_duplicate_indices_accumulate():
    """The same row named by several (n, k) slots sums its weights."""
    table = torch.eye(128)
    idx = torch.tensor([[3, 3, 5, 3]], dtype=torch.int32)
    w = torch.tensor([[1.0, 2.0, 10.0, 4.0]])
    out = og.weighted_onehot_gather(table, idx, w, plain=True)
    assert float(out[0, 3]) == pytest.approx(7.0) and float(out[0, 5]) == pytest.approx(10.0)
    assert float(out.sum()) == pytest.approx(17.0)


def _grads(table, idx, w, jax_side):
    if jax_side:
        def loss(t, w_):
            return jnp.sum(og_jax.weighted_onehot_gather(t, jnp.asarray(idx), w_) ** 2)

        gt, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(w))
        return np.asarray(gt), np.asarray(gw)
    t = torch.from_numpy(table).requires_grad_(True)
    w_ = torch.from_numpy(w).requires_grad_(True)
    (og.weighted_onehot_gather(t, torch.from_numpy(idx), w_, plain=True) ** 2).sum().backward()
    return t.grad.numpy(), w_.grad.numpy()


@pytest.mark.parametrize("out_of_range", [False, True])
def test_gradients_match_jax(out_of_range):
    """Both gradients of sum(out^2) (the table's by K14, the weights' by K13
    with unit weights and a row dot) against the JAX package's custom VJP at
    (B, C, N, K) = (128, 128, 200, 8). Bound: atol 1e-3, rtol 1e-4, the JAX
    test's. With indices at -1, B and B + 7 the forward and both gradients
    still agree (such an index contributes nothing, and its weight's
    gradient is 0)."""
    table, idx, w = _inputs(128, 128, 200, 8, seed=2, out_of_range=out_of_range)
    if out_of_range:
        want = np.asarray(og_jax.weighted_onehot_gather(jnp.asarray(table), jnp.asarray(idx),
                                                        jnp.asarray(w)))
        got = og.weighted_onehot_gather(*map(torch.from_numpy, (table, idx, w)), plain=True)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    gt_j, gw_j = _grads(table, idx, w, True)
    gt_t, gw_t = _grads(table, idx, w, False)
    print(f"onehot gradients plain vs JAX: table {np.abs(gt_t - gt_j).max():.3g}, weights "
          f"{np.abs(gw_t - gw_j).max():.3g}")
    np.testing.assert_allclose(gt_t, gt_j, atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(gw_t, gw_j, atol=1e-3, rtol=1e-4)
    if out_of_range:
        bad = (idx < 0) | (idx >= 128)
        assert bad.any() and not gw_t[bad].any()
