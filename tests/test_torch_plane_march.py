"""The PyTorch port's plane-march kernels (K11 forward, K12 replay backward)
against the JAX package's, through their plain PyTorch versions.

CPU tests at tests/test_plane_march.py's shapes (2 tiles of 64 rays, a
3 x 32 x 32 repacked grid of 8 positions a row, subrange entries, SH degree
2): the same seeded tables, rays and grid go through
thr3ed_atom_tpu.ops.pallas.plane_march (its Pallas kernels in interpret mode)
and thr3ed_atom_tpu_torch.ops.plane_march's plain versions.
tests/test_torch_kernels.py holds the CUDA kernels against the same plain
versions on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_plane_march import GS, NCOEFF, R, T_TILES, _setup
from test_torch_gnomonic import _one_torch_thread  # noqa: F401
from thr3ed_atom_tpu.ops.pallas import plane_march as pm_jax
from thr3ed_atom_tpu_torch.ops import plane_march as pm


def _inputs(opaque=False, goff=0):
    """tests/test_plane_march.py's seeded inputs, as JAX arrays and as torch
    tensors. ``opaque`` makes every ray's positions land inside its entries'
    patches (patch origins 0, in-plane slopes within +-0.2, every position
    live) and the densities positive and 40 times larger, so that a tile's
    rays turn opaque within its first entries: an early exit at transmittance
    0.5 then ends a tile before its last entry. ``goff`` shifts the tables'
    group indices by that much (the grid operand then starts at group goff)."""
    tables, counts, rays, grid = _setup(None)
    if opaque:
        rng = np.random.default_rng(11)
        tables = np.array(tables)
        tables[..., 1:3] = 0
        rays = np.array(rays)
        for lane in (0, 2):
            rays[..., lane] = rng.uniform(4, 10, rays.shape[:2])
            rays[..., lane + 1] = rng.uniform(-0.2, 0.2, rays.shape[:2])
        rays[..., 7] = 3 * GS
        dens = np.zeros(grid.shape[-1], bool)
        dens[3 * NCOEFF::32] = True
        g32 = np.asarray(grid.astype(jnp.float32))
        grid = jnp.asarray(np.where(dens, np.abs(g32) * 40.0, g32)).astype(jnp.bfloat16)
        tables, rays = jnp.asarray(tables), jnp.asarray(rays)
    if goff:
        tables = jnp.asarray(tables).at[..., 0].add(goff)
    torch_in = (torch.from_numpy(np.array(tables)), torch.from_numpy(np.array(counts)),
                torch.from_numpy(np.array(rays)),
                torch.from_numpy(np.array(grid.astype(jnp.float32))).to(torch.bfloat16))
    return (tables, counts, rays, grid), torch_in


@pytest.mark.parametrize("relu,with_diffuse,exit_eps,opaque,goff", [
    (False, False, 0.0, False, 0), (False, True, 0.0, False, 0), (True, True, 1e-4, False, 0),
    (True, False, 0.0, False, 2), (True, True, 0.5, True, 0)])
def test_forward_matches_jax(relu, with_diffuse, exit_eps, opaque, goff):
    """plane_march_render_plain against the JAX package's plane_march_render
    (K11's TPU kernel in interpret mode): the same taps, bf16 tents and
    products, the same relu_trap; what remains is f32 round-off of the SH
    fold's dot and of exp / sigmoid. Bound: max-abs 1e-5 (measured <=
    2.4e-7). With ``group_offset`` the tables' global groups address the
    grid operand from group goff. On the opaque grid the early exit must end
    a tile before its last entry, at the same entry in both."""
    (tj, cj, rj, gj), (tt, ct, rt, gt) = _inputs(opaque, goff)
    kw = dict(ncoeff=NCOEFF, relu_sigma=relu, exit_eps=exit_eps, with_diffuse=with_diffuse)
    want = np.asarray(pm_jax.plane_march_render(tj, cj, rj, gj, group_offset=goff,
                                                interpret=True, **kw))
    got = pm.plane_march_render_plain(tt, ct, rt, gt, group_offset=goff, **kw).numpy()
    assert got.shape == want.shape == (T_TILES, R, 8)
    gap = np.abs(got - want).max()
    print(f"plane march forward plain vs JAX: max-abs {gap:.3g}")
    assert gap <= 1e-5 and np.abs(want[..., 3]).max() > 0.02
    if not with_diffuse:
        assert not got[..., 5:].any()
    if opaque:
        full = pm.plane_march_render_plain(tt, ct, rt, gt, **{**kw, "exit_eps": 0.0})
        _, (n_exit, _) = pm.plane_march_render_plain(tt, ct, rt, gt, return_work=True, **kw)
        _, (n_full, _) = pm.plane_march_render_plain(tt, ct, rt, gt, return_work=True,
                                                     **{**kw, "exit_eps": 0.0})
        assert n_exit < n_full and np.abs(full.numpy() - got).max() > 1e-3


def _cotangent_gap(got, want):
    scale = np.abs(want).max()
    a, b = want.astype(np.float64).ravel(), got.astype(np.float64).ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))
    return scale, np.abs(got - want).max(), int((got != want).sum()), cos


@pytest.mark.parametrize("relu,with_diffuse,exit_eps,opaque", [
    (False, False, 0.0, False), (True, True, 0.0, False), (True, True, 0.5, True)])
def test_backward_matches_jax(relu, with_diffuse, exit_eps, opaque):
    """plane_march's gradient through the plain replay VJP (K12's plain
    version, the cotangent cast to the grid's bf16) against the JAX package's
    custom VJP (K12's TPU kernel in interpret mode) for a seeded output
    cotangent, without and with an early exit that ends tiles. Bound: the bf16
    cotangents equal, or within 2^-8 of the largest element with cosine >
    0.99999 (the f32 sums of W^T @ d_interp run in another order before the
    cast). Measured: <= 19 of 786,432 elements differ, by one bf16 unit of
    their own size."""
    (tj, cj, rj, gj), (tt, ct, rt, gt) = _inputs(opaque)
    kw = dict(ncoeff=NCOEFF, relu_sigma=relu, exit_eps=exit_eps, with_diffuse=with_diffuse)
    gw = np.random.default_rng(1).standard_normal((T_TILES, R, 8)).astype(np.float32)

    def loss(g):
        return jnp.sum(pm_jax.plane_march(tj, cj, rj, g, interpret=True, **kw) * gw)

    want = np.asarray(jax.grad(loss)(gj).astype(jnp.float32))
    grid = gt.clone().requires_grad_(True)
    out = pm.plane_march(tt, ct, rt, grid, plain=True, **kw)
    (out * torch.from_numpy(gw)).sum().backward()
    assert grid.grad.dtype == torch.bfloat16
    got = grid.grad.float().numpy()
    scale, gap, n_diff, cos = _cotangent_gap(got, want)
    print(f"plane march gradient plain vs JAX: {n_diff} of {got.size} differ, max-abs "
          f"{gap:.3g} of {scale:.3g}, cosine {cos:.9f}")
    assert scale > 1e-3
    assert n_diff == 0 or (gap <= scale * 2.0 ** -8 and cos > 0.99999)


def test_backward_is_the_plain_replay_and_exit_is_consistent():
    """The autograd Function's gradient is plane_march_grad_plain of the
    output cotangent cast to bf16; and, as tests/test_plane_march.py:213
    checks for the JAX package, the gradient with exit_eps 1e-4 equals the one
    without on a low-density scene where no tile saturates."""
    (_, (tt, ct, rt, gt)) = _inputs()
    rt = rt.clone()
    rt[..., 8] = 0.01
    kw = dict(ncoeff=NCOEFF, relu_sigma=False, with_diffuse=False)
    grads = []
    for eps in (0.0, 1e-4):
        grid = gt.clone().requires_grad_(True)
        out = pm.plane_march(tt, ct, rt, grid, exit_eps=eps, plain=True, **kw)
        (out[..., :4] ** 2).sum().backward()
        grads.append(grid.grad)
    assert torch.equal(grads[0], grads[1]) and float(grads[0].float().abs().max()) > 0.0
    out = pm.plane_march_render_plain(tt, ct, rt, gt, exit_eps=0.0, **kw)
    gout = torch.zeros_like(out)
    gout[..., :4] = 2.0 * out[..., :4]
    want = pm.plane_march_grad_plain(tt, ct, rt, gt, out, gout, exit_eps=0.0, **kw)
    assert torch.equal(grads[0], want.to(torch.bfloat16))
