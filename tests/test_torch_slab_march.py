"""The PyTorch port's slab-march kernels (K9 forward, K10 replay backward)
against the JAX package's, through their plain PyTorch versions.

CPU tests at tests/test_slab_march_grad.py's shapes (2 tiles of 64 rays, a
3 x 32 x 32 repacked grid, split entries, SH degree 2): the same seeded
tables, rays and grid go through thr3ed_atom_tpu.ops.pallas.slab_march (its
Pallas kernels in interpret mode) and thr3ed_atom_tpu_torch.ops.slab_march's
plain versions. tests/test_torch_kernels.py holds the CUDA kernels against
the same plain versions on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_slab_march_grad import NCOEFF, R, T_TILES, _setup
from thr3ed_atom_tpu.ops.pallas import slab_march as sm_jax
from thr3ed_atom_tpu_torch.ops import slab_march as sm


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(opaque=False):
    """tests/test_slab_march_grad.py's seeded inputs, as JAX arrays and as
    torch tensors. ``opaque`` makes every ray's samples land inside its
    entries' patches (patch origins 0, in-plane slopes within +-0.2, all 12
    slabs live) and scales the densities by 40, so that a tile's rays turn
    opaque within two entries: an early exit at transmittance 0.5 then ends
    the first tile before its third entry."""
    tables, counts, rays, grid = _setup(None)
    if opaque:
        rng = np.random.default_rng(11)
        tables = np.array(tables)
        tables[..., 1:3] = 0
        rays = np.array(rays)
        for lane in (0, 2):
            rays[..., lane] = rng.uniform(4, 12, rays.shape[:2])
            rays[..., lane + 1] = rng.uniform(-0.2, 0.2, rays.shape[:2])
        rays[..., 7] = 11.0
        dens = np.zeros(grid.shape[-1], bool)
        dens[3 * NCOEFF::32] = True
        g32 = np.asarray(grid.astype(jnp.float32))
        grid = jnp.asarray(np.where(dens, np.abs(g32) * 40.0, g32)).astype(jnp.bfloat16)
        tables, rays = jnp.asarray(tables), jnp.asarray(rays)
    torch_in = (torch.from_numpy(np.array(tables)), torch.from_numpy(np.array(counts)),
                torch.from_numpy(np.array(rays)),
                torch.from_numpy(np.array(grid.astype(jnp.float32))).to(torch.bfloat16))
    return (tables, counts, rays, grid), torch_in


@pytest.mark.parametrize("with_diffuse,exit_eps,opaque", [
    (False, 0.0, False), (True, 0.0, False), (False, 1e-4, False), (True, 0.5, True)])
def test_forward_matches_jax(with_diffuse, exit_eps, opaque):
    """slab_march_render_plain against the JAX package's slab_march (K9's TPU
    kernel in interpret mode): the same taps, bf16 tents and products; what
    remains is f32 round-off of the SH fold's dot and of exp / sigmoid.
    Bound: max-abs 2e-6 (measured 2.4e-7). On the opaque grid the early exit
    must end a tile before its last entry (an exit at transmittance 0.5, so
    that the skipped entry would still show), at the same entry in both."""
    (tj, cj, rj, gj), (tt, ct, rt, gt) = _inputs(opaque)
    want = np.asarray(sm_jax.slab_march(tj, cj, rj, gj, ncoeff=NCOEFF, exit_eps=exit_eps,
                                        with_diffuse=with_diffuse, interpret=True))
    got = sm.slab_march_render_plain(tt, ct, rt, gt, ncoeff=NCOEFF, exit_eps=exit_eps,
                                     with_diffuse=with_diffuse).numpy()
    assert got.shape == want.shape == (T_TILES, R, 8)
    gap = np.abs(got - want).max()
    print(f"slab march forward plain vs JAX: max-abs {gap:.3g}")
    assert gap <= 2e-6 and np.abs(want[..., 3]).max() > 0.1
    if not with_diffuse:
        assert not got[..., 5:].any()
    if opaque:
        # the exit removed work: a run without it composites more entries
        full = sm.slab_march_render_plain(tt, ct, rt, gt, ncoeff=NCOEFF, exit_eps=0.0,
                                          with_diffuse=with_diffuse).numpy()
        assert np.abs(full - got).max() > 1e-3 and got[..., 3].min() >= 1.0 - exit_eps


@pytest.mark.parametrize("relu_sigma,with_diffuse", [(False, False), (True, True)])
def test_grid_gradient_matches_jax(relu_sigma, with_diffuse):
    """The grid gradient of sum(out * w) through slab_march(plain=True) (the
    replay VJP K10's plain version, cast to the grid's bf16) against jax.grad
    of the JAX package's slab_march (its custom VJP, interpret mode): the
    replay rounds d_interp to bf16 where the reference does and the taps'
    products are exact. Bound: max-abs within one bf16 unit of the largest
    element (2^-8 of it) and cosine > 0.99999 (measured: bit-equal)."""
    (tj, cj, rj, gj), (tt, ct, rt, gt) = _inputs()
    gw = np.random.default_rng(3).normal(size=(T_TILES, R, 8)).astype(np.float32)
    kw = dict(ncoeff=NCOEFF, relu_sigma=relu_sigma, exit_eps=0.0, with_diffuse=with_diffuse)
    want = jax.grad(lambda g: jnp.sum(sm_jax.slab_march(tj, cj, rj, g, interpret=True, **kw)
                                      * gw))(gj)
    want = np.asarray(want.astype(jnp.float32))
    g = gt.clone().requires_grad_(True)
    (sm.slab_march(tt, ct, rt, g, plain=True, **kw) * torch.from_numpy(gw)).sum().backward()
    assert g.grad.dtype == torch.bfloat16
    got = g.grad.float().numpy()
    scale = np.abs(want).max()
    cos = float((got * want).sum() / np.sqrt((got ** 2).sum() * (want ** 2).sum()))
    gap = np.abs(got - want).max()
    print(f"slab march gradient plain vs JAX: max-abs {gap:.3g} of {scale:.3g}, "
          f"cosine {cos:.9f}, {(got != want).sum()} elements differ")
    assert scale > 1e-3 and gap <= scale * 2.0 ** -8 and cos > 0.99999


def test_gradient_with_early_exit_matches_jax():
    """With the early exit on an opaque grid, the replay stops where the
    forward stopped: the plain gradient (f32, before the bf16 cast) equals the
    JAX package's cast gradient to one bf16 unit of its largest element, and
    differs from the no-exit gradient."""
    (tj, cj, rj, gj), (tt, ct, rt, gt) = _inputs(opaque=True)
    gw = np.random.default_rng(4).normal(size=(T_TILES, R, 8)).astype(np.float32)
    kw = dict(ncoeff=NCOEFF, exit_eps=0.5)
    want = jax.grad(lambda g: jnp.sum(sm_jax.slab_march(tj, cj, rj, g, interpret=True, **kw)
                                      * gw))(gj)
    want = np.asarray(want.astype(jnp.float32))
    out = sm.slab_march_render_plain(tt, ct, rt, gt, **kw)
    got = sm.slab_march_grad_plain(tt, ct, rt, gt, out, torch.from_numpy(gw), **kw)
    assert got.dtype == torch.float32 and got.shape == gt.shape
    got = got.to(torch.bfloat16).float().numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= scale * 2.0 ** -8
    out0 = sm.slab_march_render_plain(tt, ct, rt, gt, ncoeff=NCOEFF, exit_eps=0.0)
    full = sm.slab_march_grad_plain(tt, ct, rt, gt, out0, torch.from_numpy(gw),
                                    ncoeff=NCOEFF, exit_eps=0.0)
    assert float((full.to(torch.bfloat16).float() - torch.from_numpy(got)).abs().max()) > 0.0


def test_wrappers_route_cpu_tensors_to_plain_versions():
    """On CPU tensors the kernel wrappers run their plain versions and count
    no launch; malformed operands raise."""
    _, (tt, ct, rt, gt) = _inputs()
    before = (sm.slab_march_render.launches, sm.slab_march_grad.launches)
    out = sm.slab_march_render(tt, ct, rt, gt, ncoeff=NCOEFF)
    torch.testing.assert_close(out, sm.slab_march_render_plain(tt, ct, rt, gt, ncoeff=NCOEFF),
                               rtol=0, atol=0)
    sm.slab_march_grad(tt, ct, rt, gt, out, torch.ones_like(out), ncoeff=NCOEFF)
    assert (sm.slab_march_render.launches, sm.slab_march_grad.launches) == before
    with pytest.raises(ValueError, match="bf16"):
        sm.slab_march_render(tt, ct, rt, gt.float(), ncoeff=NCOEFF)
    with pytest.raises(ValueError, match="ncoeff"):
        sm.slab_march_render(tt, ct, rt, gt, ncoeff=16)
