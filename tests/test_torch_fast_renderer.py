"""The PyTorch port's fast two-phase renderer (``render_sh_voxel_grid_fast``),
its cell-packed tables (ops/packed_grid.py), the hierarchical renderer and
``sample_pdf``, the flat-ray routes of the pose-structured procedures and
VolumetricModel's cache of prepared tables, against the JAX package.

CPU tests at small sizes (12^3 grids, 256 rays, up to 64 samples a ray).
Inputs come from numpy seeds; the jitter's uniforms, the fine uniforms and
the density noise's normals are drawn from the JAX key, split as the JAX
procedure splits it, and given to the port. The JAX functions run op by op
(no jit), as the port's do; each test states its tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thr3ed_atom_tpu.models.voxels import VoxelGrid as JaxVoxelGrid, VoxelGridLocation, VoxelSize
from thr3ed_atom_tpu.modules import volumetric_model as vm_jax
from thr3ed_atom_tpu.ops import packed_grid as pg_jax
from thr3ed_atom_tpu.rendering import fast_renderer as fast_jax
from thr3ed_atom_tpu.rendering import hierarchical as hier_jax
from thr3ed_atom_tpu.rendering import interface as if_jax
from thr3ed_atom_tpu.rendering import rays as rays_jax
from thr3ed_atom_tpu.rendering import renderer as renderer_jax
from thr3ed_atom_tpu.utils.camera import CameraBounds as JaxBounds
from thr3ed_atom_tpu.utils.camera import CameraIntrinsics as JaxIntrinsics
from thr3ed_atom_tpu_torch.apps import render_sh_voxel_grid as rcli
from thr3ed_atom_tpu_torch.models import voxels
from thr3ed_atom_tpu_torch.modules import trainer
from thr3ed_atom_tpu_torch.modules import volumetric_model as vm
from thr3ed_atom_tpu_torch.ops import packed_grid as pg
from thr3ed_atom_tpu_torch.ops.grid_sample import trilinear_grid_sample
from thr3ed_atom_tpu_torch.rendering import fast_renderer as fast
from thr3ed_atom_tpu_torch.rendering import hierarchical as hier
from thr3ed_atom_tpu_torch.rendering import rays, renderer
from thr3ed_atom_tpu_torch.rendering.interface import Rays
from thr3ed_atom_tpu_torch.utils.camera import CameraBounds, CameraIntrinsics, pose_spherical

BOUNDS = (1.0, 6.0)
INTR = CameraIntrinsics(20, 24, 26.0)
FAST = "render_sh_voxel_grid_fast"
HIER = "render_sh_voxel_grid_hierarchical"
ACC = "accumulated_weight"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the suite runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def n_(x):
    return np.asarray(x)


def t(x):
    return torch.from_numpy(np.array(x))


def _scene(size=12, seed=3, sh_degree=2, post="relu"):
    """A carved scene from a seed: density -1 (relu: empty) outside a ball,
    or an abs field (``post="identity"``), or a softplus field; SH of
    ``sh_degree``; numpy arrays and the grid config."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-2.0, 6.0, (size,) * 3 + (1,)).astype(np.float32)
    coords = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing="ij"), -1)
    dist = np.linalg.norm(coords - (size - 1) / 2, axis=-1, keepdims=True)
    d = np.where(dist < size / 3, d, -1.0).astype(np.float32)
    pre = "abs" if post == "identity" else "identity"
    f = (rng.normal(size=(size,) * 3 + (3 * (sh_degree + 1) ** 2,)) * 0.5).astype(np.float32)
    config = dict(voxel_size=(2.0 / size,) * 3, grid_location=(0.1, -0.05, 0.0),
                  density_preactivation=pre, density_postactivation=post,
                  feature_preactivation="identity", feature_postactivation="identity",
                  expected_density_scale=1.5, radiance_transfer_function=None)
    return d, f, config


def _grids(**kw):
    d, f, config = _scene(**kw)
    jgrid = JaxVoxelGrid(
        densities=jnp.asarray(d), features=jnp.asarray(f),
        voxel_size=VoxelSize(*config["voxel_size"]),
        grid_location=VoxelGridLocation(*config["grid_location"]),
        **{k: v for k, v in config.items() if k not in ("voxel_size", "grid_location")})
    return jgrid, voxels.voxel_grid_from_numpy(d, f, config, device="cpu")


def _flat_rays(n=256, seed=1):
    """Rays of one pose's image plus 8 that point away and miss the grid."""
    pose = pose_spherical(40.0, -30.0, 3.2)
    r = rays_jax.flatten_rays(rays_jax.cast_rays(JaxIntrinsics(*INTR), pose))
    idx = np.random.default_rng(seed).choice(len(r), n, replace=False)
    o, d = np.array(r.origins)[idx], np.array(r.directions)[idx]
    d[:8] = -d[:8]
    return o.astype(np.float32), d.astype(np.float32)


def _configs(S=48, **cfg):
    return (renderer_jax.SHVoxGridRenderConfig(num_samples_per_ray=S,
                                               camera_bounds=JaxBounds(*BOUNDS), **cfg),
            renderer.SHVoxGridRenderConfig(num_samples_per_ray=S,
                                           camera_bounds=CameraBounds(*BOUNDS), **cfg))


def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# ------------------------------------------------------------------- packed tables


@pytest.mark.parametrize("shape", [(4, 5, 6, 3), (8, 8, 8, 28), (3, 7, 2, 1)])
def test_pack_grid_cells_equals_jax(shape):
    """pack_grid_cells: the same [(W+1)(D+1)(H+1), 8C] table as the JAX
    package's, element for element (a copy: no arithmetic)."""
    volume = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = pg.pack_grid_cells(t(volume))
    want = n_(pg_jax.pack_grid_cells(jnp.asarray(volume)))
    assert got.shape == want.shape == ((shape[0] + 1) * (shape[1] + 1) * (shape[2] + 1),
                                       8 * shape[3])
    np.testing.assert_array_equal(got.numpy(), want)


def _edge_coords(dims, n=600, seed=2):
    """Normalized coords over [-1.6, 1.6]^3 (beyond the zero border) plus
    coords exactly on cell edges (integer voxel coordinates), where the
    floor decides the cell."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    sizes = np.asarray(dims, np.float32)
    k = rng.integers(-2, sizes.astype(int) + 2, (n // 2, 3)).astype(np.float32)
    coords[: n // 2] = (2.0 * k + 1.0) / sizes - 1.0
    return coords


@pytest.mark.parametrize("dims", [(4, 5, 6), (8, 8, 8)])
def test_cell_and_weights_match_jax(dims):
    """_cell_and_weights on random coords and on cell edges: the cell rows
    and the validity mask equal to the JAX package's, the 8 weights within
    1e-7 (both multiply the same f32 terms)."""
    coords = _edge_coords(dims)
    cells, weights, valid = pg._cell_and_weights(t(coords), dims)
    jcells, jweights, jvalid = pg_jax._cell_and_weights(jnp.asarray(coords), dims)
    np.testing.assert_array_equal(cells.numpy(), n_(jcells))
    np.testing.assert_array_equal(valid.numpy(), n_(jvalid))
    assert valid.any() and not valid.all()
    np.testing.assert_allclose(weights.numpy(), n_(jweights), rtol=0, atol=1e-7)


@pytest.mark.parametrize("shape", [(4, 5, 6, 3), (8, 8, 8, 28)])
def test_packed_trilinear_sample_matches_jax_and_grid_sample(shape):
    """packed_trilinear_sample against the JAX package's (an einsum at
    Precision.HIGHEST) within 1e-6, and against the port's eight-tap
    trilinear_grid_sample within 1e-5 (the JAX package's own bound)."""
    rng = np.random.default_rng(0)
    volume = rng.standard_normal(shape).astype(np.float32)
    coords = _edge_coords(shape[:3], n=512)
    got = pg.packed_trilinear_sample(pg.pack_grid_cells(t(volume)), t(coords), shape[:3])
    want = pg_jax.packed_trilinear_sample(pg_jax.pack_grid_cells(jnp.asarray(volume)),
                                          jnp.asarray(coords), shape[:3])
    np.testing.assert_allclose(got.numpy(), n_(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), trilinear_grid_sample(t(volume), t(coords)).numpy(),
                               rtol=0, atol=1e-5)


def test_top_k_order_matches_jax_on_ties():
    """top_k_stable picks the samples jax.lax.top_k picks, in its order,
    where weights tie: all-zero rows (rays that miss the box), repeated
    values and a row with a single weight."""
    rng = np.random.default_rng(5)
    w = np.round(rng.uniform(0, 1, (64, 48)), 1).astype(np.float32)  # many ties
    w[:8] = 0.0
    w[8, :] = 0.0
    w[8, 30] = 0.5
    for k in (1, 16, 48):
        vals, idx = fast.top_k_stable(t(w), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(w), k)
        np.testing.assert_array_equal(idx.numpy(), n_(jidx))
        np.testing.assert_array_equal(vals.numpy(), n_(jvals))


# ------------------------------------------------------------------ fast renderer


def _fast_draws(key, n, S, cfg):
    """The JAX procedure's draws from ``key`` (jitter, then noise)."""
    sample_key, noise_key = jax.random.split(key)
    draws = {}
    if cfg.get("perturb_sampled_points", True):
        draws["t_rand"] = t(n_(jax.random.uniform(sample_key, (n, S))))
    if cfg.get("stochastic_density_noise_std", 0.0) > 0.0:
        draws["noise"] = t(n_(jax.random.normal(noise_key, (n, S))))
    return draws


def _compare_render(got, want, extras=(), colour_atol=1e-5):
    np.testing.assert_allclose(got.colour.detach().numpy(), n_(want.colour), rtol=0,
                               atol=colour_atol)
    np.testing.assert_allclose(got.depth.detach().numpy(), n_(want.depth), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.extra[ACC].detach().numpy(), n_(want.extra[ACC]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.extra["disparity"].detach().numpy(),
                               n_(want.extra["disparity"]), rtol=1e-4)
    for k in extras:
        np.testing.assert_allclose(got.extra[k].detach().numpy(), n_(want.extra[k]), rtol=0,
                                   atol=colour_atol)


def _render_and_grads(jfn, tfn, jgrid, tgrid, o, d, extras=()):
    """Both renders and the gradients of a seeded linear loss on colour,
    depth, acc (and ``extras``) with respect to the grids."""
    rng = np.random.default_rng(4)
    n = len(o)
    gc, gd, ga, ge = (rng.normal(size=(n, k)).astype(np.float32) for k in (3, 1, 1, 3))
    jr = if_jax.Rays(jnp.asarray(o), jnp.asarray(d))

    def loss_j(grid):
        out = jfn(grid, jr)
        loss = (jnp.sum(out.colour * gc) + jnp.sum(out.depth * gd)
                + jnp.sum(out.extra[ACC] * ga))
        for k in extras:
            loss = loss + jnp.sum(out.extra[k] * ge)
        return loss, out

    (_, want), g_j = jax.value_and_grad(loss_j, has_aux=True)(jgrid)
    with tgrid.trainable():
        got = tfn(tgrid, Rays(t(o), t(d)))
        loss = (torch.sum(got.colour * t(gc)) + torch.sum(got.depth * t(gd))
                + torch.sum(got.extra[ACC] * t(ga)))
        for k in extras:
            loss = loss + torch.sum(got.extra[k] * t(ge))
        loss.backward()
    grads = {fld: (n_(getattr(g_j, fld)), getattr(tgrid, fld).grad.numpy())
             for fld in ("densities", "features")}
    return got, want, grads


FAST_CASES = {
    "full_k": dict(fast_topk=48, white_bkgd=True),
    "full_k_diffuse_black": dict(fast_topk=48, render_diffuse=True, white_bkgd=False),
    "small_k": dict(fast_topk=8, white_bkgd=True),
    "fused_diffuse": dict(fast_topk=16, white_bkgd=True, also_render_diffuse=True),
    "optimized_perturb": dict(fast_topk=16, optimized_sampling=True,
                              perturb_sampled_points=True, white_bkgd=True),
    "noise": dict(fast_topk=16, perturb_sampled_points=True, stochastic_density_noise_std=1.0,
                  white_bkgd=True),
    "bf16_tables": dict(fast_topk=16, fast_bf16_features=True, white_bkgd=True),
    "unpacked": dict(fast_topk=16, fast_pack_features=False, white_bkgd=True,
                     also_render_diffuse=True),
}


@pytest.mark.parametrize("case", list(FAST_CASES))
def test_fast_render_and_gradient_match_jax(case):
    """render_sh_voxel_grid_fast's colour, acc, depth and disparity (and the
    fused diffuse colour) against the JAX package's in the configurations
    of tests/test_fast_renderer.py (full and small K, the diffuse render,
    black and white backgrounds, the fused diffuse colour, AABB-bound
    sampling with jitter, density noise, bf16 and unpacked feature tables),
    the draws taken from the JAX key, on a relu scene with empty space and
    8 rays that miss the box: colour within 1e-5 (bf16 tables 2e-5), acc
    and depth 1e-5 (rtol and atol), disparity 1e-4 relative. The gradient of
    a seeded linear loss on the outputs with respect to the grid's
    densities and features: cosine > 0.99999."""
    cfg = {"perturb_sampled_points": False, **FAST_CASES[case]}
    jgrid, tgrid = _grids()
    o, d = _flat_rays()
    jc, tc = _configs(48, **cfg)
    key = jax.random.PRNGKey(17)
    draws = _fast_draws(key, len(o), 48, cfg)
    extras = ("diffuse_colour",) if cfg.get("also_render_diffuse") else ()
    got, want, grads = _render_and_grads(
        lambda g, r: fast_jax.render_sh_voxel_grid_fast(g, r, jc, key),
        lambda g, r: fast.render_sh_voxel_grid_fast(g, r, tc, **draws),
        jgrid, tgrid, o, d, extras)
    _compare_render(got, want, extras, 2e-5 if case == "bf16_tables" else 1e-5)
    acc = got.extra[ACC].detach()
    assert float(acc.max()) > 0.5
    if "noise" not in case:  # noise lends the rays that miss density
        assert float(acc[:8].max()) == 0.0
    for fld, (a, b) in grads.items():
        cos = _cosine(a, b)
        print(f"{case}: {fld} gradient cosine {cos:.9f}, max-abs {np.abs(a - b).max():.3g} "
              f"of {np.abs(a).max():.3g}")
        assert cos > 0.99999, (fld, cos)


@pytest.mark.parametrize("sh_degree,post", [(0, "relu"), (1, "softplus"), (3, "identity"),
                                            (4, "relu"), (4, "softplus")])
def test_fast_render_activations_and_sh_degrees_match_jax(sh_degree, post):
    """SH degrees 0-4 and the relu, softplus and abs / identity density
    fields, through the fast renderer at K 16 of 32 samples: outputs within
    the bounds of test_fast_render_and_gradient_match_jax, gradient cosine
    > 0.99999."""
    jgrid, tgrid = _grids(sh_degree=sh_degree, post=post)
    o, d = _flat_rays(seed=3)
    jc, tc = _configs(32, fast_topk=16, perturb_sampled_points=False, white_bkgd=True)
    got, want, grads = _render_and_grads(
        lambda g, r: fast_jax.render_sh_voxel_grid_fast(g, r, jc, None),
        lambda g, r: fast.render_sh_voxel_grid_fast(g, r, tc), jgrid, tgrid, o, d)
    _compare_render(got, want)
    for fld, (a, b) in grads.items():
        assert _cosine(a, b) > 0.99999, (fld, _cosine(a, b))


def test_fast_at_full_k_equals_exact_renderer():
    """At K = S the two-phase render is the exact one (the port's exact
    renderer): colour within 2e-5, depth 1e-4, acc 1e-5 (the JAX package's
    own bounds, tests/test_fast_renderer.py)."""
    _, tgrid = _grids()
    o, d = _flat_rays()
    _, tc = _configs(48, fast_topk=48, perturb_sampled_points=False, white_bkgd=True)
    r = Rays(t(o), t(d))
    got = fast.render_sh_voxel_grid_fast(tgrid, r, tc)
    want = renderer.render_sh_voxel_grid(tgrid, r, tc)
    torch.testing.assert_close(got.colour, want.colour, rtol=0, atol=2e-5)
    torch.testing.assert_close(got.depth, want.depth, rtol=0, atol=1e-4)
    torch.testing.assert_close(got.extra[ACC], want.extra[ACC], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["render_sh_voxel_grid_gnomonic", "render_sh_voxel_grid_bricked",
                                  "render_sh_voxel_grid_planes"])
def test_flat_rays_through_pose_procedures_equal_fast(name, caplog):
    """Flat ray batches through the gnomonic, bricked and planes procedure
    objects are the fast renderer's render, equal; the switch is logged
    once per class. A model of either procedure renders flat rays through
    render_rays the same way."""
    _, tgrid = _grids()
    o, d = _flat_rays()
    _, tc = _configs(32, fast_topk=16, perturb_sampled_points=True, white_bkgd=True)
    procedure = renderer.RENDER_PROCEDURES[name]
    type(procedure)._warned_flat_rays = False
    r = Rays(t(o), t(d))
    with caplog.at_level("INFO"):
        got = procedure(tgrid, r, tc, torch.Generator().manual_seed(0))
        again = procedure(tgrid, r, tc, torch.Generator().manual_seed(0))
    assert sum("flat ray batch" in m for m in caplog.messages) == 1
    want = fast.render_sh_voxel_grid_fast(tgrid, r, tc, torch.Generator().manual_seed(0))
    for out in (got, again):
        torch.testing.assert_close(out.colour, want.colour, rtol=0, atol=0)
        torch.testing.assert_close(out.extra[ACC], want.extra[ACC], rtol=0, atol=0)
    model = vm.VolumetricModel(tgrid, name, tc, device="cpu")
    by_model = model.render_rays(r, perturb_sampled_points=False)
    plain = fast.render_sh_voxel_grid_fast(tgrid, r, tc.replace(perturb_sampled_points=False))
    torch.testing.assert_close(by_model.colour, plain.colour, rtol=0, atol=0)


# ------------------------------------------------------------------- hierarchical


@pytest.mark.parametrize("deterministic", [True, False])
def test_sample_pdf_matches_jax(deterministic):
    """sample_pdf on coarse weights with empty rays (all-zero weights),
    single-bin rays and random ones: deterministic (linspace, as the JAX
    package's rounds it) and with the uniforms the JAX key drew. The cdf's
    cumsum sums in another order than XLA's scan (a few ulps of 1), and a
    sample moves by (cdf error / its bin's pdf) x the bin's width: each
    sample within 5e-5 + 1e-6 x width / pdf of the JAX package's (bins with
    the 1e-5 floor of an empty ray's pdf are the ill-conditioned ones)."""
    rng = np.random.default_rng(6)
    R, B, n = 64, 24, 40
    bins = np.sort(rng.uniform(1.0, 6.0, (R, B + 1)), axis=-1).astype(np.float32)
    weights = rng.uniform(0, 1, (R, B)).astype(np.float32) ** 4
    weights[:6] = 0.0
    weights[6:10] = 0.0
    weights[6:10, 5] = 3.0
    key = jax.random.PRNGKey(9)
    want = hier_jax.sample_pdf(None if deterministic else key, jnp.asarray(bins),
                               jnp.asarray(weights), n, deterministic=deterministic)
    u = None if deterministic else t(n_(jax.random.uniform(key, (R, n), maxval=1.0 - 1e-6)))
    got = hier.sample_pdf(t(bins), t(weights), n, deterministic=deterministic, u=u)
    assert got.shape == (R, n)
    pdf = (weights + 1e-5) / (weights + 1e-5).sum(-1, keepdims=True)
    below = np.stack([np.clip(np.searchsorted(b, g, side="right") - 1, 0, B - 1)
                      for b, g in zip(bins, got.numpy())])
    width = np.take_along_axis(np.diff(bins, axis=-1), below, -1)
    bound = 5e-5 + 1e-6 * width / np.take_along_axis(pdf, below, -1)
    err = np.abs(got.numpy() - n_(want))
    print(f"sample_pdf max error {err.max():.3g}, within bound {(err <= bound).mean()}")
    assert (err <= bound).all()
    if deterministic:
        assert (np.diff(got.numpy(), axis=-1) >= 0).all()
    drawn = hier.sample_pdf(t(bins), t(weights), n, generator=torch.Generator().manual_seed(0))
    assert float(drawn.min()) >= 1.0 and float(drawn.max()) <= 6.0


def _hier_draws(key, n, S, cfg):
    """The JAX hierarchical procedure's draws from ``key``: the coarse
    jitter, the fine uniforms, the noise."""
    sc, sf = hier.hierarchical_budget(S)
    coarse_key, fine_key, noise_key = jax.random.split(key, 3)
    draws = {}
    if cfg.get("perturb_sampled_points", True):
        draws["t_rand"] = t(n_(jax.random.uniform(coarse_key, (n, sc))))
        draws["u"] = t(n_(jax.random.uniform(fine_key, (n, sf), maxval=1.0 - 1e-6)))
    if cfg.get("stochastic_density_noise_std", 0.0) > 0.0:
        draws["noise"] = t(n_(jax.random.normal(noise_key, (n, sc + sf))))
    return draws


@pytest.mark.parametrize("cfg", [
    dict(perturb_sampled_points=False),
    dict(perturb_sampled_points=True, optimized_sampling=True,
         stochastic_density_noise_std=1.0, also_render_diffuse=True),
], ids=["deterministic", "perturbed_noise"])
def test_hierarchical_render_and_gradient_match_jax(cfg):
    """render_sh_voxel_grid_hierarchical (a 48-sample budget: 24 coarse +
    24 fine, top 16) against the JAX package's, deterministic and with the
    jitter, fine uniforms and noise the JAX key drew (AABB-bound bounds):
    outputs within the fast renderer's bounds, gradient cosine > 0.99999."""
    cfg = dict(fast_topk=16, white_bkgd=True, **cfg)
    jgrid, tgrid = _grids()
    o, d = _flat_rays(seed=4)
    jc, tc = _configs(48, **cfg)
    key = jax.random.PRNGKey(23)
    draws = _hier_draws(key, len(o), 48, cfg)
    extras = ("diffuse_colour",) if cfg.get("also_render_diffuse") else ()
    got, want, grads = _render_and_grads(
        lambda g, r: hier_jax.render_sh_voxel_grid_hierarchical(g, r, jc, key),
        lambda g, r: hier.render_sh_voxel_grid_hierarchical(g, r, tc, **draws),
        jgrid, tgrid, o, d, extras)
    _compare_render(got, want, extras)
    for fld, (a, b) in grads.items():
        cos = _cosine(a, b)
        print(f"hierarchical {cfg}: {fld} gradient cosine {cos:.9f}")
        assert cos > 0.99999, (fld, cos)


# ----------------------------------------------------------- model and its cache


def _model(procedure=FAST, **cfg):
    jgrid, tgrid = _grids()
    kw = dict(num_samples_per_ray=48, white_bkgd=True, parallel_rays_chunk_size=128,
              fast_topk=16, **cfg)
    jmodel = vm_jax.VolumetricModel(jgrid, procedure, renderer_jax.SHVoxGridRenderConfig(
        camera_bounds=JaxBounds(*BOUNDS), **kw))
    tmodel = vm.VolumetricModel(tgrid, procedure, renderer.SHVoxGridRenderConfig(
        camera_bounds=CameraBounds(*BOUNDS), **kw), device="cpu")
    return jmodel, tmodel


@pytest.mark.parametrize("procedure", [FAST, HIER])
def test_model_render_matches_jax_and_save_load(procedure, tmp_path):
    """VolumetricModel through the fast and hierarchical procedures: the
    chunked render (chunks of 128 rays sharing one set of packed tables)
    equals render_rays over the pose's rays and is within 1e-5 of the JAX
    model's render; a checkpoint the port writes loads in the JAX package
    with the procedure's name, and the reverse, and the render CLI renders
    it (two frames into rendered_video.gif)."""
    jmodel, tmodel = _model(procedure)
    pose = pose_spherical(40.0, -30.0, 3.2)
    got = tmodel.render(pose, INTR)
    flat = rays.flatten_rays(rays.cast_rays(INTR, pose, device="cpu"))
    torch.testing.assert_close(tmodel.render_rays(flat, perturb_sampled_points=False
                                                  ).colour.reshape(20, 24, 3),
                               got.colour, rtol=0, atol=0)
    want = jmodel.render(pose, JaxIntrinsics(*INTR))
    np.testing.assert_allclose(got.colour.numpy(), n_(want.colour), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.depth.numpy(), n_(want.depth), rtol=1e-5, atol=1e-5)
    tmodel.save(tmp_path / "port_model")
    back, _ = vm_jax.create_volumetric_model_from_saved_model(tmp_path / "port_model")
    assert back.render_procedure_name == procedure
    jmodel.save(tmp_path / "jax_model", extra_info={"hemispherical_radius": 3.2,
                                                    "camera_intrinsics": [16, 16, 18.0]})
    loaded, _ = vm.create_volumetric_model_from_saved_model(tmp_path / "jax_model",
                                                            device="cpu")
    assert loaded.render_procedure_name == procedure
    torch.testing.assert_close(loaded.render(pose, INTR).colour, got.colour, rtol=0, atol=0)
    out = rcli.main(["-i", str(tmp_path / "jax_model"), "-o", str(tmp_path / "render"),
                     "--num_frames", "3", "--render_scale_factor", "1",
                     "--overridden_num_samples_per_ray", "32"], device="cpu")
    assert out.name == "rendered_video.gif" and out.stat().st_size > 0


def test_prepared_cache_reused_and_invalidated(monkeypatch):
    """The packed tables are built once for all chunks of a render and
    reused across renders; an in-place Adam step on the grid (its version
    counters move), drop_prepared_cache, a new grid and another table
    choice each rebuild them; a differentiable render_rays packs its own.
    After the step the render equals a fresh model's render of the updated
    grid (no stale tables)."""
    _, tmodel = _model()
    calls = []
    original = fast.prepare_for_config

    def counting(grid, config):
        calls.append(config.fast_bf16_features)
        return original(grid, config)

    monkeypatch.setattr(fast.render_sh_voxel_grid_fast, "prepare", counting)
    pose, intr = pose_spherical(40.0, -30.0, 3.2), INTR
    first = tmodel.render(pose, intr)  # 480 rays in 4 chunks
    tmodel.render(pose_spherical(80.0, -20.0, 3.2), intr)
    assert len(calls) == 1
    grid = tmodel.thre3d_repr
    opt, _ = trainer.make_gnomonic_optimizer(grid, 0.05)
    with grid.trainable():
        loss = tmodel.render_rays(rays.flatten_rays(rays.cast_rays(intr, pose, device="cpu")),
                                  perturb_sampled_points=False).colour.mean()
        assert len(calls) == 1  # the differentiable render packed its own tables
        loss.backward()
    opt.step()
    after = tmodel.render(pose, intr)
    assert len(calls) == 2
    fresh = vm.VolumetricModel(grid, FAST, tmodel.render_config, device="cpu").render(pose, intr)
    assert len(calls) == 3
    torch.testing.assert_close(after.colour, fresh.colour, rtol=0, atol=0)
    assert not torch.equal(after.colour, first.colour)
    tmodel.render(pose, intr)
    assert len(calls) == 3  # still cached
    tmodel.drop_prepared_cache()
    tmodel.render(pose, intr)
    assert len(calls) == 4
    tmodel.render(pose, intr, fast_bf16_features=True)
    assert calls[-1] is True and len(calls) == 5
    tmodel.thre3d_repr = voxels.voxel_grid_from_numpy(*_scene(seed=5), device="cpu")
    tmodel.render(pose, intr, fast_bf16_features=True)
    assert len(calls) == 6


def _soft_blob(size=16, seed=3):
    """Soft gaussian density blobs with random colours (SH degree 2), the
    kind of scene the reference's quality gates render, numpy from a seed."""
    rng = np.random.default_rng(seed)
    coords = (np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing="ij"), -1) + 0.5) / size
    d = np.zeros((size,) * 3, np.float32)
    for _ in range(4):
        c, r = rng.uniform(0.3, 0.7, 3), rng.uniform(0.08, 0.18)
        d += 30.0 * np.exp(-np.sum((coords - c) ** 2, -1) / (2 * r * r))
    f = (rng.normal(size=(size,) * 3 + (27,)) * 0.3).astype(np.float32)
    f[..., ::9] += rng.uniform(-1, 1, (size,) * 3 + (3,)).astype(np.float32)
    config = dict(voxel_size=(3.0 / size,) * 3, grid_location=(0.0, 0.0, 0.0),
                  density_preactivation="identity", density_postactivation="relu",
                  feature_preactivation="identity", feature_postactivation="identity",
                  expected_density_scale=1.0, radiance_transfer_function=None)
    return (d - 1.0)[..., None].astype(np.float32), f, config


def test_top_k_quality_against_exact_matches_jax():
    """The fast (top 64) and hierarchical (top 64 of a 512-sample budget)
    renders of a soft-blob scene, each as PSNR against the exact render at
    512 samples, in both packages: the same dB within 0.05 (the port's
    renders are the JAX package's to ~1e-6). The hierarchical render's top
    64 are cut from samples crowded where the weight is, so it keeps less
    of the colour than the uniform render's top 64: its dB is the lower in
    both packages."""
    d, f, config = _soft_blob()
    jgrid = JaxVoxelGrid(densities=jnp.asarray(d), features=jnp.asarray(f),
                         voxel_size=VoxelSize(*config["voxel_size"]),
                         density_preactivation="identity", density_postactivation="relu")
    tgrid = voxels.voxel_grid_from_numpy(d, f, config, device="cpu")
    intr, pose = CameraIntrinsics(24, 24, 26.4), pose_spherical(45.0, -40.0, 4.0)
    kw = dict(num_samples_per_ray=512, perturb_sampled_points=False, white_bkgd=True,
              fast_topk=64, parallel_rays_chunk_size=4096)

    def psnr(a, b):
        return float(-10.0 * np.log10(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))

    db = {}
    for name, model_cls, grid, cfg, bounds, intrinsics in (
            ("jax", vm_jax.VolumetricModel, jgrid, renderer_jax.SHVoxGridRenderConfig,
             JaxBounds(2.0, 6.0), JaxIntrinsics(*intr)),
            ("port", vm.VolumetricModel, tgrid, renderer.SHVoxGridRenderConfig,
             CameraBounds(2.0, 6.0), intr)):
        extra = dict(device="cpu") if name == "port" else {}
        config_ = cfg(camera_bounds=bounds, **kw)
        imgs = {proc: model_cls(grid, proc, config_, **extra).render(pose, intrinsics).colour
                for proc in ("render_sh_voxel_grid", FAST, HIER)}
        db[name] = {proc: psnr(imgs[proc], imgs["render_sh_voxel_grid"]) for proc in (FAST, HIER)}
    print(f"PSNR against the exact render at 512 samples: {db}")
    for proc in (FAST, HIER):
        assert abs(db["port"][proc] - db["jax"][proc]) < 0.05, (proc, db)
    assert db["port"][HIER] < db["port"][FAST] and db["jax"][HIER] < db["jax"][FAST]
