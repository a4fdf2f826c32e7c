"""The PyTorch port's CUDA kernels against their plain versions, and the port's
import hygiene. This file imports nothing of JAX, so it also runs where JAX is
not installed (the GPU machine):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tests marked ``gpu`` decide in the ``cuda`` fixture whether a card is present
and skip without one; on the CPU only the hygiene tests run. Inputs are made
with numpy from a seed; each test states its tolerance."""
import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from thr3ed_atom_tpu_torch.models.voxels import resolve_device, voxel_grid_from_numpy
from thr3ed_atom_tpu_torch.ops.relu_trap import relu_trap, relu_trap_plain
from thr3ed_atom_tpu_torch.modules.trainer import make_gnomonic_optimizer
from thr3ed_atom_tpu_torch.rendering import gnomonic as gn
from thr3ed_atom_tpu_torch.rendering import gnomonic_train as gt
from thr3ed_atom_tpu_torch.rendering import warp_matmul as wm
from thr3ed_atom_tpu_torch.utils.camera import pose_spherical

REPO = Path(__file__).resolve().parent.parent
H = W = 128
FOCAL = 140.0
SS = 1.25


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test where there is no card (the CPU suite
    runs in several worker processes at once, and PyTorch's threads in each
    of them starve the others: the CPU cases here ran ~10x slower so); on a
    card's machine the threads are left as they are."""
    if torch.cuda.is_available():
        yield
        return
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
    b[:k] = a[:k] + rng.uniform(-2e-6, 2e-6, k).astype(np.float32)
    a[k:2 * k] = np.abs(a[k:2 * k])
    b[k:2 * k] = -np.abs(b[k:2 * k])
    a[2 * k:3 * k] = -np.abs(a[2 * k:3 * k])
    b[2 * k:3 * k] = np.abs(b[2 * k:3 * k])
    a[3 * k:4 * k] = -np.abs(a[3 * k:4 * k])
    b[3 * k:4 * k] = -np.abs(b[3 * k:4 * k])
    b[4 * k:4 * k + 100] = a[4 * k:4 * k + 100]
    return a, b


def _resample_inputs(seed, NB=8, CH=8, K=256, N=128, order=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(NB, CH, K)).astype(np.float32)
    X[:, :, : K // 4] = 0.0
    lo, hi = wm._clip_range(order, K)
    pos = rng.uniform(lo - 3, hi + 3, (NB, 1, N)).astype(np.float32)
    pos[:, :, :8] = np.arange(8, dtype=np.float32) + 2.0
    return X, np.clip(pos, lo, hi)


def _grid(size, seed=3, device="cpu", density_scale=1.0, ncoeff=9, relu=True):
    """Carved scene, numpy from a seed: a relu field (density -1 outside a
    ball), or with ``relu=False`` the CLI's other field (abs, then identity;
    0 outside the ball); ``ncoeff`` SH coefficients a colour (SH degree 2 by
    default); ``density_scale`` makes the ball opaque."""
    rng = np.random.default_rng(seed)
    densities = rng.uniform(-2.0, 4.0, (size,) * 3 + (1,)).astype(np.float32)
    densities *= np.float32(density_scale)
    coords = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing="ij"), -1)
    dist = np.linalg.norm(coords - (size - 1) / 2, axis=-1, keepdims=True)
    densities = np.where(dist < size / 4, densities, -1.0 if relu else 0.0).astype(np.float32)
    features = (rng.normal(size=(size,) * 3 + (3 * ncoeff,)) * 0.4).astype(np.float32)
    config = dict(voxel_size=(2.0 / size,) * 3, grid_location=(0.0, 0.0, 0.0),
                  density_preactivation="identity" if relu else "abs",
                  density_postactivation="relu" if relu else "identity",
                  feature_preactivation="identity", feature_postactivation="identity",
                  expected_density_scale=1.0, radiance_transfer_function=None)
    return voxel_grid_from_numpy(densities, features, config, device=device)


# (ncoeff, relu) beyond the default SH degree 2 relu field: the gnomonic
# kernels' other instances (SH degrees 0, 1, 3; the abs / identity field)
SH_CASES = [(1, True), (1, False), (4, True), (4, False), (16, True), (16, False), (9, False)]


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py's imports, load without
    JAX or the JAX package."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "thr3ed_atom_tpu_torch").rglob("*.py")
    )
    code = (
        "import sys, importlib, runpy\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "smoke = runpy.run_path('chip_smoke.py', run_name='chip_smoke_imports')\n"
        "smoke['load_port']()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m.startswith('jaxlib.')\n"
        "       or m == 'thr3ed_atom_tpu' or m.startswith('thr3ed_atom_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(modules) >= 19
    for name in ("rendering.gnomonic_train", "modules.trainer", "utils.metrics",
                 "apps.train_sh_voxel_grid", "data.dataset", "data.png", "modules.tester",
                 "visualizations.static", "utils.misc", "utils.profiling",
                 "ops.plane_march", "rendering.planes", "ops.onehot_gather",
                 "visualizations.video", "apps.render_sh_voxel_grid", "utils.lpips",
                 "rendering.rays", "rendering.sample", "rendering.process",
                 "rendering.accumulate", "ops.grid_sample", "diffusion.unet",
                 "diffusion.gaussian_diffusion", "diffusion.model",
                 "apps.train_thre3infusion", "tools.make_synthetic_dataset",
                 "tools.run_quality_gates", "tools.run_gate_battery"):
        assert f"thr3ed_atom_tpu_torch.{name}" in modules


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "thr3ed_atom_tpu", "PIL", "imageio", "click",
             "yaml", "tensorboardX", "matplotlib")


def test_port_sources_import_no_forbidden_packages():
    """No import statement anywhere in the port (apps/ included) or in
    chip_smoke.py, at module level or inside a function, names JAX, flax,
    optax, the JAX package or a package the card's machine lacks (PIL,
    imageio, click, yaml, tensorboardX, matplotlib), except as an optional
    import: in the body of a ``try`` whose handler catches ImportError (the
    camera-rays plot and the feedback panel's time stamp, skipped with a log
    line where matplotlib or PIL is missing). JAX, flax, optax and the JAX
    package are not imported even so."""
    import ast

    files = sorted((REPO / "thr3ed_atom_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert REPO / "thr3ed_atom_tpu_torch" / "apps" / "train_sh_voxel_grid.py" in files
    for tool in ("make_synthetic_dataset", "run_quality_gates", "run_gate_battery"):
        assert REPO / "thr3ed_atom_tpu_torch" / "tools" / f"{tool}.py" in files
    never = {"jax", "jaxlib", "flax", "optax", "thr3ed_atom_tpu"}
    bad, optional = [], []
    for path in files:
        tree = ast.parse(path.read_text())
        guarded = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Try) and any(
                    isinstance(h.type, ast.Name)
                    and h.type.id in ("ImportError", "ModuleNotFoundError")
                    for h in node.handlers):
                guarded |= {id(n) for stmt in node.body for n in ast.walk(stmt)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                if root in FORBIDDEN and (id(node) not in guarded or root in never):
                    bad.append(f"{path.name}: {n}")
                elif root in FORBIDDEN:
                    optional.append(f"{path.name}: {n}")
    assert not bad, bad
    assert sorted(optional) == ["static.py: PIL", "static.py: matplotlib"], optional


def test_entry_points_default_to_cuda():
    """``device=None`` resolves to the CUDA card; nothing falls back to the
    CPU. The tools' functions too (their ``main`` refuses without a card:
    tests/test_torch_tools.py)."""
    import inspect

    from thr3ed_atom_tpu_torch.models.voxels import voxel_grid_from_numpy
    from thr3ed_atom_tpu_torch.modules.volumetric_model import (
        VolumetricModel,
        create_volumetric_model_from_saved_model,
    )

    from thr3ed_atom_tpu_torch.apps import train_thre3infusion
    from thr3ed_atom_tpu_torch.diffusion.model import Thre3inFusionModel
    from thr3ed_atom_tpu_torch.tools import make_synthetic_dataset as msd
    from thr3ed_atom_tpu_torch.tools import run_gate_battery as rgb
    from thr3ed_atom_tpu_torch.tools import run_quality_gates as rqg

    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    for fn in (VolumetricModel.__init__, create_volumetric_model_from_saved_model,
               voxel_grid_from_numpy, Thre3inFusionModel.__init__,
               train_thre3infusion.main, msd.main, msd.make_blob_scene,
               rqg.run_gates, rqg.render, rqg.occupancy_neutrality_db, rqg.sharp_scene_db,
               rgb.run_battery):
        assert inspect.signature(fn).parameters["device"].default is None


@pytest.mark.parametrize("round_output", [True, False])
def test_repack_returns_channel_last_storage(round_output):
    """Every march axis and direction, bf16 or f32: the vertex slices are a
    permuted view of a contiguous [nvert, nu, nv, C] tensor (the layout the
    CUDA composites gather from), and rounding them to bf16 keeps it."""
    grid = _grid(8)
    for axis in range(3):
        for flip in (False, True):
            st = gn.statics_for_grid(grid, axis, flip, pos_per_cell=2)
            sl = gn.repack_position_slices(grid, st, round_output=round_output)
            assert sl.dtype == (torch.bfloat16 if round_output else torch.float32)
            assert sl.permute(0, 1, 3, 2).is_contiguous()
            assert sl.to(torch.bfloat16).permute(0, 1, 3, 2).is_contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("relu", [True, False])
def test_relu_trap_kernel_matches_plain(cuda, relu):
    """-fmad=false and the reference's operation order: equal to f32 ulp."""
    a, b = _trap_pairs()
    a_t, b_t = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    got = relu_trap(a_t, b_t, relu)
    torch.cuda.synchronize()
    want = relu_trap_plain(a_t, b_t, relu)
    for w, g in zip(want, got):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 3, 5])
@pytest.mark.parametrize("taps", [False, True])
def test_resample_rows_kernel_matches_plain(cuda, order, taps):
    """Same taps, same order of summation, no contraction: atol 1e-6."""
    X, pos = _resample_inputs(7, NB=64, K=512, N=512, order=order)
    X_t, p_t = torch.from_numpy(X).to(cuda), torch.from_numpy(pos).to(cuda)
    got = wm.resample_rows(X_t, p_t, order, taps)
    torch.cuda.synchronize()
    want = wm.resample_rows_plain(X_t, p_t, order, taps)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# (K, N) of the warp pass's edge cases: N not a multiple of 4 or 128, rows
# past the 48 KB shared-memory stage (K = 4096), a row whose outputs span
# several sweeps of a block
RESAMPLE_EDGES = [(512, 509), (256, 130), (4096, 300), (300, 1031)]


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 3, 5])
@pytest.mark.parametrize("taps", [False, True])
@pytest.mark.parametrize("K,N", RESAMPLE_EDGES)
def test_resample_rows_kernel_edge_cases(cuda, order, taps, K, N):
    """K2 at ragged widths, with positions at both edges of [0, K - 1] (and
    just inside them) and at exact integers: equal to the plain version,
    atol 1e-6, rtol 0. K = 512 and 256 stage the row slab in shared memory,
    K = 4096 (past the 48 KB stage) and K = 300 (not a multiple of 4) gather
    through L1."""
    X, pos = _resample_inputs(11, NB=16, K=K, N=N, order=order)
    lo, hi = wm._clip_range(order, K)
    pos[:, :, :6] = np.array([lo, hi, lo + 1e-6, hi - 1e-4, np.floor(hi), lo + 0.5],
                             dtype=np.float32)
    pos[:, :, -3:] = np.array([hi, lo, hi], dtype=np.float32)
    X_t, p_t = torch.from_numpy(X).to(cuda), torch.from_numpy(pos).to(cuda)
    want = wm.resample_rows_plain(X_t, p_t, order, taps)
    got = wm.resample_rows(X_t, p_t, order, taps)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@contextlib.contextmanager
def _nan_allocations():
    """Inside the block torch.empty hands out floating-point tensors filled
    with NaN, so that an output element a kernel leaves unwritten shows (the
    caching allocator would hand back memory that an earlier call zeroed)."""
    empty = torch.empty

    def nan_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    torch.empty = nan_empty
    try:
        yield
    finally:
        torch.empty = empty


def _composite_case(device, P, diffuse, exit_eps, density_scale, ncoeff=9, relu=True):
    """One pose's composite inputs; the opaque scene is seen from closer, so
    its disc covers whole exit tiles."""
    tgrid = _grid(32, device=device, density_scale=density_scale, ncoeff=ncoeff, relu=relu)
    pose = pose_spherical(140.0, -30.0, 3.5 if density_scale == 1.0 else 2.2)
    rot = np.asarray(pose.rotation, np.float32).reshape(3, 3)
    org = np.asarray(pose.translation, np.float32).reshape(3)
    axis, flip = gn.dominant_axis_for_pose(rot)
    st = gn.statics_for_grid(tgrid, axis, flip, with_diffuse=diffuse,
                             pos_per_cell=P, exit_eps=exit_eps, qb=128)
    Pn, Qn, PB, Pb = gn.gnomonic_frame(None, H, W, FOCAL, SS, st)
    QB, Qb = gn._qb_blocks(st, Qn)
    slices = gn.repack_position_slices(tgrid, st)
    geo = gn.gnomonic_geometry(torch.from_numpy(rot).to(device),
                               torch.from_numpy(org).to(device), st, H, W,
                               torch.tensor(FOCAL, device=device), SS)
    occ = gn.gnomonic_occupancy_lite(slices, geo.geom, st, Pn, Qn, PB, Pb, QB, Qb)
    return (slices, None, None, geo.geom, st, Pn, Qn, PB, Pb, occ), geo


@pytest.mark.gpu
@pytest.mark.parametrize("P,diffuse,exit_eps,density_scale,ncoeff,relu",
                         [(2, False, 1e-4, 1.0, 9, True), (1, True, 0.0, 1.0, 9, True),
                          (2, False, 1e-4, 30.0, 9, True)]
                         + [(2, False, 1e-4, 1.0, nc, relu) for nc, relu in SH_CASES])
def test_composite_kernel_matches_plain(cuda, P, diffuse, exit_eps, density_scale, ncoeff,
                                        relu):
    """CUDA composite against the plain version at the kernel's exit grain:
    the same roundings and no contraction; exp/sigmoid differ by ulps.
    Bound: colour/acc 1e-4, depth 1e-3. The opaque scene (density x 30) must
    end some tiles early, so the exit's grain is held too. Also at SH
    degrees 0, 1 and 3 and with the abs / identity field."""
    args, geo = _composite_case(cuda, P, diffuse, exit_eps, density_scale, ncoeff, relu)
    got = gn.composite_positions_fused(*args, xr=geo.xr, yr=geo.yr)
    torch.cuda.synchronize()
    want, work = gn.composite_positions_fused_plain(
        *args, xr=geo.xr, yr=geo.yr, exit_tile=gn.CUDA_EXIT_TILE, return_work=True)
    if density_scale > 1.0:
        st = args[4]
        _, work_all = gn.composite_positions_fused_plain(
            *args[:4], st._replace(exit_eps=0.0), *args[5:], xr=geo.xr, yr=geo.yr,
            return_work=True)
        assert int(work.sum()) < int(work_all.sum())
    gap = (got - want).abs().amax(dim=(1, 2)).cpu().numpy()
    assert gap[:5].max() < 1e-4 and gap[5] < 1e-3, gap


def test_composite_early_exit_grain_on_opaque_scene():
    """On the CPU: the opaque scene ends tiles early at the CUDA grain, and the
    exit changes each texel by no more than exit_eps in T and acc (colour by
    exit_eps per unit radiance, depth by exit_eps times the far distance)."""
    args, geo = _composite_case("cpu", 2, False, 1e-4, 30.0)
    st = args[4]
    state, work = gn.composite_positions_fused_plain(
        *args, xr=geo.xr, yr=geo.yr, exit_tile=gn.CUDA_EXIT_TILE, return_work=True)
    full, work_all = gn.composite_positions_fused_plain(
        *args[:4], st._replace(exit_eps=0.0), *args[5:], xr=geo.xr, yr=geo.yr,
        return_work=True)
    assert work.shape == work_all.shape == (gn._num_positions(st),) + state.shape[1:]
    assert bool((work <= work_all).all()) and int(work.sum()) < int(work_all.sum())
    gap = (state - full).abs().amax(dim=(1, 2)).numpy()
    assert gap[:5].max() <= 1e-4 and gap[5] <= 1e-4 * 10.0, gap


def _adjoint_positions(seed, NB, K, N, order):
    """Positions [NB, 1, N] for the adjoint: rows of seeded random positions
    with a clipped run piling onto one tap (scattered), rising and falling
    maps clipped at both ends (gathered, as the warp's rows), a row clipped
    whole onto each edge, a rising row with a long flat run, and monotone
    rows shuffled (scattered), all in one batch."""
    _, pos = _resample_inputs(seed, NB=NB, K=K, N=N, order=order)
    lo, hi = wm._clip_range(order, K)
    pos[: NB // 4, :, 8:40] = lo
    rng = np.random.default_rng(seed + 1)
    q = NB // 4
    a = rng.uniform(-0.2 * K, 0.3 * K, (NB - q, 1, 1))
    slope = rng.uniform(0.6, 1.0, (NB - q, 1, 1)) * K / N
    pos[q:] = np.clip(a + slope * np.arange(N), lo, hi)
    pos[q + 1::4] = pos[q + 1::4, :, ::-1]  # falling
    pos[q + 2] = lo
    pos[q + 3] = hi
    pos[q + 4, :, N // 8: N // 2] = pos[q + 4, :, N // 8: N // 8 + 1]
    for r in range(q + 5, NB, 8):
        pos[r, 0] = rng.permutation(pos[r, 0])
    return np.ascontiguousarray(pos, dtype=np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 3, 5])
@pytest.mark.parametrize("taps", [False, True])
@pytest.mark.parametrize("K,N", [(512, 512), (200, 512), (1024, 384)])
def test_resample_rows_adjoint_kernel_matches_plain(cuda, order, taps, K, N):
    """The adjoint resample (K4) against its plain version on the positions
    of ``_adjoint_positions`` (gathered and scattered rows in one batch),
    also where K != N. The plain version sums in float64 (with the same f32
    weights), rounded to f32: on an H100 its f32 run (scatter_add_, atomics
    in a varying order) strays from those sums by up to 5.3e-5 of values up
    to 80, the kernel's f32 sums (the gather in n order, the scatter's
    shared-memory atomics in a varying one) by up to 7.6e-6; both are
    printed. rtol 1e-5, atol 1e-5. The resample's backward launches the
    kernel once."""
    X, _ = _resample_inputs(7, NB=64, K=K, N=N, order=order)
    pos = _adjoint_positions(7, 64, K, N, order)
    rng = np.random.default_rng(8)
    dY = rng.normal(size=(64, 3, 8, N) if taps else (64, 8, N)).astype(np.float32)
    dY_t, p_t = torch.from_numpy(dY).to(cuda), torch.from_numpy(pos).to(cuda)
    got = wm.resample_rows_adjoint(dY_t, p_t, order, K, taps)
    torch.cuda.synchronize()
    want = wm.resample_rows_adjoint_plain(dY_t.double(), p_t, order, K, taps).float()
    plain32 = wm.resample_rows_adjoint_plain(dY_t, p_t, order, K, taps)
    print(f"K4 order {order} taps {taps} K {K} N {N}: max-abs to the float64 sums "
          f"{float((got - want).abs().max()):.3g} (the f32 plain version's "
          f"{float((plain32 - want).abs().max()):.3g}) of {float(want.abs().max()):.3g}")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    X_t = torch.from_numpy(X).to(cuda).requires_grad_(True)
    before = wm.resample_rows_adjoint.launches
    wm.resample_rows(X_t, p_t, order, taps).backward(dY_t)
    assert wm.resample_rows_adjoint.launches == before + 1
    torch.testing.assert_close(X_t.grad, want, rtol=1e-5, atol=1e-5)


def _train_case(device, P, diffuse, size=32, seed=3, ncoeff=9, relu=True):
    """One pose's training operands: slices, materialized geometry, flags."""
    tgrid = _grid(size, seed=seed, device=device, ncoeff=ncoeff, relu=relu)
    pose = pose_spherical(140.0, -30.0, 3.5)
    rot = np.asarray(pose.rotation, np.float32).reshape(3, 3)
    org = np.asarray(pose.translation, np.float32).reshape(3)
    axis, flip = gn.dominant_axis_for_pose(rot)
    st = gn.statics_for_grid(tgrid, axis, flip, with_diffuse=diffuse, pos_per_cell=P, qb=128)
    Pn, Qn, PB, Pb = gn.gnomonic_frame(None, H, W, FOCAL, SS, st)
    QB, Qb = gn._qb_blocks(st, Qn)
    slices = gn.repack_position_slices(tgrid, st)
    geo = gn.gnomonic_geometry(torch.from_numpy(rot).to(device),
                               torch.from_numpy(org).to(device), st, H, W,
                               torch.tensor(FOCAL, device=device), SS,
                               phase=(0.25, -0.125), skip_basis=False)
    occ = gn.gnomonic_occupancy_lite(slices, geo.geom, st, Pn, Qn, PB, Pb, QB, Qb)
    return (slices, geo.ybasis, geo.norm, geo.geom, st, Pn, Qn, PB, Pb, occ)


@pytest.mark.gpu
@pytest.mark.parametrize("P,diffuse,ncoeff,relu",
                         [(2, True, 9, True), (1, False, 9, True)]
                         + [(2, True, nc, relu) for nc, relu in SH_CASES])
def test_composite_operand_branch_kernel_matches_plain(cuda, P, diffuse, ncoeff, relu):
    """K1's training branch (basis and norm read from the operands) against
    the plain version: colour/acc 1e-4, depth 1e-3, as the serving branch;
    also at SH degrees 0, 1 and 3 and with the abs / identity field."""
    args = _train_case(cuda, P, diffuse, ncoeff=ncoeff, relu=relu)
    got = gn.composite_positions_fused(*args)
    torch.cuda.synchronize()
    want = gn.composite_positions_fused_plain(*args)
    gap = (got - want).abs().amax(dim=(1, 2)).cpu().numpy()
    assert gap[:5].max() < 1e-4 and gap[5] < 1e-3 and gap[6:].max(initial=0.0) < 1e-4, gap
    assert float(want[4].max()) > 0.5


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("P,diffuse,ncoeff,relu",
                         [(2, True, 9, True), (1, False, 9, True)]
                         + [(2, True, nc, relu) for nc, relu in SH_CASES])
def test_composite_backward_kernel_matches_plain(cuda, P, diffuse, ncoeff, relu):
    """The replay backward (K3) against its plain version on a seeded state
    cotangent. The replay and the per-texel cotangents are the same
    operations; the two tent sums run in different orders, and a last-bit
    difference can move a bf16 rounding of the q-summed cotangent by one
    bf16 unit. Bound: max-abs <= 1e-2 of the largest element, cosine >
    0.99999; pad channels are zero. Also at SH degrees 0, 1 and 3 and with
    the abs / identity field."""
    slices, yb, nm, geom, st, Pn, Qn, PB, Pb, occ = _train_case(cuda, P, diffuse,
                                                                ncoeff=ncoeff, relu=relu)
    state = gn.composite_positions_fused_plain(slices, yb, nm, geom, st, Pn, Qn, PB, Pb, occ)
    gen = torch.Generator(device=cuda).manual_seed(5)
    gstate = torch.randn(state.shape, generator=gen, device=cuda)
    S_total = (gstate[1:] * state[1:]).sum(0)
    gaux = torch.cat([gstate, S_total[None], state[0:1]])
    before = gt.composite_backward_fused.launches
    got = gt.composite_backward_fused(slices, yb, nm, geom, gaux, occ, st, Pn, Qn, PB, Pb)
    torch.cuda.synchronize()
    assert gt.composite_backward_fused.launches == before + 1
    want = gt.composite_backward_fused_plain(slices, yb, nm, geom, gaux, occ, st, Pn, Qn,
                                             PB, Pb)
    assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert scale > 0.0 and err <= 1e-2 * scale, (err, scale)
    assert _cosine(got.float(), want.float()) > 0.99999
    assert not got[:, :, 3 * st.ncoeff + 1:].any()


def _deep_grid(axis, device, n_axis=256, n_other=16, seed=4, ncoeff=16):
    """A grid of n_axis vertices along the march axis and n_other across it
    (the ball of ``_grid`` in the [-1, 1]^3 box, SH degree 3): a march of
    (n_axis - 1) P + 1 positions over a small vertex stack."""
    rng = np.random.default_rng(seed)
    dims = [n_other] * 3
    dims[axis] = n_axis
    densities = rng.uniform(-2.0, 4.0, tuple(dims) + (1,)).astype(np.float32)
    axes = [np.linspace(-1.0, 1.0, n, dtype=np.float32) for n in dims]
    coords = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    inside = np.linalg.norm(coords, axis=-1, keepdims=True) < 0.5
    densities = np.where(inside, densities, -1.0).astype(np.float32)
    features = (rng.normal(size=tuple(dims) + (3 * ncoeff,)) * 0.4).astype(np.float32)
    config = dict(voxel_size=tuple(2.0 / n for n in dims), grid_location=(0.0, 0.0, 0.0),
                  density_preactivation="identity", density_postactivation="relu",
                  feature_preactivation="identity", feature_postactivation="identity",
                  expected_density_scale=1.0, radiance_transfer_function=None)
    return voxel_grid_from_numpy(densities, features, config, device=device)


# (view, P) of the staged-footprint cases
FOOTPRINT_CASES = [("edge", 1), ("edge", 2), ("flipped", 1), ("flipped", 2), ("far", 1),
                   ("far", 2), ("deep", 8)]


def _footprint_case(device, view, P):
    """A pose's operands for the staged footprints of K1 and K3: "edge" (the
    grid's edge inside the frame: tent taps outside the grid), "flipped" (the
    frame mirrored in u and v, so U and V fall along p and q: ku, kv < 0),
    "far" (a 64^3 grid zoomed out until some tiles' footprints exceed the
    stage and take the direct gather, others not) and "deep" (256 vertices
    along the march axis at P = 8 and SH degree 3 on a 64 x 64 image: over
    2000 positions, whose per-position tables leave the stage less than its
    preferred size). Diffuse on, early exit at 1e-4, training operands."""
    focal = {"far": 60.0, "deep": 70.0}.get(view, FOCAL)
    height = width = 64 if view == "deep" else H
    pose = pose_spherical(140.0, -30.0, 3.5)
    rot = np.asarray(pose.rotation, np.float32).reshape(3, 3)
    org = np.asarray(pose.translation, np.float32).reshape(3)
    axis, flip = gn.dominant_axis_for_pose(rot)
    if view == "deep":
        tgrid = _deep_grid(axis, device)
    else:
        tgrid = _grid(64 if view == "far" else 32, device=device)
    st = gn.statics_for_grid(tgrid, axis, flip, with_diffuse=True, pos_per_cell=P,
                             exit_eps=1e-4, qb=128)
    Pn, Qn, PB, Pb = gn.gnomonic_frame(None, height, width, focal, SS, st)
    QB, Qb = gn._qb_blocks(st, Qn)
    slices = gn.repack_position_slices(tgrid, st)
    geo = gn.gnomonic_geometry(torch.from_numpy(rot).to(device),
                               torch.from_numpy(org).to(device), st, height, width,
                               torch.tensor(focal, device=device), SS,
                               phase=(0.25, -0.125), skip_basis=False)
    geom = geo.geom
    if view == "flipped":
        geom = geom.clone()
        geom[:, 2] = geom[:, 2] + geom[:, 3] * float(Pn - 1)
        geom[:, 4] = geom[:, 4] + geom[:, 5] * float(Qn - 1)
        geom[:, 3] = -geom[:, 3]
        geom[:, 5] = -geom[:, 5]
    occ = gn.gnomonic_occupancy_lite(slices, geom, st, Pn, Qn, PB, Pb, QB, Qb)
    return (slices, geo.ybasis, geo.norm, geom, st, Pn, Qn, PB, Pb, occ), geo


def test_fold_records_tile_their_slots():
    """On the CPU: K3's v-fold output is sized by the flags: one dense dt1
    slot [Pb, 3 ncoeff + 1, nv] per (u-block, position) with a needed
    q-block, one edge slot [(Pb / 8) (Qb / 32), 3 ncoeff + 1, 8, 4] per
    needed (u-block, q-block, position); the slots follow each other in flag
    order, without gaps or overlaps."""
    slices, _, _, _, st, Pn, Qn, PB, Pb, occ = _train_case("cpu", 2, True)
    QB, Qb = gn._qb_blocks(st, Qn)
    pos_needed = occ[1].clone()
    pos_needed[0, 0, ::3] = 0  # some dead blocks
    d_off, s_off, n_dt1, n_edge = gt.fold_records(pos_needed, st, Pb, Qb)
    used, nv = 3 * st.ncoeff + 1, slices.shape[3]
    any_u = (pos_needed > 0).any(dim=1)
    for off, flags, size, total in ((d_off, any_u, Pb * used * nv, n_dt1),
                                    (s_off, pos_needed > 0,
                                     (Pb // 8) * (Qb // 32) * used * 8 * 4, n_edge)):
        assert off.shape == flags.shape and off.dtype == torch.int64
        live = off[flags].tolist()
        assert bool((off[~flags] == -1).all()) and live == sorted(live)
        assert live == [i * size for i in range(len(live))] and total == len(live) * size


@pytest.mark.parametrize("view,P", FOOTPRINT_CASES)
def test_footprint_cases_hold_their_geometry(view, P):
    """On the CPU: each view of the staged-footprint GPU cases has what it is
    there for: needed positions whose u-tents reach past the grid's edge
    (all but deep), ku, kv < 0 (flipped), tiles spanning more v lines than
    either stage holds (far: 31 |kv| + 2 > 64), over 2000 positions (deep;
    K1's tables and stage of the parent design fit about 1300 at SH degree
    2, K3's march about 1900 at degree 3). Every tile of the other views
    fits the smallest stage (at most 48 v lines and 1536 records of two
    slices x u lines x v lines x channel groups), so none takes the direct
    gather there."""
    (slices, _, _, geom, st, Pn, _, _, _, occ), _ = _footprint_case("cpu", view, P)
    nu = slices.shape[1]
    needed = occ[2].sum(0) > 0
    U = geom[needed, 2:3] + geom[needed, 3:4] * torch.arange(Pn, dtype=torch.float32)
    assert bool(needed.any())
    if view != "deep":
        assert bool((((U > -1.0) & (U < 0.0)) | ((U > nu - 1.0) & (U < nu))).any())
    if view == "flipped":
        assert bool((geom[:, 3] < 0).all() and (geom[:, 5] < 0).all())
    ku, kv = float(geom[needed, 3].abs().max()), float(geom[needed, 5].abs().max())
    nu_c, nv_c = int(7 * ku) + 3, int(31 * kv) + 3  # tap lines of a tile, at most
    if view == "far":
        assert 31 * kv + 2 > 64.0
    else:
        groups = -(-(3 * st.ncoeff + 1) // 8)
        assert nv_c <= 48 and 2 * nu_c * nv_c * groups <= 1536, (nu_c, nv_c)
    if view == "deep":
        assert geom.shape[0] > 2000 and st.ncoeff == 16


@pytest.mark.gpu
@pytest.mark.parametrize("view,P", FOOTPRINT_CASES)
def test_fused_kernels_on_staged_footprints(cuda, view, P):
    """K1 (serving and training branches) and K3 on the views of
    ``_footprint_case``, at the existing tolerances: K1 colour/acc/diffuse
    1e-4, depth 1e-3 at the CUDA exit grain; K3 max-abs <= 1e-2 of the
    largest element, cosine > 0.99999, pad channels zero. Each launch counts
    its direct-gather tiles on its own: in the far view every launch must
    send tiles down the direct gather; in the others (whose footprints fit
    the stage, test_footprint_cases_hold_their_geometry) none may, so every
    tile ran the staged path (the cp.async ring, the shared lerp and
    u-resample), on a stage cut to fit the deep view's tables there."""
    args, geo = _footprint_case(cuda, view, P)
    slices, yb, nm, geom, st, Pn, Qn, PB, Pb, occ = args
    direct = {k: torch.zeros(1, dtype=torch.int32, device=cuda)
              for k in ("K1 serving", "K1 training", "K3")}
    serving = (slices, None, None) + args[3:]
    got = gn.composite_positions_fused(*serving, xr=geo.xr, yr=geo.yr,
                                       direct_tiles=direct["K1 serving"])
    torch.cuda.synchronize()
    want = gn.composite_positions_fused_plain(*serving, xr=geo.xr, yr=geo.yr,
                                              exit_tile=gn.CUDA_EXIT_TILE)
    gap = (got - want).abs().amax(dim=(1, 2)).cpu().numpy()
    assert gap[:5].max() < 1e-4 and gap[5] < 1e-3 and gap[6:].max() < 1e-4, gap
    train = args[:4] + (st._replace(exit_eps=0.0),) + args[5:]
    got = gn.composite_positions_fused(*train, direct_tiles=direct["K1 training"])
    torch.cuda.synchronize()
    state = gn.composite_positions_fused_plain(*train)
    gap = (got - state).abs().amax(dim=(1, 2)).cpu().numpy()
    assert gap[:5].max() < 1e-4 and gap[5] < 1e-3 and gap[6:].max() < 1e-4, gap

    gen = torch.Generator(device=cuda).manual_seed(5)
    gstate = torch.randn(state.shape, generator=gen, device=cuda)
    S_total = (gstate[1:] * state[1:]).sum(0)
    gaux = torch.cat([gstate, S_total[None], state[0:1]])
    bwd = (slices, yb, nm, geom, gaux, occ, train[4], Pn, Qn, PB, Pb)
    got = gt.composite_backward_fused(*bwd, direct_tiles=direct["K3"])
    torch.cuda.synchronize()
    want = gt.composite_backward_fused_plain(*bwd)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert scale > 0.0 and err <= 1e-2 * scale, (err, scale)
    assert _cosine(got.float(), want.float()) > 0.99999
    assert not got[:, :, 3 * st.ncoeff + 1:].any()
    counts = {k: int(v.item()) for k, v in direct.items()}
    if view == "far":
        assert min(counts.values()) > 0, counts
    else:
        assert max(counts.values()) == 0, counts


@pytest.mark.gpu
def test_fused_kernels_at_full_width(cuda):
    """K1 (training branch) and K3 at the training CLI's final stage: a 256^3
    carved relu scene (SH degree 2) at the automatic P (1 at 256^3), one
    400 x 400 view at focal 440 (the CLI's halved NeRF-synthetic frame),
    diffuse on, exit 0, on the stage Stage::fit picks for that march (a
    real stage: records and lines > 0), at the staged footprints'
    tolerances: K1 1e-4 a row, 1e-3 depth; K3 max-abs <= 1e-2 of the
    largest element, cosine > 0.99999, pad channels zero."""
    size, side, focal = 256, 400, 440.0
    rng = np.random.default_rng(3)
    densities = rng.uniform(-2.0, 4.0, (size,) * 3 + (1,)).astype(np.float32)
    coords = (np.arange(size, dtype=np.float32) - (size - 1) / 2) ** 2
    dist2 = coords[:, None, None] + coords[None, :, None] + coords[None, None, :]
    densities[dist2 >= (size / 4) ** 2] = -1.0
    features = rng.standard_normal((size,) * 3 + (27,), dtype=np.float32) * np.float32(0.4)
    config = dict(voxel_size=(3.0 / size,) * 3, grid_location=(0.0, 0.0, 0.0),
                  density_preactivation="identity", density_postactivation="relu",
                  feature_preactivation="identity", feature_postactivation="identity",
                  expected_density_scale=1.0, radiance_transfer_function=None)
    grid = voxel_grid_from_numpy(densities, features, config, device=cuda)
    del densities, features
    pose = pose_spherical(140.0, -30.0, 4.0)
    rot = np.asarray(pose.rotation, np.float32).reshape(3, 3)
    org = np.asarray(pose.translation, np.float32).reshape(3)
    axis, flip = gn.dominant_axis_for_pose(rot)
    tstat = gt.make_gnomonic_train_statics(grid, axis, flip, image_height=side,
                                           image_width=side, white_bkgd=True,
                                           apply_diffuse_render_regularization=True)
    st = tstat.statics
    assert st.pos_per_cell == 1 and tstat.fused
    Pn, Qn, PB, Pb = tstat.frame
    slices = gn.repack_position_slices(grid, st, vertex_only=True)
    geo = gn.gnomonic_geometry(torch.from_numpy(rot).to(cuda), torch.from_numpy(org).to(cuda),
                               st, side, side, torch.tensor(focal, device=cuda),
                               tstat.supersample, phase=(0.25, -0.125), lite=True,
                               skip_basis=False)
    occ = gn.gnomonic_occupancy_lite(slices, geo.geom, st, Pn, Qn, PB, Pb,
                                     *gn._qb_blocks(st, Qn))
    assert bool(occ[1].any())
    for recs, lines in (gn.composite_fused_stage(st, True), gt.composite_backward_fused_stage(st)):
        assert recs > 0 and lines > 0, (recs, lines)
    args = (slices, geo.ybasis, geo.norm, geo.geom, st, Pn, Qn, PB, Pb, occ)
    got = gn.composite_positions_fused(*args)
    torch.cuda.synchronize()
    state = gn.composite_positions_fused_plain(*args)
    gap = (got - state).abs().amax(dim=(1, 2)).cpu().numpy()
    assert gap[:5].max() < 1e-4 and gap[5] < 1e-3 and gap[6:].max() < 1e-4, gap
    del got
    gen = torch.Generator(device=cuda).manual_seed(5)
    gstate = torch.randn(state.shape, generator=gen, device=cuda)
    gaux = torch.cat([gstate, (gstate[1:] * state[1:]).sum(0)[None], state[0:1]])
    bwd = (slices, geo.ybasis, geo.norm, geo.geom, gaux, occ, st, Pn, Qn, PB, Pb)
    got = gt.composite_backward_fused(*bwd)
    torch.cuda.synchronize()
    want = gt.composite_backward_fused_plain(*bwd)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert scale > 0.0 and err <= 1e-2 * scale, (err, scale)
    assert _cosine(got.float(), want.float()) > 0.99999
    assert not got[:, :, 3 * st.ncoeff + 1:].any()


@pytest.mark.gpu
def test_train_step_kernels_match_plain(cuda):
    """One gnomonic_train_step_multi (k = 2) through the kernels against the
    same step through the plain versions, from the same grid: the grid
    gradients within cosine > 0.99999, the losses within rtol 1e-5; the step
    launched K1, K3, K2 and K4."""
    pose = pose_spherical(140.0, -30.0, 3.5)
    rot = np.asarray(pose.rotation, np.float32).reshape(3, 3)
    org = np.asarray(pose.translation, np.float32).reshape(3)
    axis, flip = gn.dominant_axis_for_pose(rot)
    images = torch.rand((2, H, W, 3), generator=torch.Generator().manual_seed(1)).to(cuda)
    grads, losses = [], []
    counters = (gn.composite_positions_fused, gt.composite_backward_fused,
                wm.resample_rows, wm.resample_rows_adjoint)
    for plain in (False, True):
        tgrid = _grid(32, device=cuda)
        ts = gt.make_gnomonic_train_statics(tgrid, axis, flip, image_height=H,
                                            image_width=W, white_bkgd=True, pos_per_cell=2)
        opt, sched = make_gnomonic_optimizer(tgrid)
        before = [c.launches for c in counters]
        m = gt.gnomonic_train_step_multi(ts, opt, tgrid, images, np.stack([rot] * 2),
                                         np.stack([org] * 2), FOCAL,
                                         phases=[(0.1, 0.2), (-0.3, 0.4)],
                                         scheduler=sched, plain=plain)
        torch.cuda.synchronize()
        counts = [c.launches - b for c, b in zip(counters, before)]
        assert counts == ([2, 2, 4, 4] if not plain else [0, 0, 0, 0]), counts
        grads.append((tgrid.densities.grad.clone(), tgrid.features.grad.clone()))
        losses.append(float(m["total_loss"]))
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all()) and _cosine(a, b) > 0.99999


def _stripe_case(device, P, diffuse, exit_eps=0.0, density_scale=1.0, qb=0, ncoeff=9,
                 relu=True):
    """One pose's v2 stripe operands (qb = 0; qb = 128 splits Qn = 256 into
    two q-blocks): t1, the tents and liveness, the materialized basis and
    norm, and the [PB, NP] (or [PB, QB, NP]) flags."""
    gn._strict_f32()
    tgrid = _grid(32, device=device, density_scale=density_scale, ncoeff=ncoeff, relu=relu)
    pose = pose_spherical(140.0, -30.0, 3.5 if density_scale == 1.0 else 2.2)
    rot = np.asarray(pose.rotation, np.float32).reshape(3, 3)
    org = np.asarray(pose.translation, np.float32).reshape(3)
    axis, flip = gn.dominant_axis_for_pose(rot)
    st = gn.statics_for_grid(tgrid, axis, flip, with_diffuse=diffuse, pos_per_cell=P,
                             exit_eps=exit_eps, qb=qb)
    Pn, Qn, PB, Pb = gn.gnomonic_frame(None, H, W, FOCAL, SS, st)
    slices = gn.repack_position_slices(tgrid, st, vertex_only=False)
    geo = gn.gnomonic_geometry(torch.from_numpy(rot).to(device),
                               torch.from_numpy(org).to(device), st, H, W,
                               torch.tensor(FOCAL, device=device), SS,
                               phase=(0.25, -0.125), lite=False, skip_basis=False)
    t1 = gn.resample_u(slices, geo.Ru)
    occ = gn.gnomonic_occupancy(slices, geo.Ru, st, PB, Pb, RvT=geo.RvT,
                                QB=gn._qb_blocks(st, Qn)[0])
    return (t1, geo.RvT, geo.ybasis, geo.live_u, geo.live_v, geo.norm, geo.geom, st,
            Pn, Qn, PB, Pb, occ)


@pytest.mark.gpu
@pytest.mark.parametrize("P,diffuse,exit_eps,density_scale,ncoeff,relu",
                         [(2, False, 1e-4, 1.0, 9, True), (1, True, 0.0, 1.0, 9, True),
                          (2, False, 1e-4, 30.0, 9, True)]
                         + [(2, False, 1e-4, 1.0, nc, relu) for nc, relu in SH_CASES])
def test_stripe_composite_kernel_matches_plain(cuda, P, diffuse, exit_eps, density_scale,
                                               ncoeff, relu):
    """The stripe composite (K5) against its plain version at the kernel's
    exit grain: the two-tap sum equals the dense product exactly, the march
    rounds as the plain version; exp/sigmoid differ by ulps. Bound:
    colour/acc 1e-4, depth 1e-3 (as K1). The opaque scene must end some
    tiles early. Also at SH degrees 0, 1 and 3 and with the abs / identity
    field."""
    args = _stripe_case(cuda, P, diffuse, exit_eps, density_scale, ncoeff=ncoeff, relu=relu)
    before = gn.composite_positions.launches
    got = gn.composite_positions(*args)
    torch.cuda.synchronize()
    assert gn.composite_positions.launches == before + 1
    want, work = gn.composite_positions_plain(*args, exit_tile=gn.CUDA_EXIT_TILE,
                                              return_work=True)
    if density_scale > 1.0:
        st = args[7]
        _, work_all = gn.composite_positions_plain(
            *args[:7], st._replace(exit_eps=0.0), *args[8:], return_work=True)
        assert int(work.sum()) < int(work_all.sum())
    gap = (got - want).abs().amax(dim=(1, 2)).cpu().numpy()
    assert gap[:5].max() < 1e-4 and gap[5] < 1e-3 and gap[6:].max(initial=0.0) < 1e-4, gap
    assert float(want[4].max()) > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("P,diffuse,ncoeff,relu",
                         [(2, True, 9, True), (1, False, 9, True)]
                         + [(2, True, nc, relu) for nc, relu in SH_CASES])
def test_stripe_backward_kernel_matches_plain(cuda, P, diffuse, ncoeff, relu):
    """The stripe replay backward (K7) against its plain version on a seeded
    state cotangent: the same replay and bf16 cotangents; the v-fold sums a
    row's taps in ascending q, the plain version in a matmul's order, and a
    last-bit difference can move a bf16 rounding of dt1 by one unit. Bound:
    max-abs <= 1e-2 of the largest element, cosine > 0.99999; pad channels
    and dead blocks are zero (dt1 allocated NaN-filled). Autograd of
    composite_positions_diff launches K5 once and K7 once. Also at SH degrees
    0, 1 and 3 and with the abs / identity field."""
    args = _stripe_case(cuda, P, diffuse, ncoeff=ncoeff, relu=relu)
    t1, st, (Pn, Qn, PB, Pb), occ = args[0], args[7], args[8:12], args[12]
    state = gn.composite_positions_plain(*args)
    gen = torch.Generator(device=cuda).manual_seed(5)
    gstate = torch.randn(state.shape, generator=gen, device=cuda)
    S_total = (gstate[1:] * state[1:]).sum(0)
    gaux = torch.cat([gstate, S_total[None], state[0:1]])
    ops = args[1:7]
    with _nan_allocations():
        got = gt.composite_backward(t1, *ops, gaux, occ, st, Pn, Qn, PB, Pb)
    torch.cuda.synchronize()
    want = gt.composite_backward_plain(t1, *ops, gaux, occ, st, Pn, Qn, PB, Pb)
    assert got.shape == want.shape == t1.shape and got.dtype == torch.bfloat16
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert scale > 0.0 and err <= 1e-2 * scale, (err, scale)
    assert _cosine(got.float(), want.float()) > 0.99999
    assert not got[:, 3 * st.ncoeff + 1:].any()
    dead = (occ[1] == 0).T.repeat_interleave(Pb, 1)  # [NP, Pn]
    assert not got.permute(0, 2, 1, 3)[dead].any()
    counts = (gn.composite_positions.launches, gt.composite_backward.launches)
    t1g = t1.detach().requires_grad_(True)
    out = gt.composite_positions_diff(t1g, *ops, *occ, st, Pn, Qn, PB, Pb)
    out.backward(gstate)
    assert (gn.composite_positions.launches - counts[0],
            gt.composite_backward.launches - counts[1]) == (1, 1)
    assert _cosine(t1g.grad.float(), want.float()) > 0.99999


# K7's band-kernel cases: (grid, P, height, width, focal) of one pose. narrow:
# Qn = 128, two texel rows a CTA; tall: Qn = 2048, clusters of 4 CTAs;
# deep: 256 vertices along the march axis at P = 8 (over 2000 positions,
# SH degree 3); coarse: a 256 x 256 cross-section on 128 texels (|kv| > 1:
# some rows v get no column); fine: a 16^3 grid on a 1280-texel frame
# (|kv| << 1: many columns reach one v; clusters of 3 CTAs with idle columns);
# past: Qn = 4224, past the band kernel's reach (clusters of 8 CTAs of 512
# columns), which takes the three launches
BAND_CASES = {"narrow": ("ball32", 2, 96, 96, 105.0),
              "tall": ("ball32", 2, 1600, 160, 1750.0),
              "deep": ("deep", 8, 64, 64, 70.0),
              "coarse": ("wide", 2, 64, 64, 70.0),
              "fine": ("ball16", 2, 1024, 1024, 1120.0),
              "past": ("ball32", 2, 3300, 160, 3600.0)}


def _band_case(device, view):
    """The stripe operands of BAND_CASES[view] (diffuse on, qb = 0) or of
    QSPLIT_BAND_CASES[view] (its qb: [PB, QB, NP] flags), as
    ``_stripe_case`` builds them."""
    if view in BAND_CASES:
        grid_kind, P, height, width, focal, qb = *BAND_CASES[view], 0
    else:
        grid_kind, P, height, width, focal, qb = QSPLIT_BAND_CASES[view]
    gn._strict_f32()
    pose = pose_spherical(140.0, -30.0, 3.5)
    rot = np.asarray(pose.rotation, np.float32).reshape(3, 3)
    org = np.asarray(pose.translation, np.float32).reshape(3)
    axis, flip = gn.dominant_axis_for_pose(rot)
    if grid_kind == "deep":
        tgrid = _deep_grid(axis, device)
    elif grid_kind == "wide":
        tgrid = _deep_grid(axis, device, n_axis=16, n_other=256, ncoeff=9)
    else:
        tgrid = _grid(int(grid_kind[4:]), device=device)
    st = gn.statics_for_grid(tgrid, axis, flip, with_diffuse=True, pos_per_cell=P,
                             exit_eps=0.0, qb=qb)
    Pn, Qn, PB, Pb = gn.gnomonic_frame(None, height, width, focal, SS, st)
    slices = gn.repack_position_slices(tgrid, st, vertex_only=False)
    geo = gn.gnomonic_geometry(torch.from_numpy(rot).to(device),
                               torch.from_numpy(org).to(device), st, height, width,
                               torch.tensor(focal, device=device), SS,
                               phase=(0.25, -0.125), lite=False, skip_basis=False)
    if qb == 0:
        occ = gn.gnomonic_occupancy(slices, geo.Ru, st, PB, Pb)
    else:
        occ = gn.gnomonic_occupancy(slices, geo.Ru, st, PB, Pb, RvT=geo.RvT,
                                    QB=gn._qb_blocks(st, Qn)[0])
    return slices, geo, st, (Pn, Qn, PB, Pb), occ


@pytest.mark.parametrize("view", list(BAND_CASES))
def test_band_cases_hold_their_geometry(view):
    """On the CPU: each K7 band case has what it is there for: Qn = 128 with
    two rows a CTA (narrow), Qn = 2048 and clusters of 4 (tall), over 2000
    positions (deep), |kv| > 1 on its needed positions (coarse), |kv| < 0.1
    and a cluster with idle columns (fine), Qn = 4224 and no band plan
    (past); every case has needed blocks and dead ones."""
    slices, geo, st, (Pn, Qn, PB, Pb), occ = _band_case("cpu", view)
    NP, nv = slices.shape[0], slices.shape[3]
    plan = gt.stripe_band_plan(Qn, Pb, NP, 3 * st.ncoeff + 1, nv)
    needed = occ[1].sum(0) > 0
    kv = float(geo.geom[needed, 5].abs().max())
    assert bool(needed.any()) and not bool(occ[1].all())
    if view == "past":
        assert Qn == 4224 and plan is None, (Qn, plan)
        return
    expect = {"narrow": Qn == 128 and plan.R == 2, "tall": Qn == 2048 and plan.S == 4,
              "deep": NP > 2000 and st.ncoeff == 16, "coarse": kv > 1.0,
              "fine": kv < 0.1 and plan.S * plan.Qc > Qn}
    assert expect[view], (Qn, NP, kv, plan)


@pytest.mark.gpu
@pytest.mark.parametrize("view", list(BAND_CASES))
def test_stripe_backward_band_cases(cuda, view):
    """K7's band kernel on the BAND_CASES views against its plain version
    (the bounds of test_stripe_backward_kernel_matches_plain: max-abs <= 1e-2
    of the largest element, cosine > 0.99999, pad channels and dead blocks
    zero, both outputs allocated NaN-filled) and against the three-launch
    design it replaced, which folds in the same order (bit-equal); the past
    case runs the three launches itself."""
    slices, geo, st, (Pn, Qn, PB, Pb), occ = _band_case(cuda, view)
    t1 = gn.resample_u(slices, geo.Ru)
    ops = (geo.RvT, geo.ybasis, geo.live_u, geo.live_v, geo.norm, geo.geom)
    args = (t1, *ops, st, Pn, Qn, PB, Pb, occ)
    state = gn.composite_positions_plain(*args)
    gen = torch.Generator(device=cuda).manual_seed(5)
    gstate = torch.randn(state.shape, generator=gen, device=cuda)
    gaux = torch.cat([gstate, (gstate[1:] * state[1:]).sum(0)[None], state[0:1]])
    checked = gn._check_stripe_operands("K7", t1, *ops, occ, st, Pn, Qn, PB, Pb)
    with _nan_allocations():
        got = gt.composite_backward(t1, *ops, gaux, occ, st, Pn, Qn, PB, Pb)
        old = gt.stripe_backward_three_launch(checked, gaux.contiguous(), st, Pn, Qn, Pb,
                                              1, Qn)
    torch.cuda.synchronize()
    want = gt.composite_backward_plain(t1, *ops, gaux, occ, st, Pn, Qn, PB, Pb)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert scale > 0.0 and err <= 1e-2 * scale, (err, scale)
    assert _cosine(got.float(), want.float()) > 0.99999
    assert not got[:, 3 * st.ncoeff + 1:].any()
    dead = (occ[1] == 0).T.repeat_interleave(Pb, 1)  # [NP, Pn]
    assert not got.permute(0, 2, 1, 3)[dead].any()
    assert torch.equal(got, old)


@pytest.mark.parametrize("Qn", list(range(128, 2049, 128)))
def test_stripe_band_plan_fits(Qn):
    """On the CPU: K7's launch plan at every frame width of the CLI's
    frames (Qn 128-2048) and marches of up to 2041 positions (P = 8 on a
    256^3 grid) at SH degrees 0-3 and nv 16-256: at most 227 KB of shared
    memory and 512 threads (the kernel's launch bound, under the 1024 of a
    block); clusters of at most 8 CTAs (none up to Qn = 256) whose columns,
    multiples of 32, cover the frame with no CTA idle; rows a CTA dividing
    the flag blocks; t1 staged wherever its ring fits. K8's plan (q-blocks
    of 128 and 256 columns) is the same plan."""
    for NP in (65, 255, 1021, 2041):
        for used in (4, 13, 28, 49):
            for nv in (16, 64, 128, 256):
                plan = gt.stripe_band_plan(Qn, 128, NP, used, nv)
                assert plan.smem <= 227 * 1024 and plan.threads <= 512 <= 1024
                assert plan.threads == plan.R * plan.Qc and plan.Qc % 32 == 0
                assert 1 <= plan.S <= 8 and (plan.S - 1) * plan.Qc < Qn <= plan.S * plan.Qc
                assert 128 % plan.R == 0 and (Qn > 256 or plan.S == 1)
                ring = 6 * used * plan.R * nv
                rest = plan.smem - (ring if plan.staged else 0)
                assert plan.staged == (rest + ring <= 227 * 1024)
                for qb in (128, 256):  # K8's q-blocks: the same plan, the same bytes
                    if Qn > qb and Qn % qb == 0:
                        assert gt.stripe_band_plan(Qn, 128, NP, used, nv, QB=Qn // qb) == plan
    unaligned = gt.stripe_band_plan(Qn, 128, 255, 28, 128, t1_aligned=False)
    assert not unaligned.staged


@pytest.mark.parametrize("Qn,NP,fits", [(4096, 2041, True), (4224, 255, False),
                                        (8192, 65, False), (512, 8000, False)])
def test_stripe_band_plan_reach(Qn, NP, fits):
    """On the CPU: K7's band plan reaches Qn = 4096 (a cluster of 8 CTAs of
    512 columns) and no further, and no plan fits where the position tables
    fill the shared memory; there the plan is None and the wrapper takes the
    three launches."""
    plan = gt.stripe_band_plan(Qn, 128, NP, 28, 128)
    assert (plan is not None) == fits
    if fits:
        assert (plan.S, plan.Qc) == (8, 512) and plan.smem <= 227 * 1024


# K8's band-kernel cases: (grid, P, height, width, focal, qb) of one pose
# (diffuse on). two_blocks: Qn = 256 in two live q-blocks, one CTA (the
# frame of _stripe_case(qb=128), zoomed in: that one sees the ball in one
# block only); four_blocks: Qn = 512 in four; straddle: Qn = 640, clusters
# of 2 CTAs of 320 columns, q-block 2 (columns 256-383) live in both;
# sixteen_blocks: Qn = 2048, clusters of 4; qb256: Qn = 768 in three
# q-blocks of 256, block 1 across two CTAs of 384; deep_qsplit: over 2000
# positions (SH degree 3) in two live q-blocks; dead_block: a q-block that
# no u-block needs; past_qsplit: Qn = 4224 (33 q-blocks), past the band
# kernel's reach, which takes the three launches
QSPLIT_BAND_CASES = {"two_blocks": ("ball32", 2, 128, 128, 300.0, 128),
                     "four_blocks": ("ball32", 2, 400, 400, 1000.0, 128),
                     "straddle": ("ball32", 2, 480, 480, 1200.0, 128),
                     "sixteen_blocks": ("ball32", 2, 1600, 160, 1750.0, 128),
                     "qb256": ("ball32", 2, 600, 600, 1500.0, 256),
                     "deep_qsplit": ("deep", 8, 200, 200, 400.0, 128),
                     "dead_block": ("ball32", 2, 400, 400, 800.0, 128),
                     "past_qsplit": ("ball32", 2, 3300, 160, 3600.0, 128)}


def _live_straddlers(plan, QB, Qb, pos_needed):
    """The q-blocks whose columns lie in two CTAs of ``plan``'s clusters and
    that some u-block needs at some position."""
    live = pos_needed.sum(dim=(0, 2)) > 0  # [QB]
    return [b for b in range(QB)
            if b * Qb // plan.Qc != ((b + 1) * Qb - 1) // plan.Qc and bool(live[b])]


@pytest.mark.parametrize("view", list(QSPLIT_BAND_CASES))
def test_qsplit_band_cases_hold_their_geometry(view):
    """On the CPU: each K8 band case has what it is there for: two live
    q-blocks of Qn = 256 in one CTA (two_blocks), four in one CTA
    (four_blocks), a live q-block across two CTAs (straddle at qb = 128,
    qb256 at qb = 256), Qn = 2048 in clusters of 4 (sixteen_blocks), over
    2000 positions (deep_qsplit), a q-block no u-block needs while its
    neighbours are live (dead_block), Qn = 4224 and no band plan
    (past_qsplit); in every case some band's union of needed positions is
    longer than a live q-block's own count (that block's texels sit out
    phases) and some positions are dead."""
    slices, geo, st, (Pn, Qn, PB, Pb), occ = _band_case("cpu", view)
    NP, nv = slices.shape[0], slices.shape[3]
    QB, Qb = gn._qb_blocks(st, Qn)
    pn = occ[1]
    assert pn.shape == (PB, QB, NP) and QB > 1, (pn.shape, QB)
    per_block = pn.sum(-1)  # [PB, QB]
    union = (pn != 0).any(1).sum(-1)  # [PB]
    assert bool(((per_block > 0) & (per_block < union[:, None])).any()), (per_block, union)
    assert not bool((pn != 0).any(1).all())
    plan = gt.stripe_band_plan(Qn, Pb, NP, 3 * st.ncoeff + 1, nv, QB=QB)
    if view == "past_qsplit":
        assert Qn == 4224 and plan is None, (Qn, plan)
        return
    live_blocks = per_block.sum(0) > 0  # [QB]
    dead_blocks = [b for b in range(1, QB - 1)
                   if not live_blocks[b] and live_blocks[:b].any() and live_blocks[b + 1:].any()]
    dead_blocks += [b for b in (0, QB - 1) if not live_blocks[b] and live_blocks.any()]
    expect = {"two_blocks": (Qn, QB, plan.S) == (256, 2, 1) and bool((per_block > 0).all()),
              "four_blocks": (Qn, QB, plan.S) == (512, 4, 1) and int(live_blocks.sum()) == 4,
              "straddle": (Qn, Qb, plan.S, plan.Qc) == (640, 128, 2, 320)
              and _live_straddlers(plan, QB, Qb, pn) == [2],
              "sixteen_blocks": (Qn, QB, plan.S) == (2048, 16, 4),
              "qb256": (Qn, Qb, plan.S) == (768, 256, 2)
              and _live_straddlers(plan, QB, Qb, pn) == [1],
              "deep_qsplit": NP > 2000 and st.ncoeff == 16 and bool((per_block > 0).any(0).all()),
              "dead_block": len(dead_blocks) > 0 and bool(live_blocks.any())}
    assert expect[view], (Qn, QB, Qb, NP, plan, per_block)


@pytest.mark.gpu
@pytest.mark.parametrize("view", list(QSPLIT_BAND_CASES))
def test_stripe_backward_qsplit_band_cases(cuda, view, monkeypatch):
    """K8 on the QSPLIT_BAND_CASES views through the band kernel (the past
    case through the three launches: counted), bit-equal to the three
    launches on the same operands (the fold adds the same per-q-block
    partials in the same order) and against its plain version with the
    bounds of test_qsplit_backward_kernel_matches_plain (max-abs <= 1e-2 of
    the largest element, cosine > 0.99999); pad channels and positions no
    q-block of a u-block needs stay zero (dt1 allocated NaN-filled)."""
    slices, geo, st, (Pn, Qn, PB, Pb), occ = _band_case(cuda, view)
    QB, Qb = gn._qb_blocks(st, Qn)
    t1 = gn.resample_u(slices, geo.Ru)
    ops = (geo.RvT, geo.ybasis, geo.live_u, geo.live_v, geo.norm, geo.geom)
    args = (t1, *ops, st, Pn, Qn, PB, Pb, occ)
    state = gn.composite_positions_qb_plain(*args)
    gen = torch.Generator(device=cuda).manual_seed(5)
    gstate = torch.randn(state.shape, generator=gen, device=cuda)
    gaux = torch.cat([gstate, (gstate[1:] * state[1:]).sum(0)[None], state[0:1]])
    checked = gn._check_stripe_operands("K8", t1, *ops, occ, st, Pn, Qn, PB, Pb)
    three_launch, taken = gt.stripe_backward_three_launch, []

    def counted(*a):
        taken.append(a[-2:])
        return three_launch(*a)

    monkeypatch.setattr(gt, "stripe_backward_three_launch", counted)
    before = gt.composite_backward_qb.launches
    with _nan_allocations():
        got = gt.composite_backward(t1, *ops, gaux, occ, st, Pn, Qn, PB, Pb)
        old = three_launch(checked, gaux.contiguous(), st, Pn, Qn, Pb, QB, Qb)
    torch.cuda.synchronize()
    assert gt.composite_backward_qb.launches == before + 1
    assert taken == ([(QB, Qb)] if view == "past_qsplit" else []), taken
    want = gt.composite_backward_qb_plain(t1, *ops, gaux, occ, st, Pn, Qn, PB, Pb)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert scale > 0.0 and err <= 1e-2 * scale, (err, scale)
    assert _cosine(got.float(), want.float()) > 0.99999
    assert not got[:, 3 * st.ncoeff + 1:].any()
    dead = (occ[1] == 0).all(1).T.repeat_interleave(Pb, 1)  # [NP, Pn]
    assert not got.permute(0, 2, 1, 3)[dead].any()
    assert torch.equal(got, old)


@pytest.mark.parametrize("Qn,QB,fits", [(4096, 32, True), (4096, 16, True), (2048, 32, True),
                                        (2048, 64, False), (4224, 33, False),
                                        (4224, 3, False)])
def test_stripe_band_plan_reach_qsplit(Qn, QB, fits):
    """On the CPU: K8's band plan (QB q-blocks) is K7's plan for the frame
    up to 32 q-blocks, the bits of a flag word, and None past them (qb = 32
    at Qn = 2048) or past Qn = 4096; there the wrapper takes the three
    launches."""
    plan = gt.stripe_band_plan(Qn, 128, 1021, 28, 128, QB=QB)
    assert (plan is not None) == fits
    if fits:
        assert plan == gt.stripe_band_plan(Qn, 128, 1021, 28, 128)
        assert plan.smem <= 227 * 1024


# K5's cases: the K7 band views (Qn = 128 and 2048, over 2000 positions,
# |kv| > 1, |kv| << 1, Qn = 4224), the opaque scene at exit 1e-4 (tiles end
# early) and K6's q-block grain (qb = 128: two q-blocks)
STRIPE_CASES = list(BAND_CASES) + ["opaque", "qsplit"]


def _stripe_view_case(device, view):
    """The stripe composite's operands of STRIPE_CASES[view], as
    ``composite_positions`` takes them."""
    if view == "opaque":
        return _stripe_case(device, 2, False, 1e-4, 30.0)
    if view == "qsplit":
        return _stripe_case(device, 2, True, qb=128)
    slices, geo, st, (Pn, Qn, PB, Pb), occ = _band_case(device, view)
    t1 = gn.resample_u(slices, geo.Ru)
    return (t1, geo.RvT, geo.ybasis, geo.live_u, geo.live_v, geo.norm, geo.geom, st,
            Pn, Qn, PB, Pb, occ)


@pytest.mark.gpu
@pytest.mark.parametrize("view", STRIPE_CASES)
def test_stripe_composite_cases(cuda, view):
    """K5 (K6 on the q-split view) on the STRIPE_CASES views against its
    plain version at the kernel's exit grain, with the bounds of
    test_stripe_composite_kernel_matches_plain (colour / acc 1e-4, depth
    1e-3)."""
    args = _stripe_view_case(cuda, view)
    got = gn.composite_positions(*args)
    torch.cuda.synchronize()
    plain = gn.composite_positions_qb_plain if view == "qsplit" else gn.composite_positions_plain
    want = plain(*args, exit_tile=gn.CUDA_EXIT_TILE)
    gap = (got - want).abs().amax(dim=(1, 2)).cpu().numpy()
    assert bool(torch.isfinite(got).all())
    assert gap[:5].max() < 1e-4 and gap[5] < 1e-3 and gap[6:].max(initial=0.0) < 1e-4, gap


def _includes(name, seen):
    """The headers csrc/``name`` includes (``#include "..."``), transitively."""
    import re

    from thr3ed_atom_tpu_torch import kernels

    for header in re.findall(r'#include\s+"([^"]+)"', (kernels.CSRC / name).read_text()):
        if header not in seen:
            seen.add(header)
            _includes(header, seen)
    return seen


@pytest.mark.parametrize("lib", ["relu_trap", "composite_fused", "composite_backward_fused",
                                 "composite_stripe", "composite_stripe_backward",
                                 "resample_rows", "slab_march", "slab_march_backward",
                                 "plane_march", "plane_march_backward", "onehot_gather",
                                 "resample_rows_adjoint"])
def test_kernel_sources_list_their_headers(lib):
    """On the CPU: each library's entry in kernels.SOURCES names its source
    first and then exactly the headers that source includes, directly or
    through another header, so that a header's edit rebuilds every library
    that uses it; and the twelve libraries are all there are."""
    from thr3ed_atom_tpu_torch import kernels

    assert len(kernels.SOURCES) == 12
    src, *headers = kernels.SOURCES[lib]
    assert src == lib + ".cu" and (kernels.CSRC / src).is_file()
    assert len(headers) == len(set(headers)) and set(headers) == _includes(src, set())


def test_bind_binds_each_function_once(monkeypatch):
    """On the CPU, with a stand-in library: kernels.bind looks a function up
    and sets its ctypes signature on the first call only, then returns the
    same cached object."""
    import ctypes
    from thr3ed_atom_tpu_torch import kernels

    class Fn:
        def __init__(self):
            self.sets = 0

        def __setattr__(self, name, value):
            if name == "argtypes":
                object.__setattr__(self, "sets", self.sets + 1)
            object.__setattr__(self, name, value)

    class Lib:
        def __init__(self):
            self.f, self.g = Fn(), Fn()

    loads = []

    def fake_load(name):
        loads.append(name)
        return Lib()

    monkeypatch.setattr(kernels, "load", fake_load)
    monkeypatch.setattr(kernels, "_bound", {})
    args = [ctypes.c_void_p, ctypes.c_int]
    first = kernels.bind("fake", "f", args)
    assert all(kernels.bind("fake", "f", args) is first for _ in range(3))
    other = kernels.bind("fake", "g", args)
    assert loads == ["fake", "fake"] and first.sets == 1 and other.sets == 1
    assert first.argtypes == args and first.restype is ctypes.c_int and other is not first


@pytest.mark.gpu
def test_v2_train_step_kernels_match_plain(cuda):
    """One gnomonic_train_step_multi with qb = 0 (k = 2) through the kernels
    against the same step through the plain versions: the grid gradients
    within cosine > 0.99999, the losses within rtol 1e-5; the step launched
    K5, K7, K2 and K4 and neither fused kernel."""
    pose = pose_spherical(140.0, -30.0, 3.5)
    rot = np.asarray(pose.rotation, np.float32).reshape(3, 3)
    org = np.asarray(pose.translation, np.float32).reshape(3)
    axis, flip = gn.dominant_axis_for_pose(rot)
    images = torch.rand((2, H, W, 3), generator=torch.Generator().manual_seed(1)).to(cuda)
    grads, losses = [], []
    counters = (gn.composite_positions, gt.composite_backward, wm.resample_rows,
                wm.resample_rows_adjoint, gn.composite_positions_fused,
                gt.composite_backward_fused)
    for plain in (False, True):
        tgrid = _grid(32, device=cuda)
        ts = gt.make_gnomonic_train_statics(tgrid, axis, flip, image_height=H,
                                            image_width=W, white_bkgd=True, pos_per_cell=2,
                                            qb=0)
        opt, sched = make_gnomonic_optimizer(tgrid)
        before = [c.launches for c in counters]
        m = gt.gnomonic_train_step_multi(ts, opt, tgrid, images, np.stack([rot] * 2),
                                         np.stack([org] * 2), FOCAL,
                                         phases=[(0.1, 0.2), (-0.3, 0.4)],
                                         scheduler=sched, plain=plain)
        torch.cuda.synchronize()
        counts = [c.launches - b for c, b in zip(counters, before)]
        assert counts == ([2, 2, 4, 4, 0, 0] if not plain else [0] * 6), counts
        grads.append((tgrid.densities.grad.clone(), tgrid.features.grad.clone()))
        losses.append(float(m["total_loss"]))
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all()) and _cosine(a, b) > 0.99999


@pytest.mark.gpu
@pytest.mark.parametrize("diffuse,exit_eps,density_scale,ncoeff,relu",
                         [(True, 0.0, 1.0, 9, True), (False, 1e-4, 30.0, 9, True)]
                         + [(True, 0.0, 1.0, nc, relu) for nc, relu in SH_CASES])
def test_qsplit_composite_kernel_matches_plain(cuda, diffuse, exit_eps, density_scale, ncoeff,
                                               relu):
    """The q-split stripe composite (K6: qb = 128, two q-blocks) against its
    plain version at the kernel's exit grain: the march is K5's with the
    q-block's flags. Bound: colour/acc 1e-4, depth 1e-3 (K5's); the opaque
    scene must end some tiles early. composite_positions routes QB > 1 to K6
    and launches no K5. Also at SH degrees 0, 1 and 3 and with the abs /
    identity field."""
    args = _stripe_case(cuda, 2, diffuse, exit_eps, density_scale, qb=128, ncoeff=ncoeff,
                        relu=relu)
    assert args[12][0].dim() == 3 and args[12][0].shape[1] == 2
    before = (gn.composite_positions.launches, gn.composite_positions_qb.launches)
    got = gn.composite_positions(*args)
    torch.cuda.synchronize()
    assert (gn.composite_positions.launches - before[0],
            gn.composite_positions_qb.launches - before[1]) == (0, 1)
    want, work = gn.composite_positions_qb_plain(*args, exit_tile=gn.CUDA_EXIT_TILE,
                                                 return_work=True)
    if density_scale > 1.0:
        st = args[7]
        _, work_all = gn.composite_positions_qb_plain(
            *args[:7], st._replace(exit_eps=0.0), *args[8:], return_work=True)
        assert int(work.sum()) < int(work_all.sum())
    gap = (got - want).abs().amax(dim=(1, 2)).cpu().numpy()
    assert gap[:5].max() < 1e-4 and gap[5] < 1e-3 and gap[6:].max(initial=0.0) < 1e-4, gap
    assert float(want[4].max()) > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("ncoeff,relu", [(9, True)] + SH_CASES)
def test_qsplit_backward_kernel_matches_plain(cuda, ncoeff, relu):
    """The q-split replay backward (K8) against its plain version on a seeded
    state cotangent: the same replay; the fold sums each q-block's part of a
    row's range in ascending q and adds the partials in q-block order, the
    plain version each partial in a matmul's order. Bound: max-abs <= 1e-2 of
    the largest element, cosine > 0.99999; pad channels zero. Autograd of
    composite_positions_diff launches K6 once and K8 once. Also at SH degrees
    0, 1 and 3 and with the abs / identity field."""
    args = _stripe_case(cuda, 2, True, qb=128, ncoeff=ncoeff, relu=relu)
    t1, st, (Pn, Qn, PB, Pb), occ = args[0], args[7], args[8:12], args[12]
    state = gn.composite_positions_qb_plain(*args)
    gen = torch.Generator(device=cuda).manual_seed(5)
    gstate = torch.randn(state.shape, generator=gen, device=cuda)
    gaux = torch.cat([gstate, (gstate[1:] * state[1:]).sum(0)[None], state[0:1]])
    ops = args[1:7]
    got = gt.composite_backward(t1, *ops, gaux, occ, st, Pn, Qn, PB, Pb)
    torch.cuda.synchronize()
    want = gt.composite_backward_qb_plain(t1, *ops, gaux, occ, st, Pn, Qn, PB, Pb)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert scale > 0.0 and err <= 1e-2 * scale, (err, scale)
    assert _cosine(got.float(), want.float()) > 0.99999
    assert not got[:, 3 * st.ncoeff + 1:].any()
    counts = (gn.composite_positions_qb.launches, gt.composite_backward_qb.launches,
              gt.composite_backward.launches)
    t1g = t1.detach().requires_grad_(True)
    gt.composite_positions_diff(t1g, *ops, *occ, st, Pn, Qn, PB, Pb).backward(gstate)
    assert (gn.composite_positions_qb.launches - counts[0],
            gt.composite_backward_qb.launches - counts[1],
            gt.composite_backward.launches - counts[2]) == (1, 1, 0)


def _bricked_case(device, density_scale=1.0, size=64, image=128, ncoeff=9, relu=True,
                  tile_px=0, focal=None):
    """One pose's slab-march operands on a carved scene (see ``_grid``): the
    repacked grid, ray records, tables and counts at the serving threshold;
    tiles of ``tile_px`` pixels (0: the procedure's choice, 16 here), the
    focal length ``image * 1.1`` unless given."""
    from thr3ed_atom_tpu_torch.rendering import bricked as br

    tgrid = _grid(size, device=device, density_scale=density_scale, ncoeff=ncoeff, relu=relu)
    pose = pose_spherical(140.0, -30.0, 3.5)
    rot = torch.as_tensor(np.asarray(pose.rotation, np.float32).reshape(3, 3)).to(device)
    org = torch.as_tensor(np.asarray(pose.translation, np.float32).reshape(3)).to(device)
    axis, flip = br.dominant_axis_for_pose(rot.cpu().numpy())
    st = br.statics_for_grid(tgrid, axis, flip, with_diffuse=True, axis_supersample=2,
                             tile_px=tile_px)
    rep, occ = br.prepare_bricked_grid(tgrid, st)
    focal = image * 1.1 if focal is None else focal
    ro, rd = br._tile_image_rays(image, image, focal, image, image, rot, org, st.tile_px)
    rf = br.compute_ray_features(ro, rd, st)
    tables, counts, _ = br.build_tables(rf, occ, st)
    return st, (tables, counts, rf, rep)


# the slab and plane marches' cases: (relu, exit_eps, density_scale, ncoeff,
# abs_field): SH degree 2 on the relu scene, then SH degrees 0 and 1 with the
# relu field and with the abs / identity field (relu off) each
MARCH_CASES = [(True, 1e-4, 1.0, 9, False), (False, 0.0, 1.0, 9, False),
               (True, 1e-4, 30.0, 9, False)] + [
    (relu, 1e-4 if relu else 0.0, 1.0, nc, not relu) for nc in (1, 4) for relu in (True, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("relu,exit_eps,density_scale,ncoeff,abs_field", MARCH_CASES)
def test_slab_march_kernels_match_plain(cuda, relu, exit_eps, density_scale, ncoeff, abs_field):
    """The slab-march render (K9) against its plain version: the same taps,
    tents and order of sums, exp / sigmoid as PyTorch's. Bound: max-abs
    1e-6. The replay backward (K10) on a seeded cotangent against its plain
    version: f32 atomics add in another order. Bound: max-abs <= 1e-4 of the
    largest element (f32, before the cast), cosine > 0.99999; within one
    bf16 unit after the cast. Each wrapper counts one launch. Also at SH
    degrees 0 and 1, relu on and off (off on the abs / identity field)."""
    from thr3ed_atom_tpu_torch.ops import slab_march as sm

    st, ops = _bricked_case(cuda, density_scale, ncoeff=ncoeff, relu=not abs_field)
    kw = dict(ncoeff=st.ncoeff, relu_sigma=relu, exit_eps=exit_eps, with_diffuse=True)
    before = (sm.slab_march_render.launches, sm.slab_march_grad.launches)
    got = sm.slab_march_render(*ops, **kw)
    torch.cuda.synchronize()
    want = sm.slab_march_render_plain(*ops, **kw)
    assert float((got - want).abs().max()) <= 1e-6
    assert float(want[..., 3].max()) > 0.5
    gout = torch.randn(got.shape, generator=torch.Generator(device=cuda).manual_seed(3),
                       device=cuda)
    dg = sm.slab_march_grad(*ops, want, gout, **kw)
    torch.cuda.synchronize()
    dg_plain = sm.slab_march_grad_plain(*ops, want, gout, **kw)
    assert (sm.slab_march_render.launches - before[0],
            sm.slab_march_grad.launches - before[1]) == (1, 1)
    scale = float(dg_plain.abs().max())
    assert scale > 0.0 and float((dg - dg_plain).abs().max()) <= 1e-4 * scale
    assert _cosine(dg, dg_plain) > 0.99999
    cast = (dg.to(torch.bfloat16).float() - dg_plain.to(torch.bfloat16).float()).abs().max()
    assert float(cast) <= scale * 2.0 ** -8


def _cut_tables(counts):
    """The counts of a march with every third tile emptied and the next of
    each three cut to its first entry (the tables are left as they are)."""
    cut = counts.clone()
    t = torch.arange(cut.shape[0], device=cut.device)
    cut[t % 3 == 0] = 0
    cut[t % 3 == 1] = torch.clamp(cut[t % 3 == 1], max=1)
    return cut


def _march_table_cases(render, render_plain, ops, kw):
    """K9 or K11 (``render``) against its plain version (max-abs 1e-6) on
    ``ops`` with empty and single-entry tiles (``_cut_tables``), whose empty
    tiles write zeros, and with exit_eps 1: every tile's vote before its
    first entry ends it, so the output is zero; one launch a call."""
    tables, counts, rays, grid = ops
    cut = _cut_tables(counts)
    assert int((cut == 0).sum()) > 0 and int((cut == 1).sum()) > 0
    before = render.launches
    got = render(tables, cut, rays, grid, **kw)
    torch.cuda.synchronize()
    want = render_plain(tables, cut, rays, grid, **kw)
    assert float((got - want).abs().max()) <= 1e-6
    assert not got[cut[:, 0] == 0].any() and float(want[..., 3].max()) > 0.5
    first = {**kw, "exit_eps": 1.0}
    got = render(*ops, **first)
    torch.cuda.synchronize()
    assert float((got - render_plain(*ops, **first)).abs().max()) <= 1e-6
    assert not got.any()
    assert render.launches - before == 2


@pytest.mark.gpu
@pytest.mark.parametrize("tile_px", [16, 8])
@pytest.mark.parametrize("relu,exit_eps,density_scale,ncoeff,abs_field", MARCH_CASES)
def test_slab_march_kernel_table_cases(cuda, relu, exit_eps, density_scale, ncoeff, abs_field,
                                       tile_px):
    """K9 on tiles of 256 and 64 rays (16 and 8 pixels) at every
    MARCH_CASES case, against its plain version with the bound of
    test_slab_march_kernels_match_plain (max-abs 1e-6): as they come, with
    empty and single-entry tiles, and with an exit at the first entry."""
    from thr3ed_atom_tpu_torch.ops import slab_march as sm

    st, ops = _bricked_case(cuda, density_scale, ncoeff=ncoeff, relu=not abs_field,
                            tile_px=tile_px)
    assert ops[2].shape[1] == tile_px ** 2
    kw = dict(ncoeff=st.ncoeff, relu_sigma=relu, exit_eps=exit_eps, with_diffuse=True)
    got = sm.slab_march_render(*ops, **kw)
    torch.cuda.synchronize()
    assert float((got - sm.slab_march_render_plain(*ops, **kw)).abs().max()) <= 1e-6
    _march_table_cases(sm.slab_march_render, sm.slab_march_render_plain, ops, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("segment", [(1, 2), (0, 2), (2, 4)])
def test_slab_march_kernels_at_group_offset(cuda, segment):
    """K9 / K10 on a depth segment: segment i of n of the pose's slab
    groups [g0, g1), tables of global group indices
    (``build_tables(..., group_range=)``), the repacked grid's groups
    [g0, g1) and group_offset g0, against their plain versions at the same
    offset with test_slab_march_kernels_match_plain's bounds (K9 max-abs
    1e-6; K10 max-abs <= 1e-4 of the largest element, cosine > 0.99999)."""
    from thr3ed_atom_tpu_torch.ops import slab_march as sm
    from thr3ed_atom_tpu_torch.rendering import bricked as br

    i, n = segment
    tgrid = _grid(64, device=cuda)
    pose = pose_spherical(140.0, -30.0, 3.5)
    rot = torch.as_tensor(np.asarray(pose.rotation, np.float32).reshape(3, 3)).to(cuda)
    org = torch.as_tensor(np.asarray(pose.translation, np.float32).reshape(3)).to(cuda)
    axis, flip = br.dominant_axis_for_pose(rot.cpu().numpy())
    st = br.statics_for_grid(tgrid, axis, flip, with_diffuse=True, axis_supersample=2)
    rep, occ = br.prepare_bricked_grid(tgrid, st)
    G = occ.shape[0]
    g0, g1 = i * G // n, (i + 1) * G // n
    assert g0 > 0 or n == 2
    ro, rd = br._tile_image_rays(128, 128, 140.8, 128, 128, rot, org, st.tile_px)
    rf = br.compute_ray_features(ro, rd, st)
    tables, counts, _ = br.build_tables(rf, occ[g0:g1], st, group_range=(g0, g1))
    ops = (tables, counts, rf, rep[g0:g1].contiguous())
    kw = dict(ncoeff=st.ncoeff, relu_sigma=True, exit_eps=1e-4, with_diffuse=True,
              group_offset=g0)
    got = sm.slab_march_render(*ops, **kw)
    torch.cuda.synchronize()
    want = sm.slab_march_render_plain(*ops, **kw)
    assert int(counts.sum()) > 0 and float(want[..., 3].max()) > 0.1
    assert float((got - want).abs().max()) <= 1e-6
    gout = torch.randn(got.shape, generator=torch.Generator(device=cuda).manual_seed(3),
                       device=cuda)
    dg = sm.slab_march_grad(*ops, want, gout, **kw)
    torch.cuda.synchronize()
    dg_plain = sm.slab_march_grad_plain(*ops, want, gout, **kw)
    scale = float(dg_plain.abs().max())
    assert scale > 0.0 and float((dg - dg_plain).abs().max()) <= 1e-4 * scale
    assert _cosine(dg, dg_plain) > 0.99999


@pytest.mark.gpu
def test_mesh_steps_on_a_one_rank_nccl_group(cuda):
    """The mesh steps under a one-rank NCCL group against the single-device
    steps from the same state and draws: the gnomonic step (n_dev 1, k 2)
    against gnomonic_train_step_multi and the bricked step at (1, 1)
    against bricked_train_step; metrics within rtol 1e-5, Adam's first
    moments (0.1 g) cosine > 0.99999 (K3, K4 and K10 sum in f32 in a
    varying order); the replicas agree."""
    import torch.distributed as dist

    from thr3ed_atom_tpu_torch.modules import bricked_trainer as bt
    from thr3ed_atom_tpu_torch.parallel import mesh as pm
    from thr3ed_atom_tpu_torch.rendering import bricked as br

    assert pm.init_process_group(backend="nccl", device=cuda)
    try:
        rng = np.random.default_rng(0)
        poses = [pose_spherical(140.0 + 6.0 * i, -30.0, 3.5) for i in range(2)]
        rots = np.stack([np.asarray(p.rotation, np.float32).reshape(3, 3) for p in poses])
        orgs = np.stack([np.asarray(p.translation, np.float32).reshape(3) for p in poses])
        images = torch.as_tensor(rng.random((2, H, W, 3), dtype=np.float32)).to(cuda)
        phases = [torch.tensor([0.1, -0.2], device=cuda), torch.tensor([-0.3, 0.25],
                                                                        device=cuda)]
        results = []
        for mesh in (False, True):
            grid = _grid(32, device=cuda)
            axis, flip = gn.dominant_axis_for_pose(rots[0])
            ts = gt.make_gnomonic_train_statics(grid, axis, flip, image_height=H,
                                                image_width=W, white_bkgd=True)
            opt, _ = make_gnomonic_optimizer(grid, 0.03)
            if mesh:
                m = gt.gnomonic_train_step_mesh(ts, opt, 1, grid, images, rots, orgs, FOCAL,
                                                phases=phases)
                assert pm.replicas_agree([grid.densities, grid.features])
            else:
                m = gt.gnomonic_train_step_multi(ts, opt, grid, images, rots, orgs, FOCAL,
                                                 phases=phases)
            results.append((m, opt.state[grid.features]["exp_avg"].clone()))
        for name in results[0][0]:
            np.testing.assert_allclose(float(results[1][0][name]), float(results[0][0][name]),
                                       rtol=1e-5, err_msg=name)
        assert _cosine(results[1][1], results[0][1]) > 0.99999
        results = []
        for mesh in (False, True):
            grid = _grid(32, device=cuda)
            axis, flip = br.dominant_axis_for_pose(rots[0])
            bs = bt.make_bricked_train_statics(grid, axis, flip, image_height=H, image_width=W,
                                               focal=FOCAL, ray_batch_size=4 * 256,
                                               white_bkgd=True)
            # four tiles over the ball in the middle of the image
            draws = (torch.tensor([48, 56, 56, 64], device=cuda),
                     torch.tensor([56, 48, 64, 56], device=cuda), torch.tensor(0.5))
            opt, _ = make_gnomonic_optimizer(grid, 0.03)
            pose_arr = np.concatenate([rots, orgs[:, :, None]], 2)
            idx = torch.tensor([0, 1, 0, 1], device=cuda)
            if mesh:
                m = bt.bricked_train_step_mesh(bs, opt, (1, 1), grid, images, pose_arr, idx,
                                               draws=draws)
            else:
                m = bt.bricked_train_step(bs, opt, grid, images, pose_arr, idx, draws=draws)
            results.append((m, opt.state[grid.features]["exp_avg"].clone()))
        for name in results[1][0]:
            np.testing.assert_allclose(float(results[1][0][name]), float(results[0][0][name]),
                                       rtol=1e-5, err_msg=name)
        assert float(results[0][1].abs().max()) > 0.0
        assert _cosine(results[1][1], results[0][1]) > 0.99999
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_bricked_render_and_train_step_kernels_match_plain(cuda):
    """render_image_bricked through K9 against the plain render (max-abs
    1e-6), and one bricked_train_step (4 tiles, diffuse, K = 2) through K9 /
    K10 against the same step through the plain versions with the same
    draws: losses within rtol 1e-5, grid gradients cosine > 0.99999; the
    step launched K9 and K10 once each."""
    from thr3ed_atom_tpu_torch.modules import bricked_trainer as bt
    from thr3ed_atom_tpu_torch.ops import slab_march as sm
    from thr3ed_atom_tpu_torch.rendering import bricked as br
    from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
    from thr3ed_atom_tpu_torch.utils.camera import CameraBounds, CameraIntrinsics

    config = SHVoxGridRenderConfig(num_samples_per_ray=64, camera_bounds=CameraBounds(1.0, 6.0),
                                   white_bkgd=True, perturb_sampled_points=False)
    pose = pose_spherical(140.0, -30.0, 3.5)
    intr = CameraIntrinsics(120, 120, 132.0)
    tgrid = _grid(64, device=cuda)
    got = br.render_image_bricked(tgrid, pose, intr, config)
    want = br.render_image_bricked(tgrid, pose, intr, config, plain=True)
    assert float((got.colour - want.colour).abs().max()) <= 1e-6
    rot = np.asarray(pose.rotation, np.float32).reshape(3, 3)
    axis, flip = br.dominant_axis_for_pose(rot)
    P = np.concatenate([rot, np.asarray(pose.translation, np.float32).reshape(3, 1)], 1)[None]
    images = torch.rand((1, 120, 120, 3), generator=torch.Generator().manual_seed(1)).to(cuda)
    # tiles over the ball (about 19 pixels around the image centre) and one
    # beside it
    draws = (torch.tensor([44, 52, 36, 0]), torch.tensor([44, 40, 56, 60]), torch.tensor(0.4))
    grads, losses = [], []
    for plain in (False, True):
        g = _grid(64, device=cuda)
        ts = bt.make_bricked_train_statics(g, axis, flip, image_height=120, image_width=120,
                                           focal=132.0, ray_batch_size=1024, white_bkgd=True,
                                           axis_supersample=2)
        opt, _ = make_gnomonic_optimizer(g)
        before = (sm.slab_march_render.launches, sm.slab_march_grad.launches)
        m = bt.bricked_train_step(ts, opt, g, images, P, torch.zeros(4, dtype=torch.long),
                                  draws=draws, plain=plain)
        torch.cuda.synchronize()
        launched = (sm.slab_march_render.launches - before[0],
                    sm.slab_march_grad.launches - before[1])
        assert launched == ((0, 0) if plain else (1, 1)), launched
        grads.append((g.densities.grad.clone(), g.features.grad.clone()))
        losses.append(float(m["total_loss"]))
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all()) and float(b.abs().max()) > 0.0
        assert _cosine(a, b) > 0.99999


# K10's bucket cases: (tile_px, image, focal, bucket cells or None for
# slab_backward_plan's): tiles of 16 x 16 (R = 256) and 8 x 8 (R = 64) rays
# on a 256-pixel image (0.4 voxels a pixel, as the serving and CLI frames),
# every step's box of cells within the buckets; a far focal (about 2.5
# voxels a pixel) whose 8-pixel tiles reach beyond 2 R = 128 cells of a
# patch at most steps (the direct path); and buckets of 16 cells that send
# most steps of 16-pixel tiles down the direct path beside summed ones
BUCKET_CASES = {"r256": (16, 256, None, None), "r64": (8, 256, None, None),
                "far": (8, 128, 40.0, None), "few": (16, 128, None, 16)}


@pytest.mark.gpu
@pytest.mark.parametrize("view", list(BUCKET_CASES))
def test_slab_march_backward_bucket_cases(cuda, view, monkeypatch):
    """K10 on the BUCKET_CASES views against its plain version with the
    bounds of test_slab_march_kernels_match_plain (max-abs <= 1e-4 of the
    largest element before the cast, cosine > 0.99999, one bf16 unit after
    it); its counts: every tap product added once, the global atomics far
    fewer than the products where the steps are summed in shared memory,
    and steps down the direct path exactly where the box exceeds the
    buckets (the far and few views)."""
    from thr3ed_atom_tpu_torch.ops import slab_march as sm

    tile_px, image, focal, cells = BUCKET_CASES[view]
    st, ops = _bricked_case(cuda, image=image, tile_px=tile_px, focal=focal)
    assert ops[2].shape[1] == tile_px ** 2
    if cells is not None:
        plan = sm.slab_backward_plan
        monkeypatch.setattr(sm, "slab_backward_plan", lambda R, nc: plan(R, nc)._replace(
            cells=cells, smem=plan(R, nc).smem - (plan(R, nc).cells - cells) * 4 * 17))
    kw = dict(ncoeff=st.ncoeff, relu_sigma=True, exit_eps=1e-4, with_diffuse=True)
    out = sm.slab_march_render_plain(*ops, **kw)
    gout = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(3),
                       device=cuda)
    stats = torch.zeros(4, dtype=torch.int64, device=cuda)
    dg = sm.slab_march_grad(*ops, out, gout, **kw, stats=stats)
    torch.cuda.synchronize()
    dg_plain = sm.slab_march_grad_plain(*ops, out, gout, **kw)
    scale = float(dg_plain.abs().max())
    assert scale > 0.0 and float((dg - dg_plain).abs().max()) <= 1e-4 * scale
    assert _cosine(dg, dg_plain) > 0.99999
    cast = (dg.to(torch.bfloat16).float() - dg_plain.to(torch.bfloat16).float()).abs().max()
    assert float(cast) <= scale * 2.0 ** -8
    products, atomics, summed, direct = stats.tolist()
    assert products > 0 and summed + direct > 0
    if view in ("r256", "r64"):
        assert direct == 0 and atomics * 4 < products, stats.tolist()
    else:
        assert direct > 0 and summed > 0, stats.tolist()


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_slab_march_grad_adds_into_dgrid(device, request):
    """slab_march_grad with ``dgrid=``: it adds the cotangent into the given
    tensor and returns that tensor (on the card the kernel alone, the
    zeroing left to the caller): the fresh cotangent plus what the tensor
    held, exactly on the CPU and within K10's 1e-4 of the largest element
    on the card; a tensor of another shape, dtype or layout is refused."""
    from thr3ed_atom_tpu_torch.ops import slab_march as sm

    dev = request.getfixturevalue("cuda") if device == "cuda" else torch.device("cpu")
    st, ops = _bricked_case(dev, size=32, image=64)
    kw = dict(ncoeff=st.ncoeff, relu_sigma=True, exit_eps=1e-4, with_diffuse=True)
    out = sm.slab_march_render_plain(*ops, **kw)
    gen = torch.Generator(device=dev).manual_seed(5)
    gout = torch.randn(out.shape, generator=gen, device=dev)
    fresh = sm.slab_march_grad(*ops, out, gout, **kw)
    base = torch.randn(fresh.shape, generator=gen, device=dev)
    held = base.clone()
    got = sm.slab_march_grad(*ops, out, gout, **kw, dgrid=held)
    assert got is held
    scale = float(fresh.abs().max())
    assert scale > 0.0
    gap = float((got - (base + fresh)).abs().max())
    assert gap == 0.0 if device == "cpu" else gap <= 1e-4 * scale
    for bad in (held[:-1], held.to(torch.float64), held.transpose(1, 2)):
        with pytest.raises(ValueError, match="dgrid"):
            sm.slab_march_grad(*ops, out, gout, **kw, dgrid=bad)


@pytest.mark.parametrize("R", [64, 256])
@pytest.mark.parametrize("ncoeff", [1, 4, 9])
def test_slab_backward_plan_fits(R, ncoeff):
    """On the CPU: K10's launch plan for tiles of 64 and 256 rays at SH
    degrees 0-2 (NUSED 4, 13, 28): one thread a ray (at most 1024),
    buckets of 2 R cells (at most the (PU + 1) x (PV + 1) a patch's taps
    reach), the used channels rounded up to 4, at most 227 KB, and at least
    two blocks an SM by shared memory."""
    from thr3ed_atom_tpu_torch.ops import slab_march as sm

    plan = sm.slab_backward_plan(R, ncoeff)
    assert plan.threads == R <= 1024
    assert plan.ch % 4 == 0 and 3 * ncoeff + 1 <= plan.ch < 3 * ncoeff + 5
    assert plan.cells == min(2 * R, (sm.PU + 1) * (sm.PV + 1))
    assert plan.smem == R * plan.ch * 4 + R * 16 + plan.cells * (1 + sm.BACKWARD_BUCKET) * 4
    assert plan.smem <= 227 * 1024 and 2 * (plan.smem + 1024) <= 228 * 1024


def _planes_case(device, density_scale=1.0, size=64, image=128, ncoeff=9, relu=True,
                 tile_px=0):
    """One pose's plane-march operands on a carved scene (see ``_grid``): the
    repacked position grid (P = 4 AUTO at 64^3), ray records, tables and
    counts at the serving threshold; tiles of ``tile_px`` pixels (0: the
    procedure's choice, 16 here)."""
    from thr3ed_atom_tpu_torch.rendering import planes as pl

    tgrid = _grid(size, device=device, density_scale=density_scale, ncoeff=ncoeff, relu=relu)
    pose = pose_spherical(140.0, -30.0, 3.5)
    rot = torch.as_tensor(np.asarray(pose.rotation, np.float32).reshape(3, 3)).to(device)
    org = torch.as_tensor(np.asarray(pose.translation, np.float32).reshape(3)).to(device)
    axis, flip = pl.dominant_axis_for_pose(rot.cpu().numpy())
    st = pl.statics_for_grid(tgrid, axis, flip, with_diffuse=True, tile_px=tile_px)
    rep, occ = pl.prepare_plane_grid(tgrid, st)
    rf, tables, counts, _ = pl.tile_operands(st, image, image, image * 1.1, occ, rot, org)
    return st, (tables, counts, rf, rep)


@pytest.mark.gpu
@pytest.mark.parametrize("relu,exit_eps,density_scale,ncoeff,abs_field", MARCH_CASES)
def test_plane_march_kernels_match_plain(cuda, relu, exit_eps, density_scale, ncoeff,
                                         abs_field):
    """The plane-march render (K11) against its plain version: the same taps,
    tents, relu_trap and order of sums, exp / sigmoid as PyTorch's. Bound:
    max-abs 1e-6, also with the tables' groups shifted by a group offset of
    1. The replay backward (K12) on a seeded cotangent against its plain
    version: f32 atomics add in another order. Bound: max-abs <= 1e-4 of the
    largest element (f32, before the cast), cosine > 0.99999; within one
    bf16 unit after the cast. Each wrapper counts one launch a call. Also
    at SH degrees 0 and 1, relu on and off (off on the abs / identity
    field)."""
    from thr3ed_atom_tpu_torch.ops import plane_march as pm

    st, ops = _planes_case(cuda, density_scale, ncoeff=ncoeff, relu=not abs_field)
    assert st.pos_per_cell == 4 and st.tile_px == 16
    kw = dict(ncoeff=st.ncoeff, relu_sigma=relu, exit_eps=exit_eps, with_diffuse=True)
    before = (pm.plane_march_render.launches, pm.plane_march_grad.launches)
    got = pm.plane_march_render(*ops, **kw)
    torch.cuda.synchronize()
    want = pm.plane_march_render_plain(*ops, **kw)
    assert float((got - want).abs().max()) <= 1e-6
    assert float(want[..., 3].max()) > 0.5
    shifted = ops[0].clone()
    shifted[..., 0] += 1
    got1 = pm.plane_march_render(shifted, *ops[1:], group_offset=1, **kw)
    want1 = pm.plane_march_render_plain(shifted, *ops[1:], group_offset=1, **kw)
    assert float((got1 - want1).abs().max()) <= 1e-6
    gout = torch.randn(got.shape, generator=torch.Generator(device=cuda).manual_seed(3),
                       device=cuda)
    dg = pm.plane_march_grad(*ops, want, gout, **kw)
    torch.cuda.synchronize()
    dg_plain = pm.plane_march_grad_plain(*ops, want, gout, **kw)
    assert (pm.plane_march_render.launches - before[0],
            pm.plane_march_grad.launches - before[1]) == (2, 1)
    scale = float(dg_plain.abs().max())
    assert scale > 0.0 and float((dg - dg_plain).abs().max()) <= 1e-4 * scale
    assert _cosine(dg, dg_plain) > 0.99999
    cast = (dg.to(torch.bfloat16).float() - dg_plain.to(torch.bfloat16).float()).abs().max()
    assert float(cast) <= scale * 2.0 ** -8


# K12's bucket plans: plane_backward_plan's as it is, and one of 8 cells,
# which sends the steps whose box of cells is larger (most of them) down the
# direct path beside summed ones
PLANE_BUCKET_CELLS = {"real": None, "forced": 8}


@pytest.mark.gpu
@pytest.mark.parametrize("plan", list(PLANE_BUCKET_CELLS))
@pytest.mark.parametrize("tile_px", [16, 8])
@pytest.mark.parametrize("relu,exit_eps,density_scale,ncoeff,abs_field", MARCH_CASES)
def test_plane_march_backward_bucket_cases(cuda, relu, exit_eps, density_scale, ncoeff,
                                           abs_field, tile_px, plan, monkeypatch):
    """K12 on tiles of 256 and 64 rays (16 and 8 pixels) of a 256-pixel image
    (about 0.4 voxels a pixel, as the serving and CLI frames) at every
    MARCH_CASES case, against its plain version with the bounds of
    test_plane_march_kernels_match_plain (max-abs <= 1e-4 of the largest
    element before the cast, cosine > 0.99999, one bf16 unit after it); its
    counts: on the real plan no step down the direct path (every box of a
    position step fits the buckets) and the global atomics at most a quarter
    of the tap products; on a plan of 8 cells, steps both summed and added
    directly."""
    from thr3ed_atom_tpu_torch.ops import plane_march as pm

    st, ops = _planes_case(cuda, density_scale, image=256, ncoeff=ncoeff, relu=not abs_field,
                           tile_px=tile_px)
    assert ops[2].shape[1] == tile_px ** 2
    cells = PLANE_BUCKET_CELLS[plan]
    if cells is not None:
        real = pm.plane_backward_plan
        monkeypatch.setattr(pm, "plane_backward_plan", lambda R, nc: real(R, nc)._replace(
            cells=cells, smem=real(R, nc).smem - (real(R, nc).cells - cells) * 4 * 17))
    kw = dict(ncoeff=st.ncoeff, relu_sigma=relu, exit_eps=exit_eps, with_diffuse=True)
    out = pm.plane_march_render_plain(*ops, **kw)
    gout = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(3),
                       device=cuda)
    stats = torch.zeros(4, dtype=torch.int64, device=cuda)
    before = pm.plane_march_grad.launches
    dg = pm.plane_march_grad(*ops, out, gout, **kw, stats=stats)
    torch.cuda.synchronize()
    assert pm.plane_march_grad.launches - before == 1
    dg_plain = pm.plane_march_grad_plain(*ops, out, gout, **kw)
    scale = float(dg_plain.abs().max())
    assert scale > 0.0 and float((dg - dg_plain).abs().max()) <= 1e-4 * scale
    assert _cosine(dg, dg_plain) > 0.99999
    cast = (dg.to(torch.bfloat16).float() - dg_plain.to(torch.bfloat16).float()).abs().max()
    assert float(cast) <= scale * 2.0 ** -8
    products, atomics, summed, direct = stats.tolist()
    assert products > 0 and summed > 0, stats.tolist()
    if cells is None:
        assert direct == 0 and atomics * 4 < products, stats.tolist()
    else:
        assert direct > 0, stats.tolist()


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_plane_march_grad_adds_into_dgrid(device, request):
    """plane_march_grad with ``dgrid=``: it adds the cotangent into the given
    tensor and returns that tensor (on the card the kernel alone, the
    zeroing left to the caller): the fresh cotangent plus what the tensor
    held, exactly on the CPU and within K12's 1e-4 of the largest element
    on the card; a tensor of another shape, dtype or layout is refused, and
    so is a ``stats`` tensor of another dtype or size."""
    from thr3ed_atom_tpu_torch.ops import plane_march as pm

    dev = request.getfixturevalue("cuda") if device == "cuda" else torch.device("cpu")
    st, ops = _planes_case(dev, size=32, image=64)
    kw = dict(ncoeff=st.ncoeff, relu_sigma=True, exit_eps=1e-4, with_diffuse=True)
    out = pm.plane_march_render_plain(*ops, **kw)
    gen = torch.Generator(device=dev).manual_seed(5)
    gout = torch.randn(out.shape, generator=gen, device=dev)
    fresh = pm.plane_march_grad(*ops, out, gout, **kw)
    base = torch.randn(fresh.shape, generator=gen, device=dev)
    held = base.clone()
    got = pm.plane_march_grad(*ops, out, gout, **kw, dgrid=held)
    assert got is held
    scale = float(fresh.abs().max())
    assert scale > 0.0
    gap = float((got - (base + fresh)).abs().max())
    assert gap == 0.0 if device == "cpu" else gap <= 1e-4 * scale
    for bad in (held[:-1], held.to(torch.float64), held.transpose(1, 2)):
        with pytest.raises(ValueError, match="dgrid"):
            pm.plane_march_grad(*ops, out, gout, **kw, dgrid=bad)
    for bad in (torch.zeros(4, dtype=torch.int32, device=dev),
                torch.zeros(3, dtype=torch.int64, device=dev)):
        with pytest.raises(ValueError, match="stats"):
            pm.plane_march_grad(*ops, out, gout, **kw, stats=bad)


@pytest.mark.parametrize("R", [64, 256])
@pytest.mark.parametrize("ncoeff", [1, 4, 9])
def test_plane_backward_plan_fits(R, ncoeff):
    """On the CPU: K12's launch plan for tiles of 64 and 256 rays at SH
    degrees 0-2: K10's plan (test_slab_backward_plan_fits) on the planes
    patch, buckets of min(2 R, 17 x 25) cells, so that a 256-ray tile's
    every position step fits (its taps have corners in at most the 17 x 25
    cells of the [16, 24] patch), at most 227 KB, and at least two blocks
    an SM by shared memory beside the kernel's static tables (tile order,
    boxes, counts: under 2 KB)."""
    from thr3ed_atom_tpu_torch.ops import plane_march as pm
    from thr3ed_atom_tpu_torch.ops import slab_march as sm

    plan = pm.plane_backward_plan(R, ncoeff)
    assert plan == sm.slab_backward_plan(R, ncoeff, (pm.PU, pm.PV))
    assert plan.threads == R
    assert plan.ch % 4 == 0 and 3 * ncoeff + 1 <= plan.ch < 3 * ncoeff + 5
    assert plan.cells == min(2 * R, (pm.PU + 1) * (pm.PV + 1))
    assert R == 64 or plan.cells == (pm.PU + 1) * (pm.PV + 1)
    assert plan.smem == R * plan.ch * 4 + R * 16 + plan.cells * (1 + sm.BACKWARD_BUCKET) * 4
    assert plan.smem <= 227 * 1024 and 2 * (plan.smem + 2048 + 1024) <= 228 * 1024


@pytest.mark.gpu
@pytest.mark.parametrize("tile_px", [16, 8])
@pytest.mark.parametrize("relu,exit_eps,density_scale,ncoeff,abs_field", MARCH_CASES)
def test_plane_march_kernel_table_cases(cuda, relu, exit_eps, density_scale, ncoeff,
                                        abs_field, tile_px):
    """K11 on tiles of 256 and 64 rays (16 and 8 pixels) at every
    MARCH_CASES case, against its plain version with the bound of
    test_plane_march_kernels_match_plain (max-abs 1e-6): as they come, with
    empty and single-entry tiles, and with an exit at the first entry."""
    from thr3ed_atom_tpu_torch.ops import plane_march as pm

    st, ops = _planes_case(cuda, density_scale, ncoeff=ncoeff, relu=not abs_field,
                           tile_px=tile_px)
    assert ops[2].shape[1] == tile_px ** 2
    kw = dict(ncoeff=st.ncoeff, relu_sigma=relu, exit_eps=exit_eps, with_diffuse=True)
    got = pm.plane_march_render(*ops, **kw)
    torch.cuda.synchronize()
    assert float((got - pm.plane_march_render_plain(*ops, **kw)).abs().max()) <= 1e-6
    _march_table_cases(pm.plane_march_render, pm.plane_march_render_plain, ops, kw)


@pytest.mark.gpu
def test_planes_render_and_repack_gradient_kernels_match_plain(cuda):
    """render_image_planes through K11 against the plain render (max-abs
    1e-6); the gradient of sum(out[..., :4]^2) through repack_plane_grid and
    plane_march with the kernels (K11, K12) against the plain versions':
    cosine > 0.99999 for the densities and the features."""
    from thr3ed_atom_tpu_torch.ops import plane_march as pm
    from thr3ed_atom_tpu_torch.rendering import planes as pl
    from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
    from thr3ed_atom_tpu_torch.utils.camera import CameraBounds, CameraIntrinsics

    config = SHVoxGridRenderConfig(num_samples_per_ray=64, camera_bounds=CameraBounds(1.0, 6.0),
                                   white_bkgd=True, perturb_sampled_points=False)
    pose = pose_spherical(140.0, -30.0, 3.5)
    intr = CameraIntrinsics(120, 120, 132.0)
    tgrid = _grid(64, device=cuda)
    got = pl.render_image_planes(tgrid, pose, intr, config)
    want = pl.render_image_planes(tgrid, pose, intr, config, plain=True)
    assert float((got.colour - want.colour).abs().max()) <= 1e-6
    st, (tables, counts, rf, _) = _planes_case(cuda)
    kw = dict(ncoeff=st.ncoeff, relu_sigma=st.relu_sigma, exit_eps=0.0)
    grads = []
    for plain in (False, True):
        g = _grid(64, device=cuda)
        g.densities.requires_grad_(True)
        g.features.requires_grad_(True)
        out = pm.plane_march(tables, counts, rf, pl.repack_plane_grid(g, st), plain=plain, **kw)
        (out[..., :4] ** 2).sum().backward()
        grads.append((g.densities.grad, g.features.grad))
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all()) and float(b.abs().max()) > 0.0
        assert _cosine(a, b) > 0.99999


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,N,K,same", [
    (128, 128, 300, 8, False), (256, 128, 1024, 4, False), (128, 256, 64, 1, False),
    (512, 128, 65536, 8, False), (100, 6, 333, 3, False), (4096, 128, 20000, 8, False),
    (64, 70, 500, 32, False), (512, 128, 4096, 8, True), (128, 128, 1, 8, False),
    (1024, 128, 5000, 8, False), (512, 128, 1 << 20, 1, False), (800, 128, 5000, 8, False),
    (1600, 128, 5000, 8, False), (1601, 70, 5000, 8, False)])
def test_onehot_kernels_match_plain(cuda, B, C, N, K, same):
    """K13 (weighted one-hot gather) and K14 (its scatter-add adjoint) against
    their plain versions, with indices at -1, B and B + 7 among them (they
    contribute nothing). K14's branches: 64-channel shared-memory slices (B
    <= 800, C > 32; B = 800 at the edge), 32-channel ones (C = 6; B = 1024;
    B = 1600 at the edge), and past shared memory (B = 1601, B = 4096:
    global atomics); K13 (one path: a warp a row over 128 channels, the
    table rows from device memory) at C = 6, 70 (lanes past C masked), 128
    and 256 (two channel slices); rows with and without repeated indices;
    K = 1 at N = 2^20 (the shape of the weights' cotangent, where K13
    merges nothing); K = 32, C = 70 (not a multiple of 4 or of a slice), N
    = 1, and every index of every row equal (the worst contention). Bounds:
    f32 sums in another order, max-abs <= 1e-5 of the largest value + 1e-6;
    K14 measured on an H100 at most 4.8e-6 of the largest value with every
    index equal (2.4e-3 of 497), 1.4e-6 elsewhere (1.8e-4 of 135 at B =
    512, N = 65,536). The autograd
    backward launches K14 once and K13 once (the weights' cotangent)."""
    from thr3ed_atom_tpu_torch.ops import onehot_gather as og

    gen = torch.Generator(device=cuda).manual_seed(5)
    table = torch.randn(B, C, generator=gen, device=cuda)
    idx = torch.randint(0, B, (N, K), generator=gen, device=cuda, dtype=torch.int32)
    if same:
        idx.fill_(B // 3)
    else:
        idx[::7, 0] = -1
        idx[3::11, -1] = B
        idx[5::13, K // 2] = B + 7
    w = torch.randn(N, K, generator=gen, device=cuda)
    g = torch.randn(N, C, generator=gen, device=cuda)
    out = og.onehot_gather_forward(table, idx, w)
    torch.cuda.synchronize()
    want = og.onehot_gather_plain(table, idx, w)
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max()) + 1e-6
    dt = og.onehot_scatter_add(idx, w, g, B)
    torch.cuda.synchronize()
    dt_want = og.onehot_scatter_add_plain(idx, w, g, B)
    print(f"K14 {(B, C, N, K, same)}: max-abs {float((dt - dt_want).abs().max()):.3g} of "
          f"{float(dt_want.abs().max()):.3g}")
    assert float((dt - dt_want).abs().max()) <= 1e-5 * float(dt_want.abs().max()) + 1e-6
    t = table.clone().requires_grad_(True)
    w_ = w.clone().requires_grad_(True)
    before = (og.onehot_gather_forward.launches, og.onehot_scatter_add.launches)
    (og.weighted_onehot_gather(t, idx, w_) * g).sum().backward()
    assert (og.onehot_gather_forward.launches - before[0],
            og.onehot_scatter_add.launches - before[1]) == (2, 1)
    assert float((t.grad - dt_want).abs().max()) <= 1e-5 * float(dt_want.abs().max()) + 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("n", [130, 512, 640])
def test_prefilter_matrix_form_on_the_card(cuda, n):
    """The B-spline prefilter's matrix form on the card (an f32 cuBLAS
    product, TF32 off) against the float64 product on the CPU: within 4e-7
    x the largest value (a few f32 ulp), along axis 0 and along the last
    axis (the matmul warp's lines); its gradient is M^T g within the same
    bound; the card's and the CPU's plain recursions agree to 1e-6."""
    gn._strict_f32()
    rng = np.random.default_rng(n)
    a = rng.uniform(0.0, 1.0, (n, 8, 24)).astype(np.float32)
    a[-(n // 5):] = 0.0  # a zero-padded tail, as the warp's second pass
    m64 = gn._bspline_prefilter_matrix64(n)
    want = (m64 @ a.reshape(n, -1).astype(np.float64)).reshape(a.shape)
    scale = np.abs(want).max()
    x = torch.from_numpy(a).to(cuda).requires_grad_(True)
    got = gn.bspline_prefilter_axis0(x)
    g = rng.normal(size=a.shape).astype(np.float32)
    got.backward(torch.from_numpy(g).to(cuda))
    torch.cuda.synchronize()
    assert np.abs(got.detach().cpu().numpy() - want).max() <= 4e-7 * scale
    g_want = (m64.T @ g.reshape(n, -1).astype(np.float64)).reshape(a.shape)
    assert np.abs(x.grad.cpu().numpy() - g_want).max() <= 4e-7 * np.abs(g_want).max()
    line = wm.prefilter_last_axis(torch.from_numpy(np.moveaxis(a, 0, -1).copy()).to(cuda))
    assert np.abs(np.moveaxis(line.cpu().numpy(), -1, 0) - want).max() <= 4e-7 * scale
    plain = gn.bspline_prefilter_axis0(torch.from_numpy(a).to(cuda), plain=True)
    cpu = gn.bspline_prefilter_axis0(torch.from_numpy(a), plain=True)
    assert float((plain.cpu() - cpu).abs().max()) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 3, 5])
def test_gather_warp_on_the_card(cuda, order):
    """The gather warp (``_warp_to_camera``, warp_impl "gather") of one
    composited state on the card against the same function on the CPU, and
    its gradient with respect to the state: outputs within 1e-4 (texel
    positions may round 1 ulp apart, ~3e-5 on this random state), gradient
    cosine > 0.9999 (order 5: > 0.999, where near-subnormal B-spline tails
    may take the other side of a clamp tie). The state has empty rows and
    columns, so the hull clamp meets ties."""
    gn._strict_f32()
    tgrid = _grid(16)
    pose = pose_spherical(140.0, -30.0, 3.5)
    rot = np.asarray(pose.rotation, np.float32).reshape(3, 3)
    org = np.asarray(pose.translation, np.float32).reshape(3)
    axis, flip = gn.dominant_axis_for_pose(rot)
    st = gn.statics_for_grid(tgrid, axis, flip, with_diffuse=True, pos_per_cell=1)
    geo = gn.gnomonic_geometry(torch.from_numpy(rot), torch.from_numpy(org), st, H, W,
                               torch.tensor(FOCAL), SS)
    Pn, Qn, _, _ = gn.gnomonic_frame(None, H, W, FOCAL, SS, st)
    rng = np.random.default_rng(5)
    state = rng.uniform(0.0, 1.0, (9, Pn, Qn)).astype(np.float32)
    state[:, : Pn // 3] = 0.0
    state[:, :, Qn // 2:] = 0.0
    g_out = torch.from_numpy(rng.normal(size=(H, W, 8)).astype(np.float32))
    outs, grads = [], []
    for dev in ("cpu", cuda):
        s = torch.from_numpy(state).to(dev).requires_grad_(True)
        out = gn._warp_to_camera(
            s, tuple(v.to(dev) for v in geo.xr), tuple(v.to(dev) for v in geo.yr),
            torch.from_numpy(rot).to(dev), st, H, W, torch.tensor(FOCAL, device=dev), SS,
            True, warp_order=order, warp_impl="gather")
        flat = torch.cat([out.colour, out.extra["accumulated_weight"], out.depth,
                          out.extra["diffuse_colour"]], -1)
        flat.backward(g_out.to(dev))
        outs.append(flat.detach().cpu())
        grads.append(s.grad.cpu())
    torch.cuda.synchronize()
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4
    assert _cosine(grads[1], grads[0]) > (0.999 if order == 5 else 0.9999)


@pytest.mark.gpu
@pytest.mark.parametrize("impl,order", [("matmul", 5), ("gather", 3), ("gather", 5)])
def test_train_step_warp_options_match_plain(cuda, impl, order):
    """One gnomonic_train_step_multi (k = 2) through warp order 5 and through
    the gather warp with the kernels, against the same step through the
    plain versions (the prefilter's row recursion included): the grid
    gradients within cosine > 0.99999, the losses within rtol 1e-5."""
    pose = pose_spherical(140.0, -30.0, 3.5)
    rot = np.asarray(pose.rotation, np.float32).reshape(3, 3)
    org = np.asarray(pose.translation, np.float32).reshape(3)
    axis, flip = gn.dominant_axis_for_pose(rot)
    images = torch.rand((2, H, W, 3), generator=torch.Generator().manual_seed(1)).to(cuda)
    grads, losses = [], []
    for plain in (False, True):
        tgrid = _grid(32, device=cuda)
        ts = gt.make_gnomonic_train_statics(tgrid, axis, flip, image_height=H, image_width=W,
                                            white_bkgd=True, pos_per_cell=2,
                                            warp_order=order, warp_impl=impl)
        opt, sched = make_gnomonic_optimizer(tgrid)
        m = gt.gnomonic_train_step_multi(ts, opt, tgrid, images, np.stack([rot] * 2),
                                         np.stack([org] * 2), FOCAL,
                                         phases=[(0.1, 0.2), (-0.3, 0.4)],
                                         scheduler=sched, plain=plain)
        torch.cuda.synchronize()
        grads.append((tgrid.densities.grad.clone(), tgrid.features.grad.clone()))
        losses.append(float(m["total_loss"]))
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all()) and _cosine(a, b) > 0.99999


# --------------------------------------------------------- ray-batch procedures


def _ray_batch_rays(n=4096, seed=0, device="cpu"):
    """Flat rays of a 64 x 64 view of ``_grid``'s scene (pose (140, -30,
    3.5)), the first 8 turned away from the box (they miss it)."""
    from thr3ed_atom_tpu_torch.rendering import rays as rays_mod
    from thr3ed_atom_tpu_torch.utils.camera import CameraIntrinsics

    flat = rays_mod.flatten_rays(rays_mod.cast_rays(
        CameraIntrinsics(64, 64, 70.0), pose_spherical(140.0, -30.0, 3.5), device="cpu"))
    idx = torch.from_numpy(np.random.default_rng(seed).permutation(len(flat))[:n])
    o, d = flat.origins[idx].clone(), flat.directions[idx].clone()
    d[:8] = -d[:8]
    return rays_mod.Rays(o.to(device), d.to(device))


def _ray_batch_config(**kw):
    from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
    from thr3ed_atom_tpu_torch.utils.camera import CameraBounds

    return SHVoxGridRenderConfig(num_samples_per_ray=128, camera_bounds=CameraBounds(1.0, 6.0),
                                 white_bkgd=True, fast_topk=32, **kw)


def _render_draws_np(procedure, config, n, seed):
    """Explicit draws (numpy, from a seed) for a render of ``n`` rays."""
    from thr3ed_atom_tpu_torch.rendering.hierarchical import hierarchical_budget

    rng = np.random.default_rng(seed)
    S = config.num_samples_per_ray
    if procedure.endswith("hierarchical"):
        sc, sf = hierarchical_budget(S)
        return dict(t_rand=rng.uniform(size=(n, sc)), u=rng.uniform(0, 1 - 1e-6, (n, sf)),
                    noise=rng.normal(size=(n, sc + sf)))
    return dict(t_rand=rng.uniform(size=(n, S)), noise=rng.normal(size=(n, S)))


@pytest.mark.gpu
@pytest.mark.parametrize("procedure", ["render_sh_voxel_grid_fast",
                                       "render_sh_voxel_grid_hierarchical"])
@pytest.mark.parametrize("cfg", [
    dict(perturb_sampled_points=False),
    dict(perturb_sampled_points=True, optimized_sampling=True, stochastic_density_noise_std=1.0,
         also_render_diffuse=True),
    dict(perturb_sampled_points=False, fast_bf16_features=True),
    dict(perturb_sampled_points=False, fast_pack_features=False),
], ids=["plain", "perturbed_noise_diffuse", "bf16_tables", "unpacked"])
def test_fast_and_hierarchical_renders_on_the_card(cuda, procedure, cfg):
    """The fast and hierarchical renders (4096 rays, 128 samples, top 32)
    of a 32^3 relu scene on the card against the same function on the CPU,
    fed the same draws, and the gradient of a seeded linear loss on the
    outputs with respect to the grid: colour and acc within 1e-4, depth
    within 1e-3 (exp and the cumsum round differently on the card; a sample
    whose weight nearly ties another may be selected on one side only), the
    rays that miss the box empty on both; gradient cosine > 0.99999 (the
    table gradients sum by f32 atomics on the card, in varying order)."""
    from thr3ed_atom_tpu_torch.rendering.renderer import RENDER_PROCEDURES

    fn = RENDER_PROCEDURES[procedure]
    config = _ray_batch_config(**cfg)
    draws = _render_draws_np(procedure, config, 4096, seed=3)
    rng = np.random.default_rng(4)
    gc = torch.from_numpy(rng.normal(size=(4096, 8)).astype(np.float32))
    outs, grads = [], []
    for dev in ("cpu", cuda):
        gn._strict_f32()
        grid = _grid(32, device=dev)
        rays = _ray_batch_rays(device=dev)
        kw = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in draws.items()}
        with grid.trainable():
            out = fn(grid, rays, config, **kw)
            parts = [out.colour, out.depth, out.extra["accumulated_weight"],
                     out.extra.get("diffuse_colour", out.colour)]
            flat = torch.cat(parts, -1)
            (flat * gc.to(dev)).sum().backward()
        outs.append(flat.detach().cpu())
        grads.append((grid.densities.grad.cpu(), grid.features.grad.cpu()))
    torch.cuda.synchronize()
    err = (outs[0] - outs[1]).abs()
    assert float(err[:, [0, 1, 2, 4, 5, 6, 7]].max()) <= 1e-4 and float(err[:, 3].max()) <= 1e-3
    if not cfg.get("stochastic_density_noise_std"):
        assert float(outs[1][:8, 4].abs().max()) == 0.0
    assert float(outs[1][:, 4].max()) > 0.5
    for a, b in zip(*grads):
        assert bool(torch.isfinite(b).all()) and _cosine(a, b) > 0.99999


@pytest.mark.gpu
@pytest.mark.parametrize("procedure", ["render_sh_voxel_grid_fast", "render_sh_voxel_grid",
                                       "render_sh_voxel_grid_hierarchical"])
def test_ray_batch_step_gradient_on_the_card(cuda, procedure):
    """One ray-batch train step (1024 rays, 128 samples, top 32, the diffuse
    regularization: fused, or the exact procedure's second render) on the
    card against the same step on the CPU with the same draws: the losses
    within rtol 1e-5, the grid gradients cosine > 0.99999."""
    from thr3ed_atom_tpu_torch.modules import trainer

    rng = np.random.default_rng(6)
    images = torch.from_numpy(rng.uniform(0, 1, (3, 48, 48, 3)).astype(np.float32))
    poses = torch.from_numpy(np.stack([np.concatenate(
        [np.asarray(p.rotation), np.asarray(p.translation)], 1) for p in (
            pose_spherical(40.0 + 60.0 * i, -30.0, 3.5) for i in range(3))]).astype(np.float32))
    statics = trainer.TrainStepStatics(
        render_config=_ray_batch_config(perturb_sampled_points=True), image_height=48,
        image_width=48, focal=52.0, ray_batch_size=1024, render_procedure=procedure)
    spec = _render_draws_np(procedure, statics.render_config, 1024, seed=7)
    diff = _render_draws_np(procedure, statics.render_config, 1024, seed=8)
    spec.pop("noise"), diff.pop("noise")
    img, pix = rng.integers(0, 3, 1024), rng.integers(0, 48 * 48, 1024)
    losses, grads = [], []
    for dev in ("cpu", cuda):
        draws = trainer.RayBatchDraws(
            torch.from_numpy(img).to(dev), torch.from_numpy(pix).to(dev),
            {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in spec.items()},
            {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in diff.items()})
        grid = _grid(32, device=dev)
        opt, sched = make_gnomonic_optimizer(grid)
        m = trainer.ray_batch_train_step(statics, opt, grid, images.to(dev), poses.to(dev),
                                         draws=draws, scheduler=sched)
        losses.append(float(m["total_loss"]))
        grads.append((grid.densities.grad.cpu(), grid.features.grad.cpu()))
    torch.cuda.synchronize()
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    for a, b in zip(*grads):
        assert bool(torch.isfinite(b).all()) and _cosine(a, b) > 0.99999


@pytest.mark.gpu
def test_prepared_cache_after_an_in_place_update_on_the_card(cuda, monkeypatch):
    """A fast model on the card: the packed tables are built once for all
    chunks and renders; an Adam step (the card's foreach update, in place)
    moves the grid's version counters, so the next render packs anew and
    equals a fresh model's render of the updated grid."""
    from thr3ed_atom_tpu_torch.modules.volumetric_model import VolumetricModel
    from thr3ed_atom_tpu_torch.rendering import fast_renderer as fast
    from thr3ed_atom_tpu_torch.rendering import renderer  # noqa: F401 (sets .prepare)
    from thr3ed_atom_tpu_torch.utils.camera import CameraIntrinsics

    calls = []
    original = fast.prepare_for_config
    monkeypatch.setattr(fast.render_sh_voxel_grid_fast, "prepare",
                        lambda g, c: calls.append(1) or original(g, c))
    grid = _grid(32, device=cuda)
    config = _ray_batch_config(perturb_sampled_points=False, parallel_rays_chunk_size=1024)
    model = VolumetricModel(grid, "render_sh_voxel_grid_fast", config, device=cuda)
    pose, intr = pose_spherical(140.0, -30.0, 3.5), CameraIntrinsics(64, 64, 70.0)
    first = model.render(pose, intr)
    model.render(pose, intr)
    assert len(calls) == 1
    opt, _ = make_gnomonic_optimizer(grid)
    with grid.trainable():
        model.render_rays(_ray_batch_rays(device=cuda), perturb_sampled_points=False
                          ).colour.mean().backward()
    opt.step()
    after = model.render(pose, intr)
    assert len(calls) == 2
    fresh = VolumetricModel(grid, "render_sh_voxel_grid_fast", config, device=cuda).render(
        pose, intr)
    torch.cuda.synchronize()
    assert torch.equal(after.colour, fresh.colour) and not torch.equal(after.colour,
                                                                      first.colour)
