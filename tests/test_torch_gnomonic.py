"""The PyTorch port's gnomonic march against the JAX package: statics, frame,
geometry, occupancy, the vertex repack and the fused composite (K1).

CPU tests run the port's plain versions against the JAX functions (the fused
Pallas kernel in interpret mode) on a carved 16^3 relu scene, 128 x 128 images
and Qn = 256 (two q-blocks). tests/test_torch_kernels.py holds the CUDA
composite against the same plain version on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thr3ed_atom_tpu.models.voxels import VoxelGrid as JaxVoxelGrid, VoxelSize
from thr3ed_atom_tpu.rendering import gnomonic as gn_jax
from thr3ed_atom_tpu_torch.models.voxels import voxel_grid_from_numpy
from thr3ed_atom_tpu_torch.rendering import gnomonic as gn
from thr3ed_atom_tpu_torch.utils.camera import pose_spherical

H = W = 128
FOCAL = 140.0
SS = 1.25


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker processes
    at once, and PyTorch's idle OpenMP threads spinning in each of them starve
    the others (the plain path issues many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(size=16, seed=3, ncoeff=9):
    """Numpy arrays of a relu scene carved to a ball (density -1 outside), the
    recipe of tests/test_gnomonic.py's q-split test, made from a seed."""
    rng = np.random.default_rng(seed)
    densities = rng.uniform(-2.0, 4.0, (size,) * 3 + (1,)).astype(np.float32)
    coords = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing="ij"), -1)
    dist = np.linalg.norm(coords - (size - 1) / 2, axis=-1, keepdims=True)
    densities = np.where(dist < size / 4, densities, -1.0).astype(np.float32)
    features = (rng.normal(size=(size,) * 3 + (3 * ncoeff,)) * 0.4).astype(np.float32)
    config = dict(voxel_size=(2.0 / size,) * 3, grid_location=(0.0, 0.0, 0.0),
                  density_preactivation="identity", density_postactivation="relu",
                  feature_preactivation="identity", feature_postactivation="identity",
                  expected_density_scale=1.0, radiance_transfer_function=None)
    return densities, features, config


def _grids(size=16, seed=3):
    d, f, config = _scene(size, seed)
    jgrid = JaxVoxelGrid(densities=jnp.asarray(d), features=jnp.asarray(f),
                         voxel_size=VoxelSize(*config["voxel_size"]),
                         density_preactivation="identity",
                         density_postactivation="relu")
    tgrid = voxel_grid_from_numpy(d, f, config, device="cpu")
    return jgrid, tgrid


def _pose_arrays(yaw, pitch, radius=3.5):
    pose = pose_spherical(yaw, pitch, radius)
    rot = np.asarray(pose.rotation, np.float32).reshape(3, 3)
    org = np.asarray(pose.translation, np.float32).reshape(3)
    return pose, rot, org


def _variant(jgrid, tgrid, rot, P, diffuse=False, exit_eps=0.0):
    axis, flip = gn.dominant_axis_for_pose(rot)
    sj = gn_jax.statics_for_grid(jgrid, axis, flip, with_diffuse=diffuse,
                                 pos_per_cell=P, exit_eps=exit_eps,
                                 interpret=True, qb=128)
    st = gn.statics_for_grid(tgrid, axis, flip, with_diffuse=diffuse,
                             pos_per_cell=P, exit_eps=exit_eps, qb=128)
    return sj, st


@pytest.mark.parametrize("yaw,pitch", [(140.0, -30.0), (35.0, -70.0)])
def test_statics_frame_repack_occupancy_match_jax(yaw, pitch):
    """Statics, frame and supersample are equal; the repack is bitwise equal in
    bf16; geom and the frame ranges agree to f32 ulp scale; the occupancy
    flags from the same geom are exactly equal."""
    jgrid, tgrid = _grids()
    pose, rot, org = _pose_arrays(yaw, pitch)
    for P in (1, 2, 0):
        sj, st = _variant(jgrid, tgrid, rot, P)
        assert tuple(getattr(st, f) for f in gn.GnomonicStatics._fields if f != "exit_eps") \
            == tuple(getattr(sj, f) for f in gn.GnomonicStatics._fields if f != "exit_eps")
    assert gn.frame_rounding(H, W, SS, st) == gn_jax.frame_rounding(H, W, SS, sj)
    assert gn.gnomonic_frame(None, H, W, FOCAL, SS, st) == \
        gn_jax.gnomonic_frame(None, H, W, FOCAL, SS, sj)
    assert gn.effective_supersample(SS, st, H, W) == gn_jax.effective_supersample(SS, sj, H, W)
    assert gn.effective_supersample(1.0, st, 24, 32) == gn_jax.effective_supersample(1.0, sj, 24, 32)

    s_j = np.asarray(gn_jax.repack_position_slices(jgrid, sj, True, True).astype(jnp.float32))
    s_t = gn.repack_position_slices(tgrid, st)
    assert s_t.dtype == torch.bfloat16 and s_t.permute(0, 1, 3, 2).is_contiguous()
    np.testing.assert_array_equal(s_t.float().numpy(), s_j)

    Pn, Qn, PB, Pb = gn.gnomonic_frame(None, H, W, FOCAL, SS, st)
    QB, Qb = gn._qb_blocks(st, Qn)
    assert (Pn, Qn, QB, Qb) == (256, 256, 2, 128)
    geo_j = gn_jax.gnomonic_geometry(jnp.asarray(rot), jnp.asarray(org), sj, H, W,
                                     jnp.float32(FOCAL), SS, lite=True, skip_basis=True)
    geo_t = gn.gnomonic_geometry(torch.from_numpy(rot), torch.from_numpy(org), st, H, W,
                                 torch.tensor(FOCAL), SS)
    gj = np.asarray(geo_j.geom)
    np.testing.assert_allclose(geo_t.geom.numpy(), gj, rtol=2e-6, atol=2e-6)
    for a, b in zip(geo_t.xr + geo_t.yr, geo_j.xr + geo_j.yr):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-7)

    occ_j = gn_jax.gnomonic_occupancy_lite(jnp.asarray(s_j).astype(jnp.bfloat16),
                                           jnp.asarray(gj), sj, Pn, Qn, PB, Pb, QB, Qb)
    occ_t = gn.gnomonic_occupancy_lite(s_t, torch.from_numpy(gj), st, Pn, Qn, PB,
                                       Pb, QB, Qb)
    for a, b in zip(occ_t, occ_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < int(occ_t[1].sum()) < occ_t[1].numel()  # some skipping happens


@pytest.mark.parametrize(
    "P,diffuse,exit_eps,yaw,pitch",
    [(1, False, 0.0, 140.0, -30.0), (2, True, 0.0, 140.0, -30.0),
     (2, False, 1e-4, 35.0, -70.0), (1, True, 1e-4, 250.0, -20.0)],
)
def test_composite_plain_matches_jax(P, diffuse, exit_eps, yaw, pitch):
    """The plain composite against the JAX fused kernel (interpret mode) on the
    same slices, geom and flags, exiting at the JAX grain. The tents round
    where the reference rounds and sum two taps each, so the resampled values
    are equal; what remains is f32 round-off of exp/sigmoid and the SH fold.
    Bound: colour/acc 3e-3, depth 2e-2 (tests/test_gnomonic.py's bound between
    the JAX package's own kernels); the measured gap is printed."""
    jgrid, tgrid = _grids()
    pose, rot, org = _pose_arrays(yaw, pitch)
    sj, st = _variant(jgrid, tgrid, rot, P, diffuse, exit_eps)
    Pn, Qn, PB, Pb = gn.gnomonic_frame(None, H, W, FOCAL, SS, st)
    QB, Qb = gn._qb_blocks(st, Qn)
    s_t = gn.repack_position_slices(tgrid, st)
    s_j = gn_jax.repack_position_slices(jgrid, sj, True, True)
    geo_j = gn_jax.gnomonic_geometry(jnp.asarray(rot), jnp.asarray(org), sj, H, W,
                                     jnp.float32(FOCAL), SS, lite=True, skip_basis=True)
    occ_j = gn_jax.gnomonic_occupancy_lite(s_j, geo_j.geom, sj, Pn, Qn, PB, Pb, QB, Qb)
    want = np.asarray(gn_jax.composite_positions_fused(
        s_j, None, None, geo_j.geom, sj, Pn, Qn, PB, Pb, occ_j, xr=geo_j.xr, yr=geo_j.yr))
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    got = gn.composite_positions_fused(
        s_t, None, None, t(geo_j.geom), st, Pn, Qn, PB, Pb,
        tuple(t(o) for o in occ_j), xr=tuple(map(t, geo_j.xr)),
        yr=tuple(map(t, geo_j.yr))).numpy()
    assert got.shape == want.shape == (9 if diffuse else 6, Pn, Qn)
    gap = np.abs(got - want).max(axis=(1, 2))
    print(f"composite plain vs JAX max-abs per row (T, rgb, acc, depth, ...): {gap}")
    assert gap[0] < 3e-3 and gap[1:5].max() < 3e-3 and gap[5] < 2e-2
    if diffuse:
        assert gap[6:].max() < 3e-3
    assert float(want[4].max()) > 0.5  # the scene is really hit
