"""The gnomonic pose pipeline without host syncs: the pose operands staged
for the device (``gnomonic.stage_f32``), the image corners made on the device
(``_corner_ranges``) and K3's scratch sized by the frame's worst case
(``gnomonic_train.fold_records_capacity``). This file imports nothing of JAX,
so its ``gpu`` case also runs on the card's machine:

    python -m pytest --noconftest -m gpu tests/test_torch_pose_staging.py

On the CPU the staged operands are the blocking copies' values bit for bit,
the corner ranges repeat bit for bit, and the worst case bounds the flags'
counts; on a card one train step and one render path run under
``torch.cuda.set_sync_debug_mode("error")``."""
import numpy as np
import pytest
import torch

from thr3ed_atom_tpu_torch.models.voxels import voxel_grid_from_numpy
from thr3ed_atom_tpu_torch.modules.trainer import make_gnomonic_optimizer
from thr3ed_atom_tpu_torch.rendering import gnomonic as gn
from thr3ed_atom_tpu_torch.rendering import gnomonic_train as gt
from thr3ed_atom_tpu_torch.utils.camera import CameraIntrinsics, pose_spherical

H = W = 64
FOCAL = 70.0
SS = 1.25


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test where there is no card (the CPU suite
    runs in several worker processes at once)."""
    if torch.cuda.is_available():
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(size=16, seed=3, device="cpu"):
    """A relu scene carved to a ball (density -1 outside), numpy from a seed."""
    rng = np.random.default_rng(seed)
    densities = rng.uniform(-2.0, 4.0, (size,) * 3 + (1,)).astype(np.float32)
    coords = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing="ij"), -1)
    dist = np.linalg.norm(coords - (size - 1) / 2, axis=-1, keepdims=True)
    densities = np.where(dist < size / 4, densities, -1.0).astype(np.float32)
    features = (rng.normal(size=(size,) * 3 + (27,)) * 0.4).astype(np.float32)
    config = dict(voxel_size=(2.0 / size,) * 3, grid_location=(0.0, 0.0, 0.0),
                  density_preactivation="identity", density_postactivation="relu",
                  feature_preactivation="identity", feature_postactivation="identity",
                  expected_density_scale=1.0, radiance_transfer_function=None)
    return voxel_grid_from_numpy(densities, features, config, device=device)


def _blocking_f32(x, dev):
    """The copy the pose operands took before staging: pageable, blocking."""
    return torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                           dtype=torch.float32).to(dev)


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.int32)


def _pose_parts():
    """Pose operands as the callers pass them: float64 and float32 numpy,
    lists, Python numbers, CPU tensors of either width, 0-d and batched."""
    rng = np.random.default_rng(11)
    rot64 = rng.normal(size=(3, 3))
    return [rot64, rot64.astype(np.float32), rng.normal(size=(4, 3)).tolist(),
            140.123456789, np.float64(0.1), torch.tensor(rng.normal(size=3)),
            torch.tensor(rng.normal(size=(2, 3, 3)), dtype=torch.float32),
            torch.tensor(2.5e-8, dtype=torch.float64), [[1e-40, -0.0, 3.0]]]


def test_staged_operands_equal_the_blocking_copies_on_the_cpu():
    """On the CPU ``stage_f32`` is the blocking copy bit for bit (dtype,
    shape, subnormals and signed zeros included), and pins nothing."""
    parts = _pose_parts()
    got = gn.stage_f32(parts, "cpu")
    assert len(got) == len(parts)
    for x, g in zip(parts, got):
        want = _blocking_f32(x, "cpu")
        assert g.dtype == torch.float32 and g.shape == want.shape and g.device == want.device
        assert torch.equal(_bits(g), _bits(want))
        assert not g.is_pinned()


def test_staged_train_step_inputs_equal_per_pose_copies():
    """The k poses' rotations, origins and focal as ``_multi_pose_grads``
    stages them (numpy, list and tensor inputs) equal per-operand copies."""
    rots = np.stack([np.asarray(pose_spherical(a, -30.0, 3.5).rotation,
                                np.float64).reshape(3, 3) for a in (10.0, 20.0, 30.0)])
    orgs = np.stack([np.asarray(pose_spherical(a, -30.0, 3.5).translation,
                                np.float64).reshape(3) for a in (10.0, 20.0, 30.0)])
    for r, o, f in ((rots, orgs, FOCAL), (rots.tolist(), orgs.tolist(), np.float64(FOCAL)),
                    (torch.tensor(rots), torch.tensor(orgs, dtype=torch.float32),
                     torch.tensor(FOCAL))):
        k = len(r)
        staged = gn.stage_f32([*(r[i] for i in range(k)), *(o[i] for i in range(k)), f], "cpu")
        want = [_blocking_f32(r[i], "cpu") for i in range(k)]
        want += [_blocking_f32(o[i], "cpu") for i in range(k)] + [_blocking_f32(f, "cpu")]
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(staged, want))


def _corner_ranges_before(rotation, height, width, focal, statics):
    """``_corner_ranges`` with its corners copied from the host, as before."""
    axis, (u_ax, v_ax) = statics.axis, gn._uv_axes(statics.axis)
    g = -1.0 if statics.flip else 1.0
    dev = rotation.device
    cx = torch.tensor([0.0, width, 0.0, width], dtype=torch.float32, device=dev)
    cy = torch.tensor([0.0, 0.0, height, height], dtype=torch.float32, device=dev)
    dirs_cam = torch.stack(
        [(cx - width / 2) / focal, -(cy - height / 2) / focal,
         -torch.ones(4, dtype=torch.float32, device=dev)], dim=-1,
    )
    d = torch.matmul(dirs_cam, rotation.T)
    x_c = g * d[:, u_ax] / d[:, axis]
    y_c = g * d[:, v_ax] / d[:, axis]
    return (x_c.min(), x_c.max()), (y_c.min(), y_c.max())


@pytest.mark.parametrize("height,width", [(64, 64), (45, 80)])
def test_corner_ranges_repeat_bit_for_bit(height, width):
    """The corners made on the device give the ranges that the host's
    corners gave, bit for bit, on every call and at two frame sizes."""
    grid = _grid()
    for yaw, pitch in ((140.0, -30.0), (33.0, -70.0)):
        rot = np.asarray(pose_spherical(yaw, pitch, 3.5).rotation, np.float32).reshape(3, 3)
        axis, flip = gn.dominant_axis_for_pose(rot)
        st = gn.statics_for_grid(grid, axis, flip, pos_per_cell=1)
        rot_t, focal = torch.from_numpy(rot), torch.tensor(FOCAL)
        want = _corner_ranges_before(rot_t, height, width, focal, st)
        for _ in range(2):
            got = gn._corner_ranges(rot_t, height, width, focal, st)
            for a, b in zip(got, want):
                assert all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("P,yaw,pitch", [(1, 140.0, -30.0), (2, 140.0, -70.0),
                                         (2, 260.0, -70.0)])
def test_fold_records_capacity_bounds_the_counts(P, yaw, pitch):
    """K3's scratch, sized on the host by the frame's worst case, holds the
    dt1 rows and edge records that ``fold_records`` counts for random flags
    (every density of needed slots), and equals the counts when every slot
    is needed; the slots' offsets stay inside it. Three march variants:
    (2, flipped), (1, not flipped), (0, flipped); two u- and two q-blocks."""
    grid = _grid()
    rot = np.asarray(pose_spherical(yaw, pitch, 3.5).rotation, np.float32).reshape(3, 3)
    axis, flip = gn.dominant_axis_for_pose(rot)
    st = gn.statics_for_grid(grid, axis, flip, pos_per_cell=P, qb=128)
    Pn, Qn, PB, Pb = gn.gnomonic_frame(None, 2 * H, 2 * W, FOCAL, SS, st)
    QB, Qb = gn._qb_blocks(st, Qn)
    assert PB == QB == 2
    NP = gn._num_positions(st)
    cap_dt1, cap_edge = gt.fold_records_capacity(st, PB, QB, Pb, Qb)
    d_size, s_size = gt._fold_slot_sizes(st, Pb, Qb)
    gen = torch.Generator().manual_seed(7 + P)
    for density in (0.0, 0.1, 0.5, 0.9, 1.0):
        flags = (torch.rand((PB, QB, NP), generator=gen) < density).to(torch.int32)
        d_off, s_off, n_dt1, n_edge = gt.fold_records(flags, st, Pb, Qb)
        assert n_dt1.dim() == 0 and n_edge.dim() == 0
        assert int(n_dt1) <= cap_dt1 and int(n_edge) <= cap_edge
        assert int(d_off.max()) + d_size <= cap_dt1 and int(s_off.max()) + s_size <= cap_edge
        if density == 1.0:
            assert (int(n_dt1), int(n_edge)) == (cap_dt1, cap_edge)


@pytest.mark.gpu
def test_pose_pipeline_runs_without_a_host_sync():
    """On a card: one ``gnomonic_train_step_multi`` (k = 2, numpy poses and a
    Python focal as the trainer passes them, the phases drawn on the device)
    and one three-pose ``render_poses_gnomonic`` raise nothing under
    ``set_sync_debug_mode("error")``, and give what the same calls give with
    the mode off, bit for bit; ``stage_f32`` sends mixed parts as the
    blocking copies would, each part 512-byte aligned."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from types import SimpleNamespace

    cuda = torch.device("cuda")
    parts = _pose_parts() + [torch.arange(5.0, device=cuda)]
    staged = gn.stage_f32(parts, cuda)
    torch.cuda.synchronize()
    for x, g in zip(parts, staged):
        want = _blocking_f32(x, cuda)
        assert g.device == want.device and g.shape == want.shape
        assert torch.equal(_bits(g), _bits(want))
    assert all(g.data_ptr() % 512 == 0 for g in staged[:-1])

    poses = [pose_spherical(140.0 + 5.0 * i, -30.0, 3.5) for i in range(3)]
    rots = np.stack([np.asarray(p.rotation, np.float32).reshape(3, 3) for p in poses[:2]])
    orgs = np.stack([np.asarray(p.translation, np.float32).reshape(3) for p in poses[:2]])
    axis, flip = gn.dominant_axis_for_pose(rots[0])
    images = torch.rand((2, H, W, 3), generator=torch.Generator().manual_seed(1)).to(cuda)
    config = SimpleNamespace(white_bkgd=True, gnomonic_pos_per_cell=1)
    intr = CameraIntrinsics(H, W, FOCAL)

    def start():
        """A grid, its train statics, optimizer and phase generator: set-up,
        whose copies from the host block, as the trainer's do."""
        grid = _grid(32, device=cuda)
        ts = gt.make_gnomonic_train_statics(grid, axis, flip, image_height=H, image_width=W,
                                            white_bkgd=True, pos_per_cell=1)
        opt, sched = make_gnomonic_optimizer(grid)
        return grid, ts, opt, sched, torch.Generator(device=cuda).manual_seed(5)

    def run(grid, ts, opt, sched, gen):
        m = gt.gnomonic_train_step_multi(ts, opt, grid, images, rots, orgs, FOCAL, gen,
                                         scheduler=sched)
        out = gn.render_poses_gnomonic(grid, poses, intr, config)
        return [*m.values(), grid.densities, grid.features, out.colour, out.depth,
                *out.extra.values()]

    want = run(*start())
    state = start()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run(*state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
