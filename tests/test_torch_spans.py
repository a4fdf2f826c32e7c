"""The port's spans (utils/profiling.py ``span``): one shared no-op with no
profiler recording, and under ``torch.profiler`` the ``t3.`` ranges that the
benchmark's span metrics read, counted and nested as the train step and the
render path emit them. CPU tests on a small carved relu scene through the
plain versions."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from thr3ed_atom_tpu_torch.models.voxels import voxel_grid_from_numpy
from thr3ed_atom_tpu_torch.modules.trainer import make_gnomonic_optimizer
from thr3ed_atom_tpu_torch.rendering import gnomonic as gn
from thr3ed_atom_tpu_torch.rendering import gnomonic_train as gt
from thr3ed_atom_tpu_torch.utils import profiling
from thr3ed_atom_tpu_torch.utils.camera import CameraIntrinsics, pose_spherical

H = W = 32
FOCAL = 36.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(size=8, seed=5):
    rng = np.random.default_rng(seed)
    densities = rng.uniform(-2.0, 4.0, (size,) * 3 + (1,)).astype(np.float32)
    coords = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing="ij"), -1)
    dist = np.linalg.norm(coords - (size - 1) / 2, axis=-1, keepdims=True)
    densities = np.where(dist < size / 3, densities, -1.0).astype(np.float32)
    features = (rng.normal(size=(size,) * 3 + (27,)) * 0.4).astype(np.float32)
    config = dict(voxel_size=(2.0 / size,) * 3, grid_location=(0.0, 0.0, 0.0),
                  density_preactivation="identity", density_postactivation="relu",
                  feature_preactivation="identity", feature_postactivation="identity",
                  expected_density_scale=1.0, radiance_transfer_function=None)
    return voxel_grid_from_numpy(densities, features, config, device="cpu")


def _pose(yaw, pitch=-30.0):
    pose = pose_spherical(yaw, pitch, 3.5)
    rot = np.asarray(pose.rotation, np.float32).reshape(3, 3)
    return pose, rot, np.asarray(pose.translation, np.float32).reshape(3)


def _spans(prof):
    """The t3. ranges of a trace: [(name, start us, end us)]."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("t3.")]


def _counts(spans):
    out = {}
    for name, _, _ in spans:
        out[name] = out.get(name, 0) + 1
    return out


def _inside(spans, root):
    (r0, r1), = [(s, e) for n, s, e in spans if n == root]
    return all(r0 <= s and e <= r1 for _, s, e in spans)


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    """No profiler recording: every span is one shared object and entering
    it never reaches record_function."""
    def refuse(name):
        raise AssertionError(f"record_function({name}) entered with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    a, b = profiling.span("step"), profiling.span("warp")
    assert a is b
    with a, b:
        pass


def test_span_under_a_profiler_records_a_t3_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("repack"):
            torch.ones(4).sum()
    assert _counts(_spans(prof)) == {"t3.repack": 1}


def _train_case(k):
    grid = _grid()
    poses = [_pose(70.0), _pose(80.0)][:k]
    axis, flip = gn.dominant_axis_for_pose(poses[0][1])
    assert all(gn.dominant_axis_for_pose(p[1]) == (axis, flip) for p in poses)
    tstat = gt.make_gnomonic_train_statics(grid, axis, flip, image_height=H, image_width=W,
                                           white_bkgd=True, pos_per_cell=1)
    opt, sched = make_gnomonic_optimizer(grid, 0.01)
    images = torch.rand((k, H, W, 3), generator=torch.Generator().manual_seed(0))
    return grid, tstat, opt, sched, images, poses


def test_train_step_multi_emits_the_phase_spans():
    """A k = 2 gnomonic_train_step_multi: one step, a repack and its
    backward, each pose's geometry, composite, warp and backward, one
    optimizer span, all inside t3.step."""
    grid, tstat, opt, sched, images, poses = _train_case(2)
    rots = np.stack([p[1] for p in poses])
    orgs = np.stack([p[2] for p in poses])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gt.gnomonic_train_step_multi(tstat, opt, grid, images, rots, orgs, FOCAL,
                                     phases=[(0.1, -0.2), (-0.3, 0.2)], scheduler=sched)
    spans = _spans(prof)
    assert _counts(spans) == {"t3.step": 1, "t3.repack": 2, "t3.geometry": 2,
                              "t3.composite": 2, "t3.warp": 2, "t3.backward": 2,
                              "t3.optimizer": 1}
    assert _inside(spans, "t3.step")


def test_single_pose_train_step_emits_the_phase_spans():
    """gnomonic_train_step: the repack before the pose, its backward inside
    t3.backward, one span of each phase inside t3.step."""
    grid, tstat, opt, sched, images, ((_, rot, org),) = _train_case(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gt.gnomonic_train_step(tstat, opt, grid, images[0], rot, org, FOCAL,
                               phase=(0.1, -0.2), scheduler=sched)
    spans = _spans(prof)
    assert _counts(spans) == {"t3.step": 1, "t3.repack": 1, "t3.geometry": 1,
                              "t3.composite": 1, "t3.warp": 1, "t3.backward": 1,
                              "t3.optimizer": 1}
    assert _inside(spans, "t3.step")


def test_render_poses_emits_the_frame_spans():
    """A 2-pose render_poses_gnomonic: one path, a frame per pose, each with
    its geometry, composite and warp, the repack nested in the first
    frame's geometry (a cache miss); all inside t3.path."""
    grid = _grid()
    poses = [_pose(70.0)[0], _pose(80.0)[0]]
    config = SimpleNamespace(white_bkgd=True, gnomonic_pos_per_cell=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = gn.render_poses_gnomonic(grid, poses, CameraIntrinsics(H, W, FOCAL), config)
    assert out.colour.shape == (2, H, W, 3)
    spans = _spans(prof)
    assert _counts(spans) == {"t3.path": 1, "t3.frame": 2, "t3.geometry": 2,
                              "t3.composite": 2, "t3.warp": 2, "t3.repack": 1}
    assert _inside(spans, "t3.path")
    (r0, r1), = [(s, e) for n, s, e in spans if n == "t3.repack"]
    first = min((s, e) for n, s, e in spans if n == "t3.geometry")
    assert first[0] <= r0 and r1 <= first[1]
