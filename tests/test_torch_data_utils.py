"""The port's last small modules against the JAX package's: data/utils.py
(the image transform, the infinite batches), utils/misc.py's
check_power_of_2 and batchify, the camera-rays plot, the feedback panel's
training-time stamp, the TensorBoard event files (parsed with
tensorboardX.proto.event_pb2 beside the file tensorboardX's SummaryWriter
writes) and the NeRF-synthetic converter, on a scene each test writes
itself. Inputs are made with numpy from seeds."""
import importlib.util
import json
import struct
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_gnomonic import _one_torch_thread  # noqa: F401
from test_torch_trainer import _write_dataset

REPO = Path(__file__).resolve().parent.parent


def _records(path):
    """The payloads of a TFRecord file, each record's masked CRCs checked
    with the port's crc (so the JAX package's file checks the port's CRC)."""
    from thr3ed_atom_tpu_torch.utils.tensorboard import masked_crc32c

    data, out, i = Path(path).read_bytes(), [], 0
    while i < len(data):
        length = data[i:i + 8]
        n = struct.unpack("<Q", length)[0]
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == masked_crc32c(length)
        payload = data[i + 12:i + 12 + n]
        assert struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] == masked_crc32c(payload)
        out.append(payload)
        i += 16 + n
    return out


def _scalars(path):
    """[(step, tag, value)] of an event file, and its file_version."""
    from tensorboardX.proto import event_pb2

    events = []
    for payload in _records(path):
        e = event_pb2.Event()
        e.ParseFromString(payload)
        events.append(e)
    assert events[0].file_version == "brain.Event:2"
    return [(e.step, v.tag, v.simple_value) for e in events[1:] for v in e.summary.value]


def test_image_transform_and_batches_match_jax(tmp_path):
    """get_image_transform on 8-bit RGB, RGBA and grey images (flipped or
    not, resized down, up and to the same size) equals the JAX package's
    PIL transform array for array; infinite_batches fed the JAX generator's
    draws yields its batches, and from a torch.Generator batches of the
    right shapes drawn over every view."""
    from PIL import Image

    from thr3ed_atom_tpu.data import utils as du_jax
    from thr3ed_atom_tpu.data.dataset import PosedImagesDataset as JaxDataset
    from thr3ed_atom_tpu_torch.data import utils as du
    from thr3ed_atom_tpu_torch.data.dataset import PosedImagesDataset

    rng = np.random.default_rng(0)
    for shape in ((37, 29, 3), (20, 24, 4), (16, 18)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        for size in (None, (11, 13), (48, 40), shape[:2]):
            for flip in (False, True):
                want = du_jax.get_image_transform(size, flip)(Image.fromarray(img))
                got = du.get_image_transform(size, flip)(img)
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, want, err_msg=f"{shape} {size} {flip}")
    data = _write_dataset(tmp_path / "data", n_train=5, n_test=1, size=8)
    args = (data / "train", data / "train_camera_params.json")
    ds_j, ds_t = JaxDataset(*args), PosedImagesDataset(*args)
    it_j = du_jax.infinite_batches(jax.random.PRNGKey(3), ds_j, 4)
    key, draws = jax.random.PRNGKey(3), []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.randint(sub, (4,), 0, 5)))
    for (img_t, pose_t), (img_j, pose_j) in zip(du.infinite_batches(None, ds_t, 4, draws),
                                                it_j):
        np.testing.assert_array_equal(img_t, img_j)
        np.testing.assert_array_equal(pose_t, pose_j)
    gen = torch.Generator().manual_seed(0)
    batches = du.infinite_batches(gen, ds_t, 3)
    seen = set()
    for _ in range(20):
        images, poses = next(batches)
        assert images.shape == (3, 8, 8, 3) and poses.shape == (3, 3, 4)
        seen |= {int(np.argmax([np.array_equal(p, q) for q in ds_t.poses])) for p in poses}
    assert seen == set(range(5))


def test_misc_helpers_match_jax():
    """check_power_of_2 on 0-1025 and batchify's chunked map (chunks of 3 of
    10, one chunk, chunk size None, verbose) equal the JAX package's."""
    from thr3ed_atom_tpu.utils import misc as misc_jax
    from thr3ed_atom_tpu_torch.utils import misc

    for x in range(1026):
        assert misc.check_power_of_2(x) == misc_jax.check_power_of_2(x)
    calls = []

    def proc(x):
        calls.append(len(x))
        return [v * v for v in x]

    def collate(parts):
        return [v for p in parts for v in p]

    for chunk in (3, 10, 20, None):
        for verbose in (False, True):
            calls.clear()
            got = misc.batchify(proc, collate, chunk, verbose=verbose)(list(range(10)))
            n_port = list(calls)
            calls.clear()
            want = misc_jax.batchify(proc, collate, chunk)(list(range(10)))
            assert got == want and n_port == calls


class _Axes:
    def __init__(self, record):
        self.record = record

    def plot(self, x, y, z, color):
        self.record.append(np.stack([x, y, z], -1))

    def scatter(self, x, y, z, color):
        self.record.append(("cameras", np.stack([x, y, z], -1)))


class _Figure:
    def __init__(self, record):
        self.record = record

    def suptitle(self, text):
        pass

    def add_subplot(self, *a, **kw):
        return _Axes(self.record)


@pytest.mark.parametrize("ndc", [False, True])
def test_camera_rays_plot_matches_jax(tmp_path, monkeypatch, ndc):
    """visualize_camera_rays draws the JAX package's plot: with numpy's
    global generator seeded alike, every ray segment and the camera
    locations equal the JAX package's within 1e-6 (recorded through a stand-in
    figure), with and without the NDC map; a real run writes
    casted_camera_rays.png."""
    from matplotlib import pyplot as plt

    from thr3ed_atom_tpu.data.dataset import PosedImagesDataset as JaxDataset
    from thr3ed_atom_tpu.visualizations import static as st_jax
    from thr3ed_atom_tpu_torch.data.dataset import PosedImagesDataset
    from thr3ed_atom_tpu_torch.visualizations import static as st

    data = _write_dataset(tmp_path / "data", n_train=3, n_test=1, size=8)
    args = (data / "train", data / "train_camera_params.json")
    records = []
    for mod, ds in ((st_jax, JaxDataset(*args)), (st, PosedImagesDataset(*args))):
        rec = []
        monkeypatch.setattr(plt, "figure", lambda rec=rec: _Figure(rec))
        for name in ("savefig", "tight_layout", "close"):
            monkeypatch.setattr(plt, name, lambda *a, **kw: None)
        np.random.seed(4)
        mod.visualize_camera_rays(ds, tmp_path, num_rays_per_image=5, do_ndcize_rays=ndc)
        records.append(rec)
    monkeypatch.undo()
    assert len(records[0]) == len(records[1]) == 3 * 5 + 1
    for a, b in zip(*records):
        if isinstance(a, tuple):
            a, b = a[1], b[1]
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6, atol=1e-6)
    if not ndc:
        st.visualize_camera_rays(PosedImagesDataset(*args), tmp_path, num_rays_per_image=2)
        assert (tmp_path / "casted_camera_rays.png").stat().st_size > 0


def test_feedback_panel_time_stamp_matches_jax():
    """process_rendered_output_for_feedback_log with a training time draws
    the JAX package's stamp (PIL's ImageDraw here, anti-aliased over the
    panel): the colour and acc thirds of the panel equal byte for byte with
    and without the stamp, which starts in the colour third; the depth third
    within 4 levels (the port's own magma table,
    tests/test_torch_dataset.py's bound)."""
    import jax.numpy as jnp

    from thr3ed_atom_tpu.rendering.interface import RenderOut as JaxOut
    from thr3ed_atom_tpu.visualizations import static as st_jax
    from thr3ed_atom_tpu_torch.rendering.interface import RenderOut
    from thr3ed_atom_tpu_torch.visualizations import static as st

    rng = np.random.default_rng(2)
    w = 40  # square, as the renders
    colour = rng.random((w, w, 3), dtype=np.float32)
    depth = rng.uniform(2, 6, (w, w, 1)).astype(np.float32)
    acc = rng.random((w, w, 1), dtype=np.float32)
    out_j = JaxOut(jnp.asarray(colour), jnp.asarray(depth),
                   {"accumulated_weight": jnp.asarray(acc)})
    out_t = RenderOut(torch.from_numpy(colour), torch.from_numpy(depth),
                      {"accumulated_weight": torch.from_numpy(acc)})
    panels = {}
    for t in (None, 3723.5):
        panels[t] = (st.process_rendered_output_for_feedback_log(out_t, t),
                     st_jax.process_rendered_output_for_feedback_log(out_j, t))
    for got, want in panels.values():
        assert got.shape == want.shape == (w, 3 * w, 3) and got.dtype == want.dtype
        for third in (slice(0, w), slice(2 * w, 3 * w)):
            np.testing.assert_array_equal(got[:, third], want[:, third])
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 4
    # the stamp starts in the colour third (held equal above, stamp included)
    assert (panels[3723.5][0][:, :w] != panels[None][0][:, :w]).any()


def test_event_files_match_tensorboardx(tmp_path):
    """The port's event writer against tensorboardX's SummaryWriter fed the
    same scalars (steps 0-300, negative and large values, a unicode tag):
    both files parse with event_pb2, every record's masked CRC32C checks
    with the port's crc, and the (step, tag, value) sequences are equal; a
    trainer run writes training_logs/tensorboard/ with the scalars of its
    summaries.jsonl."""
    from tensorboardX import SummaryWriter

    from thr3ed_atom_tpu_torch.utils.tensorboard import EventFileWriter, crc32c

    assert crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    scalars = [(step, tag, value) for step in (0, 1, 7, 300)
               for tag, value in (("total_loss", 0.25 + step), ("PSNR dB", -3.5e7 / (step + 1)),
                                  ("τ", 1e-30))]
    writer_j = SummaryWriter(str(tmp_path / "jax"))
    writer_t = EventFileWriter(tmp_path / "port")
    for step, tag, value in scalars:
        writer_j.add_scalar(tag, value, global_step=step)
        writer_t.add_scalar(tag, value, step)
    writer_j.close()
    (file_j,) = (tmp_path / "jax").glob("events.out.tfevents.*")
    (file_t,) = (tmp_path / "port").glob("events.out.tfevents.*")
    got, want = _scalars(file_t), _scalars(file_j)
    assert got == want and len(got) == len(scalars)

    from thr3ed_atom_tpu_torch.data.dataset import PosedImagesDataset
    from thr3ed_atom_tpu_torch.modules import trainer
    from thr3ed_atom_tpu_torch.modules.volumetric_model import VolumetricModel
    from thr3ed_atom_tpu_torch.models.voxels import VoxelSize, create_voxel_grid
    from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
    from thr3ed_atom_tpu_torch.utils.camera import CameraBounds

    data = _write_dataset(tmp_path / "data", n_train=2, n_test=1, size=8)
    grid = create_voxel_grid(torch.Generator().manual_seed(0), (8, 8, 8), 27,
                             VoxelSize(0.25, 0.25, 0.25))
    model = VolumetricModel(grid, "render_sh_voxel_grid_fast",
                            SHVoxGridRenderConfig(num_samples_per_ray=8, fast_topk=4,
                                                  camera_bounds=CameraBounds(1.5, 4.5)),
                            device="cpu")
    trainer.train_sh_vox_grid_vol_mod_with_posed_images(
        model, PosedImagesDataset(data / "train", data / "train_camera_params.json"),
        tmp_path / "out", ray_batch_size=32, num_stages=1, num_iterations_per_stage=2,
        summary_freq=1, fast_debug_mode=True)
    logs = tmp_path / "out" / "training_logs"
    (events,) = (logs / "tensorboard").glob("events.out.tfevents.*")
    jsonl = [json.loads(line) for line in (logs / "summaries.jsonl").read_text().splitlines()]
    assert _scalars(events) == [(r["step"], r["name"], np.float32(r["value"]).item())
                                for r in jsonl]


def test_blender_converter_matches_the_repository_tool(tmp_path):
    """The port's converter (argparse, data/png.py) on a NeRF-synthetic
    scene written here (transforms_{train,val,test}.json, 8-bit RGBA PNGs of
    24 x 20 pixels) writes the camera-params JSON files of the repository's
    click / PIL tool, equal as parsed JSON; the port reads them back."""
    from click.testing import CliRunner

    from thr3ed_atom_tpu_torch.data.dataset import PosedImagesDataset
    from thr3ed_atom_tpu_torch.data.png import write_png
    from thr3ed_atom_tpu_torch.tools import convert_from_nerf_blender_dataset as conv

    rng = np.random.default_rng(1)
    scene = tmp_path / "scene"
    for split, n in (("train", 3), ("val", 2), ("test", 2)):
        (scene / split).mkdir(parents=True)
        frames = []
        for i in range(n):
            write_png(scene / split / f"r_{i}.png",
                      rng.integers(0, 256, (20, 24, 4)).astype(np.uint8))
            m = np.eye(4)
            m[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            m[:3, 3] = rng.normal(size=3) * 4.0
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": m.tolist()})
        (scene / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": 0.6911112070083618, "frames": frames}))
    spec = importlib.util.spec_from_file_location(
        "repo_convert", REPO / "tools" / "convert_from_nerf_blender_dataset.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    result = CliRunner().invoke(tool.main, ["-d", str(scene), "-o", str(tmp_path / "jax")])
    assert result.exit_code == 0, result.output
    conv.main(["-d", str(scene), "-o", str(tmp_path / "port")])
    for split in ("train", "val", "test"):
        name = f"{split}_camera_params.json"
        got = json.loads((tmp_path / "port" / name).read_text())
        want = json.loads((tmp_path / "jax" / name).read_text())
        assert got == want and len(got) == len(json.loads(
            (scene / f"transforms_{split}.json").read_text())["frames"])
    ds = PosedImagesDataset(scene / "train", tmp_path / "port" / "train_camera_params.json")
    assert ds.images.shape == (3, 20, 24, 3)
