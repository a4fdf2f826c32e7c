"""LPIPS and the held-out tester of the PyTorch port against the JAX package:
the seeded fallback weights draw for draw, ``lpips`` and ``LPIPSMetric`` at
tests/test_lpips.py's 64 x 64 pairs, the converted-npz loader, and the
tester's result keys and values on a small held-out set rendered by the
exact renderer. CPU tests; inputs from numpy seeds."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thr3ed_atom_tpu.data.dataset import PosedImagesDataset as JaxDataset
from thr3ed_atom_tpu.models.voxels import VoxelGrid as JaxVoxelGrid, VoxelSize
from thr3ed_atom_tpu.modules import tester as tester_jax
from thr3ed_atom_tpu.modules.volumetric_model import VolumetricModel as JaxModel
from thr3ed_atom_tpu.rendering.renderer import SHVoxGridRenderConfig as JaxConfig
from thr3ed_atom_tpu.utils import lpips as lpips_jax
from thr3ed_atom_tpu.utils.camera import CameraBounds as JaxBounds
from thr3ed_atom_tpu_torch.data.dataset import PosedImagesDataset
from thr3ed_atom_tpu_torch.data.png import write_png
from thr3ed_atom_tpu_torch.models.voxels import voxel_grid_from_numpy
from thr3ed_atom_tpu_torch.modules import tester
from thr3ed_atom_tpu_torch.modules.volumetric_model import VolumetricModel
from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
from thr3ed_atom_tpu_torch.utils import lpips
from thr3ed_atom_tpu_torch.utils.camera import (
    CameraBounds,
    CameraIntrinsics,
    pose_spherical,
    to8b,
)
from thr3ed_atom_tpu_torch.utils.constants import (
    BOUNDS,
    EXTRINSIC,
    FOCAL,
    HEIGHT,
    INTRINSIC,
    ROTATION,
    TRANSLATION,
    WIDTH,
)


@pytest.fixture(scope="module")
def metrics():
    return lpips_jax.LPIPSMetric(), lpips.LPIPSMetric(device="cpu")


def _pair(seed=0, size=64):
    """tests/test_lpips.py's pair: an image and a noised copy."""
    rng = np.random.default_rng(seed)
    a = rng.random((size, size, 3), dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape).astype(np.float32), 0, 1)
    return a, b


def test_random_weights_equal_jax_arrays():
    """The fallback weights (numpy seed 1889) are the JAX package's arrays,
    bit for bit, key for key."""
    want = lpips_jax.random_lpips_weights()
    got = lpips.random_lpips_weights()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed", [0, 11])
def test_lpips_matches_jax(metrics, seed):
    """lpips on a batch of two 64 x 64 pairs and LPIPSMetric on one pair
    against the JAX package's: within 1e-6 abs (values ~2e-3); identical
    images score 0; more noise scores higher, as in the JAX tests."""
    jm, tm = metrics
    assert tm.name == jm.name == "lpips_rand_vgg" and not tm.calibrated
    a, b = _pair(seed)
    c, d = _pair(seed + 1)
    want = np.asarray(lpips_jax.lpips(jm.weights, jnp.stack([a, c]), jnp.stack([b, d])))
    got = lpips.lpips(tm.weights, torch.from_numpy(np.stack([a, c])),
                      torch.from_numpy(np.stack([b, d]))).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert tm(a, b) == pytest.approx(jm(a, b), abs=1e-6)
    assert tm(a, a) == pytest.approx(0.0, abs=1e-6)
    rough = np.clip(a + np.random.default_rng(3).normal(0, 0.4, a.shape), 0, 1).astype(np.float32)
    assert tm(a, b) < tm(a, rough)


def test_weights_loader_npz_path(tmp_path, monkeypatch):
    """A converted npz (here the seed-7 arrays, marked calibrated) loads
    through ``weights_path`` and through THR3ED_LPIPS_WEIGHTS: calibrated,
    named lpips_vgg, scoring as the JAX package does with the same file;
    an npz without the marker counts as calibrated, as in JAX."""
    arrays = lpips.random_lpips_weights(seed=7)
    arrays["calibrated"] = np.ones((), np.float32)
    path = tmp_path / "w.npz"
    np.savez(path, **arrays)
    weights, calibrated = lpips.load_lpips_weights(path, device="cpu")
    assert calibrated and weights["conv0_w"].device.type == "cpu"
    np.testing.assert_array_equal(weights["conv12_w"].numpy(), arrays["conv12_w"])
    monkeypatch.setenv("THR3ED_LPIPS_WEIGHTS", str(path))
    tm, jm = lpips.LPIPSMetric(device="cpu"), lpips_jax.LPIPSMetric()
    assert tm.calibrated and tm.name == "lpips_vgg"
    a, b = _pair(seed=2)
    assert tm(a, b) == pytest.approx(jm(a, b), abs=1e-6)
    del arrays["calibrated"]
    np.savez(tmp_path / "bare.npz", **arrays)
    assert lpips.load_lpips_weights(tmp_path / "bare.npz", device="cpu")[1]


class _Recorder:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, name, value, global_step=None):
        self.scalars[name] = (value, global_step)


def test_tester_reports_lpips_as_jax(tmp_path):
    """The port's held-out tester on a 2-view test set (24 x 24, PNGs written
    with the port's codec) rendered from an 8^3 model with the exact
    renderer, against the JAX tester on the same files and grid: the same
    result keys (TEST_SET_PSNR and, under the fallback weights,
    TEST_SET_LPIPS_RAND), LPIPS within 1e-4 and PSNR within 1e-3 dB of
    JAX's, each written to the summary writer at the step."""
    G, size = 8, 24
    rng = np.random.default_rng(0)
    coords = (np.stack(np.meshgrid(*[np.arange(G)] * 3, indexing="ij"), -1) - (G - 1) / 2) / G
    d = np.where(np.linalg.norm(coords, axis=-1) < 0.35, 6.0, 0.0)[..., None].astype(np.float32)
    f = rng.standard_normal((G, G, G, 3)).astype(np.float32)
    kw = dict(num_samples_per_ray=32, perturb_sampled_points=False, white_bkgd=True,
              render_num_samples_per_ray=24)
    tmodel = VolumetricModel(
        voxel_grid_from_numpy(d, f, dict(voxel_size=(3 / G,) * 3, grid_location=(0, 0, 0)),
                              device="cpu"),
        render_config=SHVoxGridRenderConfig(camera_bounds=CameraBounds(2.0, 6.0), **kw),
        device="cpu")
    jmodel = JaxModel(JaxVoxelGrid(densities=jnp.asarray(d), features=jnp.asarray(f),
                                   voxel_size=VoxelSize(3 / G, 3 / G, 3 / G)),
                      render_config=JaxConfig(camera_bounds=JaxBounds(2.0, 6.0), **kw))
    intr = CameraIntrinsics(size, size, size * 1.2)
    img_dir = tmp_path / "test"
    img_dir.mkdir()
    params = {}
    for i in range(2):
        pose = pose_spherical(i * 137.0, -33.0, 4.0)
        out = tmodel.render(pose, intr, num_samples_per_ray=64)
        write_png(img_dir / f"t_{i}.png", to8b(out.colour.numpy()))
        params[f"t_{i}.png"] = {
            INTRINSIC: {BOUNDS: [2.0, 6.0], HEIGHT: size, WIDTH: size, FOCAL: size * 1.2},
            EXTRINSIC: {ROTATION: pose.rotation.tolist(), TRANSLATION: pose.translation.tolist()},
        }
    (tmp_path / "test_camera_params.json").write_text(json.dumps(params))
    ds = dict(images_dir=img_dir, camera_params_json=tmp_path / "test_camera_params.json")
    recorder = _Recorder()
    got = tester.test_sh_vox_grid_vol_mod_with_posed_images(
        tmodel, PosedImagesDataset(**ds), tensorboard_writer=recorder, global_step=42)
    want = tester_jax.test_sh_vox_grid_vol_mod_with_posed_images(jmodel, JaxDataset(**ds))
    print(f"tester: port {got}, JAX {want}")
    assert sorted(got) == sorted(want) == sorted([tester.TEST_SET_PSNR,
                                                  tester.TEST_SET_LPIPS_RAND])
    assert got[tester.TEST_SET_LPIPS_RAND] == pytest.approx(
        want[tester_jax.TEST_SET_LPIPS_RAND], abs=1e-4)
    assert got[tester.TEST_SET_PSNR] == pytest.approx(want[tester_jax.TEST_SET_PSNR], abs=1e-3)
    assert 0.0 < got[tester.TEST_SET_LPIPS_RAND] and got[tester.TEST_SET_PSNR] > 30.0
    assert {k: v[1] for k, v in recorder.scalars.items()} == {k: 42 for k in got}
