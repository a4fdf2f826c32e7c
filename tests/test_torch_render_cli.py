"""The PyTorch port's render CLI and its GIF writer against the JAX package:
the CLI's options against the click command's, CPU runs of main([...]) on
small models saved with the planes and the gnomonic procedures whose panel
frames are held against the JAX package's render_camera_path_for_volumetric_model,
and the GIF decoded with PIL (present here, not on the card's machine).

CPU tests: 16^3 grids (SH degree 2, relu), 32 x 32 renders, 3 frames; the
JAX side runs its Pallas kernels in interpret mode, the port its plain
versions. Grids are made from seeds with numpy."""
import importlib.util
import io
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import GifImagePlugin, Image

from test_torch_gnomonic import _one_torch_thread, _scene  # noqa: F401
from thr3ed_atom_tpu.models.voxels import VoxelGrid as JaxVoxelGrid, VoxelSize
from thr3ed_atom_tpu.modules import volumetric_model as vm_jax
from thr3ed_atom_tpu.rendering.renderer import SHVoxGridRenderConfig as JaxConfig
from thr3ed_atom_tpu.utils.camera import CameraBounds as JaxBounds
from thr3ed_atom_tpu.utils.camera import CameraIntrinsics as JaxIntrinsics
from thr3ed_atom_tpu.utils.camera import get_thre360_animation_poses as jax_poses
from thr3ed_atom_tpu.visualizations.animations import (
    render_camera_path_for_volumetric_model as jax_render_path,
)
from thr3ed_atom_tpu_torch.apps import render_sh_voxel_grid as cli
from thr3ed_atom_tpu_torch.visualizations import video

REPO = Path(__file__).resolve().parent.parent
SIZE, RADIUS = 32, 3.5


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_render_sh_voxel_grid",
                                                  REPO / "apps" / "render_sh_voxel_grid.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["jax_render_sh_voxel_grid"] = module
    spec.loader.exec_module(module)
    return module.main


def test_cli_options_match_click():
    """Every option of the JAX package's click command exists in the port's
    parser with the same spellings, default, requiredness and choices, and
    nothing more; the integer options refuse values below 1 as click's
    IntRange(min=1) does."""
    actions = {a.dest: a for a in cli.build_parser()._actions if a.dest != "help"}
    params = {p.name: p for p in _jax_cli().params}
    assert set(actions) == set(params)
    for name, p in params.items():
        a = actions[name]
        assert sorted(a.option_strings) == sorted(p.opts), name
        assert a.required == p.required, name
        assert a.default == (None if p.required else p.default), name
        if hasattr(p.type, "choices"):
            assert tuple(a.choices) == tuple(p.type.choices), name
    for flag in ("--num_frames", "--fps", "--num_spiral_rounds",
                 "--overridden_num_samples_per_ray"):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(["-i", "m", "-o", "o", flag, "0"])


def _save_jax_model(path, procedure):
    """A 16^3 relu ball scene saved by the JAX package with ``procedure`` and
    the CLI's extra info (radius, 32 x 32 intrinsics)."""
    d, f, config = _scene()
    jgrid = JaxVoxelGrid(densities=jnp.asarray(d), features=jnp.asarray(f),
                         voxel_size=VoxelSize(*config["voxel_size"]),
                         density_preactivation="identity", density_postactivation="relu")
    config = JaxConfig(num_samples_per_ray=32, camera_bounds=JaxBounds(1.0, 6.0),
                       white_bkgd=True, perturb_sampled_points=False)
    vm_jax.VolumetricModel(jgrid, procedure, config).save(
        path, {"hemispherical_radius": RADIUS,
               "camera_intrinsics": [SIZE, SIZE, SIZE * 1.1]})
    return path


@pytest.fixture
def palette_frames():
    """PIL keeps a GIF's later frames as palette indices (one global palette)
    for the test's duration."""
    old = GifImagePlugin.LOADING_STRATEGY
    GifImagePlugin.LOADING_STRATEGY = GifImagePlugin.LoadingStrategy.RGB_AFTER_DIFFERENT_PALETTE_ONLY
    yield
    GifImagePlugin.LOADING_STRATEGY = old


def _decode(gif_path):
    """The GIF's frames as palette indices, and its delay and loop fields."""
    im = Image.open(io.BytesIO(gif_path.read_bytes()))
    frames = []
    for i in range(im.n_frames):
        im.seek(i)
        assert im.mode == "P"
        frames.append(np.asarray(im))
    return np.stack(frames), im.info.get("duration"), im.info.get("loop")


@pytest.mark.parametrize("procedure", ["render_sh_voxel_grid_planes",
                                       "render_sh_voxel_grid_gnomonic"])
def test_cli_run_matches_jax_frames(tmp_path, monkeypatch, palette_frames, procedure):
    """main([...], device="cpu") on a model the JAX package saved: 3 thre360
    frames (--num_frames 4 drops the closing pose, as the JAX CLI does) at
    pitch -30, scale 1. The colour and inverted-acc panels equal the JAX
    package's render_camera_path_for_volumetric_model frames of the same
    model within one 8-bit level (the renders agree to 3e-3), the depth
    panel within two (its magma colormap of the per-frame normalised depth
    steepens a truncation step; measured: 2 of 9,216 values differ by 2);
    the object shows. rendered_video.gif decodes with PIL to the encoder's
    palette indices exactly: 3 frames of 32 x 96, 2 cs a frame at 50 fps,
    looping."""
    model = _save_jax_model(tmp_path / "model", procedure)
    seen = []

    def recording_write_video(path, frames, fps):
        seen.append(frames)
        return video.write_video(path, frames, fps)

    monkeypatch.setattr(cli, "write_video", recording_write_video)
    out = cli.main(["-i", str(model.with_suffix(".json")), "-o", str(tmp_path / "out"),
                    "--num_frames", "4", "--render_scale_factor", "1", "--camera_pitch",
                    "-30", "--fps", "50"], device="cpu")
    assert out == tmp_path / "out" / "rendered_video.gif" and out.exists()
    (frames,) = seen
    assert frames.shape == (3, SIZE, 3 * SIZE, 3) and frames.dtype == np.uint8
    jmodel, _ = vm_jax.create_volumetric_model_from_saved_model(model)
    want = jax_render_path(jmodel, jax_poses(RADIUS, -30.0, 4),
                           JaxIntrinsics(SIZE, SIZE, SIZE * 1.1), render_scale_factor=1.0,
                           overridden_num_samples_per_ray=512, verbose=False)
    gap = np.abs(frames.astype(np.int32) - want.astype(np.int32))
    print(f"{procedure} CLI frames vs JAX: max {gap.max()} levels, "
          f"{(gap > 0).mean():.4f} of the values differ")
    colour, depth, acc = (gap[:, :, k * SIZE:(k + 1) * SIZE] for k in range(3))
    assert colour.max() <= 1 and acc.max() <= 1 and depth.max() <= 2
    assert frames[:, :, 2 * SIZE:].min() < 100  # the acc panel shows the object
    indices, duration, loop = _decode(out)
    _, want_idx = video.gif_palette(frames)
    assert indices.shape == (3, SIZE, 3 * SIZE)
    np.testing.assert_array_equal(indices, want_idx)
    assert duration == 20 and loop == 0


def test_gif_encoder_round_trips(palette_frames):
    """encode_gif on frames of more than 256 colours (the 6 x 6 x 6 palette;
    enough pixels that the LZW table fills and restarts) and of few colours
    (their own palette), and on 1-39 pixel streams (every code-width edge of
    a short stream): PIL decodes each to the encoder's indices exactly, and
    the palette it reads is the encoder's."""
    rng = np.random.default_rng(0)
    cases = [rng.integers(0, 256, (2, 120, 160, 3), dtype=np.uint8),
             rng.integers(0, 4, (3, 33, 17, 3), dtype=np.uint8) * 60]
    cases += [rng.integers(0, 3, (1, 1, n, 3), dtype=np.uint8) * 100 for n in range(1, 40)]
    for frames in cases:
        palette, want = video.gif_palette(frames)
        assert len(palette) <= 256
        im = Image.open(io.BytesIO(video.encode_gif(frames, 60)))
        assert im.n_frames == len(frames)
        for i in range(im.n_frames):
            im.seek(i)
            np.testing.assert_array_equal(np.asarray(im), want[i])
        got_pal = np.asarray(im.getpalette()[:3 * len(palette)], np.uint8).reshape(-1, 3)
        np.testing.assert_array_equal(got_pal, palette)
    few = cases[1]
    palette, idx = video.gif_palette(few)
    np.testing.assert_array_equal(palette[idx], few)  # exact colours when <= 256
