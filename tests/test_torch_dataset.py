"""The PyTorch port's image files and posed-image dataset against PIL and the
JAX package: PNG round trips (grey, grey + alpha, RGB, RGBA; PIL's files use
every row filter), and thr3ed_atom_tpu_torch.data.dataset.PosedImagesDataset
against thr3ed_atom_tpu.data.dataset.PosedImagesDataset on the same files:
images, poses, bounds, intrinsics, hemispherical radius, scene-scale
normalization, white or premultiplied alpha, at downsample factors 1, 2 and 1.5;
the depth colormap against matplotlib's.

CPU only; inputs are made from seeds with numpy."""
import json
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from thr3ed_atom_tpu.data.dataset import PosedImagesDataset as JaxDataset
from thr3ed_atom_tpu_torch.data.dataset import PosedImagesDataset, resize_bilinear_uint8
from thr3ed_atom_tpu_torch.data.png import read_png, write_png
from thr3ed_atom_tpu_torch.utils.camera import pose_spherical

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def _image(rng, h, w, c):
    """A smooth ramp plus noise (so PIL's adaptive filter picks every row
    filter), with a varying alpha channel where there is one."""
    ramp = (np.add.outer(np.arange(h) * 3, np.arange(w) * 2) % 256)[..., None]
    img = (ramp + rng.integers(0, 40, (h, w, c))) % 256
    if c in (2, 4):
        img[..., -1] = rng.integers(0, 256, (h, w))
        img[: h // 4, :, -1] = 0
        img[h // 4: h // 2, :, -1] = 255
    return img.astype(np.uint8)


def _filter_types(path):
    """The row filter types of an 8-bit PNG file."""
    data = path.read_bytes()
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + length
    w, h, _, colour = hdr[:4]
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(h, 1 + w * bpp)[:, 0].tolist())


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_round_trips_against_pil(tmp_path, channels):
    """read_png reads PIL's files bit for bit (filters 0-4 all occur across
    the cases); PIL reads write_png's files bit for bit; read_png reads its
    own files back."""
    rng = np.random.default_rng(channels)
    img = _image(rng, 37, 53, channels)
    arr = img[..., 0] if channels == 1 else img
    pil_file, own_file = tmp_path / "pil.png", tmp_path / "own.png"
    Image.fromarray(arr, MODES[channels]).save(pil_file)
    assert _filter_types(pil_file) - {0}  # PIL filtered some rows
    np.testing.assert_array_equal(read_png(pil_file), arr)
    write_png(own_file, arr)
    assert _filter_types(own_file) == {0}
    np.testing.assert_array_equal(np.asarray(Image.open(own_file)), arr)
    np.testing.assert_array_equal(read_png(own_file), arr)


def test_png_filters_cover_all_five_and_bad_files_raise(tmp_path):
    """A large smooth RGB image from PIL uses all five filters and reads back
    exactly; 16-bit, palette and non-PNG files raise naming the file."""
    rng = np.random.default_rng(0)
    img = np.cumsum(rng.integers(0, 6, (96, 120, 3)), axis=1).astype(np.uint8)
    img[40:60] = rng.integers(0, 256, (20, 120, 3))
    path = tmp_path / "big.png"
    Image.fromarray(img).save(path)
    np.testing.assert_array_equal(read_png(path), img)
    deep = tmp_path / "deep.png"
    Image.fromarray(rng.integers(0, 65535, (8, 8)).astype(np.uint16)).save(deep)
    pal = tmp_path / "pal.png"
    Image.fromarray(img).convert("P").save(pal)
    jpg = tmp_path / "x.jpg"
    Image.fromarray(img).save(jpg)
    for bad in (deep, pal, jpg):
        with pytest.raises(ValueError, match=bad.name):
            read_png(bad)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resize_matches_pil(channels):
    """resize_bilinear_uint8 against PIL's resize(BILINEAR) on downscales by
    2, 1.5 and a ragged factor: PIL's fixed-point passes reproduced, so the
    bytes are equal, the RGBA case's low alphas (where the un-premultiply
    divides by alpha / 255) included."""
    rng = np.random.default_rng(10 + channels)
    for (h, w), (th, tw) in (((64, 64), (32, 32)), ((64, 48), (42, 32)),
                             ((40, 40), (17, 23))):
        img = _image(rng, h, w, channels)
        if channels == 4:  # a band of low alphas
            img[h // 2: 3 * h // 4, :, 3] = rng.integers(1, 9, (3 * h // 4 - h // 2, w))
        arr = img[..., 0] if channels == 1 else img
        want = np.asarray(Image.fromarray(arr, MODES[channels]).resize((tw, th),
                                                                       Image.BILINEAR))
        got = resize_bilinear_uint8(img, tw, th)
        got = got[..., 0] if channels == 1 else got
        if channels == 4:
            assert ((want[..., 3] > 0) & (want[..., 3] < 16)).any()  # low alphas occur
        np.testing.assert_array_equal(got, want)


def _write_dataset(root, channels, n=5, size=48, seed=0):
    """A posed-image dataset in the JAX package's on-disk layout: PNGs under
    root/train and root/train_camera_params.json (one extra image without a
    pose entry, which both datasets drop)."""
    rng = np.random.default_rng(seed)
    img_dir = root / "train"
    img_dir.mkdir(parents=True)
    params = {}
    for i in range(n):
        name = f"r_{i}.png"
        img = _image(rng, size, size, channels)
        write_png(img_dir / name, img)
        pose = pose_spherical(30.0 * i, -30.0 - 5 * i, 3.0 + 0.25 * i)
        rot = np.asarray(pose.rotation, np.float32).reshape(3, 3)
        tr = np.asarray(pose.translation, np.float32).reshape(3, 1)
        params[name] = {
            "intrinsic": {"bounds": [2.0 + 0.1 * i, 6.0 - 0.1 * i], "height": size,
                          "width": size, "focal": 60.0},
            "extrinsic": {"rotation": rot.tolist(), "translation": tr.tolist()},
        }
    write_png(img_dir / "extra.png", _image(rng, size, size, channels))
    (root / "train_camera_params.json").write_text(json.dumps(params))
    return img_dir, root / "train_camera_params.json"


@pytest.mark.parametrize("channels,white", [(4, True), (4, False), (3, True), (1, False)])
@pytest.mark.parametrize("factor", [1.0, 2.0, 1.5])
def test_dataset_matches_jax(tmp_path, channels, white, factor):
    """The port's PosedImagesDataset against the JAX package's on the same
    files: poses, bounds, intrinsics, the hemispherical radius and the
    config dict equal; images equal at every factor (the resize gives PIL's
    bytes). normalize_scene_scale and image_data_range as the JAX
    package's."""
    img_dir, cams = _write_dataset(tmp_path, channels)
    for kw in (dict(), dict(normalize_scene_scale=True, image_data_range=(-1.0, 1.0))):
        args = dict(images_dir=img_dir, camera_params_json=cams, downsample_factor=factor,
                    rgba_white_bkgd=white, **kw)
        got, want = PosedImagesDataset(**args), JaxDataset(**args)
        assert len(got) == len(want) == 5
        assert got.images.shape == want.images.shape == (5, int(48 / factor),
                                                          int(48 / factor), 3)
        assert got.images.dtype == np.float32 and got.poses.dtype == np.float32
        gap = np.abs(got.images - want.images).max()
        print(f"channels={channels} white={white} factor={factor} {kw}: image gap {gap:.3g}")
        assert gap == 0.0
        np.testing.assert_array_equal(got.poses, want.poses)
        assert tuple(got.camera_bounds) == tuple(want.camera_bounds)
        assert tuple(got.camera_intrinsics) == tuple(want.camera_intrinsics)
        assert got.get_hemispherical_radius_estimate() == want.get_hemispherical_radius_estimate()
        assert got.get_config_dict() == want.get_config_dict()
        assert got.camera_parameters == want.camera_parameters


def test_magma_matches_matplotlib():
    """The feedback panels' depth colormap without matplotlib: 17 anchors of
    magma, interpolated linearly, within 4 / 255 of matplotlib's 1024-entry
    table (what the JAX package draws with); measured 3.55 / 255."""
    plt = pytest.importorskip("matplotlib.pyplot")
    from thr3ed_atom_tpu_torch.utils.camera import magma

    t = np.linspace(0.0, 1.0, 10001)
    want = plt.get_cmap("magma", lut=1024)(t)[..., :3]
    assert np.abs(magma(t) - want).max() <= 4.0 / 255
    np.testing.assert_array_equal(magma(np.array([-1.0, 2.0])), magma(np.array([0.0, 1.0])))
