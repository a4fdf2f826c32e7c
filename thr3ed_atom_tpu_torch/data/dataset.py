"""Posed-image datasets (counterpart of thr3ed_atom_tpu/data/dataset.py).

On-disk contract (shared with the JAX package): a directory of images + a JSON
file mapping image filename -> {intrinsic: {bounds, height, width, focal},
extrinsic: {rotation 3x3, translation 3x1}}. The whole dataset is loaded into
numpy arrays once; the trainer moves each stage's images to the card.

Images are 8-bit PNGs read with data/png.py. A downscale repeats, byte for
byte, what the JAX package gets from PIL's ``resize(BILINEAR)``: an RGBA (or
grey + alpha) image is premultiplied in 8 bits, resized with the antialiased
triangle filter in PIL's fixed point (a horizontal then a vertical pass, each
clipped to 8 bits), and un-premultiplied in 8 bits (truncating, as PIL).
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np

from thr3ed_atom_tpu_torch.data.png import read_png
from thr3ed_atom_tpu_torch.utils.camera import (
    CameraBounds,
    CameraIntrinsics,
    CameraPose,
    adjust_dynamic_range,
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
from thr3ed_atom_tpu_torch.utils.logging import log


PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit resampling


def _bilinear_coeffs(in_size: int, out_size: int):
    """PIL's precompute_coeffs and normalize_coeffs_8bpc (Resample.c) for the
    bilinear filter over the whole axis: (first source index [out], window
    size [out], fixed-point coefficients [out, ksize] int64). The triangle's
    support is widened by the downscale factor; each output's window is cut
    to [0, in_size), its weights are normalized in double and rounded half
    away from zero to PRECISION_BITS fraction bits."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates towards zero, as astype does
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    t = np.abs((x[None] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where((x[None] < xmax[:, None]) & (t < 1.0), 1.0 - t, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # PIL's sum, in window order
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    one = float(1 << PRECISION_BITS)
    kk = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    return xmin, xmax, kk.astype(np.int64)


def _resample_axis(img: np.ndarray, axis: int, xmin: np.ndarray, kk: np.ndarray) -> np.ndarray:
    """One pass of PIL's ImagingResample{Horizontal,Vertical}_8bpc along
    ``axis`` of an int64 image: the accumulator starts at half a unit, adds
    every source byte times its coefficient, and is clipped to 8 bits
    (clip8). Integer sums are exact, so their order does not matter."""
    src = np.moveaxis(img, axis, 0)
    acc = np.full((len(xmin),) + src.shape[1:], 1 << (PRECISION_BITS - 1), dtype=np.int64)
    extra = (1,) * (src.ndim - 1)
    for j in range(kk.shape[1]):  # coefficients past a window's end are 0
        idx = np.minimum(xmin + j, src.shape[0] - 1)
        acc += src[idx] * kk[:, j].reshape((-1,) + extra)
    return np.moveaxis(np.clip(acc >> PRECISION_BITS, 0, 255), 0, axis)


def resize_bilinear_uint8(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W, C] resized to [height, width, C] as PIL's
    ``resize(BILINEAR)`` (ImagingResampleInner): the horizontal pass over
    only the source rows the vertical pass reads, then the vertical pass, in
    PIL's fixed point. An alpha channel (C = 2 or 4) is premultiplied before
    and removed after, as ``Image.resize`` does for RGBA and LA."""
    img = image.astype(np.int64)
    alpha = img.shape[-1] in (2, 4)
    if alpha:  # PIL's MULDIV255: round(colour * alpha / 255)
        t = img[..., :-1] * img[..., -1:] + 128
        img = np.concatenate([((t >> 8) + t) >> 8, img[..., -1:]], axis=-1)
    h, w = img.shape[:2]
    ymin, ysize, kk_v = _bilinear_coeffs(h, height)
    if w != width:
        # only the rows the vertical pass reads: the first window's start to
        # the last window's end
        first, last = int(ymin[0]), int(ymin[-1] + ysize[-1])
        xmin, _, kk_h = _bilinear_coeffs(w, width)
        img = _resample_axis(img[first:last], 1, xmin, kk_h)
        ymin = ymin - first
    if h != height:
        img = _resample_axis(img, 0, ymin, kk_v)
    out = img
    if alpha:  # PIL's unpremultiply: truncated, kept where alpha is 0 or 255
        rgb, a = out[..., :-1], out[..., -1:]
        un = np.clip(255 * rgb // np.maximum(a, 1), 0, 255)
        out[..., :-1] = np.where((a == 0) | (a == 255), rgb, un)
    return out.astype(np.uint8)


class PosedImagesDataset:
    """Images + per-image camera poses, materialized as numpy arrays."""

    def __init__(
        self,
        images_dir: Path,
        camera_params_json: Path,
        image_data_range: Tuple[float, float] = (0.0, 1.0),
        normalize_scene_scale: bool = False,
        downsample_factor: float = 1.0,
        rgba_white_bkgd: bool = False,
    ) -> None:
        images_dir, camera_params_json = Path(images_dir), Path(camera_params_json)
        assert images_dir.exists(), f"Images dir doesn't exist: {images_dir}"
        assert camera_params_json.exists(), (
            f"CameraParams file doesn't exist: {camera_params_json}"
        )

        with open(camera_params_json) as f:
            self._camera_parameters: Dict[str, Any] = json.load(f)

        image_file_paths = sorted(p for p in images_dir.iterdir() if p.is_file())
        self._image_file_paths = self._filter_image_file_paths(
            image_file_paths, self._camera_parameters
        )

        self._images_dir = images_dir
        self._camera_params_json = camera_params_json
        self._image_data_range = image_data_range
        self._normalize_scene_scale_bool = normalize_scene_scale
        self._downsample_factor = downsample_factor
        self._rgba_white_bkgd = rgba_white_bkgd

        self._camera_bounds = self._setup_camera_bounds()
        self._camera_intrinsics = self._setup_camera_intrinsics()

        if normalize_scene_scale:
            self._normalize_scene_scale()

        # eager load: images [N, H, W, 3] float32, poses [N, 3, 4] float32
        self._images, self._poses = self._load_all()
        log.info(
            f"Loaded {len(self._images)} posed images at resolution "
            f"[{self._camera_intrinsics.height} x {self._camera_intrinsics.width}]"
        )

    # ------------------------------------------------------------------ properties

    @property
    def images(self) -> np.ndarray:
        return self._images

    @property
    def poses(self) -> np.ndarray:
        return self._poses

    @property
    def camera_bounds(self) -> CameraBounds:
        return self._camera_bounds

    @camera_bounds.setter
    def camera_bounds(self, camera_bounds: CameraBounds) -> None:
        self._camera_bounds = camera_bounds

    @property
    def camera_intrinsics(self) -> CameraIntrinsics:
        return self._camera_intrinsics

    @property
    def camera_parameters(self) -> Dict[str, Any]:
        return self._camera_parameters

    def get_config_dict(self) -> Dict[str, Any]:
        return {
            "images_dir": self._images_dir,
            "camera_params_json": self._camera_params_json,
            "image_data_range": self._image_data_range,
            "normalize_scene_scale": self._normalize_scene_scale_bool,
            "downsample_factor": self._downsample_factor,
            "rgba_white_bkgd": self._rgba_white_bkgd,
        }

    def __len__(self) -> int:
        return len(self._image_file_paths)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._images[index], self._poses[index]

    # ------------------------------------------------------------------ setup internals

    @staticmethod
    def _filter_image_file_paths(
        image_file_paths: List[Path], camera_parameters: Dict[str, Any]
    ) -> List[Path]:
        """Drop images that have no pose entry."""
        if len(image_file_paths) == len(camera_parameters):
            return image_file_paths
        return [p for p in image_file_paths if p.name in camera_parameters]

    def _setup_camera_bounds(self) -> CameraBounds:
        all_bounds = np.vstack(
            [
                np.array(cp[INTRINSIC][BOUNDS], dtype=np.float32)
                for cp in self._camera_parameters.values()
            ]
        )
        # global near/far with 10% slack on both ends
        return CameraBounds(float(all_bounds.min() * 0.9), float(all_bounds.max() * 1.1))

    def _setup_camera_intrinsics(self) -> CameraIntrinsics:
        all_intrinsics = np.vstack(
            [
                np.array(
                    [cp[INTRINSIC][HEIGHT], cp[INTRINSIC][WIDTH], cp[INTRINSIC][FOCAL]],
                    dtype=np.float32,
                )
                for cp in self._camera_parameters.values()
            ]
        )
        assert np.all(all_intrinsics == all_intrinsics[0, :]), (
            "all cameras must share identical intrinsics"
        )
        height, width, focal = all_intrinsics[0, :] / self._downsample_factor
        return CameraIntrinsics(int(height), int(width), float(focal))

    def _normalize_scene_scale(self) -> None:
        """Scale all camera translations (and bounds) by the farthest camera's norm."""
        all_locations = np.concatenate(
            [
                self.extract_pose(cp).translation
                for cp in self._camera_parameters.values()
            ],
            axis=-1,
        )
        max_norm = float(np.max(np.linalg.norm(all_locations, axis=0)))
        for params in self._camera_parameters.values():
            translation = params[EXTRINSIC][TRANSLATION]
            for row in range(3):
                translation[row][0] = str(float(translation[row][0]) / max_norm)
        self._camera_bounds = CameraBounds(
            self._camera_bounds.near / max_norm, self._camera_bounds.far / max_norm
        )

    def get_hemispherical_radius_estimate(self) -> float:
        """Mean camera-location norm."""
        all_locations = np.squeeze(
            np.array(
                [
                    cp[EXTRINSIC][TRANSLATION]
                    for cp in self._camera_parameters.values()
                ]
            ).astype(np.float32)
        )
        return float(np.linalg.norm(all_locations, axis=-1).mean())

    @staticmethod
    def extract_pose(camera_params: Dict[str, Any]) -> CameraPose:
        rotation = np.array(camera_params[EXTRINSIC][ROTATION]).astype(np.float32)
        translation = np.array(camera_params[EXTRINSIC][TRANSLATION]).astype(np.float32)
        return CameraPose(rotation, translation)

    # ------------------------------------------------------------------ image loading

    def _process_image(self, image: np.ndarray) -> np.ndarray:
        """Resize + RGBA handling: white-composite or premultiply alpha; grey
        repeats to 3 channels; >4 channel images keep the first 3."""
        height, width = self._camera_intrinsics.height, self._camera_intrinsics.width
        if image.ndim == 2:
            image = image[..., None]
        if image.shape[:2] != (height, width):
            image = resize_bilinear_uint8(image, width, height)
        arr = image.astype(np.float32) / 255.0
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        if arr.shape[-1] == 4:
            rgb, alpha = arr[..., :3], arr[..., 3:]
            if self._rgba_white_bkgd:
                arr = rgb * alpha + (1.0 - alpha)
            else:
                arr = rgb * alpha
        elif arr.shape[-1] > 4:
            arr = arr[..., :3]
        if self._image_data_range != (0.0, 1.0):
            arr = adjust_dynamic_range(
                arr, drange_in=(0.0, 1.0), drange_out=self._image_data_range
            )
        return arr

    def _load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        images, poses = [], []
        for path in self._image_file_paths:
            images.append(self._process_image(read_png(path)))
            pose = self.extract_pose(self._camera_parameters[path.name])
            poses.append(np.hstack([pose.rotation, pose.translation]))
        return (
            np.stack(images).astype(np.float32),
            np.stack(poses).astype(np.float32),
        )
