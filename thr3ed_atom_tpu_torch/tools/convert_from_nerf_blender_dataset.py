"""Convert a NeRF-synthetic (blender) scene into the per-image camera-params
JSON layout the trainers read (counterpart of the repository's
tools/convert_from_nerf_blender_dataset.py, with argparse for click and
data/png.py for PIL).

    python -m thr3ed_atom_tpu_torch.tools.convert_from_nerf_blender_dataset \\
        -d <scene with transforms_{train,val,test}.json> -o <output>

For each split it reads ``transforms_<split>.json``, takes the image size from
the split's first PNG and the focal from ``camera_angle_x``, bounds the rays at
NEAR, FAR = 2, 6, and writes ``<split>_camera_params.json`` keyed by image file
name, with each frame's rotation and translation.
"""
import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from thr3ed_atom_tpu_torch.data.png import read_png
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

SPLITS = ("train", "val", "test")
NEAR, FAR = 2.0, 6.0


def convert(data_path: Path, output_path: Path) -> None:
    """Write ``<split>_camera_params.json`` under ``output_path`` for each
    split of the scene at ``data_path``."""
    data_path, output_path = Path(data_path), Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    log.info(f"loading the data from source path: {data_path}")
    for split in SPLITS:
        with open(data_path / f"transforms_{split}.json") as f:
            meta = json.load(f)
        first_name = meta["frames"][0]["file_path"].split("/")[-1] + ".png"
        height, width = read_png(data_path / split / first_name).shape[:2]
        focal = 0.5 * width / np.tan(0.5 * float(meta["camera_angle_x"]))
        converted = {}
        for frame in meta["frames"]:
            filename = frame["file_path"].split("/")[-1] + ".png"
            transform = np.array(frame["transform_matrix"])
            converted[filename] = {
                INTRINSIC: {BOUNDS: [NEAR, FAR], HEIGHT: height, WIDTH: width, FOCAL: focal},
                EXTRINSIC: {ROTATION: transform[:3, :3].tolist(),
                            TRANSLATION: transform[:3, -1:].tolist()},
            }
        out_file = output_path / f"{split}_camera_params.json"
        with open(out_file, "w", encoding="utf-8") as f:
            json.dump(converted, f, ensure_ascii=False, indent=4)
        log.info(f"wrote {out_file} ({len(converted)} poses)")


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m thr3ed_atom_tpu_torch.tools.convert_from_nerf_blender_dataset",
        description="Convert a NeRF-synthetic scene to per-image camera-params JSON.")
    p.add_argument("-d", "--data_path", required=True,
                   help="path to the original nerf synthetic dataset scene")
    p.add_argument("-o", "--output_path", required=True,
                   help="path for outputting the converted scene")
    args = p.parse_args(argv)
    convert(Path(args.data_path), Path(args.output_path))


if __name__ == "__main__":
    main()
