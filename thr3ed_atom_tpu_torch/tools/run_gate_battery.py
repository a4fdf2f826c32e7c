"""The production quality gates on the CUDA card over two poses, one JSON
artifact a run (counterpart of the repository's tools/run_gate_battery.py:
the same scene, poses, gates, thresholds and JSON keys).

    python -m thr3ed_atom_tpu_torch.tools.run_gate_battery [--round N] [--out FILE]

The exact renderer at 1024 samples a ray is the oracle everywhere; each gate
takes the minimum PSNR over the poses (45, -40) and (160, -20) of the 128^3
converged blob scene at 400 x 400: gnomonic at P = 1, 2, 4 with qb = 128
(P = 4 above P = 2), gnomonic P = 2 on the sharp scene (> 45 dB), the
bricked ladder K = 1, 2, 4 (each K above the last), the occupancy skip
against neither skip nor exit, and fast top-32 / top-64 against the exact
renderer at 512 samples. It prints a line a gate and a summary, and exits 1
if a gate fails; ``main`` refuses to run without a card (exit 2), the
functions take ``device=`` (None: the card).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

from thr3ed_atom_tpu_torch.tools.make_synthetic_dataset import make_blob_scene
from thr3ed_atom_tpu_torch.tools.run_quality_gates import (
    BRICKED,
    EXACT,
    FAST,
    GNOMONIC,
    min_psnr,
    occupancy_neutrality_db,
    render,
    sharp_scene_db,
)
from thr3ed_atom_tpu_torch.utils.camera import CameraIntrinsics, pose_spherical

GRID_SIZE = 128
IMAGE_SIZE = 400
POSE_ANGLES = ((45.0, -40.0), (160.0, -20.0))


def run_battery(grid_size: int = GRID_SIZE, image_size: int = IMAGE_SIZE, device=None,
                round_: int = 5, echo: Callable[[str], None] = print) -> dict:
    """Every gate over ``POSE_ANGLES`` on ``device`` (None: the card);
    returns the JSON artifact's dict."""
    t0 = time.perf_counter()
    dev = torch.device("cuda") if device is None else torch.device(device)
    scene = make_blob_scene(grid_size=grid_size, seed=3, converged=True, device=dev)
    intr = CameraIntrinsics(image_size, image_size, image_size * 1.1)
    poses = [pose_spherical(a, e, 4.0) for a, e in POSE_ANGLES]
    gates = {}

    def gate(name, value, threshold, detail=""):
        ok = bool(value > threshold)
        gates[name] = {"db": round(value, 2), "threshold": threshold, "ok": ok,
                       "detail": detail}
        echo(f"[{time.perf_counter() - t0:6.0f}s] {name}: {value:.2f} dB "
             f"(gate > {threshold}) {'OK' if ok else 'FAIL'} {detail}")

    def vs(reference, procedure, spp=1024, **cfg):
        return min_psnr(render(scene, procedure, spp, poses, intr, dev, **cfg), reference)

    echo("rendering exact@1024 oracle...")
    exact = render(scene, EXACT, 1024, poses, intr, dev, parallel_rays_chunk_size=4096)
    pv = {p: vs(exact, GNOMONIC, gnomonic_pos_per_cell=p, gnomonic_qb=128) for p in (1, 2, 4)}
    gate("gnomonic_P1_vs_exact1024", pv[1], 60.0)
    gate("gnomonic_P2_vs_exact1024", pv[2], 75.0, "the headline bench config")
    gate("gnomonic_P4_vs_exact1024", pv[4], pv[2], "quadrature monotonicity")
    gate("gnomonic_P2_sharp_scene", sharp_scene_db(scene, poses, intr, dev), 45.0)

    bk = {k: vs(exact, BRICKED, bricked_axis_supersample=k) for k in (1, 2, 4)}
    gate("bricked_K1_vs_exact1024", bk[1], 60.0)
    gate("bricked_K2_monotone", bk[2], bk[1])
    gate("bricked_K4_monotone", bk[4], bk[2])
    gate("bricked_occupancy_skip_neutral", occupancy_neutrality_db(
        scene, poses, intr, dev, on=render(scene, BRICKED, 1024, poses, intr, dev)), 60.0)

    exact512 = render(scene, EXACT, 512, poses, intr, dev, parallel_rays_chunk_size=8192)
    fast32 = vs(exact512, FAST, 512, fast_topk=32)
    gate("fast_top32_vs_exact512", fast32, 25.0, "soft-scene worst case")
    gate("fast_top64_vs_exact512", vs(exact512, FAST, 512, fast_topk=64), max(31.0, fast32))

    return {
        "round": round_,
        "grid": grid_size,
        "image": image_size,
        "poses": [list(p) for p in POSE_ANGLES],
        "all_ok": all(g["ok"] for g in gates.values()),
        "wall_s": round(time.perf_counter() - t0, 1),
        "gates": gates,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m thr3ed_atom_tpu_torch.tools.run_gate_battery")
    ap.add_argument("--round", type=int, default=5)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("refusing to run the gate battery without a CUDA card: the gates hold "
              "the card's kernels", file=sys.stderr)
        return 2
    out = run_battery(round_=args.round, echo=lambda line: print(line, flush=True))
    path = args.out or f"GATES_r{args.round:02d}.json"
    Path(path).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({"all_ok": out["all_ok"], "wall_s": out["wall_s"], "artifact": path}))
    return 0 if out["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
