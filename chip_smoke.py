"""Smoke run of the PyTorch/CUDA port (thr3ed_atom_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from thr3ed_atom_tpu_torch/csrc with nvcc (one
nvcc per source, all at once) and holds each against its plain PyTorch
version on the card at the main paths' shapes:
  1-4. the build, relu_trap (K1a), the warp resample (K2; its bilinear pass
       and F.grid_sample as median and range of K2_READINGS device-clock
       readings each; the row slab staged in shared memory against the L1
       gathers; its launch path split into binding, stream handle, checks,
       allocation and launch, before and after kernels.bind) and the fused
       composite (K1; also on an opaque copy of the scene, where its early
       exit must end tiles; with the count of tiles that gathered a
       footprint directly);
  5.   the serving path through the entry points a user calls: a 128^3
       SH-degree-2 model (random blob scene from a seed, bench.py's
       configuration) saved with save_model, loaded with
       create_volumetric_model_from_saved_model and rendered with
       render_poses at 400 x 400 (P = 2, qb = 128, exit_eps = 1e-4,
       Catmull-Rom matmul warp), held against the same render through the
       plain versions;
  6.   the warp adjoint (K4), also on rows shuffled out of order (its
       scatter); K2 and K4 and their library calls are also timed as
       the host queues them, beside each wrapper's launch path (and the
       launch path as it was before kernels.bind, around the same kernel);
  7.   K1's training branch (materialized SH basis and norm) and the replay
       backward (K3) on one pose with a seeded state cotangent; K3's march
       and u-fold timed apart on the device clock (torch.profiler), and the
       bytes of its v-fold output beside a per-texel cotangent buffer's;
  8.   the training path, bench_train.py's configuration: 10
       gnomonic_train_step_multi steps of 4 views (400 x 400, P = 2, diffuse
       regularization, Adam lr 0.03, phase jitter) on a 128^3 grid started at
       uniform(-1, 1), towards views rendered in phase 5; the loss must fall
       and the first step's gradient must match the plain versions' step;
  9-10. the stripe composite (K5; its CTA shape and shared memory) and its
       replay backward (K7) at 128^3 and at the CLI's first stage (64^3, P = 4, 200 x 200), where K1, K3 and both warp
       passes (K2, K4) are held too; K7 also against the three launches
       its band kernel replaced (bit-equal), both timed, with their
       cotangent-buffer bytes and the band kernel's launch plan;
  11.  the serving path with gnomonic_qb = 0;
  12.  the training CLI end to end, main([...]) twice (the default qb, and
       --gnomonic_qb 0) on 20 views it renders and writes first: each
       stage's first step is held against the plain versions' step, and the
       loss on that step's views must fall by 1% over the stage;
  13.  the q-split stripe composite (K6) and its replay backward (K8) at
       qb = 128 on the 128^3 blob pose (K8 through the band kernel, held
       bit-equal to the three launches it replaced, both timed, with each
       band's union of needed positions against its q-blocks' own counts);
       K7 and K8, each beside the three launches, split by launch under
       torch.profiler in a process of its own (``--stripe-split``: the
       band path's trace must name no march and no fold kernel); and one
       gnomonic_train_step_multi with fused=False, qb = 128 against the
       plain versions' step;
  14.  the slab-march render (K9) and its replay backward (K10) on one
       bricked pose of the blob model (400 x 400, tile 16, K = 2, the
       serving occupancy threshold), and on an opaque copy, where the early
       exit must end tiles; K9 and K10 also on the bricked trainer's batch
       of 64 tiles of that pose, K10's call, its kernel alone (into a
       cotangent zeroed before) and the cotangent's zeroing timed apart
       (CUDA events), with its tap products, global atomics and steps
       summed in shared memory or added directly; K9's table entries a tile
       (max, mean, empty tiles), live samples, registers a thread and
       blocks an SM;
  15.  bricked serving through the entry points: the blob model saved with
       render_procedure="render_sh_voxel_grid_bricked", loaded, 8 poses
       through render_poses, held against the plain render;
  16.  the training CLI with --render_procedure render_sh_voxel_grid_bricked
       (64^3 then 128^3, 4 steps a stage, 64 tiles a step): each stage's
       first step against the plain versions' step with the same tiles and
       theta, and the loss on those tiles falling by 1% over the stage;
  17.  the plane-march render (K11) and its replay backward (K12) on one
       planes pose of the blob model (400 x 400, tile 16, P = 2, the serving
       occupancy threshold), and on an opaque copy, where the early exit
       must end tiles; K11 also at the render CLI's frame (phase 19's
       second pose, 800 x 800, 2500 tiles); its table entries a tile, live
       positions, registers a thread and blocks an SM; K12's call, its
       kernel alone (into a cotangent zeroed before) and the zeroing timed
       apart, with its tap products, global atomics and steps summed in
       shared memory or added directly, its registers and blocks an SM;
  18.  planes serving through the entry points: the blob model saved with
       render_procedure="render_sh_voxel_grid_planes", loaded, 8 poses
       through render_poses, held against the plain render; the gradient
       through repack_plane_grid and plane_march against the plain versions';
  19.  the render CLI, main([...]) in-process on the planes model: 7 frames
       of 800 x 800 into rendered_video.gif, whose blocks are checked;
  20.  the one-hot gather (K13) and its scatter-add (K14) against their plain
       versions at the JAX package's test shapes and at the trilinear corners
       of 256K samples in an 8^3 brick, with embedding_bag and its dense
       backward (and index_add_) timed beside them, K13 also at the shape
       of the weights' cotangent (K = 1 on 2M rows), K13 and K14 at B =
       4096 (K14 past shared memory), and the differentiable gather.
  21.  the reference's quality gates (tools/run_quality_gates.py's scene,
       camera and thresholds) on the port: the exact renderer
       (render_sh_voxel_grid, the default procedure) at 1024 samples a ray,
       and gnomonic at P = 1, 2, 4, P = 2 with the gather warp and with warp
       order 5 in both forms, bricked at K = 1, 2, 4, each through
       VolumetricModel.render and gated on its PSNR against the exact
       render; through the port's tools/run_quality_gates, the bricked
       occupancy skip against neither skip nor exit (> 60 dB) and gnomonic
       P = 2 on the sharp (voxel-noise) scene against its own exact render
       (> 30 dB); the exact render on the card against the CPU on a 64 x 64
       crop;
  22.  one gnomonic_train_step_multi through warp order 5 and one through
       the gather warp (phase 8's first step), each against its plain step;
  23.  the held-out tester with LPIPS on phase 12's test views, and LPIPS on
       the card against the CPU on one pair;
  24.  timings: the exact render a pose, orders 3 and 5 and both warp forms a
       gnomonic pose, the B-spline prefilter alone (both passes' operands,
       beside its row recursion) and LPIPS at 400 x 400;
  25.  the fast two-phase renderer's gates (fast top-32 > 25 dB, top-64 >
       31 dB against the exact render at 512 samples a ray; the
       hierarchical render's dB beside them, no gate), the fast and
       hierarchical renders on the card against the CPU on phase 21's crop,
       and flat rays through the gnomonic, bricked and planes procedures
       equal to the fast render;
  26.  one ray-batch train step (2048 rays x 512 samples, top 64 and K = S)
       through the fast and the hierarchical renderers, card against CPU
       with the same draws (fast: loss rtol 1e-5, gradient cosine > 0.99999;
       hierarchical: 5e-5, 0.99995);
  27.  five ray-batch steps at the CLI's full width (256^3, 16384 rays x 512
       samples, top 64, packed f32 features): the loss on a fixed batch
       falls; peak memory, ms a step and rays/s, and a step's split
       (packing forward and backward, forward, backward, Adam);
  28.  the training CLI in-process through the fast renderer, the
       hierarchical renderer, and a softplus field routed from the gnomonic
       default to the fast renderer (64^3 then 128^3, 4 steps a stage): the
       checkpoints load in the port, the held-out test with LPIPS ran.
  29.  3inFusion (the diffusion package and its training CLI): the CLI's
       UNet on the card against the CPU on a 32^3 crop, batch 2 (output
       and a p_sample step within 1e-4 of their scale, a train step's loss
       rtol 1e-5, its gradient cosine > 0.99999); main([...]) at the CLI's
       widths, diffusion and crop ratio on phase 5's saved 128^3 scene
       (crop 112^3, DIFF_BATCH crops a step, DIFF_STEPS steps, the in-loop
       mosaic once, nothing logged as failed): ms a step, voxels/s, peak
       memory, the loss on a fixed batch falling; the final checkpoint
       reloaded to equal leaves; two samples of 25 reverse steps rendered
       through phase 5's gnomonic procedure into a mosaic (K1 and K2
       counted), ms a reverse step; a train step with TF32 on beside it
       in f32, and the f32 step's top kernels under torch.profiler.
  30.  multi-GPU training under a one-rank NCCL group: the gnomonic mesh step
       (phase 8's first step: 4 views, its phases) against
       gnomonic_train_step_multi (metrics bit-equal, Adam's first moments
       cosine > 0.99999: K4 adds rows out of order with f32 atomics), the
       bricked mesh step at (1, 1) on 64 tiles of those views of the blob
       grid against bricked_train_step (loss rtol 1e-6, moments cosine >
       0.99999: K10's atomics), and one full-width ray-batch step (phase
       27's start and fixed batch) against ray_batch_train_step (loss rtol
       1e-6, gradient cosine > 0.99999);
  31.  two ranks on the one card under gloo with CUDA tensors (NCCL refuses
       two ranks on one device), spawned: the gnomonic step at n_dev 2, k 2,
       the bricked step at (1, 2) (K9 / K10 at group_offset G / 2 on rank 1)
       and at (2, 1), each against phase 30's single-device step over the
       same 4 views or 64 tiles (loss rtol 1e-5, moments cosine > 0.99999;
       > 0.9999 across depth segments, which compose through 1 - acc; the
       two ranks' grids bit-identical), each rank's second step's ms;
  32.  the training CLI with --use_mesh true at one rank (its own NCCL
       group), 2 stages of 4 steps on phase 12's dataset: every step went
       through gnomonic_train_step_mesh, K1-K4 counted.
  33.  the training CLI's default recipe at full width: the port's
       make_synthetic_dataset renders 20 + 4 views of 800 x 800 of a 128^3
       blob scene at 1024 samples a ray, and main([...]) runs every
       default (256^3 in four stages from 32^3, data halved, gnomonic with
       qb = 128) but RECIPE_STEPS steps a stage and the save, test and
       feedback frequencies: each stage's first step against the plain
       versions' whole step (loss rtol 1e-5, gradient cosine > 0.99999),
       the loss on its views falling by 1%, K1-K4 launched and K5-K8 not;
       ms/step, peak memory, held-out PSNR, and the stage Stage::fit chose
       for K1 and K3 with their direct tiles on one view; the checkpoints,
       a --resume_from at stage 4 with its Adam moments (two finite
       steps), and the render CLI on model_final with its checkpoint load,
       render and GIF encoding timed apart.
Phase 14 also holds K9 / K10 at group_offset > 0 (the second of two depth
segments of the pose's slab groups) against their plain versions.
The launch counts of phases 5, 8, 11, 12, 13, 15, 16, 18, 19, 20, 21, 22, 29, 30, 32 and 33, each
reset just before its run, show the paths went through the kernels; one more
pass of phases 5, 8, 15 and 18 under torch.profiler prints the device time
and the device's busy share.

Prints the card's name and power limit first, one JSON line of per-kernel
results before the last line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase raises and the script exits non-zero without that line; it
also exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. Imports nothing of JAX.

    python3 chip_smoke.py --readings PORT_ROOT

reads K5 (phase 9's serving pose and training operands), K6 (phase 13's
serving pose), K7 and K8 (``stripe_split``: phases 10 and 13's training
operands, the call and the three launches split by launch, a hash of the
output), K9 and K10 (phase 14's pose and its 64-tile batch; K10's
call, its kernel alone on CUDA events and under torch.profiler, and the
zeroing), K11 (phase 17's pose and the render CLI's frame), K12 (the
pose, in its tiles of 16 x 16 and of 8 x 8 pixels: the call, the kernel
alone and under torch.profiler, the zeroing, its counts where the port's
wrapper takes ``stats``) and K13 (phase 20's three shapes: K = 8, the
weights' cotangent at K = 1 and B = 4096) on the operands those phases
build, with the port package of the
checkout at PORT_ROOT (built there): a parent commit's readings in the
same call as this one's, on one card. K9's and K11's registers a thread
and blocks an SM come from the port's march_launch_shape where it has
one, else from ptxas's log of the build and the occupancy rule for a
thread a ray. It prints them as one JSON line and the card's name and
power limit; no kernel is held against its plain version in this mode.

    python3 chip_smoke.py --diffusion-batch B

runs one full-width 3inFusion train step (the CLI's UNet, 112^3 crops of
the 128^3 blob scene) at batch B and prints its peak memory or that it ran
out of memory: how DIFF_BATCH was chosen.

    python3 chip_smoke.py --full-recipe

runs phase 33 alone after the build and prints its results as one JSON
line.

    python3 chip_smoke.py --stripe-split

prints K7's and K8's split by launch (``stripe_split``) and then one JSON
line; phase 13 runs it, since torch.profiler reads kernels short or not at
all late in a long process on the card's machine.
"""
import contextlib
import ctypes
import gc
import hashlib
import inspect
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

REPO = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
GRID_SIZE, IMAGE_SIZE, NUM_POSES = 128, 400, 8
CLI_VIEWS, CLI_SIZE = (16, 4), 800  # the CLI's dataset: (train, test) views, pixels
CLI_GRID = 128  # the CLI's final grid; its first stage is half that
CLI_STEPS = 4  # the CLI's steps per stage
ONEHOT_BCNK = (512, 128, 262_144, 8)  # phase 20: trilinear corners of 256K samples, 8^3 brick
ONEHOT_LARGE_B = 4096  # phase 20: K14 past shared memory (its global-atomic branch)
# 50-60 ms at the H100's 1.6-2.0 GHz: longer than the host takes to queue 50
# calls of a kernel's wrapper (tens of microseconds each)
QUEUE_CYCLES = 100_000_000
K2_READINGS = 7  # phase 3: device-clock readings of K2's bilinear pass and F.grid_sample
# phase 14: the bricked trainer's tiles a step at the CLI's ray batch (16384 // 256)
K10_BATCH_TILES = 64


def load_port():
    """Import the port's modules (the repository root must be on sys.path)."""
    from thr3ed_atom_tpu_torch import kernels
    from thr3ed_atom_tpu_torch.apps import render_sh_voxel_grid as rcli
    from thr3ed_atom_tpu_torch.apps import train_sh_voxel_grid as cli
    from thr3ed_atom_tpu_torch.data import dataset, png
    from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid, voxel_grid_from_numpy
    from thr3ed_atom_tpu_torch.modules import bricked_trainer as bt
    from thr3ed_atom_tpu_torch.modules import trainer
    from thr3ed_atom_tpu_torch.modules import volumetric_model as vm
    from thr3ed_atom_tpu_torch.ops import onehot_gather as og
    from thr3ed_atom_tpu_torch.ops import plane_march as pm
    from thr3ed_atom_tpu_torch.ops import relu_trap as rt
    from thr3ed_atom_tpu_torch.ops import slab_march as sm
    from thr3ed_atom_tpu_torch.rendering import bricked as br
    from thr3ed_atom_tpu_torch.rendering import planes as pl
    from thr3ed_atom_tpu_torch.rendering import gnomonic as gn
    from thr3ed_atom_tpu_torch.rendering import gnomonic_train as gt
    from thr3ed_atom_tpu_torch.rendering import warp_matmul as wm
    from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
    from thr3ed_atom_tpu_torch.utils import camera

    return dict(kernels=kernels, voxel_grid_from_numpy=voxel_grid_from_numpy,
                VoxelGrid=VoxelGrid, vm=vm, rt=rt, gn=gn, gt=gt, wm=wm,
                trainer=trainer, Config=SHVoxGridRenderConfig, camera=camera, cli=cli,
                png=png, br=br, sm=sm, bt=bt, pl=pl, pm=pm, og=og, rcli=rcli,
                dataset=dataset)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def blob_scene(grid_size, seed=3, num_blobs=6):
    """The port's make_synthetic_dataset blob scene, converged (the JAX
    tool's arrays bit for bit): soft density blobs with random colours and
    mild view dependence, empty space at -1 under identity pre- / relu
    post-activation. Returns (densities, features, grid config)."""
    from thr3ed_atom_tpu_torch.tools.make_synthetic_dataset import blob_scene_arrays

    return blob_scene_arrays(grid_size, seed, num_blobs, converged=True)


def time_ms(torch, fn, iters):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events). The calls are queued behind a device-side sleep of QUEUE_CYCLES,
    so a kernel shorter than its launch path on the host is timed at the
    device's pace, not the host's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_paced(torch, fn, iters, repeats=3):
    """Per-call ms of ``fn`` as the host queues it on an idle device (where a
    call's launch path outlasts its kernel, the device waits on the host):
    ``repeats`` runs of ``iters`` back-to-back calls on CUDA events, each
    with the ms that Python's garbage collector took inside it; and the
    launch path's host ms a call, on the host clock while the device sleeps."""
    pauses, begun = [], []

    def on_gc(phase, _info):
        if phase == "start":
            begun.append(time.perf_counter())
        elif begun:
            pauses.append(time.perf_counter() - begun.pop())

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms, gc_ms = [], []
    gc.callbacks.append(on_gc)
    try:
        for _ in range(repeats):
            pauses.clear()
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end) / iters)
            gc_ms.append(sum(pauses) * 1e3)
    finally:
        gc.callbacks.remove(on_gc)
    torch.cuda._sleep(QUEUE_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    launch_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return dict(ms=ms, gc_ms=gc_ms, launch_ms=launch_ms)


def legacy_rows_call(torch, kernels, wm, adjoint):
    """K2's (``adjoint``: K4's) wrapper as its launch path ran before
    ``kernels.bind`` (library looked up and function typed on every call, a
    ``torch.cuda.Stream`` object per call, checks through device objects),
    around the same kernel: the "before" of the launch-path comparison."""
    lib = "resample_rows_adjoint" if adjoint else "resample_rows"
    args = wm._ROWS_ARGS

    def call(t, pos, order, K_or_taps, taps=False):
        if t.device.type != "cuda" or pos.device != t.device:
            raise ValueError("unsupported devices")
        if t.dtype != torch.float32 or pos.dtype != torch.float32:
            raise TypeError("float32 inputs required")
        if not (t.is_contiguous() and pos.is_contiguous()):
            raise ValueError("contiguous inputs required")
        if order not in (1, 3, 5):
            raise ValueError("unsupported warp order")
        NB, CH, N = t.shape[0], t.shape[-2], t.shape[-1]
        if adjoint:
            K = K_or_taps
            if t.shape != ((NB, 3, CH, N) if taps else (NB, CH, N)) or pos.shape != (NB, 1, N):
                raise ValueError("shapes")
            shape, rest = (NB, CH, K), (NB, CH, K, N, order, int(taps))
        else:
            taps, K, N = K_or_taps, t.shape[2], pos.shape[2]
            if t.dim() != 3 or pos.shape != (NB, 1, N):
                raise ValueError("shapes")
            shape = (NB, 3, CH, N) if taps else (NB, CH, N)
            rest = (NB, CH, K, N, order, int(taps))
        if CH != 8:
            raise ValueError("CH = 8 required")
        out = torch.empty(shape, dtype=torch.float32, device=t.device)
        fn = getattr(kernels.load(lib), lib + "_launch")
        fn.argtypes = args
        fn.restype = ctypes.c_int
        err = fn(t.data_ptr(), pos.data_ptr(), out.data_ptr(), *rest,
                 torch.cuda.current_stream(t.device).cuda_stream)
        kernels.check(err, lib)
        return out

    return call


def launch_parts(torch, kernels, wm, t, pos, order, extra, adjoint, n=2000, n_launch=50):
    """Host microseconds a call of each part of K2's (``adjoint``: K4's)
    launch path, before (``legacy_rows_call``'s steps) and after (the
    wrapper's): the binding, the stream handle, the checks, the output
    allocation, and the ctypes launch itself (``n_launch`` calls queued
    behind a device-side sleep); on the host clock."""
    lib = "resample_rows_adjoint" if adjoint else "resample_rows"
    args = wm._ROWS_ARGS
    NB, CH, N = t.shape[0], t.shape[-2], pos.shape[-1]
    shape = (NB, CH, extra) if adjoint else ((NB, 3, CH, N) if extra else (NB, CH, N))
    rest = ((NB, CH, extra, N, order, 0) if adjoint
            else (NB, CH, t.shape[2], N, order, int(extra)))
    name = "resample_rows_adjoint" if adjoint else "resample_rows"

    def bind_before():
        fn = getattr(kernels.load(lib), lib + "_launch")
        fn.argtypes = args
        fn.restype = ctypes.c_int

    def check_before():
        if t.device.type != "cuda" or pos.device != t.device:
            raise ValueError
        if t.dtype != torch.float32 or pos.dtype != torch.float32:
            raise TypeError
        if not (t.is_contiguous() and pos.is_contiguous()) or order not in (1, 3, 5):
            raise ValueError
        if pos.shape != (t.shape[0], 1, pos.shape[2]) or t.shape[-2] != 8:
            raise ValueError

    def check_after():
        wm._check_rows(name, t, pos, order)
        if pos.shape != (NB, 1, N):
            raise ValueError

    def host_us(fn, count):
        t0 = time.perf_counter()
        for _ in range(count):
            fn()
        return (time.perf_counter() - t0) * 1e6 / count

    fn = kernels.bind(lib, lib + "_launch", args)
    out = torch.empty(shape, dtype=torch.float32, device=t.device)
    s = kernels.stream(t)
    parts = dict(
        bind_before=host_us(bind_before, n),
        bind_after=host_us(lambda: kernels.bind(lib, lib + "_launch", args), n),
        stream_before=host_us(lambda: torch.cuda.current_stream(t.device).cuda_stream, n),
        stream_after=host_us(lambda: kernels.stream(t), n),
        checks_before=host_us(check_before, n),
        checks_after=host_us(check_after, n),
        allocation=host_us(lambda: torch.empty(shape, dtype=torch.float32, device=t.device), n))
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    parts["launch"] = host_us(lambda: fn(t.data_ptr(), pos.data_ptr(), out.data_ptr(), *rest, s),
                              n_launch)
    torch.cuda.synchronize()
    return parts


def parts_str(parts):
    return ", ".join(f"{k} {v:.2f}" for k, v in parts.items())


def paced_str(h):
    return (f"[{', '.join(f'{m:.4f}' for m in h['ms'])}] (gc "
            f"[{', '.join(f'{m:.2f}' for m in h['gc_ms'])}] ms), launch path "
            f"{h['launch_ms']:.4f}")


def device_profile(torch, fn, n, unit, top_n=6):
    """``fn()`` (``n`` poses or steps) once under torch.profiler: (wall ms per
    unit of the profiled pass, device ms per unit summed over kernels, a
    summary of the device launches per unit and the top kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:top_n]
    summary = (f"{sum(e.count for e in events) / n:.1f} device launches/{unit}; top: "
               + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / n:.4f} ms/{unit}"
                           for e in top))
    return wall, device_ms, summary


def kernel_times(torch, fn, n, names, call_ms):
    """Device ms per call of the kernels whose names hold each of ``names``,
    over ``n`` calls of ``fn`` under torch.profiler (after one warm-up
    call), and the share of ``call_ms`` (a call's CUDA-event time) that the
    trace's device time makes up. On the card's machine a trace taken late
    in a process that has run heavy work (this script's phases from 7 on)
    reads short or empty kernels (shares 0-0.92); one taken early in a
    process of its own (``stripe_split``, ``--readings``) reads 0.94-1.0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out, total = dict.fromkeys(names, 0.0), 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            total += e.self_device_time_total / 1e3 / n
            for name in names:
                if name in e.key:
                    out[name] += e.self_device_time_total / 1e3 / n
    return out, total / call_ms


def bound(nbytes, ops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b):
    return float((a - b).abs().max())


def tent_footprint(torch, coord, n):
    """[n, len(coord)] 0/1: the grid lines floor(c) and floor(c) + 1 inside
    [0, n) that a two-tap tent at each coordinate reads."""
    k0 = torch.floor(coord)[None, :]
    lines = torch.arange(n, dtype=torch.float32, device=coord.device)[:, None]
    return ((lines == k0) | (lines == k0 + 1.0)).to(torch.float32)


def composite_records(torch, work, geom, nvert, nu, nv, P):
    """Distinct (vertex, u, v) records the composite's marched (position,
    texel) pairs read: the 2 x 2 tent footprints of each position's marched
    texels on vertex j // P and, for an interior position, on the next one."""
    NP, Pn, Qn = work.shape
    dev = work.device
    pf = torch.arange(Pn, dtype=torch.float32, device=dev)
    qf = torch.arange(Qn, dtype=torch.float32, device=dev)
    need = torch.zeros((nvert, nu, nv), dtype=torch.bool, device=dev)
    for j in range(NP):
        if not bool(work[j].any()):
            continue
        au = tent_footprint(torch, geom[j, 2] + geom[j, 3] * pf, nu)  # [nu, Pn]
        av = tent_footprint(torch, geom[j, 4] + geom[j, 5] * qf, nv)  # [nv, Qn]
        hit = (au @ work[j].to(torch.float32) @ av.T) > 0  # exact: 0/1 sums
        need[min(j // P, nvert - 1)] |= hit
        if P > 1 and j % P:
            need[min(j // P + 1, nvert - 1)] |= hit
    return int(need.sum())


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def resample_sources(torch, pos, order, K):
    """Source samples [NB, K] that a resample at ``pos`` [NB, 1, N] reads:
    floor(pos) - 1 .. floor(pos) + 2 for order 3 (two taps for order 1)."""
    k0 = torch.floor(pos[:, 0]).long()  # [NB, N]
    # column K collects the taps outside [0, K)
    need = torch.zeros((pos.shape[0], K + 1), dtype=torch.bool, device=pos.device)
    for t in ((-1, 0, 1, 2) if order == 3 else (0, 1)):
        k = k0 + t
        k = torch.where((k >= 0) & (k < K), k, K)
        need.scatter_(1, k, torch.ones_like(k, dtype=torch.bool))
    return int(need[:, :K].sum())


def psnr(a, b):
    mse = float(((a - b) ** 2).mean())
    return float("inf") if mse == 0 else -10.0 * float(np.log10(mse))


def stripe_case(torch, gn, grid, st, rot, org, size, focal, ss, phase=None):
    """The stripe composite's operands for one pose (``st`` with qb = 0, or
    qb > 0 for the q-split grain), and how many elements of the u-resampled
    stack t1 differ from an f32 reference (each sums at most two exact bf16
    products, so none may)."""
    gn._strict_f32()
    Pn, Qn, PB, Pb = gn.gnomonic_frame(None, size, size, None, ss, st)
    slices = gn.repack_position_slices(grid, st, vertex_only=False)
    geo = gn.gnomonic_geometry(rot, org, st, size, size, focal, ss, phase=phase, lite=False,
                               skip_basis=False)
    t1 = gn.resample_u(slices, geo.Ru)
    ref = torch.einsum("jpu,jucv->jcpv", geo.Ru.float(), slices.float()).to(torch.bfloat16)
    mismatch = int((t1 != ref).sum())
    del ref
    occ = gn.gnomonic_occupancy(slices, geo.Ru, st, PB, Pb, RvT=geo.RvT,
                                QB=gn._qb_blocks(st, Qn)[0])
    return (t1, geo.RvT, geo.ybasis, geo.live_u, geo.live_v, geo.norm, geo.geom, st,
            Pn, Qn, PB, Pb, occ), mismatch


def stripe_plain(gn, args):
    """The plain version of the stripe composite the operands select: K5's,
    or K6's for q-split flags."""
    qsplit = args[12][0].dim() == 3
    return (gn.composite_positions_qb_plain if qsplit else gn.composite_positions_plain,
            "K6" if qsplit else "K5")


def stripe_compare(torch, gn, args, label):
    """K5 (or K6, q-split flags) against its plain version at the kernel's
    exit grain: colour / acc (and diffuse) within 1e-4, depth within 1e-3, as
    K1. Returns the per-row gaps and the marched (position, texel) mask."""
    plain, k = stripe_plain(gn, args)
    got = gn.composite_positions(*args)
    torch.cuda.synchronize()
    want, work = plain(*args, exit_tile=gn.CUDA_EXIT_TILE, return_work=True)
    gap = (got - want).abs().amax(dim=(1, 2)).tolist()
    check(bool(torch.isfinite(got).all()), f"{k} ({label}) produced non-finite values")
    check(max(gap[:5] + gap[6:]) <= 1e-4 and gap[5] <= 1e-3,
          f"{k} vs plain ({label}): per-row max-abs {gap}")
    check(float(want[4].max()) > 0.5, f"{k} ({label}): the scene is not hit")
    print(f"# {k} composite_stripe {label}: max-abs per row {gap}; marched pairs "
          f"{int(work.sum())} of {work.numel()}", flush=True)
    return gap, work


def stripe_counts(torch, args, work):
    """(bytes read, operations) of the stripe march over the marched pairs
    ``work``: t1's used channels on each marched texel row of a position at
    the v rows its tents reach, the tents' nonzero taps, geometry, flags, the
    basis and norm of marched texels, the liveness; 2 taps (mul, add) per
    used channel and the SH fold per marched pair."""
    t1, rvt, _, _, _, _, _, st, Pn, Qn, PB, _, _ = args
    NP = t1.shape[0]
    nc, used = st.ncoeff, 3 * st.ncoeff + 1
    rows = work.any(dim=2).sum(dim=1).double()
    vrows = (rvt != 0).any(dim=2).sum(dim=1).double()
    t1_elems = int((rows * vrows).sum()) * used
    texels = int(work.any(dim=0).sum())
    nbytes = (t1_elems * 2 + int((rvt != 0).sum()) * 2 + NP * 8 * 4
              + 2 * args[12][0].numel() * 4
              + (nc + 1) * texels * 4 + NP * (Pn + Qn) * 4)
    return nbytes, int(work.sum()) * (used * 4 + 3 * nc * 2)


@contextlib.contextmanager
def nan_allocations(torch):
    """Inside the block torch.empty hands out floating-point tensors filled
    with NaN, so that an output element a kernel leaves unwritten shows (the
    caching allocator would hand back memory that an earlier call zeroed)."""
    empty = torch.empty

    def nan_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    torch.empty = nan_empty
    try:
        yield
    finally:
        torch.empty = empty


# the kernels of csrc/composite_stripe_backward.cu, as torch.profiler names them
STRIPE_BACKWARD_KERNELS = ("column_taps_kernel", "stripe_band_kernel", "stripe_march_kernel",
                           "stripe_fold_kernel")


def stripe_backward_args(torch, args, state, gen):
    """The replay backward's operands (composite_backward's arguments) on
    the stripe operands ``args``: a state cotangent drawn from ``gen`` and
    gaux, its S_total and T_final rows from the forward ``state``."""
    t1, ops, st, frame, occ = args[0], args[1:7], args[7], args[8:12], args[12]
    gstate = torch.randn(state.shape, generator=gen, device=state.device)
    gaux = torch.cat([gstate, (gstate[1:] * state[1:]).sum(0)[None], state[0:1]])
    return (t1, *ops, gaux, occ, st, *frame)


def union_schedule(pos_needed):
    """For q-split flags [PB, QB, NP]: each u-block band's union of needed
    positions (the band kernel's phases), each q-block's own count, and the
    share of (texel, phase) pairs in which a texel's q-block sits the phase
    out."""
    per_block = pos_needed.sum(-1)  # [PB, QB]
    union = (pos_needed != 0).any(1).sum(-1)  # [PB]
    idle = 1.0 - float(per_block.sum()) / max(float(union.sum()) * pos_needed.shape[1], 1.0)
    return dict(union=union.tolist(), per_block=per_block.tolist(), idle_share=idle)


def stripe_backward_compare(torch, gn, gt, args, work, gen, label):
    """K7 (or K8, q-split flags) against its plain version on a seeded state
    cotangent: max-abs within 1e-2 of the largest element, cosine > 0.99999
    (K3's bound), pad channels and dead blocks zero (dt1 allocated
    NaN-filled). Returns (max-abs, cosine, ms, plain ms, bound, extra).
    The wrapper must take the band kernel (not the three launches). Also
    the three launches the band kernel replaced, on the same operands:
    bit-equal to the band kernel (checked) and timed, the bytes of their
    cotangent buffer, the band kernel's launch plan and, for K8, each band's
    union of needed positions against its q-blocks' own counts (the split
    by launch: ``stripe_split``)."""
    t1, ops, st, frame, occ = args[0], args[1:7], args[7], args[8:12], args[12]
    qsplit = occ[0].dim() == 3
    k = "K8" if qsplit else "K7"
    backward_plain = gt.composite_backward_qb_plain if qsplit else gt.composite_backward_plain
    bargs = stripe_backward_args(torch, args, stripe_plain(gn, args)[0](*args), gen)
    gaux = bargs[7]
    three_launch_fn, taken = gt.stripe_backward_three_launch, []
    gt.stripe_backward_three_launch = lambda *a: taken.append(a) or three_launch_fn(*a)
    try:
        with nan_allocations(torch):
            got = gt.composite_backward(*bargs)
        torch.cuda.synchronize()
    finally:
        gt.stripe_backward_three_launch = three_launch_fn
    check(not taken, f"{k} ({label}) took the three launches, not the band kernel")
    want = backward_plain(*bargs)
    err, scale = max_abs(got.float(), want.float()), float(want.float().abs().max())
    cos = cosine(got.float(), want.float())
    used = 3 * st.ncoeff + 1
    check(scale > 0.0 and err <= 1e-2 * scale and cos > 0.99999,
          f"{k} vs plain ({label}): max-abs {err} (scale {scale}), cosine {cos}")
    check(not bool(got[:, used:].any()), f"{k} ({label}) wrote pad channels")
    Pn, Qn, PB, Pb = frame
    dead = (occ[1] == 0).reshape(PB, -1, occ[1].shape[-1]).all(1).T.repeat_interleave(Pb, 1)
    check(not bool(got.permute(0, 2, 1, 3)[dead].any()), f"{k} ({label}) wrote dead blocks")
    ms = time_ms(torch, lambda: gt.composite_backward(*bargs), 5)
    plain_ms = time_ms(torch, lambda: backward_plain(*bargs), 1)
    # bytes: the replay's reads (as K5), the cotangent rows of texels in
    # needed blocks, dt1 written; ops: the replay, ~120 per pair for the
    # cell's backward, the SH fold back, and the v-fold (2 taps x mul+add per
    # used channel and column) of every needed texel row
    rb, rops = stripe_counts(torch, args, work)
    QB, Qb = gn._qb_blocks(st, Qn)
    needed_texels = int(occ[1].any(dim=-1).sum()) * Pb * Qb
    nbytes = rb + gaux.shape[0] * needed_texels * 4 + got.numel() * 2
    nops = (rops + int(work.sum()) * (120 + used * 2)
            + int(occ[1].sum()) * Pb * used * Qb * 4)
    print(f"# {k} composite_stripe_backward {label}: max-abs {err:.3g} of {scale:.3g}, cosine "
          f"{cos:.9f}; ms={ms:.4f} plain_ms={plain_ms:.4f}; dt1 {tuple(got.shape)}", flush=True)
    checked = gn._check_stripe_operands(k, t1, *ops, occ, st, *frame)
    g32 = gaux.contiguous()

    def three_launch():
        return three_launch_fn(checked, g32, st, Pn, Qn, Pb, QB, Qb)

    with nan_allocations(torch):
        old = three_launch()
    torch.cuda.synchronize()
    old_err = max_abs(got.float(), old.float())
    check(torch.equal(old, got), f"{k} ({label}): the band kernel differs from the three "
          f"launches by {old_err}")
    old_ms = time_ms(torch, three_launch, 5)
    _, n_slots = gt.dvals_slots(checked[8])
    dvals_bytes = n_slots * used * Pb * Qb * 2
    aligned = t1.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t1.stride()[:3])
    plan = gt.stripe_band_plan(Qn, Pb, t1.shape[0], used, t1.shape[3], aligned, QB)
    sched = union_schedule(occ[1]) if qsplit else None
    union_line = ("" if sched is None else
                  f"; {QB} q-blocks of {Qb}: each band's union of needed positions "
                  f"{sched['union']} against its q-blocks' own counts {sched['per_block']}, "
                  f"(texel, phase) pairs sitting out {sched['idle_share']:.4f}")
    print(f"# {k} {label}: band kernel, clusters of {plan.S} CTAs of {plan.R} x "
          f"{plan.Qc} texels ({plan.threads} threads), {plan.smem} bytes of shared memory, "
          f"t1 staged {plan.staged}{union_line}. The three launches on the same operands: "
          f"ms={old_ms:.4f}, their cotangent buffer {n_slots} slots = {dvals_bytes} bytes; "
          f"bit-equal to the band kernel", flush=True)
    extra = dict(band_plan=plan._asdict(), three_launch_ms=old_ms,
                 three_launch_dvals_bytes=dvals_bytes, three_launch_bit_equal=True)
    if sched is not None:
        extra["union_schedule"] = sched
    del old, checked, g32
    return err, cos, ms, plain_ms, bound(nbytes, nops), extra


def resample_operands(wm, call):
    """(X, positions, order, taps) of every resample_rows call that ``call()``
    makes; run it with the plain versions (nothing is launched)."""
    seen, original = [], wm.resample_rows

    def record(X, pos, order, taps=False, plain=False):
        seen.append((X.detach().clone(), pos.clone(), order, taps))
        return original(X, pos, order, taps, plain=plain)

    wm.resample_rows = record
    try:
        call()
    finally:
        wm.resample_rows = original
    return seen


def uncounted(counters, fn):
    """``fn()`` with the launch counts put back as they were afterwards: the
    launches of a check are not the main path's."""
    saved = {name: c.launches for name, c in counters.items()}
    try:
        return fn()
    finally:
        for name, c in counters.items():
            c.launches = saved[name]


def views_loss(torch, gt, tstat, grid, views):
    """The step's objective (mean over the views) on ``views`` = (images,
    rotations, origins, focal, phases), forward only."""
    images, rots, orgs, focal, phases = views
    with torch.no_grad():
        return float(sum(gt._pose_loss(tstat, grid, images[i], rots[i], orgs[i], focal,
                                       phase=phases[i])[0] for i in range(len(phases)))
                     / len(phases))


def recording_step(torch, gt, original_step, counters, steps, firsts):
    """A stand-in for gnomonic_train_step_multi that times each step (CUDA
    synchronized) into ``steps`` as (grid size, fused, ms, loss), keeps each
    stage's first step in ``firsts`` (the grid it started from, its views
    and phases, loss and gradient) and, after the stage's CLI_STEPS-th step,
    the loss on those views; those evaluations' launches are not counted."""

    def timed_step(tstat, optimizer, grid, images, rots, orgs, focal, generator=None,
                   *, phases=None, **kw):
        # the phases drawn here as the step draws them, so that a stage's
        # first step can be replayed through the plain versions
        if phases is None:
            phases = [None if generator is None else gt.draw_phase(generator)
                      for _ in images]
        dims = tstat.statics.dims[0]
        first = dims not in firsts
        if first:
            start = (grid.densities.detach().clone(), grid.features.detach().clone())
            loss_before = uncounted(counters, lambda: views_loss(
                torch, gt, tstat, grid, (images, rots, orgs, focal, phases)))
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        m = original_step(tstat, optimizer, grid, images, rots, orgs, focal,
                          phases=phases, **kw)
        torch.cuda.synchronize()
        steps.append((dims, tstat.fused, (time.perf_counter() - t_step) * 1e3,
                      float(m["total_loss"])))
        if first:
            firsts[dims] = dict(
                tstat=tstat, start=start, voxel_size=grid.voxel_size,
                config=grid.get_config_dict(), loss=steps[-1][3],
                loss_before=loss_before, views=(images, rots, orgs, focal, phases),
                grads=(grid.densities.grad.clone(), grid.features.grad.clone()))
        elif sum(s_[0] == dims for s_ in steps) == CLI_STEPS:
            rec = firsts[dims]
            rec["loss_after"] = uncounted(counters, lambda: views_loss(
                torch, gt, rec["tstat"], grid, rec["views"]))
        return m

    return timed_step


def check_stage_first_steps(torch, port, firsts, qb):
    """Each CLI stage's first step against the same step through the plain
    versions (on a copy of the grid the step started from, the same views
    and phases): loss within rtol 1e-5, grid gradient cosine > 0.99999 (the
    bounds of phase 8); and the stage's progress on those views: their loss,
    evaluated alone before the first step (equal to the step's, rtol 1e-5)
    and after the stage's last step, falls by at least 1%."""
    out = {}
    for dims, rec in sorted(firsts.items()):
        plain_loss, cos = replay_first_step(torch, port, rec)
        check(abs(rec["loss"] - plain_loss) <= 1e-5 * plain_loss and min(cos) > 0.99999,
              f"CLI qb={qb}: stage {dims}^3 first step vs plain: loss {rec['loss']} vs "
              f"{plain_loss}, gradient cosines {cos}")
        check(abs(rec["loss_before"] - rec["loss"]) <= 1e-5 * rec["loss"],
              f"CLI qb={qb}: stage {dims}^3 views' loss {rec['loss_before']} before the "
              f"first step, the step's {rec['loss']}")
        check(rec["loss_after"] <= 0.99 * rec["loss_before"],
              f"CLI qb={qb}: stage {dims}^3 loss on its first step's views "
              f"{rec['loss_before']} -> {rec['loss_after']} after its last step")
        out[f"{dims}^3"] = dict(loss=rec["loss"], plain_loss=plain_loss, grad_cos=cos,
                                loss_before=rec["loss_before"], loss_after=rec["loss_after"])
    return out


def replay_first_step(torch, port, rec):
    """A recorded first step through the plain versions, on a copy of the
    grid it started from (on the card), with its views and phases. Returns
    the plain loss and the cosines of the recorded grid gradients against
    the plain ones (densities, features)."""
    d0, f0 = (t.to(rec.get("device", "cuda")) for t in rec["start"])
    g = port["VoxelGrid"](d0, f0, voxel_size=rec["voxel_size"], **rec["config"])
    opt, sched = port["trainer"].make_gnomonic_optimizer(g, 0.03)
    m = port["gt"].gnomonic_train_step_multi(rec["tstat"], opt, g, *rec["views"][:4],
                                             phases=rec["views"][4], scheduler=sched,
                                             plain=True)
    cos = [cosine(a.to(b.device), b)
           for a, b in zip(rec["grads"], (g.densities.grad, g.features.grad))]
    return float(m["total_loss"]), cos


def make_posed_dataset(torch, camera, png, model, root, views, size):
    """``views`` = (train, test) views of ``model`` at size x size (focal
    1.1 size, radius 4, seeded poses) rendered through the serving path and
    written in the JAX package's layout: root/<split>/r_<i>.png (RGB) and
    root/<split>_camera_params.json."""
    rng = np.random.default_rng(5)
    intr = camera.CameraIntrinsics(size, size, size * 1.1)
    for mode, n in zip(("train", "test"), views):
        poses = [camera.pose_spherical(rng.uniform(0, 360), rng.uniform(-80, -10), 4.0)
                 for _ in range(n)]
        colour = model.render_poses(poses, intr).colour.clamp(0.0, 1.0).cpu().numpy()
        (root / mode).mkdir(parents=True)
        params = {}
        for i, pose in enumerate(poses):
            name = f"r_{i}.png"
            png.write_png(root / mode / name, camera.to8b(colour[i]))
            params[name] = {
                "intrinsic": {"bounds": [2.0, 6.0], "height": size, "width": size,
                              "focal": size * 1.1},
                "extrinsic": {
                    "rotation": np.asarray(pose.rotation, np.float32).reshape(3, 3).tolist(),
                    "translation": np.asarray(pose.translation,
                                              np.float32).reshape(3, 1).tolist(),
                },
            }
        (root / f"{mode}_camera_params.json").write_text(json.dumps(params))


def check_cli_run(torch, trained, out_dir, steps, counts, qb):
    """The checks of one CLI run: a finite final grid; the JAX package's
    checkpoint names with their _opt.npz; 4 steps per stage through the
    expected pipeline; a held-out PSNR per stage; K1 / K3 launched and K5 /
    K7 not (qb > 0), or the reverse (qb = 0). Returns ms/step (steps 2-4) and
    losses per stage and the held-out PSNRs."""
    g = trained.thre3d_repr
    check(g.grid_dims == (CLI_GRID,) * 3, f"CLI qb={qb}: final grid {g.grid_dims}")
    check(all(bool(torch.isfinite(t).all()) for t in (g.densities, g.features)),
          f"CLI qb={qb}: non-finite grid")
    saved = out_dir / "saved_models"
    for it, stage in ((1, 1), (2, 1), (4, 1), (5, 2), (6, 2), (8, 2)):
        stem = saved / f"model_stage_{stage}_iter_{it}"
        for suffix in (".npz", ".json", "_opt.npz"):
            check(Path(str(stem) + suffix).exists(), f"CLI qb={qb}: missing {stem}{suffix}")
    check((saved / "model_final.npz").exists(), f"CLI qb={qb}: missing model_final")
    check(len(steps) == 8 and all(f == (qb > 0) for _, f, _, _ in steps),
          f"CLI qb={qb}: steps {[(d, f) for d, f, _, _ in steps]}")
    losses, ms = {}, {}
    for dims, _, t, loss in steps:
        losses.setdefault(dims, []).append(round(loss, 5))
        ms.setdefault(dims, []).append(t)
    check(all(len(ls) == CLI_STEPS for ls in losses.values()), f"CLI qb={qb}: losses {losses}")
    summaries = [json.loads(line) for line in
                 (out_dir / "training_logs" / "summaries.jsonl").read_text().splitlines()]
    test_psnr = {s["step"]: round(s["value"], 3) for s in summaries
                 if s["name"] == "TEST_SET_PSNR"}
    check(sorted(test_psnr) == [4, 8], f"CLI qb={qb}: held-out tests at {sorted(test_psnr)}")
    mine = ("composite_fused", "composite_backward_fused")
    other = ("composite_stripe", "composite_stripe_backward")
    if qb == 0:
        mine, other = other, mine
    check(all(counts[k] > 0 for k in mine + ("resample_rows", "resample_rows_adjoint"))
          and all(counts[k] == 0 for k in other), f"CLI qb={qb}: launches {counts}")
    return dict(ms_per_step={f"{d}^3": round(float(np.mean(v[1:])), 3) for d, v in ms.items()},
                losses={f"{d}^3": v for d, v in losses.items()}, test_psnr=test_psnr)


def slab_counts(ops, work, ncoeff, out_elems, shade_ops=50):
    """(bytes, operations) of the slab march (K9) or the plane march (K11) on
    ``ops`` = (tables, counts, rays, grid) with the plain version's ``work``
    = (live samples or positions marched, 32-lane records read): the tiles'
    live table entries, the ray records, the used channels of every record
    the taps read, the output; per live sample the tents (~20), 4 taps x
    (mul, add) per used channel, the SH fold and ``shade_ops`` for the
    shading and compositing (~50; ~80 for a plane-march cell with its
    relu_trap)."""
    tables, counts, rays, _ = ops
    n_samples, touched = work
    nused = 3 * ncoeff + 1
    nbytes = (int(counts.sum()) * 16 + rays.numel() * 4 + int(touched.sum()) * nused * 2
              + out_elems * 4)
    return nbytes, n_samples * (20 + 8 * nused + 2 * 3 * ncoeff + shade_ops)


def table_stats(counts):
    """(max, mean, empty tiles) of a march's table entries a tile."""
    c = counts[:, 0].float()
    return int(c.max()), float(c.mean()), int((c == 0).sum())


def ptxas_registers(log, kernel, ncoeff, relu, diffuse):
    """ptxas's registers a thread of ``kernel``<ncoeff, relu, diffuse> in an
    nvcc log built with -Xptxas -v; None where the log does not name it."""
    tag = f"{kernel}ILi{ncoeff}ELb{int(relu)}ELb{int(diffuse)}E"
    found = False
    for line in (log or "").splitlines():
        if "Compiling entry function" in line:
            found = tag in line
        elif found and "Used" in line and "registers" in line:
            return int(line.split("Used")[1].split("registers")[0])
    return None


def blocks_by_registers(regs, threads):
    """Blocks an SM of the H100 holds for a kernel without shared memory by
    its registers a thread (the occupancy calculator's rule: 256-register
    units a warp, 64K registers and 64 warps an SM, 32 blocks)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    return min(32, 64 // warps, (65536 // per_warp) // warps)


def march_shape(sm, lib, R, kw, log=None):
    """K9's or K11's (``lib``) registers a thread, blocks an SM and threads a
    block at tiles of R rays: from the port's ``march_launch_shape`` where it
    has one, else ptxas's registers in ``log`` and ``blocks_by_registers`` for
    a thread a ray (the layout before lane groups)."""
    if hasattr(sm, "march_launch_shape"):
        regs, blocks, threads = sm.march_launch_shape(lib, R, kw["ncoeff"], kw["relu_sigma"],
                                                      kw["with_diffuse"])
        return dict(registers=regs, blocks_per_sm=blocks, threads=threads, source="cuda")
    regs = ptxas_registers(log, f"{lib}_kernel", kw["ncoeff"], kw["relu_sigma"],
                           kw["with_diffuse"])
    return dict(registers=regs, threads=R, source="ptxas",
                blocks_per_sm=None if regs is None else blocks_by_registers(regs, R))


def gif_frames(data: bytes):
    """(width, height, frames) of a GIF89a, walking its blocks: the header
    and global colour table, extensions, image descriptors with their LZW
    sub-blocks, the trailer; raises on a malformed stream."""
    check(data[:6] == b"GIF89a", f"GIF header {data[:6]!r}")
    width, height = int.from_bytes(data[6:8], "little"), int.from_bytes(data[8:10], "little")
    pos = 13 + (3 << ((data[10] & 7) + 1) if data[10] & 0x80 else 0)
    frames = 0

    def skip_sub_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            pos = skip_sub_blocks(pos + 2)
        elif data[pos] == 0x2C:
            flags = data[pos + 9]
            pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)  # after the LZW minimum code size
            frames += 1
        else:
            raise RuntimeError(f"chip_smoke: GIF block 0x{data[pos]:02x} at {pos}")
    check(pos == len(data) - 1, "bytes after the GIF trailer")
    return width, height, frames


def trilinear_corners(torch, gen, dev, n, side):
    """The 8 trilinear corner indices [n, 8] int32 and weights [n, 8] f32 of
    n uniform samples inside one brick of side^3 vertices."""
    pts = torch.rand(n, 3, generator=gen, device=dev) * (side - 1)
    base = torch.clamp(torch.floor(pts), max=side - 2)
    frac = pts - base
    idx, w = [], []
    for corner in range(8):
        bits = [(corner >> a) & 1 for a in range(3)]
        ijk = base.long() + torch.tensor(bits, device=dev)
        idx.append((ijk[:, 0] * side + ijk[:, 1]) * side + ijk[:, 2])
        wc = torch.ones(n, device=dev)
        for a in range(3):
            wc = wc * (frac[:, a] if bits[a] else 1.0 - frac[:, a])
        w.append(wc)
    return torch.stack(idx, 1).to(torch.int32), torch.stack(w, 1)


def bricked_recording_step(torch, bt, original_step, counters, steps, firsts):
    """A stand-in for bricked_train_step that draws the step's tiles and theta
    as the step draws them, times the step (CUDA synchronized) into
    ``steps`` as (grid size, ms, loss), keeps each stage's first step in
    ``firsts`` (the grid it started from, its batch and draws, loss and
    gradient) and, after the stage's CLI_STEPS-th step, the loss on that
    batch; those evaluations' launches are not counted."""

    def batch_loss(tstat, grid, batch):
        with torch.no_grad():
            return float(bt.tile_loss(tstat, grid, *batch)[0])

    def timed_step(tstat, optimizer, grid, images, poses, pose_idx, generator=None, *,
                   draws=None, **kw):
        if draws is None:
            draws = bt.draw_tiles(generator, tstat)
        batch = (images, poses, pose_idx, draws)
        dims = tstat.bricked.dims[0]
        first = dims not in firsts
        if first:
            start = (grid.densities.detach().clone(), grid.features.detach().clone())
            loss_before = uncounted(counters, lambda: batch_loss(tstat, grid, batch))
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        m = original_step(tstat, optimizer, grid, images, poses, pose_idx, draws=draws, **kw)
        torch.cuda.synchronize()
        steps.append((dims, (time.perf_counter() - t_step) * 1e3, float(m["total_loss"])))
        if first:
            firsts[dims] = dict(
                tstat=tstat, start=start, voxel_size=grid.voxel_size,
                config=grid.get_config_dict(), loss=steps[-1][2], loss_before=loss_before,
                batch=batch, grads=(grid.densities.grad.clone(), grid.features.grad.clone()))
        elif sum(s_[0] == dims for s_ in steps) == CLI_STEPS:
            rec = firsts[dims]
            rec["loss_after"] = uncounted(counters,
                                          lambda: batch_loss(rec["tstat"], grid, rec["batch"]))
        return m

    return timed_step


def check_bricked_first_steps(torch, port, original_step, firsts):
    """Each bricked CLI stage's first step against the same step through the
    plain versions (a copy of its starting grid, the same tiles, views and
    theta): loss within rtol 1e-5, gradient cosine > 0.99999; the loss on
    that batch, evaluated alone before the step (equal to the step's, rtol
    1e-5) and after the stage's last step, falls by at least 1%."""
    out = {}
    for dims, rec in sorted(firsts.items()):
        d0, f0 = rec["start"]
        g = port["VoxelGrid"](d0, f0, voxel_size=rec["voxel_size"], **rec["config"])
        opt, sched = port["trainer"].make_gnomonic_optimizer(g, 0.03)
        images, poses, pose_idx, draws = rec["batch"]
        m = original_step(rec["tstat"], opt, g, images, poses, pose_idx, draws=draws,
                          scheduler=sched, plain=True)
        plain_loss = float(m["total_loss"])
        cos = [cosine(a, b) for a, b in zip(rec["grads"], (g.densities.grad, g.features.grad))]
        check(abs(rec["loss"] - plain_loss) <= 1e-5 * plain_loss and min(cos) > 0.99999,
              f"bricked CLI: stage {dims}^3 first step vs plain: loss {rec['loss']} vs "
              f"{plain_loss}, gradient cosines {cos}")
        check(abs(rec["loss_before"] - rec["loss"]) <= 1e-5 * rec["loss"],
              f"bricked CLI: stage {dims}^3 batch loss {rec['loss_before']} before the "
              f"first step, the step's {rec['loss']}")
        check(rec["loss_after"] <= 0.99 * rec["loss_before"],
              f"bricked CLI: stage {dims}^3 loss on its first step's tiles "
              f"{rec['loss_before']} -> {rec['loss_after']} after its last step")
        out[f"{dims}^3"] = dict(loss=rec["loss"], plain_loss=plain_loss, grad_cos=cos,
                                loss_before=rec["loss_before"], loss_after=rec["loss_after"])
    return out


def replay_first_step(torch, port, rec):
    """A recorded first step through the plain versions, on a copy of the
    grid it started from (on the card), with its views and phases. Returns
    the plain loss and the cosines of the recorded grid gradients against
    the plain ones (densities, features)."""
    d0, f0 = (t.to(rec.get("device", "cuda")) for t in rec["start"])
    g = port["VoxelGrid"](d0, f0, voxel_size=rec["voxel_size"], **rec["config"])
    opt, sched = port["trainer"].make_gnomonic_optimizer(g, 0.03)
    m = port["gt"].gnomonic_train_step_multi(rec["tstat"], opt, g, *rec["views"][:4],
                                             phases=rec["views"][4], scheduler=sched,
                                             plain=True)
    cos = [cosine(a.to(b.device), b)
           for a, b in zip(rec["grads"], (g.densities.grad, g.features.grad))]
    return float(m["total_loss"]), cos


class PlanesRun(NamedTuple):
    """What phases 17-20 hand back: the four kernels' results, the launch
    counts of phases 18 (serving, gradient), 19 and 20, and their times."""
    results: dict
    launches18: dict
    launches18g: dict
    launches19: dict
    launches20: dict
    ms_pose_p: float
    wall19: float


def planes_phases(torch, port, workdir, *, scene, grid, d, f, grid_config, config, intr,
                  render_poses, axis, flip, gen, dev) -> PlanesRun:
    """Phases 17-20 (the plane march, planes serving, the render CLI, the
    one-hot gather pair) on the blob model of phase 5 (``scene``): its grid,
    scene arrays, render config, intrinsics and poses, with phase 4's march
    variant and pose."""
    gn, wm, sm, vm = (port[k_] for k_ in ("gn", "wm", "sm", "vm"))
    results = {}
    # ---- phase 17: the plane march (K11) and its replay backward (K12) on one
    # planes pose of the blob model: the serving render config's variant
    # (400 x 400, tile 16, P = 2, exit 1e-4, the serving occupancy
    # threshold), and an opaque copy where the early exit must end tiles
    pl, pm, og = port["pl"], port["pm"], port["og"]
    pst = pl.variant_statics(grid, axis, flip, config)
    check(pst.tile_px == 16 and pst.pos_per_cell == (2 if GRID_SIZE == 128 else
                                                     pst.pos_per_cell)
          and pst.exit_eps == 1e-4 and pst.occ_sigma_thresh > 0.0, f"planes statics {pst}")
    kw11 = dict(ncoeff=pst.ncoeff, relu_sigma=pst.relu_sigma, exit_eps=pst.exit_eps,
                with_diffuse=pst.with_diffuse)

    def k11_case(vgrid, label, cli=False):
        ops, kw, ovf = k11_operands(torch, port, scene, dev, vgrid, cli=cli)
        check(kw == kw11, f"K11 ({label}) kwargs {kw}")
        tab, cnt, rf, _ = ops
        got = pm.plane_march_render(*ops, **kw11)
        torch.cuda.synchronize()
        want, work = pm.plane_march_render_plain(*ops, **kw11, return_work=True)
        _, work0 = pm.plane_march_render_plain(*ops, **{**kw11, "exit_eps": 0.0},
                                               return_work=True)
        err = max_abs(got, want)
        check(bool(torch.isfinite(got).all()) and err <= 1e-6,
              f"K11 vs plain ({label}): max-abs {err}")
        check(float(want[..., 3].max()) > 0.5, f"K11 ({label}): the scene is not hit")
        print(f"# K11 plane_march {label}: max-abs {err:.3g}; {rf.shape[0]} tiles, "
              f"{int(cnt.sum())} entries (a tile: max / mean / empty tiles "
              f"{table_stats(cnt)}); live positions marched {work[0]} (exit_eps 0: "
              f"{work0[0]}); overflow {bool(ovf)}", flush=True)
        return ops, want, work, work0, err

    opaque = port["voxel_grid_from_numpy"](np.where(d > 0, d * 100.0, d), f, grid_config,
                                           device=dev)
    _, _, p_work, p_work0, k11_err_opaque = k11_case(opaque, "opaque")
    check(p_work[0] < p_work0[0], "the plane march's early exit ended no tile on the opaque scene")
    del opaque
    # the render CLI's frame (phase 19's second pose at 800 x 800, 2500 tiles)
    ops11c, out11c, work11c, _, k11_err_cli = k11_case(grid, "the render CLI's frame",
                                                       cli=True)
    k11_cli_ms = time_ms(torch, lambda: pm.plane_march_render(*ops11c, **kw11), 10)
    k11_cli_bound = bound(*slab_counts(ops11c, work11c, pst.ncoeff, out11c.numel(),
                                       shade_ops=80))
    k11_cli = dict(ms=k11_cli_ms, max_abs_err=k11_err_cli, tiles=int(ops11c[0].shape[0]),
                   positions_marched=work11c[0], entries_max_mean_empty=table_stats(ops11c[1]),
                   bound_ms=k11_cli_bound[0])
    print(f"# K11 plane_march (the render CLI's frame): ms={k11_cli_ms:.4f}, bound "
          f"{k11_cli_bound[0]:.4f} ms ({k11_cli_bound[1]})", flush=True)
    del ops11c, out11c, work11c
    ops11, out11, work11, _, k11_err = k11_case(grid, "blob")
    k11_ms = time_ms(torch, lambda: pm.plane_march_render(*ops11, **kw11), 20)
    k11_plain_ms = time_ms(torch, lambda: pm.plane_march_render_plain(*ops11, **kw11), 1)
    k11_bytes, k11_ops = slab_counts(ops11, work11, pst.ncoeff, out11.numel(), shade_ops=80)
    k11_shape = march_shape(sm, "plane_march", ops11[2].shape[1], kw11)
    k11_entries = table_stats(ops11[1])
    gout11 = torch.randn(out11.shape, generator=gen, device=dev)
    got12 = pm.plane_march_grad(*ops11, out11, gout11, **kw11)
    torch.cuda.synchronize()
    want12 = pm.plane_march_grad_plain(*ops11, out11, gout11, **kw11)
    scale12 = float(want12.abs().max())
    k12_err = max_abs(got12, want12)
    k12_cos = cosine(got12, want12)
    k12_cast = max_abs(got12.to(torch.bfloat16).float(), want12.to(torch.bfloat16).float())
    check(scale12 > 0.0 and k12_err <= 1e-4 * scale12 and k12_cos > 0.99999
          and k12_cast <= scale12 * 2.0 ** -8,
          f"K12 vs plain: max-abs {k12_err} (scale {scale12}), cosine {k12_cos}, "
          f"after the bf16 cast {k12_cast}")
    k12_pose = grad_readings(torch, pm.plane_march_grad, "plane_march_backward", ops11, out11,
                             gout11, kw11, "pose")
    k12_ms = k12_pose["ms"]
    check(k12_pose["steps_summed"] > 0 and k12_pose["steps_direct"] == 0
          and k12_pose["global_atomics"] * 4 < k12_pose["tap_products"],
          f"K12 did not sum its steps in shared memory: {k12_pose}")
    k12_shape = dict(zip(("registers", "blocks_per_sm", "threads"),
                         pm.plane_backward_launch_shape(ops11[2].shape[1], **{
                             k_: kw11[k_] for k_ in ("ncoeff", "relu_sigma", "with_diffuse")})))
    k12_shape["smem"] = pm.plane_backward_plan(ops11[2].shape[1], pst.ncoeff).smem
    k12_plain_ms = time_ms(torch, lambda: pm.plane_march_grad_plain(
        *ops11, out11, gout11, **kw11), 1)
    nused11 = 3 * pst.ncoeff + 1
    k12_bytes = k11_bytes - out11.numel() * 4 + 2 * out11.numel() * 4 + want12.numel() * 4
    k12_ops = k11_ops + work11[0] * (60 + 4 * nused11 * 2 + nused11)
    print(f"# K11 plane_march (blob, 400 x 400): ms={k11_ms:.4f} plain_ms={k11_plain_ms:.4f}; "
          f"bound counts {k11_bytes} bytes, {k11_ops} operations, {int(work11[1].sum())} "
          f"position records read; launch {k11_shape}", flush=True)
    print(f"# K12 plane_march_backward: max-abs {k12_err:.3g} of {scale12:.3g} (f32), "
          f"{k12_cast:.3g} after the bf16 cast, cosine {k12_cos:.9f}; ms={k12_ms:.4f} "
          f"plain_ms={k12_plain_ms:.4f}; bound counts {k12_bytes} bytes, {k12_ops} "
          f"operations; launch {k12_shape}", flush=True)
    del got12, want12

    # ---- phase 18: planes serving through the entry points: the blob model
    # saved with the planes procedure, loaded, 8 poses through render_poses;
    # then the gradient of sum(out[..., :4]^2) through repack_plane_grid and
    # plane_march on phase 17's pose, K11 / K12 against the plain versions
    pmodel = vm.VolumetricModel(grid, "render_sh_voxel_grid_planes", config)
    vm.save_model(pmodel, workdir / "blob128_planes",
                  {"hemispherical_radius": 4.0,
                   "camera_intrinsics": [IMAGE_SIZE, IMAGE_SIZE, intr.focal]})
    del pmodel
    pmodel, _ = vm.create_volumetric_model_from_saved_model(workdir / "blob128_planes")
    check(pmodel.render_procedure_name == "render_sh_voxel_grid_planes"
          and pmodel.thre3d_repr.device.type == "cuda", "the loaded planes model")
    pmodel.render_poses(render_poses, intr)  # warm-up: the variants' repacks
    torch.cuda.synchronize()
    counters18 = {"plane_march": pm.plane_march_render, "plane_march_backward": pm.plane_march_grad,
                  "slab_march": sm.slab_march_render, "composite_fused": gn.composite_positions_fused,
                  "resample_rows": wm.resample_rows, "onehot_gather": og.onehot_gather_forward,
                  "onehot_scatter_add": og.onehot_scatter_add}
    idle18 = {k_: 0 for k_ in counters18}
    for c in counters18.values():
        c.launches = 0
    t0 = time.perf_counter()
    outp = pmodel.render_poses(render_poses, intr)
    torch.cuda.synchronize()
    ms_pose_p = (time.perf_counter() - t0) * 1e3 / NUM_POSES
    launches18 = {name: c.launches for name, c in counters18.items()}
    check(launches18 == {**idle18, "plane_march": NUM_POSES},
          f"planes serving launches {launches18}")
    accp = outp.extra["accumulated_weight"]
    check(outp.colour.shape == (NUM_POSES, IMAGE_SIZE, IMAGE_SIZE, 3), "planes colour shape")
    for name, t in (("colour", outp.colour), ("depth", outp.depth), ("acc", accp)):
        check(bool(torch.isfinite(t).all()), f"planes render: non-finite {name}")
    check(float(accp.min()) >= 0.0 and float(accp.max()) <= 1.0 + 1e-6 and float(accp.max()) > 0.5,
          "planes render: acc outside [0, 1] or the scene is not hit")
    refp = pl.render_poses_planes(pmodel.thre3d_repr, render_poses, intr, pmodel.render_config,
                                  plain=True)
    psnr_p = psnr(outp.colour, refp.colour)
    gmodel, _ = vm.create_volumetric_model_from_saved_model(workdir / "blob128")
    psnr_pg = psnr(outp.colour, gmodel.render_poses(render_poses, intr).colour)
    overflow18 = [bool(x) for x in outp.extra["bricked_tap_overflow"]]
    print(f"# planes serving: {NUM_POSES} poses, {ms_pose_p:.3f} ms/pose (host clock, "
          f"synchronized), launches {launches18}; PSNR vs plain {psnr_p:.2f} dB (colour "
          f"max-abs {max_abs(outp.colour, refp.colour):.3g}), vs the gnomonic render "
          f"{psnr_pg:.2f} dB; tap overflow per pose {overflow18}", flush=True)
    check(psnr_p >= 60.0, f"planes render vs plain PSNR {psnr_p:.2f} dB < 60")
    _, dev_p, summary_p = device_profile(
        torch, lambda: pmodel.render_poses(render_poses, intr), NUM_POSES, "pose")
    print(f"# planes serving profile: device {dev_p:.4f} ms/pose summed over kernels, "
          f"busy share {dev_p / ms_pose_p:.3f}, {summary_p}", flush=True)
    del pmodel, gmodel, outp, refp, accp
    grads18, launches18g = [], None
    for plain in (False, True):
        g18 = port["voxel_grid_from_numpy"](d, f, grid_config, device=dev)
        g18.densities.requires_grad_(True)
        g18.features.requires_grad_(True)
        for c in counters18.values():
            c.launches = 0
        out18 = pm.plane_march(*ops11[:3], pl.repack_plane_grid(g18, pst), plain=plain, **kw11)
        (out18[..., :4] ** 2).sum().backward()
        torch.cuda.synchronize()
        if not plain:
            launches18g = {name: c.launches for name, c in counters18.items()}
        grads18.append((g18.densities.grad, g18.features.grad))
        del g18, out18
    cos18 = [cosine(a, b) for a, b in zip(*grads18)]
    check(launches18g == {**idle18, "plane_march": 1, "plane_march_backward": 1},
          f"planes gradient launches {launches18g}")
    check(all(bool(torch.isfinite(a).all()) for a in grads18[0]) and min(cos18) > 0.99999,
          f"planes repack gradient vs plain: cosines {cos18}")
    print(f"# planes repack gradient (one pose, sum(out[..., :4]^2)): cosines vs plain "
          f"(densities, features) {cos18}; launches {launches18g}", flush=True)
    del grads18, ops11, out11, gout11

    # ---- phase 19: the render CLI in-process on the planes model: 8 frames
    # asked (the thre360 path drops the closing pose: 7 rendered) at scale 2
    # (800 x 800, 2500 tiles a pose)
    rcli = port["rcli"]
    for c in counters18.values():
        c.launches = 0
    t0 = time.perf_counter()
    gif_path = rcli.main(["-i", str(workdir / "blob128_planes.json"), "-o",
                          str(workdir / "render_planes"), "--num_frames", "8",
                          "--render_scale_factor", "2"])
    torch.cuda.synchronize()
    wall19 = time.perf_counter() - t0
    launches19 = {name: c.launches for name, c in counters18.items()}
    check(launches19 == {**idle18, "plane_march": 7}, f"render CLI launches {launches19}")
    gif_w, gif_h, gif_n = gif_frames(gif_path.read_bytes())
    side = 2 * int(intr.height)
    check(gif_path.name == "rendered_video.gif" and (gif_w, gif_h, gif_n) == (3 * side, side, 7),
          f"render CLI GIF {gif_path.name}: {gif_w} x {gif_h}, {gif_n} frames")
    print(f"# render CLI (planes, 7 frames of {side} x {side}): {wall19:.2f} s in main(); "
          f"{gif_path.name} {gif_path.stat().st_size} bytes, {gif_w} x {gif_h}, {gif_n} "
          f"frames; launches {launches19}", flush=True)

    # ---- phase 20: the one-hot gather (K13) and its scatter-add (K14) against
    # their plain versions at the JAX package's test shapes and at the
    # trilinear corners of 256K samples in one 8^3-vertex brick (B = 512,
    # C = 128, K = 8), each with out-of-range indices (-1, B); the library
    # calls embedding_bag and its dense backward timed beside the kernels;
    # then the differentiable gather forward and backward with the counts reset
    k13_err = k14_err = 0.0
    for (B, C, N, K) in [(128, 128, 300, 8), (256, 128, 1024, 4), (128, 256, 64, 1), ONEHOT_BCNK]:
        if (B, C, N, K) == ONEHOT_BCNK:
            idx20, w20 = trilinear_corners(torch, gen, dev, N, 8)
        else:
            idx20 = torch.randint(0, B, (N, K), generator=gen, device=dev, dtype=torch.int32)
            w20 = torch.randn(N, K, generator=gen, device=dev)
        table20 = torch.randn(B, C, generator=gen, device=dev)
        g20 = torch.randn(N, C, generator=gen, device=dev)
        bad = idx20.clone()
        bad[::97, 0] = -1
        bad[5::89, K - 1] = B
        for ids in (idx20, bad):
            got13 = og.onehot_gather_forward(table20, ids, w20)
            torch.cuda.synchronize()
            want13 = og.onehot_gather_plain(table20, ids, w20)
            got14 = og.onehot_scatter_add(ids, w20, g20, B)
            torch.cuda.synchronize()
            want14 = og.onehot_scatter_add_plain(ids, w20, g20, B)
            e13, e14 = max_abs(got13, want13), max_abs(got14, want14)
            check(e13 <= 1e-5 * float(want13.abs().max()) + 1e-6
                  and e14 <= 1e-5 * float(want14.abs().max()) + 1e-6,
                  f"K13 / K14 vs plain at {(B, C, N, K)}: max-abs {e13}, {e14}")
            k13_err, k14_err = max(k13_err, e13), max(k14_err, e14)
    src20 = lambda: (w20[..., None] * g20[:, None, :]).reshape(-1, C)  # noqa: E731
    idx_long = idx20.long()
    k13_ms = time_ms(torch, lambda: og.onehot_gather_forward(table20, idx20, w20), 20)
    k13_plain_ms = time_ms(torch, lambda: og.onehot_gather_plain(table20, idx20, w20), 5)
    k13_lib_ms = time_ms(torch, lambda: torch.nn.functional.embedding_bag(
        idx_long, table20, per_sample_weights=w20, mode="sum"), 20)
    lib13 = torch.nn.functional.embedding_bag(idx_long, table20, per_sample_weights=w20,
                                              mode="sum")
    k14_ms = time_ms(torch, lambda: og.onehot_scatter_add(idx20, w20, g20, B), 20)
    k14_plain_ms = time_ms(torch, lambda: og.onehot_scatter_add_plain(idx20, w20, g20, B), 5)
    # d_table = W^T g as one library call: embedding_bag's dense backward,
    # given the bag of each index (row n for all K of its indices) as its
    # forward would record it; index_add_ needs the [N K, C] product first
    flat20 = idx_long.reshape(-1)
    bags20 = (torch.arange(N, device=dev).repeat_interleave(K), torch.full((N,), K, device=dev),
              torch.zeros(N, dtype=torch.long, device=dev))
    lib14 = lambda: torch.ops.aten._embedding_bag_dense_backward(  # noqa: E731
        g20, flat20, *bags20, B, False, 0, w20.reshape(-1), -1)
    k14_lib_ms = time_ms(torch, lib14, 20)
    k14_lib_err = max_abs(lib14(), og.onehot_scatter_add(idx20, w20, g20, B))
    k14_index_add_ms = time_ms(torch, lambda: torch.zeros(B, C, device=dev).index_add_(
        0, flat20, src20()), 20)
    k14_src_ms = time_ms(torch, src20, 20)
    k13_bound = bound(B * C * 4 + 2 * N * K * 4 + N * C * 4, 2 * N * K * C)
    k14_bound = bound(2 * N * K * 4 + N * C * 4 + B * C * 4, 2 * N * K * C)
    print(f"# K13 onehot_gather {ONEHOT_BCNK}: max-abs {k13_err:.3g} over the cases; ms={k13_ms:.4f} "
          f"plain_ms={k13_plain_ms:.4f} embedding_bag ms={k13_lib_ms:.4f} (max-abs vs the "
          f"kernel {max_abs(lib13, og.onehot_gather_forward(table20, idx20, w20)):.3g}); "
          f"bound {k13_bound[0]:.4f} ms ({k13_bound[1]})", flush=True)
    print(f"# K14 onehot_scatter_add {ONEHOT_BCNK}: max-abs {k14_err:.3g}; ms={k14_ms:.4f} "
          f"plain_ms={k14_plain_ms:.4f} embedding_bag's dense backward ms={k14_lib_ms:.4f} "
          f"(max-abs vs the kernel {k14_lib_err:.3g}); index_add_ with its source product "
          f"ms={k14_index_add_ms:.4f}, the product alone ms={k14_src_ms:.4f}; bound "
          f"{k14_bound[0]:.4f} ms ({k14_bound[1]})", flush=True)
    # K13 at the autograd backward's shape: the weights' cotangent gathers
    # each index's row alone (K = 1 on N K rows, unit weights)
    idx1, w1 = idx20.reshape(N * K, 1), torch.ones(N * K, 1, device=dev)
    k13_1 = og.onehot_gather_forward(table20, idx1, w1)
    torch.cuda.synchronize()
    want13_1 = og.onehot_gather_plain(table20, idx1, w1)
    k13_1_err = max_abs(k13_1, want13_1)
    check(k13_1_err <= 1e-5 * float(want13_1.abs().max()) + 1e-6,
          f"K13 vs plain at K = 1, N = {N * K}: max-abs {k13_1_err}")
    del k13_1, want13_1
    k13_1_ms = time_ms(torch, lambda: og.onehot_gather_forward(table20, idx1, w1), 10)
    k13_1_plain_ms = time_ms(torch, lambda: og.onehot_gather_plain(table20, idx1, w1), 2)
    k13_1_lib_ms = time_ms(torch, lambda: torch.nn.functional.embedding_bag(
        idx1.long(), table20, per_sample_weights=w1, mode="sum"), 10)
    k13_1_bound = bound(B * C * 4 + 2 * N * K * 4 + N * K * C * 4, 2 * N * K * C)
    print(f"# K13 onehot_gather at the weights' cotangent (K = 1, N = {N * K}): max-abs "
          f"{k13_1_err:.3g}; ms={k13_1_ms:.4f} plain_ms={k13_1_plain_ms:.4f} embedding_bag "
          f"ms={k13_1_lib_ms:.4f}; bound {k13_1_bound[0]:.4f} ms ({k13_1_bound[1]})", flush=True)
    del idx1, w1
    # K14 at a table past shared memory (B = 4096: its global-atomic branch),
    # the same N, K, C and seeded indices, beside the same library call; K13
    # there too (a 2 MB table, rows drawn at random)
    BL = ONEHOT_LARGE_B
    idxL = torch.randint(0, BL, (N, K), generator=gen, device=dev, dtype=torch.int32)
    flatL = idxL.long().reshape(-1)
    tableL = torch.randn(BL, C, generator=gen, device=dev)
    k13L = og.onehot_gather_forward(tableL, idxL, w20)
    torch.cuda.synchronize()
    k13L_want = og.onehot_gather_plain(tableL, idxL, w20)
    k13L_err = max_abs(k13L, k13L_want)
    check(k13L_err <= 1e-5 * float(k13L_want.abs().max()) + 1e-6,
          f"K13 vs plain at B = {BL}: max-abs {k13L_err}")
    del k13L, k13L_want
    k13L_ms = time_ms(torch, lambda: og.onehot_gather_forward(tableL, idxL, w20), 20)
    k13L_plain_ms = time_ms(torch, lambda: og.onehot_gather_plain(tableL, idxL, w20), 5)
    k13L_lib_ms = time_ms(torch, lambda: torch.nn.functional.embedding_bag(
        flatL.reshape(N, K), tableL, per_sample_weights=w20, mode="sum"), 20)
    k13L_bound = bound(BL * C * 4 + 2 * N * K * 4 + N * C * 4, 2 * N * K * C)
    print(f"# K13 onehot_gather at B = {BL}: max-abs "
          f"{k13L_err:.3g}; ms={k13L_ms:.4f} plain_ms={k13L_plain_ms:.4f} embedding_bag "
          f"ms={k13L_lib_ms:.4f}; bound {k13L_bound[0]:.4f} ms ({k13L_bound[1]})", flush=True)
    del tableL
    k14L = og.onehot_scatter_add(idxL, w20, g20, BL)
    torch.cuda.synchronize()
    k14L_want = og.onehot_scatter_add_plain(idxL, w20, g20, BL)
    k14L_err = max_abs(k14L, k14L_want)
    check(k14L_err <= 1e-5 * float(k14L_want.abs().max()) + 1e-6,
          f"K14 vs plain at B = {BL}: max-abs {k14L_err}")
    k14L_ms = time_ms(torch, lambda: og.onehot_scatter_add(idxL, w20, g20, BL), 20)
    k14L_lib_ms = time_ms(torch, lambda: torch.ops.aten._embedding_bag_dense_backward(
        g20, flatL, *bags20, BL, False, 0, w20.reshape(-1), -1), 20)
    k14L_bound = bound(2 * N * K * 4 + N * C * 4 + BL * C * 4, 2 * N * K * C)
    print(f"# K14 onehot_scatter_add at B = {BL} (global atomics): max-abs {k14L_err:.3g}; "
          f"ms={k14L_ms:.4f}, embedding_bag's dense backward ms={k14L_lib_ms:.4f}; bound "
          f"{k14L_bound[0]:.4f} ms", flush=True)
    del idxL, flatL, k14L, k14L_want
    t20 = table20.clone().requires_grad_(True)
    w20g = w20.clone().requires_grad_(True)
    for c in counters18.values():
        c.launches = 0
    (og.weighted_onehot_gather(t20, idx20, w20g) * g20).sum().backward()
    torch.cuda.synchronize()
    launches20 = {name: c.launches for name, c in counters18.items()}
    check(launches20 == {**idle18, "onehot_gather": 2, "onehot_scatter_add": 1},
          f"differentiable one-hot gather launches {launches20}")
    check(bool(torch.isfinite(t20.grad).all()) and bool(torch.isfinite(w20g.grad).all()),
          "one-hot gather gradients")
    print(f"# differentiable one-hot gather {ONEHOT_BCNK}: launches {launches20}", flush=True)
    del table20, g20, t20, w20g, idx20, w20, idx_long, lib13, flat20, bags20
    results["plane_march"] = dict(
        err=max(k11_err, k11_err_opaque, k11_err_cli), ms=k11_ms, plain_ms=k11_plain_ms,
        bound=bound(k11_bytes, k11_ops),
        extra=dict(positions_marched=work11[0], opaque_positions_marched=p_work[0],
                   opaque_positions_without_exit=p_work0[0],
                   entries_max_mean_empty=k11_entries, launch=k11_shape,
                   render_cli_frame=k11_cli))
    results["plane_march_backward"] = dict(
        err=k12_err, ms=k12_ms, plain_ms=k12_plain_ms, bound=bound(k12_bytes, k12_ops),
        extra=dict(cosine_vs_plain=k12_cos, max_abs_err_after_bf16_cast=k12_cast,
                   grad_scale=scale12, pose=k12_pose, launch=k12_shape))
    results["onehot_gather"] = dict(
        err=max(k13_err, k13_1_err, k13L_err), ms=k13_ms, plain_ms=k13_plain_ms,
        bound=k13_bound, library=k13_lib_ms,
        extra=dict(shape_BCNK=list(ONEHOT_BCNK), library_call="torch.nn.functional.embedding_bag("
                   "mode='sum', per_sample_weights=w)",
                   k1_shape_BCNK=[B, C, N * K, 1], k1_max_abs_err=k13_1_err, k1_ms=k13_1_ms,
                   k1_plain_ms=k13_1_plain_ms, k1_library_ms=k13_1_lib_ms,
                   k1_bound_ms=k13_1_bound[0], large_B=ONEHOT_LARGE_B,
                   large_B_max_abs_err=k13L_err, large_B_ms=k13L_ms,
                   large_B_plain_ms=k13L_plain_ms, large_B_library_ms=k13L_lib_ms,
                   large_B_bound_ms=k13L_bound[0]))
    results["onehot_scatter_add"] = dict(
        err=k14_err, ms=k14_ms, plain_ms=k14_plain_ms, bound=k14_bound, library=k14_lib_ms,
        extra=dict(shape_BCNK=list(ONEHOT_BCNK), library_call="torch.ops.aten."
                   "_embedding_bag_dense_backward(mode=sum, per_sample_weights=w)",
                   library_max_abs_vs_kernel=k14_lib_err,
                   index_add_with_source_product_ms=k14_index_add_ms,
                   source_product_ms=k14_src_ms, large_B=ONEHOT_LARGE_B,
                   large_B_max_abs_err=k14L_err, large_B_ms=k14L_ms,
                   large_B_library_ms=k14L_lib_ms, large_B_bound_ms=k14L_bound[0]))
    return PlanesRun(results, launches18, launches18g, launches19, launches20, ms_pose_p,
                     wall19)


# the reference's quality gates (tools/run_quality_gates.py, QUALITY_GATES_r05.json)
GATE_POSE = (45.0, -40.0, 4.0)
GATES_DB = {"gnomonic_P1": 60.0, "gnomonic_P2": 73.0, "gnomonic_P4": 75.0,
            "gnomonic_P2_gather": 73.0, "gnomonic_P2_order5": 73.0,
            "gnomonic_P2_gather_order5": 73.0,
            "bricked_K1": 60.0, "bricked_K2": 70.0, "bricked_K4": 75.0}
EXACT_CROP = 64  # phase 21: the exact render's card-vs-CPU crop, 64 x 64 = 4096 rays


class TrainingView(NamedTuple):
    """Phase 8's first step: its grid init, views, targets and phases."""
    init_grid: object
    targets: object
    rots: np.ndarray
    orgs: np.ndarray
    pick: np.ndarray
    phases: list
    variant: tuple


def warp_options_phases(torch, port, workdir, *, scene, view, dev) -> dict:
    """Phases 21-24 (this slice's paths): the reference's quality gates on the
    port, the train step through warp order 5 and through the gather warp,
    the held-out tester with LPIPS, and the new paths' timings. ``scene`` is
    the blob model of phase 5, ``view`` phase 8's first step. Returns what
    the summary prints."""
    gn, gt, wm, vm, camera = (port[k_] for k_ in ("gn", "gt", "wm", "vm", "camera"))
    from thr3ed_atom_tpu_torch.modules import tester
    from thr3ed_atom_tpu_torch.rendering import rays as rays_mod
    from thr3ed_atom_tpu_torch.rendering.renderer import render_sh_voxel_grid
    from thr3ed_atom_tpu_torch.tools import run_quality_gates as rqg
    from thr3ed_atom_tpu_torch.utils import lpips

    grid, config, intr = scene.grid, scene.config, scene.intr
    counters = {"composite_fused": gn.composite_positions_fused,
                "resample_rows": wm.resample_rows}
    out = {}

    # ---- phase 21: the reference's quality gates. tools/run_quality_gates.py's
    # scene and camera (the 128^3 blob, 400 x 400, focal 440, pose (45, -40,
    # 4), bounds (2, 6), no jitter, white background), every render through
    # VolumetricModel.render, each PSNR against the exact render at 1024
    # samples a ray
    gate_pose = camera.pose_spherical(*GATE_POSE)
    gate_config = config.replace(num_samples_per_ray=1024, parallel_rays_chunk_size=4096)
    exact = vm.VolumetricModel(grid, "render_sh_voxel_grid", gate_config, device=dev)
    check(vm.VolumetricModel(grid, render_config=gate_config, device=dev).render_procedure_name
          == "render_sh_voxel_grid", "the default procedure is not the exact renderer")
    t0 = time.perf_counter()
    ref = exact.render(gate_pose, intr)
    torch.cuda.synchronize()
    exact_wall = time.perf_counter() - t0
    acc = ref.extra["accumulated_weight"]
    check(ref.colour.shape == (IMAGE_SIZE, IMAGE_SIZE, 3)
          and all(bool(torch.isfinite(x).all()) for x in (ref.colour, ref.depth, acc))
          and float(acc.max()) > 0.5 and float(acc.min()) < 1e-3,
          "the exact render is not finite, or misses the scene or the background")
    renders = {
        "gnomonic_P1": ("render_sh_voxel_grid_gnomonic", dict(gnomonic_pos_per_cell=1)),
        "gnomonic_P2": ("render_sh_voxel_grid_gnomonic", dict(gnomonic_pos_per_cell=2)),
        "gnomonic_P4": ("render_sh_voxel_grid_gnomonic", dict(gnomonic_pos_per_cell=4)),
        "gnomonic_P2_gather": ("render_sh_voxel_grid_gnomonic", dict(
            gnomonic_pos_per_cell=2, gnomonic_warp_impl="gather")),
        "gnomonic_P2_order5": ("render_sh_voxel_grid_gnomonic", dict(
            gnomonic_pos_per_cell=2, gnomonic_warp_order=5)),
        "gnomonic_P2_gather_order5": ("render_sh_voxel_grid_gnomonic", dict(
            gnomonic_pos_per_cell=2, gnomonic_warp_impl="gather", gnomonic_warp_order=5)),
        "bricked_K1": ("render_sh_voxel_grid_bricked", dict(bricked_axis_supersample=1)),
        "bricked_K2": ("render_sh_voxel_grid_bricked", dict(bricked_axis_supersample=2)),
        "bricked_K4": ("render_sh_voxel_grid_bricked", dict(bricked_axis_supersample=4)),
    }
    gates, launches21 = {}, {}
    for name, (procedure, cfg) in renders.items():
        model = vm.VolumetricModel(grid, procedure, gate_config.replace(**cfg), device=dev)
        for c in counters.values():
            c.launches = 0
        img = model.render(gate_pose, intr).colour
        torch.cuda.synchronize()
        if procedure.endswith("gnomonic"):
            launches21[name] = {k_: c.launches for k_, c in counters.items()}
        gates[name] = psnr(img, ref.colour)
        check(bool(torch.isfinite(img).all()), f"{name}: non-finite render")
    # the new warp paths ran through the kernels: K1, and K2 for the matmul
    # warp (two launches a pass at order 5), none for the gather warp
    check(launches21["gnomonic_P2_order5"] == {"composite_fused": 1, "resample_rows": 4}
          and launches21["gnomonic_P2_gather"] == {"composite_fused": 1, "resample_rows": 0}
          and launches21["gnomonic_P2_gather_order5"]
          == {"composite_fused": 1, "resample_rows": 0}
          and launches21["gnomonic_P2"] == {"composite_fused": 1, "resample_rows": 2},
          f"phase 21 launches {launches21}")
    print(f"# quality gates (PSNR vs the exact render at 1024 samples, pose {GATE_POSE}, "
          f"exact render {exact_wall:.2f} s on the host clock): "
          + ", ".join(f"{k_} {v:.2f} dB (gate {GATES_DB[k_]})" for k_, v in gates.items())
          + f"; gnomonic launches {launches21}", flush=True)
    failed = {k_: v for k_, v in gates.items() if not v >= GATES_DB[k_]}
    check(not failed, f"quality gates failed: {failed}")
    check(gates["gnomonic_P1"] < gates["gnomonic_P2"] < gates["gnomonic_P4"],
          f"gnomonic P ladder not monotone: {gates}")
    out["gates_db"] = gates
    # the two gates of the reference's battery beyond the PSNR ladders, through
    # the port's run_quality_gates: the bricked occupancy skip and early exit
    # against neither (lossless), and gnomonic P = 2 on the sharp
    # (voxel-noise) scene against its own exact render
    t0 = time.perf_counter()
    tool_gates = {
        "bricked_occupancy_neutrality": rqg.occupancy_neutrality_db(grid, [gate_pose], intr, dev),
        "gnomonic_P2_sharp_scene": rqg.sharp_scene_db(grid, [gate_pose], intr, dev),
    }
    print("# quality gates through tools/run_quality_gates (port): " + ", ".join(
        f"{k_} {v:.2f} dB (gate {rqg.GATES[k_]})" for k_, v in tool_gates.items())
        + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    failed = {k_: v for k_, v in tool_gates.items() if not v > rqg.GATES[k_]}
    check(not failed, f"quality gates failed: {failed}")
    out["tool_gates_db"] = tool_gates

    # the exact render on the card against the same function on the CPU, on
    # the central 64 x 64 crop (4096 rays)
    flat = rays_mod.flatten_rays(rays_mod.cast_rays(intr, gate_pose, dev))
    lo = (IMAGE_SIZE - EXACT_CROP) // 2
    rows = torch.arange(lo, lo + EXACT_CROP, device=dev)
    idx = (rows[:, None] * IMAGE_SIZE + rows[None, :]).reshape(-1)
    crop = rays_mod.Rays(flat.origins[idx], flat.directions[idx])
    got = render_sh_voxel_grid(grid, crop, gate_config)
    cpu_grid = port["voxel_grid_from_numpy"](scene.d, scene.f, scene.grid_config, device="cpu")
    t0 = time.perf_counter()
    want = render_sh_voxel_grid(cpu_grid, rays_mod.Rays(crop.origins.cpu(),
                                                        crop.directions.cpu()), gate_config)
    cpu_s = time.perf_counter() - t0
    crop_err = {k_: max_abs(a.cpu(), b) for k_, a, b in (
        ("colour", got.colour, want.colour), ("depth", got.depth, want.depth),
        ("acc", got.extra["accumulated_weight"], want.extra["accumulated_weight"]))}
    check(crop_err["colour"] <= 1e-4 and crop_err["acc"] <= 1e-4 and crop_err["depth"] <= 1e-3
          and float(want.extra["accumulated_weight"].max()) > 0.5,
          f"exact render card vs CPU on the crop: {crop_err}")
    print(f"# exact render, card vs CPU on the {EXACT_CROP} x {EXACT_CROP} crop (4096 rays, "
          f"1024 samples): max-abs {crop_err} (CPU {cpu_s:.1f} s)", flush=True)
    out["exact_crop_max_abs"] = crop_err
    del cpu_grid, want, got, crop, flat, ref, exact

    # ---- phase 22: one train step (phase 8's first: 4 views, 128^3 from
    # uniform(-1, 1), diffuse regularization, jitter) through warp order 5 (the
    # matmul warp) and through the gather warp (order 3), each against the
    # same step through the plain versions
    ax, fl, sw = view.variant
    step_args = (view.targets[view.pick], view.rots[view.pick], view.orgs[view.pick],
                 intr.focal)
    train_counters = {"composite_fused": gn.composite_positions_fused,
                      "composite_backward_fused": gt.composite_backward_fused,
                      "resample_rows": wm.resample_rows,
                      "resample_rows_adjoint": wm.resample_rows_adjoint}
    k_views = len(view.pick)
    steps22 = {}
    for label, kw in (("order5", dict(warp_order=5)), ("gather", dict(warp_impl="gather"))):
        grads, losses = [], []
        for plain in (True, False):
            g = view.init_grid()
            tstat = gt.make_gnomonic_train_statics(
                g, ax, fl, image_height=IMAGE_SIZE, image_width=IMAGE_SIZE, white_bkgd=True,
                apply_diffuse_render_regularization=True, warp_swap=sw, **kw)
            opt, sched = port["trainer"].make_gnomonic_optimizer(g, 0.03)
            for c in train_counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            m = gt.gnomonic_train_step_multi(tstat, opt, g, *step_args, phases=view.phases,
                                             scheduler=sched, plain=plain)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            grads.append((g.densities.grad.clone(), g.features.grad.clone()))
            losses.append(float(m["total_loss"]))
            del g, opt, sched
        counts = {k_: c.launches for k_, c in train_counters.items()}
        warp_launches = 4 * k_views if label == "order5" else 0
        check(counts == dict(composite_fused=k_views, composite_backward_fused=k_views,
                             resample_rows=warp_launches, resample_rows_adjoint=warp_launches),
              f"{label} train step launches {counts}")
        cos = [cosine(a, b) for a, b in zip(grads[1], grads[0])]
        check(min(cos) > 0.99999 and abs(losses[1] - losses[0]) <= 1e-5 * losses[0]
              and all(bool(torch.isfinite(x).all()) for x in grads[1]),
              f"{label} train step vs plain: gradient cosines {cos}, losses {losses}")
        steps22[label] = dict(loss=losses[1], plain_loss=losses[0], cosines=cos,
                              launches=counts, first_step_ms=step_ms)
        print(f"# train step through {label} (k={k_views}, variant {view.variant}): loss "
              f"{losses[1]:.6f} (plain {losses[0]:.6f}), gradient cosines vs plain {cos}; "
              f"{step_ms:.1f} ms (host clock, first step); launches {counts}", flush=True)
        del grads
    out["train_steps"] = steps22

    # ---- phase 23: the held-out tester with LPIPS on the card: phase 12's
    # 4 test views (downsampled to 400 x 400) against the gnomonic model; the
    # metric on the card against the CPU on one pair
    ds = port["dataset"].PosedImagesDataset(
        images_dir=workdir / "blob_views" / "test",
        camera_params_json=workdir / "blob_views" / "test_camera_params.json",
        downsample_factor=2.0, rgba_white_bkgd=True)
    model = vm.VolumetricModel(grid, "render_sh_voxel_grid_gnomonic", config, device=dev)
    t0 = time.perf_counter()
    res23 = tester.test_sh_vox_grid_vol_mod_with_posed_images(model, ds)
    tester_s = time.perf_counter() - t0
    key23 = tester.TEST_SET_LPIPS_RAND if tester.TEST_SET_LPIPS_RAND in res23 \
        else tester.TEST_SET_LPIPS
    check(sorted(res23) == sorted([tester.TEST_SET_PSNR, key23]) and res23[tester.TEST_SET_PSNR]
          > 30.0 and 0.0 <= res23[key23] < 0.05, f"tester results {res23}")
    img, _ = ds[0]
    rendered = model.render(camera.CameraPose(rotation=ds[0][1][:, :3],
                                              translation=ds[0][1][:, 3:]),
                            ds.camera_intrinsics).colour
    metric_gpu = tester._get_lpips(dev)
    metric_cpu = lpips.LPIPSMetric(device="cpu")
    l_gpu, l_cpu = metric_gpu(rendered, img), metric_cpu(rendered.cpu(), img)
    check(abs(l_gpu - l_cpu) <= 1e-4 * max(1.0, abs(l_cpu)) and l_gpu > 0.0,
          f"LPIPS card {l_gpu} vs CPU {l_cpu}")
    print(f"# tester: {res23} on {len(ds)} views of {ds.camera_intrinsics[:2]} "
          f"({tester_s:.2f} s in the tester, {metric_gpu.name}); LPIPS of one pair on the card "
          f"{l_gpu:.8f}, on the CPU {l_cpu:.8f}", flush=True)
    out["tester"] = dict(results=res23, lpips_card=l_gpu, lpips_cpu=l_cpu)

    # ---- phase 24: timings (CUDA events), each beside its plain version
    pose = gate_pose
    t24 = {}
    exact = vm.VolumetricModel(grid, "render_sh_voxel_grid", gate_config, device=dev)
    t24["exact_render_ms_pose"] = time_ms(torch, lambda: exact.render(pose, intr), 2)
    variants = {"matmul_order3": {}, "matmul_order5": dict(gnomonic_warp_order=5),
                "gather_order3": dict(gnomonic_warp_impl="gather"),
                "gather_order5": dict(gnomonic_warp_impl="gather", gnomonic_warp_order=5)}
    for label, cfg in variants.items():
        m_ = vm.VolumetricModel(grid, "render_sh_voxel_grid_gnomonic",
                                config.replace(gnomonic_pos_per_cell=2, **cfg), device=dev)
        t24[f"gnomonic_P2_{label}_ms_pose"] = time_ms(torch, lambda: m_.render(pose, intr), 10)
    # the prefilter alone, on the two passes' operands of this pose's frame
    st = gn._variant_statics(grid, *gn.dominant_axis_for_pose(
        np.asarray(pose.rotation, np.float32).reshape(3, 3)), config)
    ss = gn.effective_supersample(config.gnomonic_supersample, st, IMAGE_SIZE, IMAGE_SIZE)
    Pn, Qn, _, _ = gn.gnomonic_frame(None, IMAGE_SIZE, IMAGE_SIZE, intr.focal, ss, st)
    Hp = -(-IMAGE_SIZE // 128) * 128
    gen24 = torch.Generator(device=dev).manual_seed(24)
    for label, shape in (("pass_a", (Pn, 8, Qn)), ("pass_b", (Hp, 8, -(-Pn // 128) * 128))):
        x = torch.rand(shape, generator=gen24, device=dev)
        t24[f"prefilter_{label}_ms"] = time_ms(torch, lambda: wm.prefilter_last_axis(x), 20)
        t24[f"prefilter_{label}_plain_ms"] = time_ms(
            torch, lambda: wm.prefilter_last_axis(x, plain=True), 3)
        err = max_abs(wm.prefilter_last_axis(x), wm.prefilter_last_axis(x, plain=True))
        check(err <= 2e-6, f"prefilter {label}: matrix vs recursion max-abs {err}")
        t24[f"prefilter_{label}_shape"] = list(shape)
    a_img = rendered[None].contiguous()
    b_img = torch.as_tensor(np.asarray(img, np.float32), device=dev)[None]
    t24["lpips_400_ms"] = time_ms(torch, lambda: lpips.lpips(metric_gpu.weights, a_img, b_img),
                                  5)
    print(f"# timings (CUDA events; {card_line()}): {json.dumps(t24)}", flush=True)
    out["timings"] = t24
    return out


# the reference's gates of the fast renderer (QUALITY_GATES_r05.json), against
# the exact render at 512 samples a ray
FAST_GATES_DB = {"fast_top32": 25.0, "fast_top64": 31.0}
STEP_CHECK_RAYS = 2048  # phase 26: the ray-batch step held card vs CPU
FULL_GRID, FULL_RAYS, FULL_STEPS = 256, 16384, 5  # phase 27: the CLI's defaults
FAST, HIER = "render_sh_voxel_grid_fast", "render_sh_voxel_grid_hierarchical"


def cuda_ms(torch, fn):
    """(fn()'s result, its device ms between two CUDA events)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def explicit_render_draws(torch, procedure, config, n, gen, dev):
    """A render's draws for ``n`` rays from the CPU generator ``gen``: the
    jitter, the hierarchical procedure's fine uniforms, the noise (only
    those the config uses), moved to ``dev``."""
    from thr3ed_atom_tpu_torch.rendering.hierarchical import U_MAX, hierarchical_budget

    S = config.num_samples_per_ray
    sc, sf = hierarchical_budget(S) if procedure == HIER else (S, 0)
    draws = {}
    if config.perturb_sampled_points:
        draws["t_rand"] = torch.rand((n, sc), generator=gen)
        if sf:
            draws["u"] = torch.rand((n, sf), generator=gen) * U_MAX
    if config.stochastic_density_noise_std > 0.0:
        draws["noise"] = torch.randn((n, sc + sf), generator=gen)
    return {k: v.to(dev) for k, v in draws.items()}


def ray_batch_phases(torch, port, workdir, *, scene, view, dev) -> dict:
    """Phases 25-28 (this slice's paths, no hand-written kernel on them):
    the fast and hierarchical renders against the exact render and against
    the CPU, flat rays through the pose-structured procedures, one ray-batch
    step card vs CPU, five steps at the CLI's full width, and the training
    CLI through the ray-batch procedures. ``scene`` is the blob model of
    phase 5, ``view`` phase 8's first step (its targets and poses). Returns
    what the summary prints."""
    vm, camera, cli = port["vm"], port["camera"], port["cli"]
    from thr3ed_atom_tpu_torch.modules import trainer
    from thr3ed_atom_tpu_torch.rendering import fast_renderer as fast
    from thr3ed_atom_tpu_torch.rendering import rays as rays_mod
    from thr3ed_atom_tpu_torch.rendering.renderer import RENDER_PROCEDURES

    grid, config, intr = scene.grid, scene.config, scene.intr
    out = {}

    # ---- phase 25: the fast and hierarchical renders. The reference's gates
    # on tools/run_quality_gates.py's scene and pose: fast top-32 and top-64
    # against the exact render at 512 samples a ray (the hierarchical render
    # beside them, no gate), each through VolumetricModel.render; on the
    # central 64 x 64 crop (4096 rays) the card against the CPU, and flat
    # rays through the gnomonic, bricked and planes procedures equal to the
    # fast renderer's
    gate_pose = camera.pose_spherical(*GATE_POSE)
    cfg512 = config.replace(num_samples_per_ray=512)
    exact = vm.VolumetricModel(grid, "render_sh_voxel_grid",
                               cfg512.replace(parallel_rays_chunk_size=8192), device=dev)
    ref, exact_ms = cuda_ms(torch, lambda: exact.render(gate_pose, intr).colour)
    del exact
    renders = {"fast_top32": (FAST, 32), "fast_top64": (FAST, 64),
               "hierarchical_top64": (HIER, 64)}
    db, ms25 = {}, {"exact512_ms_pose": exact_ms}
    for name, (procedure, k) in renders.items():
        model = vm.VolumetricModel(grid, procedure, cfg512.replace(fast_topk=k), device=dev)
        img, first_ms = cuda_ms(torch, lambda: model.render(gate_pose, intr).colour)
        check(img.shape == (IMAGE_SIZE, IMAGE_SIZE, 3) and bool(torch.isfinite(img).all()),
              f"{name}: render not finite")
        db[name] = psnr(img, ref)
        ms25[f"{name}_ms_pose_with_packing"] = first_ms
        ms25[f"{name}_ms_pose"] = time_ms(torch, lambda: model.render(gate_pose, intr), 3)
        if name == "fast_top64":
            _, dev_ms, prof25 = device_profile(torch, lambda: model.render(gate_pose, intr), 1,
                                               "pose", top_n=8)
            ms25["fast_top64_profiled_device_ms_pose"] = dev_ms
        del model
    print(f"# fast renderer gates (PSNR vs the exact render at 512 samples, pose {GATE_POSE}): "
          + ", ".join(f"{k_} {v:.2f} dB" + (f" (gate {FAST_GATES_DB[k_]})"
                                            if k_ in FAST_GATES_DB else " (no gate)")
                      for k_, v in db.items())
          + f"; CUDA-event ms a pose {json.dumps(ms25)}; fast top-64 pose under "
          f"torch.profiler: {prof25}", flush=True)
    failed = {k_: db[k_] for k_, gate in FAST_GATES_DB.items() if not db[k_] > gate}
    check(not failed, f"fast renderer gates failed: {failed}")
    out.update(gates_db=db, render_ms=ms25)

    flat = rays_mod.flatten_rays(rays_mod.cast_rays(intr, gate_pose, dev))
    lo = (IMAGE_SIZE - EXACT_CROP) // 2
    rows = torch.arange(lo, lo + EXACT_CROP, device=dev)
    idx = (rows[:, None] * IMAGE_SIZE + rows[None, :]).reshape(-1)
    crop = rays_mod.Rays(flat.origins[idx], flat.directions[idx])
    crop_cpu = rays_mod.Rays(crop.origins.cpu(), crop.directions.cpu())
    cpu_grid = port["voxel_grid_from_numpy"](scene.d, scene.f, scene.grid_config, device="cpu")
    cfg64 = cfg512.replace(fast_topk=64)
    crop_err = {}
    # colour bounds: the hierarchical samples crowd where the weight is, so
    # many weights nearly tie at its top-64 cut, and an ulp of exp or of the
    # cdf's sums (the card's and the CPU's differ) moves a sample across it
    for name, procedure, colour_bound in (("fast", FAST, 1e-4), ("hierarchical", HIER, 2e-3)):
        fn = RENDER_PROCEDURES[procedure]
        got, want = fn(grid, crop, cfg64), fn(cpu_grid, crop_cpu, cfg64)
        err = {k_: max_abs(a.cpu(), b) for k_, a, b in (
            ("colour", got.colour, want.colour), ("depth", got.depth, want.depth),
            ("acc", got.extra["accumulated_weight"], want.extra["accumulated_weight"]))}
        check(err["colour"] <= colour_bound and err["acc"] <= 1e-4 and err["depth"] <= 1e-3
              and float(want.extra["accumulated_weight"].max()) > 0.5,
              f"{name} render card vs CPU on the crop: {err}")
        crop_err[name] = err
    want = fast.render_sh_voxel_grid_fast(grid, crop, cfg64)
    for procedure in ("render_sh_voxel_grid_gnomonic", "render_sh_voxel_grid_bricked",
                      "render_sh_voxel_grid_planes"):
        got = RENDER_PROCEDURES[procedure](grid, crop, cfg64)
        check(torch.equal(got.colour, want.colour) and torch.equal(got.depth, want.depth),
              f"flat rays through {procedure} differ from the fast renderer's")
    print(f"# fast / hierarchical renders, card vs CPU on the {EXACT_CROP} x {EXACT_CROP} crop "
          f"(512 samples, top 64; bounds colour 1e-4 / 2e-3, acc 1e-4, depth 1e-3): max-abs "
          f"{crop_err}; "
          "flat rays through gnomonic, bricked and planes equal the fast render", flush=True)
    out["crop_max_abs"] = crop_err
    del cpu_grid, want, got, crop, crop_cpu, flat, ref

    # ---- phase 26: one ray-batch step (2048 rays x 512 samples, the
    # diffuse regularization, jitter) from phase 8's start grid towards its
    # targets, on the card against the same step on the CPU with the same
    # explicit draws, through the fast and the hierarchical procedures, at
    # top 64 and at K = S (no top-K cut)
    targets = view.targets
    poses = torch.as_tensor(np.concatenate([view.rots, view.orgs[:, :, None]], -1),
                            dtype=torch.float32)
    step_cfg = cfg64.replace(perturb_sampled_points=True)
    steps26 = {}
    # bounds (loss rtol, gradient cosine): the card's and the CPU's expf differ
    # by an ulp, which 1 - exp(-sigma delta) turns into ~1e-5 of a small
    # alpha (the K = S readings show it without a top-K cut); the
    # hierarchical render also places its fine samples from those weights,
    # and its top-64 cut meets near ties
    step_bounds = {FAST: (1e-5, 0.99999), HIER: (5e-5, 0.99995)}
    for procedure in (FAST, HIER):
        for k in (64, 512):
            cfg_k = step_cfg.replace(fast_topk=k)
            statics = trainer.TrainStepStatics(
                render_config=cfg_k, image_height=IMAGE_SIZE, image_width=IMAGE_SIZE,
                focal=intr.focal, ray_batch_size=STEP_CHECK_RAYS, render_procedure=procedure)
            gen = torch.Generator().manual_seed(26)
            img_idx = torch.randint(0, len(targets), (STEP_CHECK_RAYS,), generator=gen)
            pix_idx = torch.randint(0, IMAGE_SIZE * IMAGE_SIZE, (STEP_CHECK_RAYS,),
                                    generator=gen)
            spec = explicit_render_draws(torch, procedure, cfg_k, STEP_CHECK_RAYS, gen, "cpu")
            losses, grads, step_ms = [], [], {}
            for d_ in ("cpu", dev):
                g = view.init_grid().to(d_)
                opt, sched = port["trainer"].make_gnomonic_optimizer(g, 0.03)
                draws = trainer.RayBatchDraws(img_idx.to(d_), pix_idx.to(d_),
                                              {k_: v.to(d_) for k_, v in spec.items()})
                t0 = time.perf_counter()
                m = trainer.ray_batch_train_step(statics, opt, g, targets.to(d_),
                                                 poses.to(d_), draws=draws, scheduler=sched)
                losses.append(float(m["total_loss"]))
                step_ms[str(d_)] = (time.perf_counter() - t0) * 1e3
                grads.append((g.densities.grad.cpu(), g.features.grad.cpu()))
                del g, opt, sched
            cos = [cosine(a, b) for a, b in zip(grads[1], grads[0])]
            err = [max_abs(a, b) for a, b in zip(grads[1], grads[0])]
            scale = [float(b.abs().max()) for b in grads[0]]
            rtol, min_cos = step_bounds[procedure]
            rel = abs(losses[1] - losses[0]) / losses[0]
            check(rel <= rtol and min(cos) > min_cos
                  and all(bool(torch.isfinite(a).all()) for a in grads[1]),
                  f"{procedure} top {k} step card vs CPU: losses {losses}, cosines {cos}")
            steps26[f"{procedure}_top{k}"] = dict(
                loss=losses[1], cpu_loss=losses[0], loss_rel_diff=rel, cosines=cos,
                max_abs=err, grad_scale=scale, host_ms_first_step=step_ms)
            print(f"# ray-batch step through {procedure} ({STEP_CHECK_RAYS} rays x 512 samples, "
                  f"top {k}), card vs CPU (bounds: loss rtol {rtol}, cosine > {min_cos}): loss "
                  f"{losses[1]:.7f} / {losses[0]:.7f} (relative {rel:.3g}), gradient cosines "
                  f"{cos}, max-abs {err} of {scale}; host ms {step_ms}", flush=True)
            del grads
    out["step_card_vs_cpu"] = steps26

    # ---- phase 27: the CLI's full width. Five ray-batch steps through the
    # fast renderer at its defaults: a 256^3 SH-degree-2 grid from
    # uniform(-1, 1) (the blob scene's box), 16384 rays of 512 samples, top
    # 64, packed f32 features, diffuse regularization, towards phase 8's
    # targets. The loss on a fixed batch falls; peak memory, ms a step (CUDA
    # events), rays/s and the split of a step
    torch.cuda.empty_cache()
    g27 = torch.Generator(device=dev).manual_seed(27)
    shape = (FULL_GRID,) * 3
    half = tuple(v * GRID_SIZE / FULL_GRID for v in scene.grid_config["voxel_size"])
    big = port["VoxelGrid"](
        torch.rand(shape + (1,), generator=g27, device=dev) * 2.0 - 1.0,
        torch.rand(shape + (27,), generator=g27, device=dev) * 2.0 - 1.0,
        voxel_size=half, grid_location=scene.grid_config["grid_location"],
        density_preactivation="identity", density_postactivation="relu")
    statics = trainer.TrainStepStatics(
        render_config=step_cfg, image_height=IMAGE_SIZE, image_width=IMAGE_SIZE,
        focal=intr.focal, ray_batch_size=FULL_RAYS, render_procedure=FAST)
    poses_dev = poses.to(dev)
    gen_eval = torch.Generator().manual_seed(270)
    fixed = trainer.RayBatchDraws(
        torch.randint(0, len(targets), (FULL_RAYS,), generator=gen_eval).to(dev),
        torch.randint(0, IMAGE_SIZE * IMAGE_SIZE, (FULL_RAYS,), generator=gen_eval).to(dev),
        explicit_render_draws(torch, FAST, step_cfg, FULL_RAYS, gen_eval, dev))

    def fixed_loss():
        with torch.no_grad():
            return float(trainer.ray_batch_loss(statics, big, targets, poses_dev, fixed)[0])

    loss_before = fixed_loss()
    opt, sched = port["trainer"].make_gnomonic_optimizer(big, 0.03)
    step_gen = torch.Generator(device=dev).manual_seed(271)
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9  # the grid and what earlier phases hold
    torch.cuda.reset_peak_memory_stats()
    step_ms, step_losses = [], []
    for _ in range(FULL_STEPS):
        m, ms_ = cuda_ms(torch, lambda: trainer.ray_batch_train_step(
            statics, opt, big, targets, poses_dev, step_gen, scheduler=sched))
        step_ms.append(ms_)
        step_losses.append(float(m["total_loss"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss_after = fixed_loss()
    check(loss_after < 0.99 * loss_before and all(np.isfinite(step_losses)),
          f"full-width steps: fixed-batch loss {loss_before} -> {loss_after}, "
          f"step losses {step_losses}")
    ms_step = float(np.mean(step_ms[1:]))

    # the split of one more step, CUDA events between its parts; the packing's
    # forward and its backward alone (its gradient tables zero) beside it
    parts = {}
    opt.zero_grad(set_to_none=True)
    with big.trainable():
        tables, parts["pack_forward"] = cuda_ms(torch, lambda: fast.prepare_for_config(
            big, step_cfg))
        zeros = [torch.zeros_like(t_) for t_ in tables]
        _, parts["pack_backward"] = cuda_ms(torch, lambda: torch.autograd.backward(
            tables, zeros))
        del tables, zeros
        opt.zero_grad(set_to_none=True)
        draws = trainer.draw_ray_batch(step_gen, statics, len(targets))
        (loss, _), parts["forward"] = cuda_ms(torch, lambda: trainer.ray_batch_loss(
            statics, big, targets, poses_dev, draws, step_gen))
        _, parts["backward"] = cuda_ms(torch, lambda: loss.backward())
        _, parts["adam"] = cuda_ms(torch, opt.step)
    del loss
    _, prof_ms, prof = device_profile(torch, lambda: trainer.ray_batch_train_step(
        statics, opt, big, targets, poses_dev, step_gen, scheduler=sched), 1, "step", top_n=8)
    out["full_width"] = dict(
        grid=FULL_GRID, rays=FULL_RAYS, samples=512, topk=64, step_ms=step_ms,
        ms_per_step=ms_step, rays_per_sec=FULL_RAYS / ms_step * 1e3, peak_gb=peak_gb,
        allocated_before_gb=base_gb,
        step_losses=step_losses, fixed_batch_loss=[loss_before, loss_after], split_ms=parts,
        profiled_device_ms=prof_ms)
    print(f"# full width ({FULL_GRID}^3, {FULL_RAYS} rays x 512 samples, top 64, packed f32; "
          f"{card_line()}): ms/step (CUDA events) {[round(v, 3) for v in step_ms]}, steps 2-"
          f"{FULL_STEPS} {ms_step:.3f} ms = {FULL_RAYS / ms_step * 1e3:.0f} rays/s; peak memory "
          f"{peak_gb:.2f} GB ({base_gb:.2f} GB allocated before the first step); losses "
          f"{step_losses}; fixed-batch loss {loss_before:.6f} -> "
          f"{loss_after:.6f}; split (ms) {json.dumps(parts)}; under torch.profiler "
          f"{prof_ms:.3f} device ms/step, {prof}", flush=True)
    del big, opt, sched, poses_dev, fixed
    torch.cuda.empty_cache()

    # ---- phase 28: the training CLI in-process through the ray-batch
    # procedures on phase 12's dataset (64^3 then 128^3, 4 steps a stage,
    # the CLI's defaults otherwise): the fast renderer, the hierarchical
    # renderer, and a softplus field under the default gnomonic procedure,
    # which routes to the fast renderer. Each run's checkpoints load in the
    # port; its held-out test ran through the fast (or hierarchical) render
    # with LPIPS
    data = workdir / "blob_views"
    original_step = trainer.ray_batch_train_step
    cli28 = {}
    for label, extra, procedure, post in (
            ("fast", ["--render_procedure", FAST], FAST, "relu"),
            ("hierarchical", ["--render_procedure", HIER], HIER, "relu"),
            ("softplus", ["--use_relu_field", "false", "--use_softplus_field", "true"], FAST,
             "softplus")):
        steps = []

        def timed(statics_, optimizer, grid_, *args, **kw):
            m_, ms_ = cuda_ms(torch, lambda: original_step(statics_, optimizer, grid_, *args,
                                                           **kw))
            steps.append((grid_.grid_dims[0], ms_, float(m_["total_loss"])))
            return m_

        out_dir = workdir / f"cli_{label}"
        argv = ["-d", str(data), "-o", str(out_dir), "--grid_dims", *[str(CLI_GRID)] * 3,
                "--num_stages", "2", "--num_iterations_per_stage", str(CLI_STEPS),
                "--save_frequency", "2", "--test_frequency", str(CLI_STEPS),
                "--feedback_frequency", str(CLI_STEPS), "--summary_frequency", "1"] + extra
        trainer.ray_batch_train_step = timed
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            trained = cli.main(argv)
        finally:
            trainer.ray_batch_train_step = original_step
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        g = trained.thre3d_repr
        check(trained.render_procedure_name == procedure and g.density_postactivation == post
              and g.grid_dims == (CLI_GRID,) * 3 and len(steps) == 2 * CLI_STEPS
              and all(np.isfinite(x[2]) for x in steps)
              and all(bool(torch.isfinite(t_).all()) for t_ in (g.densities, g.features)),
              f"CLI {label}: {trained.render_procedure_name}, {g.density_postactivation}, "
              f"{g.grid_dims}, steps {steps}")
        loaded, _ = vm.create_volumetric_model_from_saved_model(
            out_dir / "saved_models" / "model_final", device=dev)
        check(loaded.render_procedure_name == procedure
              and torch.equal(loaded.thre3d_repr.features, g.features.detach()),
              f"CLI {label}: the final checkpoint does not load back")
        summaries = [json.loads(line) for line in
                     (out_dir / "training_logs" / "summaries.jsonl").read_text().splitlines()]
        tests = {s["name"]: round(s["value"], 4) for s in summaries
                 if s["name"].startswith("TEST_SET") and s["step"] == 2 * CLI_STEPS}
        check(tests.get("TEST_SET_PSNR", 0) > 0 and len(tests) == 2,
              f"CLI {label}: held-out results {tests}")
        ms = {}
        for dims, t_, _ in steps:
            ms.setdefault(f"{dims}^3", []).append(t_)
        cli28[label] = dict(wall_s=wall, peak_gb=peak, tests=tests,
                            ms_per_step={k_: round(float(np.mean(v[1:])), 3)
                                         for k_, v in ms.items()},
                            losses=[round(x[2], 5) for x in steps])
        print(f"# CLI {label} ({procedure}, {post} field): {wall:.1f} s in main(); ms/step per "
              f"stage (CUDA events, steps 2-{CLI_STEPS}) {cli28[label]['ms_per_step']}; losses "
              f"{cli28[label]['losses']}; held-out {tests}; peak memory {peak:.2f} GB",
              flush=True)
        del trained, loaded
    out["cli"] = cli28
    return out


# phases 30-32: multi-GPU training over torch.distributed. The card's
# machine has one H100: a one-rank NCCL group, and two ranks on the one card
# under gloo with CUDA tensors (NCCL refuses two ranks on one device)
MESH_TILES = K10_BATCH_TILES  # the bricked mesh steps' tiles (the trainer's batch)


def mesh_case(torch, port, *, scene, view, dev) -> dict:
    """The mesh phases' shared inputs on the host: phase 8's start grid,
    targets, views and phases (the gnomonic steps), the blob grid and
    MESH_TILES tiles from one seed (the bricked steps, exit_eps 0 so that
    depth segments compose exactly)."""
    bt = port["bt"]
    g = view.init_grid()
    idx = np.asarray(view.pick)
    tiles_gen = torch.Generator(device=dev).manual_seed(30)
    b_statics = bricked_mesh_statics(port, scene.grid, view.variant, scene.intr.focal)
    draws = tuple(x.cpu() for x in bt.draw_tiles(tiles_gen, b_statics))
    pose_idx = np.random.default_rng(30).integers(0, len(view.rots), MESH_TILES)
    return dict(init=(g.densities.detach().cpu(), g.features.detach().cpu()),
                grid_config=dict(voxel_size=tuple(g.voxel_size), **g.get_config_dict()),
                scene=(scene.d, scene.f, scene.grid_config), targets=view.targets.cpu(),
                rots=view.rots, orgs=view.orgs, pick=idx,
                phases=[p.cpu() for p in view.phases], variant=view.variant,
                focal=float(scene.intr.focal), draws=draws, pose_idx=pose_idx)


def bricked_mesh_statics(port, grid, variant, focal):
    return port["bt"].make_bricked_train_statics(
        grid, variant[0], variant[1], image_height=IMAGE_SIZE, image_width=IMAGE_SIZE,
        focal=focal, ray_batch_size=MESH_TILES * 256, white_bkgd=True, exit_eps=0.0)


def mesh_step(torch, port, case, dev, kind, mesh_shape=None):
    """One step of ``kind`` ("gnomonic" / "bricked") from the case's state on
    ``dev``: single-device (``mesh_shape`` None) or this rank's part of the
    mesh step. Returns (metrics as floats, Adam's first moments on the
    host, ms of the step on CUDA events, whether the replicas agree)."""
    gt, bt = port["gt"], port["bt"]
    from thr3ed_atom_tpu_torch.parallel.mesh import replicas_agree

    if kind == "gnomonic":
        d, f = case["init"]
        grid = port["VoxelGrid"](d.to(dev), f.to(dev), **case["grid_config"])
        ax, fl, sw = case["variant"]
        tstat = gt.make_gnomonic_train_statics(
            grid, ax, fl, image_height=IMAGE_SIZE, image_width=IMAGE_SIZE, white_bkgd=True,
            apply_diffuse_render_regularization=True, warp_swap=sw)
        idx, phases = case["pick"], [p.to(dev) for p in case["phases"]]
        if mesh_shape is not None:
            n_dev, rank = mesh_shape
            k = len(idx) // n_dev
            idx, phases = idx[rank * k:(rank + 1) * k], phases[rank * k:(rank + 1) * k]
        args = (case["targets"].to(dev)[torch.as_tensor(idx, device=dev)],
                case["rots"][idx], case["orgs"][idx], case["focal"])
        opt, _ = port["trainer"].make_gnomonic_optimizer(grid, 0.03)
        if mesh_shape is None:
            step = lambda: gt.gnomonic_train_step_multi(tstat, opt, grid, *args,  # noqa: E731
                                                        phases=phases)
        else:
            step = lambda: gt.gnomonic_train_step_mesh(tstat, opt, mesh_shape[0],  # noqa: E731
                                                       grid, *args, phases=phases)
    else:
        d, f, grid_config = case["scene"]
        grid = port["voxel_grid_from_numpy"](d.copy(), f.copy(), grid_config, device=dev)
        statics = bricked_mesh_statics(port, grid, case["variant"], case["focal"])
        poses = np.concatenate([case["rots"], case["orgs"][:, :, None]], -1)
        pose_idx = torch.as_tensor(case["pose_idx"], device=dev)
        draws = tuple(x.to(dev) for x in case["draws"])
        targets = case["targets"].to(dev)
        opt, _ = port["trainer"].make_gnomonic_optimizer(grid, 0.03)
        if mesh_shape is None:
            step = lambda: bt.bricked_train_step(statics, opt, grid, targets,  # noqa: E731
                                                 poses, pose_idx, draws=draws)
        else:
            step = lambda: bt.bricked_train_step_mesh(  # noqa: E731
                statics, opt, mesh_shape, grid, targets, poses, pose_idx, draws=draws)
    m, ms = cuda_ms(torch, step)
    agree = replicas_agree([grid.densities, grid.features]) if mesh_shape else True
    moments = tuple(opt.state[p]["exp_avg"].cpu() for p in (grid.densities, grid.features))
    return {k_: float(v) for k_, v in m.items()}, moments, ms, agree


def _mesh_rank(rank: int, world: int, workdir: str) -> None:
    """A rank of phase 31's world: two processes on the one card under gloo
    with CUDA tensors, rendezvous through a file in ``workdir``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    port = load_port()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/pg", rank=rank,
                            world_size=world)
    try:
        case = torch.load(Path(workdir) / "mesh_case.pt", weights_only=False)
        out = {}
        for label, kind, shape in (("gnomonic_2x2", "gnomonic", (2, rank)),
                                   ("bricked_1x2", "bricked", (1, 2)),
                                   ("bricked_2x1", "bricked", (2, 1))):
            # twice from the same state: the first warms the path up, the
            # second is timed; both must read the same metrics
            m_warm = mesh_step(torch, port, case, dev, kind, shape)[0]
            m, moments, ms, agree = mesh_step(torch, port, case, dev, kind, shape)
            out[label] = dict(metrics=m, ms=ms, agree=agree and m == m_warm,
                              moments=moments if rank == 0 else None)
        torch.save(out, Path(workdir) / f"mesh_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def mesh_phases(torch, port, workdir, *, scene, view, dev) -> dict:
    """Phases 30-32: the mesh steps under a one-rank NCCL group against the
    single-device steps from the same state and draws (phase 8's gnomonic
    step of 4 views, MESH_TILES bricked tiles of phase 8's views of the blob
    grid at (1, 1), one full-width ray-batch step from phase 27's start);
    two ranks on the one card under gloo with CUDA tensors (the gnomonic
    step at n_dev 2, k 2; the bricked step at (1, 2), where K9 / K10 run at
    group_offset G / 2 on rank 1, and at (2, 1)) against the same
    single-device steps; the training CLI with --use_mesh true at one rank.
    Returns what the summary prints."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from thr3ed_atom_tpu_torch.parallel import mesh as pm

    gt, gn, wm, trainer, cli = (port[k_] for k_ in ("gt", "gn", "wm", "trainer", "cli"))
    out = {}
    case = mesh_case(torch, port, scene=scene, view=view, dev=dev)
    # ---- phase 30: a one-rank NCCL group
    check(pm.init_process_group(backend="nccl", device=dev) and dist.get_backend() == "nccl",
          "a one-rank NCCL group")
    single = {}
    try:
        # the kernels each mesh step must launch
        counters = {"gnomonic": {"composite_fused": gn.composite_positions_fused,
                                 "composite_backward_fused": gt.composite_backward_fused,
                                 "resample_rows": wm.resample_rows,
                                 "resample_rows_adjoint": wm.resample_rows_adjoint},
                    "bricked": {"slab_march": port["sm"].slab_march_render,
                                "slab_march_backward": port["sm"].slab_march_grad}}
        nccl = {}
        for kind in ("gnomonic", "bricked"):
            shape = (1, 0) if kind == "gnomonic" else (1, 1)
            # warm-ups: the step ms below are warm (a first collective of a
            # group also sets up its NCCL communicator); then single and mesh
            # alternate twice, and the second pair is checked
            mesh_step(torch, port, case, dev, kind)
            mesh_step(torch, port, case, dev, kind, shape)
            pairs = []
            for _ in range(2):
                single[kind] = mesh_step(torch, port, case, dev, kind)
                for c in counters[kind].values():
                    c.launches = 0
                mesh = mesh_step(torch, port, case, dev, kind, shape)
                launches = {k_: c.launches for k_, c in counters[kind].items()}
                pairs.append((single[kind][2], mesh[2]))
            m0, m1 = single[kind][0], mesh[0]
            cos = [cosine(a, b) for a, b in zip(mesh[1], single[kind][1])]
            # the forward kernels are deterministic: the gnomonic step's metrics
            # are bit-equal; the bricked mesh loss is a sum over the global
            # count where the single step takes means (one rounding); the
            # gradients go through f32 atomics (K4 on rows out of order, K10)
            if kind == "gnomonic":
                ok = m0 == m1
            else:
                ok = abs(m1["total_loss"] - m0["total_loss"]) <= 1e-6 * m0["total_loss"]
            check(ok and min(cos) > 0.99999 and mesh[3] and all(launches.values()),
                  f"one-rank NCCL {kind} step vs single: {m1} vs {m0}, moment cosines {cos}, "
                  f"launches {launches}")
            # the step's collectives alone: all_reduce_ of the grid's gradient
            # and the metrics on this one rank
            grads = [torch.zeros(t.shape, device=dev) for t in mesh[1]] + [
                torch.zeros(5, device=dev)]
            all_reduce_ms = [cuda_ms(torch, lambda: pm.all_reduce_(grads))[1]
                             for _ in range(3)]
            del grads
            nccl[kind] = dict(metrics=m1, single_metrics=m0, moment_cosines=cos,
                              ms=mesh[2], single_ms=single[kind][2], pairs_ms=pairs,
                              all_reduce_ms=all_reduce_ms, launches=launches)
            print(f"# mesh (NCCL, 1 rank) {kind}: metrics {m1} (single-device {m0}), "
                  f"moment cosines {cos}; (single-device ms, mesh ms) "
                  f"{[(round(a, 3), round(b, 3)) for a, b in pairs]} (CUDA events, after a "
                  f"warm-up step of each, alternating); all_reduce_ of the gradient alone "
                  f"{[round(x, 3) for x in all_reduce_ms]} ms; launches {launches}", flush=True)
        # the ray batch from phase 27's start: the 256^3 grid of its seed, its
        # fixed batch of FULL_RAYS rays
        poses = torch.as_tensor(np.concatenate([view.rots, view.orgs[:, :, None]], -1),
                                dtype=torch.float32, device=dev)
        step_cfg = scene.config.replace(perturb_sampled_points=True, fast_topk=64,
                                        num_samples_per_ray=512)
        gen_eval = torch.Generator().manual_seed(270)
        fixed = trainer.RayBatchDraws(
            torch.randint(0, len(view.targets), (FULL_RAYS,), generator=gen_eval).to(dev),
            torch.randint(0, IMAGE_SIZE * IMAGE_SIZE, (FULL_RAYS,), generator=gen_eval).to(dev),
            explicit_render_draws(torch, FAST, step_cfg, FULL_RAYS, gen_eval, dev))
        rb = []
        # single and mesh alternate: the first pair warms up, the last is checked
        for i, use_mesh in enumerate((False, True) * 3):
            g27 = torch.Generator(device=dev).manual_seed(27)
            shape = (FULL_GRID,) * 3
            big = port["VoxelGrid"](
                torch.rand(shape + (1,), generator=g27, device=dev) * 2.0 - 1.0,
                torch.rand(shape + (27,), generator=g27, device=dev) * 2.0 - 1.0,
                voxel_size=tuple(v * GRID_SIZE / FULL_GRID
                                 for v in scene.grid_config["voxel_size"]),
                grid_location=scene.grid_config["grid_location"],
                density_preactivation="identity", density_postactivation="relu")
            statics = trainer.TrainStepStatics(
                render_config=step_cfg, image_height=IMAGE_SIZE, image_width=IMAGE_SIZE,
                focal=scene.intr.focal, ray_batch_size=FULL_RAYS, use_mesh=use_mesh,
                render_procedure=FAST)
            opt, sched = trainer.make_gnomonic_optimizer(big, 0.03)
            m, ms = cuda_ms(torch, lambda: trainer.ray_batch_train_step(
                statics, opt, big, view.targets, poses, draws=fixed, scheduler=sched))
            rb.append((float(m["total_loss"]), (big.densities.grad.clone(),
                                                big.features.grad.clone()) if i >= 4 else None,
                       ms))
            del big, opt, sched
        pairs = [(rb[i][2], rb[i + 1][2]) for i in (2, 4)]
        grads = [torch.zeros_like(g) for g in rb[-1][1]] + [torch.zeros(5, device=dev)]
        all_reduce_ms = [cuda_ms(torch, lambda: pm.all_reduce_(grads))[1] for _ in range(3)]
        del grads
        rb = rb[-2:]
        cos = [cosine(a, b) for a, b in zip(rb[1][1], rb[0][1])]
        check(abs(rb[1][0] - rb[0][0]) <= 1e-6 * rb[0][0] and min(cos) > 0.99999,
              f"one-rank NCCL ray-batch step vs single: losses {rb[1][0]} / {rb[0][0]}, "
              f"gradient cosines {cos}")
        nccl["ray_batch"] = dict(loss=rb[1][0], single_loss=rb[0][0], grad_cosines=cos,
                                 ms=rb[1][2], single_ms=rb[0][2], pairs_ms=pairs,
                                 all_reduce_ms=all_reduce_ms)
        print(f"# mesh (NCCL, 1 rank) ray batch ({FULL_GRID}^3, {FULL_RAYS} rays): loss "
              f"{rb[1][0]:.7f} (single-device {rb[0][0]:.7f}), gradient cosines {cos}; "
              f"(single-device ms, mesh ms) {[(round(a, 3), round(b, 3)) for a, b in pairs]} "
              f"(CUDA events, after a warm-up step of each, alternating); all_reduce_ of the "
              f"gradient alone {[round(x, 3) for x in all_reduce_ms]} ms", flush=True)
        del rb, fixed, poses
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    out["nccl_one_rank"] = nccl

    # ---- phase 31: two ranks on the one card under gloo with CUDA tensors
    torch.save(case, workdir / "mesh_case.pt")
    t0 = time.perf_counter()
    mp.spawn(_mesh_rank, args=(2, str(workdir)), nprocs=2, join=True)
    wall = time.perf_counter() - t0
    ranks = [torch.load(workdir / f"mesh_rank{r}.pt", weights_only=False) for r in range(2)]
    gloo = {}
    for label, kind in (("gnomonic_2x2", "gnomonic"), ("bricked_1x2", "bricked"),
                        ("bricked_2x1", "bricked")):
        r0, r1 = ranks[0][label], ranks[1][label]
        m0 = single[kind][0]
        cos = [cosine(a, b) for a, b in zip(r0["moments"], single[kind][1])]
        rel = abs(r0["metrics"]["total_loss"] - m0["total_loss"]) / m0["total_loss"]
        # the two ranks' averages (gnomonic) or segments (bricked) sum in
        # another order than one device's: loss rtol 1e-5; the gradients
        # also through f32 atomics: cosine > 0.99999. Depth segments compose
        # through the front's T = 1 - acc (the JAX package's rule), which
        # cancels where the front is nearly opaque (the blob scene is): the
        # back segment's gradient is off by up to ~1e-3 of it there, so
        # that split is held at cosine > 0.9999 (0.99997 on an H100)
        min_cos = 0.9999 if label == "bricked_1x2" else 0.99999
        check(r0["agree"] and r1["agree"] and r0["metrics"] == r1["metrics"] and rel <= 1e-5
              and min(cos) > min_cos,
              f"two-rank gloo {label} vs single: {r0['metrics']} vs {m0}, moment cosines {cos}")
        gloo[label] = dict(metrics=r0["metrics"], loss_rel_diff=rel, moment_cosines=cos,
                           ms=[r0["ms"], r1["ms"]])
        print(f"# mesh (gloo, 2 ranks on one card) {label}: metrics {r0['metrics']} "
              f"(single-device {m0}), loss relative {rel:.3g}, moment cosines {cos} (bound "
              f"{min_cos}); step ms (CUDA events, each rank's second step, the two sharing "
              f"the card) "
              f"{[round(r0['ms'], 3), round(r1['ms'], 3)]}", flush=True)
    gloo["wall_s"] = wall
    out["gloo_two_ranks"] = gloo
    del ranks, single

    # ---- phase 32: the training CLI with --use_mesh true at one rank (it forms
    # its own one-rank NCCL group), 2 stages of 4 steps on phase 12's dataset
    counters32 = {"composite_fused": gn.composite_positions_fused,
                  "composite_backward_fused": gt.composite_backward_fused,
                  "resample_rows": wm.resample_rows,
                  "resample_rows_adjoint": wm.resample_rows_adjoint}
    calls = []
    original = gt.gnomonic_train_step_mesh

    def counted(*a, **kw):
        calls.append(a[2])
        return original(*a, **kw)

    out_dir = workdir / "cli_mesh"
    argv = ["-d", str(workdir / "blob_views"), "-o", str(out_dir), "--grid_dims",
            *[str(CLI_GRID)] * 3, "--num_stages", "2", "--num_iterations_per_stage",
            str(CLI_STEPS), "--save_frequency", str(CLI_STEPS), "--test_frequency",
            str(CLI_STEPS), "--feedback_frequency", str(CLI_STEPS), "--summary_frequency", "1",
            "--use_mesh", "true"]
    for c in counters32.values():
        c.launches = 0
    gt.gnomonic_train_step_mesh = counted
    t0 = time.perf_counter()
    try:
        trained = cli.main(argv)
    finally:
        gt.gnomonic_train_step_mesh = original
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0
    launches32 = {k_: c.launches for k_, c in counters32.items()}
    summaries = [json.loads(line) for line in
                 (out_dir / "training_logs" / "summaries.jsonl").read_text().splitlines()]
    losses = [round(s["value"], 5) for s in summaries if s["name"] == "total_loss"]
    check(not dist.is_initialized() and calls == [1] * (2 * CLI_STEPS)
          and all(v > 0 for v in launches32.values())
          and (out_dir / "saved_models" / "model_final.npz").exists()
          and trained.thre3d_repr.grid_dims == (CLI_GRID,) * 3 and all(np.isfinite(losses)),
          f"CLI --use_mesh true: mesh calls {calls}, launches {launches32}, losses {losses}")
    out["cli"] = dict(wall_s=wall32, launches=launches32, losses=losses)
    print(f"# CLI --use_mesh true (1 rank, NCCL): {wall32:.1f} s in main(); mesh steps "
          f"{len(calls)}; launches {launches32}; losses {losses}", flush=True)
    del trained
    return out


# phase 29: 3inFusion at the training CLI's widths on phase 5's 128^3 scene
# the largest of 32 / 16 / 8 whose full-width step fits the card (--diffusion-batch on an
# NVIDIA H100 80GB HBM3 at 700 W: 32 and 16 ran out of memory at 71.8 and 78.2 GB; 8 peaks
# at 43.85 GB)
DIFF_BATCH = 8
DIFF_STEPS = 6  # train steps of the full-width run
DIFF_SAMPLE_ITERS = 25  # reverse steps of each of the mosaic's samples
DIFF_CHECK_CROP = 32  # the card-vs-CPU check's crop side (batch 2)


def app_unet(dunet, channels, generator=None):
    """apps/train_thre3infusion.py's UNet for a scene of ``channels`` grid channels."""
    return dunet.UNetModel(
        in_channels=channels, model_channels=32, out_channels=channels, num_res_blocks=1,
        attention_resolutions=(), use_bottleneck_attn=True, channel_mult=(1, 2, 4, 8),
        conv_resample=True, dims=3, num_classes=None, use_checkpoint=True, num_heads=4,
        num_head_channels=-1, use_scale_shift_norm=True, resblock_updown=False,
        generator=generator)


def app_diffusion(gdm):
    """The training CLI's diffusion: cosine, 500 steps, EPSILON / FIXED_SMALL / MSE."""
    return gdm.GaussianDiffusion(
        betas=gdm.get_named_beta_schedule("cosine", 500),
        model_mean_type=gdm.ModelMeanType.EPSILON, model_var_type=gdm.ModelVarType.FIXED_SMALL,
        loss_type=gdm.LossType.MSE)


def diffusion_phase(torch, port, workdir, *, dev) -> dict:
    """Phase 29: 3inFusion (no hand-written kernel of its own; its sample
    mosaic renders through phase 5's gnomonic procedure, K1 and K2). The
    training CLI's UNet on the card against the CPU (output, a train step's
    loss and gradient, a p_sample step); main([...]) at the CLI's widths,
    diffusion and crop ratio on phase 5's 128^3 SH-degree-2 scene (crop
    112^3) with DIFF_BATCH crops a step, the in-loop mosaic once; the loss
    on a fixed batch before and after; a train step with TF32 on beside one
    without; two samples of DIFF_SAMPLE_ITERS reverse steps rendered into a
    mosaic through the gnomonic procedure, its launches counted; the final
    checkpoint reloaded. Returns what the summary prints."""
    import copy
    import logging

    from thr3ed_atom_tpu_torch.apps import train_thre3infusion as dcli
    from thr3ed_atom_tpu_torch.diffusion import gaussian_diffusion as gdm
    from thr3ed_atom_tpu_torch.diffusion import model as dmodel
    from thr3ed_atom_tpu_torch.diffusion import nn as dnn
    from thr3ed_atom_tpu_torch.diffusion import unet as dunet

    gn, wm, vm = port["gn"], port["wm"], port["vm"]
    Model = dmodel.Thre3inFusionModel
    out = {}
    torch.cuda.empty_cache()
    scene_path = workdir / "blob128"
    vol, _ = vm.create_volumetric_model_from_saved_model(scene_path, device="cpu")
    norm_cpu, _, _ = dmodel.normalize_grid(Model.serialize_vol_mod_to_tensor_grid(vol)[0])
    del vol
    channels = norm_cpu.shape[-1]
    diffusion = app_diffusion(gdm)
    dmodel.strict_f32()

    # ---- 29a: card against CPU at the CLI's widths, a 32^3 crop, batch 2:
    # perturbed weights (the zero-initialised convs would hide a path)
    gen = torch.Generator().manual_seed(290)
    cpu_unet = app_unet(dunet, channels, gen)
    with torch.no_grad():
        for p in cpu_unet.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    card_unet = copy.deepcopy(cpu_unet).to(dev)
    crop = (DIFF_CHECK_CROP,) * 3
    batch = dmodel.crop_batch(norm_cpu, torch.tensor([[10, 40, 70], [60, 20, 5]]), crop)
    t = torch.tensor([17, 403])
    noise = torch.randn(batch.shape, generator=gen)
    z = torch.randn(batch.shape, generator=gen)
    # the UNet's convolution FLOPs a voxel of a forward (2 x MACs, counted on
    # the CPU forward by hooks on its convs): the compute a step's time stands on
    conv_flops = []
    hooks = [m.register_forward_hook(lambda m_, i_, o_: conv_flops.append(
        2 * o_.numel() * m_.weight[0].numel())) for m in cpu_unet.modules()
        if isinstance(m, dnn.ConvNd)]
    with torch.no_grad():
        cpu_unet(batch, t)
    for h in hooks:
        h.remove()
    flops_voxel = sum(conv_flops) / batch[..., 0].numel()
    out["conv_gflop_forward"] = {f"{n}^3": flops_voxel * n ** 3 / 1e9 for n in (112, 128)}
    res = {}
    for name, unet, d_ in (("cpu", cpu_unet, "cpu"), ("card", card_unet, dev)):
        args = (batch.to(d_), t.to(d_))
        with torch.no_grad():
            fwd = unet(*args).cpu()
            x_t = diffusion.q_sample(args[0], args[1], noise.to(d_))
            step = diffusion.p_sample(unet, x_t, args[1], noise=z.to(d_))[0].cpu()
        loss = diffusion.training_losses(unet, *args, noise=noise.to(d_))["loss"].mean()
        loss.backward()
        grads = torch.cat([p.grad.reshape(-1).cpu() for p in unet.parameters()])
        res[name] = (fwd, step, float(loss.detach()), grads)
    scale = float(res["cpu"][0].abs().max())
    fwd_rel = max_abs(res["card"][0], res["cpu"][0]) / scale
    step_rel = max_abs(res["card"][1], res["cpu"][1]) / float(res["cpu"][1].abs().max())
    loss_rel = abs(res["card"][2] - res["cpu"][2]) / abs(res["cpu"][2])
    grad_cos = cosine(res["card"][3], res["cpu"][3])
    out["card_vs_cpu"] = dict(unet_rel=fwd_rel, unet_scale=scale, p_sample_rel=step_rel,
                              loss_rel=loss_rel, loss=res["cpu"][2], grad_cosine=grad_cos)
    print(f"# 3inFusion card vs CPU (CLI widths, {DIFF_CHECK_CROP}^3 x 2, {channels} channels):"
          f" UNet max-abs / scale {fwd_rel:.3g} (scale {scale:.4g}), p_sample step "
          f"{step_rel:.3g}, loss {res['cpu'][2]:.7f} relative gap {loss_rel:.3g}, gradient "
          f"cosine {grad_cos:.9f}; convolution GFLOP a forward "
          f"{json.dumps(out['conv_gflop_forward'])} ({flops_voxel:.0f} a voxel; "
          f"{sum(p.numel() for p in cpu_unet.parameters())} parameters)", flush=True)
    check(scale > 0 and fwd_rel <= 1e-4 and step_rel <= 1e-4 and loss_rel <= 1e-5
          and grad_cos > 0.99999, f"3inFusion card vs CPU: {out['card_vs_cpu']}")
    del cpu_unet, card_unet, res, batch, noise, z

    # ---- 29b: the CLI's full width, main([...]) on phase 5's scene; the
    # step and the sample timed on CUDA events, the log kept
    steps, samples, messages = [], [], []
    original_step, original_sample = Model.train_step, Model.sample

    def timed_step(self, *args):
        loss, ms = cuda_ms(torch, lambda: original_step(self, *args))
        steps.append((ms, float(loss), torch.cuda.max_memory_allocated() / 1e9))
        return loss

    def timed_sample(self, *args, **kw):
        grids, ms = cuda_ms(torch, lambda: original_sample(self, *args, **kw))
        samples.append((kw.get("max_iter"), ms))
        return grids

    class Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    keep = Keep()
    logging.getLogger().addHandler(keep)
    out_dir = workdir / "thre3infusion"
    argv = ["-i", str(scene_path), "-o", str(out_dir), "--batch_size", str(DIFF_BATCH),
            "--num_iters", str(DIFF_STEPS), "--sample_frequency", str(DIFF_STEPS),
            "--save_frequency", str(DIFF_STEPS), "--loss_feedback_frequency", "1",
            "--visualization_samples", "1"]
    Model.train_step, Model.sample = timed_step, timed_sample
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        model = dcli.main(argv)
    finally:
        Model.train_step, Model.sample = original_step, original_sample
        logging.getLogger().removeHandler(keep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    side = dmodel.training_crop_side((GRID_SIZE,) * 3, 0.8, 4)
    check(side == 112 and model.unet.in_channels == channels == 28,
          f"3inFusion: crop {side}, channels {model.unet.in_channels}")
    failed = [m for m in messages if "sample visualization failed" in m]
    check(not failed, f"3inFusion: the in-loop mosaic failed: {failed}")
    gif = out_dir / "generated_samples" / f"samples_{DIFF_STEPS}.gif"
    check(gif.exists(), f"3inFusion: no in-loop mosaic {gif}")
    w_, h_, n_frames = gif_frames(gif.read_bytes())
    check(n_frames == 59, f"3inFusion in-loop mosaic: {n_frames} frames")
    step_ms = [s_[0] for s_ in steps]
    step_losses = [s_[1] for s_ in steps]
    peak_gb = max(s_[2] for s_ in steps)
    check(len(steps) == DIFF_STEPS and all(np.isfinite(step_losses)),
          f"3inFusion steps {steps}")
    ms_step = float(np.mean(step_ms[1:]))
    voxels = DIFF_BATCH * side ** 3

    # the loss on a fixed crop batch, timesteps and noise: the initial UNet
    # (train()'s initialisation from the seed) against the trained one
    g29 = torch.Generator(device=dev).manual_seed(291)
    norm = norm_cpu.to(dev)
    fixed = dmodel.crop_batch(norm, torch.tensor([[3, 9, 14], [12, 0, 7]]), (side,) * 3)
    fixed_t = torch.tensor([50, 250], device=dev)
    fixed_noise = torch.randn(fixed.shape, generator=g29, device=dev)
    initial = app_unet(dunet, channels, torch.Generator().manual_seed(42)).to(dev)

    def fixed_loss(unet):
        with torch.no_grad():
            return float(diffusion.training_losses(unet, fixed, fixed_t,
                                                   noise=fixed_noise)["loss"].mean())

    loss_before, loss_after = fixed_loss(initial), fixed_loss(model.unet)
    del initial
    check(loss_after < loss_before, f"3inFusion fixed-batch loss {loss_before} -> {loss_after}")
    in_loop = [ms for it, ms in samples if it is None]
    out["full_width"] = dict(
        batch=DIFF_BATCH, crop=side, steps=DIFF_STEPS, step_ms=step_ms, ms_per_step=ms_step,
        voxels_per_sec=voxels / ms_step * 1e3, peak_gb=peak_gb, step_losses=step_losses,
        fixed_batch_loss=[loss_before, loss_after], main_s=wall,
        in_loop_sample_ms=in_loop, in_loop_ms_per_reverse_step=[ms / 500 for ms in in_loop])
    print(f"# 3inFusion full width ({card_line()}): batch {DIFF_BATCH} x {side}^3 x {channels}, "
          f"ms/step (CUDA events) {[round(v, 3) for v in step_ms]}, steps 2-{DIFF_STEPS} "
          f"{ms_step:.3f} ms = {voxels / ms_step * 1e3:.4g} voxels/s; peak memory "
          f"{peak_gb:.2f} GB; losses {step_losses}; fixed-batch loss {loss_before:.7f} -> "
          f"{loss_after:.7f}; main() {wall:.1f} s, its in-loop sample (500 reverse steps, "
          f"{GRID_SIZE}^3, batch 1) {[round(ms, 1) for ms in in_loop]} ms", flush=True)

    # ---- 29c: the final checkpoint reloads in the port to equal leaves
    again = Model(app_unet(dunet, channels), diffusion, device=dev)
    again.load_params(out_dir / "saved_models" / "model_final")
    saved = dunet.flax_leaves(again.params)
    mine = dunet.flax_leaves(model.params)
    check(len(saved) == len(mine) and all(np.array_equal(a, b) for a, b in zip(saved, mine)),
          "3inFusion: the final checkpoint does not reload to the trained leaves")
    del again, saved, mine

    # ---- 29d: two samples of DIFF_SAMPLE_ITERS reverse steps each, rendered
    # through the scene's gnomonic procedure into a mosaic; K1 and K2 counted
    counters = {"composite_fused": gn.composite_positions_fused,
                "resample_rows": wm.resample_rows}
    for c in counters.values():
        c.launches = 0
    samples.clear()
    Model.sample = timed_sample
    t0 = time.perf_counter()
    try:
        path = model.visualize_samples_mosaic(
            (GRID_SIZE,) * 3, 2, workdir / "mosaic" / "samples.mp4", num_frames=60, fps=24,
            generator=torch.Generator(device=dev).manual_seed(292),
            max_iter=DIFF_SAMPLE_ITERS)
    finally:
        Model.sample = original_sample
    torch.cuda.synchronize()
    mosaic_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    check(model.render_procedure_name == "render_sh_voxel_grid_gnomonic"
          and all(v > 0 for v in launches.values()), f"3inFusion mosaic launches {launches}")
    mw, mh, mframes = gif_frames(path.read_bytes())
    check(mframes == 59 and mw == 2 * w_, f"3inFusion mosaic GIF {mw} x {mh}, {mframes} frames")
    ms_reverse = float(np.mean([ms for _, ms in samples])) / DIFF_SAMPLE_ITERS
    out["sampling"] = dict(samples=2, max_iter=DIFF_SAMPLE_ITERS,
                           sample_ms=[ms for _, ms in samples], ms_per_reverse_step=ms_reverse,
                           mosaic_s=mosaic_s, launches=launches, gif=[mw, mh, mframes])
    print(f"# 3inFusion sampling ({card_line()}): 2 x {DIFF_SAMPLE_ITERS} reverse steps on "
          f"{GRID_SIZE}^3 x {channels}, batch 1: {[round(ms, 1) for _, ms in samples]} ms = "
          f"{ms_reverse:.3f} ms a reverse step; mosaic {mw} x {mh} x {mframes} frames in "
          f"{mosaic_s:.1f} s; launches {launches}", flush=True)

    # ---- 29e: the same train step with cuDNN / cuBLAS TF32 on, beside it
    # without (the second of two steps each, on one drawn batch)
    opt = torch.optim.Adam(model.unet.parameters(), lr=8e-5, betas=(0.9, 0.999), eps=1e-8)
    draws = dmodel.draw_train_step(g29, tuple(norm.shape), (side,) * 3, DIFF_BATCH,
                                   torch.full((500,), 1 / 500))
    tbatch = dmodel.crop_batch(norm, draws.offsets, (side,) * 3)
    tf32 = {}
    for label, allow in (("f32", False), ("tf32", True)):
        torch.backends.cudnn.allow_tf32 = allow
        torch.backends.cuda.matmul.allow_tf32 = allow
        try:
            tf32[label] = [cuda_ms(torch, lambda: model.train_step(
                opt, tbatch, draws.timesteps, draws.noise))[1] for _ in range(2)][1]
        finally:
            dmodel.strict_f32()
    _, prof_ms, prof = device_profile(torch, lambda: model.train_step(
        opt, tbatch, draws.timesteps, draws.noise), 1, "step", top_n=8)
    out["tf32_step_ms"] = tf32
    out["profiled_device_ms"] = prof_ms
    print(f"# 3inFusion train step with TF32 on ({card_line()}; a reading, the port "
          f"keeps f32): {tf32['tf32']:.3f} ms against {tf32['f32']:.3f} ms in f32; the f32 "
          f"step under torch.profiler {prof_ms:.1f} device ms ({prof_ms / tf32['f32']:.3f} of "
          f"its CUDA-event time), {prof}", flush=True)
    del model, opt, draws, tbatch, norm, fixed, fixed_noise
    torch.cuda.empty_cache()
    return out


# phase 33: the training CLI's default recipe at full width: every default of
# apps/train_sh_voxel_grid.py (256^3 in 4 stages 32^3 -> 256^3, data halved,
# gnomonic with qb = 128) on the dataset of the port's make_synthetic_dataset
RECIPE_VIEWS, RECIPE_IMAGE = (20, 4), 800  # the tool's (train, test) views and pixels
# experiments/run_canonical_256.sh's dataset: a 128^3 blob scene at 1024 samples a ray
RECIPE_SCENE, RECIPE_GT_SAMPLES = 128, 1024
RECIPE_STEPS = 6  # steps a stage (the CLI's 7000, cut)
RECIPE_FRAMES = 5  # the render CLI's frames asked (the thre360 path drops the last)
RECIPE_COUNTERS = ("composite_fused", "composite_backward_fused", "resample_rows",
                   "resample_rows_adjoint", "composite_stripe", "composite_stripe_qb",
                   "composite_stripe_backward", "composite_stripe_backward_qb")


def recipe_counters(port):
    gn, gt, wm = port["gn"], port["gt"], port["wm"]
    fns = (gn.composite_positions_fused, gt.composite_backward_fused, wm.resample_rows,
           wm.resample_rows_adjoint, gn.composite_positions, gn.composite_positions_qb,
           gt.composite_backward, gt.composite_backward_qb)
    return dict(zip(RECIPE_COUNTERS, fns))


def adam_checksum(torch, optimizer):
    """(step, f64 sums of Adam's two moments of each parameter): equal after a
    save and a resume that restored the moments bit for bit."""
    sums = []
    step = None
    for p in optimizer.param_groups[0]["params"]:
        state = optimizer.state[p]
        step = int(state["step"])
        sums += [float(state[k].double().sum()) for k in ("exp_avg", "exp_avg_sq")]
    return step, sums


def recipe_recorder(torch, gt, original_step, counters, steps_per_stage):
    """A stand-in for gnomonic_train_step_multi for phase 33. At each stage's
    first step it closes the stage before (its peak memory and launches), keeps
    the step's start grid (on the host), views, phases, loss and gradient (on
    the host), evaluates the loss on those views alone, and resets the peak
    memory; it times every step (CUDA synchronized), evaluates the first
    step's views again after the stage's last step and keeps Adam's checksum
    there. The evaluations' launches are not counted, and run before the
    peak's reset or after the step."""
    rec = dict(steps=[], firsts={}, launches={}, peak_gb={}, checksum={}, resumed=None)
    stage = {"dims": None, "base": None}

    def close():
        if stage["dims"] is not None:
            torch.cuda.synchronize()
            rec["peak_gb"][stage["dims"]] = torch.cuda.max_memory_allocated() / 1e9
            rec["launches"][stage["dims"]] = {n: c.launches - stage["base"][n]
                                              for n, c in counters.items()}

    def timed_step(tstat, optimizer, grid, images, rots, orgs, focal, generator=None,
                   *, phases=None, **kw):
        if phases is None:
            phases = [None if generator is None else gt.draw_phase(generator)
                      for _ in images]
        dims = tstat.statics.dims[0]
        first = dims not in rec["firsts"]
        views = (images, rots, orgs, focal, phases)
        if first:
            close()
            if rec["resumed"] is None:
                rec["resumed"] = adam_checksum(torch, optimizer) if optimizer.state else ()
            start = tuple(t.detach().to("cpu", copy=True) for t in (grid.densities,
                                                                      grid.features))
            loss_before = uncounted(counters, lambda: views_loss(torch, gt, tstat, grid, views))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stage.update(dims=dims, base={n: c.launches for n, c in counters.items()})
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        m = original_step(tstat, optimizer, grid, images, rots, orgs, focal,
                          phases=phases, **kw)
        torch.cuda.synchronize()
        rec["steps"].append((dims, tstat.fused, (time.perf_counter() - t_step) * 1e3,
                             float(m["total_loss"])))
        if first:
            rec["firsts"][dims] = dict(
                tstat=tstat, start=start, device=grid.device, voxel_size=grid.voxel_size,
                config=grid.get_config_dict(), loss=rec["steps"][-1][3],
                loss_before=loss_before, views=views,
                grads=tuple(t.grad.to("cpu", copy=True) for t in (grid.densities,
                                                                  grid.features)))
        if sum(s_[0] == dims for s_ in rec["steps"]) == steps_per_stage:
            first_rec = rec["firsts"][dims]
            first_rec["loss_after"] = uncounted(counters, lambda: views_loss(
                torch, gt, first_rec["tstat"], grid, first_rec["views"]))
            rec["checksum"][dims] = adam_checksum(torch, optimizer)
        return m

    rec["close"] = close
    return rec, timed_step


def recipe_view_kernels(torch, port, rec):
    """K1 (training branch) and K3 on the first view of a stage's recorded
    first step, from the grid it started from, each counting its tiles that
    gathered directly, beside the stage Stage::fit chose for each (K3 on a
    seeded state cotangent)."""
    gn, gt = port["gn"], port["gt"]
    dev = rec["device"]
    d0, f0 = (t.to(dev) for t in rec["start"])
    grid = port["VoxelGrid"](d0, f0, voxel_size=rec["voxel_size"], **rec["config"])
    tstat = rec["tstat"]
    st = tstat.statics
    Pn, Qn, PB, Pb = tstat.frame
    _, rots, orgs, focal, phases = rec["views"]
    slices = gn.repack_position_slices(grid, st, vertex_only=tstat.fused).to(torch.bfloat16)
    geo = gn.gnomonic_geometry(gt._f32(rots[0], dev), gt._f32(orgs[0], dev), st,
                               tstat.height, tstat.width, gt._f32(focal, dev),
                               tstat.supersample, phase=phases[0], lite=tstat.fused,
                               skip_basis=False)
    occ = gn.gnomonic_occupancy_lite(slices, geo.geom, st, Pn, Qn, PB, Pb,
                                     *gn._qb_blocks(st, Qn))
    args = (slices, geo.ybasis, geo.norm, geo.geom, st, Pn, Qn, PB, Pb, occ)
    direct = [torch.zeros(1, dtype=torch.int32, device=dev) for _ in range(2)]
    state = gn.composite_positions_fused(*args, direct_tiles=direct[0])
    gstate = torch.randn(state.shape, generator=torch.Generator(device=dev).manual_seed(7),
                         device=dev)
    gaux = torch.cat([gstate, (gstate[1:] * state[1:]).sum(0)[None], state[0:1]])
    gt.composite_backward_fused(*args[:4], gaux, occ, *args[4:9], direct_tiles=direct[1])
    TP, TQ = gn.CUDA_EXIT_TILE
    return dict(P=st.pos_per_cell, positions=gn._num_positions(st), frame=(Pn, Qn),
                tiles=(Pn // TP) * (Qn // TQ),
                k1_stage=gn.composite_fused_stage(st, True),
                k3_stage=gt.composite_backward_fused_stage(st),
                k1_direct_tiles=int(direct[0].item()), k3_direct_tiles=int(direct[1].item()))


def recipe_phase(torch, port, workdir, *, dev) -> dict:
    """Phase 33: the training CLI's default recipe at full width. The
    dataset: make_synthetic_dataset's main on the card (RECIPE_VIEWS views
    of RECIPE_IMAGE pixels of a RECIPE_SCENE^3 blob scene at
    RECIPE_GT_SAMPLES samples a ray). The run: the training CLI's main with
    every default but -d, -o, RECIPE_STEPS steps a stage and the save, test
    and feedback frequencies (each stage saves, tests and renders its
    feedback; its edges do anyway). Per stage (32^3 .. 256^3): its first
    step against the plain versions' whole step (phase 12's bounds); the
    loss on its first step's views falling by 1%; K1-K4
    launched, K5-K8 not; ms/step, peak GB, held-out PSNR, the stage
    Stage::fit chose for K1 and K3 and their direct tiles. After: a finite
    256^3 grid, the checkpoints, a resume at stage 4 with its Adam moments
    (two finite steps), and the render CLI's GIF with its load / render /
    encode split."""
    from thr3ed_atom_tpu_torch.tools import make_synthetic_dataset as msd

    gt, cli, rcli = port["gt"], port["cli"], port["rcli"]
    t_phase = time.perf_counter()
    free_gb = shutil.disk_usage(workdir).free / 1e9
    # what earlier phases still hold: every stage's peak below includes it
    resident_gb = torch.cuda.memory_allocated() / 1e9
    data = workdir / "recipe_data"
    t0 = time.perf_counter()
    check(msd.main(["-o", str(data), "--num_train", str(RECIPE_VIEWS[0]), "--num_test",
                    str(RECIPE_VIEWS[1]), "--image_size", str(RECIPE_IMAGE), "--grid_size",
                    str(RECIPE_SCENE), "--gt_samples_per_ray", str(RECIPE_GT_SAMPLES)]) == 0,
          "make_synthetic_dataset failed")
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    pngs = sorted(data.rglob("*.png"))
    check(len(pngs) == sum(RECIPE_VIEWS) and (data / "ground_truth_grid.npz").exists(),
          f"dataset: {len(pngs)} PNGs")
    print(f"# recipe dataset: {len(pngs)} views of {RECIPE_IMAGE} x {RECIPE_IMAGE} "
          f"({RECIPE_SCENE}^3 blob scene, {RECIPE_GT_SAMPLES} samples a ray, fast renderer) "
          f"in {data_s:.1f} s; {free_gb:.1f} GB free on the work disk; {resident_gb:.2f} GB "
          f"allocated on the card before the phase", flush=True)

    counters = recipe_counters(port)
    original_step = gt.gnomonic_train_step_multi
    out_dir = workdir / "recipe_run"
    freq = str(RECIPE_STEPS)
    argv = ["-d", str(data), "-o", str(out_dir), "--num_iterations_per_stage", freq,
            "--save_frequency", freq, "--test_frequency", freq, "--feedback_frequency", freq]
    rec, timed_step = recipe_recorder(torch, gt, original_step, counters, RECIPE_STEPS)
    for c in counters.values():
        c.launches = 0
    gt.gnomonic_train_step_multi = timed_step
    t0 = time.perf_counter()
    try:
        trained = cli.main(argv)
        rec["close"]()
    finally:
        gt.gnomonic_train_step_multi = original_step
    wall = time.perf_counter() - t0
    g = trained.thre3d_repr
    defaults = cli.build_parser().parse_args(["-d", "", "-o", ""])
    side, n_stages = defaults.grid_dims[0], defaults.num_stages
    check(g.grid_dims == (side,) * 3
          and all(bool(torch.isfinite(t).all()) for t in (g.densities, g.features)),
          f"recipe: final grid {g.grid_dims}, or not finite")
    del trained, g
    stages = sorted(rec["firsts"])
    check(stages == [side >> (n_stages - 1 - i) for i in range(n_stages)]
          and len(rec["steps"]) == n_stages * RECIPE_STEPS
          and all(fused for _, fused, _, _ in rec["steps"]),
          f"recipe: steps {[(d, f) for d, f, _, _ in rec['steps']]}")
    saved = out_dir / "saved_models"
    for stage in range(1, n_stages + 1):
        for it in ((stage - 1) * RECIPE_STEPS + 1, stage * RECIPE_STEPS):
            stem = saved / f"model_stage_{stage}_iter_{it}"
            for suffix in (".npz", ".json", "_opt.npz"):
                check(Path(str(stem) + suffix).exists(), f"recipe: missing {stem}{suffix}")
    check((saved / "model_final.npz").exists(), "recipe: missing model_final")
    summaries = [json.loads(line) for line in
                 (out_dir / "training_logs" / "summaries.jsonl").read_text().splitlines()]
    test_psnr = {s["step"]: s["value"] for s in summaries if s["name"] == "TEST_SET_PSNR"}
    check(sorted(test_psnr) == [RECIPE_STEPS * s for s in range(1, n_stages + 1)],
          f"recipe: held-out tests at {sorted(test_psnr)}")
    feedback = sorted((out_dir / "training_logs" / "rendered_output").glob("*.png"))
    print(f"# recipe: {wall:.1f} s in main(); {len(feedback)} feedback images", flush=True)

    per_stage = {}
    for i, dims in enumerate(stages):
        first = rec["firsts"][dims]
        counts = rec["launches"][dims]
        check(all(counts[k] > 0 for k in RECIPE_COUNTERS[:4])
              and all(counts[k] == 0 for k in RECIPE_COUNTERS[4:]),
              f"recipe {dims}^3: launches {counts}")
        check(abs(first["loss_before"] - first["loss"]) <= 1e-5 * first["loss"],
              f"recipe {dims}^3: views' loss {first['loss_before']} before the first step, "
              f"the step's {first['loss']}")
        check(first["loss_after"] <= 0.99 * first["loss_before"],
              f"recipe {dims}^3: loss on its first step's views {first['loss_before']} -> "
              f"{first['loss_after']} after its last step")
        ms = [t for d, _, t, _ in rec["steps"] if d == dims]
        row = dict(ms_per_step=float(np.mean(ms[1:])), first_step_ms=ms[0],
                   peak_gb=rec["peak_gb"][dims], test_psnr=test_psnr[RECIPE_STEPS * (i + 1)],
                   loss_before=first["loss_before"], loss_after=first["loss_after"],
                   launches=counts, views_a_step=len(first["views"][4]),
                   image=(first["tstat"].height, first["tstat"].width))
        # the whole first step through the plain versions fits at every
        # stage (256^3: ~9 s on an NVIDIA H100 80GB HBM3 at 700 W)
        t0 = time.perf_counter()
        plain_loss, cos = uncounted(counters, lambda: replay_first_step(torch, port, first))
        check(abs(first["loss"] - plain_loss) <= 1e-5 * plain_loss and min(cos) > 0.99999,
              f"recipe {dims}^3: first step vs plain: loss {first['loss']} vs "
              f"{plain_loss}, gradient cosines {cos}")
        row.update(plain_loss=plain_loss, grad_cos=cos, plain_s=time.perf_counter() - t0)
        row["kernels_one_view"] = uncounted(counters, lambda: recipe_view_kernels(
            torch, port, first))
        torch.cuda.empty_cache()
        per_stage[f"{dims}^3"] = row
        print(f"# recipe stage {dims}^3 ({row['image'][0]} x {row['image'][1]}, "
              f"{row['views_a_step']} views a step): {row['ms_per_step']:.3f} ms/step "
              f"(steps 2-{RECIPE_STEPS}, CUDA synchronized; first {ms[0]:.1f}), peak "
              f"{row['peak_gb']:.2f} GB, held-out PSNR {row['test_psnr']:.3f} dB, loss on the "
              f"first step's views {first['loss_before']:.5f} -> {first['loss_after']:.5f}; "
              f"whole first step vs plain ({row['plain_s']:.1f} s): loss {first['loss']} vs "
              f"{plain_loss}, cosines {cos}; one view: {row['kernels_one_view']}; launches "
              f"{counts}", flush=True)
    # --resume_from the last stage-4 checkpoint with two more steps a stage:
    # stage 4 from its iteration RECIPE_STEPS + 1 with the saved Adam moments
    # (the other checkpoints, 5.6 GB at 256^3 with Adam's, make room first)
    ckpt = saved / f"model_stage_{n_stages}_iter_{n_stages * RECIPE_STEPS}"
    for path in saved.glob("model_stage_*"):
        if not path.name.startswith(ckpt.name):
            path.unlink()
    res, timed_res = recipe_recorder(torch, gt, original_step, counters, RECIPE_STEPS + 2)
    gt.gnomonic_train_step_multi = timed_res
    t0 = time.perf_counter()
    try:
        resumed = cli.main(["-d", str(data), "-o", str(workdir / "recipe_resume"),
                            "--num_iterations_per_stage", str(RECIPE_STEPS + 2),
                            "--resume_from", str(ckpt)])
        res["close"]()
    finally:
        gt.gnomonic_train_step_multi = original_step
    resume_s = time.perf_counter() - t0
    g = resumed.thre3d_repr
    losses = [loss for _, _, _, loss in res["steps"]]
    check([d for d, _, _, _ in res["steps"]] == [side, side]
          and all(np.isfinite(losses)) and bool(torch.isfinite(g.features).all()),
          f"recipe resume: steps {res['steps']}")
    check(res["resumed"] == rec["checksum"][side],
          f"recipe resume: Adam state {res['resumed']} at the resume, "
          f"{rec['checksum'][side]} saved")
    del resumed, g
    shutil.rmtree(workdir / "recipe_resume")
    print(f"# recipe resume from {ckpt.name}: stage {n_stages} at iteration "
          f"{RECIPE_STEPS + 1}, Adam "
          f"step {res['resumed'][0]} and moments as saved; losses {losses}; {resume_s:.1f} s "
          f"in main()", flush=True)

    # the render CLI on model_final: the checkpoint load, the render and the
    # GIF's encoding timed apart (host clock, synchronized)
    split = {}

    def timed(name, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            split[name] = time.perf_counter() - t
            return r
        return call

    parts = {"load_s": "create_volumetric_model_from_saved_model",
             "render_s": "render_camera_path_for_volumetric_model", "encode_s": "write_video"}
    originals = {attr: getattr(rcli, attr) for attr in parts.values()}
    for name, attr in parts.items():
        setattr(rcli, attr, timed(name, originals[attr]))
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    try:
        gif_path = rcli.main(["-i", str(saved / "model_final.json"), "-o",
                              str(workdir / "recipe_render"), "--num_frames",
                              str(RECIPE_FRAMES)])
    finally:
        for attr, fn in originals.items():
            setattr(rcli, attr, fn)
    render_wall = time.perf_counter() - t0
    render_launches = {n: c.launches for n, c in counters.items()}
    gif_w, gif_h, gif_n = gif_frames(gif_path.read_bytes())
    frame = RECIPE_IMAGE  # the CLI's training frame (halved data) at the render scale 2
    check((gif_w, gif_h, gif_n) == (3 * frame, frame, RECIPE_FRAMES - 1)
          and render_launches["composite_fused"] > 0 and render_launches["resample_rows"] > 0,
          f"recipe render CLI: GIF {gif_w} x {gif_h}, {gif_n} frames; launches "
          f"{render_launches}")
    print(f"# recipe render CLI (model_final {side}^3, {gif_n} frames of {frame} x {frame}): "
          f"{render_wall:.2f} s in main(): load {split['load_s']:.2f} s, render "
          f"{split['render_s']:.2f} s, GIF encoding {split['encode_s']:.2f} s; "
          f"{gif_path.stat().st_size} bytes; launches {render_launches}", flush=True)
    shutil.rmtree(out_dir)
    phase_s = time.perf_counter() - t_phase
    print(f"# recipe (phase 33): {phase_s:.1f} s", flush=True)
    return dict(stages=per_stage, resident_gb=resident_gb, dataset_s=data_s, wall_s=wall,
                resume_s=resume_s,
                render_cli=dict(wall_s=render_wall, **split, launches=render_launches),
                phase_s=phase_s,
                launches={k: sum(r["launches"][k] for r in per_stage.values())
                          for k in RECIPE_COUNTERS})


def diffusion_batch_probe(torch, batch: int) -> int:
    """``--diffusion-batch B``: one full-width 3inFusion train step (the
    CLI's UNet and diffusion, 112^3 crops of the 128^3 blob scene's
    normalized grid) at batch B; prints its peak memory, or that it ran out
    of memory, and the card's name and power limit."""
    from thr3ed_atom_tpu_torch.diffusion import gaussian_diffusion as gdm
    from thr3ed_atom_tpu_torch.diffusion import model as dmodel
    from thr3ed_atom_tpu_torch.diffusion import unet as dunet

    print(card_line(), flush=True)
    dev = torch.device("cuda")
    d, f, _ = blob_scene(GRID_SIZE)
    norm = dmodel.normalize_grid(torch.as_tensor(np.concatenate([d, f], -1)).to(dev))[0]
    model = dmodel.Thre3inFusionModel(app_unet(dunet, norm.shape[-1]), app_diffusion(gdm),
                                      device=dev)
    dmodel.strict_f32()
    side = dmodel.training_crop_side((GRID_SIZE,) * 3, 0.8, 4)
    opt = torch.optim.Adam(model.unet.parameters(), lr=8e-5)
    gen = torch.Generator(device=dev).manual_seed(0)
    result = dict(batch=batch, crop=side)
    torch.cuda.reset_peak_memory_stats()
    try:
        for i in range(2):
            draws = dmodel.draw_train_step(gen, tuple(norm.shape), (side,) * 3, batch,
                                           torch.full((500,), 1 / 500))
            batch_t = dmodel.crop_batch(norm, draws.offsets, (side,) * 3)
            loss, ms = cuda_ms(torch, lambda: model.train_step(opt, batch_t, draws.timesteps,
                                                                draws.noise))
            result[f"step{i + 1}_ms"] = ms
            del draws, batch_t
        result.update(fits=True, loss=float(loss))
    except torch.cuda.OutOfMemoryError as error:
        result.update(fits=False, error=str(error).splitlines()[0])
    result["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"diffusion_batch": result}), flush=True)
    return 0


def main() -> int:
    import torch

    args = sys.argv[1:]
    if args and args not in (["--stripe-split"], ["--full-recipe"]) and (
            len(args) != 2 or args[0] not in ("--readings", "--diffusion-batch")):
        print("usage: python3 chip_smoke.py [--readings PORT_ROOT | --stripe-split | "
              "--diffusion-batch B | --full-recipe]", file=sys.stderr)
        return 2
    root = Path(args[1]).resolve() if args[:1] == ["--readings"] else REPO
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not (root / "thr3ed_atom_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    if args == ["--stripe-split"]:
        port = load_port()
        dev = torch.device("cuda")
        split = stripe_split(torch, port, main_scene(port, dev), dev)
        print(json.dumps({"stripe_split": split}))
        return 0
    if args[:1] == ["--diffusion-batch"]:
        load_port()
        return diffusion_batch_probe(torch, int(args[1]))
    if args[:1] == ["--readings"]:
        return readings(torch)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        if args == ["--full-recipe"]:
            return full_recipe(torch, workdir)
        return run(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def full_recipe(torch, workdir: Path) -> int:
    """Phase 33 alone, after the build, in a process of its own."""
    port = load_port()
    print(card_line())
    print(f"# torch device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    port["kernels"].build_all()
    print(f"# build in {time.perf_counter() - t0:.1f} s", flush=True)
    recipe = recipe_phase(torch, port, workdir, dev=torch.device("cuda"))
    print(json.dumps({"full_recipe": recipe}, default=str))
    return 0


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Scene(NamedTuple):
    """The main path's scene: the 128^3 blob model (arrays and grid), the
    serving render config, intrinsics, the orbit poses and the first render
    pose's rotation, origin and march variant."""
    d: np.ndarray
    f: np.ndarray
    grid_config: dict
    config: object
    intr: object
    poses: list
    grid: object
    rot0: np.ndarray
    org0: np.ndarray
    axis: int
    flip: bool


def main_scene(port, dev) -> Scene:
    d, f, grid_config = blob_scene(GRID_SIZE)
    Config, camera = port["Config"], port["camera"]
    config = Config(num_samples_per_ray=256,
                    camera_bounds=camera.CameraBounds(2.0, 6.0),
                    perturb_sampled_points=False, white_bkgd=True, gnomonic_qb=128)
    intr = camera.CameraIntrinsics(IMAGE_SIZE, IMAGE_SIZE, IMAGE_SIZE * 1.1)
    poses = camera.get_thre360_animation_poses(4.0, -60.0, NUM_POSES + 1)
    grid = port["voxel_grid_from_numpy"](d, f, grid_config, device=dev)
    rot0 = np.asarray(poses[1].rotation, np.float32).reshape(3, 3)
    org0 = np.asarray(poses[1].translation, np.float32).reshape(3)
    axis, flip = port["gn"].dominant_axis_for_pose(rot0)
    return Scene(d, f, grid_config, config, intr, poses, grid, rot0, org0, axis, flip)


def k5_operands(torch, port, sc, dev, kind):
    """The stripe composite's operands on the blob pose and the count of t1
    elements that differ from the f32 reference (``stripe_case``):
    ``serving`` the serving statics with qb = 0 at exit 1e-4 (phase 9),
    ``training`` the qb = 0 train statics (diffuse, phase-shifted frame;
    phases 9-10), ``qsplit`` the serving statics with qb = 128 at exit 1e-4
    (K6, phase 13), ``qsplit_training`` the fused=False, qb = 128 train
    statics (K6 / K8, phase 13)."""
    gn, gt, wm = port["gn"], port["gt"], port["wm"]
    focal_t = torch.tensor(sc.intr.focal, dtype=torch.float32, device=dev)
    rot0_t, org0_t = torch.as_tensor(sc.rot0, device=dev), torch.as_tensor(sc.org0, device=dev)
    if kind in ("training", "qsplit_training"):
        swap0 = wm.warp_swap_for_pose(sc.rot0, sc.axis, sc.flip, IMAGE_SIZE, IMAGE_SIZE,
                                      sc.intr.focal)
        qb = 128 if kind == "qsplit_training" else 0
        tstat0 = gt.make_gnomonic_train_statics(
            sc.grid, sc.axis, sc.flip, image_height=IMAGE_SIZE, image_width=IMAGE_SIZE,
            white_bkgd=True, apply_diffuse_render_regularization=True, warp_swap=swap0, qb=qb,
            fused=False)
        check(not tstat0.fused and gn._qb_blocks(tstat0.statics, tstat0.frame[1])[0]
              == (4 if qb else 1), f"{kind} train statics: fused {tstat0.fused}, frame "
              f"{tstat0.frame}")
        return stripe_case(torch, gn, sc.grid, tstat0.statics, rot0_t, org0_t, IMAGE_SIZE,
                           focal_t, tstat0.supersample, phase=(0.25, -0.125))
    st = gn._variant_statics(sc.grid, sc.axis, sc.flip, sc.config)
    ss = gn.effective_supersample(sc.config.gnomonic_supersample, st, IMAGE_SIZE, IMAGE_SIZE)
    qb = 0 if kind == "serving" else st.qb
    return stripe_case(torch, gn, sc.grid, st._replace(qb=qb, exit_eps=1e-4), rot0_t, org0_t,
                       IMAGE_SIZE, focal_t, ss)


def k10_operands(torch, port, sc, dev, vgrid=None):
    """Phase 14's slab-march operands (tables, counts, ray records, the
    repacked grid) of the blob pose on the serving variant, of ``vgrid``
    (default: the scene's grid), its kwargs and whether the tables
    overflowed."""
    br = port["br"]
    vgrid = sc.grid if vgrid is None else vgrid
    bst = br.variant_statics(vgrid, sc.axis, sc.flip, sc.config)
    rep, occ_b = br.prepare_bricked_grid(vgrid, bst)
    rf, tab, cnt, ovf = br.tile_operands(bst, IMAGE_SIZE, IMAGE_SIZE, sc.intr.focal, occ_b,
                                         torch.as_tensor(sc.rot0, device=dev),
                                         torch.as_tensor(sc.org0, device=dev))
    kw = dict(ncoeff=bst.ncoeff, relu_sigma=bst.relu_sigma, exit_eps=bst.exit_eps,
              with_diffuse=bst.with_diffuse)
    return (tab, cnt, rf, rep), kw, ovf


def k11_operands(torch, port, sc, dev, vgrid=None, cli=False, tile_px=None):
    """Phase 17's plane-march operands (tables, counts, ray records, the
    repacked grid) of the blob pose on the serving variant, of ``vgrid``
    (default: the scene's grid), its kwargs and whether the tables
    overflowed; ``cli``: of the render CLI's frame instead (phase 19: 800 x
    800, focal doubled, the second pose of its thre360 path at pitch 60,
    2500 tiles); ``tile_px``: tiles of that edge instead of the variant's."""
    pl = port["pl"]
    vgrid = sc.grid if vgrid is None else vgrid
    rot, org, size, focal, axis, flip = (sc.rot0, sc.org0, IMAGE_SIZE, sc.intr.focal, sc.axis,
                                         sc.flip)
    if cli:
        pose = port["camera"].get_thre360_animation_poses(4.0, 60.0, NUM_POSES)[1]
        rot = np.asarray(pose.rotation, np.float32).reshape(3, 3)
        org = np.asarray(pose.translation, np.float32).reshape(3)
        size, focal = 2 * IMAGE_SIZE, 2 * sc.intr.focal
        axis, flip = pl.dominant_axis_for_pose(rot)
    pst = pl.variant_statics(vgrid, axis, flip, sc.config)
    if tile_px is not None:
        pst = pst._replace(tile_px=tile_px)
    rep, occ_p = pl.prepare_plane_grid(vgrid, pst)
    rf, tab, cnt, ovf = pl.tile_operands(pst, size, size, focal, occ_p,
                                         torch.as_tensor(rot, device=dev),
                                         torch.as_tensor(org, device=dev))
    kw = dict(ncoeff=pst.ncoeff, relu_sigma=pst.relu_sigma, exit_eps=pst.exit_eps,
              with_diffuse=pst.with_diffuse)
    return (tab, cnt, rf, rep), kw, ovf


def k10_cotangent(torch, out):
    """The output cotangent K10 is driven with: normal draws of ``out``'s
    shape from seed 0."""
    return torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(0),
                       device=out.device)


def trainer_batch(torch, ops, *per_tile):
    """The bricked trainer's batch of a pose: K10_BATCH_TILES of its tiles,
    drawn without replacement from a seed (the trainer draws its tiles over
    the image at random), as (ops, *per_tile) with the tables, counts, ray
    records and each of ``per_tile`` ([T, ...] tensors) cut to them."""
    T = ops[0].shape[0]
    sel = torch.as_tensor(np.sort(np.random.default_rng(0).choice(T, K10_BATCH_TILES,
                                                                  replace=False)),
                          device=ops[0].device)
    return (tuple(x[sel] for x in ops[:3]) + tuple(ops[3:]),) + tuple(x[sel] for x in per_tile)


def grad_readings(torch, grad, name, ops, out, gout, kw, label, counted=True, profiled=False):
    """A replay backward on ``ops``: K10 (``grad`` the port's
    slab_march_grad, ``name`` "slab_march_backward") or K12
    (plane_march_grad, "plane_march_backward"). Device ms (CUDA events) of a
    call, of the kernel alone (launched into a cotangent zeroed before,
    ``dgrid=``; None where the port's wrapper has no ``dgrid``) and of the
    f32 cotangent's zeroing alone (torch.zeros of the grid's shape);
    ``profiled``, the kernel's device ms under torch.profiler too (a wrapper
    with or without ``dgrid``); ``counted``, where the wrapper takes
    ``stats``, its counts: tap products (the global atomics of a tap-by-tap
    add), global atomics issued, steps summed in shared memory and added
    directly."""
    grid = ops[3]
    params = inspect.signature(grad).parameters
    ms = time_ms(torch, lambda: grad(*ops, out, gout, **kw), 5)
    kernel_ms = None
    if "dgrid" in params:
        dgrid = torch.zeros(grid.shape, dtype=torch.float32, device=grid.device)
        kernel_ms = time_ms(torch, lambda: grad(*ops, out, gout, **kw, dgrid=dgrid), 5)
        del dgrid
    zeros_ms = time_ms(torch, lambda: torch.zeros(grid.shape, dtype=torch.float32,
                                                  device=grid.device), 5)
    r = dict(ms=ms, kernel_ms=kernel_ms, zeros_ms=zeros_ms, tiles=int(ops[0].shape[0]),
             rays_a_tile=int(ops[2].shape[1]))
    alone = "not measured" if kernel_ms is None else f"{kernel_ms:.4f}"
    line = (f"# {name} {label} ({r['tiles']} tiles of {r['rays_a_tile']} rays): ms={ms:.4f}; "
            f"the kernel alone {alone}, the zeroing alone {zeros_ms:.4f} (CUDA events)")
    if profiled:
        kname = f"{name}_kernel"
        parts, r["profiled_share"] = kernel_times(torch, lambda: grad(*ops, out, gout, **kw),
                                                  5, [kname], ms)
        r["profiled_kernel_ms"] = parts[kname]
        line += (f"; the kernel under torch.profiler {r['profiled_kernel_ms']:.4f} (the trace "
                 f"holds {r['profiled_share']:.3f} of the call)")
    if counted and "stats" in params:
        stats = torch.zeros(4, dtype=torch.int64, device=out.device)
        grad(*ops, out, gout, **kw, stats=stats)
        torch.cuda.synchronize()
        products, atomics, summed, direct = stats.tolist()
        r.update(tap_products=products, global_atomics=atomics, steps_summed=summed,
                 steps_direct=direct)
        line += (f"; tap products {products} (a tap-by-tap add's global atomics), global "
                 f"atomics {atomics}, steps summed in shared memory {summed}, added "
                 f"directly {direct}")
    print(line, flush=True)
    return r


def stripe_split(torch, port, sc, dev):
    """K7 on phase 10's operands and K8 on phase 13's (the training pose at
    128^3, qb = 0 and qb = 128), a seeded state cotangent: the call and the
    three launches the band kernel replaced (``stripe_backward_three_launch``),
    each by CUDA events and split by launch under
    torch.profiler (with the share of the events' time the trace holds),
    and a sha1 of the call's dt1, which agrees between ports that sum alike.
    Printed as it goes; returns {"k7": {...}, "k8": {...}}."""
    gn, gt = port["gn"], port["gt"]
    out = {}
    for kind, key in (("training", "k7"), ("qsplit_training", "k8")):
        args, _ = k5_operands(torch, port, sc, dev, kind)
        bargs = stripe_backward_args(torch, args, gn.composite_positions(*args),
                                     torch.Generator(device=dev).manual_seed(10))
        del args
        st, (Pn, Qn, PB, Pb) = bargs[9], bargs[10:]
        QB, Qb = gn._qb_blocks(st, Qn)
        checked = gn._check_stripe_operands(key, *bargs[:7], *bargs[8:])
        g32 = bargs[7].contiguous()
        fns = {"call": lambda: gt.composite_backward(*bargs),
               "three_launch": lambda: gt.stripe_backward_three_launch(
                   checked, g32, st, Pn, Qn, Pb, QB, Qb)}
        r = {}
        for name, fn in fns.items():
            ms = time_ms(torch, fn, 5)
            parts, share = kernel_times(torch, fn, 5, STRIPE_BACKWARD_KERNELS, ms)
            r[name] = dict(ms=ms, parts_ms=parts, profiled_share=share)
        dt1 = fns["call"]()
        r["dt1_sha1"] = hashlib.sha1(dt1.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
        out[key] = r
        print(f"# {key.upper()} ({QB} q-block{'s' if QB > 1 else ''}): "
              + "; ".join(f"{name} {v['ms']:.4f} ms (CUDA events), under torch.profiler "
                          + ", ".join(f"{n_} {t:.4f}" for n_, t in v["parts_ms"].items())
                          + f" (the trace holds {v['profiled_share']:.3f} of the call)"
                          for name, v in r.items() if name != "dt1_sha1")
              + f"; dt1 sha1 {r['dt1_sha1']}", flush=True)
        del bargs, fns, dt1, checked, g32
    return out


def stripe_split_process():
    """``stripe_split`` in a process of its own (``--stripe-split``), where
    torch.profiler's trace holds the kernels' time (see kernel_times);
    waits for it and returns its result."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--stripe-split"],
                          capture_output=True, text=True, timeout=600, cwd=str(REPO))
    print("\n".join(line for line in proc.stdout.splitlines() if line.startswith("# K")),
          flush=True)
    check(proc.returncode == 0, f"--stripe-split failed (rc {proc.returncode}): "
          f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])["stripe_split"]


def readings(torch) -> int:
    """The ``--readings`` mode: K5-K13 of the imported port on the operands
    phases 9, 10, 13, 14, 17 and 20 build (see the module docstring)."""
    port = load_port()
    gn, gt, sm, pm = port["gn"], port["gt"], port["sm"], port["pm"]
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    logs = port["kernels"].build_all()
    for name in ("slab_march", "plane_march"):
        for line in logs.get(name, "").splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry")):
                print(f"# ptxas {name}: {line.strip()}")
    sc = main_scene(port, dev)
    out = {}
    for kind, key, iters in (("serving", "k5_serving_ms", 20), ("training", "k5_training_ms", 10),
                             ("qsplit", "k6_serving_ms", 20)):
        args, _ = k5_operands(torch, port, sc, dev, kind)
        out[key] = time_ms(torch, lambda: gn.composite_positions(*args), iters)
        del args
    out.update(stripe_split(torch, port, sc, dev))
    ops, kw, _ = k10_operands(torch, port, sc, dev)
    fwd = sm.slab_march_render(*ops, **kw)
    gout = k10_cotangent(torch, fwd)
    for label, args in (("pose", (ops, fwd, gout)),
                        ("batch", trainer_batch(torch, ops, fwd, gout))):
        out[f"k9_{label}_ms"] = time_ms(torch, lambda: sm.slab_march_render(*args[0], **kw), 20)
        r = grad_readings(torch, sm.slab_march_grad, "slab_march_backward", *args, kw, label,
                          counted=False, profiled=True)
        out.update({f"k10_{label}_{k}": v for k, v in r.items()})
    out["k9_shape"] = march_shape(sm, "slab_march", ops[2].shape[1], kw, logs.get("slab_march"))
    del ops, fwd, gout
    for label, cli in (("pose", False), ("cli", True)):
        ops11, kw11, _ = k11_operands(torch, port, sc, dev, cli=cli)
        out[f"k11_{label}_ms"] = time_ms(torch, lambda: pm.plane_march_render(*ops11, **kw11),
                                         20 if not cli else 10)
        out[f"k11_{label}_tiles"] = int(ops11[0].shape[0])
        if not cli:
            out["k11_shape"] = march_shape(sm, "plane_march", ops11[2].shape[1], kw11,
                                           logs.get("plane_march"))
        del ops11
    # K12 on the pose, and on the pose cut into 8 x 8 tiles (the planes
    # procedure's tiles past 128 vertices a side)
    for label, tile_px in (("pose", None), ("pose_tile8", 8)):
        ops11, kw11, _ = k11_operands(torch, port, sc, dev, tile_px=tile_px)
        fwd11 = pm.plane_march_render(*ops11, **kw11)
        gout11 = k10_cotangent(torch, fwd11)
        r = grad_readings(torch, pm.plane_march_grad, "plane_march_backward", ops11, fwd11,
                          gout11, kw11, label, profiled=True)
        out.update({f"k12_{label}_{k}": v for k, v in r.items()})
        del ops11, fwd11, gout11
    # K13 at phase 20's three shapes: the trilinear corners (K = 8), the
    # weights' cotangent (K = 1 on N K rows) and B = 4096
    og = port["og"]
    B, C, N, K = ONEHOT_BCNK
    gen = torch.Generator(device=dev).manual_seed(20)
    idx, w = trilinear_corners(torch, gen, dev, N, 8)
    table = torch.randn(B, C, generator=gen, device=dev)
    idxL = torch.randint(0, ONEHOT_LARGE_B, (N, K), generator=gen, device=dev,
                         dtype=torch.int32)
    tableL = torch.randn(ONEHOT_LARGE_B, C, generator=gen, device=dev)
    ones = torch.ones(N * K, 1, device=dev)
    for key, args, iters in (("k13_ms", (table, idx, w), 20),
                             ("k13_k1_ms", (table, idx.reshape(N * K, 1), ones), 10),
                             ("k13_large_B_ms", (tableL, idxL, w), 20)):
        out[key] = time_ms(torch, lambda: og.onehot_gather_forward(*args), iters)
    del idx, w, table, idxL, tableL, ones
    print(f"# K9 pose {out['k9_pose_ms']:.4f} ms, batch {out['k9_batch_ms']:.4f}, "
          f"{out['k9_shape']}; K11 pose {out['k11_pose_ms']:.4f}, CLI frame "
          f"{out['k11_cli_ms']:.4f} ({out['k11_cli_tiles']} tiles), {out['k11_shape']}; "
          f"K12 pose {out['k12_pose_ms']:.4f}, 8 x 8 tiles {out['k12_pose_tile8_ms']:.4f}; "
          f"K13 {out['k13_ms']:.4f}, K = 1 {out['k13_k1_ms']:.4f}, B = {ONEHOT_LARGE_B} "
          f"{out['k13_large_B_ms']:.4f}", flush=True)
    print(json.dumps({"readings": out, "port": str(Path(gn.__file__).resolve().parents[2])}))
    return 0


def run(torch, workdir: Path) -> int:
    """The phases; files go to ``workdir``."""
    port = load_port()
    kernels, gn, wm, rt, vm = (port[k] for k in ("kernels", "gn", "wm", "rt", "vm"))
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- phase 1: the card, the build
    smi = card_line()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"# torch device: {kind}; torch {torch.__version__}, cuda {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    logs = kernels.build_all()
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry")):
                print(f"# ptxas {name}: {line.strip()}")
    print(f"# build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)

    # the main path's shapes
    Config, camera = port["Config"], port["camera"]
    scene = main_scene(port, dev)
    d, f, grid_config, config, intr, poses, grid, rot0, org0, axis, flip = scene
    results = {}

    # ---- phase 4 inputs first (phase 2 uses the march's shapes)
    st = gn._variant_statics(grid, axis, flip, config)
    ss = gn.effective_supersample(config.gnomonic_supersample, st, IMAGE_SIZE, IMAGE_SIZE)
    Pn, Qn, PB, Pb = gn.gnomonic_frame(None, IMAGE_SIZE, IMAGE_SIZE, intr.focal, ss, st)
    QB, Qb = gn._qb_blocks(st, Qn)
    NP = gn._num_positions(st)
    print(f"# march: grid {GRID_SIZE}^3 C={gn._padded_channels(st)} P={st.pos_per_cell} "
          f"NP={NP} frame {Pn}x{Qn} blocks {Pb}x{Qb} ({PB}x{QB})", flush=True)

    # ---- phase 2: relu_trap (K1a) test entry vs plain, one frame per cell
    gen = torch.Generator(device=dev).manual_seed(0)
    n = (NP - 1) * Pn * Qn
    a = torch.rand(n, generator=gen, device=dev) * 8.0 - 4.0
    b = torch.rand(n, generator=gen, device=dev) * 8.0 - 4.0
    k = n // 4
    b[:k] = a[:k] + (torch.rand(k, generator=gen, device=dev) - 0.5) * 4e-6
    b[k:k + 1000] = a[k:k + 1000]
    trap_err, trap_ms, trap_plain_ms = 0.0, {}, {}
    for relu in (True, False):
        x, y = (a, b) if relu else (a.abs(), b.abs())
        got = rt.relu_trap(x, y, relu)
        torch.cuda.synchronize()
        want = rt.relu_trap_plain(x, y, relu)
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=1e-6, atol=1e-7)
            trap_err = max(trap_err, max_abs(g_, w_))
        trap_ms[relu] = time_ms(torch, lambda: rt.relu_trap(x, y, relu), 20)
        trap_plain_ms[relu] = time_ms(torch, lambda: rt.relu_trap_plain(x, y, relu), 5)
    del got, want
    print(f"# K1a relu_trap: n={n} max_abs={trap_err:.3g} ms={trap_ms} plain_ms={trap_plain_ms}",
          flush=True)
    results["relu_trap"] = dict(
        err=trap_err, ms=trap_ms[True], plain_ms=trap_plain_ms[True],
        bound=bound(n * 4 * 6, n * 30),
    )

    # ---- phase 3: resample_rows (K2) vs plain at [512, 8, 512] -> [512, 3, 8, 512]
    NB, CH, K, N = Pn, 8, Qn, -(-IMAGE_SIZE // 128) * 128
    X = torch.randn(NB, CH, K, generator=gen, device=dev)
    X[:, :, : K // 3] = 0.0
    a_i = torch.rand(NB, 1, 1, generator=gen, device=dev) * (K / 4)
    slope = 0.6 + 0.4 * torch.rand(NB, 1, 1, generator=gen, device=dev)
    pos = (a_i + slope * torch.arange(N, device=dev, dtype=torch.float32)).contiguous()
    rs_err = 0.0
    for order in (1, 3):
        lo, hi = wm._clip_range(order, K)
        p_o = pos.clamp(lo, hi).contiguous()
        for taps in (False, True):
            got = wm.resample_rows(X, p_o, order, taps)
            torch.cuda.synchronize()
            want = wm.resample_rows_plain(X, p_o, order, taps)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
            rs_err = max(rs_err, max_abs(got, want))
    p3 = pos.clamp(*wm._clip_range(3, K)).contiguous()
    rs_ms = time_ms(torch, lambda: wm.resample_rows(X, p3, 3, True), 50)
    rs_plain_ms = time_ms(torch, lambda: wm.resample_rows_plain(X, p3, 3, True), 10)
    print(f"# K2 resample_rows: [{NB},{CH},{K}] -> [{NB},3,{CH},{N}] max_abs={rs_err:.3g} "
          f"ms={rs_ms:.4f} plain_ms={rs_plain_ms:.4f}", flush=True)
    # a library yardstick exists only for the bilinear pass without taps:
    # F.grid_sample over [NB, CH, 1, K] at the same positions (never used by the port)
    p1 = pos.clamp(*wm._clip_range(1, K)).contiguous()
    gxy = torch.stack([p1[:, 0] * (2.0 / (K - 1)) - 1.0, torch.zeros_like(p1[:, 0])], -1)
    X4 = X[:, :, None, :]
    lib = torch.nn.functional.grid_sample(X4, gxy[:, None], mode="bilinear",
                                          padding_mode="zeros", align_corners=True)
    k1o = wm.resample_rows(X, p1, 1)
    # K2_READINGS device-clock readings of each, in turns (kernel, library)
    bil_runs, lib_runs = [], []
    for _ in range(K2_READINGS):
        bil_runs.append(time_ms(torch, lambda: wm.resample_rows(X, p1, 1), 50))
        lib_runs.append(time_ms(torch, lambda: torch.nn.functional.grid_sample(
            X4, gxy[:, None], mode="bilinear", padding_mode="zeros", align_corners=True), 50))
    bil_ms, lib_ms = float(np.median(bil_runs)), float(np.median(lib_runs))
    print(f"# K2 order 1 without taps, {K2_READINGS} device-clock readings each: kernel "
          f"median {bil_ms:.4f} ms (range {min(bil_runs):.4f}-{max(bil_runs):.4f}), "
          f"F.grid_sample median {lib_ms:.4f} ms (range {min(lib_runs):.4f}-"
          f"{max(lib_runs):.4f}) (max-abs {max_abs(k1o, lib[:, :, 0]):.3g}: grid_sample "
          f"renormalizes positions)", flush=True)
    # the kernel stages a row's [8, K] slab in shared memory where it fits
    # and X is 16-byte aligned; the same values 4 bytes off that alignment
    # take its L1 gathers: 3 device-clock readings each, in turns; both exact
    X_l1 = torch.empty(X.numel() + 1, device=dev)[1:].view_as(X).copy_(X)
    stage_runs = {}
    for label, p_o, order, taps in (("order1", p1, 1, False), ("order3_taps", p3, 3, True)):
        check(torch.equal(wm.resample_rows(X, p_o, order, taps),
                          wm.resample_rows(X_l1, p_o, order, taps)),
              f"K2 {label}: staged and L1 passes differ")
        runs = dict(staged=[], l1=[])
        for _ in range(3):
            for key, x_in in (("staged", X), ("l1", X_l1)):
                runs[key].append(time_ms(torch, lambda: wm.resample_rows(x_in, p_o, order,
                                                                         taps), 50))
        stage_runs[label] = runs
        print(f"# K2 {label}: row slab staged in shared memory "
              f"{' '.join(f'{m:.4f}' for m in runs['staged'])} ms, gathered through L1 "
              f"(X 4 bytes off alignment) {' '.join(f'{m:.4f}' for m in runs['l1'])} ms",
              flush=True)
    del X_l1
    # the same calls queued as they come from the host (the serving path's
    # pace), the wrapper's launch path beside them; "before": the launch
    # path as it was before kernels.bind, around the same kernel
    legacy_k2 = legacy_rows_call(torch, kernels, wm, adjoint=False)
    k2_paced = dict(
        order3_taps=host_paced(torch, lambda: wm.resample_rows(X, p3, 3, True), 50),
        order1=host_paced(torch, lambda: wm.resample_rows(X, p1, 1), 50),
        order1_before=host_paced(torch, lambda: legacy_k2(X, p1, 1, False), 50),
        order1_library=host_paced(torch, lambda: torch.nn.functional.grid_sample(
            X4, gxy[:, None], mode="bilinear", padding_mode="zeros", align_corners=True), 50))
    for label, h in k2_paced.items():
        print(f"# K2 host-paced ms, {label}: {paced_str(h)}", flush=True)
    k2_parts = launch_parts(torch, kernels, wm, X, p1, 1, False, adjoint=False)
    print(f"# K2 launch path, host us a call: {parts_str(k2_parts)}", flush=True)
    # bytes: the source samples the band reads, the positions, the output
    n_src = resample_sources(torch, p3, 3, K)
    results["resample_rows"] = dict(
        err=rs_err, ms=rs_ms, plain_ms=rs_plain_ms,
        bound=bound(4 * (n_src * CH + NB * N + NB * 3 * CH * N),
                    NB * N * (CH * 4 * 2 + 40)),
    )

    # ---- phase 4: composite_fused (K1) vs plain on the 128^3 blob scene, and
    # on the same scene made opaque (density x 100), where tiles end early
    def k1_inputs(vgrid):
        slices = gn._cached_slices(vgrid, st, {})
        geo = gn.gnomonic_geometry(torch.as_tensor(rot0, device=dev),
                                   torch.as_tensor(org0, device=dev), st,
                                   IMAGE_SIZE, IMAGE_SIZE,
                                   torch.tensor(intr.focal, dtype=torch.float32, device=dev), ss)
        occ = gn.gnomonic_occupancy_lite(slices, geo.geom, st, Pn, Qn, PB, Pb, QB, Qb)
        return slices, geo, occ

    def k1_compare(slices, geo, occ, eps, label):
        args = (slices, None, None, geo.geom, st._replace(exit_eps=eps), Pn, Qn, PB, Pb, occ)
        direct = torch.zeros(1, dtype=torch.int32, device=dev)
        got = gn.composite_positions_fused(*args, xr=geo.xr, yr=geo.yr, direct_tiles=direct)
        torch.cuda.synchronize()
        want, work = gn.composite_positions_fused_plain(
            *args, xr=geo.xr, yr=geo.yr, exit_tile=gn.CUDA_EXIT_TILE, return_work=True)
        gap = (got - want).abs().amax(dim=(1, 2)).tolist()
        check(bool(torch.isfinite(got).all()), "composite produced non-finite values")
        check(max(gap[:5]) <= 1e-4 and gap[5] <= 1e-3,
              f"composite vs plain ({label}, exit_eps={eps}): per-row max-abs {gap}")
        print(f"# K1 composite {label} exit_eps={eps}: max-abs per row (T,rgb,acc,depth) "
              f"{gap}; marched (position, texel) pairs {int(work.sum())} of {NP * Pn * Qn}; "
              f"direct-gather tiles {int(direct.item())} of {(Pn // 8) * (Qn // 32)}",
              flush=True)
        return max(gap), work

    k1_err = 0.0
    opaque = port["voxel_grid_from_numpy"](np.where(d > 0, d * 100.0, d), f, grid_config,
                                           device=dev)
    o_slices, o_geo, o_occ = k1_inputs(opaque)
    o_work = {}
    for eps in (0.0, 1e-4):
        err, o_work[eps] = k1_compare(o_slices, o_geo, o_occ, eps, "opaque")
        k1_err = max(k1_err, err)
    check(int(o_work[1e-4].sum()) < int(o_work[0.0].sum()),
          "the early exit ended no tile on the opaque scene")
    del opaque, o_slices, o_geo, o_occ, o_work

    slices, geo, occ = k1_inputs(grid)
    for eps in (0.0, 1e-4):
        err, work = k1_compare(slices, geo, occ, eps, "blob")
        k1_err = max(k1_err, err)
    args = (slices, None, None, geo.geom, st, Pn, Qn, PB, Pb, occ)
    k1_ms = time_ms(torch, lambda: gn.composite_positions_fused(*args, xr=geo.xr, yr=geo.yr), 20)
    k1_plain_ms = time_ms(torch, lambda: gn.composite_positions_fused_plain(
        *args, xr=geo.xr, yr=geo.yr, exit_tile=gn.CUDA_EXIT_TILE), 3)
    nvert, nu, C, nv = slices.shape
    # both terms count this pose's marched pairs (work at exit_eps 1e-4) only.
    # ops per pair: 2 x 2 tent taps x 2 (mul, add) per used channel, the v
    # combine (4 per channel) and the SH fold (2 per coefficient). bytes: the
    # used channels (bf16) of the distinct vertex records those pairs read,
    # the geometry, both flag arrays, the state written
    used = 3 * st.ncoeff + 1
    n_work = int(work.sum())
    n_rec = composite_records(torch, work, geo.geom, nvert, nu, nv, st.pos_per_cell)
    k1_ops = n_work * (used * 8 + used * 4 + 3 * st.ncoeff * 2)
    k1_bytes = n_rec * used * 2 + NP * 8 * 4 + 2 * PB * QB * NP * 4 + 6 * Pn * Qn * 4
    print(f"# K1 composite: ms={k1_ms:.4f} plain_ms={k1_plain_ms:.4f}; bound counts "
          f"{n_work} pairs, {n_rec} of {nvert * nu * nv} vertex records "
          f"({k1_bytes} bytes, {k1_ops} operations)", flush=True)
    results["composite_fused"] = dict(
        err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms, bound=bound(k1_bytes, k1_ops),
    )
    del slices, work

    # ---- phase 5: the serving path end to end
    model = vm.VolumetricModel(grid, "render_sh_voxel_grid_gnomonic", config)
    vm.save_model(model, workdir / "blob128",
                  {"hemispherical_radius": 4.0,
                   "camera_intrinsics": [IMAGE_SIZE, IMAGE_SIZE, intr.focal]})
    del model
    model, extra = vm.create_volumetric_model_from_saved_model(workdir / "blob128")
    check(model.thre3d_repr.device.type == "cuda", "the loaded model is not on the card")
    render_poses = poses[:NUM_POSES]
    variants = {gn.dominant_axis_for_pose(np.asarray(p.rotation)) for p in render_poses}
    check(len(variants) >= 2, f"poses span {len(variants)} march variant(s)")
    model.render_poses(render_poses, intr)  # warm-up: builds the variants' slices
    torch.cuda.synchronize()
    # relu_trap (K1a) is a device function of composite_fused: it has no
    # launch of its own on this path
    counters = {"composite_fused": gn.composite_positions_fused,
                "resample_rows": wm.resample_rows}
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = model.render_poses(render_poses, intr)
    torch.cuda.synchronize()
    ms_per_pose = (time.perf_counter() - t0) * 1e3 / NUM_POSES
    launches = {name: c.launches for name, c in counters.items()}
    print(f"# serving: {NUM_POSES} poses, {len(variants)} variants, "
          f"{ms_per_pose:.3f} ms/pose (host clock, synchronized), launches {launches}",
          flush=True)
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    launches["relu_trap"] = launches["composite_fused"]

    # one more pass under torch.profiler: where the device time goes, and the
    # device's busy share of the timed pass's wall time
    _, device_ms, summary = device_profile(
        torch, lambda: model.render_poses(render_poses, intr), NUM_POSES, "pose")
    print(f"# serving profile: device {device_ms:.4f} ms/pose summed over kernels, "
          f"busy share {device_ms / ms_per_pose:.3f}, {summary}", flush=True)
    acc = out.extra["accumulated_weight"]
    check(out.colour.shape == (NUM_POSES, IMAGE_SIZE, IMAGE_SIZE, 3), "colour shape")
    for name, t in (("colour", out.colour), ("depth", out.depth), ("acc", acc)):
        check(bool(torch.isfinite(t).all()), f"non-finite {name}")
    check(float(acc.min()) >= 0.0 and float(acc.max()) <= 1.0 + 1e-6, "acc outside [0, 1]")
    check(float(acc.max()) > 0.5, "the scene is not hit")
    ref = gn.render_poses_gnomonic(model.thre3d_repr, render_poses, intr,
                                   model.render_config, plain=True)
    psnr5 = psnr(out.colour, ref.colour)
    col_err = max_abs(out.colour, ref.colour)
    print(f"# serving vs plain: PSNR {psnr5:.2f} dB, colour max-abs {col_err:.3g}, "
          f"depth max-abs {max_abs(out.depth, ref.depth):.3g}", flush=True)
    check(psnr5 >= 60.0, f"serving render vs plain PSNR {psnr5:.2f} dB < 60")

    # ---- phase 6: resample_rows_adjoint (K4) vs plain at [512, 3, 8, 512] -> [512, 8, 512]
    dY3 = torch.randn(NB, 3, CH, N, generator=gen, device=dev)
    dY1 = dY3[:, 0].contiguous()
    # the same positions with each row shuffled: not monotone, so scattered
    perm = torch.argsort(torch.rand(NB, N, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(6)), 1)
    p3s = torch.gather(p3[:, 0], 1, perm)[:, None].contiguous()
    adj_err = plain32_err = 0.0
    for order, p_o, taps in [(o, pos.clamp(*wm._clip_range(o, K)).contiguous(), t)
                             for o in (1, 3) for t in (False, True)] + [(3, p3s, True)]:
        dY = dY3 if taps else dY1
        got = wm.resample_rows_adjoint(dY, p_o, order, K, taps)
        torch.cuda.synchronize()
        # held against the plain version summed in float64; the f32 plain
        # version's own gap to those sums is printed beside the kernel's
        want = wm.resample_rows_adjoint_plain(dY.double(), p_o, order, K, taps).float()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        adj_err = max(adj_err, max_abs(got, want))
        plain32 = wm.resample_rows_adjoint_plain(dY, p_o, order, K, taps)
        plain32_err = max(plain32_err, max_abs(plain32, want))
    adj_ms = time_ms(torch, lambda: wm.resample_rows_adjoint(dY3, p3, 3, K, True), 50)
    adj_scatter_ms = time_ms(torch, lambda: wm.resample_rows_adjoint(dY3, p3s, 3, K, True), 50)
    adj_plain_ms = time_ms(torch, lambda: wm.resample_rows_adjoint_plain(dY3, p3, 3, K, True), 10)
    # the library yardstick of the bilinear pass without taps: grid_sample's
    # input gradient at the same positions (never used by the port)
    g4 = dY1[:, :, None, :]
    lib_adj = torch.ops.aten.grid_sampler_2d_backward(
        g4, X4, gxy[:, None], 0, 0, True, [True, False])[0]
    k4o = wm.resample_rows_adjoint(dY1, p1, 1, K)
    adj_bil_ms = time_ms(torch, lambda: wm.resample_rows_adjoint(dY1, p1, 1, K), 50)
    adj_lib_ms = time_ms(torch, lambda: torch.ops.aten.grid_sampler_2d_backward(
        g4, X4, gxy[:, None], 0, 0, True, [True, False]), 50)
    adj_bil_bound = bound(4 * (NB * CH * N + NB * N + NB * CH * K), NB * N * (8 + CH * 4 * 2))
    print(f"# K4 resample_rows_adjoint: [{NB},3,{CH},{N}] -> [{NB},{CH},{K}] max-abs to the "
          f"float64 sums {adj_err:.3g} (the f32 plain version's {plain32_err:.3g}) "
          f"ms={adj_ms:.4f} plain_ms={adj_plain_ms:.4f}; rows shuffled (scattered) "
          f"ms={adj_scatter_ms:.4f}; order 1 without taps: kernel "
          f"ms={adj_bil_ms:.4f}, grid_sample input gradient ms={adj_lib_ms:.4f} (max-abs "
          f"{max_abs(k4o, lib_adj[:, :, 0]):.3g}: grid_sample renormalizes positions), bound "
          f"{adj_bil_bound[0]:.4f} ms", flush=True)
    legacy_k4 = legacy_rows_call(torch, kernels, wm, adjoint=True)
    k4_paced = dict(
        order3_taps=host_paced(torch, lambda: wm.resample_rows_adjoint(dY3, p3, 3, K, True), 50),
        order1=host_paced(torch, lambda: wm.resample_rows_adjoint(dY1, p1, 1, K), 50),
        order1_before=host_paced(torch, lambda: legacy_k4(dY1, p1, 1, K), 50),
        order1_library=host_paced(torch, lambda: torch.ops.aten.grid_sampler_2d_backward(
            g4, X4, gxy[:, None], 0, 0, True, [True, False]), 50))
    for label, h in k4_paced.items():
        print(f"# K4 host-paced ms, {label}: {paced_str(h)}", flush=True)
    k4_parts = launch_parts(torch, kernels, wm, dY1, p1, 1, K, adjoint=True)
    print(f"# K4 launch path, host us a call: {parts_str(k4_parts)}", flush=True)
    # bytes: the cotangent read, the positions, dX written. ops: the four
    # weights (~40) and per channel 4 weighted taps (mul, add) + 2 tap adds
    results["resample_rows_adjoint"] = dict(
        err=adj_err, ms=adj_ms, plain_ms=adj_plain_ms,
        bound=bound(4 * (NB * 3 * CH * N + NB * N + NB * CH * K),
                    NB * N * (40 + CH * (4 * 2 + 2))),
        extra=dict(order1_ms=adj_bil_ms, order1_library_ms=adj_lib_ms,
                   order1_bound_ms=adj_bil_bound[0], shuffled_rows_ms=adj_scatter_ms,
                   plain_f32_max_abs_vs_float64=plain32_err, host_paced=k4_paced,
                   launch_path_us=k4_parts),
    )
    results["resample_rows"]["extra"] = dict(order1_ms=bil_ms, order1_library_ms=lib_ms,
                                             order1_readings_ms=bil_runs,
                                             order1_library_readings_ms=lib_runs,
                                             host_paced=k2_paced, launch_path_us=k2_parts,
                                             stage_readings_ms=stage_runs)
    del dY3, dY1, got, want, plain32, p3s

    # ---- phase 7: the composite's training branch (K1, ybasis / norm
    # operands) and its replay backward (K3) vs plain, one pose, diffuse on
    gt, trainer = port["gt"], port["trainer"]
    swap0 = wm.warp_swap_for_pose(rot0, axis, flip, IMAGE_SIZE, IMAGE_SIZE, intr.focal)
    tstat = gt.make_gnomonic_train_statics(
        grid, axis, flip, image_height=IMAGE_SIZE, image_width=IMAGE_SIZE,
        white_bkgd=True, apply_diffuse_render_regularization=True, warp_swap=swap0)
    stt = tstat.statics
    Pn_t, Qn_t, PB_t, Pb_t = tstat.frame
    slices_t = gn.repack_position_slices(grid, stt)
    geo_t = gn.gnomonic_geometry(
        torch.as_tensor(rot0, device=dev), torch.as_tensor(org0, device=dev), stt,
        IMAGE_SIZE, IMAGE_SIZE, torch.tensor(intr.focal, dtype=torch.float32, device=dev),
        tstat.supersample, phase=(0.25, -0.125), skip_basis=False)
    occ_t = gn.gnomonic_occupancy_lite(slices_t, geo_t.geom, stt, Pn_t, Qn_t, PB_t, Pb_t,
                                       *gn._qb_blocks(stt, Qn_t))
    args7 = (slices_t, geo_t.ybasis, geo_t.norm, geo_t.geom, stt, Pn_t, Qn_t, PB_t, Pb_t, occ_t)
    state_k = gn.composite_positions_fused(*args7)
    torch.cuda.synchronize()
    state_p, work_t = gn.composite_positions_fused_plain(*args7, return_work=True)
    gap = (state_k - state_p).abs().amax(dim=(1, 2)).tolist()
    check(max(gap[:5] + gap[6:]) <= 1e-4 and gap[5] <= 1e-3,
          f"composite training branch vs plain: per-row max-abs {gap}")
    k1op_ms = time_ms(torch, lambda: gn.composite_positions_fused(*args7), 20)
    k1op_plain_ms = time_ms(torch, lambda: gn.composite_positions_fused_plain(*args7), 2)
    nc_t, used_t = stt.ncoeff, 3 * stt.ncoeff + 1
    NP_t = gn._num_positions(stt)
    n_work_t = int(work_t.sum())
    n_rec_t = composite_records(torch, work_t, geo_t.geom, nvert, nu, nv, stt.pos_per_cell)
    # texels of the (u-block, q-block) tiles with a live cell / a needed
    # position: only those need the basis, norm and cotangent operands
    _, Qb_t = gn._qb_blocks(stt, Qn_t)
    live_texels = int(occ_t[0].any(-1).sum()) * Pb_t * Qb_t
    needed_texels = int(occ_t[1].any(-1).sum()) * Pb_t * Qb_t
    # as K1's bound, plus the basis and norm operands read
    k1op_bytes = (n_rec_t * used_t * 2 + NP_t * 8 * 4 + 2 * PB_t * Qn_t // 128 * NP_t * 4
                  + (nc_t + 1) * live_texels * 4 + 9 * Pn_t * Qn_t * 4)
    k1op_ops = n_work_t * (used_t * 8 + used_t * 4 + 3 * nc_t * 2)
    print(f"# K1 composite, training branch (diffuse, phase-shifted frame {Pn_t}x{Qn_t}): "
          f"max-abs per row {gap}; ms={k1op_ms:.4f} plain_ms={k1op_plain_ms:.4f}; "
          f"{n_work_t} marched pairs, {n_rec_t} vertex records; operand texels "
          f"{live_texels} live / {needed_texels} needed of {Pn_t * Qn_t}", flush=True)

    gstate = torch.randn(state_p.shape, generator=gen, device=dev)
    S_total = (gstate[1:] * state_p[1:]).sum(0)
    gaux = torch.cat([gstate, S_total[None], state_p[0:1]])
    args3 = args7[:4] + (gaux, occ_t) + args7[4:9]
    got3 = gt.composite_backward_fused(*args3)
    torch.cuda.synchronize()
    want3 = gt.composite_backward_fused_plain(*args3)
    k3_err = max_abs(got3.float(), want3.float())
    k3_scale = float(want3.float().abs().max())
    k3_cos = cosine(got3.float(), want3.float())
    check(k3_scale > 0.0 and k3_err <= 1e-2 * k3_scale and k3_cos > 0.99999,
          f"composite backward vs plain: max-abs {k3_err} (scale {k3_scale}), cosine {k3_cos}")
    check(not bool(got3[:, :, used_t:].any()), "composite backward wrote pad channels")
    k3_ms = time_ms(torch, lambda: gt.composite_backward_fused(*args3), 10)
    k3_plain_ms = time_ms(torch, lambda: gt.composite_backward_fused_plain(*args3), 1)
    k3_parts, k3_share = kernel_times(torch, lambda: gt.composite_backward_fused(*args3), 10,
                                      ("backward_march_kernel", "ufold_kernel"), k3_ms)
    # the march's v-fold output (bf16 dt1 rows, f32 edge records), beside the
    # per-texel bf16 cotangent buffer (dvals) that the design before it wrote
    # and read back
    _, _, n_dt1, n_edge = gt.fold_records(occ_t[1], stt, Pb_t, gn._qb_blocks(stt, Qn_t)[1])
    records_bytes = n_dt1 * 2 + n_edge * 4
    _, n_slots = gt.dvals_slots(occ_t[1])
    dvals_bytes = n_slots * used_t * Pb_t * 128 * 2
    dsl_bytes = got3.numel() * 2
    live_rows = int(occ_t[2].sum()) * Pb_t  # (position, texel row) pairs the u-fold reads
    # bytes: the vertex records the replayed pairs read, geometry, flags, the
    # basis, norm and cotangent operands of the tiles with a needed position,
    # the dslices written. ops: the
    # replay (as K1), ~120 per pair for the cell's backward, the v-fold (2
    # taps x mul+add per channel) per pair and the u-fold per live row
    k3_bytes = (n_rec_t * used_t * 2 + NP_t * 8 * 4 + 2 * PB_t * Qn_t // 128 * NP_t * 4
                + (nc_t + 1 + gaux.shape[0]) * needed_texels * 4 + dsl_bytes)
    k3_ops = (n_work_t * (used_t * 8 + used_t * 4 + 3 * nc_t * 2 + 120 + used_t * 4)
              + live_rows * used_t * nv * 4)
    print(f"# K3 composite_backward_fused: max-abs {k3_err:.3g} of {k3_scale:.3g}, cosine "
          f"{k3_cos:.9f}; ms={k3_ms:.4f} plain_ms={k3_plain_ms:.4f}; device clock "
          f"(torch.profiler, 10 calls): march {k3_parts['backward_march_kernel']:.4f} ms, "
          f"u-fold {k3_parts['ufold_kernel']:.4f} ms (the trace holds {k3_share:.3f} of the "
          f"call); v-fold output {records_bytes} bytes "
          f"(dt1 rows {n_dt1 * 2}, edge records {n_edge * 4}; a per-texel cotangent "
          f"buffer: {n_slots} slots = {dvals_bytes} bytes), "
          f"dslices {dsl_bytes} bytes", flush=True)
    results["composite_fused"]["extra"] = dict(
        training_branch_ms=k1op_ms, training_branch_plain_ms=k1op_plain_ms,
        training_branch_bound_ms=bound(k1op_bytes, k1op_ops)[0],
        training_branch_max_abs_err=max(gap))
    results["composite_backward_fused"] = dict(
        err=k3_err, ms=k3_ms, plain_ms=k3_plain_ms, bound=bound(k3_bytes, k3_ops),
        extra=dict(cosine_vs_plain=k3_cos, march_ms=k3_parts["backward_march_kernel"],
                   ufold_ms=k3_parts["ufold_kernel"], profiled_share=k3_share,
                   records_bytes=records_bytes,
                   dvals_bytes=dvals_bytes, dslices_bytes=dsl_bytes))
    del args3, args7, got3, want3, state_k, state_p, work_t, gstate, gaux, slices_t, geo_t, occ_t

    # ---- phase 8: training end to end. Targets: 8 views of one march
    # variant rendered by the serving path; the grid starts at uniform(-1, 1)
    # (the trainer's init); 10 gnomonic_train_step_multi steps of k = 4 views
    # with Adam at lr 0.03 and phase jitter, the first step also through the
    # plain versions
    rng = np.random.default_rng(0)
    buckets = {}
    for _ in range(96):
        pose = camera.pose_spherical(rng.uniform(0, 360), rng.uniform(-90, 0), 4.0)
        R = np.asarray(pose.rotation, np.float32).reshape(3, 3)
        ax, fl = gn.dominant_axis_for_pose(R)
        key = (ax, fl, wm.warp_swap_for_pose(R, ax, fl, IMAGE_SIZE, IMAGE_SIZE, intr.focal))
        buckets.setdefault(key, []).append(pose)
    (ax, fl, sw), views = max(buckets.items(), key=lambda kv: len(kv[1]))
    check(len(views) >= 8, f"largest march variant has {len(views)} views")
    views = views[:8]
    targets = model.render_poses(views, intr).colour.contiguous()  # [8, H, W, 3]
    rots = np.stack([np.asarray(v.rotation, np.float32).reshape(3, 3) for v in views])
    orgs = np.stack([np.asarray(v.translation, np.float32).reshape(3) for v in views])
    k_views, n_steps = trainer._GN_MIN_POSES_PER_STEP, 10
    picks = [rng.choice(8, k_views, replace=False) for _ in range(n_steps)]
    phase_gen = torch.Generator(device=dev).manual_seed(11)
    phases = [[gt.draw_phase(phase_gen) for _ in range(k_views)] for _ in range(n_steps)]
    del model, out, ref

    def init_grid():
        g = torch.Generator(device=dev).manual_seed(7)
        shape = (GRID_SIZE,) * 3
        return port["VoxelGrid"](
            torch.rand(shape + (1,), generator=g, device=dev) * 2.0 - 1.0,
            torch.rand(shape + (27,), generator=g, device=dev) * 2.0 - 1.0,
            voxel_size=grid_config["voxel_size"], grid_location=grid_config["grid_location"],
            density_preactivation="identity", density_postactivation="relu")

    def train_step(g, opt, sched, i, plain=False):
        idx = picks[i]
        return gt.gnomonic_train_step_multi(
            tstat8, opt, g, targets[idx], rots[idx], orgs[idx], intr.focal,
            phases=phases[i], scheduler=sched, plain=plain)

    g_plain = init_grid()
    tstat8 = gt.make_gnomonic_train_statics(
        g_plain, ax, fl, image_height=IMAGE_SIZE, image_width=IMAGE_SIZE, white_bkgd=True,
        apply_diffuse_render_regularization=True, warp_swap=sw)
    opt_p, sched_p = trainer.make_gnomonic_optimizer(g_plain, 0.03)
    t0 = time.perf_counter()
    m_plain = train_step(g_plain, opt_p, sched_p, 0, plain=True)
    torch.cuda.synchronize()
    plain_step_ms = (time.perf_counter() - t0) * 1e3
    ref_grads = (g_plain.densities.grad.clone(), g_plain.features.grad.clone())
    del g_plain, opt_p, sched_p

    g_k = init_grid()
    opt, sched = trainer.make_gnomonic_optimizer(g_k, 0.03)
    # the replay backward's cotangent buffer on this (dense) starting grid
    with torch.no_grad():
        st8 = tstat8.statics
        sl8 = gn.repack_position_slices(g_k, st8)
        geo8 = gn.gnomonic_geometry(
            torch.as_tensor(rots[picks[0][0]], device=dev),
            torch.as_tensor(orgs[picks[0][0]], device=dev), st8, IMAGE_SIZE, IMAGE_SIZE,
            torch.tensor(intr.focal, dtype=torch.float32, device=dev), tstat8.supersample)
        occ8 = gn.gnomonic_occupancy_lite(sl8, geo8.geom, st8, *tstat8.frame,
                                          *gn._qb_blocks(st8, tstat8.frame[1]))
        _, slots8 = gt.dvals_slots(occ8[1])
        _, _, dt1_8, edge8 = gt.fold_records(occ8[1], st8, tstat8.frame[3],
                                             gn._qb_blocks(st8, tstat8.frame[1])[1])
    print(f"# training grid: {slots8} of {occ8[1].numel()} (u-block, q-block, position) "
          f"slots needed; K3's v-fold output {dt1_8 * 2 + edge8 * 4} bytes (dt1 rows "
          f"{dt1_8 * 2}, edge records {edge8 * 4}; a per-texel cotangent buffer: "
          f"{slots8 * (3 * st8.ncoeff + 1) * tstat8.frame[3] * 128 * 2} bytes)", flush=True)
    del sl8, geo8, occ8
    train_counters = {"composite_fused": gn.composite_positions_fused,
                      "composite_backward_fused": gt.composite_backward_fused,
                      "resample_rows": wm.resample_rows,
                      "resample_rows_adjoint": wm.resample_rows_adjoint}
    torch.cuda.reset_peak_memory_stats()
    for c in train_counters.values():
        c.launches = 0
    losses, step_ms, grad_cos = [], [], None
    for i in range(n_steps):
        t0 = time.perf_counter()
        m = train_step(g_k, opt, sched, i)
        losses.append(float(m["total_loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        grads = (g_k.densities.grad, g_k.features.grad)
        check(all(bool(torch.isfinite(x).all()) for x in grads) and np.isfinite(losses[-1]),
              f"step {i}: non-finite loss or gradient")
        if i == 0:
            grad_cos = [cosine(a, b) for a, b in zip(grads, ref_grads)]
            check(min(grad_cos) > 0.99999 and abs(losses[0] - float(m_plain["total_loss"]))
                  <= 1e-5 * losses[0],
                  f"first step kernels vs plain: gradient cosines {grad_cos}, loss "
                  f"{losses[0]} vs {float(m_plain['total_loss'])}")
    train_launches = {name: c.launches for name, c in train_counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(v > 0 for v in train_launches.values()), f"a kernel was not launched: {train_launches}")
    per_step = {name: v / n_steps for name, v in train_launches.items()}
    check(per_step == {"composite_fused": k_views, "composite_backward_fused": k_views,
                       "resample_rows": 2 * k_views, "resample_rows_adjoint": 2 * k_views},
          f"launches per step {per_step}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    ms_per_step = float(np.mean(step_ms[1:]))
    print(f"# training: 128^3 grid from uniform(-1, 1), {IMAGE_SIZE}x{IMAGE_SIZE}, k={k_views} "
          f"views of variant {(ax, fl, sw)}, P={tstat8.statics.pos_per_cell}, frame "
          f"{tstat8.frame}, Adam lr 0.03, jitter on; losses {[round(x, 5) for x in losses]}; "
          f"first-step gradient cosine vs plain (densities, features) {grad_cos}; "
          f"plain step {plain_step_ms:.1f} ms; {ms_per_step:.3f} ms/step over steps 2-{n_steps} "
          f"(host clock, synchronized; step 1 {step_ms[0]:.1f} ms); launches per step "
          f"{per_step}; peak memory {peak_gb:.2f} GB", flush=True)
    def two_steps():
        for i in range(2):
            train_step(g_k, opt, sched, i)

    prof_ms, train_dev_ms, summary = device_profile(torch, two_steps, 2, "step", top_n=8)
    print(f"# training profile: device {train_dev_ms:.4f} ms/step summed over kernels, "
          f"{prof_ms:.3f} ms/step under the profiler, busy share {train_dev_ms / prof_ms:.3f} "
          f"(of the profiled wall time), {summary}", flush=True)

    # ---- phase 9: the stripe composite (K5) vs plain: the serving
    # configuration with qb = 0 on the blob pose (exit_eps 1e-4, and 0), the
    # training operands (diffuse, phase-shifted frame, exit 0), and the CLI's
    # first stage (64^3, P = 4, 200 x 200), where K1 is held too
    rot0_t, org0_t = torch.as_tensor(rot0, device=dev), torch.as_tensor(org0, device=dev)
    a9, t1_exact = k5_operands(torch, port, scene, dev, "serving")
    check(t1_exact == 0, f"u-resample t1 differs from the f32 reference in {t1_exact} elements")
    k5_err, k5_work = 0.0, None
    for eps in (0.0, 1e-4):
        a = a9[:7] + (a9[7]._replace(exit_eps=eps),) + a9[8:]
        gap, work = stripe_compare(torch, gn, a, f"serving 128^3 exit_eps={eps}")
        k5_err = max(k5_err, max(gap))
        if eps > 0.0:
            k5_work = work
    k5_ms = time_ms(torch, lambda: gn.composite_positions(*a9), 20)
    k5_plain_ms = time_ms(torch, lambda: gn.composite_positions_plain(
        *a9, exit_tile=gn.CUDA_EXIT_TILE), 2)
    k5_bytes, k5_ops = stripe_counts(torch, a9, k5_work)
    TP, TQ = gn.CUDA_EXIT_TILE
    print(f"# K5 composite_stripe (serving, 128^3): ms={k5_ms:.4f} plain_ms={k5_plain_ms:.4f}; "
          f"CTA {TP} x {TQ} texels (one exit tile), {32 * a9[0].shape[0]} bytes of shared "
          f"memory (the position tables), t1 and taps read from device memory; "
          f"{int(k5_work.sum())} marched pairs; bound counts {k5_bytes} bytes, {k5_ops} "
          f"operations; t1 {tuple(a9[0].shape)} bit-equal to the f32 reference", flush=True)
    del a9, k5_work

    # the training operands at 128^3 (qb = 0 train statics, diffuse on)
    args9t, _ = k5_operands(torch, port, scene, dev, "training")
    gap, work9t = stripe_compare(torch, gn, args9t, "training operands 128^3")
    k5_err = max(k5_err, max(gap))
    k5t_ms = time_ms(torch, lambda: gn.composite_positions(*args9t), 10)

    # ---- phase 10: the stripe replay backward (K7) vs plain, same operands
    k7_err, k7_cos, k7_ms, k7_plain_ms, k7_bound, k7_extra = stripe_backward_compare(
        torch, gn, gt, args9t, work9t, gen, "training 128^3")
    del args9t, work9t

    # the CLI's first stage: 64^3 blob, P = 4, 200 x 200 (focal x 0.5)
    d64, f64, cfg64 = blob_scene(CLI_GRID // 2)
    grid64 = port["voxel_grid_from_numpy"](d64, f64, cfg64, device=dev)
    S1 = IMAGE_SIZE // 2
    focal64 = torch.tensor(intr.focal / 2, dtype=torch.float32, device=dev)
    for fused in (False, True):
        ts64 = gt.make_gnomonic_train_statics(
            grid64, axis, flip, image_height=S1, image_width=S1, white_bkgd=True,
            apply_diffuse_render_regularization=True, qb=128 if fused else 0)
        if not fused:
            a64, _ = stripe_case(torch, gn, grid64, ts64.statics, rot0_t, org0_t, S1, focal64,
                                 ts64.supersample, phase=(0.25, -0.125))
            gap, w64 = stripe_compare(torch, gn, a64, "training operands 64^3")
            k5_err = max(k5_err, max(gap))
            e7 = stripe_backward_compare(torch, gn, gt, a64, w64, gen, "training 64^3")
            k7_err, k7_cos = max(k7_err, e7[0]), min(k7_cos, e7[1])
            k7_extra["stage1_64"] = dict(ms=e7[2], **e7[5])
            del a64, w64
            continue
        st64 = ts64.statics
        Pn64, Qn64, PB64, Pb64 = ts64.frame
        sl64 = gn.repack_position_slices(grid64, st64)
        geo64 = gn.gnomonic_geometry(rot0_t, org0_t, st64, S1, S1, focal64, ts64.supersample,
                                     phase=(0.25, -0.125), skip_basis=False)
        occ64 = gn.gnomonic_occupancy_lite(sl64, geo64.geom, st64, Pn64, Qn64, PB64, Pb64,
                                           *gn._qb_blocks(st64, Qn64))
        a1 = (sl64, geo64.ybasis, geo64.norm, geo64.geom, st64, Pn64, Qn64, PB64, Pb64, occ64)
        got1 = gn.composite_positions_fused(*a1)
        torch.cuda.synchronize()
        want1 = gn.composite_positions_fused_plain(*a1)
        gap = (got1 - want1).abs().amax(dim=(1, 2)).tolist()
        check(max(gap[:5] + gap[6:]) <= 1e-4 and gap[5] <= 1e-3,
              f"K1 at 64^3 vs plain: per-row max-abs {gap}")
        gs = torch.randn(want1.shape, generator=gen, device=dev)
        gaux64 = torch.cat([gs, (gs[1:] * want1[1:]).sum(0)[None], want1[0:1]])
        a3 = a1[:4] + (gaux64, occ64) + a1[4:9]
        got3 = gt.composite_backward_fused(*a3)
        torch.cuda.synchronize()
        want3 = gt.composite_backward_fused_plain(*a3)
        e3, sc3 = max_abs(got3.float(), want3.float()), float(want3.float().abs().max())
        c3 = cosine(got3.float(), want3.float())
        check(sc3 > 0.0 and e3 <= 1e-2 * sc3 and c3 > 0.99999,
              f"K3 at 64^3 vs plain: max-abs {e3} (scale {sc3}), cosine {c3}")
        print(f"# K1 / K3 at the CLI's first stage ({CLI_GRID // 2}^3, P={st64.pos_per_cell}, "
              f"frame {Pn64}x{Qn64}): K1 "
              f"max-abs per row {gap}; K3 max-abs {e3:.3g} of {sc3:.3g}, cosine {c3:.9f}",
              flush=True)
        results["composite_fused"]["extra"]["stage1_64_max_abs_err"] = max(gap)
        results["composite_backward_fused"]["extra"]["stage1_64_max_abs_err"] = e3
        # K2 / K4 at this stage's warp: both passes' (X, positions) of the warp
        # of K1's state (frame 256 x 256 -> 200 x 200, order 3 with taps),
        # captured from the plain warp, through the kernels vs the plain
        # versions with the bounds of phases 3 and 6
        warp_ops = resample_operands(wm, lambda: gn._warp_to_camera(
            want1, geo64.xr, geo64.yr, rot0_t, st64, S1, S1, focal64, ts64.supersample, True,
            warp_order=ts64.warp_order, warp_swap=ts64.warp_swap, plain=True))
        check(len(warp_ops) == 2, f"the warp made {len(warp_ops)} resample calls, not 2")
        e2 = e4 = 0.0
        for X, p, order, taps in warp_ops:
            got = wm.resample_rows(X, p, order, taps)
            torch.cuda.synchronize()
            want = wm.resample_rows_plain(X, p, order, taps)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
            dY = torch.randn(got.shape, generator=gen, device=dev)
            got_a = wm.resample_rows_adjoint(dY, p, order, X.shape[2], taps)
            torch.cuda.synchronize()
            want_a = wm.resample_rows_adjoint_plain(dY.double(), p, order, X.shape[2],
                                                    taps).float()
            torch.testing.assert_close(got_a, want_a, rtol=1e-5, atol=1e-5)
            e2, e4 = max(e2, max_abs(got, want)), max(e4, max_abs(got_a, want_a))
        # K4 gathers the rows whose positions never decrease or never increase
        monotone = [int(((d >= 0).all(1) | (d <= 0).all(1)).sum())
                    for d in (torch.diff(p[:, 0], dim=1) for _, p, _, _ in warp_ops)]
        print(f"# K2 / K4 at the CLI's first stage: passes "
              f"{[(tuple(X.shape), tuple(p.shape), order, taps) for X, p, order, taps in warp_ops]}"
              f"; K2 max-abs {e2:.3g}, K4 max-abs {e4:.3g}; monotone rows a pass {monotone}",
              flush=True)
        for name, e in (("resample_rows", e2), ("resample_rows_adjoint", e4)):
            results[name]["err"] = max(results[name]["err"], e)
            results[name]["extra"]["stage1_64_max_abs_err"] = e
        del a1, a3, got1, want1, got3, want3, sl64, geo64, occ64, gs, gaux64, warp_ops
        del got, want, dY, got_a, want_a
    del grid64
    results["composite_stripe"] = dict(
        err=k5_err, ms=k5_ms, plain_ms=k5_plain_ms, bound=bound(k5_bytes, k5_ops),
        extra=dict(training_operands_ms=k5t_ms))
    results["composite_stripe_backward"] = dict(
        err=k7_err, ms=k7_ms, plain_ms=k7_plain_ms, bound=k7_bound,
        extra=dict(cosine_vs_plain=k7_cos, **k7_extra))

    # ---- phase 11: the serving path with gnomonic_qb = 0 on phase 5's saved model
    model, _ = vm.create_volumetric_model_from_saved_model(workdir / "blob128")
    model.render_poses(render_poses, intr, gnomonic_qb=0)  # warm-up
    torch.cuda.synchronize()
    counters11 = {"composite_stripe": gn.composite_positions,
                  "composite_fused": gn.composite_positions_fused,
                  "resample_rows": wm.resample_rows}
    for c in counters11.values():
        c.launches = 0
    t0 = time.perf_counter()
    out0 = model.render_poses(render_poses, intr, gnomonic_qb=0)
    torch.cuda.synchronize()
    ms_pose_v2 = (time.perf_counter() - t0) * 1e3 / NUM_POSES
    launches11 = {name: c.launches for name, c in counters11.items()}
    check(launches11["composite_stripe"] == NUM_POSES and launches11["composite_fused"] == 0
          and launches11["resample_rows"] > 0, f"qb=0 serving launches {launches11}")
    for name, t in (("colour", out0.colour), ("depth", out0.depth)):
        check(bool(torch.isfinite(t).all()), f"qb=0 render: non-finite {name}")
    ref0 = gn.render_poses_gnomonic(model.thre3d_repr, render_poses, intr,
                                    model.render_config.replace(
                                        gnomonic_qb=0, perturb_sampled_points=False),
                                    plain=True)
    fused_out = model.render_poses(render_poses, intr)
    psnr_plain = psnr(out0.colour, ref0.colour)
    psnr_fused = psnr(out0.colour, fused_out.colour)
    print(f"# serving qb=0: {NUM_POSES} poses, {ms_pose_v2:.3f} ms/pose (host clock, "
          f"synchronized), launches {launches11}; PSNR vs plain {psnr_plain:.2f} dB, vs the "
          f"fused render {psnr_fused:.2f} dB (colour max-abs "
          f"{max_abs(out0.colour, fused_out.colour):.3g})", flush=True)
    check(psnr_plain >= 60.0, f"qb=0 render vs plain PSNR {psnr_plain:.2f} dB < 60")
    del out0, ref0, fused_out

    # ---- phase 12: the training CLI end to end. The dataset: 16 train and 4
    # test views of the blob model at 800 x 800 (serving path), as PNGs with
    # the JAX package's camera JSON; two in-process runs of main(), the
    # default qb and --gnomonic_qb 0
    data = workdir / "blob_views"
    make_posed_dataset(torch, camera, port["png"], model, data, CLI_VIEWS, CLI_SIZE)
    del model
    cli = port["cli"]
    counters12 = {"composite_fused": gn.composite_positions_fused,
                  "composite_backward_fused": gt.composite_backward_fused,
                  "composite_stripe": gn.composite_positions,
                  "composite_stripe_backward": gt.composite_backward,
                  "resample_rows": wm.resample_rows,
                  "resample_rows_adjoint": wm.resample_rows_adjoint}
    original_step = gt.gnomonic_train_step_multi
    cli_runs = {}
    for qb in (128, 0):
        steps, firsts = [], {}

        timed_step = recording_step(torch, gt, original_step, counters12, steps, firsts)

        out_dir = workdir / f"cli_qb{qb}"
        argv = ["-d", str(data), "-o", str(out_dir), "--grid_dims", *[str(CLI_GRID)] * 3,
                "--num_stages", "2", "--num_iterations_per_stage", "4",
                "--save_frequency", "2", "--test_frequency", "4", "--feedback_frequency", "4",
                "--summary_frequency", "1"] + (["--gnomonic_qb", "0"] if qb == 0 else [])
        gt.gnomonic_train_step_multi = timed_step
        torch.cuda.reset_peak_memory_stats()
        for c in counters12.values():
            c.launches = 0
        t0 = time.perf_counter()
        try:
            trained = cli.main(argv)
        finally:
            gt.gnomonic_train_step_multi = original_step
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: c.launches for name, c in counters12.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        cli_runs[qb] = check_cli_run(torch, trained, out_dir, steps, counts, qb)
        cli_runs[qb].update(launches=counts, peak_gb=peak, wall_s=wall)
        del trained
        print(f"# CLI qb={qb}: {wall:.1f} s in main(); ms/step per stage "
              f"{cli_runs[qb]['ms_per_step']}; losses per stage {cli_runs[qb]['losses']}; "
              f"held-out PSNR per stage {cli_runs[qb]['test_psnr']}; launches {counts}; "
              f"peak memory {peak:.2f} GB", flush=True)
        # after main(): the plain replays stay out of its time and peak memory
        stages = uncounted(counters12, lambda: check_stage_first_steps(torch, port, firsts, qb))
        print(f"# CLI qb={qb}: each stage's first step vs plain and its views' loss after "
              f"the stage's last step: {stages}", flush=True)
        del firsts

    # ---- phase 13: the q-split v2 kernels at qb = 128 (Qn = 512: four
    # q-blocks): the composite (K6) on the blob pose's serving statics (exit
    # 1e-4 and 0) and on training operands, its replay backward (K8), then
    # one gnomonic_train_step_multi with fused=False, qb = 128 (phase 8's
    # views, phases and start grid) against the plain versions' step
    a13, t1_exact = k5_operands(torch, port, scene, dev, "qsplit")
    check(t1_exact == 0 and a13[12][0].dim() == 3,
          f"q-split operands: t1 mismatches {t1_exact}, flags {tuple(a13[12][0].shape)}")
    k6_err, k6_work = 0.0, None
    for eps in (0.0, 1e-4):
        a = a13[:7] + (a13[7]._replace(exit_eps=eps),) + a13[8:]
        gap, work = stripe_compare(torch, gn, a, f"q-split serving 128^3 exit_eps={eps}")
        k6_err = max(k6_err, max(gap))
        if eps > 0.0:
            k6_work = work
    k6_ms = time_ms(torch, lambda: gn.composite_positions(*a13), 20)
    k6_plain_ms = time_ms(torch, lambda: gn.composite_positions_qb_plain(
        *a13, exit_tile=gn.CUDA_EXIT_TILE), 2)
    k6_bytes, k6_ops = stripe_counts(torch, a13, k6_work)
    print(f"# K6 composite_stripe_qb (serving, 128^3, flags {tuple(a13[12][0].shape)}): "
          f"ms={k6_ms:.4f} plain_ms={k6_plain_ms:.4f}; {int(k6_work.sum())} marched pairs; "
          f"bound counts {k6_bytes} bytes, {k6_ops} operations", flush=True)
    del a13, k6_work
    args13t, _ = k5_operands(torch, port, scene, dev, "qsplit_training")
    gap, work13t = stripe_compare(torch, gn, args13t, "q-split training operands 128^3")
    k6_err = max(k6_err, max(gap))
    k6t_ms = time_ms(torch, lambda: gn.composite_positions(*args13t), 10)
    k8_err, k8_cos, k8_ms, k8_plain_ms, k8_bound, k8_extra = stripe_backward_compare(
        torch, gn, gt, args13t, work13t, gen, "q-split training 128^3")
    del args13t, work13t
    # K7 and K8 (phases 10 and 13's operands), the band kernel and the three
    # launches, split by launch under torch.profiler in a process of its
    # own: the band path's trace names no march and no fold kernel
    split = stripe_split_process()
    for key, extra in (("k7", results["composite_stripe_backward"]["extra"]), ("k8", k8_extra)):
        parts = split[key]["call"]["parts_ms"]
        check(parts["stripe_band_kernel"] > 0.0 and parts["stripe_march_kernel"] == 0.0
              and parts["stripe_fold_kernel"] == 0.0,
              f"{key.upper()} did not run as the column taps and the band kernel: {parts}")
        extra.update(column_taps_ms=parts["column_taps_kernel"],
                     band_ms=parts["stripe_band_kernel"], split_process=split[key])

    tstat13 = gt.make_gnomonic_train_statics(
        grid, ax, fl, image_height=IMAGE_SIZE, image_width=IMAGE_SIZE, white_bkgd=True,
        apply_diffuse_render_regularization=True, warp_swap=sw, qb=128, fused=False)
    idx0 = picks[0]
    step_args = (targets[idx0], rots[idx0], orgs[idx0], intr.focal)
    g_plain = init_grid()
    opt_p, sched_p = trainer.make_gnomonic_optimizer(g_plain, 0.03)
    m_plain13 = gt.gnomonic_train_step_multi(tstat13, opt_p, g_plain, *step_args,
                                             phases=phases[0], scheduler=sched_p, plain=True)
    ref13 = (g_plain.densities.grad.clone(), g_plain.features.grad.clone())
    del g_plain, opt_p, sched_p
    g_q = init_grid()
    opt_q, sched_q = trainer.make_gnomonic_optimizer(g_q, 0.03)
    counters13 = {"composite_stripe_qb": gn.composite_positions_qb,
                  "composite_stripe_backward_qb": gt.composite_backward_qb,
                  "composite_stripe": gn.composite_positions,
                  "composite_stripe_backward": gt.composite_backward,
                  "composite_fused": gn.composite_positions_fused,
                  "composite_backward_fused": gt.composite_backward_fused,
                  "resample_rows": wm.resample_rows,
                  "resample_rows_adjoint": wm.resample_rows_adjoint}
    for c in counters13.values():
        c.launches = 0
    t0 = time.perf_counter()
    m_q = gt.gnomonic_train_step_multi(tstat13, opt_q, g_q, *step_args, phases=phases[0],
                                       scheduler=sched_q)
    torch.cuda.synchronize()
    qstep_ms = (time.perf_counter() - t0) * 1e3
    launches13 = {name: c.launches for name, c in counters13.items()}
    check(launches13 == dict(composite_stripe_qb=k_views, composite_stripe_backward_qb=k_views,
                             composite_stripe=0, composite_stripe_backward=0,
                             composite_fused=0, composite_backward_fused=0,
                             resample_rows=2 * k_views, resample_rows_adjoint=2 * k_views),
          f"fused=False, qb=128 step launches {launches13}")
    loss13, loss13_plain = float(m_q["total_loss"]), float(m_plain13["total_loss"])
    cos13 = [cosine(a, b) for a, b in zip((g_q.densities.grad, g_q.features.grad), ref13)]
    check(abs(loss13 - loss13_plain) <= 1e-5 * loss13_plain and min(cos13) > 0.99999,
          f"q-split step vs plain: loss {loss13} vs {loss13_plain}, gradient cosines {cos13}")
    print(f"# q-split train step (fused=False, qb=128, k={k_views}, frame {tstat13.frame}): "
          f"loss {loss13:.6f} (plain {loss13_plain:.6f}), gradient cosines {cos13}; "
          f"{qstep_ms:.1f} ms (host clock, synchronized, first step); launches {launches13}",
          flush=True)
    del g_q, opt_q, sched_q, ref13, m_q, m_plain13

    # ---- phase 14: the slab march (K9) and its replay backward (K10) on one
    # bricked pose of the blob model: the serving render config's variant
    # (400 x 400, tile 16, K = 2, exit 1e-4, the serving occupancy
    # threshold), and an opaque copy where the early exit must end tiles
    br, sm, bt = port["br"], port["sm"], port["bt"]
    bst = br.variant_statics(grid, axis, flip, config)
    check(bst.tile_px == 16 and bst.axis_supersample == 2 and bst.exit_eps == 1e-4
          and bst.occ_sigma_thresh > 0.0, f"bricked statics {bst}")

    def k9_case(vgrid, label):
        ops, kw9, ovf = k10_operands(torch, port, scene, dev, vgrid)
        tab, cnt, rf, _ = ops
        got = sm.slab_march_render(*ops, **kw9)
        torch.cuda.synchronize()
        want, work = sm.slab_march_render_plain(*ops, **kw9, return_work=True)
        _, work0 = sm.slab_march_render_plain(*ops, **{**kw9, "exit_eps": 0.0},
                                              return_work=True)
        err = max_abs(got, want)
        check(bool(torch.isfinite(got).all()) and err <= 1e-6,
              f"K9 vs plain ({label}): max-abs {err}")
        check(float(want[..., 3].max()) > 0.5, f"K9 ({label}): the scene is not hit")
        print(f"# K9 slab_march {label}: max-abs {err:.3g}; {rf.shape[0]} tiles, "
              f"{int(cnt.sum())} entries (a tile: max / mean / empty tiles "
              f"{table_stats(cnt)}); live samples marched {work[0]} (exit_eps 0: "
              f"{work0[0]}); overflow {bool(ovf)}", flush=True)
        return ops, kw9, want, work, work0, err

    opaque = port["voxel_grid_from_numpy"](np.where(d > 0, d * 100.0, d), f, grid_config,
                                           device=dev)
    _, _, _, o_work, o_work0, k9_err_opaque = k9_case(opaque, "opaque")
    check(o_work[0] < o_work0[0], "the slab march's early exit ended no tile on the opaque scene")
    del opaque
    ops9, kw9, out9, work9, _, k9_err = k9_case(grid, "blob")
    k9_ms = time_ms(torch, lambda: sm.slab_march_render(*ops9, **kw9), 20)
    k9_plain_ms = time_ms(torch, lambda: sm.slab_march_render_plain(*ops9, **kw9), 1)
    k9_bytes, k9_ops = slab_counts(ops9, work9, bst.ncoeff, out9.numel())
    k9_shape = march_shape(sm, "slab_march", ops9[2].shape[1], kw9)
    k9_entries = table_stats(ops9[1])
    # K9 on the bricked trainer's batch of K10_BATCH_TILES tiles of the pose
    (ops9b,) = trainer_batch(torch, ops9)
    got9b = sm.slab_march_render(*ops9b, **kw9)
    torch.cuda.synchronize()
    want9b, work9b = sm.slab_march_render_plain(*ops9b, **kw9, return_work=True)
    k9_err_batch = max_abs(got9b, want9b)
    check(bool(torch.isfinite(got9b).all()) and k9_err_batch <= 1e-6,
          f"K9 on the {K10_BATCH_TILES}-tile batch vs plain: max-abs {k9_err_batch}")
    k9_batch_ms = time_ms(torch, lambda: sm.slab_march_render(*ops9b, **kw9), 20)
    k9_batch_bound = bound(*slab_counts(ops9b, work9b, bst.ncoeff, want9b.numel()))
    print(f"# K9 slab_march on the trainer's batch ({K10_BATCH_TILES} tiles): max-abs "
          f"{k9_err_batch:.3g}; entries a tile (max / mean / empty tiles) "
          f"{table_stats(ops9b[1])}; live samples marched {work9b[0]}; ms={k9_batch_ms:.4f}, "
          f"bound {k9_batch_bound[0]:.4f} ms ({k9_batch_bound[1]}); launch {k9_shape}",
          flush=True)
    del ops9b, got9b, want9b
    gout9 = k10_cotangent(torch, out9)
    got10 = sm.slab_march_grad(*ops9, out9, gout9, **kw9)
    torch.cuda.synchronize()
    want10 = sm.slab_march_grad_plain(*ops9, out9, gout9, **kw9)
    scale10 = float(want10.abs().max())
    k10_err = max_abs(got10, want10)
    k10_cos = cosine(got10, want10)
    k10_cast = max_abs(got10.to(torch.bfloat16).float(), want10.to(torch.bfloat16).float())
    check(scale10 > 0.0 and k10_err <= 1e-4 * scale10 and k10_cos > 0.99999
          and k10_cast <= scale10 * 2.0 ** -8,
          f"K10 vs plain: max-abs {k10_err} (scale {scale10}), cosine {k10_cos}, "
          f"after the bf16 cast {k10_cast}")
    k10_pose = grad_readings(torch, sm.slab_march_grad, "slab_march_backward", ops9, out9,
                             gout9, kw9, "pose")
    k10_ms = k10_pose["ms"]
    check(k10_pose["steps_summed"] > 0 and
          k10_pose["global_atomics"] < k10_pose["tap_products"],
          f"K10 summed no step in shared memory: {k10_pose}")
    # the bricked trainer's batch of K10_BATCH_TILES tiles of the pose
    ops10b, out10b, gout10b = trainer_batch(torch, ops9, out9, gout9)
    got10b = sm.slab_march_grad(*ops10b, out10b, gout10b, **kw9)
    torch.cuda.synchronize()
    want10b = sm.slab_march_grad_plain(*ops10b, out10b, gout10b, **kw9)
    scale10b = float(want10b.abs().max())
    e10b, c10b = max_abs(got10b, want10b), cosine(got10b, want10b)
    check(scale10b > 0.0 and e10b <= 1e-4 * scale10b and c10b > 0.99999,
          f"K10 on the {K10_BATCH_TILES}-tile batch vs plain: max-abs {e10b} (scale "
          f"{scale10b}), cosine {c10b}")
    del got10b, want10b
    k10_batch = grad_readings(torch, sm.slab_march_grad, "slab_march_backward", ops10b,
                              out10b, gout10b, kw9,
                             f"the trainer's batch (max-abs {e10b:.3g} of {scale10b:.3g})")
    del ops10b, out10b, gout10b
    k10_plain_ms = time_ms(torch, lambda: sm.slab_march_grad_plain(
        *ops9, out9, gout9, **kw9), 1)
    nused9 = 3 * bst.ncoeff + 1
    k10_bytes = k9_bytes - out9.numel() * 4 + 2 * out9.numel() * 4 + want10.numel() * 4
    k10_ops = k9_ops + work9[0] * (60 + 4 * nused9 * 2 + nused9)
    # K9 / K10 at a group offset: the second of two depth segments of the
    # pose's slab groups (rank 1 of the bricked mesh step at (1, 2)): tables
    # of global group indices over the segment's groups, the repacked grid's
    # groups from g0 on
    rep_s, occ_s = br.prepare_bricked_grid(grid, bst)
    G9 = occ_s.shape[0]
    g0 = G9 // 2
    tab_s, cnt_s, _ = br.build_tables(ops9[2], occ_s[g0:], bst, group_range=(g0, G9))
    ops_s = (tab_s, cnt_s, ops9[2], rep_s[g0:].contiguous())
    kw_s = {**kw9, "group_offset": g0}
    got_s = sm.slab_march_render(*ops_s, **kw_s)
    torch.cuda.synchronize()
    want_s = sm.slab_march_render_plain(*ops_s, **kw_s)
    k9_seg_err = max_abs(got_s, want_s)
    check(k9_seg_err <= 1e-6 and float(want_s[..., 3].max()) > 0.1 and int(cnt_s.sum()) > 0,
          f"K9 at group_offset {g0} vs plain: max-abs {k9_seg_err}")
    gout_s = k10_cotangent(torch, want_s)
    dg_s = sm.slab_march_grad(*ops_s, want_s, gout_s, **kw_s)
    torch.cuda.synchronize()
    dg_s_plain = sm.slab_march_grad_plain(*ops_s, want_s, gout_s, **kw_s)
    scale_s = float(dg_s_plain.abs().max())
    k10_seg_err, k10_seg_cos = max_abs(dg_s, dg_s_plain), cosine(dg_s, dg_s_plain)
    check(scale_s > 0.0 and k10_seg_err <= 1e-4 * scale_s and k10_seg_cos > 0.99999,
          f"K10 at group_offset {g0} vs plain: max-abs {k10_seg_err} of {scale_s}, cosine "
          f"{k10_seg_cos}")
    k9_seg_ms = time_ms(torch, lambda: sm.slab_march_render(*ops_s, **kw_s), 20)
    k10_seg_ms = time_ms(torch, lambda: sm.slab_march_grad(*ops_s, want_s, gout_s, **kw_s),
                         20)
    segment = dict(group_offset=g0, groups=G9 - g0, of_groups=G9, entries=int(cnt_s.sum()),
                   k9_ms=k9_seg_ms, k9_max_abs_err=k9_seg_err, k10_ms=k10_seg_ms,
                   k10_max_abs_err=k10_seg_err, k10_cosine=k10_seg_cos)
    print(f"# K9 / K10 at group_offset {g0} (groups {g0}-{G9 - 1} of {G9}, {int(cnt_s.sum())} "
          f"entries; {card_line()}): K9 max-abs {k9_seg_err:.3g}, ms={k9_seg_ms:.4f}; K10 "
          f"max-abs {k10_seg_err:.3g} of {scale_s:.3g}, cosine {k10_seg_cos:.9f}, "
          f"ms={k10_seg_ms:.4f} (the whole pose at offset 0: K9 {k9_ms:.4f}, K10 "
          f"{k10_ms:.4f})", flush=True)
    del rep_s, occ_s, ops_s, got_s, want_s, gout_s, dg_s, dg_s_plain
    print(f"# K9 slab_march (blob, 400 x 400): ms={k9_ms:.4f} plain_ms={k9_plain_ms:.4f}; "
          f"bound counts {k9_bytes} bytes, {k9_ops} operations, {int(work9[1].sum())} slab "
          f"records read", flush=True)
    print(f"# K10 slab_march_backward: max-abs {k10_err:.3g} of {scale10:.3g} (f32), "
          f"{k10_cast:.3g} after the bf16 cast, cosine {k10_cos:.9f}; ms={k10_ms:.4f} "
          f"plain_ms={k10_plain_ms:.4f}; bound counts {k10_bytes} bytes, {k10_ops} "
          f"operations", flush=True)
    del ops9, out9, gout9, got10, want10

    # ---- phase 15: bricked serving through the entry points: the blob model
    # saved with the bricked procedure, loaded, 8 poses through render_poses
    bmodel = vm.VolumetricModel(grid, "render_sh_voxel_grid_bricked", config)
    vm.save_model(bmodel, workdir / "blob128_bricked",
                  {"hemispherical_radius": 4.0,
                   "camera_intrinsics": [IMAGE_SIZE, IMAGE_SIZE, intr.focal]})
    del bmodel
    bmodel, _ = vm.create_volumetric_model_from_saved_model(workdir / "blob128_bricked")
    check(bmodel.render_procedure_name == "render_sh_voxel_grid_bricked"
          and bmodel.thre3d_repr.device.type == "cuda", "the loaded bricked model")
    bmodel.render_poses(render_poses, intr)  # warm-up: the variants' repacks
    torch.cuda.synchronize()
    counters15 = {"slab_march": sm.slab_march_render, "slab_march_backward": sm.slab_march_grad,
                  "composite_fused": gn.composite_positions_fused,
                  "resample_rows": wm.resample_rows}
    for c in counters15.values():
        c.launches = 0
    t0 = time.perf_counter()
    outb = bmodel.render_poses(render_poses, intr)
    torch.cuda.synchronize()
    ms_pose_b = (time.perf_counter() - t0) * 1e3 / NUM_POSES
    launches15 = {name: c.launches for name, c in counters15.items()}
    check(launches15 == dict(slab_march=NUM_POSES, slab_march_backward=0, composite_fused=0,
                             resample_rows=0), f"bricked serving launches {launches15}")
    accb = outb.extra["accumulated_weight"]
    check(outb.colour.shape == (NUM_POSES, IMAGE_SIZE, IMAGE_SIZE, 3), "bricked colour shape")
    for name, t in (("colour", outb.colour), ("depth", outb.depth), ("acc", accb)):
        check(bool(torch.isfinite(t).all()), f"bricked render: non-finite {name}")
    check(float(accb.min()) >= 0.0 and float(accb.max()) <= 1.0 + 1e-6 and float(accb.max()) > 0.5,
          "bricked render: acc outside [0, 1] or the scene is not hit")
    refb = br.render_poses_bricked(bmodel.thre3d_repr, render_poses, intr,
                                   bmodel.render_config, plain=True)
    psnr_b = psnr(outb.colour, refb.colour)
    gmodel, _ = vm.create_volumetric_model_from_saved_model(workdir / "blob128")
    psnr_bg = psnr(outb.colour, gmodel.render_poses(render_poses, intr).colour)
    overflow15 = [bool(x) for x in outb.extra["bricked_tap_overflow"]]
    print(f"# bricked serving: {NUM_POSES} poses, {ms_pose_b:.3f} ms/pose (host clock, "
          f"synchronized), launches {launches15}; PSNR vs plain {psnr_b:.2f} dB (colour "
          f"max-abs {max_abs(outb.colour, refb.colour):.3g}), vs the gnomonic render "
          f"{psnr_bg:.2f} dB; tap overflow per pose {overflow15}", flush=True)
    check(psnr_b >= 60.0, f"bricked render vs plain PSNR {psnr_b:.2f} dB < 60")
    _, dev_b, summary_b = device_profile(
        torch, lambda: bmodel.render_poses(render_poses, intr), NUM_POSES, "pose")
    print(f"# bricked serving profile: device {dev_b:.4f} ms/pose summed over kernels, "
          f"busy share {dev_b / ms_pose_b:.3f}, {summary_b}", flush=True)
    del bmodel, gmodel, outb, refb, accb

    # ---- phase 16: the training CLI with the bricked procedure on phase
    # 12's dataset: 64^3 then 128^3, 4 steps a stage, the default ray batch
    # (64 tiles of 16 x 16)
    counters16 = {"slab_march": sm.slab_march_render, "slab_march_backward": sm.slab_march_grad,
                  **counters12, "composite_stripe_qb": gn.composite_positions_qb,
                  "composite_stripe_backward_qb": gt.composite_backward_qb}
    original_bstep = bt.bricked_train_step
    steps_b, firsts_b = [], {}
    out_dir = workdir / "cli_bricked"
    argv = ["-d", str(data), "-o", str(out_dir), "--grid_dims", *[str(CLI_GRID)] * 3,
            "--num_stages", "2", "--num_iterations_per_stage", str(CLI_STEPS),
            "--save_frequency", "2", "--test_frequency", "4", "--feedback_frequency", "4",
            "--summary_frequency", "1", "--render_procedure", "render_sh_voxel_grid_bricked"]
    bt.bricked_train_step = bricked_recording_step(torch, bt, original_bstep, counters16,
                                                   steps_b, firsts_b)
    torch.cuda.reset_peak_memory_stats()
    for c in counters16.values():
        c.launches = 0
    t0 = time.perf_counter()
    try:
        trained = cli.main(argv)
    finally:
        bt.bricked_train_step = original_bstep
    torch.cuda.synchronize()
    wall16 = time.perf_counter() - t0
    counts16 = {name: c.launches for name, c in counters16.items()}
    peak16 = torch.cuda.max_memory_allocated() / 1e9
    if counts16["slab_march"] == 0 or counts16["slab_march_backward"] == 0:
        raise RuntimeError(f"chip_smoke: the bricked CLI run launched no slab march: {counts16}")
    check(all(v == 0 for k_, v in counts16.items() if not k_.startswith("slab_march"))
          and counts16["slab_march_backward"] == 2 * CLI_STEPS,
          f"bricked CLI launches {counts16}")
    gb = trained.thre3d_repr
    check(trained.render_procedure_name == "render_sh_voxel_grid_bricked"
          and gb.grid_dims == (CLI_GRID,) * 3
          and all(bool(torch.isfinite(t).all()) for t in (gb.densities, gb.features)),
          f"bricked CLI: final model {trained.render_procedure_name} {gb.grid_dims}")
    for stem in ("model_stage_1_iter_4", "model_stage_2_iter_8"):
        check((out_dir / "saved_models" / f"{stem}_opt.npz").exists(),
              f"bricked CLI: missing {stem}_opt.npz")
    check([s_[0] for s_ in steps_b] == [CLI_GRID // 2] * CLI_STEPS + [CLI_GRID] * CLI_STEPS,
          f"bricked CLI steps {[s_[0] for s_ in steps_b]}")
    summaries = [json.loads(line) for line in
                 (out_dir / "training_logs" / "summaries.jsonl").read_text().splitlines()]
    psnr16 = {s_["step"]: round(s_["value"], 3) for s_ in summaries
              if s_["name"] == "TEST_SET_PSNR"}
    check(sorted(psnr16) == [4, 8], f"bricked CLI: held-out tests at {sorted(psnr16)}")
    ms_step_b = {f"{dd}^3": round(float(np.mean([t for d_, t, _ in steps_b if d_ == dd][1:])), 3)
                 for dd in (CLI_GRID // 2, CLI_GRID)}
    losses_b = {f"{dd}^3": [round(l_, 5) for d_, _, l_ in steps_b if d_ == dd]
                for dd in (CLI_GRID // 2, CLI_GRID)}
    del trained, gb
    print(f"# CLI bricked: {wall16:.1f} s in main(); ms/step per stage {ms_step_b} (steps 2-4, "
          f"host clock, synchronized); losses per stage {losses_b}; held-out PSNR per stage "
          f"{psnr16}; launches {counts16}; peak memory {peak16:.2f} GB", flush=True)
    stages_b = uncounted(counters16, lambda: check_bricked_first_steps(
        torch, port, original_bstep, firsts_b))
    print(f"# CLI bricked: each stage's first step vs plain and its tiles' loss after the "
          f"stage's last step: {stages_b}", flush=True)
    del firsts_b

    planes_results, launches18, launches18g, launches19, launches20, ms_pose_p, wall19 = (
        planes_phases(torch, port, workdir, scene=scene, grid=grid, d=d, f=f,
                      grid_config=grid_config, config=config, intr=intr,
                      render_poses=render_poses, axis=axis, flip=flip, gen=gen, dev=dev))
    view = TrainingView(init_grid, targets, rots, orgs, picks[0], phases[0], (ax, fl, sw))
    new_paths = warp_options_phases(torch, port, workdir, scene=scene, dev=dev, view=view)
    ray_paths = ray_batch_phases(torch, port, workdir, scene=scene, dev=dev, view=view)
    mesh_paths = mesh_phases(torch, port, workdir, scene=scene, dev=dev, view=view)
    diffusion = diffusion_phase(torch, port, workdir, dev=dev)
    recipe = recipe_phase(torch, port, workdir, dev=dev)
    results["composite_stripe_qb"] = dict(
        err=k6_err, ms=k6_ms, plain_ms=k6_plain_ms, bound=bound(k6_bytes, k6_ops),
        extra=dict(training_operands_ms=k6t_ms))
    results["composite_stripe_backward_qb"] = dict(
        err=k8_err, ms=k8_ms, plain_ms=k8_plain_ms, bound=k8_bound,
        extra=dict(cosine_vs_plain=k8_cos, **k8_extra))
    results["slab_march"] = dict(
        err=max(k9_err, k9_err_opaque, k9_err_batch), ms=k9_ms, plain_ms=k9_plain_ms,
        bound=bound(k9_bytes, k9_ops),
        extra=dict(samples_marched=work9[0], opaque_samples_marched=o_work[0],
                   opaque_samples_without_exit=o_work0[0],
                   entries_max_mean_empty=k9_entries, launch=k9_shape,
                   trainer_batch=dict(ms=k9_batch_ms, max_abs_err=k9_err_batch,
                                      samples_marched=work9b[0],
                                      bound_ms=k9_batch_bound[0]),
                   group_offset_segment=segment))
    results["slab_march_backward"] = dict(
        err=k10_err, ms=k10_ms, plain_ms=k10_plain_ms, bound=bound(k10_bytes, k10_ops),
        extra=dict(cosine_vs_plain=k10_cos, max_abs_err_after_bf16_cast=k10_cast,
                   grad_scale=scale10, pose=k10_pose, trainer_batch=k10_batch,
                   group_offset_segment=segment))
    results.update(planes_results)

    rows = []
    meta = {
        "composite_fused": ("cuda", "thr3ed_atom_tpu_torch/csrc/composite_fused.cu",
                            "thr3ed_atom_tpu/rendering/gnomonic.py:1010"),
        "relu_trap": ("cuda", "thr3ed_atom_tpu_torch/csrc/relu_trap.cuh",
                      "thr3ed_atom_tpu/ops/pallas/plane_march.py:83"),
        "resample_rows": ("cuda", "thr3ed_atom_tpu_torch/csrc/resample_rows.cu",
                          "thr3ed_atom_tpu/rendering/warp_matmul.py:253"),
        "composite_backward_fused": (
            "cuda", "thr3ed_atom_tpu_torch/csrc/composite_backward_fused.cu",
            "thr3ed_atom_tpu/rendering/gnomonic_train.py:999"),
        "resample_rows_adjoint": ("cuda", "thr3ed_atom_tpu_torch/csrc/resample_rows_adjoint.cu",
                                  "thr3ed_atom_tpu/rendering/warp_matmul.py:253"),
        "composite_stripe": ("cuda", "thr3ed_atom_tpu_torch/csrc/composite_stripe.cu",
                             "thr3ed_atom_tpu/rendering/gnomonic.py:619"),
        "composite_stripe_backward": (
            "cuda", "thr3ed_atom_tpu_torch/csrc/composite_stripe_backward.cu",
            "thr3ed_atom_tpu/rendering/gnomonic_train.py:651"),
        "composite_stripe_qb": ("cuda", "thr3ed_atom_tpu_torch/csrc/composite_stripe.cu",
                                "thr3ed_atom_tpu/rendering/gnomonic.py:551"),
        "composite_stripe_backward_qb": (
            "cuda", "thr3ed_atom_tpu_torch/csrc/composite_stripe_backward.cu",
            "thr3ed_atom_tpu/rendering/gnomonic_train.py:569"),
        "slab_march": ("cuda", "thr3ed_atom_tpu_torch/csrc/slab_march.cu",
                       "thr3ed_atom_tpu/ops/pallas/slab_march.py:277"),
        "slab_march_backward": ("cuda", "thr3ed_atom_tpu_torch/csrc/slab_march_backward.cu",
                                "thr3ed_atom_tpu/ops/pallas/slab_march.py:539"),
        "plane_march": ("cuda", "thr3ed_atom_tpu_torch/csrc/plane_march.cu",
                        "thr3ed_atom_tpu/ops/pallas/plane_march.py:392"),
        "plane_march_backward": ("cuda", "thr3ed_atom_tpu_torch/csrc/plane_march_backward.cu",
                                 "thr3ed_atom_tpu/ops/pallas/plane_march.py:652"),
        "onehot_gather": ("cuda", "thr3ed_atom_tpu_torch/csrc/onehot_gather.cu",
                          "thr3ed_atom_tpu/ops/pallas/onehot_gather.py:104"),
        "onehot_scatter_add": ("cuda", "thr3ed_atom_tpu_torch/csrc/onehot_gather.cu",
                               "thr3ed_atom_tpu/ops/pallas/onehot_gather.py:127"),
    }
    # launches: each kernel's main path, counts reset just before the run and
    # read just after: the two gnomonic CLI runs of phase 12 for K1-K5 and
    # K7; phase 13's fused=False, qb=128 step for K6 / K8; phase 16's bricked
    # CLI run for K9 / K10; phase 19's render CLI run for K11, phase 18's
    # gradient through the repack for K12, phase 20's differentiable gather
    # for K13 / K14. relu_trap (K1a) is a device function of the six
    # composite kernels and of K11 / K12. The serving runs (phases 5, 15, 18)
    # and the 10-step training run (phase 8) stand beside them
    inside = ("composite_fused", "composite_backward_fused", "composite_stripe",
              "composite_stripe_backward", "composite_stripe_qb",
              "composite_stripe_backward_qb", "plane_march", "plane_march_backward")
    for counts in [r["launches"] for r in cli_runs.values()] + [train_launches, launches]:
        counts["relu_trap"] = sum(counts.get(k, 0) for k in inside)
    main_path = {name: sum(r["launches"].get(name, 0) for r in cli_runs.values())
                 for name in meta}
    main_path.update({k_: launches13[k_] for k_ in ("composite_stripe_qb",
                                                    "composite_stripe_backward_qb")})
    main_path.update({k_: counts16[k_] for k_ in ("slab_march", "slab_march_backward")})
    main_path.update(plane_march=launches19["plane_march"],
                     plane_march_backward=launches18g["plane_march_backward"],
                     onehot_gather=launches20["onehot_gather"],
                     onehot_scatter_add=launches20["onehot_scatter_add"])
    check(all(v > 0 for v in main_path.values()), f"a kernel was not launched on the main "
          f"path: {main_path}")
    for name, r in results.items():
        route, source, replaces = meta[name]
        rows.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=main_path[name], max_abs_err=r["err"], max_abs_vs_plain=r["err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r.get("library"),
            launches_cli_qb128=cli_runs[128]["launches"].get(name, 0),
            launches_cli_qb0=cli_runs[0]["launches"].get(name, 0),
            launches_training_phase8=train_launches.get(name, 0),
            launches_serving_phase5=launches.get(name, 0),
        ))
        if name in launches13:
            rows[-1]["launches_qsplit_step_phase13"] = launches13[name]
        if name in counts16:
            rows[-1]["launches_cli_bricked_phase16"] = counts16[name]
        if name in launches15:
            rows[-1]["launches_serving_bricked_phase15"] = launches15[name]
        if name in ("plane_march", "plane_march_backward", "onehot_gather",
                    "onehot_scatter_add"):
            rows[-1].update(launches_serving_planes_phase18=launches18[name],
                            launches_gradient_phase18=launches18g[name],
                            launches_render_cli_phase19=launches19[name],
                            launches_autograd_phase20=launches20[name])
        if name == "relu_trap":
            rows[-1]["launches_inside"] = ", ".join(inside)
        if name == "composite_stripe":
            rows[-1]["launches_serving_qb0_phase11"] = launches11["composite_stripe"]
        if name in mesh_paths["cli"]["launches"]:
            rows[-1]["launches_cli_use_mesh_phase32"] = mesh_paths["cli"]["launches"][name]
        if name in recipe["launches"]:
            rows[-1]["launches_full_recipe_phase33"] = recipe["launches"][name]
        if name in diffusion["sampling"]["launches"]:
            rows[-1]["launches_diffusion_mosaic_phase29"] = (
                diffusion["sampling"]["launches"][name])
        rows[-1].update(r.get("extra", {}))
    print(f"# serving ms/pose {ms_per_pose:.3f} (qb=0: {ms_pose_v2:.3f}; bricked: "
          f"{ms_pose_b:.3f}; planes: {ms_pose_p:.3f}); training ms/step {ms_per_step:.3f}; "
          f"CLI ms/step qb=128 {cli_runs[128]['ms_per_step']}, qb=0 "
          f"{cli_runs[0]['ms_per_step']}, bricked {ms_step_b}; render CLI {wall19:.2f} s; "
          f"exact render {new_paths['timings']['exact_render_ms_pose']:.1f} ms/pose; quality "
          f"gates {new_paths['gates_db']} {new_paths['tool_gates_db']}; fast renderer gates "
          f"{ray_paths['gates_db']}; "
          f"full-width ray-batch step {ray_paths['full_width']['ms_per_step']:.3f} ms "
          f"(peak {ray_paths['full_width']['peak_gb']:.2f} GB); 3inFusion step "
          f"{diffusion['full_width']['ms_per_step']:.1f} ms at batch {DIFF_BATCH} (peak "
          f"{diffusion['full_width']['peak_gb']:.2f} GB), reverse step "
          f"{diffusion['sampling']['ms_per_reverse_step']:.2f} ms; mesh steps (gloo, 2 ranks "
          f"on one card, ms per rank) "
          f"{ {k_: v['ms'] for k_, v in mesh_paths['gloo_two_ranks'].items() if k_ != 'wall_s'} }"
          f"; full recipe ms/step "
          f"{ {k_: round(v['ms_per_step'], 3) for k_, v in recipe['stages'].items()} }, peak GB "
          f"{ {k_: round(v['peak_gb'], 2) for k_, v in recipe['stages'].items()} } ("
          f"{recipe['resident_gb']:.2f} held before the phase), "
          f"held-out PSNR "
          f"{ {k_: round(v['test_psnr'], 3) for k_, v in recipe['stages'].items()} }; total "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
