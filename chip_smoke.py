"""Smoke run of the PyTorch/CUDA port (thr3ed_atom_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from thr3ed_atom_tpu_torch/csrc with nvcc,
holds each against its plain PyTorch version on the card at the serving
path's shapes (the composite also on an opaque copy of the scene, where its
early exit must end tiles), then drives the serving path through the entry
points a user calls: a 128^3 SH-degree-2 model (random blob scene from a seed,
bench.py's configuration) saved with save_model, loaded with
create_volumetric_model_from_saved_model and rendered with render_poses at
400 x 400 (P = 2, qb = 128, exit_eps = 1e-4, Catmull-Rom matmul warp). The
launch counts of that run show it went through the kernels; its images are
held against the same render through the plain versions. One more pass under
torch.profiler prints the device time per pose and the device's busy share.

Prints the card's name and power limit first, one JSON line of per-kernel
results before the last line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase raises and the script exits non-zero without that line; it
also exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. Imports nothing of JAX.
"""
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
GRID_SIZE, IMAGE_SIZE, NUM_POSES = 128, 400, 8


def load_port():
    """Import the port's modules (the repository root must be on sys.path)."""
    from thr3ed_atom_tpu_torch import kernels
    from thr3ed_atom_tpu_torch.models.voxels import voxel_grid_from_numpy
    from thr3ed_atom_tpu_torch.modules import volumetric_model as vm
    from thr3ed_atom_tpu_torch.ops import relu_trap as rt
    from thr3ed_atom_tpu_torch.rendering import gnomonic as gn
    from thr3ed_atom_tpu_torch.rendering import warp_matmul as wm
    from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
    from thr3ed_atom_tpu_torch.utils import camera

    return dict(kernels=kernels, voxel_grid_from_numpy=voxel_grid_from_numpy,
                vm=vm, rt=rt, gn=gn, wm=wm, Config=SHVoxGridRenderConfig,
                camera=camera)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def blob_scene(grid_size, seed=3, num_blobs=6):
    """tools/make_synthetic_dataset.py make_blob_scene(converged=True): soft
    density blobs with random colours and mild view dependence, empty space
    at -1 under identity pre- / relu post-activation."""
    rng = np.random.default_rng(seed)
    coords = (
        np.stack(np.meshgrid(*[np.arange(grid_size)] * 3, indexing="ij"), -1)
        - (grid_size - 1) / 2
    ) / grid_size
    densities = np.zeros((grid_size,) * 3, dtype=np.float32)
    features = np.zeros((grid_size,) * 3 + (27,), dtype=np.float32)
    for _ in range(num_blobs):
        center = rng.uniform(-0.28, 0.28, size=3)
        radius = rng.uniform(0.08, 0.16)
        colour = rng.uniform(-3.0, 3.0, size=3)
        dist = np.linalg.norm(coords - center, axis=-1)
        blob = np.exp(-((dist / radius) ** 2) * 4.0).astype(np.float32)
        densities += 8.0 * blob
        for channel in range(3):
            features[..., channel * 9] += colour[channel] * blob
            features[..., channel * 9 + 1: channel * 9 + 4] += (
                rng.uniform(-0.5, 0.5, size=3).astype(np.float32) * blob[..., None]
            )
    densities = np.where(densities > 0.05, densities, -1.0).astype(np.float32)
    config = dict(voxel_size=(3.0 / grid_size,) * 3, grid_location=(0.0, 0.0, 0.0),
                  density_preactivation="identity", density_postactivation="relu",
                  feature_preactivation="identity", feature_postactivation="identity",
                  expected_density_scale=1.0, radiance_transfer_function=None)
    return densities[..., None], features, config


def time_ms(torch, fn, iters):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not (REPO / "thr3ed_atom_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    port = load_port()
    kernels, gn, wm, rt, vm = (port[k] for k in ("kernels", "gn", "wm", "rt", "vm"))
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- phase 1: the card, the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
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
    axis, flip = gn.dominant_axis_for_pose(rot0)
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
    bil_ms = time_ms(torch, lambda: wm.resample_rows(X, p1, 1), 50)
    lib_ms = time_ms(torch, lambda: torch.nn.functional.grid_sample(
        X4, gxy[:, None], mode="bilinear", padding_mode="zeros", align_corners=True), 50)
    print(f"# K2 order 1 without taps: kernel ms={bil_ms:.4f}, F.grid_sample ms={lib_ms:.4f} "
          f"(max-abs {max_abs(k1o, lib[:, :, 0]):.3g}: grid_sample renormalizes positions)",
          flush=True)
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
        got = gn.composite_positions_fused(*args, xr=geo.xr, yr=geo.yr)
        torch.cuda.synchronize()
        want, work = gn.composite_positions_fused_plain(
            *args, xr=geo.xr, yr=geo.yr, exit_tile=gn.CUDA_EXIT_TILE, return_work=True)
        gap = (got - want).abs().amax(dim=(1, 2)).tolist()
        check(bool(torch.isfinite(got).all()), "composite produced non-finite values")
        check(max(gap[:5]) <= 1e-4 and gap[5] <= 1e-3,
              f"composite vs plain ({label}, exit_eps={eps}): per-row max-abs {gap}")
        print(f"# K1 composite {label} exit_eps={eps}: max-abs per row (T,rgb,acc,depth) "
              f"{gap}; marched (position, texel) pairs {int(work.sum())} of {NP * Pn * Qn}",
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
    with tempfile.TemporaryDirectory() as tmp:
        model = vm.VolumetricModel(grid, "render_sh_voxel_grid_gnomonic", config)
        vm.save_model(model, Path(tmp) / "blob128",
                      {"hemispherical_radius": 4.0,
                       "camera_intrinsics": [IMAGE_SIZE, IMAGE_SIZE, intr.focal]})
        del model
        model, extra = vm.create_volumetric_model_from_saved_model(Path(tmp) / "blob128")
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.render_poses(render_poses, intr)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in dev_events) / 1e3 / NUM_POSES
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:6]
    print(f"# serving profile: device {device_ms:.4f} ms/pose summed over kernels, "
          f"busy share {device_ms / ms_per_pose:.3f}, "
          f"{sum(e.count for e in dev_events) / NUM_POSES:.1f} device launches/pose; top: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / NUM_POSES:.4f} ms/pose"
                      for e in top), flush=True)
    acc = out.extra["accumulated_weight"]
    check(out.colour.shape == (NUM_POSES, IMAGE_SIZE, IMAGE_SIZE, 3), "colour shape")
    for name, t in (("colour", out.colour), ("depth", out.depth), ("acc", acc)):
        check(bool(torch.isfinite(t).all()), f"non-finite {name}")
    check(float(acc.min()) >= 0.0 and float(acc.max()) <= 1.0 + 1e-6, "acc outside [0, 1]")
    check(float(acc.max()) > 0.5, "the scene is not hit")
    ref = gn.render_poses_gnomonic(model.thre3d_repr, render_poses, intr,
                                   model.render_config, plain=True)
    mse = float(((out.colour - ref.colour) ** 2).mean())
    psnr = float("inf") if mse == 0 else -10.0 * np.log10(mse)
    col_err = max_abs(out.colour, ref.colour)
    print(f"# serving vs plain: PSNR {psnr:.2f} dB, colour max-abs {col_err:.3g}, "
          f"depth max-abs {max_abs(out.depth, ref.depth):.3g}", flush=True)
    check(psnr >= 60.0, f"serving render vs plain PSNR {psnr:.2f} dB < 60")

    rows = []
    meta = {
        "composite_fused": ("cuda", "thr3ed_atom_tpu_torch/csrc/composite_fused.cu",
                            "thr3ed_atom_tpu/rendering/gnomonic.py:934"),
        "relu_trap": ("cuda", "thr3ed_atom_tpu_torch/csrc/relu_trap.cuh",
                      "thr3ed_atom_tpu/ops/pallas/plane_march.py:83"),
        "resample_rows": ("cuda", "thr3ed_atom_tpu_torch/csrc/resample_rows.cu",
                          "thr3ed_atom_tpu/rendering/warp_matmul.py:206"),
    }
    for name, r in results.items():
        route, source, replaces = meta[name]
        rows.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["err"], max_abs_vs_plain=r["err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=None,
        ))
        if name == "relu_trap":
            rows[-1]["launches_inside"] = "composite_fused"
    print(f"# serving ms/pose {ms_per_pose:.3f}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
