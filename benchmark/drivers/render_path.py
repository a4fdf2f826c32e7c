"""Driver: the render CLI's camera path through ``VolumetricModel.render_poses``
(gnomonic), as ``visualizations/animations.py`` calls it.

Set-up makes the model from the seed (the converged blob scene made at the
configuration's grid size, as a relu-field grid) and the path (the thre360
orbit: the traffic's frame count, pitch and radius, at the stored
intrinsics times the render scale factor), and renders the whole path once
(every march variant of the path runs). A unit is one call over the whole
path, closed loop; each call starts from an empty variant cache, so it
repacks the grid as the CLI's one call does. The window ends at a call's
end.

``correct`` compares frames of the window's last call, drawn from the seed,
with the plain reference (``reference/gnomonic_plain.py``: no early exit),
which repacks and renders them from the same grid and poses.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference import gnomonic_plain as ref
from reference import scene

OUTPUTS = ("colour", "depth", "acc")


class Driver:
    def __init__(self, ctx):
        from thr3ed_atom_tpu_torch.models.voxels import VoxelGrid, VoxelSize
        from thr3ed_atom_tpu_torch.modules.volumetric_model import VolumetricModel
        from thr3ed_atom_tpu_torch.rendering.renderer import SHVoxGridRenderConfig
        from thr3ed_atom_tpu_torch.utils.camera import CameraBounds, CameraIntrinsics, CameraPose

        self.ctx = ctx
        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.cfg, self.tr, self.dev = cfg, tr, dev
        G = int(cfg["grid_dims"][0])
        extent = float(cfg["grid_world_size"][0])
        scale = float(cfg["expected_density_scale"])
        dens, feats = scene.blob_scene(G, ctx.seed, dev, 3 * (cfg["sh_degree"] + 1) ** 2)
        self.grid_in = ref.Grid(dens / scale, feats, extent / G, scale)
        grid = VoxelGrid(self.grid_in.densities.clone(), feats.clone(),
                         voxel_size=VoxelSize(*(extent / G,) * 3),
                         density_preactivation="identity", density_postactivation="relu",
                         expected_density_scale=scale)
        self.size = int(round(tr["stored_size"] * tr["render_scale_factor"]))
        self.focal = float(tr["stored_focal"] * tr["render_scale_factor"])
        self.intrinsics = CameraIntrinsics(self.size, self.size, self.focal)
        self.poses = scene.orbit_poses(tr["num_frames"], tr["camera_pitch"], tr["view_radius"])
        self.path = [CameraPose(rotation=p[:, :3], translation=p[:, 3:]) for p in self.poses]
        self.frames_per_unit = len(self.path)
        self.model = VolumetricModel(
            thre3d_repr=grid, render_procedure=cfg["render_procedure"],
            render_config=SHVoxGridRenderConfig(
                num_samples_per_ray=tr["num_samples_per_ray"],
                camera_bounds=CameraBounds(tr["near"], tr["far"]), white_bkgd=cfg["white_bkgd"],
                gnomonic_pos_per_cell=cfg["gnomonic_pos_per_cell"],
                gnomonic_supersample=cfg["gnomonic_supersample"],
                gnomonic_warp_order=cfg["gnomonic_warp_order"], gnomonic_qb=cfg["gnomonic_qb"]),
            device=dev)
        rng = np.random.default_rng(ctx.seed)
        self.judged = sorted(rng.choice(len(self.path), size=int(tr["judged_frames"]),
                                        replace=False).tolist())
        self.calls = 0
        self.last = None
        self.run_unit()  # every variant of the path, once
        self.calls = 0

    def run_unit(self):
        self.model.drop_prepared_cache()
        self.last = self.model.render_poses(self.path, self.intrinsics,
                                            num_samples_per_ray=self.tr["num_samples_per_ray"])
        self.calls += 1

    def close_window(self):
        finite = bool(torch.isfinite(self.last.colour).all())
        frames = {i: {"colour": self.last.colour[i], "depth": self.last.depth[i],
                      "acc": self.last.extra["accumulated_weight"][i]} for i in self.judged}
        if self.ctx.fault == "altered":
            frames[self.judged[0]]["colour"] = frames[self.judged[0]]["colour"].clone()
            frames[self.judged[0]]["colour"][0, 0, 0] += 0.25
        self.frames = {i: {k: v.cpu() for k, v in f.items()} for i, f in frames.items()}
        return self.calls * self.frames_per_unit, 0 if finite else self.frames_per_unit

    def release(self):
        del self.model, self.last
        if self.dev.startswith("cuda"):
            torch.cuda.empty_cache()

    def reference_frames(self, dt=torch.float32):
        out = {}
        for i in self.judged:
            pose = self.poses[i]
            r = ref.render_frame(self.grid_in, pose[:, :3], pose[:, 3], self.focal, self.size,
                                 self.size, self.cfg["gnomonic_supersample"], dt)
            out[i] = {k: r[k].float().cpu() for k in OUTPUTS}
        return out

    def judge(self):
        prog = self.reference_frames(torch.bfloat16) if self.ctx.fault == "control" else self.frames
        want = self.reference_frames()
        gaps = {k: max(float((prog[i][k].float() - want[i][k]).abs().max()) for i in self.judged)
                for k in OUTPUTS}
        return [(f"{k}_gap", gaps[k] if math.isfinite(gaps[k]) else None,
                 float(self.ctx.limits[f"{k}_gap"])) for k in OUTPUTS]
