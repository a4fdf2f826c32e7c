"""The work counts against hand counts at small shapes."""
import json
from pathlib import Path

import torch

import harness
from reference import unet_plain

BENCH = Path(__file__).resolve().parents[1]


def test_gnomonic_composite_by_hand():
    # 16^3, SH 2: 28 used channels, P = 8 (256 / 15 cells -> 16, capped) -> 121
    # positions; 24 px views: supersample max(1.25, 2.5 * 16 / 24) -> 40 texels
    # -> a 128 x 128 frame; 9 state rows with the diffuse output
    work = harness.load_work("gnomonic_train")
    config = {"grid_dims": [16] * 3, "gnomonic_supersample": 1.25, "sh_degree": 2,
              "apply_diffuse_render_regularization": True, "poses_per_step": 4}
    forward = 121 * (3 * 128 * 16 * 28 + 128 * 128 * (3 * 28 + 54 + 40))
    got = work.composite(config, {"view_size": 24})
    assert got["flops"] == 3.0 * forward * 4
    assert got["bytes"] == 4 * (2 * 16 ** 3 * 28 * 2 + 2 * 9 * 128 * 128 * 4)
    step = work.step(config, {"view_size": 24})
    assert step["bytes"] == 9.0 * 16 ** 3 * 28 * 4
    assert step["flops"] == got["flops"] + 12.0 * 16 ** 3 * 28


def test_render_frame_by_hand():
    # 16^3 at 48 px: supersample max(1.25, 2.5 * 16 / 48) = 1.25 -> 60 -> 128
    work = harness.load_work("render_path")
    config = {"grid_dims": [16] * 3, "gnomonic_supersample": 1.25, "sh_degree": 2}
    traffic = {"stored_size": 24, "render_scale_factor": 2.0, "num_frames": 3}
    frame = work.composite_frame(config, traffic)
    assert frame["flops"] == 121 * (3 * 128 * 16 * 28 + 128 * 128 * (3 * 28 + 54 + 40))
    assert frame["bytes"] == 16 ** 3 * 28 * 2 + 6 * 128 * 128 * 4
    warp = 2 * 8 * 4 * 2 * (128 * 48 + 48 * 48)
    assert work.step(config, traffic)["flops"] == 2 * (frame["flops"] + warp)


def test_diffusion_convolutions_against_a_counted_forward():
    """work/diffusion_train.py's forward operations equal those of the
    reference UNet's convolutions (counted from their output shapes by hooks)
    and its attention, at a small width and crop."""
    work = harness.load_work("diffusion_train")
    with open(BENCH / "configs" / "thre3infusion_unet32.json") as f:
        config = dict(json.load(f), model_channels=8)
    side = 16
    net = unet_plain.UNet(28, 8, tuple(config["channel_mult"]), 1, config["num_heads"])
    counted = []

    def hook(module, inputs, output):
        cin, k = module.weight.shape[1], module.weight.shape[2]
        counted.append(2.0 * cin * output.shape[1] * k ** 3 * output[0, 0].numel())

    for m in net.modules():
        if isinstance(m, unet_plain.Conv):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net(torch.zeros(1, side, side, side, 28), torch.zeros(1, dtype=torch.long))
    n, c = (side // 8) ** 3, 64
    attention = 2.0 * n * c * 3 * c + 2.0 * 2 * n * n * c + 2.0 * n * c * c
    assert abs(work.forward_flops(config, side) - (sum(counted) + attention)) < 1e-6 * sum(counted)
    assert work.crop_side(config, {"scene_size": 128}) == 112
