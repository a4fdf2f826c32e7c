"""Work of one camera-path call, from the configuration's and the traffic's
shapes alone: per frame the composite's forward over every position and
texel (as ``work/gnomonic_train.py`` counts it, serving rows) and the
two-pass warp's four taps a channel; bytes: the bf16 slices read and the
frame's outputs (colour, accumulated weight, depth) written once."""
import math


def _frame(config, traffic):
    G = int(config["grid_dims"][0])
    size = int(round(traffic["stored_size"] * traffic["render_scale_factor"]))
    ss = max(config["gnomonic_supersample"], min(4.0, 2.5 * G / size))
    return G, size, -(-int(math.ceil(size * ss)) // 128) * 128


def composite_frame(config, traffic):
    G, _, n = _frame(config, traffic)
    ncoeff = (config["sh_degree"] + 1) ** 2
    used = 3 * ncoeff + 1
    P = max(1, min(8, 2 ** round(math.log2(max(1.0, 256 / (G - 1))))))
    positions = (G - 1) * P + 1
    flops = positions * (3 * n * G * used + n * n * (3 * used + 2 * 3 * ncoeff + 40))
    return {"flops": float(flops), "bytes": float(G ** 3 * used * 2 + 6 * n * n * 4)}


def step(config, traffic):
    """One call: every frame of the path."""
    _, size, n = _frame(config, traffic)
    frames = int(traffic["num_frames"]) - 1
    comp = composite_frame(config, traffic)
    warp = 2 * 8 * 4 * 2 * (n * size + size * size)
    return {"flops": frames * (comp["flops"] + warp),
            "bytes": frames * (comp["bytes"] + size * size * 5 * 4.0)}
