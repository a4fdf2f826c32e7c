"""Work of one gnomonic training step, from the configuration's and the
traffic's shapes alone (at the renderer's roundings: bf16 slices, f32
state), whatever kernel does it.

``composite``: the composite forward and its replay backward over a step's
views. Per view and position the u-tents resample the vertex slice's used
channels to the texel rows (3 operations a value), the v-tents to the
texels (3 more), the SH basis folds the colour (2 a coefficient), the cell
integral and compositing take ~40; the backward replays the forward and
runs its adjoint, twice the forward. Bytes: the slices read once and the
per-position slice cotangent written once (bf16), the state written and its
cotangent read once (f32).

``step``: the whole step's least work: the composite's operations plus
Adam's (~12 a parameter); bytes: the f32 parameters read by the repack, the
gradient written, and Adam's reads of parameter, gradient and both moments
and writes of parameter and moments.
"""
import math


def _frame(config, traffic):
    G = int(config["grid_dims"][0])
    size = int(traffic["view_size"])
    ss = max(config["gnomonic_supersample"], min(4.0, 2.5 * G / size))
    n = -(-int(math.ceil(size * ss)) // 128) * 128
    return G, n


def composite(config, traffic):
    G, n = _frame(config, traffic)
    ncoeff = (config["sh_degree"] + 1) ** 2
    used = 3 * ncoeff + 1
    P = max(1, min(8, 2 ** round(math.log2(max(1.0, 256 / (G - 1))))))
    positions = (G - 1) * P + 1
    rows = 9 if config["apply_diffuse_render_regularization"] else 6
    forward = positions * (3 * n * G * used + n * n * (3 * used + 2 * 3 * ncoeff + 40))
    views = int(config["poses_per_step"])
    slices = G ** 3 * used * 2
    return {"flops": 3.0 * forward * views,
            "bytes": float(views * (2 * slices + 2 * rows * n * n * 4))}


def step(config, traffic):
    G = int(config["grid_dims"][0])
    params = G ** 3 * (3 * (config["sh_degree"] + 1) ** 2 + 1)
    comp = composite(config, traffic)
    return {"flops": comp["flops"] + 12.0 * params, "bytes": 9.0 * params * 4}
