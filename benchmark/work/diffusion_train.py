"""Work of one 3inFusion training step, from the configuration's and the
traffic's shapes alone: the UNet's convolutions and bottleneck attention,
2 operations a multiply-add, for the forward and the backward (input and
weight gradients, twice the forward); the recomputation that gradient
checkpointing adds is not needed work and is not counted. Bytes are not the
bound here and are counted as the crops and the noise read once."""
import math


def _convs(config, side):
    """[(in channels, out channels, kernel, output side)] in call order."""
    base, mult = config["model_channels"], config["channel_mult"]
    channels = 1 + 3 * (config["sh_degree"] + 1) ** 2
    out = [(channels, base, 3, side)]
    ch, s, skips = base, side, [base]
    for level, m in enumerate(mult):
        for _ in range(config["num_res_blocks"]):
            out += [(ch, m * base, 3, s), (m * base, m * base, 3, s)]
            if ch != m * base:
                out.append((ch, m * base, 1, s))
            ch = m * base
            skips.append(ch)
        if level != len(mult) - 1:
            s //= 2
            out.append((ch, ch, 3, s))
            skips.append(ch)
    out += [(ch, ch, 3, s)] * 4  # the middle's two residual blocks
    for level, m in reversed(list(enumerate(mult))):
        for i in range(config["num_res_blocks"] + 1):
            cin = ch + skips.pop()
            out += [(cin, m * base, 3, s), (m * base, m * base, 3, s), (cin, m * base, 1, s)]
            ch = m * base
            if level and i == config["num_res_blocks"]:
                s *= 2
                out.append((ch, ch, 3, s))
    out.append((ch, channels, 3, s))
    return out, ch


def crop_side(config, traffic):
    size = int(traffic["scene_size"])
    side = min(int(math.ceil((float(size) ** 3 * config["crop_ratio"]) ** (1.0 / 3.0))), size)
    g = 2 ** (len(config["channel_mult"]) - 1)
    return max((side // g) * g, g)


def forward_flops(config, side):
    """Operations of one crop's forward pass."""
    convs, _ = _convs(config, side)
    total = sum(2.0 * cin * cout * k ** 3 * s ** 3 for cin, cout, k, s in convs)
    c = config["model_channels"] * config["channel_mult"][-1]
    n = (side // 2 ** (len(config["channel_mult"]) - 1)) ** 3
    total += 2.0 * n * c * 3 * c + 2.0 * 2 * n * n * c + 2.0 * n * c * c  # qkv, attention, proj
    return total


def step(config, traffic):
    side = crop_side(config, traffic)
    batch = int(config["batch_size"])
    voxels = side ** 3 * (1 + 3 * (config["sh_degree"] + 1) ** 2)
    return {"flops": 3.0 * batch * forward_flops(config, side), "bytes": 2.0 * batch * voxels * 4}
