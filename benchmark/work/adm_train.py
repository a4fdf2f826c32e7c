"""Work of one training step of ADM's UNet on 3-D crops, from the
configuration's and the traffic's shapes alone: the convolutions, the
attention blocks' qkv and output projections and their two products
(softmax(q k^T) v), 2 operations a multiply-add, for the forward, the input
gradients and the weight gradients (3x the forward; the first convolution's
input needs no gradient: 2x). The recomputation that gradient checkpointing
and the fused attention's backward add is not needed work and is not
counted. Bytes are not the bound here and are counted as the crops and the
noise read once (f32); the attention products' bytes as q, k, v and the
output read or written once in fp16, and again with their gradients."""
import math


def channels(config):
    return 1 + 3 * (config["sh_degree"] + 1) ** 2


def layers(config, side):
    """([(in channels, out channels, kernel, output side)] of every
    convolution, [(tokens, channels)] of every attention block), in call
    order of one crop's forward."""
    base, mult = config["model_channels"], config["channel_mult"]
    nrb, attn_ds = config["num_res_blocks"], set(config["attention_resolutions"])
    convs, attns = [(channels(config), base, 3, side)], []

    def res(cin, cout, s):  # the block's convolutions run at its output side
        convs.extend([(cin, cout, 3, s), (cout, cout, 3, s)])
        if cin != cout:
            convs.append((cin, cout, 1, s))

    ch, s, ds, skips = base, side, 1, [base]
    for level, m in enumerate(mult):
        for _ in range(nrb):
            res(ch, m * base, s)
            ch = m * base
            if ds in attn_ds:
                attns.append((s ** 3, ch))
            skips.append(ch)
        if level != len(mult) - 1:
            s //= 2
            res(ch, ch, s)  # resblock_updown: pooled, then both convolutions
            skips.append(ch)
            ds *= 2
    res(ch, ch, s)
    attns.append((s ** 3, ch))
    res(ch, ch, s)
    for level, m in reversed(list(enumerate(mult))):
        for i in range(nrb + 1):
            res(ch + skips.pop(), m * base, s)
            ch = m * base
            if ds in attn_ds:
                attns.append((s ** 3, ch))
            if level and i == nrb:
                s *= 2
                res(ch, ch, s)
                ds //= 2
    out = 2 * channels(config) if config["learn_sigma"] else channels(config)
    convs.append((ch, out, 3, s))
    return convs, attns


def crop_side(config, traffic):
    size = int(traffic["scene_size"])
    side = min(int(math.ceil((float(size) ** 3 * config["crop_ratio"]) ** (1.0 / 3.0))), size)
    g = 2 ** (len(config["channel_mult"]) - 1)
    return max((side // g) * g, g)


def forward_flops(config, side):
    """(convolutions, attention projections, attention products) of one
    crop's forward."""
    convs, attns = layers(config, side)
    conv = sum(2.0 * cin * cout * k ** 3 * s ** 3 for cin, cout, k, s in convs)
    proj = sum(2.0 * n * c * 3 * c + 2.0 * n * c * c for n, c in attns)
    products = sum(2.0 * 2 * n * n * c for n, c in attns)
    return conv, proj, products


def attention(config, traffic):
    """The fused attention kernels' needed work in a step: the two products,
    forward and backward."""
    side = crop_side(config, traffic)
    batch = int(config["batch_size"])
    _, attns = layers(config, side)
    _, _, products = forward_flops(config, side)
    return {"flops": 3.0 * batch * products,
            "bytes": batch * sum(12.0 * n * c * 2 for n, c in attns)}


def step(config, traffic):
    side = crop_side(config, traffic)
    batch = int(config["batch_size"])
    conv, proj, products = forward_flops(config, side)
    first = 2.0 * channels(config) * config["model_channels"] * 27 * side ** 3
    return {"flops": batch * (3.0 * (conv + proj + products) - first),
            "bytes": 2.0 * batch * side ** 3 * channels(config) * 4}
