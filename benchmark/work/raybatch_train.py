"""Work of one ray-batch training step, from the configuration's shapes
alone: its least bytes are those of ``work/gnomonic_train.py``'s step (the
f32 parameters read, the gradient written, Adam's reads and writes of
parameter, gradient and moments); its operations, the lookups and the
shading of the batch's samples (eight taps a value, forward and backward),
are three orders below and bound nothing."""


def step(config, traffic):
    G = int(config["grid_dims"][0])
    channels = 3 * (config["sh_degree"] + 1) ** 2 + 1
    samples = config["ray_batch_size"] * config["train_num_samples_per_ray"]
    shaded = config["ray_batch_size"] * config["fast_topk"]
    flops = 3.0 * (samples * (8 * 2 + 30) + shaded * (8 * 2 * (channels - 1) + 80))
    return {"flops": flops + 12.0 * G ** 3 * channels, "bytes": 9.0 * G ** 3 * channels * 4}
