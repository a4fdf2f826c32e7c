"""Device ms per step of the convolution kernels (cuDNN's forward, data- and
weight-gradient kernels), by the name fragments below."""
from readers import device_ms_per_frame

FRAGMENTS = ("conv", "Conv", "wgrad", "dgrad", "fprop")


def read(run):
    return device_ms_per_frame(run, lambda name: any(f in name for f in FRAGMENTS))
