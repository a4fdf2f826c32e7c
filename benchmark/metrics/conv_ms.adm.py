"""Device ms per step of the convolution kernels (cuDNN's forward, data- and
weight-gradient kernels, by name; attention's and PyTorch's own kernels
left out)."""
from readers import device_ms_per_frame
from readers_fp16 import is_convolution


def read(run):
    return device_ms_per_frame(run, is_convolution)
