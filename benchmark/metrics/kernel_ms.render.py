"""Device ms per frame (per step in training) of the port's own CUDA
kernels, by the names in ``port_kernels.json``."""
from readers import device_ms_per_frame, is_port_kernel


def read(run):
    return device_ms_per_frame(run, is_port_kernel)
