"""Device ms per frame (per step in training) of every kernel that is not
one of the port's own: aten, cuBLAS, cuDNN and the optimizer's kernels."""
from readers import device_ms_per_frame, is_port_kernel


def read(run):
    return device_ms_per_frame(run, lambda name: not is_port_kernel(name))
