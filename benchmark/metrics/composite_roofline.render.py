"""The serving composite (K1) against its roofline: the least time of its
work per frame (``work/<driver>.py`` ``composite_frame``) over its device
time per frame."""
from readers import device_ms_per_frame, share_of_peak

KERNELS = ("composite_fused_kernel",)


def read(run):
    ms = device_ms_per_frame(run, lambda name: any(k in name for k in KERNELS))
    if ms is None:
        return None
    return share_of_peak(run, run.work.composite_frame(run.cell.config, run.cell.traffic), ms / 1e3)
