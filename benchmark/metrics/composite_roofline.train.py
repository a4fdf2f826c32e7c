"""The composite forward and its replay backward (K1, K3) against their
roofline: the least time of their work (``work/<driver>.py`` ``composite``)
over those kernels' device time per step."""
from readers import device_ms_per_frame, share_of_peak

KERNELS = ("composite_fused_kernel", "backward_march_kernel", "ufold_kernel")


def read(run):
    ms = device_ms_per_frame(run, lambda name: any(k in name for k in KERNELS))
    if ms is None:
        return None
    return share_of_peak(run, run.work.composite(run.cell.config, run.cell.traffic), ms / 1e3)
