"""The step's needed work (``work/adm_train.py``: convolutions, attention
projections and products, forward and backward) at the dense fp16 peak,
over the traced window's time per step."""
from readers_fp16 import share_of_fp16_peak


def read(run):
    tr = run.trace
    if tr is None or not tr.units:
        return None
    work = run.work.step(run.cell.config, run.cell.traffic)
    return share_of_fp16_peak(run, work, (tr.t1_us - tr.t0_us) / 1e6 / tr.frames)
