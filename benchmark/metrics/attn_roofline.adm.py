"""The attention products' needed work a step (``work/adm_train.py``
``attention``) at the dense fp16 peak, over the fused attention kernels'
device time a step."""
from readers_fp16 import attention_ms, share_of_fp16_peak


def read(run):
    ms = attention_ms(run)
    work = run.work.attention(run.cell.config, run.cell.traffic)
    return None if ms is None else share_of_fp16_peak(run, work, ms / 1e3)
