"""The whole step's share of the chip's peak: the least time its needed
work could take (``work/<driver>.py`` ``step``) over the traced window's
time per step."""
from readers import mfu


def read(run):
    return mfu(run, run.work.step(run.cell.config, run.cell.traffic))
