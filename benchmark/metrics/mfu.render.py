"""One frame's share of the chip's peak: the least time of a frame's needed
work (``work/<driver>.py`` ``step`` over the path's frames) over the traced
window's time per frame."""
from readers import mfu


def read(run):
    return mfu(run, run.work.step(run.cell.config, run.cell.traffic))
