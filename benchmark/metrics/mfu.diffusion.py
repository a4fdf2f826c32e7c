"""The UNet's convolution and attention operations of a forward and backward
(``work/diffusion_train.py``) against the f32 peak, over the traced
window's time per step (TF32 is off, so the f32 peak applies)."""
from readers import mfu


def read(run):
    return mfu(run, run.work.step(run.cell.config, run.cell.traffic))
