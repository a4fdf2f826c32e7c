"""The window's wall time over the training steps completed in it."""


def read(run):
    w = run.window
    return 1e3 * w.seconds / w.units if w and w.units else None
