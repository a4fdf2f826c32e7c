"""The window's wall time over the frames of the camera-path calls
completed in it (the window ends at a call's end)."""


def read(run):
    w = run.window
    return 1e3 * w.seconds / (w.units * w.frames_per_unit) if w and w.units else None
