"""The host's span around each call into the entry, with no synchronize,
per frame (per step in training): a short window before the traced one."""
import statistics


def read(run):
    w = run.window
    if run.trace is None or not w or not w.enqueue_ms:
        return None
    return statistics.fmean(w.enqueue_ms) / w.frames_per_unit
