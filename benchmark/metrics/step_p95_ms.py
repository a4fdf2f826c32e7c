"""The 95th percentile of all the window's step times: CUDA events recorded
after each step, read after the window."""
import sys

from harness import quantile


def read(run):
    w = run.window
    if not w or not w.unit_ms:
        return None
    print(f"step_p95_ms over {len(w.unit_ms)} steps", file=sys.stderr)
    return quantile(w.unit_ms, 0.95)
