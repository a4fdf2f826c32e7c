"""Profiling utilities (counterpart of thr3ed_atom_tpu/utils/profiling.py): a
``torch.profiler`` trace of a run, written as a Chrome trace (open it in
Perfetto or chrome://tracing), and a throughput meter for the train loop."""
import contextlib
import time
from pathlib import Path
from typing import Optional

import torch

from thr3ed_atom_tpu_torch.utils.logging import log


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Trace the host and, where a card is present, the device into
    ``log_dir``/trace.json (no-op when None)."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    log.info(f"capturing a torch.profiler trace into {path}")
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(path / "trace.json"))


class ThroughputMeter:
    """Sliding-window rays/sec (or any unit/sec) meter for the hot loop."""

    def __init__(self, window: int = 50):
        self._window = window
        self._events = []  # (timestamp, units)

    def tick(self, units: float) -> None:
        self._events.append((time.perf_counter(), units))
        if len(self._events) > self._window:
            self._events.pop(0)

    @property
    def per_sec(self) -> float:
        if len(self._events) < 2:
            return 0.0
        span = self._events[-1][0] - self._events[0][0]
        units = sum(u for _, u in self._events[1:])
        return units / span if span > 0 else 0.0
