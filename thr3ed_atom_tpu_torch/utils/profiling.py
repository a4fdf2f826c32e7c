"""Profiling utilities (counterpart of thr3ed_atom_tpu/utils/profiling.py): a
``torch.profiler`` trace of a run, written as a Chrome trace (open it in
Perfetto or chrome://tracing), and the program's named spans in it."""
import contextlib
from pathlib import Path
from typing import Optional

import torch
from torch.profiler import record_function

from thr3ed_atom_tpu_torch.utils.logging import log

_profiler_enabled = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler`` range named ``t3.<name>`` while a profiler
    records, so the span shares the trace's clock with the kernels and
    runtime calls it encloses; otherwise one shared no-op context (a single
    check, nothing allocated)."""
    if not _profiler_enabled():
        return _NO_SPAN
    return record_function("t3." + name)


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
