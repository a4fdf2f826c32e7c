"""Helpers that the metric readers share: the table of peaks, the port's
kernel names, a bound's time and per-frame device time."""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Optional

from harness import load_json

HERE = Path(__file__).resolve().parent


def peaks(device_kind: str) -> Optional[dict]:
    """The device's published peaks, or None for a device the table lacks."""
    return load_json(HERE / "peaks.json")["devices"].get(device_kind)


@functools.lru_cache(maxsize=None)
def port_kernels():
    return tuple(load_json(HERE / "metrics" / "port_kernels.json"))


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in port_kernels())


def bound_s(work: dict, peak: dict) -> float:
    """The least time ``work`` could take: the larger of its bytes at the
    peak bandwidth and its f32 operations at the peak rate."""
    return max(work["bytes"] / peak["bytes_per_s"], work["flops"] / peak["f32_flops_per_s"])


def device_ms_per_frame(run, match) -> Optional[float]:
    """Device ms per frame (per step in training) of the traced kernels that
    ``match`` accepts; None without a trace or without such a kernel."""
    tr = run.trace
    if tr is None or not any(match(n) for n, _, _ in tr.kernels):
        return None
    return tr.device_us(match) / 1e3 / tr.frames


def share_of_peak(run, work: dict, device_s_per_frame: Optional[float]) -> Optional[float]:
    """100 x the bound's time over the measured time, per frame."""
    peak = peaks(run.device_kind)
    if peak is None or not device_s_per_frame:
        return None
    return 100.0 * bound_s(work, peak) / device_s_per_frame


def idle_share(run) -> Optional[float]:
    tr = run.trace
    if tr is None or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s() / ((tr.t1_us - tr.t0_us) / 1e6))


def mfu(run, work_per_unit: dict) -> Optional[float]:
    """The whole unit's share of the peak: its least time over the traced
    window's time per unit."""
    tr = run.trace
    if tr is None or not tr.units:
        return None
    per_frame = {k: v / run.window.frames_per_unit for k, v in work_per_unit.items()}
    return share_of_peak(run, per_frame, (tr.t1_us - tr.t0_us) / 1e6 / tr.frames)
