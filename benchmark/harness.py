"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json``, the timed window, the profiler trace and its reduction,
the device record and the result line.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); the mix names its driver
(``drivers/<driver>.py``, the entry the window calls) and the work count
(``work/<driver>.py``); ``cells/<cell>.json`` holds the cell's correctness
limits; each metric is read by ``metrics/<metric>.py``. Nothing here knows a
cell, a configuration or a metric by name.
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that a run of the port may not load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "thr3ed_atom_tpu")
GAP_MIN_US = 20.0  # idle gaps shorter than this are launch spacing, not named


def log(what: str, since: float) -> float:
    """Print what took how long to standard error; returns the time now."""
    now = time.perf_counter()
    print(f"bench: {what} {now - since:.3f} s", file=sys.stderr, flush=True)
    return now


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """A workload of BENCHMARK.json with its files loaded."""

    name: str
    spec: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def driver_name(self) -> str:
        return self.traffic["driver"]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[Dict[str, Any]] = None) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    specs = {w["name"]: w for w in bench["workloads"]}
    if name not in specs:
        raise KeyError(f"no workload '{name}' in BENCHMARK.json")
    spec = specs[name]
    return Cell(
        name=name, spec=spec,
        config=load_json(HERE / "configs" / f"{spec['config']}.json"),
        traffic=load_json(HERE / "traffic" / f"{spec['traffic']}.json"),
        limits=load_json(HERE / "cells" / f"{name}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def load_driver(driver: str):
    return load_module(HERE / "drivers" / f"{driver}.py", f"bench_driver_{driver}")


def load_work(driver: str):
    return load_module(HERE / "work" / f"{driver}.py", f"bench_work_{driver}")


def load_reader(metric: str):
    return load_module(HERE / "metrics" / f"{metric}.py",
                       "bench_metric_" + metric.replace(".", "_"))


# ------------------------------------------------------------------ the window


@dataclass
class Window:
    """What one measured window saw: host seconds, units completed, frames
    per unit, each unit's device-ordered time (CUDA events recorded after
    each unit) and the host's enqueue span of each call."""

    seconds: float = 0.0
    units: int = 0
    frames_per_unit: int = 1
    unit_ms: List[float] = field(default_factory=list)
    enqueue_ms: List[float] = field(default_factory=list)


def run_window(torch, driver, seconds: float, max_units: Optional[int] = None) -> Window:
    """Call ``driver.run_unit()`` in a closed loop until ``seconds`` of host
    time have passed (or ``max_units`` ran), then wait for the device. The
    window runs from a synchronized start to the device's end of the last
    unit."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    ends = []
    win = Window(frames_per_unit=int(getattr(driver, "frames_per_unit", 1)))
    t0 = time.perf_counter()
    start.record()
    while True:
        h0 = time.perf_counter()
        driver.run_unit()
        win.enqueue_ms.append((time.perf_counter() - h0) * 1e3)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        win.units += 1
        if time.perf_counter() - t0 >= seconds or (max_units and win.units >= max_units):
            break
    torch.cuda.synchronize()
    win.seconds = time.perf_counter() - t0
    prev = start
    for ev in ends:
        win.unit_ms.append(prev.elapsed_time(ev))
        prev = ev
    return win


# ------------------------------------------------------------------- the trace


@dataclass
class Trace:
    """The device's kernels and the host's ops over a profiled window."""

    units: int
    frames_per_unit: int
    kernels: List[Tuple[str, float, float]]  # (name, start us, end us)
    host: List[Tuple[str, float, float]]
    t0_us: float
    t1_us: float

    @property
    def frames(self) -> int:
        return self.units * self.frames_per_unit

    def device_us(self, match=None) -> float:
        """Summed kernel time of the kernels whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.kernels if match is None or match(n))

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def breakdown(self, top: int = 10) -> Dict[str, List[List[Any]]]:
        by_name: Dict[str, float] = {}
        for n, s, e in self.kernels:
            by_name[n[:96]] = by_name.get(n[:96], 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps: Dict[str, float] = {}
        busy = self.busy_intervals()
        edges = [(self.t0_us, busy[0][0] if busy else self.t1_us)]
        edges += [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        if busy:
            edges.append((busy[-1][1], self.t1_us))
        # each gap is named by the innermost host op running at its middle:
        # sweep the gaps in time order over the host ops sorted by start
        host = sorted(self.host, key=lambda h: h[1])
        active, i = [], 0
        for a, b in edges:
            if b - a < GAP_MIN_US:
                continue
            mid = 0.5 * (a + b)
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[2] >= mid]
            name = min(active, key=lambda h: h[2] - h[1])[0] if active else "host idle"
            gaps[name[:96]] = gaps.get(name[:96], 0.0) + (b - a) / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in idle]}


def run_traced(torch, driver, units: int, seconds: float) -> Trace:
    """``units`` units of the closed loop (at most ``seconds``) under
    torch.profiler, each inside a record_function span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            pass
        t0 = time.perf_counter()
        done = 0
        while done < units and time.perf_counter() - t0 < seconds:
            with record_function("bench.unit"):
                driver.run_unit()
            done += 1
        torch.cuda.synchronize()
        with record_function("bench.window"):
            pass
    kernels, host, marks = [], [], []
    events = prof.events()
    # host annotations (record_function, the optimizer's step) are mirrored on
    # the device's timeline as ranges: they are not device work
    host_names = {e.name for e in events if e.device_type != DeviceType.CUDA}
    for e in events:
        rng = (float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if e.name not in host_names and not getattr(e, "is_user_annotation", False):
                kernels.append((e.name, *rng))
        elif e.name == "bench.window":
            marks.append(rng[0])
        elif e.name != "bench.unit":
            host.append((e.name, *rng))
    t0_us, t1_us = (min(marks), max(marks)) if len(marks) == 2 else (
        min(s for _, s, _ in kernels), max(e for _, _, e in kernels))
    kernels = [(n, max(s, t0_us), min(e, t1_us)) for n, s, e in kernels if e > t0_us and s < t1_us]
    return Trace(done, int(getattr(driver, "frames_per_unit", 1)), kernels, host, t0_us, t1_us)


# ------------------------------------------------------------------- the result


def device_record(torch, count: int) -> Dict[str, Any]:
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
           "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                        for i in range(count)))}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        rec["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        rec["power_limit_w"] = None
    return rec


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one (whole names:
    the port's package name begins with the JAX package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def quantile(values: List[float], q: float) -> float:
    """The q-quantile of all ``values`` (inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    cuts = statistics.quantiles(values, n=100, method="inclusive")
    return float(cuts[int(round(q * 100)) - 1])
