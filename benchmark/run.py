"""Run one cell of the benchmark of thr3ed_atom_tpu_torch once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the inputs from the seed, the program's objects, the cell's first
units, which the correctness check judges, and one warm unit of every shape)
counts as ``setup_s``; then the window calls the cell's driver in a closed
loop for ``--seconds`` (``--trace 1``: a short window for the host's spans,
then a profiled one). After the window the program's state is freed and the
driver's plain reference decides ``correct``. The last line of standard
output is the result's JSON object; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# build and kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(HERE))

import harness  # noqa: E402


class Context:
    """What a driver is given: the cell's configuration and traffic, the
    seed, the device, and (for the readings of the controls only) a fault to
    plant."""

    def __init__(self, cell: harness.Cell, seed: int, device: str, fault: str = ""):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.limits = cell.limits
        self.seed = int(seed)
        self.device = device
        self.fault = fault


class Record:
    """What the metric readers read."""

    def __init__(self, cell, setup_s, window, trace, work, device_kind):
        self.cell = cell
        self.setup_s = setup_s
        self.window = window
        self.trace = trace
        self.work = work
        self.device_kind = device_kind


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def judge(checks):
    """(correct, the checks as {name: {value, limit}}): every number present,
    finite and at most its limit."""
    out, ok = {}, True
    for name, value, limit in checks:
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok and bool(checks), out


def measure(cell: harness.Cell, seed: int, seconds: float, trace: bool, device: str,
            fault: str = "", t_start: float = T_START):
    """Set up, run the window, free the program's state, judge. Returns
    (result dict, checks) without printing; a CPU device runs the same
    steps with the program's plain versions (the harness's own tests)."""
    import torch

    ctx = Context(cell, seed, device, fault)
    driver = harness.load_driver(cell.driver_name).Driver(ctx)
    work = harness.load_work(cell.driver_name)
    on_card = device.startswith("cuda")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t_start
    t = harness.log("set-up", t_start)
    tr = None
    if on_card:
        win = harness.run_window(torch, driver, seconds,
                                 max_units=cell.traffic["trace_units"] if trace else None)
        if trace:
            tr = harness.run_traced(torch, driver, cell.traffic["trace_units"], seconds)
    else:
        win = harness.Window(frames_per_unit=int(getattr(driver, "frames_per_unit", 1)))
        t0 = time.perf_counter()
        for _ in range(int(cell.traffic.get("cpu_units", 1))):
            driver.run_unit()
            win.units += 1
        win.seconds = time.perf_counter() - t0
    t = harness.log("window", t)
    attempted, failed = driver.close_window()
    if on_card:
        dev_rec = harness.device_record(torch, int(cell.spec["chips"]))
    else:
        dev_rec = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    driver.release()
    correct, checks = judge(driver.judge())
    harness.log("reference and comparison", t)
    rec = Record(cell, setup_s, win, tr, work, dev_rec["kind"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = harness.load_reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct and failed == 0, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_rec}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = (tr.t1_us - tr.t0_us) / 1e6
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch

    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))  # the program's package at the checkout's root
    result = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = harness.forbidden_modules()
    if bad:
        print(f"run.py: modules loaded that the port may not use: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
