"""The readings that a cell's correctness limits are set from (not run by
the benchmark's own runs): for each seed, set-up with its judged units, a
few units of the window, then the comparison with the plain reference,
with the program as it is or with a fault planted (``--fault``: ``control``,
the reference in the precision below the configuration's in the program's
place; ``half_batch``, ``frozen``, ``altered``: see the cell's driver). One
JSON line a seed; the seeds share one process.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 [--fault control]
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import harness  # noqa: E402
from run import Context  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--fault", default="")
    p.add_argument("--units", type=int, default=1, help="window units before the comparison")
    args = p.parse_args(argv)
    import torch

    cell = harness.load_cell(args.workload)
    driver_mod = harness.load_driver(cell.driver_name)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        driver = driver_mod.Driver(Context(cell, seed, "cuda", args.fault))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(args.units):
            driver.run_unit()
        attempted, failed = driver.close_window()
        driver.release()
        t2 = time.perf_counter()
        checks = driver.judge()
        t3 = time.perf_counter()
        print(json.dumps({"seed": seed, "fault": args.fault or "program",
                          **{name: value for name, value, _ in checks},
                          "failed": failed, "setup_s": t1 - t0, "units_s": t2 - t1,
                          "reference_s": t3 - t2}), flush=True)
        del driver
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
