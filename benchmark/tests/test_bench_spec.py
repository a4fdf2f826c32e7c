"""BENCHMARK.json against the benchmark's contract, and every file it names."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LAYERS = {"entry", "train step and PyTorch ops", "kernels", "3inFusion", "device"}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_lines(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names))


def test_configs_files_and_reductions(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["source"].startswith("https://")
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("benchmark/")
        with open(path) as f:
            data = json.load(f)
        assert data["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not re.search(r"(_dim|_rank|channels|hidden|width|size_per)$", key), key


def test_cells_name_files_that_exist(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        with open(BENCH / "traffic" / f"{w['traffic']}.json") as f:
            traffic = json.load(f)
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        assert (BENCH / "work" / f"{traffic['driver']}.py").is_file()
        with open(BENCH / "cells" / f"{w['name']}.json") as f:
            assert json.load(f)["limits"]


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["layer"] in LAYERS and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        reported = [m for m in bench["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])


def test_run_without_a_card_prints_no_result(tmp_path):
    """A run without a CUDA card exits non-zero and prints no result line."""
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "train_gnomonic_256", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark, no result."""
    subprocess.run(["cp", "-r", str(BENCH), str(tmp_path / "benchmark")], check=True)
    subprocess.run(["cp", str(ROOT / "BENCHMARK.json"), str(tmp_path)], check=True)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "train_gnomonic_256",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
