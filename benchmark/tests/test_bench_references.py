"""Each cell's run on the CPU at a small size, with the program's plain
versions: the program comes out correct against the plain reference under
the cell's limits, and the control (the reference in the precision below
the configuration's, in the program's place) and each fault the cell can
have, planted under the timed path, come out not correct."""
import pytest
import torch

import harness
import run

SMALL = {
    "train_gnomonic_256": (
        dict(grid_dims=[8, 8, 8]),
        dict(scene_size=6, view_size=16, view_focal=17.6, target_samples=16, cpu_units=1),
        ("control", "half_batch", "frozen")),
    "diffusion_train_112": (
        dict(model_channels=8, batch_size=2),
        dict(scene_size=10, cpu_units=1),
        ("control", "half_batch", "frozen")),
    "render_path_256": (
        dict(grid_dims=[12, 12, 12]),
        dict(num_frames=4, stored_size=20, stored_focal=22.0, judged_frames=2, cpu_units=1),
        ("control", "altered")),
}


def _measure(name, fault, bench=None, small=None):
    torch.manual_seed(0)
    cell = harness.load_cell(name, bench)
    config, traffic, _ = small or SMALL[name]
    cell.config = dict(cell.config, **config)
    cell.traffic = dict(cell.traffic, **traffic)
    return run.measure(cell, 2 ** 31 + 11, 1.0, False, "cpu", fault=fault)


CASES = [(name, fault) for name, (_, _, faults) in SMALL.items() for fault in ("",) + faults]


@pytest.mark.parametrize("name,fault", CASES)
def test_cell_against_its_reference(name, fault):
    with torch.random.fork_rng():
        torch.set_num_threads(2)
        result = _measure(name, fault)
    assert result["correct"] is (fault == ""), result["checks"]


def test_ray_batch_step_against_its_reference():
    """The ray-batch step (a cell not in BENCHMARK.json yet: its control does
    not separate from sound runs on the chip) agrees with its reference."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    bench["workloads"].append({"name": "train_raybatch_256", "config": "relu_field_256",
                               "traffic": "raybatch_stage4", "chips": 1, "why": "-"})
    small = (dict(grid_dims=[12, 12, 12], ray_batch_size=256, train_num_samples_per_ray=48,
                  fast_topk=12),
             dict(scene_size=8, view_size=20, view_focal=22.0, target_samples=24, cpu_units=1),
             ())
    with torch.random.fork_rng():
        torch.set_num_threads(2)
        result = _measure("train_raybatch_256", "", bench, small)
    assert result["correct"] is True, result["checks"]
