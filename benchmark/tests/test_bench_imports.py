"""What a run and the references load."""
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "thr3ed_atom_tpu")

RUN_TINY = """
import sys
sys.path[:0] = [{root!r}, {bench!r}]
import torch
import harness, run
cell = harness.load_cell("render_path_256")
cell.config = dict(cell.config, grid_dims=[8, 8, 8])
cell.traffic = dict(cell.traffic, num_frames=3, stored_size=16, stored_focal=17.6,
                    judged_frames=1, cpu_units=1)
run.measure(cell, 7, 1.0, False, "cpu")
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REFERENCE = """
import sys
sys.path[:0] = [{bench!r}]
from reference import gnomonic_plain, scene, unet_plain, volume_plain
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _tops(code: str):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(BENCH.parent),
                                                              bench=str(BENCH))],
                         capture_output=True, text=True, timeout=600, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package():
    tops = _tops(RUN_TINY)
    assert "thr3ed_atom_tpu_torch" in tops
    assert not tops & set(FORBIDDEN)


def test_the_references_load_nothing_of_the_program():
    tops = _tops(REFERENCE)
    assert not tops & set(FORBIDDEN + ("thr3ed_atom_tpu_torch",))
