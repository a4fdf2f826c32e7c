"""The port's tools (thr3ed_atom_tpu_torch/tools/) against the repository's
JAX tools (tools/make_synthetic_dataset.py, run_quality_gates.py,
run_gate_battery.py) on the CPU, at tiny sizes: the blob scene bit for bit,
the dataset each writes, and the gate batteries' names, thresholds, JSON keys
and dB values. The JAX tools run unchanged; only their size constants are set
on the imported modules, and their kernels run in interpret mode as the JAX
package's own tests run them."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_gnomonic import _one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TINY_GRID, TINY_IMAGE = 16, 24
DB_TOL = 0.05  # dB; the port's renders agree with JAX's to f32 round-off


@pytest.fixture(scope="module")
def jax_tools():
    """The JAX tools as modules (their own directory on sys.path, as they
    import each other)."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import make_synthetic_dataset
        import run_gate_battery
        import run_quality_gates
    finally:
        sys.path.remove(str(REPO / "tools"))
    return make_synthetic_dataset, run_quality_gates, run_gate_battery


@pytest.fixture(scope="module")
def gate_runs(jax_tools, tmp_path_factory):
    """Both gate batteries of both packages at TINY_GRID^3, TINY_IMAGE^2: the
    JAX tools' JSON artifacts (written by their main) and the port's dicts.
    The JAX battery refuses a CPU backend (its kernels would take hours at
    full size), so its one backend query is answered "tpu"; every other
    caller, the JAX package's interpret-mode choice among them, still sees
    the CPU."""
    import jax

    _, jq, jb = jax_tools
    from thr3ed_atom_tpu_torch.tools import run_gate_battery as pb
    from thr3ed_atom_tpu_torch.tools import run_quality_gates as pq

    out = tmp_path_factory.mktemp("gates")
    saved = {m: (m.GRID_SIZE, m.IMAGE_SIZE) for m in (jq, jb)}
    real_backend, argv = jax.default_backend, sys.argv

    def backend():
        caller = sys._getframe(1).f_globals.get("__name__")
        return "tpu" if caller == jb.__name__ else real_backend()

    try:
        for m in (jq, jb):
            m.GRID_SIZE, m.IMAGE_SIZE = TINY_GRID, TINY_IMAGE
        jax.default_backend = backend
        sys.argv = ["run_quality_gates.py", "-o", str(out / "qg.json")]
        jq.main()
        sys.argv = ["run_gate_battery.py", "--out", str(out / "gb.json")]
        assert jb.main() == 1  # gates fail at this size
    finally:
        jax.default_backend, sys.argv = real_backend, argv
        for m, (g, i) in saved.items():
            m.GRID_SIZE, m.IMAGE_SIZE = g, i
    quiet = lambda line: None  # noqa: E731
    return dict(
        jax_quality=json.loads((out / "qg.json").read_text()),
        jax_battery=json.loads((out / "gb.json").read_text()),
        port_quality=pq.run_gates(TINY_GRID, TINY_IMAGE, device="cpu", echo=quiet),
        port_battery=pb.run_battery(TINY_GRID, TINY_IMAGE, device="cpu", echo=quiet),
    )


@pytest.mark.parametrize("grid_size", [16, 24])
@pytest.mark.parametrize("seed", [3, 7])
@pytest.mark.parametrize("converged", [False, True])
def test_blob_scene_is_bit_equal(jax_tools, grid_size, seed, converged):
    """make_blob_scene: the same arrays bit for bit and the same grid config
    as the JAX tool's."""
    from thr3ed_atom_tpu_torch.tools.make_synthetic_dataset import make_blob_scene

    want = jax_tools[0].make_blob_scene(grid_size=grid_size, seed=seed, converged=converged)
    got = make_blob_scene(grid_size=grid_size, seed=seed, converged=converged, device="cpu")
    for a, b in ((got.densities, want.densities), (got.features, want.features)):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tuple(got.voxel_size) == tuple(want.voxel_size)
    for name in ("grid_location", "density_preactivation", "density_postactivation",
                 "feature_preactivation", "feature_postactivation",
                 "expected_density_scale", "radiance_transfer_function"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("procedure", ["render_sh_voxel_grid", "render_sh_voxel_grid_fast"])
def test_dataset_tools_write_the_same_dataset(jax_tools, tmp_path, procedure):
    """Both tools' main at grid 16, 24 x 24, 2 + 1 views, 64 samples: the
    same files; camera JSONs within 1e-6, the ground-truth grids equal, the
    decoded PNGs within one 8-bit level."""
    from thr3ed_atom_tpu_torch.tools import make_synthetic_dataset as port

    args = ["--num_train", "2", "--num_test", "1", "--image_size", str(TINY_IMAGE),
            "--grid_size", str(TINY_GRID), "--gt_samples_per_ray", "64",
            "--render_procedure", procedure]
    jax_tools[0].main.main(["-o", str(tmp_path / "jax")] + args, standalone_mode=False)
    assert port.main(["-o", str(tmp_path / "port")] + args, device="cpu") == 0
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*"))
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*"))
    assert len([f for f in files if f.suffix == ".png"]) == 3
    for split in ("train", "test"):
        want = json.loads((tmp_path / "jax" / f"{split}_camera_params.json").read_text())
        got = json.loads((tmp_path / "port" / f"{split}_camera_params.json").read_text())
        assert list(got) == list(want)
        for name in want:
            assert got[name]["intrinsic"] == want[name]["intrinsic"]
            for key in ("rotation", "translation"):
                np.testing.assert_allclose(got[name]["extrinsic"][key],
                                           want[name]["extrinsic"][key], atol=1e-6)
            png = Path(split) / name
            a = np.asarray(Image.open(tmp_path / "jax" / png), np.int16)
            b = np.asarray(Image.open(tmp_path / "port" / png), np.int16)
            assert a.shape == b.shape == (TINY_IMAGE, TINY_IMAGE, 3)
            assert np.abs(a - b).max() <= 1, (png, np.abs(a - b).max())
            assert a.std() > 0  # the scene is in view
    with np.load(tmp_path / "jax" / "ground_truth_grid.npz") as want, \
            np.load(tmp_path / "port" / "ground_truth_grid.npz") as got:
        assert sorted(got.files) == sorted(want.files) == ["densities", "features"]
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k])


def _gate_rules(gates, threshold_key):
    """Per gate: its keys and its threshold (None for a pass-only entry)."""
    return {name: (sorted(g), g.get(threshold_key)) for name, g in gates.items()}


@pytest.mark.parametrize("tool,threshold_key,db_key", [
    ("quality", "gate", "dB"), ("battery", "threshold", "db")])
def test_gate_tools_keep_the_jax_gates(gate_runs, tool, threshold_key, db_key):
    """The same JSON keys, gates in the same order with the same keys and
    thresholds (the battery's monotone gates: the previous rung's dB,
    within DB_TOL), and gnomonic P2, bricked K2 and the sharp scene within
    DB_TOL of the JAX tool's dB."""
    want, got = gate_runs[f"jax_{tool}"], gate_runs[f"port_{tool}"]
    assert sorted(got) == sorted(want)
    assert list(got["gates"]) == list(want["gates"])
    rules_w = _gate_rules(want["gates"], threshold_key)
    rules_g = _gate_rules(got["gates"], threshold_key)
    for name, (keys, threshold) in rules_w.items():
        assert rules_g[name][0] == keys, name
        if threshold is None:
            assert rules_g[name][1] is None, name
        else:
            assert rules_g[name][1] == pytest.approx(threshold, abs=DB_TOL), name
    k2 = "bricked_K2_vs_exact1024" if tool == "quality" else "bricked_K2_monotone"
    for name in ("gnomonic_P2_vs_exact1024", k2, "gnomonic_P2_sharp_scene"):
        assert abs(got["gates"][name][db_key] - want["gates"][name][db_key]) <= DB_TOL, name
    if tool == "battery":
        assert (got["grid"], got["image"], got["poses"]) == (
            want["grid"], want["image"], want["poses"])


@pytest.mark.parametrize("tool", ["make_synthetic_dataset", "run_quality_gates",
                                  "run_gate_battery"])
def test_tools_refuse_main_without_a_card(tmp_path, monkeypatch, capsys, tool):
    """Without a CUDA card each tool's main writes nothing and returns 2."""
    import importlib

    module = importlib.import_module(f"thr3ed_atom_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    argv = {"make_synthetic_dataset": ["-o", str(tmp_path / "data")],
            "run_quality_gates": ["-o", str(tmp_path / "qg.json")],
            "run_gate_battery": ["--out", str(tmp_path / "gb.json")]}[tool]
    assert module.main(argv) == 2
    assert "CUDA card" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())
