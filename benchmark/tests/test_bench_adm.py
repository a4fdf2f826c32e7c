"""The ADM cell (``diffusion_train_adm64``): its spec entries and
configuration, its work counts against a hand count at a small shape, its
readers on a made-up trace, and the cell on the CPU at a small size against
its reference, with its control and faults coming out not correct."""
import json
from pathlib import Path

import pytest
import torch

import harness
import run
from reference import adm_plain

BENCH = Path(__file__).resolve().parents[1]
CELL = "diffusion_train_adm64"
# width 8 in heads of 8 on 16^3 crops of a 32^3 scene, two crops; the loss
# scale starts where fp16 holds the gradients of so few voxels (each
# element's share of the mean loss is ~256x that at 64^3)
SMALL = (dict(model_channels=8, num_head_channels=8, batch_size=2, initial_lg_loss_scale=12.0),
         dict(scene_size=32, cpu_units=1))
# fp16's error in the whole gradient is ~10x larger at this size than at
# the cell's (the CPU's readings: program 0.0138, bf16 control 0.0617 ..
# 0.0847); the other limits are the cell's
SMALL_GRAD_GAP = 0.03


@pytest.fixture(scope="module")
def bench():
    with open(BENCH.parent / "BENCHMARK.json") as f:
        return json.load(f)


def test_the_cell_and_its_configuration(bench):
    cell = harness.load_cell(CELL, bench)
    assert cell.spec["chips"] == 1 and cell.driver_name == "adm_train"
    config = cell.config
    assert (config["model_channels"], config["num_res_blocks"], config["channel_mult"]) == (
        192, 3, [1, 2, 3, 4])
    assert config["attention_resolutions"] == [2, 4, 8] and config["num_head_channels"] == 64
    assert config["resblock_updown"] and config["use_scale_shift_norm"] and config["learn_sigma"]
    assert (config["dropout"], config["norm_groups"], config["num_timesteps"]) == (0.1, 32, 1000)
    assert config["use_fp16"] and config["ema_rate"] == 0.9999
    assert config["reduced"] == ["class_cond", "batch_size"]
    assert set(config["reduced"]) <= set(config["assumed"])
    step_ms = next(m for m in bench["end_to_end"] if m["name"] == "step_ms")
    assert CELL in step_ms["workloads"]
    new = [m for m in bench["per_layer"] if CELL in m.get("workloads", [])]
    assert {m["name"] for m in new} == {
        "attn_ms.adm", "attn_roofline.adm", "conv_ms.adm", "mfu.adm", "idle_share.adm",
        "span_host_ms.forward.adm", "span_host_ms.backward.adm", "span_host_ms.optimizer.adm",
        "span_idle_ms.forward.adm", "span_idle_ms.backward.adm", "span_idle_ms.optimizer.adm",
        "span_syncs.adm", "skips.adm"}
    assert all(m["workloads"] == [CELL] and m["moves"] == "step_ms" for m in new)
    assert set(cell.limits) == {"loss_gap", "grad_gap", "grad_median_gap", "change_gap", "ema_gap",
                                "skipped_steps"}


def test_work_against_a_counted_forward():
    """work/adm_train.py's convolutions and attention blocks equal those of
    the reference UNet's forward (counted from their shapes by hooks), at
    width 8 on 16^3 crops."""
    work = harness.load_work("adm_train")
    with open(BENCH / "configs" / "adm64_unet3d.json") as f:
        config = dict(json.load(f), model_channels=8, num_head_channels=8, batch_size=2)
    side = 16
    net = adm_plain.UNet(28, 8, tuple(config["channel_mult"]), 3, (2, 4, 8), 8, 32, 0.1)
    convs, attns = [], []

    def conv_hook(module, inputs, output):
        cin, k = module.weight.shape[1], module.weight.shape[2]
        convs.append(2.0 * cin * output.shape[1] * k ** 3 * output[0, 0].numel())

    def attn_hook(module, inputs, output):
        attns.append((output[0, 0].numel(), output.shape[1]))

    for m in net.modules():
        if isinstance(m, adm_plain.Conv):
            m.register_forward_hook(conv_hook)
        if isinstance(m, adm_plain.Attention):
            m.register_forward_hook(attn_hook)
    with torch.no_grad():
        net(torch.zeros(1, side, side, side, 28), torch.zeros(1, dtype=torch.long))
    conv, proj, products = work.forward_flops(config, side)
    assert conv == sum(convs) and len(attns) == 22
    assert work.layers(config, side)[1] == attns
    assert proj == sum(8.0 * n * c * c for n, c in attns)
    assert products == sum(4.0 * n * n * c for n, c in attns)
    traffic = {"scene_size": 32}
    assert work.crop_side(config, traffic) == side
    first = 2.0 * 28 * 8 * 27 * side ** 3
    assert work.step(config, traffic)["flops"] == 2 * (3 * (conv + proj + products) - first)
    assert work.attention(config, traffic)["flops"] == 2 * 3 * products


class _Run:
    def __init__(self, trace, cell, work, kind="NVIDIA H100 80GB HBM3"):
        self.trace, self.cell, self.work, self.device_kind = trace, cell, work, kind
        self.window = harness.Window(units=2)


def _trace(spans=True):
    kernels = [("flash_fwd_kernel<Flash_fwd_kernel_traits<64>>", 0.0, 3000.0),
               ("flash_bwd_convert_dq_kernel", 3000.0, 3500.0),
               ("sm90_xmma_fprop_implicit_gemm_f16f16_f16f32_f32", 4000.0, 9000.0),
               ("void at::native::vectorized_elementwise_kernel<4, conv>", 9000.0, 9100.0),
               ("sm90_xmma_wgrad_implicit_gemm_f16f16", 9500.0, 10000.0)]
    host = [("t3.step", 0.0, 10000.0), ("t3.forward", 0.0, 5000.0),
            ("t3.backward", 5000.0, 9400.0), ("t3.optimizer", 9400.0, 10000.0),
            ("t3.skip", 9500.0, 9600.0), ("cudaStreamSynchronize", 9450.0, 9490.0)]
    return harness.Trace(2, 1, kernels, host if spans else [], 0.0, 10000.0)


def test_readers_on_a_made_up_trace():
    """The new readers per step on a trace of two steps; the span readers
    give nothing where the trace holds no t3. span (a program without
    them), and a device the peaks lack gives no share."""
    cell = harness.load_cell(CELL)
    work = harness.load_work("adm_train")
    run_ = _Run(_trace(), cell, work)

    def read(name, r=run_):
        return harness.load_reader(name).read(r)

    assert read("attn_ms.adm") == pytest.approx(3.5 / 2)
    assert read("conv_ms.adm") == pytest.approx(5.5 / 2)
    assert read("skips.adm") == 0.5 and read("span_syncs.adm") == 0.5
    assert read("idle_share.adm") == pytest.approx(100.0 * 900.0 / 10000.0)
    assert read("span_host_ms.backward.adm") == pytest.approx(4.4 / 2)
    attn = work.attention(cell.config, cell.traffic)["flops"] / 989e12
    assert read("attn_roofline.adm") == pytest.approx(100.0 * attn / 1.75e-3)
    step = work.step(cell.config, cell.traffic)["flops"] / 989e12
    assert read("mfu.adm") == pytest.approx(100.0 * step / 5e-3)
    bare = _Run(_trace(spans=False), cell, work)
    for name in ("skips.adm", "span_syncs.adm", "span_host_ms.forward.adm",
                 "span_idle_ms.optimizer.adm"):
        assert read(name, bare) is None
    assert read("mfu.adm", _Run(_trace(), cell, work, kind="cpu")) is None


def test_span_readers_read_through_spans():
    """The span_* readers (named apart from the host_ms / idle_ms / syncs
    files, which test_bench_spans.py counts) return spans.py's values."""
    import spans
    cell = harness.load_cell(CELL)
    run_ = _Run(_trace(), cell, harness.load_work("adm_train"))
    assert harness.load_reader("span_syncs.adm").read(run_) == spans.syncs(run_)
    for kind in ("host_ms", "idle_ms"):
        for phase in ("forward", "backward", "optimizer"):
            got = harness.load_reader(f"span_{kind}.{phase}.adm").read(run_)
            assert got == getattr(spans, kind)(run_, phase), (kind, phase)


def _measure(fault, monkeypatch):
    from thr3ed_atom_tpu_torch.diffusion import model
    monkeypatch.setattr(model, "INITIAL_LG_LOSS_SCALE", SMALL[0]["initial_lg_loss_scale"])
    torch.manual_seed(0)
    cell = harness.load_cell(CELL)
    config, traffic = SMALL
    cell.config = dict(cell.config, **config)
    cell.traffic = dict(cell.traffic, **traffic)
    cell.limits = dict(cell.limits, grad_gap=SMALL_GRAD_GAP)
    return run.measure(cell, 2 ** 31 + 11, 1.0, False, "cpu", fault=fault)


@pytest.mark.parametrize("fault", ["", "control", "half_batch", "frozen", "ema_rate"])
def test_cell_against_its_reference(fault, monkeypatch):
    with torch.random.fork_rng():
        torch.set_num_threads(2)
        result = _measure(fault, monkeypatch)
    assert result["correct"] is (fault == ""), result["checks"]
