"""spans.py on hand-built traces: self time with nested spans, gaps named by
the innermost t3. span, syncs inside and outside the root spans, division
by frames, None without spans."""
from types import SimpleNamespace

import pytest

import harness
import spans


def _trace(host, kernels, units=2, frames_per_unit=1, t0=0.0, t1=1000.0):
    return harness.Trace(units, frames_per_unit, kernels, host, t0, t1)


def _run(trace):
    return SimpleNamespace(trace=trace)


# two steps of 400 us; the second's geometry holds a nested repack
HOST = [
    ("t3.step", 0.0, 400.0),
    ("t3.geometry", 10.0, 110.0),
    ("aten::add", 20.0, 30.0),
    ("t3.backward", 200.0, 350.0),
    ("cudaStreamSynchronize", 250.0, 260.0),
    ("t3.step", 500.0, 900.0),
    ("t3.geometry", 510.0, 650.0),
    ("t3.repack", 520.0, 580.0),
    ("t3.optimizer", 800.0, 890.0),
    ("cudaMemcpy", 810.0, 815.0),
    ("cudaMemcpyAsync", 820.0, 825.0),
    ("cudaDeviceSynchronize", 950.0, 960.0),  # after the last step
]
KERNELS = [
    ("k", 0.0, 50.0),
    ("k", 40.0, 100.0),   # merges with the first: busy 0-100
    ("k", 100.0, 210.0),  # 0 us gap: not a gap
    ("k", 300.0, 310.0),  # gap 210-300 at 255: t3.backward
    ("k", 315.0, 460.0),  # 5 us gap: under GAP_MIN_US
    ("k", 540.0, 600.0),  # gap 460-540 at 500: t3.step (its start)
    ("k", 700.0, 980.0),  # gap 600-700 at 650: the geometry's end
    # window end 980-1000 at 990: under no span
]


def test_self_time_subtracts_nested_spans():
    got = spans.self_us(spans.spans_of(_trace(HOST, KERNELS)))
    assert got == {"t3.step": 800.0 - 100.0 - 150.0 - 140.0 - 90.0,
                   "t3.geometry": 100.0 + 140.0 - 60.0, "t3.repack": 60.0,
                   "t3.backward": 150.0, "t3.optimizer": 90.0}


def test_gaps_take_the_innermost_span_at_their_middle():
    tr = _trace(HOST, KERNELS)
    assert spans.idle_us(tr, spans.spans_of(tr)) == {
        "t3.backward": 90.0, "t3.step": 80.0, "t3.geometry": 100.0, "": 20.0}


def test_a_gap_under_no_span_is_left_unnamed():
    tr = _trace([("t3.step", 0.0, 100.0), ("aten::mul", 150.0, 250.0)],
                [("k", 0.0, 100.0), ("k", 300.0, 1000.0)])
    assert spans.idle_us(tr, spans.spans_of(tr)) == {"": 200.0}
    assert spans.idle_ms(_run(tr), "step") == 0.0


def test_syncs_count_inside_the_root_spans_only():
    tr = _trace(HOST, KERNELS)
    assert spans.sync_count(tr, spans.spans_of(tr)) == 2  # not the Async copy, not 950
    path = _trace([("t3.path", 0.0, 100.0), ("cudaEventSynchronize", 50.0, 60.0),
                   ("cudaStreamSynchronize", 120.0, 130.0)], [("k", 0.0, 1000.0)])
    assert spans.sync_count(path, spans.spans_of(path)) == 1


def test_readers_divide_by_frames():
    steps = _run(_trace(HOST, KERNELS))
    assert steps.trace.frames == 2
    assert spans.host_ms(steps, "geometry") == pytest.approx(0.180 / 2)
    assert spans.host_ms(steps, "repack") == pytest.approx(0.060 / 2)
    assert spans.idle_ms(steps, "backward") == pytest.approx(0.090 / 2)
    assert spans.syncs(steps) == 1.0
    frames = _run(_trace(HOST, KERNELS, units=1, frames_per_unit=4))
    assert spans.host_ms(frames, "geometry") == pytest.approx(0.180 / 4)
    assert spans.syncs(frames) == 0.5
    assert spans.host_ms(steps, "warp") == 0.0  # spans, but none of this phase


def test_readers_give_none_without_spans():
    bare = _run(_trace([("aten::add", 0.0, 10.0), ("cudaStreamSynchronize", 5.0, 6.0)],
                       KERNELS))
    for read in (lambda r: spans.host_ms(r, "repack"), lambda r: spans.idle_ms(r, "repack"),
                 spans.syncs):
        assert read(bare) is None
        assert read(_run(None)) is None


def test_each_span_metric_reads_through_its_file():
    """Every metric file that reads spans returns the helper's value."""
    run = _run(_trace(HOST, KERNELS))
    names = [p.stem for p in (harness.HERE / "metrics").glob("*.py")
             if p.stem.split(".")[0] in ("host_ms", "idle_ms", "syncs")]
    assert len(names) == 22
    for name in names:
        kind, *phase = name.split(".")[:-1]
        want = spans.syncs(run) if kind == "syncs" else getattr(spans, kind)(run, phase[0])
        assert harness.load_reader(name).read(run) == want
