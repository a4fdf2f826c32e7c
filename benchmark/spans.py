"""The program's own spans in a traced window: the ``t3.`` ranges that
``thr3ed_atom_tpu_torch.utils.profiling.span`` opens while a profiler
records, read from ``harness.Trace.host`` on the profiler's clock, so they
line up with the kernels and runtime calls without conversion. The readers
give a phase's value per unit (per step in training, per frame in the
render: ``Trace.frames``) and None when the trace holds no ``t3.`` span, as
a program without spans gives."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from harness import GAP_MIN_US, Trace

PREFIX = "t3."
ROOTS = ("t3.step", "t3.path")
# runtime calls after which the host has waited for the device
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})

Span = Tuple[str, float, float]


def spans_of(trace: Optional[Trace]) -> List[Span]:
    """The trace's t3. spans by start, an enclosing span before the spans
    it holds."""
    if trace is None:
        return []
    return sorted((h for h in trace.host if h[0].startswith(PREFIX)),
                  key=lambda h: (h[1], -h[2]))


def self_us(spans: List[Span]) -> Dict[str, float]:
    """Each span name's summed duration less the parts that the t3. spans
    nested in it cover (spans of one thread nest)."""
    out: Dict[str, float] = {}
    stack: List[Span] = []
    for name, s, e in spans:
        while stack and stack[-1][2] <= s:
            stack.pop()
        out[name] = out.get(name, 0.0) + (e - s)
        if stack:
            parent = stack[-1]
            out[parent[0]] -= min(e, parent[2]) - s
        stack.append((name, s, e))
    return out


def idle_us(trace: Trace, spans: List[Span]) -> Dict[str, float]:
    """The window's device gaps of at least ``GAP_MIN_US`` (between merged
    kernel intervals and at the window's two ends, as ``Trace.breakdown``
    cuts them), summed by the innermost t3. span active at each gap's
    middle; "" sums the gaps under no span."""
    busy = trace.busy_intervals()
    edges = [(trace.t0_us, busy[0][0] if busy else trace.t1_us)]
    edges += [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy:
        edges.append((busy[-1][1], trace.t1_us))
    out: Dict[str, float] = {}
    active: List[Span] = []
    i = 0
    for a, b in edges:
        if b - a < GAP_MIN_US:
            continue
        mid = 0.5 * (a + b)
        while i < len(spans) and spans[i][1] <= mid:
            active.append(spans[i])
            i += 1
        active = [h for h in active if h[2] >= mid]
        name = min(active, key=lambda h: h[2] - h[1])[0] if active else ""
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def sync_count(trace: Trace, spans: List[Span]) -> int:
    """Host syncs that start inside a root span (t3.step or t3.path), from
    any thread; the harness's own synchronize after the window is outside."""
    roots = [(s, e) for n, s, e in spans if n in ROOTS]
    return sum(1 for n, s, _ in trace.host
               if n in SYNCS and any(a <= s <= b for a, b in roots))


def _per_unit(run, value) -> Optional[float]:
    tr = run.trace
    spans = spans_of(tr)
    if not spans or not tr.frames:
        return None
    return value(tr, spans) / tr.frames


def host_ms(run, phase: str) -> Optional[float]:
    """The host's self time in ``t3.<phase>`` spans, ms per unit."""
    return _per_unit(run, lambda tr, spans: self_us(spans).get(PREFIX + phase, 0.0) / 1e3)


def idle_ms(run, phase: str) -> Optional[float]:
    """The device's idle time in gaps named by ``t3.<phase>``, ms per unit."""
    return _per_unit(run, lambda tr, spans: idle_us(tr, spans).get(PREFIX + phase, 0.0) / 1e3)


def syncs(run) -> Optional[float]:
    """Host syncs inside the root spans per unit."""
    return _per_unit(run, sync_count)
