"""The traced stretch of a ``--trace 1`` run, and what is read from it.

The stretch follows the measured window in the same process, on the same
engine, driver and traffic, so that the window's own spans and rates stay
free of the profiler.  ``torch.profiler`` records the host and the card;
64 spin kernels open the trace (a trace taken late in a process has been
seen to lose its first device records), then a ``record_function`` marker
holds the stretch, which ends after the card has drained.  Nothing is
written to disk.

From the trace: every device operation inside the marker (kernels,
memsets and copies) with its start and end, the seconds in which at least
one ran (``busy_s``), the marker's length (``window_s``), the device
operations that took the most time by name, and the idle time on the card
by what the host's main thread was doing at the middle of each gap.  And
the engine's own spans (``mfi.*``, the port's ``utils/trace.SPANS``,
which it opens while a profiler records) on the marker's thread inside
the stretch, for the per-layer readers: host ms a pair by span, and the
card's idle time by the innermost span open.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

MARK = "portbench.stretch"
SPAN_PREFIX = "mfi."
SPIN_KERNELS = 64
TOP = 10


@dataclasses.dataclass
class TraceView:
    rows: List[Tuple[str, float, float]]    # (name, start us, end us)
    window_us: float
    busy_us: float
    pairs: int
    idle_by_host: List[Tuple[str, float]]   # (host op, idle us), longest
    host_ops: List[Tuple[str, int, float]]  # (host op, calls, us)
    # the engine's spans inside the stretch, (name, start us, end us), and
    # the stretch's start (us, the clock of `rows`)
    spans: List[Tuple[str, float, float]] = dataclasses.field(
        default_factory=list)
    start_us: float = 0.0

    def matching(self, names: Sequence[str]) -> List[Tuple[str, float, float]]:
        """The rows whose name holds one of `names`."""
        return [r for r in self.rows if any(n in r[0] for n in names)]

    def ms_per_pair(self, names: Sequence[str]) -> Optional[float]:
        """Device ms a pair of the rows matching `names`; None where no
        row matches."""
        rows = self.matching(names)
        if not rows or not self.pairs:
            return None
        return sum(e - s for _, s, e in rows) / self.pairs / 1e3

    def roofline(self, names: Sequence[str], least_s_a_pair: float
                 ) -> Optional[float]:
        """A kernel's share of its roofline (%): the least time of the
        stretch's pairs (`least_s_a_pair` each, counted from the algorithm,
        whatever launches carry it) over the device time of the rows
        matching `names`; None where no row matches."""
        rows = self.matching(names)
        if not rows or not self.pairs:
            return None
        busy_s = sum(e - s for _, s, e in rows) / 1e6
        return 100.0 * least_s_a_pair * self.pairs / busy_s

    def idle_percent(self) -> Optional[float]:
        """The share (%) of the stretch in which no kernel, memset or copy
        ran on the card; None where the trace holds no device row."""
        if not self.rows or self.window_us <= 0:
            return None
        return 100.0 * (self.window_us - self.busy_us) / self.window_us

    def span_ms_per_pair(self, names: Sequence[str],
                         within: Sequence[str] = ()) -> Optional[float]:
        """Host ms a pair inside the spans named `names` (whole names),
        each span whole, its children included; with `within`, only those
        that lie inside a span named there.  None where none opened."""
        picked = [(s, e) for n, s, e in self.spans if n in names]
        if within:
            outer = sorted((s, e) for n, s, e in self.spans if n in within)
            picked = [p for p in picked if _inside(p, outer)]
        if not picked or not self.pairs:
            return None
        return sum(e - s for s, e in picked) / self.pairs / 1e3

    def idle_within(self, names: Sequence[str]) -> Optional[float]:
        """The share (%) of the stretch in which the card ran nothing while
        a span named in `names` (whole names) was the innermost one open;
        None where none opened."""
        if self.window_us <= 0 or not any(n in names
                                          for n, _, _ in self.spans):
            return None
        idle = _gaps(_union([(s, e) for _, s, e in self.rows]),
                     self.start_us, self.start_us + self.window_us)
        held = [(s, e) for s, e, n in _innermost(self.spans) if n in names]
        return 100.0 * _overlap(idle, held) / self.window_us

    def device_ops(self) -> List[Tuple[str, float]]:
        by_name: Dict[str, float] = {}
        for name, s, e in self.rows:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name, us / 1e6] for name, us in top]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(),
                "idle_gaps": [[name, us / 1e6]
                              for name, us in self.idle_by_host[:TOP]]}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _gaps(busy: List[Tuple[float, float]], start: float,
          end: float) -> List[Tuple[float, float]]:
    """The intervals of [start, end] that `busy` (sorted, disjoint) leaves
    free."""
    edges = [start] + [x for iv in busy for x in iv] + [end]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def _inside(span: Tuple[float, float],
            outer: List[Tuple[float, float]]) -> bool:
    """Whether `span` lies inside one of `outer` (sorted, disjoint)."""
    i = bisect.bisect_right(outer, (span[0], float("inf"))) - 1
    return i >= 0 and outer[i][0] <= span[0] and span[1] <= outer[i][1]


def _innermost(spans: List[Tuple[str, float, float]]
               ) -> List[Tuple[float, float, str]]:
    """The time of one thread's nesting spans cut into pieces (start, end,
    name), in order, each named by the innermost span open in it; no
    piece where none is open.  A span that outlasts its parent is cut at
    the parent's end."""
    pieces: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []        # (end, name), outermost first
    now = float("-inf")

    def close(t):
        nonlocal now
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > now:
                pieces.append((now, end, name))
                now = end

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        close(s)
        if stack:
            if s > now:
                pieces.append((now, s, stack[-1][1]))
            e = min(e, stack[-1][0])
        stack.append((e, name))
        now = s
    close(float("inf"))
    return pieces


def _overlap(a: List[Tuple[float, float]],
             b: List[Tuple[float, float]]) -> float:
    """The length of time in both of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(events, pairs: int) -> TraceView:
    """The view of a profiler's events (``prof.events()``) around the
    marker."""
    from torch.autograd import DeviceType
    # the marker is recorded on the host and, as an annotation, on the
    # card: the host's record bounds the stretch, the card's is no work
    marks = [e for e in events
             if e.name == MARK and e.device_type == DeviceType.CPU]
    if not marks:
        raise RuntimeError(f"the trace holds no {MARK!r} marker")
    mark = marks[0]
    m0, m1 = mark.time_range.start, mark.time_range.end
    rows = []
    host = []
    spans = []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name != MARK and s >= m0 and t <= m1 and t > s:
                rows.append((e.name, float(s), float(t)))
        elif e.thread == mark.thread and e is not mark and t > m0 and s < m1:
            host.append((float(s), float(t), e.name))
            if e.name.startswith(SPAN_PREFIX) and s >= m0 and t <= m1:
                spans.append((e.name, float(s), float(t)))
    busy = _union([(s, t) for _, s, t in rows])
    idle: Dict[str, float] = {}
    for a, b in _gaps(busy, m0, m1):
        mid = (a + b) / 2
        inside = [h for h in host if h[0] <= mid <= h[1]]
        # the innermost op: the one that started last
        name = max(inside)[2] if inside else "python (no op)"
        idle[name] = idle.get(name, 0.0) + (b - a)
    return TraceView(rows, float(m1 - m0),
                     float(sum(t - s for s, t in busy)), pairs,
                     sorted(idle.items(), key=lambda kv: -kv[1]),
                     _host_ops(host), sorted(spans, key=lambda x: x[1]),
                     float(m0))


def _host_ops(host) -> List[Tuple[str, int, float]]:
    """(name, calls, us) of the main thread's host ops, most time first."""
    by: Dict[str, List[float]] = {}
    for s, t, name in host:
        n = by.setdefault(name, [0, 0.0])
        n[0] += 1
        n[1] += t - s
    return sorted(((k, int(c), us) for k, (c, us) in by.items()),
                  key=lambda x: -x[2])[:TOP]


def stretch(run: Callable[[float], int], seconds: float) -> TraceView:
    """Profile `run(seconds)` (which returns the pairs it dispatched and
    waits for their outputs) and read the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(SPIN_KERNELS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        with record_function(MARK):
            pairs = run(seconds)
            torch.cuda.synchronize()
    return read(prof.events(), pairs)
