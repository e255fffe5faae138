"""The benchmark's own spans and its reading of the profiler's trace.

Spans are host intervals that the harness records around its calls into
the program (a layer it cannot see from outside, such as the tokenizer
inside the embedder, is wrapped in an object it passes in). While a
trace runs, each span is also a ``torch.profiler.record_function``
annotation, so that the trace can name what the host was doing in each
of the device's idle gaps.

The profiler records the operations and annotations of the thread that
started it only, so work that the program launches from a thread of its
own (the continuous batcher's decode thread) is marked differently:
:meth:`Spans.marked` wraps a callable of the program so that, while a
trace runs, each call's start is a mark on the host's clock. A mark
opens a segment of the device's timeline that lasts to the next mark;
where that thread waits for the device at the end of each call, as the
batcher does, the device work in a segment is that call's.

:class:`DeviceTrace` runs ``torch.profiler`` (CPU and CUDA activities)
over a window and reduces the raw events to the numbers the metrics
read: the union of the device's busy intervals, device seconds by
kernel name, and the idle gaps by the host's activity.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

from benchmark.roofline import busy_union

ANNOTATION = "bench/"
CLOCK = ANNOTATION + "clock"


class Spans:
    """Host seconds by span name, counted while ``active``."""

    def __init__(self) -> None:
        self.seconds: dict[str, float] = defaultdict(float)
        self.active = False
        self.annotate = False
        # (time.time_ns(), name, note) of each marked call while a trace runs
        self.marks: list[tuple[int, str, object]] = []

    def marked(self, fn, name: str, note=None):
        """`fn`, wrapped: while a trace runs, each call first records a
        mark ``name`` with ``note()``, what that call's work is."""

        def wrapped(*args, **kwargs):
            if self.annotate:
                self.marks.append((time.time_ns(), name, note() if note is not None else None))
            return fn(*args, **kwargs)

        return wrapped

    @contextlib.contextmanager
    def span(self, name: str):
        ann = contextlib.nullcontext()
        if self.annotate:
            import torch

            ann = torch.profiler.record_function(ANNOTATION + name)
        t0 = time.perf_counter()
        with ann:
            yield
        if self.active:
            self.seconds[name] += time.perf_counter() - t0


class DeviceTrace:
    """``torch.profiler`` over one window on the default CUDA device.

    Made before the program's set-up: it opens and closes one short
    profiler run at once, so that the profiler's tracing of the card starts
    up here, before any other thread of the program launches work (a
    profiler run whose start-up raced a decode thread's launches has been
    seen to record no device operation at all)."""

    def __init__(self, spans: Spans | None = None) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.spans = spans
        self.prof = None
        self.window_s = 0.0
        self._t0 = 0.0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        # the host's clock (time.time_ns) against the trace's: an
        # annotation of this thread around one reading of it
        with torch.profiler.record_function(CLOCK):
            self._clock_ns = time.time_ns()
        if self.spans is not None:
            self.spans.marks.clear()
            self.spans.annotate = True
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        if self.spans is not None:
            self.spans.annotate = False
        self.prof.stop()

    def device_events(self) -> int:
        """Device operations the last profiler run recorded."""
        return sum(_is_device(ev) for ev in self.prof.profiler.kineto_results.events())

    def summary(self, top: int = 10) -> dict:
        """busy_s, window_s, kernel_s (device seconds by name) and the
        breakdown (device_ops and idle_gaps, each the `top` largest)."""
        events = self.prof.profiler.kineto_results.events()
        marks = list(self.spans.marks) if self.spans is not None else []
        return summarize(events, self.window_s, top, marks, self._clock_ns)


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA") and not ev.is_user_annotation()


def summarize(events, window_s: float, top: int = 10, marks=(), clock_ns: int | None = None) -> dict:
    """Reduce kineto events (``start_ns``, ``end_ns``, ``name``,
    ``device_type``, ``is_user_annotation``) to the trace's numbers.

    The window starts at the earliest event and lasts `window_s`, the
    host's reading. Device intervals are the device's non-annotation
    events (kernels, copies, sets). `marks` are :class:`Spans` marks,
    moved onto the trace's clock by the ``bench/clock`` annotation taken
    at host time `clock_ns`. Each mark opens a segment that ends at the
    next mark; a segment that ends inside the window reports, under
    ``segments[name]``, its note and the union of the device intervals
    that start in it, in seconds. An idle gap is named by the innermost
    of the harness's spans and segments that covers its middle, else by
    the outermost CPU operation that does, else "host (no torch op)"
    (a span's name is followed by that operation's, where one covers it);
    gaps are summed by name."""
    dev, host = [], []
    clock_at = None
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        if ev.name() == CLOCK and str(ev.device_type()).endswith("CPU"):
            clock_at = s
        if e <= s:
            continue
        if _is_device(ev):
            dev.append((s, e, ev.name()))
        elif str(ev.device_type()).endswith("CPU") and ev.name() != "Activity Buffer Request":
            host.append((s, e, ev.name()))
    if not dev:
        return {
            "busy_s": 0.0, "window_s": window_s, "kernel_s": {}, "segments": {},
            "device_ops": [], "idle_gaps": [],
        }
    t0 = min([s for s, _, _ in dev] + [s for s, _, _ in host])
    t1 = t0 + int(window_s * 1e9)
    clipped = [(max(s, t0), min(e, t1), n) for s, e, n in dev if e > t0 and s < t1]
    busy_ns = busy_union([(s, e) for s, e, _ in clipped])
    kernel_s: dict[str, float] = defaultdict(float)
    for s, e, n in clipped:
        kernel_s[n] += (e - s) / 1e9
    shift = clock_at - clock_ns if clock_at is not None and clock_ns is not None else None
    seg_spans, segments = _segments(clipped, marks, shift, t1)
    gaps = _gaps(sorted((s, e) for s, e, _ in clipped), t0, t1)
    names = _name_gaps(gaps, host + seg_spans)
    idle: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for (gs, ge), name in zip(gaps, names):
        idle[name][0] += 1
        idle[name][1] += (ge - gs) / 1e9
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    gap_rows = sorted(idle.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": window_s,
        "kernel_s": dict(kernel_s),
        "segments": segments,
        "device_ops": [[n[:120], s] for n, s in ops],
        "idle_gaps": [[f"{n[:100]} ({c} gaps)", s] for n, (c, s) in gap_rows],
    }


def _segments(clipped, marks, shift, t1: int) -> tuple[list, dict]:
    """The marks' segments as annotation intervals (for naming gaps), and
    for each name the [note, device seconds] of its segments that end by
    `t1` (see :func:`summarize`)."""
    if shift is None or not marks:
        return [], {}
    bounds = sorted((m + shift, name, note) for m, name, note in marks)
    starts = [b for b, _, _ in bounds]
    spans, per_seg = [], [[] for _ in bounds]
    for i, (b, name, _) in enumerate(bounds):
        end = starts[i + 1] if i + 1 < len(bounds) else t1
        spans.append((b, end, ANNOTATION + name))
    for s, e, _ in clipped:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0:
            per_seg[i].append((s, e))
    out: dict[str, list] = defaultdict(list)
    for i, (b, name, note) in enumerate(bounds[:-1]):
        if starts[i + 1] <= t1:
            out[name].append([note, busy_union(per_seg[i]) / 1e9])
    return spans, dict(out)


def _gaps(intervals, t0: int, t1: int) -> list[tuple[int, int]]:
    out, cur = [], t0
    for s, e in intervals:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        out.append((cur, t1))
    return out


def _cover(intervals, mids, outermost: bool) -> list:
    """For each of the increasing `mids`, the name of the interval that
    covers it and starts earliest (`outermost`) or latest, else None: a
    sweep with a heap of the intervals begun, dropping those ended."""
    import heapq

    intervals = sorted(intervals)
    out, heap, i = [], [], 0
    sign = 1 if outermost else -1
    for mid in mids:
        while i < len(intervals) and intervals[i][0] <= mid:
            s, e, n = intervals[i]
            heapq.heappush(heap, (sign * s, e, n))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def _name_gaps(gaps, host) -> list[str]:
    """The host's activity at each gap's middle (see :func:`summarize`)."""
    mids = [(gs + ge) // 2 for gs, ge in gaps]
    spans = _cover([h for h in host if h[2].startswith(ANNOTATION)], mids, outermost=False)
    ops = _cover([h for h in host if not h[2].startswith(ANNOTATION)], mids, outermost=True)
    return [
        (sp[len(ANNOTATION):] + (f": {op}" if op else "")) if sp else (op or "host (no torch op)")
        for sp, op in zip(spans, ops)
    ]
