"""Spans of the port's serving path: timed blocks on the observability
plane's switch.

A span is one block on one thread (or an interval of a request), with a
start and an end in nanoseconds on the span clock
(``time.perf_counter_ns``, monotonic), an id, a parent (0 at the top),
the request it serves, the thread (its native id; None for an interval
that is no call on one thread) and a few attributes. The continuous
batcher records ``cb.request`` (with ``cb.queue``), ``cb.prefill`` (with
``.launch``, ``.sync``) and ``cb.step`` (with ``.upload``, ``.launch``,
``.sync``); ``TorchEmbedder`` records ``embed.batch`` over
``embed.tokenize``, ``.pad``, ``.upload``, ``.encode`` and ``.readback``;
the DeepSeek-V3 family (``models/deepseek.py``) records ``lm.mla`` and
``lm.moe`` around each layer's attention and feed-forward, and the Kimi
Linear family (``models/kimi_linear.py``) ``lm.kda`` around each KDA
layer beside them, inside the batcher's ``cb.step.launch`` and
``cb.prefill.launch``.

Spans follow the plane's switch (``observability.PLANE``): with the plane
on they go to a bounded ring of their own beside its flight recorder,
sized as that recorder is (``PATHWAY_OBS_RING``), so serving at a step
every few milliseconds never pushes the flight ring's rare events
(faults, breaker flips, restarts) out; they go to no exporter. Off (no
plane, no ``torch.profiler`` session) :func:`span` is two reads that
return the shared :data:`NULL_SPAN`, whose ``with`` allocates nothing.
While a ``torch.profiler`` session runs, plane on or off, each leaf span
is also a ``record_function("pathway/<name>")`` annotation, so a device
trace names its idle gaps by the phase (an annotation around a whole
batch would hide them); the profiler records annotations of the thread
that started it only.

:func:`export_chrome_trace` writes the ring's spans as Chrome-trace
events on the profiler's clock, alone or into a trace written by
``torch.profiler``'s ``export_chrome_trace``: one timeline with the
device's kernels.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any

import torch.autograd.profiler as _torch_profiler

from pathway_tpu_torch.internals import observability as _obs

__all__ = [
    "ANNOTATION",
    "NULL_SPAN",
    "Span",
    "span",
    "new_span_id",
    "add_span",
    "spans",
    "profiler_clock_offset_ns",
    "export_chrome_trace",
]

ANNOTATION = "pathway/"
_SPAN_IDS = itertools.count(1)
_OPEN = threading.local()  # `spans`: the thread's open spans, innermost last
_LOCK = threading.Lock()
_RING: tuple[Any, deque] | None = None  # (the plane, its spans)


def new_span_id() -> int:
    return next(_SPAN_IDS)


def _ring(plane: Any) -> deque:
    """The spans of `plane`, a fresh ring for a fresh plane."""
    global _RING
    ring = _RING
    if ring is None or ring[0] is not plane:
        with _LOCK:
            ring = _RING
            if ring is None or ring[0] is not plane:
                ring = _RING = (plane, deque(maxlen=plane.recorder.ring.maxlen))
    return ring[1]


def add_span(
    name: str,
    start_ns: int,
    end_ns: int,
    *,
    span_id: int | None = None,
    parent: int = 0,
    request: int | None = None,
    tid: int | None = None,
    attrs: dict | None = None,
) -> None:
    """One finished span into the plane's span ring, if the plane is on.
    Stamps are on the span clock; `tid` is the native id of the thread it
    ran on, None for an interval that is no call on one thread."""
    plane = _obs.PLANE
    if plane is None:
        return
    _ring(plane).append({
        "name": name, "id": span_id or next(_SPAN_IDS), "parent": parent, "request": request,
        "tid": tid, "start_ns": start_ns, "end_ns": end_ns, "attrs": attrs or {},
    })


def spans() -> list[dict]:
    """The spans still in the plane's ring, oldest first ([] with the
    plane off)."""
    plane = _obs.PLANE
    return list(_ring(plane)) if plane is not None else []


class _NullSpan:
    """What :func:`span` returns while nothing records."""

    __slots__ = ()
    id = 0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


NULL_SPAN = _NullSpan()


class Span:
    """One block on one thread, timed on the span clock. Its parent is
    `parent`, else the innermost span open on the thread; its request is
    `request`, else the parent's. A `leaf` is also a profiler annotation
    ``pathway/<name>`` while a ``torch.profiler`` session runs. On exit
    it goes to the plane's span ring, if the plane is on."""

    __slots__ = (
        "name", "id", "parent", "request", "leaf", "attrs", "start_ns", "end_ns",
        "_annotation",
    )

    def __init__(
        self, name: str, parent: int | None = None, request: int | None = None,
        leaf: bool = True,
    ):
        self.name = name
        self.id = next(_SPAN_IDS)
        self.parent = parent
        self.request = request
        self.leaf = leaf
        self.attrs: dict | None = None
        self.start_ns = self.end_ns = 0
        self._annotation = None

    def set(self, **attrs: Any) -> None:
        """Attach attributes (numbers or short strings)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = getattr(_OPEN, "spans", None)
        if stack is None:
            stack = _OPEN.spans = []
        if stack:
            if self.parent is None:
                self.parent = stack[-1].id
            if self.request is None:
                self.request = stack[-1].request
        stack.append(self)
        if self.leaf and _torch_profiler._is_profiler_enabled:
            self._annotation = _torch_profiler.record_function(ANNOTATION + self.name)
            self._annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
        _OPEN.spans.pop()
        add_span(
            self.name, self.start_ns, self.end_ns, span_id=self.id,
            parent=self.parent or 0, request=self.request,
            tid=threading.get_native_id(), attrs=self.attrs,
        )
        return False


def span(
    name: str, *, parent: int | None = None, request: int | None = None,
    leaf: bool = True,
) -> "Span | _NullSpan":
    """A :class:`Span` to enter around a block, or :data:`NULL_SPAN` when
    neither the plane nor a profiler session is on."""
    if _obs.PLANE is None and not _torch_profiler._is_profiler_enabled:
        return NULL_SPAN
    return Span(name, parent, request, leaf)


def profiler_clock_offset_ns() -> int:
    """What to add to a span stamp to put it on ``torch.profiler``'s
    clock, which stamps host and device events in Unix nanoseconds: the
    tightest of a few paired readings of the two clocks."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def export_chrome_trace(path: str, *, merge_with: str | None = None) -> int:
    """Write the ring's spans as Chrome-trace events on the profiler's
    clock (:func:`profiler_clock_offset_ns`); returns how many spans. A
    span of one thread is a complete event (``"X"``) on that thread's row
    (its native id, as the profiler names threads); an interval of no one
    thread (a request, its wait in the queue) is an async pair (``"b"``,
    ``"e"``) keyed by its request.

    `merge_with` names a trace written by ``torch.profiler``'s
    ``export_chrome_trace``: the spans take its ``baseTimeNanoseconds`` and
    follow its events in one file at `path`. Without it ``ts`` counts
    microseconds from the Unix epoch."""
    ring = spans()
    doc: dict[str, Any] = {"traceEvents": [], "baseTimeNanoseconds": 0}
    if merge_with is not None:
        with open(merge_with) as f:
            doc = json.load(f)
    shift = profiler_clock_offset_ns() - int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    for s in ring:
        name = ANNOTATION + s["name"]
        ts = (s["start_ns"] + shift) / 1e3
        args = {"id": s["id"], "parent": s["parent"], "request": s["request"], **s["attrs"]}
        if s["tid"] is not None:
            events.append({
                "ph": "X", "cat": "pathway", "name": name, "pid": pid, "tid": s["tid"],
                "ts": ts, "dur": (s["end_ns"] - s["start_ns"]) / 1e3, "args": args,
            })
        else:
            key = {"cat": "pathway", "name": name, "pid": pid, "id": s["request"] or s["id"]}
            events.append({"ph": "b", "ts": ts, "args": args, **key})
            events.append({"ph": "e", "ts": (s["end_ns"] + shift) / 1e3, **key})
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(ring)
