"""Unified observability plane: one event spine every subsystem feeds.

Reference parity: the reference engine treats observability as a
first-class subsystem — OTLP traces + metrics (src/engine/telemetry.rs),
a per-process OpenMetrics endpoint (src/engine/http_server.rs:21-60) and
per-operator ``ProberStats`` probes (graph.rs:988-995). This module is
the port's equivalent spine; four concerns share it:

* **wave tracing** — the :class:`~pathway_tpu_torch.engine.frontier.
  FrontierScheduler` pump emits one structured span event per
  (operator, wave) with queue-wait vs execute vs stash time, and the
  process mesh tags data frames with trace context
  (``run_id, sender, seq, wall clock``) so a wave's timeline is
  reconstructable across workers by joining each process's dump on
  (wire, time, sender);

* **metrics registry** — per-source watermark lag and frontier age,
  per-operator latency *histograms* (not just the cumulative
  ``time_ns``), mesh wire counters, device-plane compile/quarantine
  counts and RetryPolicy/breaker + fault-plane events, plus the
  out-of-core state plane (``pathway_spill_runs`` / ``_bytes`` gauges
  per store, the ``pathway_spill_probe_tier`` ladder counter,
  ``pathway_spill_compactions`` and the ``pathway_spill_merge_seconds``
  histogram — engine/spill.py), all exported through the Prometheus
  endpoint (internals/metrics.py), the JSONL/OTLP telemetry exporter
  (internals/telemetry.py) and the ``/statistics`` JSON route;

* **pipeline profiler** — ``pw.run(profile=...)`` (or
  ``PATHWAY_PROFILE=1``/``=path``) writes a per-run profile attributing
  wall-clock to named operators and pipeline stages
  (ingest/exchange/compute/emit + idle/poll/checkpoint), directly
  answering the ``join_ingest_share`` / ``threads4_speedup``
  attribution questions (ROADMAP items 1 and 4);

* **flight recorder** — a bounded in-memory ring of recent
  wave/fault/retry/mesh events, dumped to ``PATHWAY_FLIGHT_DIR`` on
  crash (:func:`pathway_tpu_torch.engine.faults.hard_crash`), runtime error,
  supervisor restart, or on demand (:func:`dump_flight`), so
  postmortems stop depending on re-running with logging enabled.

**Hot-path contract** (mirrors ``PATHWAY_FAULTS=0``): the module global
``PLANE`` *is* the switch — every engine probe is a single
``PLANE is None`` test when observability is off, and probes fire per
WAVE (or per frame / per retry), never per row. Enable with
``PATHWAY_OBSERVABILITY=1``, ``pw.run(observability=True)``, profiling,
or :func:`enable` directly. Catalog of metrics, span fields and the
dump layout: docs/observability.md.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Iterable
from pathway_tpu_torch.analysis import lockgraph as _lockgraph

__all__ = [
    "PLANE",
    "ObservabilityPlane",
    "MetricsRegistry",
    "Profiler",
    "FlightRecorder",
    "enable",
    "disable",
    "enabled",
    "maybe_enable_from_env",
    "record",
    "dump_flight",
    "pretime",
    "pretimes",
    "register_retry_policy",
    "retry_policies",
]

# -------------------------------------------------------------- fast path
#
# `PLANE is None` is the entire cost of a disabled probe. Callers import
# the module (`from pathway_tpu_torch.internals import observability as obs`)
# and test `obs.PLANE is not None` inline — never through a function call
# on the hot path.

PLANE: "ObservabilityPlane | None" = None
_LOCK = _lockgraph.register_lock("obs.plane", threading.Lock())

# Pre-run stage time (static-ingest parse in io/fs.py happens at graph
# BUILD time, before pw.run creates the plane) accumulates here always:
# a couple of timer reads per `fs.read` call, never per row. The
# profiler folds it into its report as the `ingest` stage — this is what
# lets the profile's ingest share reconcile with the bench's
# `join_ingest_share` (clock-started-after-ingest methodology).
_PRETIMES: dict[str, float] = {}
_PRETIMES_LOCK = _lockgraph.register_lock(
    "obs.pretimes", threading.Lock()
)

# RetryPolicy instances announce themselves here (always on — one WeakSet
# add per policy construction) so /metrics can export breaker states
# without the policies holding a reference cycle.
_RETRY_POLICIES: "weakref.WeakSet[Any]" = weakref.WeakSet()


def pretime(stage: str, seconds: float) -> None:
    """Accumulate pre-run stage wall time (e.g. static-ingest parsing)."""
    with _PRETIMES_LOCK:
        _PRETIMES[stage] = _PRETIMES.get(stage, 0.0) + seconds


def pretimes() -> dict[str, float]:
    with _PRETIMES_LOCK:
        return dict(_PRETIMES)


def pretimes_take() -> dict[str, float]:
    """Consume the accumulated pre-run times. Each profile report takes
    the window since the previous take, so a second pw.run in one
    process never re-counts the first run's ingest parsing."""
    global _PRETIMES
    with _PRETIMES_LOCK:
        out, _PRETIMES = _PRETIMES, {}
    return out


def register_retry_policy(policy: Any) -> None:
    _RETRY_POLICIES.add(policy)


def retry_policies() -> list[Any]:
    return list(_RETRY_POLICIES)


# ------------------------------------------------------------- registry


# Log-spaced latency buckets (seconds): 50 µs .. 30 s, the range between
# a trivial stateless wave and a cold XLA compile.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class _Histogram:
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple[float, ...]):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # +inf bucket last
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = 0
        for b in self.bounds:
            if value <= b:
                break
            i += 1
        self.counts[i] += 1
        self.sum += value
        self.count += 1

    def cumulative(self) -> list[tuple[float, int]]:
        """[(le_bound, cumulative_count)] incl. the +Inf bucket."""
        out = []
        acc = 0
        for b, c in zip(self.bounds, self.counts):
            acc += c
            out.append((b, acc))
        out.append((float("inf"), acc + self.counts[-1]))
        return out


class MetricsRegistry:
    """Counters, gauges and histograms keyed by (name, sorted label
    items). Updated per wave / frame / retry — never per row — so one
    lock is fine."""

    def __init__(self) -> None:
        self._lock = _lockgraph.register_lock(
            "obs.metrics", threading.Lock()
        )
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._histograms: dict[tuple, _Histogram] = {}
        # name -> (prom type, help) declared on first touch
        self.meta: dict[str, tuple[str, str]] = {}

    @staticmethod
    def _key(name: str, labels: dict | None) -> tuple:
        if not labels:
            return (name,)
        return (name, tuple(sorted(labels.items())))

    def _declare(self, name: str, typ: str, help_: str) -> None:
        if name not in self.meta:
            self.meta[name] = (typ, help_)

    def counter(
        self, name: str, labels: dict | None = None, inc: float = 1,
        help: str = "",
    ) -> None:
        k = self._key(name, labels)
        with self._lock:
            self._declare(name, "counter", help)
            self._counters[k] = self._counters.get(k, 0) + inc

    def gauge(
        self, name: str, value: float, labels: dict | None = None,
        help: str = "",
    ) -> None:
        k = self._key(name, labels)
        with self._lock:
            self._declare(name, "gauge", help)
            self._gauges[k] = value

    def observe(
        self, name: str, value: float, labels: dict | None = None,
        bounds: tuple[float, ...] = DEFAULT_BUCKETS, help: str = "",
    ) -> None:
        k = self._key(name, labels)
        with self._lock:
            self._declare(name, "histogram", help)
            h = self._histograms.get(k)
            if h is None:
                h = self._histograms[k] = _Histogram(bounds)
            h.observe(value)

    # -------------------------------------------------------------- reads
    #
    # Subsystems may react to each other's signals through the registry
    # (the serving gateway's watermark backpressure reads the runtime's
    # lag gauges) — reads are snapshots under the same lock as writes.

    def gauge_value(self, name: str, labels: dict | None = None) -> float | None:
        """Current value of one gauge series (None if never set)."""
        k = self._key(name, labels)
        with self._lock:
            return self._gauges.get(k)

    def counter_value(self, name: str, labels: dict | None = None) -> float:
        k = self._key(name, labels)
        with self._lock:
            return self._counters.get(k, 0.0)

    def histogram_stats(
        self, name: str, labels: dict | None = None
    ) -> tuple[int, float]:
        """(observation count, value sum) of a histogram — one labeled
        series, or aggregated across every series of `name` when labels
        is None. The adaptive planner reads the per-operator wave-latency
        histograms through this to find hot chains
        (internals/planner.py AdaptivePolicy)."""
        with self._lock:
            if labels is not None:
                h = self._histograms.get(self._key(name, labels))
                return (h.count, h.sum) if h is not None else (0, 0.0)
            count, total = 0, 0.0
            for k, h in self._histograms.items():
                if k[0] == name:
                    count += h.count
                    total += h.sum
            return count, total

    def max_gauge(
        self,
        name: str,
        label: str | None = None,
        values: Iterable[str] | None = None,
    ) -> float:
        """Max across every series of `name` (0.0 when absent). With
        `label`+`values` only series whose `label` is in `values` count —
        e.g. the watermark lag of a specific source set."""
        allowed = set(values) if values is not None else None
        best = 0.0
        with self._lock:
            for k, v in self._gauges.items():
                if k[0] != name:
                    continue
                if label is not None and allowed is not None:
                    series_labels = dict(k[1]) if len(k) > 1 else {}
                    if series_labels.get(label) not in allowed:
                        continue
                best = max(best, v)
        return best

    # ------------------------------------------------------------- export

    def items(self):
        """Snapshot: (name, labels-dict, kind, payload) tuples. payload is
        a float for counter/gauge, a _Histogram copy-view for histogram."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = [
                (k, (list(h.counts), h.sum, h.count, h.bounds))
                for k, h in self._histograms.items()
            ]
        out = []
        for k, v in counters:
            out.append((k[0], dict(k[1]) if len(k) > 1 else {}, "counter", v))
        for k, v in gauges:
            out.append((k[0], dict(k[1]) if len(k) > 1 else {}, "gauge", v))
        for k, (counts, s, c, bounds) in hists:
            h = _Histogram(bounds)
            h.counts, h.sum, h.count = counts, s, c
            out.append((k[0], dict(k[1]) if len(k) > 1 else {}, "histogram", h))
        return out

    def snapshot(self) -> dict:
        """JSON-friendly view for the /statistics route and dumps."""
        out: dict[str, Any] = {}
        for name, labels, kind, payload in self.items():
            ent = out.setdefault(name, {"type": kind, "series": []})
            if kind == "histogram":
                ent["series"].append(
                    {
                        "labels": labels,
                        "count": payload.count,
                        "sum": round(payload.sum, 6),
                        "buckets": [
                            [b if b != float("inf") else "+Inf", c]
                            for b, c in payload.cumulative()
                        ],
                    }
                )
            else:
                ent["series"].append({"labels": labels, "value": payload})
        return out


# ------------------------------------------------------------- profiler


# stage classification by engine node class name: everything unknown is
# "compute" (the operator cone doing actual work)
_INGEST_NODES = {"InputNode"}
# ShardedNode is NOT exchange: it wraps the stateful operator's replicas
# and its wave time is the operator compute itself
_EXCHANGE_NODES = {"ProcessExchangeNode"}
_EMIT_NODES = {"OutputNode", "SubscribeNode", "CaptureNode"}


def stage_of(node: Any) -> str:
    name = type(node).__name__
    if name in _INGEST_NODES:
        return "ingest"
    if name in _EXCHANGE_NODES:
        return "exchange"
    if name in _EMIT_NODES:
        return "emit"
    return "compute"


class Profiler:
    """Attributes run wall-clock to named operators and pipeline stages.

    Fed per (operator, wave) by the scheduler/step hooks; the runtime
    adds loop-level stages (``idle``, ``poll``, ``checkpoint``,
    ``quiesce``) and io/fs.py contributes pre-run ``ingest`` parse time
    (:func:`pretime`). ``report()`` reconciles everything against the
    observed wall clock and states the attributed share explicitly —
    the instrument is honest about what it could not see."""

    def __init__(self) -> None:
        self._lock = _lockgraph.register_lock(
            "obs.profiler", threading.Lock()
        )
        self.t0_wall = time.time()
        self.t0 = time.perf_counter()
        # node_id -> [exec_ns, queue_ns, stash_ns, waves]
        self._ops: dict[int, list] = {}
        self._meta: dict[int, tuple[str, str, str]] = {}  # op, label, stage
        self._stages: dict[str, float] = {}  # loop-level stage seconds
        self._pre: dict[str, float] | None = None  # taken at first report()

    def op_wave(
        self, node: Any, exec_ns: int, queue_ns: int, stash_ns: int
    ) -> None:
        nid = node.node_id
        with self._lock:
            acc = self._ops.get(nid)
            if acc is None:
                acc = self._ops[nid] = [0, 0, 0, 0]
                self._meta[nid] = (
                    type(node).__name__,
                    getattr(node, "label", None) or "",
                    stage_of(node),
                )
            acc[0] += exec_ns
            acc[1] += queue_ns
            acc[2] += stash_ns
            acc[3] += 1

    def stage_seconds(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._stages[stage] = self._stages.get(stage, 0.0) + seconds

    def report(self, graph: Any = None) -> dict:
        wall = time.perf_counter() - self.t0
        if self._pre is None:
            self._pre = pretimes_take()
        pre = self._pre
        with self._lock:
            ops = {k: list(v) for k, v in self._ops.items()}
            meta = dict(self._meta)
            loop_stages = dict(self._stages)
        operators = []
        stage_exec: dict[str, float] = {
            "ingest": 0.0, "exchange": 0.0, "compute": 0.0, "emit": 0.0,
        }
        for nid, (exec_ns, queue_ns, stash_ns, waves) in ops.items():
            op, label, stage = meta[nid]
            exec_s = exec_ns / 1e9
            stage_exec[stage] = stage_exec.get(stage, 0.0) + exec_s
            rows_in = rows_out = None
            if graph is not None and nid < len(graph.nodes):
                n = graph.nodes[nid]
                rows_in, rows_out = n.rows_in, n.rows_out
            operators.append(
                {
                    "id": nid,
                    "operator": op,
                    "label": label,
                    "stage": stage,
                    "exec_s": round(exec_s, 6),
                    "queue_wait_s": round(queue_ns / 1e9, 6),
                    "stash_s": round(stash_ns / 1e9, 6),
                    "waves": waves,
                    "rows_in": rows_in,
                    "rows_out": rows_out,
                }
            )
        operators.sort(key=lambda o: -o["exec_s"])
        pre_total = sum(pre.values())
        total = wall + pre_total  # pipeline wall incl. pre-run ingest parse
        # loop-level stages (idle/poll/checkpoint/quiesce) + operator
        # exec cover the pump; the remainder is scheduler overhead we
        # did not separately time — report it, never hide it
        attributed = (
            sum(stage_exec.values()) + sum(loop_stages.values()) + pre_total
        )
        overhead = max(total - attributed, 0.0)
        stages: dict[str, Any] = {}
        for name, s in sorted(stage_exec.items()):
            stages[name] = round(s, 6)
        for name, s in sorted(loop_stages.items()):
            stages[name] = round(stages.get(name, 0.0) + s, 6)
        for name, s in sorted(pre.items()):
            stages[name] = round(stages.get(name, 0.0) + s, 6)
        stages["unattributed"] = round(overhead, 6)
        ingest_total = stages.get("ingest", 0.0) + stages.get("poll", 0.0)
        for o in operators:
            o["share"] = round(o["exec_s"] / total, 4) if total > 0 else 0.0
        return {
            "started_at": self.t0_wall,
            "wall_s": round(wall, 6),
            "pre_run_s": round(pre_total, 6),
            "total_s": round(total, 6),
            "attributed_s": round(min(attributed, total), 6),
            "attributed_pct": round(
                100.0 * min(attributed, total) / total, 2
            ) if total > 0 else 100.0,
            # the bench's join_ingest_share methodology: share of total
            # pipeline wall spent turning external bytes into engine rows
            "ingest_share": round(ingest_total / total, 4) if total > 0 else 0.0,
            "stages": stages,
            "operators": operators,
            # the O(1)-dispatch claim, measured: host dispatches per
            # lockstep wave (a cone fire counts 1, a fallback wave its
            # member count — docs/megakernel.md)
            **(
                {
                    "wave_dispatches": {
                        "waves": graph.wave_count,
                        "dispatches": graph.dispatch_count,
                        "per_wave_mean": round(
                            graph.dispatch_count / graph.wave_count, 3
                        ),
                    }
                }
                if graph is not None and getattr(graph, "wave_count", 0)
                else {}
            ),
            # plan visibility: the optimizer's decisions for this run
            # (fusion groups, pushdowns, join-order advice, replans) —
            # see docs/planner.md
            **(
                {"plan": graph.plan_report}
                if graph is not None
                and getattr(graph, "plan_report", None) is not None
                else {}
            ),
            # morsel execution visibility: stolen share of executed
            # morsels (cumulative gauge the steal scheduler maintains)
            # plus the last wave's queue/steal tallies — docs/parallelism.md
            **self._morsel_section(),
        }

    @staticmethod
    def _morsel_section() -> dict:
        if PLANE is None:
            return {}
        ratio = PLANE.metrics.gauge_value("pathway_steal_ratio")
        if ratio is None:
            return {}
        from pathway_tpu_torch.engine import morsel as _morsel

        return {"morsels": {
            "steal_ratio": round(float(ratio), 4),
            "last_wave": _morsel.last_run(),
        }}


# ------------------------------------------------------- flight recorder


class FlightRecorder:
    """Bounded ring of recent events; `dump` writes them (plus the fault
    schedule's fired log) to disk for postmortems. A deque append under
    the GIL is the whole recording cost."""

    def __init__(self, size: int = 4096):
        self.ring: deque = deque(maxlen=size)
        self._dump_lock = _lockgraph.register_lock(
            "obs.flight_dump", threading.Lock()
        )
        self.dumped: list[str] = []  # paths written so far (tests)

    def append(self, event: dict) -> None:
        self.ring.append(event)

    def snapshot(self) -> list[dict]:
        return list(self.ring)

    def dump(self, reason: str, directory: str, context: dict) -> str:
        """Write `flight-<proc>-<pid>-<reason>-<n>.json`; returns the
        path. Never raises (a failing dump must not mask the crash that
        triggered it) — returns "" on failure."""
        with self._dump_lock:
            try:
                os.makedirs(directory, exist_ok=True)
                fired: list = []
                try:  # lazy: engine.faults imports this module's peers
                    from pathway_tpu_torch.engine import faults as _faults

                    fired = [list(x) for x in _faults.fired_log()]
                except Exception:  # noqa: BLE001
                    pass
                payload = {
                    "reason": reason,
                    "ts": time.time(),
                    "pid": os.getpid(),
                    **context,
                    "faults_fired": fired,
                    "events": self.snapshot(),
                }
                path = os.path.join(
                    directory,
                    f"flight-p{context.get('process_id', 0)}"
                    f"-{os.getpid()}-{reason}-{len(self.dumped)}.json",
                )
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(payload, f)
                os.replace(tmp, path)
                self.dumped.append(path)
                return path
            except Exception:  # noqa: BLE001 — best effort by contract
                return ""


# ---------------------------------------------------------------- plane


class ObservabilityPlane:
    """The live spine: ring + registry + optional profiler + exporters."""

    def __init__(
        self,
        *,
        profile: bool = False,
        ring_size: int = 4096,
        flight_dir: str | None = None,
    ):
        import uuid

        self.run_id = uuid.uuid4().hex[:16]
        self.process_id = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
        self.recorder = FlightRecorder(ring_size)
        self.metrics = MetricsRegistry()
        self.profiler: Profiler | None = Profiler() if profile else None
        self._exporters: list[Callable[[dict], None]] = []
        self._seq = 0
        self._seq_lock = _lockgraph.register_lock(
            "obs.seq", threading.Lock()
        )
        self.flight_dir = flight_dir or os.environ.get(
            "PATHWAY_FLIGHT_DIR"
        ) or os.path.join(tempfile.gettempdir(), "pathway_flight")
        # frontier-age tracker (set by the runtime's source tick)
        self._frontier_last: float | None = None
        self._frontier_changed_at = time.monotonic()
        self._last_tick = 0.0

    # ------------------------------------------------------------ events

    def next_seq(self) -> int:
        with self._seq_lock:
            self._seq += 1
            return self._seq

    def add_exporter(self, fn: Callable[[dict], None]) -> None:
        self._exporters.append(fn)

    def remove_exporter(self, fn: Callable[[dict], None]) -> None:
        try:
            self._exporters.remove(fn)
        except ValueError:
            pass

    def record(self, kind: str, *, export: bool = True, **fields: Any) -> None:
        """Append one structured event to the ring; fan out to exporters
        (telemetry) unless export=False (high-volume wave spans stay in
        the ring + histograms only)."""
        ev = {"k": kind, "ts": round(time.time(), 6), **fields}
        self.recorder.append(ev)
        if export and self._exporters:
            for fn in self._exporters:
                try:
                    fn(ev)
                except Exception:  # noqa: BLE001 — an exporter must not kill a wave
                    pass

    # ------------------------------------------------------- wave tracing

    def wave(
        self,
        node: Any,
        t: float,
        exec_ns: int,
        queue_ns: int = 0,
        stash_ns: int = 0,
        injected: bool = False,
    ) -> None:
        """One (operator, wave) span from the scheduler/step pump."""
        label = getattr(node, "label", None) or ""
        op = type(node).__name__
        self.metrics.observe(
            "pathway_operator_wave_seconds",
            exec_ns / 1e9,
            {"operator": op, "label": label, "id": str(node.node_id)},
            help="per-operator wave execution latency",
        )
        if queue_ns:
            self.metrics.observe(
                "pathway_operator_queue_wait_seconds",
                queue_ns / 1e9,
                {"operator": op, "label": label, "id": str(node.node_id)},
                help="wave wait between staging/stash and firing",
            )
        if self.profiler is not None:
            self.profiler.op_wave(node, exec_ns, queue_ns, stash_ns)
        self.record(
            "wave",
            export=False,
            node=node.node_id,
            op=op,
            label=label,
            t=t if t != float("inf") else "end",
            proc=self.process_id,
            q_us=queue_ns // 1000,
            x_us=exec_ns // 1000,
            s_us=stash_ns // 1000,
            inj=int(injected),
        )

    # --------------------------------------------------- runtime sources

    def tick_sources(
        self,
        local_time: float,
        sources_fn: Callable[[], Iterable[tuple[str, float]]],
        frontier_fn: Callable[[], float],
        min_interval_s: float = 0.25,
    ) -> None:
        """Throttled per-source watermark-lag + frontier-age gauges,
        called from the pump loop. The callables run only when a tick is
        due, so the per-iteration cost between ticks is one clock read."""
        now = time.monotonic()
        if now - self._last_tick < min_interval_s:
            return
        self._last_tick = now
        global_frontier = frontier_fn()
        for name, wm in sources_fn():
            if wm == float("inf"):
                lag = 0.0
                self.metrics.gauge(
                    "pathway_source_done", 1, {"source": name},
                    help="1 once the source announced the empty frontier",
                )
            else:
                # watermark and clock share the even-ms domain: the lag
                # is how far this source trails the local clock
                lag = max(local_time - wm, 0) / 1000.0
            self.metrics.gauge(
                "pathway_source_watermark_lag_seconds", lag,
                {"source": name},
                help="local clock minus the source's watermark",
            )
        if global_frontier != self._frontier_last:
            self._frontier_last = global_frontier
            self._frontier_changed_at = now
        self.metrics.gauge(
            "pathway_frontier_age_seconds",
            now - self._frontier_changed_at,
            help="seconds since the global frontier last advanced",
        )

    def stage_seconds(
        self, stage: str, seconds: float, profile: bool = True
    ) -> None:
        """Loop-level stage attribution (idle/poll/checkpoint/quiesce).
        profile=False keeps a stage out of the profiler's attributed sum
        (the metric still exports) — used for windows whose wave work is
        already attributed per-operator, which would double-count."""
        if profile and self.profiler is not None:
            self.profiler.stage_seconds(stage, seconds)
        self.metrics.counter(
            "pathway_runtime_stage_seconds_total", {"stage": stage}, seconds,
            help="pump-loop wall time by stage",
        )

    # -------------------------------------------------------------- dump

    def dump(self, reason: str) -> str:
        return self.recorder.dump(
            reason,
            self.flight_dir,
            {"run_id": self.run_id, "process_id": self.process_id},
        )


# -------------------------------------------------------------- controls


def enable(
    *,
    profile: bool = False,
    ring_size: int | None = None,
    flight_dir: str | None = None,
) -> ObservabilityPlane:
    """Install the plane (idempotent; an existing plane gains a profiler
    when `profile` asks for one)."""
    global PLANE
    with _LOCK:
        if PLANE is None:
            PLANE = ObservabilityPlane(
                profile=profile,
                ring_size=ring_size
                or int(os.environ.get("PATHWAY_OBS_RING", "4096")),
                flight_dir=flight_dir,
            )
        else:
            if profile and PLANE.profiler is None:
                PLANE.profiler = Profiler()
            if flight_dir:
                PLANE.flight_dir = flight_dir
        return PLANE


def disable() -> None:
    global PLANE
    with _LOCK:
        PLANE = None


def enabled() -> bool:
    return PLANE is not None


def _truthy(v: str | None) -> bool:
    return bool(v) and v not in ("0", "false", "no", "")


def maybe_enable_from_env() -> ObservabilityPlane | None:
    """PATHWAY_OBSERVABILITY=1 enables the plane; PATHWAY_PROFILE=1 (or
    =path) additionally arms the profiler (and implies the plane)."""
    prof = os.environ.get("PATHWAY_PROFILE")
    if _truthy(os.environ.get("PATHWAY_OBSERVABILITY")) or _truthy(prof):
        return enable(profile=_truthy(prof))
    return PLANE


def profile_path_from_env() -> str | None:
    """The profile output path PATHWAY_PROFILE asks for ("1" means the
    default ./pathway_profile.json)."""
    v = os.environ.get("PATHWAY_PROFILE")
    if not _truthy(v):
        return None
    return "pathway_profile.json" if v in ("1", "true", "yes") else v


def record(kind: str, **fields: Any) -> None:
    """Guarded convenience for cold paths (fault shots, breaker flips)."""
    p = PLANE
    if p is not None:
        p.record(kind, **fields)


def dump_flight(reason: str) -> str | None:
    """Dump the flight recorder if the plane is live; safe anywhere
    (including inside ``os._exit`` crash paths)."""
    p = PLANE
    if p is None:
        return None
    return p.dump(reason)
