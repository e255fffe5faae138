"""Prometheus/OpenMetrics HTTP endpoint + the /statistics JSON route.

Reference parity: src/engine/http_server.rs (:21-60) — one plain-HTTP
metrics server per process at port 20000 + process_id, exposing input/
output latency and per-operator row counters; enabled by
`pw.run(with_http_server=True)`. Beyond seed parity this endpoint now
exports every series the observability plane collects
(internals/observability.py): per-operator latency histograms, per-source
watermark lag and frontier age, mesh wire counters, device-plane
compile/quarantine/fallback counts, retry-policy breaker states and the
fault plane's shot counter. The port's device plane runs eagerly: its
per-bucket shape ledger stands in for the compile ledger, and it has no
quarantine and no host fallback, so those series read empty and 0.
Label values are escaped per the OpenMetrics exposition grammar. ``/statistics`` serves the same state as one JSON
document (the reference's per-process statistics route). Metric catalog:
docs/observability.md.
"""

from __future__ import annotations

import http.server
import json
import math
import os
import threading
import time
from typing import Any

from pathway_tpu_torch.internals import observability as _obs


def _escape(value: Any) -> str:
    """OpenMetrics label-value escaping: backslash, double quote, and
    newline must be escaped inside the quoted value."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    if isinstance(v, float) and (math.isinf(v) or math.isnan(v)):
        return "+Inf" if v > 0 else ("-Inf" if v < 0 else "NaN")
    if isinstance(v, float):
        return repr(round(v, 9))
    return str(v)


class _Lines:
    """Accumulates exposition lines, emitting each # TYPE header once."""

    def __init__(self) -> None:
        self.lines: list[str] = []
        self._typed: set[str] = set()

    def typ(self, name: str, typ: str) -> None:
        if name not in self._typed:
            self._typed.add(name)
            self.lines.append(f"# TYPE {name} {typ}")

    def sample(self, name: str, labels: dict, value: Any) -> None:
        self.lines.append(f"{name}{_labels(labels)} {_fmt(value)}")


def _operator_lines(out: _Lines, graph: Any) -> None:
    out.typ("pathway_operator_rows_in", "counter")
    out.typ("pathway_operator_rows_out", "counter")
    out.typ("pathway_operator_seconds_total", "counter")
    for node in graph.nodes:
        labels = {
            "operator": type(node).__name__,
            "label": getattr(node, "label", None) or "",
            "id": node.node_id,
        }
        out.sample("pathway_operator_rows_in", labels, node.rows_in)
        out.sample("pathway_operator_rows_out", labels, node.rows_out)
        out.sample(
            "pathway_operator_seconds_total", labels,
            round(node.time_ns / 1e9, 6),
        )
    err = getattr(graph, "error_log", None)
    if err is not None:
        out.typ("pathway_errors_total", "counter")
        out.sample(
            "pathway_errors_total", {}, len(getattr(err, "entries", []))
        )


def _registry_lines(out: _Lines, registry: Any) -> None:
    for name, labels, kind, payload in registry.items():
        if kind == "histogram":
            out.typ(name, "histogram")
            for le, c in payload.cumulative():
                out.sample(name + "_bucket", {**labels, "le": _fmt(le)}, c)
            out.sample(name + "_sum", labels, round(payload.sum, 9))
            out.sample(name + "_count", labels, payload.count)
        else:
            out.typ(name, kind)
            out.sample(name, labels, payload)


def _mesh_lines(out: _Lines, mesh: Any) -> None:
    for key, val in mesh.stats.items():
        name = f"pathway_mesh_{key}_total"
        out.typ(name, "counter")
        out.sample(name, {}, val)
    out.typ("pathway_mesh_processes", "gauge")
    out.sample("pathway_mesh_processes", {}, mesh.n)
    out.typ("pathway_mesh_dead_peers", "gauge")
    out.sample("pathway_mesh_dead_peers", {}, len(mesh._dead))


def _device_lines(out: _Lines) -> None:
    # never CREATE the plane from a metrics scrape: only report one that
    # already exists (the singleton is built lazily by real dispatch use)
    from pathway_tpu_torch.engine import device_plane as dp_mod

    plane = dp_mod._plane
    if plane is None or not plane.programs:
        return
    out.typ("pathway_device_compiles", "gauge")
    out.typ("pathway_device_quarantined", "gauge")
    out.typ("pathway_device_host_fallbacks", "gauge")
    for (prog, bucket), n in plane.shape_counts().items():
        out.sample(
            "pathway_device_compiles",
            {"program": prog, "bucket": repr(bucket)}, n,
        )
    with plane._lock:
        progs = list(plane.programs)
    for name in progs:
        # a failed dispatch raises: no program ever degrades to the host
        out.sample("pathway_device_host_fallbacks", {"program": name}, 0)
    pools = plane.slot_pools()
    if pools:
        # continuous-batching occupancy straight off the plane, scrapable
        # even when the observability plane (and its counters) is off
        out.typ("pathway_serving_slot_pool", "gauge")
        for pname, snap in pools.items():
            for stat in ("active", "refills", "joined_inflight", "high_water"):
                out.sample(
                    "pathway_serving_slot_pool",
                    {"pool": pname, "stat": stat}, snap[stat],
                )


_BREAKER_STATES = {"closed": 0, "open": 1, "half_open": 2}


def _retry_lines(out: _Lines) -> None:
    policies = _obs.retry_policies()
    if not policies:
        return
    out.typ("pathway_breaker_state", "gauge")
    out.typ("pathway_retry_attempts", "gauge")
    out.typ("pathway_retry_retries", "gauge")
    for p in sorted(policies, key=lambda p: p.name):
        labels = {"policy": p.name}
        out.sample(
            "pathway_breaker_state", labels,
            _BREAKER_STATES.get(p.state, -1),
        )
        out.sample("pathway_retry_attempts", labels, p.attempts_total)
        out.sample("pathway_retry_retries", labels, p.retries_total)


def _fault_lines(out: _Lines) -> None:
    from pathway_tpu_torch.engine import faults

    if not faults.active():
        return
    out.typ("pathway_faults_fired", "gauge")
    out.sample("pathway_faults_fired", {}, len(faults.fired_log()))


def _scheduler_lines(out: _Lines, session: Any) -> None:
    graph = getattr(session, "graph", None)
    sched = getattr(graph, "scheduler", None) if graph is not None else None
    if sched is None:
        return
    out.typ("pathway_waves_fired_total", "counter")
    out.sample("pathway_waves_fired_total", {}, sched.waves_fired)


def _render_metrics(session: Any, started_at: float) -> str:
    out = _Lines()
    out.typ("pathway_uptime_seconds", "gauge")
    out.sample(
        "pathway_uptime_seconds", {}, round(time.time() - started_at, 3)
    )
    graph = getattr(session, "graph", None)
    if graph is not None:
        _operator_lines(out, graph)
    _scheduler_lines(out, session)
    plane = _obs.PLANE
    if plane is not None:
        _registry_lines(out, plane.metrics)
    mesh = getattr(session, "mesh", None)
    if mesh is not None:
        _mesh_lines(out, mesh)
    _device_lines(out)
    _retry_lines(out)
    _fault_lines(out)
    out.lines.append("# EOF")
    return "\n".join(out.lines) + "\n"


# ------------------------------------------------------------ statistics


def render_statistics(session: Any, started_at: float) -> dict:
    """One JSON document with the whole per-process observable state —
    the machine-readable sibling of /metrics (reference: the engine's
    per-process statistics route)."""
    stats: dict[str, Any] = {
        "uptime_s": round(time.time() - started_at, 3),
        "pid": os.getpid(),
        "process_id": int(os.environ.get("PATHWAY_PROCESS_ID", "0")),
    }
    graph = getattr(session, "graph", None)
    if graph is not None:
        stats["operators"] = [
            {
                "id": n.node_id,
                "operator": type(n).__name__,
                "label": getattr(n, "label", None) or "",
                "name": n.describe() if hasattr(n, "describe") else "",
                "rows_in": n.rows_in,
                "rows_out": n.rows_out,
                "latency_ms": round(n.time_ns / 1e6, 3),
                **(
                    {"replaced": True}
                    if getattr(n, "_replaced", False)
                    else {}
                ),
                **(
                    {"sketch": n.sketch()}
                    if hasattr(n, "sketch")
                    else {}
                ),
            }
            for n in graph.nodes
        ]
        # plan visibility (docs/planner.md): the optimizer's decisions —
        # fusion groups, pushdowns, join-order advice, adaptive replans —
        # so a fused plan is debuggable instead of opaque
        plan = getattr(graph, "plan_report", None)
        if plan is not None:
            stats["plan"] = plan
        stats["errors"] = len(getattr(graph.error_log, "entries", []))
        sched = getattr(graph, "scheduler", None)
        if sched is not None:
            # the pump thread mutates these dicts with no lock; a scrape
            # mid-mutation retries instead of 500ing the handler
            for _ in range(3):
                try:
                    stats["scheduler"] = {
                        "waves_fired": sched.waves_fired,
                        "pending_slots": sum(
                            1 for ts in sched._pending.values() if ts
                        ),
                        "async_holds": len(sched._async_waves),
                    }
                    break
                except RuntimeError:
                    continue
    stats["connectors"] = [
        {"name": c.name, "done": c.done}
        for c in getattr(session, "connectors", [])
    ]
    plane = _obs.PLANE
    if plane is not None:
        stats["run_id"] = plane.run_id
        stats["metrics"] = plane.metrics.snapshot()
    mesh = getattr(session, "mesh", None)
    if mesh is not None:
        with mesh._cv:  # recv threads add to _dead under this lock
            dead = sorted(mesh._dead)
        stats["mesh"] = {
            **mesh.stats,
            "processes": mesh.n,
            "dead_peers": dead,
            "data_frames_sent": mesh.data_frames_sent,
        }
    from pathway_tpu_torch.engine import device_plane as dp_mod

    if dp_mod._plane is not None and dp_mod._plane.programs:
        stats["device_plane"] = {
            "compiles": {
                f"{prog}/{bucket}": n
                for (prog, bucket), n in dp_mod._plane.shape_counts().items()
            },
            "quarantined": {},
            "slot_pools": dp_mod._plane.slot_pools(),
        }
    policies = _obs.retry_policies()
    if policies:
        stats["retry_policies"] = [
            {
                "policy": p.name,
                "state": p.state,
                "attempts": p.attempts_total,
                "retries": p.retries_total,
            }
            for p in sorted(policies, key=lambda p: p.name)
        ]
    from pathway_tpu_torch.engine import faults

    if faults.active():
        stats["faults_fired"] = [list(x) for x in faults.fired_log()]
    return stats


def start_metrics_server(session: Any, port: int | None = None) -> threading.Thread:
    if port is None:
        process_id = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
        port = 20000 + process_id
    started_at = time.time()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self) -> None:  # noqa: N802
            path = self.path.split("?", 1)[0].rstrip("/") or "/metrics"
            if path == "/statistics":
                body = json.dumps(
                    render_statistics(session, started_at), default=str
                ).encode()
                ctype = "application/json"
            elif path in ("/metrics", ""):
                body = _render_metrics(session, started_at).encode()
                ctype = "application/openmetrics-text; version=1.0.0"
            else:
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args: Any) -> None:  # silence request logs
            pass

    server = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread
