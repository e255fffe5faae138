"""Telemetry: traces + metrics export.

Reference parity: src/engine/telemetry.rs:436 — an OTLP exporter for run
spans and engine metrics, configured from the monitoring server setting.
Here the OpenTelemetry SDK is used when installed and an endpoint is
configured; otherwise a local JSONL exporter (PATHWAY_TELEMETRY_FILE)
records the same spans/metrics so runs remain observable in any
environment. Span structure mirrors the reference: one `run` root span,
`wave` spans per finalized timestamp (sampled), `checkpoint` spans, and
periodic operator-stats metric flushes.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any
from pathway_tpu_torch.analysis import lockgraph as _lockgraph

_LOCK = _lockgraph.register_lock("telemetry.registry", threading.Lock())


class _LocalExporter:
    """JSONL spans/metrics when no OTLP stack is available."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def export(self, record: dict) -> None:
        with _LOCK:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def shutdown(self) -> None:
        with _LOCK:
            self._f.close()


_OTLP_PROVIDERS: dict[str, Any] = {}


class _OtlpExporter:
    """Real OpenTelemetry export (requires the opentelemetry-sdk +
    exporter packages and a collector endpoint). The TracerProvider is a
    process-wide singleton per endpoint and is NOT installed globally —
    a second pw.run() in the same process keeps exporting (installing
    globally would make later set_tracer_provider calls no-ops against a
    shut-down provider)."""

    def __init__(self, endpoint: str, run_id: str):
        from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
            OTLPSpanExporter,
        )
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import BatchSpanProcessor

        provider = _OTLP_PROVIDERS.get(endpoint)
        if provider is None:
            resource = Resource.create({"service.name": "pathway-tpu"})
            provider = TracerProvider(resource=resource)
            provider.add_span_processor(
                BatchSpanProcessor(OTLPSpanExporter(endpoint=endpoint))
            )
            _OTLP_PROVIDERS[endpoint] = provider
        self._provider = provider
        self._tracer = provider.get_tracer("pathway_tpu_torch")
        self.run_id = run_id

    def export(self, record: dict) -> None:
        # spans are emitted directly through the tracer; metric records
        # become span events on a short-lived span
        span = self._tracer.start_span(record.get("name", "metric"))
        for k, v in record.items():
            if isinstance(v, (str, int, float, bool)):
                span.set_attribute(k, v)
        span.end()

    def shutdown(self) -> None:
        # flush only: the provider is shared across runs in this process
        self._provider.force_flush()


class Telemetry:
    """Span/metric recorder; construct via Telemetry.create()."""

    def __init__(self, exporter: Any, run_id: str):
        self.exporter = exporter
        self.run_id = run_id

    @classmethod
    def create(cls, endpoint: str | None = None) -> "Telemetry | None":
        """Endpoint resolution: explicit arg > PATHWAY_MONITORING_SERVER
        (OTLP) > PATHWAY_TELEMETRY_FILE (local JSONL) > disabled."""
        run_id = str(uuid.uuid4())
        endpoint = endpoint or os.environ.get("PATHWAY_MONITORING_SERVER")
        if endpoint:
            try:
                return cls(_OtlpExporter(endpoint, run_id), run_id)
            except ImportError:
                pass  # no OTel SDK: fall through to the local exporter
        path = os.environ.get("PATHWAY_TELEMETRY_FILE")
        if path:
            return cls(_LocalExporter(path), run_id)
        return None

    # ----------------------------------------------------------- recording

    def span(self, name: str, **attrs: Any) -> "_Span":
        return _Span(self, name, attrs)

    def metric(self, name: str, value: float, **attrs: Any) -> None:
        self.exporter.export(
            {
                "kind": "metric",
                "name": name,
                "value": value,
                "run_id": self.run_id,
                "ts": time.time(),
                **attrs,
            }
        )

    def operator_stats(self, graph: Any) -> None:
        """Flush per-operator probes (rows in/out, cumulative latency) —
        the reference's OperatorStats export (graph.rs:988-995)."""
        for node in graph.nodes:
            self.exporter.export(
                {
                    "kind": "operator",
                    "operator": type(node).__name__,
                    "label": getattr(node, "label", None) or "",
                    "id": node.node_id,
                    "rows_in": node.rows_in,
                    "rows_out": node.rows_out,
                    "latency_ms": node.time_ns / 1e6,
                    "run_id": self.run_id,
                    "ts": time.time(),
                }
            )

    def export_event(self, event: dict) -> None:
        """Observability-spine subscriber: structured events (faults,
        breaker flips, device quarantines, mesh quiesces) flow out the
        same JSONL/OTLP pipe as spans and metrics. High-volume wave spans
        are ring-only by design (observability.ObservabilityPlane.record
        export=False) — they arrive as histograms instead."""
        self.exporter.export(
            {"kind": "event", "run_id": self.run_id, **event}
        )

    def shutdown(self) -> None:
        self.exporter.shutdown()


class _Span:
    def __init__(self, telemetry: Telemetry, name: str, attrs: dict):
        self.telemetry = telemetry
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.telemetry.exporter.export(
            {
                "kind": "span",
                "name": self.name,
                "duration_ms": (time.perf_counter() - self.t0) * 1e3,
                "error": bool(exc[0]),
                "run_id": self.telemetry.run_id,
                "ts": time.time(),
                **self.attrs,
            }
        )


def attach_telemetry(session: Any, endpoint: str | None = None) -> Telemetry | None:
    """Wire run telemetry into a session: wave metrics every flush
    interval + operator stats, and a final flush at end of run."""
    telemetry = Telemetry.create(endpoint)
    if telemetry is None:
        return None
    state = {"waves": 0, "last_flush": time.monotonic()}

    def monitor(wave_time: int) -> None:
        state["waves"] += 1
        now = time.monotonic()
        if now - state["last_flush"] >= 1.0:
            state["last_flush"] = now
            telemetry.metric("pathway.waves", state["waves"], time=wave_time)
            telemetry.operator_stats(session.graph)

    session.monitors.append(monitor)
    return telemetry


__all__ = ["Telemetry", "attach_telemetry"]
