"""pw.run: lower all registered sinks and execute
(reference: internals/run.py:11 + graph_runner/__init__.py:113)."""

from __future__ import annotations

import json
import logging
from typing import Any

from pathway_tpu_torch.internals import observability as obs
from pathway_tpu_torch.internals.config import get_config
from pathway_tpu_torch.internals.lowering import Session
from pathway_tpu_torch.internals.parse_graph import G

logger = logging.getLogger("pathway_tpu_torch.run")

# The live session of a blocking pw.run (always-on serving processes run
# pw.run on a thread; shutdown hooks and tests stop it cooperatively).
_CURRENT: dict[str, Any] = {}


def current_session() -> Any:
    return _CURRENT.get("session")


def stop_current_run() -> None:
    """Cooperatively stop a streaming ``pw.run``: the pump closes its
    connectors at the next wave boundary and finalizes with the usual
    end-of-stream flush. No-op when nothing is running."""
    s = _CURRENT.get("session")
    if s is not None:
        s.stop_event.set()


def _arm_observability(
    observability: bool | None, profile: bool | str | None
) -> str | None:
    """Resolve the observability/profile switches (explicit args win over
    PATHWAY_OBSERVABILITY / PATHWAY_PROFILE) and return the profile
    output path, if profiling. The plane stays process-wide; the
    profiler is re-armed fresh per run so reports never mix runs."""
    profile_path: str | None = None
    if profile:
        profile_path = (
            "pathway_profile.json" if profile is True else str(profile)
        )
        obs.enable(profile=True)
    elif observability or observability is None:
        if observability:
            obs.enable()
        else:
            obs.maybe_enable_from_env()
        # PATHWAY_PROFILE is its own switch: honored whether the plane
        # came from the env or from an explicit observability=True
        profile_path = obs.profile_path_from_env()
        if profile_path is not None:
            obs.enable(profile=True)
    if profile_path is not None and obs.PLANE is not None:
        obs.PLANE.profiler = obs.Profiler()  # per-run window
    return profile_path


def run(
    *,
    debug: bool = False,
    monitoring_level: Any = None,
    with_http_server: bool = False,
    default_logging: bool = True,
    persistence_config: Any = None,
    license_key: str | None = None,
    runtime_typechecking: bool = True,
    terminate_on_error: bool = False,
    autocommit_duration_ms: int | None = None,
    device: str | None = None,
    observability: bool | None = None,
    profile: bool | str | None = None,
    **kwargs: Any,
) -> None:
    import time as _time

    profile_path = _arm_observability(observability, profile)
    _build_t0 = _time.perf_counter()
    session = Session()
    _CURRENT["session"] = session
    session.graph.terminate_on_error = terminate_on_error or get_config().terminate_on_error
    if autocommit_duration_ms:
        session.autocommit_ms = autocommit_duration_ms
    for hook in G.pre_run_hooks:
        hook()
    # plan optimizer context: the whole sink set is registered before
    # lowering starts, so the optimizer sees the full reachable spec DAG
    # (consumer counts for fusion, id observability for key elision).
    # subscribe callbacks receive row keys; output sinks declare whether
    # they do (io/fs file writers don't).
    session.attach_plan_roots(
        [s.table for s in G.sinks],
        sink_meta=[
            (
                s.table,
                s.kind != "output" or s.params.get("observes_ids", True),
            )
            for s in G.sinks
        ],
        persistent=persistence_config is not None,
    )
    for sink in G.sinks:
        if sink.kind == "subscribe":
            session.subscribe(
                sink.table,
                on_change=sink.params.get("on_change"),
                on_time_end=sink.params.get("on_time_end"),
                on_end=sink.params.get("on_end"),
            )
        elif sink.kind == "output":
            session.output(
                sink.table,
                sink.params["write_batch"],
                sink.params.get("flush"),
                sink.params.get("close"),
                write_native=sink.params.get("write_native"),
                # transactional-sink surfaces (io/outbox.py): keyed
                # idempotent writes + atomic epoch-commit hooks; dormant
                # unless persistence + exactly-once arm the outbox
                write_keyed=sink.params.get("write_keyed"),
                txn=sink.params.get("exactly_once"),
            )
        else:
            raise ValueError(f"unknown sink kind {sink.kind}")
    if with_http_server:
        from pathway_tpu_torch.internals.metrics import start_metrics_server

        start_metrics_server(session)
    if monitoring_level not in (None, False, "none"):
        from pathway_tpu_torch.internals.monitoring import attach_monitor

        attach_monitor(session)
    if persistence_config is not None:
        # wrap AFTER lowering: session.connectors only exist once the sinks
        # above have been lowered into engine nodes
        from pathway_tpu_torch.persistence import attach_persistence

        attach_persistence(session, persistence_config)
    # telemetry: OTLP when configured + SDK present, local JSONL via
    # PATHWAY_TELEMETRY_FILE otherwise (reference: telemetry.rs:436)
    from pathway_tpu_torch.internals.telemetry import attach_telemetry

    telemetry = attach_telemetry(session, get_config().monitoring_server)
    spine_exporter = None
    if obs.PLANE is not None:
        # graph build + lowering (incl. the session's one-time parallel/
        # jax machinery import) is its own profile stage — without it the
        # report would blame ~1s of library init on "unattributed"
        obs.PLANE.stage_seconds("build", _time.perf_counter() - _build_t0)
        if telemetry is not None:
            # observability-spine events flow out the telemetry pipe too
            spine_exporter = telemetry.export_event
            obs.PLANE.add_exporter(spine_exporter)
    dumps_before = (
        len(obs.PLANE.recorder.dumped) if obs.PLANE is not None else 0
    )
    try:
        if telemetry is not None:
            with telemetry.span("run"):
                session.execute()
        else:
            session.execute()
    except BaseException:
        # outer net for errors outside the runtime pumps (lowering,
        # persistence attach, static pump) — the pumps dump their own
        # richer record first, so skip if one already landed this run
        if (
            obs.PLANE is not None
            and len(obs.PLANE.recorder.dumped) == dumps_before
        ):
            obs.dump_flight("run-error")
        raise
    finally:
        # drop the cooperative-stop handle IF it is still ours — a
        # concurrent run on another thread may already have replaced it,
        # and stopping a finished session must stay a no-op (also frees
        # the session graph in long-lived serving processes)
        if _CURRENT.get("session") is session:
            _CURRENT.pop("session", None)
        # restore the terminal if the monitoring TUI was live
        for m in session.monitors:
            live = getattr(m, "live", None)
            if live is not None:
                try:
                    live.stop()
                except Exception:  # noqa: BLE001
                    pass
        if spine_exporter is not None and obs.PLANE is not None:
            obs.PLANE.remove_exporter(spine_exporter)
        if telemetry is not None:
            telemetry.operator_stats(session.graph)
            telemetry.shutdown()
    plane = obs.PLANE
    if plane is not None and plane.profiler is not None and profile_path:
        report = plane.profiler.report(session.graph)
        with open(profile_path, "w") as f:
            json.dump(report, f, indent=2)
        logger.info(
            "profile: %.2fs wall (%.1f%% attributed, ingest share %.1f%%)"
            " -> %s",
            report["total_s"], report["attributed_pct"],
            100.0 * report["ingest_share"], profile_path,
        )


def run_all(**kwargs: Any) -> None:
    run(**kwargs)
