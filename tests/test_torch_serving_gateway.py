"""The port's serving gateway (``pathway_tpu_torch/serving/``): the cases
of ``tests/test_serving_gateway.py`` run against the port.

Admission control, watermark backpressure and the gateway are host code
copied from the JAX package under the rename
(``tests/test_torch_host_copy.py`` holds the copies to the reference's
AST); these cases hold their behaviour on the port's engine and HTTP
connector to the same contracts: token buckets and the bounded queue,
shed and delay off the watermark-lag gauges, 429 with a Retry-After under
a burst, 503 before the pipeline runs and 504 when it never answers, and
no lost or cross-wired responses among concurrent REST clients.
"""

from __future__ import annotations

import contextlib
import socket
import threading
import time as _time

import pytest
import requests

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import observability as obs
from pathway_tpu_torch.internals import run as run_mod
from pathway_tpu_torch.internals.lowering import Session
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.serving import (
    AdmissionController,
    ServingGateway,
    TokenBucket,
    WatermarkBackpressure,
)


@pytest.fixture(autouse=True)
def _teardown_plane():
    G.clear()
    yield
    G.clear()
    obs.disable()


def run_capture(table: pw.Table):
    """tests/utils.py's helper on the port's engine."""
    session = Session()
    cap = session.capture(table)
    session.execute()
    return cap


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# -------------------------------------------------------- admission units


def test_token_bucket_burst_then_refusal_with_retry_after():
    b = TokenBucket(rate=10.0, burst=3.0)
    assert b.try_take() == 0.0
    assert b.try_take() == 0.0
    assert b.try_take() == 0.0
    wait = b.try_take()
    assert 0.0 < wait <= 0.11  # ~1 token / 10 rps
    _time.sleep(wait + 0.02)
    assert b.try_take() == 0.0  # refilled


def test_admission_queue_bound_and_release():
    ctl = AdmissionController("/r", max_queue=2)
    assert ctl.admit()
    assert ctl.admit()
    refused = ctl.admit()
    assert not refused and refused.reason == "queue_full"
    ctl.release()
    assert ctl.admit()  # freed capacity readmits
    assert ctl.stats["admitted"] == 3 and ctl.stats["shed"] == 1


def test_admission_bound_holds_under_concurrent_admits():
    """The queue check and the in-flight increment are one atomic
    reservation: a 50-thread stampede never overshoots max_queue."""
    ctl = AdmissionController("/r", max_queue=5)
    decisions: list[bool] = []
    lock = threading.Lock()

    def go() -> None:
        d = ctl.admit()
        with lock:
            decisions.append(bool(d))

    threads = [threading.Thread(target=go) for _ in range(50)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(decisions) == 5
    assert ctl.in_flight == 5


def test_conflicting_query_retention_args_fail_loudly():
    with pytest.raises(ValueError, match="conflicting"):
        pw.io.http.rest_connector(
            route="/x",
            schema=pw.schema_from_types(query=str, user=str),
            keep_queries=True,
            delete_completed_queries=True,
        )


def test_admission_tenant_isolation():
    ctl = AdmissionController("/r", tenant_rate=1.0, tenant_burst=1.0)
    assert ctl.admit("alice")
    blocked = ctl.admit("alice")  # alice's bucket is drained
    assert not blocked and blocked.reason == "tenant_rate"
    assert blocked.retry_after > 0.0
    assert ctl.admit("bob")  # bob is unaffected


def test_admission_tenant_table_is_bounded():
    ctl = AdmissionController(
        "/r", tenant_rate=100.0, tenant_burst=100.0, max_tenants=8
    )
    for i in range(20):  # attacker-controlled cardinality
        assert ctl.admit(f"t{i}")
    assert len(ctl._tenants) <= 8


# ------------------------------------------------------ backpressure units


def _set_lag(source: str, lag: float) -> None:
    obs.PLANE.metrics.gauge(
        "pathway_source_watermark_lag_seconds", lag, {"source": source}
    )


def test_backpressure_thresholds_off_the_lag_gauge():
    obs.enable()
    bp = WatermarkBackpressure(
        delay_lag_s=1.0, shed_lag_s=5.0, max_delay_s=0.4, poll_interval_s=0.0
    )
    _set_lag("src", 0.2)
    assert bp.decide() == ("ok", 0.0)
    _set_lag("src", 3.0)
    verdict, seconds = bp.decide()
    assert verdict == "delay" and 0.0 < seconds <= 0.4
    _set_lag("src", 8.0)
    verdict, seconds = bp.decide()
    assert verdict == "shed" and seconds >= 1.0
    assert bp.stats["shed"] == 1 and bp.stats["delayed"] == 1


def test_backpressure_watches_only_named_sources():
    obs.enable()
    bp = WatermarkBackpressure(
        delay_lag_s=1.0, shed_lag_s=2.0, poll_interval_s=0.0,
        sources=("mine",),
    )
    _set_lag("other", 99.0)  # a straggler the gateway does not serve
    assert bp.decide()[0] == "ok"
    _set_lag("mine", 3.0)
    assert bp.decide()[0] == "shed"


def test_backpressure_without_plane_is_noop():
    bp = WatermarkBackpressure(poll_interval_s=0.0)
    assert bp.decide() == ("ok", 0.0)


def test_gateway_backpressure_sheds_with_reason():
    obs.enable()
    gw = ServingGateway(
        max_queue=100,
        backpressure=WatermarkBackpressure(
            delay_lag_s=0.5, shed_lag_s=1.0, poll_interval_s=0.0
        ),
    )
    _set_lag("src", 2.0)
    d = gw.admit("/q", {})
    assert not d and d.reason == "backpressure" and d.retry_after >= 1.0
    assert gw.snapshot()["/q"]["shed"] == 1


# ---------------------------------------------------- live-pipeline harness


@contextlib.contextmanager
def _serving(writer_fn, gateway=None, timeout_s: float = 20.0, **rest_kw):
    """rest_connector + pipeline on a background pw.run; yields the port.
    Stops the run and the webserver on exit."""
    port = _free_port()
    ws = pw.io.http.PathwayWebserver(host="127.0.0.1", port=port)
    queries, writer = pw.io.http.rest_connector(
        webserver=ws,
        route="/q",
        schema=pw.schema_from_types(query=str, user=str),
        gateway=gateway,
        timeout_s=timeout_s,
        **rest_kw,
    )
    writer_fn(queries, writer)
    t = threading.Thread(target=pw.run, daemon=True)
    t.start()
    try:
        deadline = _time.time() + 15
        while _time.time() < deadline:
            try:
                r = requests.post(
                    f"http://127.0.0.1:{port}/q",
                    json={"query": "warmup", "user": "w"}, timeout=10,
                )
                if r.status_code != 503:
                    break
            except requests.ConnectionError:
                _time.sleep(0.05)
        yield port
    finally:
        run_mod.stop_current_run()
        ws.stop()
        t.join(timeout=20)


def _echo_pipeline(queries, writer):
    @pw.udf
    def answer(q: str) -> str:
        return f"ans:{q}"

    writer(queries.select(result=answer(pw.this.query)))


def test_concurrent_rest_clients_no_lost_or_crosswired_responses():
    """The satellite: N parallel clients against one live pipeline —
    every response matches its own request, none lost."""
    with _serving(_echo_pipeline) as port:
        results: dict[int, tuple[int, str | None]] = {}

        def hit(i: int) -> None:
            r = requests.post(
                f"http://127.0.0.1:{port}/q",
                json={"query": f"w{i}", "user": f"u{i}"}, timeout=20,
            )
            results[i] = (
                r.status_code, r.json() if r.status_code == 200 else None
            )

        threads = [
            threading.Thread(target=hit, args=(i,)) for i in range(24)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert len(results) == 24  # none lost
        assert all(code == 200 for code, _ in results.values()), results
        for i, (_code, body) in results.items():
            assert body == f"ans:w{i}"  # none cross-wired
        stats = pw.io.http.route_stats()["/q"]
        assert stats["pending"] == 0  # every future cleaned up
        assert stats["responses"] >= 24


def test_rest_gateway_sheds_with_429_and_retry_after():
    gw = ServingGateway(max_queue=2)

    def slow_pipeline(queries, writer):
        @pw.udf
        def answer(q: str) -> str:
            _time.sleep(0.2)
            return f"ans:{q}"

        writer(queries.select(result=answer(pw.this.query)))

    with _serving(slow_pipeline, gateway=gw) as port:
        results: list[requests.Response] = []
        lock = threading.Lock()

        def hit(i: int) -> None:
            r = requests.post(
                f"http://127.0.0.1:{port}/q",
                json={"query": f"w{i}", "user": "u"}, timeout=20,
            )
            with lock:
                results.append(r)

        threads = [
            threading.Thread(target=hit, args=(i,)) for i in range(10)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        codes = sorted(r.status_code for r in results)
        assert 429 in codes, codes  # the burst got shed
        assert 200 in codes, codes  # admitted ones answered
        for r in results:
            if r.status_code == 429:
                assert int(r.headers["Retry-After"]) >= 1
                assert r.json()["reason"] == "queue_full"
        assert gw.snapshot()["/q"]["shed"] >= 1


def test_rest_503_before_pipeline_runs():
    port = _free_port()
    ws = pw.io.http.PathwayWebserver(host="127.0.0.1", port=port)
    pw.io.http.rest_connector(
        webserver=ws, route="/q",
        schema=pw.schema_from_types(query=str, user=str),
    )
    ws.start()  # server up, pipeline NOT running
    try:
        r = requests.post(
            f"http://127.0.0.1:{port}/q",
            json={"query": "x", "user": "u"}, timeout=10,
        )
        assert r.status_code == 503
    finally:
        ws.stop()


def test_rest_504_when_the_pipeline_never_answers():
    def silent_pipeline(queries, writer):
        # the response table is empty: every future times out
        writer(queries.filter(pw.this.query == "__never__"))

    with _serving(silent_pipeline, timeout_s=1.0) as port:
        r = requests.post(
            f"http://127.0.0.1:{port}/q",
            json={"query": "x", "user": "u"}, timeout=15,
        )
        assert r.status_code == 504
        assert pw.io.http.route_stats()["/q"]["timeouts"] >= 1


# ------------------------------------------------------- io/http satellites


def test_webserver_bind_error_surfaces_to_the_caller():
    port = _free_port()
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", port))
    blocker.listen(1)
    try:
        ws = pw.io.http.PathwayWebserver(host="127.0.0.1", port=port)
        with pytest.raises(RuntimeError, match="failed to bind"):
            ws.start()
        with pytest.raises(RuntimeError, match="failed to bind"):
            ws.start()  # a failed start stays failed, loudly
    finally:
        blocker.close()


def test_webserver_stop_releases_the_port():
    port = _free_port()
    ws = pw.io.http.PathwayWebserver(host="127.0.0.1", port=port)
    ws.start()
    ws.stop()
    deadline = _time.time() + 5
    while True:
        probe = socket.socket()
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            probe.bind(("127.0.0.1", port))
            probe.close()
            break
        except OSError:
            probe.close()
            if _time.time() > deadline:
                raise
            _time.sleep(0.1)


def test_delete_completed_queries_retracts_answered_rows():
    events: list[tuple[str, bool]] = []

    def pipeline(queries, writer):
        pw.io.subscribe(
            queries,
            on_change=lambda key, row, time, is_addition: events.append(
                (row["query"], is_addition)
            ),
        )
        _echo_pipeline(queries, writer)

    with _serving(pipeline, delete_completed_queries=True) as port:
        r = requests.post(
            f"http://127.0.0.1:{port}/q",
            json={"query": "once", "user": "u"}, timeout=15,
        )
        assert r.status_code == 200
        deadline = _time.time() + 10
        while ("once", False) not in events and _time.time() < deadline:
            _time.sleep(0.05)
    assert ("once", True) in events  # the query row arrived...
    assert ("once", False) in events  # ...and was retracted on completion


def test_keep_queries_alias_maps_to_delete(caplog):
    events: list[tuple[str, bool]] = []

    def pipeline(queries, writer):
        pw.io.subscribe(
            queries,
            on_change=lambda key, row, time, is_addition: events.append(
                (row["query"], is_addition)
            ),
        )
        _echo_pipeline(queries, writer)

    # keep_queries=False == delete_completed_queries=True (deprecated alias)
    with _serving(pipeline, keep_queries=False) as port:
        r = requests.post(
            f"http://127.0.0.1:{port}/q",
            json={"query": "once", "user": "u"}, timeout=15,
        )
        assert r.status_code == 200
        deadline = _time.time() + 10
        while ("once", False) not in events and _time.time() < deadline:
            _time.sleep(0.05)
    assert ("once", False) in events


def test_http_read_failures_ride_the_retry_policy():
    """The bare-`pass` satellite: poll failures are retried under the
    unified policy (visible attempts/failures) instead of swallowed."""
    from pathway_tpu_torch.io._retry import RetryPolicy
    dead_port = _free_port()  # nothing listens here
    policy = RetryPolicy(
        "http.read:test", max_attempts=3, initial_delay_ms=1,
        jitter_ms=0, breaker_threshold=None,
    )
    t = pw.io.http.read(
        f"http://127.0.0.1:{dead_port}/feed",
        schema=pw.schema_from_types(data=str),
        mode="static",
        retry_policy=policy,
    )
    cap = run_capture(t)
    assert not cap.state.rows  # nothing arrived...
    assert policy.attempts_total == 3  # ...but the policy retried
    assert policy.retries_total == 2
    assert policy.last_error is not None


def test_http_read_breaker_opens_under_streaming_failures():
    from pathway_tpu_torch.io._retry import RetryPolicy

    dead_port = _free_port()
    policy = RetryPolicy(
        "http.read:breaker", max_attempts=1, initial_delay_ms=1,
        jitter_ms=0, breaker_threshold=2, breaker_reset_ms=60_000,
    )
    t = pw.io.http.read(
        f"http://127.0.0.1:{dead_port}/feed",
        schema=pw.schema_from_types(data=str),
        mode="streaming",
        refresh_interval_ms=10,
        retry_policy=policy,
    )
    seen: list = []
    pw.io.subscribe(t, on_change=lambda *a, **k: seen.append(a))
    run_thread = threading.Thread(target=pw.run, daemon=True)
    run_thread.start()
    try:
        deadline = _time.time() + 10
        while policy.state != "open" and _time.time() < deadline:
            _time.sleep(0.05)
        assert policy.state == "open"  # consecutive poll failures tripped it
        assert not seen
    finally:
        run_mod.stop_current_run()
        run_thread.join(timeout=15)


# -------------------------------------- chip_smoke's gateway_overload


REHEARSAL_EMBEDDER = dict(vocab_size=512, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32, embed_dim=32)


def test_gateway_overload_phase_rehearses_on_the_cpu():
    """chip_smoke's `gateway_overload` at a small size on the CPU: the
    loadgen's closed-loop clients against the retrieval server behind the
    gateway, then under a 20 ms straggler with and without it. Every
    answer equals a direct slab query of its own text, every refusal is a
    429 with Retry-After (the phase raises otherwise); under the straggler
    the gateway sheds and holds its queue, and without it every client
    piles up."""
    import chip_smoke

    texts = chip_smoke.load_texts(chip_smoke.ROOT)[:300]
    rungs = (
        ("clients_20", 20, 1.0, 8, 0.0),
        ("clients_200", 200, 1.0, 32, 0.0),
        ("straggler_gateway", 20, 1.0, 4, 20.0),
        ("straggler_no_gateway", 20, 1.0, None, 20.0),
    )
    res = chip_smoke.run_gateway_overload("cpu", REHEARSAL_EMBEDDER, texts, rungs=rungs)
    r = res["rungs"]
    assert res["answers_checked"] == sum(x["ok"] for x in r.values()) > 0
    assert res["mismatches"] == res["crossed"] == 0
    assert r["clients_200"]["max_pending"] <= 32
    assert r["straggler_gateway"]["shed_429"] > 0 and r["straggler_gateway"]["max_pending"] <= 4
    assert r["straggler_no_gateway"]["max_pending"] == 20 and r["straggler_no_gateway"]["shed_429"] == 0
    assert all(x["errors"] == x["timeouts"] == x["pending_after"] == 0 for x in r.values())
