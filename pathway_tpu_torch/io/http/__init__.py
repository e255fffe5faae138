"""pw.io.http — REST ingress/egress + request-response over the dataflow.

Reference: io/http/_server.py (PathwayWebserver :329, rest_connector :624)
— an aiohttp server turns HTTP requests into rows of a streaming table; a
response writer subscribes to a result table and completes the pending
HTTP futures. This is the serving front of the RAG stack.

Admission control, per-tenant isolation and watermark backpressure live
one layer up: pass ``gateway=pw.serving.ServingGateway(...)`` to
:func:`rest_connector` and over-limit requests get 429 + Retry-After at
the edge instead of piling futures into the pending map
(docs/serving.md §6).
"""

from __future__ import annotations

import asyncio
import logging
import math as _math
import json as _json
import threading
import time as _time
from typing import Any, Callable

from pathway_tpu_torch.engine.runtime import Connector, InputSession
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import observability as _obs
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals import universe as univ
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.keys import Key, sequential_key
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import OpSpec, Table
from pathway_tpu_torch.analysis import lockgraph as _lockgraph

_LOG = logging.getLogger("pathway_tpu_torch.io.http")

# Per-route ingress stats (pending response futures, totals). This is
# the observable that distinguishes "the edge said no" from "futures
# piled up": the serving load bench reads max_pending in its no-gateway
# control run, and the metrics registry mirrors the live depth as
# pathway_serving_pending_futures{route}.
_ROUTE_STATS: dict[str, dict] = {}
_ROUTE_STATS_LOCK = _lockgraph.register_lock(
    "io.http_route_stats", threading.Lock()
)


def route_stats() -> dict[str, dict]:
    """Snapshot of per-route ingress counters ({route: {pending,
    max_pending, requests, responses, timeouts}})."""
    with _ROUTE_STATS_LOCK:
        return {r: dict(s) for r, s in _ROUTE_STATS.items()}


class PathwayWebserver:
    """One aiohttp server shared by any number of rest_connector routes.

    ``start()`` raises in the CALLER when the bind fails (port already
    taken, bad host): the server thread records the error, never enters
    ``run_forever``, and the starter re-raises it — previously the
    thread died silently and ``_ready.wait`` just timed out, leaving the
    pipeline up with no ingress. ``stop()`` shuts the loop down and
    releases the socket.
    """

    def __init__(self, host: str = "0.0.0.0", port: int = 8080, with_cors: bool = False):
        self.host = host
        self.port = port
        self.with_cors = with_cors
        self._routes: list[tuple[str, list[str], Callable]] = []
        self._started = False
        self._loop: asyncio.AbstractEventLoop | None = None
        self._ready = threading.Event()
        self._error: BaseException | None = None
        self._runner: Any = None

    def add_route(self, route: str, methods: list[str], handler: Callable) -> None:
        self._routes.append((route, methods, handler))

    def start(self) -> None:
        if self._started:
            if self._error is not None:  # a failed start stays failed
                raise RuntimeError(
                    f"webserver failed to bind {self.host}:{self.port}"
                ) from self._error
            return
        self._started = True
        import aiohttp.web as web

        def run() -> None:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            app = web.Application()
            for route, methods, handler in self._routes:
                for m in methods:
                    app.router.add_route(m, route, handler)

            async def main() -> None:
                runner = web.AppRunner(app)
                await runner.setup()
                site = web.TCPSite(runner, self.host, self.port)
                await site.start()
                self._runner = runner

            try:
                loop.run_until_complete(main())
            except BaseException as e:  # noqa: BLE001 — surfaced to the caller
                self._error = e
                self._ready.set()
                loop.close()
                return
            self._ready.set()
            loop.run_forever()
            # stop() ended the loop: release the socket before exiting
            if self._runner is not None:
                loop.run_until_complete(self._runner.cleanup())
            loop.close()

        threading.Thread(target=run, daemon=True, name="pw-webserver").start()
        if not self._ready.wait(timeout=10):
            raise TimeoutError(
                f"webserver on {self.host}:{self.port} did not start within 10s"
            )
        if self._error is not None:
            raise RuntimeError(
                f"webserver failed to bind {self.host}:{self.port}"
            ) from self._error

    def stop(self) -> None:
        """Stop the server loop and release the port (idempotent)."""
        loop = self._loop
        if (
            loop is not None
            and not loop.is_closed()
            and self._error is None
            and self._ready.is_set()
        ):
            try:
                loop.call_soon_threadsafe(loop.stop)
            except RuntimeError:
                pass  # lost the race against the loop closing itself


class _RestConnector(Connector):
    """Never-finishing connector fed by HTTP requests."""

    def __init__(self, name: str, session: InputSession):
        super().__init__(name, session)

    def start(self) -> None:
        pass

    @property
    def done(self) -> bool:
        return False


def rest_connector(
    host: str | None = None,
    port: int | None = None,
    *,
    webserver: PathwayWebserver | None = None,
    route: str = "/",
    methods: tuple[str, ...] = ("POST",),
    schema: Any = None,
    autocommit_duration_ms: int | None = 50,
    keep_queries: bool | None = None,
    delete_completed_queries: bool | None = None,
    request_validator: Callable | None = None,
    gateway: Any = None,
    timeout_s: float = 120.0,
) -> tuple[Table, Callable[[Table], None]]:
    """Returns (queries_table, response_writer).

    ``delete_completed_queries=True`` retracts a query row from the table
    once its HTTP exchange finishes (response delivered or timed out), so
    a long-lived serving process keeps a bounded queries table instead of
    accreting every request ever made. ``keep_queries`` is the reference's
    deprecated inverse alias — passing it explicitly maps to
    ``delete_completed_queries = not keep_queries``.

    ``gateway`` (a :class:`pathway_tpu_torch.serving.ServingGateway`) puts
    admission control and watermark backpressure in front of the row
    insert: refused requests answer 429 with a ``Retry-After`` header and
    never touch the pipeline.
    """
    import aiohttp.web as web

    if keep_queries is not None and delete_completed_queries is not None:
        if keep_queries == delete_completed_queries:
            raise ValueError(
                f"conflicting rest_connector arguments: keep_queries="
                f"{keep_queries} and delete_completed_queries="
                f"{delete_completed_queries} ask for opposite behavior"
            )
    elif keep_queries is not None:
        _LOG.warning(
            "rest_connector(keep_queries=...) is deprecated; use "
            "delete_completed_queries=%s", not keep_queries,
        )
        delete_completed_queries = not keep_queries
    delete_completed_queries = bool(delete_completed_queries)
    if webserver is None:
        webserver = PathwayWebserver(host or "0.0.0.0", port or 8080)
    if schema is None:
        schema = sch.schema_from_types(query=str, user=str)
    names = list(schema.__columns__)
    defaults = schema.default_values()

    pending: dict[int, asyncio.Future] = {}
    pending_lock = _lockgraph.register_lock(
        "io.http_pending", threading.Lock()
    )
    session_holder: dict[str, InputSession] = {}
    stats = {
        "pending": 0, "max_pending": 0, "requests": 0, "responses": 0,
        "timeouts": 0,
    }
    with _ROUTE_STATS_LOCK:
        _ROUTE_STATS[route] = stats

    def _gauge_pending(depth: int) -> None:
        # called OUTSIDE pending_lock: the registry has its own lock and
        # per-request bookkeeping must not serialize handlers behind it
        if _obs.PLANE is not None:
            _obs.PLANE.metrics.gauge(
                "pathway_serving_pending_futures", depth, {"route": route},
                help="response futures currently awaiting the pipeline",
            )

    async def handler(request: "web.Request") -> "web.Response":
        if request.method in ("POST", "PUT", "PATCH"):
            try:
                payload = await request.json()
            except Exception:  # noqa: BLE001
                payload = {}
        else:
            payload = dict(request.query)
        if request_validator is not None:
            try:
                request_validator(payload)
            except Exception as e:  # noqa: BLE001
                return web.json_response({"error": str(e)}, status=400)
        admitted = False
        if gateway is not None:
            decision = await gateway.admit_async(route, payload)
            if not decision:
                return web.json_response(
                    {"error": "too many requests", "reason": decision.reason},
                    status=429,
                    headers={
                        "Retry-After": str(
                            max(int(_math.ceil(decision.retry_after)), 1)
                        )
                    },
                )
            admitted = True
        try:
            row = []
            for n in names:
                if n in payload:
                    v = payload[n]
                    if isinstance(v, (dict, list)):
                        v = Json(v)
                    row.append(v)
                elif n in defaults:
                    row.append(defaults[n])
                else:
                    row.append(None)
            key = sequential_key()
            # the handler runs ON the webserver's loop: bind the future
            # there explicitly (get_event_loop is deprecated inside
            # coroutines and can pick the wrong loop under re-entrancy)
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            sess = session_holder.get("session")
            if sess is None:
                return web.json_response(
                    {"error": "pipeline not running"}, status=503
                )
            with pending_lock:
                pending[key.value] = fut
                stats["requests"] += 1
                stats["pending"] += 1
                depth = stats["pending"]
                stats["max_pending"] = max(stats["max_pending"], depth)
            _gauge_pending(depth)
            inserted = False
            try:
                # inside the try: an insert failure (session closing)
                # must still run the finally below, or the pending entry
                # and its gauge increment leak for the process lifetime
                sess.insert(key, tuple(row))
                inserted = True
                result = await asyncio.wait_for(fut, timeout=timeout_s)
                stats["responses"] += 1
            except asyncio.TimeoutError:
                stats["timeouts"] += 1
                return web.json_response({"error": "timeout"}, status=504)
            finally:
                with pending_lock:
                    pending.pop(key.value, None)
                    stats["pending"] -= 1
                    depth = stats["pending"]
                _gauge_pending(depth)
                if delete_completed_queries and inserted:
                    # the exchange is over: retract the query row so the
                    # serving tables stay bounded (the retraction flows
                    # through the pipeline and removes the response row)
                    sess.remove(key, tuple(row))
            if isinstance(result, Json):
                result = result.value
            return web.json_response(result, dumps=lambda obj: Json.dumps(obj))
        finally:
            if admitted:
                gateway.release(route)

    webserver.add_route(route, list(methods), handler)

    def factory(session: InputSession) -> _RestConnector:
        session_holder["session"] = session
        return _RestConnector(f"rest:{route}", session)

    spec = OpSpec("connector", [], factory=factory, upsert=False)
    queries = Table(spec, schema, univ.Universe())

    G.pre_run_hooks.append(webserver.start)

    def response_writer(response_table: Table) -> None:
        rnames = response_table._column_names()
        try:
            result_idx = rnames.index("result")
        except ValueError:
            result_idx = 0

        def write_batch(time: int, entries: list) -> None:
            for key, row, diff in entries:
                if diff <= 0:
                    continue
                with pending_lock:
                    fut = pending.get(key.value)
                if fut is not None and not fut.done():
                    loop = fut.get_loop()
                    loop.call_soon_threadsafe(
                        lambda f=fut, v=row[result_idx]: (not f.done()) and f.set_result(v)
                    )

        G.add_sink("output", response_table, write_batch=write_batch)

    return queries, response_writer


# --- egress: per-row HTTP requests ---------------------------------------


def write(
    table: Table,
    url: str,
    *,
    method: str = "POST",
    format: str = "json",  # noqa: A002
    headers: dict[str, str] | None = None,
    n_retries: int = 0,
    retry_policy: Any = None,
    **kwargs: Any,
) -> None:
    """Per-row HTTP egress. Retries ride the unified ``pw.io.RetryPolicy``
    — pass one via ``retry_policy`` (wins over ``n_retries``), or set
    ``n_retries`` to get a policy with the legacy fixed 0.5 s spacing."""
    import requests as _requests

    from pathway_tpu_torch.io._retry import RetryPolicy

    names = table._column_names()
    if retry_policy is None:
        retry_policy = RetryPolicy(
            f"http:{url}",
            max_attempts=n_retries + 1,
            initial_delay_ms=500,
            backoff_factor=1.0,
            jitter_ms=0,
            breaker_threshold=None,
        )

    def _write(time: int, entries: list, ids: list | None = None) -> None:
        for i, (_key, row, diff) in enumerate(entries):
            payload = dict(zip(names, row))
            payload["time"] = time
            payload["diff"] = diff
            hdrs = headers
            if ids is not None:
                # exactly-once replay safety (io/outbox.py): a stable
                # content key per request — receivers drop exact repeats
                hdrs = {**(headers or {}), "X-Pathway-Msg-Id": str(ids[i])}
            retry_policy.call(
                _requests.request,
                method, url, json=_json.loads(Json.dumps(payload)),
                headers=hdrs, timeout=30,
            )

    G.add_sink(
        "output", table,
        write_batch=lambda time, entries: _write(time, entries),
        write_keyed=_write,
    )


def read(
    url: str,
    *,
    schema: Any = None,
    format: str = "json",  # noqa: A002
    refresh_interval_ms: int = 10000,
    mode: str = "streaming",
    retry_policy: Any = None,
    **kwargs: Any,
) -> Table:
    """Poll an HTTP endpoint and stream its (JSON) rows.

    Poll failures ride the unified ``pw.io.RetryPolicy`` (pass your own
    via ``retry_policy``): transient errors retry with backoff inside one
    poll, consecutive failures open the circuit breaker (visible in
    /metrics like every other connector), and in streaming mode the
    poller keeps its cadence through an open breaker instead of silently
    swallowing errors. In static mode the connector logs an ERROR and
    finishes empty once the policy gives up."""
    import requests as _requests

    from pathway_tpu_torch.engine.runtime import ThreadConnector
    from pathway_tpu_torch.internals.keys import key_for_values
    from pathway_tpu_torch.io._retry import CircuitOpen, RetryPolicy

    if schema is None:
        schema = sch.schema_from_types(data=dt.JSON)
    names = list(schema.__columns__)
    pk = schema.primary_key_columns()
    if retry_policy is None:
        retry_policy = RetryPolicy(f"http.read:{url}", max_attempts=3)

    def poll_once(sess: InputSession) -> None:
        resp = _requests.get(url, timeout=30)
        data = resp.json()
        records = data if isinstance(data, list) else [data]
        for rec in records:
            row = tuple(
                Json(rec.get(n)) if isinstance(rec.get(n), (dict, list)) else rec.get(n)
                for n in names
            )
            key = (
                key_for_values(*[rec.get(c) for c in pk])
                if pk
                else key_for_values(Json.dumps(rec))
            )
            sess.insert(key, row)

    def factory(session: InputSession):
        def run_fn(sess: InputSession) -> None:
            last_logged: str | None = None
            while True:
                try:
                    retry_policy.call(poll_once, sess)
                    last_logged = None
                except CircuitOpen:
                    pass  # breaker already logged the open transition
                except Exception as e:  # noqa: BLE001 — poller must keep cadence
                    if mode == "static":
                        _LOG.error(
                            "http static read of %s failed after retries: "
                            "%s: %s", url, type(e).__name__, e,
                        )
                        return
                    msg = f"{type(e).__name__}: {e}"
                    if msg != last_logged:  # once per distinct failure
                        last_logged = msg
                        _LOG.warning("http poll of %s failed: %s", url, msg)
                if mode == "static":
                    return
                _time.sleep(refresh_interval_ms / 1000.0)

        return ThreadConnector(f"http:{url}", session, run_fn)

    spec = OpSpec("connector", [], factory=factory, upsert=pk is not None)
    return Table(spec, schema, univ.Universe())
