"""AsyncTransformer: fully-decoupled async row->row processing.

Reference: stdlib/utils/async_transformer.py:282 — results loop back
through a Python connector, arriving at fresh engine timestamps so slow
async work never backpressures the upstream dataflow, with:
  * retraction handling — a retracted input row retracts its result;
  * `.successful` / `.failed` result tables (failures keyed by the input
    row, output columns None);
  * `with_options(capacity=…, retry_strategy=…, cache_strategy=…)` using
    the shared UDF machinery (internals/udfs.py);
  * open()/close() lifecycle hooks around the worker.
"""

from __future__ import annotations

import asyncio
import logging
import queue
import threading
from typing import Any

from pathway_tpu_torch.engine.runtime import Connector, InputSession, _get_async_loop
from pathway_tpu_torch.internals import universe as univ
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.analysis import lockgraph as _lockgraph
from pathway_tpu_torch.internals.table import OpSpec, Table
from pathway_tpu_torch.io._retry import log_degradation

logger = logging.getLogger("pathway_tpu_torch.stdlib.async_transformer")


class AsyncTransformer:
    """Subclass and implement `async def invoke(self, **kwargs) -> dict`.

    `output_schema` declares the result columns. `.successful` is the
    result table (keyed by the input row's key); `.failed` holds the rows
    whose invocation raised (after retries), with all output columns None.
    """

    output_schema: Any = None

    def __init__(self, input_table: Table, *, instance: Any = None, **kwargs: Any):
        assert self.output_schema is not None, "set output_schema"
        self._input_table = input_table
        self._queue: queue.Queue = queue.Queue()
        self._capacity: int | None = None
        self._retry_strategy: Any = None
        self._cached_fn: Any = None
        names = list(self.output_schema.__columns__)
        in_names = input_table._column_names()

        def on_change(key: Any, row: tuple, time: int, is_addition: bool) -> None:
            self._queue.put((key, dict(zip(in_names, row)), is_addition))

        def on_end() -> None:
            self._queue.put(None)

        G.add_sink("subscribe", input_table, on_change=on_change, on_end=on_end)

        transformer = self

        # Loopback workers: the subscribed input deltas drive async
        # invocations (bounded by `capacity`, wrapped in the retry
        # strategy); results insert into FRESH input sessions — the
        # decoupling the reference gets from its output-connector +
        # loopback pair. A side's session exists only if its table is
        # consumed by the pipeline (results for an unused side drop).
        ok_holder: dict[str, InputSession] = {}
        fail_holder: dict[str, InputSession] = {}

        def start_worker() -> None:
            loop = _get_async_loop()
            sem = (
                asyncio.Semaphore(self._capacity)
                if self._capacity
                else None
            )
            transformer.open()

            def run() -> None:
                pending: set = set()
                results: dict[Any, tuple] = {}  # key -> last emitted row
                # key -> generation: an in-flight invoke only publishes if
                # its generation is still live (a retraction or a newer
                # insert invalidates it — otherwise a slow invoke would
                # resurrect a retracted row)
                gens: dict[Any, int] = {}
                publish_lock = _lockgraph.register_lock(
                    "stdlib.async_transformer", threading.Lock()
                )
                while True:
                    item = transformer._queue.get()
                    if item is None:
                        break
                    key, row_dict, is_addition = item
                    if not is_addition:
                        with publish_lock:
                            gens.pop(key, None)
                            old = results.pop(key, None)
                            if old is not None:
                                side, out_row = old
                                sess = (ok_holder if side else fail_holder).get("s")
                                if sess is not None:
                                    sess.remove(key, out_row)
                        continue
                    with publish_lock:
                        gen = gens[key] = gens.get(key, 0) + 1

                    async def invoke_one(k=key, rd=row_dict, g=gen) -> None:
                        if sem is not None:
                            await sem.acquire()
                        try:
                            call = transformer._invoke
                            if transformer._retry_strategy is not None:
                                result = await transformer._retry_strategy.invoke(
                                    lambda: call(rd)
                                )
                            else:
                                result = await call(rd)
                            side, out_row = True, tuple(
                                result.get(n) for n in names
                            )
                        except Exception:  # noqa: BLE001 — failed side
                            side, out_row = False, tuple(None for _ in names)
                        finally:
                            if sem is not None:
                                sem.release()
                        with publish_lock:
                            if gens.get(k) != g:
                                return  # retracted/superseded while in flight
                            results[k] = (side, out_row)
                            sess = (ok_holder if side else fail_holder).get("s")
                            if sess is not None:
                                sess.insert(k, out_row)

                    fut = asyncio.run_coroutine_threadsafe(invoke_one(), loop)
                    pending.add(fut)
                    pending = {f for f in pending if not f.done()}
                for f in pending:
                    try:
                        f.result(timeout=60)
                    except Exception as e:  # noqa: BLE001 — per-row
                        # errors were already routed to the failure
                        # table inside invoke_one; this drain only
                        # absorbs teardown races, visibly
                        log_degradation(
                            logger, "async_transformer.drain", e
                        )
                transformer.close()

            t = threading.Thread(target=run, daemon=True, name="pw-async-xform")
            t.start()
            _worker_holder["t"] = t

        _worker_holder: dict[str, Any] = {}
        started = threading.Event()

        class _LoopbackConnector(Connector):
            """One per consumed side; the FIRST to start launches the
            shared worker (the other side's session may never exist if
            its table isn't used — results for it are dropped)."""

            holder: dict[str, InputSession]

            def start(self) -> None:
                self.holder["s"] = self.session
                if not started.is_set():
                    started.set()
                    start_worker()

            @property
            def done(self) -> bool:
                t = _worker_holder.get("t")
                return (
                    t is not None and not t.is_alive()
                    and not self.session._staged
                )

        class _OkConnector(_LoopbackConnector):
            holder = ok_holder

        class _FailConnector(_LoopbackConnector):
            holder = fail_holder

        ok_spec = OpSpec(
            "connector", [],
            factory=lambda s: _OkConnector("async-transformer", s),
            upsert=True,
        )
        fail_spec = OpSpec(
            "connector", [],
            factory=lambda s: _FailConnector("async-transformer-failed", s),
            upsert=True,
        )
        self._result = Table(ok_spec, self.output_schema, univ.Universe())
        self._failed = Table(fail_spec, self.output_schema, univ.Universe())

    # ------------------------------------------------------------- invoke

    async def _invoke(self, row_dict: dict) -> dict:
        if self._cached_fn is not None:
            return await self._cached_fn(**row_dict)
        return await self.invoke(**row_dict)

    async def invoke(self, **kwargs: Any) -> dict:
        raise NotImplementedError

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass

    # ------------------------------------------------------------- surface

    @property
    def successful(self) -> Table:
        return self._result

    @property
    def failed(self) -> Table:
        return self._failed

    @property
    def output_table(self) -> Table:
        return self._result

    def with_options(
        self,
        capacity: int | None = None,
        retry_strategy: Any = None,
        cache_strategy: Any = None,
    ) -> "AsyncTransformer":
        """Reference surface: bound concurrent invocations, wrap each in
        an AsyncRetryStrategy, and memoize through the given CacheStrategy
        (internals/udfs.py — InMemoryCache, DiskCache, …)."""
        if capacity is not None:
            self._capacity = capacity
        if retry_strategy is not None:
            self._retry_strategy = retry_strategy
        if cache_strategy is not None:
            async def _raw(**kwargs: Any) -> dict:
                return await self.invoke(**kwargs)

            self._cached_fn = cache_strategy.wrap(_raw)
        return self
