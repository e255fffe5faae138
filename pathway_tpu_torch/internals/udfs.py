"""UDF system: @pw.udf with caching, retries, batching, async executors.

Reference: internals/udfs/__init__.py (UDF :68, @pw.udf :290),
executors.py, caches.py, retries.py. TPU addition: `batched=True` UDFs
receive a list of argument batches per engine wave — the path by which
JAX-jitted embedders get full batches instead of row-at-a-time calls.
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import inspect
import json
import os
import pickle
import random
import time
import typing
from typing import Any, Callable

from pathway_tpu_torch.internals import expression as ex


# ------------------------------------------------------------------ caches


class CacheStrategy:
    def wrap(self, fn: Callable) -> Callable:
        raise NotImplementedError


class InMemoryCache(CacheStrategy):
    """Per-run in-memory memoization (reference: caches.py InMemoryCache)."""

    def wrap(self, fn: Callable) -> Callable:
        cache: dict[str, Any] = {}

        if asyncio.iscoroutinefunction(fn):
            lock: dict[str, asyncio.Future] = {}

            @functools.wraps(fn)
            async def awrapper(*args: Any, **kwargs: Any) -> Any:
                key = _cache_key(args, kwargs)
                if key in cache:
                    return cache[key]
                result = await fn(*args, **kwargs)
                cache[key] = result
                return result

            return awrapper

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            key = _cache_key(args, kwargs)
            if key in cache:
                return cache[key]
            result = fn(*args, **kwargs)
            cache[key] = result
            return result

        return wrapper


class DiskCache(CacheStrategy):
    """Persistent cache under the persistence dir (reference: caches.py:35)."""

    def __init__(self, name: str | None = None):
        self.name = name

    def wrap(self, fn: Callable) -> Callable:
        from pathway_tpu_torch.internals.config import get_config

        base = get_config().persistent_storage_path or os.path.join(
            os.getcwd(), ".pathway-cache"
        )
        cache_dir = os.path.join(base, "udf-cache", self.name or fn.__name__)
        os.makedirs(cache_dir, exist_ok=True)

        def path_for(key: str) -> str:
            return os.path.join(cache_dir, key)

        def load(key: str) -> tuple[bool, Any]:
            p = path_for(key)
            if os.path.exists(p):
                with open(p, "rb") as f:
                    return True, pickle.load(f)  # noqa: S301
            return False, None

        def store(key: str, value: Any) -> None:
            with open(path_for(key), "wb") as f:
                pickle.dump(value, f)

        if asyncio.iscoroutinefunction(fn):
            @functools.wraps(fn)
            async def awrapper(*args: Any, **kwargs: Any) -> Any:
                key = _cache_key(args, kwargs)
                hit, val = load(key)
                if hit:
                    return val
                val = await fn(*args, **kwargs)
                store(key, val)
                return val

            return awrapper

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            key = _cache_key(args, kwargs)
            hit, val = load(key)
            if hit:
                return val
            val = fn(*args, **kwargs)
            store(key, val)
            return val

        return wrapper


DefaultCache = DiskCache


def _cache_key(args: tuple, kwargs: dict) -> str:
    try:
        blob = json.dumps([repr(args), repr(sorted(kwargs.items()))], sort_keys=True)
    except Exception:  # noqa: BLE001
        blob = repr((args, kwargs))
    return hashlib.sha256(blob.encode()).hexdigest()


# ----------------------------------------------------------------- retries


class AsyncRetryStrategy:
    async def invoke(self, fn: Callable, /, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError


class NoRetryStrategy(AsyncRetryStrategy):
    async def invoke(self, fn: Callable, /, *args: Any, **kwargs: Any) -> Any:
        return await fn(*args, **kwargs)


class ExponentialBackoffRetryStrategy(AsyncRetryStrategy):
    """Reference: retries.py ExponentialBackoffRetryStrategy."""

    def __init__(
        self,
        max_retries: int = 3,
        initial_delay: int = 1000,
        backoff_factor: float = 2,
        jitter_ms: int = 300,
    ):
        self.max_retries = max_retries
        self.initial_delay = initial_delay / 1000
        self.backoff_factor = backoff_factor
        self.jitter = jitter_ms / 1000

    async def invoke(self, fn: Callable, /, *args: Any, **kwargs: Any) -> Any:
        delay = self.initial_delay
        for attempt in range(self.max_retries + 1):
            try:
                return await fn(*args, **kwargs)
            except Exception:  # noqa: BLE001
                if attempt == self.max_retries:
                    raise
                await asyncio.sleep(delay + random.random() * self.jitter)
                delay *= self.backoff_factor
        raise AssertionError("unreachable")


class FixedDelayRetryStrategy(ExponentialBackoffRetryStrategy):
    def __init__(self, max_retries: int = 3, delay_ms: int = 1000):
        super().__init__(max_retries, delay_ms, 1, 0)


# --------------------------------------------------------------- executors


class Executor:
    kind = "auto"

    def __init__(self, **kwargs: Any):
        self.kwargs = kwargs


def auto_executor() -> Executor:
    return Executor()


def sync_executor() -> Executor:
    e = Executor()
    e.kind = "sync"
    return e


def async_executor(
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
) -> Executor:
    e = Executor(capacity=capacity, timeout=timeout, retry_strategy=retry_strategy)
    e.kind = "async"
    return e


def fully_async_executor(
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
) -> Executor:
    e = Executor(capacity=capacity, timeout=timeout, retry_strategy=retry_strategy)
    e.kind = "fully_async"
    return e


# --------------------------------------------------------------------- UDF


class UDF:
    """User-defined function applied to table columns.

    Subclass with `__wrapped__`, or use the @udf decorator. Calling the UDF
    on column expressions builds the right Apply expression; async functions
    lower onto the engine's async-apply operator.
    """

    def __init__(
        self,
        *,
        return_type: Any = None,
        deterministic: bool = False,
        propagate_none: bool = False,
        executor: Executor | None = None,
        cache_strategy: CacheStrategy | None = None,
        max_batch_size: int | None = None,
        batched: bool = False,
    ):
        self.return_type = return_type
        self.deterministic = deterministic
        self.propagate_none = propagate_none
        self.executor = executor or auto_executor()
        self.cache_strategy = cache_strategy
        self.max_batch_size = max_batch_size
        # batched=True: __wrapped__ receives LISTS (one per argument,
        # whole coalesced wave) and returns a list of per-row results —
        # the path by which JAX-jitted functions get full device batches.
        # Dispatch rides the device plane's wave coalescer + async-apply,
        # so batches coalesce across concurrently admitted waves and a
        # slow batch never blocks other stages (stage overlap).
        self.batched = batched
        if batched and cache_strategy is not None:
            raise ValueError(
                "batched=True UDFs do not compose with cache_strategy "
                "(per-row caches would bypass the coalesced dispatch)"
            )
        # one coalescer PER CALL SIGNATURE (arity + kwarg names): call
        # sites with different shapes must never share a flush, or the
        # column transpose would silently truncate to the shortest row
        self._coalescers: dict[Any, Any] = {}
        self._prepared: Callable | None = None

    def __wrapped__(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError

    @property
    def func(self) -> Callable:
        if self._prepared is None:
            fn = self.__wrapped__
            if self.cache_strategy is not None:
                fn = self.cache_strategy.wrap(fn)
            cap = self.executor.kwargs.get("capacity")
            timeout = self.executor.kwargs.get("timeout")
            retry = self.executor.kwargs.get("retry_strategy")
            if asyncio.iscoroutinefunction(self.__wrapped__):
                fn = _wrap_async(fn, cap, timeout, retry)
            self._prepared = fn
        return self._prepared

    def _return_type(self) -> Any:
        if self.return_type is not None:
            return self.return_type
        try:
            hints = typing.get_type_hints(self.__wrapped__)
            return hints.get("return", Any)
        except Exception:  # noqa: BLE001
            return Any

    # ------------------------------------------------------- batched path

    def _flush_batch(self, items: list[tuple[tuple, dict]]) -> list:
        """Transpose a coalesced wave into per-argument lists and run the
        wrapped function ONCE over the whole batch."""
        args_cols = [list(col) for col in zip(*(it[0] for it in items))]
        kw_keys = items[0][1].keys() if items else ()
        kwargs_cols = {k: [it[1][k] for it in items] for k in kw_keys}
        out = list(self.__wrapped__(*args_cols, **kwargs_cols))
        if len(out) != len(items):
            raise ValueError(
                f"batched UDF returned {len(out)} results for "
                f"{len(items)} rows"
            )
        return out

    def _batched_expression(
        self, args: tuple, kwargs: dict, rt: Any
    ) -> ex.ColumnExpression:
        if asyncio.iscoroutinefunction(self.__wrapped__):
            raise ValueError(
                "batched=True UDFs must be synchronous (the batch runs "
                "on the device-plane dispatch pool, off the event loop)"
            )
        # the function signature is batch-in/batch-out: unwrap the row
        # type from a list[T] annotation
        if typing.get_origin(rt) is list and typing.get_args(rt):
            rt = typing.get_args(rt)[0]
        sig = (len(args), tuple(sorted(kwargs)))
        coalescer = self._coalescers.get(sig)
        if coalescer is None:
            from pathway_tpu_torch.engine.device_plane import get_device_plane

            coalescer = self._coalescers[sig] = get_device_plane().coalescer(
                self._flush_batch, max_batch=self.max_batch_size or 4096
            )

        async def per_row(*a: Any, **kw: Any) -> Any:
            return await coalescer.submit((a, kw))

        return ex.AsyncApplyExpression(
            per_row, rt, *args,
            propagate_none=self.propagate_none,
            deterministic=self.deterministic, **kwargs,
        )

    def __call__(self, *args: Any, **kwargs: Any) -> ex.ColumnExpression:
        rt = self._return_type()
        if self.batched:
            return self._batched_expression(args, kwargs, rt)
        fn = self.func
        is_coro = asyncio.iscoroutinefunction(self.__wrapped__)
        kind = self.executor.kind
        if kind == "auto":
            kind = "async" if is_coro else "sync"
        if kind == "fully_async":
            return ex.FullyAsyncApplyExpression(
                fn, rt, *args,
                propagate_none=self.propagate_none,
                deterministic=self.deterministic, **kwargs,
            )
        if kind == "async" or is_coro:
            return ex.AsyncApplyExpression(
                fn, rt, *args,
                propagate_none=self.propagate_none,
                deterministic=self.deterministic, **kwargs,
            )
        return ex.ApplyExpression(
            fn, rt, *args,
            propagate_none=self.propagate_none,
            deterministic=self.deterministic,
            max_batch_size=self.max_batch_size, **kwargs,
        )


def _wrap_async(
    fn: Callable,
    capacity: int | None,
    timeout: float | None,
    retry: AsyncRetryStrategy | None,
) -> Callable:
    sem: asyncio.Semaphore | None = None

    @functools.wraps(fn)
    async def wrapper(*args: Any, **kwargs: Any) -> Any:
        nonlocal sem
        if capacity is not None and sem is None:
            sem = asyncio.Semaphore(capacity)

        async def call() -> Any:
            if retry is not None:
                return await retry.invoke(fn, *args, **kwargs)
            return await fn(*args, **kwargs)

        async def guarded() -> Any:
            if sem is not None:
                async with sem:
                    return await call()
            return await call()

        if timeout is not None:
            return await asyncio.wait_for(guarded(), timeout)
        return await guarded()

    return wrapper


class _FunctionUDF(UDF):
    def __init__(self, fn: Callable, **kwargs: Any):
        super().__init__(**kwargs)
        self._fn = fn
        self.__name__ = getattr(fn, "__name__", "udf")
        self.__doc__ = getattr(fn, "__doc__", None)

    @property
    def __wrapped__(self) -> Callable:  # type: ignore[override]
        return self._fn

    def _return_type(self) -> Any:
        if self.return_type is not None:
            return self.return_type
        try:
            hints = typing.get_type_hints(self._fn)
            return hints.get("return", Any)
        except Exception:  # noqa: BLE001
            return Any


def udf(
    fn: Callable | None = None,
    /,
    *,
    return_type: Any = None,
    deterministic: bool = False,
    propagate_none: bool = False,
    executor: Executor | None = None,
    cache_strategy: CacheStrategy | None = None,
    max_batch_size: int | None = None,
    batched: bool = False,
) -> Any:
    """@pw.udf decorator (reference: udfs/__init__.py:290).

    ``batched=True`` flips the calling convention: the function receives
    one LIST per argument holding a whole coalesced wave of rows and
    returns a list of per-row results — the device-plane path by which a
    JAX-jitted function sees full batches instead of row-at-a-time
    calls. ``max_batch_size`` caps the coalesced batch."""

    def wrap(f: Callable) -> _FunctionUDF:
        return _FunctionUDF(
            f,
            return_type=return_type,
            deterministic=deterministic,
            propagate_none=propagate_none,
            executor=executor,
            cache_strategy=cache_strategy,
            max_batch_size=max_batch_size,
            batched=batched,
        )

    if fn is not None:
        return wrap(fn)
    return wrap


def async_options(**kwargs: Any) -> Callable:
    def wrap(f: Callable) -> Callable:
        return _FunctionUDF(f, executor=async_executor(**kwargs))

    return wrap
