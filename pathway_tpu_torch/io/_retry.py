"""pw.io.RetryPolicy — the one retry/degradation policy for connectors.

Before this module every connector improvised its own failure handling:
``io/nats.py`` hand-rolled an uncapped reconnect backoff, ``io/gdrive.py``
swallowed every download error, ``io/http``'s writer looped a bare
``n_retries`` counter, and the engine's ``OutputNode`` kept its own
five-attempt loop. This class unifies them:

* **exponential backoff + full jitter** — delays grow by
  ``backoff_factor`` from ``initial_delay_ms`` up to ``max_delay_ms``,
  each with a uniform jitter slice so synchronized retry storms decohere;
* **max attempts** — ``None`` means retry forever (streaming reconnect
  loops), an int bounds the attempts before the last error propagates;
* **circuit breaker** — after ``breaker_threshold`` *consecutive*
  failures the breaker opens: calls fail fast with :class:`CircuitOpen`
  (no sleep, no side effects) until ``breaker_reset_ms`` elapses, then
  one half-open probe decides whether to close it or re-open with a
  doubled cooldown (capped at 8x). ``on_breaker_open`` fires exactly
  once per open transition — connectors log their warning there;
* **fault injection** — every attempt probes the
  ``io.retry.{name}`` injection point (engine/faults.py), so a seeded
  :class:`~pathway_tpu_torch.engine.faults.FaultSchedule` can flap any
  connector deterministically.

The async surface (:meth:`invoke`) matches
``pathway_tpu_torch.internals.udfs.AsyncRetryStrategy``, so a ``RetryPolicy``
drops into ``pw.udfs.async_executor(retry_strategy=...)`` unchanged.
"""

from __future__ import annotations

import asyncio
import logging
import random
import threading
import time as _time
from typing import Any, Callable, Iterator

from pathway_tpu_torch.engine import faults
from pathway_tpu_torch.internals import observability as _obs
from pathway_tpu_torch.analysis import lockgraph as _lockgraph

__all__ = ["RetryPolicy", "CircuitOpen", "log_degradation"]


def log_degradation(
    logger: logging.Logger, point: str, exc: BaseException,
    level: int = logging.WARNING,
) -> None:
    """A survivable I/O failure the caller chooses to absorb: logged and
    counted, never silent. The repo lint (analysis/lint.py
    ``swallowed-io-error``) bans bare ``except: pass`` on I/O paths —
    degradations that don't warrant a full :class:`RetryPolicy` route
    through here so operators can see them
    (``pathway_io_degradations_total{point=...}`` in /metrics)."""
    logger.log(level, "%s: degraded: %s: %s", point, type(exc).__name__, exc)
    if _obs.PLANE is not None:
        _obs.PLANE.metrics.counter(
            "pathway_io_degradations_total", {"point": point},
            help="survivable I/O failures absorbed as degradations",
        )

_LOG = logging.getLogger("pathway_tpu_torch.io.retry")


class CircuitOpen(RuntimeError):
    """Fail-fast signal: the policy's breaker is open, the call was not
    attempted. Carries the underlying error that opened the breaker."""

    def __init__(self, name: str, last_error: BaseException | None):
        super().__init__(
            f"circuit breaker open for {name!r}"
            + (f" (last error: {last_error})" if last_error else "")
        )
        self.last_error = last_error


class RetryPolicy:
    def __init__(
        self,
        name: str = "io",
        *,
        max_attempts: int | None = 5,
        initial_delay_ms: int = 200,
        backoff_factor: float = 2.0,
        max_delay_ms: int = 5_000,
        jitter_ms: int = 100,
        breaker_threshold: int | None = 8,
        breaker_reset_ms: int = 30_000,
        retry_on: tuple[type[BaseException], ...] = (Exception,),
        on_breaker_open: Callable[["RetryPolicy"], None] | None = None,
        sleep: Callable[[float], None] = _time.sleep,
    ):
        if max_attempts is not None and max_attempts < 1:
            raise ValueError("max_attempts must be >= 1 (or None)")
        self.name = name
        self.max_attempts = max_attempts
        self.initial_delay = initial_delay_ms / 1000.0
        self.backoff_factor = backoff_factor
        self.max_delay = max_delay_ms / 1000.0
        self.jitter = jitter_ms / 1000.0
        self.breaker_threshold = breaker_threshold
        self.breaker_reset = breaker_reset_ms / 1000.0
        self.retry_on = retry_on
        self.on_breaker_open = on_breaker_open
        self._sleep = sleep
        self._rng = random.Random(name)  # jitter only; never affects results
        self._lock = _lockgraph.register_lock(
            "io.retry_breaker", threading.Lock()
        )
        # breaker state: "closed" | "open" | "half_open"
        self.state = "closed"
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._open_count = 0  # escalates the cooldown; stats for tests
        self._last_error: BaseException | None = None
        self.attempts_total = 0
        self.retries_total = 0
        # /metrics + /statistics export breaker state per policy — a
        # WeakSet registration, so dropped policies vanish on their own
        _obs.register_retry_policy(self)

    # ------------------------------------------------------------- breaker

    @property
    def last_error(self) -> BaseException | None:
        """The most recent failure recorded by the policy (None after a
        success) — what ``on_breaker_open`` hooks report."""
        with self._lock:
            return self._last_error

    def _cooldown(self) -> float:
        # doubled per consecutive open, capped at 8x — a flapping service
        # gets probed less and less often
        return self.breaker_reset * min(2 ** max(self._open_count - 1, 0), 8)

    def _admit(self) -> None:
        """Gate one attempt through the breaker (raises CircuitOpen)."""
        with self._lock:
            if self.state == "closed":
                return
            if self.state == "open":
                if _time.monotonic() - self._opened_at >= self._cooldown():
                    self.state = "half_open"  # this attempt is the probe
                    return
                raise CircuitOpen(self.name, self._last_error)
            # half_open: one probe is already in flight; fail fast rather
            # than stampede the recovering service
            raise CircuitOpen(self.name, self._last_error)

    def _record_success(self) -> None:
        closed = False
        with self._lock:
            self._consecutive_failures = 0
            if self.state != "closed":
                self.state = "closed"
                self._open_count = 0
                closed = True
            self._last_error = None
        if closed and _obs.PLANE is not None:
            _obs.PLANE.record("breaker.close", policy=self.name)
            # the recovery twin of pathway_breaker_opens_total: without
            # it a breaker that re-closed after its half-open probe was
            # invisible in the metrics registry
            _obs.PLANE.metrics.counter(
                "pathway_retry_breaker_closes_total", {"policy": self.name},
                help="circuit-breaker close (recovery) transitions",
            )

    def _record_failure(self, err: BaseException) -> None:
        if _obs.PLANE is not None:
            _obs.PLANE.record(
                "retry.failure", export=False, policy=self.name,
                error=f"{type(err).__name__}: {err}"[:300],
            )
            _obs.PLANE.metrics.counter(
                "pathway_retry_failures_total", {"policy": self.name},
                help="failed attempts recorded by retry policies",
            )
        opened = False
        with self._lock:
            self._last_error = err
            self._consecutive_failures += 1
            if self.state == "half_open":
                # the probe failed: straight back to open, longer cooldown
                self.state = "open"
                self._opened_at = _time.monotonic()
                self._open_count += 1
                opened = True
            elif (
                self.state == "closed"
                and self.breaker_threshold is not None
                and self._consecutive_failures >= self.breaker_threshold
            ):
                self.state = "open"
                self._opened_at = _time.monotonic()
                self._open_count += 1
                opened = True
        if opened:
            if _obs.PLANE is not None:
                _obs.PLANE.record(
                    "breaker.open", policy=self.name,
                    failures=self._consecutive_failures,
                    error=f"{type(err).__name__}: {err}"[:300],
                )
                _obs.PLANE.metrics.counter(
                    "pathway_breaker_opens_total", {"policy": self.name},
                    help="circuit-breaker open transitions",
                )
            if self.on_breaker_open is not None:
                try:
                    self.on_breaker_open(self)
                except Exception:  # noqa: BLE001 — a logging hook must not kill IO
                    _LOG.exception("on_breaker_open hook failed for %r", self.name)
            else:
                _LOG.warning(
                    "circuit breaker OPEN for %r after %d consecutive "
                    "failures (last: %s); failing fast for %.1fs",
                    self.name, self._consecutive_failures, err, self._cooldown(),
                )

    # ------------------------------------------------------------- backoff

    def delay_for(self, attempt: int) -> float:
        """Capped, jittered delay before retry number `attempt` (1-based).
        The exponent is clamped: an unbounded reconnect loop
        (max_attempts=None) reaches attempt counts where an unclamped
        ``factor ** attempt`` overflows to OverflowError and kills the
        loop — the opposite of 'retry forever'."""
        try:
            base = self.initial_delay * (
                self.backoff_factor ** min(attempt - 1, 64)
            )
        except OverflowError:  # pathological factor: saturate at the cap
            base = self.max_delay
        return min(base, self.max_delay) + self._rng.random() * self.jitter

    def backoffs(self) -> Iterator[float]:
        """Fresh capped+jittered delay sequence — reconnect loops call
        ``next()`` per failure and replace the iterator after a success."""
        attempt = 0
        while True:
            attempt += 1
            yield self.delay_for(attempt)

    # ---------------------------------------------------------------- sync

    def call(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        """Run `fn` under the policy: breaker gate, injected faults, retry
        with backoff, breaker bookkeeping. Raises the last error once
        attempts are exhausted (or CircuitOpen when failing fast)."""
        attempt = 0
        while True:
            attempt += 1
            self._admit()
            self.attempts_total += 1
            try:
                faults.check(f"io.retry.{self.name}")
                result = fn(*args, **kwargs)
            except self.retry_on as e:
                self._record_failure(e)
                if self.max_attempts is not None and attempt >= self.max_attempts:
                    raise
                if self.state == "open":
                    raise CircuitOpen(self.name, e) from e
                self.retries_total += 1
                self._sleep(self.delay_for(attempt))
                continue
            except Exception as e:  # non-retryable: propagate immediately,
                # but RECORD the failure — a half-open probe that died
                # this way must flip back to open, not wedge in
                # half_open where every _admit fails fast forever
                self._record_failure(e)
                raise
            self._record_success()
            return result

    # --------------------------------------------------------------- async

    async def invoke(self, fn: Callable, /, *args: Any, **kwargs: Any) -> Any:
        """AsyncRetryStrategy-compatible surface (same policy, same
        breaker state, non-blocking sleeps)."""
        attempt = 0
        while True:
            attempt += 1
            self._admit()
            self.attempts_total += 1
            try:
                faults.check(f"io.retry.{self.name}")
                return await fn(*args, **kwargs)
            except self.retry_on as e:
                self._record_failure(e)
                if self.max_attempts is not None and attempt >= self.max_attempts:
                    raise
                if self.state == "open":
                    raise CircuitOpen(self.name, e) from e
                self.retries_total += 1
                await asyncio.sleep(self.delay_for(attempt))
            except Exception as e:  # non-retryable: record, then propagate
                # (a half-open probe must not wedge the breaker)
                self._record_failure(e)
                raise
