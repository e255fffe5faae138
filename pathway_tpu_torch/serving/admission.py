"""Admission control: token buckets + bounded queues at the serving edge.

The thin `rest_connector` accepted every concurrent request: each one
became a pending future and a staged row, so overload showed up as an
unbounded `pending` map, minutes-long p99 and eventually a dead server —
the engine never saw *less* work, just later. This module makes the edge
say no early:

* :class:`TokenBucket` — the standard (rate, burst) limiter. Refill is
  computed lazily off a monotonic clock; `try_take` never sleeps and
  returns the seconds until the next token when it refuses, which
  becomes the 429's ``Retry-After``.
* :class:`AdmissionController` — one per gateway. A route-level bucket
  plus lazily-created per-tenant buckets (the tenant is whatever field
  the gateway's config names), and a bounded in-flight counter: requests
  past ``max_queue`` are shed immediately instead of piling futures into
  the response map. Every decision lands in the metrics registry
  (``pathway_serving_admitted_total``, ``pathway_serving_shed_total``
  with a ``reason`` label, ``pathway_serving_queue_depth``).

Shedding is deliberately *cheap*: one clock read and two dict lookups on
admit, zero background threads.
"""

from __future__ import annotations

import threading
import time as _time

from pathway_tpu_torch.internals import observability as _obs
from pathway_tpu_torch.analysis import lockgraph as _lockgraph

__all__ = ["TokenBucket", "AdmissionController", "AdmissionDecision"]


class TokenBucket:
    """(rate, burst) limiter with lazy refill off the monotonic clock."""

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate/burst must be > 0, got {rate}/{burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last = _time.monotonic()
        self._lock = _lockgraph.register_lock(
            "serving.token_bucket", threading.Lock()
        )

    def try_take(self, n: float = 1.0) -> float:
        """Take `n` tokens if available; returns 0.0 on success, else the
        seconds until `n` tokens will have accumulated (the Retry-After)."""
        with self._lock:
            now = _time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate


class AdmissionDecision:
    """The gateway's verdict on one request."""

    __slots__ = ("admitted", "reason", "retry_after")

    def __init__(self, admitted: bool, reason: str = "", retry_after: float = 0.0):
        self.admitted = admitted
        self.reason = reason  # "" | "route_rate" | "tenant_rate" | "queue_full" | "backpressure"
        self.retry_after = retry_after

    def __bool__(self) -> bool:
        return self.admitted


class AdmissionController:
    """Route-level + per-tenant token buckets and a bounded in-flight
    queue for one gateway route. Thread-safe; called from aiohttp
    handlers (any number of event loops / threads)."""

    def __init__(
        self,
        route: str,
        *,
        rate: float | None = None,
        burst: float | None = None,
        tenant_rate: float | None = None,
        tenant_burst: float | None = None,
        max_queue: int = 1024,
        max_tenants: int = 10_000,
    ):
        self.route = route
        self.max_queue = max_queue
        self._route_bucket = (
            TokenBucket(rate, burst or max(rate, 1.0))
            if rate is not None
            else None
        )
        self._tenant_rate = tenant_rate
        self._tenant_burst = tenant_burst
        self._max_tenants = max_tenants
        self._tenants: dict[str, TokenBucket] = {}
        self._lock = _lockgraph.register_lock(
            "serving.admission", threading.Lock()
        )
        self._in_flight = 0
        self.stats = {"admitted": 0, "shed": 0, "max_in_flight": 0}

    # ------------------------------------------------------------ decisions

    def _shed(self, reason: str, retry_after: float) -> AdmissionDecision:
        self.stats["shed"] += 1
        if _obs.PLANE is not None:
            _obs.PLANE.metrics.counter(
                "pathway_serving_shed_total",
                {"route": self.route, "reason": reason},
                help="requests refused at the serving edge",
            )
        return AdmissionDecision(False, reason, retry_after)

    def admit(self, tenant: str | None = None) -> AdmissionDecision:
        """Gate one request. An admitted request MUST be paired with one
        `release()` once its response future resolves (or fails)."""
        # RESERVE the queue slot atomically with the bound check — a
        # check-then-increment in two lock sections would let concurrent
        # callers overshoot max_queue, the one bound this class exists
        # to enforce. A bucket refusal below refunds the reservation.
        with self._lock:
            if self._in_flight >= self.max_queue:
                depth = self._in_flight
                decision = self._shed("queue_full", 1.0)
                self._gauge_depth(depth)
                return decision
            self._in_flight += 1
            depth = self._in_flight
        if self._route_bucket is not None:
            wait = self._route_bucket.try_take()
            if wait > 0.0:
                self.release()
                return self._shed("route_rate", wait)
        if tenant is not None and self._tenant_rate is not None:
            with self._lock:
                bucket = self._tenants.get(tenant)
                if bucket is None:
                    if len(self._tenants) >= self._max_tenants:
                        # tenant cardinality is attacker-controlled: evict
                        # the whole table rather than grow unbounded (a
                        # fresh bucket starts full, so honest tenants see
                        # at most one extra burst)
                        self._tenants.clear()
                    bucket = self._tenants[tenant] = TokenBucket(
                        self._tenant_rate,
                        self._tenant_burst or max(self._tenant_rate, 1.0),
                    )
            wait = bucket.try_take()
            if wait > 0.0:
                self.release()
                return self._shed("tenant_rate", wait)
        with self._lock:
            self.stats["admitted"] += 1
            self.stats["max_in_flight"] = max(
                self.stats["max_in_flight"], depth
            )
        if _obs.PLANE is not None:
            _obs.PLANE.metrics.counter(
                "pathway_serving_admitted_total", {"route": self.route},
                help="requests admitted past the serving edge",
            )
        self._gauge_depth(depth)
        return AdmissionDecision(True)

    def release(self) -> None:
        with self._lock:
            self._in_flight = max(self._in_flight - 1, 0)
            depth = self._in_flight
        self._gauge_depth(depth)

    def shed_external(self, reason: str, retry_after: float) -> AdmissionDecision:
        """Record a shed decided outside the controller (backpressure)."""
        return self._shed(reason, retry_after)

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight

    def _gauge_depth(self, depth: int) -> None:
        if _obs.PLANE is not None:
            _obs.PLANE.metrics.gauge(
                "pathway_serving_queue_depth", depth, {"route": self.route},
                help="admitted requests currently awaiting a response",
            )
