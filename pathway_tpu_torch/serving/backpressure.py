"""Watermark-tied backpressure: the gateway reads the pipeline's own
progress signal and slows intake when the frontier falls behind.

Admission control (admission.py) bounds *how much* the edge accepts;
backpressure decides *whether the pipeline can afford it right now*. The
signal is the per-source watermark-lag gauge the runtime already
publishes through the observability plane
(``pathway_source_watermark_lag_seconds`` — the pump's throttled
``tick_sources`` writes it every 250 ms): when a straggling cone lets a
source's watermark trail the local clock, the lag gauge grows, and the
gateway reacts *before* the latency shows up at the client:

* lag past ``delay_lag_s`` — admission is **delayed**: the handler
  sleeps (non-blocking, on its event loop) up to ``max_delay_s``,
  pacing intake to the pipeline instead of queueing blindly;
* lag past ``shed_lag_s`` — admission is **shed**: 429 with a
  Retry-After proportional to the observed lag, so a straggler slows
  intake instead of ballooning p99 for everyone already queued.

Reading the gauge is one registry scan per decision window (results are
memoized for ``poll_interval_s``), so the request path stays cheap. With
the observability plane off there is no signal and backpressure is a
no-op — the gateway degrades to plain admission control.
"""

from __future__ import annotations

import threading
import time as _time

from pathway_tpu_torch.internals import observability as _obs
from pathway_tpu_torch.analysis import lockgraph as _lockgraph

__all__ = ["WatermarkBackpressure"]


class WatermarkBackpressure:
    """Shed/delay policy off the max per-source watermark lag."""

    def __init__(
        self,
        *,
        delay_lag_s: float = 1.0,
        shed_lag_s: float = 5.0,
        max_delay_s: float = 0.5,
        poll_interval_s: float = 0.25,
        sources: tuple[str, ...] | None = None,
    ):
        if shed_lag_s < delay_lag_s:
            raise ValueError(
                f"shed_lag_s ({shed_lag_s}) must be >= delay_lag_s "
                f"({delay_lag_s})"
            )
        self.delay_lag_s = delay_lag_s
        self.shed_lag_s = shed_lag_s
        self.max_delay_s = max_delay_s
        self.poll_interval_s = poll_interval_s
        self.sources = sources  # None = every source the plane reports
        self._lock = _lockgraph.register_lock(
            "serving.backpressure", threading.Lock()
        )
        self._cached_lag = 0.0
        self._cached_at = 0.0
        self.stats = {"delayed": 0, "shed": 0, "max_lag_s": 0.0}

    # ------------------------------------------------------------- signal

    def current_lag(self) -> float:
        """Max watermark lag (seconds) across the watched sources, read
        from the metrics registry; memoized for poll_interval_s."""
        now = _time.monotonic()
        with self._lock:
            if now - self._cached_at < self.poll_interval_s:
                return self._cached_lag
        plane = _obs.PLANE
        lag = 0.0
        if plane is not None:
            lag = plane.metrics.max_gauge(
                "pathway_source_watermark_lag_seconds",
                label="source",
                values=self.sources,
            )
        with self._lock:
            self._cached_lag = lag
            self._cached_at = now
            self.stats["max_lag_s"] = max(self.stats["max_lag_s"], lag)
        return lag

    # ----------------------------------------------------------- decisions

    def decide(self) -> tuple[str, float]:
        """One admission-time decision: ("ok"|"delay"|"shed", seconds).
        For "delay" the seconds are how long to pace this request; for
        "shed" they are the Retry-After hint."""
        lag = self.current_lag()
        if lag >= self.shed_lag_s:
            self.stats["shed"] += 1
            # the frontier is `lag` seconds behind: retrying much sooner
            # than it can catch up just sheds again
            return "shed", max(round(lag, 3), 1.0)
        if lag >= self.delay_lag_s:
            self.stats["delayed"] += 1
            # pace proportionally inside the [delay, shed) band
            frac = (lag - self.delay_lag_s) / max(
                self.shed_lag_s - self.delay_lag_s, 1e-9
            )
            return "delay", round(self.max_delay_s * frac, 4)
        return "ok", 0.0
