"""The always-on serving gateway: the layer between HTTP ingress and the
frontier runtime.

``rest_connector`` turns requests into rows; this gateway decides which
requests *become* rows. Per route it composes:

1. **admission control** (admission.py) — route + per-tenant token
   buckets and a bounded in-flight queue; refusals are 429 with a
   computed ``Retry-After`` instead of unbounded pending futures;
2. **watermark backpressure** (backpressure.py) — when the pipeline's
   frontier lags ingress past configured thresholds, admission is paced
   (async delay) or shed, so a straggling cone slows intake instead of
   ballooning p99;
3. **observability** — every decision is a counter/gauge in the metrics
   registry and the shed path records spine events, so the load bench
   (scripts/serving_loadgen.py) and /metrics read the same truth.

Use it by passing ``gateway=ServingGateway(...)`` to ``rest_connector``
(or to the `xpacks.llm.servers` REST servers, which forward it); the
aiohttp handler consults :meth:`admit_async` before inserting a row and
calls :meth:`release` when the response future resolves.

The gateway is deliberately engine-agnostic: it never touches scheduler
internals, only the metrics registry — the same contract external
autoscalers get.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import observability as _obs
from pathway_tpu_torch.serving.admission import AdmissionController, AdmissionDecision
from pathway_tpu_torch.serving.backpressure import WatermarkBackpressure

__all__ = ["ServingGateway"]


class ServingGateway:
    """Admission + backpressure for any number of rest_connector routes.

    Parameters mirror the two policies:

    * ``rate``/``burst`` — route-level token bucket (requests/sec;
      None = unlimited rate, queue bound still applies);
    * ``tenant_rate``/``tenant_burst``/``tenant_field`` — per-tenant
      buckets keyed on a payload field (None = no tenant isolation);
    * ``max_queue`` — bound on admitted-but-unanswered requests per
      route (the old unbounded ``pending`` map);
    * ``backpressure`` — a :class:`WatermarkBackpressure` (or None to
      run open-loop). ``delay``ed requests are paced on the event loop;
      ``shed`` requests get 429 + Retry-After like rate refusals.
    """

    def __init__(
        self,
        *,
        rate: float | None = None,
        burst: float | None = None,
        tenant_rate: float | None = None,
        tenant_burst: float | None = None,
        tenant_field: str | None = None,
        max_queue: int = 1024,
        backpressure: WatermarkBackpressure | None = None,
    ):
        self._kw = dict(
            rate=rate,
            burst=burst,
            tenant_rate=tenant_rate,
            tenant_burst=tenant_burst,
            max_queue=max_queue,
        )
        self.tenant_field = tenant_field
        self.backpressure = backpressure
        self._routes: dict[str, AdmissionController] = {}

    def controller(self, route: str) -> AdmissionController:
        ctl = self._routes.get(route)
        if ctl is None:
            ctl = self._routes[route] = AdmissionController(route, **self._kw)
        return ctl

    def tenant_of(self, payload: dict) -> str | None:
        if self.tenant_field is None:
            return None
        v = payload.get(self.tenant_field)
        return None if v is None else str(v)

    # ------------------------------------------------------------ decisions

    async def admit_async(
        self, route: str, payload: dict
    ) -> AdmissionDecision:
        """The handler-side gate: applies backpressure (await-sleeping
        through a `delay` verdict), then admission control. An admitted
        request must be released via :meth:`release` when its future
        resolves."""
        ctl = self.controller(route)
        if self.backpressure is not None:
            verdict, seconds = self.backpressure.decide()
            if verdict == "shed":
                if _obs.PLANE is not None:
                    _obs.PLANE.record(
                        "serving.backpressure_shed", route=route,
                        retry_after=seconds,
                    )
                return ctl.shed_external("backpressure", seconds)
            if verdict == "delay" and seconds > 0.0:
                import asyncio

                await asyncio.sleep(seconds)
        return ctl.admit(self.tenant_of(payload))

    def admit(self, route: str, payload: dict) -> AdmissionDecision:
        """Synchronous gate for non-async callers (tests, loadgen
        harnesses): backpressure `delay` is ignored here — only shed."""
        ctl = self.controller(route)
        if self.backpressure is not None:
            verdict, seconds = self.backpressure.decide()
            if verdict == "shed":
                return ctl.shed_external("backpressure", seconds)
        return ctl.admit(self.tenant_of(payload))

    def release(self, route: str) -> None:
        self.controller(route).release()

    # --------------------------------------------------------------- stats

    def snapshot(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            route: {**ctl.stats, "in_flight": ctl.in_flight}
            for route, ctl in self._routes.items()
        }
        if self.backpressure is not None:
            out["backpressure"] = dict(self.backpressure.stats)
        return out
