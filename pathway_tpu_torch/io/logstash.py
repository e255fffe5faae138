"""pw.io.logstash — stream table updates to Logstash's HTTP input.

Reference parity: python/pathway/io/logstash/__init__.py:14 — in the
reference this is a thin delegation to the HTTP writer (flat JSON objects
with time/diff fields), and it is the same here: the HTTP egress
connector is fully native (io/http).
"""

from __future__ import annotations

from typing import Any


def write(
    table: Any,
    endpoint: str,
    n_retries: int = 0,
    retry_policy: Any = None,
    connect_timeout_ms: int | None = None,
    request_timeout_ms: int | None = None,
) -> None:
    """Sends the stream of updates from the table to the HTTP input of
    Logstash as flat JSON objects with `time` and `diff` fields.

    ``retry_policy`` takes a :class:`pw.io.RetryPolicy` governing the
    per-request retries (backoff, jitter, circuit breaker); when omitted,
    ``n_retries`` builds the legacy fixed-spacing policy.

    Under exactly-once mode (persistence + the transactional outbox,
    io/outbox.py) deliveries ride the HTTP writer's keyed path: every
    record carries a stable ``X-Pathway-Msg-Id`` content key, so a
    replay after a crash re-sends the same ids and the Logstash
    pipeline can drop exact duplicates (docs/robustness.md)."""
    from pathway_tpu_torch.io.http import write as http_write

    http_write(
        table,
        endpoint,
        method="POST",
        format="json",
        n_retries=n_retries,
        retry_policy=retry_policy,
        connect_timeout_ms=connect_timeout_ms,
        request_timeout_ms=request_timeout_ms,
    )


__all__ = ["write"]
