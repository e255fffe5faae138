"""pw.io.slack — send table rows as Slack messages.

Reference parity: python/pathway/io/slack/__init__.py (send_alerts :11),
which posts each alert row to chat.postMessage via the HTTP connector;
identical mechanism here over `requests`.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.parse_graph import G

_API_URL = "https://slack.com/api/chat.postMessage"


def send_alerts(alerts: Any, slack_channel_id: str, slack_token: str) -> None:
    """Posts every new value of the `alerts` column to a Slack channel
    (insertions only — retractions are not un-sent)."""
    import requests

    table = alerts.table.select(message=alerts)

    def write_batch(time: int, entries: list) -> None:
        for _key, row, diff in entries:
            if diff <= 0:
                continue
            resp = requests.post(
                _API_URL,
                json={"channel": slack_channel_id, "text": str(row[0])},
                headers={"Authorization": f"Bearer {slack_token}"},
                timeout=30,
            )
            resp.raise_for_status()
            body = resp.json()
            if not body.get("ok", False):
                raise RuntimeError(f"slack API error: {body.get('error')}")

    G.add_sink("output", table, write_batch=write_batch)


__all__ = ["send_alerts"]
