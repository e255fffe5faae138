"""pw.io.nats — streaming message-queue connector over a native protocol
client.

Reference parity: python/pathway/io/nats/__init__.py (read :23, write
:154) + the Rust-side NATS reader/writer in src/connectors/data_storage.rs.
The reference links the async-nats crate; this implementation speaks the
NATS client protocol directly over a TCP socket (INFO/CONNECT, SUB, PUB/
HPUB, MSG/HMSG, PING/PONG) — no client library required.

Semantics:
  * read(): one reader thread per connector subscribes to the topic
    (optionally in a queue group — NATS's native partitioned-reader
    mechanism: PATHWAY_PROCESS_ID-stamped members of the same group split
    the subject's traffic). Core NATS is at-most-once from subscribe time;
    replay/backfill durability comes from the framework's persistence
    layer, which journals the parsed stream and replays it on resume
    (persistence/__init__.py) — the same division of labor the reference
    uses for non-seekable sources.
  * write(): publishes one message per row with `pathway_time` and
    `pathway_diff` headers (HPUB), like the reference's message-queue
    writers.
"""

from __future__ import annotations

import json as _json
import logging
import socket
import threading
import time as _time
from typing import Any, Iterable

from pathway_tpu_torch.engine import faults
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.analysis import lockgraph as _lockgraph
from pathway_tpu_torch.io._retry import RetryPolicy, log_degradation

logger = logging.getLogger("pathway_tpu_torch.io.nats")


class NatsError(RuntimeError):
    pass


def _parse_uri(uri: str) -> tuple[str, int]:
    u = uri
    if "://" in u:
        scheme, u = u.split("://", 1)
        if scheme not in ("nats", "tcp"):
            raise NatsError(f"unsupported NATS scheme {scheme!r}")
    if "@" in u:  # creds in uri: user:pass@host
        u = u.rsplit("@", 1)[1]
    host, _, port = u.partition(":")
    return host or "127.0.0.1", int(port or 4222)


class NatsConnection:
    """Minimal NATS client protocol implementation (docs.nats.io client
    protocol): text control lines + binary payloads over one TCP stream."""

    def __init__(self, uri: str, *, name: str = "pathway", timeout: float = 10.0):
        host, port = _parse_uri(uri)
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(timeout)
        self._buf = bytearray()
        self._lock = _lockgraph.register_lock(
            "io.nats_writer", threading.Lock()
        )
        self.server_info: dict = {}
        self._handshake(name)

    # ------------------------------------------------------------ protocol

    def _handshake(self, name: str) -> None:
        line = self._read_line()
        if not line.startswith(b"INFO "):
            raise NatsError(f"expected INFO, got {line[:40]!r}")
        self.server_info = _json.loads(line[5:].decode())
        connect = {
            "verbose": False,
            "pedantic": False,
            "tls_required": False,
            "name": name,
            "lang": "python",
            "version": "0",
            "protocol": 1,
            "headers": True,
        }
        self._send(b"CONNECT " + _json.dumps(connect).encode() + b"\r\n")

    def _send(self, data: bytes) -> None:
        with self._lock:
            self.sock.sendall(data)

    def _fill(self) -> None:
        chunk = self.sock.recv(65536)
        if not chunk:
            raise ConnectionError("NATS server closed the connection")
        self._buf.extend(chunk)

    def _read_line(self) -> bytes:
        while True:
            idx = self._buf.find(b"\r\n")
            if idx >= 0:
                line = bytes(self._buf[:idx])
                del self._buf[: idx + 2]
                return line
            self._fill()

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:  # payload + trailing CRLF
            self._fill()
        data = bytes(self._buf[:n])
        del self._buf[: n + 2]
        return data

    # --------------------------------------------------------- client ops

    def subscribe(self, subject: str, sid: str = "1", queue_group: str | None = None) -> None:
        if queue_group:
            self._send(f"SUB {subject} {queue_group} {sid}\r\n".encode())
        else:
            self._send(f"SUB {subject} {sid}\r\n".encode())

    def publish(
        self, subject: str, payload: bytes, headers: dict[str, str] | None = None
    ) -> None:
        if headers:
            hdr = b"NATS/1.0\r\n" + b"".join(
                f"{k}: {v}\r\n".encode() for k, v in headers.items()
            ) + b"\r\n"
            self._send(
                f"HPUB {subject} {len(hdr)} {len(hdr) + len(payload)}\r\n".encode()
                + hdr + payload + b"\r\n"
            )
        else:
            self._send(
                f"PUB {subject} {len(payload)}\r\n".encode() + payload + b"\r\n"
            )

    def next_message(self) -> tuple[str, bytes, dict[str, str]] | None:
        """Blocks for the next MSG/HMSG; answers PING transparently and
        keeps idle connections alive with client-side PINGs (a quiet
        subject must not read as a disconnect). Returns (subject, payload,
        headers) or None on control lines / keepalive rounds."""
        try:
            line = self._read_line()
        except socket.timeout:
            # idle socket: probe the server; two unanswered probes in a
            # row mean the connection is actually gone
            self._idle_probes = getattr(self, "_idle_probes", 0) + 1
            if self._idle_probes > 2:
                raise ConnectionError("NATS server unresponsive to PING") from None
            self._send(b"PING\r\n")
            return None
        self._idle_probes = 0
        if line == b"PING":
            self._send(b"PONG\r\n")
            return None
        if line in (b"PONG", b"+OK"):
            return None
        if line.startswith(b"-ERR"):
            raise NatsError(line.decode(errors="replace"))
        if line.startswith(b"MSG "):
            parts = line.decode().split(" ")
            # MSG <subject> <sid> [reply-to] <#bytes>
            subject, n = parts[1], int(parts[-1])
            return subject, self._read_exact(n), {}
        if line.startswith(b"HMSG "):
            parts = line.decode().split(" ")
            # HMSG <subject> <sid> [reply-to] <#hdr> <#total>
            subject, hn, total = parts[1], int(parts[-2]), int(parts[-1])
            blob = self._read_exact(total)
            headers: dict[str, str] = {}
            for hline in blob[:hn].split(b"\r\n")[1:]:
                if b":" in hline:
                    k, _, v = hline.decode(errors="replace").partition(":")
                    headers[k.strip()] = v.strip()
            return subject, blob[hn:], headers
        raise NatsError(f"unexpected protocol line {line[:60]!r}")

    def flush(self) -> None:
        self._send(b"PING\r\n")

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError as e:
            log_degradation(logger, "nats.socket_close", e, logging.DEBUG)


# -------------------------------------------------------------------- read


def read(
    uri: str,
    topic: str,
    *,
    schema: Any = None,
    format: str = "raw",  # noqa: A002
    autocommit_duration_ms: int | None = 1500,
    json_field_paths: dict[str, str] | None = None,
    parallel_readers: int | None = None,
    queue_group: str | None = None,
    persistent_id: str | None = None,
    name: str | None = None,
    terminate_on_disconnect: bool = False,
    debug_data: Any = None,
) -> Any:
    """Reads a NATS subject as a streaming table.

    Formats: 'raw' (bytes `data` column), 'plaintext' (utf-8 `data`),
    'json' (columns from `schema`, with optional `json_field_paths`
    dot-paths). `queue_group` joins a NATS queue group so parallel
    processes split the subject's traffic (the partitioned-reader shape).
    `terminate_on_disconnect` ends the stream when the server closes the
    connection instead of reconnecting (bounded streams / tests).
    """
    from pathway_tpu_torch.io.python import ConnectorSubject
    from pathway_tpu_torch.io.python import read as python_read

    if format == "json":
        if schema is None:
            raise ValueError("pw.io.nats.read(format='json') requires a schema")
    else:
        schema = sch.schema_from_types(data=bytes if format == "raw" else str)
    columns = list(schema.__columns__)
    paths = {
        col: [p for p in path.lstrip("/").replace("/", ".").split(".") if p]
        for col, path in (json_field_paths or {}).items()
    }

    class NatsSubject(ConnectorSubject):
        def run(self) -> None:
            # unified reconnect policy (same 0.2s->5s exponential timings
            # the old hand-rolled loop used, now capped, jittered, and
            # fault-injectable at io.retry.{name}); max_attempts=None:
            # a streaming subject reconnects forever
            policy = RetryPolicy(
                name or f"nats:{topic}",
                max_attempts=None,
                initial_delay_ms=200,
                backoff_factor=2.0,
                max_delay_ms=5_000,
                jitter_ms=100,
                breaker_threshold=None,
            )
            delays = policy.backoffs()
            while True:
                try:
                    faults.check(f"io.retry.{policy.name}")
                    conn = NatsConnection(uri, name=name or "pathway-reader")
                    conn.subscribe(topic, queue_group=queue_group)
                    delays = policy.backoffs()  # connected: reset backoff
                    while True:
                        msg = conn.next_message()
                        if msg is None:
                            continue
                        _subject, payload, _headers = msg
                        self._deliver(payload)
                except (ConnectionError, socket.timeout, OSError):
                    if terminate_on_disconnect:
                        return
                    _time.sleep(next(delays))

        def _deliver(self, payload: bytes) -> None:
            if format == "raw":
                self.next(data=payload)
            elif format == "plaintext":
                self.next(data=payload.decode("utf-8", errors="replace"))
            else:
                try:
                    doc = _json.loads(payload)
                except ValueError:
                    return  # unparsable message: skip (reference logs + skips)
                row = {}
                for col in columns:
                    node: Any = doc
                    for part in paths.get(col, [col]):
                        node = node.get(part) if isinstance(node, dict) else None
                    row[col] = node
                self.next(**row)

    return python_read(
        NatsSubject(),
        schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"nats:{topic}",
        replay_style="live",  # a subject delivers new messages only
    )


# ------------------------------------------------------------------- write


def write(
    table: Any,
    uri: str,
    topic: str,
    *,
    format: str = "json",  # noqa: A002
    delimiter: str = ",",
    value: Any = None,
    headers: Iterable[Any] | None = None,
) -> None:
    """Publishes table updates to a NATS subject with pathway_time /
    pathway_diff headers (one message per row update)."""
    names = table._column_names()
    header_cols = [h.name for h in headers] if headers else []
    value_idx = 0
    if format in ("plaintext", "raw"):
        if value is not None:
            value_idx = names.index(value.name)
        elif len(names) != 1:
            raise ValueError(
                f"pw.io.nats.write(format={format!r}) needs `value` when the "
                "table has more than one column"
            )
    state: dict[str, Any] = {"conn": None}

    def _conn() -> NatsConnection:
        if state["conn"] is None:
            state["conn"] = NatsConnection(uri, name="pathway-writer")
        return state["conn"]

    def _write(time: int, entries: list, ids: list | None = None) -> None:
        conn = _conn()
        try:
            for i, (_key, row, diff) in enumerate(entries):
                hdr = {"pathway_time": str(time), "pathway_diff": str(diff)}
                if ids is not None:
                    # exactly-once replay safety (io/outbox.py): stable
                    # per-record content key for consumer-side dedup
                    hdr["pathway_msg_id"] = str(ids[i])
                for col in header_cols:
                    hdr[col] = str(row[names.index(col)])
                if format == "json":
                    payload = Json.dumps(dict(zip(names, row))).encode()
                elif format == "dsv":
                    payload = delimiter.join(str(v) for v in row).encode()
                elif format == "plaintext":
                    payload = str(row[value_idx]).encode()
                elif format == "raw":
                    v = row[value_idx]
                    payload = v if isinstance(v, bytes) else str(v).encode()
                else:
                    raise ValueError(f"unsupported NATS output format {format!r}")
                conn.publish(topic, payload, headers=hdr)
        except (ConnectionError, OSError):
            state["conn"] = None  # reconnect next batch; OutputNode retries
            raise

    def close() -> None:
        if state["conn"] is not None:
            state["conn"].close()

    G.add_sink(
        "output", table,
        write_batch=lambda time, entries: _write(time, entries),
        write_keyed=_write,
        close=close,
    )


__all__ = ["read", "write", "NatsConnection", "NatsError"]
