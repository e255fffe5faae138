"""Epoch-fenced transactional sinks: a replayable outbox WAL.

PR 3's chaos plane proves crash recovery is byte-identical *inside* the
engine, but the guarantee used to die at the sink boundary: deliveries
between the last checkpoint and a crash could repeat or vanish on
resume, so outputs were only at-least-once (the old contract in
docs/persistence.md). This module extends the commit protocol through
the writers:

1. **Stage** — under exactly-once mode every :class:`OutputNode` stops
   writing directly; its waves append to a per-sink outbox WAL (a
   ``SegmentedJournal`` under the persistence backend root, reusing its
   fsync + torn-tail handling and crc-framed codec records).
2. **Seal** — at each checkpoint fence the staged segments are fsynced
   and the per-sink staged offsets ride the metadata commit
   (``MetadataStore.commit(outbox=...)``). The metadata rename is the
   linearization point: once it lands, the epoch's sink output is
   *sealed* — it WILL be delivered, exactly once, even across crashes.
3. **Deliver + ack** — after the commit the sealed range flushes
   through the real writer (grouped by wave time, under the sink's
   ``RetryPolicy``), then an ack record (``{sink}.ack``, fsync-then-
   rename) advances the per-sink delivery high-watermark and acked
   segments are garbage-collected via ``SegmentedJournal.compact``.

Crash windows (all deterministic injection points, docs/robustness.md):

* ``sink.outbox.pre_seal`` — staged but not sealed: recovery discards
  the unsealed WAL tail; the replayed inputs regenerate and re-stage it
  (their offsets were never committed either).
* ``sink.outbox.post_seal`` — sealed but nothing delivered: recovery
  replays the whole sealed-unacked range from the WAL.
* ``sink.flush.torn`` — mid-flush: some batches delivered, ack not
  advanced. Recovery re-delivers the range; idempotence makes that
  safe — fs sinks commit offset-named atomic segments (a re-delivery
  rewrites the same segment byte-identically), and at-least-once
  targets (kafka, nats, http, logstash) carry a **content key** per
  record (``{wal_offset}:{blake2b(record)}``, stable across replays —
  the ``pathway_msg_id`` / ``X-Pathway-Msg-Id`` header) so the consumer
  drops exact duplicates.

``PATHWAY_EXACTLY_ONCE=0`` (or no persistence config, or a static
pipeline with no streaming connectors) bypasses all of this: sinks
write directly per wave, byte-identical to the pre-outbox behavior.

Metrics (when the observability plane is armed):
``pathway_sink_sealed_epochs_total{sink}``,
``pathway_sink_replays_total{sink}``,
``pathway_sink_dedup_drops_total{sink}``,
``pathway_sink_outbox_bytes{sink}``.
"""

from __future__ import annotations

import hashlib
import json as _json
import logging
import os
from typing import Any, Callable

from pathway_tpu_torch.engine import faults
from pathway_tpu_torch.internals import observability as _obs
from pathway_tpu_torch.internals.keys import Key
from pathway_tpu_torch.persistence import _fsync_write, codec

__all__ = ["SinkOutbox", "OutboxManager", "exactly_once_enabled"]

_LOG = logging.getLogger("pathway_tpu_torch.io.outbox")


def exactly_once_enabled() -> bool:
    """The kill switch: PATHWAY_EXACTLY_ONCE=0 reproduces the direct
    per-wave sink writes byte-identically (at-least-once on crash)."""
    return os.environ.get("PATHWAY_EXACTLY_ONCE", "1") != "0"


def content_key(offset: int, time: int, row: tuple, diff: int) -> str:
    """Deterministic per-record delivery id. The WAL offset makes it
    unique and *stable across replays* (a replay reads the identical
    records back); the content hash makes accidental collisions after a
    WAL rebuild detectable. Consumers deduplicate on exact repeats."""
    h = hashlib.blake2b(
        codec.encode_record((offset, (int(time),) + tuple(row), int(diff))),
        digest_size=8,
    ).hexdigest()
    return f"{offset}:{h}"


def _metric(kind: str, name: str, sink: str, value: float = 1) -> None:
    plane = _obs.PLANE
    if plane is None:
        return
    helps = {
        "pathway_sink_sealed_epochs_total": "checkpoint epochs sealed with sink output",
        "pathway_sink_replays_total": "outbox replay sessions after a restart",
        "pathway_sink_dedup_drops_total": "records skipped below the acked high-watermark",
        "pathway_sink_outbox_bytes": "bytes held in the sink's outbox WAL",
    }
    if kind == "counter":
        plane.metrics.counter(name, {"sink": sink}, inc=value, help=helps[name])
    else:
        plane.metrics.gauge(name, value, {"sink": sink}, help=helps[name])


class SinkOutbox:
    """One sink's staged-output WAL + delivery watermark.

    The WAL record is ``(key.value, (time,) + row, diff)`` through the
    persistence codec, so every engine value a sink can see journals
    losslessly. Offsets are global per sink; the ack file records the
    delivery high-watermark ``{"offset": N, "epoch": E}``.
    """

    def __init__(
        self,
        name: str,
        journal: Any,  # persistence.SegmentedJournal (duck-typed)
        root: str,
        *,
        write_batch: Callable[[int, list], None],
        write_keyed: Callable[[int, list, list], None] | None = None,
        flush: Callable[[], None] | None = None,
        close: Callable[[], None] | None = None,
        retry: Any = None,
        txn: dict | None = None,
    ):
        self.name = name
        self.journal = journal
        self.root = root
        self.write_batch = write_batch
        self.write_keyed = write_keyed
        self.flush_fn = flush
        self.close_fn = close
        self.retry = retry
        self.txn = txn or {}
        self.ack_path = os.path.join(root, f"{name}.ack")
        self.acked = 0
        self.acked_epoch = 0
        ack = self._read_ack()
        if ack is not None:
            self.acked = int(ack.get("offset", 0))
            self.acked_epoch = int(ack.get("epoch", 0))
        self.staged = journal.total_events(name)
        self._last_sealed = self.staged
        self._writer: Any = None
        self._closed = False

    # ------------------------------------------------------------ staging

    def stage(self, time: int, entries: list) -> None:
        """Append one wave's (key, row, diff) entries to the WAL. Not
        yet durable — seal() at the checkpoint fence fsyncs."""
        if self._writer is None:
            self._writer = self.journal.open_segment(self.name, self.staged)
        for (key, row, diff) in entries:
            self._writer.append(key.value, (int(time),) + tuple(row), int(diff))
            self.staged += 1

    def seal(self) -> int:
        """Make everything staged so far durable; returns the sealed
        offset the metadata commit records for this sink."""
        if self._writer is not None:
            self._writer.flush(sync=True)
        if self.staged > self._last_sealed:
            self._last_sealed = self.staged
            _metric("counter", "pathway_sink_sealed_epochs_total", self.name)
        self._gauge_bytes()
        return self.staged

    def _gauge_bytes(self) -> None:
        if _obs.PLANE is None:
            return
        _metric(
            "gauge", "pathway_sink_outbox_bytes", self.name,
            self.journal.size_bytes(self.name),
        )

    # ----------------------------------------------------------- delivery

    def _read_ack(self) -> dict | None:
        try:
            with open(self.ack_path) as f:
                return _json.load(f)
        except (OSError, ValueError):
            return None

    def _write_ack(self, offset: int, epoch: int) -> None:
        _fsync_write(
            self.ack_path,
            _json.dumps({"offset": offset, "epoch": epoch}).encode(),
        )
        self.acked = offset
        self.acked_epoch = epoch

    def deliver(self, epoch: int, *, replay: bool = False) -> bool:
        """Flush the sealed-unacked range ``(acked, staged]`` through
        the writer, grouped by wave time, then ack + compact. Returns
        True when the range was fully delivered and acked; False leaves
        the range pending for the next fence / restart (the sink's
        retry policy gave up — exactly-once degrades to *delayed*, not
        to dropped)."""
        lo, hi = self.acked, self.staged
        if lo >= hi:
            return True
        if replay:
            _metric("counter", "pathway_sink_replays_total", self.name)
        records = [
            (off, kv, row, diff)
            for (off, kv, row, diff) in self.journal.load_from(self.name, lo)
            if off < hi
        ]
        dropped = (hi - lo) - len(records)
        if dropped > 0:
            # can only happen after external WAL damage; deliver what
            # survives rather than wedging the pipeline
            _LOG.error(
                "outbox %r lost %d staged record(s) below the sealed "
                "horizon", self.name, dropped,
            )
        # group into the original per-wave batches (consecutive same time)
        groups: list[tuple[int, list, list]] = []
        for (off, kv, row, diff) in records:
            time, payload = int(row[0]), tuple(row[1:])
            entry = (Key(kv), payload, int(diff))
            cid = content_key(off, time, payload, int(diff))
            if groups and groups[-1][0] == time:
                groups[-1][1].append(entry)
                groups[-1][2].append(cid)
            else:
                groups.append((time, [entry], [cid]))
        try:
            for (time, entries, ids) in groups:
                if self.write_keyed is not None:
                    self._call(self.write_keyed, time, entries, ids)
                else:
                    self._call(self.write_batch, time, entries)
                # crash window: part of the sealed range is at the
                # target, the ack has not advanced — recovery replays
                # the WHOLE range and idempotence absorbs the overlap
                faults.crash("sink.flush.torn")
            commit = self.txn.get("commit")
            if commit is not None:
                # offset-named atomic segment: a replay of the same
                # range rewrites the same segment byte-identically
                commit(lo)
            if self.flush_fn is not None:
                self.flush_fn()
        except Exception as e:  # noqa: BLE001 — a dead sink must not kill the pump
            abort = self.txn.get("abort")
            if abort is not None:
                abort()
            _LOG.error(
                "outbox %r delivery failed (%s: %s); %d record(s) stay "
                "sealed for the next fence",
                self.name, type(e).__name__, e, hi - lo,
            )
            return False
        self._write_ack(hi, epoch)
        # roll the segment so compaction can free fully-acked ones
        if self._writer is not None and self._writer.count:
            self._writer.close()
            self._writer = self.journal.open_segment(self.name, self.staged)
        self.journal.compact(self.name, self.acked)
        self._gauge_bytes()
        return True

    def _call(self, fn: Callable, *args: Any) -> None:
        if self.retry is not None:
            self.retry.call(fn, *args)
        else:
            fn(*args)

    # ----------------------------------------------------------- recovery

    def recover(self, sealed: int, epoch: int) -> None:
        """Restart negotiation: drop the staged-unsealed WAL tail, then
        replay the sealed-unacked range (if any) through the writer."""
        if sealed == 0 and self.acked == 0:
            # fresh outbox state: nothing was ever sealed or acked, so
            # any on-disk sink artifacts (fs epoch segments) are orphans
            # of an unrelated previous run against the same output path
            # — without this they would consolidate into this run's file
            reset = self.txn.get("reset")
            if reset is not None:
                reset()
        self._truncate_to(sealed)
        self.staged = sealed
        self._last_sealed = sealed
        if self.acked > sealed:
            # delivery ran ahead of the epoch the engine rolled back to
            # (one-epoch snapshot fallback / full journal replay): the
            # target already holds output the re-run will regenerate.
            # Re-staged records reuse the same WAL offsets, so their
            # content keys usually match and the consumer's dedup (or
            # its state-convergent consolidation) absorbs the overlap —
            # this is the documented at-least-once residue of the
            # degradation ladder's deeper rungs.
            _metric(
                "counter", "pathway_sink_dedup_drops_total", self.name,
                self.acked - sealed,
            )
            _LOG.warning(
                "outbox %r acked to %d but the restored epoch sealed %d; "
                "the re-run re-delivers the gap with stable content keys",
                self.name, self.acked, sealed,
            )
            self._write_ack(sealed, epoch)
        elif self.acked < sealed:
            self.deliver(epoch, replay=True)

    def _truncate_to(self, offset: int) -> None:
        """Remove WAL records at or past `offset` (the pre-seal crash
        window: staged events whose input offsets were never committed
        — the re-run re-derives and re-stages them)."""
        self.journal.truncate_to(self.name, offset)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self.close_fn is not None:
            self.close_fn()


class OutboxManager:
    """All of a session's sink outboxes under one persistence root.

    Owned by the ``CheckpointManager``: ``seal_all`` runs inside the
    checkpoint fence just before the metadata commit, ``deliver_all``
    right after it, ``recover`` at attach time, ``close`` at end of
    stream (the writers close only after the final ack)."""

    def __init__(self, root: str):
        from pathway_tpu_torch.persistence import SegmentedJournal

        self.root = os.path.join(root, "outbox")
        os.makedirs(self.root, exist_ok=True)
        self.journal = SegmentedJournal(self.root)
        self.sinks: dict[str, SinkOutbox] = {}

    def register(self, name: str, node: Any) -> SinkOutbox:
        """Wire one OutputNode through the outbox: its waves stage
        instead of writing, and its transactional hooks (atomic fs
        segments / keyed writers) arm."""
        txn = getattr(node, "txn", None) or {}
        ob = SinkOutbox(
            name,
            self.journal,
            self.root,
            write_batch=node.write_batch,
            write_keyed=getattr(node, "write_keyed", None),
            # a sink may carry a stricter outbox-only flush (kafka's
            # raising queue drain) that must NOT ride the direct
            # per-wave path, where a raise would make the retry loop
            # re-deliver the whole batch
            flush=txn.get("flush") or node.flush,
            close=node.close,
            retry=node.retry_policy,
            txn=txn,
        )
        self.sinks[name] = ob
        node.attach_outbox(ob)
        return ob

    def recover(self, sealed_map: dict, epoch: int) -> None:
        for name, ob in self.sinks.items():
            ob.recover(int(sealed_map.get(name, 0)), epoch)

    def seal_all(self) -> dict[str, int]:
        return {name: ob.seal() for name, ob in self.sinks.items()}

    def deliver_all(self, epoch: int) -> None:
        for ob in self.sinks.values():
            ob.deliver(epoch)

    def close(self) -> None:
        for ob in self.sinks.values():
            ob.close()
