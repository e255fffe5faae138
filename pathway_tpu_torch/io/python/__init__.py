"""Python connector: user-defined streaming sources.

Reference: io/python/__init__.py (ConnectorSubject :49, read :349).
A subject runs on its own thread (the reference's one-thread-per-connector
model, src/connectors/mod.rs:427) and pushes rows into an input session;
commits translate to engine timestamps.
"""

from __future__ import annotations

import json as _json
import time as _time
from typing import Any, Iterable

from pathway_tpu_torch.engine.runtime import InputSession, ThreadConnector
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals import universe as univ
from pathway_tpu_torch.internals.keys import Key, key_for_values, sequential_key
from pathway_tpu_torch.internals.table import OpSpec, Table


class ConnectorSubject:
    """Subclass and implement run(); inside, call next()/next_json()/
    next_str()/next_bytes(), commit(), and optionally _remove()."""

    _session: InputSession | None = None
    _schema_names: list[str] | None = None
    _pk_cols: list[str] | None = None
    _deletions_enabled: bool = True

    def run(self) -> None:
        raise NotImplementedError

    def on_stop(self) -> None:
        pass

    @property
    def _with_metadata(self) -> bool:
        return False

    def _key_for(self, values: dict[str, Any]) -> Key:
        if self._pk_cols:
            return key_for_values(*[values[c] for c in self._pk_cols])
        return sequential_key()

    def next(self, **kwargs: Any) -> None:
        assert self._session is not None and self._schema_names is not None
        row = tuple(kwargs.get(n) for n in self._schema_names)
        self._session.insert(self._key_for(kwargs), row)

    # -------------------------------------------------- offset frontiers
    # (reference: src/persistence/frontier.rs OffsetAntichain) — subjects
    # over seekable sources mark consumed positions and seek on resume;
    # pair with read(replay_style="offset").

    def mark_frontier(self, frontier: dict) -> None:
        """Everything delivered so far is covered by {partition: position}."""
        assert self._session is not None
        self._session.mark_frontier(frontier)

    def resume_frontier(self) -> dict:
        """The committed frontier of the previous run ({} = cold start)."""
        assert self._session is not None
        return dict(self._session.resume_frontier or {})

    def next_json(self, message: dict | str | bytes) -> None:
        if isinstance(message, (str, bytes)):
            message = _json.loads(message)
        self.next(**message)

    def next_str(self, message: str) -> None:
        self.next(data=message)

    def next_bytes(self, message: bytes) -> None:
        self.next(data=message)

    def _remove(self, values: dict[str, Any]) -> None:
        assert self._session is not None and self._schema_names is not None
        row = tuple(values.get(n) for n in self._schema_names)
        self._session.remove(self._key_for(values), row)

    def _remove_inner(self, key: Key, values: dict[str, Any]) -> None:
        assert self._session is not None and self._schema_names is not None
        row = tuple(values.get(n) for n in self._schema_names)
        self._session.remove(key, row)

    def commit(self) -> None:
        # the engine's autocommit tick picks staged rows up; an explicit
        # commit simply yields so the pump can take the batch
        _time.sleep(0)

    def close(self) -> None:
        pass


def read(
    subject: ConnectorSubject,
    *,
    schema: Any = None,
    format: str = "json",  # noqa: A002
    autocommit_duration_ms: int | None = None,
    name: str | None = None,
    replay_style: str = "seekable",
    **kwargs: Any,
) -> Table:
    if schema is None:
        schema = sch.schema_from_types(data=str if format != "binary" else bytes)
    names = list(schema.__columns__)
    pk = schema.primary_key_columns()
    upsert = pk is not None

    def factory(session: InputSession) -> ThreadConnector:
        subject._session = session
        subject._schema_names = names
        subject._pk_cols = pk

        def run_fn(sess: InputSession) -> None:
            try:
                subject.run()
            finally:
                subject.on_stop()
                sess.close()

        connector = ThreadConnector(name or type(subject).__name__, session, run_fn)
        connector.replay_style = replay_style
        return connector

    spec = OpSpec("connector", [], factory=factory, upsert=upsert, name=name)
    return Table(spec, schema, univ.Universe())
