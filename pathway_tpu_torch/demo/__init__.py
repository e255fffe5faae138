"""pw.demo: streaming simulators (reference: python/pathway/demo/__init__.py
generate_custom_stream :28, noisy_linear_stream :118, range_stream,
replay_csv / replay_csv_with_time)."""

from __future__ import annotations

import csv as _csv
import random
import time as _time
from typing import Any, Callable, Mapping

from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.io.python import ConnectorSubject, read as _python_read


def generate_custom_stream(
    value_generators: Mapping[str, Callable[[int], Any]],
    *,
    schema: Any,
    nb_rows: int | None = None,
    input_rate: float = 1.0,
    autocommit_duration_ms: int = 20,
    persistent_id: str | None = None,
    name: str | None = None,
):
    class StreamSubject(ConnectorSubject):
        def run(self) -> None:
            i = 0
            while nb_rows is None or i < nb_rows:
                values = {name: gen(i) for name, gen in value_generators.items()}
                self.next(**values)
                self.commit()
                i += 1
                if input_rate > 0:
                    _time.sleep(1.0 / input_rate)

    return _python_read(
        StreamSubject(), schema=schema,
        autocommit_duration_ms=autocommit_duration_ms, name=name,
    )


def range_stream(
    nb_rows: int = 30, offset: int = 0, input_rate: float = 1.0,
    autocommit_duration_ms: int = 20, **kwargs: Any,
):
    schema = sch.schema_from_types(value=int)
    return generate_custom_stream(
        {"value": lambda i: i + offset},
        schema=schema, nb_rows=nb_rows, input_rate=input_rate,
        autocommit_duration_ms=autocommit_duration_ms,
    )


def noisy_linear_stream(
    nb_rows: int = 10, input_rate: float = 1.0,
    autocommit_duration_ms: int = 20, **kwargs: Any,
):
    schema = sch.schema_from_types(x=float, y=float)
    rng = random.Random(0)
    return generate_custom_stream(
        {"x": lambda i: float(i), "y": lambda i: float(i) + (2 * rng.random() - 1) / 10},
        schema=schema, nb_rows=nb_rows, input_rate=input_rate,
        autocommit_duration_ms=autocommit_duration_ms,
    )


def replay_csv(
    path: str, *, schema: Any, input_rate: float = 1.0,
    autocommit_ms: int = 20, **kwargs: Any,
):
    names = list(schema.__columns__)
    dtypes = {n: c.dtype for n, c in schema.__columns__.items()}

    class ReplaySubject(ConnectorSubject):
        def run(self) -> None:
            from pathway_tpu_torch.io.fs import _coerce

            with open(path, newline="") as f:
                for rec in _csv.DictReader(f):
                    vals = {n: _coerce(rec[n], dtypes[n]) for n in names if n in rec}
                    self.next(**vals)
                    self.commit()
                    if input_rate > 0:
                        _time.sleep(1.0 / input_rate)

    return _python_read(ReplaySubject(), schema=schema, autocommit_duration_ms=autocommit_ms)


def replay_csv_with_time(
    path: str, *, schema: Any, time_column: str, unit: str = "s",
    autocommit_ms: int = 100, speedup: float = 1.0, **kwargs: Any,
):
    names = list(schema.__columns__)
    dtypes = {n: c.dtype for n, c in schema.__columns__.items()}
    mult = {"s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}[unit]

    class ReplayTimeSubject(ConnectorSubject):
        def run(self) -> None:
            from pathway_tpu_torch.io.fs import _coerce

            prev_t: float | None = None
            with open(path, newline="") as f:
                for rec in _csv.DictReader(f):
                    vals = {n: _coerce(rec[n], dtypes[n]) for n in names if n in rec}
                    t = float(vals[time_column]) * mult
                    if prev_t is not None and t > prev_t:
                        _time.sleep((t - prev_t) / speedup)
                    prev_t = t
                    self.next(**vals)
                    self.commit()

    return _python_read(ReplayTimeSubject(), schema=schema, autocommit_duration_ms=autocommit_ms)
