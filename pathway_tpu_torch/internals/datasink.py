"""DataSink: descriptor consumed by Table.to (reference: internals/datasink.py)."""

from __future__ import annotations

from typing import Any, Callable


class DataSink:
    """Base: sinks register an output in the global parse graph."""

    def consume(self, table: Any) -> None:
        raise NotImplementedError


class CallbackDataSink(DataSink):
    def __init__(
        self,
        write_batch: Callable[[int, list], None],
        flush: Callable[[], None] | None = None,
        close: Callable[[], None] | None = None,
    ):
        self.write_batch = write_batch
        self.flush = flush
        self.close = close

    def consume(self, table: Any) -> None:
        from pathway_tpu_torch.internals.parse_graph import G

        G.add_sink(
            "output",
            table,
            write_batch=self.write_batch,
            flush=self.flush,
            close=self.close,
        )
