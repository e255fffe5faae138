"""pw.io.csv (reference: io/csv wrappers over fs)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io import fs


class CsvParserSettings:
    def __init__(self, delimiter: str = ",", quote: str = '"', **kwargs: Any):
        self.delimiter = delimiter
        self.quote = quote


def read(path: Any, *, schema: Any = None, csv_settings: CsvParserSettings | None = None,
         mode: str = "streaming", **kwargs: Any):
    return fs.read(path, format="csv", schema=schema, csv_settings=csv_settings,
                   mode=mode, **kwargs)


def write(table: Any, filename: Any, **kwargs: Any) -> None:
    fs.write(table, filename, format="csv", **kwargs)
