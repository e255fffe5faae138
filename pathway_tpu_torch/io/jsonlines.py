"""pw.io.jsonlines (reference: io/jsonlines)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io import fs


def read(path: Any, *, schema: Any = None, mode: str = "streaming", **kwargs: Any):
    return fs.read(path, format="json", schema=schema, mode=mode, **kwargs)


def write(table: Any, filename: Any, **kwargs: Any) -> None:
    fs.write(table, filename, format="json", **kwargs)
