"""pw.io.plaintext (reference: io/plaintext)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io import fs


def read(path: Any, *, mode: str = "streaming", **kwargs: Any):
    return fs.read(path, format="plaintext", mode=mode, **kwargs)


def write(table: Any, filename: Any, **kwargs: Any) -> None:
    fs.write(table, filename, format="plaintext", **kwargs)
