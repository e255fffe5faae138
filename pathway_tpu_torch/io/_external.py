"""Shared machinery for service-backed connectors.

The reference implements these against native client crates
(src/connectors/data_storage.rs). Here each family exposes the same
read()/write() API; families whose client library is absent in the runtime
raise a clear error at call time (the API surface and descriptors stay
importable so templates/YAML configs parse).
"""

from __future__ import annotations

import importlib
from typing import Any


def require_module(name: str, family: str) -> Any:
    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(
            f"pw.io.{family} requires the {name!r} package, which is not "
            f"installed in this environment"
        ) from e


# (the former gated_reader/gated_writer stubs are gone: every connector
# family now carries a real implementation, raising ImportError only when
# its client library is genuinely absent)
