"""pw.io.airbyte — ingest records from an Airbyte source connector.

Reference parity: python/pathway/io/airbyte/__init__.py, which drives an
Airbyte source (docker image or PyAirbyte venv) through the Airbyte
protocol and streams its RECORD messages. Here the connector runs the
source as a subprocess speaking the Airbyte protocol on stdout (the
`docker run <image> read --config ... --catalog ...` contract); records
stream into the table as JSON rows. Requires a container runtime (or any
executable implementing the protocol) — checked at call time.
"""

from __future__ import annotations

import json as _json
import os
import subprocess
import tempfile
import time as _time
from typing import Any, Sequence

from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.json import Json


def read(
    config_file_path: str | os.PathLike | None = None,
    streams: Sequence[str] = (),
    *,
    config: dict | None = None,
    image: str | None = None,
    executable: str | None = None,
    mode: str = "streaming",
    refresh_interval_ms: int = 60000,
    name: str | None = None,
    **kwargs: Any,
) -> Any:
    """Runs an Airbyte source and streams its RECORD messages for the
    selected `streams` as rows with a single Json `data` column.

    Provide either `image` (docker image of the source, run via docker) or
    `executable` (a local binary/script speaking the Airbyte protocol).
    """
    from pathway_tpu_torch.io.python import ConnectorSubject
    from pathway_tpu_torch.io.python import read as python_read

    if config is None:
        if config_file_path is None:
            raise ValueError("pw.io.airbyte.read needs config or config_file_path")
        with open(config_file_path) as f:
            text = f.read()
        config = (
            _json.loads(text)
            if text.lstrip().startswith("{")
            else __import__("yaml").safe_load(text)
        )
    if not streams:
        raise ValueError(
            "pw.io.airbyte.read requires at least one stream name; the "
            "configured catalog syncs exactly the streams you list"
        )
    if image is None and executable is None:
        raise ValueError(
            "pw.io.airbyte.read requires `image` (docker) or `executable` "
            "(a local Airbyte-protocol source)"
        )
    if image is not None and executable is None:
        import shutil

        if shutil.which("docker") is None:
            raise RuntimeError(
                "pw.io.airbyte: docker is not available to run the source "
                f"image {image!r}; pass `executable` instead"
            )

    schema = sch.schema_from_types(data=Json)
    wanted = set(streams)

    class AirbyteSubject(ConnectorSubject):
        def run(self) -> None:
            with tempfile.TemporaryDirectory() as tmp:
                cfg = os.path.join(tmp, "config.json")
                with open(cfg, "w") as f:
                    _json.dump(config, f)
                catalog = os.path.join(tmp, "catalog.json")
                with open(catalog, "w") as f:
                    _json.dump(self._catalog(), f)
                while True:
                    self._one_sync(cfg, catalog, tmp)
                    if mode != "streaming":
                        return
                    _time.sleep(refresh_interval_ms / 1000.0)

        def _catalog(self) -> dict:
            return {
                "streams": [
                    {
                        "stream": {"name": s, "json_schema": {}, "supported_sync_modes": ["full_refresh"]},
                        "sync_mode": "full_refresh",
                        "destination_sync_mode": "append",
                    }
                    for s in wanted
                ]
            }

        def _one_sync(self, cfg: str, catalog: str, tmp: str) -> None:
            if executable is not None:
                cmd = [executable, "read", "--config", cfg, "--catalog", catalog]
            else:
                cmd = [
                    "docker", "run", "--rm", "-i",
                    "-v", f"{tmp}:/airbyte-config",
                    image,
                    "read", "--config", "/airbyte-config/config.json",
                    "--catalog", "/airbyte-config/catalog.json",
                ]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )
            assert proc.stdout is not None
            for line in proc.stdout:
                try:
                    msg = _json.loads(line)
                except ValueError:
                    continue
                if msg.get("type") == "RECORD":
                    rec = msg.get("record", {})
                    if rec.get("stream") in wanted:
                        self.next(data=Json(rec.get("data", {})))
            _stdout, stderr = proc.communicate(timeout=60)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"airbyte source exited with {proc.returncode}: "
                    f"{(stderr or '')[-1000:]}"
                )

    return python_read(
        AirbyteSubject(),
        schema=schema,
        name=name or f"airbyte:{','.join(wanted) or 'all'}",
    )


__all__ = ["read"]
