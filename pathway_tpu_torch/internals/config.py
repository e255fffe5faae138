"""Runtime configuration from environment (reference: internals/config.py +
src/engine/dataflow/config.rs env-first config).

Env vars mirror the reference's: PATHWAY_THREADS, PATHWAY_PROCESSES,
PATHWAY_PROCESS_ID, PATHWAY_FIRST_PORT, PATHWAY_PERSISTENT_STORAGE,
PATHWAY_RUN_ID. TPU additions: PATHWAY_DEVICE (cpu|tpu), PATHWAY_MESH
(e.g. "dp=2,tp=4" for the device mesh used by the numeric plane).
"""

from __future__ import annotations

import os
import uuid
from dataclasses import dataclass, field


@dataclass
class PathwayConfig:
    threads: int = 1
    processes: int = 1
    process_id: int = 0
    first_port: int = 10000
    run_id: str = field(default_factory=lambda: str(uuid.uuid4()))
    persistent_storage_path: str | None = None
    license_key: str | None = None
    monitoring_server: str | None = None
    ignore_asserts: bool = False
    device: str = "cpu"
    mesh_spec: str | None = None
    terminate_on_error: bool = False

    @property
    def replay_storage(self) -> str | None:
        return os.environ.get("PATHWAY_REPLAY_STORAGE")

    @property
    def replay_mode(self) -> str:
        return os.environ.get("PATHWAY_REPLAY_MODE", "")


def _int_env(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


_config: PathwayConfig | None = None


def get_config(refresh: bool = False) -> PathwayConfig:
    global _config
    if _config is None or refresh:
        _config = PathwayConfig(
            threads=_int_env("PATHWAY_THREADS", 1),
            processes=_int_env("PATHWAY_PROCESSES", 1),
            process_id=_int_env("PATHWAY_PROCESS_ID", 0),
            first_port=_int_env("PATHWAY_FIRST_PORT", 10000),
            persistent_storage_path=os.environ.get("PATHWAY_PERSISTENT_STORAGE"),
            license_key=os.environ.get("PATHWAY_LICENSE_KEY"),
            monitoring_server=os.environ.get("PATHWAY_MONITORING_SERVER"),
            device=os.environ.get("PATHWAY_DEVICE", "cpu"),
            mesh_spec=os.environ.get("PATHWAY_MESH"),
        )
    return _config


def set_license_key(key: str | None) -> None:
    get_config().license_key = key


def set_monitoring_config(*, server_endpoint: str | None = None) -> None:
    get_config().monitoring_server = server_endpoint
