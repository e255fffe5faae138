"""Engine hook for the device data plane of a shuffle: the host wire only.

Counterpart of ``pathway_tpu/parallel/device_exchange.py``. There, rows
that carry vector columns may cross worker shards through a device-mesh
``all_to_all``; the port has no device mesh until the multi-device slice
(ROADMAP item A9), so :func:`engine_exchanger` returns None and the
engine's exchange sites (``engine/workers.py``, ``internals/planner.py``)
take the host wire. That is also what the JAX package's default mode does
on any mesh that is not a real multi-device TPU, so the outputs are the
same.

Mode (``PATHWAY_DEVICE_EXCHANGE``): "1" forces the device wire, which
raises here; "0" and unset take the host wire.
"""

from __future__ import annotations

import os

# the process-wide exchanger the planner retunes; the port never builds one
_ENGINE_EXCHANGER = None


def mode() -> str:
    v = os.environ.get("PATHWAY_DEVICE_EXCHANGE")
    if v == "1":
        return "force"
    if v == "0":
        return "off"
    return "auto"


def require_host_wire() -> None:
    """Raise when the caller forces the device wire, which waits for the
    multi-device slice."""
    if mode() == "force":
        raise NotImplementedError(
            "PATHWAY_DEVICE_EXCHANGE=1 forces the device-mesh exchange, which "
            "waits for the multi-device port (ROADMAP item A9); unset it to "
            "shuffle on the host wire"
        )


def engine_exchanger() -> None:
    """The engine's vector-payload exchanger: None, the host wire."""
    require_host_wire()
    return None
