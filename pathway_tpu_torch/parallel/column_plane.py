"""Engine hook for the sharded column plane: the host wire only.

Counterpart of ``pathway_tpu/parallel/column_plane.py``, where a
NativeBatch's scalar columns may cross worker shards as one device
collective. The port has no device mesh until the multi-device slice
(ROADMAP item A9): :func:`engine_column_exchanger` returns None, and the
engine's exchange sites (``engine/workers.py``, ``engine/cone.py``,
``internals/planner.py``) split batches on the host with the same routing.
``PATHWAY_DEVICE_EXCHANGE=1`` raises (see ``device_exchange.py``).
"""

from __future__ import annotations

from pathway_tpu_torch.parallel.device_exchange import require_host_wire

# the process-wide exchanger the planner retunes; the port never builds one
_ENGINE_EXCHANGER = None


def engine_column_exchanger() -> None:
    """The engine's column exchanger: None, the host wire."""
    require_host_wire()
    return None
