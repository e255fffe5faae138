"""Sharded NativeBatch column plane: the engine's key-hash shuffle as one
mesh collective.

Counterpart of ``pathway_tpu/parallel/column_plane.py``. The host
exchange moves a wave's rows either as per-row Python entries (pickled
over the process mesh) or as ``NativeBatch.select`` masks (thread
shards). This module lifts the batch's scalar columns (key_lo, key_hi,
token, diff: flat 64-bit arrays) onto the mesh's devices and shuffles the
whole column set with one ``all_to_all`` a round
(``parallel/exchange.py exchange_columns_with_respill``). Routing stays a
host decision (``engine/workers.native_shards``: the exact 128-bit
``key % n_shards`` or the group-key rule), and frontier and watermark
traffic stays on the host ring (``parallel/process_mesh.py``). Intern
tokens are process-wide, so a split inside one process needs no row
blob.

Mode (``PATHWAY_DEVICE_EXCHANGE``, shared with the vector plane): "1"
forces the column plane on, "0" forces it off, unset is AUTO: on only
across at least two CUDA devices, for batches of at least
``auto_min_rows()`` rows (the vector plane's 262144-element crossover over
the 4 lanes a scalar batch ships; the adaptive planner retunes it from
the ``pathway_device_exchange_rows`` counters in both directions).

Faults: the ``mesh.device_wire`` fault point models the wire dropping a
wave. One retry, and a second fault raises; the JAX package's
degradation to the host wire is not ported, and neither is any other:
a failed collective raises.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np

from pathway_tpu_torch.analysis import lockgraph as _lockgraph
from pathway_tpu_torch.engine import faults
from pathway_tpu_torch.parallel import device_exchange as _dx
from pathway_tpu_torch.parallel.exchange import exchange_columns_with_respill
from pathway_tpu_torch.parallel.mesh import default_mesh

__all__ = [
    "ColumnExchanger",
    "engine_column_exchanger",
    "auto_min_rows",
    "stats",
    "reset_stats",
]

# the vector plane's crossover is in ELEMENTS; a scalar batch ships 4
# 64-bit lanes a row, so rows = elems / 4
_AUTO_LANES = 4


def auto_min_rows() -> int:
    return max(_dx.auto_min_elems() // _AUTO_LANES, 1)


_STATS_LOCK = _lockgraph.register_lock("column_plane.stats", threading.Lock())
_STATS = {
    "invocations": 0,  # column-plane collectives dispatched
    "rows": 0,  # rows shuffled over the device wire
    "wire_faults": 0,  # mesh.device_wire shots (the retried one included)
}


def stats() -> dict:
    with _STATS_LOCK:
        return dict(_STATS)


def reset_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


class ColumnExchanger:
    """Splits a NativeBatch across shards through the mesh collective.

    ``split_batch(batch, shards, n_shards)`` returns the per-shard
    sub-batches (token-valid in this process), or None when the batch
    takes the host path (mode off, auto below its gate, more shards than
    the mesh, an empty batch). The result is row for row
    ``[batch.select(shards == p) for p in range(n_shards)]``.
    """

    MIN_ROWS = 8  # below this the dispatch overhead always dominates

    def __init__(self, mesh=None, axis: str = "data"):
        self.mesh = mesh if mesh is not None else default_mesh((axis,))
        self.axis = axis
        self._auto_ok = _dx.auto_eligible_mesh(self.mesh)
        self._auto_min_rows = auto_min_rows()
        self._auto_min_rows_base = self._auto_min_rows
        # read once, as DeviceExchanger._mode; the adaptive policy
        # refreshes it at its fences
        self._mode = _dx.mode()

    def split_batch(self, batch: Any, shards: np.ndarray, n_shards: int) -> "list | None":
        n = len(batch)
        if n_shards > self.mesh.shape[self.axis]:
            return None
        if self._mode == "off":
            return None
        if self._mode == "auto" and not (
            self._auto_ok and n >= max(self._auto_min_rows, self.MIN_ROWS)
        ):
            return None  # below the measured wire crossover
        if n == 0:
            return None  # nothing to ship; an empty split is the host's
        for attempt in (0, 1):
            try:
                # the injectable wire: a drop retries once, a second raises
                faults.check("mesh.device_wire")
            except faults.FaultInjected:
                with _STATS_LOCK:
                    _STATS["wire_faults"] += 1
                if attempt == 1:
                    raise
                continue
            break
        cols_per_dest, _srcs = exchange_columns_with_respill(
            [batch.key_lo, batch.key_hi, batch.token, batch.diff],
            np.asarray(shards, np.int64),
            self.mesh,
            self.axis,
        )
        with _STATS_LOCK:
            _STATS["invocations"] += 1
            _STATS["rows"] += n
        _dx.note_exchange_metrics(n)
        from pathway_tpu_torch.engine.native.dataplane import NativeBatch

        out = []
        for d in range(n_shards):
            lo, hi, tok, diff = cols_per_dest[d]
            out.append(
                NativeBatch(
                    batch.tab, lo, hi, tok, diff,
                    # a split of pairwise-distinct +1 rows stays distinct
                    distinct_hint=batch.distinct_hint,
                )
            )
        return out


_ENGINE_EXCHANGER: ColumnExchanger | None = None


def engine_column_exchanger() -> ColumnExchanger | None:
    """The process-wide column exchanger of the engine's exchange sites,
    or None for the host wire (see ``device_exchange.engine_exchanger``);
    under a forced mode a mesh that cannot be built raises."""
    global _ENGINE_EXCHANGER
    m = _dx.mode()
    if m == "off":
        return None
    if _ENGINE_EXCHANGER is None:
        if m == "auto" and not _dx.auto_can_engage():
            return None
        _ENGINE_EXCHANGER = ColumnExchanger()
    return _ENGINE_EXCHANGER
