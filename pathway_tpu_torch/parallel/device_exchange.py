"""Engine hook for the device data plane of a shuffle: batches whose rows
carry numeric vector columns (embeddings and the like) move those
payloads between worker shards through the mesh exchange
(``parallel/exchange.py``) instead of the host object plane; per-row
control metadata (key, scalar columns, diff) stays on the host.

Counterpart of ``pathway_tpu/parallel/device_exchange.py``. The mesh is
``parallel.mesh.default_mesh()``: every CUDA device, or the shards that
``PATHWAY_MESH_DEVICES`` names (``cpu*8`` on the CPU, ``cuda:0*4`` on one
card).

Mode (``PATHWAY_DEVICE_EXCHANGE``): "1" forces the device plane on, "0"
forces it off, unset is AUTO. Auto engages per batch only when both:

* the mesh spans at least two distinct CUDA devices (shards that share
  one device only copy within it: the JAX package's rule that only a
  real multi-device TPU mesh is eligible), and
* the vector payload holds at least ``PATHWAY_DEVICE_EXCHANGE_MIN_ELEMS``
  elements (default 262144, the JAX package's measured crossover against
  the pickled TCP wire).

So on one H100 auto takes the host wire, as the JAX package does on one
chip. Payload dtypes: float32 natively, int32 bit-exactly as a float32
view; float64 stays on the host (a cast would change row bytes and break
retraction identity).

The eligibility gates decide the wire before any dispatch: fewer than
``MIN_ROWS`` rows, more shards than the mesh has, no vector columns, a
float64 column, a dtype that changes mid-batch, ragged rows, a route
function that raises, auto's minimum. Past them nothing degrades: a
failed exchange raises, and under a forced mode so does a mesh that
cannot be built (the JAX package returns None there and takes the host
wire).
"""

from __future__ import annotations

import os
from typing import Any, Callable

import numpy as np
import torch

from pathway_tpu_torch.parallel.exchange import exchange_with_respill
from pathway_tpu_torch.parallel.mesh import default_mesh

AUTO_MIN_ELEMS = 262_144  # the JAX package's measured wire crossover


def mode() -> str:
    v = os.environ.get("PATHWAY_DEVICE_EXCHANGE")
    if v == "1":
        return "force"
    if v == "0":
        return "off"
    return "auto"


def enabled() -> bool:
    return mode() != "off"


def auto_min_elems() -> int:
    raw = os.environ.get("PATHWAY_DEVICE_EXCHANGE_MIN_ELEMS")
    if raw is None:
        return AUTO_MIN_ELEMS
    try:
        return int(float(raw))
    except ValueError:
        return AUTO_MIN_ELEMS  # malformed override: keep the measured default


def auto_eligible_mesh(mesh) -> bool:
    """Auto mode pays only across at least two distinct CUDA devices."""
    return len({d for d in mesh.devices.flat if d.type == "cuda"}) >= 2


def auto_can_engage() -> bool:
    """Whether auto mode could engage on this machine (two CUDA devices
    at least); when it cannot, the engine hooks take the host wire
    without building a mesh."""
    return torch.cuda.device_count() >= 2


def note_exchange_metrics(rows: int) -> None:
    """Wire-cost visibility for the adaptive planner (and /metrics),
    shared by the vector-payload and scalar-column planes: one pair of
    counters governs the AUTO crossover retune at the next epoch fence
    (internals/planner.py `_retune_exchange`)."""
    from pathway_tpu_torch.internals import observability as _obs

    if _obs.PLANE is not None:
        m = _obs.PLANE.metrics
        m.counter(
            "pathway_device_exchange_invocations",
            help="device-mesh batch exchanges dispatched",
        )
        m.counter(
            "pathway_device_exchange_rows", inc=rows,
            help="rows moved over the device-mesh exchange",
        )


class DeviceExchanger:
    """Routes the ndarray columns of an entry batch over the device mesh.

    Per batch: the rows' float ndarray columns (one dtype and shape across
    the batch) are stacked into one [n, d] matrix and shuffled to their
    destination shards by the mesh exchange with host-exact routing;
    every other column travels as control metadata. Rows are reassembled
    at the destination in (src-major, arrival) order.
    """

    MIN_ROWS = 8  # below this the dispatch overhead always dominates

    def __init__(self, mesh=None, axis: str = "data"):
        self.mesh = mesh if mesh is not None else default_mesh((axis,))
        self.axis = axis
        self.invocations = 0
        self.rows_exchanged = 0
        self._auto_ok = auto_eligible_mesh(self.mesh)
        self._auto_min = auto_min_elems()  # parsed once, not per batch
        # _auto_min_base anchors the adaptive planner's retuning: each
        # run's policy restores it and bounds its doublings relative to
        # it, so tuning never ratchets across pw.run calls of this
        # process-wide exchanger (internals/planner.py)
        self._auto_min_base = self._auto_min
        # the mode is read once here (an env read per batch is measurable
        # on the wave path); the adaptive policy refreshes it at fences
        self._mode = mode()

    @staticmethod
    def _vector_columns(row: tuple) -> list[int]:
        # f32 rides natively; i32 rides as a bit-exact f32 view. f64
        # would come back rounded, and different row bytes break
        # retraction matching downstream, so it stays on the host.
        return [
            i
            for i, v in enumerate(row)
            if isinstance(v, np.ndarray)
            and v.dtype in (np.float32, np.int32)
            and v.ndim >= 1
        ]

    def try_exchange(
        self,
        entries: list,
        shard_of_entry: Callable[[Any, tuple], int],
        n_shards: int,
    ) -> list[list] | None:
        """Per-shard entry lists, or None when the batch is not eligible
        (no or irregular vector columns, too small, mesh mismatch).
        shard_of_entry(key, row) must be the operator's exact host
        routing rule; device routing follows it bit for bit."""
        if len(entries) < self.MIN_ROWS:
            return None
        if n_shards > self.mesh.shape[self.axis]:
            return None
        first_row = entries[0][1]
        vcols = self._vector_columns(first_row)
        if not vcols:
            return None
        shapes = [first_row[c].shape for c in vcols]
        dtypes = [first_row[c].dtype for c in vcols]
        n = len(entries)
        if self._mode == "off":
            return None
        if self._mode == "auto":
            n_elems = n * sum(int(np.prod(s)) for s in shapes)
            if not (self._auto_ok and n_elems >= self._auto_min):
                return None  # below the measured wire crossover
        dests = np.empty(n, np.int64)
        mats = []
        try:
            for j, c in enumerate(vcols):
                mat = np.stack([e[1][c] for e in entries])
                if mat.dtype != dtypes[j]:
                    # a later row changed dtype: a cast would change row
                    # bytes silently (see _vector_columns): host wire
                    return None
                if mat.dtype == np.int32:
                    mat = mat.view(np.float32)  # bit-exact transport form
                mats.append(mat.reshape(n, -1))
            for i, (key, row, _diff) in enumerate(entries):
                dests[i] = shard_of_entry(key, row)
        except Exception:  # noqa: BLE001 — ragged rows / failing routes: ineligible
            return None
        widths = [m.shape[1] for m in mats]
        payload = np.concatenate(mats, axis=1) if len(mats) > 1 else mats[0]
        ids = np.arange(n, dtype=np.int64)  # reassembly uses the src indices
        _keys, pays, srcs = exchange_with_respill(ids, payload, dests, self.mesh, self.axis)
        self.invocations += 1
        self.rows_exchanged += n
        note_exchange_metrics(n)
        out: list[list] = [[] for _ in range(n_shards)]
        splits = np.cumsum(widths)[:-1]
        for d in range(n_shards):
            for vec_row, i in zip(pays[d], srcs[d]):
                key, row, diff = entries[int(i)]
                parts = np.split(vec_row, splits) if len(mats) > 1 else [vec_row]
                new_row = list(row)
                for j, c in enumerate(vcols):
                    p = np.ascontiguousarray(parts[j], np.float32)
                    if dtypes[j] == np.int32:
                        p = p.view(np.int32)  # undo the bit-exact view
                    new_row[c] = p.reshape(shapes[j])
                out[d].append((key, tuple(new_row), diff))
        return out


_ENGINE_EXCHANGER: DeviceExchanger | None = None


def engine_exchanger() -> DeviceExchanger | None:
    """The process-wide exchanger of the engine's sharded nodes, or None
    for the host wire: when the mode is off, or auto with fewer than two
    CUDA devices (auto could never engage). Under a forced mode a mesh
    that cannot be built raises."""
    global _ENGINE_EXCHANGER
    m = mode()
    if m == "off":
        return None
    if _ENGINE_EXCHANGER is None:
        if m == "auto" and not auto_can_engage():
            return None
        _ENGINE_EXCHANGER = DeviceExchanger()
    return _ENGINE_EXCHANGER
