"""IvfPqIndex: the incremental IVF-PQ index, resident on the card.

Counterpart of ``pathway_tpu/indexing/ann.py`` (the all-resident index;
its RAM/disk tiers and its mesh-sharded search wait for later slices).
`VectorSlabIndex` answers every query by scanning the whole slab; this
subclass keeps the same host bookkeeping (slots, keys, tombstone mask,
(score, key) re-rank) and maintains an IVF-PQ routing structure
(`pathway_tpu_torch/ops/ivf.py`) on top of it, incrementally:

* **additions** append into per-list cells: the nearest coarse list with
  space, spilling to the next-nearest of the top 4 (counted as *spills*),
  growing the cube when all four are full, so a row always lives inside
  its own probe footprint (the no-lost-inserts rule); chronic spilling
  schedules a retrain.
* **retractions** tombstone the row's cell; when the dead fraction
  crosses `compact_frac` the lists are compacted in place.
* **retraining** (fresh centroids and codebooks, nearest-list re-pack)
  runs against a snapshot, on a background thread unless
  `background_retrain=False`, then swaps the new generation in under the
  generation lock and replays the mutations that landed meanwhile.
  Queries racing a retrain read the old generation to the end.

Training is the JAX package's seeded numpy, so both packages build the
same generation from the same stream. Search runs `_ivf_pq_search_fn` on
the device through the plane's program ledger, over device mirrors of the
cube and of the f32 rows: small deltas are written into the resident
tensors in place (``index_put_`` / ``index_copy_``), and a shape change
(new generation, cap growth, slot-bucket growth) rebuilds them. On the
card a failed search raises: the JAX package's 3-strike degradation to
numpy is not ported, and ``device=False`` is the only road to the numpy
mirror. Below `train_min` rows the index IS the exact slab search.

`counters` and `stats()` are what callers read; with the observability
plane armed the index also publishes its gauges (``pathway_index_*``) to
the metrics registry, as the JAX package does (its tier gauges wait with
the tiers).
"""

from __future__ import annotations

import atexit
import itertools
import logging
import os
import threading
import time
import weakref
from typing import Any

import numpy as np
import torch

from pathway_tpu_torch.engine.device_plane import get_device_plane
from pathway_tpu_torch.ops import ivf as _ivf
from pathway_tpu_torch.stdlib.indexing.host_indexes import VectorSlabIndex

_GEN_SEQ = itertools.count(1)
_NAME_SEQ = itertools.count(1)
_log = logging.getLogger(__name__)

# Indexes with a live background retrain, drained at interpreter exit. A
# daemon thread still inside numpy or a torch call when the runtimes
# finalize aborts the whole process, so exit waits for every in-flight
# retrain to end, and a retrain that ends after exit began skips its
# recall probe (the thread's only device call).
_LIVE_RETRAINS: "weakref.WeakSet[IvfPqIndex]" = weakref.WeakSet()
_EXITING = threading.Event()


@atexit.register
def _drain_retrain_threads() -> None:
    _EXITING.set()
    for idx in list(_LIVE_RETRAINS):
        t = idx._retrain_thread
        if t is not None and t.is_alive():
            t.join()


def _tiers_requested(tiered, hot_lists, ram_lists) -> bool:
    # PATHWAY_ANN_TIERED as in the JAX package: unset keeps the
    # constructor's wish, 0 vetoes, anything else opts in
    want = tiered if tiered is not None else (hot_lists is not None or ram_lists is not None)
    v = os.environ.get("PATHWAY_ANN_TIERED")
    if v is None:
        return bool(want)
    return v.strip().lower() not in ("0", "false", "")


def _write_cells(cube, valid, slotmap, li, pi, codes, vbits, sids):
    cube.index_put_((li, pi), codes)
    valid.index_put_((li, pi), vbits)
    slotmap.index_put_((li, pi), sids)


def _write_rows(rows, idx, fresh):
    rows.index_copy_(0, idx, fresh)


class _Generation:
    """One trained routing structure: coarse centroids + PQ codebooks +
    the packed per-list cell arrays (host numpy). Mutations only ever
    touch cells; centroids/codebooks are immutable per generation (that
    is what makes the background-retrain swap atomic)."""

    def __init__(
        self,
        centroids: np.ndarray,
        codebooks: np.ndarray,
        cap: int,
        trained_rows: int,
    ):
        L = centroids.shape[0]
        m = codebooks.shape[0]
        self.centroids = centroids
        self.codebooks = codebooks
        self.cube = np.zeros((L, cap, m), np.uint8)
        self.valid = np.zeros((L, cap), bool)
        self.slots = np.full((L, cap), -1, np.int32)
        self.fill = np.zeros(L, np.int64)  # next append pos per list
        self.cell_of: dict[int, tuple[int, int]] = {}  # slot -> (l, pos)
        self.n_dead = 0
        self.spills = 0
        self.trained_rows = trained_rows
        self.version = next(_GEN_SEQ)

    @property
    def n_lists(self) -> int:
        return self.cube.shape[0]

    @property
    def cap(self) -> int:
        return self.cube.shape[1]

    def used_cells(self) -> int:
        return int(self.fill.sum())

    def tombstone_frac(self) -> float:
        used = self.used_cells()
        return (self.n_dead / used) if used else 0.0

    def grow_cap(self) -> None:
        L, cap, m = self.cube.shape
        self.cube = np.concatenate(
            [self.cube, np.zeros((L, cap, m), np.uint8)], axis=1
        )
        self.valid = np.concatenate(
            [self.valid, np.zeros((L, cap), bool)], axis=1
        )
        self.slots = np.concatenate(
            [self.slots, np.full((L, cap), -1, np.int32)], axis=1
        )

    def as_arrays(self, full: np.ndarray) -> _ivf.IvfPqArrays:
        return _ivf.IvfPqArrays(
            centroids=self.centroids,
            codes=self.cube,
            valid=self.valid,
            slots=self.slots,
            codebooks=self.codebooks,
            full=full,
        )


class IvfPqIndex(VectorSlabIndex):
    """Incremental IVF-PQ over the host vector slab (see module doc).

    Below `train_min` live rows the index IS the exact slab search.
    `nprobe` is the per-query recall knob: pass it per `search`/
    `search_batch` call, or rely on the per-index default
    (`ops.ivf.auto_nprobe`). `device` is as for `VectorSlabIndex`: the
    card by default, a name or ``torch.device``, or False for the numpy
    mirror. `tiered`/`hot_lists`/`ram_lists` (the RAM/disk tiers) and
    `sharded` (the mesh search) raise NotImplementedError until their
    slices land.
    """

    def __init__(
        self,
        dimensions: int | None = None,
        reserved_space: int = 1024,
        metric: str = "cos",
        device: bool | str | torch.device = True,
        *,
        n_lists: int | None = None,
        nprobe: int | None = None,
        subvectors: int | None = None,
        train_min: int = 256,
        retrain_factor: float = 1.0,
        compact_frac: float = 0.3,
        background_retrain: bool = True,
        seed: int = 0,
        name: str | None = None,
        sharded: bool | None = None,
        tiered: bool | None = None,
        hot_lists: int | None = None,
        ram_lists: int | None = None,
    ):
        if _tiers_requested(tiered, hot_lists, ram_lists):
            raise NotImplementedError(
                "the tiered IVF-PQ index (RAM/disk tiers over engine/spill.py) is "
                "not ported yet; it is next in ROADMAP's queue of modules"
            )
        if sharded if sharded is not None else os.environ.get("PATHWAY_ANN_SHARDED") == "1":
            raise NotImplementedError(
                "the mesh-sharded IVF-PQ search is not ported yet; it comes with "
                "the multi-device slice (ROADMAP A9)"
            )
        super().__init__(
            dimensions=dimensions,
            reserved_space=reserved_space,
            metric=metric,
            device=device,
        )
        self.n_lists_cfg = n_lists
        self.nprobe = nprobe
        self.subvectors = subvectors
        self.train_min = max(2, train_min)
        self.retrain_factor = retrain_factor
        self.compact_frac = compact_frac
        self.background_retrain = background_retrain
        self.seed = seed
        self.name = name or f"ivfpq-{next(_NAME_SEQ)}"
        self._gen: _Generation | None = None
        self._gen_lock = threading.RLock()
        self._retrain_mutex = threading.Lock()  # one retrain at a time
        self._retrain_thread: threading.Thread | None = None
        self._changed_since_snapshot: set[int] | None = None
        self._adds_since_train = 0
        self._nprobe_override: int | None = None
        # device mirrors of the generation (cube/valid/slots + f32 rows)
        self._ann_dev: dict[str, torch.Tensor] | None = None
        self._ann_dev_version = -1
        self._ann_dirty_cells: set[tuple[int, int]] = set()
        self._ann_full: torch.Tensor | None = None  # [padded_slots, d] f32
        self._ann_full_slots = 0
        self._ann_dirty_slots: set[int] = set()
        self.counters = {
            "retrains": 0,
            "compactions": 0,
            "spills": 0,
            "retrain_seconds": 0.0,
            "retrain_failures": 0,
            "ann_searches": 0,
            "exact_searches": 0,
            # the device mirrors: in-place writes of dirty cells and rows
            # against whole rebuilds
            "cell_updates": 0,
            "row_updates": 0,
            "cube_rebuilds": 0,
            "row_rebuilds": 0,
        }
        self.last_recall: float | None = None
        self._metrics_dirty = True

    # ----------------------------------------------------------- pickling

    def __getstate__(self):
        # under the generation lock: a background retrain may be mid-swap
        with self._gen_lock:
            st = super().__getstate__()
        st["_gen_lock"] = None
        st["_retrain_mutex"] = None
        st["_retrain_thread"] = None
        st["_changed_since_snapshot"] = None
        st["_ann_dev"] = None
        st["_ann_dev_version"] = -1
        st["_ann_dirty_cells"] = set()
        st["_ann_full"] = None
        st["_ann_full_slots"] = 0
        st["_ann_dirty_slots"] = set()
        return st

    def __setstate__(self, st):
        self.__dict__.update(st)
        self._metrics_dirty = True
        self._gen_lock = threading.RLock()
        self._retrain_mutex = threading.Lock()

    # ----------------------------------------------------------- mutation

    def add(self, key, data, metadata=None) -> None:
        with self._gen_lock:
            old_slot = self.slot_of.get(key)
            super().add(key, data, metadata)
            slot = self.slot_of[key]
            gen = self._gen
            if self._changed_since_snapshot is not None:
                self._changed_since_snapshot.add(slot)
            if gen is not None:
                if old_slot is not None:
                    # in-place value update: the row may now belong to a
                    # different list — tombstone + re-append
                    self._tombstone_cell(gen, slot)
                self._append_cell(gen, slot, self.vectors[slot])
            self._adds_since_train += 1
            self._after_mutation()

    def remove(self, key) -> None:
        with self._gen_lock:
            slot = self.slot_of.get(key)
            super().remove(key)
            if slot is None:
                return
            if self._changed_since_snapshot is not None:
                self._changed_since_snapshot.add(slot)
            if self._gen is not None:
                self._tombstone_cell(self._gen, slot)
            self._after_mutation()

    def _append_cell(self, gen: _Generation, slot: int, vec: np.ndarray) -> None:
        code = _ivf.pq_encode(vec[None, :], gen.codebooks)[0]
        cc = (gen.centroids * gen.centroids).sum(1)
        dist = cc - 2.0 * (gen.centroids @ vec.astype(np.float32))
        n_pref = min(4, gen.n_lists)
        prefs = np.argpartition(dist, n_pref - 1)[:n_pref]
        prefs = prefs[np.argsort(dist[prefs], kind="stable")]
        lst = -1
        for cand in prefs:
            if gen.fill[cand] < gen.cap:
                lst = int(cand)
                break
        if 0 <= lst != int(prefs[0]):
            # landed in a non-first preference: a spill. Chronic spilling
            # means the partition has drifted from the data — schedule a
            # re-split. (The grow path below is NOT a spill: the row ends
            # up in its true nearest list.)
            gen.spills += 1
            self.counters["spills"] += 1
        if lst < 0:
            # every preferred list full: GROW the cube and append to the
            # true nearest list. Never scatter to an arbitrary list — the
            # no-lost-inserts invariant is that a row always lives in one
            # of its top-4 nearest lists, so a self-query probing its
            # nprobe>=4 nearest lists is guaranteed to reach it.
            lst = int(prefs[0])
            gen.grow_cap()
            self._ann_dev = None  # shape changed: full device rebuild
            self._ann_dev_version = -1
        pos = int(gen.fill[lst])
        gen.cube[lst, pos] = code
        gen.valid[lst, pos] = True
        gen.slots[lst, pos] = slot
        gen.fill[lst] = pos + 1
        gen.cell_of[slot] = (lst, pos)
        self._ann_dirty_cells.add((lst, pos))
        self._ann_dirty_slots.add(slot)

    def _tombstone_cell(self, gen: _Generation, slot: int) -> None:
        cell = gen.cell_of.pop(slot, None)
        if cell is None:
            return
        lst, pos = cell
        gen.valid[lst, pos] = False
        gen.slots[lst, pos] = -1
        gen.n_dead += 1
        self._ann_dirty_cells.add((lst, pos))

    def _after_mutation(self) -> None:
        self._metrics_dirty = True
        gen = self._gen
        if gen is not None and gen.tombstone_frac() > self.compact_frac:
            self._compact(gen)
        self._maybe_retrain()

    # --------------------------------------------------------- compaction

    def _compact(self, gen: _Generation) -> None:
        """Re-pack every list dropping tombstoned cells (device cube
        rebuilt on next search). O(live cells) host work, amortized by
        the compact_frac threshold."""
        new_cube = np.zeros_like(gen.cube)
        new_valid = np.zeros_like(gen.valid)
        new_slots = np.full_like(gen.slots, -1)
        new_fill = np.zeros_like(gen.fill)
        cell_of: dict[int, tuple[int, int]] = {}
        for lst in range(gen.n_lists):
            fl = int(gen.fill[lst])
            live = np.flatnonzero(gen.valid[lst, :fl])
            k = live.size
            new_cube[lst, :k] = gen.cube[lst, live]
            new_valid[lst, :k] = True
            new_slots[lst, :k] = gen.slots[lst, live]
            new_fill[lst] = k
            for pos, slot in enumerate(gen.slots[lst, live]):
                cell_of[int(slot)] = (lst, pos)
        gen.cube, gen.valid, gen.slots = new_cube, new_valid, new_slots
        gen.fill, gen.cell_of, gen.n_dead = new_fill, cell_of, 0
        self._ann_dev = None  # cell positions moved wholesale: rebuild
        self._ann_dev_version = -1
        self._ann_dirty_cells.clear()
        self.counters["compactions"] += 1
        self._publish_metrics()

    # ---------------------------------------------------------- retraining

    def _needs_retrain(self) -> bool:
        n = len(self.slot_of)
        if self._gen is None:
            return n >= self.train_min
        if n < self.train_min:
            return False
        if self._adds_since_train > self.retrain_factor * max(
            self._gen.trained_rows, 1
        ):
            return True
        return self._gen.spills > max(64, 0.05 * n)

    def _maybe_retrain(self) -> None:
        if not self._needs_retrain():
            return
        if not self.background_retrain:
            # non-blocking: the caller may hold the generation lock (add
            # path) — blocking on the retrain mutex here while another
            # thread's retrain waits for the generation lock would ABBA-
            # deadlock. A retrain already in flight serves the need.
            if self._retrain_mutex.acquire(blocking=False):
                try:
                    self._retrain_locked()
                finally:
                    self._retrain_mutex.release()
            return
        if _EXITING.is_set():
            return
        if self._retrain_thread is not None and self._retrain_thread.is_alive():
            return
        t = threading.Thread(
            target=self._retrain_guarded,
            name=f"pw-ann-retrain-{self.name}",
            daemon=True,
        )
        self._retrain_thread = t
        _LIVE_RETRAINS.add(self)
        t.start()

    def _retrain_guarded(self) -> None:
        # a background thread has no caller to raise to: a failed retrain
        # is counted and logged, and the previous generation keeps serving
        try:
            self.retrain_now()
        except Exception:
            self.counters["retrain_failures"] += 1
            _log.exception("IvfPqIndex %s: retrain failed; keeping the previous generation", self.name)
            return
        # the sampled recall probe rides the background thread only, and
        # never once exit has begun (it searches on the device)
        if _EXITING.is_set():
            return
        try:
            self.measured_recall()
        except Exception:
            _log.exception("IvfPqIndex %s: recall probe failed", self.name)

    def retrain_now(self) -> None:
        """Train a fresh generation and swap it in. Safe to call from a
        background thread: the wave path only blocks for the final swap
        (a pointer flip + replay of mid-train mutations)."""
        with self._retrain_mutex:
            self._retrain_locked()

    def _retrain_locked(self) -> None:
        t0 = time.monotonic()
        with self._gen_lock:
            slots = np.fromiter(
                (s for s in self.key_of), np.int64, count=len(self.key_of)
            )
            if slots.size < 2:
                return
            vecs = self.vectors[slots].copy()
            self._changed_since_snapshot = set()
        # ------- heavy training OFF the lock (queries keep flowing) ----
        n, d = vecs.shape
        L = self.n_lists_cfg or _ivf.auto_lists(n)
        m = self.subvectors or _ivf.auto_subvectors(d)
        spherical = self.metric in ("cos", "cosine")
        centroids = _ivf.train_coarse_centroids(
            vecs, L, seed=self.seed, spherical=spherical
        )
        codebooks = _ivf.train_pq_codebooks(vecs, m, seed=self.seed)
        codes = _ivf.pq_encode(vecs, codebooks)
        # TRUE nearest-list assignment (unlike the throughput-tuned
        # balanced packing of ops.ivf.build_ivf_pq): the incremental
        # index promises no-lost-inserts, so every row must live in its
        # own probe footprint. Skew costs cap (scan padding), and the
        # k-means re-split is what keeps skew bounded over time.
        assign = _ivf.assign_lists(vecs, centroids)
        counts = np.bincount(assign, minlength=L)
        cap = max(
            8,
            get_device_plane().buckets.cap_bucket(
                max(2 * ((n + L - 1) // L), int(counts.max()) if n else 1), lo=8
            ),
        )
        gen = _Generation(centroids, codebooks, cap, trained_rows=n)
        for row in np.argsort(assign, kind="stable"):
            lst = int(assign[row])
            pos = int(gen.fill[lst])
            gen.cube[lst, pos] = codes[row]
            gen.valid[lst, pos] = True
            gen.slots[lst, pos] = int(slots[row])
            gen.fill[lst] = pos + 1
            gen.cell_of[int(slots[row])] = (lst, pos)
        # ------------------- atomic swap + replay ----------------------
        with self._gen_lock:
            changed = self._changed_since_snapshot or set()
            self._changed_since_snapshot = None
            for slot in changed:
                self._tombstone_cell(gen, slot)
                if slot in self.key_of:  # live now: (re-)insert fresh value
                    self._append_cell(gen, slot, self.vectors[slot])
            self._gen = gen
            self._adds_since_train = 0
            self._ann_dev = None
            self._ann_dev_version = -1
            self._ann_dirty_cells.clear()
            # the f32 row mirror survives generations (slot-addressed);
            # the exact slab's bf16 mirror serves no search from now on
            self._device_docs = self._device_valid = None
            self._dirty_slots = None
            self.counters["retrains"] += 1
            self.counters["retrain_seconds"] += time.monotonic() - t0
        self._publish_metrics()

    def wait_retrain(self, timeout: float = 60.0) -> None:
        t = self._retrain_thread
        if t is not None:
            t.join(timeout)

    # -------------------------------------------------------------- search

    def search(self, query, k, metadata_filter=None, *, nprobe=None):
        return self.search_batch([(query, k, metadata_filter)], nprobe=nprobe)[0]

    def search_batch(self, items, *, nprobe=None):
        self._nprobe_override = nprobe
        try:
            return super().search_batch(items)
        finally:
            self._nprobe_override = None

    def _topk(self, qmat: np.ndarray, k: int):
        with self._gen_lock:
            gen = self._gen
        if gen is None:
            self.counters["exact_searches"] += 1
            if self._metrics_dirty:  # mutation-state gauges, per wave at
                self._publish_metrics()  # most, never per idle search
            return super()._topk(qmat, k)
        self.counters["ann_searches"] += 1
        nprobe = (
            self._nprobe_override
            or self.nprobe
            or _ivf.auto_nprobe(gen.n_lists)
        )
        out = self._ann_topk(qmat, k, gen, nprobe)
        if self._metrics_dirty:
            self._publish_metrics()
        return out

    def _ann_topk(self, qmat: np.ndarray, k: int, gen: _Generation, nprobe: int):
        if self.device is None:
            return self._ann_topk_host(qmat, k, gen, nprobe)
        return self._ann_topk_device(qmat, k, gen, nprobe)

    def _candidates(self, k: int, gen: _Generation) -> int:
        return max(_ivf.auto_candidates(k), gen.cap)

    def _ann_topk_host(self, qmat, k, gen: _Generation, nprobe: int):
        with self._gen_lock:
            arrays = gen.as_arrays(self.vectors[: self.n_slots])
            slots_out, dists = _ivf.ivf_pq_search_host(
                qmat, arrays, min(k, len(self.slot_of)),
                nprobe=nprobe, candidates=self._candidates(k, gen),
                metric=self.metric,
            )
        return self._collect(slots_out, dists)

    def _ann_topk_device(self, qmat, k, gen: _Generation, nprobe: int):
        # the whole refresh + dispatch stays under the generation lock:
        # the retrain thread's recall probe may search concurrently with
        # the engine thread, and an in-place mirror write must never land
        # under another dispatch still reading the tensors
        with self._gen_lock:
            self._refresh_ann_device(gen)
            return self._ann_dispatch(qmat, k, gen, nprobe)

    def _ann_dispatch(self, qmat, k, gen: _Generation, nprobe: int):
        plane = get_device_plane()
        dev, full, n_full = self._ann_dev, self._ann_full, self._ann_full_slots
        # a gather past `full` is a device fault on the card, not a clamp:
        # every slot the cube names lies below n_slots
        if n_full < self.n_slots:
            raise RuntimeError(
                f"ANN index {self.name}: {n_full} rescore rows on the device "
                f"for {self.n_slots} slots"
            )
        n_q = qmat.shape[0]
        if n_q > plane.buckets.max_rows:
            qpad, qbucket = qmat.astype(np.float32), n_q
        else:
            (qpad,), qbucket = plane.pad_rows([qmat.astype(np.float32)], n_q)
        kk = min(k, len(self.slot_of))
        cand = self._candidates(k, gen)
        P = min(nprobe, gen.n_lists)
        prog = plane.program("ann_ivf_search", _ivf._ivf_pq_search_fn)
        slots_out, dists = prog(
            torch.from_numpy(np.ascontiguousarray(qpad)).to(self.device),
            dev["centroids"],
            dev["cube"],
            dev["valid"],
            dev["slots"],
            dev["codebooks"],
            full,
            k=kk,
            nprobe=P,
            candidates=cand,
            metric=self.metric,
            bucket=(
                gen.n_lists, gen.cap, gen.cube.shape[2], n_full, qbucket,
                kk, P, cand, self.dim,
            ),
        )
        return self._collect(slots_out[:n_q].cpu().numpy(), dists[:n_q].cpu().numpy())

    @staticmethod
    def _collect(slots_out: np.ndarray, dists: np.ndarray):
        out = []
        for r in range(slots_out.shape[0]):
            keep = np.isfinite(dists[r]) & (slots_out[r] >= 0)
            out.append((slots_out[r][keep], dists[r][keep]))
        return out

    # ------------------------------------------------------ device mirrors

    def _refresh_ann_device(self, gen: _Generation) -> None:
        """Sync the generation cube + f32 row mirror with host state.
        Small deltas are written into the resident tensors in place;
        shape changes (new generation, cap growth, slot-bucket growth)
        rebuild them — the same policy as the slab mirror."""
        plane = get_device_plane()
        self._refresh_ann_rows(plane)
        dev = self._ann_dev
        shape_ok = (
            dev is not None
            and self._ann_dev_version == gen.version
            and tuple(dev["cube"].shape) == gen.cube.shape
        )
        if shape_ok and self._ann_dirty_cells:
            ub = plane.buckets.rows_bucket(
                min(len(self._ann_dirty_cells), plane.buckets.max_rows)
            )
            if len(self._ann_dirty_cells) > ub:
                shape_ok = False
            else:
                # pad the update to its row bucket by repeating the first
                # cell: a repeated (index, value) pair writes the same
                # value, and the ledger sees a bounded set of shapes
                cells = list(self._ann_dirty_cells)
                cells += [cells[0]] * (ub - len(cells))
                li = np.asarray([c[0] for c in cells], np.int64)
                pi = np.asarray([c[1] for c in cells], np.int64)
                prog = plane.program("ann_cells_update", _write_cells)
                try:
                    prog(
                        dev["cube"],
                        dev["valid"],
                        dev["slots"],
                        *(
                            torch.from_numpy(a).to(self.device)
                            for a in (li, pi, gen.cube[li, pi], gen.valid[li, pi], gen.slots[li, pi])
                        ),
                        bucket=(gen.n_lists, gen.cap, ub),
                    )
                except Exception:
                    # a write that failed part-way leaves the mirror unknown
                    self._ann_dev = None
                    self._ann_dev_version = -1
                    raise
                self.counters["cell_updates"] += 1
        if not shape_ok:

            def put(a: np.ndarray) -> torch.Tensor:
                return torch.from_numpy(a).to(self.device, copy=True)

            self._ann_dev = {
                "centroids": put(gen.centroids),
                "codebooks": put(gen.codebooks),
                "cube": put(gen.cube),
                "valid": put(gen.valid),
                "slots": put(gen.slots),
            }
            self._ann_dev_version = gen.version
            self.counters["cube_rebuilds"] += 1
        self._ann_dirty_cells.clear()

    def _refresh_ann_rows(self, plane) -> None:
        """Sync the [padded_slots, d] f32 rescore rows, slot-addressed."""
        padded = self._padded_slots()
        full_ok = self._ann_full is not None and self._ann_full_slots == padded
        if full_ok and self._ann_dirty_slots:
            ub = plane.buckets.rows_bucket(
                min(len(self._ann_dirty_slots), plane.buckets.max_rows)
            )
            if len(self._ann_dirty_slots) > ub:
                full_ok = False
            else:
                idx = np.fromiter(self._ann_dirty_slots, np.int64)
                idx = np.concatenate([idx, np.full(ub - len(idx), idx[0], np.int64)])
                prog = plane.program("ann_rows_update", _write_rows)
                try:
                    prog(
                        self._ann_full,
                        torch.from_numpy(idx).to(self.device),
                        torch.from_numpy(self.vectors[idx]).to(self.device),
                        bucket=(padded, ub, self.dim),
                    )
                except Exception:
                    self._ann_full = None
                    raise
                self.counters["row_updates"] += 1
        if not full_ok:
            self._ann_full = torch.from_numpy(self.vectors[:padded]).to(self.device, copy=True)
            self._ann_full_slots = padded
            self.counters["row_rebuilds"] += 1
        self._ann_dirty_slots.clear()

    # ------------------------------------------------------------- quality

    def measured_recall(
        self,
        k: int = 10,
        sample: int = 16,
        nprobe: int | None = None,
        seed: int = 0,
    ) -> float | None:
        """Sampled recall@k of the ANN path vs the exact f32 scan over the
        live rows (`last_recall`, in `stats()`). Returns None when the
        index is still in exact (untrained) mode."""
        with self._gen_lock:
            gen = self._gen
            if gen is None or len(self.slot_of) <= k:
                return None
            live = np.fromiter(
                (s for s in self.key_of), np.int64, count=len(self.key_of)
            )
        rng = np.random.default_rng(seed)
        picks = rng.choice(live, size=min(sample, live.size), replace=False)
        qmat = self.vectors[picks].astype(np.float32)
        ann = self._ann_topk(
            qmat, k, gen, nprobe or self.nprobe or _ivf.auto_nprobe(gen.n_lists)
        )
        exact = self._topk_host(qmat, k)
        hits = 0
        total = 0
        for (a_idx, _a_d), (e_idx, e_d) in zip(ann, exact):
            order = np.argsort(e_d, kind="stable")[:k]
            e_set = set(int(s) for s in np.asarray(e_idx)[order])
            a_set = set(int(s) for s in np.asarray(a_idx)[:k])
            total += len(e_set)
            hits += len(e_set & a_set)
        recall = (hits / total) if total else 1.0
        self.last_recall = recall
        self._publish_metrics(recall_k=k)
        return recall

    # ------------------------------------------------------------- metrics

    def _publish_metrics(self, recall_k: int | None = None) -> None:
        from pathway_tpu_torch.internals import observability as _obs

        plane = _obs.PLANE
        if plane is None:
            return  # stay dirty: publish once the plane comes up
        self._metrics_dirty = False
        labels = {"index": self.name}
        gen = self._gen
        m = plane.metrics
        m.gauge(
            "pathway_index_size_rows", len(self.slot_of), labels,
            help="live rows in the ANN index",
        )
        m.gauge(
            "pathway_index_lists", gen.n_lists if gen else 0, labels,
            help="coarse IVF lists in the current generation (0 = exact mode)",
        )
        m.gauge(
            "pathway_index_tombstone_frac",
            gen.tombstone_frac() if gen else 0.0, labels,
            help="dead fraction of used cells (compaction trigger)",
        )
        m.gauge(
            "pathway_index_retrain_seconds",
            self.counters["retrain_seconds"], labels,
            help="cumulative background-retrain wall seconds",
        )
        m.gauge(
            "pathway_index_spills", self.counters["spills"], labels,
            help="appends that overflowed their preferred list",
        )
        m.gauge(
            "pathway_index_retrains", self.counters["retrains"], labels,
            help="generation swaps since start",
        )
        m.gauge(
            "pathway_index_compactions", self.counters["compactions"], labels,
            help="tombstone compactions since start",
        )
        if recall_k is not None and self.last_recall is not None:
            m.gauge(
                "pathway_index_recall_at_k",
                self.last_recall,
                {**labels, "k": str(recall_k)},
                help="sampled ANN recall@k vs the exact scan",
            )

    # ------------------------------------------------------------- stats

    def stats(self) -> dict[str, Any]:
        with self._gen_lock:
            gen = self._gen
            return {
                "size_rows": len(self.slot_of),
                "lists": gen.n_lists if gen else 0,
                "cap": gen.cap if gen else 0,
                "tombstone_frac": gen.tombstone_frac() if gen else 0.0,
                "trained": gen is not None,
                "recall_at_k": self.last_recall,
                **self.counters,
            }
