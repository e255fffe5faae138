"""Morsel-driven parallel execution: cache-sized work units + stealing.

The reference engine scales by partitioning *data* across timely workers
rather than operators (SURVEY.md §worker-architecture); until this
module the thread plane here statically assigned one pool future per
operator replica, so one straggling replica stalled the whole wave
barrier while its siblings' threads idled. This module replaces that
static assignment with *morsels* — cache-sized row batches
(``PATHWAY_MORSEL_ROWS``, default 64k rows) — queued per operator and
drained by a small work-stealing crew:

* every stateful replica owns ONE ordered queue of morsel tasks
  (stateful updates must apply in segment order, and exactly one thread
  may touch a replica's state at any instant — the single-consumer
  invariant ``internals/verifier.check_morsel_contract`` re-proves);
* a worker prefers its own queues newest-first (LIFO-local: the most
  recently enqueued queue's rows are the cache-warm ones) and steals
  the OLDEST claimable queue of another worker (FIFO-steal: the oldest
  queue has waited longest, so draining it shortens the wave's critical
  path most);
* a queue is claimed one morsel at a time behind a ``busy`` latch, so a
  straggling replica's REMAINING morsels migrate to idle threads the
  moment the current morsel completes — stealing moves future work,
  never in-flight state.

Why emission order survives: tasks only *compute* (native groupby
updates, replica fires into private per-replica collectors); all
emission happens after the wave barrier, on the calling thread, in
replica order (``ShardedNode._emit_collected``) with per-replica parts
merged in segment order (``cone._merge_agg``). Which thread ran a
morsel is therefore unobservable in the output bytes.

``PATHWAY_MORSEL=0`` bypasses every morsel path byte-identically (the
``morsel-off`` CI leg pins it); the gates are read at session seams
(``refresh``) and mirrored into process caches for the hot paths —
never read from the environment per wave (the PR 9(h) bug class).
"""

from __future__ import annotations

import os
import threading
from time import perf_counter_ns
from typing import Any, Callable, Sequence

from pathway_tpu_torch.analysis import lockgraph as _lockgraph

__all__ = [
    "DEFAULT_ROWS",
    "enabled",
    "enabled_cached",
    "morsel_rows",
    "morsel_rows_cached",
    "refresh",
    "set_rows",
    "split_batch",
    "run_stealing",
    "last_run",
    "live_depth",
]

DEFAULT_ROWS = 65536

# injected-straggler probe: the seeded determinism harness
# (tests/test_morsel.py) delays morsels here via PATHWAY_FAULTS
# ("morsel.steal.straggler~0.3;seed=N") to force steals and assert the
# stolen runs stay byte-identical to serial
_STRAGGLER_POINT = "morsel.steal.straggler"
_STRAGGLER_SLEEP_S = 0.002


# ------------------------------------------------------------------- gates


def enabled() -> bool:
    """PATHWAY_MORSEL=0 restores the pre-morsel execution byte-
    identically (A/B-pinned by the morsel-off leg). Environment read —
    call at construction/lowering seams only; hot paths use
    :func:`enabled_cached`."""
    return os.environ.get("PATHWAY_MORSEL", "1") != "0"


def morsel_rows() -> int:
    """PATHWAY_MORSEL_ROWS: target rows per morsel (default 64k — about
    a cache-friendly column slice; tests set tiny values to force
    splitting on small inputs). Environment read — seams only."""
    try:
        v = int(os.environ.get("PATHWAY_MORSEL_ROWS", str(DEFAULT_ROWS)))
    except ValueError:
        return DEFAULT_ROWS
    return max(1, v)


# Hot-path mirrors (the verifier.enabled_cached pattern): refreshed at
# every session's execute seam so an in-process env flip applies
# uniformly from the next session build — never mid-wave.
_ENABLED_CACHE: bool | None = None
_ROWS_CACHE: int | None = None
# the env-configured base: adaptive retunes (planner._retune_morsels)
# move _ROWS_CACHE within bounded multiples of this, never past it
_ROWS_BASE: int = DEFAULT_ROWS


def enabled_cached() -> bool:
    global _ENABLED_CACHE
    if _ENABLED_CACHE is None:
        _ENABLED_CACHE = enabled()
    return _ENABLED_CACHE


def morsel_rows_cached() -> int:
    global _ROWS_CACHE
    if _ROWS_CACHE is None:
        refresh()
    return _ROWS_CACHE  # type: ignore[return-value]


def refresh() -> bool:
    """Re-read both gates and refresh the hot-path caches; the build
    gate in Session.execute calls this (and fs connector construction
    snapshots the values into its info dict)."""
    global _ENABLED_CACHE, _ROWS_CACHE, _ROWS_BASE
    _ENABLED_CACHE = enabled()
    _ROWS_BASE = morsel_rows()
    _ROWS_CACHE = _ROWS_BASE
    return _ENABLED_CACHE


def set_rows(n: int) -> int:
    """Adaptive morsel sizing (planner fences): clamp to bounded
    multiples of the configured base so auto-tuning can neither explode
    a morsel past cache residency nor shred waves into dispatch
    confetti. Returns the applied value."""
    global _ROWS_CACHE
    base = _ROWS_BASE
    floor = max(base // 16, 1024)
    ceil = min(base * 16, 1 << 20)
    if floor > ceil:  # tiny test-forced bases: keep them pinned
        floor = ceil = base
    _ROWS_CACHE = max(floor, min(int(n), ceil))
    return _ROWS_CACHE


# ---------------------------------------------------------- batch splitting


def split_batch(batch: Any, rows: int) -> list:
    """Row-contiguous morsel slices of a NativeBatch. Concatenating the
    slices in order reproduces the input row-for-row (boolean-mask
    ``select`` preserves ``distinct_hint``), so every downstream merge
    proof over segments applies unchanged to morsels."""
    n = len(batch)
    if n <= rows:
        return [batch]
    import numpy as np

    idx = np.arange(n)
    return [
        batch.select((idx >= s) & (idx < s + rows))
        for s in range(0, n, rows)
    ]


# ------------------------------------------------------- stealing scheduler

_STEAL_LOCK = _lockgraph.register_lock("morsel.steal", threading.Lock())

# live number of unclaimed+in-flight morsels (frontier pump publishes it
# as the pathway_morsel_queue_depth gauge) and the last wave's stats
_LIVE_DEPTH = 0
_LAST_RUN: dict = {"queues": 0, "tasks": 0, "steals": 0, "local": 0}


def live_depth() -> int:
    return _LIVE_DEPTH


def last_run() -> dict:
    return dict(_LAST_RUN)


class _Queue:
    __slots__ = ("tasks", "next", "busy")

    def __init__(self, tasks: list):
        self.tasks = tasks
        self.next = 0
        self.busy = False


class StealScheduler:
    """One wave's morsel queues + the claim protocol.

    Claim invariants (re-proved by check_morsel_contract's probe):
      * per queue, morsels run in index order (stateful replicas);
      * at any instant at most one thread runs a given queue (the
        ``busy`` latch IS the single-consumer guarantee);
      * every morsel runs exactly once, or not at all after a failure
        (the wave raises, downstream never consumes partial output).

    Termination needs no waiting: a runner finding no claimable queue
    exits — any still-busy queue's remaining morsels are re-claimed by
    whichever runner finishes its current morsel, so active runners
    never drop below the number of claimable queues.
    """

    def __init__(self, queues: Sequence[Sequence[Callable[[], Any]]],
                 n_workers: int):
        global _LIVE_DEPTH
        self._qs = [_Queue(list(ts)) for ts in queues]
        self._n_workers = max(1, n_workers)
        self._fail: BaseException | None = None
        self.steals = 0
        self.local = 0
        self.task_ns: list[int] = []
        self._total = sum(len(q.tasks) for q in self._qs)
        with _STEAL_LOCK:
            _LIVE_DEPTH += self._total

    def _claim(self, wid: int):
        """Next (queue, task, stolen) for worker `wid`, or None when
        nothing is claimable. LIFO over the worker's own queues, FIFO
        over everyone else's."""
        with _STEAL_LOCK:
            if self._fail is not None:
                return None
            qs = self._qs
            nw = self._n_workers
            pick = -1
            stolen = False
            for qi in range(len(qs) - 1, -1, -1):  # LIFO-local
                q = qs[qi]
                if qi % nw == wid and not q.busy and q.next < len(q.tasks):
                    pick = qi
                    break
            if pick < 0:
                for qi in range(len(qs)):  # FIFO-steal
                    q = qs[qi]
                    if qi % nw != wid and not q.busy and (
                        q.next < len(q.tasks)
                    ):
                        pick = qi
                        stolen = True
                        break
            if pick < 0:
                return None
            q = qs[pick]
            q.busy = True
            task = q.tasks[q.next]
            q.next += 1
            return q, task, stolen

    def _complete(self, q: _Queue, stolen: bool, dur_ns: int) -> None:
        global _LIVE_DEPTH
        with _STEAL_LOCK:
            q.busy = False
            _LIVE_DEPTH -= 1
            if stolen:
                self.steals += 1
            else:
                self.local += 1
            self.task_ns.append(dur_ns)

    def _abort(self, q: _Queue, exc: BaseException) -> None:
        global _LIVE_DEPTH
        with _STEAL_LOCK:
            q.busy = False
            _LIVE_DEPTH -= 1  # the failed morsel; finish() reconciles
            if self._fail is None:
                self._fail = exc

    def runner(self, wid: int) -> None:
        from pathway_tpu_torch.engine import faults as _faults

        while True:
            got = self._claim(wid)
            if got is None:
                return
            q, task, stolen = got
            if _faults.fire(_STRAGGLER_POINT):
                import time as _time

                _time.sleep(_STRAGGLER_SLEEP_S)
            t0 = perf_counter_ns()
            try:
                task()
            except BaseException as e:  # noqa: BLE001 — wave re-raises
                self._abort(q, e)
                return
            self._complete(q, stolen, perf_counter_ns() - t0)

    def finish(self) -> None:
        """Post-barrier: publish metrics, re-raise the first failure
        (same semantics as the future-per-replica wave barrier)."""
        global _LAST_RUN, _LIVE_DEPTH
        if self._fail is not None:
            # runs after the barrier, so q.next is final: subtract the
            # tasks nobody will ever claim now
            with _STEAL_LOCK:
                _LIVE_DEPTH = max(
                    0,
                    _LIVE_DEPTH - sum(
                        len(q.tasks) - q.next for q in self._qs
                    ),
                )
        stats = {
            "queues": len(self._qs),
            "tasks": self._total,
            "steals": self.steals,
            "local": self.local,
        }
        _LAST_RUN = stats
        from pathway_tpu_torch.internals import observability as _obs

        plane = _obs.PLANE
        if plane is not None and (self.steals or self.local):
            m = plane.metrics
            m.counter(
                "pathway_morsel_exec_total", inc=self.steals + self.local,
                help="morsel tasks executed by the stealing crew",
            )
            m.counter(
                "pathway_steal_local_total", inc=self.local,
                help="morsels run by their home worker (LIFO-local)",
            )
            if self.steals:
                m.counter(
                    "pathway_steal_total", inc=self.steals,
                    help="morsels drained by a non-home worker (FIFO-steal)",
                )
            total = m.counter_value("pathway_morsel_exec_total")
            m.gauge(
                "pathway_steal_ratio",
                m.counter_value("pathway_steal_total") / total
                if total else 0.0,
                help="stolen share of all executed morsels (cumulative)",
            )
            for ns in self.task_ns:
                m.observe(
                    "pathway_morsel_task_seconds", ns / 1e9,
                    bounds=(1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0),
                    help="wall seconds per executed morsel task",
                )
        if self._fail is not None:
            raise self._fail


def run_stealing(
    queues: Sequence[Sequence[Callable[[], Any]]],
    n_workers: int | None = None,
) -> None:
    """Execute per-operator morsel queues to completion with work
    stealing; blocks until every morsel ran (the wave barrier) and
    re-raises the first task failure.

    The calling thread always participates as worker 0, so the wave
    makes progress even when the shared pool is saturated with scan
    decode — the extra runners are pure parallelism, never a liveness
    dependency."""
    queues = [q for q in queues if q]
    if not queues:
        return
    sched = StealScheduler(queues, n_workers or _crew_size(len(queues)))
    futures = []
    if sched._n_workers > 1:
        from pathway_tpu_torch.engine.workers import _pool

        pool = _pool()
        futures = [
            pool.submit(sched.runner, i)
            for i in range(1, sched._n_workers)
        ]
    sched.runner(0)
    for f in futures:
        f.result()
    sched.finish()


def _crew_size(n_queues: int) -> int:
    from pathway_tpu_torch.engine.workers import worker_threads

    return max(1, min(worker_threads(), n_queues))
