"""Lock-order analyzer: a runtime recorder that turns the ABBA deadlock
class into a CI-detectable property.

The engine's lock graph has produced two real deadlocks already fixed
reactively: the device-plane ``program()`` building ``jax.jit`` while
holding the plane lock against a gc finalizer re-entering
``drop_program`` (PR 7), and the ANN retrain path acquiring the gen lock
against the add path holding it the other way (PR 8). Both were
*order* bugs — thread 1 takes A then B, thread 2 takes B then A — which
a recorder can prove absent for everything a test run exercises.

Every known engine lock registers through :func:`register_lock` with a
stable role name. With ``PATHWAY_LOCK_CHECK`` unset the shim hands the
raw lock back — zero overhead, nothing recorded. With
``PATHWAY_LOCK_CHECK=1`` the lock is wrapped: each thread keeps the
stack of roles it currently holds, and every acquisition while holding
role H records the directed edge ``H -> acquired`` (with the first
observation's call site) into one process-wide edge set. A cycle in the
merged graph means two code paths disagree about the global order —
exactly the ABBA precondition — even if the interleaving that would
deadlock never fired in this run.

Checks run at process exit (an atexit hook armed on first registration:
any Python process with the recorder on fails loudly on a cycle) and on
demand via :func:`assert_acyclic` — the ``lock-order`` CI leg runs the
tier-1 suite plus the chaos-quick drill under the recorder
(scripts/test_both_planes.py, docs/static-analysis.md).

Role-name notes: per-instance locks of one role (admission buckets, mesh
send locks) share a name; reentrant acquisitions and same-role nesting
record no edge (the role *is* the ordering unit — instance-level cycles
within a role need the finer-grained analysis the registry names leave
room for).
"""

from __future__ import annotations

import os
import threading
import traceback

__all__ = [
    "register_lock",
    "enabled",
    "edges",
    "registry",
    "find_cycle",
    "assert_acyclic",
    "reset",
    "LockOrderError",
]


class LockOrderError(RuntimeError):
    """A cycle exists in the merged lock-acquisition-order graph."""


def enabled() -> bool:
    """PATHWAY_LOCK_CHECK=1 arms the recorder (read at lock-creation
    time; the wrapper itself never touches the environment)."""
    return os.environ.get("PATHWAY_LOCK_CHECK", "0") == "1"


# (held_role, acquired_role) -> call site of the first observation
_EDGES: dict[tuple[str, str], str] = {}
_EDGES_LOCK = threading.Lock()
# role -> number of locks registered under it (the instrumentation
# coverage surface; tests pin the known-role floor)
_REGISTRY: dict[str, int] = {}
_TLS = threading.local()
_ATEXIT_ARMED = False


def _held() -> list[tuple[str, int]]:
    """This thread's stack of held locks as (role, lock object id) —
    the id distinguishes a reentrant re-acquire (cannot block, no
    ordering constraint) from a SIBLING instance of a held role (can
    block, so cross-role edges still apply)."""
    h = getattr(_TLS, "held", None)
    if h is None:
        h = _TLS.held = []
    return h


def _note_edge(held: str, acquired: str) -> None:
    key = (held, acquired)
    if key in _EDGES:  # benign unlocked probe: first writer wins below
        return
    site = ""
    for fr in reversed(traceback.extract_stack(limit=8)[:-2]):
        if "analysis/lockgraph" not in fr.filename.replace("\\", "/"):
            site = f"{fr.filename}:{fr.lineno} in {fr.name}"
            break
    with _EDGES_LOCK:
        _EDGES.setdefault(key, site)


class _InstrumentedLock:
    """Order-recording shim over a threading Lock/RLock. API-compatible
    with both (context manager, acquire(blocking, timeout), release,
    locked when the inner lock has it)."""

    __slots__ = ("_lock", "name")

    def __init__(self, lock, name: str):
        self._lock = lock
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            held = _held()
            me = id(self)
            # two acquisitions impose NO order constraint: a
            # non-blocking acquire (fails instead of waiting — the ANN
            # inline-retrain trylock pattern is deadlock-free by
            # construction) and a reentrant re-acquire of a lock THIS
            # thread already owns. A sibling INSTANCE of a held role can
            # block, so its cross-role edges are still recorded —
            # role-to-same-role edges stay out (the role is the ordering
            # unit). Holding the lock always joins the stack: it
            # constrains every later blocking acquisition.
            if blocking and not any(lid == me for _n, lid in held):
                for h, _lid in held:
                    if h != self.name:
                        _note_edge(h, self.name)
            held.append((self.name, me))
        return ok

    def release(self) -> None:
        self._lock.release()
        held = _held()
        me = id(self)
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] == me:
                del held[i]
                break

    def locked(self) -> bool:
        inner = getattr(self._lock, "locked", None)
        return inner() if inner is not None else False

    def __enter__(self) -> "_InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # debugging aid
        return f"<lockgraph {self.name} over {self._lock!r}>"


def register_lock(name: str, lock=None, *, reentrant: bool = False):
    """Register an engine lock under a stable role `name`.

    Returns the lock to use in its place: the raw lock when the recorder
    is off (zero overhead — the shim only exists under
    PATHWAY_LOCK_CHECK=1), the recording wrapper otherwise. `lock=None`
    creates a fresh ``Lock`` (or ``RLock`` with ``reentrant=True``).
    """
    global _ATEXIT_ARMED
    if lock is None:
        lock = threading.RLock() if reentrant else threading.Lock()
    with _EDGES_LOCK:
        _REGISTRY[name] = _REGISTRY.get(name, 0) + 1
    if not enabled():
        return lock
    if not _ATEXIT_ARMED:
        _ATEXIT_ARMED = True
        import atexit

        atexit.register(_exit_check)
    return _InstrumentedLock(lock, name)


def _exit_check() -> None:
    """Process-exit gate: any recorded cycle fails the run loudly (the
    lock-order CI leg and the chaos drill's workload subprocesses both
    ride this — no per-harness wiring needed)."""
    cycle = find_cycle()
    if cycle is None:
        return
    import sys

    sys.stderr.write(_cycle_message(cycle) + "\n")
    sys.stderr.flush()
    os._exit(86)


# ------------------------------------------------------------- inspection


def edges() -> dict[tuple[str, str], str]:
    with _EDGES_LOCK:
        return dict(_EDGES)


def registry() -> dict[str, int]:
    with _EDGES_LOCK:
        return dict(_REGISTRY)


def reset() -> None:
    """Drop recorded edges (tests); registered locks stay instrumented."""
    with _EDGES_LOCK:
        _EDGES.clear()


def find_cycle() -> list[str] | None:
    """A cycle in the merged order graph as a role path
    ``[a, b, ..., a]``, or None. stdlib graphlib does the traversal;
    sorted insertion keeps the reported cycle deterministic."""
    import graphlib

    preds: dict[str, set[str]] = {}
    for (src, dst) in sorted(edges()):
        preds.setdefault(dst, set()).add(src)
        preds.setdefault(src, set())
    try:
        graphlib.TopologicalSorter(preds).prepare()
    except graphlib.CycleError as e:
        # args[1]: [a, b, ..., a] with each node an immediate
        # predecessor of the next — exactly our edge direction
        return list(e.args[1])
    return None


def _cycle_message(cycle: list[str]) -> str:
    e = edges()
    lines = [
        "lockgraph: lock-acquisition-order CYCLE (ABBA deadlock "
        "precondition): " + " -> ".join(cycle)
    ]
    for src, dst in zip(cycle, cycle[1:]):
        lines.append(f"  {src} -> {dst}  first seen at {e.get((src, dst), '?')}")
    return "\n".join(lines)


def assert_acyclic() -> None:
    """Raise :class:`LockOrderError` (with the cycle and the first-seen
    call sites) if the merged acquisition-order graph has a cycle."""
    cycle = find_cycle()
    if cycle is not None:
        raise LockOrderError(_cycle_message(cycle))
