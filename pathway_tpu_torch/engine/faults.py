"""Deterministic fault-injection plane.

The recovery contract (persistence/__init__.py: metadata → operator
snapshots → journal tail) and the failure handling around it (connector
retries, mesh death detection, device-plane degradation) are only worth
anything if failures can be *produced on demand, reproducibly*. This
module makes failures a first-class, seed-deterministic input:

* every failure domain exposes **named injection points** — dotted
  identifiers like ``persistence.metadata.torn`` or
  ``device.dispatch.embed`` — by calling :func:`fire` / :func:`check` /
  :func:`crash` at the site where the real failure would bite;
* a :class:`FaultSchedule` (seed + ``PATHWAY_FAULTS=`` spec) decides,
  reproducibly, which point fires on which *hit* (the Nth time execution
  reaches it) — hit counts, not wall clocks, so a schedule replays
  identically across runs and machines;
* ``PATHWAY_FAULTS=0`` (or unset) is the no-op default: every probe is a
  single ``is None`` test on a module global, so the hot path pays
  effectively nothing.

Spec grammar (documented in docs/robustness.md)::

    PATHWAY_FAULTS := "0" | "" | clause (";" clause)*
    clause        := "seed=" INT
                   | point "@" hits        # fire on specific hits
                   | point "~" FLOAT       # per-hit probability
    hits          := INT ("," INT)*        # 1-based hit numbers
                   | INT "+"               # every hit from the Nth on
                   | INT "+" INT           # Nth then every Kth after
    point         := dotted name, fnmatch globs allowed ("io.*")

Examples::

    PATHWAY_FAULTS="runtime.wave.crash@7"          # crash on wave 7
    PATHWAY_FAULTS="seed=3;io.retry.src~0.2"       # 20% flaky reads
    PATHWAY_FAULTS="persistence.metadata.torn@2"   # tear the 2nd commit
    PATHWAY_FAULTS="device.dispatch.*@1+"          # every dispatch fails
    PATHWAY_FAULTS="sink.outbox.post_seal@3"       # die between the epoch
                                                   # seal and the sink flush
    PATHWAY_FAULTS="sink.flush.torn@5"             # die mid-flush, part of
                                                   # a sealed range delivered
    PATHWAY_FAULTS="mesh.member.join@1"            # fail a join announcement
                                                   # (mesh.member.leave too)
    PATHWAY_FAULTS="swap.mid_commit@1"             # die inside a blue/green
                                                   # swap's rename commit
    PATHWAY_FAULTS="swap.replay.divergent@1"       # force the green replay
                                                   # to mismatch -> abort

The sink-side windows (``sink.outbox.pre_seal``, ``sink.outbox.post_seal``,
``sink.flush.torn`` — probed in persistence/__init__.py and io/outbox.py)
exercise the transactional-sink protocol: staged-but-unsealed output must
be discarded and regenerated, sealed-but-unacked output must replay from
the outbox WAL, and a torn flush must be absorbed by idempotent delivery
(atomic fs segments / content-keyed dedup).

Probabilistic decisions are a pure function of ``(seed, pattern, point,
hit)``, so each point's fault sequence is fixed by the schedule alone —
independent of thread interleaving and of which other points a glob
clause happens to match — and two runs with the same spec see the same
faults on the same hits.  The catalog of live injection points is in docs/robustness.md;
:func:`fired_log` records every shot for drill assertions.
"""

from __future__ import annotations

import fnmatch
import os
import random
import threading
from pathway_tpu_torch.analysis import lockgraph as _lockgraph

__all__ = [
    "FaultInjected",
    "FaultSchedule",
    "active",
    "check",
    "crash",
    "fire",
    "fired_log",
    "hard_crash",
    "install",
    "reset",
    "CRASH_EXIT_CODE",
]

# the drill's recognizable "injected hard crash" exit status (mirrors the
# persistence recovery tests' os._exit(17) convention)
CRASH_EXIT_CODE = 17


class FaultInjected(ConnectionError):
    """Raised by :func:`check` at a fired injection point.

    Subclasses :class:`ConnectionError` (itself an ``OSError``) on
    purpose: IO retry paths treat injected faults exactly like the real
    transient failures they stand in for — no special-casing anywhere.
    """

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected fault at {point} (hit {hit})")
        self.point = point
        self.hit = hit


class _Clause:
    """One parsed spec clause: a point pattern + a firing rule."""

    __slots__ = ("pattern", "hits", "every", "prob", "seed")

    def __init__(
        self,
        pattern: str,
        hits: frozenset[int] | None = None,
        every: tuple[int, int] | None = None,  # (first, step)
        prob: float | None = None,
        seed: int = 0,
    ):
        self.pattern = pattern
        self.hits = hits
        self.every = every
        self.prob = prob
        self.seed = seed

    def decide(self, point: str, hit: int) -> bool:
        if self.prob is not None:
            # a pure function of (seed, pattern, point, hit): when a glob
            # matches several points probed concurrently, each point's
            # decision sequence is still independent of probe
            # interleaving — a shared draw stream would not be
            rng = random.Random(f"{self.seed}:{self.pattern}:{point}:{hit}")
            return rng.random() < self.prob
        if self.every is not None:
            first, step = self.every
            return hit >= first and (hit - first) % step == 0
        assert self.hits is not None
        return hit in self.hits


def _parse_clause(text: str, seed: int) -> _Clause:
    if "~" in text:
        pattern, _, p = text.partition("~")
        prob = float(p)
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"fault probability out of range: {text!r}")
        return _Clause(pattern.strip(), prob=prob, seed=seed)
    if "@" in text:
        pattern, _, spec = text.partition("@")
        spec = spec.strip()
        if "+" in spec:
            first_s, _, step_s = spec.partition("+")
            first = int(first_s)
            step = int(step_s) if step_s else 1
            if first < 1 or step < 1:
                raise ValueError(f"bad fault hit spec: {text!r}")
            return _Clause(pattern.strip(), every=(first, step))
        hits = frozenset(int(h) for h in spec.split(",") if h)
        if not hits or min(hits) < 1:
            raise ValueError(f"bad fault hit spec: {text!r}")
        return _Clause(pattern.strip(), hits=hits)
    raise ValueError(
        f"unparsable PATHWAY_FAULTS clause {text!r} "
        "(expected point@hits, point~prob, or seed=N)"
    )


class FaultSchedule:
    """Seed-deterministic decision table: injection point -> fire?.

    ``decide(point)`` increments the point's hit counter and returns
    whether any matching clause fires on that hit. Thread-safe: points
    are probed from connector threads, the dispatch pool, and the pump
    concurrently.
    """

    def __init__(self, spec: str):
        self.spec = spec
        self.seed = 0
        clauses: list[tuple[str, str]] = []
        for raw in spec.replace(",", ";").split(";"):
            # commas also separate clauses EXCEPT inside an @h1,h2 list;
            # re-join number-only fragments onto the previous clause
            raw = raw.strip()
            if not raw:
                continue
            if raw.isdigit() and clauses and "@" in clauses[-1][1]:
                clauses[-1] = (clauses[-1][0], clauses[-1][1] + "," + raw)
                continue
            if raw.startswith("seed="):
                self.seed = int(raw[5:])
                continue
            clauses.append(("c", raw))
        self.clauses = [_parse_clause(c, self.seed) for (_k, c) in clauses]
        self._hits: dict[str, int] = {}
        self._fired: list[tuple[str, int]] = []
        self._lock = _lockgraph.register_lock(
            "faults.schedule", threading.Lock()
        )

    def decide(self, point: str) -> bool:
        return self.decide_hit(point)[0]

    def decide_hit(self, point: str) -> tuple[bool, int]:
        """(fired, hit) under one lock hold — callers that record the
        shot must use THIS hit number, not a later hit_count() read
        (concurrent probes of the same point would skew it)."""
        with self._lock:
            hit = self._hits.get(point, 0) + 1
            self._hits[point] = hit
            fired = any(
                c.decide(point, hit)
                for c in self.clauses
                if fnmatch.fnmatchcase(point, c.pattern)
            )
            if fired:
                self._fired.append((point, hit))
            return fired, hit

    @property
    def fired(self) -> list[tuple[str, int]]:
        with self._lock:
            return list(self._fired)

    def hit_count(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)


# ---------------------------------------------------------------- plumbing
#
# The module global IS the fast path: `_SCHEDULE is None` is the entire
# cost of a probe when faults are off. Parsed lazily from the env on
# first probe so `PATHWAY_FAULTS` set by a test/drill before pw.run() is
# honored without import-order games.

_SCHEDULE: FaultSchedule | None = None
_RESOLVED = False
_INSTALL_LOCK = _lockgraph.register_lock(
    "faults.install", threading.Lock()
)


def _resolve() -> FaultSchedule | None:
    global _SCHEDULE, _RESOLVED
    with _INSTALL_LOCK:
        if not _RESOLVED:
            spec = os.environ.get("PATHWAY_FAULTS", "0").strip()
            _SCHEDULE = FaultSchedule(spec) if spec not in ("", "0") else None
            _RESOLVED = True
    return _SCHEDULE


def install(schedule: FaultSchedule | str | None) -> FaultSchedule | None:
    """Install a schedule programmatically (tests/drills). Accepts a
    spec string, a FaultSchedule, or None (disable)."""
    global _SCHEDULE, _RESOLVED
    with _INSTALL_LOCK:
        if isinstance(schedule, str):
            schedule = (
                FaultSchedule(schedule) if schedule not in ("", "0") else None
            )
        _SCHEDULE = schedule
        _RESOLVED = True
    return _SCHEDULE


def reset() -> None:
    """Forget any installed schedule; the next probe re-reads the env."""
    global _SCHEDULE, _RESOLVED
    with _INSTALL_LOCK:
        _SCHEDULE = None
        _RESOLVED = False


def active() -> bool:
    s = _SCHEDULE if _RESOLVED else _resolve()
    return s is not None


def _note_shot(point: str, hit: int, action: str) -> None:
    """Feed the fired shot into the observability flight recorder (one
    event per SHOT, never per probe — probes that don't fire cost only
    the schedule lookup). The drill asserts every entry of `fired_log`
    has a matching recorder event (scripts/chaos_drill.py)."""
    from pathway_tpu_torch.internals import observability as obs

    if obs.PLANE is not None:
        obs.PLANE.record("fault", point=point, hit=hit, action=action)
        obs.PLANE.metrics.counter(
            "pathway_faults_fired_total", {"point": point},
            help="injected fault shots by point",
        )


def fire(point: str) -> bool:
    """Probe an injection point: True when the schedule says this hit
    fails. The caller performs the domain-appropriate damage (tear a
    file, skip a write, quarantine an entry)."""
    s = _SCHEDULE if _RESOLVED else _resolve()
    if s is None:
        return False
    fired, hit = s.decide_hit(point)
    if fired:
        _note_shot(point, hit, "fire")
    return fired


def check(point: str) -> None:
    """Raise :class:`FaultInjected` when the point fires — the generic
    action for call sites whose real failure mode is an exception."""
    s = _SCHEDULE if _RESOLVED else _resolve()
    if s is None:
        return
    fired, hit = s.decide_hit(point)
    if fired:
        _note_shot(point, hit, "check")
        raise FaultInjected(point, hit)


def crash(point: str) -> None:
    """Hard-crash the process (``os._exit``) when the point fires — no
    cleanup, no atexit, exactly like a kill -9 mid-wave."""
    s = _SCHEDULE if _RESOLVED else _resolve()
    if s is None:
        return
    fired, hit = s.decide_hit(point)
    if fired:
        _note_shot(point, hit, "crash")
        hard_crash()


def hard_crash() -> None:
    # black-box before the box disappears: the flight recorder's dump is
    # the only record a kill -9-style exit leaves behind
    try:
        from pathway_tpu_torch.internals import observability as obs

        obs.dump_flight("crash")
    except Exception:  # noqa: BLE001 — nothing may delay the crash path
        pass
    os._exit(CRASH_EXIT_CODE)


def fired_log() -> list[tuple[str, int]]:
    """(point, hit) shots fired so far — drills assert the schedule
    actually exercised what it claimed to."""
    s = _SCHEDULE if _RESOLVED else _resolve()
    return s.fired if s is not None else []
