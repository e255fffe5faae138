"""Engine core: z-set collections, operator nodes, arrangements.

Reference parity: the ~60-op `Graph` trait (src/engine/graph.rs:664-1005)
implemented over differential collections (src/engine/dataflow.rs). Here
each op is a `Node` in a DAG; a `Graph` owns the nodes; the `Runtime`
(engine/runtime.py) pumps timestamps through in topological order.

Data model: an engine table is a keyed z-set — entries `(key, row, diff)`
where `key` is a 128-bit pointer, `row` a tuple of values, `diff` a signed
multiplicity. A healthy table has exactly one row per key (diff sum == 1);
the general multiset form appears inside arrangements keyed by derived
(join/group) keys.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from pathway_tpu_torch.internals import observability as _obs
from pathway_tpu_torch.internals.errors import ERROR, ErrorValue, global_error_log
from pathway_tpu_torch.internals.keys import (
    Key,
    _hash_bytes as _hash_bytes_128,
    hash_values,
    key_for_values,
)

Entry = tuple[Key, tuple, int]  # (key, row, diff)


def _native_batch_type():
    """The token-resident batch type, or None when the plane is off.
    Imported lazily: core must load when no compiler is available."""
    try:
        from pathway_tpu_torch.engine.native import dataplane

        if dataplane.available():
            return dataplane.NativeBatch
    except Exception:  # noqa: BLE001
        pass
    return None


NativeBatch: Any = None  # resolved on first use via _nb_type()
_NB_RESOLVED = False


def _nb_type():
    global NativeBatch, _NB_RESOLVED
    if not _NB_RESOLVED:
        NativeBatch = _native_batch_type()
        _NB_RESOLVED = True
    return NativeBatch


def iterate_native_on() -> bool:
    """Token-resident iterate scope gate: the data plane is up AND the
    PATHWAY_ITERATE_NATIVE kill switch (bit-identical A/B vs the object
    plumbing; docs/iterate.md) is not set to 0."""
    import os

    return (
        _nb_type() is not None
        and os.environ.get("PATHWAY_ITERATE_NATIVE", "1") != "0"
    )


# ------------------------------------------------------------------ hashing


def freeze_value(v: Any) -> Any:
    """Make a value usable as part of a dict key (multiset token).

    Fast path: anything already hashable IS its own frozen form (freezing
    only rewrites unhashable values — ndarrays, dicts, lists — and tuples
    containing them are themselves unhashable), so one hash() probe
    replaces the recursive walk for the common all-scalar rows.
    """
    if isinstance(v, np.ndarray):
        return ("\x00ndarray", str(v.dtype), v.shape, v.tobytes())
    try:
        hash(v)
        return v
    except TypeError:
        pass
    if isinstance(v, tuple):
        return tuple(freeze_value(x) for x in v)
    if isinstance(v, dict):
        from pathway_tpu_torch.internals.json import Json

        return ("\x00json", Json.dumps(v))
    if isinstance(v, list):
        return tuple(freeze_value(x) for x in v)
    return ("\x00repr", repr(v))


def freeze_row(row: tuple) -> tuple:
    try:
        hash(row)
        return row
    except TypeError:
        return tuple(freeze_value(v) for v in row)


def consolidate(entries: Iterable[Entry]) -> list[Entry]:
    """Sum diffs of identical (key, row) pairs; drop zeros.

    Fast path: a batch whose keys are all distinct with diff=1 (the shape
    every static ingest and reindex produces) is already consolidated —
    detecting that needs only integer set inserts, not row freezing.
    """
    if not isinstance(entries, list):
        entries = list(entries)
    seen: set[int] = set()
    for key, _row, diff in entries:
        if diff != 1 or key.value in seen:
            break
        seen.add(key.value)
    else:
        return entries
    acc: dict[tuple, tuple[Key, tuple, int]] = {}
    for key, row, diff in entries:
        token = (key.value, freeze_row(row))
        if token in acc:
            k, r, d = acc[token]
            acc[token] = (k, r, d + diff)
        else:
            acc[token] = (key, row, diff)
    return [(k, r, d) for (k, r, d) in acc.values() if d != 0]


def rows_equal(a: tuple, b: tuple) -> bool:
    """Row equality without the double `freeze_row` round-trip.

    Plain tuple comparison covers the hashable common case. Rows holding
    ndarrays always go through the frozen comparison: tuple.__eq__ on a
    size-1 array truth-tests the elementwise result, which would treat
    dtype/shape changes preserving the value as equal (the frozen form
    compares dtype + shape + bytes).
    """
    for v in a:
        if isinstance(v, np.ndarray):
            return freeze_row(a) == freeze_row(b)
    try:
        return bool(a == b)
    except (ValueError, TypeError):
        return freeze_row(a) == freeze_row(b)


def delta_emit(
    emitted: dict[Key, tuple], out: list[Entry], key: Key, new: tuple | None
) -> None:
    """Retract-old / emit-new bookkeeping shared by every keyed node:
    compares the previously emitted row for `key` against `new` (None =
    key gone) and appends the retraction/insertion entries to `out`."""
    old = emitted.get(key)
    if old is not None and (new is None or not rows_equal(old, new)):
        out.append((key, old, -1))
        del emitted[key]
    if new is not None and (old is None or not rows_equal(old, new)):
        out.append((key, new, 1))
        emitted[key] = new


class KeyedState:
    """Arrangement of a healthy keyed table: key -> row."""

    __slots__ = ("rows",)

    def __init__(self) -> None:
        self.rows: dict[Key, tuple] = {}

    def update(self, entries: Iterable[Entry]) -> None:
        for key, row, diff in entries:
            if diff > 0:
                self.rows[key] = row
            elif diff < 0:
                existing = self.rows.get(key)
                if existing is not None and rows_equal(existing, row):
                    del self.rows[key]

    def get(self, key: Key) -> tuple | None:
        return self.rows.get(key)

    def items(self):
        return self.rows.items()

    def __len__(self) -> int:
        return len(self.rows)

    def as_entries(self) -> list[Entry]:
        return [(k, r, 1) for k, r in self.rows.items()]


class MultisetState:
    """Arrangement by a derived key: dkey -> {token: (payload, count)}.

    Out-of-core tier (engine/spill.py): a node that spills attaches a
    miss hook (`_resolve`) that promotes an absent group back from the
    LSM run tier before any read or write touches it — residency is
    exclusive, so a group lives either in `groups` (the tail) or in one
    run's live set, never both. `_rec` tracks touch recency for the
    owner's coldest-first eviction; both stay None (zero overhead, and
    byte-identical codec snapshots) until a store attaches."""

    __slots__ = ("groups", "_resolve", "_rec", "_seq", "_spill_store")

    def __init__(self) -> None:
        self.groups: dict[Any, dict[Any, tuple[Any, int]]] = {}
        self._resolve: Callable[[Any], None] | None = None
        self._rec: dict[Any, int] | None = None
        self._seq = 0
        self._spill_store: Any = None

    def update_one(self, dkey: Any, payload: Any, diff: int) -> None:
        group = self.groups.get(dkey)
        if group is None:
            if self._resolve is not None:
                self._resolve(dkey)
                group = self.groups.get(dkey)
            if group is None:
                group = self.groups[dkey] = {}
        if self._rec is not None:
            self._seq += 1
            self._rec[dkey] = self._seq
        token = freeze_value(payload)
        cur = group.get(token)
        new_count = (cur[1] if cur else 0) + diff
        if new_count == 0:
            group.pop(token, None)
            if not group:
                del self.groups[dkey]
                if self._rec is not None:
                    self._rec.pop(dkey, None)
        else:
            group[token] = (payload, new_count)

    def get(self, dkey: Any) -> list[tuple[Any, int]]:
        group = self.groups.get(dkey)
        if group is None and self._resolve is not None:
            self._resolve(dkey)
            group = self.groups.get(dkey)
        if self._rec is not None and group is not None:
            self._seq += 1
            self._rec[dkey] = self._seq
        if not group:
            return []
        return list(group.values())

    def group_keys(self):
        return self.groups.keys()

    def __contains__(self, dkey: Any) -> bool:
        if dkey in self.groups:
            return True
        if self._resolve is not None:
            self._resolve(dkey)
            return dkey in self.groups
        return False

    def spill_attach(self, store: Any, resolve: Callable[[Any], None]) -> None:
        self._spill_store = store
        self._resolve = resolve
        if self._rec is None:
            # backfill recency from insertion order: oldest-inserted
            # groups are the first eviction candidates
            self._rec = {k: i for i, k in enumerate(self.groups)}
            self._seq = len(self._rec)


# ------------------------------------------------- shard-rescale protocol
#
# Operator snapshots are taken per worker shard. The reference pins a
# snapshot to its worker count (changing `-w` forces a cold start); here
# a snapshot taken at PATHWAY_THREADS=N restores at THREADS=M by merging
# the N shard states and re-partitioning along the operator's shard key
# — the same `_shard_of` routing the exchange uses, so the restored
# layout is byte-identical to what a fresh M-shard run would hold.
#
# `_state_routing` maps each persisted attr to how its entries route:
#   "key"    — dict keyed by Key (or KeyedState): token = key.value
#   "keytup" — dict keyed by (key.value, ...) tuples: token = entry[0]
#   "token"  — dict (or MultisetState) keyed by the shard token itself
# A list-valued attr (side tables) applies its rule element-wise. Nodes
# whose state cannot be expressed this way override merge_shard_states /
# split_shard_state; nodes that declare nothing refuse (the checkpoint
# manager falls back to journal replay).


class RescaleUnsupported(RuntimeError):
    """This operator cannot re-partition its snapshot across a different
    worker count; resume falls back to full journal replay."""


def _spill_blocks_rescale(state: Any) -> bool:
    """A spilled arrangement's authoritative state spans tail + on-disk
    runs; merging/splitting only the tail would silently lose the run
    tier, so rescale refuses (journal-replay fallback) while runs exist."""
    store = getattr(state, "_spill_store", None)
    return store is not None and store.has_runs


def _merge_pair(a: Any, b: Any) -> Any:
    """Union two per-shard state containers (disjoint by construction:
    every shard key lives on exactly one shard)."""
    if isinstance(a, KeyedState):
        a.rows.update(b.rows)
        return a
    if isinstance(a, MultisetState):
        if _spill_blocks_rescale(a) or _spill_blocks_rescale(b):
            raise RescaleUnsupported(
                "spilled arrangement (on-disk runs) cannot merge across "
                "worker shards; resume falls back to journal replay"
            )
        a.groups.update(b.groups)
        return a
    if isinstance(a, dict):
        a.update(b)
        return a
    if isinstance(a, list):
        return [_merge_pair(x, y) for x, y in zip(a, b)]
    raise RescaleUnsupported(f"cannot merge state of type {type(a).__name__}")


def _split_container(value: Any, rule: str, n: int, shard_of) -> list[Any]:
    """Partition one state container into n shard-local containers."""
    if isinstance(value, list):
        parts_per_elem = [_split_container(v, rule, n, shard_of) for v in value]
        return [[pe[s] for pe in parts_per_elem] for s in range(n)]
    if isinstance(value, KeyedState):
        outs = [KeyedState() for _ in range(n)]
        for key, row in value.rows.items():
            outs[shard_of(key.value)].rows[key] = row
        return outs
    if isinstance(value, MultisetState):
        if _spill_blocks_rescale(value):
            raise RescaleUnsupported(
                "spilled arrangement (on-disk runs) cannot re-partition "
                "across worker shards; resume falls back to journal replay"
            )
        outs = [MultisetState() for _ in range(n)]
        for dkey, group in value.groups.items():
            outs[shard_of(dkey)].groups[dkey] = group
        return outs
    if isinstance(value, dict):
        if isinstance(value, defaultdict) and value.default_factory is not None:
            factory = value.default_factory
            fresh: Callable[[], dict] = lambda: defaultdict(factory)  # noqa: E731
        else:
            fresh = dict
        outs = [fresh() for _ in range(n)]
        for k, v in value.items():
            if rule == "key":
                tok = k.value
            elif rule == "keytup":
                tok = k[0]
            else:  # "token"
                tok = k
            outs[shard_of(tok)][k] = v
        return outs
    raise RescaleUnsupported(f"cannot split state of type {type(value).__name__}")


def _spill_evict_multiset(state: MultisetState, store: Any, pack) -> int:
    """Seal the coldest groups of a MultisetState into one spill run,
    down to the store's low-water mark. `pack(dkey, group)` returns the
    group's self-contained payload bytes (the owner adds its per-group
    side state — emitted rows, group keys — so promotion restores the
    node exactly)."""
    from pathway_tpu_torch.persistence import codec as _codec

    if len(state.groups) <= store.budget:
        return 0
    target = int(store.budget * 0.75)
    n_evict = len(state.groups) - target
    rec = state._rec if state._rec is not None else {}
    victims = sorted(state.groups, key=lambda k: rec.get(k, 0))[:n_evict]
    items = []
    for dkey in victims:
        group = state.groups.pop(dkey)
        try:
            # pack() must defer owner-side mutation until its encode
            # succeeded: a group whose payload the codec cannot express
            # (exotic reducer values) simply stays resident
            items.append((_codec.encode_value(dkey), pack(dkey, group)))
        except Exception:  # noqa: BLE001
            state.groups[dkey] = group
            continue
        rec.pop(dkey, None)
    if not items:
        return 0
    return store.seal(items)


def _spill_check_strict(store: Any, owner: str) -> None:
    """Deep exclusive-residency proof at restore (reads every run), so
    it only runs under PATHWAY_VERIFY=strict; the cheap manifest checks
    always run inside spill.attach_store."""
    from pathway_tpu_torch.engine import spill as _spill
    from pathway_tpu_torch.internals import verifier as _verifier

    if _verifier.mode() == "strict":
        _spill.check_two_tier(store, owner)


# ------------------------------------------------------------------- nodes


class Node:
    """A dataflow operator. Inputs buffer entries; `finish_time` consumes
    them when the wave for a timestamp reaches this node."""

    def __init__(self, graph: "Graph", inputs: Sequence["Node"] = ()):
        self.graph = graph
        self.inputs = list(inputs)
        self.downstream: list[tuple[Node, int]] = []
        self.buffers: list[list[Entry]] = [[] for _ in inputs]
        # per-input count of buffered NativeBatch segments: inputs without
        # segments keep the zero-copy take_input fast path
        self._nseg: list[int] = [0] * len(self.inputs)
        self.node_id = graph.register(self)
        for i, inp in enumerate(self.inputs):
            inp.downstream.append((self, i))
        # observability (reference: OperatorStats graph.rs:520 + the
        # per-operator probes of graph.rs:988-995)
        self.rows_in = 0
        self.rows_out = 0
        self.time_ns = 0  # cumulative finish_time latency
        # user-frame trace (set by lowering from the op spec) — enriches
        # runtime error messages with the pipeline call site
        self.trace: str | None = None
        # plan-node label (the op-spec kind, set by lowering): what makes
        # two GroupByNodes distinguishable in the TUI, logs and metrics
        self.label: str | None = None

    # Wave-cone membership (engine/cone.py): a cone HEAD keeps `_cone`
    # set and fires the whole cone at its topo slot; absorbed interior
    # members are skipped by Graph.step but stay live — fallback waves,
    # persistence and Graph.end still drive them directly. Class-level
    # defaults keep the common case attribute-read-only.
    _cone = None
    _cone_absorbed = False

    def describe(self) -> str:
        """Human identity for monitors/metrics: type, plan label, call
        site when known, and the node id."""
        base = type(self).__name__
        if self.label:
            base += f"[{self.label}]"
        if self.trace:
            base += f"@{self.trace}"
        return f"{base}#{self.node_id}"

    def log_error(self, message: str) -> None:
        if self.trace:
            message = f"{message} (at {self.trace})"
        self.graph.log_error(message)

    def accept(self, input_idx: int, entries) -> None:
        """entries: list[Entry], or a token-resident NativeBatch segment
        (appended whole; materialized lazily at take_input unless the node
        consumes segments natively via take_segments)."""
        if type(entries) is list:
            self.buffers[input_idx].extend(entries)
        else:
            self.buffers[input_idx].append(entries)
            self._nseg[input_idx] += 1

    def emit(self, time: int, entries) -> None:
        if entries is None or len(entries) == 0:
            return
        self.rows_out += len(entries)
        for node, idx in self.downstream:
            node.accept(idx, entries)

    def take_input(self, idx: int = 0) -> list[Entry]:
        entries = self.buffers[idx]
        self.buffers[idx] = []
        if self._nseg[idx]:
            self._nseg[idx] = 0
            flat: list[Entry] = []
            for seg in entries:
                if type(seg) is tuple:
                    flat.append(seg)
                else:
                    flat.extend(seg.materialize())
            entries = flat
        self.rows_in += len(entries)
        return entries

    def take_segments(self, idx: int = 0) -> tuple[list, list[Entry]]:
        """Segment-aware drain for native-capable nodes: returns
        (native_batches, python_entries) in arrival order within each
        kind. rows_in accounting included."""
        buf = self.buffers[idx]
        self.buffers[idx] = []
        self._nseg[idx] = 0
        batches: list = []
        entries: list[Entry] = []
        for seg in buf:
            if type(seg) is tuple:
                entries.append(seg)
            else:
                batches.append(seg)
        self.rows_in += len(entries) + sum(len(b) for b in batches)
        return batches, entries

    def finish_time(self, time: int) -> None:
        raise NotImplementedError

    def on_end(self, time: int) -> None:
        """Called once when the stream is complete (frontier -> +inf)."""

    # ------------------------------------------------- operator snapshots
    #
    # Reference parity: operator persistence
    # (reference/src/persistence/operator_snapshot.rs) — each
    # stateful operator can dump/restore its full state so resume does
    # not replay the whole input journal. `_persist_attrs` names the
    # attributes that constitute the operator's state; a node with no
    # state declares none and returns None (nothing to persist).

    _persist_attrs: tuple[str, ...] = ()

    def persist_signature(self) -> str:
        """Structural identity of this operator for snapshot validity.
        Subclasses add semantic parameters (reducer set, join mode, …) so
        a changed pipeline refuses stale state. Caveat (shared with the
        reference): Python function bodies (UDFs, predicates) are not
        hashable into the signature — changing only a UDF body while
        keeping structure reuses the old state."""
        return f"{type(self).__name__}/{len(self.inputs)}"

    def persist_state(self) -> dict | None:
        if not self._persist_attrs:
            return None
        return {
            a: getattr(self, a) for a in self._persist_attrs if hasattr(self, a)
        }

    def restore_state(self, state: dict) -> None:
        for a, v in state.items():
            setattr(self, a, v)

    # See the shard-rescale protocol above: declares, per persisted attr,
    # how snapshot entries route across worker shards. None = this node
    # type refuses rescale (journal-replay fallback). The methods take
    # `self` so nodes with run-local state (native join/groupby intern
    # tokens) can consult their plan; they are called on a template
    # replica, never mutate it.
    _state_routing: dict[str, str] | None = None

    def merge_shard_states(self, states: list[dict]) -> dict:
        """Union per-shard snapshots into one logical state (shard keys
        are disjoint across shards by construction)."""
        if not states:
            return {}
        merged = dict(states[0])
        for st in states[1:]:
            for attr, v in st.items():
                if attr in merged:
                    merged[attr] = _merge_pair(merged[attr], v)
                else:
                    merged[attr] = v
        return merged

    def split_shard_state(self, merged: dict, n: int, shard_of) -> list[dict]:
        """Partition a merged snapshot into n shard-local snapshots using
        the same routing the exchange applies to live rows."""
        routing = self._state_routing
        if routing is None:
            raise RescaleUnsupported(
                f"{type(self).__name__} does not support worker-count rescale"
            )
        outs: list[dict] = [{} for _ in range(n)]
        for attr, value in merged.items():
            rule = routing.get(attr)
            if rule is None:
                raise RescaleUnsupported(
                    f"{type(self).__name__}.{attr} has no shard routing"
                )
            for s, part in enumerate(_split_container(value, rule, n, shard_of)):
                outs[s][attr] = part
        return outs


# dispatch-count buckets: wave dispatches are small integers (operator
# counts), not latencies — the default latency buckets would flatten them
_WAVE_DISPATCH_BOUNDS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)
_MORSEL_SEG_BOUNDS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


class Graph:
    """Owns nodes in topological (creation) order."""

    def __init__(self) -> None:
        self.nodes: list[Node] = []
        self.error_log = global_error_log()
        self.terminate_on_error = False
        # the FrontierScheduler driving this graph, when one is attached
        # (engine/frontier.py); operators may consult it for their input
        # frontier (e.g. the iterate scope). None under the static pump.
        self.scheduler = None
        # installed wave cones (engine/cone.py) + the host-dispatch
        # meter behind the O(1)-dispatches-per-wave claim: a cone fire
        # is ONE dispatch where the per-node plan pays one per member
        self._cones: list = []
        self.wave_count = 0
        self.dispatch_count = 0

    def register(self, node: Node) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    def log_error(self, message: str) -> None:
        if self.terminate_on_error:
            raise RuntimeError(message)
        self.error_log.log(message)

    def step(self, time: int) -> None:
        from time import perf_counter_ns

        plane = _obs.PLANE
        dispatches = 0
        for node in self.nodes:
            if node._cone_absorbed:
                continue  # the head's cone fire covers this member
            cone = node._cone
            t0 = perf_counter_ns()
            if cone is not None:
                dispatches += cone.fire(time)
            else:
                node.finish_time(time)
                dispatches += 1
            elapsed = perf_counter_ns() - t0
            node.time_ns += elapsed
            if plane is not None:
                plane.wave(node, time, elapsed)
        self.wave_count += 1
        self.dispatch_count += dispatches
        if plane is not None:
            plane.metrics.observe(
                "pathway_wave_dispatches",
                float(dispatches),
                bounds=_WAVE_DISPATCH_BOUNDS,
                help="host dispatches per wave (cone fire = 1)",
            )

    def end(self, time: int) -> None:
        # per node: drain buffered input FIRST, then end-of-stream hooks —
        # a sink must write the final wave (e.g. an upstream buffer's
        # flush, delivered via topo order) before its on_end closes the
        # file. Upstream on_end emissions still precede every downstream
        # node's finish_time because nodes run in topological order.
        # Cone heads drain through their cone first so late segments keep
        # cone semantics; the members' own finish_time/on_end still run
        # (no-ops once drained) — absorbed nodes are NOT skipped here.
        plane = _obs.PLANE
        if plane is None:
            for node in self.nodes:
                if node._cone is not None:
                    node._cone.fire(time)
                node.finish_time(time)
                node.on_end(time)
            return
        from time import perf_counter_ns

        for node in self.nodes:
            t0 = perf_counter_ns()
            if node._cone is not None:
                node._cone.fire(time)
            node.finish_time(time)
            node.on_end(time)
            # record the end-flush span for the profiler/histograms but
            # do NOT fold it into time_ns: the seconds-total stat must
            # read the same whether instrumentation is on or off
            plane.wave(node, time, perf_counter_ns() - t0)


class InputNode(Node):
    """Entry point: the runtime / connector sessions push batches here.
    Accepts plain entry lists and token-resident NativeBatch segments
    (mixed freely; native waves stay native end to end)."""

    def __init__(self, graph: Graph):
        super().__init__(graph, ())
        self.pending: list = []  # Entry tuples and/or NativeBatch segments

    def push(self, entries) -> None:
        if type(entries) is list:
            self.pending.extend(entries)
        else:
            self.pending.append(entries)

    def finish_time(self, time: int) -> None:
        if not self.pending:
            return
        out, self.pending = self.pending, []
        nb_t = _nb_type()
        batches = [s for s in out if type(s) is nb_t] if nb_t is not None else []
        entries = [s for s in out if type(s) is not nb_t]
        if batches and _obs.PLANE is not None:
            # segments per input wave = morsel units the scan handed over;
            # the histogram is what the planner's morsel retune reads
            # alongside task latency to judge split granularity
            _obs.PLANE.metrics.observe(
                "pathway_morsel_wave_segments",
                float(len(batches)),
                bounds=_MORSEL_SEG_BOUNDS,
                help="native segments entering one input wave",
            )
        _emit_merged(self, time, batches, entries)


class StatelessNode(Node):
    """Map-like node: fn(entries) -> entries."""

    def __init__(self, graph: Graph, inp: Node, fn: Callable[[list[Entry], int], list[Entry]]):
        super().__init__(graph, [inp])
        self.fn = fn

    def finish_time(self, time: int) -> None:
        entries = self.take_input()
        if entries:
            self.emit(time, self.fn(entries, time))


class RowwiseNode(Node):
    """Evaluate compiled row functions over aligned same-universe inputs.

    Reference: expression_table (dataflow.rs:1246) + Rowwise context.
    Input 0 drives the universe; inputs 1..n are key-aligned side tables
    whose current row is visible to the expressions.

    `native_specs` (lowering-gated: every output expression is a plain
    column of one input) keeps the node token-resident: per-input state
    is {key128 -> token} and output rows splice across the aligned
    source rows in C (dp_splice_cols) — the ix/select-from-side pattern
    stays on the token plane end to end. Demotes permanently on the
    first plane-unrepresentable row (state decodes once).
    """

    _state_routing = {
        "side_states": "key",
        "emitted": "key",
        "deferred": "key",
        "_main_state_": "key",
    }

    def __init__(
        self,
        graph: Graph,
        inputs: Sequence[Node],
        fn: Callable[..., tuple],
        append_only: bool = False,
        native_specs: list | None = None,
    ):
        super().__init__(graph, inputs)
        self.fn = fn  # fn(key, *rows) -> out_row
        self._persist_attrs = ("side_states", "emitted", "deferred", "_main_state_")
        self._specs = native_specs
        self._tok = native_specs is not None and _tok_plane() is not None
        if self._tok:
            self._dp = _tok_plane()
            self._tab = self._dp.default_table()
            self.side_states: Any = [{} for _ in range(len(inputs) - 1)]
            self.emitted: Any = {}
            self._main_state_: Any = {}
        else:
            self.side_states = [KeyedState() for _ in range(len(inputs) - 1)]
            self.emitted = {}
        self.deferred: dict[Key, int] = {}

    # ------------------------------------------------------- token plane

    def _demote(self) -> None:
        if not self._tok:
            return
        tab = self._tab
        sides = []
        for st in self.side_states:
            ks = KeyedState()
            ks.rows = {Key(kv): tab.row(t) for kv, t in st.items()}
            sides.append(ks)
        self.side_states = sides
        self.emitted = {Key(kv): tab.row(t) for kv, t in self.emitted.items()}
        ms = KeyedState()
        ms.rows = {Key(kv): tab.row(t) for kv, t in self._main_state_.items()}
        self._main_state_ = ms
        self._tok = False

    def persist_state(self) -> dict | None:
        if not self._tok:
            return super().persist_state()
        tab = self._tab
        sides = []
        for st in self.side_states:
            ks = KeyedState()
            ks.rows = {Key(kv): tab.row(t) for kv, t in st.items()}
            sides.append(ks)
        ms = KeyedState()
        ms.rows = {Key(kv): tab.row(t) for kv, t in self._main_state_.items()}
        return {
            "side_states": sides,
            "emitted": {Key(kv): tab.row(t) for kv, t in self.emitted.items()},
            "deferred": dict(self.deferred),
            "_main_state_": ms,
        }

    def restore_state(self, state: dict) -> None:
        if not self._tok:
            super().restore_state(state)
            return
        tab = self._tab
        sides = []
        emitted = {}
        main = {}
        ok = True
        for st in state.get("side_states", []):
            d = {}
            for k, row in st.rows.items():
                t = tab.intern_row(row)
                if t is None:
                    ok = False
                    break
                d[k.value] = t
            sides.append(d)
        if ok:
            for k, row in state.get("emitted", {}).items():
                t = tab.intern_row(row)
                if t is None:
                    ok = False
                    break
                emitted[k.value] = t
        if ok:
            for k, row in state.get("_main_state_", KeyedState()).rows.items():
                t = tab.intern_row(row)
                if t is None:
                    ok = False
                    break
                main[k.value] = t
        if not ok:
            self._demote()
            super().restore_state(state)
            return
        self.side_states = sides
        self.emitted = emitted
        self._main_state_ = main
        self.deferred = dict(state.get("deferred", {}))

    def _finish_tok(self, time: int) -> bool:
        raws = [self.take_segments(i) for i in range(len(self.inputs))]
        waves = []
        for b, e in raws:
            w = _wave_triples(self._tab, b, e)
            if w is None:
                for i, (bb, ee) in enumerate(raws):
                    for seg in bb:
                        self.accept(i, seg)
                    if ee:
                        self.accept(i, ee)
                    self.rows_in -= len(ee) + sum(len(x) for x in bb)
                self._demote()
                return False
            waves.append(w)
        if not any(waves):
            return True
        affected: dict = dict.fromkeys(kv for kv, _t, _d in waves[0])
        for i, w in enumerate(waves[1:]):
            _tok_update_keyed(self.side_states[i], w)
            for kv, _t, _d in w:
                affected[kv] = None
        main = self._main_state_
        _tok_update_keyed(main, waves[0])
        # keys with every aligned source present splice in one C call
        plan_kvs: list[int] = []
        src_toks: list[list[int]] = [[] for _ in range(len(self.inputs))]
        for kv in affected:
            t0 = main.get(kv)
            if t0 is None:
                continue
            row_toks = [t0]
            for st in self.side_states:
                ts = st.get(kv)
                if ts is None:
                    break
                row_toks.append(ts)
            else:
                plan_kvs.append(kv)
                for s, t in enumerate(row_toks):
                    src_toks[s].append(t)
        new_toks: dict = {}
        if plan_kvs:
            res = self._dp.splice_cols(
                self._tab,
                [
                    np.fromiter(ts, np.uint64, len(plan_kvs))
                    for ts in src_toks
                ],
                self._specs,
            )
            if res is None:
                # malformed token (cannot happen for plane-built rows):
                # demote and recompute the affected keys object-side
                keys = [Key(kv) for kv in affected]
                self._demote()
                out: list[Entry] = []
                ms = self._main_state()
                for key in keys:
                    row0 = ms.get(key)
                    new = self._compute(key, row0) if row0 is not None else None
                    delta_emit(self.emitted, out, key, new)
                self.emit(time, out)
                return True
            new_toks = dict(zip(plan_kvs, res.tolist()))
        kvs: list = []
        toks: list = []
        diffs: list = []
        for kv in affected:
            _tok_delta_emit(
                self.emitted, kvs, toks, diffs, kv, new_toks.get(kv)
            )
        dp_nb = self._dp
        n = len(kvs)
        if n:
            self.emit(
                time,
                dp_nb.NativeBatch(
                    self._tab,
                    np.fromiter((kv & _MASK64 for kv in kvs), np.uint64, n),
                    np.fromiter((kv >> 64 for kv in kvs), np.uint64, n),
                    np.fromiter(toks, np.uint64, n),
                    np.fromiter(diffs, np.int64, n),
                ),
            )
        return True

    def _compute(self, key: Key, row0: tuple) -> tuple | None:
        rows = [row0]
        for st in self.side_states:
            side_row = st.get(key)
            if side_row is None:
                return None  # wait until all aligned inputs have the key
            rows.append(side_row)
        return self.fn(key, *rows)  # column fns are individually guarded

    def finish_time(self, time: int) -> None:
        if self._tok:
            if self._finish_tok(time):
                return
        main = self.take_input(0)
        side_batches = [self.take_input(i) for i in range(1, len(self.inputs))]
        if not main and not any(side_batches):
            return
        main_state: KeyedState = self._main_state()
        affected: dict[Key, None] = {}
        for key, _row, _diff in main:
            affected[key] = None
        for i, batch in enumerate(side_batches):
            self.side_states[i].update(batch)
            for key, _row, _diff in batch:
                affected[key] = None
        main_state.update(main)
        out: list[Entry] = []
        for key in affected:
            row0 = main_state.get(key)
            new = self._compute(key, row0) if row0 is not None else None
            delta_emit(self.emitted, out, key, new)
        self.emit(time, out)

    def _main_state(self) -> KeyedState:
        if not hasattr(self, "_main_state_"):
            self._main_state_ = KeyedState()
        return self._main_state_


def decode_cols_dict(dp_mod, tab, tokens, sorted_cols: list[int]):
    """Shared batch-column decode for native-plan nodes: col idx ->
    (vals_i, vals_f, tags) with boolness-preserving tags (0 int, 1 float,
    2 bad, 3 bool). None = malformed batch (caller materializes)."""
    if not sorted_cols:
        return {}
    dec = dp_mod.decode_num_cols(tab, tokens, sorted_cols)
    if dec is None:
        return None
    vi, vf, tg = dec
    return {c: (vi[j], vf[j], tg[j]) for j, c in enumerate(sorted_cols)}


class MapNode(Node):
    """Stateless per-row map with key passthrough — the token-resident
    select. Unlike RowwiseNode it keeps NO emitted-state: an update stream
    (k, old, -1), (k, new, +1) maps to the corresponding output pair,
    exactly like the reference's map operators (differential `map` does
    not suppress unchanged outputs either). Lowering uses it only on
    native-plane tables, where every expression has a vectorized plan.

    native_plan: {"specs": [("col", src_idx) | ("val", slot)],
                  "plans": [NumpyPlan per slot], "needed_cols": [ints]}.
    Rows a plan flags BAD fall back to the per-row compiled fn, which
    reproduces exact Python semantics (ERROR poison + error log).
    """

    def __init__(
        self,
        graph: Graph,
        inp: Node,
        fn: Callable[[Key, tuple], tuple],
        native_plan: dict | None = None,
    ):
        super().__init__(graph, [inp])
        self.fn = fn
        self._plan = native_plan if _nb_type() is not None else None
        if self._plan is not None:
            from pathway_tpu_torch.engine.native import dataplane as _dp

            self._dp = _dp

    def _map_batch(self, time: int, batch) -> None:
        plan = self._plan
        n = len(batch)
        decoded = decode_cols_dict(
            self._dp, batch.tab, batch.token, plan["needed_cols"]
        )
        if decoded is None:
            self._map_entries(time, batch.materialize())
            return
        from pathway_tpu_torch.internals.expression_numpy import KeyColsPlan

        n_slots = len(plan["plans"])
        vals_i = np.zeros((max(n_slots, 1), n), np.int64)
        vals_f = np.zeros((max(n_slots, 1), n), np.float64)
        vtag = np.zeros((max(n_slots, 1), n), np.uint8)
        for s, p in enumerate(plan["plans"]):
            if isinstance(p, KeyColsPlan):
                rk = self._dp.rekey(batch.tab, batch.token, p.cols)
                if rk is None:
                    self._map_entries(time, batch.materialize())
                    return
                lo, hi = rk
                bad = (lo == 0) & (hi == 0)  # ERROR in key columns
                vals_i[s] = lo.view(np.int64)
                vals_f[s] = hi.view(np.float64)
                vtag[s] = np.where(bad, np.uint8(255), np.uint8(4))
                continue
            vi, vf, tg = p.eval_map(decoded, n)
            vals_i[s] = vi
            vals_f[s] = vf
            vtag[s] = tg
        out_tok, status = self._dp.build_rows(
            batch.tab, batch.token, plan["specs"], vals_i, vals_f, vtag
        )
        ok = status == 0
        if ok.all():
            self.emit(
                time,
                self._dp.NativeBatch(
                    batch.tab, batch.key_lo, batch.key_hi, out_tok, batch.diff,
                    distinct_hint=batch.distinct_hint,  # keys pass through
                ),
            )
            return
        if ok.any():
            nb = batch.select(ok)
            self.emit(
                time,
                self._dp.NativeBatch(
                    batch.tab, nb.key_lo, nb.key_hi,
                    np.ascontiguousarray(out_tok[ok]), nb.diff,
                    distinct_hint=nb.distinct_hint,
                ),
            )
        # BAD rows: exact per-row Python semantics
        self._map_entries(time, batch.select(~ok).materialize())

    def _map_entries(self, time: int, entries: list[Entry]) -> None:
        out: list[Entry] = []
        for key, row, diff in entries:
            out.append((key, self.fn(key, row), diff))
        self.emit(time, out)

    def finish_time(self, time: int) -> None:
        if self._plan is not None:
            batches, entries = self.take_segments()
            for b in batches:
                self._map_batch(time, b)
            if entries:
                self._map_entries(time, entries)
            return
        entries = self.take_input()
        if entries:
            self._map_entries(time, entries)


class FilterNode(Node):
    """Predicate filter. `native_plan` (a NumpyPlan for the condition)
    lets token-resident batches filter by mask; rows the plan can't judge
    (BAD) re-evaluate per row — matching the Python path's ERROR-to-False
    + error-log behavior."""

    def __init__(
        self,
        graph: Graph,
        inp: Node,
        predicate: Callable[[Key, tuple], Any],
        native_plan=None,
    ):
        super().__init__(graph, [inp])
        self.predicate = predicate
        self._plan = native_plan if _nb_type() is not None else None
        if self._plan is not None:
            from pathway_tpu_torch.engine.native import dataplane as _dp

            self._dp = _dp
            self._sorted_cols = sorted(self._plan.needed_cols)

    def _filter_entries(self, time: int, entries: list[Entry]) -> None:
        out = []
        for key, row, diff in entries:
            try:
                keep = self.predicate(key, row)
            except Exception as e:  # noqa: BLE001
                self.log_error(f"filter: {type(e).__name__}: {e}")
                keep = False
            if isinstance(keep, ErrorValue):
                self.log_error("filter: Error value in condition")
                keep = False
            if keep:
                out.append((key, row, diff))
        self.emit(time, out)

    def finish_time(self, time: int) -> None:
        if self._plan is not None:
            batches, entries = self.take_segments()
            for b in batches:
                decoded = decode_cols_dict(
                    self._dp, b.tab, b.token, self._sorted_cols
                )
                if decoded is None:
                    self._filter_entries(time, b.materialize())
                    continue
                keep, bad = self._plan.eval_mask(decoded, len(b))
                if keep.any():
                    self.emit(time, b.select(keep))
                if bad.any():
                    self._filter_entries(time, b.select(bad).materialize())
            if entries:
                self._filter_entries(time, entries)
            return
        entries = self.take_input()
        if not entries:
            return
        self._filter_entries(time, entries)


class _NativeProgramBuilder:
    """Composes per-stage native plans (MapNode-style specs/plans,
    FilterNode cond plans) into one fused vectorized program. Tracks the
    compile-time virtual schema: each stage-output column is either a
    passthrough of a SOURCE column or a computed slot, so the fused
    runtime decodes exactly the source columns any plan can reach and
    never interns intermediate rows. Shared by lowering's static fusion
    and the AdaptivePolicy's runtime re-fusion."""

    def __init__(self) -> None:
        self.virt: list | None = None  # None = identity over the source
        self.stages: list = []
        self.needed_src: set[int] = set()
        # source schema width when the caller knows it (lowering does;
        # runtime re-fusion doesn't) — the plan verifier's schema check
        # resolves stage-boundary references against it
        self.src_width: int | None = None

    def _resolve(self, j: int):
        return ("src", j) if self.virt is None else self.virt[j]

    def _need(self, cols) -> None:
        for c in cols:
            it = self._resolve(c)
            if it[0] == "src":
                self.needed_src.add(it[1])

    def adopt(self, program: dict) -> None:
        """Seed from a stored (source-relative) program — chain head."""
        assert self.virt is None and not self.stages
        self.stages = list(program["stages"])
        self.needed_src = set(program["needed_src"])
        self.virt = program.get("final_env")

    def adopt_rebased(self, program: dict) -> bool:
        """Append a stored program mid-chain: its source IS the current
        virtual schema, so stage items compose through the runtime env
        unchanged; only the needed-source set and the final schema rebase
        through the current virt. "keycols" items can't rebase (they
        blake the ORIGINAL source tokens), so such programs only compose
        as the chain head."""
        if self.virt is None and not self.stages:
            self.adopt(program)
            return True
        for st in program["stages"]:
            if st[0] == "map" and any(it[0] == "keycols" for it in st[1]):
                return False
        for c in program["needed_src"]:
            it = self._resolve(c)
            if it[0] == "src":
                self.needed_src.add(it[1])
        self.stages.extend(program["stages"])
        fe = program.get("final_env")
        if fe is not None:
            self.virt = [
                self._resolve(it[1]) if it[0] == "src" else ("slot",)
                for it in fe
            ]
        return True

    def add_map(self, specs: list, plans: list) -> bool:
        from pathway_tpu_torch.internals.expression_numpy import KeyColsPlan

        items: list = []
        new_virt: list = []
        for kind, idx in specs:
            if kind == "col":
                items.append(("env", idx))
                new_virt.append(self._resolve(idx))
                continue
            p = plans[idx]
            if isinstance(p, KeyColsPlan):
                src_cols: list[int] = []
                for c in p.cols:
                    it = self._resolve(c)
                    if it[0] != "src":
                        return False  # pointer_from over a computed value
                    src_cols.append(it[1])
                items.append(("keycols", src_cols))
            else:
                self._need(p.needed_cols)
                items.append(("plan", p))
            new_virt.append(("slot",))
        self.stages.append(("map", items))
        self.virt = new_virt
        return True

    def add_filter(self, plan) -> bool:
        self._need(plan.needed_cols)
        self.stages.append(("filter", plan))
        return True

    def build(self) -> dict:
        return {
            "needed_src": sorted(self.needed_src),
            "stages": self.stages,
            "final_env": self.virt,
            "src_width": self.src_width,
        }


class FusedRowwiseNode(Node):
    """One engine node for a fused linear chain of rowwise operators
    (select / with_columns / filter, optionally terminated by a reindex
    on the object plane) — the plan optimizer's chain-fusion target
    (internals/planner.py, docs/planner.md).

    ``stages``: list of ``("map", row_fn)`` / ``("filter", pred)``
    steps; ``rekey`` an optional final key function (object plane only).

    ``native_program`` (every stage numpy-plannable over a native-plane
    source) evaluates the composed program per wave with intermediate
    values held as column arrays: ONE source decode, no intermediate
    intern-table writes, one final row build — versus one decode + row
    build + intern per chain node unfused. Rows any stage flags BAD run
    the composed per-row path from the original row, reproducing the
    unfused per-node fallback semantics exactly.

    ``stateful=True`` (object-plane chains containing at least one
    rowwise stage) reproduces RowwiseNode's keyed delta-suppression: the
    node arranges the input by key and re-emits per affected key, so the
    fused stream is byte-identical to the chain of suppressing
    RowwiseNodes it replaces (suppression composes: suppressing only at
    the chain tail is equivalent to suppressing at every stage for
    healthy keyed streams). Stateless mode streams entries through like
    MapNode/FilterNode do.
    """

    _state_routing = {"_main_state_": "key", "emitted": "key"}

    def __init__(
        self,
        graph: Graph,
        inp: Node,
        stages: list,
        *,
        stateful: bool = False,
        native_program: dict | None = None,
        rekey: Callable | None = None,
        detail: str = "",
    ):
        super().__init__(graph, [inp])
        self.stages = stages
        self.rekey = rekey
        self.detail = detail
        self._stateful = stateful
        self._program = native_program if _nb_type() is not None else None
        if self._program is not None:
            from pathway_tpu_torch.engine.native import dataplane as _dp

            self._dp = _dp
        if stateful:
            self._persist_attrs = ("_main_state_", "emitted")
            self._main_state_ = KeyedState()
            self.emitted: dict[Key, tuple] = {}

    def describe(self) -> str:
        base = f"FusedRowwiseNode[{self.detail or 'fused'}]"
        if self.trace:
            base += f"@{self.trace}"
        return f"{base}#{self.node_id}"

    def persist_signature(self) -> str:
        kinds = "+".join(k for k, _f in self.stages)
        return (
            f"FusedRowwiseNode/{kinds}/stateful={int(self._stateful)}"
            f"/native={int(self._program is not None)}"
            f"/rekey={int(self.rekey is not None)}"
        )

    # ------------------------------------------------------ per-row path

    def _run_row(self, key: Key, row: tuple) -> tuple | None:
        """Composed program on one row; None = dropped by a filter.
        Map fns are per-column guarded (ERROR poison + log) by lowering;
        filter errors reproduce FilterNode's log-and-drop."""
        for kind, fn in self.stages:
            if kind == "map":
                row = fn(key, row)
            else:
                try:
                    keep = fn(key, row)
                except Exception as e:  # noqa: BLE001
                    self.log_error(f"filter: {type(e).__name__}: {e}")
                    return None
                if isinstance(keep, ErrorValue):
                    self.log_error("filter: Error value in condition")
                    return None
                if not keep:
                    return None
        return row

    def _emit_entries(self, time: int, out: list[Entry]) -> None:
        if self.rekey is not None:
            rekeyed: list[Entry] = []
            for key, row, diff in out:
                try:
                    nk = self.rekey(key, row)
                except Exception as e:  # noqa: BLE001
                    self.log_error(f"reindex: {type(e).__name__}: {e}")
                    continue
                rekeyed.append((nk, row, diff))
            self.emit(time, consolidate(rekeyed))
            return
        self.emit(time, out)

    def _stream_entries(self, time: int, entries: list[Entry]) -> None:
        out: list[Entry] = []
        for key, row, diff in entries:
            new = self._run_row(key, row)
            if new is not None:
                out.append((key, new, diff))
        self._emit_entries(time, out)

    # ------------------------------------------------------- native path

    def _run_batch(self, time: int, b) -> None:
        """Vectorized composed program over one NativeBatch. Maintains a
        row selection (indices into the batch) plus an environment of
        virtual columns: ("src", i) passthrough of source column i, or
        ("slot", s) computed (vals_i, vals_f, tags) arrays aligned to
        the current selection."""
        prog = self._program
        dp_mod = self._dp
        n = len(b)
        decoded = decode_cols_dict(dp_mod, b.tab, b.token, prog["needed_src"])
        if decoded is None:
            self._stream_entries(time, b.materialize())
            return
        sel = np.arange(n)
        slots: list = []  # (vi, vf, tg) aligned to sel
        env: list | None = None  # None = identity over source columns
        fallback: list = []  # original-row indices for the per-row path

        def arrays(item):
            if item[0] == "src":
                vi, vf, tg = decoded[item[1]]
                return vi[sel], vf[sel], tg[sel]
            return slots[item[1]]

        def env_item(j):
            return ("src", j) if env is None else env[j]

        for step in prog["stages"]:
            if not len(sel):
                break
            if step[0] == "filter":
                plan = step[1]
                dec = {j: arrays(env_item(j)) for j in plan.needed_cols}
                keep, bad = plan.eval_mask(dec, len(sel))
                if bad.any():
                    fallback.extend(sel[bad].tolist())
                m = keep & ~bad
                if not m.all():
                    sel = sel[m]
                    slots = [
                        (vi[m], vf[m], tg[m]) for (vi, vf, tg) in slots
                    ]
                continue
            # map step: build the next environment
            new_env: list = []
            for item in step[1]:
                if item[0] == "env":
                    new_env.append(env_item(item[1]))
                elif item[0] == "keycols":
                    rk = dp_mod.rekey(b.tab, b.token[sel], item[1])
                    if rk is None:
                        self._stream_entries(time, b.materialize())
                        return
                    lo, hi = rk
                    badk = (lo == 0) & (hi == 0)
                    slots.append((
                        lo.view(np.int64), hi.view(np.float64),
                        np.where(badk, np.uint8(255), np.uint8(4)),
                    ))
                    new_env.append(("slot", len(slots) - 1))
                else:  # ("plan", plan)
                    plan = item[1]
                    dec = {j: arrays(env_item(j)) for j in plan.needed_cols}
                    vi, vf, tg = plan.eval_map(dec, len(sel))
                    slots.append((vi, vf, tg))
                    new_env.append(("slot", len(slots) - 1))
            env = new_env
        if len(sel):
            if env is None:
                # pure filter chain: tokens pass through untouched
                mask = np.zeros(n, bool)
                mask[sel] = True
                self.emit(time, b.select(mask))
            else:
                specs: list = []
                used: list[int] = []
                for item in env:
                    if item[0] == "src":
                        specs.append(("col", item[1]))
                    else:
                        specs.append(("val", len(used)))
                        used.append(item[1])
                n_sel = len(sel)
                vals_i = np.zeros((max(len(used), 1), n_sel), np.int64)
                vals_f = np.zeros((max(len(used), 1), n_sel), np.float64)
                vtag = np.zeros((max(len(used), 1), n_sel), np.uint8)
                for pos, s in enumerate(used):
                    vals_i[pos], vals_f[pos], vtag[pos] = slots[s]
                out_tok, status = dp_mod.build_rows(
                    b.tab, b.token[sel], specs, vals_i, vals_f, vtag
                )
                ok = status == 0
                if (~ok).any():
                    fallback.extend(sel[~ok].tolist())
                if ok.any():
                    self.emit(
                        time,
                        dp_mod.NativeBatch(
                            b.tab,
                            np.ascontiguousarray(b.key_lo[sel][ok]),
                            np.ascontiguousarray(b.key_hi[sel][ok]),
                            np.ascontiguousarray(out_tok[ok]),
                            np.ascontiguousarray(b.diff[sel][ok]),
                            distinct_hint=b.distinct_hint,
                        ),
                    )
        if fallback:
            fallback.sort()
            mask = np.zeros(n, bool)
            mask[np.asarray(fallback, np.int64)] = True
            self._stream_entries(time, b.select(mask).materialize())

    # ---------------------------------------------------- stateful path

    def _finish_stateful(self, time: int) -> None:
        entries = self.take_input()
        if not entries:
            return
        state: KeyedState = self._main_state_
        affected: dict[Key, None] = {}
        for key, _row, _diff in entries:
            affected[key] = None
        state.update(entries)
        out: list[Entry] = []
        for key in affected:
            row0 = state.get(key)
            new = self._run_row(key, row0) if row0 is not None else None
            delta_emit(self.emitted, out, key, new)
        self._emit_entries(time, out)

    def finish_time(self, time: int) -> None:
        if self._stateful:
            self._finish_stateful(time)
            return
        if self._program is not None:
            batches, entries = self.take_segments()
            for b in batches:
                self._run_batch(time, b)
            if entries:
                self._stream_entries(time, entries)
            return
        entries = self.take_input()
        if entries:
            self._stream_entries(time, entries)

    # --------------------------------------------------- runtime fusion

    @classmethod
    def from_live_nodes(cls, graph: Graph, chain: list) -> "FusedRowwiseNode | None":
        """Fuse a linear run of live stateless nodes (MapNode /
        FilterNode / stateless FusedRowwiseNode) in the running graph —
        the AdaptivePolicy's re-fusion action, applied at a drained
        epoch fence. Returns None when the run doesn't compose (a member
        with a native plan that the composed program can't absorb would
        be a perf regression, stateful/rekey members change semantics)."""
        stages: list = []
        builder = _NativeProgramBuilder()
        any_plan = False
        native = True
        for pos, node in enumerate(chain):
            if isinstance(node, FusedRowwiseNode):
                if node._stateful or node.rekey is not None:
                    return None
                stages.extend(node.stages)
                if node._program is not None:
                    any_plan = True
                    if native:
                        native = builder.adopt_rebased(node._program)
                else:
                    native = False
            elif isinstance(node, MapNode):
                stages.append(("map", node.fn))
                if node._plan is not None:
                    any_plan = True
                    if native:
                        native = builder.add_map(
                            node._plan["specs"], node._plan["plans"]
                        )
                else:
                    native = False
            elif isinstance(node, FilterNode):
                stages.append(("filter", node.predicate))
                if node._plan is not None:
                    any_plan = True
                    if native:
                        native = builder.add_filter(node._plan)
                else:
                    native = False
            else:
                return None
        program = builder.build() if native and builder.stages else None
        if any_plan and program is None:
            return None  # would demote a vectorized run to per-row
        head, tail = chain[0], chain[-1]
        inp = head.inputs[0]
        fused = cls(
            graph, inp, stages, native_program=program,
            detail="refused:" + "+".join(k for k, _ in stages),
        )
        fused.label = "fused"
        fused.trace = head.trace
        inp.downstream = [
            (d, i) for (d, i) in inp.downstream if d is not head
        ]
        fused.downstream = list(tail.downstream)
        for d, i in fused.downstream:
            d.inputs[i] = fused
        tail.downstream = []
        for node in chain:
            node._replaced = True
        return fused


def _emit_merged(node: Node, time: int, batches: list, entries: list[Entry]) -> None:
    """Shared wave emission for nodes that re-key or merge streams: keeps
    token-resident batches native when the whole wave is native, and
    consolidates (re-keying can collide keys; inputs can carry retract
    pairs). Mirrors InputNode.finish_time's merging rules."""
    nb_t = _nb_type()
    if batches and not entries:
        nb = batches[0] if len(batches) == 1 else nb_t.concat(batches)
        if not nb.is_distinct_insert():
            nb = nb.consolidate()
        node.emit(time, nb)
        return
    if batches:
        flat: list[Entry] = []
        for b in batches:
            flat.extend(b.materialize())
        flat.extend(entries)
        node.emit(time, consolidate(flat))
        return
    if entries:
        node.emit(time, consolidate(entries))


# ---------------------------------------------- token-plane stateful tail
#
# The stateful operator tail (set ops, update_rows/cells, ix, dedup,
# buffer/forget/freeze, gradual_broadcast, flatten) runs token-resident:
# state lives in int-keyed dicts {key128 -> intern token}, waves stay as
# flat (kv, tok, diff) triples, and output re-emits as NativeBatch —
# matching the reference's typed-record operators
# (reference/src/engine/dataflow.rs:1555-2224,
# src/engine/dataflow/operators/time_column.rs:380) instead of decoding
# every row to Python objects per wave.
#
# Plane discipline: a node starts in token mode when the plane is up and
# DEMOTES (one-time state decode, permanent) when a wave carries a row
# the plane can't represent (tuples/ndarrays/Json) — correctness never
# depends on the gate. Operator snapshots always export the OBJECT form,
# so persistence, rescale, and cross-plane restore compose unchanged.
# One visible difference from the object plane: token equality is
# byte-equality, so an update changing 1 to 1.0 re-emits where the
# object plane (Python ==) suppressed it — this matches the reference's
# typed Value semantics (Value::Int(1) != Value::Float(1.0)).

_MASK64 = (1 << 64) - 1


def _tok_plane():
    """The dataplane module when the token plane is on, else None."""
    if _nb_type() is None:
        return None
    from pathway_tpu_torch.engine.native import dataplane

    return dataplane


def _wave_triples(tab, batches, entries) -> list | None:
    """One wave as [(kv, tok, diff)] triples; None when an object entry
    is not plane-representable (caller demotes)."""
    out: list = []
    for b in batches:
        out.extend(
            zip(
                ((h << 64) | l for h, l in zip(b.key_hi.tolist(), b.key_lo.tolist())),
                b.token.tolist(),
                b.diff.tolist(),
            )
        )
    for key, row, d in entries:
        t = tab.intern_row(row)
        if t is None:
            return None
        out.append((key.value, t, d))
    return out


def _flatten_segments(batches, entries) -> list[Entry]:
    """Object-plane form of a drained wave (demotion fallback)."""
    flat: list[Entry] = []
    for b in batches:
        flat.extend(b.materialize())
    flat.extend(entries)
    return flat


_EMPTY_U64 = np.empty(0, np.uint64)
_EMPTY_I64 = np.empty(0, np.int64)
_MISSING_SENTINEL = object()  # "no previous value" marker (None is a value)


def _wave_arrays(tab, batches, entries):
    """One wave as (lo, hi, tok, diff) numpy columns — the array twin of
    `_wave_triples` for nodes whose whole wave logic is vectorized (no
    per-row tuples ever built). None when an object entry is not
    plane-representable (caller demotes)."""
    los, his, tks, dfs = [], [], [], []
    for b in batches:
        los.append(np.asarray(b.key_lo, np.uint64))
        his.append(np.asarray(b.key_hi, np.uint64))
        tks.append(np.asarray(b.token, np.uint64))
        dfs.append(np.asarray(b.diff, np.int64))
    if entries:
        n = len(entries)
        elo = np.empty(n, np.uint64)
        ehi = np.empty(n, np.uint64)
        etk = np.empty(n, np.uint64)
        edf = np.empty(n, np.int64)
        for i, (key, row, d) in enumerate(entries):
            t = tab.intern_row(row)
            if t is None:
                return None
            kv = key.value
            elo[i] = kv & _MASK64
            ehi[i] = kv >> 64
            etk[i] = t
            edf[i] = d
        los.append(elo)
        his.append(ehi)
        tks.append(etk)
        dfs.append(edf)
    if not los:
        return _EMPTY_U64, _EMPTY_U64, _EMPTY_U64, _EMPTY_I64
    if len(los) == 1:
        return los[0], his[0], tks[0], dfs[0]
    return (
        np.concatenate(los),
        np.concatenate(his),
        np.concatenate(tks),
        np.concatenate(dfs),
    )


_VOID16 = np.dtype((np.void, 16))


def _void16(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(lo, hi) uint64 columns as one void16 array — hashable 128-bit key
    cells for vectorized membership (np.isin) without Python bigints."""
    a = np.empty((len(lo), 2), np.uint64)
    a[:, 0] = lo
    a[:, 1] = hi
    return a.reshape(-1).view(_VOID16)


def _kvs_of(lo: np.ndarray, hi: np.ndarray) -> list[int]:
    """Python bigint kvs for (lo, hi) columns (rare paths / state dicts)."""
    return [
        (h << 64) | l for h, l in zip(hi.tolist(), lo.tolist())
    ]


def _kv_cols(kvs) -> tuple[np.ndarray, np.ndarray]:
    """Bigint kvs -> (lo, hi) uint64 columns."""
    n = len(kvs)
    lo = np.empty(n, np.uint64)
    hi = np.empty(n, np.uint64)
    for i, kv in enumerate(kvs):
        lo[i] = kv & _MASK64
        hi[i] = kv >> 64
    return lo, hi


def nks_decode(nstate, tab) -> KeyedState:
    """Decode a NativeKeyedState (key128 -> token) into the object-form
    KeyedState (Key -> row) — the shared demote/snapshot conversion of
    the token-resident iterate scope (capture states, fed mirrors)."""
    ks = KeyedState()
    lo, hi, tok = nstate.items_arrays()
    tl = tok.tolist()
    for i, kv in enumerate(_kvs_of(lo, hi)):
        ks.rows[Key(kv)] = tab.row(tl[i])
    return ks


def nks_encode(rows: dict, tab):
    """Encode {Key: row} into a fresh NativeKeyedState (restore path);
    None when any row is not plane-representable (caller demotes)."""
    from pathway_tpu_torch.engine import native as _nat

    items = list(rows.items())
    n = len(items)
    lo = np.empty(n, np.uint64)
    hi = np.empty(n, np.uint64)
    tok = np.empty(n, np.uint64)
    for i, (key, row) in enumerate(items):
        t = tab.intern_row(row)
        if t is None:
            return None
        kv = key.value
        lo[i] = kv & _MASK64
        hi[i] = kv >> 64
        tok[i] = t
    st = _nat.NativeKeyedState()
    st.update(lo, hi, tok, np.ones(n, np.int64))
    return st


class _Key128Set:
    """Set of 128-bit keys as numpy void16 cells: O(1) amortized bulk
    adds, vectorized membership, bigints only on demand (demote/
    snapshot). Replaces per-row Python-int sets on hot paths
    (BufferNode.released holds every row ever released).

    Layout: LSM-style sorted-unique chunks merged binary-counter
    fashion — each add sorts only its own wave, every key is copied
    O(log n) times total, chunk count stays O(log n), memory is bounded
    by the DISTINCT key count, and membership binary-searches each chunk
    for the (few) candidates instead of ever streaming the history."""

    __slots__ = ("_chunks",)

    def __init__(self):
        self._chunks: list[np.ndarray] = []  # sorted-unique void16, sizes ↓

    def add_arrays(self, lo: np.ndarray, hi: np.ndarray) -> None:
        if not len(lo):
            return
        self._chunks.append(np.unique(_void16(lo, hi)))
        # binary-counter merge: amortized O(n log n) total maintenance
        while (
            len(self._chunks) > 1
            and len(self._chunks[-1]) >= len(self._chunks[-2])
        ):
            b = self._chunks.pop()
            a = self._chunks.pop()
            self._chunks.append(np.unique(np.concatenate([a, b])))

    def add_kvs(self, kvs) -> None:
        if kvs:
            self.add_arrays(*_kv_cols(list(kvs)))

    def contains(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """Vectorized membership mask for (lo, hi) columns."""
        cand = _void16(lo, hi)
        mask = np.zeros(len(cand), bool)
        for chunk in self._chunks:
            pos = np.searchsorted(chunk, cand)
            pos[pos == len(chunk)] = 0
            mask |= chunk[pos] == cand
        return mask

    def to_kv_set(self) -> set[int]:
        out: set[int] = set()
        for chunk in self._chunks:
            pairs = chunk.view(np.uint64).reshape(-1, 2)
            out.update(_kvs_of(pairs[:, 0], pairs[:, 1]))
        return out

    def __len__(self) -> int:
        # distinct count: chunks may share keys until their merge
        if not self._chunks:
            return 0
        if len(self._chunks) == 1:
            return len(self._chunks[0])
        return len(np.unique(np.concatenate(self._chunks)))


_F53 = 1 << 53  # largest contiguous exact-int range of float64


class _Live128Map:
    """{128-bit key -> (tok, thr[, diff])} as chunked numpy columns — the
    ForgetNode live rows and (with_diff=True) the BufferNode pending rows
    (each holds up to EVERY in-flight row; a dict of Python bigints would
    dominate the wave).

    Dict semantics replay positionally: each appended chunk preserves
    ROW order, deletions are entries with tok == 0 (tokens start at 1),
    and `_gather` keeps the LAST entry per key across the chronological
    chunks, then drops deletion sentinels — exactly `live[kv] = ...` /
    `live.pop(kv)` applied in arrival order, so a retract + re-insert of
    the same row in one wave stays live and an insert + retract stays
    dead.

    Thresholds stay exact: chunks may be int64 or float64, and
    `thr_compatible` refuses a mix of floats with ints beyond 2^53
    (concatenation would round them) — the caller demotes to the
    object plane's exact Python-scalar comparisons instead."""

    __slots__ = ("_lo", "_hi", "_tok", "_thr", "_diff", "_big_int", "_float")

    def __init__(self, with_diff: bool = False):
        self._lo: list[np.ndarray] = []
        self._hi: list[np.ndarray] = []
        self._tok: list[np.ndarray] = []
        self._thr: list[np.ndarray] = []
        self._diff: list[np.ndarray] | None = [] if with_diff else None
        self._big_int = False  # any stored int chunk with |thr| > 2^53
        self._float = False  # any stored float chunk

    def thr_compatible(self, thr: np.ndarray) -> bool:
        """Would storing this thr chunk keep comparisons exact?"""
        if thr.dtype.kind == "f":
            return not self._big_int
        if np.abs(thr).max(initial=0) > _F53:
            return not self._float
        return True

    def now_compatible(self, now) -> bool:
        """Would `stored thr <= now` evaluate without rounding?"""
        if now is None:
            return True
        if isinstance(now, float):
            return not self._big_int
        if abs(now) > _F53:
            return not self._float
        return True

    def apply(self, lo, hi, tok, thr, ins_mask, diff=None) -> None:
        """One wave's worth of ops in row order: rows with ins_mask True
        upsert (tok, thr[, diff]); rows with False delete their key."""
        if not len(lo):
            return
        thr = np.asarray(thr)
        if thr.dtype.kind == "f":
            self._float = True
        elif np.abs(thr).max(initial=0) > _F53:
            self._big_int = True
        self._lo.append(lo)
        self._hi.append(hi)
        self._tok.append(np.where(ins_mask, tok, np.uint64(0)))
        self._thr.append(thr)
        if self._diff is not None:
            self._diff.append(
                np.ones(len(lo), np.int64)
                if diff is None
                else np.asarray(diff, np.int64)
            )

    @staticmethod
    def _cat(parts: list[np.ndarray]) -> np.ndarray:
        if len(parts) == 1:
            return parts[0]
        return np.concatenate(
            parts, dtype=np.result_type(*(p.dtype for p in parts))
        )

    def _gather(self):
        """(lo, hi, tok, thr, diff|None) after replaying overwrites/
        deletes (last entry per key wins; tok == 0 rows drop), or None
        when empty."""
        if not self._lo:
            return None
        lo = self._cat(self._lo)
        hi = self._cat(self._hi)
        tok = self._cat(self._tok)
        thr = self._cat(self._thr)
        diff = self._cat(self._diff) if self._diff is not None else None
        keys = _void16(lo, hi)
        # keep the last occurrence per key: unique on the reversed array
        n = len(keys)
        _, first_rev = np.unique(keys[::-1], return_index=True)
        last = np.zeros(n, bool)
        last[n - 1 - first_rev] = True
        keep = last & (tok != 0)
        lo, hi, tok, thr = lo[keep], hi[keep], tok[keep], thr[keep]
        self._lo, self._hi, self._tok, self._thr = [lo], [hi], [tok], [thr]
        if diff is not None:
            diff = diff[keep]
            self._diff = [diff]
        if not len(lo):
            return None
        return lo, hi, tok, thr, diff

    def expire(self, now):
        """Pop rows with thr <= now. Returns (lo, hi, tok, diff|None) of
        the popped rows; compacts the store to one chunk of survivors."""
        g = self._gather()
        if g is None:
            return _EMPTY_U64, _EMPTY_U64, _EMPTY_U64, None
        lo, hi, tok, thr, diff = g
        exp = thr <= now
        keep = ~exp
        self._lo = [lo[keep]]
        self._hi = [hi[keep]]
        self._tok = [tok[keep]]
        self._thr = [thr[keep]]
        if diff is not None:
            self._diff = [diff[keep]]
        return lo[exp], hi[exp], tok[exp], diff[exp] if diff is not None else None

    def items_arrays(self):
        """(lo, hi, tok, thr, diff|None) of live rows (demote/snapshot)."""
        return self._gather()


def _thr_cmp_exact(thr: np.ndarray, now) -> bool:
    """Can `thr <= now` evaluate without float64 rounding? (numpy casts
    int64 to float64 when the other side is a float — exact only within
    |v| <= 2^53; the object plane compares Python scalars exactly)."""
    if now is None:
        return True
    if thr.dtype.kind == "i":
        if isinstance(now, float):
            return bool(np.abs(thr).max(initial=0) <= _F53)
        return True
    return not (isinstance(now, int) and abs(now) > _F53)


def _plan_array(plan, decoded, n):
    """Plan results as one numeric numpy column, or None (demote). Pure
    int waves stay exact int64. Int/float mixes unify to float64 only
    while every int is exactly representable (|v| <= 2^53); beyond that
    the wave demotes so threshold comparisons keep exact Python-int
    semantics (ns-epoch timestamps mixed with float durations)."""
    vi, vf, tg = plan.eval_map(decoded, n)
    if n == 0:
        return vi[:0]
    if (tg == 0).all():
        return vi
    if (tg <= 1).all():
        is_int = tg == 0
        if np.abs(vi[is_int]).max(initial=0) > (1 << 53):
            return None
        return np.where(is_int, vi.astype(np.float64), vf)
    return None  # bool / None / error / fallback: object semantics


class _TokTailNode(Node):
    """Shared machinery for token-resident stateful-tail nodes."""

    def __init__(self, graph: Graph, inputs: Sequence[Node]):
        super().__init__(graph, inputs)
        dp = _tok_plane()
        self._dp = dp
        self._tok = dp is not None
        if self._tok:
            self._tab = dp.default_table()

    # Subclasses define: _demoted_state() -> dict of object-form state
    # attrs, and _encode_state(st) -> bool (install object-form state into
    # token form; False = not representable, stay demoted).

    def _demote(self) -> None:
        """One-way switch to the object plane: decode token state."""
        if not self._tok:
            return
        for attr, value in self._demoted_state().items():
            setattr(self, attr, value)
        self._tok = False

    def _drain_waves(self, time: int):
        """Drain all inputs. Returns (triples_per_input | None,
        entries_per_input). triples None => demoted mid-drain; the object
        entries (2nd element) are the full wave either way."""
        raws = [self.take_segments(i) for i in range(len(self.inputs))]
        if not self._tok:
            return None, [_flatten_segments(b, e) for b, e in raws]
        waves = []
        for b, e in raws:
            w = _wave_triples(self._tab, b, e)
            if w is None:
                self._demote()
                return None, [_flatten_segments(bb, ee) for bb, ee in raws]
            waves.append(w)
        return waves, None

    def _emit_tok(self, time: int, kvs: list, toks: list, diffs: list,
                  consolidate_out: bool = False) -> None:
        n = len(kvs)
        if n == 0:
            return
        dp = self._dp
        nb = dp.NativeBatch(
            self._tab,
            np.fromiter((kv & _MASK64 for kv in kvs), np.uint64, n),
            np.fromiter((kv >> 64 for kv in kvs), np.uint64, n),
            np.fromiter(toks, np.uint64, n),
            np.fromiter(diffs, np.int64, n),
        )
        if consolidate_out:
            nb = nb.consolidate()
            if not len(nb):
                return
        self.emit(time, nb)

    def _emit_tok_arrays(
        self,
        time: int,
        lo, hi, tok, diff,
        consolidate_out: bool = False,
        distinct: bool = False,
    ) -> None:
        """Array twin of _emit_tok: emit (lo, hi, tok, diff) columns as one
        NativeBatch without materializing Python kv ints. `distinct=True`
        asserts the rows are an all-+1 pairwise-distinct insert (e.g. a
        subset of a distinct ingest wave): output consolidation — and
        even the O(n) distinct re-check — is skipped."""
        if len(lo) == 0:
            return
        nb = self._dp.NativeBatch(
            self._tab,
            np.ascontiguousarray(lo, np.uint64),
            np.ascontiguousarray(hi, np.uint64),
            np.ascontiguousarray(tok, np.uint64),
            np.ascontiguousarray(diff, np.int64),
            distinct_hint=distinct,
        )
        if consolidate_out and not distinct and not nb.is_distinct_insert():
            nb = nb.consolidate()
            if not len(nb):
                return
        self.emit(time, nb)

    def _demote_replay(self, lo, hi, tok, diff) -> list[Entry]:
        """Demote with a wave already drained into arrays: decode it to
        object entries (state converts via _demoted_state) so the caller
        can replay it through its object path."""
        tab = self._tab
        tl = tok.tolist()
        dl = diff.tolist()
        entries = [
            (Key(kv), tab.row(tl[i]), dl[i])
            for i, kv in enumerate(_kvs_of(lo, hi))
        ]
        self._demote()
        return entries

    def _requeue(self, raws: list) -> None:
        """Put drained segments back so the object path re-drains them."""
        for i, (batches, entries) in enumerate(raws):
            for b in batches:
                self.accept(i, b)
            if entries:
                self.accept(i, entries)
            self.rows_in -= len(entries) + sum(len(b) for b in batches)

    # ------------------------------------------------ snapshot (object form)

    def persist_state(self) -> dict | None:
        if not self._persist_attrs:
            return None
        if not self._tok:
            return super().persist_state()
        return self._demoted_state()

    def restore_state(self, state: dict) -> None:
        if self._tok and not self._encode_state(state):
            self._demote()
            super().restore_state(state)
            return
        if not self._tok:
            super().restore_state(state)

    # Object-form decode helpers.

    def _rowdict_obj(self, d: dict) -> dict:
        tab = self._tab
        return {Key(kv): tab.row(t) for kv, t in d.items()}

    def _rowdict_tok(self, d: dict) -> dict | None:
        tab = self._tab
        out = {}
        items = d.rows.items() if isinstance(d, KeyedState) else d.items()
        for k, row in items:
            t = tab.intern_row(row)
            if t is None:
                return None
            out[k.value] = t
        return out


def _keyed_state_of(rows: dict) -> KeyedState:
    st = KeyedState()
    st.rows = rows
    return st


class ReindexNode(Node):
    """Assign new keys via fn(key, row) -> new_key (reindex / with_id_from).

    `native_cols` (lowering-gated: PointerExpression over plain
    stably-typed columns of a native-plane input, no instance) keeps the
    wave token-resident: new keys are blake2b-128 of the projected column
    pieces in C (dataplane.cpp dp_rekey — byte-identical to
    key_for_values), so with_id_from no longer forces the object plane.
    Rows whose key columns hold ERROR take the per-row path (the planes'
    ERROR serializations differ by design)."""

    def __init__(
        self,
        graph: Graph,
        inp: Node,
        key_fn: Callable[[Key, tuple], Key],
        native_cols: list[int] | None = None,
        native_key_col: int | None = None,
        native_salt: int | None = None,
    ):
        super().__init__(graph, [inp])
        self.key_fn = key_fn
        self.native_cols = native_cols
        # with_id(<pointer column>): the new key IS the column's key128 —
        # bulk-decoded in C (dp_decode_key_col), rows whose column holds a
        # non-Key value fall back to the exact per-row path
        self.native_key_col = native_key_col
        # concat_reindex's per-input salt: new key = blake(key, salt) in C
        self.native_salt = native_salt

    def _rekey_object(self, entries: list[Entry]) -> list[Entry]:
        out: list[Entry] = []
        for key, row, diff in entries:
            try:
                nk = self.key_fn(key, row)
            except Exception as e:  # noqa: BLE001
                self.log_error(f"reindex: {type(e).__name__}: {e}")
                continue
            out.append((nk, row, diff))
        return out

    def _rekey_batch(self, dp, b):
        """(lo, hi, fallback_mask) for one batch, or None (materialize)."""
        if self.native_salt is not None:
            lo, hi = dp.rekey_salt(b.key_lo, b.key_hi, self.native_salt)
            return lo, hi, np.zeros(len(b), bool)
        if self.native_key_col is not None:
            res = dp.decode_key_col(b.tab, b.token, self.native_key_col)
            if res is None:
                return None
            lo, hi, st = res
            return lo, hi, st != 0
        res = dp.rekey(b.tab, b.token, self.native_cols)
        if res is None:
            return None
        lo, hi = res
        return lo, hi, (lo == 0) & (hi == 0)  # ERROR in key columns

    def finish_time(self, time: int) -> None:
        if (
            self.native_cols is None
            and self.native_key_col is None
            and self.native_salt is None
        ) or _nb_type() is None:
            entries = self.take_input()
            if entries:
                self.emit(time, consolidate(self._rekey_object(entries)))
            return
        from pathway_tpu_torch.engine.native import dataplane as dp

        batches, entries = self.take_segments()
        out_entries = self._rekey_object(entries) if entries else []
        out_batches = []
        for b in batches:
            res = self._rekey_batch(dp, b)
            if res is None:
                out_entries.extend(self._rekey_object(b.materialize()))
                continue
            lo, hi, bad = res
            if bad.any():
                out_entries.extend(self._rekey_object(b.select(bad).materialize()))
                good = ~bad
                b = b.select(good)
                lo, hi = lo[good], hi[good]
            out_batches.append(
                dp.NativeBatch(b.tab, lo, hi, b.token, b.diff)
            )
        _emit_merged(self, time, out_batches, out_entries)


class ConcatNode(Node):
    def __init__(self, graph: Graph, inputs: Sequence[Node]):
        super().__init__(graph, inputs)

    def finish_time(self, time: int) -> None:
        batches: list = []
        entries: list[Entry] = []
        for i in range(len(self.inputs)):
            b, e = self.take_segments(i)
            batches.extend(b)
            entries.extend(e)
        if batches or entries:
            _emit_merged(self, time, batches, entries)


class FlattenNode(Node):
    """Expand a sequence column into child rows, key = hash(parent, i).

    Stateless, so no plane demotion: native batches expand in C
    (dp_flatten, str/bytes columns — the only sequence types the plane
    represents); rows the kernel can't judge take the object path."""

    def __init__(self, graph: Graph, inp: Node, flatten_idx: int):
        super().__init__(graph, [inp])
        self.flatten_idx = flatten_idx

    def finish_time(self, time: int) -> None:
        if _nb_type() is not None:
            from pathway_tpu_torch.engine.native import dataplane as dp

            batches, entries = self.take_segments()
            out_batches = []
            obj: list[Entry] = list(entries)
            for b in batches:
                res = dp.flatten_batch(b.tab, b, self.flatten_idx)
                if res is None:
                    obj.extend(b.materialize())
                    continue
                child, fb = res
                if len(child):
                    out_batches.append(child)
                if fb.any():
                    obj.extend(b.select(fb).materialize())
            out_obj = self._flatten_entries(obj) if obj else []
            _emit_merged(self, time, out_batches, out_obj)
            return
        entries = self.take_input()
        if entries:
            self.emit(time, consolidate(self._flatten_entries(entries)))

    def _flatten_entries(self, entries: list[Entry]) -> list[Entry]:
        out: list[Entry] = []
        for key, row, diff in entries:
            seq = row[self.flatten_idx]
            if seq is None:
                continue
            if isinstance(seq, (str, bytes)):
                items: Iterable[Any] = seq if isinstance(seq, str) else [
                    seq[i : i + 1] for i in range(len(seq))
                ]
            elif isinstance(seq, np.ndarray):
                items = list(seq)
            elif isinstance(seq, (tuple, list)):
                items = seq
            else:
                self.log_error(f"flatten: cannot flatten {type(seq).__name__}")
                continue
            for i, item in enumerate(items):
                new_row = row[: self.flatten_idx] + (item,) + row[self.flatten_idx + 1 :]
                nk = Key(hash_values(key, i))
                out.append((nk, new_row, diff))
        return out


def _tok_update_keyed(state: dict, wave: list) -> None:
    """KeyedState.update, token form: +1 sets, -1 deletes when the stored
    token matches (byte-equality stands in for rows_equal)."""
    for kv, tok, d in wave:
        if d > 0:
            state[kv] = tok
        elif d < 0 and state.get(kv) == tok:
            del state[kv]


def _tok_delta_emit(emitted: dict, kvs, toks, diffs, kv: int, new) -> None:
    old = emitted.get(kv)
    if old is not None and old != new:
        kvs.append(kv)
        toks.append(old)
        diffs.append(-1)
        del emitted[kv]
    if new is not None and old != new:
        kvs.append(kv)
        toks.append(new)
        diffs.append(1)
        emitted[kv] = new


class SetOpNode(_TokTailNode):
    """intersect / difference / restrict on key sets.

    Output rows come from input 0; inputs 1..n contribute key presence.
    mode: 'intersect' | 'difference' | 'restrict'
    Token mode: pure key-level — state is {key128 -> token} / count dicts,
    no row ever decodes (reference: dataflow.rs:1671-1760 runs these on
    arranged keys the same way).
    """

    _persist_attrs = ("main", "others", "emitted")
    _state_routing = {"main": "key", "others": "key", "emitted": "key"}

    def persist_signature(self) -> str:
        return f"SetOpNode/{len(self.inputs)}/{self.mode}"

    def __init__(self, graph: Graph, inputs: Sequence[Node], mode: str):
        super().__init__(graph, inputs)
        self.mode = mode
        if self._tok:
            self.main: Any = {}
            self.others: list[dict] = [{} for _ in range(len(inputs) - 1)]
        else:
            self.main = KeyedState()
            self.others = [defaultdict(int) for _ in range(len(inputs) - 1)]
        self.emitted: dict = {}

    def _demoted_state(self) -> dict:
        return {
            "main": _keyed_state_of(self._rowdict_obj(self.main)),
            "others": [
                defaultdict(int, {Key(kv): c for kv, c in o.items()})
                for o in self.others
            ],
            "emitted": self._rowdict_obj(self.emitted),
        }

    def _encode_state(self, st: dict) -> bool:
        main = self._rowdict_tok(st["main"])
        emitted = self._rowdict_tok(st["emitted"])
        if main is None or emitted is None:
            return False
        self.main = main
        self.emitted = emitted
        self.others = [
            {k.value: c for k, c in o.items()} for o in st["others"]
        ]
        return True

    def _present(self, key) -> bool:
        if self.mode == "intersect" or self.mode == "restrict":
            return all(o.get(key, 0) > 0 for o in self.others)
        if self.mode == "difference":
            return self.others[0].get(key, 0) <= 0
        raise AssertionError(self.mode)

    def finish_time(self, time: int) -> None:
        waves, obj = self._drain_waves(time)
        if waves is not None:
            affected = dict.fromkeys(kv for kv, _t, _d in waves[0])
            for i, w in enumerate(waves[1:]):
                o = self.others[i]
                for kv, _t, d in w:
                    c = o.get(kv, 0) + d
                    if c == 0:
                        o.pop(kv, None)
                    else:
                        o[kv] = c
                    affected[kv] = None
            _tok_update_keyed(self.main, waves[0])
            kvs: list = []
            toks: list = []
            diffs: list = []
            for kv in affected:
                tok = self.main.get(kv)
                new = tok if tok is not None and self._present(kv) else None
                _tok_delta_emit(self.emitted, kvs, toks, diffs, kv, new)
            self._emit_tok(time, kvs, toks, diffs)
            return
        main_batch = obj[0]
        affected_o: dict[Key, None] = {k: None for k, _, _ in main_batch}
        for i in range(1, len(self.inputs)):
            for key, _row, diff in obj[i]:
                self.others[i - 1][key] += diff
                affected_o[key] = None
        self.main.update(main_batch)
        out: list[Entry] = []
        for key in affected_o:
            row = self.main.get(key)
            present = row is not None and self._present(key)
            delta_emit(self.emitted, out, key, row if present else None)
        self.emit(time, out)


class UpdateRowsNode(_TokTailNode):
    """union with right-priority (reference: update_rows dataflow.rs).
    Token mode: key-level only; row tokens pass through undecoded."""

    _persist_attrs = ("left", "right", "emitted")
    _state_routing = {"left": "key", "right": "key", "emitted": "key"}

    def __init__(self, graph: Graph, left: Node, right: Node):
        super().__init__(graph, [left, right])
        if self._tok:
            self.left: Any = {}
            self.right: Any = {}
        else:
            self.left = KeyedState()
            self.right = KeyedState()
        self.emitted: dict = {}

    def _demoted_state(self) -> dict:
        return {
            "left": _keyed_state_of(self._rowdict_obj(self.left)),
            "right": _keyed_state_of(self._rowdict_obj(self.right)),
            "emitted": self._rowdict_obj(self.emitted),
        }

    def _encode_state(self, st: dict) -> bool:
        left = self._rowdict_tok(st["left"])
        right = self._rowdict_tok(st["right"])
        emitted = self._rowdict_tok(st["emitted"])
        if left is None or right is None or emitted is None:
            return False
        self.left, self.right, self.emitted = left, right, emitted
        return True

    def finish_time(self, time: int) -> None:
        waves, obj = self._drain_waves(time)
        if waves is not None:
            lw, rw = waves
            if not lw and not rw:
                return
            affected = dict.fromkeys(kv for kv, _t, _d in lw)
            affected.update(dict.fromkeys(kv for kv, _t, _d in rw))
            _tok_update_keyed(self.left, lw)
            _tok_update_keyed(self.right, rw)
            kvs: list = []
            toks: list = []
            diffs: list = []
            for kv in affected:
                new = self.right.get(kv)
                if new is None:
                    new = self.left.get(kv)
                _tok_delta_emit(self.emitted, kvs, toks, diffs, kv, new)
            self._emit_tok(time, kvs, toks, diffs)
            return
        lb, rb = obj
        if not lb and not rb:
            return
        affected_o = {k: None for k, _, _ in lb}
        affected_o.update({k: None for k, _, _ in rb})
        self.left.update(lb)
        self.right.update(rb)
        out: list[Entry] = []
        for key in affected_o:
            new = self.right.get(key)
            if new is None:
                new = self.left.get(key)
            delta_emit(self.emitted, out, key, new)
        self.emit(time, out)


class UpdateCellsNode(_TokTailNode):
    """Override selected columns where the right table has the key.
    Token mode: merged rows splice in C (dp_splice_cols), batched per
    wave over the affected keys."""

    _persist_attrs = ("left", "right", "emitted")
    _state_routing = {"left": "key", "right": "key", "emitted": "key"}

    def persist_signature(self) -> str:
        return f"UpdateCellsNode/{self.col_map}"

    def __init__(self, graph: Graph, left: Node, right: Node, col_map: list[int | None]):
        # col_map[i] = index into right row overriding left col i, or None
        super().__init__(graph, [left, right])
        self.col_map = col_map
        self._splice_specs = [
            (0, i) if m is None else (1, m) for i, m in enumerate(col_map)
        ]
        if self._tok:
            self.left: Any = {}
            self.right: Any = {}
        else:
            self.left = KeyedState()
            self.right = KeyedState()
        self.emitted: dict = {}

    _demoted_state = UpdateRowsNode._demoted_state
    _encode_state = UpdateRowsNode._encode_state

    def finish_time(self, time: int) -> None:
        waves, obj = self._drain_waves(time)
        if waves is not None:
            lw, rw = waves
            if not lw and not rw:
                return
            affected = dict.fromkeys(kv for kv, _t, _d in lw)
            affected.update(dict.fromkeys(kv for kv, _t, _d in rw))
            _tok_update_keyed(self.left, lw)
            _tok_update_keyed(self.right, rw)
            # pass 1: plan — gone (0) / passthrough tok (1) / splice slot (2)
            plan: list[tuple[int, int, int]] = []
            sl: list[int] = []
            sr: list[int] = []
            for kv in affected:
                ltok = self.left.get(kv)
                if ltok is None:
                    plan.append((kv, 0, 0))
                    continue
                rtok = self.right.get(kv)
                if rtok is None:
                    plan.append((kv, 1, ltok))
                else:
                    plan.append((kv, 2, len(sl)))
                    sl.append(ltok)
                    sr.append(rtok)
            merged: list = []
            if sl:
                res = self._dp.splice_cols(
                    self._tab,
                    [
                        np.fromiter(sl, np.uint64, len(sl)),
                        np.fromiter(sr, np.uint64, len(sr)),
                    ],
                    self._splice_specs,
                )
                if res is None:  # malformed token — cannot happen for
                    self._demote()  # plane-built rows; object fallback
                    self._emit_cells_object(time, [Key(kv) for kv in affected])
                    return
                merged = res.tolist()
            kvs: list = []
            toks: list = []
            diffs: list = []
            for kv, kind, v in plan:
                new = None if kind == 0 else (v if kind == 1 else merged[v])
                _tok_delta_emit(self.emitted, kvs, toks, diffs, kv, new)
            self._emit_tok(time, kvs, toks, diffs)
            return
        lb, rb = obj
        if not lb and not rb:
            return
        affected_o = {k: None for k, _, _ in lb}
        affected_o.update({k: None for k, _, _ in rb})
        self.left.update(lb)
        self.right.update(rb)
        self._emit_cells_object(time, affected_o)

    def _emit_cells_object(self, time: int, affected) -> None:
        out: list[Entry] = []
        for key in affected:
            lrow = self.left.get(key)
            new = None
            if lrow is not None:
                rrow = self.right.get(key)
                if rrow is None:
                    new = lrow
                else:
                    new = tuple(
                        rrow[m] if m is not None else lrow[i]
                        for i, m in enumerate(self.col_map)
                    )
            delta_emit(self.emitted, out, key, new)
        self.emit(time, out)


class JoinNode(Node):
    """Incremental equi-join with inner/left/right/outer modes.

    Reference: join_tables (dataflow.rs:2270). State: both sides arranged by
    join key. Delta rule: d(L ⋈ R) = dL ⋈ R_old + L_new ⋈ dR.
    Output key assignment: 'hash' (new key from (lkey, rkey)), 'left', 'right'.
    """

    _persist_attrs = ("left_state", "right_state")
    _state_routing = {"left_state": "token", "right_state": "token"}

    def persist_signature(self) -> str:
        return (
            f"JoinNode/{self.mode}/{self.id_mode}/{self.left_width}"
            f"/{self.right_width}/{int(self.asof_now)}"
            f"/native={int(getattr(self, '_plan', None) is not None)}"
            f"/emit={getattr(self, 'emit_cols', None)}"
        )

    def merge_shard_states(self, states: list[dict]) -> dict:
        if any(
            st.get(k) is not None for st in states
            for k in ("spill", "spill_left", "spill_right")
        ):
            # spilled arrangements rescale as METADATA: pop the run
            # manifests, merge the resident tails normally, then fold the
            # manifests (spill.merge_manifests — run files stay in place)
            from pathway_tpu_torch.engine import spill as _spill

            stripped = [
                {
                    k: v for k, v in st.items()
                    if k not in ("spill", "spill_left", "spill_right")
                }
                for st in states
            ]
            merged = self.merge_shard_states(stripped)
            for key in ("spill_left", "spill_right"):
                mans = [st[key] for st in states if st.get(key) is not None]
                if mans:
                    merged[key] = _spill.merge_manifests(mans)
            if any(st.get("spill") is not None for st in states):
                per_side = []
                for side in range(2):
                    mans = [
                        st["spill"][side] for st in states
                        if st.get("spill") is not None
                        and st["spill"][side] is not None
                    ]
                    per_side.append(
                        _spill.merge_manifests(mans) if mans else None
                    )
                merged["spill"] = per_side
            return merged
        if not states or "njoin" not in states[0]:
            return super().merge_shard_states(states)
        # native arrangements: concat the flat arrays; intern ids are
        # consistent across shards (one process-wide table wrote them),
        # so the byte maps union without renumbering
        merged = []
        for side in range(2):
            exps = [st["njoin"][side] for st in states]
            jk_bytes: dict = {}
            tok_bytes: dict = {}
            for e in exps:
                jk_bytes.update(e["jk_bytes"])
                tok_bytes.update(e["tok_bytes"])
            merged.append({
                "jk": np.concatenate([e["jk"] for e in exps]),
                "klo": np.concatenate([e["klo"] for e in exps]),
                "khi": np.concatenate([e["khi"] for e in exps]),
                "tok": np.concatenate([e["tok"] for e in exps]),
                "cnt": np.concatenate([e["cnt"] for e in exps]),
                "jk_bytes": jk_bytes,
                "tok_bytes": tok_bytes,
            })
        return {"njoin": merged}

    def split_shard_state(self, merged: dict, n: int, shard_of) -> list[dict]:
        if any(
            merged.get(k) is not None
            for k in ("spill", "spill_left", "spill_right")
        ):
            # metadata split: every shard inherits the full run list as
            # shared runs (exchange routing keeps probes owner-only)
            from pathway_tpu_torch.engine import spill as _spill

            rest = {
                k: v for k, v in merged.items()
                if k not in ("spill", "spill_left", "spill_right")
            }
            outs = self.split_shard_state(rest, n, shard_of)
            for key in ("spill_left", "spill_right"):
                man = merged.get(key)
                if man is not None:
                    for s, part in enumerate(_spill.split_manifest(man, n)):
                        outs[s][key] = part
            if merged.get("spill") is not None:
                per_side = [
                    _spill.split_manifest(m, n) if m is not None else None
                    for m in merged["spill"]
                ]
                for s in range(n):
                    outs[s]["spill"] = [
                        ps[s] if ps is not None else None for ps in per_side
                    ]
            return outs
        if "njoin" not in merged:
            return super().split_shard_state(merged, n, shard_of)
        # shard of a jk = shard of its VALUE tuple: decode the canonical
        # bytes back to values and route through the same _shard_of the
        # live exchange uses (byte-identical to the C group route)
        from pathway_tpu_torch.engine.native import dataplane as _dp

        outs: list[dict] = [{"njoin": [None, None]} for _ in range(n)]
        for side in range(2):
            exp = merged["njoin"][side]
            jk = exp["jk"]
            # vectorized: decode each UNIQUE jk once, scatter via inverse
            uniq, inverse = (
                np.unique(jk, return_inverse=True)
                if len(jk)
                else (np.empty(0, np.uint64), np.empty(0, np.intp))
            )
            uniq_shard = np.array(
                [
                    shard_of(_dp.decode_row(exp["jk_bytes"][int(t)]))
                    for t in uniq
                ],
                dtype=np.int64,
            )
            shards = (
                uniq_shard[inverse] if len(jk) else np.empty(0, np.int64)
            )
            for s in range(n):
                sel = shards == s
                sub_jk = exp["jk"][sel]
                sub_tok = exp["tok"][sel]
                outs[s]["njoin"][side] = {
                    "jk": sub_jk,
                    "klo": exp["klo"][sel],
                    "khi": exp["khi"][sel],
                    "tok": sub_tok,
                    "cnt": exp["cnt"][sel],
                    "jk_bytes": {
                        int(t): exp["jk_bytes"][int(t)]
                        for t in np.unique(sub_jk)
                    },
                    "tok_bytes": {
                        int(t): exp["tok_bytes"][int(t)]
                        for t in np.unique(sub_tok)
                    },
                }
        return outs

    def persist_state(self) -> dict:
        if self._plan is None:
            st = super().persist_state()
            for side, key in ((0, "spill_left"), (1, "spill_right")):
                store = self._spill_js[side]
                if store is not None and store.has_runs:
                    st[key] = store.manifest()
            return st
        st = {"njoin": [self._export_arr(a) for a in self._arrs]}
        spills = [
            (s.manifest() if s is not None and s.has_runs else None)
            for s in self._spill_n
        ]
        if any(m is not None for m in spills):
            st["spill"] = spills
        return st

    def restore_state(self, st: dict) -> None:
        from pathway_tpu_torch.engine import spill as _spill

        if ("njoin" in st) != (self._plan is not None):
            raise RuntimeError(
                "join snapshot was taken with a different native-kernel "
                "setting; cannot restore operator state"
            )
        if self._plan is None:
            st = dict(st)
            manifests = (st.pop("spill_left", None), st.pop("spill_right", None))
            super().restore_state(st)
            for side, man in enumerate(manifests):
                if man is not None:
                    self._spill_attach_py(side, _spill.attach_store(man))
                    _spill_check_strict(
                        self._spill_js[side], f"join n{self.node_id}"
                    )
            return
        for arr, dump in zip(self._arrs, st["njoin"]):
            self._import_arr(arr, dump)
        for side, man in enumerate(st.get("spill") or []):
            if man is not None:
                self._spill_adopt_native(side, _spill.attach_store(man))
                _spill_check_strict(
                    self._spill_n[side], f"join n{self.node_id}"
                )

    def _export_arr(self, arr) -> dict:
        """Intern ids are run-local: snapshot canonical BYTES per unique
        jk/row token (re-interned on restore)."""
        jk, klo, khi, tok, cnt = arr.export_state()
        ujk = {int(t): self._tab.get_bytes(int(t)) for t in set(jk.tolist())}
        utok = {int(t): self._tab.get_bytes(int(t)) for t in set(tok.tolist())}
        return {
            "jk": jk, "klo": klo, "khi": khi, "tok": tok, "cnt": cnt,
            "jk_bytes": ujk, "tok_bytes": utok,
        }

    def _import_arr(self, arr, dump: dict) -> None:
        jk_map = {
            old: self._tab.intern(b) for old, b in dump["jk_bytes"].items()
        }
        tok_map = {
            old: self._tab.intern(b) for old, b in dump["tok_bytes"].items()
        }
        jk = np.array([jk_map[int(t)] for t in dump["jk"]], np.uint64)
        tok = np.array([tok_map[int(t)] for t in dump["tok"]], np.uint64)
        arr.update(jk, dump["klo"], dump["khi"], tok, dump["cnt"])

    # ---- out-of-core spill tier (engine/spill.py) --------------------
    # Exclusive residency: a join key's rows live EITHER in the resident
    # arrangement (tail) or in exactly one sealed run on disk. Any touch
    # promotes the group back into the tail before the wave reads it, so
    # the dataflow is byte-identical to the all-resident run.

    def spill_stores(self) -> list:
        """Active spill stores (verifier contract surface)."""
        return [s for s in (*self._spill_js, *self._spill_n) if s is not None]

    def _spill_attach_py(self, side: int, store) -> None:
        from pathway_tpu_torch.persistence import codec as _codec

        st = self.left_state if side == 0 else self.right_state
        self._spill_js[side] = store
        st.spill_attach(store, lambda dkey, _s=side: self._spill_resolve_py(_s, dkey))
        store.tail_keys = lambda _st=st: (
            _codec.encode_value(k) for k in _st.groups
        )

    def _spill_resolve_py(self, side: int, dkey) -> None:
        """Promote one spilled group into the resident tail (miss hook)."""
        from pathway_tpu_torch.persistence import codec as _codec

        store = self._spill_js[side]
        if store is None:
            return
        raw = store.take(_codec.encode_value(dkey))
        if raw is None:
            return
        st = self.left_state if side == 0 else self.right_state
        entries = _codec.decode_value(raw)
        st.groups[dkey] = {
            freeze_value(p): (p, c) for p, c in entries
        }

    def _maybe_spill_py(self) -> None:
        from pathway_tpu_torch.engine import spill as _spill
        from pathway_tpu_torch.persistence import codec as _codec

        if not _spill.enabled():
            return
        budget = _spill.default_budget()
        pack = lambda dkey, group: _codec.encode_value(tuple(group.values()))  # noqa: E731
        for side, st in ((0, self.left_state), (1, self.right_state)):
            if self._spill_js[side] is None:
                if len(st.groups) <= budget:
                    continue
                label = f"n{self.node_id}-{'left' if side == 0 else 'right'}"
                self._spill_attach_py(side, _spill.store_for(label))
            _spill_evict_multiset(st, self._spill_js[side], pack)

    # Native plane: the C arrangement has no miss hook, so promotion is
    # eager — before a wave probes/updates, every spilled group whose jk
    # appears in the wave is re-inserted (dj_update) in original
    # insertion order. jk/row tokens are run-local intern ids; payloads
    # therefore carry canonical BYTES, re-interned on promote.

    def _spill_adopt_native(self, side: int, store) -> None:
        self._spill_n[side] = store
        arr = self._arrs[side]
        store.tail_keys = lambda _a=arr: (
            self._tab.get_bytes(int(jk)) for jk in _a.group_sizes()[0]
        )

    def _spill_store_native(self, side: int):
        from pathway_tpu_torch.engine import spill as _spill

        if self._spill_n[side] is None:
            label = f"n{self.node_id}-{'jl' if side == 0 else 'jr'}"
            self._spill_adopt_native(side, _spill.store_for(label))
        return self._spill_n[side]

    def _spill_promote_native(self, lw, rw) -> None:
        from pathway_tpu_torch.persistence import codec as _codec

        jks: set[int] = set()
        if lw is not None:
            jks.update(int(t) for t in set(lw[4].tolist()))
        if rw is not None:
            jks.update(int(t) for t in set(rw[4].tolist()))
        for side in range(2):
            store = self._spill_n[side]
            rec = self._spill_rec[side]
            arr = self._arrs[side]
            for jk_t in jks:
                self._spill_seq += 1
                rec[jk_t] = self._spill_seq
                if store is None or not store.has_runs:
                    continue
                raw = store.take(self._tab.get_bytes(jk_t))
                if raw is None:
                    continue
                klo_b, khi_b, cnt_b, row_bytes = _codec.decode_value(raw)
                klo = np.frombuffer(klo_b, np.uint64)
                khi = np.frombuffer(khi_b, np.uint64)
                cnt = np.frombuffer(cnt_b, np.int64)
                tok = np.array(
                    [self._tab.intern(b) for b in row_bytes], np.uint64
                )
                arr.update(
                    np.full(len(cnt), jk_t, np.uint64), klo, khi, tok, cnt
                )

    def _spill_native_evict(self) -> None:
        from pathway_tpu_torch.engine import spill as _spill
        from pathway_tpu_torch.persistence import codec as _codec

        if not _spill.enabled():
            return
        budget = _spill.default_budget()
        for side in range(2):
            arr = self._arrs[side]
            jk_live, nrows = arr.group_sizes()
            if len(jk_live) <= budget and self._spill_n[side] is None:
                continue
            store = self._spill_store_native(side)
            if len(jk_live) <= store.budget:
                continue
            target = int(store.budget * 0.75)
            rec = self._spill_rec[side]
            order = sorted(
                jk_live.tolist(), key=lambda t: rec.get(int(t), 0)
            )
            items = []
            for jk_t in order[: len(jk_live) - target]:
                jk_t = int(jk_t)
                res = arr.evict_group(jk_t)
                if res is None:
                    continue
                klo, khi, tok, cnt = res
                rec.pop(jk_t, None)
                payload = _codec.encode_value((
                    klo.tobytes(), khi.tobytes(), cnt.tobytes(),
                    [self._tab.get_bytes(int(t)) for t in tok],
                ))
                items.append((self._tab.get_bytes(jk_t), payload))
            if items:
                store.seal(items)

    _ID_MODES = {"hash": 0, "left": 1, "right": 2, "cheap": 3}

    def __init__(
        self,
        graph: Graph,
        left: Node,
        right: Node,
        left_jk: Callable[[Key, tuple], Any],
        right_jk: Callable[[Key, tuple], Any],
        mode: str = "inner",
        id_mode: str = "hash",
        left_width: int = 0,
        right_width: int = 0,
        exact_match: bool = False,
        asof_now: bool = False,
        native_plan: dict | None = None,
        emit_cols: list[int] | None = None,
    ):
        super().__init__(graph, [left, right])
        self.left_jk = left_jk
        self.right_jk = right_jk
        self.mode = mode
        self.id_mode = id_mode
        self.left_width = left_width
        self.right_width = right_width
        # projection pushdown (lowering-gated): the post-join select's
        # column picks fuse into the C row emission — indexes into the
        # virtual (lkey, rkey, *lrow, *rrow) joined row
        self.emit_cols = emit_cols
        self.left_state = MultisetState()
        self.right_state = MultisetState()
        # out-of-core tier (engine/spill.py): per-side stores, created
        # lazily when an arrangement first exceeds the resident budget
        self._spill_js: list = [None, None]   # python-plane MultisetStates
        self._spill_n: list = [None, None]    # native NativeJoinArrs
        self._spill_rec: tuple = ({}, {})     # native jk-token recency
        self._spill_seq = 0
        # asof_now: left deltas join the right side's state as of their
        # arrival; right-side changes never retro-update results
        # (reference: asof_now joins / use_external_index_as_of_now)
        self.asof_now = asof_now
        # Token-resident inner join (lowering-gated: mode inner, plain
        # stably-typed join-key columns on native-plane sides): both
        # arrangements live in C (dataplane.cpp dj_*), the delta rule
        # dL ⋈ R_old + L_new ⋈ dR probes flat ids, and output rows
        # assemble in C — the VERDICT r2 "arrange/delta-join in the hot
        # loop" path. Reference: dataflow.rs:2270 over differential join.
        self._plan = None
        if native_plan is not None and _nb_type() is not None:
            from pathway_tpu_torch.engine.native import dataplane as _dp

            self._plan = native_plan
            self._dp = _dp
            self._tab = _dp.default_table()
            self._arrs = (_dp.NativeJoinArr(), _dp.NativeJoinArr())
        self._sketch_cache = {
            "left": {"distinct_jk": 0}, "right": {"distinct_jk": 0},
        }
        if id_mode == "cheap":
            # bound once: a per-emitted-row import lookup would hand back
            # a slice of the very nanoseconds id elision exists to save
            from pathway_tpu_torch.internals.keys import cheap_join_key

            self._cheap_join_key = cheap_join_key

    def sketch(self) -> dict:
        """Incremental cardinality sketch of both arrangements (distinct
        join keys held) — the planner's runtime signal for join
        orientation costing (/statistics surfaces it per join node).
        Served from a snapshot the PUMP thread refreshes after each
        wave: the scrape thread must never walk the live C arrangement
        (dj_len iterates a map a concurrent dj_update may rehash)."""
        return self._sketch_cache

    def _refresh_sketch(self) -> None:
        if self._plan is not None:
            self._sketch_cache = {
                "left": {"distinct_jk": len(self._arrs[0])},
                "right": {"distinct_jk": len(self._arrs[1])},
            }
        else:
            self._sketch_cache = {
                "left": {"distinct_jk": len(self.left_state.groups)},
                "right": {"distinct_jk": len(self.right_state.groups)},
            }

    def _jk_of(self, side: int, key: Key, row: tuple) -> Any:
        fn = self.left_jk if side == 0 else self.right_jk
        try:
            jk = fn(key, row)
        except Exception as e:  # noqa: BLE001
            self.log_error(f"join key: {type(e).__name__}: {e}")
            return None
        if isinstance(jk, ErrorValue) or (isinstance(jk, tuple) and any(isinstance(x, ErrorValue) for x in jk)):
            return None
        return freeze_value(jk)

    def _out_entry(self, lkey, lrow, rkey, rrow, diff) -> Entry:
        if lrow is None:
            lrow = (None,) * self.left_width
        if rrow is None:
            rrow = (None,) * self.right_width
        if self.id_mode == "left" and lkey is not None:
            key = lkey
        elif self.id_mode == "right" and rkey is not None:
            key = rkey
        elif (
            self.id_mode == "cheap" and lkey is not None and rkey is not None
        ):
            # plan-gated id elision (inner joins whose output ids are
            # provably unobservable): SplitMix pair mix instead of blake
            key = self._cheap_join_key(lkey, rkey)
        else:
            key = Key(hash_values(lkey, rkey))
        # output rows carry both side keys so pw.left.id / pw.right.id resolve
        return (key, (lkey, rkey) + tuple(lrow) + tuple(rrow), diff)

    def _wave_arrays(self, side: int):
        """One side's wave as flat arrays (lo, hi, tok, diff, jk) — native
        batches concatenate; object-plane rows intern individually (rows
        that cannot enter the plane, e.g. ERROR payloads, are logged and
        skipped). Returns None for an empty wave."""
        batches, entries = self.take_segments(side)
        parts = []
        nb_t = _nb_type()
        if batches:
            b = batches[0] if len(batches) == 1 else nb_t.concat(batches)
            parts.append((b.key_lo, b.key_hi, b.token, b.diff))
        if entries:
            lo = np.empty(len(entries), np.uint64)
            hi = np.empty(len(entries), np.uint64)
            tok = np.empty(len(entries), np.uint64)
            diff = np.empty(len(entries), np.int64)
            keep = 0
            for key, row, d in entries:
                t = self._tab.intern_row(row)
                if t is None:
                    self.log_error(
                        "join: row not representable in the native plane; "
                        "skipped"
                    )
                    continue
                hi[keep], lo[keep] = key.to_hi_lo()
                tok[keep] = t
                diff[keep] = d
                keep += 1
            if keep:
                parts.append((lo[:keep], hi[:keep], tok[:keep], diff[:keep]))
        if not parts:
            return None
        if len(parts) == 1:
            lo, hi, tok, diff = parts[0]  # no-copy fast path (common wave)
        else:
            lo = np.concatenate([p[0] for p in parts])
            hi = np.concatenate([p[1] for p in parts])
            tok = np.concatenate([p[2] for p in parts])
            diff = np.concatenate([p[3] for p in parts])
        cols = self._plan["l_cols" if side == 0 else "r_cols"]
        # forbid_error: ERROR join keys drop, like the object plane's
        # _jk_of (rows with ERROR in PAYLOAD columns join normally)
        res = self._dp.project_group(self._tab, tok, cols, forbid_error=True)
        if res is None:
            self.log_error("join: malformed native rows; wave skipped")
            return None
        jk = res[0]
        ok = jk != 0
        if not ok.all():
            self.log_error(
                f"join: {int((~ok).sum())} row(s) with Error join keys skipped"
            )
            lo, hi, tok, diff, jk = lo[ok], hi[ok], tok[ok], diff[ok], jk[ok]
            if not len(jk):
                return None
        return lo, hi, tok, diff, jk

    def _emit_matches(self, time, l_arrs, r_arrs, diffs) -> None:
        if len(diffs) == 0:
            return
        res = self._dp.join_rows(
            self._tab, *l_arrs, *r_arrs,
            id_mode=self._ID_MODES.get(self.id_mode, 0),
            out_cols=self.emit_cols,
            l_width=self.left_width,
        )
        if res is None:
            self.log_error("join: malformed row token in match set")
            return
        out_lo, out_hi, out_tok = res
        keep = diffs != 0
        if keep.all():  # no zero-product matches: skip the subset copies
            self.emit(
                time,
                self._dp.NativeBatch(
                    self._tab, out_lo, out_hi, out_tok,
                    np.ascontiguousarray(diffs),
                ),
            )
            return
        self.emit(
            time,
            self._dp.NativeBatch(
                self._tab,
                np.ascontiguousarray(out_lo[keep]),
                np.ascontiguousarray(out_hi[keep]),
                np.ascontiguousarray(out_tok[keep]),
                np.ascontiguousarray(diffs[keep]),
            ),
        )

    def _finish_native(self, time: int) -> None:
        lw = self._wave_arrays(0)
        rw = self._wave_arrays(1)
        l_arr, r_arr = self._arrs
        if lw is not None or rw is not None:
            from pathway_tpu_torch.engine import spill as _spill

            if _spill.enabled():
                # promote every spilled group this wave touches BEFORE
                # any probe/update: the probe ladder must see the full
                # arrangement or match counts would silently drop
                self._spill_promote_native(lw, rw)
        if lw is not None:
            lo, hi, tok, diff, jk = lw
            idx, klo, khi, ktok, cnt = r_arr.probe(jk)  # dL ⋈ R_old
            self._emit_matches(
                time,
                (lo[idx], hi[idx], tok[idx]),
                (klo, khi, ktok),
                diff[idx] * cnt,
            )
            l_arr.update(jk, lo, hi, tok, diff)
        if rw is not None:
            lo, hi, tok, diff, jk = rw
            idx, klo, khi, ktok, cnt = l_arr.probe(jk)  # L_new ⋈ dR
            self._emit_matches(
                time,
                (klo, khi, ktok),
                (lo[idx], hi[idx], tok[idx]),
                cnt * diff[idx],
            )
            r_arr.update(jk, lo, hi, tok, diff)
        if lw is not None or rw is not None:
            from pathway_tpu_torch.engine import spill as _spill

            if _spill.enabled():
                self._spill_native_evict()
            self._refresh_sketch()

    def finish_time(self, time: int) -> None:
        if self._plan is not None:
            self._finish_native(time)
            return
        lb = self.take_input(0)
        rb = self.take_input(1)
        if not lb and not rb:
            return
        ldelta: dict[Any, list[tuple[tuple[Key, tuple], int]]] = defaultdict(list)
        rdelta: dict[Any, list[tuple[tuple[Key, tuple], int]]] = defaultdict(list)
        for key, row, diff in lb:
            jk = self._jk_of(0, key, row)
            if jk is not None:
                ldelta[jk].append(((key, row), diff))
        for key, row, diff in rb:
            jk = self._jk_of(1, key, row)
            if jk is not None:
                rdelta[jk].append(((key, row), diff))

        out: list[Entry] = []
        outer = self.mode in ("left", "outer", "full")
        router = self.mode in ("right", "outer", "full") and not self.asof_now

        # For outer modes, snapshot match counts before applying deltas.
        def rcount(jk: Any) -> int:
            return sum(c for _, c in self.right_state.get(jk))

        def lcount(jk: Any) -> int:
            return sum(c for _, c in self.left_state.get(jk))

        pre_r = {jk: rcount(jk) for jk in set(ldelta) | set(rdelta)} if outer else {}
        pre_l = {jk: lcount(jk) for jk in set(ldelta) | set(rdelta)} if router else {}

        # asof_now: right delta applies BEFORE left delta joins, and right
        # changes never join existing left state
        if self.asof_now:
            for jk, drs in rdelta.items():
                for payload, dc in drs:
                    self.right_state.update_one(jk, payload, dc)
            for jk, dls in ldelta.items():
                rmatches = self.right_state.get(jk)
                for (lkey, lrow), dc in dls:
                    for (rkey, rrow), rc in rmatches:
                        out.append(self._out_entry(lkey, lrow, rkey, rrow, dc * rc))
                    if not rmatches and self.mode in ("left", "outer", "full"):
                        out.append(self._out_entry(lkey, lrow, None, None, dc))
            self.emit(time, consolidate(out))
            self._maybe_spill_py()
            self._refresh_sketch()
            return
        # dL ⋈ R_old
        for jk, dls in ldelta.items():
            rmatches = self.right_state.get(jk)
            for (lkey, lrow), dc in dls:
                for (rkey, rrow), rc in rmatches:
                    out.append(self._out_entry(lkey, lrow, rkey, rrow, dc * rc))
        # apply left delta
        for jk, dls in ldelta.items():
            for payload, dc in dls:
                self.left_state.update_one(jk, payload, dc)
        # L_new ⋈ dR
        for jk, drs in rdelta.items():
            lmatches = self.left_state.get(jk)
            for (rkey, rrow), dc in drs:
                for (lkey, lrow), lc in lmatches:
                    out.append(self._out_entry(lkey, lrow, rkey, rrow, lc * dc))
        for jk, drs in rdelta.items():
            for payload, dc in drs:
                self.right_state.update_one(jk, payload, dc)

        # Outer padding via antijoin transitions.
        if outer:
            for jk in set(ldelta) | set(rdelta):
                before, after = pre_r.get(jk, 0), rcount(jk)
                # left rows present before/after this wave
                if before == 0 or after == 0:
                    lrows_now = self.left_state.get(jk)
                    lrows_before = _rollback(lrows_now, ldelta.get(jk, []))
                    if before == 0:
                        for (lkey, lrow), c in lrows_before:
                            out.append(self._out_entry(lkey, lrow, None, None, -c))
                    if after == 0:
                        for (lkey, lrow), c in lrows_now:
                            out.append(self._out_entry(lkey, lrow, None, None, c))
                else:
                    # matched throughout; pad only the delta if no matches at all
                    pass
        if router:
            for jk in set(ldelta) | set(rdelta):
                before, after = pre_l.get(jk, 0), lcount(jk)
                if before == 0 or after == 0:
                    rrows_now = self.right_state.get(jk)
                    rrows_before = _rollback(rrows_now, rdelta.get(jk, []))
                    if before == 0:
                        for (rkey, rrow), c in rrows_before:
                            out.append(self._out_entry(None, None, rkey, rrow, -c))
                    if after == 0:
                        for (rkey, rrow), c in rrows_now:
                            out.append(self._out_entry(None, None, rkey, rrow, c))
        self.emit(time, consolidate(out))
        self._maybe_spill_py()
        self._refresh_sketch()


def _rollback(
    now: list[tuple[Any, int]], delta: list[tuple[Any, int]]
) -> list[tuple[Any, int]]:
    """Reconstruct a multiset state before a delta was applied."""
    acc: dict[Any, tuple[Any, int]] = {}
    for payload, c in now:
        acc[freeze_value(payload)] = (payload, c)
    for payload, dc in delta:
        token = freeze_value(payload)
        cur = acc.get(token)
        nc = (cur[1] if cur else 0) - dc
        if nc == 0:
            acc.pop(token, None)
        else:
            acc[token] = (payload, nc)
    return list(acc.values())


class GroupByNode(Node):
    """Incremental groupby + reduce (reference: group_by_table dataflow.rs:2991).

    gk_fn(key, row) -> (group_values_tuple, group_key:Key)
    arg_fns: per reducer, fn(key, row, time) -> args tuple
    Output row = group_values_tuple + (reduced values...).
    """

    _NATIVE_KINDS = {"count": 0, "sum": 1, "avg": 2}

    def __init__(
        self,
        graph: Graph,
        inp: Node,
        gk_fn: Callable,
        reducers: list[Any],
        arg_fns: list[Callable],
        set_id: bool = False,
        native_ok: bool = True,
        native_plan: dict | None = None,
    ):
        super().__init__(graph, [inp])
        self.gk_fn = gk_fn
        self.reducers = reducers
        self.arg_fns = arg_fns
        self.emitted: dict[Key, tuple] = {}
        # Native semigroup hot path (C++ zs_agg): all-invertible reducer
        # sets are delta-aggregated in O(batch) without maintaining the
        # per-group multiset in Python. `native_ok=False` forces the
        # Python path when argument dtypes aren't provably scalar numeric
        # (lowering decides; ndarray sums etc. need the generic reducers).
        # Reference: semigroup reducer dispatch, src/engine/reduce.rs:40
        # + dataflow.rs:2715.
        #
        # `native_plan` (lowering-provided) additionally enables the
        # token-resident batch path: {"gb_cols": [col indices]} plus
        # "arg_plans": per reducer None (count) | ("col", idx) |
        # ("numpy", NumpyPlan). With a plan, group tokens are intern ids
        # of the projected group bytes (dataplane), shared between whole-
        # batch C processing and the per-row fallback, so mixed waves
        # aggregate into one state.
        self._native = None
        self._plan = None
        if native_ok and all(
            type(r).__name__ in ("CountReducer", "SumReducer", "AvgReducer")
            for r in reducers
        ):
            from pathway_tpu_torch.engine import native as _nat

            if _nat.available():
                self._native = _nat.NativeGroupAgg(
                    [self._NATIVE_KINDS[r.name] for r in reducers]
                )
                self._gid_by_token: dict[Any, int] = {}
                self._ginfo: list[tuple[Key, tuple]] = []
                if native_plan is not None and _nb_type() is not None:
                    self._plan = native_plan
                    from pathway_tpu_torch.engine.native import dataplane as _dp

                    self._dp = _dp
                    self._tab = _dp.default_table()
                    # gtoken -> (Key, gvals); tokens are intern ids, or
                    # synthetic ids >= 2^63 for non-encodable group values
                    # (ERROR poison etc., assigned by the per-row path)
                    self._ginfo_map: dict[int, tuple[Key, tuple]] = {}
                    self._syn_by_token: dict[Any, int] = {}
                    self._syn_next = 1 << 63
        if self._native is None:
            self.state = MultisetState()  # gkey -> {token: ((gvals,args),cnt)}
            self.gkeys: dict[Any, tuple[Key, tuple]] = {}  # fzn gval->(Key,gvals)
            self.stateful_state: dict[Any, list[Any]] = {}
            # out-of-core tier: lazily created once the resident group
            # count first exceeds the spill budget (native accumulator
            # modes never spill — their state is fixed-width per group)
            self._spill = None

    # ---- out-of-core spill tier (engine/spill.py) --------------------
    # A spilled group carries its multiset AND its per-group side state
    # (gkeys entry, last emitted row) so promotion restores the node
    # exactly: delta_emit keeps retracting against the right prior row.

    def spill_stores(self) -> list:
        s = getattr(self, "_spill", None)
        return [s] if s is not None else []

    def _spill_attach(self, store) -> None:
        from pathway_tpu_torch.persistence import codec as _codec

        self._spill = store
        self.state.spill_attach(store, self._spill_resolve)
        store.tail_keys = lambda _st=self.state: (
            _codec.encode_value(k) for k in _st.groups
        )

    def _spill_resolve(self, token_g) -> None:
        from pathway_tpu_torch.persistence import codec as _codec

        store = self._spill
        if store is None:
            return
        raw = store.take(_codec.encode_value(token_g))
        if raw is None:
            return
        entries, ginfo, em = _codec.decode_value(raw)
        self.state.groups[token_g] = {
            freeze_value(p): (p, c) for p, c in entries
        }
        self.gkeys.setdefault(token_g, ginfo)
        if em is not None:
            self.emitted.setdefault(ginfo[0], em)

    def _maybe_spill(self) -> None:
        from pathway_tpu_torch.engine import spill as _spill
        from pathway_tpu_torch.persistence import codec as _codec

        if not _spill.enabled():
            return
        if self._spill is None:
            if len(self.state.groups) <= _spill.default_budget():
                return
            self._spill_attach(_spill.store_for(f"n{self.node_id}-reduce"))

        def pack(token_g, group):
            ginfo = self.gkeys[token_g]
            em = self.emitted.get(ginfo[0])
            raw = _codec.encode_value((tuple(group.values()), ginfo, em))
            self.gkeys.pop(token_g, None)
            if em is not None:
                self.emitted.pop(ginfo[0], None)
            return raw

        _spill_evict_multiset(self.state, self._spill, pack)

    def persist_signature(self) -> str:
        reds = ",".join(
            getattr(r, "name", type(r).__name__) for r in self.reducers
        )
        return f"GroupByNode/[{reds}]/native={int(self._native is not None)}"

    # ------------------------------------------------------ shard rescale

    def merge_shard_states(self, states: list[dict]) -> dict:
        if not states:
            return {}
        if any(st.get("spill") is not None for st in states):
            # metadata rescale: merge the resident tails normally, fold
            # the run manifests without touching run files
            from pathway_tpu_torch.engine import spill as _spill

            mans = [st["spill"] for st in states if st.get("spill") is not None]
            merged = self.merge_shard_states([
                {k: v for k, v in st.items() if k != "spill"}
                for st in states
            ])
            merged["spill"] = _spill.merge_manifests(mans)
            return merged
        if "native_plan" in states[0]:
            # group-aligned arrays concatenate; slots align positionally
            aggs = [st["native_plan"] for st in states]
            merged_agg = {
                k: np.concatenate([a[k] for a in aggs]) for k in aggs[0]
            }
            slots: list = []
            emitted: dict = {}
            for st in states:
                slots.extend(st["slots"])
                emitted.update(st["emitted"])
            return {
                "native_plan": merged_agg, "slots": slots, "emitted": emitted
            }
        if "native" in states[0]:
            # dense per-shard group ids renumber into one merged id space
            # (merged gid = row order); the result is a valid restore_state
            # input so merge alone serves the rescale-to-one-worker case
            merged_g2t: dict = {}
            merged_info: list = []
            total: list = []
            red: dict[str, list] = {
                k: [] for k in ("isum", "fsum", "cnt", "fseen", "err", "ovf")
            }
            emitted: dict = {}
            for st in states:
                exp, g2t, info = st["native"], st["gid_by_token"], st["ginfo"]
                gid_to_tok = {gid: t for t, gid in g2t.items()}
                m = len(exp["g"])
                r = len(exp["isum"]) // m if m else 0
                for i in range(m):
                    gid = int(exp["g"][i])
                    merged_g2t[gid_to_tok[gid]] = len(merged_info)
                    merged_info.append(info[gid])
                    total.append(exp["total"][i])
                    for k in red:
                        red[k].append(exp[k][i * r:(i + 1) * r])
                emitted.update(st["emitted"])
            m = len(merged_info)
            exp_out = {"g": np.arange(m, dtype=np.uint64),
                       "total": np.asarray(total, np.int64)}
            for k, dt_ in (
                ("isum", np.int64), ("fsum", np.float64), ("cnt", np.int64),
                ("fseen", np.int64), ("err", np.int64), ("ovf", np.uint8),
            ):
                exp_out[k] = (
                    np.concatenate(red[k]).astype(dt_)
                    if red[k]
                    else np.empty(0, dt_)
                )
            return {
                "native": exp_out,
                "gid_by_token": merged_g2t,
                "ginfo": merged_info,
                "emitted": emitted,
            }
        return super().merge_shard_states(states)

    def split_shard_state(self, merged: dict, n: int, shard_of) -> list[dict]:
        if merged.get("spill") is not None:
            from pathway_tpu_torch.engine import spill as _spill

            rest = {k: v for k, v in merged.items() if k != "spill"}
            outs = self.split_shard_state(rest, n, shard_of)
            for s, part in enumerate(
                _spill.split_manifest(merged["spill"], n)
            ):
                outs[s]["spill"] = part
            return outs
        if "native" in merged:
            # decompose the canonical merged export, routed by group token
            exp, g2t, info = (
                merged["native"], merged["gid_by_token"], merged["ginfo"]
            )
            gid_to_tok = {gid: t for t, gid in g2t.items()}
            m = len(exp["g"])
            r = len(exp["isum"]) // m if m else 0
            gkey_shard: dict = {}
            parts: list[dict] = [
                {
                    "native": {
                        "g": [], "total": [],
                        "isum": [], "fsum": [], "cnt": [],
                        "fseen": [], "err": [], "ovf": [],
                    },
                    "gid_by_token": {},
                    "ginfo": [],
                    "emitted": {},
                }
                for _ in range(n)
            ]
            for i in range(m):
                gid = int(exp["g"][i])
                tok = gid_to_tok[gid]
                s = shard_of(tok)
                p = parts[s]
                ngid = len(p["ginfo"])
                p["ginfo"].append(info[gid])
                p["gid_by_token"][tok] = ngid
                p["native"]["g"].append(ngid)
                p["native"]["total"].append(exp["total"][i])
                for k in ("isum", "fsum", "cnt", "fseen", "err", "ovf"):
                    p["native"][k].append(exp[k][i * r:(i + 1) * r])
                gkey_shard[info[gid][0]] = s
            for p in parts:
                pe = p["native"]
                pe["g"] = np.asarray(pe["g"], np.uint64)
                pe["total"] = np.asarray(pe["total"], np.int64)
                for k, dt_ in (
                    ("isum", np.int64), ("fsum", np.float64),
                    ("cnt", np.int64), ("fseen", np.int64),
                    ("err", np.int64), ("ovf", np.uint8),
                ):
                    pe[k] = (
                        np.concatenate(pe[k]).astype(dt_)
                        if pe[k]
                        else np.empty(0, dt_)
                    )
            for gkey, rrow in merged["emitted"].items():
                s = gkey_shard.get(gkey)
                if s is None:
                    raise RescaleUnsupported(
                        "groupby emitted key missing from ginfo"
                    )
                parts[s]["emitted"][gkey] = rrow
            return parts
        if "native_plan" in merged:
            agg, slots = merged["native_plan"], merged["slots"]
            m = len(slots)
            r = len(agg["isum"]) // m if m else 0
            # per-slot route token = the group's VALUE tuple, decoded from
            # its canonical bytes ("b") or taken raw ("v" — the object
            # plane routes these, same freeze_value token)
            from pathway_tpu_torch.engine.native import dataplane as _dp

            shard_by_slot = np.empty(m, np.int64)
            gkey_shard: dict[Key, int] = {}
            for i, (kind, payload) in enumerate(slots):
                if kind == "b":
                    s = shard_of(_dp.decode_row(payload))
                    gkey = Key(_hash_bytes_128(payload))
                else:
                    s = shard_of(freeze_value(tuple(payload)))
                    gkey = key_for_values(*payload)
                shard_by_slot[i] = s
                gkey_shard[gkey] = s
            outs: list[dict] = []
            for s in range(n):
                gi = np.nonzero(shard_by_slot == s)[0]
                red_idx = (
                    (gi[:, None] * r + np.arange(r)).ravel()
                    if r
                    else np.empty(0, np.int64)
                )
                sub_agg = {
                    k: (
                        v[gi]
                        if k in ("g", "total")
                        else v[red_idx]
                    )
                    for k, v in agg.items()
                }
                sub_emitted = {}
                for k, v in merged["emitted"].items():
                    ks = gkey_shard.get(k)
                    if ks is None:
                        raise RescaleUnsupported(
                            "groupby emitted key missing from group slots"
                        )
                    if ks == s:
                        sub_emitted[k] = v
                outs.append({
                    "native_plan": sub_agg,
                    "slots": [slots[int(i)] for i in gi],
                    "emitted": sub_emitted,
                })
            return outs
        # python mode: keyed by the frozen group token; emitted is keyed
        # by the group's OUTPUT key — derive its token through gkeys
        key_tok = {
            gkey: tok for tok, (gkey, _g) in merged.get("gkeys", {}).items()
        }
        outs = [
            {
                "state": st, "gkeys": gk, "stateful_state": ss, "emitted": {}
            }
            for st, gk, ss in zip(
                _split_container(merged["state"], "token", n, shard_of),
                _split_container(merged["gkeys"], "token", n, shard_of),
                # stateful_state keys are (group_token, reducer_idx)
                _split_container(
                    merged["stateful_state"], "keytup", n, shard_of
                ),
            )
        ]
        for gkey, row in merged.get("emitted", {}).items():
            tok = key_tok.get(gkey)
            if tok is None:
                raise RescaleUnsupported(
                    "groupby emitted key missing from gkeys"
                )
            outs[shard_of(tok)]["emitted"][gkey] = row
        return outs

    def persist_state(self) -> dict:
        if self._native is not None and self._plan is not None:
            # intern tokens are run-local: snapshot each group's canonical
            # BYTES (re-interned on restore) or its raw gvals for
            # synthetic (non-encodable) groups
            agg = self._native.export_state()
            slots = []
            for g in agg["g"]:
                g = int(g)
                if g >= 1 << 63:
                    slots.append(("v", self._ginfo_map[g][1]))
                else:
                    slots.append(("b", self._tab.get_bytes(g)))
            return {
                "native_plan": agg,
                "slots": slots,
                "emitted": self.emitted,
            }
        if self._native is not None:
            return {
                "native": self._native.export_state(),
                "gid_by_token": self._gid_by_token,
                "ginfo": self._ginfo,
                "emitted": self.emitted,
            }
        st = {
            "state": self.state,
            "gkeys": self.gkeys,
            "stateful_state": self.stateful_state,
            "emitted": self.emitted,
        }
        if self._spill is not None and self._spill.has_runs:
            st["spill"] = self._spill.manifest()
        return st

    def restore_state(self, st: dict) -> None:
        mode = (
            "plan" if self._native is not None and self._plan is not None
            else "native" if self._native is not None
            else "python"
        )
        st_mode = (
            "plan" if "native_plan" in st
            else "native" if "native" in st
            else "python"
        )
        if mode != st_mode:
            # PATHWAY_TPU_NATIVE toggled between runs; the aggregate
            # representations are not interchangeable
            raise RuntimeError(
                "groupby snapshot was taken with a different native-kernel "
                "setting; cannot restore operator state"
            )
        if mode == "plan":
            agg = st["native_plan"]
            new_g = []
            for kind, payload in st["slots"]:
                if kind == "b":
                    tok = self._tab.intern(payload)
                    gvals = self._dp.decode_row(payload)
                    gkey = Key(_hash_bytes_128(payload))
                else:
                    tok = self._syn_next
                    self._syn_next += 1
                    gvals = payload
                    self._syn_by_token[freeze_value(gvals)] = tok
                    gkey = key_for_values(*gvals)
                self._ginfo_map[tok] = (gkey, gvals)
                new_g.append(tok)
            agg = dict(agg)
            agg["g"] = np.asarray(new_g, np.uint64)
            self._native.import_state(agg)
            self.emitted = st["emitted"]
        elif mode == "native":
            self._native.import_state(st["native"])
            self._gid_by_token = st["gid_by_token"]
            self._ginfo = st["ginfo"]
            self.emitted = st["emitted"]
        else:
            self.state = st["state"]
            self.gkeys = st["gkeys"]
            self.stateful_state = st["stateful_state"]
            self.emitted = st["emitted"]
            man = st.get("spill")
            if man is not None:
                from pathway_tpu_torch.engine import spill as _spill

                self._spill_attach(_spill.attach_store(man))
                _spill_check_strict(self._spill, f"reduce n{self.node_id}")

    def _group_token(self, gvals: tuple) -> int:
        """Plan mode: the group's intern id (canonical bytes) or a
        synthetic >= 2^63 id for non-encodable group values."""
        tok = self._tab.intern_row(gvals)
        if tok is None:
            ftok = freeze_value(gvals)
            tok = self._syn_by_token.get(ftok)
            if tok is None:
                tok = self._syn_next
                self._syn_next += 1
                self._syn_by_token[ftok] = tok
                self._ginfo_map[tok] = (key_for_values(*gvals), gvals)
            return tok
        if tok not in self._ginfo_map:
            self._ginfo_map[tok] = (key_for_values(*gvals), gvals)
        return tok

    def _group_info(self, gt: int) -> tuple[Key, tuple]:
        info = self._ginfo_map.get(gt)
        if info is None:  # batch-path group seen first natively
            gvals = self._dp.decode_row(self._tab.get_bytes(gt))
            # key via key_for_values, the CANONICAL group key — for plain
            # scalar pieces it equals blake2b(gbytes), and for groups the
            # per-row path registered first (exotic/ERROR values) the two
            # paths must agree on one key
            info = (key_for_values(*gvals), gvals)
            self._ginfo_map[gt] = info
        return info

    def _finish_native(self, time: int, entries: list[Entry]) -> None:
        n = len(entries)
        n_red = len(self.reducers)
        gtok = np.empty(n, np.uint64)
        diffs = np.empty(n, np.int64)
        vals_i = np.zeros((n_red, n), np.int64)
        vals_f = np.zeros((n_red, n), np.float64)
        tags = np.zeros((n_red, n), np.uint8)
        keep = 0
        plan_mode = self._plan is not None
        for key, row, diff in entries:
            try:
                gvals = self.gk_fn(key, row)
            except Exception as e:  # noqa: BLE001
                self.log_error(f"groupby key: {type(e).__name__}: {e}")
                continue
            if plan_mode:
                gid = self._group_token(gvals)
            else:
                ftok = freeze_value(gvals)
                gid = self._gid_by_token.get(ftok)
                if gid is None:
                    gid = len(self._ginfo)
                    self._gid_by_token[ftok] = gid
                    self._ginfo.append((key_for_values(*gvals), gvals))
            gtok[keep] = gid
            diffs[keep] = diff
            for ri, red in enumerate(self.reducers):
                if red.n_args == 0:
                    continue  # count: tag 0, value unused
                try:
                    v = self.arg_fns[ri](key, row, time)[0]
                except Exception as e:  # noqa: BLE001
                    self.log_error(f"reducer arg: {type(e).__name__}: {e}")
                    v = ERROR
                if isinstance(v, (bool, np.bool_, int, np.integer)):
                    try:
                        vals_i[ri, keep] = int(v)
                    except OverflowError:
                        # outside the kernel's i64 domain (the reference's
                        # Rust IntSum is i64 too) — poison, don't wrap
                        tags[ri, keep] = 2
                elif isinstance(v, (float, np.floating)):
                    vals_f[ri, keep] = float(v)
                    tags[ri, keep] = 1
                else:
                    tags[ri, keep] = 2  # ERROR / None / non-numeric
            keep += 1
        if not keep:
            return
        g_ids, totals, isum, fsum, cnts, flags = self._native.update(
            gtok[:keep], vals_i[:, :keep], vals_f[:, :keep],
            tags[:, :keep], diffs[:keep],
        )
        self._emit_agg(time, g_ids, totals, isum, fsum, cnts, flags)

    def _emit_agg(self, time, g_ids, totals, isum, fsum, cnts, flags) -> None:
        plan_mode = self._plan is not None
        out: list[Entry] = []
        # plan mode emits token-resident: the retract-old/insert-new pairs
        # leave as ONE NativeBatch (rows interned, never decoded), so a
        # groupby inside a hot loop — the iterate scope's per-round
        # aggregations — feeds downstream joins without any object rows.
        # The suppression rule stays delta_emit's Python rows_equal, so
        # emission CONTENT is bit-identical to the object transport.
        kvs: list = []
        toks: list = []
        diffs: list = []
        for j in range(len(g_ids)):
            if plan_mode:
                gkey, gvals = self._group_info(int(g_ids[j]))
            else:
                gkey, gvals = self._ginfo[int(g_ids[j])]
            if totals[j] == 0:
                new = None
            else:
                vals = []
                for ri, red in enumerate(self.reducers):
                    fl = int(flags[j, ri])
                    if red.name == "count":
                        vals.append(int(totals[j]))
                    elif fl & 2:
                        vals.append(ERROR)
                    elif red.name == "sum":
                        if fl & 1:
                            vals.append(float(isum[j, ri]) + float(fsum[j, ri]))
                        else:
                            vals.append(int(isum[j, ri]))
                    else:  # avg
                        c = int(cnts[j, ri])
                        vals.append(
                            (float(isum[j, ri]) + float(fsum[j, ri])) / c
                            if c else None
                        )
                new = tuple(gvals) + tuple(vals)
            if not plan_mode:
                delta_emit(self.emitted, out, gkey, new)
                continue
            pos = len(out)
            delta_emit(self.emitted, out, gkey, new)
            kpos = len(kvs)
            for key, row, d in out[pos:]:
                t = self._tab.intern_row(row)
                if t is None:
                    # exotic value: the whole group's pair stays object
                    del kvs[kpos:], toks[kpos:], diffs[kpos:]
                    break
                kvs.append(key.value)
                toks.append(t)
                diffs.append(d)
            else:
                del out[pos:]
        n = len(kvs)
        if n:
            self.emit(
                time,
                self._dp.NativeBatch(
                    self._tab,
                    np.fromiter((kv & _MASK64 for kv in kvs), np.uint64, n),
                    np.fromiter((kv >> 64 for kv in kvs), np.uint64, n),
                    np.fromiter(toks, np.uint64, n),
                    np.fromiter(diffs, np.int64, n),
                ),
            )
        self.emit(time, out)

    def _prepare_native_batch(self, batch, gtok=None):
        """Pure half of the token-resident wave: group projection + arg
        decode, no state touched. Returns (gtok, vals_i, vals_f, tags)
        or None when the plan can't judge the batch (caller falls back
        with nothing applied). `gtok` may be supplied by a caller that
        already projected the group columns — the wave cone's sharded
        path shares ONE projection between exchange routing and the
        groupby update (engine/cone.py)."""
        plan = self._plan
        if gtok is None:
            res = self._dp.project_group(self._tab, batch.token, plan["gb_cols"])
            if res is None:
                return None
            gtok = res[0]
        n = len(batch)
        n_red = len(self.reducers)
        # decode every distinct arg column once
        col_plans = [p for p in plan["arg_plans"] if p is not None]
        need_cols = sorted(
            {p[1] for p in col_plans if p[0] == "col"}
            | {c for p in col_plans if p[0] == "numpy" for c in p[1].needed_cols}
        )
        decoded = decode_cols_dict(self._dp, self._tab, batch.token, need_cols)
        if decoded is None:
            return None
        vals_i = np.zeros((n_red, n), np.int64)
        vals_f = np.zeros((n_red, n), np.float64)
        tags = np.zeros((n_red, n), np.uint8)
        for ri, p in enumerate(plan["arg_plans"]):
            if p is None:
                continue  # count
            if p[0] == "col":
                vi, vf, tg = decoded[p[1]]
                # fold the boolness tag back to int for zs_agg
                tg = np.where(tg == 3, 0, tg).astype(np.uint8)
            else:  # ("numpy", NumpyPlan)
                vi, vf, tg = p[1].eval(decoded, n)
            vals_i[ri] = vi
            vals_f[ri] = vf
            tags[ri] = tg
        return gtok, vals_i, vals_f, tags

    def _finish_native_batch(self, time: int, batch) -> bool:
        """Token-resident wave: group projection, arg decode and the
        semigroup aggregation all run in C/numpy; Python appears only for
        the affected groups' output rows. Returns False when the batch
        can't be handled (caller materializes)."""
        prep = self._prepare_native_batch(batch)
        if prep is None:
            return False
        gtok, vals_i, vals_f, tags = prep
        g_ids, totals, isum, fsum, cnts, flags = self._native.update(
            gtok, vals_i, vals_f, tags, np.ascontiguousarray(batch.diff)
        )
        self._emit_agg(time, g_ids, totals, isum, fsum, cnts, flags)
        return True

    def finish_time(self, time: int) -> None:
        if self._native is not None and self._plan is not None:
            batches, entries = self.take_segments()
            for b in batches:
                if not self._finish_native_batch(time, b):
                    entries = b.materialize() + entries
            if entries:
                self._finish_native(time, entries)
            return
        entries = self.take_input()
        if not entries:
            return
        if self._native is not None:
            self._finish_native(time, entries)
            return
        affected: dict[Any, None] = {}
        batch_per_group: dict[Any, list[tuple[tuple, int]]] = defaultdict(list)
        for key, row, diff in entries:
            try:
                gvals = self.gk_fn(key, row)
            except Exception as e:  # noqa: BLE001
                self.log_error(f"groupby key: {type(e).__name__}: {e}")
                continue
            args = []
            for fn in self.arg_fns:
                try:
                    args.append(fn(key, row, time))
                except Exception as e:  # noqa: BLE001
                    self.log_error(f"reducer arg: {type(e).__name__}: {e}")
                    args.append(ERROR)
            token_g = freeze_value(gvals)
            if token_g not in self.gkeys:
                self.gkeys[token_g] = (key_for_values(*gvals), gvals)
            self.state.update_one(token_g, tuple(args), diff)
            batch_per_group[token_g].append((tuple(args), diff))
            affected[token_g] = None

        out: list[Entry] = []
        for token_g in affected:
            gkey, gvals = self.gkeys[token_g]
            entries_now = self.state.get(token_g)
            from pathway_tpu_torch.internals.reducers import StatefulReducer

            if not entries_now and not any(
                isinstance(r, StatefulReducer) for r in self.reducers
            ):
                new = None
            else:
                vals = []
                for ri, reducer in enumerate(self.reducers):
                    if isinstance(reducer, StatefulReducer):
                        st_key = (token_g, ri)
                        state = self.stateful_state.get(st_key)
                        rows = [
                            (list(args[ri]), cnt)
                            for args, cnt in batch_per_group.get(token_g, [])
                        ]
                        state = reducer.combine_fn(state, rows)
                        self.stateful_state[st_key] = state
                        vals.append(state)
                    else:
                        per_reducer = [(args[ri], cnt) for args, cnt in entries_now]
                        vals.append(reducer.from_multiset(per_reducer))
                new = tuple(gvals) + tuple(vals)
                if not entries_now:
                    new = None
            delta_emit(self.emitted, out, gkey, new)
        self.emit(time, out)
        self._maybe_spill()


def _canon_scalar(v: Any) -> Any:
    """Shard-token canonicalization (bool -> int, integral float -> int)
    matching workers._canon + dataplane canon_piece for scalars."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, float) and v.is_integer():
        return int(v)
    return v


class DeduplicateNode(_TokTailNode):
    """Keep one accepted row per instance via acceptor(new, old) -> bool
    (reference: deduplicate dataflow.rs:3101).

    Token mode (lowering-gated on plain instance/value columns): instance
    grouping and output keys compute in C (dp_project_group / dp_rekey),
    the value column bulk-decodes once per wave, and only the acceptor
    itself runs per candidate row — accepted rows pass through as tokens.
    """

    _persist_attrs = ("accepted", "ikeys")
    _state_routing = {"accepted": "token", "ikeys": "token"}

    def __init__(
        self,
        graph: Graph,
        inp: Node,
        instance_fn: Callable[[Key, tuple], Any],
        value_fn: Callable[[Key, tuple], Any],
        acceptor: Callable[[Any, Any], bool],
        keep_key: bool = False,
        native_cfg: dict | None = None,
    ):
        super().__init__(graph, [inp])
        self.instance_fn = instance_fn
        self.value_fn = value_fn
        self.acceptor = acceptor
        # native_cfg: {"inst_cols": [i] | None, "value_col": j,
        #              "value_kind": "num" | "str"}
        self._cfg = native_cfg
        self._tok = self._tok and native_cfg is not None
        if self._tok:
            # gtok -> (kv, row_tok, value, ikey_kv); const-instance gtok=0
            self.accepted: Any = {}
            self.ikeys: Any = {}  # unused in token mode (ikv in accepted)
            self._const_ikv = (
                key_for_values(0).value if not native_cfg["inst_cols"] else None
            )
        else:
            self.accepted = {}
            self.ikeys = {}

    # ---------------------------------------------------------- snapshots

    def _inst_value(self, gtok: int) -> Any:
        if not self._cfg["inst_cols"]:
            return 0
        vals = self._dp.decode_row(self._tab.get_bytes(gtok))
        return vals[0] if len(vals) == 1 else vals

    def _demoted_state(self) -> dict:
        tab = self._tab
        accepted: dict = {}
        ikeys: dict = {}
        for gtok, (kv, tok, _val, ikv) in self.accepted.items():
            inst = freeze_value(self._inst_value(gtok))
            accepted[inst] = (Key(kv), tab.row(tok))
            ikeys[inst] = Key(ikv)
        return {"accepted": accepted, "ikeys": ikeys}

    def _encode_state(self, st: dict) -> bool:
        tab = self._tab
        cfg = self._cfg
        accepted: dict = {}
        for inst, (key, row) in st["accepted"].items():
            tok = tab.intern_row(row)
            ikey = st["ikeys"].get(inst)
            if tok is None or ikey is None:
                return False
            if not cfg["inst_cols"]:
                gtok = 0
            else:
                vals = inst if isinstance(inst, tuple) else (inst,)
                pieces = []
                for v in vals:
                    p = self._dp.encode_scalar(_canon_scalar(v))
                    if p is None:
                        return False
                    pieces.append(p)
                gtok = tab.intern(b"".join(pieces))
            accepted[gtok] = (key.value, tok, row[cfg["value_col"]], ikey.value)
        self.accepted = accepted
        self.ikeys = {}
        return True

    # --------------------------------------------------------------- wave

    def _decode_values(self, toks: np.ndarray):
        """Value column as Python scalars, or None (demote)."""
        cfg = self._cfg
        if cfg["value_kind"] == "str":
            cols = self._dp.decode_str_cols(self._tab, toks, [cfg["value_col"]])
            return None if cols is None else cols[0]
        dec = self._dp.decode_num_cols(self._tab, toks, [cfg["value_col"]])
        if dec is None:
            return None
        vi, vf, tg = dec
        tg0 = tg[0]
        if ((tg0 != 0) & (tg0 != 1) & (tg0 != 3)).any():
            return None
        vi0 = vi[0].tolist()
        vf0 = vf[0].tolist()
        return [
            vf0[i] if t == 1 else (bool(vi0[i]) if t == 3 else vi0[i])
            for i, t in enumerate(tg0.tolist())
        ]

    def _finish_tok(self, time: int) -> bool:
        raw = self.take_segments()
        w = _wave_arrays(self._tab, *raw)
        if w is None:
            self._requeue([raw])
            self._demote()
            return False
        lo0, hi0, tok0, diff0 = w
        if not len(lo0):
            return True
        ins = diff0 > 0
        if not ins.any():
            return True
        lo, hi, tok = lo0[ins], hi0[ins], tok0[ins]
        order = np.lexsort((lo, hi))  # canonical within-wave order
        lo, hi, tok = lo[order], hi[order], tok[order]
        n = len(tok)
        cfg = self._cfg
        acceptor = self.acceptor
        accepted = self.accepted

        def _demote_full_wave() -> None:
            self._finish_object(
                time, self._demote_replay(lo0, hi0, tok0, diff0)
            )

        gts = None
        rep_ug = rep_ilo = rep_ihi = None
        if cfg["inst_cols"]:
            res = self._dp.project_group(self._tab, tok, cfg["inst_cols"])
            if res is None:
                _demote_full_wave()
                return True
            gts = res[0]
            # rekey pre-flight on ONE representative row per group (the
            # instance key is a pure function of the group token): any
            # unkeyable instance demotes BEFORE the acceptor runs, so the
            # acceptor is never invoked twice for a row (once here, once
            # in the object replay)
            rep_ug, rep_idx = np.unique(gts, return_index=True)
            rkr = self._dp.rekey(self._tab, tok[rep_idx], cfg["inst_cols"])
            if rkr is None or ((rkr[0] == 0) & (rkr[1] == 0)).any():
                _demote_full_wave()
                return True
            rep_ilo, rep_ihi = rkr

        # Phase 1 — fold winners per group WITHOUT touching state:
        # widx[g] = winning row index this wave, touched[g] = accepted
        # entry at wave start. State mutates only after the pre-flight
        # checks below, so a demotion mid-wave replays cleanly.
        touched: dict = {}
        widx: dict = {}
        if acceptor is None:
            # keep-latest: winner is the last row per group in canonical
            # order — whole wave folds vectorized, no per-row Python
            if gts is None:
                widx[0] = n - 1
                touched[0] = accepted.get(0)
            else:
                _u, first_rev = np.unique(gts[::-1], return_index=True)
                idxs = n - 1 - first_rev
                for g, i in zip(gts[idxs].tolist(), idxs.tolist()):
                    widx[g] = i
                    touched[g] = accepted.get(g)
        else:
            vals = self._decode_values(tok)
            if vals is None:
                _demote_full_wave()
                return True
            gl = gts.tolist() if gts is not None else None
            log_error = self.log_error
            _miss = _MISSING_SENTINEL
            for i in range(n):
                g = gl[i] if gl is not None else 0
                j = widx.get(g)
                if j is not None:
                    pv = vals[j]
                else:
                    pa = accepted.get(g)
                    if pa is None:
                        pv = _miss
                    else:
                        pv = pa[2]
                try:
                    ok = True if pv is _miss else acceptor(vals[i], pv)
                except Exception as e:  # noqa: BLE001
                    log_error(f"deduplicate acceptor: {e}")
                    ok = False
                if ok:
                    if g not in touched:
                        touched[g] = accepted.get(g)
                    widx[g] = i
        if not widx:
            return True

        # Phase 2 — materialize winner identity (kv/tok/ikv) for the few
        # winning rows only; the instance keys come from the pre-flighted
        # per-group representatives (rekey never runs over the full wave).
        groups = list(widx)
        idx_arr = np.fromiter(widx.values(), np.int64, len(groups))
        if cfg["inst_cols"]:
            pos = np.searchsorted(
                rep_ug, np.asarray(groups, rep_ug.dtype)
            )
            ikvs = _kvs_of(rep_ilo[pos], rep_ihi[pos])
        else:
            ikvs = [self._const_ikv] * len(groups)
        wkvs = _kvs_of(lo[idx_arr], hi[idx_arr])
        wtoks = tok[idx_arr].tolist()
        if acceptor is None:
            wvals = [None] * len(groups)
        else:
            wvals = [vals[i] for i in widx.values()]
        kvs: list = []
        toks_o: list = []
        diffs: list = []
        for j, g in enumerate(groups):
            orig = touched[g]
            accepted[g] = (wkvs[j], wtoks[j], wvals[j], ikvs[j])
            if orig is not None:
                if orig[1] == wtoks[j] and orig[3] == ikvs[j]:
                    continue  # wave ended on the row it started with
                kvs.append(orig[3])
                toks_o.append(orig[1])
                diffs.append(-1)
            kvs.append(ikvs[j])
            toks_o.append(wtoks[j])
            diffs.append(1)
        self._emit_tok(time, kvs, toks_o, diffs, consolidate_out=True)
        return True

    def finish_time(self, time: int) -> None:
        if self._tok:
            if self._finish_tok(time):
                return
        entries = self.take_input()
        if not entries:
            return
        self._finish_object(time, entries)

    def _finish_object(self, time: int, entries: list[Entry]) -> None:
        # canonical within-wave order: batches arrive shard-concatenated
        # under multi-worker execution, so order-sensitive acceptance must
        # not depend on arrival order inside one timestamp (worker-count
        # invariance; engine/workers.py). Across waves, time order rules.
        entries = sorted(entries, key=lambda e: e[0].value)
        out: list[Entry] = []
        for key, row, diff in entries:
            if diff <= 0:
                continue  # dedup state machine consumes insertions only
            try:
                inst = freeze_value(self.instance_fn(key, row))
            except Exception as e:  # noqa: BLE001
                self.log_error(f"deduplicate instance: {e}")
                continue
            prev = self.accepted.get(inst)
            try:
                ok = (
                    self.acceptor(self.value_fn(key, row), self.value_fn(*prev))
                    if prev is not None and self.acceptor is not None
                    else True
                )
            except Exception as e:  # noqa: BLE001
                self.log_error(f"deduplicate acceptor: {e}")
                ok = False
            if ok:
                if inst not in self.ikeys:
                    self.ikeys[inst] = key_for_values(*(inst if isinstance(inst, tuple) else (inst,)))
                ikey = self.ikeys[inst]
                if prev is not None:
                    out.append((ikey, prev[1], -1))
                out.append((ikey, row, 1))
                self.accepted[inst] = (key, row)
        self.emit(time, consolidate(out))


class IxNode(_TokTailNode):
    """Pointer lookup: for each source row, fetch the target row at
    pointer_fn(key, row) (reference: ix_table dataflow.rs:2133).

    Token mode (lowering-gated on a plain pointer column): pointers
    extract in C (dp_decode_key_col) and the lookup is int-dict key
    chasing — target row tokens pass through to the output undecoded."""

    _persist_attrs = ("source_by_ptr", "target_state", "emitted")

    def split_shard_state(self, merged: dict, n: int, shard_of) -> list[dict]:
        # input 0 routes by pointer token, input 1 by record key (the two
        # agree: a Key pointer's token IS the target key's value); emitted
        # is keyed by the SOURCE key, whose pointer token is recorded in
        # source_by_ptr
        outs = [
            {"source_by_ptr": sp, "target_state": ts, "emitted": {}}
            for sp, ts in zip(
                _split_container(merged["source_by_ptr"], "token", n, shard_of),
                _split_container(merged["target_state"], "key", n, shard_of),
            )
        ]
        skey_shard: dict[Key, int] = {}
        for ptr_tok, group in merged["source_by_ptr"].groups.items():
            s = shard_of(ptr_tok)
            for (skey, _srow, _ptr), _c in group.values():
                skey_shard[skey] = s
        for skey, row in merged["emitted"].items():
            s = skey_shard.get(skey)
            if s is None:
                raise RescaleUnsupported("ix emitted key missing source row")
            outs[s]["emitted"][skey] = row
        return outs

    def __init__(
        self,
        graph: Graph,
        source: Node,
        target: Node,
        pointer_fn: Callable[[Key, tuple], Any],
        optional: bool = False,
        strict: bool = True,
        target_width: int = 0,
        ptr_col: int | None = None,
    ):
        super().__init__(graph, [source, target])
        self.pointer_fn = pointer_fn
        self.optional = optional
        self.strict = strict
        self.target_width = target_width
        self.ptr_col = ptr_col
        self._tok = self._tok and ptr_col is not None
        if self._tok:
            # ptrkv|None -> {(skv, stok): count}; {kv: tok}; {skv: tok}
            self.source_by_ptr: Any = {}
            self.target_state: Any = {}
            self.emitted: Any = {}
            self._pad_tok: int | None = None
        else:
            self.source_by_ptr = MultisetState()  # ptr -> {(skey, srow)}
            self.target_state = KeyedState()
            self.emitted = {}

    def _pad(self) -> int:
        if self._pad_tok is None:
            self._pad_tok = self._tab.intern_row((None,) * self.target_width)
        return self._pad_tok

    def _demoted_state(self) -> dict:
        tab = self._tab
        ms = MultisetState()
        for ptrkv, grp in self.source_by_ptr.items():
            g: dict = {}
            for (skv, stok), c in grp.items():
                ptr = Key(ptrkv) if ptrkv is not None else None
                payload = (Key(skv), tab.row(stok), ptr)
                g[freeze_value(payload)] = (payload, c)
            ms.groups[ptrkv] = g
        return {
            "source_by_ptr": ms,
            "target_state": _keyed_state_of(self._rowdict_obj(self.target_state)),
            "emitted": self._rowdict_obj(self.emitted),
        }

    def _encode_state(self, st: dict) -> bool:
        tab = self._tab
        sbp: dict = {}
        for ptrkv, grp in st["source_by_ptr"].groups.items():
            if not (ptrkv is None or isinstance(ptrkv, int)):
                return False  # non-Key pointer: stay on the object plane
            g: dict = {}
            for (skey, srow, _ptr), c in grp.values():
                stok = tab.intern_row(srow)
                if stok is None:
                    return False
                g[(skey.value, stok)] = c
            sbp[ptrkv] = g
        target = self._rowdict_tok(st["target_state"])
        emitted = self._rowdict_tok(st["emitted"])
        if target is None or emitted is None:
            return False
        self.source_by_ptr, self.target_state, self.emitted = sbp, target, emitted
        return True

    def _finish_tok(self, time: int) -> bool:
        """Token-plane wave; False => demoted, caller reruns object-side
        (inputs are re-buffered before demotion consumes anything)."""
        raws = [self.take_segments(0), self.take_segments(1)]
        sw = _wave_triples(self._tab, *raws[0])
        tw = _wave_triples(self._tab, *raws[1])
        ptrs: Any = None
        if sw:
            toks = np.fromiter((t for _kv, t, _d in sw), np.uint64, len(sw))
            ptrs = self._dp.decode_key_col(self._tab, toks, self.ptr_col)
        if (
            sw is None
            or tw is None
            or (sw and (ptrs is None or (ptrs[2] > 1).any()))
        ):
            # unrepresentable row or non-Key pointer value: object plane
            self._requeue(raws)
            self._demote()
            return False
        return self._apply_tok(time, sw, tw, ptrs)

    def _apply_tok(self, time: int, sw, tw, ptrs) -> bool:
        affected: dict = {}
        if sw:
            plo, phi, pst = ptrs
            plo = plo.tolist()
            phi = phi.tolist()
            pst = pst.tolist()
            for (kv, tok, d), lo, hi, st_ in zip(sw, plo, phi, pst):
                ptrkv = None if st_ else (hi << 64) | lo
                grp = self.source_by_ptr.get(ptrkv)
                if grp is None:
                    grp = self.source_by_ptr[ptrkv] = {}
                ent = (kv, tok)
                c = grp.get(ent, 0) + d
                if c == 0:
                    grp.pop(ent, None)
                    if not grp:
                        del self.source_by_ptr[ptrkv]
                else:
                    grp[ent] = c
                affected[ptrkv] = None
        for kv, _tok, _d in tw:
            affected[kv] = None
        _tok_update_keyed(self.target_state, tw)
        kvs: list = []
        toks_o: list = []
        diffs: list = []
        emitted = self.emitted
        for ptrkv in affected:
            grp = self.source_by_ptr.get(ptrkv)
            if not grp:
                continue
            trow = self.target_state.get(ptrkv) if ptrkv is not None else None
            if ptrkv is None and self.optional:
                new0 = self._pad()
            elif trow is None:
                new0 = self._pad() if self.optional else None
            else:
                new0 = trow
            for (skv, _stok), c in list(grp.items()):
                new = new0
                old = emitted.get(skv)
                if old is not None and (new is None or old != new):
                    kvs.append(skv)
                    toks_o.append(old)
                    diffs.append(-1)
                    del emitted[skv]
                    old = None
                if new is not None and c > 0 and old != new:
                    kvs.append(skv)
                    toks_o.append(new)
                    diffs.append(1)
                    emitted[skv] = new
                if c <= 0 and emitted.get(skv) is not None:
                    kvs.append(skv)
                    toks_o.append(emitted.pop(skv))
                    diffs.append(-1)
        self._emit_tok(time, kvs, toks_o, diffs)
        return True

    def finish_time(self, time: int) -> None:
        if self._tok:
            if self._finish_tok(time):
                return
        sb = self.take_input(0)
        tb = self.take_input(1)
        if not sb and not tb:
            return
        affected_ptrs: dict[Any, None] = {}
        for key, row, diff in sb:
            try:
                ptr = self.pointer_fn(key, row)
            except Exception as e:  # noqa: BLE001
                self.log_error(f"ix pointer: {e}")
                continue
            self.source_by_ptr.update_one(
                ptr.value if isinstance(ptr, Key) else freeze_value(ptr), (key, row, ptr), diff
            )
            affected_ptrs[ptr.value if isinstance(ptr, Key) else freeze_value(ptr)] = None
        for key, _row, _diff in tb:
            affected_ptrs[key.value] = None
        self.target_state.update(tb)

        out: list[Entry] = []
        for ptr_tok in affected_ptrs:
            for (skey, srow, ptr), c in self.source_by_ptr.get(ptr_tok):
                trow = (
                    self.target_state.get(ptr) if isinstance(ptr, Key) else None
                )
                if ptr is None and self.optional:
                    new = (None,) * self.target_width
                elif trow is None:
                    if self.optional:
                        new = (None,) * self.target_width
                    else:
                        new = None
                else:
                    new = trow
                old = self.emitted.get(skey)
                if old is not None and (new is None or not rows_equal(old, new)):
                    out.append((skey, old, -1))
                    del self.emitted[skey]
                if new is not None and c > 0 and (old is None or not rows_equal(old, new)):
                    out.append((skey, new, 1))
                    self.emitted[skey] = new
                if c <= 0 and skey in self.emitted:
                    out.append((skey, self.emitted.pop(skey), -1))
        self.emit(time, out)


class SortNode(Node):
    """Maintain prev/next pointers over sorted instances, incrementally
    (reference: operators/prev_next.rs:11-40 — a bidirectional cursor walk
    over the delta's neighborhoods, never a re-sort of the instance).

    Each instance keeps a bisect-maintained ordered list of
    (sort_value, key.value, key); a wave's deltas touch only the inserted/
    removed positions and their immediate neighbors, so the per-wave work
    is O(delta · log n) comparisons (plus the list memmove), not the old
    O(n log n) full re-sort — at 1M rows per instance a single-row update
    re-emits 3 rows instead of 1M."""

    _persist_attrs = ("instances", "sortvals", "emitted")

    def split_shard_state(self, merged: dict, n: int, shard_of) -> list[dict]:
        # routed by instance; sortvals/emitted are keyed by row Key but
        # each key's instance is recorded in sortvals
        insts = _split_container(merged["instances"], "token", n, shard_of)
        outs = [
            {"instances": inst, "sortvals": {}, "emitted": {}}
            for inst in insts
        ]
        key_shard: dict[Key, int] = {}
        for key, (inst, sv) in merged["sortvals"].items():
            s = shard_of(inst)
            key_shard[key] = s
            outs[s]["sortvals"][key] = (inst, sv)
        for key, row in merged["emitted"].items():
            s = key_shard.get(key)
            if s is None:
                raise RescaleUnsupported("sort emitted key missing sortval")
            outs[s]["emitted"][key] = row
        return outs

    def __init__(
        self,
        graph: Graph,
        inp: Node,
        sort_key_fn: Callable[[Key, tuple], Any],
        instance_fn: Callable[[Key, tuple], Any],
    ):
        super().__init__(graph, [inp])
        self.sort_key_fn = sort_key_fn
        self.instance_fn = instance_fn
        # inst -> ordered [(sv, key.value, key)] (bisect keeps it sorted;
        # key.value tiebreaks, so key objects are never compared)
        self.instances: dict[Any, list] = defaultdict(list)
        self.sortvals: dict[Key, tuple] = {}  # key -> (inst, sv)
        self.emitted: dict[Key, tuple] = {}

    def persist_signature(self) -> str:
        # /v2: the ordered-list state layout (a v1 dict-of-dicts snapshot
        # must be rejected, falling back to journal replay)
        return "SortNode/v2/1"

    def _bulk_load(self, entries: list[Entry], affected: dict) -> None:
        """Pure-insert wave: group, extend, ONE sort per instance — per-
        entry bisect.insert would be O(n^2) memmove on descending input.
        Only inserted items and their post-sort neighbors are affected
        (an instance much larger than the wave must not be re-emitted)."""
        import bisect

        per_inst: dict[Any, list] = defaultdict(list)
        for key, row, _diff in entries:
            inst = freeze_value(self.instance_fn(key, row))
            sv = self.sort_key_fn(key, row)
            per_inst[inst].append((sv, key.value, key))
            self.sortvals[key] = (inst, sv)
        for inst, items in per_inst.items():
            order = self.instances[inst]
            order.extend(items)
            order.sort()
            if len(items) * 2 >= len(order):
                for _sv, _kv, key in order:
                    affected.setdefault(key, None)
                continue
            for item in items:
                i = bisect.bisect_left(order, item)
                affected.setdefault(item[2], None)
                if i > 0:
                    affected.setdefault(order[i - 1][2], None)
                if i + 1 < len(order):
                    affected.setdefault(order[i + 1][2], None)

    def finish_time(self, time: int) -> None:
        import bisect

        entries = self.take_input()
        if not entries:
            return
        affected: dict[Key, None] = {}  # keys whose (prev, next) may move
        removed: dict[Key, None] = {}
        if all(d > 0 for _k, _r, d in entries) and not any(
            e[0] in self.sortvals for e in entries
        ) and len(entries) > 64:
            self._bulk_load(entries, affected)
            entries = []
        for key, row, diff in entries:
            if diff > 0:
                # an insert over a live key (update arriving +1-first):
                # drop the stale position before inserting the new one
                stale = self.sortvals.get(key)
                if stale is not None:
                    s_inst, s_sv = stale
                    s_order = self.instances[s_inst]
                    si = bisect.bisect_left(s_order, (s_sv, key.value, key))
                    if si < len(s_order) and s_order[si][2] == key:
                        del s_order[si]
                        if si > 0:
                            affected.setdefault(s_order[si - 1][2], None)
                        if si < len(s_order):
                            affected.setdefault(s_order[si][2], None)
                        if not s_order:
                            del self.instances[s_inst]
                inst = freeze_value(self.instance_fn(key, row))
                sv = self.sort_key_fn(key, row)
                order = self.instances[inst]
                item = (sv, key.value, key)
                i = bisect.bisect_left(order, item)
                order.insert(i, item)
                self.sortvals[key] = (inst, sv)
                affected[key] = None
                removed.pop(key, None)
                if i > 0:
                    affected.setdefault(order[i - 1][2], None)
                if i + 1 < len(order):
                    affected.setdefault(order[i + 1][2], None)
            else:
                loc = self.sortvals.pop(key, None)
                if loc is None:
                    continue
                inst, sv = loc
                order = self.instances[inst]
                i = bisect.bisect_left(order, (sv, key.value, key))
                if i < len(order) and order[i][2] == key:
                    del order[i]
                if i > 0:
                    affected.setdefault(order[i - 1][2], None)
                if i < len(order):
                    affected.setdefault(order[i][2], None)
                affected.pop(key, None)
                removed[key] = None
                if not order:
                    del self.instances[inst]
        out: list[Entry] = []
        for key in removed:
            if key in self.sortvals:
                continue  # re-inserted in the same wave
            old = self.emitted.pop(key, None)
            if old is not None:
                out.append((key, old, -1))
        for key in affected:
            loc = self.sortvals.get(key)
            if loc is None:
                continue  # removed later in the wave
            inst, sv = loc
            order = self.instances[inst]
            i = bisect.bisect_left(order, (sv, key.value, key))
            prev = order[i - 1][2] if i > 0 else None
            nxt = order[i + 1][2] if i + 1 < len(order) else None
            delta_emit(self.emitted, out, key, (prev, nxt))
        self.emit(time, consolidate(out))


class CaptureNode(Node):
    """Accumulates the full update stream and final state (debug/capture).

    ``token_resident=True`` (the iterate scope's capture streams) keeps the
    log on the token plane: native waves append WHOLE as ``(time,
    NativeBatch)`` items beside plain ``(time, key, row, diff)`` tuples —
    the reader (IterateNode) consumes both kinds as one z-set — and the
    final state lives in a C keyed store (key128 -> token). Object rows
    arriving on a token log are interned in place; a plane-unrepresentable
    row demotes the capture (log materialized in order, positions remapped
    through the ``on_demote(cap, bounds)`` hook so the owning scope stays
    consistent). Operator snapshots always export the OBJECT form."""

    _persist_attrs = ("stream", "state")

    def __init__(self, graph: Graph, inp: Node, token_resident: bool = False):
        super().__init__(graph, [inp])
        self.stream: list = []  # 4-tuples and/or (time, NativeBatch) items
        self.state = KeyedState()
        self._tok = bool(token_resident) and _nb_type() is not None
        self.on_demote: Callable | None = None
        if self._tok:
            from pathway_tpu_torch.engine import native as _nat

            self._nat = _nat
            self._dp = _tok_plane()
            self._tab = self._dp.default_table()
            self._nstate = _nat.NativeKeyedState()

    def finish_time(self, time: int) -> None:
        if not self._tok:
            entries = self.take_input()
            if not entries:
                return
            for key, row, diff in entries:
                self.stream.append((time, key, row, diff))
            self.state.update(entries)
            return
        # token log: drain the raw buffer in ARRIVAL order (the log is the
        # scope's update history; take_segments would split the kinds)
        buf = self.buffers[0]
        if not buf:
            return
        self.buffers[0] = []
        self._nseg[0] = 0
        rows = 0
        i = 0
        n_items = len(buf)
        while i < n_items:
            seg = buf[i]
            if type(seg) is tuple:
                j = i
                while j < n_items and type(buf[j]) is tuple:
                    j += 1
                chunk = buf[i:j]
                if self._append_obj(time, chunk):
                    rows += len(chunk)
                    i = j
                    continue
                # plane-unrepresentable row: demote, replay the tail
                # (this chunk included — none of it reached the log)
                self.demote()
                tail: list[Entry] = []
                for seg2 in buf[i:]:
                    if type(seg2) is tuple:
                        tail.append(seg2)
                    else:
                        tail.extend(seg2.materialize())
                for key, row, d in tail:
                    self.stream.append((time, key, row, d))
                self.state.update(tail)
                self.rows_in += rows + len(tail)
                return
            rows += len(seg)
            self.stream.append((time, seg))
            self._nstate.update(seg.key_lo, seg.key_hi, seg.token, seg.diff)
            i += 1
        self.rows_in += rows

    def _append_obj(self, time: int, entries: list[Entry]) -> bool:
        """Intern a run of object entries onto the token log (+ keyed
        state). False (and no log/state mutation) when a row is not
        plane-representable — the caller demotes and replays."""
        n = len(entries)
        lo = np.empty(n, np.uint64)
        hi = np.empty(n, np.uint64)
        tok = np.empty(n, np.uint64)
        diff = np.empty(n, np.int64)
        for i, (key, row, d) in enumerate(entries):
            t = self._tab.intern_row(row)
            if t is None:
                return False
            kv = key.value
            lo[i] = kv & _MASK64
            hi[i] = kv >> 64
            tok[i] = t
            diff[i] = d
        for key, row, d in entries:
            self.stream.append((time, key, row, d))
        self._nstate.update(lo, hi, tok, diff)
        return True

    # --------------------------------------------------- plane transitions

    def _log_object_form(self) -> tuple[list, list[int]]:
        """The log with native items expanded to 4-tuples, in order, plus
        ``bounds``: old item index i -> its new index (len+1 entries)."""
        new: list = []
        bounds = [0]
        for item in self.stream:
            if len(item) == 4:
                new.append(item)
            else:
                t, nb = item
                new.extend((t, k, r, d) for (k, r, d) in nb.materialize())
            bounds.append(len(new))
        return new, bounds

    def _state_object_form(self) -> KeyedState:
        return nks_decode(self._nstate, self._tab)

    def demote(self) -> list[int]:
        """One-way switch to the object plane; returns the position-bounds
        map and notifies the owner (iterate) via ``on_demote``."""
        if not self._tok:
            return list(range(len(self.stream) + 1))
        self._tok = False
        self.stream, bounds = self._log_object_form()
        st = self._state_object_form()
        st.rows.update(self.state.rows)  # object rows seen mid-demotion
        self.state = st
        self._nstate = None
        if self.on_demote is not None:
            self.on_demote(self, bounds)
        return bounds

    # ------------------------------------------------- snapshots (object)

    def persist_state(self) -> dict:
        if not self._tok:
            return {"stream": self.stream, "state": self.state}
        stream, _bounds = self._log_object_form()
        return {"stream": stream, "state": self._state_object_form()}

    def restore_state(self, st: dict) -> None:
        self.stream = st["stream"]
        self.state = st["state"]
        if not self._tok:
            return
        nst = nks_encode(st["state"].rows, self._tab)
        if nst is None:
            # snapshot holds plane-unrepresentable rows: stay object
            self._tok = False
            self._nstate = None
            if self.on_demote is not None:
                self.on_demote(self, list(range(len(self.stream) + 1)))
            return
        self._nstate = nst
        self.state = KeyedState()  # token mode: the C store is the state


class SubscribeNode(Node):
    """pw.io.subscribe: per-row callbacks + time-end + end callbacks
    (reference: subscribe_table dataflow.rs:3645)."""

    def __init__(
        self,
        graph: Graph,
        inp: Node,
        on_change: Callable | None = None,
        on_time_end: Callable | None = None,
        on_end: Callable | None = None,
        sort_by_time: bool = True,
    ):
        super().__init__(graph, [inp])
        self.on_change = on_change
        self.on_time_end_cb = on_time_end
        self.on_end_cb = on_end
        self._ended = False

    def finish_time(self, time: int) -> None:
        entries = self.take_input()
        if entries and self.on_change is not None:
            for key, row, diff in consolidate(entries):
                reps = abs(diff)
                for _ in range(reps):
                    self.on_change(key, row, time, diff > 0)
        if entries and self.on_time_end_cb is not None:
            self.on_time_end_cb(time)

    def on_end(self, time: int) -> None:
        if not self._ended and self.on_end_cb is not None:
            self._ended = True
            self.on_end_cb()


class _TimeColNode(_TokTailNode):
    """Shared token-plane machinery for the temporal trio (buffer/forget/
    freeze — reference: operators/time_column.rs). Lowering passes numpy
    plans for the threshold/current expressions; a wave bulk-decodes the
    needed columns once, evaluates both plans vectorized, and the
    watermark logic runs over (kv, tok, diff, thr, cur) without touching
    Python rows."""

    def __init__(
        self,
        graph: Graph,
        inp: Node,
        threshold_fn: Callable[[Key, tuple], Any],
        current_fn: Callable[[Key, tuple], Any],
        native_plans: tuple | None = None,
    ):
        super().__init__(graph, [inp])
        self.threshold_fn = threshold_fn  # row's release threshold
        self.current_fn = current_fn  # row's event-time contribution to "now"
        self.now: Any = None
        self._plans = native_plans
        self._tok = self._tok and native_plans is not None
        if self._tok:
            self._needed_cols = sorted(
                native_plans[0].needed_cols | native_plans[1].needed_cols
            )

    def _tok_wave(self, time: int):
        """Drain + decode one wave: ((lo, hi, tok, diff) columns, thr[],
        cur[] numeric arrays, distinct flag) — or None after demotion
        (object path re-drains; nothing consumed). `distinct` means the
        wave is provably an all-+1 pairwise-distinct insert (every
        segment carried the ingest distinct hint): any row SUBSET emitted
        from it needs no output consolidation."""
        raw = self.take_segments()
        w = _wave_arrays(self._tab, *raw)
        distinct = not raw[1] and all(
            getattr(b, "distinct_hint", False) for b in raw[0]
        )
        thr = cur = None
        if w is not None and len(w[0]):
            decoded = decode_cols_dict(self._dp, self._tab, w[2], self._needed_cols)
            if decoded is not None:
                thr = _plan_array(self._plans[0], decoded, len(w[0]))
                cur = _plan_array(self._plans[1], decoded, len(w[0]))
        if w is None or (len(w[0]) and (thr is None or cur is None)):
            self._requeue([raw])
            self._demote()
            return None
        if thr is None:
            thr = cur = _EMPTY_I64
        return w, thr, cur, distinct

    def _demote(self) -> None:
        if not self._tok:
            return
        for attr, value in self._demoted_state().items():
            setattr(self, attr, value)
        self._tok = False


class BufferNode(_TimeColNode):
    """Postpone rows until the stream's max threshold passes their release
    time (reference: operators/time_column.rs postpone_core:380)."""

    _persist_attrs = ("now", "pending", "released")

    def __init__(
        self,
        graph: Graph,
        inp: Node,
        threshold_fn: Callable[[Key, tuple], Any],
        current_fn: Callable[[Key, tuple], Any],
        flush_on_end: bool = True,
        native_plans: tuple | None = None,
    ):
        super().__init__(graph, inp, threshold_fn, current_fn, native_plans)
        # token mode: _Live128Map pending (kv -> (tok, thr, diff) columns)
        # + _Key128Set released; object: {Key -> (row, diff, thr)} + set
        self.pending = _Live128Map(with_diff=True) if self._tok else {}
        self.released = _Key128Set() if self._tok else set()
        self.flush_on_end = flush_on_end
        self._virtual_end = False

    def _demoted_state(self) -> dict:
        tab = self._tab
        pending: dict = {}
        g = self.pending.items_arrays()
        if g is not None:
            plo, phi, ptok, pthr, pdiff = g
            tokl = ptok.tolist()
            thrl = pthr.tolist()
            dl = pdiff.tolist()
            for i, kv in enumerate(_kvs_of(plo, phi)):
                pending[Key(kv)] = (tab.row(tokl[i]), dl[i], thrl[i])
        return {
            "now": self.now,
            "pending": pending,
            "released": self.released.to_kv_set(),
        }

    def _encode_state(self, st: dict) -> bool:
        tab = self._tab
        n = len(st["pending"])
        lo = np.empty(n, np.uint64)
        hi = np.empty(n, np.uint64)
        tok = np.empty(n, np.uint64)
        dif = np.empty(n, np.int64)
        thr_f = np.empty(n, np.float64)
        thr_i = np.empty(n, np.int64)
        all_int = True
        any_big = False
        for i, (key, (row, d, thr)) in enumerate(st["pending"].items()):
            t = tab.intern_row(row)
            if t is None or not isinstance(thr, (int, float)):
                return False
            kv = key.value
            lo[i] = kv & _MASK64
            hi[i] = kv >> 64
            tok[i] = t
            dif[i] = d
            if isinstance(thr, int) and abs(thr) < (1 << 63):
                thr_i[i] = thr
                thr_f[i] = thr
                any_big = any_big or abs(thr) > _F53
            else:
                all_int = False
                # ints >= 2^63 don't fit int64 either: they force float
                # storage AND are always beyond float64 exactness
                any_big = any_big or isinstance(thr, int)
                thr_f[i] = thr
        if not all_int and any_big:
            return False  # float64 storage would round the big ints
        self.now = st["now"]
        self.pending = _Live128Map(with_diff=True)
        self.pending.apply(
            lo, hi, tok, thr_i if all_int else thr_f,
            np.ones(n, bool), diff=dif,
        )
        self.released = _Key128Set()
        self.released.add_kvs(st["released"])
        return True

    def _finish_tok(self, time: int) -> bool:
        res = self._tok_wave(time)
        if res is None:
            return False
        (lo, hi, tok, diff), thr, cur, distinct = res
        n = len(lo)
        if not n:
            return True
        pending = self.pending
        now = self.now
        if len(cur):
            cmax = cur.max().item()
            if now is None or cmax > now:
                now = cmax
        if not (
            pending.thr_compatible(thr)
            and pending.now_compatible(now)
            and _thr_cmp_exact(thr, now)
        ):
            # any float/big-int mix (stored, wave, or threshold-vs-
            # watermark) would round: fall back to the object plane's
            # exact Python-scalar comparisons. self.now is untouched —
            # the object replay recomputes it from the same entries.
            self._finish_object(time, self._demote_replay(lo, hi, tok, diff))
            return True
        self.now = now
        # bulk path: watermark already passed the row's threshold
        rel = (
            thr <= now if now is not None else np.zeros(n, bool)
        )
        extras: list = []  # (kv, tok, d) released via membership
        nr_idx = np.flatnonzero(~rel)
        rel_idx = np.flatnonzero(rel)
        if nr_idx.size and rel_idx.size:
            # keys with BOTH released and ahead-of-watermark rows in one
            # wave (in-wave time corrections) are order-sensitive: a row
            # releasing the key makes every LATER row of that key pass
            # through. Replay exactly the object algorithm, in row order,
            # for those keys only.
            keyv = _void16(lo, hi)
            inter = np.intersect1d(keyv[rel_idx], keyv[nr_idx])
            if inter.size:
                im = np.isin(keyv, inter)
                im_idx = np.flatnonzero(im)  # ascending = original order
                rel_idx = np.flatnonzero(rel & ~im)
                nr_idx = np.flatnonzero(~rel & ~im)
                premem = self.released.contains(
                    lo[im_idx], hi[im_idx]
                ).tolist()
                kv_i = _kvs_of(lo[im_idx], hi[im_idx])
                tok_i = tok[im_idx].tolist()
                d_i = diff[im_idx].tolist()
                thr_i = thr[im_idx].tolist()
                wave_released: set = set()
                for j, kv in enumerate(kv_i):
                    one = slice(im_idx[j], im_idx[j] + 1)
                    if (
                        kv in wave_released
                        or premem[j]
                        or (now is not None and thr_i[j] <= now)
                    ):
                        wave_released.add(kv)
                        extras.append((kv, tok_i[j], d_i[j]))
                        pending.apply(  # pop the key if pended
                            lo[one], hi[one], tok[one], thr[one],
                            np.zeros(1, bool),
                        )
                    else:
                        pending.apply(
                            lo[one], hi[one], tok[one], thr[one],
                            np.asarray([d_i[j] > 0]), diff=diff[one],
                        )
        member_idx = None
        if nr_idx.size:
            # rows ahead of the watermark: released-set membership decides
            # pass-through vs pending upsert/delete (bulk, row order;
            # member rows emit below as array slices — already released,
            # so no set update and no Python bigints)
            member = self.released.contains(lo[nr_idx], hi[nr_idx])
            if member.any():
                member_idx = nr_idx[member]
            pending.apply(
                lo[nr_idx], hi[nr_idx], tok[nr_idx], thr[nr_idx],
                (diff[nr_idx] > 0) & ~member, diff=diff[nr_idx],
            )
        if rel_idx.size:
            rlo, rhi = lo[rel_idx], hi[rel_idx]
            self.released.add_arrays(rlo, rhi)
            # a pending key released by this wave leaves the buffer —
            # probe the (small) pending key set with searchsorted and
            # append delete ops only for actual hits, instead of flooding
            # the pending store with one delete sentinel per released row
            g = pending.items_arrays()
            if g is not None:
                ps = np.sort(_void16(g[0], g[1]))
                relv = _void16(rlo, rhi)
                pos = np.searchsorted(ps, relv)
                pos[pos == len(ps)] = 0
                hitm = ps[pos] == relv
                if hitm.any():
                    idx2 = rel_idx[hitm]
                    pending.apply(
                        lo[idx2], hi[idx2], tok[idx2], thr[idx2],
                        np.zeros(len(idx2), bool),
                    )
        parts_lo = [lo[rel_idx]]
        parts_hi = [hi[rel_idx]]
        parts_tok = [tok[rel_idx]]
        parts_diff = [diff[rel_idx]]
        if member_idx is not None:
            parts_lo.append(lo[member_idx])
            parts_hi.append(hi[member_idx])
            parts_tok.append(tok[member_idx])
            parts_diff.append(diff[member_idx])
        pure_subset = distinct  # rel/member rows ⊆ one distinct wave
        if now is not None:
            # release pending rows whose threshold has passed
            plo, phi, ptok, pdiff = pending.expire(now)
            if len(plo):
                pure_subset = False  # held rows join from earlier waves
                self.released.add_arrays(plo, phi)
                parts_lo.append(plo)
                parts_hi.append(phi)
                parts_tok.append(ptok)
                parts_diff.append(pdiff)
        if extras:
            pure_subset = False
            self.released.add_kvs([kv for kv, _t, _d in extras])
            elo, ehi = _kv_cols([kv for kv, _t, _d in extras])
            parts_lo.append(elo)
            parts_hi.append(ehi)
            parts_tok.append(
                np.asarray([t for _kv, t, _d in extras], np.uint64)
            )
            parts_diff.append(
                np.asarray([d for _kv, _t, d in extras], np.int64)
            )
        self._emit_tok_arrays(
            time,
            np.concatenate(parts_lo),
            np.concatenate(parts_hi),
            np.concatenate(parts_tok),
            np.concatenate(parts_diff),
            consolidate_out=True,
            distinct=pure_subset,
        )
        return True

    def finish_time(self, time: int) -> None:
        if self._tok and self._finish_tok(time):
            return
        self._finish_object(time, self.take_input())

    def _finish_object(self, time: int, entries: list[Entry]) -> None:
        if not entries:
            return
        # The watermark ("now") advances once per wave, not per row: every
        # row in a wave sees the same frontier regardless of batch order
        # (worker-count invariance; matches the reference's per-timestamp
        # frontier in time_column.rs — the frontier moves between batches).
        for key, row, _diff in entries:
            cur = self.current_fn(key, row)
            if self.now is None or cur > self.now:
                self.now = cur
        out: list[Entry] = []
        for key, row, diff in entries:
            thr = self.threshold_fn(key, row)
            if key.value in self.released or (self.now is not None and thr <= self.now):
                self.released.add(key.value)
                out.append((key, row, diff))
                self.pending.pop(key, None)
            else:
                if diff > 0:
                    self.pending[key] = (row, diff, thr)
                else:
                    self.pending.pop(key, None)
        # release pending rows whose threshold has passed
        if self.now is not None:
            ready = [k for k, (_r, _d, thr) in self.pending.items() if thr <= self.now]
            for k in ready:
                row, diff, _ = self.pending.pop(k)
                self.released.add(k.value)
                out.append((k, row, diff))
        self.emit(time, consolidate(out))

    def on_end(self, time: int) -> None:
        if not self.flush_on_end:
            return
        if self._tok:
            g = self.pending.items_arrays()
            self.pending = _Live128Map(with_diff=True)
            if g is None:
                return
            plo, phi, ptok, _pthr, pdiff = g
            self.released.add_arrays(plo, phi)
            self._emit_tok_arrays(
                time, plo, phi, ptok, pdiff, consolidate_out=True
            )
            return
        if not self.pending:
            return
        out = [(k, row, diff) for k, (row, diff, _t) in self.pending.items()]
        self.pending.clear()
        for k, _r, _d in out:
            self.released.add(k.value)
        self.emit(time, consolidate(out))


class ForgetNode(_TimeColNode):
    """Retract rows older than the moving threshold; drop late arrivals
    (reference: time_column.rs forget:566 + ignore_late:677)."""

    _persist_attrs = ("now", "live")

    def __init__(
        self,
        graph: Graph,
        inp: Node,
        threshold_fn: Callable[[Key, tuple], Any],
        current_fn: Callable[[Key, tuple], Any],
        mark_forgetting_records: bool = False,
        native_plans: tuple | None = None,
    ):
        super().__init__(graph, inp, threshold_fn, current_fn, native_plans)
        # token mode: _Live128Map (kv -> (tok, thr) as numpy columns);
        # object: {Key -> (row, thr)}
        self.live = _Live128Map() if self._tok else {}

    def _demoted_state(self) -> dict:
        tab = self._tab
        live: dict = {}
        g = self.live.items_arrays()
        if g is not None:
            lo, hi, tok, thr, _diff = g
            thrl = thr.tolist()
            tokl = tok.tolist()
            for i, kv in enumerate(_kvs_of(lo, hi)):
                live[Key(kv)] = (tab.row(tokl[i]), thrl[i])
        return {"now": self.now, "live": live}

    def _encode_state(self, st: dict) -> bool:
        tab = self._tab
        n = len(st["live"])
        lo = np.empty(n, np.uint64)
        hi = np.empty(n, np.uint64)
        tok = np.empty(n, np.uint64)
        thr = np.empty(n, np.float64)
        thr_i = np.empty(n, np.int64)
        all_int = True
        any_big = False
        for i, (key, (row, th)) in enumerate(st["live"].items()):
            t = tab.intern_row(row)
            if t is None:
                return False
            if not isinstance(th, (int, float)):
                return False
            kv = key.value
            lo[i] = kv & _MASK64
            hi[i] = kv >> 64
            tok[i] = t
            if isinstance(th, int) and abs(th) < (1 << 63):
                thr_i[i] = th
                thr[i] = th
                any_big = any_big or abs(th) > _F53
            else:
                all_int = False
                # ints >= 2^63 don't fit int64 either: they force float
                # storage AND are always beyond float64 exactness
                any_big = any_big or isinstance(th, int)
                thr[i] = th
        if not all_int and any_big:
            return False  # float64 storage would round the big ints
        self.now = st["now"]
        self.live = _Live128Map()
        self.live.apply(
            lo, hi, tok, thr_i if all_int else thr, np.ones(n, bool)
        )
        return True

    def _finish_tok(self, time: int) -> bool:
        res = self._tok_wave(time)
        if res is None:
            return False
        (lo, hi, tok, diff), thr, cur, distinct = res
        n = len(lo)
        if not n:
            return True
        live = self.live
        now0 = self.now
        # the watermark advances from EVERY row's current-time value —
        # including late rows dropped below (object-plane parity)
        now = now0
        if len(cur):
            cmax = cur.max().item()
            if now is None or cmax > now:
                now = cmax
        if not (
            live.thr_compatible(thr)
            and live.now_compatible(now)
            and _thr_cmp_exact(thr, now)
            and _thr_cmp_exact(thr, now0)
        ):
            # any float/big-int mix (stored, wave, or threshold-vs-
            # watermark) would round: fall back to the object plane's
            # exact Python-scalar comparisons (self.now untouched)
            self._finish_object(time, self._demote_replay(lo, hi, tok, diff))
            return True
        if now0 is not None:
            keep = ~((thr <= now0) & (diff > 0))  # drop late insertions
            if not keep.all():
                lo, hi, tok = lo[keep], hi[keep], tok[keep]
                diff, thr = diff[keep], thr[keep]
        live.apply(lo, hi, tok, thr, diff > 0)  # upserts + deletes, row order
        self.now = now
        pure_subset = distinct
        if now is not None:
            elo, ehi, etok, _ed = live.expire(now)
            if len(elo):
                pure_subset = False  # expiry retractions join the wave
                lo = np.concatenate([lo, elo])
                hi = np.concatenate([hi, ehi])
                tok = np.concatenate([tok, etok])
                diff = np.concatenate(
                    [diff, np.full(len(elo), -1, np.int64)]
                )
        self._emit_tok_arrays(
            time, lo, hi, tok, diff, consolidate_out=True,
            distinct=pure_subset,
        )
        return True

    def finish_time(self, time: int) -> None:
        if self._tok:
            if self._finish_tok(time):
                return
        entries = self.take_input()
        self._finish_object(time, entries)

    def _finish_object(self, time: int, entries: list[Entry]) -> None:
        if not entries:
            return
        # Late-row checks use the PREVIOUS wave's watermark; the watermark
        # advances once at the end of the wave (order/worker-count
        # invariant — the reference's frontier moves between batches,
        # time_column.rs forget:566 + ignore_late:677).
        now0 = self.now
        out: list[Entry] = []
        for key, row, diff in entries:
            thr = self.threshold_fn(key, row)
            if now0 is not None and thr <= now0 and diff > 0:
                # late row: ignore
                continue
            out.append((key, row, diff))
            if diff > 0:
                self.live[key] = (row, thr)
            else:
                self.live.pop(key, None)
        for key, row, _diff in entries:
            cur = self.current_fn(key, row)
            if self.now is None or cur > self.now:
                self.now = cur
        # retract rows that have fallen behind the advanced threshold
        if self.now is not None:
            expired = [k for k, (_r, thr) in self.live.items() if thr <= self.now]
            for k in expired:
                row, _ = self.live.pop(k)
                out.append((k, row, -1))
        self.emit(time, consolidate(out))


class FreezeNode(_TimeColNode):
    """Ignore updates/retractions to rows past the freeze threshold
    (reference: time_column.rs freeze via dataflow.rs:1555)."""

    _persist_attrs = ("now",)

    def __init__(
        self,
        graph: Graph,
        inp: Node,
        threshold_fn: Callable[[Key, tuple], Any],
        current_fn: Callable[[Key, tuple], Any],
        native_plans: tuple | None = None,
    ):
        super().__init__(graph, inp, threshold_fn, current_fn, native_plans)

    def _demoted_state(self) -> dict:
        return {"now": self.now}

    def _encode_state(self, st: dict) -> bool:
        self.now = st["now"]
        return True

    def _finish_tok(self, time: int) -> bool:
        res = self._tok_wave(time)
        if res is None:
            return False
        (lo, hi, tok, diff), thr, cur, distinct = res
        if not len(lo):
            return True
        now0 = self.now
        if not _thr_cmp_exact(thr, now0):
            # int/float watermark mix beyond 2^53 would round: object
            # plane's exact scalar comparisons take over
            self._finish_object(time, self._demote_replay(lo, hi, tok, diff))
            return True
        if now0 is not None:
            keep = thr > now0  # frozen region: drop the change
            lo, hi, tok, diff = lo[keep], hi[keep], tok[keep], diff[keep]
            cur = cur[keep]
        now = now0
        if len(cur):  # only accepted rows advance the clock
            cmax = cur.max().item()
            if now is None or cmax > now:
                now = cmax
        self.now = now
        self._emit_tok_arrays(
            time, lo, hi, tok, diff, consolidate_out=True, distinct=distinct
        )
        return True

    def finish_time(self, time: int) -> None:
        if self._tok and self._finish_tok(time):
            return
        self._finish_object(time, self.take_input())

    def _finish_object(self, time: int, entries: list[Entry]) -> None:
        if not entries:
            return
        # freeze checks use the previous wave's watermark; advance at wave
        # end (order/worker-count invariant; see ForgetNode)
        now0 = self.now
        out: list[Entry] = []
        for key, row, diff in entries:
            thr = self.threshold_fn(key, row)
            if now0 is not None and thr <= now0:
                continue  # frozen region: drop the change
            out.append((key, row, diff))
        for key, row, _diff in out:  # only accepted rows advance the clock
            cur = self.current_fn(key, row)
            if self.now is None or cur > self.now:
                self.now = cur
        self.emit(time, consolidate(out))


class GradualBroadcastNode(_TokTailNode):
    """Broadcast (lower, value, upper) from a small table onto every row of a
    big table with hysteresis (reference: operators/gradual_broadcast.rs:65).

    Token mode: the big side stays key-level ({kv -> tok}, rows never
    decode); only the small hysteresis table (a handful of rows) takes
    the object path for its lvu expressions."""

    _persist_attrs = ("current", "big_state", "emitted")

    def __init__(
        self,
        graph: Graph,
        big: Node,
        small: Node,
        lvu_fn: Callable[[Key, tuple], tuple],
    ):
        super().__init__(graph, [big, small])
        self.lvu_fn = lvu_fn
        self.current: Any = None  # (lower, value, upper)
        if self._tok:
            self.big_state: Any = {}
            self.emitted: Any = {}  # kv -> broadcast value
        else:
            self.big_state = KeyedState()
            self.emitted = {}

    def _demoted_state(self) -> dict:
        return {
            "current": self.current,
            "big_state": _keyed_state_of(self._rowdict_obj(self.big_state)),
            "emitted": {Key(kv): v for kv, v in self.emitted.items()},
        }

    def _encode_state(self, st: dict) -> bool:
        big = self._rowdict_tok(st["big_state"])
        if big is None:
            return False
        self.current = st["current"]
        self.big_state = big
        self.emitted = {k.value: v for k, v in st["emitted"].items()}
        return True

    def _finish_tok(self, time: int) -> bool:
        raw_b = self.take_segments(0)
        raw_s = self.take_segments(1)
        bw = _wave_triples(self._tab, *raw_b)
        if bw is None:
            self._requeue([raw_b, raw_s])
            self._demote()
            return False
        sb = _flatten_segments(*raw_s)
        if not bw and not sb:
            return True
        new_value = self.current[1] if self.current else None
        sb = sorted(sb, key=lambda e: e[0].value)
        for key, row, diff in sb:
            if diff > 0:
                lower, value, upper = self.lvu_fn(key, row)
                if (
                    self.current is None
                    or value < self.current[0]
                    or value > self.current[2]
                ):
                    self.current = (lower, value, upper)
                    new_value = value
        _tok_update_keyed(self.big_state, bw)
        big = self.big_state
        emitted = self.emitted
        changed_all = new_value is not None and (
            not emitted or any(v != new_value for v in emitted.values())
        )
        val_tok = None
        if new_value is not None:
            val_tok = self._tab.intern_row((new_value,))
            if val_tok is None:  # non-scalar broadcast value
                self._demote()
                bb = [(Key(kv), self._tab.row(t), d) for kv, t, d in bw]
                self._finish_object(time, bb, sb, resorted=True)
                return True
        old_toks: dict = {}
        kvs: list = []
        toks: list = []
        diffs: list = []

        def old_tok_of(v):
            t = old_toks.get(v)
            if t is None:
                t = old_toks[v] = self._tab.intern_row((v,))
            return t

        targets = (
            big.keys()
            if changed_all
            else [kv for kv, _t, d in bw if d > 0 and kv in big]
        )
        for kv in list(targets):
            old = emitted.get(kv)
            if old is not None and old != new_value:
                kvs.append(kv)
                toks.append(old_tok_of(old))
                diffs.append(-1)
            if new_value is not None and old != new_value:
                kvs.append(kv)
                toks.append(val_tok)
                diffs.append(1)
                emitted[kv] = new_value
        # retractions of removed big rows
        for kv, _t, d in bw:
            if d < 0 and kv in emitted and kv not in big:
                kvs.append(kv)
                toks.append(old_tok_of(emitted.pop(kv)))
                diffs.append(-1)
        self._emit_tok(time, kvs, toks, diffs, consolidate_out=True)
        return True

    def finish_time(self, time: int) -> None:
        if self._tok:
            if self._finish_tok(time):
                return
        bb = self.take_input(0)
        sb = self.take_input(1)
        if not bb and not sb:
            return
        self._finish_object(time, bb, sb)

    def _finish_object(
        self, time: int, bb: list[Entry], sb: list[Entry], resorted: bool = False
    ) -> None:
        new_value = self.current[1] if self.current else None
        # canonical order within the wave (worker-count invariance)
        sb = sorted(sb, key=lambda e: e[0].value)
        for key, row, diff in sb:
            if diff > 0:
                lower, value, upper = self.lvu_fn(key, row)
                if (
                    self.current is None
                    or value < self.current[0]
                    or value > self.current[2]
                ):
                    self.current = (lower, value, upper)
                    new_value = value
        self.big_state.update(bb)
        out: list[Entry] = []
        changed_all = new_value is not None and (
            not self.emitted or any(v != new_value for v in self.emitted.values())
        )
        targets = self.big_state.items() if changed_all else [
            (k, self.big_state.get(k)) for k, _r, d in bb if d > 0 and self.big_state.get(k) is not None
        ]
        for key, _row in list(targets):
            old = self.emitted.get(key)
            if old is not None and old != new_value:
                out.append((key, (old,), -1))
            if new_value is not None and old != new_value:
                out.append((key, (new_value,), 1))
                self.emitted[key] = new_value
        # retractions of removed big rows
        for key, _row, diff in bb:
            if diff < 0 and key in self.emitted and self.big_state.get(key) is None:
                out.append((key, (self.emitted.pop(key),), -1))
        self.emit(time, consolidate(out))


class ExternalIndexNode(Node):
    """Feed index-table diffs into a mutable host/device index; answer query
    rows with top-k matches, optionally augmented with data-table columns.

    Reference parity: UseExternalIndexAsOfNow
    (src/engine/dataflow/operators/external_index.rs:38,
    src/engine/dataflow.rs:2224) generalized with a non-as-of-now mode
    (answers update when the index changes) and built-in result repacking
    (the reference does repacking in Python via flatten+ix,
    stdlib/indexing/data_index.py:294).

    Inputs: [index_table, query_table] (+ [data_table] unless mode='reply').
    Modes:
      'reply'    -> (reply,) where reply = ((doc_key, score), ...)
      'collapse' -> query_row + (data_col_tuple, ...) + (scores, ids)
      'flat'     -> one row per match: query_row + data_row + (score, id)
    """

    _persist_attrs = (
        "host_index", "query_state", "data_state", "indexed", "emitted",
        "matches",
    )

    def persist_signature(self) -> str:
        return (
            f"ExternalIndexNode/{self.mode}/{int(self.asof_now)}"
            f"/{self.data_width}/{type(self.host_index).__name__}"
        )

    def __init__(
        self,
        graph: Graph,
        inputs: Sequence[Node],
        host_index: Any,
        index_fn: Callable[[Key, tuple], tuple],  # -> (data, metadata | None)
        query_fn: Callable[[Key, tuple], tuple],  # -> (qdata, k, filter | None)
        mode: str = "reply",
        asof_now: bool = True,
        data_width: int = 0,
    ):
        super().__init__(graph, inputs)
        self.host_index = host_index
        self.index_fn = index_fn
        self.query_fn = query_fn
        self.mode = mode
        self.asof_now = asof_now
        self.data_width = data_width
        self.query_state = KeyedState()
        self.data_state = KeyedState()
        self.indexed: dict[Key, Any] = {}  # doc key -> data fed to the index
        # emitted: qkey -> list[(out_key, out_row)]
        self.emitted: dict[Key, list[tuple[Key, tuple]]] = {}
        # raw matches memo: qkey -> [(doc_key, score)] — lets data-only waves
        # re-pack rows without re-running the search
        self.matches: dict[Key, list] = {}

    def index_tiers(self) -> list:
        """Tiered ANN indexes behind this node (verifier contract
        surface — `index-tier-contract`). Unwraps the rerank wrapper;
        non-tiered and exact indexes contribute nothing."""
        hi = self.host_index
        hi = getattr(hi, "inner", hi)
        if getattr(hi, "_tiers", None) is not None:
            return [hi]
        return []

    def _search_many(
        self, queries: list[tuple[Key, tuple]]
    ) -> dict[Key, list] | None:
        """Run a wave's searches in ONE batched index call (the TPU index
        fuses the whole batch into a single matmul+top-k program).

        Returns qkey -> [(doc_key, score)] with [] for unanswerable queries,
        or None when the whole batched search failed (callers must then keep
        previously emitted answers instead of dropping them).
        """
        results: dict[Key, list] = {}
        prepared: list[tuple[Key, tuple]] = []
        for qkey, qrow in queries:
            try:
                qdata, k, flt = self.query_fn(qkey, qrow)
            except Exception as e:  # noqa: BLE001
                self.log_error(f"index query: {type(e).__name__}: {e}")
                results[qkey] = []
                continue
            if isinstance(qdata, ErrorValue) or qdata is None:
                results[qkey] = []
                continue
            prepared.append((qkey, (qdata, int(k), flt)))
        if not prepared:
            return results
        try:
            if hasattr(self.host_index, "search_batch"):
                all_matches = self.host_index.search_batch(
                    [item for _k, item in prepared]
                )
            else:
                all_matches = [
                    self.host_index.search(q, k, f) for _key, (q, k, f) in prepared
                ]
        except Exception as e:  # noqa: BLE001
            self.log_error(f"index search: {type(e).__name__}: {e}")
            return None
        for (qkey, _item), matches in zip(prepared, all_matches):
            results[qkey] = matches
        return results

    def _repack(
        self, qkey: Key, qrow: tuple, matches: list
    ) -> list[tuple[Key, tuple]]:
        if self.mode == "reply":
            reply = tuple((dk, float(s)) for dk, s in matches)
            return [(qkey, (reply,))]
        data_rows = []
        for dk, s in matches:
            drow = self.data_state.get(dk)
            if drow is None:
                drow = (None,) * self.data_width
            data_rows.append((dk, float(s), drow))
        if self.mode == "collapse":
            cols = tuple(
                tuple(dr[i] for (_dk, _s, dr) in data_rows)
                for i in range(self.data_width)
            )
            scores = tuple(s for (_dk, s, _dr) in data_rows)
            ids = tuple(dk for (dk, _s, _dr) in data_rows)
            return [(qkey, qrow + cols + (scores, ids))]
        # flat
        out = []
        for rank, (dk, s, drow) in enumerate(data_rows):
            out.append(
                (Key(hash_values(qkey, rank)), qrow + drow + (s, dk))
            )
        return out

    def finish_time(self, time: int) -> None:
        idx_batch = self.take_input(0)
        q_batch = self.take_input(1)
        d_batch = self.take_input(2) if len(self.inputs) > 2 else []
        if not idx_batch and not q_batch and not d_batch:
            return
        # Apply index mutations: removals before additions so a same-wave
        # (-old, +new) update nets to the new value, and a retraction only
        # evicts when it matches what is actually indexed (KeyedState-style
        # equality guard — an unordered (+new, -old) pair must not delete
        # the fresh document).
        index_changed = False
        idx_batch = consolidate(idx_batch)
        for phase in (0, 1):  # 0: removals, 1: additions
            for key, row, diff in idx_batch:
                if (diff < 0) != (phase == 0):
                    continue
                try:
                    data, meta = self.index_fn(key, row)
                except Exception as e:  # noqa: BLE001
                    self.log_error(f"index row: {type(e).__name__}: {e}")
                    continue
                try:
                    if diff > 0:
                        self.host_index.add(key, data, meta)
                        self.indexed[key] = data
                        index_changed = True
                    elif key in self.indexed and freeze_value(
                        self.indexed[key]
                    ) == freeze_value(data):
                        self.host_index.remove(key)
                        del self.indexed[key]
                        index_changed = True
                except Exception as e:  # noqa: BLE001
                    self.log_error(f"index update: {type(e).__name__}: {e}")
        if d_batch:
            self.data_state.update(d_batch)
        out: list[Entry] = []

        def retract(qkey: Key) -> None:
            for okey, orow in self.emitted.pop(qkey, []):
                out.append((okey, orow, -1))

        # group the query batch per key so an update (-old, +new) in one
        # wave retracts once and answers once, regardless of entry order
        q_batch = consolidate(q_batch)
        self.query_state.update(q_batch)
        changed_queries: dict[Key, None] = {k: None for k, _r, _d in q_batch}
        repack_only: list[Key] = []
        if not self.asof_now and (index_changed or d_batch):
            for qkey in self.query_state.rows:
                if qkey in changed_queries:
                    continue
                if index_changed or qkey not in self.matches:
                    changed_queries[qkey] = None
                else:
                    # data-table-only change: the match set is intact, only
                    # the attached rows need re-packing — skip the search
                    repack_only.append(qkey)
        to_search = [
            (qkey, qrow)
            for qkey in changed_queries
            if (qrow := self.query_state.get(qkey)) is not None
        ]
        searched = self._search_many(to_search)
        if searched is None:
            # batched search failed: keep existing answers for live queries,
            # only retract queries that were themselves removed
            for qkey in changed_queries:
                if self.query_state.get(qkey) is None:
                    retract(qkey)
                    self.matches.pop(qkey, None)
            searched = {}
        else:
            for qkey in changed_queries:
                retract(qkey)
                self.matches.pop(qkey, None)
        for qkey, matches in searched.items():
            qrow = self.query_state.get(qkey)
            if qrow is None:
                continue
            self.matches[qkey] = matches
            results = self._repack(qkey, qrow, matches)
            if results:
                self.emitted[qkey] = results
            for okey, orow in results:
                out.append((okey, orow, 1))
        for qkey in repack_only:
            qrow = self.query_state.get(qkey)
            if qrow is None:
                continue
            retract(qkey)
            results = self._repack(qkey, qrow, self.matches[qkey])
            if results:
                self.emitted[qkey] = results
            for okey, orow in results:
                out.append((okey, orow, 1))
        self.emit(time, consolidate(out))
