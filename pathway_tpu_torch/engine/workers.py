"""Multi-worker execution: sharded operators + the wave-boundary exchange.

Reference parity: the reference runs N timely workers, each building the
same dataflow, with records hash-exchanged between workers on every
stateful operator's key (docs 10.worker-architecture.md:37-43,
src/engine/dataflow/shard.rs `Shard` impls; the exchange pact comes from
vendored timely). Here the same model is expressed per-operator: a
`ShardedNode` owns N replicas ("workers") of a stateful node, each holding
the shard of that node's state for the keys routed to it. At every wave
boundary the node's input batches are exchanged — partitioned by the
operator's shard key (record key for keyed nodes, join key for joins,
group key for reductions) — and the replicas run concurrently on the
worker pool. Worker-count invariance holds because routing partitions
exactly along each operator's state key: every group/jk/key sees all its
entries in one replica, in arrival order.

Threads, not processes, execute the replicas (PATHWAY_THREADS=N): pure
Python sections serialize on the GIL, but the native kernel hot paths
(zs_agg groupby aggregation, tokenizers — ctypes calls release the GIL)
and any numeric-plane JAX dispatches genuinely parallelize. The
TPU-mesh exchange primitive for numeric columns is
`pathway_tpu_torch.parallel.exchange` (an `all_to_all` over ICI); this module is
the host-side control-plane equivalent for arbitrary Python rows.
"""

from __future__ import annotations

import hashlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Sequence

from pathway_tpu_torch.engine.core import Entry, Graph, InputNode, Node
from pathway_tpu_torch.engine import morsel as _morsel
from pathway_tpu_torch.analysis import lockgraph as _lockgraph

# Route functions map (key, row) -> an int or hashable token; the shard is
# token % n_shards (ints, e.g. Key.value) or hash(token) % n_shards.
RouteFn = Callable[[Any, tuple], Any]

_POOL: ThreadPoolExecutor | None = None
_POOL_LOCK = _lockgraph.register_lock("workers.pool", threading.Lock())


def worker_threads() -> int:
    """PATHWAY_THREADS, read per-session so tests can flip it in-process."""
    try:
        return max(1, int(os.environ.get("PATHWAY_THREADS", "1")))
    except ValueError:
        return 1


def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(
                max_workers=max(4, (os.cpu_count() or 1)),
                thread_name_prefix="pw-worker",
            )
    return _POOL


class _FinishTask:
    """One replica-wave morsel: ``replica.finish_time(t)`` as a repeat-
    free callable (a bound closure per replica would pin `time` fine
    too; a named task keeps steal traces readable)."""

    __slots__ = ("replica", "time")

    def __init__(self, replica: Node, time: int):
        self.replica = replica
        self.time = time

    def __call__(self) -> None:
        self.replica.finish_time(self.time)


class _Collector:
    """Duck-typed downstream sink capturing one replica's emits (entry
    lists or NativeBatch segments, kept as segments)."""

    __slots__ = ("segments",)

    def __init__(self) -> None:
        self.segments: list = []

    def accept(self, input_idx: int, entries) -> None:
        if type(entries) is list:
            if entries:
                self.segments.append(entries)
        else:
            self.segments.append(entries)

    def take(self) -> list:
        out, self.segments = self.segments, []
        return out


def _canon(v: Any) -> Any:
    """Normalize a shard token so routing agrees with Python equality:
    1 == 1.0 == True must route identically (a group key mixing int and
    float forms is ONE group to the operator's dict state)."""
    if isinstance(v, tuple):
        return tuple(_canon(x) for x in v)
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, float) and v.is_integer():
        return int(v)  # also folds -0.0 -> 0
    return v


def native_shards(batch: Any, plan: Any, n: int):
    """Shard array for a NativeBatch under a route plan (('key',) |
    ('group', cols) | ('ptr_col', col)), or None when the plan can't
    judge the batch. The SINGLE dispatch point for thread- AND
    process-level native routing — both must agree byte-for-byte with
    _shard_of."""
    if plan is None:
        return None
    from pathway_tpu_torch.engine.native import dataplane as dp

    if plan[0] == "key":
        return dp.route_key(batch.key_lo, batch.key_hi, n)
    if plan[0] == "ptr_col":
        # route by the pointer column's key128 (ix colocation); batches
        # holding a non-Key pointer fall back to the object route
        res = dp.decode_key_col(batch.tab, batch.token, plan[1])
        if res is None or (res[2] != 0).any():
            return None
        return dp.route_key(res[0], res[1], n)
    res = dp.project_group(batch.tab, batch.token, plan[1], n_shards=n)
    return None if res is None else res[1]


def _shard_of(token: Any, n: int) -> int:
    """Process-stable shard assignment. Python's hash() is salted per
    process (PYTHONHASHSEED), which would route a group to a different
    worker after restart — operator snapshots store per-shard state, so
    routing must be a pure function of the token's content.

    Non-int tokens hash via blake2b of the token's canonical value
    serialization — the same bytes the native data plane computes in C++
    (dataplane.cpp dp_project_group), so a batch routed natively and a
    row routed here always land on the same shard."""
    if isinstance(token, bool):
        return int(token) % n
    if isinstance(token, int):
        return token % n
    from pathway_tpu_torch.internals.keys import _serialize_value

    out: list[bytes] = []
    try:
        _serialize_value(_canon(token), out)
        payload = b"".join(out)
    except Exception:  # noqa: BLE001 — exotic token: stable repr fallback
        payload = repr(_canon(token)).encode()
    digest = hashlib.blake2b(payload, digest_size=16).digest()
    return int.from_bytes(digest[:8], "little") % n


class ShardedNode(Node):
    """N replicas of a stateful node, each owning one key-range shard.

    `factory(graph, input_nodes) -> Node` builds one replica; replicas are
    constructed against a private throwaway graph (never stepped) with
    dummy inputs, and their emits are captured by per-replica collectors.
    `route_fns[i]` gives the shard key for entries arriving on input i.
    """

    def __init__(
        self,
        graph: Graph,
        inputs: Sequence[Node],
        factory: Callable[[Graph, list[Node]], Node],
        route_fns: Sequence[RouteFn],
        n_shards: int,
        native_routes: Sequence[Any] | None = None,
    ):
        super().__init__(graph, inputs)
        assert len(route_fns) == len(inputs)
        self.route_fns = list(route_fns)
        # per input: None, ('key',) — record-key routing — or
        # ('group', [col_idx...]) — group-key routing; lets NativeBatch
        # segments split across replicas without materializing (the C
        # routing is byte-identical to _shard_of, see dataplane.cpp)
        self.native_routes = list(native_routes or [None] * len(inputs))
        self.n_shards = n_shards
        self.replicas: list[Node] = []
        self.collectors: list[_Collector] = []
        for _ in range(n_shards):
            shadow = Graph()
            shadow.terminate_on_error = graph.terminate_on_error
            dummies = [InputNode(shadow) for _ in inputs]
            replica = factory(shadow, list(dummies))
            collector = _Collector()
            replica.downstream = [(collector, 0)]  # type: ignore[list-item]
            self.replicas.append(replica)
            self.collectors.append(collector)

    # -------------------------------------------------------------- exchange

    def _exchange(self, input_idx: int, entries: list[Entry]) -> list[int]:
        """Partition one input batch across replicas by the shard key.

        Returns the list of replica ids that received data. Entries whose
        route function fails go to shard 0 (the replica re-evaluates the
        same expression and logs the error through the normal path).
        """
        n = self.n_shards
        route = self.route_fns[input_idx]
        # ICI data plane: vector-carrying rows move their numeric payload
        # over the device mesh (PATHWAY_DEVICE_EXCHANGE=1); control
        # metadata stays host-side. Routing is the same _shard_of rule.
        from pathway_tpu_torch.parallel.device_exchange import engine_exchanger

        dev = engine_exchanger()
        if dev is not None:

            def shard_of_entry(key: Any, row: tuple) -> int:
                return _shard_of(route(key, row), n)

            routed = dev.try_exchange(entries, shard_of_entry, n)
            if routed is not None:
                touched = []
                for s, ents in enumerate(routed):
                    if ents:
                        self.replicas[s].accept(input_idx, ents)
                        touched.append(s)
                return touched
        buckets: list[list[Entry]] = [[] for _ in range(n)]
        for entry in entries:
            key, row, _diff = entry
            try:
                s = _shard_of(route(key, row), n)
            except Exception:  # noqa: BLE001 - replica will log it
                s = 0
            buckets[s].append(entry)
        touched = []
        for s in range(n):
            if buckets[s]:
                self.replicas[s].accept(input_idx, buckets[s])
                touched.append(s)
        return touched

    def _exchange_native(self, input_idx: int, batch: Any) -> list[int]:
        """Split a NativeBatch across replicas without materializing.
        Falls back to the object plane when this input has no native
        route plan or the C routing rejects the batch."""
        plan = self.native_routes[input_idx]
        if plan is not None:
            import numpy as np

            shards = native_shards(batch, plan, self.n_shards)
            if shards is not None:
                # sharded column plane: the batch's scalar columns cross
                # as ONE device collective along the host-exact routing
                # (PATHWAY_DEVICE_EXCHANGE; row order identical to the
                # select path below)
                from pathway_tpu_torch.parallel.column_plane import (
                    engine_column_exchanger,
                )

                ce = engine_column_exchanger()
                if ce is not None:
                    subs = ce.split_batch(batch, shards, self.n_shards)
                    if subs is not None:
                        touched = []
                        for s, sub in enumerate(subs):
                            if len(sub):
                                self.replicas[s].accept(input_idx, sub)
                                touched.append(s)
                        return touched
                touched = []
                for s in np.unique(shards):
                    sub = batch.select(shards == s)
                    self.replicas[int(s)].accept(input_idx, sub)
                    touched.append(int(s))
                return touched
        return self._exchange(input_idx, batch.materialize())

    def finish_time(self, time: int) -> None:
        active: set[int] = set()
        for i in range(len(self.inputs)):
            batches, entries = self.take_segments(i)
            for b in batches:
                active.update(self._exchange_native(i, b))
            if entries:
                active.update(self._exchange(i, entries))
        if not active:
            return
        ordered = sorted(active)
        if len(ordered) == 1:
            self.replicas[ordered[0]].finish_time(time)
        elif _morsel.enabled_cached():
            # per-replica morsel queues drained with work stealing: the
            # frontier/static pump no longer pins a replica to the pool
            # thread that happened to receive its future — idle threads
            # drain a straggler's queue instead of blocking the barrier
            # (emission stays on this thread, in replica order, below)
            _morsel.run_stealing(
                [[_FinishTask(self.replicas[s], time)] for s in ordered]
            )
        else:
            futures = [
                _pool().submit(self.replicas[s].finish_time, time)
                for s in ordered
            ]
            for f in futures:
                f.result()  # wave barrier; re-raises replica errors
        self._emit_collected(time, ordered)

    def _emit_collected(self, time: int, shards: Iterable[int]) -> None:
        out: list[Entry] = []
        for s in shards:
            for seg in self.collectors[s].take():
                if type(seg) is list:
                    out.extend(seg)
                else:
                    if out:
                        self.emit(time, out)
                        out = []
                    self.emit(time, seg)
        if out:
            self.emit(time, out)

    def on_end(self, time: int) -> None:
        # Graph.end runs on_end then finish_time per node in topo order, so
        # emitting here still reaches downstream buffers before they close.
        # (No sharded node type currently implements on_end; this keeps the
        # wrapper correct for any future one.)
        for s in range(self.n_shards):
            self.replicas[s].on_end(time)
        self._emit_collected(time, range(self.n_shards))

    # ----------------------------------------------- operator snapshots

    def persist_signature(self) -> str:
        # worker-count independent: a snapshot taken at PATHWAY_THREADS=N
        # restores at M by re-partitioning along the shard key (the
        # checkpoint manager adapts the state before restore_state runs)
        return self.replicas[0].persist_signature()

    def persist_state(self) -> dict | None:
        shards = [r.persist_state() for r in self.replicas]
        if all(s is None for s in shards):
            return None
        return {"n_shards": self.n_shards, "shards": shards}

    def restore_state(self, state: dict) -> None:
        if state.get("n_shards") != self.n_shards:
            # the checkpoint manager rescales before applying; reaching
            # here means a caller skipped adaptation
            raise RuntimeError(
                f"snapshot has {state.get('n_shards')} worker shards, "
                f"session has {self.n_shards} (rescale adaptation missing)"
            )
        for replica, st in zip(self.replicas, state["shards"]):
            if st is not None:
                replica.restore_state(st)

    def rescale_state(self, state: dict) -> dict:
        """Re-partition a snapshot taken at a different worker count onto
        this node's shards (raises RescaleUnsupported when the inner node
        type cannot express its routing)."""
        template = self.replicas[0]
        shards = (
            [s for s in state["shards"] if s is not None]
            if "n_shards" in state
            else [state]
        )
        merged = template.merge_shard_states(shards)
        n = self.n_shards
        parts = template.split_shard_state(
            merged, n, lambda tok: _shard_of(tok, n)
        )
        return {"n_shards": n, "shards": parts}

    # Aggregate observability over replicas (rows_in counted at exchange).
    @property
    def shard_rows(self) -> list[tuple[int, int]]:
        return [(r.rows_in, r.rows_out) for r in self.replicas]


def adapt_shard_state(node: Any, st: dict) -> dict:
    """Re-shape a snapshot for the node's current worker layout: rescales
    ShardedNode states across PATHWAY_THREADS changes, merges multi-shard
    snapshots into unsharded sessions, and recurses into nodes embedding a
    sub-graph (IterateNode) whose states carry per-node `sub` lists.
    Raises RescaleUnsupported when an operator cannot re-partition — the
    checkpoint manager catches it in its read phase and falls back to
    journal replay before any node has mutated."""
    if isinstance(node, ShardedNode):
        if st.get("n_shards") == node.n_shards:
            return st
        return node.rescale_state(st)
    sub_graph = getattr(node, "sub_graph", None)
    if sub_graph is not None and isinstance(st, dict) and "sub" in st:
        st = dict(st)
        st["sub"] = [
            None if s is None else adapt_shard_state(n2, s)
            for n2, s in zip(sub_graph.nodes, st["sub"])
        ]
        return st
    if "n_shards" in st and "shards" in st:
        # snapshot from a multi-worker run restoring into an unsharded
        # session: merge the shard states
        return node.merge_shard_states(
            [s for s in st["shards"] if s is not None]
        )
    return st


class ProcessExchangeNode(Node):
    """Inter-process exchange boundary: one per stateful-operator input.

    The wave's batch partitions by the operator's shard key across
    processes (bucket p goes to process p over the TCP mesh); the
    downstream operator (optionally thread-sharded on top) owns its
    shard exclusively: every key lives on exactly one process.

    Two delivery protocols share the split logic:

      * frontier mode (default, ``Runtime.run_mesh``): ``finish_time``
        only SENDS — buckets cross the wire tagged with their
        timestamp, and the receiving pump injects them below the peer's
        replica of this node (``inject_remote``) once its input
        frontier passes that time. No blocking, no per-wave barrier: a
        slow peer delays only the operators consuming its wire.
      * lockstep BSP (deprecated fallback, ``run_lockstep``): the node
        BLOCKS until every peer's bucket for this (node, round)
        arrives — the old global wave barrier.

    `route` maps (key, row) -> shard token; None routes everything to
    process 0 (operators with global state: buffers, gradual broadcast,
    external indexes, iterate).
    """

    def __init__(
        self,
        graph: Graph,
        inp: Node,
        mesh: Any,
        route: RouteFn | None,
        wire_id: int,
        native_route: Any = None,
    ):
        super().__init__(graph, [inp])
        self.mesh = mesh
        self.route = route
        # plan-node label: exchange boundaries are not spec-built, so the
        # wire id is their identity in metrics/monitors
        self.label = f"exchange:w{wire_id}"
        # token-resident route plan (('key',) | ('group', cols)): native
        # batches split in C and cross the mesh in wire form — unique-row
        # blob + flat arrays — instead of per-row pickled tuples
        self.native_route = native_route
        # wire identity: must match across processes (same program, same
        # creation order) and be unique across sessions sharing one
        # process-wide mesh — the lowering allocates it
        self.wire_id = wire_id
        self.round = 0
        # frontier protocol switches (set by Runtime.run_mesh)
        self.frontier_mode = False
        self.end_barrier = False

    def persist_signature(self) -> str:
        return f"ProcessExchange/{self.mesh.n}/{int(self.route is None)}"

    def persist_state(self) -> dict:
        return {"round": self.round}

    def restore_state(self, st: dict) -> None:
        self.round = st["round"]

    def _split_native(self, batch: Any, n: int):
        """Per-process sub-batches of a NativeBatch, or None (no plan /
        plan rejected the batch -> object-plane fallback)."""
        shards = native_shards(batch, self.native_route, n)
        if shards is None:
            return None
        # device column plane: the wave's bulk columns split through the
        # mesh collective (host routing, identical order); buckets still
        # leave this process in wire form — dense ids + unique-row blob
        # as out-of-band buffers, never per-row pickles
        from pathway_tpu_torch.parallel.column_plane import engine_column_exchanger

        ce = engine_column_exchanger()
        if ce is not None:
            subs = ce.split_batch(batch, shards, n)
            if subs is not None:
                return subs
        return [batch.select(shards == p) for p in range(n)]

    def _split_wave(self, batches, entries):
        """Partition one drained wave into per-process (entry, native)
        buckets along the operator's shard key."""
        n = self.mesh.n
        buckets: list[list[Entry]] = [[] for _ in range(n)]
        nb_buckets: list[list] = [[] for _ in range(n)]
        for b in batches:
            subs = self._split_native(b, n) if self.route is not None else None
            if subs is None:
                if self.route is None:
                    nb_buckets[0].append(b)
                else:
                    entries = b.materialize() + entries
                continue
            for p, sub in enumerate(subs):
                if len(sub):
                    nb_buckets[p].append(sub)
        if self.route is None:
            buckets[0].extend(entries)
        else:
            route = self.route
            shard_of = _shard_of
            # route tokens repeat heavily within a wave (group keys):
            # memoize token -> shard so the blake2b serialization runs
            # once per DISTINCT token, not once per row. The cache key
            # includes the token's TYPE: _shard_of routes a bare int via
            # the % fast path but an equal float via the blake path, and
            # dict equality (5 == 5.0) must not fold them — routing has
            # to stay a pure function of the token, never of which form
            # happened to arrive first in the wave.
            shard_cache: dict = {}
            route_errors = 0
            first_error: BaseException | None = None
            for entry in entries:
                key, row, _diff = entry
                try:
                    tok = route(key, row)
                except Exception as e:  # noqa: BLE001 — owner re-evaluates
                    # + logs through its normal path; shard 0 is the
                    # deterministic overflow bucket
                    route_errors += 1
                    if first_error is None:
                        first_error = e
                    buckets[0].append(entry)
                    continue
                try:
                    ck = (tok.__class__, tok)
                    p = shard_cache.get(ck)
                    if p is None:
                        p = shard_cache[ck] = shard_of(tok, n)
                except TypeError:
                    # unhashable token: no memo, route it directly
                    # (_shard_of's stable-repr fallback still applies)
                    p = shard_of(tok, n)
                buckets[p].append(entry)
            if route_errors:
                import logging

                logging.getLogger("pathway_tpu_torch.workers").warning(
                    "exchange wire %d (node %d): %d row(s) failed shard "
                    "routing, sent to process 0 (first error: %s: %s)",
                    self.wire_id, self.node_id, route_errors,
                    type(first_error).__name__, first_error,
                )
        return buckets, nb_buckets

    def inject_remote(self, time: int, payload: Any) -> None:
        """Deliver a peer's bucket below this node (frontier mode): the
        pump calls this once the wire's watermark admits `time`."""
        if isinstance(payload, tuple):
            ents, wires = payload
            if wires:
                from pathway_tpu_torch.engine.native import dataplane as dp

                for w in wires:
                    self.emit(time, dp.NativeBatch.from_wire(w))
            if ents:
                self.emit(time, ents)
        elif payload:  # legacy plain-entry frame
            self.emit(time, payload)

    def finish_time(self, time: int) -> None:
        batches, entries = self.take_segments()
        if self.frontier_mode and not self.end_barrier:
            # frontier protocol: no blocking. Peer buckets cross the
            # mesh tagged with their time and are injected below the
            # peer's replica of this node once its operators' frontiers
            # admit them; the local bucket emits downstream directly —
            # the per-node scheduler stashes it at any operator whose
            # frontier (which includes this wire's peers) still lags.
            if not batches and not entries:
                return
            buckets, nb_buckets = self._split_wave(batches, entries)
            me = self.mesh.process_id
            for p in self.mesh.peers:
                if buckets[p] or nb_buckets[p]:
                    wires = [b.to_wire() for b in nb_buckets[p]]
                    self.mesh.send_bucket(
                        p, self.wire_id, time, (buckets[p], wires)
                    )
            for b in nb_buckets[me]:
                self.emit(time, b)
            if buckets[me]:
                self.emit(time, buckets[me])
            return
        buckets, nb_buckets = self._split_wave(batches, entries)
        me = self.mesh.process_id
        # end barrier (frontier mode) reuses the blocking exchange once,
        # at the negotiated end time every process steps together
        rnd = ("end", time) if self.end_barrier else self.round
        for p in self.mesh.peers:
            wires = [b.to_wire() for b in nb_buckets[p]]
            self.mesh.send_bucket(
                p, self.wire_id, rnd, (buckets[p], wires)
            )
        merged = list(buckets[me])
        local_batches = list(nb_buckets[me])
        for p in self.mesh.peers:
            payload = self.mesh.recv_bucket(p, self.wire_id, rnd)
            if isinstance(payload, tuple):
                ents, wires = payload
                merged.extend(ents)
                if wires:
                    from pathway_tpu_torch.engine.native import dataplane as dp

                    local_batches.extend(
                        dp.NativeBatch.from_wire(w) for w in wires
                    )
            else:  # legacy plain-entry frame
                merged.extend(payload)
        self.round += 1
        for b in local_batches:
            self.emit(time, b)
        if merged:
            self.emit(time, merged)
