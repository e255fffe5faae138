"""Frontier-based progress tracking: per-operator watermarks over the DAG.

Reference parity: timely's progress tracking
(external/timely-dataflow/timely/src/progress/frontier.rs +
reachability.rs). The reference computes, per operator port, an
antichain of timestamps that may still arrive, by propagating source
capabilities through a one-shot reachability summary of the static
dataflow; an operator is notified for time t only once its input
frontier has passed t.

This module is the same idea over the engine's total-ordered even-ms
timestamp domain, where every antichain collapses to a single integer
watermark:

  * every SOURCE (a connector-fed ``InputNode``, a static batch set, or
    a remote exchange wire) carries a watermark W — a promise that no
    future delivery from it has time <= W (``DONE`` = the empty
    frontier: the source is finished);
  * a one-shot :class:`ReachabilityIndex` pass over the static DAG
    gives every node its upstream-source set (the reachability
    summary), including the implicit edges of operators that feed
    their outputs imperatively (iterate / row-transformer out_nodes);
  * a node's INPUT FRONTIER is the min over its upstream sources'
    watermarks, bounded by in-flight waves upstream of it, and the
    :class:`FrontierScheduler` fires ``finish_time(t)`` on a node as
    soon as that frontier passes t — per NODE, not per wave: an
    operator whose own inputs have settled runs ahead even while a
    sibling branch (or a peer worker across the process mesh) is still
    catching up on older timestamps.

Out-of-order ACROSS operators, always in-order AT each operator: waves
an operator cannot yet consume are stashed per-timestamp beside it and
replayed the moment its frontier passes them. This is what retires the
global BSP wave barrier (``Runtime.run_lockstep``): a straggler delays
exactly the operators that causally consume its data.
"""

from __future__ import annotations

import math
from time import perf_counter_ns
from typing import Any, Callable, Iterable

from pathway_tpu_torch.internals import observability as _obs

# The empty frontier: the source has promised it will never deliver
# again. min() over mixed int/float watermarks keeps working.
DONE = math.inf


class ReachabilityIndex:
    """One-shot reachability over the static dataflow DAG.

    Node creation order is a topological order (a node's inputs exist
    before it; imperatively-fed out_nodes are created after the node
    that feeds them), so same-timestamp notifications run in node-id
    order.
    """

    def __init__(self, graph: Any):
        nodes = list(graph.nodes)
        self.graph = graph
        self.children: list[list[int]] = [[] for _ in nodes]
        # nodes fed imperatively (iterate / row-transformer outputs):
        # they have no .inputs edge but ARE downstream of their feeder
        self.implicitly_fed: set[int] = set()
        for node in nodes:
            for inp in node.inputs:
                self.children[inp.node_id].append(node.node_id)
            for out in getattr(node, "out_nodes", {}).values():
                self.children[node.node_id].append(out.node_id)
                self.implicitly_fed.add(out.node_id)

    def cone(self, node_id: int, include_self: bool = True) -> set[int]:
        """All node ids reachable downstream of node_id."""
        seen: set[int] = set()
        stack = [node_id]
        while stack:
            nid = stack.pop()
            if nid in seen:
                continue
            seen.add(nid)
            stack.extend(self.children[nid])
        if not include_self:
            seen.discard(node_id)
        return seen

    def orphan_inputs(self) -> list[int]:
        """Nodes with no dataflow inputs and no imperative feeder: the
        potential sources. Anything here that no runtime registers as a
        live source is auto-closed (watermark DONE) so frontiers that
        merge it never stall — e.g. the static-table InputNodes of
        non-owner processes, which hold no rows on this process."""
        return [
            node.node_id
            for node in self.graph.nodes
            if not node.inputs and node.node_id not in self.implicitly_fed
        ]

    def exchange_depth(self) -> int:
        """Max number of exchange boundaries on any source->sink path
        (nodes with a ``wire_id``). Bounds how many propagation rounds a
        distributed quiescence fence needs: each round flushes one more
        exchange stage."""
        depth = [0] * len(self.graph.nodes)
        best = 0
        for node in self.graph.nodes:  # creation order is topological
            d = depth[node.node_id]
            if getattr(node, "wire_id", None) is not None:
                d += 1
                depth[node.node_id] = d
            best = max(best, d)
            for c in self.children[node.node_id]:
                depth[c] = max(depth[c], d)
        return best


class ScopeFrontier:
    """The input frontier of an iterate sub-scope.

    The loop body runs in a nested scope whose timestamps are
    (outer_time, round) products in the reference; here the outer
    coordinate is the times already released into the scope and the
    inner coordinate is the round counter. ``quiescent`` is the scope's
    progress statement: no feedback capability is held at the current
    outer time, so the fixpoint for everything released so far is
    complete. A truncated convergence (iteration_limit) keeps the
    capability, and the runtime keeps scheduling waves for the scope
    until it drops it."""

    __slots__ = ("released_through", "inner", "quiescent")

    def __init__(self) -> None:
        self.released_through: float = -1  # outer times fed to the scope
        self.inner = 0  # inner round watermark (body-graph timestamps)
        self.quiescent = True

    def release(self, outer_time: float) -> None:
        if outer_time > self.released_through:
            self.released_through = outer_time

    def advance_round(self, inner_t: int) -> None:
        self.inner = inner_t

    def hold(self) -> None:
        """Keep the feedback capability: convergence is incomplete."""
        self.quiescent = False

    def drop(self) -> None:
        self.quiescent = True


class _Pend:
    """Everything queued for one (operator, timestamp) notification:
    source payloads to deliver, and input stashed while the operator's
    frontier had not yet passed the timestamp."""

    __slots__ = ("payloads", "stash", "t0")

    def __init__(self) -> None:
        self.payloads: list[tuple[str, Any]] = []  # (kind, payload)
        self.stash: list[tuple[list, list, list | None]] = []
        # wave tracing: when this notification was first queued — the
        # fire-time delta is the wave's queue wait (observability plane
        # only; 0 keeps the disabled hot path at one predicate test)
        self.t0 = perf_counter_ns() if _obs.PLANE is not None else 0


class FrontierScheduler:
    """Fires operators per-timestamp as their input frontiers advance.

    An operator whose recent waves averaged above ``_SLOW_NS`` is
    treated as expensive: each pump pass fires at most one expensive
    wave, with every admissible cheap wave drained around it.


    Every pending notification is keyed by a SLOT and a timestamp. A
    slot is ``2*node_id`` for the operator itself (stashed input +
    source payloads + kicks) or ``2*node_id + 1`` for an exchange
    node's wire deliveries — remote buckets inject BELOW the node, so
    they must not count against the node's own outgoing watermark.

    ``pump()`` repeatedly fires the earliest admissible notification:
    (slot, t) is admissible when every source that can reach the
    operator promises nothing at or below t is still coming (watermark
    gate) and no earlier in-flight notification upstream could still
    emit to it (pending gate). Operators over settled inputs therefore
    run arbitrarily far ahead of straggling branches; emissions landing
    at a blocked operator are stashed per-timestamp and replayed, in
    order, when its frontier catches up.
    """

    _SLOW_NS = 5_000_000  # >= 5 ms average per wave = expensive operator

    def __init__(self, graph: Any, monitors: Iterable[Callable] = ()):
        self.graph = graph
        self.nodes = list(graph.nodes)
        self.monitors = list(monitors)
        self.reach = ReachabilityIndex(graph)
        self._wm: dict[Any, float] = {}
        self._kind: dict[Any, str] = {}
        self._node_of: dict[Any, Any] = {}
        self._token_cone: dict[Any, set[int]] = {}
        self._pending: dict[int, dict[float, _Pend]] = {}  # slot -> t -> pend
        self._upstream: dict[int, set] = {}  # node_id -> source tokens
        self._desc: dict[int, set[int]] = {}  # slot -> reachable node ids
        self._sealed = False
        # observability: last timestamp each operator completed
        self.completed_through: dict[int, float] = {}
        self.waves_fired = 0
        self._monitored_through: float = -1
        # per-slot cost estimate (EMA of fire wall-time, ns): drives the
        # cooperative two-tier pump — cheap operators drain freely
        # between expensive waves, so a grinding UDF never dams up the
        # causally-unrelated work (and watermarks) behind it
        self._cost_ns: dict[int, float] = {}
        # pumps that poll for deferred completions (Runtime.run and the
        # frontier static pump) opt in; the mesh pump keeps synchronous
        # async-apply semantics for now (its quiescence barriers assume
        # a drained scheduler between rounds)
        self.allow_async = False
        # stage overlap: (slot, t) -> done() for waves an operator has
        # CONSUMED but whose emission is still computing off-thread (a
        # deferred device dispatch). A hold gates downstream frontiers
        # exactly like an in-flight notification — but not the holding
        # operator's own later timestamps, which is what lets wave t+1
        # stage while wave t computes (see docs/serving.md).
        self._async_waves: dict[tuple[int, float], Callable[[], bool]] = {}

    # ------------------------------------------------------------- sources

    def _register(
        self, token: Any, node: Any, kind: str, watermark: float, cone: set
    ) -> Any:
        assert not self._sealed, "sources must be registered before pumping"
        self._wm[token] = watermark
        self._kind[token] = kind
        self._node_of[token] = node
        self._token_cone[token] = cone
        return token

    def add_source(self, node: Any, watermark: float = 0) -> Any:
        """A locally-fed InputNode (connector session or static rows)."""
        return self._register(
            node.node_id, node, "local", watermark,
            self.reach.cone(node.node_id),
        )

    def add_remote_source(self, exchange_node: Any, peer: int) -> Any:
        """Data arriving over a mesh wire from `peer`, injected BELOW
        the exchange node: its reach excludes the node itself, so the
        node's outgoing watermark never depends on its own incoming
        wires (that cycle would freeze both sides at frontier 0).
        Watermark follows the peer's announcements."""
        token = ("wire", exchange_node.wire_id, peer)
        return self._register(
            token, exchange_node, "remote", 0,
            self.reach.cone(exchange_node.node_id, include_self=False),
        )

    def add_kick_source(self, node: Any) -> Any:
        """Capability-holding operator (iterate): lets the runtime
        schedule empty waves through it so a truncated convergence
        resumes without new input."""
        return self._register(
            ("kick", node.node_id), node, "kick", 0,
            self.reach.cone(node.node_id),
        )

    def seal(self) -> None:
        """Close registration: auto-complete orphan inputs and build
        each node's upstream-source set (the reachability summary)."""
        if self._sealed:
            return
        registered_nodes = {
            self._node_of[tok].node_id
            for tok, kind in self._kind.items()
            if kind == "local"
        }
        for nid in self.reach.orphan_inputs():
            if nid not in registered_nodes:
                # nothing will ever feed it on this worker: empty frontier
                self._register(
                    nid, self.nodes[nid], "local", DONE, self.reach.cone(nid)
                )
        self._sealed = True
        for nid in range(len(self.nodes)):
            self._upstream[nid] = set()
        for tok, cone in self._token_cone.items():
            for nid in cone:
                self._upstream[nid].add(tok)

    def _slot_of(self, token: Any) -> int:
        node = self._node_of[token]
        if self._kind[token] == "remote":
            return 2 * node.node_id + 1  # wire deliveries: below the node
        return 2 * node.node_id

    def _desc_of(self, slot: int) -> set[int]:
        """Node ids a pending notification at `slot` can still reach."""
        desc = self._desc.get(slot)
        if desc is None:
            nid, below = divmod(slot, 2)
            desc = self.reach.cone(nid, include_self=not below)
            self._desc[slot] = desc
        return desc

    # ----------------------------------------------------------- progress

    def stage(self, token: Any, time: float, payload: Any = None) -> None:
        """Stage one wave from a source; delivery happens at pump time,
        once the target operator's frontier passes `time`."""
        slot = self._slot_of(token)
        pend = self._pending.setdefault(slot, {}).setdefault(time, _Pend())
        pend.payloads.append((self._kind[token], payload))
        if self._wm[token] < time:
            # a source never delivers at or below its own watermark
            self._wm[token] = time

    def advance(self, token: Any, watermark: float) -> None:
        if watermark > self._wm[token]:
            self._wm[token] = watermark

    def advance_local(self, watermark: float) -> None:
        """Advance every local + kick source (the runtime's clock tick:
        any future poll will be stamped later than `watermark`)."""
        for tok, kind in self._kind.items():
            if kind in ("local", "kick") and self._wm[tok] < watermark:
                self._wm[tok] = watermark

    def close(self, token: Any) -> None:
        self._wm[token] = DONE

    def watermark(self, token: Any) -> float:
        return self._wm[token]

    def frontier_of_node(self, node: Any) -> float:
        """The node's input frontier: min over upstream source
        watermarks, bounded by in-flight notifications (including the
        node's own — an exchange node has not SENT a wave it has not
        fired, so its announced watermark must stay below it)."""
        self.seal()
        nid = node.node_id
        ups = self._upstream.get(nid)
        f = min((self._wm[tok] for tok in ups), default=DONE) if ups else DONE
        for slot, times in self._pending.items():
            if times and nid in self._desc_of(slot):
                f = min(f, min(times) - 1)
        for (slot, t) in self._async_waves:
            if nid in self._desc_of(slot):
                f = min(f, t - 1)
        return f

    # -------------------------------------------------- async stage overlap

    def hold_async(
        self, node: Any, time: float, done_fn: Callable[[], bool]
    ) -> None:
        """Register a deferred wave: `node` consumed its input for `time`
        and will emit once `done_fn()` turns true. Downstream frontiers
        stay below `time` until then; the node itself may keep firing
        later timestamps (pipelining)."""
        self._async_waves[(2 * node.node_id, time)] = done_fn

    def has_async(self) -> bool:
        return bool(self._async_waves)

    def _poll_async(self) -> int:
        """Convert completed deferred waves into notifications: the node
        fires again at the held time to emit its results."""
        converted = 0
        for (slot, t), done in list(self._async_waves.items()):
            if done():
                del self._async_waves[(slot, t)]
                self._pending.setdefault(slot, {}).setdefault(t, _Pend())
                converted += 1
        return converted

    def fully_drained(self) -> bool:
        return not any(self._pending.values()) and not self._async_waves

    def replan_refresh(self) -> None:
        """Refresh every topology-derived cache after the adaptive
        planner rewired the live graph (internals/planner.py re-fusion
        at a drained epoch fence): node list, reachability, per-slot
        descendant cones, source cones, and the upstream summaries.
        Caller must hold the fence (fully_drained() — no in-flight
        notifications reference the old cones)."""
        assert self.fully_drained(), "replan requires a drained scheduler"
        self.nodes = list(self.graph.nodes)
        self.reach = ReachabilityIndex(self.graph)
        self._desc.clear()
        for token, kind in self._kind.items():
            node = self._node_of[token]
            self._token_cone[token] = self.reach.cone(
                node.node_id, include_self=kind != "remote"
            )
        self._upstream.clear()
        for nid in range(len(self.nodes)):
            self._upstream[nid] = set()
        for tok, cone in self._token_cone.items():
            for nid in cone:
                self._upstream[nid].add(tok)

    def global_frontier(self) -> float:
        """Min over every source watermark and in-flight notification —
        the fully-retired time: state at or below it can never change
        again (persistence cuts checkpoints here)."""
        self.seal()
        f = min(self._wm.values(), default=DONE)
        for times in self._pending.values():
            if times:
                f = min(f, min(times) - 1)
        for (_slot, t) in self._async_waves:
            f = min(f, t - 1)
        return f

    # -------------------------------------------------------------- firing

    def _stash_emissions(self, slot: int, time: float) -> None:
        """Move freshly-received input out of the fired cone's buffers
        into per-timestamp stashes. Run after each notification:
        operators whose frontier has not passed `time` keep the wave
        parked, in timestamp order, until their own notification
        fires."""
        from pathway_tpu_torch.engine.core import InputNode

        for nid in self._desc_of(slot):
            node = self.nodes[nid]
            bufs = node.buffers
            # ONLY an InputNode's `pending` is a push inbox; on other
            # nodes an attribute of that name is operator STATE (e.g.
            # BufferNode's postponed rows) and must never be stashed
            pending = node.pending if isinstance(node, InputNode) else None
            has_bufs = any(bufs)
            if not has_bufs and not pending:
                continue
            pend = self._pending.setdefault(2 * node.node_id, {}).setdefault(
                time, _Pend()
            )
            if has_bufs:
                node.buffers = [[] for _ in bufs]
                nsegs = node._nseg
                node._nseg = [0] * len(nsegs)
            else:
                bufs, nsegs = [], []
            if pending:
                node.pending = []
                pend.stash.append((bufs, nsegs, pending))
            else:
                pend.stash.append((bufs, nsegs, None))

    def _restore_stash(self, node: Any, pend: _Pend) -> None:
        for bufs, nsegs, input_pending in pend.stash:
            for i, buf in enumerate(bufs):
                if buf:
                    node.buffers[i].extend(buf)
                    node._nseg[i] += nsegs[i]
            if input_pending:
                node.pending.extend(input_pending)

    def _admissible(self, slot: int, t: float) -> bool:
        nid = slot // 2
        ups = self._upstream.get(nid)
        if ups and any(self._wm[tok] < t for tok in ups):
            return False  # an upstream source may still deliver <= t
        for other, times in self._pending.items():
            if other == slot or not times:
                continue
            mt = min(times)
            if mt > t:
                continue
            desc = self._desc_of(other)
            if nid in desc and (mt < t or slot // 2 != other // 2):
                # an earlier (or same-time upstream) in-flight wave can
                # still emit into this operator: deliver it first
                return False
        for (oslot, ot) in self._async_waves:
            if oslot == slot:
                # the operator's own deferred wave never gates its later
                # timestamps — consuming wave t+1 while t computes is the
                # double buffer; emissions still land in time order via
                # the per-timestamp stash
                continue
            if ot > t:
                continue
            if nid in self._desc_of(oslot) and (ot < t or slot // 2 != oslot // 2):
                return False
        # own earlier timestamps fire first (per-operator time order)
        own = self._pending.get(slot)
        if own and min(own) < t:
            return False
        return True

    def _fire(self, slot: int, t: float, pend: _Pend) -> None:
        nid, below = divmod(slot, 2)
        node = self.nodes[nid]
        t0 = perf_counter_ns()
        if below:
            for _kind, payload in pend.payloads:
                if payload is not None:
                    node.inject_remote(t, payload)
        else:
            for kind, payload in pend.payloads:
                if kind == "local" and payload is not None:
                    node.push(payload)
            self._restore_stash(node, pend)
            node.finish_time(t)
            self.completed_through[nid] = t
        elapsed = perf_counter_ns() - t0
        if not below:
            node.time_ns += elapsed
        ema = self._cost_ns.get(slot)
        self._cost_ns[slot] = (
            elapsed if ema is None else 0.5 * ema + 0.5 * elapsed
        )
        plane = _obs.PLANE
        if plane is None:
            self._stash_emissions(slot, t)
        else:
            s0 = perf_counter_ns()
            self._stash_emissions(slot, t)
            plane.wave(
                node, t,
                exec_ns=elapsed,
                queue_ns=max(t0 - pend.t0, 0) if pend.t0 else 0,
                stash_ns=perf_counter_ns() - s0,
                injected=bool(below),
            )
        self.waves_fired += 1

    def pump(self, budget: int | None = None) -> int:
        """Fire currently-admissible notifications; returns the count.
        A blocked notification never blocks an unrelated one — that is
        the straggler isolation the global wave barrier could not give.

        `budget` caps the notifications fired in this call: the mesh
        pump runs in chunks so watermark announcements and remote
        deliveries interleave with long-running operators — otherwise a
        grinding wave would freeze this process's outgoing frontiers
        and transitively stall every peer operator gated on them."""
        self.seal()
        fired = 0
        while budget is None or fired < budget:
            # deferred waves that finished computing become ordinary
            # notifications (the operator fires again at the held time
            # to emit); polled per pass, never waited on — the pump
            # returns to its caller when only in-flight work remains
            self._poll_async()
            # drain the whole CHEAP tier, then fire exactly one
            # expensive wave. Causal order is enforced by _admissible,
            # not by global firing order, so a straggler's backlog of
            # early-timestamped expensive waves must not dam up
            # causally-independent cheap work — cheap operators (and
            # with them this worker's outgoing watermarks) keep flowing
            # between expensive waves (timely's cooperative
            # activation/fuel idea, with an EMA cost model).
            cheap = 0
            while budget is None or fired < budget:
                n = self._fire_pass(slow_tier=False)
                cheap += n
                fired += n
                if n == 0:
                    break
            slow = 0
            if budget is None or fired < budget:
                slow = self._fire_pass(slow_tier=True, limit=1)
                fired += slow
            if cheap == 0 and slow == 0:
                break
        plane = _obs.PLANE
        if plane is not None:
            # depth of the work-stealing morsel queues left behind by the
            # waves this pass fired (engine/morsel.py). Sampled here — not
            # inside the steal loop — so the steady-state reading costs one
            # gauge per pump instead of one per morsel. Nonzero at the
            # sample point means a wave returned while stolen morsels were
            # still draining, i.e. stealing actually overlapped the pump.
            from pathway_tpu_torch.engine import morsel as _morsel

            plane.metrics.gauge(
                "pathway_morsel_queue_depth",
                float(_morsel.live_depth()),
                help="morsels queued across live steal schedulers",
            )
        return fired

    def _fire_pass(self, slow_tier: bool, limit: int | None = None) -> int:
        """One pass over the tier's slots: each fires at most its
        earliest pending time, in timestamp order."""
        slow_ns = self._SLOW_NS
        cands = sorted(
            ((min(times), slot)
             for slot, times in self._pending.items()
             if times
             and (self._cost_ns.get(slot, 0.0) >= slow_ns) == slow_tier),
            key=lambda pair: pair[0],
        )
        fired = 0
        for t, slot in cands:
            times = self._pending.get(slot)
            # re-validate against CURRENT state: an earlier fire in this
            # pass may have delivered new (earlier) waves here
            if not times or t not in times or min(times) != t:
                continue
            if not self._admissible(slot, t):
                continue
            pend = times.pop(t)
            if not times:
                del self._pending[slot]
            self._fire(slot, t, pend)
            fired += 1
            if t > self._monitored_through:
                self._monitored_through = t
                for m in self.monitors:
                    m(t)
            if limit is not None and fired >= limit:
                break
        return fired
