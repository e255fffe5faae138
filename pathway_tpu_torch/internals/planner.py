"""Adaptive plan optimizer: operator fusion, pushdown, and id elision.

Sits between spec build and engine construction (internals/lowering.py
calls in here from ``Session.node_of``), plus a runtime feedback policy
(`AdaptivePolicy`) that re-plans at safe epoch fences from the metrics
registry. The reference engine plans once and never adapts (SURVEY.md §5)
— this module is the self-tuning layer on top of the static lowering.

Passes (all gated by ``PATHWAY_FUSE``; ``PATHWAY_FUSE=0`` reproduces the
unoptimized plans byte-identically, pinned by the fusion-off CI leg):

* **Chain fusion** — linear runs of rowwise operators (select /
  with_columns / filter, reindex as an object-plane chain terminator)
  collapse into one ``FusedRowwiseNode`` (engine/core.py) that evaluates
  the composed program per wave. On the native plane the fused program
  keeps intermediate values as column arrays: one source decode, no
  intermediate intern-table writes, one final row build.
* **Pushdown** — sargable (numpy-plannable) leading filters push into
  connector scans through the scan-tuning channel; single-side filters
  over inner joins push below the join (fewer rows enter the join's
  arrangements and wire). Projection pushdown below exchanges falls out
  of fusion: fused chains build without the per-operator sharded
  exchange, so projections run before rows ever cross a wire.
* **Id elision** — when the reachable spec DAG proves a scan's row
  identities can never be observed in any output, the scan derives
  sequential keys with the cheap SplitMix64 mix instead of blake2b
  (measured ~48% of the whole jsonl parse); hash-joins whose output ids
  are equally unobservable use the cheap pair mix (``id_mode="cheap"``).
  Soundness: the analysis whitelists spec kinds whose key handling is
  fully understood and vetoes the whole session otherwise; ids are
  "observed" by id-referencing expressions, key-exposing sinks
  (subscribe / capture), and any non-whitelisted operator.
* **Cardinality sketches** — row/distinct-count estimates per join input
  (static inputs sketched at plan time, live inputs incrementally by
  JoinNode) feed a join-orientation cost model. The advice is always
  recorded in the plan report; the spec-level swap is applied only under
  ``PATHWAY_JOIN_REORDER=1`` because reordering permutes intra-wave
  emission order (z-set contents are preserved, byte layout of sinks is
  not — see docs/planner.md).
* **Adaptive re-planning** — ``AdaptivePolicy`` runs at drained epoch
  fences of the streaming pump: it reads the PR-6 metrics registry
  (per-op latency histograms via the ``gauge_value`` / ``counter_value``
  / ``histogram_stats`` read API), re-fuses hot stateless runs the
  static pass could not prove single-consumer (the live node graph
  shows the true fan-out), and retunes the device-exchange batch
  threshold from the wire counters.
"""

from __future__ import annotations

import os
from typing import Any, Callable

from pathway_tpu_torch.internals import expression as ex

# ------------------------------------------------------------------- gates


def fuse_enabled() -> bool:
    """Master optimizer gate: PATHWAY_FUSE=0 reproduces today's plans
    byte-identically (A/B-pinned by the fusion-off leg)."""
    return os.environ.get("PATHWAY_FUSE", "1") != "0"


def join_reorder_mode() -> str:
    """Sketch-costed join input reordering (permutes intra-wave emission
    order: multiset-equivalent, not byte-equivalent). Three modes:

    * ``"off"``  — ``PATHWAY_JOIN_REORDER=0``: never reorder.
    * ``"on"``   — ``PATHWAY_JOIN_REORDER=1``: reorder whenever the
      sketches say the left input is smaller (the historical opt-in).
    * ``"auto"`` — unset (the default): reorder only when the sketches
      disagree by >= ``_REORDER_AUTO_RATIO``x AND no order-sensitive sink
      (subscribe/capture — anything that observes row ids/arrival order)
      is downstream of the join, as computed by ``PlanContext`` and
      re-proved by the verifier's ``check_join_reorder``.
    """
    raw = os.environ.get("PATHWAY_JOIN_REORDER")
    if raw == "0":
        return "off"
    if raw == "1":
        return "on"
    return "auto"


# sketch ratio an "auto" reorder demands: the win must be unambiguous,
# not a coin flip between two near-equal estimates
_REORDER_AUTO_RATIO = 4


def join_reorder_enabled() -> bool:
    """Back-compat boolean view of join_reorder_mode() (forced mode)."""
    return join_reorder_mode() == "on"


def adaptive_enabled() -> bool:
    """Runtime re-planning gate (needs the observability plane for its
    signal; PATHWAY_ADAPTIVE=0 kills the policy, fusion stays static)."""
    return os.environ.get("PATHWAY_ADAPTIVE", "1") != "0"


def megakernel_enabled() -> bool:
    """Wave-cone gate: PATHWAY_MEGAKERNEL=0 skips cone installation so
    the graph executes the per-node fused plan byte-identically
    (A/B-pinned by the megakernel-off leg). Read once at the lowering
    seam (Session.execute), never per wave."""
    return os.environ.get("PATHWAY_MEGAKERNEL", "1") != "0"


# ------------------------------------------------------------ last report

_LAST_REPORT: dict | None = None


def last_report() -> dict | None:
    """The most recent session's plan report (bench / debugging hook)."""
    return _LAST_REPORT


# ------------------------------------------------------------------ sketch


class CardinalitySketch:
    """Cheap row-count + distinct-count estimate, maintained
    incrementally. Distinct counting is exact up to ``cap`` observed
    values, then becomes a lower bound (``exact`` flips False) — enough
    signal for join-orientation costing without HLL machinery."""

    __slots__ = ("rows", "exact", "_seen", "_cap")

    def __init__(self, cap: int = 8192):
        self.rows = 0
        self.exact = True
        self._seen: set[Any] = set()
        self._cap = cap

    def add(self, value: Any = None, n: int = 1) -> None:
        self.rows += n
        if value is not None and self.exact:
            self._seen.add(value)
            if len(self._seen) > self._cap:
                self.exact = False

    @property
    def distinct(self) -> int:
        return len(self._seen)

    def snapshot(self) -> dict:
        return {
            "rows": self.rows,
            "distinct": self.distinct,
            "distinct_exact": self.exact,
        }


# ------------------------------------------------------- id observability
#
# dep[spec] = frozenset of origin markers the spec's OUTPUT KEYS depend
# on. Origins: ("src", spec_id) for elidable scans, ("join", spec_id)
# for hash-joins. A marker lands in `observed` when anything can surface
# its key VALUES: an id-referencing expression, a key-exposing sink, or
# an operator whose key semantics the whitelist doesn't cover.

# spec kinds whose key derivation/usage is fully modeled below; one
# reachable spec outside this set disables id elision for the session
# (conservative global veto — sort exposes neighbor pointers, ix matches
# pointer values against keys, iterate re-keys through scopes, …).
_ELISION_KINDS = frozenset({
    "static", "static_native", "connector", "rowwise", "filter",
    "groupby", "join", "concat", "flatten", "reindex",
    "update_rows", "update_cells", "setop", "with_universe_of", "having",
    "buffer", "forget", "freeze",
})

# operators that MATCH keys across inputs: safe only when every input's
# keys derive identically (same dep set) — consistent under any
# injective key scheme
_KEY_MATCHING = frozenset({
    "update_rows", "update_cells", "setop", "with_universe_of", "having",
})


def _has_id_ref(exprs) -> bool:
    """Any IdReference (incl. join _JoinIdRef) in the expression trees."""
    seen: set[int] = set()

    def rec(e) -> bool:
        if not isinstance(e, ex.ColumnExpression) or id(e) in seen:
            return False
        seen.add(id(e))
        if isinstance(e, ex.IdReference):
            return True
        return any(rec(s) for s in e._sub_expressions())

    return any(rec(e) for e in exprs if isinstance(e, ex.ColumnExpression))


def _spec_exprs(spec) -> list:
    """Every expression a spec's params carry (shallow container sweep)."""
    out: list = []

    def add(v, depth: int = 0) -> None:
        if depth > 3:
            return
        if isinstance(v, ex.ColumnExpression):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                add(x, depth + 1)
        elif isinstance(v, dict):
            for x in v.values():
                add(x, depth + 1)

    for v in spec.params.values():
        add(v)
    # join `on` pairs / reducer args ride lists already; reducer
    # expressions hide args on the object
    for re_ in spec.params.get("reducer_exprs", []) or []:
        out.extend(a for a in getattr(re_, "_args", ()) if isinstance(a, ex.ColumnExpression))
    return out


def _spec_input_tables(spec) -> list:
    """spec.inputs plus tables referenced only through params (side
    tables in expressions, having indexers, iterate inputs/results) —
    the full consumer-edge set for reachability and fan-out counting."""
    from pathway_tpu_torch.internals.expression_compiler import referenced_tables
    from pathway_tpu_torch.internals.table import Table

    tables = list(spec.inputs)
    exprs = _spec_exprs(spec)
    if exprs:
        for t in referenced_tables(exprs):
            if isinstance(t, Table):
                tables.append(t)
    for ref in spec.params.get("indexers", []) or []:
        t = getattr(ref, "table", None)
        if isinstance(t, Table):
            tables.append(t)
    it_spec = spec.params.get("iterate")
    if it_spec is not None:
        tables.extend(getattr(it_spec, "inputs", {}).values())
    for v in spec.params.values():
        if isinstance(v, Table):
            tables.append(v)
    return tables


class PlanContext:
    """Spec-DAG-wide knowledge for one lowering session: consumer
    counts over the reachable DAG (fusion's single-consumer proofs) and
    the id-observability analysis (key/id elision)."""

    def __init__(
        self,
        roots: list,
        *,
        sink_meta: list | None = None,
        persistent: bool = False,
    ):
        # roots: tables lowering will be asked for. sink_meta: per sink
        # (table, observes_ids) — subscribe/capture expose keys, fs file
        # writers declare observes_ids=False.
        self.persistent = persistent
        self.specs: dict[int, Any] = {}
        self.consumers: dict[int, int] = {}
        self._tables: dict[int, Any] = {}
        self.elision_ok = True
        self.elision_veto_reason: str | None = None
        self.cheap_key_sources: set[int] = set()
        self.cheap_id_joins: set[int] = set()
        self.sketches: dict[int, dict] = {}
        order: list[int] = []  # postorder (inputs before consumers)
        stack = [(t, False) for t in roots]
        while stack:
            table, expanded = stack.pop()
            spec = table._spec
            self._tables.setdefault(spec.id, table)
            if expanded:
                if spec.id not in self.specs:
                    self.specs[spec.id] = spec
                    order.append(spec.id)
                continue
            if spec.id in self.specs:
                continue
            stack.append((table, True))
            for t_in in _spec_input_tables(spec):
                self.consumers[t_in._spec.id] = (
                    self.consumers.get(t_in._spec.id, 0) + 1
                )
                stack.append((t_in, False))
        # sinks consume their tables too — a chain intermediate that is
        # also directly captured/written must not fuse away
        for t in roots:
            self.consumers[t._spec.id] = (
                self.consumers.get(t._spec.id, 0) + 1
            )
        # specs upstream of an order-sensitive sink (subscribe/capture —
        # anything that observes row ids / arrival order). The "auto"
        # join-reorder mode refuses to swap any join such a sink can see,
        # because reordering permutes intra-wave emission order; fs file
        # writers declare observes_ids=False and do not pin anything.
        self.order_sensitive: set[int] = set()
        for table, observes_ids in (sink_meta or []):
            if not observes_ids:
                continue
            up = [table]
            while up:
                t = up.pop()
                sid = t._spec.id
                if sid in self.order_sensitive:
                    continue
                self.order_sensitive.add(sid)
                up.extend(_spec_input_tables(t._spec))
        self._analyze(order, sink_meta or [])

    # ---------------------------------------------------------- analysis

    def _analyze(self, order: list[int], sink_meta: list) -> None:
        if self.persistent:
            # cheap keys are deterministic per plan, but snapshots taken
            # under the other scheme must never silently mix — keep
            # persisted pipelines on blake until signatures carry the
            # key scheme
            self.elision_ok = False
            self.elision_veto_reason = "persistence attached"
        for sid in order:
            if self.specs[sid].kind not in _ELISION_KINDS:
                self.elision_ok = False
                self.elision_veto_reason = (
                    f"spec kind {self.specs[sid].kind!r} outside the "
                    "id-elision whitelist"
                )
                break
        if not self.elision_ok:
            return
        dep: dict[int, frozenset] = {}
        observed: set = set()

        def observe(markers) -> None:
            observed.update(markers)

        for sid in order:
            spec = self.specs[sid]
            kind = spec.kind
            ins = [dep.get(t._spec.id, frozenset())
                   for t in _spec_input_tables(spec)]
            exprs = _spec_exprs(spec)
            if kind == "static":
                dep[sid] = frozenset()
            elif kind == "static_native":
                dep[sid] = frozenset({("src", sid)})
            elif kind == "connector":
                if spec.params.get("native_plane") and not spec.params.get(
                    "upsert"
                ):
                    dep[sid] = frozenset({("src", sid)})
                else:
                    dep[sid] = frozenset()
            elif kind in ("rowwise", "filter", "buffer", "forget", "freeze"):
                if _has_id_ref(exprs):
                    for d in ins:
                        observe(d)
                dep[sid] = ins[0] if ins else frozenset()
            elif kind == "groupby":
                if _has_id_ref(exprs):
                    for d in ins:
                        observe(d)
                dep[sid] = frozenset()  # re-keyed by group values
            elif kind == "reindex":
                if _has_id_ref(exprs):
                    for d in ins:
                        observe(d)
                dep[sid] = frozenset()  # re-keyed by value expression
            elif kind == "join":
                if _has_id_ref(exprs):
                    for d in ins:
                        observe(d)
                l_dep = dep.get(spec.inputs[0]._spec.id, frozenset())
                r_dep = dep.get(spec.inputs[1]._spec.id, frozenset())
                id_mode = spec.params.get("id_mode", "hash")
                if id_mode == "left":
                    dep[sid] = l_dep
                elif id_mode == "right":
                    dep[sid] = r_dep
                else:
                    dep[sid] = l_dep | r_dep | frozenset({("join", sid)})
            elif kind in ("concat", "flatten"):
                # keys pass through (or derive injectively: salted
                # concat rekey, flatten child keys)
                dep[sid] = frozenset().union(*ins) if ins else frozenset()
            elif kind in _KEY_MATCHING:
                base = ins[0] if ins else frozenset()
                if all(d == base for d in ins):
                    dep[sid] = base
                else:
                    for d in ins:
                        observe(d)  # cross-origin key matching
                    dep[sid] = frozenset().union(*ins)
            else:  # unreachable given the whitelist gate
                for d in ins:
                    observe(d)
                dep[sid] = frozenset().union(*ins) if ins else frozenset()
        for table, observes_ids in sink_meta:
            if observes_ids:
                observe(dep.get(table._spec.id, frozenset()))
        for sid in order:
            spec = self.specs[sid]
            marker_src = ("src", sid)
            marker_join = ("join", sid)
            if marker_src in dep.get(sid, frozenset()) and (
                marker_src not in observed
            ):
                self.cheap_key_sources.add(sid)
            if spec.kind == "join" and marker_join not in observed and (
                spec.params.get("id_mode", "hash") == "hash"
            ):
                self.cheap_id_joins.add(sid)

    # ------------------------------------------------------------ access

    def consumer_count(self, spec) -> int:
        return self.consumers.get(spec.id, 0)

    def static_sketch(self, table) -> dict:
        """Plan-time sketch of a static input (sampled distinct count of
        the whole row). Only object-plane "static" specs carry their
        rows at plan time; lazy native scans and connectors report
        rows=None (unknown until parse/poll — the runtime view lives in
        JoinNode.sketch()), so orientation advice never costs from a
        fabricated zero."""
        spec = table._spec
        if spec.id in self.sketches:
            return self.sketches[spec.id]
        sk = CardinalitySketch()
        rows = spec.params.get("rows")
        snap: dict
        if spec.kind == "static" and isinstance(rows, list):
            for (_t, key, _row, _d) in rows[: sk._cap]:
                sk.add(key.value)
            sk.rows = len(rows)
            snap = sk.snapshot()
        else:
            snap = sk.snapshot()
            snap["rows"] = None
        self.sketches[spec.id] = snap
        return snap


# --------------------------------------------------------------- reorder


def _swap_join_spec(spec) -> None:
    """In-place orientation swap of a join spec (sketch-costed; only
    under PATHWAY_JOIN_REORDER=1 and only for unobservable hash ids —
    multiset-equivalent, wave emission order changes)."""
    spec.inputs = [spec.inputs[1], spec.inputs[0]]
    spec.params["on"] = [(r, l) for (l, r) in spec.params["on"]]
    mode = spec.params.get("mode", "inner")
    spec.params["mode"] = {"left": "right", "right": "left"}.get(mode, mode)


# ------------------------------------------------------------- wave cones


def find_cone_chains(graph) -> list[tuple]:
    """Identify wave cones on a lowered graph: scan source → optional
    fused rowwise run → bucketized groupby update (bare or sharded over
    the column-plane exchange). Returns (head, fused_or_None, target)
    triples; engine/cone.py installs them and the verifier's
    cone-contract check re-proves each one before any compile.

    Eligibility is deliberately strict — everything here is a condition
    the cone's byte-identity proof needs (docs/megakernel.md):

    * single-consumer interior: each member feeds ONLY the next member
      (one downstream edge, next member's sole input) — a second
      consumer would observe the head's merged emission the cone never
      builds;
    * the fused run must be a pure native program (no stateful
      suppression, no rekey, object stages only as the per-row BAD
      fallback) — stateful emission depends on cross-wave state the
      per-segment replay would order differently;
    * the target must hold a native groupby plan (plan-mode
      `GroupByNode`); a sharded target additionally needs the
      group-column native route so the exchange pack and the update can
      share one projection.
    """
    from pathway_tpu_torch.engine.core import (
        FusedRowwiseNode,
        GroupByNode,
        InputNode,
    )
    from pathway_tpu_torch.engine.workers import ShardedNode

    def _live_single_consumer(node):
        if len(node.downstream) != 1:
            return None
        nxt = node.downstream[0][0]
        if getattr(nxt, "_replaced", False) or nxt._cone_absorbed:
            return None
        if len(nxt.inputs) != 1 or nxt.inputs[0] is not node:
            return None
        return nxt

    def _plan_mode_groupby(node) -> bool:
        return (
            isinstance(node, GroupByNode)
            and node._native is not None
            and node._plan is not None
        )

    chains: list[tuple] = []
    for head in graph.nodes:
        if type(head) is not InputNode:
            continue
        if head._cone is not None or head._cone_absorbed:
            continue
        cur = _live_single_consumer(head)
        if cur is None:
            continue
        fused = None
        if isinstance(cur, FusedRowwiseNode):
            if (
                cur._program is None
                or cur._stateful
                or cur.rekey is not None
                or getattr(cur, "_replaced", False)
            ):
                continue
            nxt = _live_single_consumer(cur)
            if nxt is None:
                continue
            fused, cur = cur, nxt
        target = cur
        if isinstance(target, ShardedNode):
            if len(target.inputs) != 1:
                continue
            route = target.native_routes[0]
            if route is None or route[0] != "group":
                continue
            if not all(_plan_mode_groupby(r) for r in target.replicas):
                continue
        elif not _plan_mode_groupby(target):
            continue
        chains.append((head, fused, target))
    return chains


# ---------------------------------------------------------------- report


def new_report() -> dict:
    return {
        "enabled": fuse_enabled(),
        "fusion_groups": [],
        "pushdowns": [],
        "join_orders": [],
        "elision": {"sources": 0, "joins": 0, "veto": None},
        "nodes_before": 0,
        "nodes_after": 0,
        "replans": [],
    }


def publish_report(report: dict) -> None:
    global _LAST_REPORT
    _LAST_REPORT = report


# ------------------------------------------------------- adaptive policy


class AdaptivePolicy:
    """Metrics-fed re-planning at safe epoch fences.

    Runs from the streaming pump when the scheduler is fully drained (an
    epoch fence: no in-flight waves, all state retired through the
    current frontier). Two actions, both recorded in the plan report and
    as ``pathway_planner_*`` counters:

    * re-fuse hot stateless runs: the live node graph shows true
      fan-out, so linear Map/Filter/FusedRowwise runs that static fusion
      could not prove single-consumer (dead spec consumers, multi-sink
      programs) fuse at runtime once their measured share of wave time
      (per-op latency histograms, read via ``histogram_stats``) crosses
      ``hot_share``;
    * retune the device-exchange auto threshold: if the wire counters
      show exchanges averaging below ``min_rows_per_exchange`` rows, the
      crossover threshold doubles (bounded), so tiny batches stop paying
      dispatch overhead.
    """

    def __init__(
        self,
        graph,
        report: dict | None = None,
        hot_share: float = 0.10,
        min_rows_per_exchange: int = 64,
        interval_s: float = 2.0,
    ):
        self.graph = graph
        self.report = report if report is not None else new_report()
        self.hot_share = float(
            os.environ.get("PATHWAY_ADAPTIVE_HOT_SHARE", hot_share)
        )
        self.min_rows_per_exchange = min_rows_per_exchange
        self.interval_s = interval_s
        self._last = 0.0
        self._exchange_tuned = 0
        self._spill_tuned = 0
        self._spill_probe_seen = 0.0
        self._morsel_tuned = 0
        self._morsel_task_seen = 0.0
        self._morsel_task_total = 0.0
        # fresh tuning per run: the exchanger is a process-wide
        # singleton, and a previous run's doublings must not ratchet
        # into this one (same discipline as the scan-tuning claim)
        from pathway_tpu_torch.parallel import column_plane as cp
        from pathway_tpu_torch.parallel import device_exchange as dx

        if dx._ENGINE_EXCHANGER is not None:
            dx._ENGINE_EXCHANGER._auto_min = dx._ENGINE_EXCHANGER._auto_min_base
        if cp._ENGINE_EXCHANGER is not None:
            cp._ENGINE_EXCHANGER._auto_min_rows = (
                cp._ENGINE_EXCHANGER._auto_min_rows_base
            )

    # ------------------------------------------------------------ fences

    def maybe_replan(self, scheduler) -> int:
        """Called at a drained fence; returns number of plan changes."""
        import time as _time

        from pathway_tpu_torch.internals import observability as _obs

        now = _time.monotonic()
        if now - self._last < self.interval_s:
            return 0
        self._last = now
        plane = _obs.PLANE
        if plane is None:
            return 0
        changes = self._refuse_hot_chains(plane)
        changes += self._retune_exchange(plane)
        changes += self._retune_spill(plane)
        changes += self._retune_morsels(plane)
        if changes and scheduler is not None:
            scheduler.replan_refresh()
        if changes:
            # adaptive re-fusion changes the live plan after the static
            # report was published — refresh the node count so
            # /statistics and last_report() describe what is running,
            # not the plan as lowered
            self.report["nodes_after"] = sum(
                1 for n in self.graph.nodes
                if not getattr(n, "_replaced", False)
            )
        return changes

    # ------------------------------------------------------- re-fusion

    def _wave_share(self, plane, node) -> float:
        cnt, total = plane.metrics.histogram_stats(
            "pathway_operator_wave_seconds",
            {
                "operator": type(node).__name__,
                "label": getattr(node, "label", None) or "",
                "id": str(node.node_id),
            },
        )
        if not cnt:
            return 0.0
        _all_cnt, all_total = plane.metrics.histogram_stats(
            "pathway_operator_wave_seconds", None
        )
        return total / all_total if all_total else 0.0

    def _refuse_hot_chains(self, plane) -> int:
        from pathway_tpu_torch.engine.core import (
            FilterNode,
            FusedRowwiseNode,
            MapNode,
        )

        fusible = (MapNode, FilterNode, FusedRowwiseNode)
        changes = 0
        for node in list(self.graph.nodes):
            if not isinstance(node, fusible) or getattr(node, "_replaced", False):
                continue
            if node._cone_absorbed or node._cone is not None:
                continue  # cone members fire through the cone, not alone
            # start of a linear stateless run: single live downstream
            # that is also fusible, whose only input is this node
            chain = [node]
            cur = node
            while True:
                downs = [
                    d for d, _i in cur.downstream
                    if not getattr(d, "_replaced", False)
                ]
                if len(downs) != 1 or not isinstance(downs[0], fusible):
                    break
                nxt = downs[0]
                if len(nxt.inputs) != 1 or any(b for b in nxt.buffers):
                    break
                if nxt._cone_absorbed:
                    break
                chain.append(nxt)
                cur = nxt
            if len(chain) < 2:
                continue
            share = sum(self._wave_share(plane, n) for n in chain)
            if share < self.hot_share:
                continue
            fused = FusedRowwiseNode.from_live_nodes(self.graph, chain)
            if fused is None:
                continue
            changes += 1
            plane.metrics.counter("pathway_planner_refusions")
            plane.record(
                "replan", action="refuse",
                nodes=[n.describe() for n in chain], share=round(share, 4),
            )
            self.report["replans"].append({
                "action": "refuse", "share": round(share, 4),
                "nodes": [n.describe() for n in chain],
            })
        return changes

    # ------------------------------------------------- exchange retune

    def _retune_exchange(self, plane) -> int:
        from pathway_tpu_torch.parallel import column_plane as cp
        from pathway_tpu_torch.parallel import device_exchange as dx

        exchanger = dx._ENGINE_EXCHANGER
        col = cp._ENGINE_EXCHANGER
        if (exchanger is None and col is None) or self._exchange_tuned >= 4:
            return 0
        # honor an auto<->force env flip between runs on the singletons
        if exchanger is not None:
            exchanger._mode = dx.mode()
        if col is not None:
            col._mode = dx.mode()
        inv = plane.metrics.counter_value("pathway_device_exchange_invocations")
        rows = plane.metrics.counter_value("pathway_device_exchange_rows")
        if inv < 8:
            return 0
        rpi = rows / inv
        tuned = False
        if rpi < self.min_rows_per_exchange:
            # thin batches are paying dispatch overhead: raise the bar
            action = "exchange_retune"
            if exchanger is not None:
                # bounded vs the env default; a knob already saturated
                # at the bound must not burn budget or record a replan
                bound = min(exchanger._auto_min_base * 16, 1 << 26)
                if exchanger._auto_min < bound:
                    exchanger._auto_min = min(exchanger._auto_min * 2, bound)
                    tuned = True
            elif col._auto_min_rows < min(
                col._auto_min_rows_base * 16, 1 << 24
            ):
                # scalar-only workloads never build the vector exchanger:
                # tune the column plane's ROW threshold directly
                col._auto_min_rows = min(
                    col._auto_min_rows * 2,
                    col._auto_min_rows_base * 16,
                    1 << 24,
                )
                tuned = True
        elif rpi >= 8 * self.min_rows_per_exchange:
            # sustained wins (fat batches riding the wire every wave):
            # LOWER the crossover so the column lift engages earlier —
            # bounded at base/16 so auto can never reach trivial batches
            action = "exchange_retune_down"
            if exchanger is not None:
                floor = max(exchanger._auto_min_base // 16, 4096)
                if exchanger._auto_min > floor:
                    exchanger._auto_min = max(exchanger._auto_min // 2, floor)
                    tuned = True
            else:
                floor = max(
                    col._auto_min_rows_base // 16, 4096 // cp._AUTO_LANES
                )
                if col._auto_min_rows > floor:
                    col._auto_min_rows = max(col._auto_min_rows // 2, floor)
                    tuned = True
        if not tuned:
            # saturated bound or mid-band rpi: record nothing and leave
            # the retune budget for fences that can still move a knob
            return 0
        if col is not None and exchanger is not None:
            # one tuned crossover governs both planes: the column plane's
            # ROW threshold derives from the element threshold / lane count
            col._auto_min_rows = max(exchanger._auto_min // cp._AUTO_LANES, 1)
        auto_min = (
            exchanger._auto_min
            if exchanger is not None
            else col._auto_min_rows * cp._AUTO_LANES
        )
        self._exchange_tuned += 1
        plane.metrics.counter("pathway_planner_retunes")
        plane.record("replan", action=action, auto_min=auto_min)
        self.report["replans"].append({
            "action": action, "auto_min": auto_min,
        })
        return 1

    # ---------------------------------------------------- spill retune

    def _retune_spill(self, plane) -> int:
        """Thrash detection for out-of-core arrangements: when the probe
        ladder keeps landing on disk (run hits dominate the fence-to-
        fence probe window, i.e. the working set exceeds the resident
        budget), double the spilled stores' budgets — bounded at 4x the
        configured base so a genuinely huge key space cannot re-inflate
        RSS past what the operator asked for."""
        from pathway_tpu_torch.engine import spill as _spill

        if self._spill_tuned >= 4:
            return 0
        stores = [s for s in _spill.stores() if s.has_runs]
        if not stores:
            return 0
        hits = plane.metrics.counter_value(
            "pathway_spill_probe_tier", {"tier": "run_hit"}
        )
        window = hits - self._spill_probe_seen
        self._spill_probe_seen = hits
        # thrash signal: at least one full budget's worth of groups came
        # back off disk since the last fence — the tail is too small to
        # hold the live working set
        min_budget = min(s.budget for s in stores)
        if window < max(min_budget, 64):
            return 0
        tuned = []
        for s in stores:
            bound = s.base_budget * 4
            if s.budget < bound:
                s.budget = min(s.budget * 2, bound)
                tuned.append({"store": s.label, "budget": s.budget})
        if not tuned:
            return 0
        self._spill_tuned += 1
        plane.metrics.counter("pathway_planner_retunes")
        plane.record(
            "replan", action="spill_retune",
            run_hits=int(window), stores=tuned,
        )
        self.report["replans"].append({
            "action": "spill_retune", "run_hits": int(window),
            "stores": tuned,
        })
        return 1

    # --------------------------------------------------- morsel retune

    def _retune_morsels(self, plane) -> int:
        """Morsel granularity off the wave histograms: the steal
        scheduler publishes per-morsel execution latency
        (``pathway_morsel_task_seconds``); a fence window averaging
        under ~1ms means morsels are paying more claim traffic than
        compute (double the rows), over ~50ms means a straggler is too
        coarse for stealing to smooth (halve them). Bounded by
        ``morsel.set_rows`` (16x either side of the env-configured base)
        and by the usual per-run retune budget."""
        from pathway_tpu_torch.engine import morsel as _morsel

        if self._morsel_tuned >= 4 or not _morsel.enabled_cached():
            return 0
        cnt, total = plane.metrics.histogram_stats(
            "pathway_morsel_task_seconds", None
        )
        window = cnt - self._morsel_task_seen
        if window < 64:
            return 0  # too few morsels since the last fence to judge
        mean = (total - self._morsel_task_total) / window
        self._morsel_task_seen = cnt
        self._morsel_task_total = total
        rows = _morsel.morsel_rows_cached()
        if mean < 1e-3:
            applied = _morsel.set_rows(rows * 2)
            action = "morsel_retune_up"
        elif mean > 50e-3:
            applied = _morsel.set_rows(rows // 2)
            action = "morsel_retune_down"
        else:
            return 0
        if applied == rows:
            return 0  # saturated bound: leave the budget for live knobs
        self._morsel_tuned += 1
        plane.metrics.counter("pathway_planner_retunes")
        plane.record(
            "replan", action=action,
            mean_ms=round(mean * 1e3, 3), morsel_rows=applied,
        )
        self.report["replans"].append({
            "action": action, "mean_ms": round(mean * 1e3, 3),
            "morsel_rows": applied,
        })
        return 1
