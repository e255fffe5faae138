"""Lowering: graph IR (OpSpecs) -> engine nodes.

Reference parity: internals/graph_runner/ (storage_graph.py:51 plans,
operator_handler.py:77 per-op handlers, expression_evaluator.py:201 rowwise
eval). Tree-shaking is implicit: only specs reachable from requested sinks
are lowered.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine import core as eng
from pathway_tpu_torch.engine.runtime import (
    AsyncApplyNode,
    Connector,
    InputSession,
    IterateNode,
    OutputNode,
    Runtime,
)
from pathway_tpu_torch.engine.workers import ShardedNode, worker_threads
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.expression_compiler import (
    Resolver,
    compile_expression,
    referenced_tables,
)
from pathway_tpu_torch.internals.keys import Key, hash_values, key_for_values
from pathway_tpu_torch.internals import planner as _planner
from pathway_tpu_torch.internals.table import OpSpec, Table


import itertools as _itertools

_session_ids = _itertools.count()


def _route_key(key: Key, row: tuple) -> int:
    """Default shard key: the record's 128-bit key (keyed-node exchange)."""
    return key.value


class _SlotRef(ex.ColumnExpression):
    """Direct (input_idx, col_idx) reference injected during lowering."""

    def __init__(self, input_idx: int, col_idx: int):
        self.input_idx = input_idx
        self.col_idx = col_idx


class GroupResolver(Resolver):
    """Resolver for post-groupby expressions: grouping columns and reducer
    results live in the groupby node's output row."""

    def __init__(self, gb_exprs: list, reducer_slots: dict[int, int], table: Table):
        super().__init__([None], reducer_slots=reducer_slots, reducer_input=0)
        self.gb_exprs = gb_exprs
        self.source_table = table

    def resolve(self, ref: ex.ColumnReference) -> tuple[int, int | None]:
        if isinstance(ref, ex.IdReference):
            return (0, None)
        for i, g in enumerate(self.gb_exprs):
            if isinstance(g, ex.ColumnReference) and g.name == ref.name:
                return (0, i)
        raise KeyError(
            f"column {ref.name!r} is not part of the groupby key; "
            f"wrap it in a reducer"
        )


class JoinResolver(Resolver):
    """Resolver over a join node's output rows: (lkey, rkey, *lrow, *rrow)."""

    def __init__(self, left: Table, right: Table):
        super().__init__([None], left_table=left, right_table=right)
        self.left = left
        self.right = right
        self.lnames = left._column_names()
        self.rnames = right._column_names()

    def resolve(self, ref: ex.ColumnReference) -> tuple[int, int | None]:
        from pathway_tpu_torch.internals.joins import _JoinIdRef

        if isinstance(ref, _JoinIdRef):
            return (0, None)
        tab = ref.table
        if isinstance(tab, ex.ThisMarker):
            tab = self.left if tab._side in ("this", "left") else self.right
        if isinstance(ref, ex.IdReference):
            return (0, 0) if tab is self.left else (0, 1)
        if tab is self.left:
            return (0, 2 + self.lnames.index(ref.name))
        if tab is self.right:
            return (0, 2 + len(self.lnames) + self.rnames.index(ref.name))
        raise KeyError(f"table of {ref!r} is not a join side")


class Session:
    """One lowering + execution context (per pw.run / debug computation)."""

    def __init__(self) -> None:
        self.graph = eng.Graph()
        self.cache: dict[int, eng.Node] = {}
        self.static_batches: list[tuple[int, eng.InputNode, list]] = []
        self.connectors: list[Connector] = []
        self.iterate_nodes: dict[int, IterateNode] = {}
        self.placeholder_data: dict[str, list] = {}
        self.placeholder_nodes: dict[str, eng.InputNode] = {}
        self.autocommit_ms = 2
        self.monitors: list[Callable[[int], None]] = []
        # cooperative stop for background runs (LiveTable.stop)
        import threading as _threading

        self.stop_event = _threading.Event()
        # PATHWAY_THREADS worker shards for stateful operators; read per
        # session so worker-count-invariance tests can flip it in-process.
        self.n_workers = worker_threads()
        # PATHWAY_PROCESSES inter-process data plane: every process runs
        # this same graph; stateful-operator inputs exchange over the TCP
        # mesh (parallel/process_mesh.py) so each key lives on exactly
        # one process. Wire ids are namespaced per session because the
        # mesh is process-wide.
        from pathway_tpu_torch.parallel.process_mesh import get_mesh

        self.mesh = get_mesh()
        self._session_seq = next(_session_ids)
        self._connector_seq = 0
        self._exchange_seq = 0
        # spec ids whose engine nodes emit token-resident NativeBatch
        # segments (native fs sources and the map/filter nodes downstream
        # of them) — drives MapNode/FilterNode plan selection
        self._native_specs: set[int] = set()
        # ---- plan optimizer (internals/planner.py; PATHWAY_FUSE=0
        # bypasses every pass and reproduces the unoptimized plans
        # byte-identically). plan_ctx (consumer counts + id-observability
        # over the reachable spec DAG) is attached by the session owner
        # (run.py / debug / the iterate body builder) BEFORE lowering;
        # without it the optimizer stays inert.
        self.fuse = _planner.fuse_enabled()
        self.plan_ctx = None
        self.plan_report = _planner.new_report()
        self.graph.plan_report = self.plan_report
        self._fusing: set[int] = set()
        # plan-verifier inputs (internals/verifier.py): the roots and
        # sink metadata are recorded even with the optimizer off, so the
        # verifier can re-derive invariants over the same reachable DAG
        self._plan_roots: list = []
        self._sink_meta: list = []
        self._persistent = False

    def attach_plan_roots(
        self, roots: list, sink_meta: list | None = None,
        persistent: bool = False,
    ) -> None:
        """Build the optimizer's DAG-wide context from the tables this
        session will lower (sinks/subscribes/captures). Analysis failure
        downgrades to the unoptimized plans rather than erroring."""
        self._plan_roots = list(roots)
        self._sink_meta = list(sink_meta or [])
        self._persistent = persistent
        if not self.fuse or not roots:
            return
        try:
            self.plan_ctx = _planner.PlanContext(
                roots, sink_meta=sink_meta, persistent=persistent
            )
        except Exception:  # noqa: BLE001 — optimizer must never break lowering
            self.plan_ctx = None
            self.plan_report["elision"]["veto"] = "plan analysis failed"
            return
        rep = self.plan_report["elision"]
        rep["veto"] = self.plan_ctx.elision_veto_reason
        if not self._elision_session_ok():
            self.plan_ctx.cheap_key_sources.clear()
            self.plan_ctx.cheap_id_joins.clear()
            if rep["veto"] is None:
                rep["veto"] = "multi-worker / mesh session"

    def _elision_session_ok(self) -> bool:
        """Cheap keys reshard rows under worker/process exchanges (the
        route hash changes), which permutes shard-merged emission order —
        id elision therefore stays single-worker, single-process."""
        return (
            self.plan_ctx is not None
            and self.plan_ctx.elision_ok
            and self.n_workers <= 1
            and self.mesh is None
        )

    def _next_wire_id(self) -> int:
        """Cross-process-stable, cross-session-unique exchange channel id:
        sessions and exchange nodes are created in the same order on every
        process (identical programs), and the session prefix keeps two
        pipelines sharing one process-wide mesh apart."""
        self._exchange_seq += 1
        return self._session_seq * 1_000_000 + self._exchange_seq

    def _process_exchange(
        self,
        nodes: list[eng.Node],
        route_fns: list[Callable] | None,
        native_routes: list | None = None,
    ) -> list[eng.Node]:
        """Wrap operator inputs with inter-process exchange boundaries.
        route_fns=None pins everything to process 0 (global-state ops).
        native_routes lets token batches split in C and cross the mesh in
        wire form instead of per-row pickles."""
        if self.mesh is None:
            return nodes
        from pathway_tpu_torch.engine.workers import ProcessExchangeNode

        return [
            ProcessExchangeNode(
                self.graph,
                node,
                self.mesh,
                None if route_fns is None else route_fns[i],
                wire_id=self._next_wire_id(),
                native_route=(
                    None if native_routes is None else native_routes[i]
                ),
            )
            for i, node in enumerate(nodes)
        ]

    def _sharded(
        self,
        inputs: list[eng.Node],
        factory: Callable[[eng.Graph, list[eng.Node]], eng.Node],
        route_fns: list[Callable],
        native_routes: list | None = None,
    ) -> eng.Node:
        """Build a stateful node, sharded across the session's workers.

        Each worker owns the slice of the operator's state whose shard key
        routes to it (the multi-worker exchange; engine/workers.py).
        Under PATHWAY_PROCESSES > 1, the inputs first cross the
        inter-process exchange on the same shard keys, so a key's state
        lives on exactly one process (and one thread shard within it).
        Single-worker sessions build the node directly on the main graph.

        `native_routes` lets token-resident batches split across shards in
        C (engine/workers.py ShardedNode._exchange_native); inputs routed
        by the record key get the ('key',) plan automatically.
        """
        if native_routes is None:
            native_routes = [
                ("key",) if fn is _route_key else None for fn in route_fns
            ]
        inputs = self._process_exchange(list(inputs), route_fns, native_routes)
        if self.n_workers <= 1:
            return factory(self.graph, list(inputs))
        return ShardedNode(
            self.graph, inputs, factory, route_fns, self.n_workers,
            native_routes=native_routes,
        )

    # ---------------------------------------------------------------- build

    def node_of(self, table: Table) -> eng.Node:
        spec = table._spec
        if spec.id in self.cache:
            return self.cache[spec.id]
        n_before = len(self.graph.nodes)
        node = None
        if (
            self.fuse
            and self.plan_ctx is not None
            and spec.id not in self._fusing
        ):
            node = self._try_fuse_chain(table, spec)
        if node is None:
            node = self._build(table, spec)
        # user-frame trace for runtime error messages (trace.py parity)
        trace = getattr(spec, "trace", None)
        if trace and node.trace is None:
            node.trace = trace
            for replica in getattr(node, "replicas", []):
                replica.trace = trace
        # plan-node label: the op-spec kind names WHAT the operator is in
        # the pipeline (groupby/join/select/...), which is what the TUI,
        # logs and metrics show — two GroupByNodes stay distinguishable
        # via label + call-site trace + node id (Node.describe). Interior
        # nodes a spec builds (the GroupByNode under a reduce's rowwise
        # tail, join arrangement halves, …) were registered during
        # _build: label every still-unlabeled one with this spec's kind —
        # nodes of nested input specs got theirs first via the recursive
        # node_of, so the sweep only touches this spec's own nodes.
        label = spec.kind
        if spec.kind == "connector":
            label = f"connector:{spec.params.get('name') or ''}"
        for interior in self.graph.nodes[n_before:]:
            if interior.label is None:
                interior.label = label
                if trace and interior.trace is None:
                    interior.trace = trace
                for replica in getattr(interior, "replicas", []):
                    if replica.label is None:
                        replica.label = label
        if node.label is None:
            node.label = label
            for replica in getattr(node, "replicas", []):
                replica.label = label
        # semantic fingerprint incl. UDF bytecode — persistence signature
        # invalidates snapshots when only a function body changes. Kept
        # LAZY (spec reference, hashed on first access) so sessions that
        # never attach persistence don't pay for hashing bulk static rows.
        # Source connectors are exempt: their params are deployment
        # details (broker URL, port, credentials) — reconnecting the same
        # named source to a moved endpoint must keep persisted state
        # (the reference keys source persistence by name for the same
        # reason).
        if spec.kind != "connector":
            node._fingerprint_spec = spec
        self.cache[spec.id] = node
        return node

    def _guarded_row_fn(
        self, fns: list[Callable], trace: str | None
    ) -> Callable:
        """Per-column poison wrapper shared by every rowwise-style fn: a
        failing expression yields ERROR in its column only (reference:
        Value::Error semantics), logged with the user call site."""
        graph = self.graph
        suffix = f" (at {trace})" if trace else ""

        def guard(f: Callable) -> Callable:
            def g(key, rows):
                try:
                    return f(key, rows)
                except Exception as e:  # noqa: BLE001
                    graph.log_error(f"{type(e).__name__}: {e}{suffix}")
                    from pathway_tpu_torch.internals.errors import ERROR

                    return ERROR

            return g

        gfns = [guard(f) for f in fns]

        def fn(key: Key, *rows: tuple) -> tuple:
            return tuple(f(key, rows) for f in gfns)

        return fn

    def _compile_rowwise(
        self,
        main: Table,
        exprs: dict[str, ex.ColumnExpression],
        trace: str | None = None,
    ) -> tuple[list[eng.Node], Callable]:
        """Returns (input nodes, fn(key, *rows) -> out_row), handling side
        tables and async sub-expressions."""
        expr_list = list(exprs.values())
        side_tables = [
            t for t in referenced_tables(expr_list) if isinstance(t, Table) and t is not main
        ]
        # async sub-expressions get their own AsyncApplyNode each
        async_exprs = _collect_async(expr_list)
        input_nodes: list[eng.Node] = [self.node_of(main)]
        tables: list[Any] = [main]
        for t in side_tables:
            input_nodes.append(self.node_of(t))
            tables.append(t)
        substitutions: dict[int, _SlotRef] = {}
        for ae in async_exprs:
            side_idx = len(input_nodes)
            node = self._build_async_node(main, ae)
            input_nodes.append(node)
            substitutions[id(ae)] = _SlotRef(side_idx, len(main._column_names()))
        if substitutions:
            exprs = {
                name: _substitute(e, substitutions) for name, e in exprs.items()
            }
        resolver = _SubstitutingResolver(tables, substitutions)
        fns = [compile_expression(e, resolver) for e in exprs.values()]
        return input_nodes, self._guarded_row_fn(fns, trace)

    def _pointer_expr_cols(
        self, main: Table, e: Any, names: list[str]
    ) -> list[int] | None:
        """pointer_from over plain stably-typed columns: the key128 can
        blake in C (dp_rekey / build_rows vtag 4). None = not eligible."""
        if not (
            isinstance(e, ex.PointerExpression)
            and e._instance is None
            and not e._optional
            and e._args
        ):
            return None
        from pathway_tpu_torch.internals import dtype as dt

        cols: list[int] = []
        for a in e._args:
            if (
                isinstance(a, ex.ColumnReference)
                and not isinstance(a, ex.IdReference)
                and a.name in names
                and (
                    main._dtype_of(a.name) in (dt.INT, dt.STR, dt.BOOL)
                    or isinstance(main._dtype_of(a.name), dt.Pointer)
                )
            ):
                cols.append(names.index(a.name))
            else:
                return None
        return cols

    def _plane_scalar_schema(self, table: Table) -> bool:
        """Every declared column dtype is a plane-representable scalar —
        the gate for marking a STATIC table native: its object rows intern
        losslessly, so downstream operators may plan token-resident (the
        iterate bodies' closure tables — edge lists keyed by pointers —
        are the motivating case)."""
        from pathway_tpu_torch.internals import dtype as dt

        def scalar(d) -> bool:
            if d in (dt.INT, dt.FLOAT, dt.BOOL, dt.STR, dt.BYTES):
                return True
            if isinstance(d, dt.Pointer):
                return True
            if isinstance(d, dt.Optional):
                return scalar(d.wrapped)
            return False

        try:
            return all(
                scalar(table._dtype_of(n)) for n in table._column_names()
            )
        except Exception:  # noqa: BLE001 — undecidable schema: stay object
            return False

    @staticmethod
    def _distinct_insert_rows(rows: list) -> bool:
        """All diffs +1 with globally distinct keys — the shape whose
        per-key operator semantics are plane-invariant."""
        seen: set[int] = set()
        for (_t, key, _row, diff) in rows:
            if diff != 1 or key.value in seen:
                return False
            seen.add(key.value)
        return True

    def _native_map_specs(self, main: Table, exprs: dict) -> dict | None:
        """MapNode-style vectorized plan for a select's expressions over
        `main` (plain column picks, C-blakeable pointer_from, numpy-
        compilable numerics). None = not fully plannable. Shared by the
        single-node MapNode path and the optimizer's chain fusion."""
        from pathway_tpu_torch.internals.expression_numpy import (
            KeyColsPlan,
            compile_numpy,
        )

        names = main._column_names()
        specs: list = []
        plans: list = []
        needed: set[int] = set()
        for e in exprs.values():
            if (
                isinstance(e, ex.ColumnReference)
                and not isinstance(e, ex.IdReference)
                and e.name in names
            ):
                specs.append(("col", names.index(e.name)))
                continue
            key_cols = self._pointer_expr_cols(main, e, names)
            if key_cols is not None:
                specs.append(("val", len(plans)))
                plans.append(KeyColsPlan(key_cols))
                continue
            plan = compile_numpy(e, names)
            if plan is None:
                return None
            specs.append(("val", len(plans)))
            plans.append(plan)
            needed |= plan.needed_cols
        return {"specs": specs, "plans": plans, "needed_cols": sorted(needed)}

    def _try_native_map(
        self, main: Table, exprs: dict, spec: OpSpec
    ) -> eng.Node | None:
        """Select on a native-plane table whose expressions are all plain
        column projections or vectorizable numerics lowers to a stateless
        MapNode: rows stay token-resident (keys pass through, new rows
        build in C), with no sharded exchange at all. Returns None when
        the shape doesn't qualify (general RowwiseNode path)."""
        main_node = self.node_of(main)  # building it registers native-ness
        if main._spec.id not in self._native_specs:
            return None
        expr_list = list(exprs.values())
        side = [
            t
            for t in referenced_tables(expr_list)
            if isinstance(t, Table) and t is not main
        ]
        if side or _collect_async(expr_list):
            return None
        native_plan = self._native_map_specs(main, exprs)
        if native_plan is None:
            return None
        resolver = Resolver([main])
        fns = [compile_expression(e, resolver) for e in exprs.values()]
        grf = self._guarded_row_fn(fns, getattr(spec, "trace", None))
        node = eng.MapNode(
            self.graph,
            main_node,
            lambda key, row: grf(key, row),
            native_plan=native_plan,
        )
        self._native_specs.add(spec.id)
        return node

    # ------------------------------------------------------ chain fusion
    #
    # Plan-optimizer pass (internals/planner.py, docs/planner.md): linear
    # runs of rowwise operators collapse into one FusedRowwiseNode per
    # maximal same-plane group. Intermediates must be provably single-
    # consumer over the reachable spec DAG; object-plane chains need a
    # single-worker, single-process session (sharded RowwiseNodes merge
    # emissions shard-major, so unsharding them would permute bytes).

    def _fusible_spec(self, spec: OpSpec) -> bool:
        if spec.kind == "rowwise":
            exprs = list(spec.params["exprs"].values())
        elif spec.kind == "filter":
            exprs = [spec.params["cond"]]
        else:
            return False
        if _collect_async(exprs):
            return False
        main = spec.inputs[0]
        return not any(
            isinstance(t, Table) and t is not main
            for t in referenced_tables(exprs)
        )

    def _rekey_fusible(self, spec: OpSpec) -> bool:
        """Reindex terminates an object-plane fusion group (its rekey +
        consolidate runs on the fused node's output entries). Pointer-
        instance/native machinery keeps the standalone ReindexNode."""
        return spec.kind == "reindex"

    def _compile_fused_stage(self, t: Table, s: OpSpec):
        """(kind, row_fn) object step for one chain member."""
        main = s.inputs[0]
        resolver = Resolver([main])
        if s.kind == "rowwise":
            exprs = s.params["exprs"]
            fns = [compile_expression(e, resolver) for e in exprs.values()]
            grf = self._guarded_row_fn(fns, getattr(s, "trace", None))
            return ("map", lambda key, row: grf(key, row))
        cf = compile_expression(s.params["cond"], resolver)
        return ("filter", lambda key, row: cf(key, (row,)))

    def _try_fuse_chain(self, table: Table, spec: OpSpec) -> eng.Node | None:
        ctx = self.plan_ctx
        head_rekey = self._rekey_fusible(spec)
        if not head_rekey and not self._fusible_spec(spec):
            return None
        chain: list[tuple[Table, OpSpec]] = [(table, spec)]
        while True:
            t_in = chain[-1][1].inputs[0]
            s_in = t_in._spec
            if (
                s_in.id in self.cache
                or not self._fusible_spec(s_in)
                or ctx.consumer_count(s_in) != 1
            ):
                break
            chain.append((t_in, s_in))
        if len(chain) < 2:
            # a lone sargable filter directly above a native scan still
            # pushes into the parse (no node saved, rows dropped at the
            # source); anything else is not worth a fused node
            src_spec = chain[-1][1].inputs[0]._spec
            if not (
                spec.kind == "filter"
                and src_spec.params.get("scan_tuning") is not None
                and (
                    src_spec.kind == "static_native"
                    or src_spec.params.get("native_plane")
                )
            ):
                return None
        chain.reverse()  # bottom-up; chain[-1] is the requested head
        self._fusing.update(s.id for _t, s in chain)
        try:
            return self._build_fused(chain, head_rekey)
        finally:
            self._fusing.difference_update(s.id for _t, s in chain)

    def _flush_fused_group(
        self, group: list, builder, native: bool, rekey=None
    ) -> eng.Node | None:
        """Build one fusion group (>= 2 stages, or 1 stage + a rekey
        terminator) on top of the already-built node of its input.
        Cached under the group head's spec id UNLESS the group carries a
        rekey (the node then embodies the reindex ABOVE the head spec —
        node_of caches it under the reindex's own id). Returns None when
        the group is too small to fuse."""
        if not group or (len(group) < 2 and rekey is None):
            return None
        src_table = group[0][1].inputs[0]
        src_node = self.cache[src_table._spec.id]
        stages = [st for (_t, _s, st) in group]
        head_s = group[-1][1]
        stateful = (not native) and any(k == "map" for k, _f in stages)
        if stateful and (self.n_workers > 1 or self.mesh is not None):
            # unfused, these stages lower to SHARDED RowwiseNodes whose
            # emissions merge shard-major — unsharding them would
            # permute output bytes vs PATHWAY_FUSE=0. Native chains and
            # pure-filter object chains were never sharded, so they
            # fuse at any worker count.
            return None
        if native and builder is not None:
            # source schema width: the verifier's native-program type
            # check resolves every stage-boundary column reference
            # against it (internals/verifier.py)
            try:
                builder.src_width = len(src_table._column_names())
            except Exception:  # noqa: BLE001 — width stays unknown
                pass
        program = builder.build() if native and builder is not None else None
        node = eng.FusedRowwiseNode(
            self.graph,
            src_node,
            stages,
            stateful=stateful,
            native_program=program,
            rekey=rekey,
            detail="+".join(k for k, _f in stages)
            + ("+reindex" if rekey else ""),
        )
        node.label = "fused"
        node.trace = getattr(head_s, "trace", None)
        # the verifier (internals/verifier.py) re-proves the group's
        # single-consumer gates over the raw spec DAG from these ids
        node._fused_spec_ids = [s.id for _t, s, _st in group]
        if native:
            for _t, s, _st in group:
                self._native_specs.add(s.id)
        if rekey is None:
            self.cache[head_s.id] = node
        self.plan_report["fusion_groups"].append({
            "head": head_s.kind,
            "stages": [k for k, _f in stages] + (["reindex"] if rekey else []),
            "native": bool(program),
            "nodes_saved": len(stages) - 1 + (1 if rekey else 0),
            "spec_ids": list(node._fused_spec_ids),
            "trace": getattr(head_s, "trace", None),
        })
        return node

    def _build_fused(
        self, chain: list, head_rekey: bool
    ) -> eng.Node | None:
        from pathway_tpu_torch.internals.expression_numpy import compile_numpy

        src_table = chain[0][1].inputs[0]
        src_spec = src_table._spec
        # scan filter pushdown: a native scan feeding this chain alone
        # can pre-filter at parse time — decide BEFORE building the
        # source so the tuning reaches the parser (claiming resets any
        # previous session's decisions first)
        tuning = self._claim_scan_tuning(src_spec)
        scan_native = src_spec.kind == "static_native" or (
            src_spec.kind == "connector"
            and src_spec.params.get("native_plane")
        )
        if (
            tuning is not None
            and scan_native
            and self.plan_ctx.consumer_count(src_spec) == 1
        ):
            names = src_table._column_names()
            for _t, s in chain:
                if s.kind != "filter":
                    break
                plan = compile_numpy(s.params["cond"], names)
                if plan is None:
                    break
                # advisory plans only: rows a plan can't judge stay in
                # and the FilterNode above keeps the exact semantics
                tuning.setdefault("filters", []).append(plan)
                self.plan_report["pushdowns"].append({
                    "kind": "scan-filter",
                    "source": src_spec.params.get("name") or src_spec.kind,
                    "trace": getattr(s, "trace", None),
                })
        src_node = self.node_of(src_table)
        assert src_node is not None
        cur_native = src_table._spec.id in self._native_specs
        group: list = []  # (table, spec, (kind, fn))
        builder = eng._NativeProgramBuilder() if cur_native else None
        head_node: eng.Node | None = None

        def lower_single(t: Table) -> None:
            nonlocal cur_native
            self.node_of(t)  # _fusing guard forces the normal path
            cur_native = t._spec.id in self._native_specs

        def flush(rekey=None) -> None:
            nonlocal group, builder, cur_native, head_node
            node = self._flush_fused_group(group, builder, cur_native, rekey)
            if node is None:
                for t, _s, _st in group:
                    lower_single(t)
            else:
                cur_native = cur_native and node._program is not None
            group = []
            builder = eng._NativeProgramBuilder() if cur_native else None
            head_node = node

        for t, s in chain:
            if head_rekey and s is chain[-1][1]:
                # reindex head: terminates an OBJECT group; native plans
                # keep the standalone ReindexNode's C rekey paths
                if group and not cur_native:
                    resolver = Resolver([s.inputs[0]])
                    kf = compile_expression(s.params["key_expr"], resolver)

                    def key_fn(key: Key, row: tuple) -> Key:
                        v = kf(key, (row,))
                        if not isinstance(v, Key):
                            v = key_for_values(v)
                        return v

                    flush(rekey=key_fn)
                    if head_node is not None:
                        return head_node  # node_of caches it as `s`
                flush()
                lower_single(t)
                return self.cache[s.id]
            stage = self._compile_fused_stage(t, s)
            if cur_native:
                if builder is None:
                    # a singly-lowered mid-chain stage flipped the plane
                    # back to native (aligned-select marking): start a
                    # fresh program over its output
                    builder = eng._NativeProgramBuilder()
                ok = False
                if s.kind == "rowwise":
                    plan = self._native_map_specs(
                        s.inputs[0], s.params["exprs"]
                    )
                    if plan is not None:
                        ok = builder.add_map(plan["specs"], plan["plans"])
                else:
                    cplan = compile_numpy(
                        s.params["cond"], s.inputs[0]._column_names()
                    )
                    if cplan is not None:
                        ok = builder.add_filter(cplan)
                if not ok:
                    # plane break: flush what we have, lower this stage
                    # normally, and continue grouping on its output plane
                    flush()
                    lower_single(t)
                    builder = (
                        eng._NativeProgramBuilder() if cur_native else None
                    )
                    continue
            group.append((t, s, stage))
        flush()
        if head_node is not None:
            return head_node
        return self.cache.get(chain[-1][1].id)

    # -------------------------------------------------- pushdown helpers

    def _claim_scan_tuning(self, spec: OpSpec) -> dict | None:
        """The scan-tuning dict is shared by every session that lowers
        this Table (it lives on the spec, and connector factories close
        over it). The FIRST toucher in each session resets the previous
        session's decisions — a pushed filter or cheap-key choice from
        run 1 must never leak into run 2's plan (run 2 may not have the
        filter above the scan at all, or may run with PATHWAY_FUSE=0)."""
        tuning = spec.params.get("scan_tuning")
        if tuning is None or tuning.get("pinned"):
            return None
        if tuning.get("session") != self._session_seq:
            tuning["session"] = self._session_seq
            tuning["key_mode"] = 0
            tuning["filters"] = []
        return tuning

    def _apply_scan_tuning(self, spec: OpSpec) -> None:
        """Decide the scan-level optimizations for a native source
        (consumed by io/fs.py at parse time through the shared tuning
        dict): cheap sequential keys when the plan proves this source's
        row ids unobservable. Pushed filters were added by the fusion
        pass before the source was built."""
        tuning = self._claim_scan_tuning(spec)
        if tuning is None or not self.fuse or self.plan_ctx is None:
            return
        if (
            spec.id in self.plan_ctx.cheap_key_sources
            and self._elision_session_ok()
            and not tuning.get("key_mode")
        ):
            tuning["key_mode"] = 1
            self.plan_report["pushdowns"].append({
                "kind": "scan-key-elision",
                "source": spec.params.get("name") or spec.kind,
            })

    def _try_filter_pushdown(
        self, table: Table, spec: OpSpec
    ) -> eng.Node | None:
        """filter(join(L, R)) with a single-side sargable condition
        lowers as join(filter(L), R): surviving rows keep their keys and
        relative order (byte-identical), while dropped rows never enter
        the join's arrangements or cross its exchange wire."""
        if not self.fuse or self.plan_ctx is None:
            return None
        main = spec.inputs[0]
        jspec = main._spec
        if (
            jspec.kind != "join"
            or jspec.id in self.cache
            or jspec.params["mode"] != "inner"
            or jspec.params.get("asof_now")
            or self.plan_ctx.consumer_count(jspec) != 1
        ):
            return None
        cond = spec.params["cond"]
        if _collect_async([cond]):
            return None
        if any(
            isinstance(t, Table) and t is not main
            for t in referenced_tables([cond])
        ):
            return None
        out_exprs = jspec.params["exprs"]
        left_t, right_t = jspec.inputs
        refs: list[ex.ColumnReference] = []
        seen: set[int] = set()

        def collect(e) -> bool:
            if id(e) in seen:
                return True
            seen.add(id(e))
            if isinstance(e, ex.IdReference):
                return False  # output ids are not pushable
            if isinstance(e, ex.ColumnReference):
                refs.append(e)
                return True
            return all(collect(s) for s in e._sub_expressions())

        if not collect(cond) or not refs:
            return None
        side: int | None = None
        mapping: dict[int, ex.ColumnExpression] = {}
        for r in refs:
            target = out_exprs.get(r.name)
            if not isinstance(target, ex.ColumnReference) or isinstance(
                target, ex.IdReference
            ):
                return None
            ttab = target.table
            if isinstance(ttab, ex.ThisMarker):
                ttab = left_t if ttab._side in ("this", "left") else right_t
            if ttab is left_t:
                s = 0
            elif ttab is right_t:
                s = 1
            else:
                return None
            if side is None:
                side = s
            elif side != s:
                return None
            mapping[id(r)] = target
        if side is None:
            return None
        side_t = (left_t, right_t)[side]
        new_cond = _clone_replace(cond, mapping)
        side_node = self.node_of(side_t)
        resolver = Resolver([side_t])
        cf = compile_expression(new_cond, resolver)
        native_plan = None
        if side_t._spec.id in self._native_specs:
            from pathway_tpu_torch.internals.expression_numpy import compile_numpy

            native_plan = compile_numpy(new_cond, side_t._column_names())
        fnode = eng.FilterNode(
            self.graph, side_node,
            lambda key, row: cf(key, (row,)),
            native_plan=native_plan,
        )
        fnode.label = "filter:pushdown"
        fnode.trace = getattr(spec, "trace", None)
        self.plan_report["pushdowns"].append({
            "kind": "filter-through-join",
            "side": "left" if side == 0 else "right",
            "trace": getattr(spec, "trace", None),
        })
        return self._build_join(
            main, jspec, side_nodes={side: fnode}
        )

    def _build_async_node(self, main: Table, ae: ex.AsyncApplyExpression) -> eng.Node:
        resolver = Resolver([main])
        arg_fns = [compile_expression(a, resolver) for a in ae._args]
        kw_fns = {k: compile_expression(v, resolver) for k, v in ae._kwargs.items()}
        raw_fn = ae._fn

        def call(key: Key, row: tuple) -> Any:
            rows = (row,)
            args = [f(key, rows) for f in arg_fns]
            kwargs = {k: f(key, rows) for k, f in kw_fns.items()}
            return raw_fn(*args, **kwargs)

        deterministic = ae._deterministic
        return self._sharded(
            [self.node_of(main)],
            lambda sg, ins: AsyncApplyNode(
                sg, ins[0], call, is_async=True, deterministic=deterministic
            ),
            [_route_key],
        )

    def _build(self, table: Table, spec: OpSpec) -> eng.Node:
        kind = spec.kind
        g = self.graph

        if kind == "static":
            node = eng.InputNode(g)
            if (
                eng._nb_type() is not None
                and self._plane_scalar_schema(table)
                and self._distinct_insert_rows(spec.params["rows"])
            ):
                # all-scalar schema + a healthy all-insert key set: the
                # object rows intern losslessly and key-level operator
                # semantics agree across planes, so downstream operators
                # (joins/maps over debug tables, the iterate bodies'
                # closure edge lists) may plan native. Tables carrying
                # retractions or duplicate keys keep the object plans
                # (RowwiseNode's keyed dedup semantics).
                self._native_specs.add(spec.id)
            if self.mesh is not None and self.mesh.process_id != 0:
                # every process builds the same static tables; process 0
                # owns the rows (exchanges distribute them) — otherwise
                # each key would arrive N times at its owner
                return node
            rows = spec.params["rows"]
            by_time: dict[int, list] = {}
            for t, key, row, diff in rows:
                by_time.setdefault(t, []).append((key, row, diff))
            for t, entries in by_time.items():
                self.static_batches.append((t, node, entries))
            return node

        if kind == "static_native":
            node = eng.InputNode(g)
            self._native_specs.add(spec.id)
            self._apply_scan_tuning(spec)
            if self.mesh is not None and self.mesh.process_id != 0:
                return node  # process 0 owns static rows (see "static")
            parse = spec.params.get("parse")
            if parse is not None:
                # lazy static scan (io/fs.py): parse at lowering, once
                # the optimizer's scan tuning (key mode, pushed filters)
                # is decided — and only on the owning process
                batches, seq_rows = parse()
                for b in batches:
                    self.static_batches.append((0, node, b))
                if seq_rows:
                    self.static_batches.append((0, node, list(seq_rows)))
                return node
            for b in spec.params.get("batches", []):
                self.static_batches.append((0, node, b))
            rows = spec.params.get("rows", [])
            by_time: dict[int, list] = {}
            for t, key, row, diff in rows:
                by_time.setdefault(t, []).append((key, row, diff))
            for t, entries in by_time.items():
                self.static_batches.append((t, node, entries))
            return node

        if kind == "connector":
            node = eng.InputNode(g)
            if spec.params.get("native_plane"):
                self._native_specs.add(spec.id)
                self._apply_scan_tuning(spec)
            ordinal = self._connector_seq
            self._connector_seq += 1
            if self.mesh is not None and ordinal % self.mesh.n != self.mesh.process_id:
                # another process owns this source; downstream exchange
                # boundaries distribute its rows here as needed
                return node
            factory = spec.params["factory"]
            session = InputSession(node, upsert=spec.params.get("upsert", False))
            connector = factory(session)
            # global lowering ordinal: ownership is ordinal % mesh.n, and
            # elastic rebalance (parallel/membership.py) needs it to route
            # a source's journal to its owner under a NEW mesh size
            connector.ordinal = ordinal
            self.connectors.append(connector)
            return node

        if kind == "iterate_placeholder":
            node = eng.InputNode(g)
            name = spec.params["name"]
            self.placeholder_nodes[name] = node
            entries = self.placeholder_data.get(name, [])
            if entries:
                self.static_batches.append((0, node, list(entries)))
            if eng.iterate_native_on():
                # a token-resident IterateNode feeds placeholders whole
                # NativeBatch waves: let the body's operators plan native
                self._native_specs.add(spec.id)
            return node

        if kind == "filter":
            node = self._try_filter_pushdown(table, spec)
            if node is not None:
                return node

        if kind == "rowwise":
            exprs = spec.params["exprs"]
            main = spec.inputs[0]
            node = self._try_native_map(main, exprs, spec)
            if node is not None:
                return node
            input_nodes, fn = self._compile_rowwise(main, exprs, trace=spec.trace)
            # aligned-select token gate: every output expression is a
            # plain column of one input table -> rows splice in C
            # (RowwiseNode native_specs), keeping ix/side-select chains
            # token-resident
            native_specs = None
            expr_list = list(exprs.values())
            side_tables = [
                t
                for t in referenced_tables(expr_list)
                if isinstance(t, Table) and t is not main
            ]
            if not _collect_async(expr_list):
                tables = [main] + side_tables
                name_lists = [t._column_names() for t in tables]
                cand: list = []
                for e in expr_list:
                    if isinstance(e, ex.ColumnReference) and not isinstance(
                        e, ex.IdReference
                    ):
                        src = next(
                            (
                                s
                                for s, t in enumerate(tables)
                                if e.table is t and e.name in name_lists[s]
                            ),
                            None,
                        )
                        if src is not None:
                            cand.append((src, name_lists[src].index(e.name)))
                            continue
                    cand = None  # type: ignore[assignment]
                    break
                if cand is not None:
                    native_specs = cand
                    self._native_specs.add(spec.id)
            return self._sharded(
                input_nodes,
                lambda sg, ins: eng.RowwiseNode(
                    sg, ins, fn, native_specs=native_specs
                ),
                [_route_key] * len(input_nodes),
            )

        if kind == "filter":
            main = spec.inputs[0]
            cond = spec.params["cond"]
            side = [
                t for t in referenced_tables([cond]) if isinstance(t, Table) and t is not main
            ]
            if not side and not _collect_async([cond]):
                resolver = Resolver([main])
                cf = compile_expression(cond, resolver)
                native_plan = None
                main_node = self.node_of(main)
                if main._spec.id in self._native_specs:
                    from pathway_tpu_torch.internals.expression_numpy import compile_numpy

                    native_plan = compile_numpy(cond, main._column_names())
                    if native_plan is not None:
                        self._native_specs.add(spec.id)
                return eng.FilterNode(
                    g, main_node, lambda key, row: cf(key, (row,)),
                    native_plan=native_plan,
                )
            # general case: compute condition as an extra aligned column
            names = main._column_names()
            exprs = {n: ex.ColumnReference(main, n) for n in names}
            exprs["__cond__"] = cond
            input_nodes, fn = self._compile_rowwise(main, exprs, trace=spec.trace)
            rw = self._sharded(
                input_nodes,
                lambda sg, ins: eng.RowwiseNode(sg, ins, fn),
                [_route_key] * len(input_nodes),
            )
            flt = eng.FilterNode(g, rw, lambda key, row: row[-1])
            return eng.StatelessNode(
                g, flt, lambda entries, t: [(k, r[:-1], d) for k, r, d in entries]
            )

        if kind == "groupby":
            return self._build_groupby(table, spec)

        if kind == "join":
            return self._build_join(table, spec)

        if kind == "concat":
            nodes = [self.node_of(t) for t in spec.inputs]
            if spec.params.get("reindex"):
                nodes = [
                    eng.ReindexNode(
                        g, n,
                        (lambda salt: lambda key, row: Key(hash_values(key, salt)))(i),
                        # dp_rekey_salt: the salted keys blake in C, so
                        # concat_reindex unions stay token-resident
                        native_salt=i,
                    )
                    for i, n in enumerate(nodes)
                ]
                if all(t._spec.id in self._native_specs for t in spec.inputs):
                    self._native_specs.add(spec.id)
            elif all(t._spec.id in self._native_specs for t in spec.inputs):
                # token batches flow through concat untouched
                self._native_specs.add(spec.id)
            return eng.ConcatNode(g, nodes)

        if kind == "update_rows":
            # token-resident: key-level state, rows pass through as tokens
            self._native_specs.add(spec.id)
            return self._sharded(
                [self.node_of(spec.inputs[0]), self.node_of(spec.inputs[1])],
                lambda sg, ins: eng.UpdateRowsNode(sg, ins[0], ins[1]),
                [_route_key, _route_key],
            )

        if kind == "update_cells":
            col_map = spec.params["col_map"]
            self._native_specs.add(spec.id)
            return self._sharded(
                [self.node_of(spec.inputs[0]), self.node_of(spec.inputs[1])],
                lambda sg, ins: eng.UpdateCellsNode(sg, ins[0], ins[1], col_map),
                [_route_key, _route_key],
            )

        if kind == "setop":
            nodes = [self.node_of(t) for t in spec.inputs]
            mode = spec.params["mode"]
            self._native_specs.add(spec.id)
            return self._sharded(
                nodes,
                lambda sg, ins: eng.SetOpNode(sg, ins, mode),
                [_route_key] * len(nodes),
            )

        if kind == "with_universe_of":
            self._native_specs.add(spec.id)
            return self._sharded(
                [self.node_of(spec.inputs[0]), self.node_of(spec.inputs[1])],
                lambda sg, ins: eng.SetOpNode(sg, ins, "restrict"),
                [_route_key, _route_key],
            )

        if kind == "having":
            indexers = spec.params["indexers"]
            nodes = [self.node_of(spec.inputs[0])]
            for ref in indexers:
                nodes.append(self.node_of(ref.table))
            self._native_specs.add(spec.id)
            return self._sharded(
                nodes,
                lambda sg, ins: eng.SetOpNode(sg, ins, "intersect"),
                [_route_key] * len(nodes),
            )

        if kind == "reindex":
            main = spec.inputs[0]
            key_expr = spec.params["key_expr"]
            resolver = Resolver([main])
            kf = compile_expression(key_expr, resolver)

            def key_fn(key: Key, row: tuple) -> Key:
                v = kf(key, (row,))
                if not isinstance(v, Key):
                    v = key_for_values(v)
                return v

            main_node = self.node_of(main)
            # with_id_from over plain stably-typed columns of a native
            # table: blake the projected pieces in C (dp_rekey) and stay
            # on the token plane
            native_cols = None
            if main._spec.id in self._native_specs and isinstance(
                key_expr, ex.PointerExpression
            ) and key_expr._instance is None and not key_expr._optional:
                from pathway_tpu_torch.internals import dtype as dt

                names = main._column_names()
                cols: list[int] | None = []
                for a in key_expr._args:
                    if (
                        isinstance(a, ex.ColumnReference)
                        and not isinstance(a, ex.IdReference)
                        and a.name in names
                        and (
                            main._dtype_of(a.name) in (dt.INT, dt.STR, dt.BOOL)
                            # pointer pieces blake identically in C
                            or isinstance(main._dtype_of(a.name), dt.Pointer)
                        )
                    ):
                        cols.append(names.index(a.name))
                    else:
                        cols = None
                        break
                if cols:
                    native_cols = cols
                    self._native_specs.add(spec.id)
            # with_id(<pointer column>): the new key IS the column value —
            # key-level decode in C (dp_decode_key_col), no hashing at all
            native_key_col = None
            if native_cols is None and main._spec.id in self._native_specs:
                from pathway_tpu_torch.internals import dtype as dt2

                names = main._column_names()
                if (
                    isinstance(key_expr, ex.ColumnReference)
                    and not isinstance(key_expr, ex.IdReference)
                    and key_expr.name in names
                    and isinstance(main._dtype_of(key_expr.name), dt2.Pointer)
                ):
                    native_key_col = names.index(key_expr.name)
                    self._native_specs.add(spec.id)
            return eng.ReindexNode(
                g, main_node, key_fn, native_cols=native_cols,
                native_key_col=native_key_col,
            )

        if kind == "flatten":
            main = spec.inputs[0]
            idx = main._column_names().index(spec.params["column"])
            if main._spec.id in self._native_specs:
                self._native_specs.add(spec.id)
            return eng.FlattenNode(g, self.node_of(main), idx)

        if kind == "ix":
            context_t, target_t = spec.inputs
            resolver = Resolver([context_t])
            ptr_e = spec.params["pointer"]
            pf = compile_expression(ptr_e, resolver)
            optional = spec.params.get("optional", False)
            target_width = len(target_t._column_names())
            # token-resident gate: a plain pointer-typed column lets the
            # lookup run key-level in C (dp_decode_key_col)
            ptr_col = None
            names = context_t._column_names()
            if (
                isinstance(ptr_e, ex.ColumnReference)
                and not isinstance(ptr_e, ex.IdReference)
                and ptr_e.name in names
            ):
                from pathway_tpu_torch.internals import dtype as dt

                if isinstance(context_t._dtype_of(ptr_e.name), dt.Pointer):
                    ptr_col = names.index(ptr_e.name)
                    self._native_specs.add(spec.id)

            def route_ptr(key: Key, row: tuple) -> Any:
                # colocate each source row with its lookup target
                v = pf(key, (row,))
                return v.value if isinstance(v, Key) else eng.freeze_value(v)

            native_routes = None
            if ptr_col is not None:
                native_routes = [("ptr_col", ptr_col), ("key",)]

            return self._sharded(
                [self.node_of(context_t), self.node_of(target_t)],
                lambda sg, ins: eng.IxNode(
                    sg, ins[0], ins[1],
                    lambda key, row: pf(key, (row,)),
                    optional=optional,
                    target_width=target_width,
                    ptr_col=ptr_col,
                ),
                [route_ptr, _route_key],
                native_routes=native_routes,
            )

        if kind == "sort":
            main = spec.inputs[0]
            resolver = Resolver([main])
            kf = compile_expression(spec.params["key"], resolver)
            inst_e = spec.params.get("instance")
            if inst_e is not None:
                inf = compile_expression(inst_e, resolver)
            else:
                inf = lambda key, rows: 0  # noqa: E731
            return self._sharded(
                [self.node_of(main)],
                lambda sg, ins: eng.SortNode(
                    sg, ins[0],
                    lambda key, row: kf(key, (row,)),
                    lambda key, row: inf(key, (row,)),
                ),
                [lambda key, row: eng.freeze_value(inf(key, (row,)))],
            )

        if kind == "deduplicate":
            main = spec.inputs[0]
            resolver = Resolver([main])
            value_e = spec.params["value"]
            vf = compile_expression(value_e, resolver)
            inst_e = spec.params.get("instance")
            if inst_e is not None:
                instf = compile_expression(inst_e, resolver)
            else:
                instf = lambda key, rows: 0  # noqa: E731
            acceptor = spec.params["acceptor"]
            # token-resident gate: plain stably-typed value/instance
            # columns — instance groups + output keys compute in C, the
            # value column bulk-decodes, only the acceptor runs per row
            native_cfg = None
            names = main._column_names()
            from pathway_tpu_torch.internals import dtype as dt

            def _plain_col(e, dtypes) -> int | None:
                if (
                    isinstance(e, ex.ColumnReference)
                    and not isinstance(e, ex.IdReference)
                    and e.name in names
                    and main._dtype_of(e.name) in dtypes
                ):
                    return names.index(e.name)
                return None

            vcol = _plain_col(value_e, (dt.INT, dt.FLOAT, dt.BOOL, dt.STR))
            if vcol is not None:
                if inst_e is None:
                    inst_cols: list[int] | None = []
                else:
                    icol = _plain_col(
                        inst_e, (dt.INT, dt.FLOAT, dt.BOOL, dt.STR)
                    )
                    inst_cols = [icol] if icol is not None else None
                if inst_cols is not None:
                    native_cfg = {
                        "inst_cols": inst_cols,
                        "value_col": vcol,
                        "value_kind": (
                            "str" if main._dtype_of(value_e.name) is dt.STR
                            else "num"
                        ),
                    }
                    self._native_specs.add(spec.id)
            native_routes = None
            if native_cfg is not None and native_cfg["inst_cols"]:
                native_routes = [("group", native_cfg["inst_cols"])]
            return self._sharded(
                [self.node_of(main)],
                lambda sg, ins: eng.DeduplicateNode(
                    sg, ins[0],
                    lambda key, row: instf(key, (row,)),
                    lambda key, row: vf(key, (row,)),
                    acceptor,
                    native_cfg=native_cfg,
                ),
                [lambda key, row: eng.freeze_value(instf(key, (row,)))],
                native_routes=native_routes,
            )

        if kind in ("buffer", "forget", "freeze"):
            main = spec.inputs[0]
            resolver = Resolver([main])
            tf = compile_expression(spec.params["threshold"], resolver)
            cf = compile_expression(spec.params["current"], resolver)
            cls = {"buffer": eng.BufferNode, "forget": eng.ForgetNode, "freeze": eng.FreezeNode}[kind]
            # token-resident gate: vectorizable threshold/current
            # expressions evaluate per wave over bulk-decoded columns
            from pathway_tpu_torch.internals.expression_numpy import compile_numpy

            tp = compile_numpy(spec.params["threshold"], main._column_names())
            cp = compile_numpy(spec.params["current"], main._column_names())
            native_plans = (tp, cp) if tp is not None and cp is not None else None
            if native_plans is not None:
                self._native_specs.add(spec.id)
            # global watermark state: runs whole on process 0
            (inp,) = self._process_exchange([self.node_of(main)], None)
            return cls(
                g,
                inp,
                lambda key, row: tf(key, (row,)),
                lambda key, row: cf(key, (row,)),
                native_plans=native_plans,
            )

        if kind == "iterate_output":
            it_spec = spec.params["iterate"]
            name = spec.params["name"]
            it_node = self._get_iterate_node(it_spec)
            out_node = eng.InputNode(self.graph)
            it_node.set_output_node(name, out_node)
            if eng.iterate_native_on():
                # token-resident scope emissions arrive as NativeBatch
                self._native_specs.add(spec.id)
            return out_node

        if kind == "row_transformer":
            raise AssertionError("lowered via row_transformer_output")

        if kind == "row_transformer_output":
            parent = spec.params["parent"]
            name = spec.params["name"]
            tnode = self._get_transformer_node(parent)
            out_node = eng.InputNode(self.graph)
            tnode.set_output_node(name, out_node)
            return out_node

        if kind == "external_index":
            from pathway_tpu_torch.stdlib.indexing.lowering import build_external_index

            return build_external_index(self, table, spec)

        if kind == "gradual_broadcast":
            big, small = spec.inputs
            resolver = Resolver([small])
            lf = compile_expression(spec.params["lower"], resolver)
            vf = compile_expression(spec.params["value"], resolver)
            uf = compile_expression(spec.params["upper"], resolver)
            # hysteresis state is global: runs whole on process 0
            big_n, small_n = self._process_exchange(
                [self.node_of(big), self.node_of(small)], None
            )
            return eng.GradualBroadcastNode(
                g,
                big_n,
                small_n,
                lambda key, row: (lf(key, (row,)), vf(key, (row,)), uf(key, (row,))),
            )

        raise NotImplementedError(f"lowering for spec kind {kind!r}")

    # ------------------------------------------------------------- groupby

    def _build_groupby(self, table: Table, spec: OpSpec) -> eng.Node:
        from pathway_tpu_torch.internals.reducers import _EngineTimeMarker

        main = spec.inputs[0]
        gb_exprs: list = spec.params["gb_exprs"]
        out_exprs: dict[str, ex.ColumnExpression] = spec.params["out_exprs"]
        reducer_exprs: list[ex.ReducerExpression] = spec.params["reducer_exprs"]

        resolver = Resolver([main])
        gb_fns = [compile_expression(e, resolver) for e in gb_exprs]

        def gk_fn(key: Key, row: tuple) -> tuple:
            return tuple(f(key, (row,)) for f in gb_fns)

        reducers = []
        arg_fns = []
        for re_ in reducer_exprs:
            reducers.append(re_._reducer)
            per_arg: list[Callable] = []
            for a in re_._args:
                if isinstance(a, _EngineTimeMarker):
                    per_arg.append(lambda key, rows, time: time)
                else:
                    f = compile_expression(a, resolver)
                    per_arg.append(
                        (lambda f_: lambda key, rows, time: f_(key, rows))(f)
                    )
            arg_fns.append(
                (lambda fs: lambda key, row, time: tuple(
                    f(key, (row,), time) for f in fs
                ))(per_arg)
            )

        # The native semigroup kernel holds int64/double aggregates; only
        # hand it reducers whose argument dtypes are provably scalar
        # numeric (ndarray sums, durations, Json etc. keep the Python
        # recompute path, which supports them).
        from pathway_tpu_torch.internals import dtype as dt
        from pathway_tpu_torch.internals.expression import IdReference
        from pathway_tpu_torch.internals.type_interpreter import infer_dtype

        def _ref_dtype(ref) -> dt.DType:
            if isinstance(ref, IdReference) or ref.name == "id":
                return dt.ANY_POINTER
            return main._dtype_of(ref.name)

        def _scalar_numeric(re_) -> bool:
            for a in re_._args:
                if isinstance(a, _EngineTimeMarker):
                    continue
                try:
                    got = infer_dtype(a, _ref_dtype)
                except Exception:  # noqa: BLE001 - unresolvable -> not provable
                    return False
                # exact match only: Optional columns can hold None at
                # runtime, which the kernel has no clean story for
                if got not in (dt.INT, dt.FLOAT, dt.BOOL):
                    return False
            return True

        native_ok = all(
            getattr(re_._reducer, "n_args", 1) == 0 or _scalar_numeric(re_)
            for re_ in reducer_exprs
        )
        # Token-resident batch plan: applies when the group key is a plain
        # projection of stably-typed scalar columns and every reducer arg
        # is a column or a numpy-compilable numeric expression. Gated off
        # FLOAT/ANY group columns: token identity is byte-based, and a
        # float column may carry int-valued rows (literal-faithful JSON)
        # that Python dict equality would fold into one group. Pointer
        # columns ARE stable (tag-6 pieces, no cross-type folding) — the
        # graph workloads group by vertex pointers every round.
        native_plan = None
        if native_ok:
            names = main._column_names()
            gb_cols: list[int] | None = []
            for e in gb_exprs:
                if (
                    isinstance(e, ex.ColumnReference)
                    and not isinstance(e, ex.IdReference)
                    and e.name in names
                    and (
                        main._dtype_of(e.name) in (dt.INT, dt.STR, dt.BOOL)
                        or isinstance(main._dtype_of(e.name), dt.Pointer)
                    )
                ):
                    gb_cols.append(names.index(e.name))
                else:
                    gb_cols = None
                    break
            arg_plans: list | None = []
            if gb_cols is not None:
                from pathway_tpu_torch.internals.expression_numpy import compile_numpy

                for re_ in reducer_exprs:
                    if getattr(re_._reducer, "n_args", 1) == 0:
                        arg_plans.append(None)
                        continue
                    a = re_._args[0]
                    if (
                        isinstance(a, ex.ColumnReference)
                        and not isinstance(a, ex.IdReference)
                        and a.name in names
                    ):
                        arg_plans.append(("col", names.index(a.name)))
                        continue
                    plan = compile_numpy(a, names)
                    if plan is None:
                        arg_plans = None
                        break
                    arg_plans.append(("numpy", plan))
            if gb_cols is not None and arg_plans is not None:
                native_plan = {"gb_cols": gb_cols, "arg_plans": arg_plans}
        plan_for_node = native_plan
        gnode = self._sharded(
            [self.node_of(main)],
            lambda sg, ins: eng.GroupByNode(
                sg, ins[0], gk_fn, reducers, arg_fns, native_ok=native_ok,
                native_plan=plan_for_node,
            ),
            # exchange on the group key: every group's rows meet in one worker
            [lambda key, row: eng.freeze_value(gk_fn(key, row))],
            native_routes=[
                ("group", native_plan["gb_cols"]) if native_plan else None
            ],
        )
        # post-processing rowwise over (gvals..., rvals...)
        reducer_slots = {
            id(re_): len(gb_exprs) + i for i, re_ in enumerate(reducer_exprs)
        }
        gres = GroupResolver(gb_exprs, reducer_slots, main)
        fns = [compile_expression(e, gres) for e in out_exprs.values()]
        fn = self._guarded_row_fn(fns, getattr(spec, "trace", None))
        # pure slot picks over a plan-mode groupby (which emits
        # NativeBatch) splice in C: the reduce output — every hot loop's
        # per-round aggregate — stays token-resident into downstream
        # joins/maps instead of round-tripping through Python rows
        splice_specs: list | None = None
        if native_plan is not None:
            splice_specs = []
            for e in out_exprs.values():
                if isinstance(e, ex.ReducerExpression) and id(e) in reducer_slots:
                    splice_specs.append((0, reducer_slots[id(e)]))
                    continue
                if isinstance(e, ex.ColumnReference) and not isinstance(
                    e, ex.IdReference
                ):
                    slot = next(
                        (
                            i
                            for i, gexp in enumerate(gb_exprs)
                            if isinstance(gexp, ex.ColumnReference)
                            and gexp.name == e.name
                        ),
                        None,
                    )
                    if slot is not None:
                        splice_specs.append((0, slot))
                        continue
                splice_specs = None
                break
            if splice_specs is not None:
                self._native_specs.add(spec.id)
        return self._sharded(
            [gnode],
            lambda sg, ins: eng.RowwiseNode(
                sg, ins, fn, native_specs=splice_specs
            ),
            [_route_key],
        )

    # ---------------------------------------------------------------- join

    def _build_join(
        self, table: Table, spec: OpSpec, side_nodes: dict | None = None
    ) -> eng.Node:
        # ---- plan optimizer (internals/planner.py): sketch-costed
        # orientation + id elision. The orientation swap is multiset-
        # equivalent but permutes intra-wave emission order, so the mode
        # ladder is: "on" (PATHWAY_JOIN_REORDER=1) swaps on any sketch
        # win; "auto" (default) swaps only when the sketches disagree by
        # >= _REORDER_AUTO_RATIOx AND no order-sensitive sink
        # (subscribe/capture) observes this join — the verifier's
        # check_join_reorder re-proves both legs; "off" never swaps.
        # The advice and its sketches are always recorded in the report.
        ctx = self.plan_ctx
        use_cheap_ids = False
        if self.fuse and ctx is not None:
            inner = (
                spec.params["mode"] == "inner"
                and not spec.params.get("asof_now", False)
            )
            elidable = spec.id in ctx.cheap_id_joins and inner and (
                spec.params["id_mode"] == "hash"
            )
            if side_nodes is None:
                l_sk = ctx.static_sketch(spec.inputs[0])
                r_sk = ctx.static_sketch(spec.inputs[1])
                advise_swap = (
                    inner
                    and elidable
                    and l_sk["rows"] is not None
                    and r_sk["rows"] is not None
                    and l_sk["rows"] < r_sk["rows"]
                )
                mode_ = _planner.join_reorder_mode()
                applied = False
                if advise_swap and mode_ == "on":
                    _planner._swap_join_spec(spec)
                    applied = True
                elif (
                    advise_swap
                    and mode_ == "auto"
                    and l_sk["rows"] * _planner._REORDER_AUTO_RATIO
                    <= r_sk["rows"]
                    and spec.id not in ctx.order_sensitive
                ):
                    _planner._swap_join_spec(spec)
                    applied = True
                self.plan_report["join_orders"].append({
                    "join": spec.id,
                    "left": l_sk,
                    "right": r_sk,
                    "advice": "swap" if advise_swap else "keep",
                    "mode": mode_,
                    "applied": applied,
                    "trace": getattr(spec, "trace", None),
                })
            if elidable and self._elision_session_ok():
                use_cheap_ids = True
                self.plan_report["pushdowns"].append({
                    "kind": "join-id-elision",
                    "trace": getattr(spec, "trace", None),
                })
        left_t, right_t = spec.inputs
        on = spec.params["on"]
        mode = spec.params["mode"]
        id_mode = "cheap" if use_cheap_ids else spec.params["id_mode"]
        out_exprs: dict[str, ex.ColumnExpression] = spec.params["exprs"]

        lres = Resolver([left_t])
        rres = Resolver([right_t])
        lfns = [compile_expression(le, lres) for le, _ in on]
        rfns = [compile_expression(re_, rres) for _, re_ in on]

        def left_jk(key: Key, row: tuple) -> tuple:
            return tuple(f(key, (row,)) for f in lfns)

        def right_jk(key: Key, row: tuple) -> tuple:
            return tuple(f(key, (row,)) for f in rfns)

        left_width = len(left_t._column_names())
        right_width = len(right_t._column_names())
        asof_now = spec.params.get("asof_now", False)

        # Token-resident inner join (dataplane dj_* arrangements): applies
        # when both sides are native-plane and every join key is a plain
        # stably-typed scalar column (same identity gate as groupby).
        if side_nodes is not None and 0 in side_nodes:
            left_node = side_nodes[0]  # filter-through-join pushdown
        else:
            left_node = self.node_of(left_t)
        if side_nodes is not None and 1 in side_nodes:
            right_node = side_nodes[1]
        else:
            right_node = self.node_of(right_t)
        native_plan = None
        if (
            mode == "inner"
            and not asof_now
            and id_mode in ("hash", "left", "right", "cheap")
            and left_t._spec.id in self._native_specs
            and right_t._spec.id in self._native_specs
        ):
            def _plain_cols(exprs_side, table):
                names = table._column_names()
                cols = []
                for e in exprs_side:
                    if (
                        isinstance(e, ex.ColumnReference)
                        and not isinstance(e, ex.IdReference)
                        and e.name in names
                        and (
                            table._dtype_of(e.name) in (dt.INT, dt.STR, dt.BOOL)
                            # Pointer join keys (graph edges x vertex state
                            # every iterate round) are byte-stable tag-6
                            # pieces — no cross-type folding to preserve
                            or isinstance(table._dtype_of(e.name), dt.Pointer)
                        )
                    ):
                        cols.append(names.index(e.name))
                    else:
                        return None
                return cols

            from pathway_tpu_torch.internals import dtype as dt

            l_cols = _plain_cols([le for le, _ in on], left_t)
            r_cols = _plain_cols([re_ for _, re_ in on], right_t)
            # per-pair dtype match: token identity is byte-based, so a
            # BOOL key must not be asked to join an INT key (the object
            # plane's dict equality would fold True == 1)
            if l_cols is not None and r_cols is not None and all(
                left_t._dtype_of(le.name) == right_t._dtype_of(re_.name)
                for le, re_ in on
            ):
                native_plan = {"l_cols": l_cols, "r_cols": r_cols}
        jres = JoinResolver(left_t, right_t)
        # pure-column output picks on a native join fuse into the join's
        # C row emission (projection pushdown): the JoinNode emits the
        # selected pieces directly and no post-join row build runs at all
        emit_cols: list[int] | None = None
        if native_plan is not None:
            emit_cols = []
            for e in out_exprs.values():
                try:
                    from pathway_tpu_torch.internals.joins import _JoinIdRef

                    if isinstance(e, _JoinIdRef):
                        emit_cols = None
                        break
                    if isinstance(e, ex.ColumnReference):
                        _inp, idx = jres.resolve(e)
                        if idx is None:
                            emit_cols = None
                            break
                        emit_cols.append(idx)
                        continue
                except Exception:  # noqa: BLE001
                    emit_cols = None
                    break
                emit_cols = None
                break
        def make_join(sg, ins):
            node = eng.JoinNode(
                sg, ins[0], ins[1], left_jk, right_jk,
                mode=mode, id_mode=id_mode,
                left_width=left_width, right_width=right_width,
                asof_now=asof_now,
                native_plan=native_plan,
                emit_cols=emit_cols,
            )
            # the spec whose elision proof covers this node — node_of may
            # cache it under a DIFFERENT spec (filter-through-join builds
            # the join under the filter's id); the plan verifier re-checks
            # cheap ids against the join spec itself
            node._join_spec_id = spec.id
            return node

        jnode = self._sharded(
            [left_node, right_node],
            make_join,
            # exchange both sides on the join key (reference: Shard impls on
            # join arrangements, src/engine/dataflow/shard.rs)
            [
                lambda key, row: eng.freeze_value(left_jk(key, row)),
                lambda key, row: eng.freeze_value(right_jk(key, row)),
            ],
            native_routes=(
                [("group", native_plan["l_cols"]), ("group", native_plan["r_cols"])]
                if native_plan
                else None
            ),
        )
        if emit_cols is not None:
            self._native_specs.add(spec.id)
            return jnode
        fns = [compile_expression(e, jres) for e in out_exprs.values()]
        fn = self._guarded_row_fn(fns, getattr(spec, "trace", None))
        return self._sharded(
            [jnode], lambda sg, ins: eng.RowwiseNode(sg, ins, fn), [_route_key]
        )

    # ----------------------------------------------------- row transformer

    def _get_transformer_node(self, spec: OpSpec):
        if not hasattr(self, "_transformer_nodes"):
            self._transformer_nodes: dict[int, Any] = {}
        if spec.id in self._transformer_nodes:
            return self._transformer_nodes[spec.id]
        from pathway_tpu_torch.engine.transformer import RowTransformerNode

        tf = spec.params["transformer"]
        table_names = spec.params["table_names"]
        # cross-row/table access is global: runs whole on process 0
        input_nodes = self._process_exchange(
            [self.node_of(t) for t in spec.inputs], None
        )
        node = RowTransformerNode(self.graph, input_nodes, dict(tf.classes))
        for name, table in zip(table_names, spec.inputs):
            node.set_columns(name, table._column_names())
        node.trace = getattr(spec, "trace", None)
        self._transformer_nodes[spec.id] = node
        return node

    # ------------------------------------------------------------- iterate

    def _get_iterate_node(self, it_spec: Any) -> IterateNode:
        if id(it_spec) in self.iterate_nodes:
            return self.iterate_nodes[id(it_spec)]
        # the loop body is one global scope: runs whole on process 0
        input_nodes = self._process_exchange(
            [self.node_of(t) for t in it_spec.inputs.values()], None
        )
        input_names = list(it_spec.inputs.keys())

        # ONE persistent body graph: its stateful operators keep their
        # arrangements across outer timestamps and iteration rounds, so
        # every round is delta-driven (see IterateNode).
        sub = Session()
        # the body runs WHOLE on process 0 (its inputs are pinned there);
        # inheriting the mesh would plant exchange barriers inside the
        # loop that the other processes never step — deadlock
        sub.mesh = None
        # body chains fuse too (the scope's captures translate by key,
        # so id elision self-vetoes via observes_ids=True)
        sub.attach_plan_roots(
            list(it_spec.results.values()),
            sink_meta=[(t, True) for t in it_spec.results.values()],
        )
        captures: dict[str, eng.CaptureNode] = {}
        for name, t in it_spec.results.items():
            captures[name] = eng.CaptureNode(
                sub.graph, sub.node_of(t),
                token_resident=eng.iterate_native_on(),
            )
        if sub.connectors:
            raise NotImplementedError(
                "pw.iterate bodies cannot reference streaming connector "
                "tables; materialize the stream outside the loop and pass "
                "it as an iterate input"
            )
        # placeholders never lowered (unreachable from the results) still
        # need a node for the outer deltas to land in
        for name in input_names:
            if name not in sub.placeholder_nodes:
                sub.placeholder_nodes[name] = eng.InputNode(sub.graph)

        node = IterateNode(
            self.graph,
            input_nodes,
            input_names,
            it_spec.iterated_names,
            list(it_spec.results.keys()),
            sub.graph,
            sub.placeholder_nodes,
            captures,
            sub.static_batches,
            it_spec.iteration_limit,
        )
        self.iterate_nodes[id(it_spec)] = node
        return node

    # ------------------------------------------------------------- execute

    def capture(self, table: Table) -> eng.CaptureNode:
        node = eng.CaptureNode(self.graph, self.node_of(table))
        node.label = "capture"
        return node

    def subscribe(
        self,
        table: Table,
        on_change: Callable | None = None,
        on_time_end: Callable | None = None,
        on_end: Callable | None = None,
    ) -> None:
        from pathway_tpu_torch.engine.core import SubscribeNode

        node = SubscribeNode(
            self.graph, self.node_of(table), on_change, on_time_end, on_end
        )
        node.label = "subscribe"

    def output(
        self, table: Table, write_batch: Callable, flush=None, close=None,
        write_native: Callable | None = None,
        write_keyed: Callable | None = None,
        txn: dict | None = None,
    ) -> None:
        node = OutputNode(
            self.graph, self.node_of(table), write_batch, flush, close,
            write_native=write_native, write_keyed=write_keyed, txn=txn,
        )
        node.label = "output"

    def execute(self) -> None:
        # finalize + publish the plan report (plan visibility: bench,
        # /statistics and the profiler JSON read it off the graph)
        rep = self.plan_report
        rep["nodes_after"] = len(self.graph.nodes)
        rep["nodes_before"] = rep["nodes_after"] + sum(
            g["nodes_saved"] for g in rep["fusion_groups"]
        )
        if self.plan_ctx is not None:
            rep["elision"]["sources"] = len(self.plan_ctx.cheap_key_sources)
            rep["elision"]["joins"] = len(self.plan_ctx.cheap_id_joins)
        # morsel gates (engine/morsel.py): snapshot PATHWAY_MORSEL /
        # PATHWAY_MORSEL_ROWS into the hot-path caches at this seam —
        # the steal scheduler and cone splitting never read the
        # environment per wave, and an env flip mid-process applies
        # from the next session build
        from pathway_tpu_torch.engine import morsel as _morsel

        _morsel.refresh()
        # wave cones (engine/cone.py): installed BEFORE the verifier so
        # check_cone_contract re-proves every cone ahead of any compile.
        # PATHWAY_MEGAKERNEL=0 skips installation — the per-node fused
        # plan runs byte-identically. Mesh sessions never install: the
        # mesh pump owns cross-process wave pacing.
        if _planner.megakernel_enabled() and self.mesh is None:
            from pathway_tpu_torch.engine.cone import install_cones

            install_cones(self)
        else:
            rep["megakernel"] = {
                "enabled": False, "cones": [], "dissolved": None,
            }
        # plan verifier (internals/verifier.py): re-derive every
        # optimizer-assumed invariant over the built plan BEFORE the
        # runtime exists — a violated plan raises here instead of
        # corrupting data mid-run. PATHWAY_VERIFY=0 skips, =strict
        # escalates warnings; the verdict rides the published report.
        from pathway_tpu_torch.internals import observability as _obs
        from pathway_tpu_torch.internals import verifier as _verifier

        if _verifier.refresh_enabled():
            import time as _time_mod

            _v_t0 = _time_mod.perf_counter()
            try:
                rep["verify"] = _verifier.verify_session(self)
            except _verifier.PlanVerificationError as e:
                rep["verify"] = e.verdict
                _planner.publish_report(rep)
                raise
            finally:
                # the verifier is part of the build: attribute its wall
                # to its own profiler stage instead of "unattributed"
                if _obs.PLANE is not None:
                    _obs.PLANE.stage_seconds(
                        "verify", _time_mod.perf_counter() - _v_t0
                    )
        else:
            rep["verify"] = {"mode": "off"}
        _planner.publish_report(rep)
        runtime = Runtime(self.graph, autocommit_ms=self.autocommit_ms)
        runtime.monitors = list(self.monitors)
        runtime.checkpointer = getattr(self, "checkpointer", None)
        runtime.stop_event = self.stop_event
        runtime.mesh = self.mesh
        runtime.session_seq = self._session_seq
        if self.mesh is not None:
            import os as _os

            for c in self.connectors:
                runtime.add_connector(c)
            if _os.environ.get("PATHWAY_MESH_BSP") == "1":
                # deprecated lockstep fallback: every process steps every
                # wave together (kept as the measured straggler baseline)
                runtime.run_lockstep(self.static_batches)
            else:
                # frontier-based progress tracking: each process pumps at
                # its own pace; exchange wires carry (time, batch) +
                # watermarks (engine/frontier.py)
                runtime.run_mesh(self.static_batches)
            return
        if not self.connectors:
            runtime.run_static(self.static_batches)
            return
        # streaming: static data goes in at the first tick
        for t, node, entries in self.static_batches:
            node.push(entries)
        for c in self.connectors:
            runtime.add_connector(c)
        if self.static_batches:
            runtime.graph.step(runtime.next_time())
        runtime.run()


class _SubstitutingResolver(Resolver):
    def __init__(self, tables: list, substitutions: dict[int, _SlotRef]):
        super().__init__(tables)
        self.substitutions = substitutions


def _collect_async(exprs: list) -> list[ex.AsyncApplyExpression]:
    out: list[ex.AsyncApplyExpression] = []
    seen: set[int] = set()

    def rec(e: ex.ColumnExpression) -> None:
        if id(e) in seen:
            return
        seen.add(id(e))
        if isinstance(e, ex.AsyncApplyExpression):
            out.append(e)
            return
        for s in e._sub_expressions():
            rec(s)

    for e in exprs:
        rec(e)
    return out


def _clone_replace(
    e: ex.ColumnExpression, mapping: dict[int, ex.ColumnExpression]
) -> ex.ColumnExpression:
    """Copy an expression tree, replacing the nodes in `mapping` (by
    identity) with their targets. Unlike `_substitute` this never
    mutates the original — the filter-through-join pushdown rewrites a
    condition against the join output into one against a join input
    while the original spec stays intact."""
    import copy

    if id(e) in mapping:
        return mapping[id(e)]
    c = copy.copy(e)
    for name, val in list(vars(c).items()):
        if isinstance(val, ex.ColumnExpression):
            setattr(c, name, _clone_replace(val, mapping))
        elif isinstance(val, tuple) and any(
            isinstance(v, ex.ColumnExpression) for v in val
        ):
            setattr(
                c,
                name,
                tuple(
                    _clone_replace(v, mapping)
                    if isinstance(v, ex.ColumnExpression)
                    else v
                    for v in val
                ),
            )
        elif isinstance(val, dict) and any(
            isinstance(v, ex.ColumnExpression) for v in val.values()
        ):
            setattr(
                c,
                name,
                {
                    k: _clone_replace(v, mapping)
                    if isinstance(v, ex.ColumnExpression)
                    else v
                    for k, v in val.items()
                },
            )
    return c


def _substitute(
    e: ex.ColumnExpression, subs: dict[int, _SlotRef]
) -> ex.ColumnExpression:
    if id(e) in subs:
        return subs[id(e)]
    for name, val in list(vars(e).items()):
        if isinstance(val, ex.ColumnExpression):
            setattr(e, name, _substitute(val, subs))
        elif isinstance(val, tuple) and any(isinstance(v, ex.ColumnExpression) for v in val):
            setattr(
                e,
                name,
                tuple(
                    _substitute(v, subs) if isinstance(v, ex.ColumnExpression) else v
                    for v in val
                ),
            )
        elif isinstance(val, dict) and any(
            isinstance(v, ex.ColumnExpression) for v in val.values()
        ):
            setattr(
                e,
                name,
                {
                    k: _substitute(v, subs) if isinstance(v, ex.ColumnExpression) else v
                    for k, v in val.items()
                },
            )
    return e
