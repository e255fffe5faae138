"""Plan verifier: re-derives, independently of the optimizer, every
invariant the plan transforms assume — at build time, between lowering
and engine construction.

The optimizer stack rests on hand-argued soundness proofs: fusion's
single-consumer gates, id-elision's observability vetoes, the donated
exchange buffers' single-round aliasing rule, token-resident iterate
scopes, the exactly-once outbox contract, and the fused native
programs' virtual schema (docs/planner.md, docs/static-analysis.md).
Each proof lives in the pass that uses it — so a bug there corrupts
data silently at runtime. This module is the second opinion: after
lowering builds the engine graph, ``verify_session`` re-walks the spec
DAG and the built nodes with its own transfer rules and raises a
structured :class:`PlanVerificationError` (node labels via
``Node.describe()``) on any disagreement, instead of letting a broken
plan run.

Gate: ``PATHWAY_VERIFY`` — ``0`` skips the verifier, ``strict``
escalates warnings to errors, anything else (the default) verifies.
The verdict lands in the plan report under ``planner.last_report()``
(key ``"verify"``) either way.

Checks (each independent of the code it audits; see the matching
``check_*`` function):

* ``fusion-single-consumer`` — every interior spec of a fused chain has
  exactly one consumer over the reachable spec DAG and is not itself a
  sink root.
* ``id-elision`` — a fresh forward re-derivation of key-origin flow:
  every cheap-keyed scan and cheap-id join is re-proven unobservable
  (no id-referencing expression, no key-observing sink per
  ``observes_ids``, no off-whitelist operator, session single-worker /
  mesh-free / persistence-free).
* ``iterate-scope`` — token-resident iterate scopes: captures all
  token-resident with the demotion ladder wired, no side-effecting node
  in the body; object-plane-only body members are warnings (demotion
  keeps them correct but breaks the zero-round-trip contract).
* ``exactly-once-outbox`` — with persistence attached and
  ``PATHWAY_EXACTLY_ONCE`` on, every streaming sink writes through the
  outbox; an armed outbox without the contract is equally an error.
* ``native-program-schema`` — the fused ``_NativeProgramBuilder``
  programs type-check structurally: every stage's column references
  resolve inside the virtual schema of the stage boundary they cross.
* ``exchange-donation`` — the respill layout planner is re-probed over
  a shape grid: a donated wave must be single-round with the
  byte-matching ``n_shards * (cap + 1)`` layout (aliasing on a
  multi-round wave would corrupt round 2+). The same rule guards the
  live decision via :func:`check_donation`.
* ``cone-contract`` — every installed wave cone (engine/cone.py) is
  re-proved before any compile: single-consumer interior (each member
  feeds ONLY the next member — a second consumer would observe the
  merged emission the cone elides), donation only on single-round
  layouts, byte-matching staging-buffer schema (4 u64 lanes per row;
  the interior program re-passes the native-program schema check), and
  absorbed-flag consistency with ``Graph.step``'s skip rule.
* ``morsel-contract`` — morsel-parallel wave execution
  (engine/morsel.py): a dynamic probe of the steal scheduler's claim
  protocol (exactly-once, per-queue order, single-consumer latch),
  every sharded replica wired only to its private collector, and no
  donation across stolen morsels (single-round cones only).
* ``join-reorder`` — every "auto"-mode join swap the planner applied is
  re-proved: sketches disagree by the promised ratio and no
  order-sensitive sink reaches the join (independent upstream closure).
* ``spill-contract`` — every out-of-core arrangement (engine/spill.py):
  positive resident budget, manifest covers the sealed runs exactly
  (count + record-total redundancy catches a run dropped from the
  listing), and the exclusive-residency invariant behind the probe
  ladder (a key live in two tiers would let tail-first-then-newest-run
  serve stale state). Restore re-runs the manifest checks on every
  spill manifest embedded in a checkpoint BEFORE any node mutates.
* ``index-tier-contract`` — every tiered ANN index
  (pathway_tpu_torch/indexing/tiers.py): each live doc's PQ codes sit in
  EXACTLY one tier (a cold list with live rows still in the RAM cube,
  or a cold list with no live run record, breaks the probe ladder's
  exclusive-residency assumption), the tier store's manifest passes the
  spill manifest checks, and the resident/cold split agrees with the
  store's two-tier rule. Promotion must preserve no-lost-inserts: an
  append into a cold list promotes it first, which this check observes
  as the one-tier invariant holding after the fact.
"""

from __future__ import annotations

import os
from typing import Any

__all__ = [
    "PlanVerificationError",
    "mode",
    "enabled",
    "verify_session",
    "check_donation",
    "check_swap_contract",
]


def mode() -> str:
    """PATHWAY_VERIFY: "off" (=0), "strict", or the default "on"."""
    v = os.environ.get("PATHWAY_VERIFY", "1")
    if v == "0":
        return "off"
    if v == "strict":
        return "strict"
    return "on"


def enabled() -> bool:
    return mode() != "off"


# Hot-path mirror of enabled(): the live donation guard in
# parallel/exchange.py consults this per WAVE, where an env read is the
# PR 9(h) bug class. Refreshed from the environment at every session's
# execute seam (refresh_enabled, lowering-time), so an in-process
# PATHWAY_VERIFY flip applies uniformly from the next session build —
# never mid-run, and never half (build gate on, wave guard stale off).
_ENABLED_CACHE: bool | None = None


def enabled_cached() -> bool:
    global _ENABLED_CACHE
    if _ENABLED_CACHE is None:
        _ENABLED_CACHE = enabled()
    return _ENABLED_CACHE


def refresh_enabled() -> bool:
    """Re-read PATHWAY_VERIFY and refresh the hot-path cache; the
    build-time gate in Session.execute calls this instead of enabled()."""
    global _ENABLED_CACHE
    _ENABLED_CACHE = enabled()
    return _ENABLED_CACHE


class PlanVerificationError(RuntimeError):
    """A plan invariant failed re-derivation. ``findings`` carries the
    per-check messages; ``verdict`` the full report dict."""

    def __init__(self, findings: list[str], verdict: dict | None = None):
        super().__init__(
            "plan verification failed:\n  " + "\n  ".join(findings)
        )
        self.findings = findings
        self.verdict = verdict or {}


class _Verdict:
    def __init__(self, md: str):
        self.report: dict = {"mode": md, "checks": {}, "violations": [],
                             "warnings": []}
        self._strict = md == "strict"

    def start(self, check: str) -> None:
        self.report["checks"][check] = {"status": "ok"}

    def skip(self, check: str, why: str) -> None:
        self.report["checks"][check] = {"status": "skipped", "why": why}

    def violation(self, check: str, message: str) -> None:
        entry = self.report["checks"].setdefault(check, {"status": "ok"})
        entry["status"] = "violation"
        self.report["violations"].append(f"[{check}] {message}")

    def warning(self, check: str, message: str) -> None:
        if self._strict:
            self.violation(check, message + " (escalated by strict mode)")
            return
        entry = self.report["checks"].setdefault(check, {"status": "ok"})
        if entry["status"] == "ok":
            entry["status"] = "warning"
        self.report["warnings"].append(f"[{check}] {message}")

    def internal(self, check: str, exc: BaseException) -> None:
        # the verifier must never be the thing that breaks a valid plan:
        # its own failures surface as warnings (strict escalates)
        self.warning(
            check, f"verifier internal error: {type(exc).__name__}: {exc}"
        )


# ----------------------------------------------------- spec DAG walking
#
# The EDGE DEFINITION (what a spec consumes: inputs plus every table its
# params reach) is shared with the planner on purpose — two copies of
# that enumeration would silently drift, and a divergence would fail
# valid plans with PATHWAY_VERIFY on by default. What stays this
# module's own is everything the edges feed: the consumer counting, the
# key-origin transfer rules, and the id-reference walk — the logic the
# verifier exists to double-check.


def _param_exprs(spec) -> list:
    from pathway_tpu_torch.internals.planner import _spec_exprs

    return _spec_exprs(spec)


def _input_tables(spec) -> list:
    from pathway_tpu_torch.internals.planner import _spec_input_tables

    return _spec_input_tables(spec)


class _Walk:
    """One reachable-DAG traversal: postorder spec ids, sid -> spec,
    this module's own consumer counts (each input occurrence counts;
    sinks count their root), and the per-spec input tables / param
    expressions resolved ONCE — the flow analyses below reuse them
    instead of re-resolving expressions per pass."""

    __slots__ = ("order", "specs", "consumers", "in_tables", "exprs_of")

    def __init__(self, roots: list):
        self.specs: dict[int, Any] = {}
        self.consumers: dict[int, int] = {}
        self.order: list[int] = []
        self.in_tables: dict[int, list] = {}
        self.exprs_of: dict[int, list] = {}
        stack = [(t, False) for t in roots]
        while stack:
            table, expanded = stack.pop()
            spec = table._spec
            if expanded:
                if spec.id not in self.specs:
                    self.specs[spec.id] = spec
                    self.order.append(spec.id)
                continue
            if spec.id in self.specs:
                continue
            stack.append((table, True))
            exprs = _param_exprs(spec)
            tabs = _input_tables(spec)
            self.exprs_of[spec.id] = exprs
            self.in_tables[spec.id] = tabs
            for t_in in tabs:
                self.consumers[t_in._spec.id] = (
                    self.consumers.get(t_in._spec.id, 0) + 1
                )
                stack.append((t_in, False))
        for t in roots:
            self.consumers[t._spec.id] = (
                self.consumers.get(t._spec.id, 0) + 1
            )


def _has_id_reference(exprs: list) -> bool:
    from pathway_tpu_torch.internals import expression as ex

    seen: set[int] = set()
    stack = [e for e in exprs if isinstance(e, ex.ColumnExpression)]
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        if isinstance(e, ex.IdReference):
            return True
        stack.extend(
            s for s in e._sub_expressions()
            if isinstance(s, ex.ColumnExpression)
        )
    return False


# ------------------------------------------------ check: fusion groups


def _shared_walk(session, shared: dict):
    """One reachable-DAG walk per verify_session, shared by the checks
    that need it (the verifier runs on every build — don't pay the
    param-expression resolution twice)."""
    if "walk" not in shared:
        roots = getattr(session, "_plan_roots", None) or []
        shared["walk"] = _Walk(roots) if roots else None
    return shared["walk"]


def check_fusion_single_consumer(session, v: _Verdict, shared: dict) -> None:
    from pathway_tpu_torch.engine.core import FusedRowwiseNode

    check = "fusion-single-consumer"
    v.start(check)
    roots = getattr(session, "_plan_roots", None) or []
    fused = [
        n for n in session.graph.nodes
        if isinstance(n, FusedRowwiseNode)
        and getattr(n, "_fused_spec_ids", None)
    ]
    if not fused:
        return
    if not roots:
        v.warning(check, "fused nodes present but no plan roots recorded")
        return
    walk = _shared_walk(session, shared)
    specs, consumers = walk.specs, walk.consumers
    root_ids = {t._spec.id for t in roots}
    groups = 0
    for node in fused:
        ids = node._fused_spec_ids
        interior = ids if node.rekey is not None else ids[:-1]
        groups += 1
        for sid in interior:
            if sid not in specs:
                v.violation(
                    check,
                    f"{node.describe()}: fused interior spec {sid} is not "
                    "reachable from the plan roots",
                )
                continue
            n_cons = consumers.get(sid, 0)
            if n_cons != 1:
                v.violation(
                    check,
                    f"{node.describe()}: interior stage spec {sid} "
                    f"({specs[sid].kind}) has {n_cons} consumers over the "
                    "reachable spec DAG — fusing it away drops the other "
                    "consumer(s)",
                )
            if sid in root_ids:
                v.violation(
                    check,
                    f"{node.describe()}: interior stage spec {sid} is "
                    "itself a sink root — its output must stay "
                    "materialized",
                )
    v.report["checks"][check]["groups"] = groups


# --------------------------------------------------- check: id elision

_ELISION_KINDS = frozenset({
    "static", "static_native", "connector", "rowwise", "filter",
    "groupby", "join", "concat", "flatten", "reindex",
    "update_rows", "update_cells", "setop", "with_universe_of", "having",
    "buffer", "forget", "freeze",
})
_KEY_MATCHING = frozenset({
    "update_rows", "update_cells", "setop", "with_universe_of", "having",
})
_PASSTHROUGH = frozenset({"rowwise", "filter", "buffer", "forget", "freeze"})
_REKEYED = frozenset({"groupby", "reindex"})


def _derive_safe_markers(
    walk: "_Walk", sink_meta: list
) -> tuple[set, set, str | None]:
    """The verifier's own key-origin flow: per spec the set of elidable
    origins its output keys derive from, and the set of origins whose
    key *values* anything can surface. Returns (safe source sids, safe
    join sids, whitelist-veto reason). Transfer rules written fresh from
    the soundness argument in docs/planner.md."""
    order, specs = walk.order, walk.specs
    for sid in order:
        if specs[sid].kind not in _ELISION_KINDS:
            return set(), set(), (
                f"operator kind {specs[sid].kind!r} outside the elision "
                "whitelist"
            )
    origin: dict[int, frozenset] = {}
    observed: set = set()
    for sid in order:
        spec = specs[sid]
        kind = spec.kind
        ins = [
            origin.get(t._spec.id, frozenset())
            for t in walk.in_tables[sid]
        ]
        if _has_id_reference(walk.exprs_of[sid]):
            for d in ins:
                observed.update(d)
        if kind == "static_native":
            origin[sid] = frozenset({("src", sid)})
        elif kind == "connector":
            origin[sid] = (
                frozenset({("src", sid)})
                if spec.params.get("native_plane")
                and not spec.params.get("upsert")
                else frozenset()
            )
        elif kind in _PASSTHROUGH:
            origin[sid] = ins[0] if ins else frozenset()
        elif kind in _REKEYED:
            origin[sid] = frozenset()
        elif kind == "join":
            l_o = origin.get(spec.inputs[0]._spec.id, frozenset())
            r_o = origin.get(spec.inputs[1]._spec.id, frozenset())
            id_mode = spec.params.get("id_mode", "hash")
            if id_mode == "left":
                origin[sid] = l_o
            elif id_mode == "right":
                origin[sid] = r_o
            else:
                origin[sid] = l_o | r_o | frozenset({("join", sid)})
        elif kind in ("concat", "flatten"):
            origin[sid] = frozenset().union(*ins) if ins else frozenset()
        elif kind in _KEY_MATCHING:
            base = ins[0] if ins else frozenset()
            if not all(d == base for d in ins):
                # matching keys across differently-derived inputs pins
                # the key VALUES across schemes — that observes them
                for d in ins:
                    observed.update(d)
            origin[sid] = frozenset().union(*ins) if ins else frozenset()
        else:  # "static" and anything keyless
            origin[sid] = frozenset()
    for table, observes_ids in sink_meta:
        if observes_ids:
            observed.update(origin.get(table._spec.id, frozenset()))
    safe_sources = {
        sid for sid in order
        if ("src", sid) in origin.get(sid, frozenset())
        and ("src", sid) not in observed
    }
    safe_joins = {
        sid for sid in order
        if specs[sid].kind == "join"
        and specs[sid].params.get("id_mode", "hash") == "hash"
        and ("join", sid) not in observed
    }
    return safe_sources, safe_joins, None


def check_id_elision(session, v: _Verdict, shared: dict) -> None:
    from pathway_tpu_torch.engine.core import JoinNode

    check = "id-elision"
    v.start(check)
    # the engine-state claims: scans keyed cheap this session, joins
    # built with cheap pair-mix ids
    claimed_sources: list[int] = []
    claimed_joins: list[tuple[int | None, Any]] = []
    # claims come from the GRAPH, not the spec cache: on the object
    # plane a join's cached node is its select tail, and pushdown may
    # cache a join under the consuming filter's id — the elision proof
    # is keyed by the JOIN spec, which lowering stamps on the node
    for node in session.graph.nodes:
        if isinstance(node, JoinNode) and node.id_mode == "cheap":
            claimed_joins.append(
                (getattr(node, "_join_spec_id", None), node)
            )
    roots = getattr(session, "_plan_roots", None) or []
    sink_meta = getattr(session, "_sink_meta", None) or []
    walk = _shared_walk(session, shared)
    order: list[int] = walk.order if walk is not None else []
    specs: dict[int, Any] = walk.specs if walk is not None else {}
    if roots:
        for sid in order:
            tuning = specs[sid].params.get("scan_tuning")
            if (
                isinstance(tuning, dict)
                and tuning.get("session") == session._session_seq
                and tuning.get("key_mode") == 1
            ):
                claimed_sources.append(sid)
    if not claimed_sources and not claimed_joins:
        return
    if not roots:
        v.violation(
            check,
            "cheap-keyed nodes exist but no plan roots were recorded — "
            "the elision claims cannot be re-derived",
        )
        return

    def name_of(sid: int) -> str:
        node = session.cache.get(sid)
        if node is not None:
            return node.describe()
        sp = specs.get(sid)
        return f"spec#{sid}({sp.kind if sp is not None else '?'})"

    # session-level preconditions (cheap keys reshard under exchanges
    # and must never mix into persisted snapshots)
    for why, bad in (
        ("a multi-worker session", session.n_workers > 1),
        ("a process-mesh session", session.mesh is not None),
        ("an attached persistence config",
         getattr(session, "_persistent", False)
         or getattr(session, "checkpointer", None) is not None),
    ):
        if bad:
            v.violation(
                check,
                f"id elision is active under {why}: "
                + ", ".join(
                    [name_of(s) for s in claimed_sources]
                    + [n.describe() for _sid, n in claimed_joins]
                ),
            )
    safe_sources, safe_joins, veto = _derive_safe_markers(
        walk, sink_meta
    )
    if veto is not None and (claimed_sources or claimed_joins):
        v.violation(
            check,
            f"elided ids coexist with {veto} — the whitelist proof does "
            "not cover this plan",
        )
        return
    for sid in claimed_sources:
        if sid not in safe_sources:
            v.violation(
                check,
                f"{name_of(sid)}: scan keys elided (cheap sequential) but "
                "re-derivation finds the row ids OBSERVABLE — an "
                "id-referencing expression or key-observing sink "
                "(observes_ids) reaches them",
            )
    for sid, node in claimed_joins:
        if sid is None:
            v.violation(
                check,
                f"{node.describe()}: join ids elided (cheap pair mix) "
                "but the node carries no join-spec id — the claim "
                "cannot be re-derived",
            )
        elif sid not in safe_joins:
            v.violation(
                check,
                f"{node.describe()}: join ids elided (cheap pair mix) but "
                "re-derivation finds the output ids OBSERVABLE",
            )
    v.report["checks"][check]["sources"] = len(claimed_sources)
    v.report["checks"][check]["joins"] = len(claimed_joins)


# ----------------------------------------------- check: iterate scopes

# engine nodes that never ride the token plane: inside a token-resident
# scope they force per-round materialize round-trips (the demotion
# ladder keeps them CORRECT, so their presence is a warning — the
# zero-round-trip contract of docs/iterate.md is what breaks)
_OBJECT_ONLY_NODES = (
    "SortNode", "IxNode", "GradualBroadcastNode", "ExternalIndexNode",
    "RowTransformerNode", "AsyncApplyNode",
)
# side effects inside a fixpoint body would fire once per ROUND, not
# once per wave — never legal
_SIDE_EFFECT_NODES = ("OutputNode", "SubscribeNode")


def check_iterate_scopes(session, v: _Verdict, shared: dict) -> None:
    from pathway_tpu_torch.engine.runtime import IterateNode

    check = "iterate-scope"
    v.start(check)
    scopes = 0

    def scan_graph(graph) -> None:
        nonlocal scopes
        for node in graph.nodes:
            if not isinstance(node, IterateNode):
                continue
            scopes += 1
            body_kinds = {type(n).__name__ for n in node.sub_graph.nodes}
            for bad in _SIDE_EFFECT_NODES:
                if bad in body_kinds:
                    v.violation(
                        check,
                        f"{node.describe()}: iterate body contains a "
                        f"{bad} — a sink inside a fixpoint scope fires "
                        "per round, not per wave",
                    )
            for name in node.iterated_names:
                if name not in node.placeholder_nodes:
                    v.violation(
                        check,
                        f"{node.describe()}: iterated input {name!r} has "
                        "no placeholder node in the body graph",
                    )
            if node._tok:
                for name, cap in node.captures.items():
                    if not cap._tok:
                        v.violation(
                            check,
                            f"{node.describe()}: token-resident scope "
                            f"with OBJECT-plane capture {name!r} "
                            f"({cap.describe()}) — mixed-plane feedback "
                            "desynchronizes the rounds",
                        )
                    elif cap.on_demote is None:
                        v.violation(
                            check,
                            f"{node.describe()}: capture {name!r} "
                            f"({cap.describe()}) is token-resident but "
                            "its demotion ladder (on_demote) is unwired "
                            "— a plane-unrepresentable row would lose "
                            "the scope's read positions",
                        )
                for bad in _OBJECT_ONLY_NODES:
                    if bad in body_kinds:
                        v.warning(
                            check,
                            f"{node.describe()}: token-resident scope "
                            f"contains object-plane-only {bad} — every "
                            "round pays a materialize round-trip "
                            "(docs/iterate.md zero-round-trip contract)",
                        )
            scan_graph(node.sub_graph)  # nested iterate scopes

    scan_graph(session.graph)
    v.report["checks"][check]["scopes"] = scopes


# ------------------------------------------ check: exactly-once outbox


def check_exactly_once_outbox(session, v: _Verdict, shared: dict) -> None:
    from pathway_tpu_torch.engine.runtime import OutputNode
    from pathway_tpu_torch.io.outbox import exactly_once_enabled

    check = "exactly-once-outbox"
    v.start(check)
    out_nodes = [
        n for n in session.graph.nodes if isinstance(n, OutputNode)
    ]
    if not out_nodes:
        return
    persistent = getattr(session, "checkpointer", None) is not None
    eo = exactly_once_enabled()
    required = persistent and eo and bool(session.connectors)
    for node in out_nodes:
        if required and node._outbox is None:
            v.violation(
                check,
                f"{node.describe()}: persistence is attached and "
                "exactly-once is on, but this sink writes DIRECTLY — "
                "a crash between its wave write and the epoch commit "
                "duplicates or drops deliveries (io/outbox.py)",
            )
        elif node._outbox is not None and not (persistent and eo):
            v.violation(
                check,
                f"{node.describe()}: outbox armed without the "
                "exactly-once contract (persistence "
                f"{'attached' if persistent else 'absent'}, "
                f"PATHWAY_EXACTLY_ONCE {'on' if eo else 'off'}) — "
                "sealed ranges would never commit",
            )
    v.report["checks"][check]["sinks"] = len(out_nodes)
    v.report["checks"][check]["outboxed"] = sum(
        1 for n in out_nodes if n._outbox is not None
    )


# ------------------------------------- check: fused native programs


def _validate_program(prog: dict) -> list[str]:
    """Structural type check of one fused native program: every column
    reference resolves inside the virtual schema of its stage boundary."""
    problems: list[str] = []
    src_w = prog.get("src_width")
    env_w = src_w  # None = unknown source width (runtime re-fusion)

    def in_env(idx: int) -> bool:
        return env_w is None or 0 <= idx < env_w

    for sno, stage in enumerate(prog.get("stages", [])):
        kind, payload = stage[0], stage[1]
        if kind == "map":
            for it in payload:
                tag = it[0]
                if tag == "env":
                    if not in_env(it[1]):
                        problems.append(
                            f"stage {sno}: env passthrough col {it[1]} "
                            f"outside the boundary schema (width {env_w})"
                        )
                elif tag == "keycols":
                    if src_w is not None and any(
                        not 0 <= c < src_w for c in it[1]
                    ):
                        problems.append(
                            f"stage {sno}: keycols {it[1]} outside the "
                            f"SOURCE schema (width {src_w})"
                        )
                elif tag == "plan":
                    bad = [
                        c for c in it[1].needed_cols if not in_env(c)
                    ]
                    if bad:
                        problems.append(
                            f"stage {sno}: plan needs cols {bad} outside "
                            f"the boundary schema (width {env_w})"
                        )
                else:
                    problems.append(f"stage {sno}: unknown map item {tag!r}")
            env_w = len(payload)
        elif kind == "filter":
            bad = [c for c in payload.needed_cols if not in_env(c)]
            if bad:
                problems.append(
                    f"stage {sno}: filter needs cols {bad} outside the "
                    f"boundary schema (width {env_w})"
                )
        else:
            problems.append(f"stage {sno}: unknown stage kind {kind!r}")
    fe = prog.get("final_env")
    if fe is not None:
        if env_w is not None and len(fe) != env_w:
            problems.append(
                f"final schema width {len(fe)} != last boundary width "
                f"{env_w}"
            )
        for j, it in enumerate(fe):
            if it[0] == "src":
                if src_w is not None and not 0 <= it[1] < src_w:
                    problems.append(
                        f"final col {j} passes through source col "
                        f"{it[1]} outside the source schema "
                        f"(width {src_w})"
                    )
            elif it[0] != "slot":
                problems.append(f"final col {j}: unknown item {it[0]!r}")
    if src_w is not None:
        bad = [c for c in prog.get("needed_src", []) if not 0 <= c < src_w]
        if bad:
            problems.append(
                f"needed_src {bad} outside the source schema "
                f"(width {src_w})"
            )
    return problems


def check_native_programs(session, v: _Verdict, shared: dict) -> None:
    from pathway_tpu_torch.engine.core import FusedRowwiseNode

    check = "native-program-schema"
    v.start(check)
    programs = 0
    for node in session.graph.nodes:
        if not isinstance(node, FusedRowwiseNode) or node._program is None:
            continue
        programs += 1
        for problem in _validate_program(node._program):
            v.violation(check, f"{node.describe()}: {problem}")
    v.report["checks"][check]["programs"] = programs


# ------------------------------------------- check: exchange donation


def check_donation(donate: bool, rounds: int, rows_local: int | None = None,
                   n_shards: int | None = None, cap: int | None = None):
    """The donation aliasing rule, callable from the live decision point
    (parallel/exchange.py) and from the static probe below: a donated
    exchange wave MUST be single-round (the staging arrays alias the
    receive buffers; reuse across respill rounds would corrupt round
    2+), with the byte-matching padded layout."""
    if not donate:
        return
    if rounds != 1:
        raise PlanVerificationError([
            "[exchange-donation] donated exchange buffers on a "
            f"{rounds}-round wave — aliasing the staging arrays would "
            "corrupt every round after the first",
        ])
    if (
        rows_local is not None
        and n_shards is not None
        and cap is not None
        and rows_local != n_shards * (cap + 1)
    ):
        raise PlanVerificationError([
            "[exchange-donation] donated layout rows_local="
            f"{rows_local} != n_shards*(cap+1)={n_shards * (cap + 1)} — "
            "send/receive byte sizes must match for XLA to alias them",
        ])


# the planner function whose probe grid last passed: the grid verdict is
# process-invariant for a given function object, so re-probing it on
# every build would be pure waste — a monkeypatched/edited planner is a
# DIFFERENT object and re-probes
_DONATION_PROBED_FN: Any = None


def check_exchange_donation(session, v: _Verdict, shared: dict) -> None:
    global _DONATION_PROBED_FN
    check = "exchange-donation"
    v.start(check)
    import sys

    # only audit the exchange stack when this process has loaded it —
    # no exchange module means no donation can happen, and importing it
    # here would drag the jax/mesh machinery into every object-plane
    # session just to probe a decision it will never take
    _ex = sys.modules.get("pathway_tpu_torch.parallel.exchange")
    if _ex is None:
        v.skip(check, "exchange stack not loaded in this process")
        return
    plan = getattr(_ex, "plan_respill_layout", None)
    if plan is None:
        v.skip(check, "no respill layout planner exported")
        return
    if plan is _DONATION_PROBED_FN:
        v.report["checks"][check]["probes"] = "cached"
        return
    probes = 0
    for n_shards in (2, 4, 8):
        for per in (0, 1, 7, 64, 4096):
            for max_bucket in (0, 1, per // 2, per, 4 * per + 3):
                for capacity in (None, 16):
                    probes += 1
                    donate, cap, rounds, rows_local = plan(
                        capacity, max_bucket, per, n_shards
                    )
                    try:
                        check_donation(
                            donate, rounds, rows_local, n_shards, cap
                        )
                    except PlanVerificationError as e:
                        v.violation(
                            check,
                            f"layout planner (n_shards={n_shards}, "
                            f"per={per}, max_bucket={max_bucket}, "
                            f"capacity={capacity}): {e.findings[0]}",
                        )
                        return
    v.report["checks"][check]["probes"] = probes
    _DONATION_PROBED_FN = plan


# ----------------------------------------------- check: cone contract


def check_cone_contract(session, v: _Verdict, shared: dict) -> None:
    """Re-prove every installed wave cone's contract (engine/cone.py)
    BEFORE any compile: a cone that fires one merged program instead of
    per-node waves is only sound when no third party can observe the
    emissions it elides and its donated buffers can actually alias."""
    check = "cone-contract"
    v.start(check)
    cones = getattr(session.graph, "_cones", None) or []
    v.report["checks"][check]["cones"] = len(cones)
    if not cones:
        return
    for cone in cones:
        name = cone.head.describe()
        # single-consumer interior: each member feeds ONLY the next one
        for m, nxt in zip(cone.members[:-1], cone.members[1:]):
            downs = [d for d, _i in m.downstream]
            if len(downs) != 1 or downs[0] is not nxt:
                v.violation(
                    check,
                    f"{name}: multi-consumer interior — {m.describe()} "
                    f"feeds {len(downs)} consumer(s); a cone member may "
                    "feed only the next member (any other consumer "
                    "would observe the per-node emission the cone "
                    "elides)",
                )
        prog = cone.program
        rounds = prog.get("rounds", 1)
        if prog.get("donation", "none") != "none" and rounds != 1:
            v.violation(
                check,
                f"{name}: donation on a multi-round layout "
                f"({rounds} rounds) — the donated staging buffers alias "
                "the receive buffers and would corrupt every round "
                "after the first (same rule as check_donation)",
            )
        if prog.get("lanes") != 4:
            v.violation(
                check,
                f"{name}: schema-mismatched staging buffer — "
                f"{prog.get('lanes')} lanes declared, the exchange pack "
                "ships exactly 4 u64 lanes per row (key_lo, key_hi, "
                "token, diff); send/receive byte sizes must match for "
                "XLA to alias them",
            )
        interior = prog.get("interior")
        if interior is not None:
            for problem in _validate_program(interior):
                v.violation(
                    check, f"{name}: interior program schema: {problem}"
                )
        for m in cone.members[1:]:
            if not m._cone_absorbed:
                v.violation(
                    check,
                    f"{name}: {m.describe()} is a cone member but not "
                    "absorbed — Graph.step would fire it a second time "
                    "on top of the cone's fire",
                )
        if cone.head._cone is not cone:
            v.violation(
                check,
                f"{name}: head does not point back at its cone — the "
                "cone would never fire while its members stay absorbed",
            )


# ---------------------------------------------- check: spill contract


def check_spill_contract(session, v: _Verdict, shared: dict) -> None:
    """Prove every out-of-core arrangement's spill contract
    (engine/spill.py) before data flows: the probe ladder is only sound
    when a key is live in EXACTLY one tier (resident tail or one run's
    live set — tail-first-then-newest-run-first stops at the first hit),
    the run manifest covers the runs exactly, and the resident budget is
    a positive group count (a zero budget would thrash every wave
    through disk)."""
    from pathway_tpu_torch.engine import spill as _spill

    check = "spill-contract"
    v.start(check)
    stores = 0
    for node in session.graph.nodes:
        getter = getattr(node, "spill_stores", None)
        if getter is None:
            continue
        for store in getter():
            stores += 1
            who = f"{node.describe()}:{store.label}"
            if store.budget <= 0:
                v.violation(
                    check,
                    f"{who}: non-positive resident budget "
                    f"{store.budget}; every probe would take the disk "
                    "ladder",
                )
            try:
                _spill.verify_manifest(store.manifest(), who)
            except PlanVerificationError as e:
                v.violation(check, str(e.findings[0] if e.findings else e))
            try:
                _spill.check_two_tier(store, who)
            except PlanVerificationError as e:
                v.violation(check, str(e.findings[0] if e.findings else e))
    v.report["checks"][check]["stores"] = stores


# ----------------------------------------- check: index tier contract


def check_index_tier_contract(session, v: _Verdict, shared: dict) -> None:
    """Prove the tier placement of every tiered ANN index behind an
    `ExternalIndexNode` (see pathway_tpu_torch/indexing/tiers.py): exclusive
    residency per list (RAM cube XOR a live run record), manifest
    integrity of the tier store, and agreement between the placement
    flags and the store's two-tier rule."""
    from pathway_tpu_torch.indexing import tiers as _tiers

    _tiers.check_index_tier(session, v, shared)


# --------------------------------------------- check: morsel contract

# the StealScheduler class whose dynamic probe last passed — same
# process-invariance argument as _DONATION_PROBED_FN: the claim protocol
# is a pure property of the class object, a monkeypatched scheduler is a
# different object and re-probes
_MORSEL_PROBED_CLS: Any = None


def _probe_steal_scheduler(_morsel) -> list[str]:
    """Drain synthetic queues through a real StealScheduler on a private
    crew and re-derive the claim invariants from the observed trace:
    every task exactly once, per queue in index order, never two tasks
    of one queue in flight together (the single-consumer latch)."""
    import threading as _threading
    import time as _time
    from concurrent.futures import ThreadPoolExecutor

    n_queues, per, crew = 5, 4, 3
    trace_lock = _threading.Lock()
    started: list[tuple[int, int]] = []
    inflight = [0] * n_queues
    problems: list[str] = []

    def make(qi: int, ti: int):
        def run():
            with trace_lock:
                inflight[qi] += 1
                if inflight[qi] > 1:
                    problems.append(
                        f"queue {qi}: two morsels in flight at once "
                        "(single-consumer latch broken)"
                    )
                started.append((qi, ti))
            _time.sleep(0.0005)  # widen the race window
            with trace_lock:
                inflight[qi] -= 1
        return run

    queues = [[make(qi, ti) for ti in range(per)] for qi in range(n_queues)]
    sched = _morsel.StealScheduler(queues, crew)
    with ThreadPoolExecutor(
        max_workers=crew - 1, thread_name_prefix="pw-verify-steal"
    ) as pool:
        futs = [pool.submit(sched.runner, w) for w in range(1, crew)]
        sched.runner(0)
        for f in futs:
            f.result()
    # deliberately NOT sched.finish(): the probe's synthetic morsels must
    # not pollute the published pathway_morsel_*/pathway_steal_* counters
    # (every _complete already reconciled the live-depth gauge; our tasks
    # never raise, so there is no failure path to reconcile)
    if sched._fail is not None:
        problems.append(f"probe task raised: {sched._fail!r}")
    for qi in range(n_queues):
        ran = [ti for q, ti in started if q == qi]
        if ran != list(range(per)):
            problems.append(
                f"queue {qi}: start order {ran}, want exactly-once in "
                "index order (stateful replicas apply morsels in "
                "segment order)"
            )
    return problems


def check_morsel_contract(session, v: _Verdict, shared: dict) -> None:
    """Re-prove the morsel/steal execution contract (engine/morsel.py)
    whenever this build will run with morsels on:

    * dynamic probe (cached per StealScheduler class object): a private
      crew drains synthetic queues and the observed trace must show
      exactly-once execution, per-queue index order, and never two
      morsels of one queue in flight (the single-consumer latch —
      exactly what keeps stateful replicas sound under stealing);
    * static: every ShardedNode replica's ONLY downstream is its own
      private collector — emission then happens after the wave barrier
      in replica order, so which thread ran a morsel is unobservable;
      a replica wired anywhere else would leak mid-wave emission from a
      stealing thread;
    * static: installed cone programs carry no donation across stolen
      morsels — donation must stay "single-round" with rounds == 1 (a
      stolen morsel re-firing into an aliased multi-round staging
      buffer is the check_donation corruption class).
    """
    global _MORSEL_PROBED_CLS
    from pathway_tpu_torch.engine import morsel as _morsel
    from pathway_tpu_torch.engine.workers import ShardedNode

    check = "morsel-contract"
    if not _morsel.enabled_cached():
        v.skip(check, "PATHWAY_MORSEL=0 — serial wave execution")
        return
    v.start(check)
    replicas = 0
    for node in session.graph.nodes:
        if not isinstance(node, ShardedNode):
            continue
        for i, (replica, coll) in enumerate(
            zip(node.replicas, node.collectors)
        ):
            replicas += 1
            downs = list(replica.downstream)
            if len(downs) != 1 or downs[0][0] is not coll:
                v.violation(
                    check,
                    f"{node.describe()}: replica {i} feeds "
                    f"{len(downs)} downstream(s) instead of exactly its "
                    "own collector — a stealing thread's emission would "
                    "be observable before the wave barrier",
                )
    v.report["checks"][check]["replicas"] = replicas
    for cone in getattr(session.graph, "_cones", None) or []:
        prog = cone.program
        donation = prog.get("donation", "none")
        if donation != "none" and (
            donation != "single-round" or prog.get("rounds", 1) != 1
        ):
            v.violation(
                check,
                f"{cone.head.describe()}: donation {donation!r} over "
                f"{prog.get('rounds', 1)} round(s) with morsels enabled "
                "— a stolen morsel re-entering an aliased multi-round "
                "staging buffer corrupts later rounds",
            )
    if _morsel.StealScheduler is _MORSEL_PROBED_CLS:
        v.report["checks"][check]["probe"] = "cached"
        return
    problems = _probe_steal_scheduler(_morsel)
    for p in problems:
        v.violation(check, f"steal-scheduler probe: {p}")
    if not problems:
        _MORSEL_PROBED_CLS = _morsel.StealScheduler
    v.report["checks"][check]["probe"] = "ran"


# ----------------------------------------------- check: join reorder


def check_join_reorder(session, v: _Verdict, shared: dict) -> None:
    """Re-prove every join swap the planner applied in "auto" mode with
    this module's own rules: the recorded sketches must disagree by at
    least the auto ratio, and no order-sensitive sink (``observes_ids``
    per the session's sink metadata — subscribe/capture) may reach the
    join, re-derived here by an independent upstream closure over the
    sink tables rather than by trusting ``PlanContext.order_sensitive``.
    Forced swaps (PATHWAY_JOIN_REORDER=1) are the user's explicit
    opt-in and are not judged."""
    from pathway_tpu_torch.internals import planner as _planner

    check = "join-reorder"
    v.start(check)
    entries = [
        e for e in session.plan_report.get("join_orders", [])
        if e.get("applied") and e.get("mode") == "auto"
    ]
    v.report["checks"][check]["auto_swaps"] = len(entries)
    if not entries:
        return
    sensitive: set[int] = set()
    for table, observes_ids in getattr(session, "_sink_meta", None) or []:
        if not observes_ids:
            continue
        up = [table]
        while up:
            t = up.pop()
            sid = t._spec.id
            if sid in sensitive:
                continue
            sensitive.add(sid)
            up.extend(_input_tables(t._spec))
    ratio = _planner._REORDER_AUTO_RATIO
    for e in entries:
        l_rows = (e.get("left") or {}).get("rows")
        r_rows = (e.get("right") or {}).get("rows")
        if l_rows is None or r_rows is None or l_rows * ratio > r_rows:
            v.violation(
                check,
                f"join {e['join']}: auto swap applied on sketches "
                f"left={l_rows} right={r_rows} — below the {ratio}x bar "
                "the auto mode promises (a near-coin-flip swap buys "
                "nothing and still permutes emission order)",
            )
        if e["join"] in sensitive:
            v.violation(
                check,
                f"join {e['join']}: auto swap applied upstream of an "
                "order-sensitive sink — subscribe/capture observes "
                "intra-wave arrival order, which the swap permutes",
            )


# ------------------------------------------------------- swap contract


def _swap_meta_roots(root: str) -> dict[str, str]:
    """{slot name -> metadata-bearing dir} for a persistence root: either
    the root itself (single process) or its ``proc-N`` children (mesh)."""
    if os.path.exists(os.path.join(root, "metadata.json")):
        return {".": root}
    out: dict[str, str] = {}
    try:
        entries = os.listdir(root)
    except OSError:
        return out
    for fn in sorted(entries):
        if fn.startswith("proc-") and fn[5:].isdigit():
            out[fn] = os.path.join(root, fn)
    return out


def check_swap_contract(blue_root: str, green_root: str) -> dict:
    """Blue/green swap gate (parallel/bluegreen.py): the GREEN staged
    root may replace the BLUE serving root only if nothing the blue
    pipeline promised is lost. Re-proved from the roots alone — no trust
    in the green run's own claims: (1) shard-map consistency — same
    process slots on both sides; (2) offsets carried forward — every
    source the blue side committed exists on the green side at an offset
    at least as far; (3) outbox/sink compatibility — every blue sink's
    sealed delivery offset is carried forward, so exactly-once dedup
    survives the swap; (4) the green side actually warmed — its epoch is
    at least blue's (a cold-started green would replay the world onto
    already-delivered sinks). Raises PlanVerificationError on violation;
    returns the verdict report otherwise."""
    import json as _json

    check = "swap-contract"
    v = _Verdict(mode())
    v.start(check)
    blue = _swap_meta_roots(blue_root)
    green = _swap_meta_roots(green_root)
    if set(blue) != set(green):
        v.violation(
            check,
            f"shard map mismatch: blue has slots {sorted(blue)}, green "
            f"has {sorted(green)} — a swap must not change mesh "
            "membership (rebalance first, then swap)",
        )
    def _meta(d: str) -> dict | None:
        try:
            with open(os.path.join(d, "metadata.json")) as f:
                return _json.load(f)
        except (OSError, ValueError):
            return None

    for slot in sorted(set(blue) & set(green)):
        bm, gm = _meta(blue[slot]), _meta(green[slot])
        if bm is None:
            continue  # blue never committed: nothing promised, any green ok
        if gm is None:
            v.violation(
                check,
                f"slot {slot}: green has no committed metadata — it "
                "never warmed against the persisted state",
            )
            continue
        if int(gm.get("epoch", -1)) < int(bm.get("epoch", -1)):
            v.violation(
                check,
                f"slot {slot}: green epoch {gm.get('epoch')} is behind "
                f"blue epoch {bm.get('epoch')} — the fence epoch was "
                "not replayed",
            )
        boff = bm.get("offsets") or {}
        goff = gm.get("offsets") or {}
        for nm, off in boff.items():
            if nm not in goff:
                v.violation(
                    check,
                    f"slot {slot}: source {nm!r} committed by blue is "
                    "missing from green — its journal would be dropped",
                )
            elif int(goff[nm]) < int(off):
                v.violation(
                    check,
                    f"slot {slot}: source {nm!r} offset went backwards "
                    f"({off} -> {goff[nm]}) — green would re-consume "
                    "delivered input",
                )
        bout = bm.get("outbox") or {}
        gout = gm.get("outbox") or {}
        for sink, off in bout.items():
            if sink not in gout:
                v.violation(
                    check,
                    f"slot {slot}: sink {sink!r} outbox offset not "
                    "carried forward — exactly-once dedup would reset "
                    "and redeliver",
                )
            elif int(gout[sink]) < int(off):
                v.violation(
                    check,
                    f"slot {slot}: sink {sink!r} outbox offset went "
                    f"backwards ({off} -> {gout[sink]})",
                )
        if not gm.get("signature"):
            v.violation(
                check,
                f"slot {slot}: green metadata carries no pipeline "
                "signature — state cannot be mapped onto any plan",
            )
    if v.report["violations"]:
        raise PlanVerificationError(v.report["violations"], v.report)
    return v.report


# ---------------------------------------------------------------- driver

_CHECKS = (
    check_fusion_single_consumer,
    check_id_elision,
    check_iterate_scopes,
    check_exactly_once_outbox,
    check_native_programs,
    check_exchange_donation,
    check_cone_contract,
    check_spill_contract,
    check_index_tier_contract,
    check_morsel_contract,
    check_join_reorder,
)


def verify_session(session) -> dict:
    """Run every check over a lowered session. Returns the verdict dict
    (also what lands in the plan report); raises
    :class:`PlanVerificationError` when any invariant fails (strict mode
    escalates warnings). Callers gate on :func:`enabled`."""
    md = mode()
    v = _Verdict(md)
    shared: dict = {}
    for check in _CHECKS:
        try:
            check(session, v, shared)
        except PlanVerificationError:
            raise
        except Exception as e:  # noqa: BLE001 — see _Verdict.internal
            v.internal(check.__name__.replace("check_", "").replace(
                "_", "-"), e)
    if v.report["violations"]:
        raise PlanVerificationError(v.report["violations"], v.report)
    return v.report
