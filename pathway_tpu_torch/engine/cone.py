"""Wave-cone megakernel: one host dispatch from scan to exchange.

The planner identifies a *wave cone* — scan source (`InputNode`) →
optional fused rowwise run (`FusedRowwiseNode` with a native program) →
bucketized groupby update (`GroupByNode`, possibly wrapped by a
`ShardedNode` whose exchange pack rides the PR 13 column plane) — and
this module compiles it into a single fire per wave: `Graph.step` skips
the absorbed interior members and drives the whole cone at the head's
topo slot, so a steady-state wave pays O(1) host dispatches for the
cone instead of one per operator (the `pathway_wave_dispatches`
histogram measures the claim).

Why the output stays byte-identical to the per-node plan
--------------------------------------------------------

The per-node path concatenates a wave's scan segments once at the
`InputNode` (`_emit_merged`: `NativeBatch.concat` + distinct check) and
every downstream operator sees ONE batch. The cone never builds that
concat — it streams the segments — so it must prove the merge
commutes through each member:

* the fused rowwise program is row-local: running it per segment and
  concatenating the outputs is row-for-row the run over the
  concatenation (selection masks, `build_rows`, and the BAD-row
  fallback indices are all per-row functions, and per-segment fallback
  order equals global sorted order because segments are processed in
  arrival order);
* `zs_agg_update` returns affected groups in FIRST-OCCURRENCE order of
  its input with LIVE post-update values, and its float accumulation
  visits rows in batch order — so per-segment updates merged by
  first-occurrence / last-value-wins (`_merge_agg`) equal one update
  over the concatenation, PROVIDED `_emit_agg` runs once on the merged
  result (`delta_emit` mutates the emitted-state; per-segment emission
  would leak intermediate retract/insert pairs the concat never made).

Eligibility is re-checked per wave; anything the proof does not cover
degrades to the existing per-node path for that wave — never silently
(`fallback_fires` + reason are counted in the plan report):

* an object entry or a segment without ``distinct_hint`` in the scan
  pending (the per-node path may consolidate; the cone must not guess),
* a group projection / column decode the plan rejects,
* BAD rows surfacing from the fused program (the captured per-segment
  outputs are replayed through the target as the concat the per-node
  path would have built — same bytes, one wave of per-node semantics),
* a skewed (multi-round) exchange layout — the sharded split itself
  falls back inside `ColumnExchanger`, and donation is only taken on
  single-round layouts (`plan_respill_layout`; re-proved by
  `internals/verifier.check_cone_contract` before any compile).

`PATHWAY_MEGAKERNEL=0` (read once at the lowering seam —
`planner.megakernel_enabled`) skips installation entirely: the graph is
byte-identical to the PR 9 fused plan. The frontier scheduler drives
nodes individually, so `Runtime._make_scheduler` dissolves cones loudly
(plan report `megakernel.dissolved`) instead of leaving them dormant.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from pathway_tpu_torch.engine.core import (
    FusedRowwiseNode,
    GroupByNode,
    InputNode,
    _NativeProgramBuilder,
    _nb_type,
)
from pathway_tpu_torch.engine import morsel as _morsel
from pathway_tpu_torch.engine.workers import ShardedNode, _pool

__all__ = [
    "WaveCone",
    "ConeProgramBuilder",
    "install_cones",
    "dissolve_cones",
]


class _Capture:
    """Duck-typed sink standing in for a member's downstream during a
    cone fire: collects emissions (NativeBatch segments and entry lists)
    in arrival order so the cone can merge them instead of letting them
    land per-segment in the target's buffers."""

    __slots__ = ("items",)

    def __init__(self) -> None:
        self.items: list = []

    def accept(self, _idx: int, entries: Any) -> None:
        self.items.append(entries)


class ConeProgramBuilder:
    """Assembles one cone's compiled-plan descriptor from its members —
    the `_NativeProgramBuilder` grown over the whole cone: the fused
    interior program is re-adopted (and re-validated by the plan
    verifier's schema check), the groupby plan and the exchange layout
    ride along, and the donation contract is stated explicitly so
    `check_cone_contract` can refuse it before any compile."""

    def __init__(self) -> None:
        self._interior: dict | None = None
        self._gb_cols: list[int] = []
        self._n_reducers: int = 0
        self._n_shards: int = 1

    def adopt_interior(self, program: dict) -> None:
        b = _NativeProgramBuilder()
        b.adopt(program)
        b.src_width = program.get("src_width")
        self._interior = b.build()

    def set_groupby(self, plan: dict, n_reducers: int) -> None:
        self._gb_cols = list(plan["gb_cols"])
        self._n_reducers = n_reducers

    def set_exchange(self, n_shards: int) -> None:
        self._n_shards = n_shards

    def build(self) -> dict:
        return {
            "interior": self._interior,
            "gb_cols": list(self._gb_cols),
            "n_reducers": self._n_reducers,
            "n_shards": self._n_shards,
            # a NativeBatch ships (key_lo, key_hi, token, diff): four
            # u64 lanes — the staging buffer shape the exchange pads
            "lanes": 4,
            # donated staging buffers alias the receive buffers, which
            # is sound only for single-round layouts; multi-round waves
            # run undonated (exchange.plan_respill_layout)
            "donation": "single-round",
            "rounds": 1,
        }


class WaveCone:
    """One installed cone: members stay live (fallback, persistence,
    Graph.end all still see them) but `Graph.step` skips the absorbed
    interior and fires the cone once at the head's topo slot."""

    def __init__(
        self,
        head: InputNode,
        fused: FusedRowwiseNode | None,
        target: Any,  # GroupByNode | ShardedNode over GroupByNode
        report: dict,
    ):
        self.head = head
        self.fused = fused
        self.target = target
        self.members = [head] + ([fused] if fused is not None else []) + [target]
        self.report = report
        self.program = self._build_program()

    def _build_program(self) -> dict:
        b = ConeProgramBuilder()
        if self.fused is not None and self.fused._program is not None:
            b.adopt_interior(self.fused._program)
        t = self.target
        if isinstance(t, ShardedNode):
            b.set_exchange(t.n_shards)
            gb = t.replicas[0]
        else:
            gb = t
        if isinstance(gb, GroupByNode) and gb._plan is not None:
            b.set_groupby(gb._plan, len(gb.reducers))
        return b.build()

    # ----------------------------------------------------------- firing

    def fire(self, time: int) -> int:
        """Drive one wave through the cone; returns the number of host
        dispatches it cost (1 on the cone path, the member count on a
        fallback wave — Graph.step folds this into dispatch_count so the
        `pathway_wave_dispatches` histogram stays honest)."""
        head = self.head
        if not head.pending:
            return 1
        nb_t = _nb_type()
        if nb_t is None or any(
            type(s) is not nb_t or not s.distinct_hint for s in head.pending
        ):
            # the per-node path may consolidate such a wave; replay it
            # through the members unchanged (head.pending untouched)
            return self._fallback(time, "object-or-unhinted-wave")
        segs, head.pending = head.pending, []
        head.rows_out += sum(len(s) for s in segs)
        if _morsel.enabled_cached():
            # cache-sized morsels: oversized scan segments split into
            # row-contiguous slices so the fused run and the sharded
            # update below get steal-balanceable units. Concatenating
            # the slices reproduces the segment row-for-row (bool-mask
            # select keeps distinct_hint), so the segment-merge proof
            # above covers morsels unchanged.
            rows = _morsel.morsel_rows_cached()
            if any(len(s) > rows for s in segs):
                split = [m for s in segs for m in _morsel.split_batch(s, rows)]
                from pathway_tpu_torch.internals import observability as _obs

                if _obs.PLANE is not None:
                    _obs.PLANE.metrics.counter(
                        "pathway_morsel_split_total",
                        inc=len(split) - len(segs),
                        help="extra segments created by morsel splitting",
                    )
                segs = split
        batches: list = segs
        entries: list = []
        fused = self.fused
        if fused is not None:
            sink = _Capture()
            saved = fused.downstream
            fused.downstream = [(sink, 0)]  # type: ignore[list-item]
            try:
                for b in segs:
                    fused.rows_in += len(b)
                    fused._run_batch(time, b)
            finally:
                fused.downstream = saved
            batches = [s for s in sink.items if type(s) is not list]
            entries = [e for s in sink.items if type(s) is list for e in s]
        if entries:
            # BAD rows ran the composed per-row path: replay the
            # captured outputs through the target as the concat the
            # per-node path would have built (same rows, same order)
            return self._replay_target(time, batches, entries, "bad-rows")
        if not batches:
            self._count_fire()
            return 1
        target = self.target
        if isinstance(target, ShardedNode):
            ok = self._fire_sharded(time, target, batches)
        else:
            ok = self._fire_groupby(time, target, batches)
        if ok:
            self._count_fire()
            return 1
        return self._replay_target(time, batches, [], "plan-rejected-batch")

    # ------------------------------------------------- target: groupby

    def _fire_groupby(self, time: int, gb: GroupByNode, batches: list) -> bool:
        if gb._native is None or gb._plan is None:
            return False
        preps = []
        for b in batches:
            p = gb._prepare_native_batch(b)
            if p is None:
                return False  # nothing applied yet: clean per-node replay
            preps.append(p)
        parts = []
        for b, (gtok, vals_i, vals_f, tags) in zip(batches, preps):
            gb.rows_in += len(b)
            parts.append(
                gb._native.update(
                    gtok, vals_i, vals_f, tags, np.ascontiguousarray(b.diff)
                )
            )
        gb._emit_agg(time, *_merge_agg(parts))
        return True

    # ------------------------------------------- target: sharded groupby

    def _fire_sharded(self, time: int, sh: ShardedNode, batches: list) -> bool:
        from pathway_tpu_torch.engine.native import dataplane as dp
        from pathway_tpu_torch.parallel.column_plane import engine_column_exchanger

        plan = sh.native_routes[0]
        if plan is None or plan[0] != "group":
            return False
        replicas = sh.replicas
        if any(r._native is None or r._plan is None for r in replicas):
            return False
        n = sh.n_shards
        gb_cols = plan[1]
        ce = engine_column_exchanger()
        # phase A (pure): one fused projection per segment yields BOTH
        # the group tokens and the shard routing — the exchange pack and
        # the groupby update share the projection instead of each
        # re-projecting their side of the wire
        prepared = []  # (sub_batches, sub_gtoks) per segment
        for b in batches:
            res = dp.project_group(b.tab, b.token, gb_cols, n_shards=n)
            if res is None:
                return False
            gtok_full, shards = res
            subs = ce.split_batch(b, shards, n) if ce is not None else None
            if subs is None:
                subs = [b.select(shards == s) for s in range(n)]
            # split_batch is row-for-row identical to the select path,
            # so the per-shard group tokens are just the sliced rows
            gtoks = [gtok_full[shards == s] for s in range(n)]
            preps = []
            for s in range(n):
                if not len(subs[s]):
                    preps.append(None)
                    continue
                p = replicas[s]._prepare_native_batch(subs[s], gtok=gtoks[s])
                if p is None:
                    return False
                preps.append(p)
            prepared.append((subs, preps))
        # phase B (stateful): per-replica updates merge across segments
        # and emit ONCE per replica, mirroring the unsharded cone
        sh.rows_in += sum(len(b) for b in batches)
        touched = sorted(
            {
                s
                for _subs, preps in prepared
                for s, p in enumerate(preps)
                if p is not None
            }
        )
        if not touched:
            return True

        def run_replica(s: int) -> None:
            gb = replicas[s]
            parts = []
            for subs, preps in prepared:
                if preps[s] is None:
                    continue
                gtok, vals_i, vals_f, tags = preps[s]
                gb.rows_in += len(subs[s])
                parts.append(
                    gb._native.update(
                        gtok, vals_i, vals_f, tags,
                        np.ascontiguousarray(subs[s].diff),
                    )
                )
            gb._emit_agg(time, *_merge_agg(parts))

        if len(touched) == 1:
            run_replica(touched[0])
        elif _morsel.enabled_cached():
            # per-replica morsel queues: each (replica, segment) update
            # is one steal-able unit, each queue runs in segment order
            # on exactly one thread at a time (StealScheduler's busy
            # latch), parts collect in segment order, and the closing
            # task merges + emits ONCE per replica — exactly the serial
            # run_replica, just drained by whichever worker is idle.
            _morsel.run_stealing(
                [self._replica_queue(replicas[s], time, prepared, s)
                 for s in touched]
            )
        else:
            futures = [_pool().submit(run_replica, s) for s in touched]
            for f in futures:
                f.result()  # wave barrier; re-raises replica errors
        sh._emit_collected(time, touched)
        return True

    @staticmethod
    def _replica_queue(gb, time: int, prepared: list, s: int) -> list:
        """Ordered morsel tasks for one replica: one native update per
        prepared segment appending into `parts`, then one merge+emit
        tail. The queue's in-order, single-consumer execution is what
        makes parts == the serial segment loop."""
        parts: list = []

        def update_task(subs, prep):
            gtok, vals_i, vals_f, tags = prep

            def run() -> None:
                gb.rows_in += len(subs[s])
                parts.append(
                    gb._native.update(
                        gtok, vals_i, vals_f, tags,
                        np.ascontiguousarray(subs[s].diff),
                    )
                )

            return run

        tasks = [
            update_task(subs, preps[s])
            for subs, preps in prepared
            if preps[s] is not None
        ]

        def emit_tail() -> None:
            gb._emit_agg(time, *_merge_agg(parts))

        tasks.append(emit_tail)
        return tasks

    # --------------------------------------------------------- fallback

    def _replay_target(
        self, time: int, batches: list, entries: list, reason: str
    ) -> int:
        """Degrade the rest of this wave to the per-node path: feed the
        target exactly what it would have received from the concat plan
        (one merged batch, then the entry tail) and fire it normally."""
        nb_t = _nb_type()
        target = self.target
        if batches:
            nb = batches[0] if len(batches) == 1 else nb_t.concat(batches)
            target.accept(0, nb)
        if entries:
            target.accept(0, list(entries))
        target.finish_time(time)
        self._count_fallback(time, reason, drive_members=False)
        return len(self.members)

    def _fallback(self, time: int, reason: str) -> int:
        """Whole-wave degrade: drive every member's own finish_time in
        topo order — literally the per-node plan for this wave."""
        for m in self.members:
            m.finish_time(time)
        self._count_fallback(time, reason, drive_members=True)
        return len(self.members)

    # ------------------------------------------------------- accounting

    def _count_fire(self) -> None:
        self.report["cone_fires"] = self.report.get("cone_fires", 0) + 1

    def _count_fallback(self, time: int, reason: str, drive_members: bool) -> None:
        self.report["fallback_fires"] = self.report.get("fallback_fires", 0) + 1
        reasons = self.report.setdefault("fallback_reasons", {})
        reasons[reason] = reasons.get(reason, 0) + 1
        from pathway_tpu_torch.internals import observability as _obs

        if _obs.PLANE is not None:
            _obs.PLANE.record(
                "cone.fallback", export=False, reason=reason, t=time,
                members=len(self.members), whole_wave=drive_members,
            )


def _merge_agg(parts: list) -> tuple:
    """Merge per-segment `zs_agg_update` results into what ONE update
    over the concatenation returns: affected groups in first-occurrence
    order across segments, each carrying the LAST segment's live value
    (dict assignment keeps the original insertion position)."""
    if len(parts) == 1:
        return parts[0]
    pick: dict[int, tuple[int, int]] = {}
    for pi, part in enumerate(parts):
        g_ids = part[0]
        for j in range(len(g_ids)):
            pick[int(g_ids[j])] = (pi, j)
    m = len(pick)
    p0 = parts[0]
    g_ids = np.empty(m, p0[0].dtype)
    totals = np.empty(m, p0[1].dtype)
    isum = np.empty((m,) + p0[2].shape[1:], p0[2].dtype)
    fsum = np.empty((m,) + p0[3].shape[1:], p0[3].dtype)
    cnts = np.empty((m,) + p0[4].shape[1:], p0[4].dtype)
    flags = np.empty((m,) + p0[5].shape[1:], p0[5].dtype)
    for k, (gid, (pi, j)) in enumerate(pick.items()):
        part = parts[pi]
        g_ids[k] = gid
        totals[k] = part[1][j]
        isum[k] = part[2][j]
        fsum[k] = part[3][j]
        cnts[k] = part[4][j]
        flags[k] = part[5][j]
    return g_ids, totals, isum, fsum, cnts, flags


# --------------------------------------------------------- install / dissolve


def install_cones(session) -> list[WaveCone]:
    """Identify and install wave cones over a lowered session's live
    graph (planner.find_cone_chains does the identification; this marks
    the members and registers the cones on the graph). Runs BEFORE the
    plan verifier so `check_cone_contract` re-proves every installed
    cone's contract ahead of any compile."""
    from pathway_tpu_torch.internals import planner as _planner

    graph = session.graph
    rep = session.plan_report
    mk = rep.setdefault(
        "megakernel", {"enabled": True, "cones": [], "dissolved": None}
    )
    cones: list[WaveCone] = []
    for chain in _planner.find_cone_chains(graph):
        head, fused, target = chain
        cone_rep = {
            "members": [m.describe() for m in (head, fused, target) if m is not None],
            "cone_fires": 0,
            "fallback_fires": 0,
        }
        cone = WaveCone(head, fused, target, cone_rep)
        for m in cone.members[1:]:
            m._cone_absorbed = True
        head._cone = cone
        mk["cones"].append(cone_rep)
        cones.append(cone)
    graph._cones = cones
    return cones


def dissolve_cones(graph, reason: str) -> int:
    """Uninstall every cone on a graph — loudly, never silently: the
    frontier scheduler drives nodes individually, so an installed cone
    would simply never fire there; dissolving records WHY the plan fell
    back to per-node dispatch."""
    cones = getattr(graph, "_cones", None)
    if not cones:
        return 0
    for cone in cones:
        cone.head._cone = None
        for m in cone.members[1:]:
            m._cone_absorbed = False
    n = len(cones)
    graph._cones = []
    rep = getattr(graph, "plan_report", None)
    if rep is not None and "megakernel" in rep:
        rep["megakernel"]["dissolved"] = reason
    from pathway_tpu_torch.internals import observability as _obs

    if _obs.PLANE is not None:
        _obs.PLANE.record("cone.dissolve", reason=reason, cones=n)
    return n
