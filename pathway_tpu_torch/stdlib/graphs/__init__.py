"""pw.graphs: iterative graph algorithms via pw.iterate
(reference: stdlib/graphs/ — bellman_ford/, pagerank/, louvain_communities/).

Execution: each algorithm's fixpoint loop runs in the engine's
token-resident iterate scope — see docs/iterate.md for the nested-scope
token plane, the C ⊖ P feedback identity, the fallback ladder, and the
PATHWAY_ITERATE_NATIVE kill switch. pagerank and connected_components
are formulated so every round stays on the native zset plane (pure-pick
join selects, update_rows instead of join_left, vectorized arithmetic).
"""

from __future__ import annotations

from typing import Any

import pathway_tpu_torch.internals.reducers as red
from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals.common import coalesce, if_else, iterate
from pathway_tpu_torch.internals.table import Table


class Graph:
    """Vertex/edge pair (reference: stdlib/graphs/graph.py:152)."""

    def __init__(self, V: Table, E: Table):
        self.V = V
        self.E = E


_PAGERANK_SCALE = 1_000_000_000  # fixed-point rank resolution (1e-9)


def pagerank(edges: Table, steps: int = 50, damping: float = 0.85) -> Table:
    """PageRank over edges(u: Pointer, v: Pointer) -> (rank: float) keyed by
    vertex (reference: stdlib/graphs/pagerank/impl.py).

    Ranks iterate as SCALED INTEGERS (like the reference): integer
    arithmetic is exact and summation-order independent, so the fixpoint
    is bit-identical across the token and object planes and convergence
    terminates exactly (float ranks can 2-cycle at the last ulp, where
    the two planes' different summation orders diverge). The public
    `rank` column is the float unscaling, computed once outside the loop.
    """
    degs = edges.groupby(edges.u).reduce(edges.u, degree=red.count())
    vertices_u = edges.groupby(edges.u).reduce(vid=edges.u)
    vertices_v = edges.groupby(edges.v).reduce(vid=edges.v)
    # sources and targets overlap; reindex + groupby dedups to vertex set
    vertices = vertices_u.concat_reindex(vertices_v).groupby(
        ex.this.vid
    ).reduce(vid=ex.this.vid)
    scale = _PAGERANK_SCALE
    base_add = int(round(scale * (1.0 - damping)))
    dnum = int(round(damping * 10_000))

    def step(ranks: Table) -> dict[str, Table]:
        # contribution of u along each edge = rank(u) // degree(u). The
        # joins select PURE column picks (fused into the C join emission)
        # and the division runs as its own vectorized select — every
        # round of the fixpoint stays on the native zset plane
        contribs = (
            edges.join(ranks, edges.u == ranks.vid)
            .select(u=ex.left.u, v=ex.left.v, rank=ex.right.rank)
            .join(degs, ex.left.u == degs.u)
            .select(v=ex.left.v, rank=ex.left.rank, degree=ex.right.degree)
            .select(v=ex.this.v, contrib=ex.this.rank // ex.this.degree)
        )
        summed = contribs.groupby(contribs.v).reduce(
            vid=contribs.v, flow=red.sum(contribs.contrib)
        )
        # inflow per vertex via key-addressed update_rows over a zero
        # baseline (not join_left + coalesce): update_rows is a
        # token-resident operator, so every round of the fixpoint stays
        # on the native zset plane end to end (docs/iterate.md)
        base = vertices.select(vid=vertices.vid, flow=0).with_id_from(
            ex.this.vid
        )
        incoming = base.update_rows(summed.with_id_from(ex.this.vid))
        raw = incoming.select(
            vid=incoming.vid,
            rank=base_add + (incoming.flow * dnum) // 10_000,
        ).with_id_from(ex.this.vid)
        # hysteresis snap: floor-division noise (±1 unit per hop) can
        # ping-pong the integer fixpoint in a persistent micro-cycle;
        # updates within ±2 fixed-point units (2e-9 rank) keep the OLD
        # value, so the contraction provably reaches an exact fixpoint
        new_ranks = (
            raw.join(ranks, raw.vid == ranks.vid)
            .select(vid=ex.left.vid, new=ex.left.rank, old=ex.right.rank)
            .select(
                vid=ex.this.vid,
                rank=if_else(
                    (ex.this.new - ex.this.old <= 2)
                    & (ex.this.new - ex.this.old >= -2),
                    ex.this.old,
                    ex.this.new,
                ),
            )
            .with_id_from(ex.this.vid)
        )
        return {"ranks": new_ranks}

    init = vertices.select(vid=vertices.vid, rank=scale).with_id_from(
        ex.this.vid
    )
    result = iterate(lambda ranks: step(ranks), iteration_limit=steps, ranks=init)
    return result.select(
        vid=result.vid, rank=result.rank / scale
    ).with_id_from(ex.this.vid)


def bellman_ford(vertices: Table, edges: Table) -> Table:
    """Shortest paths from rows with is_source=True.

    vertices: (is_source: bool); edges: (u: Pointer, v: Pointer, dist: float).
    Returns (dist: float) keyed like vertices.
    (reference: stdlib/graphs/bellman_ford/impl.py)
    """
    INF = float("inf")
    # the vertex key rides as an explicit column (vid) and with_id(vid)
    # pins every round back onto the vertex universe. The previous shape
    # (join_left on the STATE placeholder's id + per-round reindex of the
    # relaxation table) never converged inside the iterate scope; joining
    # on a carried key column with a direct pointer re-key is the
    # fixpoint-stable formulation (louvain's delta application works the
    # same way).
    init = vertices.select(
        vid=vertices.id, dist=if_else(vertices.is_source, 0.0, INF)
    )

    def step(state: Table) -> dict[str, Table]:
        relaxed = (
            edges.join(state, edges.u == state.vid)
            .select(v=ex.left.v, cand=ex.right.dist + ex.left.dist)
        )
        best = relaxed.groupby(relaxed.v).reduce(
            v=relaxed.v, cand=red.min(relaxed.cand)
        )
        new_state = (
            state.join_left(best, state.vid == best.v)
            .select(
                vid=ex.left.vid,
                dist=if_else(
                    coalesce(ex.right.cand, INF) < ex.left.dist,
                    coalesce(ex.right.cand, INF),
                    ex.left.dist,
                ),
            )
            .with_id(ex.this.vid)
        )
        return {"state": new_state}

    result = iterate(lambda state: step(state), state=init)
    return result.without("vid")


def connected_components(edges: Table) -> Table:
    """Connected components over undirected edges(u: Pointer, v: Pointer)
    -> (vid: Pointer, rep: Pointer) keyed by vertex: every vertex labeled
    with its component's representative (the minimum vertex pointer in
    the 128-bit key order). Min-label propagation via pw.iterate
    (docs/iterate.md): an edge update re-converges from the previous
    fixpoint in O(affected), like pagerank.
    """
    # undirected closure: propagate along both directions of each edge
    fwd = edges.select(a=edges.u, b=edges.v)
    bwd = edges.select(a=edges.v, b=edges.u)
    arcs = fwd.concat_reindex(bwd)
    vertices = (
        arcs.groupby(arcs.a).reduce(vid=arcs.a)
        .concat_reindex(arcs.groupby(arcs.b).reduce(vid=arcs.b))
        .groupby(ex.this.vid)
        .reduce(vid=ex.this.vid)
    )

    def step(labels: Table) -> dict[str, Table]:
        # candidate label for b = label(a) along each arc; keep the min
        # of (own label, neighbor candidates) per vertex
        cand = (
            arcs.join(labels, arcs.a == labels.vid)
            .select(vid=ex.left.b, lab=ex.right.lab)
            .concat_reindex(labels.select(vid=labels.vid, lab=labels.lab))
        )
        best = cand.groupby(cand.vid).reduce(
            vid=cand.vid, lab=red.min(cand.lab)
        )
        return {"labels": best.with_id_from(ex.this.vid)}

    init = vertices.select(
        vid=vertices.vid, lab=vertices.vid
    ).with_id_from(ex.this.vid)
    labels = iterate(lambda labels: step(labels), labels=init)
    return labels.select(vid=labels.vid, rep=labels.lab).with_id_from(
        ex.this.vid
    )


def _with_weight(E: Table) -> Table:
    """Edges with a weight column (default 1.0 — unweighted graphs)."""
    if "weight" not in E._column_names():
        E = E.with_columns(weight=1.0)
    return E


def louvain_level(
    G: Graph, iteration_limit: int | None = None
) -> Table:
    """One Louvain level: vertices move between communities while the
    modularity gain is strictly positive; a per-round random-priority
    independent set makes parallel moves safe (no community participates
    in two movements in one round). Returns a clustering keyed like the
    vertex set with column `c` (community id, Pointer).

    Edge convention matches the reference: directed edge rows, an
    undirected edge {u, v} appears as both (u, v) and (v, u)
    (reference: stdlib/graphs/louvain_communities/impl.py:_louvain_level,
    _one_step, _propose_clusters; gain = 2*deg(v in C') -
    deg(v)*(2*deg(C') + deg(v))/m, evaluated per adjacent community and
    for staying put with the vertex's own degree removed).
    """
    from pathway_tpu_torch.internals.common import apply_with_type
    from pathway_tpu_torch.internals.keys import key_for_values

    E = _with_weight(G.E)
    V = G.V
    total = E.reduce(m=red.sum(E.weight)).with_id_from(0)
    init = V.select(c=V.pointer_from(V.id))

    def step(clustering: Table) -> dict[str, Table]:
        cl = clustering
        # endpoint communities (two key-joins over the clustering)
        e2 = E.join(cl, E.u == cl.id).select(
            u=ex.left.u, v=ex.left.v, weight=ex.left.weight, cu=ex.right.c
        )
        e3 = e2.join(cl, e2.v == cl.id).select(
            u=ex.left.u, v=ex.left.v, weight=ex.left.weight,
            cu=ex.left.cu, vc=ex.right.c,
        )
        # vertex degrees (self loops included, as in the reference);
        # isolated vertices get 0.0 via the placeholder leg
        vdeg0 = cl.select(u=ex.this.id, deg=0.0).with_id(ex.this.u)
        vdeg = vdeg0.update_rows(
            e3.groupby(e3.u)
            .reduce(u=e3.u, deg=red.sum(e3.weight))
            .with_id(ex.this.u)
        )
        # community degree sums deg(C); empty communities get 0.0
        cdeg0 = (
            cl.groupby(cl.c).reduce(cu=cl.c).with_columns(cdeg=0.0)
            .with_id(ex.this.cu)
        )
        cdeg = cdeg0.update_rows(
            e2.groupby(e2.cu)
            .reduce(cu=e2.cu, cdeg=red.sum(e2.weight))
            .with_id(ex.this.cu)
        )
        # vertex -> adjacent-community weights; the zero-weight
        # placeholder row per vertex guarantees a "stay" candidate even
        # when v has no edge into its own community
        nl = e3.filter(e3.u != e3.v)
        vc_edges = nl.select(nl.u, nl.vc, nl.weight).concat_reindex(
            cl.select(u=ex.this.id, vc=ex.this.c, weight=0.0)
        )
        gw = vc_edges.groupby(vc_edges.u, vc_edges.vc).reduce(
            u=vc_edges.u, vc=vc_edges.vc, gw=red.sum(vc_edges.weight)
        )
        g2 = gw.join(vdeg, gw.u == vdeg.id).select(
            u=ex.left.u, vc=ex.left.vc, gw=ex.left.gw, deg=ex.right.deg
        )
        g3 = g2.join(cdeg, g2.vc == cdeg.id).select(
            u=ex.left.u, vc=ex.left.vc, gw=ex.left.gw, deg=ex.left.deg,
            cdeg=ex.right.cdeg,
        )
        g4 = g3.join(cl, g3.u == cl.id).select(
            u=ex.left.u, vc=ex.left.vc, gw=ex.left.gw, deg=ex.left.deg,
            cdeg=ex.left.cdeg, cu=ex.right.c,
        )
        g4p = g4.with_columns(_mp=g4.pointer_from(0))
        gains = g4p.select(
            g4p.u, g4p.vc, g4p.cu,
            gain=2.0 * g4p.gw
            - g4p.deg
            * (
                2.0 * if_else(g4p.vc == g4p.cu, g4p.cdeg - g4p.deg, g4p.cdeg)
                + g4p.deg
            )
            / total.ix(g4p._mp).m,
        )
        best = gains.groupby(gains.u).reduce(
            u=gains.u,
            gain=red.max(gains.gain),
            # argmax payload form: the community of the max-gain row
            # (ties break to the smallest community pointer)
            vc=red.ReducerExpression(
                red.ArgMaxReducer(), gains.gain, gains.vc
            ),
        )
        stay = gains.filter(gains.vc == gains.cu)
        # strict improvement only: equal-gain moves would oscillate
        cand = (
            best.join(stay, best.u == stay.u)
            .select(
                u=ex.left.u, vc=ex.left.vc, gain=ex.left.gain,
                sgain=ex.right.gain, cu=ex.right.cu,
            )
            .filter(ex.this.gain > ex.this.sgain)
        )
        # independent set over the community graph: only the max-priority
        # move touching each community executes this round
        cand = cand.with_columns(
            r=apply_with_type(
                lambda a, b: key_for_values(a, b).value & ((1 << 63) - 1),
                int, ex.this.u, ex.this.vc,
            )
        )
        pris = cand.select(c=cand.cu, r=cand.r).concat_reindex(
            cand.select(c=cand.vc, r=cand.r)
        )
        cmax = pris.groupby(pris.c).reduce(c=pris.c, rmax=red.max(pris.r))
        w1 = cand.join(cmax, cand.cu == cmax.c).select(
            u=ex.left.u, vc=ex.left.vc, r=ex.left.r, rmax_u=ex.right.rmax
        )
        w2 = w1.join(cmax, w1.vc == cmax.c).select(
            u=ex.left.u, vc=ex.left.vc, r=ex.left.r,
            rmax_u=ex.left.rmax_u, rmax_v=ex.right.rmax,
        )
        winners = w2.filter(
            (w2.r == w2.rmax_u) & (w2.r == w2.rmax_v)
        )
        delta = (
            winners.select(u=winners.u, c=winners.vc)
            .with_id(ex.this.u)
            .without("u")
        )
        return {"clustering": cl.update_rows(delta)}

    return iterate(
        lambda clustering: step(clustering),
        iteration_limit=iteration_limit,
        clustering=init,
    )


def louvain_communities(
    G: Graph, levels: int = 1, iteration_limit: int | None = None
) -> Table:
    """Louvain community detection: `levels` rounds of one-level moves +
    community-graph contraction. Returns a table keyed like G.V with
    column `c` — each vertex's community at the final level (reference:
    louvain_communities/impl.py louvain_communities_fixed_iterations +
    contracted_to_weighted_simple_graph)."""
    if levels < 1:
        raise ValueError(f"louvain_communities: levels must be >= 1, got {levels}")
    V, E = G.V, _with_weight(G.E)
    mapping: Table | None = None
    for _lvl in range(levels):
        cl = louvain_level(Graph(V, E), iteration_limit=iteration_limit)
        if mapping is None:
            mapping = cl
        else:
            mapping = mapping.join(
                cl, mapping.c == cl.id, id=ex.left.id
            ).select(c=ex.right.c)
        # contract: communities become vertices, parallel edges merge
        eu = E.join(cl, E.u == cl.id).select(
            cu=ex.right.c, v=ex.left.v, weight=ex.left.weight
        )
        euv = eu.join(cl, eu.v == cl.id).select(
            u=ex.left.cu, v=ex.right.c, weight=ex.left.weight
        )
        E = euv.groupby(euv.u, euv.v).reduce(
            u=euv.u, v=euv.v, weight=red.sum(euv.weight)
        )
        V = cl.groupby(cl.c).reduce(cid=cl.c).with_id(ex.this.cid)
    return mapping


def exact_modularity(G: Graph, C: Table, round_digits: int = 16) -> Table:
    """Modularity of clustering C over G: sum over communities of
    (internal*m - deg^2) / m^2, rounded to `round_digits` (reference:
    louvain_communities/impl.py exact_modularity — a testing helper; the
    exact global sum creates long dependency chains on live streams)."""
    from pathway_tpu_torch.internals.common import apply_with_type

    E = _with_weight(G.E)
    total = E.reduce(m=red.sum(E.weight)).with_id_from(0)
    eu = E.join(C, E.u == C.id).select(
        weight=ex.left.weight, cu=ex.right.c, v=ex.left.v
    )
    euv = eu.join(C, eu.v == C.id).select(
        weight=ex.left.weight, cu=ex.left.cu, cv=ex.right.c
    )
    cdeg = eu.groupby(eu.cu).reduce(cu=eu.cu, deg=red.sum(eu.weight))
    cint = (
        euv.filter(euv.cu == euv.cv)
        .groupby(ex.this.cu)
        .reduce(cu=ex.this.cu, internal=red.sum(ex.this.weight))
    )
    per = cdeg.join_left(cint, cdeg.cu == cint.cu).select(
        deg=ex.left.deg, internal=coalesce(ex.right.internal, 0.0)
    )
    perp = per.with_columns(_mp=per.pointer_from(0))
    scored = perp.select(
        part=(
            perp.internal * total.ix(perp._mp).m - perp.deg * perp.deg
        )
        / (total.ix(perp._mp).m * total.ix(perp._mp).m)
    )
    out = scored.reduce(modularity=red.sum(scored.part))
    return out.select(
        modularity=apply_with_type(
            lambda x: round(x, round_digits), float, ex.this.modularity
        )
    )
