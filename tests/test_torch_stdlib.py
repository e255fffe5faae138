"""The port's stdlib (`pw.graphs`, `pw.ml`, `pw.stateful`, `pw.statistical`,
`pw.viz`) against the JAX package's.

Each case builds the same pipeline on ``import pathway_tpu as pw`` and on
``import pathway_tpu_torch as pw`` in one process (fresh parse graphs,
aligned row-id counters), on the inputs of the reference tests
(tests/test_graphs.py, the graph cases of tests/test_iterate_native.py,
tests/test_ml.py, tests/test_stateful_matrix.py and the viz cases of
tests/test_stdlib_utils.py). The two update streams and final states must
be byte-identical: every value is compared by type and ``repr`` (a pointer
by its 128-bit value, an array by dtype, shape and bytes). Each case also
keeps the reference test's own assertion, on the port's output.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu.internals.keys as jkeys
import pathway_tpu_torch as tpw
import pathway_tpu_torch.internals.keys as tkeys
from pathway_tpu.internals.lowering import Session as JaxSession
from pathway_tpu.internals.parse_graph import G as JAX_G
from pathway_tpu_torch.internals.lowering import Session as PortSession
from pathway_tpu_torch.internals.parse_graph import G as PORT_G
from tests.test_torch_parity import align_row_ids

SESSIONS = {jpw: JaxSession, tpw: PortSession}


@pytest.fixture(autouse=True)
def _clear_graphs():
    JAX_G.clear()
    PORT_G.clear()
    yield
    JAX_G.clear()
    PORT_G.clear()


def canon(v):
    """A package-independent, exact form of one engine value."""
    if type(v).__name__ == "Key":
        return ("key", v.value)
    if isinstance(v, (tuple, list)):
        return (type(v).__name__, tuple(canon(x) for x in v))
    if isinstance(v, np.ndarray):
        return ("ndarray", str(v.dtype), v.shape, v.tobytes())
    return (type(v).__name__, repr(v))


def capture(pw, table):
    session = SESSIONS[pw]()
    cap = session.capture(table)
    session.execute()
    return cap


def form(pw, table) -> tuple[list, list]:
    """The whole update stream and the final state, sorted, in exact form."""
    cap = capture(pw, table)
    stream = sorted((t, k.value, canon(row), d) for (t, k, row, d) in cap.stream)
    state = sorted((k.value, canon(row)) for k, row in cap.state.rows.items())
    return stream, state


def _row_ids_from(start: int) -> None:
    with jkeys._seq_lock, tkeys._seq_lock:
        jkeys._seq_next = tkeys._seq_next = start


def both(build):
    """`build(pw)` on the JAX package, then on the port, each on a fresh
    parse graph with both row-id counters at the same start; returns the
    two results."""
    align_row_ids()
    start = jkeys._seq_next
    out = []
    for pw, graph in ((jpw, JAX_G), (tpw, PORT_G)):
        graph.clear()
        _row_ids_from(start)
        out.append(build(pw))
        graph.clear()
    align_row_ids()
    return out


def rows_of(pw, table) -> list:
    return [tuple(r) for r in capture(pw, table).state.rows.values()]


# ------------------------------------------------------------ the surface


PUBLIC = {
    "graphs": ["Graph", "bellman_ford", "connected_components", "exact_modularity", "louvain_communities",
               "louvain_level", "pagerank"],
    "ml": ["classifiers", "hmm", "index", "smart_table_ops", "utils"],
    "stateful": ["deduplicate"],
    "statistical": ["InterpolateMode", "interpolate"],
    "viz": ["PlotHandle", "TableView", "plot", "show"],
}


@pytest.mark.parametrize("name", sorted(PUBLIC))
def test_stdlib_modules_exist_with_the_reference_public_names(name):
    ref, port = getattr(jpw, name), getattr(tpw, name)
    assert port.__name__ == f"pathway_tpu_torch.stdlib.{name}"
    public = sorted(n for n in dir(ref) if not n.startswith("_") and not isinstance(getattr(ref, n), type(np)))
    assert sorted(n for n in dir(port) if not n.startswith("_") and not isinstance(getattr(port, n), type(np))) \
        == public
    assert set(PUBLIC[name]) <= set(dir(port))
    assert getattr(ref, "__all__", None) == getattr(port, "__all__", None)
    assert getattr(jpw.stdlib, name) is ref and getattr(tpw.stdlib, name) is port


# ------------------------------------------------------------ pw.graphs
# tests/test_graphs.py


def _graph(pw, n_vertices: int, und_edges, weights=None):
    rows = []
    for i, (u, v) in enumerate(und_edges):
        w = 1.0 if weights is None else float(weights[i])
        rows.append((u, v, w))
        rows.append((v, u, w))
    vt = pw.debug.table_from_rows(pw.schema_from_types(vid=int), [(i,) for i in range(n_vertices)]) \
        .with_id_from(pw.this.vid)
    et = pw.debug.table_from_rows(pw.schema_from_types(us=int, vs=int, weight=float), rows)
    et = et.select(u=vt.pointer_from(pw.this.us), v=vt.pointer_from(pw.this.vs), weight=pw.this.weight)
    return pw.graphs.Graph(vt, et), vt


def _communities(pw, cl, vt) -> list:
    _ids, cols = pw.debug.table_to_dicts(cl.join(vt, cl.id == vt.id).select(vid=pw.right.vid, c=pw.left.c))
    groups: dict = {}
    for k in cols["vid"]:
        groups.setdefault(cols["c"][k], set()).add(cols["vid"][k])
    return sorted(sorted(g) for g in groups.values())


def _modularity(pw, g, cl) -> float:
    _ids, cols = pw.debug.table_to_dicts(pw.graphs.exact_modularity(g, cl, round_digits=9))
    return next(iter(cols["modularity"].values()))


TWO_TRIANGLES = (6, [(0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (3, 5), (2, 3)], None)
WEIGHTED_PULL = (5, [(0, 1), (2, 3), (0, 3), (4, 0), (4, 3)], [5.0, 5.0, 15.0, 0.5, 0.5])
LOCAL_MAX = (6, [(0, 1), (1, 2), (0, 2), (2, 3), (3, 4), (4, 5), (3, 5), (1, 4)], None)
_RING = [e for t in range(4) for e in ((3 * t, 3 * t + 1), (3 * t + 1, 3 * t + 2), (3 * t, 3 * t + 2))]
TRIANGLE_RING = (12, _RING + [(2, 3), (5, 6), (8, 9), (11, 0)], None)


@pytest.mark.parametrize("case", ["two_triangles", "weighted_pull", "local_max"])
def test_louvain_level_matches_the_jax_package(case):
    n, und, weights = {"two_triangles": TWO_TRIANGLES, "weighted_pull": WEIGHTED_PULL, "local_max": LOCAL_MAX}[case]

    def build(pw):
        g, vt = _graph(pw, n, und, weights)
        cl = pw.graphs.louvain_level(g)
        return form(pw, cl), _communities(pw, cl, vt), _modularity(pw, g, cl)

    want, got = both(build)
    assert got == want
    _form, groups, modularity = got
    if case == "two_triangles":
        assert groups == [[0, 1, 2], [3, 4, 5]]
        assert modularity == pytest.approx(2 * (6 * 14 - 49) / 14**2)
    elif case == "weighted_pull":
        assert 3 in next(g for g in groups if 0 in g)
    else:
        # no single-vertex move improves modularity (the level's property)
        assign = {v: i for i, grp in enumerate(groups) for v in grp}
        edges = [(u, v) for u, v in und] + [(v, u) for u, v in und]
        m = float(len(edges))

        def mod(a: dict) -> float:
            internal: dict = {}
            deg: dict = {}
            for u, v in edges:
                deg[a[u]] = deg.get(a[u], 0.0) + 1.0
                if a[u] == a[v]:
                    internal[a[u]] = internal.get(a[u], 0.0) + 1.0
            return sum((internal.get(c, 0.0) * m - d * d) / (m * m) for c, d in deg.items())

        assert mod(assign) == pytest.approx(modularity)
        for vid, c_new in itertools.product(assign, set(assign.values())):
            if assign[vid] != c_new:
                assert mod({**assign, vid: c_new}) <= modularity + 1e-9, (vid, c_new)


def test_louvain_communities_two_levels_match_the_jax_package():
    n, und, _w = TRIANGLE_RING

    def build(pw):
        g, vt = _graph(pw, n, und)
        cl1 = pw.graphs.louvain_communities(g, levels=1)
        cl2 = pw.graphs.louvain_communities(g, levels=2)
        return form(pw, cl1), form(pw, cl2), _communities(pw, cl1, vt), _communities(pw, cl2, vt)

    want, got = both(build)
    assert got == want
    g1, g2 = got[2], got[3]
    assert [0, 1, 2] in g1 and [3, 4, 5] in g1
    for grp in g1:
        assert len([h for h in g2 if set(grp) <= set(h)]) == 1, (grp, g2)


def test_exact_modularity_singletons_match_the_jax_package():
    def build(pw):
        g, _vt = _graph(pw, 4, [(0, 1), (2, 3)])
        singles = g.V.select(c=g.V.pointer_from(g.V.id))
        return form(pw, pw.graphs.exact_modularity(g, singles)), _modularity(pw, g, singles)

    want, got = both(build)
    assert got == want
    assert got[1] == pytest.approx(-0.25)


# tests/test_iterate_native.py: the four algorithms on a stream with an
# update wave, through the token-resident iterate and the object plumbing


def _edges_md() -> str:
    lines = ["u | w | __time__ | __diff__"]
    lines += [f"a{i} | a{(i + 1) % 12} | 2 | 1" for i in range(12)]
    lines += ["b0 | b1 | 2 | 1", "b1 | b2 | 2 | 1", "b2 | b0 | 4 | 1"]
    return "\n".join(lines)


def _edges_table(pw):
    t = pw.debug.table_from_markdown(_edges_md()).with_id_from(pw.this.u, pw.this.w)
    return t.select(u=t.u, v=t.w)


def _algo(pw, name: str):
    if name == "pagerank":
        return pw.graphs.pagerank(_edges_table(pw), steps=200)
    if name == "bellman_ford":
        v = pw.debug.table_from_markdown(
            """
            vid | is_source | __time__ | __diff__
            s   | True      | 2        | 1
            m   | False     | 2        | 1
            t   | False     | 2        | 1
            u   | False     | 4        | 1
            """
        ).with_id_from(pw.this.vid)
        e = pw.debug.table_from_markdown(
            """
            a | b | dist | __time__ | __diff__
            s | m | 1.0  | 2        | 1
            m | t | 2.0  | 2        | 1
            s | t | 9.0  | 2        | 1
            m | u | 1.5  | 4        | 1
            """
        )
        e2 = e.select(u=e.pointer_from(e.a), v=e.pointer_from(e.b), dist=e.dist)
        return pw.graphs.bellman_ford(v.select(is_source=v.is_source), e2)
    if name == "connected_components":
        return pw.graphs.connected_components(_edges_table(pw))
    pairs = [("a", "b", 2), ("b", "c", 2), ("a", "c", 2), ("c", "d", 4), ("d", "e", 2), ("e", "f", 2), ("d", "f", 2)]
    md = "u | w | weight | __time__ | __diff__\n" + "\n".join(
        f"{x} | {y} | 1.0 | {t} | 1\n{y} | {x} | 1.0 | {t} | 1" for x, y, t in pairs
    )
    e = pw.debug.table_from_markdown(md).with_id_from(pw.this.u, pw.this.w)
    ids = e.select(x=e.u).concat_reindex(e.select(x=e.w))
    v = ids.groupby(ids.x).reduce(vid=ids.x).with_id_from(pw.this.vid)
    e2 = e.select(u=v.pointer_from(e.u), v=v.pointer_from(e.w), weight=e.weight)
    return pw.graphs.louvain_level(pw.graphs.Graph(v, e2), iteration_limit=40)


@pytest.mark.parametrize("iterate_native", ["1", "0"])
@pytest.mark.parametrize("algo", ["pagerank", "bellman_ford", "connected_components", "louvain"])
def test_graph_algorithms_match_the_jax_package(algo, iterate_native, monkeypatch):
    """Whole update streams and final states, byte-identical, with the
    token-resident iterate on and with its kill switch thrown."""
    monkeypatch.setenv("PATHWAY_ITERATE_NATIVE", iterate_native)
    want, got = both(lambda pw: form(pw, _algo(pw, algo)))
    assert got == want
    assert got[1], "empty final state"


# ------------------------------------------------------------ pw.ml
# tests/test_ml.py


def _vec_table(pw, rows):
    return pw.debug.table_from_rows(
        pw.schema_from_types(data=np.ndarray, label=str),
        [(np.asarray(v, np.float32), lbl) for v, lbl in rows],
    )


def test_knn_lsh_classifier_majority_vote_matches_the_jax_package():
    rng = np.random.default_rng(0)
    points = [(rng.normal([5, 0], 0.3), "red") for _ in range(12)] + [(rng.normal([-5, 0], 0.3), "blue")
                                                                      for _ in range(12)]

    def build(pw):
        clf = pw.ml.classifiers
        data = _vec_table(pw, points)
        model = clf.knn_lsh_classifier_train(data, L=8, type="euclidean", d=2, M=4, A=4.0)
        queries = pw.debug.table_from_rows(
            pw.schema_from_types(data=np.ndarray),
            [(np.asarray([4.5, 0.2], np.float32),), (np.asarray([-4.4, -0.3], np.float32),)],
        )
        return form(pw, clf.knn_lsh_classify(model, data, queries, k=5))

    want, got = both(build)
    assert got == want
    assert sorted(row[1][0][1] for _k, row in got[1]) == ["'blue'", "'red'"]


def test_classifier_accuracy_matches_the_jax_package():
    def build(pw):
        exact = pw.debug.table_from_markdown(
            """
            uid | label
            1   | red
            2   | blue
            3   | red
            """
        ).with_id_from(pw.this.uid)
        predicted = exact.select(predicted_label=pw.if_else(pw.this.label == "blue", "red", pw.this.label))
        acc = pw.ml.utils.classifier_accuracy(predicted, exact)
        return form(pw, acc), {tuple(r) for r in rows_of(pw, acc)}

    want, got = both(build)
    assert got == want
    assert got[1] == {(2, True), (1, False)}


def _texts(pw, col: str, texts: list[str]):
    return pw.debug.table_from_rows(pw.schema_from_types(**{col: str}), [(t,) for t in texts]) \
        .with_id_from(pw.this[col])


def _pairs(pw, matches, left, right) -> set:
    lmap = {k: r[0] for k, r in capture(pw, left).state.rows.items()}
    rmap = {k: r[0] for k, r in capture(pw, right).state.rows.items()}
    return {(lmap[r[0]], rmap[r[1]]) for r in rows_of(pw, matches)}


def test_fuzzy_match_tables_one_to_one_matches_the_jax_package():
    def build(pw):
        left = _texts(pw, "name", ["apache kafka streaming", "jax tpu compiler", "postgres database"])
        right = _texts(pw, "title", ["the kafka streaming platform", "a database called postgres",
                                     "compiler stack for tpu jax", "totally unrelated entry zzz"])
        matches = pw.ml.smart_table_ops.fuzzy_match_tables(left, right)
        return form(pw, matches), _pairs(pw, matches, left, right)

    want, got = both(build)
    assert got == want
    assert got[1] == {
        ("apache kafka streaming", "the kafka streaming platform"),
        ("jax tpu compiler", "compiler stack for tpu jax"),
        ("postgres database", "a database called postgres"),
    }


def test_fuzzy_self_match_matches_the_jax_package():
    def build(pw):
        t = _texts(pw, "name", ["green apple pie", "apple pie green", "zebra crossing", "crossing zebra"])
        matches = pw.ml.smart_table_ops.fuzzy_self_match(t)
        return form(pw, matches), {frozenset(p) for p in _pairs(pw, matches, t, t)}

    want, got = both(build)
    assert got == want
    assert got[1] == {frozenset(("green apple pie", "apple pie green")),
                      frozenset(("zebra crossing", "crossing zebra"))}


def test_fuzzy_match_with_hint_matches_the_jax_package():
    def build(pw):
        left = _texts(pw, "name", ["kafka streaming", "postgres database"])
        right = _texts(pw, "title", ["kafka platform", "postgres store"])
        lids = {r[0]: k for k, r in capture(pw, left).state.rows.items()}
        rids = {r[0]: k for k, r in capture(pw, right).state.rows.items()}
        hint = pw.debug.table_from_rows(
            pw.schema_from_types(left=pw.Pointer, right=pw.Pointer, weight=float),
            [(lids["kafka streaming"], rids["postgres store"], 99.0)],
        )
        matches = pw.ml.smart_table_ops.fuzzy_match_tables(left, right, by_hand_match=hint)
        return form(pw, matches), _pairs(pw, matches, left, right)

    want, got = both(build)
    assert got == want
    pairs = got[1]
    assert len({a for a, _b in pairs}) == len(pairs) == len({b for _a, b in pairs})
    assert ("kafka streaming", "postgres store") in pairs


def test_hmm_reducer_decodes_like_the_jax_package():
    import networkx as nx

    def emission(state):
        def log_ppb(obs):
            good = {"HUNGRY": "GRUMPY", "FULL": "HAPPY"}[state]
            return np.log(0.9 if obs == good else 0.1)

        return log_ppb

    g = nx.DiGraph()
    for i, s in enumerate(["HUNGRY", "FULL"]):
        g.add_node(s, idx=i, calc_emission_log_ppb=emission(s))
    for a in ("HUNGRY", "FULL"):
        for b in ("HUNGRY", "FULL"):
            g.add_edge(a, b, log_transition_ppb=np.log(0.7 if a == b else 0.3))
    g.graph["start_nodes"] = ["HUNGRY", "FULL"]

    def build(pw):
        red = pw.ml.hmm.create_hmm_reducer(g)
        out = []
        for seq in (["HAPPY", "HAPPY", "GRUMPY", "GRUMPY"], ["HAPPY", "GRUMPY", "GRUMPY", "HAPPY"]):
            obs = pw.debug.table_from_markdown(
                "observation | __time__\n" + "\n".join(f"{o} | {2 * (i + 1)}" for i, o in enumerate(seq))
            )
            decoded = obs.reduce(path=red(pw.this.observation))
            out.append((form(pw, decoded), [r[0] for r in rows_of(pw, decoded)]))
        return out

    want, got = both(build)
    assert got == want
    assert got[0][1] == [("FULL", "FULL", "HUNGRY", "HUNGRY")]
    assert got[1][1] == [("FULL", "HUNGRY", "HUNGRY", "FULL")]


def test_knn_lsh_generic_classifier_matches_the_jax_package():
    rng = np.random.default_rng(0)
    rows = []
    for i in range(20):
        center = np.array([4.0, 4.0]) if i % 2 else np.array([-4.0, -4.0])
        rows.append((center + rng.normal(scale=0.5, size=2), i % 2))

    def build(pw):
        calls = {"proj": 0, "dist": 0}

        def proj(vec):
            calls["proj"] += 1
            return [(int(vec[0] > 0),), (int(vec[1] > 0),)]

        def l1(q, d):
            calls["dist"] += 1
            return float(np.abs(q - d).sum())

        clf = pw.ml.classifiers
        both_t = pw.debug.table_from_rows(pw.schema_from_types(data=np.ndarray, label=int), rows)
        queries = pw.debug.table_from_rows(
            pw.schema_from_types(data=np.ndarray), [(np.array([3.5, 3.9]),), (np.array([-3.2, -4.4]),)]
        )
        model = clf.knn_lsh_generic_classifier_train(both_t.select(both_t.data), lsh_projection=proj,
                                                     distance_function=l1, L=2)
        result = clf.knn_lsh_classify(model, both_t.select(both_t.label), queries, k=5)
        _ids, cols = pw.debug.table_to_dicts(result)
        return form(pw, result), list(cols["predicted_label"].values()), calls["proj"] > 0 and calls["dist"] > 0

    want, got = both(build)
    assert got == want
    assert got[1] == [1, 0] and got[2]


@pytest.mark.parametrize("distance_type", ["euclidean", "cosine"])
def test_knn_index_on_a_cpu_slab_matches_the_jax_package(distance_type):
    """`pw.ml.index.KNNIndex` over the port's slab with ``device="cpu"``
    (the default is the card) returns the JAX package's neighbours, in
    order, as of each query; distances within bf16 rounding of the
    mirror's scores."""
    rng = np.random.default_rng(3)
    docs = rng.normal(size=(48, 16)).astype(np.float32)
    queries = docs[[3, 17, 40]] + rng.normal(scale=0.01, size=(3, 16)).astype(np.float32)

    def build(pw):
        data = pw.debug.table_from_rows(pw.schema_from_types(doc=int, vec=np.ndarray),
                                        [(i, v) for i, v in enumerate(docs)])
        qs = pw.debug.table_from_rows(pw.schema_from_types(q=int, qvec=np.ndarray),
                                      [(i, v) for i, v in enumerate(queries)])
        kw = {"device": "cpu"} if pw is tpw else {}
        index = pw.ml.index.KNNIndex(data.vec, data, n_dimensions=16, distance_type=distance_type, **kw)
        res = index.get_nearest_items(qs.qvec, k=5, with_distances=True)
        joined = res.join(qs, res.id == qs.id).select(q=pw.right.q, doc=pw.left.doc, dist=pw.left.dist)
        return {r[0]: (tuple(r[1]), tuple(r[2])) for r in rows_of(pw, joined)}

    want, got = both(build)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for q in want:
        assert got[q][0] == want[q][0], q
        assert got[q][0][0] == [3, 17, 40][q]
        np.testing.assert_allclose(got[q][1], want[q][1], rtol=2e-2, atol=2e-2)


def test_knn_index_defaults_to_the_card():
    """Without ``device`` the slab is on the card, so with no card the
    first query raises instead of falling back to the CPU."""
    from pathway_tpu_torch.stdlib.ml.index import KNNIndex

    data = tpw.debug.table_from_rows(tpw.schema_from_types(vec=np.ndarray), [(np.ones(4, np.float32),)])
    qs = tpw.debug.table_from_rows(tpw.schema_from_types(qvec=np.ndarray), [(np.ones(4, np.float32),)])
    res = KNNIndex(data.vec, data, n_dimensions=4).get_nearest_items(qs.qvec, k=1)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capture(tpw, res)


# ------------------------------------------------- pw.stateful, pw.statistical
# tests/test_stateful_matrix.py


def test_interpolate_matches_the_jax_package():
    def build(pw):
        t = pw.debug.table_from_rows(
            pw.schema_from_types(t=int, v=float | None), [(0, 10.0), (1, None), (2, 30.0), (3, None), (4, 50.0)]
        )
        res = pw.statistical.interpolate(t, t.t, t.v)
        return form(pw, res), {r[0]: r[1] for r in rows_of(pw, res)}

    want, got = both(build)
    assert got == want
    by_t = got[1]
    assert (by_t[0], by_t[2], by_t[4]) == (10.0, 30.0, 50.0)
    assert by_t[1] == pytest.approx(20.0) and by_t[3] == pytest.approx(40.0)


@pytest.mark.parametrize("via", ["table_method", "pw_stateful"])
def test_deduplicate_acceptor_matches_the_jax_package(via):
    def build(pw):
        t = pw.debug.table_from_markdown(
            """
            v  | __time__
            1  | 2
            2  | 4
            4  | 6
            5  | 8
            10 | 10
            """
        )

        def acceptor(new, old):
            return new - old >= 2

        if via == "table_method":
            res = t.deduplicate(value=pw.this.v, acceptor=acceptor)
        else:
            res = pw.stateful.deduplicate(t, col=t.v, acceptor=acceptor)
        return form(pw, res), [r[0] for r in rows_of(pw, res)]

    want, got = both(build)
    assert got == want
    assert got[1] == [10]


@pytest.mark.parametrize("via", ["table_method", "pw_stateful"])
def test_deduplicate_instances_match_the_jax_package(via):
    def build(pw):
        t = pw.debug.table_from_markdown(
            """
            g | v | __time__
            a | 1 | 2
            b | 9 | 2
            a | 3 | 4
            b | 2 | 4
            """
        )

        def acceptor(new, old):
            return new > old

        if via == "table_method":
            res = t.deduplicate(value=pw.this.v, instance=pw.this.g, acceptor=acceptor)
        else:
            res = pw.stateful.deduplicate(t, col=t.v, instance=t.g, acceptor=acceptor)
        return form(pw, res), {r[0]: r[1] for r in rows_of(pw, res)}

    want, got = both(build)
    assert got == want
    assert got[1] == {"a": 3, "b": 9}


# ------------------------------------------------------------ pw.viz
# tests/test_stdlib_utils.py


def _nums(pw):
    return pw.debug.table_from_markdown(
        """
        colA | colB
        1    | 10
        2    | 20
        3    | 30
        """
    )


def test_show_renders_the_jax_package_html_without_bokeh():
    def build(pw):
        t = _nums(pw)
        view = t.show()
        return view._repr_html_(), repr(view), t._repr_html_()

    want, got = both(build)
    assert got == want
    html, rep, table_html = got
    assert "<table>" in html and "colA" in html and "30" in html
    assert "TableView(3 rows" in rep and "<table>" in table_html


def test_plot_raises_the_jax_package_import_error_without_bokeh():
    errors = []
    for pw in (jpw, tpw):
        with pytest.raises(ImportError, match="bokeh") as info:
            _nums(pw).plot(lambda src: src)
        errors.append(str(info.value))
    assert errors[1] == errors[0]


def test_show_live_view_on_a_stream():
    import time

    t = tpw.demo.range_stream(nb_rows=5, input_rate=200)
    view = t.show(snapshot=False)
    try:
        deadline = time.time() + 15
        while time.time() < deadline:
            if "live view" in view._repr_html_() and view._snapshot()[1]:
                break
            time.sleep(0.1)
        assert view._snapshot()[1], "live view never saw data"
    finally:
        view.stop()


def test_streaming_table_show_never_blocks():
    t = tpw.demo.range_stream(nb_rows=3, input_rate=100)
    assert "streaming table" in t._repr_html_()
    view = t.show()
    try:
        assert view._static is None
    finally:
        view.stop()
