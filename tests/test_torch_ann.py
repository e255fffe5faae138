"""The port's approximate tier (IVF-PQ search, the incremental index, the
batched reranker and the two-stage wrapper) against the JAX package.

Inputs come from numpy seeds and go through both packages in one process,
on the CPU, at small sizes (a few thousand rows, d 32). Training is seeded
numpy in both, so the trained arrays must be byte-equal. Searches must
agree under one rule, compared after the (distance, key) re-sort: the
top-1 identical for every query, keys equal at >= 99% of ranks, and
distances within 1e-5 where the keys agree (plus 1e-6 relative for dot
and l2sq, whose distances are not bounded by 2).
"""

import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.indexing.ann import IvfPqIndex as JaxIvfPqIndex
from pathway_tpu.internals.keys import Key
from pathway_tpu.ops import ivf as jivf
from pathway_tpu.ops import rerank as jrerank
from pathway_tpu.stdlib.indexing.reranking import RerankedSlabIndex as JaxReranked
from pathway_tpu_torch.engine.device_plane import get_device_plane
from pathway_tpu_torch.indexing import IvfPqIndex, RerankedSlabIndex, ann_enabled
from pathway_tpu_torch.ops import ivf as tivf
from pathway_tpu_torch.ops import make_knn_searcher
from pathway_tpu_torch.ops.rerank import BatchedReranker, rerank_scores_host
from pathway_tpu_torch.stdlib.indexing.host_indexes import VectorSlabIndex

REPO = Path(__file__).resolve().parent.parent
DIM = 32
METRICS = ["cos", "dot", "l2sq"]


def _clustered(n: int, seed: int = 0, n_clusters: int = 40, dim: int = DIM) -> np.ndarray:
    """Mixture-of-gaussians corpus, as tests/test_ann_index.py draws it."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim))
    return (
        centers[rng.integers(0, n_clusters, n)] + 0.15 * rng.normal(size=(n, dim))
    ).astype(np.float32)


def _load(index, docs: np.ndarray, start: int = 0) -> list[Key]:
    keys = [Key(start + i) for i in range(len(docs))]
    for key, vec in zip(keys, docs):
        index.add(key, vec)
    return keys


def _exact_reference(docs: np.ndarray) -> VectorSlabIndex:
    # device=False: the true f32 ranking, not the bf16 slab mirror
    ex = VectorSlabIndex(dimensions=docs.shape[1], device=False)
    _load(ex, docs)
    return ex


def _recall_at(res, ref, k: int = 10) -> float:
    vals = []
    for a, b in zip(res, ref):
        got = {key for key, _ in a[:k]}
        want = {key for key, _ in b[:k]}
        vals.append(len(got & want) / max(len(want), 1))
    return float(np.mean(vals))


def _assert_agree(got, want, rtol: float = 0.0):
    """The parity rule of this file on two lists of [(key, dist)]."""
    assert len(got) == len(want)
    ranks = same = 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert g[0][0] == w[0][0], (g[:3], w[:3])
        for (gk, gd), (wk, wd) in zip(g, w):
            ranks += 1
            if gk == wk:
                same += 1
                np.testing.assert_allclose(gd, wd, atol=1e-5, rtol=rtol)
    assert same >= 0.99 * ranks, f"keys agree at {same} of {ranks} ranks"


def _resorted(slots: np.ndarray, dists: np.ndarray):
    """Raw (slots, dists) rows as [(slot, dist)] in (dist, slot) order,
    empty ranks dropped: the seam where tie order stops mattering."""
    out = []
    for s_row, d_row in zip(np.asarray(slots), np.asarray(dists)):
        row = [(int(s), float(d)) for s, d in zip(s_row, d_row) if s >= 0 and np.isfinite(d)]
        out.append(sorted(row, key=lambda t: (t[1], t[0])))
    return out


# ------------------------------------------------------- training + packing


@pytest.mark.parametrize("metric", METRICS)
def test_build_is_byte_equal_to_jax(metric):
    """Centroids, codebooks, codes, the balanced assignment and the packed
    cube/valid/slots: the same bytes as the JAX package's build; `full`
    the same f32 rows."""
    docs = _clustered(3000, seed=1)
    want = jivf.build_ivf_pq(docs, metric=metric, seed=3)
    got = tivf.build_ivf_pq(docs, metric=metric, seed=3, device="cpu")
    for field in ("centroids", "codes", "valid", "slots", "codebooks"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field
    assert isinstance(got.full, torch.Tensor) and got.full.dtype == torch.float32
    assert got.full.numpy().tobytes() == np.asarray(want.full).tobytes()


def test_training_steps_are_byte_equal_to_jax():
    """Each numpy step alone, on a skewed corpus whose balanced assignment
    spills past the preferred lists into the least-filled ones."""
    rng = np.random.default_rng(5)
    docs = np.concatenate([
        _clustered(1500, seed=2, n_clusters=3),
        rng.normal(size=(200, DIM)).astype(np.float32),
    ])
    for fn, args in (
        ("train_coarse_centroids", (docs, 16)),
        ("train_pq_codebooks", (docs, 8)),
    ):
        assert getattr(tivf, fn)(*args, seed=4).tobytes() == getattr(jivf, fn)(*args, seed=4).tobytes()
    cents = jivf.train_coarse_centroids(docs, 16, seed=4)
    books = jivf.train_pq_codebooks(docs, 8, seed=4)
    codes = jivf.pq_encode(docs, books)
    assert tivf.pq_encode(docs, books).tobytes() == codes.tobytes()
    assert tivf.assign_lists(docs, cents).tobytes() == jivf.assign_lists(docs, cents).tobytes()
    assign = jivf.assign_lists_balanced(docs, cents, 128)
    assert tivf.assign_lists_balanced(docs, cents, 128).tobytes() == assign.tobytes()
    assert np.bincount(assign, minlength=16).max() <= 128
    for cap in (None, 128):
        for a, b in zip(tivf.pack_lists(assign, codes, 16, cap=cap),
                        jivf.pack_lists(assign, codes, 16, cap=cap)):
            assert a.tobytes() == b.tobytes()
    assert [tivf.auto_lists(n) for n in (0, 100, 10**6, 10**9)] == [
        jivf.auto_lists(n) for n in (0, 100, 10**6, 10**9)]
    assert [tivf.auto_subvectors(d) for d in (30, 64, 384)] == [
        jivf.auto_subvectors(d) for d in (30, 64, 384)]


# ------------------------------------------------------------ the search


def _search_case(metric: str):
    docs = _clustered(4000, seed=6)
    arrays = jivf.build_ivf_pq(docs, metric=metric, seed=0, n_lists=32)
    rng = np.random.default_rng(7)
    q = (docs[rng.choice(len(docs), 24)] + 0.05 * rng.normal(size=(24, DIM))).astype(np.float32)
    return arrays._replace(full=np.asarray(arrays.full)), q


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n_live", [None, 20])
def test_search_matches_jax_and_the_numpy_oracle(metric, n_live):
    """The port's search on arrays carried across by `arrays_from_numpy`
    against the JAX program and the numpy oracle. With `n_live` < L the
    trailing lists are masked out of the probe, which the oracle sees as
    the sub-layout of the first `n_live` lists."""
    arrays, q = _search_case(metric)
    k, nprobe, cand = 10, 6, 300
    dev = tivf.arrays_from_numpy(arrays, "cpu")
    ts, td = tivf._ivf_pq_search_fn(
        torch.from_numpy(q), *dev, k=k, nprobe=nprobe, candidates=cand,
        metric=metric, n_live=n_live,
    )
    assert ts.dtype == torch.int32 and td.dtype == torch.float32 and ts.shape == (24, k)
    js, jd = jivf._ivf_pq_search_fn(
        jnp.asarray(q), *arrays, k=k, nprobe=nprobe, candidates=cand,
        metric=metric, n_live=n_live,
    )
    oracle = arrays if n_live is None else tivf.sub_arrays(arrays, np.arange(n_live))
    hs, hd = tivf.ivf_pq_search_host(q, oracle, k, nprobe=nprobe, candidates=cand, metric=metric)
    rtol = 0.0 if metric == "cos" else 1e-6
    got = _resorted(ts.numpy(), td.numpy())
    _assert_agree(got, _resorted(js, jd), rtol)
    _assert_agree(got, _resorted(hs, hd), rtol)


def test_search_entry_point_and_empty_ranks():
    """`ivf_pq_search` with the default nprobe and the one-full-list
    candidate floor equals the JAX entry point; ranks past the live cells
    carry slot -1 and distance +inf, as in the JAX program."""
    arrays, q = _search_case("cos")
    ts, td = tivf.ivf_pq_search(q, tivf.arrays_from_numpy(arrays, "cpu"), 10)
    js, jd = jivf.ivf_pq_search(jnp.asarray(q), arrays, 10)
    _assert_agree(_resorted(ts.numpy(), td.numpy()), _resorted(js, jd))
    # a 3-row index: k 10 leaves 7 empty ranks
    tiny = tivf.build_ivf_pq(_clustered(3, seed=9), n_lists=2, subvectors=4, device="cpu")
    s, d = tivf.ivf_pq_search(q[:2], tiny, 10, nprobe=2)
    assert (s[:, 3:] == -1).all() and torch.isinf(d[:, 3:]).all()
    assert sorted(s[0, :3].tolist()) == [0, 1, 2]


def test_adc_chunks_give_the_same_answer(monkeypatch):
    """The ADC gather runs in chunks of probed lists under a memory cap;
    one list a chunk gives the same bits as one chunk for all."""
    arrays, q = _search_case("l2sq")
    dev = tivf.arrays_from_numpy(arrays, "cpu")
    kw = dict(k=10, nprobe=8, candidates=200, metric="l2sq")
    whole = tivf._ivf_pq_search_fn(torch.from_numpy(q), *dev, **kw)
    monkeypatch.setattr(tivf, "ADC_CHUNK_BYTES", 1)
    chunked = tivf._ivf_pq_search_fn(torch.from_numpy(q), *dev, **kw)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])


def test_arrays_from_numpy_checks_full_covers_the_slots():
    arrays, _q = _search_case("cos")
    short = arrays._replace(full=np.asarray(arrays.full)[:100])
    with pytest.raises(ValueError, match="rows"):
        tivf.arrays_from_numpy(short, "cpu")


def test_sharded_search_waits_for_the_multi_device_slice():
    """The multi-device slice has landed: the list-sharded search runs over
    a mesh of 4 CPU shards and finds what the unsharded search finds
    (tests/test_torch_sharded.py holds it to the JAX package)."""
    from pathway_tpu_torch.parallel.mesh import make_mesh

    arrays, q = _search_case("cos")
    mesh = make_mesh((4,), ("data",), ["cpu"] * 4)
    slots, dists = tivf.ivf_pq_search_sharded(q, tivf.shard_ivf_pq(arrays, mesh), 10)
    want, _ = tivf.ivf_pq_search(q, tivf.arrays_from_numpy(arrays, "cpu"), 10)
    assert torch.equal(slots[:, 0], want[:, 0]) and torch.isfinite(dists).all()
    assert make_knn_searcher(10, mesh=mesh) is not None


# -------------------------------------------------------------- reranker


@pytest.mark.parametrize("metric", METRICS)
def test_batched_reranker_matches_jax(metric):
    """Scores within 1e-5 of the JAX program (relative 1e-6 for dot and
    l2sq), -inf on invalid pairs, and one shape per bucket however ragged
    the waves: (B, C) = (3, 5), (7, 8), (8, 6) all pad to (8, 8)."""
    rng = np.random.default_rng(11)
    rr = BatchedReranker(metric, device="cpu", name=f"test_rerank_{metric}")
    for B, C in ((3, 5), (7, 8), (8, 6)):
        q = rng.normal(size=(B, DIM)).astype(np.float32)
        c = rng.normal(size=(B, C, DIM)).astype(np.float32)
        valid = rng.random((B, C)) > 0.3
        got = rr.scores(q, c, valid)
        want = np.asarray(jrerank._rerank_scores_fn(jnp.asarray(q), jnp.asarray(c), jnp.asarray(valid), metric=metric))
        assert got.shape == (B, C) and got.dtype == np.float32
        assert np.isneginf(got[~valid]).all() and np.isfinite(got[valid]).all()
        np.testing.assert_allclose(got[valid], want[valid], atol=1e-5, rtol=0 if metric == "cos" else 1e-6)
        np.testing.assert_allclose(
            BatchedReranker(metric, device=False).scores(q, c, valid), rerank_scores_host(q, c, valid, metric)
        )
    ledger = get_device_plane().programs[f"test_rerank_{metric}"]
    assert ledger.shape_counts == {(8, 8, DIM, metric): 1} and ledger.dispatches == 3


def test_reranker_custom_scorer_has_its_own_program():
    calls = []

    def scorer(q, cands, valid):
        calls.append(tuple(cands.shape))
        return (cands.sum(-1) + q.sum(-1, keepdim=True)).masked_fill(~valid, -float("inf"))

    rr = BatchedReranker("dot", device="cpu", scorer=scorer)
    q = np.ones((2, 4), np.float32)
    c = np.ones((2, 3, 4), np.float32)
    out = rr.scores(q, c, np.ones((2, 3), bool))
    np.testing.assert_array_equal(out, np.full((2, 3), 8.0, np.float32))
    assert calls == [(8, 8, 4)] and rr.program.dispatches == 1
    with pytest.raises(ValueError, match="numpy mirror"):
        BatchedReranker("dot", device=False, scorer=scorer)


# ------------------------------------------------ the incremental index


def _gen_arrays(index):
    g = index._gen
    return [g.centroids, g.codebooks, g.cube, g.valid, g.slots, g.fill]


def _assert_generations_equal(port, ref):
    for a, b in zip(_gen_arrays(port), _gen_arrays(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    assert port._gen.cell_of == ref._gen.cell_of
    assert port._gen.n_dead == ref._gen.n_dead and port._gen.spills == ref._gen.spills


def test_index_stream_matches_jax():
    """One add/remove/re-add stream into both packages' IvfPqIndex: below
    train_min the port is byte-identical to its exact slab; past it both
    build the same generation bytes through retrain, spill and cube growth,
    and compaction, and their searches agree under the rule above."""
    kw = dict(dimensions=DIM, background_retrain=False, train_min=256, seed=0, n_lists=8, compact_frac=0.2)
    port = IvfPqIndex(device="cpu", **kw)
    ref = JaxIvfPqIndex(**kw)
    slab = VectorSlabIndex(dimensions=DIM, device="cpu")
    rng = np.random.default_rng(21)
    docs = _clustered(1200, seed=22)

    def both(fn, *args):
        getattr(port, fn)(*args)
        getattr(ref, fn)(*args)

    def queries(n):
        picks = rng.choice(len(docs), n, replace=False)
        return [((docs[i] + 0.02 * rng.normal(size=DIM)).astype(np.float32), 10, None) for i in picks]

    for i in range(200):  # below train_min: the exact slab, byte for byte
        both("add", Key(i), docs[i])
        slab.add(Key(i), docs[i])
    items = queries(6)
    assert port.search_batch(items) == slab.search_batch(items)
    assert port._gen is None and port.stats()["exact_searches"] == 1

    for i in range(200, 700):  # crosses train_min: one retrain
        both("add", Key(i), docs[i])
    _assert_generations_equal(port, ref)
    cap0 = port._gen.cap
    items = queries(12)
    _assert_agree(port.search_batch(items), ref.search_batch(items))

    # a drift cluster far from the trained lists, with retrains held off
    # in both: its rows fill their nearest list, spill to the next of
    # their top 4, then find all 4 full and grow the cube
    assert port.counters["retrains"] == ref.counters["retrains"] >= 1
    port.train_min = ref.train_min = 10**9
    point = rng.normal(size=DIM) * 3
    drift = (point + 0.1 * rng.normal(size=(1100, DIM))).astype(np.float32)
    for j, vec in enumerate(drift):
        both("add", Key(5000 + j), vec)
    assert port.counters["spills"] == ref.counters["spills"] > 0
    assert port._gen.cap == ref._gen.cap > cap0
    _assert_generations_equal(port, ref)
    # (queries from the trained corpus: inside the drift cluster 1100 rows
    # lie closer together than the ADC error, so which of them make the
    # candidate cut is float noise in either package)
    items = queries(12)
    _assert_agree(port.search_batch(items), ref.search_batch(items))

    port.train_min = ref.train_min = 256
    for i in range(0, 700, 2):  # retracts: compaction past compact_frac
        both("remove", Key(i))
    for i in range(5000, 6100, 2):
        both("remove", Key(i))
    for i in range(0, 60, 2):  # re-adds of retracted keys into free slots
        both("add", Key(i), docs[i] + 0.01)
    assert port.counters["compactions"] == ref.counters["compactions"] > 0
    _assert_generations_equal(port, ref)
    items = queries(12)
    got = port.search_batch(items)
    _assert_agree(got, ref.search_batch(items))
    live = set(port.key_of.values())
    assert all({k for k, _ in m} <= live for m in got)
    both("retrain_now")
    _assert_generations_equal(port, ref)
    assert port.counters["retrains"] == ref.counters["retrains"]
    _assert_agree(port.search_batch(items), ref.search_batch(items))


def test_index_host_mirror_matches_the_oracle():
    """device=False searches through the numpy oracle; it agrees with the
    port's torch search of the same index."""
    docs = _clustered(1500, seed=23)
    port = IvfPqIndex(dimensions=DIM, device="cpu", background_retrain=False, seed=0)
    host = IvfPqIndex(dimensions=DIM, device=False, background_retrain=False, seed=0)
    _load(port, docs)
    _load(host, docs)
    items = [(docs[i] + 0.01, 10, None) for i in range(0, 1500, 75)]
    _assert_agree(port.search_batch(items), host.search_batch(items))


def test_device_mirrors_take_small_deltas_in_place():
    """After the first search, a few adds and removes are written into the
    resident tensors (same storage, counted as updates), not rebuilt; the
    shape ledger of the ANN programs stays flat."""
    docs = _clustered(1500, seed=13)
    ann = IvfPqIndex(dimensions=DIM, device="cpu", background_retrain=False, seed=0)
    keys = _load(ann, docs)
    items = [(docs[i], 10, None) for i in range(16)]
    ann.search_batch(items)
    before = dict(ann.counters)
    cube_ptr, full_ptr = ann._ann_dev["cube"].data_ptr(), ann._ann_full.data_ptr()
    for round_ in range(5):
        ann.remove(keys[round_])
        ann.add(keys[round_], docs[round_])
        res = ann.search_batch(items)
        assert res[round_][0][0] == keys[round_]
    assert ann._ann_dev["cube"].data_ptr() == cube_ptr and ann._ann_full.data_ptr() == full_ptr
    assert ann.counters["cube_rebuilds"] == before["cube_rebuilds"]
    assert ann.counters["row_rebuilds"] == before["row_rebuilds"]
    assert ann.counters["cell_updates"] - before["cell_updates"] == 5
    assert ann.counters["row_updates"] - before["row_updates"] == 5
    g = ann._gen
    assert np.array_equal(ann._ann_dev["cube"].numpy(), g.cube)
    assert np.array_equal(ann._ann_dev["valid"].numpy(), g.valid)
    assert np.array_equal(ann._ann_dev["slots"].numpy(), g.slots)
    counts = {b: n for (p, b), n in get_device_plane().shape_counts().items() if p.startswith("ann_")}
    assert counts and all(n == 1 for n in counts.values()), counts


# ------------------------------- ports of tests/test_ann_index.py:69-310


def test_ann_recall_guard_at_default_nprobe():
    docs = _clustered(4000, seed=0)
    ann = IvfPqIndex(dimensions=DIM, device="cpu", background_retrain=False, seed=0)
    _load(ann, docs)
    assert ann.stats()["trained"]
    rng = np.random.default_rng(1)
    q = docs[rng.choice(len(docs), 50)] + 0.05 * rng.normal(size=(50, DIM))
    items = [(q[i], 10, None) for i in range(len(q))]
    recall = _recall_at(ann.search_batch(items), _exact_reference(docs).search_batch(items))
    assert recall >= 0.95, f"recall@10 {recall} < 0.95 at default nprobe"
    assert ann.measured_recall() >= 0.95
    assert ann.stats()["recall_at_k"] == ann.last_recall


def test_ann_nprobe_is_a_per_query_knob():
    docs = _clustered(3000, seed=2)
    ann = IvfPqIndex(dimensions=DIM, device="cpu", background_retrain=False, seed=0)
    _load(ann, docs)
    L = ann.stats()["lists"]
    q = _clustered(20, seed=3)
    items = [(q[i], 10, None) for i in range(len(q))]
    ref = _exact_reference(docs).search_batch(items)
    wide = _recall_at(ann.search_batch(items, nprobe=L), ref)
    narrow = _recall_at(ann.search_batch(items, nprobe=1), ref)
    assert wide >= 0.95 and wide >= narrow


def test_ann_adversarial_churn():
    """Interleaved add / retract / re-add / retrain: results are always a
    subset of live rows and every live row stays findable by its own
    vector."""
    rng = np.random.default_rng(42)
    docs = _clustered(2000, seed=4)
    ann = IvfPqIndex(dimensions=DIM, device="cpu", background_retrain=False, train_min=256, seed=0)
    live: dict[Key, np.ndarray] = {}
    next_id = 0

    def check():
        assert set(ann.key_of.values()) == set(live)
        sample = rng.choice(len(live), min(30, len(live)), replace=False)
        keys = list(live)
        res = ann.search_batch([(live[keys[i]], 5, None) for i in sample])
        for i, matches in zip(sample, res):
            got = [key for key, _ in matches]
            assert set(got) <= set(live), "tombstoned row surfaced"
            assert keys[i] in got, "live row lost from its own neighborhood"

    for round_ in range(6):
        for _ in range(300):
            vec = docs[next_id % len(docs)]
            ann.add(Key(next_id), vec)
            live[Key(next_id)] = vec
            next_id += 1
        if len(live) > 200:
            for key in rng.choice(list(live), 120, replace=False):
                ann.remove(key)
                del live[key]
        for key in rng.choice(list(live), 40, replace=False):
            vec = (docs[int(rng.integers(0, len(docs)))] + 0.03 * rng.normal(size=DIM)).astype(np.float32)
            ann.add(key, vec)
            live[key] = vec
        if round_ % 2 == 1:
            ann.retrain_now()
        check()
    stats = ann.stats()
    assert stats["trained"] and stats["retrains"] >= 3


def test_ann_compaction_drops_tombstones():
    docs = _clustered(2000, seed=5)
    ann = IvfPqIndex(dimensions=DIM, device="cpu", background_retrain=False, compact_frac=0.2, seed=0)
    keys = _load(ann, docs)
    base = ann.stats()["compactions"]
    for key in keys[: len(keys) // 2]:
        ann.remove(key)
    stats = ann.stats()
    assert stats["compactions"] > base
    assert stats["tombstone_frac"] <= 0.2 + 1e-9
    live = set(ann.key_of.values())
    for matches in ann.search_batch([(docs[i], 5, None) for i in range(1500, 1520)]):
        assert {key for key, _ in matches} <= live


def test_ann_spill_then_resplit():
    ann = IvfPqIndex(
        dimensions=DIM, device="cpu", background_retrain=False, train_min=256, seed=0,
        retrain_factor=100.0,  # isolate the spill trigger from the size one
    )
    _load(ann, _clustered(1500, seed=6))
    spills_before, retrains_before = ann.stats()["spills"], ann.stats()["retrains"]
    rng = np.random.default_rng(7)
    drift = (rng.normal(size=DIM) + 0.02 * rng.normal(size=(900, DIM))).astype(np.float32)
    _load(ann, drift, start=10_000)
    stats = ann.stats()
    assert stats["spills"] > spills_before
    assert stats["retrains"] > retrains_before, "chronic spill must re-split"
    for matches in ann.search_batch([(drift[i], 10, None) for i in range(10)]):
        assert len(matches) == 10


def test_ann_background_retrain_off_wave_path():
    """Queries keep answering (old generation) while retrains run on
    another thread; the swap is atomic and results stay within the live
    rows."""
    docs = _clustered(3000, seed=8)
    ann = IvfPqIndex(dimensions=DIM, device="cpu", background_retrain=True, seed=0)
    _load(ann, docs)
    ann.wait_retrain()
    assert ann.stats()["trained"] and not ann._retrain_thread.is_alive()
    live = set(ann.key_of.values())
    stop = threading.Event()
    errors: list[Exception] = []

    def churn_retrain():
        try:
            while not stop.is_set():
                ann.retrain_now()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=churn_retrain, daemon=True)
    t.start()
    try:
        items = [(docs[i], 10, None) for i in range(40)]
        for _ in range(10):
            for matches in ann.search_batch(items):
                assert matches and {key for key, _ in matches} <= live
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors
    assert ann.stats()["retrains"] >= 2


# ---------------------------------------------- kill switch + searcher


def test_ann_enabled_env_contract(monkeypatch):
    monkeypatch.delenv("PATHWAY_ANN", raising=False)
    assert ann_enabled(True) and not ann_enabled(False)
    monkeypatch.setenv("PATHWAY_ANN", "0")
    assert not ann_enabled(True) and not ann_enabled(False)
    monkeypatch.setenv("PATHWAY_ANN", "1")
    assert ann_enabled(True) and ann_enabled(False)


def test_make_knn_searcher_routes_to_ann_and_pathway_ann_0_is_exact(monkeypatch):
    monkeypatch.delenv("PATHWAY_ANN", raising=False)
    docs = _clustered(2000, seed=12)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q = torch.from_numpy(docs[:8] + 0.01)
    ddev = torch.from_numpy(docs)
    exact = make_knn_searcher(10)(q, ddev)
    search = make_knn_searcher(10, ann=True)
    ann = search(q, ddev)
    assert len(search._cache) == 1
    ai, ei = ann.indices.numpy(), exact.indices.numpy()
    assert np.mean([len(set(ai[i]) & set(ei[i])) / 10 for i in range(8)]) >= 0.9
    # the same answer as the JAX searcher's index, queried through the port
    jidx = jivf.build_ivf_pq(docs, metric="cos")
    js, jd = jivf.ivf_pq_search(jnp.asarray(q.numpy()), jidx, 10)
    _assert_agree(_resorted(ann.indices, ann.distances), _resorted(js, jd))
    # the kill switch vetoes an explicit ann=True: exact, bit for bit
    monkeypatch.setenv("PATHWAY_ANN", "0")
    off = make_knn_searcher(10, ann=True)(q, ddev)
    assert torch.equal(off.indices, exact.indices) and torch.equal(off.distances, exact.distances)
    # and PATHWAY_ANN=1 opts an unlabeled searcher in, never an explicit False
    monkeypatch.setenv("PATHWAY_ANN", "1")
    assert hasattr(make_knn_searcher(10), "_cache")
    assert not hasattr(make_knn_searcher(10, ann=False), "_cache")


def test_make_knn_searcher_keeps_a_bounded_lru(monkeypatch):
    monkeypatch.setenv("PATHWAY_KNN_CACHE", "2")
    search = make_knn_searcher(5, ann=True)
    mats = [torch.from_numpy(_clustered(300, seed=30 + i)) for i in range(3)]
    q = mats[0][:4]
    first = search(q, mats[0])
    index0 = search._cache[id(mats[0])][2]
    again = search(q, mats[0])  # a hit: the same resident index
    assert search._cache[id(mats[0])][2] is index0 and torch.equal(first.indices, again.indices)
    search(q, mats[1])
    search(q, mats[2])  # evicts the least recently used (mats[0])
    assert list(search._cache) == [id(mats[1]), id(mats[2])]
    freed = id(mats[1])
    del mats[1]
    search(q, mats[0])  # the freed matrix's entry is pruned first
    assert freed not in search._cache and len(search._cache) == 2


# ------------------------------------------------------------- lifecycle


def test_ann_pickle_roundtrip_preserves_results():
    docs = _clustered(1200, seed=14)
    ann = IvfPqIndex(dimensions=DIM, device="cpu", background_retrain=False, seed=0)
    _load(ann, docs)
    items = [(docs[i], 10, None) for i in range(12)]
    before = ann.search_batch(items)
    state = ann.__getstate__()
    assert state["_ann_dev"] is None and state["_ann_full"] is None and state["_gen_lock"] is None
    ann2 = pickle.loads(pickle.dumps(ann))
    assert ann2.search_batch(items) == before
    ann2.add(Key(99_999), docs[0] + 0.5)  # the restored locks work
    slab = VectorSlabIndex(dimensions=DIM, device="cpu")
    _load(slab, docs[:50])
    slab.search(docs[0], 3)
    assert pickle.loads(pickle.dumps(slab)).search(docs[0], 3) == slab.search(docs[0], 3)


def test_process_exits_cleanly_with_a_live_retrain_thread():
    """The interpreter exits while a background retrain may still run: the
    exit drain waits for it, and the process ends with code 0."""
    code = (
        "import numpy as np\n"
        "from pathway_tpu_torch.indexing import IvfPqIndex\n"
        "rng = np.random.default_rng(0)\n"
        "docs = rng.normal(size=(6000, 32)).astype(np.float32)\n"
        "ann = IvfPqIndex(dimensions=32, device='cpu', train_min=5000, seed=0)\n"
        "for i, v in enumerate(docs):\n"
        "    ann.add(i, v)\n"
        "assert ann._retrain_thread is not None\n"
        "print('alive' if ann._retrain_thread.is_alive() else 'done', flush=True)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() in ("alive", "done") and "terminate" not in proc.stderr


def test_default_device_needs_a_card_and_later_slices_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: IvfPqIndex(dimensions=8),
        lambda: BatchedReranker("cos"),
        lambda: tivf.build_ivf_pq(_clustered(64, seed=1)),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # the tiers are ported: budgets and PATHWAY_ANN_TIERED=1 opt in, =0 vetoes
    assert IvfPqIndex(dimensions=8, device="cpu", tiered=True)._tiered
    assert IvfPqIndex(dimensions=8, device="cpu", hot_lists=4)._tiered
    # the sharded search is ported: the flag and PATHWAY_ANN_SHARDED=1 opt in
    assert IvfPqIndex(dimensions=8, device="cpu", sharded=True)._shard_search
    monkeypatch.setenv("PATHWAY_ANN_TIERED", "1")
    assert IvfPqIndex(dimensions=8, device="cpu")._tiered
    monkeypatch.setenv("PATHWAY_ANN_TIERED", "0")  # vetoes the budgets
    vetoed = IvfPqIndex(dimensions=8, device="cpu", hot_lists=4)
    assert not vetoed._tiered and vetoed.stats()["lists"] == 0
    monkeypatch.delenv("PATHWAY_ANN_TIERED")
    monkeypatch.setenv("PATHWAY_ANN_SHARDED", "1")
    assert IvfPqIndex(dimensions=8, device="cpu")._shard_search
    # approx=True is served by the exact top-k (ROADMAP C2)
    assert VectorSlabIndex(dimensions=8, device="cpu", approx=True).approx


# ------------------------------------------------------ two-stage wrapper


def _crippled_pair(device):
    """A port and a JAX IvfPqIndex over the same corpus, searched at
    nprobe 1 (probe misses are likely), each wrapped for reranking."""
    docs = _clustered(3000, seed=31, n_clusters=60)
    kw = dict(dimensions=DIM, background_retrain=False, seed=0, nprobe=1)
    port = IvfPqIndex(device=device, **kw)
    ref = JaxIvfPqIndex(**kw)
    _load(port, docs)
    _load(ref, docs)
    rng = np.random.default_rng(32)
    q = docs[rng.choice(len(docs), 24, replace=False)] + 0.1 * rng.normal(size=(24, DIM))
    return docs, port, ref, [(q[i].astype(np.float32), 10, None) for i in range(24)]


def test_reranked_index_recovers_probe_misses():
    docs, port, ref, items = _crippled_pair("cpu")
    exact = _exact_reference(docs).search_batch(items)
    plain = _recall_at(port.search_batch(items), exact)
    wrapped = RerankedSlabIndex(port, expand=4)
    res = wrapped.search_batch(items)
    assert wrapped.counters["rerank_expansions"] > 0
    assert _recall_at(res, exact) >= plain
    for matches in res:  # the host-index contract: ascending (dist, key)
        assert len(matches) == 10
        assert matches == sorted(matches, key=lambda m: (m[1], m[0].value))
    # the JAX wrapper over the JAX index walks the same expansions
    jwrapped = JaxReranked(ref, expand=4)
    _assert_agree(res, jwrapped.search_batch(items))
    assert wrapped.counters == jwrapped.counters
    # the reranker follows the inner index: numpy for a device=False index
    assert wrapped.reranker.device == torch.device("cpu")
    host = IvfPqIndex(dimensions=DIM, device=False)
    assert RerankedSlabIndex(host).reranker.device is None
    assert wrapped.dim == DIM and wrapped.stats()["trained"]  # delegation


# -------------------------------------------------------------- isolation


def test_ann_modules_are_in_the_no_jax_scan_and_load_no_jax():
    # test_torch_slice's AST scan walks every .py file of the package
    scanned = {str(p.relative_to(REPO)) for p in (REPO / "pathway_tpu_torch").rglob("*.py")}
    for mod in (
        "pathway_tpu_torch/ops/ivf.py",
        "pathway_tpu_torch/ops/rerank.py",
        "pathway_tpu_torch/indexing/__init__.py",
        "pathway_tpu_torch/indexing/ann.py",
        "pathway_tpu_torch/stdlib/indexing/reranking.py",
    ):
        assert mod in scanned
    code = (
        "import sys, pathway_tpu_torch, pathway_tpu_torch.indexing, pathway_tpu_torch.ops.ivf, "
        "pathway_tpu_torch.ops.rerank, pathway_tpu_torch.stdlib.indexing.reranking\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pathway_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
