"""The port's sharded searches (exact KNN and list-sharded IVF-PQ), the
sharded ``IvfPqIndex``, the mesh-spanning slot pool and
``segment_reduce``, against the JAX package.

Both sides run on 8 virtual CPU shards (the JAX package's from
``tests/conftest.py``, the port's from ``PATHWAY_MESH_DEVICES=cpu*8``) on
the same seeded numpy inputs. Tolerances: indices of the exact searches
equal (no ties in these inputs) and distances within 1e-5; IVF-PQ result
sets under tests/test_torch_ann.py's rule (the top-1 identical, keys equal
at >= 99% of ranks) and recall at least the unsharded search's per query;
generated tokens and integer reductions byte-identical; float sums and
means within 1e-5 relative. Mirrors tests/test_ops_models.py:61-82,
tests/test_column_plane.py:393-500.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.indexing.ann import IvfPqIndex as JaxIvfPqIndex
from pathway_tpu.internals.keys import Key
from pathway_tpu.ops import ivf as jivf
from pathway_tpu.ops.segment import segment_reduce as jax_segment_reduce
from pathway_tpu.ops.topk import knn_search_sharded as jax_knn_sharded
from pathway_tpu.ops.topk import make_knn_searcher as jax_searcher
from pathway_tpu.parallel import mesh as jmesh
from pathway_tpu_torch.indexing.ann import IvfPqIndex
from pathway_tpu_torch.ops import ivf as tivf
from pathway_tpu_torch.ops import knn_search, knn_search_sharded, make_knn_searcher, segment_reduce
from pathway_tpu_torch.parallel.mesh import default_mesh, make_mesh

N_DEV = 8


@pytest.fixture(autouse=True)
def mesh_env(monkeypatch):
    monkeypatch.setenv("PATHWAY_MESH_DEVICES", f"cpu*{N_DEV}")


def _clustered(n: int, d: int, seed: int, n_clusters: int = 30, spread: float = 0.1):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    docs = (centers[rng.integers(0, n_clusters, n)] + spread * rng.normal(size=(n, d))).astype(np.float32)
    q = (centers[rng.integers(0, n_clusters, 8)] + spread * rng.normal(size=(8, d))).astype(np.float32)
    return docs, q


def _same_sets(a: np.ndarray, b: np.ndarray) -> None:
    """tests/test_torch_ann.py's rule: the top-1 identical, keys equal at
    >= 99% of ranks."""
    assert np.array_equal(a[:, 0], b[:, 0])
    assert (a == b).mean() >= 0.99 or np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)]) >= 0.99


# ------------------------------------------------------------- exact KNN


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_knn_sharded_matches_single_and_jax(metric):
    rng = np.random.default_rng(4)
    d = rng.normal(size=(N_DEV * 16, 12)).astype(np.float32)
    q = rng.normal(size=(5, 12)).astype(np.float32)
    single = knn_search(torch.from_numpy(q), torch.from_numpy(d), 4, metric)
    sharded = knn_search_sharded(torch.from_numpy(q), torch.from_numpy(d), 4, metric, default_mesh())
    jm = jmesh.default_mesh(("data",))
    ref = jax_knn_sharded(jnp.asarray(q), jnp.asarray(d), k=4, metric=metric, mesh=jm)
    assert torch.equal(single.indices, sharded.indices)
    np.testing.assert_array_equal(sharded.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(sharded.distances.numpy(), np.asarray(ref.distances), atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        knn_search_sharded(torch.from_numpy(q), torch.from_numpy(d[:-1]), 4, metric, default_mesh())


def test_make_knn_searcher_with_a_mesh():
    """The exact searcher shards the rows; the ANN searcher trains once
    and shards its lists; both agree with the JAX package's searchers."""
    docs, q = _clustered(3000, 32, seed=1)
    mesh, jm = default_mesh(), jmesh.default_mesh(("data",))
    exact = make_knn_searcher(10, mesh=mesh)(torch.from_numpy(q), torch.from_numpy(docs))
    jexact = jax_searcher(10, mesh=jm)(jnp.asarray(q), jnp.asarray(docs))
    np.testing.assert_array_equal(exact.indices.numpy(), np.asarray(jexact.indices))
    search = make_knn_searcher(10, mesh=mesh, ann=True)
    dt = torch.from_numpy(docs)
    got = search(torch.from_numpy(q), dt)
    again = search(torch.from_numpy(q), dt)
    assert len(search._cache) == 1 and isinstance(next(iter(search._cache.values()))[2], tivf.ShardedIvfPq)
    assert torch.equal(got.indices, again.indices)
    ref = jax_searcher(10, mesh=jm, ann=True)(jnp.asarray(q), jnp.asarray(docs))
    _same_sets(got.indices.numpy(), np.asarray(ref.indices))


# ------------------------------------------------------------- IVF-PQ


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_ivf_sharded_matches_unsharded(metric):
    """Each shard rescans its own top candidates, so per query the
    sharded recall is at least the unsharded search's; slots are global
    and the results match the JAX package's sharded search."""
    docs, q = _clustered(3000, 32, seed=1)
    idx = tivf.build_ivf_pq(docs, metric=metric, device="cpu")
    s_un, _ = tivf.ivf_pq_search(q, idx, 10, metric=metric)
    sidx = tivf.shard_ivf_pq(idx, default_mesh())
    assert sidx.n_lists == idx.centroids.shape[0] and sidx.codes.shape[0] % N_DEV == 0
    s_sh, d_sh = tivf.ivf_pq_search_sharded(q, sidx, 10, metric=metric)
    s_un, s_sh, d_sh = s_un.numpy(), s_sh.numpy(), d_sh.numpy()
    if metric == "cos":
        qq = q / np.linalg.norm(q, axis=1, keepdims=True)
        dd = docs / np.linalg.norm(docs, axis=1, keepdims=True)
        exact = np.argsort(-(qq @ dd.T), axis=1)[:, :10]
    else:
        exact = np.argsort(((q[:, None, :] - docs[None]) ** 2).sum(-1), axis=1)[:, :10]
    for i in range(len(q)):
        assert len(set(s_sh[i]) & set(exact[i])) >= len(set(s_un[i]) & set(exact[i]))
        assert (s_sh[i] >= 0).all() and np.isfinite(d_sh[i]).all()
    jidx = jivf.build_ivf_pq(docs, metric=metric)
    js, _ = jivf.ivf_pq_search_sharded(q, jivf.shard_ivf_pq(jidx, jmesh.default_mesh(("data",))), 10, metric=metric)
    _same_sets(s_sh, np.asarray(js))


def _index_pair(sharded_port: bool):
    rng = np.random.default_rng(2)
    d = 16
    kw = dict(dimensions=d, train_min=64, background_retrain=False)
    port = IvfPqIndex(sharded=sharded_port, device="cpu", **kw)
    ref = JaxIvfPqIndex(sharded=True, **kw)
    centers = rng.normal(size=(8, d))
    for i in range(400):
        v = (centers[i % 8] + 0.05 * rng.normal(size=d)).astype(np.float32)
        port.add(Key(i), v)
        ref.add(Key(i), v)
    q = (centers[2] + 0.05 * rng.normal(size=d)).astype(np.float32)
    return port, ref, q


def test_ivf_pq_index_sharded_search_parity():
    """IvfPqIndex(sharded=True): the same result set as the unsharded
    index and as the JAX package's sharded index, through adds,
    retractions and the lazy rebuild of the placed view."""
    port, ref, q = _index_pair(True)
    plain, _, _ = _index_pair(False)
    assert port._shard_search and port.counters["sharded_searches"] == 0
    keys = lambda res: {k.value for k, _ in res}  # noqa: E731
    assert keys(port.search(q, 10)) == keys(plain.search(q, 10)) == keys(ref.search(q, 10))
    assert ref._shard_search and ref._sharded_failures == 0
    for i in range(60):
        for index in (port, plain, ref):
            index.remove(Key(i))
    got = port.search(q, 10)
    assert keys(got) == keys(plain.search(q, 10)) == keys(ref.search(q, 10))
    assert all(k.value >= 60 for k, _ in got)
    assert port.counters["sharded_searches"] == 2 and port.counters["sharded_placements"] == 2


def test_sharded_index_flag_reads_the_environment(monkeypatch):
    monkeypatch.setenv("PATHWAY_ANN_SHARDED", "1")
    assert IvfPqIndex(dimensions=8, device="cpu")._shard_search
    assert not IvfPqIndex(dimensions=8, device=False)._shard_search  # the numpy mirror
    monkeypatch.delenv("PATHWAY_ANN_SHARDED")
    assert not IvfPqIndex(dimensions=8, device="cpu")._shard_search


def test_a_failed_sharded_search_raises(monkeypatch):
    """No 3-strike switch: a sharded search that fails raises, every
    time, and so does a default mesh of one shard."""
    port, _, q = _index_pair(True)

    def broken(*args, **kwargs):
        raise RuntimeError("shard lost")

    monkeypatch.setattr(tivf, "ivf_pq_search_sharded", broken)
    for _ in range(4):
        with pytest.raises(RuntimeError, match="shard lost"):
            port.search(q, 10)
    assert port._shard_search
    monkeypatch.undo()
    monkeypatch.setenv("PATHWAY_MESH_DEVICES", "cpu")
    port.remove(Key(399))  # a mutation: the next search places anew
    with pytest.raises(RuntimeError, match="at least two shards"):
        port.search(q, 10)


# ----------------------------------------------------- mesh slot pools


class _Tok:
    def tokenize(self, s):
        return [2 + (ord(c) % 40) for c in s][:12]


def test_mesh_spanning_slot_pool_byte_identical():
    """The pool spans the mesh (n_slots x shards) and per-request tokens
    equal the single-device pool's and the JAX package's."""
    from pathway_tpu.models import transformer as jtfm
    from pathway_tpu.serving.continuous_batching import ContinuousBatcher as JaxBatcher
    from pathway_tpu_torch.models import transformer as ttfm
    from pathway_tpu_torch.models.convert import params_from_numpy
    from pathway_tpu_torch.serving.continuous_batching import ContinuousBatcher

    kw = dict(vocab_size=128, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_len=32)
    jcfg = jtfm.lm_config(dtype=jnp.float32, **kw)
    tcfg = ttfm.lm_config(dtype=torch.float32, **kw)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    prompts = [f"prompt {i}" for i in range(20)]

    def drive(make, span, name):
        cb = make(span, name)
        trees = {}  # a shard's cache block -> the parameter tree of each prefill into it
        prefill = cb._prefill

        def watched(params, ids, mask, cache, slot, **kw):
            trees.setdefault(cache["k"].data_ptr(), []).append(params)
            return prefill(params, ids, mask, cache, slot, **kw)

        cb._prefill = watched
        try:
            futs = [cb.submit(p) for p in prompts]
            return [f.result(timeout=120) for f in futs], cb.n_slots, trees
        finally:
            cb.close()

    def port(span, name):
        return ContinuousBatcher(params=tparams, cfg=tcfg, tokenizer=_Tok(), n_steps=3, n_slots=2,
                                 name=name, mesh_span=span)

    out_off, slots_off, _ = drive(port, False, "cb-mesh-off")
    out_on, slots_on, trees = drive(port, True, "cb-mesh-on")
    assert (slots_off, slots_on) == (2, 2 * N_DEV)
    assert out_on == out_off
    # each shard's parameter views are built once: every prefill into a
    # shard is handed the same tree
    assert len(trees) == N_DEV and sum(map(len, trees.values())) == len(prompts)
    assert all(len(ts) >= 2 and all(t is ts[0] for t in ts) for ts in trees.values())
    jcb = JaxBatcher(params=jparams, cfg=jcfg, tokenizer=_Tok(), n_steps=3, n_slots=2,
                     name="cb-mesh-jax", mesh_span=True)
    try:
        assert [f.result(timeout=120) for f in [jcb.submit(p) for p in prompts]] == out_on
    finally:
        jcb.close()


def test_mesh_span_without_a_mesh_raises(monkeypatch):
    from pathway_tpu_torch.models import transformer as ttfm
    from pathway_tpu_torch.serving.continuous_batching import ContinuousBatcher

    cfg = ttfm.lm_config(vocab_size=64, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_len=32,
                         dtype=torch.float32)
    params = ttfm.init_params(torch.Generator().manual_seed(0), cfg)
    monkeypatch.setenv("PATHWAY_MESH_DEVICES", "cpu")
    assert ContinuousBatcher(params=params, cfg=cfg, tokenizer=_Tok(), n_steps=2, mesh_span=True).mesh is None
    monkeypatch.delenv("PATHWAY_MESH_DEVICES")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(params=params, cfg=cfg, tokenizer=_Tok(), n_steps=2, mesh_span=True)
    monkeypatch.setenv("PATHWAY_MESH_SLOTS", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(params=params, cfg=cfg, tokenizer=_Tok(), n_steps=2)


# ------------------------------------------------------- segment_reduce


def test_segment_reduce_ops():
    vals = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])
    segs = torch.tensor([0, 0, 1, 1, 1])
    assert segment_reduce(vals, segs, 2, "sum").tolist() == [3.0, 12.0]
    assert segment_reduce(vals, segs, 2, "mean").tolist() == [1.5, 4.0]
    assert segment_reduce(vals, segs, 2, "min").tolist() == [1.0, 3.0]
    assert segment_reduce(vals, segs, 2, "max").tolist() == [2.0, 5.0]
    assert segment_reduce(vals, segs, 2, "count").tolist() == [2, 3]
    with pytest.raises(ValueError, match="unknown op"):
        segment_reduce(vals, segs, 2, "median")


@pytest.mark.parametrize("op", ["sum", "min", "max", "count", "mean", "any"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_reduce_matches_jax(op, dtype):
    """Out-of-range ids dropped, empty segments at the identity (True for
    `any`), integer means in f32; [n] and [n, 3] values."""
    rng = np.random.default_rng(0)
    for shape in ((200,), (200, 3)):
        v = (rng.normal(size=shape) * 10).astype(dtype)
        v[::7] = 0
        ids = rng.integers(-3, 14, 200).astype(np.int32)  # segments 12, 13 empty; some dropped
        ref = np.asarray(jax_segment_reduce(jnp.asarray(v), jnp.asarray(ids), 16, op))
        got = segment_reduce(torch.from_numpy(v), torch.from_numpy(ids), 16, op).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape
        if op in ("sum", "mean") and dtype == np.float32 or op == "mean":
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        else:
            assert np.array_equal(got, ref)
