"""The port's IVF-PQ search, reranker and incremental index on the card,
held to their numpy oracles.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_ann_cuda.py -q

Without a card every test skips. The TF32 cases turn
``torch.backends.cuda.matmul.allow_tf32`` on: the search and the reranker
must give the same bits as with it off, and stay within 1e-5 of the oracle
(1e-6 relative for dot and l2sq), because no product that decides their
order runs in TF32.
"""

import numpy as np
import pytest
import torch

from pathway_tpu_torch.indexing import IvfPqIndex
from pathway_tpu_torch.ops import ivf
from pathway_tpu_torch.ops.rerank import BatchedReranker, rerank_scores_host

pytestmark = pytest.mark.cuda
DIM = 64


@pytest.fixture
def cuda_device():
    # decided when the test runs, never at import: every xdist worker
    # must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: these tests hold the card's results to the oracle")
    return torch.device("cuda")


@pytest.fixture
def tf32(request):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = request.param
    yield request.param
    torch.backends.cuda.matmul.allow_tf32 = old


def _clustered(n: int, seed: int, n_clusters: int = 64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, DIM))
    return (centers[rng.integers(0, n_clusters, n)] + 0.15 * rng.normal(size=(n, DIM))).astype(np.float32)


def _resorted(slots, dists):
    out = []
    for s_row, d_row in zip(np.asarray(slots), np.asarray(dists)):
        row = [(int(s), float(d)) for s, d in zip(s_row, d_row) if s >= 0 and np.isfinite(d)]
        out.append(sorted(row, key=lambda t: (t[1], t[0])))
    return out


def _assert_agree(got, want, rtol: float):
    ranks = same = 0
    for g, w in zip(got, want):
        assert len(g) == len(w) and g[0][0] == w[0][0]
        for (gk, gd), (wk, wd) in zip(g, w):
            ranks += 1
            if gk == wk:
                same += 1
                np.testing.assert_allclose(gd, wd, atol=1e-5, rtol=rtol)
    assert same >= 0.99 * ranks, f"keys agree at {same} of {ranks} ranks"


@pytest.mark.parametrize("tf32", [False, True], indirect=True)
@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_search_on_the_card_matches_the_oracle(cuda_device, tf32, metric):
    docs = _clustered(20000, seed=1)
    rng = np.random.default_rng(2)
    q = (docs[rng.choice(len(docs), 32)] + 0.05 * rng.normal(size=(32, DIM))).astype(np.float32)
    host = ivf.build_ivf_pq(docs, metric=metric, seed=0, device="cpu")
    index = ivf.arrays_from_numpy(host, cuda_device)
    slots, dists = ivf.ivf_pq_search(q, index, 10, nprobe=16, candidates=1024, metric=metric)
    assert slots.device.type == "cuda" and slots.dtype == torch.int32 and dists.dtype == torch.float32
    hs, hd = ivf.ivf_pq_search_host(q, host, 10, nprobe=16, candidates=1024, metric=metric)
    _assert_agree(_resorted(slots.cpu(), dists.cpu()), _resorted(hs, hd), 0.0 if metric == "cos" else 1e-6)
    # the same bits with TF32 off: nothing that decides the order takes it
    torch.backends.cuda.matmul.allow_tf32 = not tf32
    s2, d2 = ivf.ivf_pq_search(q, index, 10, nprobe=16, candidates=1024, metric=metric)
    assert torch.equal(s2, slots) and torch.equal(d2, dists)


@pytest.mark.parametrize("tf32", [True], indirect=True)
@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_reranker_on_the_card_matches_the_oracle(cuda_device, tf32, metric):
    # rows of unit length on average: every score is O(1), so 1e-5 is a
    # few f32 ulps of the 384-term sums whichever order they run in
    rng = np.random.default_rng(3)
    q = (rng.normal(size=(24, 384)) / np.sqrt(384)).astype(np.float32)
    c = (rng.normal(size=(24, 120, 384)) / np.sqrt(384)).astype(np.float32)
    valid = rng.random((24, 120)) > 0.2
    got = BatchedReranker(metric, device=cuda_device).scores(q, c, valid)
    want = rerank_scores_host(q, c, valid, metric)
    assert np.isneginf(got[~valid]).all()
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5, rtol=0.0 if metric == "cos" else 1e-6)


def test_index_on_the_card_matches_its_numpy_mirror(cuda_device):
    """The same stream into a card index and a device=False one: equal
    generations, agreeing searches, small deltas written in place."""
    docs = _clustered(6000, seed=4)
    card = IvfPqIndex(dimensions=DIM, device=cuda_device, background_retrain=False, seed=0)
    host = IvfPqIndex(dimensions=DIM, device=False, background_retrain=False, seed=0)
    for i, v in enumerate(docs):
        card.add(i, v)
        host.add(i, v)
    items = [(docs[i] + 0.01, 10, None) for i in range(0, 6000, 250)]
    want = host.search_batch(items)
    got = card.search_batch(items)
    _assert_agree([[(k, d) for k, d in r] for r in got], [[(k, d) for k, d in r] for r in want], 0.0)
    rebuilds = card.counters["cube_rebuilds"], card.counters["row_rebuilds"]
    for i in range(20):
        card.remove(i)
        host.remove(i)
        card.add(10_000 + i, docs[i] * 1.01)
        host.add(10_000 + i, docs[i] * 1.01)
    got = card.search_batch(items)
    assert (card.counters["cube_rebuilds"], card.counters["row_rebuilds"]) == rebuilds
    assert card.counters["cell_updates"] >= 1 and card.counters["row_updates"] >= 1
    live = set(card.key_of.values())
    assert all({k for k, _ in r} <= live for r in got)
    _assert_agree([[(k, d) for k, d in r] for r in got], [[(k, d) for k, d in r] for r in host.search_batch(items)], 0.0)
    np.testing.assert_array_equal(card._ann_dev["cube"].cpu().numpy(), card._gen.cube)
