"""The port's public surface against the JAX package's (ROADMAP C7-C9).

A program written against ``pathway_tpu`` must find the same names in
``pathway_tpu_torch``: the package inits' exports (C7), ``knn_search``'s
``approx`` keyword (C8), and the serving and device-plane methods (C9).
Each case calls the name on both packages with the same inputs and
compares what they return.
"""

from __future__ import annotations

import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu.ops as jops
import pathway_tpu.stdlib as jstdlib
import pathway_tpu_torch.ops as tops
import pathway_tpu_torch.stdlib as tstdlib
from pathway_tpu.engine import device_plane as jplane
from pathway_tpu_torch.engine import device_plane as tplane

REPO = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------------ C7


@pytest.mark.parametrize("ref, port", [(jops, tops), (jstdlib, tstdlib)], ids=["ops", "stdlib"])
def test_package_exports_hold_the_reference_names(ref, port):
    assert set(ref.__all__) <= set(port.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def test_stdlib_exports_equal_the_reference():
    assert tstdlib.__all__ == jstdlib.__all__


def test_surface_imports_load_no_jax():
    code = (
        "import sys\n"
        "from pathway_tpu_torch.ops import IvfPqArrays, build_ivf_pq, ivf_pq_search\n"
        "from pathway_tpu_torch.stdlib import graphs, ml, stateful, statistical\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'pathway_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


# ------------------------------------------------------------------ C8


def test_knn_search_approx_is_exact_on_the_quantized_recall_corpus():
    """C2's corpus (tests/test_indexing.py::test_quantized_knn_recall):
    `approx=True` returns the port's exact result, whose recall is at
    least the JAX package's approx_max_k recall."""
    rng = np.random.default_rng(7)
    docs = rng.normal(size=(5000, 64)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q = rng.normal(size=(8, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    truth = np.argsort(-(q @ docs.T), axis=1, kind="stable")[:, :10]

    def recall(idx) -> float:
        return float(np.mean([len(set(np.asarray(r).tolist()) & set(truth[i].tolist())) / 10
                              for i, r in enumerate(idx)]))

    for metric in ("cos", "l2"):
        approx = tops.knn_search(torch.from_numpy(q), torch.from_numpy(docs), 10, metric, approx=True)
        exact = tops.knn_search(torch.from_numpy(q), torch.from_numpy(docs), 10, metric)
        assert torch.equal(approx.indices, exact.indices)
        assert torch.equal(approx.distances, exact.distances)
        ref = jops.knn_search(jnp.asarray(q), jnp.asarray(docs), 10, metric, approx=True)
        assert recall(approx.indices.numpy()) >= recall(np.asarray(ref.indices))
        assert recall(approx.indices.numpy()) == 1.0


# ------------------------------------------------------------------ C9


class _Tok:
    def tokenize(self, s):
        return [2 + (ord(c) % 40) for c in s][:12]


def _batchers():
    """One tiny continuous batcher a package, the same weights, each on a
    plane of its own."""
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
    common = dict(tokenizer=_Tok(), n_steps=3, n_slots=2, name="cb-surface", mesh_span=False)
    return (JaxBatcher(params=jparams, cfg=jcfg, plane=jplane.DevicePlane(), **common),
            ContinuousBatcher(params=tparams, cfg=tcfg, plane=tplane.DevicePlane(), **common))


def test_batcher_queue_depth_and_close_match_the_reference():
    """Requests held before their first prefill count as queued; once
    answered, none; close() drains and leaves the plane without the
    batcher's programs, slot pool and cache lease."""
    prompts = [f"prompt {i}" for i in range(5)]
    seen = []
    for cb in _batchers():
        gate = threading.Event()
        init = cb._init_cache

        def held_init(init=init, gate=gate):
            assert gate.wait(60)
            return init()

        cb._init_cache = held_init
        depths = [cb.queue_depth()]
        futs = [cb.submit(p) for p in prompts]
        depths.append(cb.queue_depth())  # the decode thread waits in held_init
        gate.set()
        out = [f.result(timeout=120) for f in futs]
        cb.drain()
        depths.append(cb.queue_depth())
        plane = cb._plane
        assert f"{cb.name}/step" in plane.programs and f"{cb.name}/slots" in plane._slot_pools
        cb.close()
        left = ([p for p in plane.programs if p.startswith(cb.name)],
                [p for p in plane._slot_pools if p.startswith(cb.name)],
                [k for k in plane._leases if isinstance(k, tuple) and cb.name in k])
        seen.append((depths, out, left))
    assert seen[1] == seen[0]
    assert seen[0][0] == [0, len(prompts), 0] and seen[0][2] == ([], [], [])


def test_slot_pool_active_matches_the_reference():
    trace = []
    for pool in (jplane.SlotPool("p", 3), tplane.SlotPool("p", 3)):
        steps = [pool.active]
        a, b = pool.acquire(), pool.acquire()
        steps.append(pool.active)
        pool.release(a)
        steps.append(pool.active)
        c, d = pool.acquire(), pool.acquire()
        steps += [pool.active, pool.acquire(), pool.active]
        for s in (b, c, d):
            pool.release(s)
        steps.append(pool.active)
        trace.append(steps)
    assert trace[1] == trace[0] == [0, 2, 1, 3, None, 3, 0]


def test_compile_counts_and_total_compiles_match_the_reference():
    """The same dispatches on both planes: the shape ledger under the
    reference's names, {(program, bucket): n} and its total."""
    results = []
    for mod, xp in ((jplane, jnp), (tplane, torch)):
        plane = mod.DevicePlane()
        double = plane.program("double", lambda x: x * 2)
        total = plane.program("total", lambda x: x.sum())
        for n in (4, 4, 8, 4, 16):
            double(xp.ones(n), bucket=n)
        total(xp.ones(8), bucket=8)
        total(xp.ones((2, 4)), bucket=8)  # another shape in one bucket
        results.append((plane.compile_counts(), double.total_compiles, total.total_compiles))
    assert results[1] == results[0]
    assert results[0] == ({("double", 4): 1, ("double", 8): 1, ("double", 16): 1, ("total", 8): 2}, 3, 2)
    # the port's own names read the same ledger
    assert plane.shape_counts() == results[1][0]
    assert (double.total_shapes, total.total_shapes) == results[1][1:]
