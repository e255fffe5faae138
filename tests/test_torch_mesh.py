"""The port's device mesh, its collectives, the key-hash exchange and the
engine's two exchange hooks, against the JAX package.

Both sides run on 8 virtual CPU shards: the JAX package on the 8 host
devices of ``tests/conftest.py``, the port on ``PATHWAY_MESH_DEVICES=cpu*8``
(the ``mesh_env`` fixture). Inputs are seeded numpy arrays given to both.
The exchange moves bits, so every comparison here is exact: the same
valid slots, keys and payloads, the same per-destination arrival order,
the same engine outputs. Mirrors tests/test_parallel.py,
tests/test_column_plane.py and tests/test_rescale_exchange.py.
"""

import collections
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JAX_G
from pathway_tpu.parallel import exchange as jex
from pathway_tpu.parallel import mesh as jmesh
from pathway_tpu_torch.engine import faults
from pathway_tpu_torch.internals.keys import key_for_values
from pathway_tpu_torch.internals.parse_graph import G as PORT_G
from pathway_tpu_torch.parallel import column_plane as cp
from pathway_tpu_torch.parallel import device_exchange as dx
from pathway_tpu_torch.parallel import exchange as tex
from pathway_tpu_torch.parallel import spmd
from pathway_tpu_torch.parallel.mesh import (
    P,
    Sharded,
    assemble,
    default_mesh,
    make_mesh,
    replicate,
    shard_rows,
)
from tests.test_torch_parity import align_row_ids

REPO = Path(__file__).resolve().parent.parent
N_DEV = 8


@pytest.fixture(autouse=True)
def mesh_env(monkeypatch):
    """8 virtual CPU shards for every mesh the port builds itself, fresh
    engine exchangers, and clean parse graphs."""
    monkeypatch.setenv("PATHWAY_MESH_DEVICES", f"cpu*{N_DEV}")
    monkeypatch.delenv("PATHWAY_DEVICE_EXCHANGE", raising=False)
    monkeypatch.setattr(dx, "_ENGINE_EXCHANGER", None)
    monkeypatch.setattr(cp, "_ENGINE_EXCHANGER", None)
    JAX_G.clear()
    PORT_G.clear()
    align_row_ids()
    yield
    JAX_G.clear()
    PORT_G.clear()


def _meshes():
    return jmesh.default_mesh(("data",)), default_mesh(("data",))


# ------------------------------------------------------------------ mesh


def test_make_mesh_shapes():
    mesh = make_mesh((N_DEV,), ("data",))
    assert mesh.shape["data"] == N_DEV
    mesh2 = make_mesh((N_DEV // 2, 2), ("data", "model"))
    assert mesh2.shape == {"data": N_DEV // 2, "model": 2}
    assert mesh2.coords(3) == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="devices"):
        make_mesh((N_DEV * 2,), ("data",))
    jm = jmesh.make_mesh((N_DEV // 2, 2), ("data", "model"))
    assert dict(jm.shape) == mesh2.shape


def test_default_mesh_reads_the_device_setting(monkeypatch):
    assert default_mesh().shape == {"data": N_DEV}
    monkeypatch.setenv("PATHWAY_MESH_DEVICES", "cpu,cpu*3")
    assert [str(d) for d in default_mesh(("x",)).devices.flat] == ["cpu"] * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("PATHWAY_MESH_DEVICES", "cuda:0*4")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_mesh()
    monkeypatch.delenv("PATHWAY_MESH_DEVICES")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_mesh()


def test_sharded_arrays_place_and_gather():
    mesh = make_mesh((4, 2), ("data", "model"))
    x = torch.arange(48.0).reshape(8, 6)
    s = shard_rows(x, mesh)
    assert [tuple(t.shape) for t in s.shards] == [(2, 6)] * 8
    assert torch.equal(s.shards[2], x[2:4]) and torch.equal(assemble(s.shards, s.spec, mesh), x)
    both = Sharded.from_global(x, mesh, P("data", "model"))
    assert tuple(both.shards[3].shape) == (2, 3) and torch.equal(assemble(both.shards, both.spec, mesh), x)
    assert both.shard_bytes() == [2 * 3 * 4] * 8
    rep = replicate(x, mesh)
    assert all(torch.equal(t, x) for t in rep.shards) and rep.shards[0] is not rep.shards[1]


# ----------------------------------------------------------- collectives


def test_collectives_order_by_shard_index():
    mesh = make_mesh((4, 2), ("data", "model"))
    x = torch.arange(16.0).reshape(8, 2)

    def body(a):
        i = spmd.axis_index("data")
        tot = spmd.psum(a.sum(), "data")
        mx = spmd.pmax(a.max(), "data")
        g = spmd.all_gather(a, "model")
        r = spmd.ppermute(a, "data", [(j, (j + 1) % 4) for j in range(4)])
        t = spmd.all_to_all(torch.arange(4.0).view(4, 1) + 10 * i, "data", 0, 0)
        return tot.expand(2, 2), mx.expand(2, 2), g[:, :1, :].reshape(2, 2), r, t.view(2, 2)

    tot, mx, g, r, t = spmd.shard_map(body, mesh, (P("data"),), (P("data"),) * 5)(x)
    assert torch.equal(tot, torch.full((8, 2), 120.0))
    assert torch.equal(mx, torch.full((8, 2), 15.0))
    assert torch.equal(r, torch.roll(x, 2, dims=0))  # each block moved one shard on
    # shard i received piece i of every shard: 10*j + i for j in order
    want = torch.tensor([[10.0 * j + i for j in range(4)] for i in range(4)]).view(8, 2)
    assert torch.equal(t, want)
    assert torch.equal(g[:2], torch.tensor([[0.0, 1.0], [0.0, 1.0]]))


def test_a_raising_shard_aborts_the_run():
    mesh = make_mesh((N_DEV,), ("data",))

    def boom(a):
        if spmd.axis_index("data") == 3:
            raise ValueError("shard 3 failed")
        return spmd.psum(a, "data")

    with pytest.raises(ValueError, match="shard 3 failed"):
        spmd.shard_map(boom, mesh, (P("data"),), P("data"))(torch.ones(N_DEV))

    def mismatched(a):
        return a if spmd.axis_index("data") == 1 else spmd.psum(a, "data")

    with pytest.raises(RuntimeError, match="different collectives"):
        spmd.shard_map(mismatched, mesh, (P("data"),), P("data"))(torch.ones(N_DEV))
    with pytest.raises(RuntimeError, match="outside a shard_map"):
        spmd.psum(torch.ones(1), "data")
    # the mesh serves the next call after both failures
    out = spmd.shard_map(lambda a: spmd.psum(a, "data"), mesh, (P("data"),), P("data"))(torch.ones(N_DEV))
    assert torch.equal(out, torch.full((N_DEV,), float(N_DEV)))


def test_collectives_carry_gradients():
    mesh = make_mesh((N_DEV,), ("data",))
    x = torch.arange(16.0).reshape(8, 2).requires_grad_()

    def body(a):
        nxt = spmd.ppermute(a, "data", [(j, (j + 1) % N_DEV) for j in range(N_DEV)])
        return spmd.psum((a * nxt).sum(), "data")

    y = spmd.shard_map(body, mesh, (P("data"),), P())(x)
    y.backward()
    want = torch.roll(x.detach(), 1, 0) + torch.roll(x.detach(), -1, 0)
    assert torch.equal(x.grad, want)


# ----------------------------------------------------------- the exchange


def test_exchange_routes_by_key_hash_like_jax():
    jm, tm = _meshes()
    rng = np.random.default_rng(0)
    n = N_DEV * 16
    keys = rng.integers(0, 2**31, n).astype(np.uint32)
    pay = rng.normal(size=(n, 4)).astype(np.float32)
    jres = jex.exchange_by_key(
        jmesh.shard_rows(keys, jm), jmesh.shard_rows(pay, jm), jm
    )
    tres = tex.exchange_by_key(keys, pay, tm)
    assert not bool(tres.overflowed) and not bool(jres.overflowed)
    v = tres.valid.numpy()
    assert np.array_equal(v, np.asarray(jres.valid))
    assert np.array_equal(tres.keys.numpy()[v], np.asarray(jres.keys)[v].astype(np.int64))
    assert np.array_equal(tres.payloads.numpy()[v], np.asarray(jres.payloads)[v])
    assert int(v.sum()) == n
    for s in range(N_DEV):
        assert all(int(k) % N_DEV == s for k in tres.keys.numpy()[s][v[s]])


def test_exchange_overflow_flag():
    jm, tm = _meshes()
    n = N_DEV * 8
    keys = np.zeros(n, np.uint32)
    pay = np.ones((n, 2), np.float32)
    tres = tex.exchange_by_key(keys, pay, tm, capacity=4)
    jres = jex.exchange_by_key(jmesh.shard_rows(keys, jm), jmesh.shard_rows(pay, jm), jm, capacity=4)
    assert bool(tres.overflowed) and bool(jres.overflowed)
    with pytest.raises(ValueError, match="dests outside"):
        tex.exchange_by_key(keys, pay, tm, dests=np.full(n, N_DEV))


def test_partition_counts():
    keys = np.asarray([0, 1, 2, 3, 4, 8, 12], np.uint32)
    assert tex.partition_counts(torch.from_numpy(keys.astype(np.int64)), 4).tolist() == [4, 1, 1, 1]
    assert np.asarray(jex.partition_counts(keys, 4)).tolist() == [4, 1, 1, 1]


def _skew(kind: str, n: int, rng) -> np.ndarray:
    if kind == "one_dest":
        return np.full(n, 2 % N_DEV, np.int64)
    if kind == "all_to_zero":
        return np.zeros(n, np.int64)
    if kind == "seventy_percent":
        return np.where(rng.random(n) < 0.7, 1, rng.integers(0, N_DEV, n)).astype(np.int64)
    return rng.integers(0, N_DEV, n).astype(np.int64)


@pytest.mark.parametrize(
    "kind,n,capacity",
    [("one_dest", N_DEV * 8, 2), ("all_to_zero", 512, 8), ("seventy_percent", 1024, 16),
     ("uniform", 1000, None), ("seventy_percent", 999, None)],
)
def test_respill_matches_jax(kind, n, capacity):
    """Rows arrive once each, at their shard, in global arrival order,
    across as many rounds as the skew takes; identical to the JAX
    package's outputs."""
    jm, tm = _meshes()
    rng = np.random.default_rng(7)
    ids = np.arange(n, dtype=np.uint32)
    pay = rng.normal(size=(n, 3)).astype(np.float32)
    dests = _skew(kind, n, rng)
    if kind == "seventy_percent" and capacity:
        max_bucket = max(collections.Counter(zip(np.arange(n) * N_DEV // n, dests)).values())
        assert -(-max_bucket // capacity) >= 3, "the input must force >= 3 rounds"
    tk, tp, ts = tex.exchange_with_respill(ids, pay, dests, tm, capacity=capacity)
    jk, jp, js = jex.exchange_with_respill(ids, pay, dests, jm, capacity=capacity)
    for d in range(N_DEV):
        idx = np.nonzero(dests == d)[0]
        assert np.array_equal(ts[d], idx) and np.array_equal(js[d], idx)
        assert np.array_equal(tp[d], pay[idx]) and np.array_equal(tp[d], jp[d])
        assert np.array_equal(tk[d], ids[idx]) and tk[d].dtype == ids.dtype


def test_route128_matches_jax_and_the_128_bit_rule():
    jm, tm = _meshes()
    rng = np.random.default_rng(3)
    n = N_DEV * 4
    lo = rng.integers(0, 2**63, n, dtype=np.uint64)
    hi = rng.integers(0, 2**63, n, dtype=np.uint64)
    dests = tex.route128(lo, hi, N_DEV)
    assert np.array_equal(dests, jex.route128(lo, hi, N_DEV))
    for i in range(n):
        assert dests[i] == ((int(hi[i]) << 64) | int(lo[i])) % N_DEV
    pay = rng.normal(size=(n, 2)).astype(np.float32)
    _k, pays, srcs = tex.exchange_with_respill(np.arange(n, dtype=np.uint32), pay, dests, tm)
    for d in range(N_DEV):
        for j, i in enumerate(srcs[d]):
            assert dests[int(i)] == d
            np.testing.assert_array_equal(pays[d][j], pay[int(i)])


def test_column_exchange_bit_exact_u64_i64():
    jm, tm = _meshes()
    rng = np.random.default_rng(3)
    n = 700
    lo = (rng.integers(0, 2**63, n).astype(np.uint64) * 2) + 1
    hi = rng.integers(0, 2**63, n).astype(np.uint64) + (1 << 63)
    tok = rng.integers(0, 1 << 40, n).astype(np.uint64)
    diff = rng.choice([-3, -1, 1, 2], n).astype(np.int64)
    dests = rng.integers(0, N_DEV, n).astype(np.int64)
    cols, srcs = tex.exchange_columns_with_respill([lo, hi, tok, diff], dests, tm)
    jcols, _ = jex.exchange_columns_with_respill([lo, hi, tok, diff], dests, jm)
    for d in range(N_DEV):
        idx = np.nonzero(dests == d)[0]
        assert np.array_equal(srcs[d], idx)
        for got, ref, src in zip(cols[d], jcols[d], (lo, hi, tok, diff)):
            assert got.dtype == src.dtype and np.array_equal(got, src[idx])
            assert np.array_equal(got, ref)


def test_single_round_layout_for_uniform_waves(monkeypatch):
    """Near-uniform waves take one "donated" round, skewed waves several
    undonated ones, on the same decisions as the JAX package."""
    jm, tm = _meshes()
    flags = {"jax": [], "port": []}
    for name, mod in (("jax", jex), ("port", tex)):
        orig = mod.exchange_by_key

        def spy(*args, _orig=orig, _name=name, **kwargs):
            flags[_name].append(kwargs.get("donate", False))
            return _orig(*args, **kwargs)

        monkeypatch.setattr(mod, "exchange_by_key", spy)
    rng = np.random.default_rng(4)
    n = 10_000
    ids = np.arange(n, dtype=np.uint32)
    pay = rng.normal(size=(n, 2)).astype(np.float32)
    hashed = rng.integers(0, N_DEV, n).astype(np.int64)
    skewed = np.where(rng.random(n) < 0.8, 0, rng.integers(0, N_DEV, n)).astype(np.int64)
    for dests, single in ((hashed, True), (skewed, False)):
        _k, tp, ts = tex.exchange_with_respill(ids, pay, dests, tm)
        jex.exchange_with_respill(ids, pay, dests, jm)
        assert flags["port"] == flags["jax"]
        assert flags["port"] == [True] if single else (len(flags["port"]) > 1 and not any(flags["port"]))
        for d in range(N_DEV):
            idx = np.nonzero(dests == d)[0]
            assert np.array_equal(ts[d], idx) and np.array_equal(tp[d], pay[idx])
        flags["port"].clear()
        flags["jax"].clear()
    # the program ledger charges one bucket per capacity
    from pathway_tpu_torch.engine.device_plane import get_device_plane

    rows = [k for k in get_device_plane().shape_counts() if k[0].startswith("exchange.a2a[data]:s8")]
    assert rows and all(v == 1 for k, v in get_device_plane().shape_counts().items() if k in rows)


def test_host_device_routing_parity_under_key_skew():
    from pathway_tpu_torch.engine.native import dataplane as dp
    from pathway_tpu_torch.engine.workers import _shard_of
    from pathway_tpu_torch.internals.keys import Key

    if not dp.available():
        pytest.skip("native dataplane unavailable")
    rng = np.random.default_rng(11)
    lo = np.concatenate([
        np.arange(256, dtype=np.uint64),
        rng.integers(0, 2**64 - 1, 256, dtype=np.uint64),
        np.full(64, 0xDEADBEEF, np.uint64),
    ])
    hi = np.concatenate([
        np.zeros(256, np.uint64),
        rng.integers(0, 2**64 - 1, 256, dtype=np.uint64),
        np.arange(64, dtype=np.uint64) << 32,
    ])
    for n_shards in (2, 3, 4, 7, 8):
        via_c = dp.route_key(lo, hi, n_shards)
        assert np.array_equal(via_c, tex.route128(lo, hi, n_shards))
        assert np.array_equal(via_c, jex.route128(lo, hi, n_shards))
        for i in range(0, len(lo), 37):
            key = Key((int(hi[i]) << 64) | int(lo[i]))
            assert _shard_of(key.value, n_shards) == via_c[i]


# ------------------------------------------------------ the vector plane


def _groupby_rows(pw):
    rows = [(f"cat{i % 5}", np.full(16, float(i), np.float32)) for i in range(64)]
    t = pw.Table.from_rows(pw.schema_from_types(cat=str, emb=np.ndarray), rows)
    res = t.groupby(t.cat).reduce(t.cat, n=pw.reducers.count())
    return sorted(map(tuple, pw.debug.table_to_pandas(res).values.tolist()))


def test_engine_groupby_routes_vectors_through_device_exchange(monkeypatch):
    monkeypatch.setenv("PATHWAY_THREADS", "4")
    base = _groupby_rows(tpw)
    PORT_G.clear()
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "1")
    got = _groupby_rows(tpw)
    ex = dx._ENGINE_EXCHANGER
    assert ex is not None and ex.invocations > 0, "device exchange not taken"
    assert ex.rows_exchanged >= 64
    from pathway_tpu.parallel import device_exchange as jdx

    monkeypatch.setattr(jdx, "_ENGINE_EXCHANGER", None)
    ref = _groupby_rows(jpw)
    assert got == base == ref == [(f"cat{i}", 13 if i < 4 else 12) for i in range(5)]


def test_device_exchange_auto_mode_policy(monkeypatch):
    assert dx.mode() == "auto"
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "1")
    assert dx.mode() == "force" and dx.enabled()
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "0")
    assert dx.mode() == "off" and not dx.enabled() and dx.engine_exchanger() is None
    monkeypatch.delenv("PATHWAY_DEVICE_EXCHANGE")
    # shards of one device (here the CPU) are never auto-eligible, and
    # auto on a machine without two CUDA devices builds no exchanger
    assert dx.engine_exchanger() is None
    ex = dx.DeviceExchanger()
    assert not ex._auto_ok and ex._mode == "auto"
    entries = [(key_for_values(i), (i, np.ones(1024, np.float32)), 1) for i in range(1024)]
    assert ex.try_exchange(entries, lambda k, r: k.value % 2, 2) is None
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "1")
    assert ex._mode == "auto"  # read at construction, not per batch
    assert ex.try_exchange(entries, lambda k, r: k.value % 2, 2) is None
    monkeypatch.delenv("PATHWAY_DEVICE_EXCHANGE")
    ex._auto_ok = True  # an eligible mesh above the crossover engages
    routed = ex.try_exchange(entries, lambda k, r: k.value % 2, 2)
    assert routed is not None and sum(len(r) for r in routed) == 1024
    assert ex.try_exchange(entries[:64], lambda k, r: k.value % 2, 2) is None
    devs = np.empty(2, object)
    devs[:] = [torch.device("cuda", 0), torch.device("cuda", 1)]
    from pathway_tpu_torch.parallel.mesh import Mesh

    assert dx.auto_eligible_mesh(Mesh(devs, ("data",)))
    devs[:] = [torch.device("cuda", 0)] * 2
    assert not dx.auto_eligible_mesh(Mesh(devs, ("data",)))


def test_device_exchange_int32_bit_exact(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "1")
    ex = dx.DeviceExchanger()
    rng = np.random.default_rng(3)
    vals = [rng.integers(-(2**31) + 1, 2**31 - 1, 16, dtype=np.int32) for _ in range(32)]
    entries = [(key_for_values(i), (i, v), 1) for i, v in enumerate(vals)]
    routed = ex.try_exchange(entries, lambda k, r: k.value % 2, 2)
    got = {row[0]: row[1] for shard in routed for _k, row, _d in shard}
    for i, v in enumerate(vals):
        assert got[i].dtype == np.int32 and np.array_equal(got[i], v), i


def _route(key, row):
    return key.value % 2


def _bad_route(key, row):
    raise RuntimeError("route boom")


INELIGIBLE = {
    "too_few_rows": ([(i, np.ones(4, np.float32)) for i in range(4)], _route, 2),
    "no_vector_columns": ([(i, "s", 1.5) for i in range(16)], _route, 2),
    "f64_columns": ([(i, np.ones(4, np.float64)) for i in range(16)], _route, 2),
    "ragged_rows": ([(i, np.ones(4 + (i % 2), np.float32)) for i in range(16)], _route, 2),
    "dtype_flips": ([(i, np.ones(4, np.float32 if i < 8 else np.float64)) for i in range(16)], _route, 2),
    "more_shards_than_mesh": ([(i, np.ones(4, np.float32)) for i in range(16)], _route, N_DEV + 1),
    "failing_route": ([(i, np.ones(4, np.float32)) for i in range(16)], _bad_route, 2),
}


@pytest.mark.parametrize("case", sorted(INELIGIBLE))
def test_ineligible_batches_take_the_host_wire(case, monkeypatch):
    """The eligibility gates decide before any dispatch, as the JAX
    package's (tests/test_rescale_exchange.py)."""
    from pathway_tpu.internals.keys import key_for_values as jkey
    from pathway_tpu.parallel import device_exchange as jdx

    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "1")
    rows, route, n_shards = INELIGIBLE[case]
    tent = [(key_for_values(r[0]), r, 1) for r in rows]
    jent = [(jkey(r[0]), r, 1) for r in rows]
    assert dx.DeviceExchanger().try_exchange(tent, route, n_shards) is None
    assert jdx.DeviceExchanger().try_exchange(jent, route, n_shards) is None


def test_exchange_preserves_rows_and_routing(monkeypatch):
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "1")
    ex = dx.DeviceExchanger()
    rng = np.random.default_rng(11)
    entries = [(key_for_values(i), (i, rng.normal(size=8).astype(np.float32)), 1) for i in range(64)]
    routed = ex.try_exchange(entries, _route, 2)
    seen = 0
    for s, ents in enumerate(routed):
        assert [row[0] for _k, row, _d in ents] == sorted(row[0] for _k, row, _d in ents)
        for key, row, _diff in ents:
            assert _route(key, row) == s
            assert row[1].dtype == np.float32 and np.array_equal(row[1], entries[row[0]][1][1])
            seen += 1
    assert seen == len(entries)


def test_a_failed_device_exchange_raises(monkeypatch):
    """Past the gates nothing degrades: a failing exchange raises (the
    JAX package has no host path here either), and a forced mode with no
    mesh to build raises where the JAX package returns None."""
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "1")
    ex = dx.DeviceExchanger()

    def broken(*args, **kwargs):
        raise RuntimeError("wire down")

    monkeypatch.setattr(dx, "exchange_with_respill", broken)
    entries = [(key_for_values(i), (i, np.ones(4, np.float32)), 1) for i in range(16)]
    with pytest.raises(RuntimeError, match="wire down"):
        ex.try_exchange(entries, _route, 2)
    monkeypatch.delenv("PATHWAY_MESH_DEVICES")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for hook in (dx.engine_exchanger, cp.engine_column_exchanger):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hook()


def _vec_rows(n=24, dim=6):
    rng = np.random.default_rng(5)
    return [(f"k{i}", i % 4, rng.normal(size=dim).astype(np.float32)) for i in range(n)]


def _build_vec_pipeline(pw):
    t = pw.debug.table_from_rows(
        pw.schema_from_types(k=str, grp=int, vec=np.ndarray), _vec_rows()
    ).with_id_from(pw.this.k)
    return t.groupby(t.grp).reduce(
        grp=t.grp,
        n=pw.reducers.count(),
        s=pw.reducers.sum(pw.apply_with_type(lambda v: float(v.sum()), float, t.vec)),
    )


def _captured(pw, lowering):
    s = lowering.Session()
    cap = s.capture(_build_vec_pipeline(pw))
    s.execute()
    return s, {tuple(r) for r in cap.state.rows.values()}


@pytest.mark.parametrize("n1,n2", [(1, 3), (3, 2)])
def test_rescale_with_device_exchange_forced(tmp_path, monkeypatch, n1, n2):
    """Snapshot at N threads with the device exchange forced, restore at
    M: the rows equal the host-wire run and the JAX package's."""
    from pathway_tpu_torch.internals import lowering
    from pathway_tpu_torch.persistence import Backend, CheckpointManager, Config

    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "1")
    cfg = Config(Backend.filesystem(str(tmp_path)))
    monkeypatch.setenv("PATHWAY_THREADS", str(n1))
    s1, rows1 = _captured(tpw, lowering)
    CheckpointManager(s1, cfg).checkpoint(finalized_time=100)
    monkeypatch.setenv("PATHWAY_THREADS", str(n2))
    PORT_G.clear()
    s2 = lowering.Session()
    cap2 = s2.capture(_build_vec_pipeline(tpw))
    m2 = CheckpointManager(s2, cfg)
    m2.restore()
    assert m2.restored
    assert {tuple(r) for r in cap2.state.rows.values()} == rows1
    if n1 > 1:  # the snapshot run had shards to exchange between
        assert dx._ENGINE_EXCHANGER.invocations > 0
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "0")
    PORT_G.clear()
    assert _captured(tpw, lowering)[1] == rows1
    from pathway_tpu.internals import lowering as jlowering

    assert _captured(jpw, jlowering)[1] == rows1


def test_sharded_vec_groupby_device_vs_host_equal(monkeypatch):
    from pathway_tpu_torch.internals import lowering

    results = {}
    monkeypatch.setenv("PATHWAY_THREADS", "3")
    for mode in ["1", "0", None]:
        if mode is None:
            monkeypatch.delenv("PATHWAY_DEVICE_EXCHANGE", raising=False)
        else:
            monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", mode)
        PORT_G.clear()
        results[mode] = _captured(tpw, lowering)[1]
    assert results["1"] == results["0"] == results[None]


# ------------------------------------------------------- the column plane


def _native_batch(n, rng):
    from pathway_tpu_torch.engine.native import dataplane as dp

    tab = dp.default_table()
    tok = np.empty(n, np.uint64)
    for i in range(n):
        tok[i] = tab.intern_row((f"row{i % 50}", i % 13))
    lo = rng.integers(0, 2**63, n).astype(np.uint64)
    hi = rng.integers(0, 2**63, n).astype(np.uint64)
    diff = rng.choice([-1, 1], n).astype(np.int64)
    return dp.NativeBatch(tab, lo, hi, tok, diff)


def _native_or_skip():
    from pathway_tpu_torch.engine.native import dataplane as dp

    if not dp.available():
        pytest.skip("native dataplane unavailable")
    return dp


def test_split_batch_matches_host_select_byte_for_byte(monkeypatch):
    dp = _native_or_skip()
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "1")
    batch = _native_batch(400, np.random.default_rng(5))
    shards = np.asarray(dp.route_key(batch.key_lo, batch.key_hi, 4), np.int64)
    subs = cp.ColumnExchanger().split_batch(batch, shards, 4)
    for p in range(4):
        ref = batch.select(shards == p)
        got = subs[p]
        for col in ("key_lo", "key_hi", "token", "diff"):
            assert np.array_equal(getattr(got, col), getattr(ref, col)), col
        assert got.materialize() == ref.materialize()


def test_split_batch_gating(monkeypatch):
    dp = _native_or_skip()
    batch = _native_batch(64, np.random.default_rng(6))
    shards = np.asarray(dp.route_key(batch.key_lo, batch.key_hi, 2), np.int64)
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "0")
    assert cp.ColumnExchanger().split_batch(batch, shards, 2) is None
    monkeypatch.delenv("PATHWAY_DEVICE_EXCHANGE")
    assert cp.ColumnExchanger().split_batch(batch, shards, 2) is None  # auto: shards of one device
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "1")
    assert cp.ColumnExchanger().split_batch(batch, shards, 2) is not None
    assert cp.ColumnExchanger().split_batch(batch, shards, N_DEV + 1) is None


def test_device_wire_fault_retries_once_then_raises(monkeypatch):
    """A lone mesh.device_wire shot is retried in place; a second shot
    raises (the JAX package degrades to the host wire there)."""
    dp = _native_or_skip()
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "1")
    batch = _native_batch(128, np.random.default_rng(9))
    shards = np.asarray(dp.route_key(batch.key_lo, batch.key_hi, 2), np.int64)
    cp.reset_stats()
    faults.install("mesh.device_wire@1+")
    try:
        ce = cp.ColumnExchanger()
        with pytest.raises(faults.FaultInjected):
            ce.split_batch(batch, shards, 2)
        assert cp.stats() == {"invocations": 0, "rows": 0, "wire_faults": 2}
        faults.install("mesh.device_wire@1")
        assert ce.split_batch(batch, shards, 2) is not None
        assert cp.stats() == {"invocations": 1, "rows": 128, "wire_faults": 3}
    finally:
        faults.reset()
        cp.reset_stats()


def test_planner_retunes_column_plane_without_vector_exchanger(monkeypatch):
    from pathway_tpu_torch.internals.planner import AdaptivePolicy

    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "1")
    ce = cp.ColumnExchanger()
    monkeypatch.setattr(cp, "_ENGINE_EXCHANGER", ce)

    class _Metrics:
        def __init__(self, inv, rows):
            self._v = {"pathway_device_exchange_invocations": inv, "pathway_device_exchange_rows": rows}

        def counter_value(self, name):
            return self._v.get(name, 0)

        def counter(self, name, inc=1, help=None):
            pass

    class _Plane:
        def __init__(self, inv, rows):
            self.metrics = _Metrics(inv, rows)

        def record(self, *args, **kwargs):
            pass

    pol = AdaptivePolicy(graph=None, min_rows_per_exchange=64)
    base = ce._auto_min_rows
    assert pol._retune_exchange(_Plane(10, 80)) == 1
    assert ce._auto_min_rows == base * 2
    assert pol._retune_exchange(_Plane(10, 10 * 64 * 8)) == 1
    assert ce._auto_min_rows == base
    burned = pol._exchange_tuned
    assert pol._retune_exchange(_Plane(10, 10 * 64)) == 0
    assert pol._exchange_tuned == burned


def _run_wordcount(tmp_path: Path, tag: str, env_extra: dict) -> tuple[str, dict]:
    inp = tmp_path / "in.jsonl"
    if not inp.exists():
        inp.write_text("".join('{"word": "w%d"}\n' % (i % 61) for i in range(3000)))
    out = tmp_path / f"out_{tag}.csv"
    code = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
import pathway_tpu_torch as pw
from pathway_tpu_torch.parallel import column_plane

t = pw.io.jsonlines.read({str(inp)!r}, schema=pw.schema_from_types(word=str), mode="static")
res = t.groupby(t.word).reduce(t.word, n=pw.reducers.count())
pw.io.csv.write(res, {str(out)!r})
pw.run()
print("STATS " + json.dumps(column_plane.stats()))
"""
    env = {**os.environ, "PATHWAY_MESH_DEVICES": f"cpu*{N_DEV}", "PATHWAY_THREADS": "4", **env_extra}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    stats = json.loads([ln for ln in r.stdout.splitlines() if ln.startswith("STATS ")][-1][6:])
    return out.read_text(), stats


def test_engine_shuffle_device_vs_host_byte_identical(tmp_path):
    """PATHWAY_DEVICE_EXCHANGE=0 reproduces the forced column plane's
    shuffled output byte for byte, and the forced run rode the mesh."""
    _native_or_skip()
    dev, dev_stats = _run_wordcount(tmp_path, "dev", {"PATHWAY_DEVICE_EXCHANGE": "1"})
    host, host_stats = _run_wordcount(tmp_path, "host", {"PATHWAY_DEVICE_EXCHANGE": "0"})
    assert dev == host
    assert dev_stats["invocations"] > 0 and host_stats["invocations"] == 0
