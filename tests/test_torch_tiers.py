"""The port's tiered IVF-PQ index and its spill store against the JAX
package's.

Ports the tier cases of ``tests/test_index_tiers.py`` onto the same corpora
(`_clustered`, the same seeds). Each deterministic case feeds one stream
into both packages' ``IvfPqIndex(tiered=True)`` on the CPU and holds the
port to the reference: the same tier placement after every rebalance, the
same promotions and demotions, and the same rankings. Searches that reach
a warm or cold list run the numpy search over the probed union in both
packages, so their results must be equal, distances included; the
all-hot route runs the port's torch search against the JAX package's XLA
search and agrees under ``tests/test_torch_ann.py``'s rule. The concurrent
churn cases race a migration thread, so they hold the port to the
invariants alone.

Also here: the spill store's seq order under a seal that races a
compaction, made deterministic by holding the seal's file write on an
event. The port's store takes a run's seq where the run enters the list;
the reference's copy takes it before the write and still fails the check.
"""

from __future__ import annotations

import pickle
import threading

import numpy as np
import pytest
import torch

import pathway_tpu.engine.spill as jspill
import pathway_tpu_torch.engine.spill as tspill
from pathway_tpu.indexing import IvfPqIndex as JaxIvfPqIndex
from pathway_tpu.indexing import tiered_enabled as jax_tiered_enabled
from pathway_tpu.internals.keys import Key
from pathway_tpu.internals.parse_graph import G as JAX_G
from pathway_tpu_torch.engine.device_plane import get_device_plane
from pathway_tpu_torch.indexing import (
    TIER_COLD,
    TIER_HOT,
    IvfPqIndex,
    tiered_enabled,
    verify_tier_state,
)
from pathway_tpu_torch.internals.parse_graph import G as PORT_G
from pathway_tpu_torch.internals.verifier import PlanVerificationError
from pathway_tpu_torch.stdlib.indexing.host_indexes import VectorSlabIndex

DIM = 32


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    JAX_G.clear()
    PORT_G.clear()
    monkeypatch.delenv("PATHWAY_ANN", raising=False)
    monkeypatch.delenv("PATHWAY_ANN_TIERED", raising=False)
    saved = [(m, m._ROOT, m._PERSISTENT) for m in (jspill, tspill)]
    jspill.set_root(str(tmp_path / "jax"), persistent=True)
    tspill.set_root(str(tmp_path / "port"), persistent=True)
    yield
    JAX_G.clear()
    PORT_G.clear()
    for m, root, persistent in saved:
        with m._ROOT_LOCK:
            m._ROOT, m._PERSISTENT = root, persistent


def _clustered(n: int, seed: int = 0, n_clusters: int = 40) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, DIM))
    return (centers[rng.integers(0, n_clusters, n)] + 0.15 * rng.normal(size=(n, DIM))).astype(np.float32)


def _load(index, docs: np.ndarray, start: int = 0) -> list[Key]:
    keys = [Key(start + i) for i in range(len(docs))]
    for key, vec in zip(keys, docs):
        index.add(key, vec)
    return keys


def _pair(docs, *, hot=4, ram=10, device="cpu", **kw):
    """The port's and the JAX package's trained tiered index over one
    stream, the rebalance daemons off (the tests migrate by hand)."""
    opts = dict(
        dimensions=DIM, background_retrain=False, seed=0, tiered=True,
        hot_lists=hot, ram_lists=ram, background_tiering=False, **kw,
    )
    port = IvfPqIndex(device=device, **opts)
    ref = JaxIvfPqIndex(**({"device": False} if device is False else {}), **opts)
    _load(port, docs)
    _load(ref, docs)
    assert port.stats()["trained"] and ref.stats()["trained"]
    _assert_same_placement(port, ref)
    return port, ref


def _assert_same_placement(port, ref):
    pt, rt = port._tiers, ref._tiers
    assert np.array_equal(pt.tier, rt.tier)
    assert (pt.promotions, pt.demotions) == (rt.promotions, rt.demotions)
    assert port.stats()["tiers"] == ref.stats()["tiers"]
    assert port._gen.cube.tobytes() == ref._gen.cube.tobytes()


def _both(port, ref, fn, *args):
    got, want = getattr(port, fn)(*args), getattr(ref, fn)(*args)
    assert got == want
    return got


def _recall_at(res, ref, k: int = 10) -> float:
    vals = []
    for a, b in zip(res, ref):
        got = {key for key, _ in a[:k]}
        want = {key for key, _ in b[:k]}
        vals.append(len(got & want) / max(len(want), 1))
    return float(np.mean(vals))


def _assert_agree(got, want):
    """tests/test_torch_ann.py's rule: the top-1 identical, keys equal at
    >= 99% of ranks, distances within 1e-5 where the keys agree."""
    assert len(got) == len(want)
    ranks = same = 0
    for g, w in zip(got, want):
        assert len(g) == len(w) and g[0][0] == w[0][0]
        for (gk, gd), (wk, wd) in zip(g, w):
            ranks += 1
            if gk == wk:
                same += 1
                np.testing.assert_allclose(gd, wd, atol=1e-5)
    assert same >= 0.99 * ranks


# ------------------------------------------------- placement + recall


def test_tiered_recall_through_the_cold_ladder():
    docs = _clustered(3000, seed=0)
    port, ref = _pair(docs)
    moved = _both(port, ref, "rebalance_tiers_now")
    assert moved["to_cold"] > 0
    _assert_same_placement(port, ref)
    assert port.stats()["tiers"]["lists_per_tier"]["cold"] > 0
    ex = VectorSlabIndex(dimensions=DIM, device=False)
    _load(ex, docs)
    rng = np.random.default_rng(1)
    q = docs[rng.choice(len(docs), 40)] + 0.05 * rng.normal(size=(40, DIM))
    items = [(q[i], 10, None) for i in range(len(q))]
    res = _both(port, ref, "search_batch", items)
    assert _recall_at(res, ex.search_batch(items)) >= 0.95
    assert port.counters["tier_host_searches"] == 1
    verify_tier_state(port)


def test_probe_promotes_hot_lists_on_access():
    docs = _clustered(2000, seed=3)
    port, ref = _pair(docs, hot=2, ram=4)
    _both(port, ref, "rebalance_tiers_now")
    ts, gen = port._tiers, port._gen
    cold = [lst for lst in ts.cold_lists() if gen.fill[lst] > 0]
    assert cold
    target = cold[0]
    slots = gen.slots[target][gen.valid[target]]
    q = port.vectors[slots[:8]].astype(np.float32)
    for _ in range(6):
        _both(port, ref, "search_batch", [(qi, 5, None) for qi in q])
        _both(port, ref, "rebalance_tiers_now")
        _assert_same_placement(port, ref)
    assert ts.promotions > 0
    assert ts.tier[target] != TIER_COLD, "the hammered list must warm up"
    verify_tier_state(port)


def test_append_into_cold_list_promotes_first():
    docs = _clustered(2000, seed=2)
    port, ref = _pair(docs, hot=2, ram=4)
    _both(port, ref, "rebalance_tiers_now")
    ts = port._tiers
    assert np.any(ts.tier == TIER_COLD)
    before = ts.promotions
    extra = _clustered(200, seed=7)
    keys = _load(port, extra, start=10_000)
    _load(ref, extra, start=10_000)
    assert ts.promotions > before, "no add ever landed in a cold list?"
    _assert_same_placement(port, ref)
    res = _both(port, ref, "search_batch", [(extra[i], 5, None) for i in range(0, 200, 20)])
    for i, matches in zip(range(0, 200, 20), res):
        assert keys[i] in {key for key, _ in matches}
    verify_tier_state(port)


def test_tombstone_on_cold_list_stays_on_ram_flags():
    docs = _clustered(1500, seed=6)
    port, ref = _pair(docs, hot=2, ram=4)
    _both(port, ref, "rebalance_tiers_now")
    ts, gen = port._tiers, port._gen
    cold = [lst for lst in ts.cold_lists() if gen.fill[lst] > 0]
    assert cold
    lst = cold[0]
    pos = int(np.flatnonzero(gen.valid[lst])[0])
    slot = int(gen.slots[lst, pos])
    key = port.key_of[slot]
    vec = port.vectors[slot].astype(np.float32).copy()
    _both(port, ref, "remove", key)
    assert ts.tier[lst] == TIER_COLD, "a retract must not promote"
    _assert_same_placement(port, ref)
    res = _both(port, ref, "search_batch", [(vec, 10, None)])[0]
    assert key not in {k for k, _ in res}
    verify_tier_state(port)


# --------------------------------------- churn x migration


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_concurrent_retract_and_tier_migration(seed):
    """Retract/add churn racing a migration thread (which seals a run per
    demotion wave, so the spill store's compaction meets those seals):
    every result set stays within the live rows and the tier contract,
    spill manifest order included, holds at the end."""
    rng = np.random.default_rng(seed)
    docs = _clustered(2000, seed=seed)
    ann = IvfPqIndex(
        dimensions=DIM, device="cpu", background_retrain=False, seed=0, tiered=True,
        hot_lists=3, ram_lists=8, background_tiering=False,
    )
    _load(ann, docs)
    live: dict[Key, np.ndarray] = {Key(i): docs[i] for i in range(len(docs))}
    stop = threading.Event()
    errors: list[Exception] = []

    def migrate():
        try:
            while not stop.is_set():
                ann.rebalance_tiers_now()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=migrate, daemon=True)
    t.start()
    next_id = len(docs)
    try:
        for _ in range(8):
            for key in rng.choice(list(live), 80, replace=False):
                ann.remove(key)
                del live[key]
            for vec in _clustered(80, seed=int(rng.integers(1 << 30))):
                key = Key(next_id)
                ann.add(key, vec)
                live[key] = vec
                next_id += 1
            keys = list(live)
            sample = rng.choice(len(keys), 20, replace=False)
            res = ann.search_batch([(live[keys[i]], 5, None) for i in sample])
            for matches in res:
                assert {k for k, _ in matches} <= set(live), "tombstoned row surfaced during migration"
    finally:
        stop.set()
        t.join(timeout=30)
    assert not errors
    verify_tier_state(ann)
    assert set(ann.key_of.values()) == set(live)


# ------------------------------------------------------- kill switch


def test_tiered_enabled_env_contract(monkeypatch):
    for env in (None, "0", "1"):
        if env is None:
            monkeypatch.delenv("PATHWAY_ANN_TIERED", raising=False)
        else:
            monkeypatch.setenv("PATHWAY_ANN_TIERED", env)
        for default in (True, False):
            assert tiered_enabled(default) == jax_tiered_enabled(default)
    monkeypatch.delenv("PATHWAY_ANN_TIERED")
    assert tiered_enabled(True) and not tiered_enabled(False)


def test_tiered_off_is_byte_identical(monkeypatch):
    docs = _clustered(1500, seed=9)
    items = [(docs[i] + 0.01, 10, None) for i in range(0, 60, 3)]
    plain = IvfPqIndex(dimensions=DIM, device="cpu", background_retrain=False, seed=0)
    _load(plain, docs)
    want = plain.search_batch(items)
    monkeypatch.setenv("PATHWAY_ANN_TIERED", "0")
    vetoed = IvfPqIndex(
        dimensions=DIM, device="cpu", background_retrain=False, seed=0,
        tiered=True, hot_lists=2, ram_lists=4,
    )
    _load(vetoed, docs)
    assert vetoed._tiers is None, "env veto must disable tier placement"
    assert vetoed.search_batch(items) == want
    ref = JaxIvfPqIndex(dimensions=DIM, background_retrain=False, seed=0, tiered=True, hot_lists=2, ram_lists=4)
    _load(ref, docs)
    assert ref._tiers is None
    _assert_agree(want, ref.search_batch(items))


def test_tiered_results_match_resident_before_any_migration():
    """Tiering on, nothing demoted yet: the tiered probe (host csim and
    the union's sub-layout) gives the resident host search's results byte
    for byte, in both packages."""
    docs = _clustered(1500, seed=9)
    items = [(docs[i] + 0.01, 10, None) for i in range(0, 60, 3)]
    plain = IvfPqIndex(dimensions=DIM, device=False, background_retrain=False, seed=0)
    _load(plain, docs)
    port, ref = _pair(docs, hot=2, ram=4, device=False)
    got = _both(port, ref, "search_batch", items)
    assert got == plain.search_batch(items)


# ----------------------------------------------- checkpoint + restore


def test_tiered_checkpoint_is_manifest_plus_hot_state():
    docs = _clustered(3000, seed=10)
    port, ref = _pair(docs, hot=2, ram=6)
    _both(port, ref, "rebalance_tiers_now")
    st, jst = port.__getstate__(), ref.__getstate__()
    assert st["_gen"].cube is None
    ckpt = st["_tier_ckpt"]
    assert ckpt["blocks"].shape[0] == len(ckpt["resident"])
    assert ckpt["blocks"].shape[0] < port._gen.n_lists
    assert ckpt["manifest"]["n_runs"] >= 1
    jckpt = jst["_tier_ckpt"]
    assert np.array_equal(ckpt["resident"], jckpt["resident"])
    assert ckpt["blocks"].tobytes() == jckpt["blocks"].tobytes()
    # (the seq counters differ: the port's store draws once for a run's
    # file name and once for its seq)
    for field in ("n_runs", "total_records"):
        assert ckpt["manifest"][field] == jckpt["manifest"][field]


def test_tiered_pickle_roundtrip_preserves_results():
    docs = _clustered(2000, seed=11)
    port, ref = _pair(docs, hot=3, ram=8)
    _both(port, ref, "rebalance_tiers_now")
    items = [(docs[i], 10, None) for i in range(12)]
    before = _both(port, ref, "search_batch", items)
    port2 = pickle.loads(pickle.dumps(port))
    assert port2.search_batch(items) == before
    verify_tier_state(port2)
    assert port2.rebalance_tiers_now() is not None


def test_restore_refuses_tampered_tier_manifest():
    docs = _clustered(2000, seed=12)
    port, _ref = _pair(docs, hot=2, ram=5)
    port.rebalance_tiers_now()
    st = port.__getstate__()
    man = st["_tier_ckpt"]["manifest"]
    assert man["runs"], "tamper target needs at least one sealed run"
    man["runs"] = man["runs"][:-1]  # the tamper: drop a run record
    fresh = IvfPqIndex.__new__(IvfPqIndex)
    with pytest.raises(PlanVerificationError, match="spill-manifest"):
        fresh.__setstate__(st)


# ------------------------------------------------- verifier contract


def _tier_session():
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.lowering import Session
    from pathway_tpu_torch.stdlib.indexing import DataIndex, IvfPqKnn

    rng = np.random.default_rng(21)
    vecs = rng.normal(size=(400, 8)).astype(np.float64).round(3)
    docs = pw.debug.table_from_rows(
        pw.schema_from_types(vec=object, name=str),
        [(tuple(vecs[i]), f"doc{i}") for i in range(len(vecs))],
    )
    queries = pw.debug.table_from_rows(
        pw.schema_from_types(qvec=object),
        [(tuple((vecs[i] + 0.01).round(3)),) for i in range(0, 400, 40)],
    )
    res = DataIndex(
        docs,
        IvfPqKnn(
            data_column=docs.vec, dimensions=8, train_min=64,
            tiered=True, hot_lists=2, ram_lists=4, device="cpu",
            # trained on the add path: the check below must not race a
            # background retrain for the index's first generation
            background_retrain=False,
        ),
    ).query_as_of_now(queries.qvec, number_of_matches=5, with_distances=True)
    s = Session()
    s.capture(res)
    s.execute()
    return s


def test_verify_session_proves_index_tier_contract():
    from pathway_tpu_torch.internals import verifier

    s = _tier_session()
    node = next(n for n in s.graph.nodes if hasattr(n, "index_tiers"))
    (hi,) = node.index_tiers()
    assert isinstance(hi, IvfPqIndex)
    hi.stop_tiering()
    hi.rebalance_tiers_now()
    rep = verifier.verify_session(s)
    assert rep["checks"]["index-tier-contract"]["indexes"] >= 1

    ts, gen = hi._tiers, hi._gen
    cold = [lst for lst in ts.cold_lists() if gen.fill[lst] > 0]
    assert cold, "session index demoted nothing; tamper target missing"
    gen.cube[cold[0], 0, :] = 7  # the same doc now lives in two tiers
    with pytest.raises(PlanVerificationError, match="index-tier"):
        verifier.verify_session(s)
    gen.cube[cold[0], :, :] = 0

    warm = int(np.flatnonzero((ts.tier != TIER_COLD) & (gen.fill > 0))[0])
    ts.tier[warm] = TIER_COLD  # a resident list flagged cold with no run
    with pytest.raises(PlanVerificationError, match="index-tier.*no live run record"):
        verifier.verify_session(s)


# --------------------------------------------------------- observability


def test_tier_metrics_published_to_registry():
    from pathway_tpu_torch.internals import observability as obs

    obs.enable()
    try:
        docs = _clustered(1500, seed=18)
        port, _ref = _pair(docs, hot=2, ram=5)
        port.rebalance_tiers_now()
        port.search_batch([(docs[0], 10, None)])
        snap = obs.PLANE.metrics.snapshot()
        for name in (
            "pathway_index_tier_rows",
            "pathway_index_tier_promotions",
            "pathway_index_tier_demotions",
            "pathway_index_tier_searches",
        ):
            assert name in snap, f"{name} missing from the registry"
            assert any(s["labels"].get("index") == port.name for s in snap[name]["series"])
        rows = snap["pathway_index_tier_rows"]["series"]
        assert {s["labels"]["tier"] for s in rows if s["labels"].get("index") == port.name} == {
            "hot", "warm", "cold",
        }
        assert snap.get("pathway_index_tier_probe_tier") is not None
        routes = {s["labels"]["route"] for s in snap["pathway_index_tier_searches"]["series"]}
        assert routes == {"host"}
    finally:
        obs.disable()


# ------------------------------------------------------ the hot route


def _all_hot_items(index, n: int = 6):
    """Queries at the centroids of hot lists, probing one list each: a
    batch whose probed union is all hot."""
    hot = np.flatnonzero(index._tiers.tier == TIER_HOT)[:n]
    return [(index._gen.centroids[lst].astype(np.float32), 5, None) for lst in hot]


def test_hot_route_runs_the_search_program_over_the_hot_sub_cube():
    """Every probed list hot: the search runs `_ivf_pq_search_fn` through
    the plane's ``ann_ivf_search_hot`` program over a pow2-padded mirror
    of the hot lists, and agrees with the JAX package's device route on
    the same placement. A batch that reaches a warm list takes the host
    route in both."""
    docs = _clustered(3000, seed=0)
    port, ref = _pair(docs, hot=4, ram=10)
    _both(port, ref, "rebalance_tiers_now")
    items = _all_hot_items(port)
    got = port.search_batch(items, nprobe=1)
    _assert_agree(got, ref.search_batch(items, nprobe=1))
    assert port.counters["tier_device_searches"] == 1 and port.counters["tier_host_searches"] == 0
    dev = port._tier_dev
    n_hot = int((port._tiers.tier == TIER_HOT).sum())
    assert dev["n_live"] == n_hot and dev["cube"].shape[0] == 8  # 4 hot lists pad to the 8 floor
    assert dev["cube"].device == torch.device("cpu")
    assert dev["cube"].numel() < port._gen.cube.size  # 8 of 64 lists on the device
    assert port.tier_device_bytes() == sum(
        t.numel() * t.element_size() for n, t in dev.items() if n != "n_live"
    )
    counts = {b: n for (p, b), n in get_device_plane().shape_counts().items() if p == "ann_ivf_search_hot"}
    assert counts and all(n == 1 for n in counts.values())
    # the mirror is cached until a mutation or a rebalance drops it
    port.search_batch(items, nprobe=1)
    assert port.counters["hot_mirror_rebuilds"] == 1
    warm = np.flatnonzero(port._tiers.tier != TIER_HOT)[0]
    mixed = items + [(port._gen.centroids[warm].astype(np.float32), 5, None)]
    _both(port, ref, "search_batch", mixed[-1:])
    assert port.counters["tier_host_searches"] == 1


def test_failed_hot_dispatch_raises(monkeypatch):
    """No strikes and no host fallback: a hot dispatch that fails raises
    to the caller (the JAX package's 3-strike switch is not ported)."""
    docs = _clustered(2000, seed=4)
    port, _ref = _pair(docs, hot=4, ram=10)
    port.rebalance_tiers_now()
    plane = get_device_plane()
    real = plane.program

    def broken(name, fn=None):
        prog = real(name, fn)
        if name != "ann_ivf_search_hot":
            return prog

        def fail(*a, **k):
            raise RuntimeError("injected hot dispatch failure")

        return fail

    monkeypatch.setattr(plane, "program", broken)
    items = _all_hot_items(port, 2)
    for _ in range(4):  # the reference would switch to the host after 3
        with pytest.raises(RuntimeError, match="injected hot dispatch failure"):
            port.search_batch(items, nprobe=1)
    assert port.counters["tier_host_searches"] == 0


# --------------------------------------------- the spill store's seq order


def _seal_during_compaction(spill, tmp_path):
    """Seal a run while its file write is held open, cut a compaction in
    that window, then let the seal finish; return the store's manifest."""
    store = spill.SpillStore("race", str(tmp_path / "race"), persistent=False)
    for i in range(2):  # two private runs: something to compact
        store.seal([(b"k%d" % i, b"v%d" % i)])
    entered, release = threading.Event(), threading.Event()
    real_write = spill._fsync_write
    sealer = []

    def held_write(path, data):
        if threading.current_thread() in sealer:
            entered.set()
            release.wait(10)
        real_write(path, data)

    spill._fsync_write = held_write
    try:
        t = threading.Thread(target=store.seal, args=([(b"late", b"payload")],))
        sealer.append(t)
        t.start()
        assert entered.wait(10), "the seal never reached its file write"
        assert store.compact_once()  # merges the two runs sealed before
        release.set()
        t.join(10)
    finally:
        spill._fsync_write = real_write
        release.set()
    assert [r.n for r in store.runs] == [2, 1]  # merged run, then the late seal
    assert store.peek(b"late") == b"payload" and store.peek(b"k0") == b"v0"
    return store.manifest()


def test_seal_racing_a_compaction_keeps_run_seqs_in_list_order(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_SPILL_COMPACT", "0")  # no background compactor
    man = _seal_during_compaction(tspill, tmp_path)
    tspill.verify_manifest(man)
    seqs = [r["seq"] for r in man["runs"]]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    assert len({r["file"] for r in man["runs"]}) == 2


def test_the_reference_store_breaks_seq_order_on_the_same_interleaving(tmp_path, monkeypatch):
    """The same interleaving on the JAX package's copy (left as it is):
    the late seal took its seq before the compactor's merged run did, and
    enters the list after it, so the manifest's check refuses it."""
    monkeypatch.setenv("PATHWAY_SPILL_COMPACT", "0")
    man = _seal_during_compaction(jspill, tmp_path)
    from pathway_tpu.internals.verifier import PlanVerificationError as JaxPVE

    with pytest.raises(JaxPVE, match="run sequence numbers out of order"):
        jspill.verify_manifest(man)


def test_merged_manifest_floor_covers_every_file_name(tmp_path, monkeypatch):
    """A merged run's file is named from a later draw of the counter than
    its seq; `merge_manifests` starts the next seal past the counter, so a
    fresh seal never reuses a file name the manifest holds."""
    monkeypatch.setenv("PATHWAY_SPILL_COMPACT", "0")
    tspill.set_root(str(tmp_path), persistent=True)
    store = tspill.store_for("floor")
    for i in range(3):
        store.seal([(b"k%d" % i, b"v")])
    assert store.compact_once()
    man = store.manifest()
    merged = tspill.merge_manifests([man])
    assert merged["seq"] >= man["seq"]
    restored = tspill.attach_store(merged)
    restored.seal([(b"fresh", b"v")])
    files = [r.file for r in restored.runs]
    assert len(set(files)) == len(files) == 2
    assert restored.peek(b"k1") == b"v" and restored.peek(b"fresh") == b"v"
    tspill.verify_manifest(restored.manifest())


def _probe_during_compaction(spill, tmp_path, method: str, read_first: bool):
    """Hold a `take` or `peek` inside its disk read of the oldest run
    while a compaction merges that run away (a scratch store unlinks it at
    once), then let the probe finish. `read_first` reads the run before
    the hold, so the promotion's dead mark lands after the swap; otherwise
    the read comes after the swap, on a file that is gone."""
    store = spill.SpillStore("probe", str(tmp_path / "probe"), persistent=False)
    store.seal([(b"cold", b"payload")])
    store.seal([(b"other", b"v")])
    entered, release = threading.Event(), threading.Event()
    real = store._lookup
    prober = []

    def held(run, h, kb):
        if threading.current_thread() not in prober:
            return real(run, h, kb)
        out = real(run, h, kb) if read_first else None
        entered.set()
        release.wait(10)
        return out if read_first else real(run, h, kb)

    store._lookup = held
    result: list = []
    t = threading.Thread(target=lambda: result.append(getattr(store, method)(b"cold")))
    prober.append(t)
    t.start()
    assert entered.wait(10)
    assert store.compact_once()
    prober.clear()  # the probe's second walk reads normally
    release.set()
    t.join(10)
    return store, result


def test_promotion_racing_a_compaction_swap_reaches_the_merged_run(tmp_path, monkeypatch):
    """A `take` that found its key in a run the compaction then merged
    away marks it dead in the merged run: the key is resident in the tail
    only, and the two-tier proof holds."""
    monkeypatch.setenv("PATHWAY_SPILL_COMPACT", "0")
    store, result = _probe_during_compaction(tspill, tmp_path, "take", read_first=True)
    assert result == [b"payload"] and store.promotions == 1
    (merged,) = store.runs
    assert b"cold" in merged.dead and store.peek(b"cold") is None
    store.tail_keys = lambda: [b"cold"]
    tspill.check_two_tier(store)


def test_the_reference_promotion_is_lost_on_the_same_interleaving(tmp_path, monkeypatch):
    """The JAX package's copy marks the key dead in the retired run: the
    merged run still holds it live beside the tail."""
    monkeypatch.setenv("PATHWAY_SPILL_COMPACT", "0")
    store, result = _probe_during_compaction(jspill, tmp_path, "take", read_first=True)
    assert result == [b"payload"]
    assert store.peek(b"cold") == b"payload"  # still live in the merged run
    store.tail_keys = lambda: [b"cold"]
    from pathway_tpu.internals.verifier import PlanVerificationError as JaxPVE

    with pytest.raises(JaxPVE, match="resident in the tail"):
        jspill.check_two_tier(store)


def test_peek_racing_a_compaction_reads_the_merged_run(tmp_path, monkeypatch):
    """A `peek` whose run file was retired and unlinked under it reads the
    key from the merged run instead of failing."""
    monkeypatch.setenv("PATHWAY_SPILL_COMPACT", "0")
    store, result = _probe_during_compaction(tspill, tmp_path, "peek", read_first=False)
    assert result == [b"payload"] and store.promotions == 0
    assert store.peek(b"cold") == b"payload"
