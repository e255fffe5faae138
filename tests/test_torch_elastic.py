"""Elastic membership and blue/green plan swaps of the port
(``pathway_tpu_torch/parallel/{membership,supervisor,bluegreen}.py``)
against the JAX package's.

Every case of tests/test_elastic.py. The protocol units run the same
calls on both packages' modules, each on its own root, and compare what
they return and leave on disk. The mesh cases run the port's supervisor
over workers that import the port: a join 2->3 (and, marked slow as in
the reference, a leave 3->2) announced mid-run must deliver the table a
never-rescaled mesh delivers, and the JAX package's static mesh delivers
the same; with ``PATHWAY_ELASTIC=0`` the intent is ignored. The swap cases
run the same worker through both packages and hold each swap's result and
the blue root's files to the reference's.

Consolidation note (as in the reference): group ownership moves across
worker output files at a rebalance, so delivered events are replayed in
global delivery order (each carries a wall-clock stamp).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

import pathway_tpu.engine.faults as jfaults
import pathway_tpu.parallel.bluegreen as jbg
import pathway_tpu.parallel.membership as jmb
import pathway_tpu.parallel.supervisor as jsup
import pathway_tpu.persistence as jpersist
import pathway_tpu_torch.engine.faults as tfaults
import pathway_tpu_torch.parallel.bluegreen as tbg
import pathway_tpu_torch.parallel.membership as tmb
import pathway_tpu_torch.parallel.supervisor as tsup
import pathway_tpu_torch.persistence as tpersist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {
    "pathway_tpu": dict(mb=jmb, bg=jbg, sup=jsup, faults=jfaults, persist=jpersist),
    "pathway_tpu_torch": dict(mb=tmb, bg=tbg, sup=tsup, faults=tfaults, persist=tpersist),
}

MESH_WORKER = textwrap.dedent(
    """
    import json, os, sys, time
    sys.path.insert(0, {repo!r})
    import {pkg} as pw
    from {pkg}.io.python import ConnectorSubject

    PDIR, OUT, READY, N = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
    PID = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))

    class Nums(ConnectorSubject):
        def run(self):
            for i in range(N):
                self.next(g=f"g{{i % 4}}", v=i)
                if i == 5:
                    open(READY + f".{{PID}}", "w").write("up")
                time.sleep(0.01)

    t = pw.io.python.read(
        Nums(), schema=pw.schema_from_types(g=str, v=int), name="nums"
    )
    agg = t.groupby(t.g).reduce(
        t.g, total=pw.reducers.sum(t.v), n=pw.reducers.count()
    )
    sink = open(OUT + f".{{PID}}", "a")
    def on_change(key, row, time, is_addition):
        sink.write(json.dumps({{**row, "add": is_addition,
                               "ts": __import__("time").time()}}) + "\\n")
        sink.flush()
    pw.io.subscribe(agg, on_change=on_change)
    pw.run(persistence_config=pw.persistence.Config(
        pw.persistence.Backend.filesystem(PDIR)))
    """
)

N_EVENTS = 160
WORKER_ENV = {"JAX_PLATFORMS": "cpu", "PATHWAY_THREADS": "2"}

requires_elastic = pytest.mark.skipif(
    os.environ.get("PATHWAY_ELASTIC") == "0",
    reason="elastic disabled (PATHWAY_ELASTIC=0 leg)",
)


def _free_port_base(n: int) -> int:
    for _ in range(60):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]
        try:
            for i in range(n * n):
                with socket.socket() as s2:
                    s2.bind(("127.0.0.1", p + i))
        except OSError:
            continue
        return p
    raise RuntimeError("no contiguous port range free")


def _consolidate(out_prefix: str, max_pids: int) -> dict:
    """Final table from the delivered add/remove stream, replayed in
    GLOBAL delivery order across all worker files."""
    events = []
    for pid in range(max_pids):
        path = out_prefix + f".{pid}"
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for i, line in enumerate(f):
                ev = json.loads(line)
                events.append((ev["ts"], pid, i, ev))
    events.sort(key=lambda e: (e[0], e[1], e[2]))
    state: dict = {}
    for _, _, _, ev in events:
        if ev["add"]:
            state[ev["g"]] = (ev["total"], ev["n"])
        elif state.get(ev["g"]) == (ev["total"], ev["n"]):
            del state[ev["g"]]
    return state


def _expected(n_events: int) -> dict:
    exp: dict = {}
    for i in range(n_events):
        g = f"g{i % 4}"
        t0, n0 = exp.get(g, (0, 0))
        exp[g] = (t0 + i, n0 + 1)
    return exp


def _mesh(pkg: str, workdir, start_n: int, announce=None) -> tuple[dict, dict, str]:
    """`pkg`'s run_supervised over `pkg`'s worker, `announce(state_dir)`
    fired once the source is up (elastic runs only); returns (result,
    consolidated final state, state dir)."""
    os.makedirs(workdir, exist_ok=True)
    pdir, out, ready = str(workdir / "pstate"), str(workdir / "deliveries"), str(workdir / "ready")
    worker = MESH_WORKER.format(repo=REPO, pkg=pkg)
    argv = [sys.executable, "-c", worker, pdir, out, ready, str(N_EVENTS)]
    base = _free_port_base(start_n + 1)

    def announcer():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not os.path.exists(ready + ".0"):
            time.sleep(0.05)
        time.sleep(0.4)  # let a few checkpoint epochs land first
        announce(pdir)

    th = threading.Thread(target=announcer) if announce is not None else None
    if th is not None:
        th.start()
    try:
        res = SIDES[pkg]["sup"].run_supervised(
            argv, start_n, base, env=WORKER_ENV, timeout_s=240,
            state_dir=pdir if announce is not None else None,
        )
    finally:
        if th is not None:
            th.join()
    return res, _consolidate(out, start_n + 2), pdir


# ------------------------------------------------ membership protocol units


def _on_both(tmp_path, scenario) -> list:
    """`scenario(side, root)` on each package, each on its own root."""
    out = []
    for pkg, side in SIDES.items():
        root = tmp_path / pkg
        root.mkdir()
        out.append(scenario(side, str(root)))
    return out


def _control_files(root: str) -> list[str]:
    d = os.path.join(root, "control")
    return sorted(f.split("-")[0] if f.endswith(".intent") else f for f in os.listdir(d)) if os.path.isdir(d) else []


def test_membership_intents_fold_and_cancel(tmp_path):
    def scenario(side, root):
        mb = side["mb"]
        trace = []
        mb.announce_join(root)
        mb.announce_join(root)
        mb.announce_leave(root)
        trace.append(mb.pending_intents(root))
        trace.append(mb.plan_membership(root, current_n=2))
        trace.append(mb.load_membership(root))
        trace.append(mb.pending_intents(root))
        mb.clear_intents(root)
        mb.announce_join(root)
        mb.announce_leave(root)
        trace.append(mb.plan_membership(root, current_n=3))
        trace.append(mb.pending_intents(root))
        trace.append(_control_files(root))
        return trace

    want, got = _on_both(tmp_path, scenario)
    assert got == want
    assert got[:2] == [(2, 1), 3]
    assert got[2] == {"generation": 1, "n": 3, "prev_n": 2, "rebalanced": False}
    assert got[3] == (2, 1) and got[4:6] == [3, (0, 0)]


def test_membership_never_plans_below_min(tmp_path):
    def scenario(side, root):
        for _ in range(5):
            side["mb"].announce_leave(root)
        return side["mb"].plan_membership(root, current_n=3), side["mb"].MIN_MEMBERS

    want, got = _on_both(tmp_path, scenario)
    assert got == want and got[0] == got[1] == 2


def test_elastic_kill_switch(monkeypatch):
    seen = []
    for value in ("0", None):
        if value is None:
            monkeypatch.delenv("PATHWAY_ELASTIC", raising=False)
        else:
            monkeypatch.setenv("PATHWAY_ELASTIC", value)
        seen.append((jmb.elastic_enabled(), tmb.elastic_enabled()))
    assert seen == [(False, False), (True, True)]


def test_quiesce_request_lifecycle(tmp_path):
    def scenario(side, root):
        mb = side["mb"]
        trace = [mb.quiesce_requested(root)]
        mb.request_quiesce(root)
        trace += [mb.quiesce_requested(root), _control_files(root)]
        mb.clear_quiesce(root)
        return trace + [mb.quiesce_requested(root)]

    want, got = _on_both(tmp_path, scenario)
    assert got == want
    assert (got[0], got[1], got[3]) == (False, True, False)


def test_recover_rebalance_discards_stale_staging(tmp_path):
    def scenario(side, root):
        os.makedirs(os.path.join(root, "proc-0.stage"))
        return side["mb"].recover_rebalance(root), sorted(os.listdir(root))

    want, got = _on_both(tmp_path, scenario)
    assert got == want
    assert got[0] is False and "proc-0.stage" not in got[1]


def test_member_fault_points_probe(monkeypatch, tmp_path):
    errors = []
    monkeypatch.setenv("PATHWAY_FAULTS", "mesh.member.join@1")
    try:
        for pkg, side in SIDES.items():
            side["faults"].reset()
            with pytest.raises(ConnectionError) as info:
                side["mb"].announce_join(str(tmp_path / pkg))
            errors.append(str(info.value))
    finally:
        monkeypatch.setenv("PATHWAY_FAULTS", "0")
        for side in SIDES.values():
            side["faults"].reset()
    assert errors[1] == errors[0]


# --------------------------------------------- elastic rebalance, A/B


@requires_elastic
def test_elastic_join_matches_static_mesh(tmp_path):
    """GROW 2->3 mid-run on the port: the rebalanced mesh delivers the
    analytic table, as the port's and the JAX package's never-rescaled
    static meshes do."""
    with ThreadPoolExecutor(3) as pool:
        elastic = pool.submit(_mesh, "pathway_tpu_torch", tmp_path / "elastic", 2, tmb.announce_join)
        static = pool.submit(_mesh, "pathway_tpu_torch", tmp_path / "static", 2)
        reference = pool.submit(_mesh, "pathway_tpu", tmp_path / "reference", 2)
        (res, state, pdir), (sres, static_state, _), (jres, jax_state, _) = (
            elastic.result(), static.result(), reference.result())
    assert res["rebalances"] == 1 and res["members"] == 3
    rec = tmb.load_membership(pdir)
    assert rec is not None and rec["n"] == 3 and rec["rebalanced"]
    assert sres["generations"] == jres["generations"] == 1
    assert state == static_state == jax_state == _expected(N_EVENTS)


@requires_elastic
@pytest.mark.slow
def test_elastic_leave_matches_static_mesh(tmp_path):
    """SHRINK 3->2 mid-run on the port: retired-process shards re-home as
    metadata moves and the output stays the JAX package's static mesh's."""
    with ThreadPoolExecutor(2) as pool:
        elastic = pool.submit(_mesh, "pathway_tpu_torch", tmp_path / "elastic", 3, tmb.announce_leave)
        reference = pool.submit(_mesh, "pathway_tpu", tmp_path / "reference", 3)
        (res, state, pdir), (_jres, jax_state, _) = elastic.result(), reference.result()
    assert res["rebalances"] == 1 and res["members"] == 2
    rec = tmb.load_membership(pdir)
    assert rec is not None and rec["n"] == 2 and rec["rebalanced"]
    assert state == jax_state == _expected(N_EVENTS)
    assert os.path.isdir(os.path.join(pdir, "proc-2.retired"))


def test_elastic_off_is_a_bypass(tmp_path, monkeypatch):
    """PATHWAY_ELASTIC=0: the port's supervisor ignores the intent, runs
    one generation and delivers the table the JAX package's does."""
    monkeypatch.setenv("PATHWAY_ELASTIC", "0")
    with ThreadPoolExecutor(2) as pool:
        port = pool.submit(_mesh, "pathway_tpu_torch", tmp_path / "off", 2, tmb.announce_join)
        ref = pool.submit(_mesh, "pathway_tpu", tmp_path / "reference", 2, jmb.announce_join)
        (res, state, pdir), (jres, jax_state, jdir) = port.result(), ref.result()
    assert res["generations"] == jres["generations"] == 1
    assert res.get("rebalances", 0) == jres.get("rebalances", 0) == 0
    assert tmb.load_membership(pdir) is None and jmb.load_membership(jdir) is None
    assert state == jax_state == _expected(N_EVENTS)


# --------------------------------------------------- blue/green swaps

SOLO_WORKER = textwrap.dedent(
    """
    import json, os, sys, time
    sys.path.insert(0, {repo!r})
    import {pkg} as pw
    from {pkg}.io.python import ConnectorSubject

    ROOT, OUT, N = sys.argv[1], sys.argv[2], int(sys.argv[3])

    class Nums(ConnectorSubject):
        def run(self):
            for i in range(N):
                self.next(g=f"g{{i % 4}}", v=i)
                time.sleep(0.005)

    t = pw.io.python.read(
        Nums(), schema=pw.schema_from_types(g=str, v=int), name="nums"
    )
    agg = t.groupby(t.g).reduce(
        t.g, total=pw.reducers.sum(t.v), n=pw.reducers.count()
    )
    # a real sink through the transactional outbox: its delivery
    # watermark must ride the swap (metadata outbox carry-forward)
    pw.io.jsonlines.write(agg, OUT)
    pw.run(persistence_config=pw.persistence.Config(
        pw.persistence.Backend.filesystem(ROOT)))
    """
)


def _run_solo(pkg: str, root: str, out: str, n: int) -> None:
    r = subprocess.run(
        [sys.executable, "-c", SOLO_WORKER.format(repo=REPO, pkg=pkg), root, out, str(n)],
        capture_output=True, text=True, timeout=180,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PATHWAY_THREADS": "1"},
    )
    assert r.returncode == 0, (pkg, r.stderr[-3000:])


def _sink_state(path: str) -> dict:
    state: dict = {}
    if os.path.exists(path):
        for line in open(path):
            rec = json.loads(line)
            if rec["diff"] > 0:
                state[rec["g"]] = (rec["total"], rec["n"])
            elif state.get(rec["g"]) == (rec["total"], rec["n"]):
                del state[rec["g"]]
    return state


def _tree_snapshot(root: str) -> list:
    out = []
    for dp, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dp, f)
            st = os.stat(p)
            out.append((os.path.relpath(p, root), st.st_size, st.st_mtime_ns))
    return sorted(out)


def _names(root: str) -> list:
    """The root's kinds of file, with the epoch and offset numbers in their
    names left out: how many checkpoints a run commits, and so which
    numbers the files carry, depends on timing."""
    import re

    return sorted({re.sub(r"\.\d+\.", ".<n>.", rel) for rel, _size, _mtime in _tree_snapshot(root)})


def _blues(tmp_path, n: int = 40) -> dict[str, str]:
    """One blue root a package, each made by its own worker (at once)."""
    roots = {pkg: str(tmp_path / pkg / "blue") for pkg in SIDES}
    for pkg in SIDES:
        (tmp_path / pkg).mkdir()
    with ThreadPoolExecutor(len(roots)) as pool:
        for f in [pool.submit(_run_solo, pkg, root, str(tmp_path / pkg / "blue.jsonl"), n)
                  for pkg, root in roots.items()]:
            f.result()
    return roots


def test_swap_commits_and_carries_offsets(tmp_path):
    """A healthy green (same plan, longer stream) warms from the clone,
    replays, passes both gates and commits at the rename, with the
    connector offset and outbox watermark advanced, on the port as on the
    JAX package."""
    blues = _blues(tmp_path)
    seen = {}
    for pkg, side in SIDES.items():
        blue = blues[pkg]
        blue_meta = side["persist"].MetadataStore(blue).load()
        assert blue_meta is not None and int(blue_meta["offsets"]["nums"]) == 40
        blue_outbox = dict(blue_meta.get("outbox") or {})
        assert blue_outbox, "jsonlines sink must seal through the outbox"
        green_out = str(tmp_path / pkg / "green.jsonl")

        def green(stage, pkg=pkg, green_out=green_out):
            _run_solo(pkg, stage, green_out, 80)
            return _sink_state(green_out)

        res = side["bg"].swap_plan(blue, green, baseline=_expected(80))
        assert res["committed"], (pkg, res["reason"])
        meta = side["persist"].MetadataStore(blue).load()
        assert meta is not None and int(meta["offsets"]["nums"]) == 80
        for sink, off in blue_outbox.items():
            assert int(meta["outbox"][sink]) >= int(off)
        assert os.path.isdir(blue + ".blue-retired")
        assert not os.path.exists(blue + ".swap.commit")
        seen[pkg] = (res["committed"], res["reason"], sorted(res["output"].items()),
                     int(meta["offsets"]["nums"]), sorted(os.listdir(os.path.dirname(blue))))
    assert seen["pathway_tpu_torch"] == seen["pathway_tpu"]


def test_swap_abort_leaves_blue_untouched(tmp_path):
    """A tampered green (metadata wrecked, never warmed) fails the swap
    contract on both packages, with the same findings; blue stays byte for
    byte as it was."""
    blues = _blues(tmp_path)
    seen = {}
    for pkg, side in SIDES.items():
        blue = blues[pkg]
        before = _tree_snapshot(blue)

        def tampered(stage):
            os.unlink(os.path.join(stage, "metadata.json"))
            return _expected(40)

        res = side["bg"].swap_plan(blue, tampered, baseline=_expected(40))
        assert not res["committed"] and "swap contract" in res["reason"]
        assert _tree_snapshot(blue) == before
        assert not os.path.isdir(blue + ".green") and not os.path.isdir(blue + ".blue-retired")
        seen[pkg] = (res["reason"].replace(blue, "<blue>"), _names(blue))
    assert seen["pathway_tpu_torch"] == seen["pathway_tpu"]


def test_swap_divergent_replay_aborts(tmp_path, monkeypatch):
    """Gate A: a green whose replay differs from the baseline aborts with
    blue still serving, also through the injectable
    swap.replay.divergent fault point; the same reasons on both packages."""
    blues = _blues(tmp_path)
    seen = {}
    for pkg, side in SIDES.items():
        blue = blues[pkg]
        before = _tree_snapshot(blue)
        res = side["bg"].swap_plan(blue, lambda stage: {"bogus": 1}, baseline=_expected(40), verify=False)
        assert not res["committed"] and "diverged" in res["reason"]
        assert _tree_snapshot(blue) == before
        monkeypatch.setenv("PATHWAY_FAULTS", "swap.replay.divergent@1")
        side["faults"].reset()
        try:
            res2 = side["bg"].swap_plan(blue, lambda stage: _expected(40), baseline=_expected(40), verify=False)
        finally:
            monkeypatch.setenv("PATHWAY_FAULTS", "0")
            side["faults"].reset()
        assert not res2["committed"] and "injected" in res2["reason"]
        assert _tree_snapshot(blue) == before
        seen[pkg] = (res["reason"], res2["reason"])
    assert seen["pathway_tpu_torch"] == seen["pathway_tpu"]


CRASHER = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    from {pkg}.parallel import bluegreen as bg
    bg.swap_plan(sys.argv[1], lambda stage: None, verify=False)
    """
)


def test_swap_mid_commit_crash_rolls_forward(tmp_path):
    """A crash inside the commit window (marker durable) is rolled forward
    by recover_swap: the verified green serves, the marker is gone; the
    port leaves the files the JAX package leaves."""
    blues = _blues(tmp_path)
    seen = {}
    for pkg, side in SIDES.items():
        blue = blues[pkg]
        r = subprocess.run(
            [sys.executable, "-c", CRASHER.format(repo=REPO, pkg=pkg), blue],
            capture_output=True, text=True, timeout=60,
            env={**os.environ, "PATHWAY_FAULTS": "swap.mid_commit@1", "JAX_PLATFORMS": "cpu"},
        )
        assert r.returncode == 17, (pkg, r.stderr[-2000:])
        assert os.path.exists(blue + ".swap.commit")
        assert side["bg"].recover_swap(blue) == "completed"
        assert os.path.isdir(blue) and not os.path.exists(blue + ".swap.commit")
        assert not os.path.isdir(blue + ".green")
        seen[pkg] = (r.returncode, _names(blue), sorted(os.listdir(os.path.dirname(blue))))
    assert seen["pathway_tpu_torch"] == seen["pathway_tpu"]


# ------------------------- chip_smoke's elastic_rescale and bluegreen_swap

REHEARSAL_EMBEDDER = dict(vocab_size=512, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32,
                          embed_dim=32, dtype="float32")


@requires_elastic
def test_elastic_rescale_phase_rehearses_on_the_cpu(tmp_path):
    """chip_smoke's `elastic_rescale` at a small size on the CPU: the
    spawn_embed pipeline over 96 documents under the supervisor, grown
    from 2 to 3 processes after process 0's first delivery; one
    rebalance, 3 members, and the table of spawn -n 1 and -n 2 (the phase
    raises otherwise), each generation delivering a share."""
    import chip_smoke

    texts = chip_smoke.load_texts(chip_smoke.ROOT)[:40]
    chip_smoke.run_spawn_embed("cpu", REHEARSAL_EMBEDDER, texts, n_docs=96, shards=4, processes=(1, 2),
                               workdir=tmp_path)
    static = {n: chip_smoke.read_spawn_output(tmp_path / f"n{n}") for n in (1, 2)}
    res = chip_smoke.run_elastic_rescale("cpu", REHEARSAL_EMBEDDER, texts, n_docs=96, shards=4,
                                         workdir=tmp_path, static=static, embed_atol=1e-5, timeout_s=120)
    assert (res["rebalances"], res["members"], res["delivered"], res["duplicates"]) == (1, 3, 96, 0)
    assert res["equal_static"] == {1: True, 2: True}
    assert sum(g["chunks"] for g in res["by_members"].values()) == 96
    assert tmb.load_membership(str(tmp_path / "elastic" / "pstate"))["n"] == 3


def test_bluegreen_swap_phase_rehearses_on_the_cpu(tmp_path):
    """chip_smoke's `bluegreen_swap` at a small size on the CPU: blue
    persisted by the embedding pipeline, the green swapped in a third
    into 10 clients' 3 s against the gateway; the swap commits with the
    offset and the outbox watermark advanced and the baseline output, and
    every request answers (the phase raises otherwise)."""
    import chip_smoke

    texts = chip_smoke.load_texts(chip_smoke.ROOT)[:300]
    res = chip_smoke.run_bluegreen_swap("cpu", {k: v for k, v in REHEARSAL_EMBEDDER.items() if k != "dtype"},
                                        texts, workdir=tmp_path, clients=10, seconds=3.0)
    assert res["committed"] and res["green_equals_baseline"]
    assert res["offsets"] == {"blue": 40, "after": 80}
    assert res["ok_during_swap"] > 0 and res["errors"] == res["timeouts"] == 0
    assert res["mismatches"] == res["crossed"] == 0
