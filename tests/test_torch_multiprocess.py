"""Multi-process runs of the port: cooperating processes over the TCP mesh,
launched by the spawn CLI, against the JAX package's.

Every case of tests/test_multiprocess.py, run twice: the same script, once
as ``python -m pathway_tpu spawn`` with ``import pathway_tpu as pw`` and
once as ``python -m pathway_tpu_torch spawn`` with ``import
pathway_tpu_torch as pw``. Each process writes its share of the result (or
of the delivered update stream, consolidated); the shares must be
byte-identical between the packages, process by process, besides equal to
the exact aggregates. Process ids for the kill cases come from files the
scripts write, since the CLI owns the processes. Last, the spawned
embedding pipeline of chip_smoke's ``spawn_embed`` phase at a tiny width
on the CPU: ``-n 2`` equals ``-n 1``, and its embeddings agree with the JAX
package's ``JaxEmbedder`` on the same weights.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("pathway_tpu", "pathway_tpu_torch")


def _free_port_base(n: int) -> int:
    """The first of `n * n` consecutive ports that are free now."""
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


def _script(tmp_path, pkg: str, template: str) -> str:
    path = tmp_path / f"{pkg}_script.py"
    path.write_text(template.format(repo=REPO, pkg=pkg))
    return str(path)


def _spawn(pkg: str, script: str, *args: str, n: int = 2, threads: int = 1) -> subprocess.Popen:
    """`python -m <pkg> spawn -n <n>` on a fresh port range, in its own
    process group (so a test can reap every child it started)."""
    return subprocess.Popen(
        [sys.executable, "-m", pkg, "spawn", "-n", str(n), "-t", str(threads),
         "--first-port", str(_free_port_base(n)), "--", script, *args],
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO},
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True,
    )


def _finish(proc: subprocess.Popen, timeout: float = 180) -> tuple[int, str]:
    try:
        _out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode, err


def _run(pkg: str, script: str, *args: str, **kw) -> None:
    rc, err = _finish(_spawn(pkg, script, *args, **kw))
    assert rc == 0, (pkg, err[-3000:])


def _wait_for(path: str, timeout: float = 60) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not os.path.exists(path):
        time.sleep(0.05)
    assert os.path.exists(path), f"{path} never appeared"


def _pid_of(path: str) -> int:
    _wait_for(path)
    for _ in range(100):
        text = open(path).read()
        if text.endswith("\n"):
            return int(text)
        time.sleep(0.01)
    raise AssertionError(f"incomplete pid file {path}")


def _canonical(share: dict) -> str:
    return json.dumps(share, sort_keys=True)


def _shares(prefix: str, n: int = 2) -> list[dict]:
    out = []
    for pid in range(n):
        with open(f"{prefix}.{pid}") as f:
            out.append(json.load(f))
    return out


def _by_package(tmp_path, run_one) -> dict[str, list[str]]:
    """`run_one(pkg, workdir)` for both packages at once (each on its own
    ports and files); returns each package's per-process shares in
    canonical form."""
    from concurrent.futures import ThreadPoolExecutor

    def one(pkg):
        work = tmp_path / pkg
        work.mkdir()
        return [_canonical(s) for s in run_one(pkg, work)]

    with ThreadPoolExecutor(len(PACKAGES)) as pool:
        futures = {pkg: pool.submit(one, pkg) for pkg in PACKAGES}
        return {pkg: f.result() for pkg, f in futures.items()}


def _expected(n: int, groups: int) -> dict:
    exp: dict = {}
    for i in range(n):
        g = f"g{i % groups}"
        t0, n0 = exp.get(g, (0, 0))
        exp[g] = (t0 + i, n0 + 1)
    return exp


def _combine(shares: list[dict]) -> dict:
    combined: dict = {}
    for share in shares:
        for g, tn in share.items():
            assert g not in combined, f"group {g} on two processes"
            combined[g] = tuple(tn)
    return combined


SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, {repo!r})
    import {pkg} as pw
    from {pkg}.io.python import ConnectorSubject

    OUT = sys.argv[1]
    PID = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))

    class Part(ConnectorSubject):
        def __init__(self, lo, hi):
            self.lo, self.hi = lo, hi

        def run(self):
            import time
            for i in range(self.lo, self.hi):
                self.next(g=f"g{{i % 5}}", v=i)
                time.sleep(0.002)

    # two sources -> round-robin ownership across the 2 processes
    a = pw.io.python.read(Part(0, 30), schema=pw.schema_from_types(g=str, v=int), name="a")
    b = pw.io.python.read(Part(30, 60), schema=pw.schema_from_types(g=str, v=int), name="b")
    t = a.concat_reindex(b)
    agg = t.groupby(t.g).reduce(t.g, total=pw.reducers.sum(t.v), n=pw.reducers.count())
    rows = {{}}
    def on_change(key, row, time, is_addition):
        if is_addition:
            rows[row["g"]] = (row["total"], row["n"])
        elif rows.get(row["g"]) == (row["total"], row["n"]):
            del rows[row["g"]]
    pw.io.subscribe(agg, on_change=on_change)
    pw.run()
    with open(OUT + f".{{PID}}", "w") as out:
        json.dump(rows, out)
    """
)


@pytest.mark.parametrize("threads", [1, 2], ids=["processes", "processes_x_threads"])
def test_two_processes_cooperate_like_the_jax_package(tmp_path, threads):
    """2 processes (x 2 thread shards): exact global aggregates, split
    between the processes, each process's share the JAX package's."""

    def run_one(pkg, work):
        out = str(work / "out.json")
        _run(pkg, _script(work, pkg, SCRIPT), out, threads=threads)
        return _shares(out)

    got = _by_package(tmp_path, run_one)
    assert got["pathway_tpu_torch"] == got["pathway_tpu"]
    shares = [json.loads(s) for s in got["pathway_tpu_torch"]]
    assert _combine(shares) == _expected(60, 5)
    assert all(shares), f"one process owned everything: {shares}"


def test_spawn_cli_contract(tmp_path):
    """`python -m pathway_tpu_torch spawn` keeps the reference's parser and
    environment contract: each child sees PATHWAY_PROCESSES,
    PATHWAY_PROCESS_ID, PATHWAY_FIRST_PORT and PATHWAY_THREADS as the JAX
    package's children do; `spawn-from-env` reads PATHWAY_SPAWN_ARGS."""
    from pathway_tpu.cli import build_parser as jax_parser
    from pathway_tpu_torch.cli import build_parser as port_parser

    assert port_parser().prog == "pathway_tpu_torch"
    argv = ["spawn", "-n", "3", "-t", "2", "--first-port", "12000", "--", "app.py", "x"]
    want, got = vars(jax_parser().parse_args(argv)), vars(port_parser().parse_args(argv))
    assert {k: v for k, v in got.items() if k != "fn"} == {k: v for k, v in want.items() if k != "fn"}

    env_script = tmp_path / "env.py"
    env_script.write_text(
        "import json, os, sys\n"
        "keys = ('PATHWAY_PROCESSES', 'PATHWAY_PROCESS_ID', 'PATHWAY_FIRST_PORT', 'PATHWAY_THREADS')\n"
        "pid = os.environ['PATHWAY_PROCESS_ID']\n"
        "json.dump({k: os.environ[k] for k in keys}, open(sys.argv[1] + '.' + pid, 'w'))\n"
    )
    def launch(pkg, how):
        out = str(tmp_path / f"{pkg}.{how}.env")
        cmd = [sys.executable, "-m", pkg, how]
        env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
        if how == "spawn":
            cmd += ["-n", "2", "-t", "3", "--first-port", "12345", "--"]
        else:
            env["PATHWAY_SPAWN_ARGS"] = "-n 2 -t 3 --first-port 12345"
        r = subprocess.run(cmd + [str(env_script), out], capture_output=True, text=True, timeout=120,
                           env=env, cwd=REPO)
        assert r.returncode == 0, (pkg, how, r.stderr[-2000:])
        return _shares(out)

    from concurrent.futures import ThreadPoolExecutor

    runs = [(pkg, how) for pkg in PACKAGES for how in ("spawn", "spawn-from-env")]
    with ThreadPoolExecutor(len(runs)) as pool:
        seen = dict(zip(runs, pool.map(lambda r: launch(*r), runs)))
    assert seen["pathway_tpu_torch", "spawn"] == seen["pathway_tpu", "spawn"] == [
        {"PATHWAY_PROCESSES": "2", "PATHWAY_PROCESS_ID": str(p), "PATHWAY_FIRST_PORT": "12345",
         "PATHWAY_THREADS": "3"} for p in range(2)
    ]
    assert seen["pathway_tpu_torch", "spawn-from-env"] == seen["pathway_tpu", "spawn-from-env"] \
        == seen["pathway_tpu", "spawn"]

    # a cooperating pipeline through the CLI, as in the reference's case
    def run_one(pkg, work):
        out = str(work / "out.json")
        _run(pkg, _script(work, pkg, SCRIPT), out)
        return _shares(out)

    got = _by_package(tmp_path, run_one)
    assert got["pathway_tpu_torch"] == got["pathway_tpu"]
    assert sum(n for _t, n in _combine([json.loads(s) for s in got["pathway_tpu_torch"]]).values()) == 60


def test_spawn_fails_when_a_child_fails(tmp_path):
    """The CLI's exit code is non-zero when any child exits non-zero."""
    script = tmp_path / "fail.py"
    script.write_text("import os, sys\nsys.exit(3 if os.environ['PATHWAY_PROCESS_ID'] == '1' else 0)\n")
    procs = [subprocess.Popen([sys.executable, "-m", pkg, "spawn", "-n", "2", "--", str(script)],
                              stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=REPO,
                              env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"})
             for pkg in PACKAGES]
    codes = [p.wait(timeout=120) for p in procs]
    assert codes == [3, 3]


ITERATE_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, {repo!r})
    import {pkg} as pw

    OUT = sys.argv[1]
    PID = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))

    def collatz_step(t):
        return {{"t": t.select(
            a=pw.if_else(t.a == 1, 1,
                         pw.if_else(t.a % 2 == 0, t.a // 2, 3 * t.a + 1)))}}

    start = pw.debug.table_from_markdown("a\\n3\\n7\\n27").with_id_from(pw.this.a)
    res = pw.iterate(collatz_step, t=start)
    rows = []
    pw.io.subscribe(res, on_change=lambda key, row, time, is_addition:
                    rows.append(row["a"]) if is_addition else None)
    pw.run()
    with open(OUT + f".{{PID}}", "w") as out:
        json.dump(rows, out)
    """
)


def test_iterate_under_two_processes(tmp_path):
    """pw.iterate pins its body to process 0; the other process must not
    deadlock on phantom exchange barriers inside the loop."""

    def run_one(pkg, work):
        out = str(work / "it.json")
        _run(pkg, _script(work, pkg, ITERATE_SCRIPT), out)
        return _shares(out)

    got = _by_package(tmp_path, run_one)
    assert got["pathway_tpu_torch"] == got["pathway_tpu"]
    assert sorted(sum((json.loads(s) for s in got["pathway_tpu_torch"]), [])) == [1, 1, 1]


SLOW_SCRIPT = textwrap.dedent(
    """
    import os, sys, time
    sys.path.insert(0, {repo!r})
    import {pkg} as pw
    from {pkg}.io.python import ConnectorSubject

    READY = sys.argv[1]
    PID = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
    with open(READY + f".pid{{PID}}", "w") as f:
        f.write(f"{{os.getpid()}}\\n")

    class Slow(ConnectorSubject):
        def run(self):
            for i in range(100000):
                self.next(g=f"g{{i % 5}}", v=i)
                if i == 5:
                    open(READY + f".{{PID}}", "w").write("up")
                time.sleep(0.05)

    t = pw.io.python.read(Slow(), schema=pw.schema_from_types(g=str, v=int), name="slow")
    agg = t.groupby(t.g).reduce(t.g, total=pw.reducers.sum(t.v))
    pw.io.subscribe(agg, on_change=lambda key, row, time, is_addition: None)
    pw.run()
    """
)


def test_worker_failure_detected_not_hung(tmp_path):
    """Killing one process mid-run surfaces a peer-death error on the
    survivor promptly, on both packages, and the CLI exits non-zero."""
    for pkg in PACKAGES:
        ready = str(tmp_path / f"{pkg}.ready")
        proc = _spawn(pkg, _script(tmp_path, pkg, SLOW_SCRIPT), ready)
        try:
            victim = _pid_of(ready + ".pid1")
            _wait_for(ready + ".0")
            time.sleep(0.5)  # let a few more waves cross the mesh
            os.kill(victim, signal.SIGKILL)
            t0 = time.monotonic()
            rc, err = _finish(proc, timeout=120)
            detect_s = time.monotonic() - t0
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        assert rc != 0, pkg
        assert "died" in err or "peer" in err, (pkg, err[-1500:])
        assert detect_s < 30, f"{pkg} took {detect_s:.1f}s to notice the dead peer"


PERSIST_SCRIPT = textwrap.dedent(
    """
    import json, os, sys, time
    sys.path.insert(0, {repo!r})
    import {pkg} as pw
    from {pkg}.io.python import ConnectorSubject

    PDIR, OUT, READY = sys.argv[1], sys.argv[2], sys.argv[3]
    PID = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
    with open(READY + f".pid{{PID}}", "w") as f:
        f.write(f"{{os.getpid()}}\\n")

    class Nums(ConnectorSubject):
        def run(self):
            for i in range(200):
                self.next(g=f"g{{i % 4}}", v=i)
                if i == 5:
                    open(READY + f".{{PID}}", "w").write("up")
                time.sleep(0.01)

    t = pw.io.python.read(Nums(), schema=pw.schema_from_types(g=str, v=int), name="nums")
    agg = t.groupby(t.g).reduce(t.g, total=pw.reducers.sum(t.v), n=pw.reducers.count())
    sink = open(OUT + f".{{PID}}", "a")
    def on_change(key, row, time, is_addition):
        sink.write(json.dumps({{**row, "add": is_addition}}) + "\\n"); sink.flush()
    pw.io.subscribe(agg, on_change=on_change)
    pw.run(persistence_config=pw.persistence.Config(
        pw.persistence.Backend.filesystem(PDIR)))
    """
)


def _consolidate(path: str) -> dict:
    state: dict = {}
    if not os.path.exists(path):
        return state
    with open(path) as f:
        for line in f:
            ev = json.loads(line)
            if ev["add"]:
                state[ev["g"]] = [ev["total"], ev["n"]]
            elif state.get(ev["g"]) == [ev["total"], ev["n"]]:
                del state[ev["g"]]
    return state


def test_multiprocess_kill_both_and_resume_exact(tmp_path):
    """Both processes die mid-run (SIGKILL, a moment apart); the restart
    negotiates the minimum common epoch and resumes to exact aggregates,
    each process's consolidated share the JAX package's."""

    def run_one(pkg, work):
        pdir, out, ready = str(work / "pstate"), str(work / "deliveries"), str(work / "ready")
        script = _script(work, pkg, PERSIST_SCRIPT)
        proc = _spawn(pkg, script, pdir, out, ready)
        try:
            pids = [_pid_of(ready + f".pid{p}") for p in range(2)]
            _wait_for(ready + ".0")
            time.sleep(1.0)
            os.kill(pids[0], signal.SIGKILL)
            time.sleep(0.05)
            os.kill(pids[1], signal.SIGKILL)
            rc, _err = _finish(proc, timeout=60)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        assert rc != 0
        os.unlink(ready + ".0")
        _run(pkg, script, pdir, out, ready)
        return [_consolidate(out + f".{p}") for p in range(2)]

    got = _by_package(tmp_path, run_one)
    assert got["pathway_tpu_torch"] == got["pathway_tpu"]
    assert _combine([json.loads(s) for s in got["pathway_tpu_torch"]]) == _expected(200, 4)


CRASH_SCRIPT = textwrap.dedent(
    """
    import json, os, sys, threading, time
    sys.path.insert(0, {repo!r})
    import {pkg} as pw
    from {pkg}.io.python import ConnectorSubject

    OUT = sys.argv[1]       # deliveries jsonl, appended across runs
    PDIR = sys.argv[2]
    MODE = sys.argv[3]      # 'crash' or 'finish'
    PID = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
    with open(OUT + f".pid{{PID}}", "w") as f:
        f.write(f"{{os.getpid()}}\\n")

    class Part(ConnectorSubject):
        def __init__(self, lo, hi):
            self.lo, self.hi = lo, hi

        def run(self):
            for i in range(self.lo, self.hi):
                self.next(g=f"g{{i % 5}}", v=i)
                time.sleep(0.002)

    a = pw.io.python.read(Part(0, 200), schema=pw.schema_from_types(g=str, v=int), name="a")
    b = pw.io.python.read(Part(200, 400), schema=pw.schema_from_types(g=str, v=int), name="b")
    t = a.concat_reindex(b)
    agg = t.groupby(t.g).reduce(t.g, total=pw.reducers.sum(t.v), n=pw.reducers.count())
    sink = open(OUT + f".{{PID}}", "a")
    def on_change(key, row, time, is_addition):
        sink.write(json.dumps(
            {{"g": row["g"], "total": row["total"], "n": row["n"], "add": is_addition}}
        ) + "\\n")
        sink.flush()
    pw.io.subscribe(agg, on_change=on_change)

    if MODE == "crash" and PID == 1:
        def crasher():
            # kill -9 semantics AFTER both processes committed an epoch
            metas = [os.path.join(PDIR, f"proc-{{p}}", "metadata.json") for p in (0, 1)]
            deadline = time.time() + 60
            while time.time() < deadline:
                if all(os.path.exists(m) for m in metas):
                    open(OUT + ".crashed", "w").close()
                    os._exit(9)
                time.sleep(0.005)
            os._exit(3)
        threading.Thread(target=crasher, daemon=True).start()

    pw.run(persistence_config=pw.persistence.Config(
        pw.persistence.Backend.filesystem(PDIR),
        snapshot_interval_ms=60))
    """
)


def test_mesh_kill9_coordinated_recovery(tmp_path):
    """Process 1 of a 2-process mesh exits as if killed -9 after both
    committed an epoch; the stalled survivor is killed too; the mesh
    restarts on the same persistence roots and coordinated min-epoch
    recovery gives exact aggregates, the JAX package's share for share."""

    def run_one(pkg, work):
        out, pdir = str(work / "deliv"), str(work / "pstorage")
        script = _script(work, pkg, CRASH_SCRIPT)
        proc = _spawn(pkg, script, out, pdir, "crash")
        try:
            survivor = _pid_of(out + ".pid0")
            _wait_for(out + ".crashed", timeout=120)
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                os.kill(survivor, signal.SIGKILL)
            rc, err = _finish(proc, timeout=60)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
        assert rc != 0, err[-2000:]
        _run(pkg, script, out, pdir, "finish")
        return [_consolidate(out + f".{p}") for p in range(2)]

    got = _by_package(tmp_path, run_one)
    assert got["pathway_tpu_torch"] == got["pathway_tpu"]
    assert _combine([json.loads(s) for s in got["pathway_tpu_torch"]]) == _expected(400, 5)


NATIVE_WIRE_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, {repo!r})
    import {pkg} as pw

    OUT = sys.argv[1]
    INPUT = sys.argv[2]
    PID = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))

    class S(pw.Schema):
        word: str

    # one fs source (owned by process 0); the groupby exchange ships the
    # token batches to their owner processes in wire form
    t = pw.io.fs.read(INPUT, format="json", schema=S, mode="streaming",
                      autocommit_duration_ms=20, _single_pass=True)
    agg = t.groupby(t.word).reduce(t.word, n=pw.reducers.count())
    rows = {{}}
    def on_change(key, row, time, is_addition):
        if is_addition:
            rows[row["word"]] = row["n"]
        elif rows.get(row["word"]) == row["n"]:
            del rows[row["word"]]
    pw.io.subscribe(agg, on_change=on_change)
    pw.run()
    with open(OUT + f".{{PID}}", "w") as out:
        json.dump(rows, out)
    """
)


def test_native_batches_cross_process_wire(tmp_path):
    """Token-resident fs ingest under a 2-process mesh: batches split in C
    and cross the TCP mesh in wire form; combined counts are exact and
    each process owns the words the JAX package's process owns."""
    inp = tmp_path / "in.jsonl"
    inp.write_text("".join('{"word": "w%d"}\n' % (i % 6) for i in range(900)))

    def run_one(pkg, work):
        out = str(work / "out")
        _run(pkg, _script(work, pkg, NATIVE_WIRE_SCRIPT), out, str(inp))
        return _shares(out)

    got = _by_package(tmp_path, run_one)
    assert got["pathway_tpu_torch"] == got["pathway_tpu"]
    shares = [json.loads(s) for s in got["pathway_tpu_torch"]]
    assert _combine([{w: (n,) for w, n in s.items()} for s in shares]) == {f"w{i}": (150,) for i in range(6)}
    assert all(shares), f"one process owned everything: {shares}"


# ----------------------------------------------- chip_smoke's spawn_embed


SPAWN_EMBED_CFG = dict(vocab_size=512, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32, embed_dim=32)
# the port's f32 encoder on the CPU against JaxEmbedder's f32 encoder on
# the same weights: the two sum in other orders (|e| <= 1, unit vectors)
EMBED_VS_JAX_ATOL = 1e-5


def test_spawn_embed_pipeline_is_width_invariant_and_matches_jax_embedder(tmp_path):
    """chip_smoke's `spawn_embed` phase at a tiny width on the CPU: 96
    documents in 4 jsonlines shards, chunked, embedded by TorchEmbedder in
    each process, grouped by document and joined back. `-n 2` gives the
    same keys, chunk counts and texts as `-n 1`, byte for byte, and the
    same embeddings within the f32 rounding of another batch; each
    process embedded rows. The embeddings agree with JaxEmbedder's on the
    weights carried across by models/convert.py."""
    import jax

    import chip_smoke
    import pathway_tpu.models.transformer as jtfm
    from pathway_tpu.xpacks.llm.embedders import JaxEmbedder

    jcfg = jtfm.embedder_config(**SPAWN_EMBED_CFG, dtype=jax.numpy.float32)
    params = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(5), jcfg))
    params_path = tmp_path / "params.npz"
    chip_smoke.save_params(params, params_path)

    texts = chip_smoke.load_texts(chip_smoke.ROOT)[:40]
    res = chip_smoke.run_spawn_embed(
        "cpu", dict(SPAWN_EMBED_CFG, dtype="float32"), texts, n_docs=96, shards=4, processes=(1, 2),
        workdir=tmp_path, params=params_path, embed_atol=EMBED_VS_JAX_ATOL,
    )
    assert res["equal_n1_n2"] and res["max_abs_err_n1_n2"] <= EMBED_VS_JAX_ATOL
    for n, run in res["runs"].items():
        assert len(run["processes"]) == n
        assert all(p["embedded_rows"] > 0 for p in run["processes"]), run
        assert sum(p["output_rows"] for p in run["processes"]) == res["chunks"]

    out = chip_smoke.read_spawn_output(tmp_path / "n1")
    want = JaxEmbedder(config=jcfg, params=params).encode_many(list(out["text"]))
    got = out["vec"]
    assert got.shape == (res["chunks"], SPAWN_EMBED_CFG["embed_dim"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=EMBED_VS_JAX_ATOL)


# ------------------------------------------------ C4: the wire form's retry


def _wide_batch(dataplane):
    """A native batch whose unique rows need more than the wire form's
    first 64 KiB blob: 2,000 rows of about 100 bytes."""
    tab = dataplane.InternTable()
    rows = [(i, f"row {i:05d} " + "x" * 90) for i in range(2000)]
    tok = np.array([tab.intern_row(r) for r in rows], np.uint64)
    n = len(rows)
    batch = dataplane.NativeBatch(tab, np.arange(n, dtype=np.uint64), np.zeros(n, np.uint64), tok,
                                  np.ones(n, np.int64))
    return batch, rows


def test_native_wire_form_carries_batches_past_the_first_blob():
    """ROADMAP C4: a batch whose unique rows outgrow the first blob
    crosses the wire whole (the retry starts from the batch's own tokens),
    and the batch itself is left as it was."""
    from pathway_tpu_torch.engine.native import dataplane

    if not dataplane.available():
        pytest.skip("the native data plane did not build")
    batch, rows = _wide_batch(dataplane)
    before = batch.token.copy()
    back = dataplane.NativeBatch.from_wire(batch.to_wire(), dataplane.InternTable())
    assert [back.tab.row(int(t)) for t in back.token] == rows
    assert np.array_equal(back.key_lo, batch.key_lo) and np.array_equal(back.diff, batch.diff)
    assert np.array_equal(batch.token, before)


def test_the_reference_wire_form_fails_past_the_first_blob():
    """The JAX package keeps the fault: its retry hands the C export the
    tokens the first attempt rewrote to local ids, local id 0 is no token,
    and the INT64_MIN it returns overflows the next blob's size."""
    from pathway_tpu.engine.native import dataplane

    if not dataplane.available():
        pytest.skip("the reference's native data plane did not build")
    batch, _rows = _wide_batch(dataplane)
    with pytest.raises(OverflowError):
        batch.to_wire()


# --------------------------------- C5: the mesh's sends to a slow receiver


def _mesh_pair(mesh_mod):
    import threading

    base = _free_port_base(2)
    meshes: list = [None, None]

    def make(pid):
        meshes[pid] = mesh_mod.ProcessMesh(process_id=pid, n_processes=2, first_port=base)

    threads = [threading.Thread(target=make, args=(p,)) for p in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(meshes), "the mesh did not connect"
    return meshes


def _send_to_a_held_receiver(mesh_mod, hold_s: float):
    """Process 0 sends a 32 MB frame while process 1's receive thread is
    held for `hold_s` seconds before it reads the frame's body."""
    import threading

    sender, receiver = _mesh_pair(mesh_mod)
    gate = threading.Event()
    recv_exact = receiver._recv_exact

    def held(conn, n):
        if n > 1 << 20:
            gate.wait(60)
        return recv_exact(conn, n)

    receiver._recv_exact = held
    payload = np.arange(8 << 20, dtype=np.float32)
    timer = threading.Timer(hold_s, gate.set)
    timer.start()
    try:
        sender.send_bucket(1, node_id=7, rnd=3, entries=[payload])
        got = receiver.recv_bucket(0, node_id=7, rnd=3)
        return got, payload
    finally:
        gate.set()
        timer.cancel()
        sender.close()
        receiver.close()


def test_mesh_send_waits_for_a_slow_receiver():
    """ROADMAP C5: a send to a live peer that drains slowly waits, past
    the 5 s that bound the connect, and the frame arrives whole."""
    from pathway_tpu_torch.parallel import process_mesh

    got, payload = _send_to_a_held_receiver(process_mesh, hold_s=6.0)
    assert len(got) == 1 and np.array_equal(got[0], payload)


def test_the_reference_mesh_send_times_out_on_a_slow_receiver():
    """The JAX package keeps the fault: its send sockets keep the
    connect's 5 s timeout, so the same send raises."""
    from pathway_tpu.parallel import process_mesh

    with pytest.raises(TimeoutError):
        _send_to_a_held_receiver(process_mesh, hold_s=6.0)
