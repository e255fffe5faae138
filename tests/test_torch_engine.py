"""The port's host dataflow engine against the JAX package's.

The same pipelines, built from the same seeded inputs, run through
``import pathway_tpu as pw`` and ``import pathway_tpu_torch as pw`` in
one process (each package has its own parse graph, cleared around every
test); their output files must be byte-identical. Also here: the native
libraries' loader under concurrent first use, the batched-UDF seam on the
port's device plane, the host-wire exchange hooks and the metrics export.
"""

import fcntl
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu.engine.core as jcore
import pathway_tpu.engine.native as jnative
import pathway_tpu.engine.native.dataplane as jdataplane
import pathway_tpu_torch as tpw
import pathway_tpu_torch.engine.core as tcore
import pathway_tpu_torch.engine.native as tnative
import pathway_tpu_torch.engine.native.dataplane as tdataplane
from pathway_tpu.internals.parse_graph import G as JAX_G
from pathway_tpu_torch.internals.parse_graph import G as PORT_G
from tests.test_torch_parity import align_row_ids

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": jpw, "port": tpw}
# each package's two native loaders and the engine module that caches
# which batch type the data plane gives it
PLANE_MODULES = {
    "jax": (jnative, jdataplane, jcore),
    "port": (tnative, tdataplane, tcore),
}


@pytest.fixture(autouse=True)
def _clear_graphs():
    JAX_G.clear()
    PORT_G.clear()
    align_row_ids()
    yield
    JAX_G.clear()
    PORT_G.clear()


def _wordcount_jsonl(path: Path, n: int) -> None:
    """bench.py's wordcount generator (`_gen_wordcount_input`, seed 7)."""
    rng = np.random.default_rng(7)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    dictionary = ["".join(rng.choice(letters, 10)) for _ in range(10_000)]
    idx = rng.integers(0, len(dictionary), n)
    path.write_text("\n".join('{"word": "%s"}' % dictionary[i] for i in idx) + "\n")


# ------------------------------------------------------------- pipelines
# each builds one pipeline on `pw`, reading under `src` and writing one
# output file `out`


def _wordcount(pw, src: Path, out: Path) -> None:
    class S(pw.Schema):
        word: str

    t = pw.io.fs.read(str(src / "words.jsonl"), format="json", schema=S, mode="static")
    res = t.groupby(t.word).reduce(t.word, count=pw.reducers.count())
    pw.io.csv.write(res, str(out))


def _join(pw, src: Path, out: Path) -> None:
    class L(pw.Schema):
        k: int
        a: str

    class R(pw.Schema):
        k: int
        b: float

    left = pw.io.csv.read(str(src / "left.csv"), schema=L, mode="static")
    right = pw.io.csv.read(str(src / "right.csv"), schema=R, mode="static")
    j = left.join(right, left.k == right.k).select(k=left.k, a=left.a, b=right.b)
    pw.io.jsonlines.write(j, str(out))


def _groupby_reducers(pw, src: Path, out: Path) -> None:
    class S(pw.Schema):
        g: str
        v: int
        f: float

    t = pw.io.csv.read(str(src / "groups.csv"), schema=S, mode="static")
    res = t.groupby(t.g).reduce(
        t.g,
        n=pw.reducers.count(),
        s=pw.reducers.sum(t.v),
        fs=pw.reducers.sum(t.f),
        avg=pw.reducers.avg(t.v),
        lo=pw.reducers.min(t.v),
        hi=pw.reducers.max(t.f),
    )
    pw.io.csv.write(res, str(out))


def _retractions(pw, src: Path, out: Path) -> None:
    t = pw.debug.table_from_markdown(
        """
        k | v | __time__ | __diff__
        a | 1 | 2        | 1
        b | 2 | 2        | 1
        a | 1 | 4        | -1
        a | 5 | 4        | 1
        c | 7 | 6        | 1
        b | 2 | 8        | -1
        c | 3 | 8        | 1
        """
    )
    res = t.groupby(t.k).reduce(t.k, total=pw.reducers.sum(t.v), n=pw.reducers.count())
    pw.io.csv.write(res, str(out))


def _fill_error(pw, src: Path, out: Path) -> None:
    t = pw.debug.table_from_markdown(
        """
        a  | b
        10 | 2
        7  | 0
        9  | 3
        1  | 0
        """
    )
    res = t.select(a=t.a, q=pw.fill_error(t.a // t.b, -1))
    pw.io.csv.write(res, str(out))


PIPELINES = {
    "wordcount": _wordcount,
    "join": _join,
    "groupby_reducers": _groupby_reducers,
    "retractions": _retractions,
    "fill_error": _fill_error,
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory) -> Path:
    src = tmp_path_factory.mktemp("engine_inputs")
    _wordcount_jsonl(src / "words.jsonl", 20_000)
    rng = np.random.default_rng(3)
    left = ["k,a"] + [f"{int(k)},w{int(k) % 97}" for k in rng.integers(0, 400, 1500)]
    right = ["k,b"] + [f"{int(k)},{rng.normal():.6f}" for k in rng.integers(0, 400, 900)]
    groups = ["g,v,f"] + [
        f"g{int(g)},{int(v)},{f:.4f}"
        for g, v, f in zip(rng.integers(0, 50, 4000), rng.integers(-1000, 1000, 4000), rng.normal(size=4000))
    ]
    (src / "left.csv").write_text("\n".join(left) + "\n")
    (src / "right.csv").write_text("\n".join(right) + "\n")
    (src / "groups.csv").write_text("\n".join(groups) + "\n")
    return src


def _run_pipeline(name: str, pkg: str, src: Path, out: Path) -> bytes:
    pw = PACKAGES[pkg]
    PIPELINES[name](pw, src, out)
    pw.run()
    return out.read_bytes()


def _plane_of(pkg: str) -> str:
    """The plane a package's engine runs on in this process."""
    native, dataplane, _core = PLANE_MODULES[pkg]
    zset, dp = native.available(), dataplane.available()
    if zset and dp:
        return "native"
    if not zset and not dp:
        return "python"
    return f"mixed (zset {zset}, dataplane {dp})"


def _unload_native(pkg: str, monkeypatch) -> None:
    """Both loaders of `pkg` as a lost first-use build leaves them: tried,
    no library. PATHWAY_TPU_NATIVE=0 would not do: each loader reads it
    once per process."""
    native, dataplane, core = PLANE_MODULES[pkg]
    for mod in (native, dataplane):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_TRIED", True)
    monkeypatch.setattr(core, "NativeBatch", None)
    monkeypatch.setattr(core, "_NB_RESOLVED", True)


def _load_native(pkg: str, monkeypatch, private_dir: Path) -> None:
    """Make sure both loaders of `pkg` hold their library. The JAX
    package's loader builds with no lock, so under several test workers
    one of them can find a half-written library (or lose one that another
    worker unlinked) and settle on "no library" for the whole process.
    Such a loader is tried again under a file lock shared by the workers,
    polling until the other worker's build is complete; a library that
    still does not load is built into a private directory (the test
    repoints the loader's module state, never the package's files)."""
    native, dataplane, core = PLANE_MODULES[pkg]
    monkeypatch.setenv("PATHWAY_TPU_NATIVE", "1")
    for mod in (native, dataplane):
        if mod._load() is not None:
            continue
        lock = Path(tempfile.gettempdir()) / f"pathway-native-retry-{mod.__name__}.lock"
        with open(lock, "w") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            try:
                deadline = time.monotonic() + 30
                while mod._LIB is None and time.monotonic() < deadline:
                    mod._TRIED = False
                    if mod._load() is None:
                        time.sleep(0.5)
                if mod._LIB is None:
                    private_dir.mkdir(parents=True, exist_ok=True)
                    for src in Path(mod.__file__).parent.glob("*.cpp"):
                        shutil.copy(src, private_dir / src.name)
                    monkeypatch.setattr(mod, "_HERE", private_dir)
                    mod._TRIED = False
                    mod._load()
            finally:
                fcntl.flock(fh, fcntl.LOCK_UN)
        assert mod._LIB is not None, f"{mod.__name__}: the native library does not load"
    core._NB_RESOLVED = False  # resolve the batch type against the loaded plane


@pytest.fixture(params=["native", "python"])
def engine_plane(request, monkeypatch, tmp_path):
    """Both packages on the same plane: the compiled native planes, or
    both loaders set to "no library" (the Python plane). Asserts, before
    and after the test, the plane each side ran on."""
    for pkg in PLANE_MODULES:
        if request.param == "python":
            _unload_native(pkg, monkeypatch)
        else:
            _load_native(pkg, monkeypatch, tmp_path / f"native-{pkg}")
    for pkg in PLANE_MODULES:
        assert _plane_of(pkg) == request.param, f"the {pkg} side is on the {_plane_of(pkg)} plane"
    yield request.param
    for pkg in PLANE_MODULES:
        assert _plane_of(pkg) == request.param, f"the {pkg} side ran on the {_plane_of(pkg)} plane"


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_engine_output_is_byte_identical_to_the_jax_package(name, engine_plane, inputs, tmp_path, monkeypatch):
    """Output files byte for byte, at the same PATHWAY_THREADS on both
    sides (morsel emission order depends on it), with both packages on
    the same plane: the native planes, then the Python plane."""
    monkeypatch.setenv("PATHWAY_THREADS", "1")
    want = _run_pipeline(name, "jax", inputs, tmp_path / "jax.out")
    got = _run_pipeline(name, "port", inputs, tmp_path / "port.out")
    assert want.count(b"\n") > 1, want
    assert got == want


def test_wordcount_equals_a_counter_over_the_input(inputs, tmp_path):
    from collections import Counter

    _run_pipeline("wordcount", "port", inputs, tmp_path / "wc.csv")
    want = Counter(json.loads(ln)["word"] for ln in (inputs / "words.jsonl").read_text().splitlines())
    got: Counter = Counter()
    lines = (tmp_path / "wc.csv").read_text().splitlines()
    assert lines[0] == "word,count,time,diff"
    for ln in lines[1:]:
        word, count, _time, diff = ln.split(",")
        got[word] += int(count) * int(diff)
    assert got == want


def _batched_double(pw, calls: list, rows: list):
    @pw.udf(batched=True)
    def double(xs: list) -> list[int]:
        calls.append(len(xs))
        return [x * 2 for x in xs]

    waves = [(i, 2 * (i // 10) + 2, 1) for i in range(30)]  # times 2, 4, 6
    t = pw.debug.table_from_rows(pw.schema_from_types(v=int), waves, is_stream=True)
    r = t.select(d=double(pw.this.v))
    pw.io.subscribe(r, on_change=lambda key, row, time, is_addition: rows.append((time, row["d"])))
    pw.run()
    return double


WANT_ROWS = [(2 * (i // 10) + 2, 2 * i) for i in range(30)]


def _hold_async_loop_until_all_rows_submitted(runtime, monkeypatch, rows: int = 30):
    """Block `runtime`'s async-apply event loop on an event that is set once
    the engine has handed it `rows` rows, so every wave's row coroutines
    are queued on the loop before any of them runs."""
    import threading

    gate = threading.Event()
    submitted = [0]
    submit = runtime._submit_async_batch

    def counting_submit(fn, insertions, graph):
        fut = submit(fn, insertions, graph)
        submitted[0] += len(insertions)
        if submitted[0] >= rows:
            gate.set()
        return fut

    monkeypatch.setattr(runtime, "_submit_async_batch", counting_submit)
    runtime._get_async_loop().call_soon_threadsafe(gate.wait, 60)
    return gate


def test_batched_udf_wave_flushes_once_through_the_port_plane(monkeypatch):
    """A `pw.udf(batched=True)` stage coalesces its rows into one flush on
    the port's device plane, as on the JAX package's: with the debug
    stream's three waves all handed to the event loop before it runs
    (held on an event here, so the interleaving does not depend on how
    busy the machine is), the deferred stage takes them in one batch call,
    and each row still comes out at its own time."""
    import pathway_tpu.engine.runtime as jruntime
    import pathway_tpu_torch.engine.runtime as truntime
    from pathway_tpu.engine.device_plane import WaveCoalescer as JaxCoalescer
    from pathway_tpu_torch.engine.device_plane import WaveCoalescer

    for pw, runtime, cls in ((jpw, jruntime, JaxCoalescer), (tpw, truntime, WaveCoalescer)):
        gate = _hold_async_loop_until_all_rows_submitted(runtime, monkeypatch)
        calls: list[int] = []
        rows: list = []
        double = _batched_double(pw, calls, rows)
        assert gate.is_set(), pw.__name__
        assert calls == [30], pw.__name__
        assert sorted(rows) == WANT_ROWS, pw.__name__
        (coalescer,) = double._coalescers.values()
        assert isinstance(coalescer, cls) and coalescer.flushes == 1, pw.__name__


def test_batched_udf_rows_match_the_reference_under_any_interleaving():
    """With no gate, how the three waves split into flushes depends on
    timing, on both packages; what holds under any interleaving is that
    every row goes through one flush exactly once, at its own time, and
    the rows equal the JAX package's."""
    want_calls: list[int] = []
    want_rows: list = []
    _batched_double(jpw, want_calls, want_rows)
    calls: list[int] = []
    rows: list = []
    double = _batched_double(tpw, calls, rows)
    assert sorted(rows) == sorted(want_rows) == WANT_ROWS
    assert sum(calls) == sum(want_calls) == 30
    (coalescer,) = double._coalescers.values()
    assert coalescer.flushes == len(calls)


def test_native_planes_load_and_carry_the_engine(inputs, tmp_path):
    """g++ is here, so both host libraries load from the port's own
    `_build/` and the wordcount runs on the native plane."""
    from pathway_tpu_torch.engine import native

    planes = native.planes()
    assert planes["zset"] and planes["dataplane"], planes
    assert native.BUILD_DIR == REPO / "pathway_tpu_torch" / "_build"
    assert list(native.BUILD_DIR.glob("libzset-*.so")) and list(native.BUILD_DIR.glob("libdataplane-*.so"))
    assert not list((REPO / "pathway_tpu_torch" / "engine" / "native").glob("*.so"))


_LOAD_AT = r"""
import json, sys, time
start = float(sys.argv[1])
while time.time() < start:
    time.sleep(0.001)
from pathway_tpu_torch.engine import native
print(json.dumps(native.planes()))
"""


def test_native_build_is_safe_under_concurrent_first_use(tmp_path):
    """Four processes load the native libraries at the same moment on a
    fresh `_build/`: one builds each library under the file lock and
    renames it into place, the others wait for it, and every process ends
    up on the native plane (no half-written library is ever loaded)."""
    pkg = tmp_path / "pathway_tpu_torch"
    shutil.copytree(
        REPO / "pathway_tpu_torch", pkg,
        ignore=shutil.ignore_patterns("_build", "__pycache__", "*.so"),
    )
    env = {**os.environ, "PYTHONPATH": str(tmp_path), "PATHWAY_TPU_NATIVE": "1"}
    import time

    start = time.time() + 5.0  # past every process's import of the package
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _LOAD_AT, str(start)], cwd=tmp_path, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(4)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert all(o["zset"] and o["dataplane"] for o in outs), outs
    # each library was compiled by exactly one process
    assert sum("zset" in o["build_seconds"] for o in outs) == 1, outs
    assert sum("dataplane" in o["build_seconds"] for o in outs) == 1, outs
    build = pkg / "_build"
    assert len(list(build.glob("libzset-*.so"))) == 1
    assert len(list(build.glob("libdataplane-*.so"))) == 1
    assert not list(build.glob(".lib*"))  # no private temp left behind


def test_exchange_hooks_keep_the_host_wire(monkeypatch):
    """Auto on a machine without two CUDA devices and "0" take the host
    wire; "1" builds the mesh exchangers, and raises when there is no
    mesh to build (the JAX package returns None there)."""
    from pathway_tpu_torch.parallel import column_plane, device_exchange

    monkeypatch.setattr(device_exchange, "_ENGINE_EXCHANGER", None)
    monkeypatch.setattr(column_plane, "_ENGINE_EXCHANGER", None)
    monkeypatch.delenv("PATHWAY_MESH_DEVICES", raising=False)
    monkeypatch.delenv("PATHWAY_DEVICE_EXCHANGE", raising=False)
    assert device_exchange.engine_exchanger() is None
    assert column_plane.engine_column_exchanger() is None
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "0")
    assert device_exchange.engine_exchanger() is None
    monkeypatch.setenv("PATHWAY_DEVICE_EXCHANGE", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for hook in (device_exchange.engine_exchanger, column_plane.engine_column_exchanger):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hook()
    monkeypatch.setenv("PATHWAY_MESH_DEVICES", "cpu*2")
    assert device_exchange.engine_exchanger().mesh.size == 2
    assert column_plane.engine_column_exchanger().mesh.size == 2


def test_metrics_export_slot_pool_and_index_gauges(monkeypatch):
    """The observability plane's registry carries the slot-pool counters
    and the IVF-PQ index gauges, and the metrics page reads the port
    plane's shape ledger under the JAX package's metric names."""
    from pathway_tpu_torch.engine.device_plane import SlotPool, get_device_plane
    from pathway_tpu_torch.indexing import IvfPqIndex
    from pathway_tpu_torch.internals import metrics
    from pathway_tpu_torch.internals import observability as obs

    monkeypatch.setattr(obs, "PLANE", obs.ObservabilityPlane())
    reg = obs.PLANE.metrics
    pool = SlotPool("test/slots", 2)
    a = pool.acquire()
    pool.acquire()
    pool.release(a)
    pool.acquire()
    assert reg.counter_value("pathway_serving_slot_acquires_total", {"pool": "test/slots"}) == 3
    assert reg.counter_value("pathway_serving_slot_refills_total", {"pool": "test/slots"}) == 1
    assert reg.counter_value("pathway_serving_joined_inflight_total", {"pool": "test/slots"}) == 2
    assert reg.gauge_value("pathway_serving_slots_active", {"pool": "test/slots"}) == 2

    import torch

    from pathway_tpu_torch import TorchLMChat
    from pathway_tpu_torch.models import lm_config

    chat = TorchLMChat(lm_config(vocab_size=256, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_len=64,
                                 dtype=torch.float32), max_new_tokens=4, device="cpu")
    chat._cb.submit("a prompt").result(timeout=60)
    chat._cb.drain()
    pool = {"pool": chat._cb.pool.name}
    assert reg.counter_value("pathway_serving_decode_steps_total", pool) == chat._cb.stats["decode_steps"] > 0

    rng = np.random.default_rng(0)
    index = IvfPqIndex(dimensions=8, device=False, background_retrain=False, name="gauged")
    for i in range(40):
        index.add(i, rng.normal(size=8))
    index.search(rng.normal(size=8), 3)
    assert reg.gauge_value("pathway_index_size_rows", {"index": "gauged"}) == 40
    assert reg.gauge_value("pathway_index_lists", {"index": "gauged"}) == 0

    plane = get_device_plane()
    prog = plane.program(plane.unique_name("metrics_probe"), lambda x: x)
    prog(np.zeros(3), bucket=(4,))
    page = metrics._render_metrics(None, 0.0)
    assert f'pathway_device_compiles{{bucket="(4,)",program="{prog.name}"}} 1' in page
    plane.drop_program(prog.name)
