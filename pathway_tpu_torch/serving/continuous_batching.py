"""Continuous batching for LLM decode: a slot scheduler over one
persistent KV cache.

Counterpart of ``pathway_tpu/serving/continuous_batching.py``.

**The slot contract.** Each row of the cache (a device-plane lease of the
family's ``init_kv_cache``) is a slot of a
:class:`~pathway_tpu_torch.engine.device_plane.SlotPool`. A request joins
at a step boundary: the family's ``prefill_into_slot`` writes its
left-padded prompt into its slot's row while the other rows stay
mid-generation. A decode step (``decode_step_slots``) advances every row
one token at the row's own position, and a row reads only its own keys,
from its first real position to its current one; a slot freed by a
longer request keeps that request's keys past the next prompt, and no
step reads them. So per request the tokens equal the wave-aligned path's
(``PATHWAY_CONTINUOUS_BATCH=0``), and over a mesh (``mesh_span``) the
single-device pool's. Decoding here is greedy; sampled generation keeps
the wave-aligned path.

**Counters.** ``stats`` is always on. The decode thread publishes each
step's and each prefill's counts and nanoseconds in one ``dict.update``,
so a copy of ``stats`` taken on another thread holds whole steps and
prefills, and in it each phase's launch and sync sum to its total
exactly. Where the family declares a ``SCAN_COUNTER`` (the Kimi Linear
family's ``kda_tokens``), ``stats`` counts the tokens its recurrent
layers scan, each prefill's prompt tokens and each step's rows, and with
the plane on ``pathway_lm_<counter>_total{pool, phase=prefill|decode}``.

**Phase graphs.** On the card and off the mesh, the phases the family
declares in ``GRAPH_PHASES`` (the GPT-2 family: the prefill and the
decode step) are replayed from CUDA graphs. A graph replays the
addresses it was captured on, so :class:`PhaseGraphs` keys its graphs by
the inputs' shapes (a prefill's width, a step's slot count) and the
cache's buffers: a decode thread that leases another cache captures
anew. ``stats`` counts ``prefill_replays``/``prefill_captures`` and
``step_replays``/``step_captures``.
"""

from __future__ import annotations

import functools
import itertools
import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable

import numpy as np
import torch

from pathway_tpu_torch.engine.device_plane import get_device_plane
from pathway_tpu_torch.internals import observability as _obs
from pathway_tpu_torch.internals import spans as _spans
from pathway_tpu_torch.models import family_of, transformer
from pathway_tpu_torch.parallel import spmd
from pathway_tpu_torch.parallel.mesh import P, Sharded, default_mesh
from pathway_tpu_torch.xpacks.llm.embedders import pad_left_rows

__all__ = ["ContinuousBatcher", "continuous_batching_on", "mesh_slots_on"]


def continuous_batching_on() -> bool:
    """PATHWAY_CONTINUOUS_BATCH=0 restores wave-aligned dispatch (default
    on)."""
    return os.environ.get("PATHWAY_CONTINUOUS_BATCH", "1") not in ("0", "false", "no")


def mesh_slots_on() -> bool:
    """PATHWAY_MESH_SLOTS=1 spans the slot pool over the device mesh
    (default off: single-device pools)."""
    return os.environ.get("PATHWAY_MESH_SLOTS", "0") == "1"


_REQUEST_IDS = itertools.count(1)


class _Request:
    __slots__ = (
        "row", "length", "future", "tokens", "token", "steps_done", "slot", "pad_len", "width",
        "id", "span", "submit_ns", "queued_ns", "first_ns",
    )

    def __init__(self, row: list, future: Future):
        self.id = next(_REQUEST_IDS)
        self.span = 0  # its cb.request span's id, with the plane on
        self.submit_ns = self.queued_ns = self.first_ns = 0  # span clock
        self.row = row  # token ids (already budget-truncated)
        self.length = len(row)
        self.future = future
        self.tokens: list[int] = []  # emitted output tokens
        self.token = 0  # the token the next decode step consumes
        self.steps_done = 0
        self.slot: int | None = None
        self.pad_len = 0  # left-pad of the prompt bucket
        self.width = 0  # physical prompt width (the seq bucket)


class PhaseGraphs:
    """One phase of a family's decode loop, replayed from one CUDA graph per
    shape of its inputs and cache buffer.

    `fn` is the phase in the form a graph can capture (the family's
    ``GRAPH_PHASES``): it reads nothing back and returns the phase's tokens
    on the device. A call takes the eager phase's arguments,
    ``(params, *args)``: the one dict among `args` is the cache, and every
    other is a tensor input (``prefill_into_slot``: ids, mask and a 0-d
    slot; ``decode_step_slots``: the [n_slots] tokens, positions and
    pads). It returns (tokens on the device, cache). The first call of a
    key runs the phase eagerly on a side stream, which warms it up and
    serves that call, then captures it over static buffers of the inputs;
    every later call copies its inputs into those buffers and replays the
    graph. A graph holds the addresses of the cache and the parameters it
    was captured on. The parameters are the batcher's own for its life;
    the cache is leased anew by each decode thread, so the key holds the
    cache's buffers: another buffer captures anew, and the graphs of the
    old one are dropped. One phase's graphs share one private memory pool,
    since its decode thread replays one graph at a time and reads its
    tokens before the next replay. ``last`` says how the latest call ran:
    ``"capture"`` or ``"replay"``.
    """

    def __init__(self, fn: Any):
        self._fn = fn  # (params, *args) -> tokens on the device
        self._graphs: dict[tuple, tuple] = {}  # key -> (graph, static inputs, tokens)
        self._pool: Any = None
        self.last: str | None = None

    def __call__(self, params: Any, *args: Any):
        cache = next(a for a in args if isinstance(a, dict))
        inputs = [a for a in args if a is not cache]
        key = (tuple(x.shape for x in inputs), tuple(t.data_ptr() for t in cache.values()))
        device = next(iter(cache.values())).device
        with torch.cuda.device(device):
            held = self._graphs.get(key)
            if held is None:
                self.last = "capture"
                return self._capture(key, params, args, device), cache
            graph, static, tokens = held
            for s, x in zip(static, inputs):
                if x.dim() == 0:  # the slot, a host tensor: a fill, not a copy
                    s.fill_(x)
                else:
                    s.copy_(x)
            graph.replay()
            self.last = "replay"
            return tokens, cache

    def _capture(self, key: tuple, params: Any, args: tuple, device: torch.device) -> torch.Tensor:
        # graphs over another cache buffer would write into a stale one;
        # a pool whose graphs are all gone takes no new capture, so a new
        # set of graphs starts a pool of its own
        self._graphs = {k: g for k, g in self._graphs.items() if k[1] == key[1]}
        if not self._graphs:
            self._pool = torch.cuda.graph_pool_handle()
        staged = [a if isinstance(a, dict) else a.to(device, copy=True) for a in args]
        here, side = torch.cuda.current_stream(), torch.cuda.Stream()
        side.wait_stream(here)
        with torch.cuda.stream(side):
            first = self._fn(params, *staged)
        here.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=side, capture_error_mode="thread_local"):
            tokens = self._fn(params, *staged)
        self._graphs[key] = (graph, [a for a in staged if not isinstance(a, dict)], tokens)
        return first


class _MeshSlots:
    """The rule of a mesh-spanning slot pool. The cache's slot axis is cut
    over the ``data`` axis of the mesh: slot i is row i % shard_slots of
    the block on shard i // shard_slots, and its prefill runs on that
    shard's device with that shard's parameters. A decode step is one
    ``spmd.shard_map`` call in which each shard advances its own rows."""

    def __init__(self, family: Any, cfg: Any, params: Any, mesh: Any, shard_slots: int):
        self.family, self.cfg, self.mesh, self.shard_slots = family, cfg, mesh, shard_slots
        # the parameters on every shard's device (shards of one device
        # share them), and each shard's own tree of them, built once
        self.params = transformer.tree_map(lambda t: Sharded.from_global(t, mesh, P(), copy=False), params)
        self.shard_params = [
            transformer.tree_map(lambda t, i=i: t.shards[i], self.params) for i in range(mesh.size)
        ]
        rows = P("data")
        self._mapped = spmd.shard_map(
            lambda *args: family.decode_step_slots(*args, cfg)[0],
            mesh, in_specs=(P(), P(None, "data"), rows, rows, rows), out_specs=rows,
        )

    def step(self, params: Any, cache: Any, tok, pos, pad):
        """The family's ``decode_step_slots`` over the mesh, with each
        shard's copy of the parameters in place of `params`: the next
        tokens as one [n_slots] tensor, and the cache."""
        return self._mapped(self.params, cache, tok, pos, pad), cache

    def init_cache(self) -> dict:
        """A block of `shard_slots` rows of the family's cache on each
        shard's device, as one Sharded a cache tensor."""
        mesh, cache = self.mesh, {}
        blocks = [self.family.init_kv_cache(self.cfg, self.shard_slots, dev) for dev in mesh.devices.flat]
        for name, t in blocks[0].items():
            shape = (len(t), t.shape[1] * mesh.size, *t.shape[2:])
            cache[name] = Sharded([b[name] for b in blocks], P(None, "data"), mesh, shape)
        return cache

    def locate(self, slot: int, cache: dict) -> tuple[Any, dict, Any, int]:
        """Where `slot`'s prefill runs: (its shard's parameters, its
        shard's cache block, that shard's device, its row in the block)."""
        shard, row = divmod(slot, self.shard_slots)
        block = {name: c.shards[shard] for name, c in cache.items()}
        return self.shard_params[shard], block, self.mesh.device(shard), row


class ContinuousBatcher:
    """Slot-based decode scheduler over one leased multi-row KV cache.

    ``submit(prompt)`` returns a :class:`concurrent.futures.Future` that
    resolves to the generated token string (``TorchLMChat``'s output
    format). A decode thread runs only while requests are in flight: it
    re-fills freed slots from the queue at every step boundary, advances
    all occupied slots one token per step, and exits (restoring the
    cache lease) when the pool drains. The cache lives on the device of
    ``params["tok_embed"]``.
    """

    def __init__(
        self,
        *,
        params: Any,
        cfg: Any,
        tokenizer: Any,
        n_steps: int,
        n_slots: int = 8,
        plane: Any = None,
        name: str | None = None,
        mesh_span: bool | None = None,
    ):
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.n_steps = n_steps
        family = self._family = family_of(cfg)
        # the counters a step reads back with its tokens, and the host's
        # count of tokens the family's recurrent layers scan
        self._counters = family.STEP_COUNTERS
        self._scan = family.SCAN_COUNTER
        self.mesh = self._shards = None
        if mesh_span if mesh_span is not None else mesh_slots_on():
            if family is not transformer:
                raise NotImplementedError(
                    f"the mesh-spanning slot pool serves the GPT-2-style family, not {type(cfg).__name__}"
                )
            mesh = default_mesh(("data",))
            if mesh.size > 1:  # one device keeps the single-device pool
                self.mesh = mesh
                self._shards = _MeshSlots(family, cfg, params, mesh, n_slots)
                n_slots *= mesh.size
        self.n_slots = n_slots
        # every write stays inside the cache: a prompt keeps its last
        # `budget` tokens, and its last decode write lands at
        # width + n_steps - 2 < max_len
        self.budget = cfg.max_len - n_steps
        self.device = params["tok_embed"].device
        self._plane = plane or get_device_plane()
        self.name = name or self._plane.unique_name("cb")
        self.pool = self._plane.slot_pool(f"{self.name}/slots", n_slots)
        # on the card and off the mesh, the phases the family declares
        # capturable are replayed from CUDA graphs
        graphed = family.GRAPH_PHASES if self.mesh is None and self.device.type == "cuda" else {}
        self._graphs = self._step_graphs = None
        prefill = functools.partial(family.prefill_into_slot, cfg=cfg)
        if "prefill" in graphed:
            prefill = self._graphs = PhaseGraphs(functools.partial(graphed["prefill"], cfg=cfg))
        self._prefill = self._plane.program(f"{self.name}/prefill", prefill)
        step = functools.partial(family.decode_step_slots, cfg=cfg)
        if self._shards is not None:
            step = self._shards.step
        elif "step" in graphed:
            step = self._step_graphs = PhaseGraphs(functools.partial(graphed["step"], cfg=cfg))
        self._step = self._plane.program(f"{self.name}/step", step)
        self._cache_key = ("cb_kv_cache", self.name, n_slots)
        self._lock = threading.Lock()
        self._queue: deque[_Request] = deque()
        self._active: dict[int, _Request] = {}  # slot -> request
        self._running = False
        self._thread: threading.Thread | None = None
        # the decode thread's timed keys and the callers' submit time, in
        # nanoseconds; `stats` shows them in seconds
        self._ns = dict.fromkeys((
            "step_seconds", "step_launch_seconds", "step_sync_seconds", "prefill_seconds",
            "prefill_launch_seconds", "prefill_sync_seconds", "loop_seconds", "queue_seconds",
        ), 0)
        self._submit_ns = 0
        # counts and host seconds; every value a number
        self.stats = {
            "submitted": 0, "completed": 0, "decode_steps": 0, "prefills": 0, "max_queue": 0,
            "prefill_tokens": 0, "prefill_positions": 0, "prefill_replays": 0,
            "prefill_captures": 0, "step_replays": 0, "step_captures": 0, "submit_seconds": 0.0,
            **dict.fromkeys(self._ns, 0.0),
        }
        if self._counters:
            self.stats.update(dict.fromkeys((*self._counters, "latent_positions"), 0))
        if self._scan:
            self.stats[self._scan] = 0
        self._labels = {"pool": self.pool.name}
        _obs.maybe_enable_from_env()  # the plane's switch holds outside pw.run too

    # ------------------------------------------------------------- surface

    def submit(self, prompt: str) -> Future:
        """Queue one prompt; the future resolves to the token string."""
        t0 = time.perf_counter_ns()
        row = list(self.tokenizer.tokenize(prompt))[-self.budget:]
        fut: Future = Future()
        req = _Request(row, fut)
        req.submit_ns = t0
        if _obs.PLANE is not None:
            req.span = _spans.new_span_id()
        with self._lock:
            req.queued_ns = time.perf_counter_ns()
            self._queue.append(req)
            self._submit_ns += req.queued_ns - t0
            st = self.stats
            st.update(
                submitted=st["submitted"] + 1, max_queue=max(st["max_queue"], len(self._queue)),
                submit_seconds=self._submit_ns / 1e9,
            )
            if not self._running:
                self._running = True
                # not a daemon: the thread ends when the pool drains, and
                # interpreter exit waits for that instead of freezing it
                # inside a torch call (which aborts the process)
                self._thread = threading.Thread(
                    target=self._loop, daemon=False, name=f"pw-cb-{self.name}"
                )
                self._thread.start()
        return fut

    def _count(self, mark: int, now: int, counts: dict, **ns: int) -> int:
        """Add `counts` and the nanoseconds `ns` to the decode thread's
        counters, with its loop's time from `mark` (its last count) to
        `now`, and publish them in ``stats`` in one ``dict.update``.
        Returns `now`, the next mark."""
        acc = self._ns
        acc["loop_seconds"] += now - mark
        for k, v in ns.items():
            acc[k] += v
        st = self.stats
        update = {k: st[k] + v for k, v in counts.items()}
        update.update((k, v / 1e9) for k, v in acc.items())
        st.update(update)
        return now

    def queue_depth(self) -> int:
        """Requests queued plus requests holding a slot."""
        with self._lock:
            return len(self._queue) + len(self._active)

    def drain(self, timeout: float | None = 30.0) -> None:
        """Block until the in-flight work finishes (tests, teardown)."""
        t = self._thread
        # a finalizer may run close() on the decode thread itself
        if t is not None and t is not threading.current_thread():
            t.join(timeout)

    def close(self) -> None:
        """Release the batcher's plane registrations (programs, slot pool,
        cache lease), after draining the in-flight work. The owner's
        finalizer calls it."""
        self.drain()
        self._plane.drop_namespace(self.name)

    # ---------------------------------------------------------- decode loop

    def _init_cache(self) -> Any:
        """A fresh multi-slot cache: the family's on the batcher's
        device, or over a mesh one block a shard."""
        if self._shards is not None:
            return self._shards.init_cache()
        return self._family.init_kv_cache(self.cfg, self.n_slots, self.device)

    def _loop(self) -> None:
        cache = self._plane.lease(self._cache_key, self._init_cache)
        try:
            with torch.no_grad():
                self._run(cache)
        except BaseException as e:  # every waiter hears of the failure
            with self._lock:
                self._running = False
                held = list(self._active)
                waiting = list(self._active.values()) + list(self._queue)
                self._active.clear()
                self._queue.clear()
            # slots go back to the pool: a leaked slot would shrink the
            # batch for good, and a later submit would wait on an
            # exhausted pool with nothing in flight
            for slot in held:
                self.pool.release(slot)
            for req in waiting:
                if not req.future.done():
                    req.future.set_exception(e)
            if not isinstance(e, Exception):
                raise
        finally:
            # restore the lease only while the namespace lives: a
            # finalizer may have dropped it mid-generation, and a restore
            # would then pin the cache in the process-wide plane with no
            # owner left
            with self._plane._lock:
                if self._plane._slot_pools.get(self.pool.name) is self.pool:
                    self._plane.restore(self._cache_key, cache)

    def _run(self, cache: Any) -> None:
        mark = time.perf_counter_ns()
        while True:
            # ---- step boundary: re-fill freed slots from the queue
            while True:
                with self._lock:
                    if not self._queue:
                        break
                    slot = self.pool.acquire()
                    if slot is None:
                        break  # batch full; the next boundary re-checks
                    req = self._queue.popleft()
                    self._active[slot] = req
                    req.slot = slot
                mark = self._admit(req, slot, cache, mark)
            with self._lock:
                if not self._active:
                    # exit under the lock: a submit racing this check
                    # either sees _running=True (and we loop again) or
                    # starts a fresh thread
                    if self._queue:
                        continue
                    self._count(mark, time.perf_counter_ns(), {})
                    self._running = False
                    return
                batch = dict(self._active)
            # ---- one decode step over every occupied slot; empty slots
            # decode token 0 at position 0 of their own row
            vec = np.zeros((3, self.n_slots), np.int64)
            for slot, req in batch.items():
                vec[:, slot] = (req.token, req.width + req.steps_done, req.pad_len)

            def launch(tok, pos, pad):
                nxt, _ = self._step(self.params, cache, tok, pos, pad, bucket=self.n_slots)
                # the step's counters ride with its tokens
                return torch.cat((nxt, cache["counts"])) if self._counters else nxt

            def tally(nxt: list, t0: int, sp: Any) -> tuple[dict, dict]:
                if sp.id:  # recording: the rows and their real keys before this step
                    sp.set(rows=len(batch), keys=sum(r.length + r.steps_done for r in batch.values()))
                counts = {"decode_steps": 1}
                if self._scan:
                    counts[self._scan] = len(batch)
                if self._counters:
                    counts.update(zip(self._counters, nxt[self.n_slots:]))
                    counts["latent_positions"] = sum(r.length + r.steps_done + 1 for r in batch.values())
                    sp.set(**counts)
                return counts, {}

            nxt, _, _, mark = self._timed(
                "step", mark, launch, tally, self._step_graphs,
                upload=lambda: torch.from_numpy(vec).to(self.device).unbind(0),
            )
            plane = _obs.PLANE
            if plane is not None:
                plane.metrics.counter(
                    "pathway_serving_decode_steps_total", self._labels,
                    help="continuous-batching decode steps dispatched",
                )
                self._count_scan(plane, "decode", len(batch))
            for slot, req in batch.items():
                req.steps_done += 1
                req.token = nxt[slot]
                req.tokens.append(req.token)
                if len(req.tokens) >= self.n_steps:
                    self._finish(slot, req)

    def _timed(
        self, phase: str, mark: int, launch: Callable[..., torch.Tensor], tally: Callable,
        graphs: PhaseGraphs | None, upload: Callable[[], tuple] | None = None, **span: Any,
    ) -> tuple[list, int, int, int]:
        """One timed phase of the decode thread, ``step`` or ``prefill``,
        in the span ``cb.<phase>``. Its launch is `upload` (in
        ``cb.<phase>.upload``) and ``launch(*uploaded)`` (in ``.launch``),
        up to the return of the phase's program; its sync reads the tensor
        `launch` returns back as a list (in ``.sync``), the phase's one
        wait for the device. ``tally(values, t0, span)`` gives the phase's
        counts and any further nanoseconds by key, which ``_count``
        publishes with the launch and sync split; with the plane on, the
        split is observed in ``pathway_serving_step_seconds``. Where the
        phase runs from `graphs`, its call counts as a ``<phase>_replays``
        or ``<phase>_captures``, the span's ``graphed`` says whether it
        replayed, and with the plane on a replay counts in
        ``pathway_serving_<phase>_graph_replays_total``. Returns (values,
        t0, t2 the end of the sync, the next mark)."""
        with _spans.span(f"cb.{phase}", leaf=False, **span) as sp:
            t0 = time.perf_counter_ns()
            uploaded = ()
            if upload is not None:
                with _spans.span(f"cb.{phase}.upload"):
                    uploaded = upload()
            with _spans.span(f"cb.{phase}.launch"):
                out = launch(*uploaded)
            t1 = time.perf_counter_ns()
            with _spans.span(f"cb.{phase}.sync"):
                out = out.tolist()
            t2 = time.perf_counter_ns()
            counts, ns = tally(out, t0, sp)
            how = graphs.last if graphs is not None else None
            counts[f"{phase}_replays"] = int(how == "replay")
            counts[f"{phase}_captures"] = int(how == "capture")
            if sp.id:
                sp.set(graphed=how == "replay")
        split = {"launch": t1 - t0, "sync": t2 - t1}
        ns.update({f"{phase}_seconds": t2 - t0, **{f"{phase}_{k}_seconds": v for k, v in split.items()}})
        mark = self._count(mark, t2, counts, **ns)
        plane = _obs.PLANE
        if plane is not None:
            for part, part_ns in split.items():
                plane.metrics.observe(
                    "pathway_serving_step_seconds", part_ns / 1e9,
                    {"pool": self.pool.name, "phase": f"{phase}_{part}"},
                    help="host seconds of a decode step or prefill, launch and token read-back apart",
                )
            if how == "replay":
                plane.metrics.counter(
                    f"pathway_serving_{phase}_graph_replays_total", self._labels,
                    help=f"{phase}s served by replaying a captured CUDA graph",
                )
        return out, t0, t2, mark

    def _admit(self, req: _Request, slot: int, cache: Any, mark: int) -> int:
        """Prefill one queued request into its freshly acquired slot (the
        join at a step boundary); returns the decode loop's next mark."""
        def launch():
            ids, mask = pad_left_rows([req.row], self.budget, n_rows=1)
            req.width = ids.shape[1]
            req.pad_len = req.width - req.length
            params, block, dev, row = self.params, cache, self.device, slot
            if self._shards is not None:
                params, block, dev, row = self._shards.locate(slot, cache)
            first, _ = self._prefill(
                params, torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev), block,
                torch.tensor(row), bucket=(1, req.width),
            )
            return first

        def tally(first: list, t0: int, sp: Any) -> tuple[dict, dict]:
            req.token = first[0]
            if sp.id:
                sp.set(slot=slot, tokens=req.length, positions=req.width)
            counts = {"prefills": 1, "prefill_tokens": req.length, "prefill_positions": req.width}
            if self._scan:
                counts[self._scan] = req.length
            return counts, {"queue_seconds": t0 - req.queued_ns}

        _, t0, req.first_ns, mark = self._timed(
            "prefill", mark, launch, tally, self._graphs, parent=req.span, request=req.id
        )
        plane = _obs.PLANE
        if plane is not None:
            m = plane.metrics
            m.observe(
                "pathway_serving_queue_wait_seconds", (t0 - req.queued_ns) / 1e9, self._labels,
                help="a request's wait from submit to the start of its prefill",
            )
            m.observe(
                "pathway_serving_first_token_seconds", (req.first_ns - req.submit_ns) / 1e9, self._labels,
                help="submit to a request's first token",
            )
            _spans.add_span("cb.queue", req.queued_ns, t0, parent=req.span, request=req.id)
            self._count_scan(plane, "prefill", req.length)
        req.tokens.append(req.token)
        if len(req.tokens) >= self.n_steps:  # n_steps == 1
            self._finish(slot, req)
        return mark

    def _count_scan(self, plane: Any, phase: str, tokens: int) -> None:
        """With the plane on, the tokens a phase's recurrent layers scanned
        (the family's ``SCAN_COUNTER``, if it declares one)."""
        if self._scan:
            plane.metrics.counter(
                f"pathway_lm_{self._scan}_total", {**self._labels, "phase": phase}, inc=tokens,
                help="tokens the model's recurrent layers scanned: prompt tokens and decode rows",
            )

    def _finish(self, slot: int, req: _Request) -> None:
        with self._lock:
            self._active.pop(slot, None)
            self.stats["completed"] += 1
        self.pool.release(slot)
        if _obs.PLANE is not None:
            _spans.add_span(
                "cb.request", req.submit_ns, time.perf_counter_ns(), span_id=req.span or None,
                request=req.id, attrs={
                    "slot": slot, "steps": req.steps_done,
                    "first_token_ms": (req.first_ns - req.submit_ns) / 1e6,
                },
            )
        if not req.future.done():
            req.future.set_result(" ".join(f"<{int(t)}>" for t in req.tokens))
