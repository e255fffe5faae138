"""Continuous batching for LLM decode: slot-based scheduling over one
persistent KV cache.

Counterpart of ``pathway_tpu/serving/continuous_batching.py``. The
wave-aligned serving path (``TorchLMChat._generate_batch``) runs a whole
generation per wave: a request that arrives just after the dispatch
waits for the entire wave to drain. Continuous batching replaces that
with a slot scheduler:

* the cache is one persistent multi-row tensor (a device-plane lease,
  ``init_kv_cache(cfg, n_slots)``); each row is a slot of a
  :class:`~pathway_tpu_torch.engine.device_plane.SlotPool`;
* a new request is admitted at the next step boundary: a b=1 prefill
  (``prefill_into_slot``) writes its prompt's cache rows into a free cache
  row while the neighbours stay mid-generation;
* every decode step advances all occupied slots by one token in one call
  with per-row positions (``decode_step_slots``);
* a request that finishes releases its slot at the step boundary, and
  the same boundary re-fills the row from the admission queue.

The three functions are those of the config's model family
(``models.family_of``), chosen once at construction: the GPT-2-style
``models/transformer.py`` with its head-major KV cache, or the DeepSeek-V3
``models/deepseek.py`` with its latent cache (whose family leaves the
mesh-spanning pool out).

Both calls go through the device plane's programs, whose shape ledger
shows that a request joining mid-generation adds no new shape: the step
is one shape, prefill one shape per prompt bucket.

``PATHWAY_CONTINUOUS_BATCH=0`` makes ``TorchLMChat`` use the wave-aligned
path; per request the two give the same tokens, because
``decode_step_slots`` is ``decode_step`` with the shared position made a
per-row vector.

**Mesh-spanning slot pools** (``mesh_span=True``, or
``PATHWAY_MESH_SLOTS=1`` when it is None): the KV cache's slot axis is
sharded over the ``data`` axis of ``parallel.mesh.default_mesh()`` (every
CUDA device, or the shards ``PATHWAY_MESH_DEVICES`` names) and the pool
grows to ``n_slots`` per shard. One scheduler drives every shard's
slots: a prefill runs on the device of its slot's shard, and a decode
step is one ``spmd.shard_map`` call in which each shard advances its own
rows. Rows never read each other's slots, so per-request tokens equal
the single-device pool's. A default mesh of one device keeps the
single-device pool, as the JAX package does on one device; a mesh that
cannot be built raises.

Decoding here is greedy (argmax); sampled generation keeps the
wave-aligned path.

**Prefill graphs.** A prefill of the GPT-2-style family is some 35 small
kernels a layer, whose launches from Python take far longer than the card
takes to run them. Where the cache is on a CUDA device, the pool is not
mesh-spanning and the family provides a capturable slot prefill
(``transformer.prefill_slot``), the prefill program is a
:class:`PrefillGraphs`: one CUDA graph captured on the first prefill of
each prompt width (the power-of-two buckets of ``pad_left_rows``) and
replayed for every later one, into any slot. The DeepSeek family, whose
prefill computes each prompt's real tokens at a width of its own, the
mesh-spanning pool and every CPU run keep the eager prefill.

**Counters** (``stats``, always on: a few clock reads a step, a prefill
and a request). A step's host time splits at the return of the step
program into ``step_launch_seconds`` (upload and launches) and
``step_sync_seconds`` (the token read-back: the host waits while the
device finishes), and a prefill's likewise; each pair sums to
``step_seconds`` or ``prefill_seconds`` exactly in nanoseconds, and the
decode thread publishes a step's or a prefill's counters in one
``dict.update``, so a copy of ``stats`` taken on another thread holds
whole ones. ``loop_seconds`` is the decode thread's time in its loop,
``queue_seconds`` each request's wait from ``submit`` to its prefill,
``submit_seconds`` the callers' time in ``submit``. ``prefill_replays``
counts the prefills served by replaying a captured graph and
``prefill_captures`` the captures (each also served its own request);
both stay 0 on the eager prefill. A family that counts
its experts (``STEP_COUNTERS`` of ``models/deepseek.py``) adds, summed
over decode steps, ``moe_assignments`` (token-expert choices),
``moe_experts_hit`` (layer-expert pairs with a token) and ``moe_max_load``
(the busiest expert's tokens, summed over layers), which come back with
the step's tokens in the same copy, and ``latent_positions`` (the real
positions the steps' rows read, counted on the host). With the
observability plane on, the batcher also records spans (``cb.request``
with ``cb.queue``; ``cb.prefill``; ``cb.step`` with ``.upload``,
``.launch``, ``.sync``; ``internals/spans.py``) and the histograms
``pathway_serving_queue_wait_seconds``,
``pathway_serving_first_token_seconds`` and
``pathway_serving_step_seconds{phase}`` for operators, and counts
``pathway_serving_prefill_graph_replays_total``; a ``cb.prefill`` span's
``graphed`` attribute says whether a replayed graph served it.
"""

from __future__ import annotations

import functools
import itertools
import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any

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


class PrefillGraphs:
    """A family's capturable slot prefill (``transformer.prefill_slot``),
    replayed from one CUDA graph per prompt width and cache buffer.

    Called as ``prefill_into_slot`` is, ``(params, ids, mask, cache, slot)``
    with `slot` a host integer or 0-d CPU tensor, it returns (first token
    [1] on the device, cache). The first call of a width runs the prefill
    eagerly on a side stream, which warms it up and serves that request,
    then captures it over static buffers of ids, mask and slot; every
    later call copies its inputs into those buffers and replays the graph.
    A graph holds the addresses of the cache and the parameters it was
    captured on. The parameters are the batcher's own for its life; the
    cache is leased anew by each decode thread, so the key holds the
    cache's buffers: another buffer captures anew, and the graphs of the
    old one are dropped. The
    batcher's graphs share one private memory pool, since its decode thread
    runs one prefill at a time, and its first token is read before the next
    replay. ``last`` says how the latest call ran: ``"capture"`` or
    ``"replay"``.
    """

    def __init__(self, fn: Any):
        self._fn = fn  # (params, ids, mask, cache, slot tensor) -> first token [1]
        self._graphs: dict[tuple, tuple] = {}  # key -> (graph, ids, mask, slot, token)
        self._pool: Any = None
        self.last: str | None = None

    def __call__(self, params: Any, ids: torch.Tensor, mask: torch.Tensor, cache: Any, slot: Any):
        key = (ids.shape[1], *(t.data_ptr() for t in cache.values()))
        with torch.cuda.device(ids.device):
            held = self._graphs.get(key)
            if held is None:
                self.last = "capture"
                return self._capture(key, params, ids, mask, cache, int(slot)), cache
            graph, s_ids, s_mask, s_slot, token = held
            s_ids.copy_(ids)
            s_mask.copy_(mask)
            s_slot.fill_(int(slot))
            graph.replay()
            self.last = "replay"
            return token, cache

    def _capture(self, key: tuple, params: Any, ids, mask, cache: Any, slot: int) -> torch.Tensor:
        # graphs over another cache buffer would write into a stale one;
        # a pool whose graphs are all gone takes no new capture, so a new
        # set of graphs starts a pool of its own
        self._graphs = {k: g for k, g in self._graphs.items() if k[1:] == key[1:]}
        if not self._graphs:
            self._pool = torch.cuda.graph_pool_handle()
        s_ids, s_mask = ids.clone(), mask.clone()
        s_slot = torch.full((), slot, dtype=torch.int64, device=ids.device)
        here, side = torch.cuda.current_stream(), torch.cuda.Stream()
        side.wait_stream(here)
        with torch.cuda.stream(side):
            first = self._fn(params, s_ids, s_mask, cache, s_slot)
        here.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=side, capture_error_mode="thread_local"):
            token = self._fn(params, s_ids, s_mask, cache, s_slot)
        self._graphs[key] = (graph, s_ids, s_mask, s_slot, token)
        return first


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
        # the expert counters a step reads back with its tokens
        self._counters = getattr(family, "STEP_COUNTERS", ())
        # mesh-spanning pool: n_slots per shard (module docstring)
        self.mesh = None
        if mesh_span if mesh_span is not None else mesh_slots_on():
            if family is not transformer:
                raise NotImplementedError(
                    f"the mesh-spanning slot pool serves the GPT-2-style family, not {type(cfg).__name__}"
                )
            mesh = default_mesh(("data",))
            if mesh.size > 1:
                self.mesh = mesh
                self.shard_slots = n_slots
                n_slots = n_slots * mesh.size
                # the parameters on every shard's device (shards of one
                # device share them)
                self._mesh_params = transformer.tree_map(
                    lambda t: Sharded.from_global(t, mesh, P(), copy=False), params
                )
        self.n_slots = n_slots
        # every write stays inside the cache: a prompt keeps its last
        # `budget` tokens, and its last decode write lands at
        # width + n_steps - 2 < max_len
        self.budget = cfg.max_len - n_steps
        self.device = params["tok_embed"].device
        self._plane = plane or get_device_plane()
        self.name = name or self._plane.unique_name("cb")
        self.pool = self._plane.slot_pool(f"{self.name}/slots", n_slots)
        prefill = functools.partial(family.prefill_into_slot, cfg=cfg)
        # a family with a capturable slot prefill, on the card and off the
        # mesh, replays it from CUDA graphs (module docstring)
        capturable = getattr(family, "prefill_slot", None)
        self._graphs = None
        if capturable is not None and self.mesh is None and self.device.type == "cuda":
            prefill = self._graphs = PrefillGraphs(functools.partial(capturable, cfg=cfg))
        self._prefill = self._plane.program(f"{self.name}/prefill", prefill)
        step = functools.partial(family.decode_step_slots, cfg=cfg)
        if self.mesh is not None:
            step = self._mesh_step_fn(step)
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
        # counts and host seconds (module docstring); every value a number
        self.stats = {
            "submitted": 0, "completed": 0, "decode_steps": 0, "prefills": 0, "max_queue": 0,
            "prefill_tokens": 0, "prefill_positions": 0, "prefill_replays": 0,
            "prefill_captures": 0, "submit_seconds": 0.0,
            **dict.fromkeys(self._ns, 0.0),
        }
        if self._counters:
            self.stats.update(dict.fromkeys((*self._counters, "latent_positions"), 0))
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

    def _mesh_step_fn(self, step):
        """The decode step over the mesh: each shard advances its own
        cache rows with its rows of the step vectors; the next tokens
        come back as one [n_slots] tensor."""
        rows = P("data")
        mapped = spmd.shard_map(
            lambda params, cache, tok, pos, pad: step(params, cache, tok, pos, pad)[0],
            self.mesh, in_specs=(P(), P(None, "data"), rows, rows, rows), out_specs=rows,
        )

        def run(params, cache, tok, pos, pad):
            return mapped(self._mesh_params, cache, tok, pos, pad), cache

        return run

    def _init_cache(self) -> Any:
        """A fresh multi-slot cache: one tensor on the batcher's device,
        or with a mesh one block of `shard_slots` rows on each shard's
        device (a dict of Sharded)."""
        if self.mesh is None:
            return self._family.init_kv_cache(self.cfg, self.n_slots, self.device)
        shards = [transformer.init_kv_cache(self.cfg, self.shard_slots, self.mesh.device(i))
                  for i in range(self.mesh.size)]
        full = (self.cfg.n_layers, self.n_slots, self.cfg.n_heads, self.cfg.max_len, self.cfg.head_dim)
        return {
            name: Sharded([c[name] for c in shards], P(None, "data"), self.mesh, full)
            for name in ("k", "v")
        }

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
            with _spans.span("cb.step", leaf=False) as sp:
                if sp.id:  # recording: the rows and their real keys before this step
                    sp.set(rows=len(batch), keys=sum(r.length + r.steps_done for r in batch.values()))
                t0 = time.perf_counter_ns()
                with _spans.span("cb.step.upload"):
                    tok, pos, pad = torch.from_numpy(vec).to(self.device).unbind(0)
                with _spans.span("cb.step.launch"):
                    nxt, _ = self._step(self.params, cache, tok, pos, pad, bucket=self.n_slots)
                    if self._counters:  # the step's counters ride with its tokens
                        nxt = torch.cat((nxt, cache["counts"]))
                t1 = time.perf_counter_ns()
                with _spans.span("cb.step.sync"):
                    nxt = nxt.tolist()  # the step's one wait for the device
                t2 = time.perf_counter_ns()
                counts = {"decode_steps": 1}
                if self._counters:
                    counts.update(zip(self._counters, nxt[self.n_slots:]))
                    counts["latent_positions"] = sum(r.length + r.steps_done + 1 for r in batch.values())
                    if sp.id:
                        sp.set(**counts)
            mark = self._count(
                mark, t2, counts,
                step_seconds=t2 - t0, step_launch_seconds=t1 - t0, step_sync_seconds=t2 - t1,
            )
            plane = _obs.PLANE
            if plane is not None:
                m = plane.metrics
                m.counter(
                    "pathway_serving_decode_steps_total", self._labels,
                    help="continuous-batching decode steps dispatched",
                )
                self._observe_phases(m, "step", t1 - t0, t2 - t1)
            for slot, req in batch.items():
                req.steps_done += 1
                req.token = nxt[slot]
                req.tokens.append(req.token)
                if len(req.tokens) >= self.n_steps:
                    self._finish(slot, req)

    def _observe_phases(self, m: Any, what: str, launch_ns: int, sync_ns: int) -> None:
        for phase, ns in (("launch", launch_ns), ("sync", sync_ns)):
            m.observe(
                "pathway_serving_step_seconds", ns / 1e9,
                {"pool": self.pool.name, "phase": f"{what}_{phase}"},
                help="host seconds of a decode step or prefill, launch and token read-back apart",
            )

    def _admit(self, req: _Request, slot: int, cache: Any, mark: int) -> int:
        """Prefill one queued request into its freshly acquired slot (the
        join at a step boundary); returns the decode loop's next mark."""
        with _spans.span("cb.prefill", parent=req.span, request=req.id, leaf=False) as sp:
            t0 = time.perf_counter_ns()
            with _spans.span("cb.prefill.launch"):
                ids, mask = pad_left_rows([req.row], self.budget, n_rows=1)
                req.width = ids.shape[1]
                req.pad_len = req.width - req.length
                params, dev, row = self.params, self.device, slot
                if self.mesh is not None:
                    # the prefill runs on the device of the slot's shard, into
                    # that shard's block of the cache
                    shard, row = divmod(slot, self.shard_slots)
                    dev = self.mesh.device(shard)
                    params = transformer.tree_map(lambda t: t.shards[shard], self._mesh_params)
                    cache = {name: c.shards[shard] for name, c in cache.items()}
                first, _ = self._prefill(
                    params, torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev), cache,
                    torch.tensor(row), bucket=(1, req.width),
                )
            t1 = time.perf_counter_ns()
            with _spans.span("cb.prefill.sync"):
                req.token = int(first[0])
            t2 = req.first_ns = time.perf_counter_ns()
            how = self._graphs.last if self._graphs is not None else None
            if sp.id:
                sp.set(slot=slot, tokens=req.length, positions=req.width, graphed=how == "replay")
        mark = self._count(
            mark, t2,
            {
                "prefills": 1, "prefill_tokens": req.length, "prefill_positions": req.width,
                "prefill_replays": int(how == "replay"), "prefill_captures": int(how == "capture"),
            },
            prefill_seconds=t2 - t0, prefill_launch_seconds=t1 - t0, prefill_sync_seconds=t2 - t1,
            queue_seconds=t0 - req.queued_ns,
        )
        plane = _obs.PLANE
        if plane is not None:
            m = plane.metrics
            m.observe(
                "pathway_serving_queue_wait_seconds", (t0 - req.queued_ns) / 1e9, self._labels,
                help="a request's wait from submit to the start of its prefill",
            )
            m.observe(
                "pathway_serving_first_token_seconds", (t2 - req.submit_ns) / 1e9, self._labels,
                help="submit to a request's first token",
            )
            self._observe_phases(m, "prefill", t1 - t0, t2 - t1)
            if how == "replay":
                m.counter(
                    "pathway_serving_prefill_graph_replays_total", self._labels,
                    help="prefills served by replaying a captured CUDA graph",
                )
            _spans.add_span("cb.queue", req.queued_ns, t0, parent=req.span, request=req.id)
        req.tokens.append(req.token)
        if len(req.tokens) >= self.n_steps:  # n_steps == 1
            self._finish(slot, req)
        return mark

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
