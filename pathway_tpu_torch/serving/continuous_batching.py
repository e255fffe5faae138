"""Continuous batching for LLM decode: slot-based scheduling over one
persistent KV cache.

Counterpart of ``pathway_tpu/serving/continuous_batching.py``. The
wave-aligned serving path (``TorchLMChat._generate_batch``) runs a whole
generation per wave: a request that arrives just after the dispatch
waits for the entire wave to drain. Continuous batching replaces that
with a slot scheduler:

* the KV cache is one persistent multi-row tensor (a device-plane lease,
  ``init_kv_cache(cfg, n_slots)``); each row is a slot of a
  :class:`~pathway_tpu_torch.engine.device_plane.SlotPool`;
* a new request is admitted at the next step boundary: a b=1 prefill
  (``models/transformer.prefill_into_slot``) writes its prompt K/V into a
  free cache row while the neighbours stay mid-generation;
* every decode step advances all occupied slots by one token in one call
  with per-row positions (``models/transformer.decode_step_slots``);
* a request that finishes releases its slot at the step boundary, and
  the same boundary re-fills the row from the admission queue.

Both calls go through the device plane's programs, whose shape ledger
shows that a request joining mid-generation adds no new shape: the step
is one shape, prefill one shape per prompt bucket.

``PATHWAY_CONTINUOUS_BATCH=0`` makes ``TorchLMChat`` use the wave-aligned
path; per request the two give the same tokens, because
``decode_step_slots`` is ``decode_step`` with the shared position made a
per-row vector.

Decoding here is greedy (argmax); sampled generation keeps the
wave-aligned path. The mesh-spanning pool of the JAX package waits for
the multi-device port: asking for it raises.
"""

from __future__ import annotations

import functools
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
from pathway_tpu_torch.models import transformer
from pathway_tpu_torch.xpacks.llm.embedders import pad_left_rows

__all__ = ["ContinuousBatcher", "continuous_batching_on"]


def continuous_batching_on() -> bool:
    """PATHWAY_CONTINUOUS_BATCH=0 restores wave-aligned dispatch (default
    on)."""
    return os.environ.get("PATHWAY_CONTINUOUS_BATCH", "1") not in ("0", "false", "no")


class _Request:
    __slots__ = ("row", "length", "future", "tokens", "token", "steps_done", "slot", "pad_len", "width")

    def __init__(self, row: list, future: Future):
        self.row = row  # token ids (already budget-truncated)
        self.length = len(row)
        self.future = future
        self.tokens: list[int] = []  # emitted output tokens
        self.token = 0  # the token the next decode step consumes
        self.steps_done = 0
        self.slot: int | None = None
        self.pad_len = 0  # left-pad of the prompt bucket
        self.width = 0  # physical prompt width (the seq bucket)


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
        cfg: transformer.TransformerConfig,
        tokenizer: Any,
        n_steps: int,
        n_slots: int = 8,
        plane: Any = None,
        name: str | None = None,
        mesh_span: bool = False,
    ):
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if mesh_span:
            raise NotImplementedError("the mesh-spanning slot pool waits for the multi-device port")
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.n_steps = n_steps
        self.n_slots = n_slots
        # every write stays inside the cache: a prompt keeps its last
        # `budget` tokens, and its last decode write lands at
        # width + n_steps - 2 < max_len
        self.budget = cfg.max_len - n_steps
        self.device = params["tok_embed"].device
        self._plane = plane or get_device_plane()
        self.name = name or self._plane.unique_name("cb")
        self.pool = self._plane.slot_pool(f"{self.name}/slots", n_slots)
        self._prefill = self._plane.program(
            f"{self.name}/prefill", functools.partial(transformer.prefill_into_slot, cfg=cfg)
        )
        self._step = self._plane.program(
            f"{self.name}/step", functools.partial(transformer.decode_step_slots, cfg=cfg)
        )
        self._cache_key = ("cb_kv_cache", self.name, n_slots)
        self._lock = threading.Lock()
        self._queue: deque[_Request] = deque()
        self._active: dict[int, _Request] = {}  # slot -> request
        self._running = False
        self._thread: threading.Thread | None = None
        # counts, and the host seconds spent in prefills and steps (each
        # with its read-back of the tokens)
        self.stats = {
            "submitted": 0, "completed": 0, "decode_steps": 0, "prefills": 0, "max_queue": 0,
            "prefill_seconds": 0.0, "step_seconds": 0.0,
        }

    # ------------------------------------------------------------- surface

    def submit(self, prompt: str) -> Future:
        """Queue one prompt; the future resolves to the token string."""
        row = list(self.tokenizer.tokenize(prompt))[-self.budget:]
        fut: Future = Future()
        req = _Request(row, fut)
        with self._lock:
            self._queue.append(req)
            self.stats["submitted"] += 1
            self.stats["max_queue"] = max(self.stats["max_queue"], len(self._queue))
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

    def drain(self, timeout: float | None = 30.0) -> None:
        """Block until the in-flight work finishes (tests, teardown)."""
        t = self._thread
        if t is not None:
            t.join(timeout)

    # ---------------------------------------------------------- decode loop

    def _loop(self) -> None:
        cache = self._plane.lease(
            self._cache_key,
            lambda: transformer.init_kv_cache(self.cfg, self.n_slots, self.device),
        )
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
                self._admit(req, slot, cache)
            with self._lock:
                if not self._active:
                    # exit under the lock: a submit racing this check
                    # either sees _running=True (and we loop again) or
                    # starts a fresh thread
                    if self._queue:
                        continue
                    self._running = False
                    return
                batch = dict(self._active)
            # ---- one decode step over every occupied slot; empty slots
            # decode token 0 at position 0 of their own row
            vec = np.zeros((3, self.n_slots), np.int64)
            for slot, req in batch.items():
                vec[:, slot] = (req.token, req.width + req.steps_done, req.pad_len)
            t0 = time.perf_counter()
            tok, pos, pad = torch.from_numpy(vec).to(self.device).unbind(0)
            nxt, _ = self._step(self.params, cache, tok, pos, pad, bucket=self.n_slots)
            nxt = nxt.tolist()  # the step's one wait for the device
            self.stats["step_seconds"] += time.perf_counter() - t0
            self.stats["decode_steps"] += 1
            if _obs.PLANE is not None:
                _obs.PLANE.metrics.counter(
                    "pathway_serving_decode_steps_total", {"pool": self.pool.name},
                    help="continuous-batching decode steps dispatched",
                )
            for slot, req in batch.items():
                req.steps_done += 1
                req.token = nxt[slot]
                req.tokens.append(req.token)
                if len(req.tokens) >= self.n_steps:
                    self._finish(slot, req)

    def _admit(self, req: _Request, slot: int, cache: Any) -> None:
        """Prefill one queued request into its freshly acquired slot (the
        join at a step boundary)."""
        t0 = time.perf_counter()
        ids, mask = pad_left_rows([req.row], self.budget, n_rows=1)
        req.width = ids.shape[1]
        req.pad_len = req.width - req.length
        first, _ = self._prefill(
            self.params, torch.from_numpy(ids).to(self.device),
            torch.from_numpy(mask).to(self.device), cache, torch.tensor(slot),
            bucket=(1, req.width),
        )
        req.token = int(first[0])
        self.stats["prefill_seconds"] += time.perf_counter() - t0
        req.tokens.append(req.token)
        self.stats["prefills"] += 1
        if len(req.tokens) >= self.n_steps:  # n_steps == 1
            self._finish(slot, req)

    def _finish(self, slot: int, req: _Request) -> None:
        with self._lock:
            self._active.pop(slot, None)
            self.stats["completed"] += 1
        self.pool.release(slot)
        if not req.future.done():
            req.future.set_result(" ".join(f"<{int(t)}>" for t in req.tokens))
