"""Device-dispatch plane: bucketed batch coalescing and staging for the
serving path.

Counterpart of ``pathway_tpu/engine/device_plane.py``. Every serving
operator of the port (the embedder's encoder, the KNN slab search)
dispatches through one process-wide :class:`DevicePlane`:

* **Shape buckets** — live waves are ragged; :class:`BucketPolicy`
  rounds rows and sequence lengths up to powers of two, so a program
  sees a bounded set of shapes however the stream arrives.
  :class:`DeviceProgram` keeps a per-bucket ledger of the distinct
  shapes it dispatched. PyTorch runs eagerly, so the ledger counts
  shapes, not compilations; it is the seam where a later CUDA graph
  per bucket plugs in.
* **Staging** — ``stage()`` runs host-side prep (tokenize, pad, copy to
  the card) on a staging thread while the caller's current dispatch
  computes.
* **Coalescing** — :class:`WaveCoalescer` gathers concurrently
  in-flight requests and flushes them as one padded dispatch, off the
  event loop.
* **Persistent buffers** — ``lease``/``restore`` keep a pool of device
  buffers per key (a KV cache per batch bucket) across dispatches; the
  port writes them in place where the JAX package donates them.
* **Decode slots** — :class:`SlotPool` is the bookkeeping of continuous
  batching: one row of a leased multi-row KV cache per request.

A failed dispatch raises to its caller: the port has no host path to
degrade to. The slot counters export to the metrics registry as
``pathway_serving_slot_*`` when the observability plane is armed, as in
the JAX package.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from pathway_tpu_torch.internals import observability as _obs

__all__ = [
    "BucketPolicy",
    "DeviceProgram",
    "DevicePlane",
    "SlotPool",
    "WaveCoalescer",
    "get_device_plane",
    "resolve_device",
]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. Raises when CUDA is asked for and there is none —
    the port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


class BucketPolicy:
    """The single shape-rounding rule of the serving path.

    Rows round up to a power of two between ``min_rows`` and
    ``max_rows``; sequence lengths round up to a power of two between
    ``min_seq`` and the caller's cap (the model context).
    """

    def __init__(self, min_rows: int = 8, max_rows: int = 4096, min_seq: int = 16):
        if min_rows < 1 or max_rows < min_rows:
            raise ValueError(f"bad row bucket range [{min_rows}, {max_rows}]")
        self.min_rows = min_rows
        self.max_rows = max_rows
        self.min_seq = min_seq

    @staticmethod
    def _round_up(n: int, lo: int, hi: int) -> int:
        b = lo
        while b < n:
            b *= 2
        return min(b, hi)

    def rows_bucket(self, n: int) -> int:
        """Padded row count for a batch of n rows (n may not exceed
        max_rows; the caller splits such batches before padding)."""
        if n > self.max_rows:
            raise ValueError(
                f"batch of {n} rows exceeds the {self.max_rows}-row bucket "
                "cap; split before padding"
            )
        return self._round_up(max(n, 1), self.min_rows, self.max_rows)

    def cap_bucket(self, n: int, lo: int = 8) -> int:
        """Padded capacity for a resident slab dimension: power-of-two
        round-up with no upper clamp."""
        b = max(1, lo)
        while b < n:
            b *= 2
        return b

    def seq_bucket(self, longest: int, cap: int) -> int:
        """Padded sequence length for rows whose longest is `longest`,
        bounded by the model cap."""
        return self._round_up(max(longest, 1), self.min_seq, cap)


def _signature(x: Any) -> Any:
    """Hashable shape signature of a call's arguments: tensors and
    arrays by (shape, dtype, device), containers element-wise, other
    values as they are."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, np.ndarray):
        return ("A", x.shape, str(x.dtype))
    if isinstance(x, dict):
        return ("D", tuple((k, _signature(v)) for k, v in sorted(x.items())))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_signature(v) for v in x))
    return x


class DeviceProgram:
    """One eager dispatch function plus its per-bucket ledger.

    Each call passes the bucket key it padded to; ``shape_counts[bucket]``
    counts the distinct argument shapes dispatched under that key (the
    JAX package's compile ledger: streaming ragged batches inside one
    bucket keep it at 1), and ``dispatches`` counts every call.
    """

    def __init__(self, name: str, fn: Callable):
        self.name = name
        self._fn = fn
        self._lock = threading.Lock()
        self.shape_counts: dict[Any, int] = {}
        self._seen: set[Any] = set()
        self.dispatches = 0

    def __call__(self, *args: Any, bucket: Any = None, **kwargs: Any) -> Any:
        sig = (_signature(args), _signature(kwargs))
        with self._lock:
            if sig not in self._seen:
                self._seen.add(sig)
                self.shape_counts[bucket] = self.shape_counts.get(bucket, 0) + 1
            self.dispatches += 1
        return self._fn(*args, **kwargs)

    @property
    def total_shapes(self) -> int:
        return sum(self.shape_counts.values())


class WaveCoalescer:
    """Coalesces concurrently in-flight requests into one padded dispatch.

    Every ``submit`` of a wave lands in ``pending`` before the flush
    scheduled behind them runs, so the flush sees the whole wave. The
    flush runs on the plane's dispatch pool, never on the event loop.
    ``flush_fn(items) -> list[results]`` must return exactly
    ``len(items)`` results in order.
    """

    def __init__(
        self,
        flush_fn: Callable[[list], list],
        max_batch: int = 4096,
        pool: ThreadPoolExecutor | None = None,
    ):
        self.flush_fn = flush_fn
        self.max_batch = max_batch
        self._pool = pool
        self.pending: list[tuple[Any, Any]] = []  # (item, asyncio.Future)
        self._scheduled = False
        self.flushes = 0  # dispatch count (tests: coalescing actually happened)

    async def submit(self, item: Any) -> Any:
        import asyncio

        loop = asyncio.get_running_loop()
        fut: Any = loop.create_future()
        self.pending.append((item, fut))
        if not self._scheduled:
            self._scheduled = True
            loop.call_soon(self._flush_cb, loop)
        return await fut

    # Called on the event loop. Splits pending into max_batch chunks and
    # hands each to the dispatch pool; results resolve the row futures
    # back on the loop. Without a pool the flush runs inline.
    def _flush_cb(self, loop: Any) -> None:
        self._scheduled = False
        while self.pending:
            batch, self.pending = (
                self.pending[: self.max_batch],
                self.pending[self.max_batch:],
            )
            items = [it for it, _f in batch]
            futs = [f for _it, f in batch]
            self.flushes += 1
            if self._pool is None:
                self._resolve(futs, *self._run(items))
            else:
                task = self._pool.submit(self._run, items)
                task.add_done_callback(
                    lambda t, futs=futs: loop.call_soon_threadsafe(
                        self._resolve, futs, *t.result()
                    )
                )

    def _run(self, items: list) -> tuple[list | None, Exception | None]:
        try:
            return self.flush_fn(items), None
        except Exception as e:  # noqa: BLE001 — delivered to every row's future
            return None, e

    @staticmethod
    def _resolve(futs: list, values: list | None, err: Exception | None) -> None:
        if err is None and (values is None or len(values) != len(futs)):
            err = RuntimeError(
                f"coalesced flush returned {0 if values is None else len(values)}"
                f" results for {len(futs)} items"
            )
        for i, f in enumerate(futs):
            if f.done():
                continue
            if err is not None:
                f.set_exception(err)
            else:
                f.set_result(values[i])


class SlotPool:
    """Fixed pool of decode slots over one persistent multi-row buffer —
    the bookkeeping half of continuous batching (serving/
    continuous_batching.py). Each slot is one row of a leased KV cache; a
    request acquires a slot at admission, holds it across its whole
    generation, and releases it at the step boundary where it finishes —
    at which point the same decode batch re-fills the row with the next
    queued request instead of waiting for the wave to drain.

    Counters: ``refills`` (acquisitions of a row that served an earlier
    request), ``joined_inflight`` (acquisitions while at least one other
    slot was mid-generation), ``high_water`` (the most slots active at
    once) and ``acquired_total``; ``snapshot()`` reads them together.
    """

    def __init__(self, name: str, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"slot pool needs >= 1 slot, got {n_slots}")
        self.name = name
        self.n_slots = n_slots
        self._lock = threading.Lock()
        # LIFO keeps hot cache rows hot; slot 0 first for determinism
        self._free = list(range(n_slots))[::-1]
        self.acquired_total = 0
        self.refills = 0
        self.joined_inflight = 0
        self.high_water = 0
        self._ever_used: set[int] = set()

    def acquire(self) -> int | None:
        """Take a free slot (None when the pool is exhausted — the caller
        leaves the request queued for the next step boundary)."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self.acquired_total += 1
            active = self.n_slots - len(self._free)
            joined = active > 1
            if joined:
                self.joined_inflight += 1
            refill = slot in self._ever_used
            if refill:
                self.refills += 1
            self._ever_used.add(slot)
            self.high_water = max(self.high_water, active)
        plane = _obs.PLANE
        if plane is not None:
            m = plane.metrics
            m.counter(
                "pathway_serving_slot_acquires_total", {"pool": self.name},
                help="decode slots handed to requests",
            )
            m.gauge(
                "pathway_serving_slots_active", active, {"pool": self.name},
                help="decode slots currently mid-generation",
            )
            if refill:
                m.counter(
                    "pathway_serving_slot_refills_total", {"pool": self.name},
                    help="freed decode slots re-filled with a new request",
                )
            if joined:
                m.counter(
                    "pathway_serving_joined_inflight_total", {"pool": self.name},
                    help="requests that joined an in-flight decode batch",
                )
        return slot

    def release(self, slot: int) -> None:
        with self._lock:
            if slot in self._free:
                raise ValueError(f"slot {slot} released twice")
            self._free.append(slot)
            active = self.n_slots - len(self._free)
        plane = _obs.PLANE
        if plane is not None:
            plane.metrics.gauge(
                "pathway_serving_slots_active", active, {"pool": self.name},
                help="decode slots currently mid-generation",
            )

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return {
                "n_slots": self.n_slots,
                "active": self.n_slots - len(self._free),
                "acquired_total": self.acquired_total,
                "refills": self.refills,
                "joined_inflight": self.joined_inflight,
                "high_water": self.high_water,
            }


class DevicePlane:
    """Process-wide device-dispatch plane (see module docstring)."""

    def __init__(self, bucket_policy: BucketPolicy | None = None):
        self.buckets = bucket_policy or BucketPolicy()
        self.programs: dict[str, DeviceProgram] = {}
        self._leases: dict[Any, list] = {}  # key -> pooled buffers
        self._slot_pools: dict[str, SlotPool] = {}
        self._name_seq = 0
        # reentrant: drop_program runs from weakref finalizers, which gc
        # may fire while this thread already holds the lock
        self._lock = threading.RLock()
        self._dispatch_pool: ThreadPoolExecutor | None = None
        self._staging_pool: ThreadPoolExecutor | None = None

    @property
    def dispatch_pool(self) -> ThreadPoolExecutor:
        """Pool the coalescers flush on."""
        with self._lock:
            if self._dispatch_pool is None:
                self._dispatch_pool = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="pw-device-dispatch"
                )
            return self._dispatch_pool

    @property
    def staging_pool(self) -> ThreadPoolExecutor:
        """Single staging thread: host-side prep runs here in order while
        the caller's current dispatch computes."""
        with self._lock:
            if self._staging_pool is None:
                self._staging_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="pw-device-staging"
                )
            return self._staging_pool

    def stage(self, prep_fn: Callable, *args: Any) -> Future:
        """Run host-side prep on the staging thread; returns a Future."""
        return self.staging_pool.submit(prep_fn, *args)

    def program(self, name: str, fn: Callable | None = None) -> DeviceProgram:
        """Register-or-get the named program. The first caller supplies
        `fn`; later callers may omit it."""
        with self._lock:
            prog = self.programs.get(name)
            if prog is None:
                if fn is None:
                    raise KeyError(f"no device program named {name!r}")
                prog = self.programs[name] = DeviceProgram(name, fn)
            return prog

    def shape_counts(self) -> dict[tuple[str, Any], int]:
        """{(program_name, bucket): distinct shapes} across the plane."""
        with self._lock:
            progs = list(self.programs.items())
        out: dict[tuple[str, Any], int] = {}
        for name, prog in progs:
            with prog._lock:
                items = list(prog.shape_counts.items())
            for bucket, n in items:
                out[(name, bucket)] = n
        return out

    def coalescer(
        self, flush_fn: Callable[[list], list], max_batch: int = 4096,
        *, inline: bool = False,
    ) -> WaveCoalescer:
        return WaveCoalescer(
            flush_fn, max_batch=max_batch,
            pool=None if inline else self.dispatch_pool,
        )

    def slot_pool(self, name: str, n_slots: int) -> SlotPool:
        """Register-or-get the named decode slot pool (continuous
        batching). Pools are plane-owned, like programs, so their counters
        outlive the batcher that uses them; `drop_namespace` releases
        them."""
        with self._lock:
            pool = self._slot_pools.get(name)
            if pool is None:
                pool = self._slot_pools[name] = SlotPool(name, n_slots)
            elif pool.n_slots != n_slots:
                raise ValueError(
                    f"slot pool {name!r} already registered with "
                    f"{pool.n_slots} slots (asked for {n_slots})"
                )
            return pool

    def slot_pools(self) -> dict[str, dict[str, int]]:
        """{pool_name: counters} across the plane."""
        with self._lock:
            pools = list(self._slot_pools.items())
        return {name: pool.snapshot() for name, pool in pools}

    def unique_name(self, prefix: str) -> str:
        """Collision-proof program name for per-instance registrations."""
        with self._lock:
            self._name_seq += 1
            return f"{prefix}#{self._name_seq}"

    # -------------------------------------------------- persistent buffers
    #
    # Each key holds a POOL of buffers: concurrent flush chunks of one
    # stage may overlap, and each needs a buffer of its own.

    def lease(self, key: Any, make: Callable[[], Any]) -> Any:
        """Take a persistent buffer for `key`, creating one on first use
        (or when every pooled buffer is leased). The caller writes it in
        place and hands it back with :meth:`restore`."""
        with self._lock:
            pool = self._leases.get(key)
            buf = pool.pop() if pool else None
        if buf is None:
            buf = make()
        return buf

    def restore(self, key: Any, buf: Any) -> None:
        with self._lock:
            self._leases.setdefault(key, []).append(buf)

    def drop_lease(self, key: Any) -> None:
        with self._lock:
            self._leases.pop(key, None)

    def drop_program(self, name: str) -> None:
        """Release a per-instance program and every lease pool keyed to it
        (lease keys embed the program name). Called from the owner's
        finalizer, so the process-global plane pins neither the program
        nor its device buffers."""
        with self._lock:
            self.programs.pop(name, None)
            for key in [k for k in self._leases if isinstance(k, tuple) and name in k]:
                del self._leases[key]

    def drop_namespace(self, prefix: str) -> None:
        """Release every program, lease pool and slot pool in a
        per-instance namespace: names equal to `prefix` or starting with
        ``prefix + "/"`` (a continuous batcher registers
        ``{prefix}/prefill``, ``{prefix}/step``, ``{prefix}/slots`` and a
        cache lease keyed on `prefix`). The match respects the delimiter,
        so ``cb#1`` never takes ``cb#10``."""

        def hit(s: Any) -> bool:
            return isinstance(s, str) and (s == prefix or s.startswith(prefix + "/"))

        with self._lock:
            for name in [p for p in self.programs if hit(p)]:
                del self.programs[name]
            for key in [
                k for k in self._leases if isinstance(k, tuple) and any(hit(e) for e in k)
            ]:
                del self._leases[key]
            for name in [p for p in self._slot_pools if hit(p)]:
                del self._slot_pools[name]

    def pad_rows(self, mats: list, n_rows: int) -> tuple[list, int]:
        """Pad each 2-d numpy array in `mats` with zero rows up to the
        row bucket for `n_rows`; returns (padded, bucket)."""
        bucket = self.buckets.rows_bucket(n_rows)
        if bucket == n_rows:
            return list(mats), bucket
        return [np.pad(m, ((0, bucket - n_rows), (0, 0))) for m in mats], bucket


_plane: DevicePlane | None = None
_plane_lock = threading.Lock()


def get_device_plane() -> DevicePlane:
    global _plane
    with _plane_lock:
        if _plane is None:
            _plane = DevicePlane()
        return _plane
