"""Per-shard programs over a device mesh, and the collectives inside them.

The port's counterpart of ``jax.shard_map`` and of the ``jax.lax``
collectives the JAX package calls under it: :func:`axis_index`,
:func:`axis_size`, :func:`psum`, :func:`pmax`, :func:`all_gather`,
:func:`all_to_all` and :func:`ppermute`.

``shard_map(fn, mesh, in_specs, out_specs)`` returns a function of global
arrays. A call cuts each argument into the blocks its spec names
(``parallel/mesh.py``; a :class:`~pathway_tpu_torch.parallel.mesh.Sharded`
argument is already cut), runs ``fn`` once per mesh device, each run on
its own thread with that device's blocks, and assembles the global
outputs under ``out_specs``. Meshes of one size share a pool of as many
worker threads, and calls on them run one at a time.

The collectives may be called anywhere inside ``fn``, inside loops too
(``ring_attention`` rotates K/V with :func:`ppermute` in its loop). Each
is a rendezvous of every shard of the call at a barrier: a shard puts
its value in its slot, waits for all, reads the slots of its group (the
shards that differ from it only along the collective's axis), and waits
again before the slots are reused. So:

* outputs are ordered by shard index along the axis, never by arrival,
  and every member of a group computes the same reduction in the same
  order, so replicated results are equal bit for bit;
* a shard that raises aborts the barrier; the others leave their waits,
  and the call re-raises the first error that is not that abort;
* shards that call different collectives (or one that returns while
  another waits in one) see each other's tags at the barrier and raise,
  instead of pairing up the wrong values;
* on a CUDA device each shard runs on its own stream, which first waits
  for the caller's stream; a shard that reads another's tensor waits on
  that shard's stream through an event and records the tensor on its
  own stream, and the caller's stream waits for every shard's before it
  assembles the outputs;
* the collectives are torch ops on the values they read (copies between
  devices, sums, stacks), so autograd flows through them, and the
  caller's grad mode holds in every shard.

A collective over devices of one card copies nothing (``.to`` of a
tensor already there returns it); across cards the copies are
peer-to-peer (NVLink where the cards have it).
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from pathway_tpu_torch.parallel.mesh import (
    Mesh,
    PartitionSpec,
    Sharded,
    assemble,
    block_index,
    local_block,
)

__all__ = [
    "all_gather",
    "all_to_all",
    "axis_index",
    "axis_size",
    "pmax",
    "ppermute",
    "psum",
    "shard_map",
]

_TLS = threading.local()
_RUNNERS_LOCK = threading.Lock()
_RUNNERS: dict[int, "_Runner"] = {}  # mesh size -> its worker pool


class _Run:
    """One call of a mapped function: the barrier and one slot a shard."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.barrier = threading.Barrier(mesh.size)
        self.slots: list[Any] = [None] * mesh.size


class _Shard:
    """The calling thread's place in a run."""

    __slots__ = ("run", "flat", "coords", "device", "stream")

    def __init__(self, run: _Run, flat: int, stream: Any):
        self.run = run
        self.flat = flat
        self.coords = run.mesh.coords(flat)
        self.device = run.mesh.device(flat)
        self.stream = stream


class _Runner:
    """Worker threads for meshes of one size (one a shard), and a CUDA
    stream for each (shard, device) they have run."""

    def __init__(self, size: int):
        self.pool = ThreadPoolExecutor(size, thread_name_prefix="pw-spmd")
        self.lock = threading.Lock()
        self.streams: dict[tuple[int, torch.device], Any] = {}

    def stream(self, flat: int, device: torch.device) -> Any:
        if device.type != "cuda":
            return None
        s = self.streams.get((flat, device))
        if s is None:
            s = self.streams[(flat, device)] = torch.cuda.Stream(device)
        return s


def _runner(mesh: Mesh) -> _Runner:
    with _RUNNERS_LOCK:
        r = _RUNNERS.get(mesh.size)
        if r is None:
            r = _RUNNERS[mesh.size] = _Runner(mesh.size)
        return r


def _current() -> _Shard:
    sh = getattr(_TLS, "shard", None)
    if sh is None:
        raise RuntimeError("a collective was called outside a shard_map body")
    return sh


def _leaves(x: Any) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [leaf for v in x.values() for leaf in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return []


def _rendezvous(tag: Any, value: Any) -> list:
    """Deposit `value`, wait for every shard, return all shards' values
    (flat order), and wait again before the slots can be reused."""
    sh = _current()
    run = sh.run
    event = None
    if sh.stream is not None:
        event = torch.cuda.Event()
        event.record(sh.stream)
    run.slots[sh.flat] = (tag, value, event)
    run.barrier.wait()
    got = list(run.slots)
    run.barrier.wait()
    tags = [g[0] for g in got]
    if any(t != tag for t in tags):
        raise RuntimeError(f"the shards called different collectives: {tags}")
    if sh.stream is not None:
        for i, (_t, v, ev) in enumerate(got):
            if i == sh.flat:
                continue
            sh.stream.wait_event(ev)
            for leaf in _leaves(v):
                if leaf.device.type == "cuda":
                    leaf.record_stream(sh.stream)
    return [g[1] for g in got]


def _group(sh: _Shard, axis: Any) -> list[int]:
    """Flat indices of the shards that differ from `sh` only along the
    axes `axis` names, in axis order."""
    mesh = sh.run.mesh
    axes = tuple(axis) if isinstance(axis, tuple) else (axis,)
    out = []
    for idx in np.ndindex(*(mesh.shape[a] for a in axes)):
        out.append(mesh.flat_index({**sh.coords, **dict(zip(axes, idx))}))
    return out


def _gather(x: Any, axis: Any, tag: Any) -> list:
    sh = _current()
    values = _rendezvous(tag, x)
    return [values[i] for i in _group(sh, axis)]


# ------------------------------------------------------------ collectives


def axis_index(axis: Any) -> int:
    """This shard's coordinate along `axis` (a name or a tuple of names,
    major first)."""
    sh = _current()
    return block_index(sh.run.mesh, axis, sh.coords)[0]


def axis_size(axis: Any) -> int:
    sh = _current()
    return block_index(sh.run.mesh, axis, sh.coords)[1]


def psum(x: torch.Tensor, axis: Any) -> torch.Tensor:
    """Sum over the shards of `axis`, in axis order."""
    parts = _gather(x, axis, ("psum", axis))
    out = parts[0].to(x.device)
    for p in parts[1:]:
        out = out + p.to(x.device)
    return out


def pmax(x: torch.Tensor, axis: Any) -> torch.Tensor:
    parts = _gather(x, axis, ("pmax", axis))
    out = parts[0].to(x.device)
    for p in parts[1:]:
        out = torch.maximum(out, p.to(x.device))
    return out


def all_gather(x: torch.Tensor, axis: Any) -> torch.Tensor:
    """[axis_size, *x.shape]: every shard's `x` along `axis`, stacked."""
    parts = _gather(x, axis, ("all_gather", axis))
    return torch.stack([p.to(x.device) for p in parts])


def all_to_all(x: torch.Tensor, axis: Any, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Shard j receives the j-th piece of every shard's `x` along
    `split_axis` (``lax.all_to_all`` untiled): that dimension must have the
    axis size, and is replaced by a new one at `concat_axis` that stacks
    the pieces in source order."""
    parts = _gather(x, axis, ("all_to_all", axis, split_axis, concat_axis))
    me, n = axis_index(axis), len(parts)
    if x.shape[split_axis] != n:
        raise ValueError(f"all_to_all splits a dimension of {x.shape[split_axis]} over {n} shards")
    return torch.stack([p.select(split_axis, me).to(x.device) for p in parts], dim=concat_axis)


def ppermute(x: torch.Tensor, axis: Any, perm: list[tuple[int, int]]) -> torch.Tensor:
    """Send `x` along the (source, destination) pairs of `perm` (axis
    positions); a shard that no pair names as destination gets zeros."""
    parts = _gather(x, axis, ("ppermute", axis, tuple(perm)))
    me = axis_index(axis)
    for src, dst in perm:
        if dst == me:
            return parts[src].to(x.device)
    return torch.zeros_like(x)


# -------------------------------------------------------------- shard_map


def _local(arg: Any, spec: Any, mesh: Mesh, flat: int) -> Any:
    """The `flat`-th device's view of one argument under its spec (a
    PartitionSpec applies to every tensor leaf; a dict or list of specs
    follows the argument's structure)."""
    if isinstance(spec, PartitionSpec):
        if isinstance(arg, Sharded):
            if arg.mesh is not mesh:
                raise ValueError("a Sharded argument of another mesh")
            return arg.shards[flat]
        if isinstance(arg, torch.Tensor):
            return local_block(arg, spec, mesh, flat).to(mesh.device(flat))
        if isinstance(arg, dict):
            return {k: _local(v, spec, mesh, flat) for k, v in arg.items()}
        if isinstance(arg, (list, tuple)):
            return type(arg)(_local(v, spec, mesh, flat) for v in arg)
        return arg
    if isinstance(spec, dict):
        return {k: _local(arg[k], spec[k], mesh, flat) for k in arg}
    return type(arg)(_local(a, s, mesh, flat) for a, s in zip(arg, spec, strict=True))


def _assemble(results: list, spec: Any, mesh: Mesh) -> Any:
    first = results[0]
    if isinstance(spec, PartitionSpec):
        if isinstance(first, torch.Tensor):
            return assemble(results, spec, mesh)
        if isinstance(first, dict):
            return {k: _assemble([r[k] for r in results], spec, mesh) for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(_assemble([r[i] for r in results], spec, mesh) for i in range(len(first)))
        return first
    if isinstance(spec, dict):
        return {k: _assemble([r[k] for r in results], spec[k], mesh) for k in first}
    return type(first)(_assemble([r[i] for r in results], s, mesh) for i, s in enumerate(spec))


def _shard_main(run: _Run, runner: _Runner, flat: int, fn: Callable, args: tuple,
                in_specs: tuple, grad: bool, caller_streams: dict) -> Any:
    mesh = run.mesh
    dev = mesh.device(flat)
    stream = runner.stream(flat, dev)
    _TLS.shard = _Shard(run, flat, stream)
    try:
        ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with torch.set_grad_enabled(grad), ctx:
            if stream is not None:
                stream.wait_stream(caller_streams[dev])
            local = [_local(a, s, mesh, flat) for a, s in zip(args, in_specs)]
            out = fn(*local)
            # a shard that returns while another still waits in a
            # collective meets it here and both raise
            _rendezvous(("end",), None)
            return out
    except BaseException:
        run.barrier.abort()
        raise
    finally:
        _TLS.shard = None


def _run(mesh: Mesh, fn: Callable, args: tuple, in_specs: tuple, out_specs: Any) -> Any:
    if getattr(_TLS, "shard", None) is not None:
        raise RuntimeError("shard_map was called inside a shard_map body")
    if len(args) != len(in_specs):
        raise TypeError(f"{len(args)} arguments for {len(in_specs)} in_specs")
    runner = _runner(mesh)
    caller_streams = {
        d: torch.cuda.current_stream(d) for d in set(mesh.devices.flat) if d.type == "cuda"
    }
    grad = torch.is_grad_enabled()
    with runner.lock:
        run = _Run(mesh)
        futs = [
            runner.pool.submit(_shard_main, run, runner, i, fn, args, in_specs, grad, caller_streams)
            for i in range(mesh.size)
        ]
        results, errors = [], []
        for f in futs:
            try:
                results.append(f.result())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
    if errors:
        real = [e for e in errors if not isinstance(e, threading.BrokenBarrierError)]
        raise (real or errors)[0]
    for flat in range(mesh.size):
        dev = mesh.device(flat)
        if dev.type != "cuda":
            continue
        caller = caller_streams[dev]
        caller.wait_stream(runner.streams[(flat, dev)])
        for leaf in _leaves(results[flat]):
            if leaf.device.type == "cuda":
                leaf.record_stream(caller)
    return _assemble(results, out_specs, mesh)


def shard_map(fn: Callable, mesh: Mesh, in_specs: tuple, out_specs: Any) -> Callable:
    """`fn` over the mesh's devices (module docstring). `in_specs` has one
    spec per positional argument; `out_specs` follows the output's
    structure."""
    in_specs = tuple(in_specs)

    def mapped(*args: Any) -> Any:
        return _run(mesh, fn, args, in_specs, out_specs)

    return mapped
