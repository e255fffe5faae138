"""pw.parallel — scale-out across processes and over a device mesh.

Counterpart of ``pathway_tpu/parallel/``. Across processes: the TCP
process mesh (``process_mesh.py``) that multi-process pipelines open, and
the elastic plane over it (``membership.py``: join/leave intents and the
fence-time rebalance; ``supervisor.py``: whole-mesh restarts from the
agreed checkpoint; ``bluegreen.py``: whole-plan swaps behind the swap
gate). Over devices, inside one process: the device mesh and sharded
arrays (``mesh.py``), per-shard programs and their collectives
(``spmd.py``), the key-hash exchange (``exchange.py``), and the engine's
two hooks that route a shuffle over it (``device_exchange.py`` for vector
columns, ``column_plane.py`` for a NativeBatch's scalar columns).

The namespace is lazy (PEP 562), as the JAX package's: every Session
imports ``process_mesh``, and a mesh-less pipeline need not load the
mesh modules.
"""

_EXPORTS = {
    "default_mesh": "mesh",
    "make_mesh": "mesh",
    "replicate": "mesh",
    "shard_rows": "mesh",
    "ExchangeResult": "exchange",
    "exchange_by_key": "exchange",
    "partition_counts": "exchange",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    val = getattr(importlib.import_module(f"pathway_tpu_torch.parallel.{target}"), name)
    globals()[name] = val  # later lookups skip __getattr__
    return val


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
