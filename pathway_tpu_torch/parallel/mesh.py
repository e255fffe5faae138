"""Device meshes and sharded arrays.

Counterpart of ``pathway_tpu/parallel/mesh.py``. The framework's
convention holds: axis ``data`` shards rows and batch, axis ``model``
shards tensors, and ``make_mesh((4, 2))`` on 8 devices gives the dp x tp
layout that ``models/transformer.py:param_specs`` names.

A :class:`Mesh` is a single-process grid of ``torch.device``s with axis
names; the JAX package's mesh is a grid of XLA devices driven by one
controller, and the port keeps that shape: one process calls a sharded
function, and ``parallel/spmd.py`` runs its per-shard body on every
device of the grid. One device may appear several times, each time as
its own shard. That is the port's counterpart of XLA's
``--xla_force_host_platform_device_count``:

* ``make_mesh(devices=...)`` takes any list, e.g. ``["cpu"] * 8``;
* call sites that build their own mesh (``IvfPqIndex(sharded=True)``,
  ``ContinuousBatcher(mesh_span=True)``, the engine's exchangers) take
  ``default_devices()``, which reads ``PATHWAY_MESH_DEVICES`` when it is
  set (``cpu*8`` for eight shards on the CPU, ``cuda:0*4`` for four on one
  card, or a comma list such as ``cuda:0,cuda:1``) and otherwise every
  CUDA device, raising when there is none.

A sharded array is a :class:`Sharded`: one tensor per mesh device, each
holding that device's block of the global array as its
:class:`PartitionSpec` says.
"""

from __future__ import annotations

import os
from typing import Any, Sequence

import numpy as np
import torch

__all__ = [
    "Mesh",
    "PartitionSpec",
    "P",
    "Sharded",
    "default_devices",
    "default_mesh",
    "make_mesh",
    "replicate",
    "shard_rows",
]

ENV_DEVICES = "PATHWAY_MESH_DEVICES"


class PartitionSpec(tuple):
    """One entry per array dimension: an axis name, a tuple of axis
    names, or None (not sharded). Trailing dimensions may be omitted."""

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def _parse_devices(raw: str) -> list[torch.device]:
    out: list[torch.device] = []
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, times = item.partition("*")
        out.extend([torch.device(name.strip())] * (int(times) if times else 1))
    if not out:
        raise ValueError(f"{ENV_DEVICES}={raw!r} names no device")
    return out


def default_devices() -> list[torch.device]:
    """The devices a mesh built without a device list spans: those named
    by ``PATHWAY_MESH_DEVICES`` (module docstring), else every CUDA
    device. Raises when neither gives one: the port never moves a mesh
    to the CPU on its own."""
    raw = os.environ.get(ENV_DEVICES)
    if raw:
        devs = _parse_devices(raw)
    elif torch.cuda.is_available():
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        raise RuntimeError(
            "no CUDA device is available for a device mesh; pass devices= or set "
            f"{ENV_DEVICES} (for example cpu*8)"
        )
    for d in devs:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{ENV_DEVICES} names {d}, and no CUDA device is available")
    return devs


class Mesh:
    """An n-dimensional grid of devices with one name per axis.

    ``shape`` maps each axis name to its size, in axis order, and
    ``devices`` is the grid (a numpy object array of ``torch.device``),
    as on the JAX package's mesh."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))
        self.size = int(devices.size)

    def coords(self, flat: int) -> dict[str, int]:
        """Axis coordinates of the `flat`-th device (row-major)."""
        idx = np.unravel_index(flat, self.devices.shape)
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def flat_index(self, coords: dict[str, int]) -> int:
        return int(np.ravel_multi_index(
            tuple(coords.get(a, 0) for a in self.axis_names), self.devices.shape
        ))

    def device(self, flat: int) -> torch.device:
        return self.devices.flat[flat]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(
    shape: Sequence[int] | None = None,
    axis_names: Sequence[str] = ("data", "model"),
    devices: Sequence | None = None,
) -> Mesh:
    devs = [torch.device(d) for d in (devices if devices is not None else default_devices())]
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, have {len(devs)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devs[:n]):
        grid[i] = d
    return Mesh(grid.reshape(tuple(shape)), axis_names)


def default_mesh(axis_names: Sequence[str] = ("data",)) -> Mesh:
    """All default devices (:func:`default_devices`) on one axis."""
    devs = default_devices()
    return make_mesh((len(devs),), axis_names, devs)


# ------------------------------------------------------------ sharded arrays


def _axes(entry: Any) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def block_index(mesh: Mesh, entry: Any, coords: dict[str, int]) -> tuple[int, int]:
    """(block, blocks) of one dimension sharded over the axes `entry`
    names, for the device at `coords` (axes in order, major first)."""
    block, blocks = 0, 1
    for a in _axes(entry):
        block = block * mesh.shape[a] + coords[a]
        blocks *= mesh.shape[a]
    return block, blocks


def local_block(x: torch.Tensor, spec: PartitionSpec, mesh: Mesh, flat: int) -> torch.Tensor:
    """The `flat`-th device's block of the global tensor `x` (a view;
    every sharded dimension must divide evenly)."""
    coords = mesh.coords(flat)
    for dim, entry in enumerate(spec):
        block, blocks = block_index(mesh, entry, coords)
        if blocks == 1:
            continue
        size = x.shape[dim]
        if size % blocks:
            raise ValueError(
                f"dimension {dim} of size {size} does not split into {blocks} blocks ({spec})"
            )
        x = x.narrow(dim, block * (size // blocks), size // blocks)
    return x


class Sharded:
    """A global array held as one tensor per mesh device (``shards``, in
    the mesh's flat order), each that device's block under ``spec``."""

    __slots__ = ("shards", "spec", "mesh", "shape")

    def __init__(self, shards: list, spec: PartitionSpec, mesh: Mesh, shape: tuple):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size} devices")
        self.shards = shards
        self.spec = PartitionSpec(*spec)
        self.mesh = mesh
        self.shape = tuple(shape)

    @classmethod
    def from_global(
        cls, x: torch.Tensor, mesh: Mesh, spec: PartitionSpec, *, copy: bool = True
    ) -> "Sharded":
        """Each device's block of `x`: its own copy, or with
        ``copy=False`` a view wherever the block already lies on the
        device (shards of one device then share memory)."""
        shards = [
            local_block(x, spec, mesh, i).to(mesh.device(i), copy=copy)
            for i in range(mesh.size)
        ]
        return cls(shards, spec, mesh, tuple(x.shape))

    def shard_bytes(self) -> list[int]:
        return [t.numel() * t.element_size() for t in self.shards]


def assemble(
    blocks: list[torch.Tensor], spec: PartitionSpec, mesh: Mesh,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """The global tensor from per-device `blocks` under `spec`: blocks of
    sharded dimensions are concatenated in axis order, and a dimension's
    replicas (devices that differ only along axes `spec` does not name)
    are taken from coordinate 0."""
    dev = torch.device(device) if device is not None else mesh.device(0)

    def build(dim: int, coords: dict[str, int]) -> torch.Tensor:
        if dim == len(spec):
            return blocks[mesh.flat_index(coords)].to(dev)
        axes = _axes(spec[dim])
        if not axes:
            return build(dim + 1, coords)
        parts = []
        for flat in np.ndindex(*(mesh.shape[a] for a in axes)):
            parts.append(build(dim + 1, {**coords, **dict(zip(axes, flat))}))
        return torch.cat(parts, dim=dim)

    return build(0, {})


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> Sharded:
    """`x` with its leading dimension sharded over `axis`."""
    return Sharded.from_global(x, mesh, PartitionSpec(axis, *([None] * (x.dim() - 1))))


def replicate(x: torch.Tensor, mesh: Mesh) -> Sharded:
    """A copy of `x` on every mesh device."""
    return Sharded.from_global(x, mesh, PartitionSpec())
