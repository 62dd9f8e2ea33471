"""Device meshes of the port (port of ``repro.launch.mesh``).

A `Mesh` names a grid of devices by axis: ``shape`` (axis -> size),
``axis_names`` and ``devices``, the flat tuple of ``torch.device``s in
row-major order over the axes. One process drives all of them (the
reference's single-controller `RagDB(mesh=)`); no process group is formed.
A device may appear more than once: S logical shards on one card, or on
"cpu" in the tests, as the reference's tests run S fake XLA host devices.
`device_groups` gathers a mesh's shards by device: each group is one
allocation of the hot arena (``core.store``). Distinct CPU entries
(``torch.device("cpu", i)``) stay distinct groups while their tensors all
land on the one CPU: that is how the tests drive several allocations.

Defined as functions, so that importing this module touches no device.
Single pod: (data=16, model=16) = 256 devices; multi-pod adds a leading
"pod" axis (2 pods = 512).

>>> m = make_mesh((4,), ("data",), devices=["cpu"] * 4)
>>> dict(m.shape), len(m.devices), m.devices[0]
({'data': 4}, 4, device(type='cpu'))
>>> dict(make_host_mesh(2, 2).shape)
{'data': 2, 'model': 2}
>>> cpus = [torch.device("cpu", i) for i in (0, 0, 1, 1)]
>>> device_groups(make_mesh((4,), ("data",), devices=cpus))
((device(type='cpu', index=0), (0, 1)), (device(type='cpu', index=1), (2, 3)))
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from types import MappingProxyType

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named device grid: ``shape`` maps each axis to its size, in
    ``axis_names`` order; ``devices`` holds prod(shape) devices."""
    shape: MappingProxyType
    axis_names: tuple
    devices: tuple


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``. ``devices`` (any sequence of
    devices or device names, repeats allowed) must hold prod(shape)
    entries; without it the mesh takes the first prod(shape) CUDA devices
    and raises when there are fewer (it never wraps around)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(f"a mesh of shape {shape} needs {n} CUDA "
                             f"devices; {have} available (pass devices= to "
                             "place several shards on one device)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != n:
        raise ValueError(f"a mesh of shape {shape} needs {n} devices, got "
                         f"{len(devices)}")
    return Mesh(MappingProxyType(dict(zip(axes, shape))), axes, devices)


def make_host_mesh(n_data: int = 1, n_model: int = 1,
                   device="cpu") -> Mesh:
    """A small (data, model) mesh of logical shards, all on ``device`` --
    used by tests and examples, never by a production run."""
    return make_mesh((n_data, n_model), ("data", "model"),
                     devices=[device] * (n_data * n_model))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh, one device a shard: (data=16, model=16), or
    (pod=2, data=16, model=16) with ``multi_pod``. Raises unless that many
    CUDA devices are present."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def n_shards(mesh: Mesh, axes) -> int:
    """The shard count of ``axes`` (one axis name or a tuple of them)."""
    ax = (axes,) if isinstance(axes, str) else tuple(axes)
    return math.prod(mesh.shape[a] for a in ax)


def dp_tp_coords(mesh: Mesh, tp_axis: str = "model", dp_axes=None) -> list:
    """(i, j) for every mesh entry in ``devices`` order: i its data shard
    (its index over ``dp_axes``, major first; by default every axis but
    ``tp_axis``), j its index on ``tp_axis`` (0 when the mesh has none).

    >>> dp_tp_coords(make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4))
    [(0, 0), (0, 1), (1, 0), (1, 1)]
    """
    names = mesh.axis_names
    dp = [a for a in names if a != tp_axis] if dp_axes is None else dp_axes
    out = []
    for idx in itertools.product(*(range(mesh.shape[a]) for a in names)):
        c = dict(zip(names, idx))
        i = 0
        for a in dp:
            i = i * mesh.shape[a] + c[a]
        out.append((i, c.get(tp_axis, 0)))
    return out


def same_device(a, b) -> bool:
    """Whether two devices are one: "cuda" and "cuda:<current>" are."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == \
        (current if b.index is None else b.index)


def normalize_device(device) -> torch.device:
    """A mesh entry as a key: "cuda" becomes "cuda:<current>"; a CPU
    entry keeps its index as given, so ``cpu:0`` and ``cpu:1`` differ."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def tensor_device(device) -> torch.device:
    """The device a tensor placed on ``device`` reports: the CPU is one
    device whatever index a mesh entry gives it."""
    d = normalize_device(device)
    return torch.device("cpu") if d.type == "cpu" else d


def device_groups(mesh: Mesh, axes=None) -> tuple:
    """The mesh's shards grouped by device: ((device, shards), ...) in
    shard order, one entry a distinct device (`normalize_device`), each
    holding the shards placed there. Shard s of ``axes`` (all axes when
    None) lies on the mesh's device at its coordinates on those axes and
    index 0 on the others. A device's shards must be contiguous in shard
    order -- the arena's regions are slot-aligned and contiguous, so one
    allocation a device holds its regions back to back; raises
    otherwise."""
    ax = (mesh.axis_names if axes is None else
          (axes,) if isinstance(axes, str) else tuple(axes))
    grid = torch.arange(len(mesh.devices)).reshape(
        tuple(mesh.shape[a] for a in mesh.axis_names))
    rest = [a for a in mesh.axis_names if a not in ax]
    grid = grid.permute([mesh.axis_names.index(a) for a in (*ax, *rest)])
    flat = grid.reshape(n_shards(mesh, ax), -1)[:, 0].tolist()
    groups: dict[torch.device, list[int]] = {}
    for s, i in enumerate(flat):
        groups.setdefault(normalize_device(mesh.devices[i]), []).append(s)
    for dev, shards in groups.items():
        if shards != list(range(shards[0], shards[-1] + 1)):
            raise ValueError(f"the shards on {dev} are {shards}: a device's "
                             "shards must be contiguous in shard order")
    return tuple((dev, tuple(shards)) for dev, shards in groups.items())
