"""Device meshes of the port (counterpart of ``repro/launch/mesh.py``).

A ``Mesh`` is a small value: ``shape``, the size of each named axis in
axis order, and ``devices``, a row-major list of torch devices, or None
for an abstract mesh. An abstract mesh is what the dry run
(``launch/dryrun_lib.py``) places specs on: ``make_production_mesh``
gives the reference's 16×16 and pods×16×16 layouts, with no device
behind them. The port runs in one process, so a mesh is not a
``torch.distributed.DeviceMesh`` (which needs a process group): the
multi-device forms (``parallel/pipeline.py::pipelined_forward``) walk its
device list. A list may repeat one device, as the BCNN's forms
(``parallel/bcnn_pipeline.py``) do: the work then runs side by side on
that card.

Functions, not module-level constants: importing this module touches no
device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.parallel.bcnn_pipeline import resolve_devices


@dataclass(frozen=True)
class Mesh:
    """Named axes over a row-major device list (None: abstract)."""
    shape: dict
    devices: tuple | None = None

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis``, every other axis at index 0."""
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices")
        names = self.axis_names
        i = names.index(axis)
        stride = math.prod(self.shape[a] for a in names[i + 1:])
        return [self.devices[j * stride] for j in range(self.shape[axis])]


def make_mesh(shape, axes, devices=None) -> Mesh:
    """An executable mesh of ``shape`` over the named ``axes``. ``devices``:
    the first prod(shape) of this list are used (one device may repeat);
    None means every CUDA device, which raises when there is none."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    devices = resolve_devices(devices)
    if n > len(devices):
        raise ValueError(f"mesh {shape} needs {n} devices, have "
                         f"{len(devices)}")
    return Mesh(dict(zip(axes, shape)), tuple(devices[:n]))


def make_production_mesh(*, multi_pod: bool = False, pods: int = 0) -> Mesh:
    """16×16 single pod, or pods×16×16 (pods=2 is the multi-pod target),
    abstract: the dry run's meshes."""
    if pods == 0:
        pods = 2 if multi_pod else 1
    if pods > 1:
        return Mesh({"pod": pods, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes: ("pod","data") on multi-pod, ("data",) else."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_local_mesh(device=None) -> Mesh:
    """1-device mesh with the production axis names. ``device`` None means
    the first CUDA device, which raises when there is none."""
    return make_mesh((1, 1), ("data", "model"),
                     None if device is None else [device])


def make_data_mesh(n_shards: int, devices=None) -> Mesh:
    """(n_shards, 1) mesh over ("data", "model"): the pure data-parallel
    deployment mesh, with the production axis names so the sharding
    helpers (``parallel/sharding.py``: ``dp_axes`` / ``batch_spec``) apply
    unchanged. ``devices``: the first ``n_shards`` are used; None means
    every CUDA device."""
    return make_mesh((n_shards, 1), ("data", "model"), devices)
