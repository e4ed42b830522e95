"""Device meshes of the port over ``torch.distributed``.

The counterpart of ``repro/launch/mesh.py`` (the port's
:mod:`repro_torch.launch.mesh` re-exports it), kept here beside the rules
so that the serving and index layers depend on no launcher.  A
:class:`Mesh` names the
ranks of a process group along axes, as a JAX mesh names devices: it
wraps a ``torch.distributed.device_mesh.DeviceMesh`` and exposes what the
sharding rules read (``axis_names``, and ``shape`` as a dict of axis
sizes), this rank's ``coordinate`` on each axis and :meth:`Mesh.group`,
the process group along one axis (or along several, flattened).

``make_production_mesh`` and ``make_test_mesh`` are FUNCTIONS: importing
this module touches no device and no process group.  Shapes as the
reference's: one pod = (16, 16) over (data, model); two pods = (2, 16,
16) over (pod, data, model).  A mesh needs a process group of at least
its size (:func:`init_distributed`); every rank of that group builds it,
since making its groups is collective.

:func:`init_distributed` is the counterpart of the reference's multi-host
entry, ``jax.distributed.initialize()``: it joins the group torchrun
describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) or, without that environment, starts a world of one over
a ``FileStore`` in a fresh temporary directory (no network).  CUDA
devices talk over NCCL, the CPU over gloo; a CUDA world whose NCCL set-up
fails raises and never carries on over gloo.
"""

from __future__ import annotations

import datetime
import math
import os
import tempfile
from typing import Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["Mesh", "make_production_mesh", "make_test_mesh",
           "init_distributed"]

Axes = Union[str, Sequence[str]]
PG_TIMEOUT_S = 600               # a collective's limit before it raises


def _dist():
    import torch.distributed as dist
    return dist


class Mesh:
    """Ranks of the current process group laid out along named axes.

    ``ranks`` are the world ranks of the mesh in row-major order (default
    ``0 .. prod(shape) - 1``); a rank outside them has ``coordinate``
    None and takes part only in building the mesh.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 ranks: Optional[Sequence[int]] = None,
                 device_type: Optional[str] = None):
        dist = _dist()
        from torch.distributed.device_mesh import DeviceMesh

        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axes {axis_names} differ "
                             "in length")
        if not dist.is_initialized():
            raise RuntimeError(
                f"a {shape} mesh over {axis_names} needs a process group "
                "of at least its size: call repro_torch.distributed."
                "mesh.init_distributed first")
        n = math.prod(shape)
        world = dist.get_world_size()
        ranks = np.arange(n) if ranks is None else np.asarray(ranks)
        if ranks.size != n or ranks.min() < 0 or ranks.max() >= world:
            raise RuntimeError(f"a {shape} mesh needs {n} ranks of the "
                               f"world; the world has {world}")
        if device_type is None:
            device_type = ("cuda" if dist.get_backend() == "nccl"
                           else "cpu")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.devices = ranks.reshape(shape)
        self.device_mesh = DeviceMesh(
            device_type, torch.as_tensor(self.devices),
            mesh_dim_names=axis_names)
        coord = self.device_mesh.get_coordinate()
        self.coordinate = (None if coord is None
                           else dict(zip(axis_names, coord)))
        self._flat: dict = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coordinate={self.coordinate})"

    @staticmethod
    def _axes(axes: Axes) -> tuple:
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def size(self, axes: Axes) -> int:
        """Ranks along ``axes`` (1 for an axis the mesh lacks)."""
        return math.prod(self.shape.get(a, 1) for a in self._axes(axes))

    def index(self, axes: Axes) -> int:
        """This rank's row-major index along ``axes``."""
        idx = 0
        for a in self._axes(axes):
            if a in self.shape:
                idx = idx * self.shape[a] + self.coordinate[a]
        return idx

    def group(self, axes: Axes):
        """The process group of this rank's line along ``axes``: one axis
        is the device mesh's own group; several are flattened into one
        group the first time they are asked for, which every rank of the
        world must do together."""
        axes = tuple(a for a in self._axes(axes) if a in self.shape)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._flat:
            rest = [a for a in self.axis_names if a not in axes]
            arr = np.moveaxis(self.devices,
                              [self.axis_names.index(a) for a in rest +
                               list(axes)],
                              range(len(self.axis_names)))
            lines = arr.reshape(-1, self.size(axes)).tolist()
            me, _ = _dist().new_subgroups_by_enumeration(lines)
            self._flat[axes] = me
        return self._flat[axes]

    def rank_of(self, axes: Axes, index: int) -> int:
        """The world rank at ``index`` along ``axes`` on this rank's line
        (the other axes at this rank's coordinate)."""
        axes = tuple(a for a in self._axes(axes) if a in self.shape)
        coord = dict(self.coordinate)
        for a in reversed(axes):
            coord[a] = index % self.shape[a]
            index //= self.shape[a]
        return int(self.devices[tuple(coord[a] for a in self.axis_names)])


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_test_mesh(data: int = 2, model: int = 2) -> Mesh:
    """Small (data, model) mesh (needs a world of >= data*model ranks)."""
    return Mesh((data, model), ("data", "model"))


def init_distributed(device="cuda") -> torch.device:
    """Join (or start) the process group and return this rank's device.

    An initialised group is used as it is.  Otherwise the world is
    torchrun's (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), or, with no such environment, a world of one over a
    ``FileStore`` in a fresh temporary directory.  ``device`` of type
    ``cuda`` selects NCCL and card ``LOCAL_RANK`` (eager NCCL set-up, so
    a failure raises here); ``cpu`` selects gloo.
    """
    dist = _dist()
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no process-group backend for device {device!r}")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device("cuda", local) if kind == "cuda" else \
        torch.device("cpu")
    if dist.is_initialized():
        want = "nccl" if kind == "cuda" else "gloo"
        if dist.get_backend() != want:
            raise RuntimeError(f"the process group runs "
                               f"{dist.get_backend()}; {device} needs {want}")
        if kind == "cuda":
            torch.cuda.set_device(dev)
        return dev
    if "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    else:
        rank, world = 0, 1
        store = os.path.join(tempfile.mkdtemp(prefix="repro_pg_"), "store")
        init_method = f"file://{store}"
    kw = dict(init_method=init_method, rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed('cuda'): no CUDA device")
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **kw)
    else:
        dist.init_process_group("gloo", **kw)
    return dev
