"""Device mesh over ``torch.distributed`` ranks (mirrors
``paddle_tpu/distributed/mesh.py``; reference: the ring registry of
platform/collective_helper.h:52-110, rings keyed by ring_id).

A mesh is a grid of ranks with named axes (``dp``, ``pp``, ``tp``,
``sp``, ``ep``), laid out row-major as ``np.arange(world).reshape(sizes)``
is, the order the reference's ``jax.devices()`` reshape gives. Each axis
of size > 1 has one process group per line of ranks along it; a rank
keeps the group of its own line. ``new_group`` is collective over the
default group, so every rank creates every axis's groups in the same
order, members or not. A line that spans the whole world reuses the
default group. A group orders its ranks by global rank, which a tuple
of axes named out of the mesh's order does not follow (``('tp', 'dp')``
on a ``{'dp': 2, 'tp': 2}`` mesh walks ranks 0, 2, 1, 3):
``group_order`` maps each axis index to its group rank. A mesh whose axes are all of size 1 needs no process
group (``torch.distributed.device_mesh`` is not used: it starts a
default group on its own where none exists).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

__all__ = ["Mesh", "PartitionSpec", "P", "NamedSharding", "create_mesh",
           "set_mesh", "get_mesh", "init_mesh", "sharding", "axis_size"]


class PartitionSpec(tuple):
    """The port's own PartitionSpec: per tensor dim, a mesh axis name, a
    tuple of names, or None (replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """Ranks on named axes, with this rank's group and coordinate on
    each axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices                  # rank ids, one per cell
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._lines: Dict[Tuple[str, ...], list] = {}
        self._orders: Dict[Tuple[str, ...], list] = {}
        self._coords: Dict[str, int] = {}
        me = self._me = dist.get_rank() if dist.is_initialized() else 0
        where = np.argwhere(devices == me)
        if len(where):
            self._coords = dict(zip(self.axis_names,
                                    (int(c) for c in where[0])))
        for name in self.axis_names:
            self._make_groups((name,))

    def _make_groups(self, names: Tuple[str, ...]) -> None:
        """The groups of the lines along ``names`` (several axes: one line
        per cell of the others, the first name major), created by every
        rank in the same order; this rank keeps its own line's."""
        if names in self._lines:
            return
        axes = [self.axis_names.index(n) for n in names]
        size = int(np.prod([self.devices.shape[a] for a in axes]))
        if size == 1:
            self._lines[names] = [self._me]
            self._orders[names] = [0]
            return
        if not dist.is_initialized():
            raise RuntimeError(
                f"mesh axes {names} of size {size} need a process group: "
                "call init_parallel_env first")
        lines = np.moveaxis(self.devices, axes,
                            range(-len(axes), 0)).reshape(-1, size)
        whole = size == dist.get_world_size()
        for line in lines:
            line = [int(r) for r in line]
            group = dist.group.WORLD if whole else dist.new_group(line)
            if self._me in line:
                self._groups[names] = group
                self._lines[names] = line
                ascending = sorted(line)
                self._orders[names] = [ascending.index(r) for r in line]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @staticmethod
    def _names(name) -> Tuple[str, ...]:
        return (name,) if isinstance(name, str) else tuple(name)

    def group(self, name):
        """This rank's process group along axis ``name`` (or a tuple of
        axes; None where the line is this rank alone). A tuple's groups
        are made at its first use, by every rank."""
        names = self._names(name)
        self._make_groups(names)
        return self._groups.get(names)

    def axis_ranks(self, name) -> list:
        """The global ranks of this rank's line along ``name``, in axis
        order."""
        names = self._names(name)
        self._make_groups(names)
        return self._lines[names]

    def group_order(self, name) -> list:
        """The group rank of each axis index along ``name``: the identity
        unless a tuple of axes is named out of the mesh's order."""
        names = self._names(name)
        self._make_groups(names)
        return self._orders[names]

    def axis_size(self, name) -> int:
        return int(np.prod([self.shape[n] for n in self._names(name)]))

    def axis_index(self, name) -> int:
        """This rank's index on ``name`` (a tuple: the first name major)."""
        idx = 0
        for n in self._names(name):
            idx = idx * self.shape[n] + self._coords.get(n, 0)
        return idx

    def __repr__(self):
        return f"Mesh({self.shape})"


class NamedSharding:
    """A PartitionSpec bound to a mesh."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            other.mesh is self.mesh and other.spec == self.spec

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


_current_mesh: Optional[Mesh] = None


def create_mesh(axes: Dict[str, int], devices: Optional[Sequence] = None
                ) -> Mesh:
    """A Mesh from ``{'dp': 2, 'tp': 4, ...}`` over ``devices`` (rank
    ids; default every rank). Axis sizes must multiply to the number of
    ranks; axes of size 1 are kept."""
    if devices is None:
        devices = range(dist.get_world_size() if dist.is_initialized()
                        else 1)
    devs = list(devices)
    names = list(axes.keys())
    sizes = [int(axes[n]) for n in names]
    total = int(np.prod(sizes))
    if total != len(devs):
        raise ValueError(
            f"mesh axes {axes} require {total} devices, have {len(devs)}")
    return Mesh(np.asarray(devs).reshape(sizes), names)


def set_mesh(mesh: Optional[Mesh]):
    global _current_mesh
    _current_mesh = mesh
    return mesh


def get_mesh() -> Optional[Mesh]:
    return _current_mesh


def init_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    return set_mesh(create_mesh(axes, devices))


def sharding(*spec, mesh: Optional[Mesh] = None) -> NamedSharding:
    m = mesh or _current_mesh
    if m is None:
        raise RuntimeError("No mesh set; call init_mesh first.")
    return NamedSharding(m, PartitionSpec(*spec))


def axis_size(name: str, mesh: Optional[Mesh] = None) -> int:
    m = mesh or _current_mesh
    if m is None or name not in m.axis_names:
        return 1
    return m.shape[name]
