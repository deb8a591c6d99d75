"""Mesh construction helpers.

Counterpart of ``paddle_tpu/parallel/mesh_utils.py``. A mesh is a list of
places with axis names and a shape: ``make_mesh([2], ["dp"], places)``, or
several named axes, ``make_mesh([2, 2, 2], ["dp", "pp", "mp"])``. Replica
r sits at ``coords(r)`` (row-major over the shape, as the JAX package
reshapes its devices), and ``axis_groups(axes)`` are the subgroups of an
axis (or of several): the replicas that differ only on those axes, each in
rank order.
A place may appear more than once (``[CUDAPlace(0)] * 2`` runs two
replicas on one card, ``[CPUPlace()] * 8`` eight on the CPU). A mesh over
a ``torch.distributed`` world (``process_group`` set) names one replica
a process: each process holds its own place, and the group spans them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.place import CUDAPlace, Place


class Mesh:
    """Places with axis names and a shape. ``places`` are this process's
    replicas; ``process_group`` (a ``torch.distributed`` group, or the
    world as ``"world"``) marks a mesh of one replica a process."""

    def __init__(self, places: Sequence[Place], axis_names: Sequence[str],
                 shape: Optional[Sequence[int]] = None, process_group=None):
        self.places = list(places)
        self.axis_names = tuple(axis_names)
        self.process_group = process_group
        if shape is None:
            shape = (self.world_size(),)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        if math.prod(self.shape.values()) != self.world_size():
            raise ValueError("mesh shape %s does not hold %d replicas"
                             % (tuple(self.shape.values()),
                                self.world_size()))

    def world_size(self) -> int:
        if self.process_group is None:
            return len(self.places)
        import torch.distributed as dist

        group = (None if self.process_group == "world"
                 else self.process_group)
        return dist.get_world_size(group)

    def coords(self, r: int) -> Dict[str, int]:
        """Replica ``r``'s coordinate on every axis."""
        out = {}
        for name in reversed(self.axis_names):
            size = self.shape[name]
            out[name] = r % size
            r //= size
        return {a: out[a] for a in self.axis_names}

    def axis_groups(self, axes: Sequence[str],
                    members: Optional[Sequence[int]] = None
                    ) -> List[List[int]]:
        """The subgroups of ``axes`` among ``members`` (default: every
        replica): replicas that agree on every other axis, each subgroup
        in rank order, the subgroups in the order of their first rank."""
        axes = set(axes)
        groups: Dict[Tuple, List[int]] = {}
        for r in (range(self.world_size()) if members is None
                  else members):
            c = self.coords(r)
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            groups.setdefault(key, []).append(r)
        return list(groups.values())

    @property
    def devices(self):
        return [p.device() for p in self.places]

    @property
    def spans_processes(self) -> bool:
        return self.process_group is not None

    def __repr__(self):
        return "Mesh(%s, axes=%s%s)" % (
            self.places, self.shape,
            ", process group" if self.spans_processes else "")


def _world():
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              places: Optional[Sequence[Place]] = None) -> Mesh:
    """A mesh of ``prod(axis_sizes)`` replicas over ``places`` (the first
    ones; default: ``default_places()``, each repeated if need be)."""
    n = math.prod(axis_sizes)
    places = list(places) if places is not None else default_places()
    if len(places) < n:
        if places and all(p == places[0] for p in places):
            places = [places[0]] * n  # one place named n times
        else:
            raise ValueError("mesh wants %d places, only %d given"
                             % (n, len(places)))
    return Mesh(places[:n], axis_names, axis_sizes)


def default_places():
    """One place a visible card (the card is the default: on a host
    without one, ``CUDAPlace(0)``, which raises when it is used)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [CUDAPlace(i) for i in range(max(n, 1))]


def default_mesh(num_devices: Optional[int] = None, axis_name: str = "dp",
                 place: Optional[Place] = None) -> Mesh:
    """Over a ``torch.distributed`` world of more than one process: one
    replica a process, on ``place`` (default: the card of its local
    rank). Else one replica a visible card (``num_devices`` of them, a
    card named again where there are fewer), or ``[place]``."""
    if _world():
        import os

        import torch.distributed as dist

        if place is None:
            local = int(os.environ.get("FLAGS_selected_gpus",
                                       os.environ.get("LOCAL_RANK", "0")))
            cards = torch.cuda.device_count() \
                if torch.cuda.is_available() else 1
            place = CUDAPlace(local % max(cards, 1))
        n = dist.get_world_size()
        if num_devices not in (None, n):
            raise ValueError("a mesh over the process world has %d "
                             "replicas, not %d" % (n, num_devices))
        return Mesh([place], [axis_name], [n], process_group="world")
    places = [place] if place is not None else default_places()
    n = num_devices or len(places)
    return make_mesh([n], [axis_name], places)


def mesh_key(mesh: Mesh) -> Tuple:
    """Stable mesh identity for cache keys."""
    return (tuple((p.kind, p._device_id) for p in mesh.places),
            mesh.axis_names, tuple(mesh.shape.values()),
            mesh.spans_processes)
