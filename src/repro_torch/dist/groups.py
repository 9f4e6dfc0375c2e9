"""Process groups over a mesh's named axes, and the collectives on them.

A mesh (``launch.mesh``) is a ``torch.distributed`` ``DeviceMesh`` whose
ranks are laid out row-major over its axes (rank r sits at
``numpy.unravel_index(r, shape)``). ``build_mesh`` makes the process
groups of each axis (the ``DeviceMesh``'s own) and of the whole mesh,
each with a timeout; any other set of axes (``("pod", "data")``) gets its
groups the first time ``axis_group`` asks for it. The groups live on the
mesh object itself. ``dist.new_group`` is collective over the world, so
every rank creates every line's group, and every rank asks for the same
sets in the same order: the prune path is SPMD (every rank runs the same
calibration, refiners and barriers).

A ``Group`` orders its members by their linear index along the axes in
the order they were asked for (``idx = idx * size(ax) + coord(ax)``, as
the reference's ``shard_map`` bodies count), and its ``all_gather``
returns the parts in that order.

Collectives on a gloo group move a CUDA tensor to the host and back,
explicitly: two ranks on one card cannot share NCCL (it refuses two ranks
on one device), so they run gloo, and staging through the host is the
path the code states rather than one a failure would select.

Spec helpers read a mesh's axis sizes only (``axis_sizes``), so a plain
mapping ``{"data": 4, "model": 2}`` stands in for a mesh wherever no
collective runs (plans, specs).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

# every group's timeout: a rank lost in a collective fails the run
TIMEOUT = datetime.timedelta(seconds=120)

# the mesh attribute that holds its groups:
# {frozenset of axes: (this rank's process group, its ranks, ascending)}
_GROUPS = "_repro_axis_groups"


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping stand-in."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"a mesh is a named DeviceMesh (launch.mesh) or a "
                        f"mapping of axis sizes, not {type(mesh).__name__}")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def mesh_size(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


def _norm_axes(mesh, axes) -> tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = tuple(axis_sizes(mesh))
    bad = [a for a in axes if a not in names]
    if bad or len(set(axes)) != len(axes) or not axes:
        raise ValueError(f"axes {axes} are not distinct axes of the mesh "
                         f"{names}")
    return axes


def _line_groups(ranks: np.ndarray, dims: tuple[int, ...]):
    """A process group (``TIMEOUT``) for every line of ``ranks`` along
    ``dims``, made on every rank; this rank's (group, members)."""
    rest = [i for i in range(ranks.ndim) if i not in dims]
    lines = np.moveaxis(ranks, rest + list(dims), range(ranks.ndim))
    lines = lines.reshape(-1, math.prod(ranks.shape[i] for i in dims))
    me, mine = dist.get_rank(), None
    for line in lines:                   # every rank creates every group
        members = tuple(sorted(int(r) for r in line))
        pg = dist.new_group(list(members), timeout=TIMEOUT)
        if me in members:
            mine = (pg, members)
    return mine


def build_mesh(shape: tuple[int, ...], names: tuple[str, ...], *,
               device_type: str):
    """A ``DeviceMesh`` of ``shape`` over the initialised world, with the
    process groups of each axis and of the whole mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialised process group: call "
            "launch.mesh.init_distributed first (under torchrun, or with a "
            "file:// store)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    ranks = np.arange(world).reshape(shape)
    groups = {frozenset((name,)): _line_groups(ranks, (i,))
              for i, name in enumerate(names)}
    groups.setdefault(frozenset(names),
                      _line_groups(ranks, tuple(range(len(shape)))))
    mesh = DeviceMesh.from_group(
        [groups[frozenset((name,))][0] for name in names], device_type,
        mesh=torch.as_tensor(ranks, dtype=torch.int),
        mesh_dim_names=tuple(names))
    setattr(mesh, _GROUPS, groups)
    return mesh


@dataclasses.dataclass(frozen=True)
class Group:
    """This rank's process group along some axes of a mesh.

    ``order[i]`` is the group rank of the member at linear index i along
    the axes; ``index`` is this rank's linear index; ``size`` the member
    count."""

    pg: object
    order: tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.order)

    def _staged(self, x: torch.Tensor) -> bool:
        return x.is_cuda and dist.get_backend(self.pg) == "gloo"

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every member's ``x``, in linear-index order."""
        host = self._staged(x)
        t = (x.cpu() if host else x).contiguous()
        parts = [torch.empty_like(t) for _ in self.order]
        dist.all_gather(parts, t, group=self.pg)
        out = torch.stack([parts[j] for j in self.order])
        return out.to(x.device) if host else out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The members' elementwise sum of ``x`` (a new tensor)."""
        host = self._staged(x)
        t = x.cpu().contiguous() if host else x.clone().contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.pg)
        return t.to(x.device) if host else t

    def barrier(self) -> None:
        dist.barrier(group=self.pg)


def axis_group(mesh, axes) -> Group:
    """This rank's ``Group`` along ``axes`` (a name or a tuple of names, in
    the order their linear index counts)."""
    axes = _norm_axes(mesh, axes)
    made = getattr(mesh, _GROUPS, None)
    if made is None:
        raise ValueError("the mesh was not made by launch.mesh (its groups "
                         "are unknown)")
    sizes = axis_sizes(mesh)
    shape = tuple(sizes.values())
    pos = {a: i for i, a in enumerate(sizes)}
    key = frozenset(axes)
    if key not in made:                  # collective: every rank asks
        made[key] = _line_groups(np.arange(math.prod(shape)).reshape(shape),
                                 tuple(sorted(pos[a] for a in axes)))
    pg, members = made[key]

    def linear(rank: int) -> int:
        coord = np.unravel_index(rank, shape)
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + int(coord[pos[a]])
        return idx

    lin = [linear(r) for r in members]          # members in group-rank order
    order = tuple(int(j) for j in np.argsort(lin))
    return Group(pg=pg, order=order, index=linear(dist.get_rank()))


def coords(mesh, rank: int | None = None) -> dict[str, int]:
    """{axis: coordinate} of ``rank`` (default: this process's) on the
    row-major mesh."""
    sizes = axis_sizes(mesh)
    rank = dist.get_rank() if rank is None else rank
    return dict(zip(sizes, (int(c) for c in np.unravel_index(
        rank, tuple(sizes.values())))))


def all_axes(mesh) -> tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def is_main(mesh=None) -> bool:
    """True on the rank that writes and prints: rank 0 of the world, or the
    only process when there is no mesh."""
    return mesh is None or dist.get_rank() == 0
