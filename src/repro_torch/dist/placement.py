"""A tree held sharded by its specs: each rank's block of every leaf.

The reference gets this from GSPMD (``jax.device_put`` onto a
``NamedSharding``); the port does it explicitly. A spec
(``dist.specs``) names, per dim, nothing (the dim is whole on every
rank), an axis, or a tuple of axes; the dim then splits into as many
equal blocks as those axes have ranks, and a rank holds the block at its
linear index along them (``idx = idx * size(ax) + coord(ax)``, the
order ``groups.Group.all_gather`` returns parts in). That is the
reference's index order, so a gathered leaf is the reference's array.

* ``shard`` — this rank's block of every leaf (a copy; a leaf whose
  spec splits nothing stays the tensor it was);
* ``gather`` — every leaf whole again, by one all-gather a split dim;
* ``block_index`` / ``writes_block`` — where a rank's block sits in its
  leaf, and whether this rank is the one that writes it to a checkpoint
  (coordinate 0 on every axis the spec does not split over, so each
  block, a replicated leaf included, is written once);
* ``bytes_per_rank`` — the reckoning of one rank's bytes of a tree (its
  leaves may live on the meta device);
* ``Layout`` — a spec tree with its mesh, what ``ckpt.save`` /
  ``ckpt.restore_like`` take as ``shardings``;
* ``all_values`` / ``agree`` — a few floats from every rank, and
  whether a flag holds on every rank of the mesh.

The specs' dims must divide (``leaf_pspec`` and ``batch_pspecs`` only
split dims that do).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import groups as groups_lib
from .specs import tree_map


@dataclasses.dataclass(frozen=True)
class Layout:
    """A spec tree (the structure of the tree it places) and its mesh."""

    specs: object
    mesh: object


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree (dicts and
    NamedTuples; a spec is a tuple, a leaf anything else)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, v, sp)
                            for v, sp in zip(tree, specs)))
    return None if tree is None else fn(tree, specs)


def block_index(shape, spec, mesh, rank: int | None = None
                ) -> tuple[slice, ...]:
    """The slices of ``rank``'s block (default: this process's) in a leaf
    of ``shape``."""
    sizes = groups_lib.axis_sizes(mesh)
    co = groups_lib.coords(mesh, rank)
    out = []
    for dim, entry in zip(shape, spec):
        axes = _axes(entry)
        n, idx = 1, 0
        for a in axes:
            n *= sizes[a]
            idx = idx * sizes[a] + co[a]
        b = dim // n
        out.append(slice(idx * b, (idx + 1) * b))
    return tuple(out)


def writes_block(spec, mesh, rank: int | None = None) -> bool:
    """True on the one rank of each block's holders that writes it: the
    one at coordinate 0 along every axis the spec does not split over."""
    used = {a for entry in spec for a in _axes(entry)}
    co = groups_lib.coords(mesh, rank)
    return all(c == 0 for a, c in co.items() if a not in used)


def split_counts(spec, mesh) -> list[int]:
    """Per dim, the number of blocks ``spec`` splits it into."""
    sizes = groups_lib.axis_sizes(mesh)
    return [math.prod(sizes[a] for a in _axes(entry)) for entry in spec]


def _splits(spec, mesh) -> bool:
    return math.prod(split_counts(spec, mesh)) > 1


def shard(tree, specs, mesh):
    """This rank's block of every leaf of ``tree``."""
    def one(x, spec):
        if not _splits(spec, mesh):
            return x
        return x[block_index(x.shape, spec, mesh)].contiguous()

    return _zip_map(one, tree, specs)


def gather(tree, specs, mesh):
    """Every leaf of a sharded ``tree`` whole, in the reference's index
    order (collective: every rank of the mesh calls it with the same
    specs)."""
    sizes = groups_lib.axis_sizes(mesh)

    def one(x, spec):
        for dim, entry in enumerate(spec):
            axes = _axes(entry)
            if math.prod(sizes[a] for a in axes) > 1:
                parts = groups_lib.axis_group(mesh, axes).all_gather(x)
                x = torch.cat(list(parts), dim=dim)
        return x

    return _zip_map(one, tree, specs)


def bytes_per_rank(tree, specs, mesh) -> int:
    """One rank's bytes of ``tree`` held by ``specs`` (every rank's are
    equal: the blocks of a leaf are)."""
    total = [0]

    def one(x, spec):
        n = math.prod(split_counts(spec, mesh))
        total[0] += math.prod(x.shape) // n * x.element_size()

    _zip_map(one, tree, specs)
    return total[0]


def like(tree):
    """A tree of meta tensors with ``tree``'s shapes and dtypes."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), tree)


def all_values(values, mesh) -> torch.Tensor:
    """(ranks, len(values)) float64 on the host: every rank's ``values``,
    in rank order (one all-gather over the whole mesh)."""
    grp = groups_lib.axis_group(mesh, groups_lib.all_axes(mesh))
    dev = "cuda" if getattr(mesh, "device_type", "cpu") == "cuda" else "cpu"
    return grp.all_gather(torch.tensor([float(v) for v in values],
                                       dtype=torch.float64,
                                       device=dev)).cpu()


def agree(flag: bool, mesh) -> bool:
    """Whether ``flag`` holds on every rank of the mesh."""
    return bool(all_values([bool(flag)], mesh).min() > 0)
