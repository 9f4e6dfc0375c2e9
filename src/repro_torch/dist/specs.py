"""Per-leaf specs of the trees the port shards (the reference's
``repro.dist.specs``, the parts the prune, train and recover paths read).

* weights and train states — "model" on a leaf's largest dim, "data"
  (FSDP) on its second, each where it divides; vectors and scalars
  replicate (``leaf_pspec``, ``param_pspecs``, ``state_pspecs``);
* batches — the leading (batch) dim over the data-parallel axes;
* calibration accumulators — replicated over the data axes (each rank
  folds in its batch shard and the partials merge by ``psum_gram``), the
  O(d²) Gram leaves (square trailing dims) column-sharded over "model"
  where it divides.

Each function reads only the mesh's axis sizes (``groups.axis_sizes``),
so a mapping ``{"data": 8}`` stands in for a mesh. Trees are nested dicts
and NamedTuples whose leaves have a ``.shape`` (None an empty subtree); a
spec is a tuple with one entry per dim: None, an axis name, or a tuple of
names. ``dist.placement`` holds a tree sharded by its specs. The
decode-cache and page-pool specs and ``mesh_slices`` belong to serving on
a mesh (ROADMAP A5).
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Sequence

from .groups import axis_sizes


def _dp_axes(mesh_shape: Mapping[str, int]) -> tuple[str, ...]:
    """The data-parallel axes, outermost first ("pod" crosses hosts)."""
    return tuple(a for a in ("pod", "data") if a in mesh_shape)


def _axes_size(mesh_shape: Mapping[str, int], axes: Sequence[str]) -> int:
    return math.prod(mesh_shape[a] for a in axes)


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts and NamedTuples (None stays
    None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    return None if tree is None else fn(tree)


def leaf_pspec(path, shape, cfg, mesh, *, fsdp: bool = True) -> tuple:
    """Weight-leaf spec: "model" on the largest dim, "data" on the second,
    each only where it divides (a dim that does not replicates); ties keep
    the dims' order, so a square (d, d) weight gets ("model", "data").
    Vectors and scalars replicate. ``path`` and ``cfg`` are the
    reference's hooks for rules by name; the rule reads shapes only."""
    del path, cfg
    ms = axis_sizes(mesh)
    shape = tuple(shape)
    assign: list = [None] * len(shape)
    if len(shape) < 2:
        return tuple(assign)
    order = sorted(range(len(shape)), key=lambda i: shape[i], reverse=True)
    i_tp, i_dp = order[0], order[1]
    if "model" in ms and shape[i_tp] % ms["model"] == 0:
        assign[i_tp] = "model"
    if fsdp and "data" in ms and shape[i_dp] % ms["data"] == 0:
        assign[i_dp] = "data"
    return tuple(assign)


def param_pspecs(cfg, params, mesh, *, fsdp: bool = True):
    """Spec tree matching ``params`` leaf for leaf."""
    return tree_map(lambda x: leaf_pspec(None, x.shape, cfg, mesh,
                                         fsdp=fsdp), params)


def state_pspecs(cfg, state, mesh, *, fsdp: bool = True):
    """Spec tree of a TrainState (params, AdamW m and v, step): the
    moments mirror the params' shapes, so the weight rule applies to
    every leaf; the step counter replicates."""
    return param_pspecs(cfg, state, mesh, fsdp=fsdp)


def batch_pspecs(cfg, batch: Any, mesh) -> Any:
    """Input-batch specs: leading dim over the DP axes, rest replicated."""
    del cfg
    ms = axis_sizes(mesh)
    dp = _dp_axes(ms)
    dp_size = _axes_size(ms, dp) if dp else 0

    def leaf(x) -> tuple:
        shape = tuple(x.shape)
        if not shape or not dp or shape[0] % dp_size:
            return (None,) * len(shape)
        return (dp if len(dp) > 1 else dp[0],) + (None,) * (len(shape) - 1)

    return tree_map(leaf, batch)


def calib_pspecs(state: Any, mesh) -> Any:
    """Specs of a calibration accumulator tree (``pruning.stats``): Gram
    leaves (square trailing dims) column-shard over "model" when it
    divides; everything else replicates. G is symmetric, so a column shard
    serves every consumer a row shard would."""
    model = axis_sizes(mesh).get("model", 1)

    def leaf(x) -> tuple:
        shape = tuple(x.shape)
        if (model > 1 and len(shape) >= 2 and shape[-1] == shape[-2]
                and shape[-1] % model == 0):
            return (None,) * (len(shape) - 1) + ("model",)
        return (None,) * len(shape)

    return tree_map(leaf, state)
