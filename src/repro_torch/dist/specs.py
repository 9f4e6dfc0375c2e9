"""Per-leaf specs of the trees the prune path shards (the reference's
``repro.dist.specs``, the part the prune path reads).

* batches — the leading (batch) dim over the data-parallel axes;
* calibration accumulators — replicated over the data axes (each rank
  folds in its batch shard and the partials merge by ``psum_gram``), the
  O(d²) Gram leaves (square trailing dims) column-sharded over "model"
  where it divides.

Each function reads only the mesh's axis sizes (``groups.axis_sizes``),
so a mapping ``{"data": 8}`` stands in for a mesh. Trees are nested dicts
whose leaves have a ``.shape``; a spec is a tuple with one entry per dim.
The weight, train-state, decode-cache and page-pool specs and
``mesh_slices`` belong to training and serving on a mesh (ROADMAP A5).
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


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


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

    return _tree_map(leaf, batch)


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

    return _tree_map(leaf, state)
