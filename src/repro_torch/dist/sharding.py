"""Logical-axis sharding rules (the reference's ``repro.dist.sharding``).

Model code in the reference names its activation dims with logical axes
(``batch``, ``seq``, ``heads``, ``kv_heads``, ``mlp``, ``expert``,
``vocab``) and a launcher decides what those names mean on the mesh:

    rules = standard_rules(multi_pod=True, kv_shardable=True)
    with use_rules(rules, mesh):
        ...

``logical_pspec`` resolves names to a spec for a concrete shape. The
reference's ``constrain`` (an XLA layout hint inside a traced step) has no
counterpart in eager PyTorch and is not ported: the port shards
explicitly where the reference runs ``shard_map``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Mapping, Sequence

# logical axis name -> mesh axes (tuple) or None (replicated)
Rules = Mapping[str, tuple[str, ...] | None]

# innermost-last stack of (rules, mesh): rule scopes are nested context
# managers, never concurrent
_ACTIVE: list[tuple[dict, object]] = []


def standard_rules(*, multi_pod: bool = False, kv_shardable: bool = False,
                   moe_parallelism: str = "tp",
                   seq_parallel: bool = True) -> dict:
    """The production rules table (mesh semantics in ``launch.mesh``):
    batch over every data-parallel axis; "seq" on "model" under sequence
    parallelism; heads tensor-parallel, KV heads only when their count
    divides the model axis; MoE "tp" shards the expert FFN dim, "ep" the
    expert axis, "local" neither."""
    return {
        "batch": ("pod", "data") if multi_pod else ("data",),
        "seq": ("model",) if seq_parallel else None,
        "heads": ("model",),
        "kv_heads": ("model",) if kv_shardable else None,
        "mlp": ("model",) if moe_parallelism == "tp" else None,
        "expert": ("model",) if moe_parallelism == "ep" else None,
        "vocab": ("model",),
    }


@contextlib.contextmanager
def use_rules(rules: Rules, mesh):
    """Install ``rules`` on ``mesh`` for the dynamic extent of the block."""
    _ACTIVE.append((dict(rules), mesh))
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_rules() -> tuple[dict, object] | None:
    """The innermost installed (rules, mesh), or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def logical_pspec(shape: Sequence[int], logical_axes: Sequence[str | None],
                  rules: Rules, mesh_shape: Mapping[str, int]
                  ) -> tuple | None:
    """Resolve logical names to a spec for a concrete shape; None when
    every dim resolves to replicated.

    A name maps to nothing when its rule is None, names an axis the mesh
    lacks or one an earlier dim already took, or when the dim does not
    divide the mapped axes' total size."""
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {tuple(shape)} vs axes {tuple(logical_axes)}")
    used: set[str] = set()
    entries: list = []
    for dim, name in zip(shape, logical_axes):
        axes = rules.get(name) if name is not None else None
        if axes is None:
            entries.append(None)
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        ok = (all(a in mesh_shape and a not in used for a in axes)
              and dim % math.prod(mesh_shape[a] for a in axes) == 0)
        if not ok:
            entries.append(None)
            continue
        used.update(axes)
        entries.append(axes[0] if len(axes) == 1 else axes)
    return tuple(entries) if used else None
