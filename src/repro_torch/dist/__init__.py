"""repro_torch.dist — the sharding subsystem (the reference's
``repro.dist``).

* ``sharding`` — the logical-axis rules tables (pure functions).
* ``specs``    — per-leaf specs of the trees the prune path shards: input
  batches and the calibration accumulator.
* ``groups``   — process groups over a mesh's axes and the collectives
  the prune path runs on them.

A spec is a tuple with one entry per dimension: ``None`` (replicated), an
axis name, or a tuple of axis names — the entries of the reference's
``PartitionSpec``.
"""
from . import groups, sharding, specs

__all__ = ["groups", "sharding", "specs"]
