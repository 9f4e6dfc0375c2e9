"""Streaming, recipe-aware, mesh-sharded calibration statistics.

The refinement needs only G = XᵀX "accumulated on-the-fly as calibration
samples pass through the layer" (paper §2.1.2), and different methods
need different statistics: sparseswaps/sparsegpt the full Gram, Wanda/RIA
warmstarts its diagonal, DSnoT only feature means and variances. This
module plans, accumulates and checkpoints exactly that state:

* ``CalibSpec`` — derived from a resolved plan: per tap, which level of
  statistics to accumulate ("gram" | "moments" | "none"). Skip-rule sites
  accumulate nothing; dsnot-only sites pay O(d) instead of O(d²).
* ``CalibStats`` — the accumulated state: the model-structured tap tree of
  raw additive moments (fp32, on the device).
* ``accumulate_stats`` — one forward per batch; the first batch's taps
  become the accumulator and later batches add into it in place (the
  reference's donated carry starts from zeros: 0 + x == x, so the sums
  agree bit for bit). Gram contributions go through
  ``kernels.ops.gram_xtx``: the CUDA kernel for activations on the card,
  its plain version on the CPU.
* ``mesh=``: a batch whose leaves' leading dims divide the data-parallel
  size splits over the data axes; each rank runs the forward on its shard
  and the partial statistics merge by ``core.gram.psum_gram``. A batch
  that does not split is accumulated whole on every rank (with a
  warning). The Gram leaves follow ``dist.specs.calib_pspecs``: each rank
  keeps its column block over "model". ``CalibStats.gram_block`` hands
  a Gram-sharded group that block as it is (the refiner's columns are
  "model"'s, ``distributed.gram_split``); ``entry`` / ``full_taps``
  gather the whole G for the rows-sharded groups.
* checkpoint/resume under ``ckpt_dir`` in the reference's format, keyed by
  the spec fingerprint, so a resumed job never mixes statistics from a
  different recipe. On a mesh rank 0 writes the whole state and every
  rank reads it on resume.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import warnings
from pathlib import Path

import torch

from repro_torch import ckpt
from repro_torch.core import gram as gram_lib
from repro_torch.dist import groups as groups_lib
from repro_torch.dist import specs as specs_lib
from repro_torch.kernels import ops
from repro_torch.models import ModelApi
from repro_torch.models import common as common_lib

from . import distributed
from . import sites as sites_lib

LEVELS = ("none", "moments", "gram")
_RANK = {lvl: i for i, lvl in enumerate(LEVELS)}
_FIELDS = {"none": (), "moments": ("d", "s", "n"), "gram": ("g", "s", "n")}


def required_level(rule) -> str:
    """The statistics a resolved site rule needs: nothing for a skip,
    feature moments for dsnot, the full Gram for everything else."""
    if rule.skip:
        return "none"
    if rule.method == "dsnot":
        return "moments"
    return "gram"


def _max_level(a: str, b: str) -> str:
    return a if _RANK[a] >= _RANK[b] else b


@dataclasses.dataclass(frozen=True)
class CalibSpec:
    """Which statistics calibration accumulates, per emitted tap name;
    omitted taps default to "none" (never emitted)."""

    levels: tuple[tuple[str, str], ...]

    def __post_init__(self):
        bad = [lvl for _, lvl in self.levels if lvl not in LEVELS]
        if bad:
            raise ValueError(f"unknown levels {bad}; have {LEVELS}")
        object.__setattr__(self, "levels",
                           tuple(sorted(dict(self.levels).items())))

    @classmethod
    def full(cls, cfg) -> "CalibSpec":
        """Every tap at gram level."""
        names = {sites_lib._emission_name(tpath)
                 for _, _, tpath, _ in sites_lib._table(cfg)}
        return cls(levels=tuple((n, "gram") for n in sorted(names)))

    @classmethod
    def from_plan(cls, cfg, plan, *, minimal: bool = True) -> "CalibSpec":
        """The per-tap levels a resolved ``PrunePlan`` needs: per tap, the
        max over the site groups it feeds. ``minimal=False`` promotes every
        non-skipped tap to gram level (skip-aware, exact dsnot losses);
        ``minimal=True`` drops dsnot-only taps to moments."""
        by_site = {g.spec.name: required_level(g.rule) for g in plan.groups}
        if not minimal:
            by_site = {k: ("none" if v == "none" else "gram")
                       for k, v in by_site.items()}
        levels: dict[str, str] = {}
        for tap in sites_lib.tap_specs(cfg, [g.spec for g in plan.groups]):
            lvl = "none"
            for site in tap.sites:
                lvl = _max_level(lvl, by_site.get(site, "none"))
            levels[tap.name] = _max_level(levels.get(tap.name, "none"), lvl)
        return cls(levels=tuple(levels.items()))

    def level(self, name: str) -> str:
        return dict(self.levels).get(name, "none")

    def covers(self, other: "CalibSpec") -> bool:
        """True when stats under this spec satisfy ``other``'s needs."""
        mine = dict(self.levels)
        return all(_RANK[mine.get(n, "none")] >= _RANK[lvl]
                   for n, lvl in other.levels)

    def fingerprint(self) -> str:
        """Content hash for checkpoint keying (the reference's)."""
        return hashlib.sha256(
            json.dumps(self.levels).encode()).hexdigest()[:16]

    def policy(self) -> common_lib.TapPolicy:
        return _SpecTapPolicy(self)


class _SpecTapPolicy(common_lib.TapPolicy):
    """TapPolicy driven by a CalibSpec; Grams go through the kernel wrapper."""

    def __init__(self, spec: CalibSpec):
        self._levels = dict(spec.levels)

    def fields(self, name: str) -> tuple[str, ...]:
        return _FIELDS[self._levels.get(name, "none")]

    def gram(self, x2: torch.Tensor) -> torch.Tensor:
        return ops.gram_xtx(x2)

    def gram_experts(self, x3: torch.Tensor) -> torch.Tensor:
        return ops.gram_xtx_stacked(x3)


@dataclasses.dataclass
class CalibStats:
    """Accumulated calibration statistics: the model-structured tap tree
    of raw additive moments (absent keys for skipped taps, "d" in place of
    "g" at the moments level), and the number of batches folded in.

    On a mesh with a "model" axis, ``col_specs`` (``calib_pspecs`` of the
    whole tree) marks the leaves whose columns ``model`` splits: ``taps``
    then holds this rank's column block of them."""

    taps: dict
    spec: CalibSpec
    batches: int = 0
    model: groups_lib.Group | None = None
    col_specs: dict | None = None

    def tap_bytes(self) -> int:
        """Accumulator footprint in bytes (this rank's, on a mesh)."""
        return sum(leaf.numel() * leaf.element_size()
                   for _, leaf in _flatten(self.taps))

    def entry(self, path: tuple[str, ...]) -> dict:
        """One tap entry {g|d, s, n}, its Gram whole."""
        ent, specs = self.taps, self.col_specs
        for k in path:
            ent = ent[k]
            specs = specs[k] if specs is not None else None
        return ent if self.model is None else _whole(ent, specs, self.model)

    def gram_block(self, path: tuple[str, ...], mesh) -> dict:
        """One tap entry {g, s, n} with its Gram cut to this rank's
        column block over the Gram-sharded refiner's column axes
        (``distributed.gram_split``): the calibration shard over "model"
        as it is, or a slice of a Gram calibration kept whole. G is never
        gathered."""
        ent, specs = self.taps, self.col_specs
        for k in path:
            ent = ent[k]
            specs = specs[k] if specs is not None else None
        return gram_block(ent, specs, mesh)

    def full_taps(self) -> dict:
        """The whole tap tree (every column block gathered)."""
        if self.model is None:
            return self.taps
        return _whole(self.taps, self.col_specs, self.model)

    def gram_state(self, path: tuple[str, ...]) -> gram_lib.GramState:
        """One tap entry as a ``core.gram.GramState`` (stacked dims kept)."""
        ent = self.entry(path)
        g = ent["g"] if "g" in ent else ent["d"]
        return gram_lib.state_from_moments(g, ent["s"], ent["n"])


def _flatten(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _flatten(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def _add_into(acc: dict, new: dict) -> None:
    for k, v in new.items():
        if isinstance(v, dict):
            _add_into(acc[k], v)
        else:
            acc[k] += v


def _is_entry(node) -> bool:
    return isinstance(node, dict) and "n" in node and not isinstance(
        node["n"], dict)


def _map_entries(tree: dict, fn) -> dict:
    """``fn(entry)`` for every {g|d, s, n} entry of a tap tree."""
    if _is_entry(tree):
        return fn(tree)
    return {k: _map_entries(v, fn) for k, v in tree.items()}


def _psum_taps(taps: dict, data: groups_lib.Group) -> dict:
    """Merge every entry's per-rank partial moments over the data group."""

    def merge(ent):
        key = "g" if "g" in ent else "d"
        st = gram_lib.psum_gram(
            gram_lib.state_from_moments(ent[key], ent["s"], ent["n"]), data)
        g, s_, n = gram_lib.moments_from_state(st)
        return {key: g, "s": s_, "n": n.to(ent["n"].dtype)}

    return _map_entries(taps, merge)


def _cols(tree, specs, grp: groups_lib.Group):
    """This rank's column block of every leaf ``specs`` shards over
    "model" (a copy, so the whole leaf can be freed)."""
    if isinstance(tree, dict):
        return {k: _cols(v, specs[k], grp) for k, v in tree.items()}
    if specs[-1:] != ("model",):
        return tree
    n = tree.shape[-1] // grp.size
    return tree[..., grp.index * n:(grp.index + 1) * n].contiguous()


def _whole(tree, specs, grp: groups_lib.Group):
    """Inverse of ``_cols``: all-gather the column blocks over "model"."""
    if isinstance(tree, dict):
        return {k: _whole(v, specs[k], grp) for k, v in tree.items()}
    if specs[-1:] != ("model",):
        return tree
    parts = grp.all_gather(tree)                   # (P, ..., d, cols)
    return torch.cat(list(parts), dim=-1)


def gram_block(ent: dict, specs, mesh) -> dict:
    """``CalibStats.gram_block`` of one entry (``specs``: its
    ``calib_pspecs``, None for an entry held whole on every rank)."""
    _, col_axes = distributed.gram_split(mesh)
    g = ent["g"]
    if specs is not None and specs["g"][-1:] == ("model",):
        if col_axes != ("model",):
            raise ValueError(f"a Gram split over 'model' cannot serve the "
                             f"column axes {col_axes}")
        block = g                                  # the calibration shard
    else:
        block = distributed.column_block(
            g, groups_lib.axis_group(mesh, col_axes)).contiguous()
    return {"g": block, "s": ent["s"], "n": ent["n"]}


def _shard_batch(batch, data: groups_lib.Group):
    """This rank's slice of every leaf's leading dim."""
    if isinstance(batch, dict):
        return {k: _shard_batch(v, data) for k, v in batch.items()}
    n = batch.shape[0] // data.size
    return batch[data.index * n:(data.index + 1) * n]


def batch_shardable(batch: dict, mesh) -> bool:
    """True iff every batch leaf's leading dim splits over the DP axes
    (and there is more than one data-parallel rank to split over)."""
    n = _dp_size(mesh)
    return n > 1 and all(leaf.ndim and leaf.shape[0] % n == 0
                         for _, leaf in _flatten(batch))


def _dp_size(mesh) -> int:
    sizes = groups_lib.axis_sizes(mesh)
    return specs_lib._axes_size(sizes, specs_lib._dp_axes(sizes))


def _expected_leaves(api: ModelApi, params, spec: CalibSpec) -> dict:
    """{leaf path: shape} of the tap tree ``spec`` accumulates: each
    field stacked on its sites' stack dims ((L,), or (L, E) for an MoE
    tap)."""
    specs = sites_lib.site_specs(api.cfg, params)
    stack = {s.name: list(s.stack_shape) for s in specs}
    out = {}
    for tap in sites_lib.tap_specs(api.cfg, specs):
        lvl = spec.level(tap.name)
        name = "/".join(tap.path)
        lead, d = stack[tap.sites[0]], tap.d_in
        for f in _FIELDS[lvl]:
            out[f"{name}/{f}"] = lead + {"g": [d, d], "d": [d], "s": [d],
                                         "n": []}[f]
    return out


def _try_resume(ckpt_dir: Path, spec: CalibSpec, expected: dict, device):
    """(start batch, taps) of the newest checkpoint under ``ckpt_dir`` that
    matches ``spec`` and the tap shapes; (0, None) otherwise."""
    found = ckpt.restore_latest(ckpt_dir)
    if found is None:
        return 0, None
    step, flat, man = found
    if (man.get("extra", {}).get("calib_spec") != spec.fingerprint()
            or {k: list(v.shape) for k, v in flat.items()} != expected):
        return 0, None
    return step, ckpt.unflatten(flat, device)


def _device_of(params) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


@torch.no_grad()
def accumulate_stats(api: ModelApi, params, batches, *,
                     spec: CalibSpec | None = None, mesh=None,
                     ckpt_dir=None, checkpoint_every: int = 0) -> CalibStats:
    """Stream calibration batches into a ``CalibStats`` accumulator.

    ``mesh``: a ``launch.mesh`` mesh; batches split over its data axes
    where they divide, and Gram columns over "model" (see the module
    docstring). ``ckpt_dir`` + ``checkpoint_every``: persist the
    accumulator every k batches and resume a matching interrupted run,
    keyed by the spec fingerprint (a different recipe recomputes).
    """
    data = model = None
    if mesh is not None:
        sizes = groups_lib.axis_sizes(mesh)
        data = groups_lib.axis_group(mesh, specs_lib._dp_axes(sizes))
        if sizes.get("model", 1) > 1:
            model = groups_lib.axis_group(mesh, "model")
    spec = spec if spec is not None else CalibSpec.full(api.cfg)
    policy = spec.policy()
    start, total, col_specs = 0, None, None
    if ckpt_dir is not None:
        ckpt_dir = Path(ckpt_dir)
        start, total = _try_resume(ckpt_dir, spec,
                                   _expected_leaves(api, params, spec),
                                   _device_of(params))
        if total is not None and model is not None:
            col_specs = specs_lib.calib_pspecs(total, mesh)
            total = _cols(total, col_specs, model)
    done, warned = start, False
    for i, batch in enumerate(batches):
        if i < start:
            continue
        split = mesh is not None and batch_shardable(batch, mesh)
        if mesh is not None and not split and data.size > 1 and not warned:
            # said, not silent: data parallelism was there but the batch
            # does not split over it
            warnings.warn(
                "calibration batches not sharded: leading dims do not "
                f"divide the data-parallel axes ({sizes}); accumulating "
                "each batch whole")
            warned = True
        _, aux = api.loss(params, _shard_batch(batch, data) if split
                          else batch, masks=None, want_taps=True,
                          tap_policy=policy)
        taps = aux["taps"]
        # the batch's taps are not held through the next batch's forward:
        # the peak is the accumulator and one batch's taps
        del aux
        if split:
            taps = _psum_taps(taps, data)
        if model is not None:
            col_specs = col_specs or specs_lib.calib_pspecs(taps, mesh)
            taps = _cols(taps, col_specs, model)
        if total is None:
            total = taps
        else:
            _add_into(total, taps)
        del taps
        done = i + 1
        if (ckpt_dir is not None and checkpoint_every
                and done % checkpoint_every == 0):
            whole = (total if model is None
                     else _whole(total, col_specs, model))
            if groups_lib.is_main(mesh):
                ckpt.save(ckpt_dir, done, whole,
                          extra={"calib_spec": spec.fingerprint()})
                ckpt.gc(ckpt_dir, keep=1)
            if mesh is not None:
                groups_lib.axis_group(
                    mesh, groups_lib.all_axes(mesh)).barrier()
    if done == 0:
        raise ValueError("no calibration batches provided")
    return CalibStats(taps=total, spec=spec, batches=done, model=model,
                      col_specs=col_specs)
