"""Plan execution: calibrate -> refine per group -> report, resumably.

``PruneExecutor`` runs a ``PrunePlan`` stage by stage. Each completed
site group's masks and per-row losses are checkpointed through
``repro_torch.ckpt`` (atomic, hash-verified, the reference's format)
under ``ckpt_dir/groups/<site>/``, tagged with the group's resolved rule
and a content hash of its inputs. An interrupted run resumes at the site
group it died on and reproduces the final masks bitwise; a checkpoint
whose rule or data no longer match the plan is recomputed, not trusted.
Every group's output is validated against its resolved pattern *before*
it is checkpointed, so a bad refiner fails at the offending group.

The tag and the hash are the reference's (``repro.pruning.executor``): the
rule as a dict, and SHA-256 over the stacked weights' raw bytes (bf16 as
its 2-byte patterns) followed by the fp32 Gram (or, at the moments level,
the Gram diagonal and the feature means). Each package resumes from the
other's group checkpoints.

On a mesh (``plan.mesh``) calibration shards over the data axes, the
sparseswaps groups refine through the mesh's refiners and every rank
ends with every mask; group checkpoints are written by rank 0 only, each
write followed by a barrier, and read by every rank. A Gram-sharded
group refines on this rank's column block of its Gram
(``CalibStats.gram_block``), never gathered; its checkpoint's data hash
covers the weights and the digests of every rank's block, so it resumes
a mesh run of the same split. Every other group's Gram is gathered whole
(from its "model" column blocks) when the group refines.

Progress flows through a callback protocol (``PruneCallback``);
``PrintProgress`` prints one line per group. After ``run``, ``recover``
trains the PERP selection on top of the run's weights (under
``ckpt_dir/recover``) and installs the result in the report, and
``export_packed`` writes the servable artifact: ``packed/``, ``masks/``
and, where leaves changed, ``weights/``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from repro_torch import ckpt
from repro_torch.core import masks as masks_lib
from repro_torch.dist import groups as groups_lib
from repro_torch.models import ModelApi
from repro_torch.runtime import fault_tolerance as ft

from . import distributed
from . import engine as engine_lib
from . import plan as plan_lib
from . import sites as sites_lib
from . import stats as stats_lib
from .recover import _flat_leaves


@dataclasses.dataclass
class SiteReport:
    name: str                    # site-group name
    labels: list[str]            # per-instance labels
    loss_init: torch.Tensor      # (N,) summed row loss per instance, warmstart
    loss_final: torch.Tensor     # (N,) after refinement
    swaps: torch.Tensor          # (N,) accepted swaps (sparseswaps only)
    pattern: str = ""            # resolved pattern for THIS site ("2:4", ...)
    method: str = ""             # resolved method for THIS site
    row_loss_init: torch.Tensor | None = None   # (N, d_out) per-row losses
    row_loss_final: torch.Tensor | None = None  # (N, d_out)

    @property
    def error_reduction(self) -> torch.Tensor:
        return (self.loss_init - self.loss_final) / torch.clamp(
            self.loss_init, min=1e-30)


@dataclasses.dataclass
class PruneReport:
    masks: dict                          # tree for loss(..., masks=...)
    sites: list[SiteReport]
    method: str                          # run-level; "mixed" if per-site
    warmstart: str
    pattern: str
    wall_time_s: float
    updated_params: dict | None = None   # sparsegpt only
    plan: plan_lib.PrunePlan | None = None

    def mean_error_reduction(self) -> float:
        """Mean relative per-layer error reduction (paper Tables 3/4)."""
        if not self.sites:            # e.g. an all-skip recipe
            return 0.0
        return float(torch.cat([s.error_reduction for s in self.sites]).mean())

    def total_loss(self, which: str = "final") -> float:
        key = {"init": "loss_init", "final": "loss_final"}[which]
        return float(sum(getattr(s, key).sum() for s in self.sites))

    def summary(self) -> str:
        lines = [f"method={self.method} warmstart={self.warmstart} "
                 f"pattern={self.pattern} wall={self.wall_time_s:.1f}s",
                 f"mean error reduction: {100*self.mean_error_reduction():.2f}%"]
        mixed = self.method == "mixed" or self.pattern == "mixed"
        for s in self.sites:
            red = 100 * float(s.error_reduction.mean())
            tag = f"  [{s.pattern} {s.method}]" if mixed else ""
            lines.append(f"  {s.name:28s} n={len(s.labels):3d} "
                         f"err-reduction {red:6.2f}%{tag}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# progress callbacks
# ---------------------------------------------------------------------------

class PruneCallback:
    """Executor progress protocol. Subclass and override what you need."""

    def on_plan(self, plan: plan_lib.PrunePlan) -> None:
        """Called once before any work, with the resolved plan."""

    def on_group_start(self, planned: plan_lib.PlannedGroup,
                       index: int, total: int) -> None:
        """Called before each active group refines (or restores)."""

    def on_group_done(self, planned: plan_lib.PlannedGroup,
                      report: SiteReport, *, restored: bool) -> None:
        """Called after each group; ``restored`` = loaded from checkpoint."""

    def on_run_done(self, report: PruneReport) -> None:
        """Called once with the assembled report."""


class PrintProgress(PruneCallback):
    """One console line per finished group."""

    def on_group_done(self, planned, report, *, restored):
        red = 100 * float(report.error_reduction.mean())
        tag = " (restored)" if restored else ""
        print(f"  {report.name:28s} err-reduction {red:6.2f}%{tag}")


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

def _copy_tree(tree):
    """New dicts over the same leaves (leaves are replaced, never mutated)."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


def _write_updated_weights(new_params: dict, g: sites_lib.SiteGroup,
                           W1: torch.Tensor) -> None:
    """Insert a group's updated weight stack at its param path, in the
    param's dtype."""
    W1 = W1.reshape(*g.stack_shape, *W1.shape[1:]) if g.stack_shape else W1[0]
    node = new_params
    for k in g.mask_path[:-1]:
        node = node[k]
    node[g.mask_path[-1]] = W1.to(node[g.mask_path[-1]].dtype)


def _rule_tag(pg: plan_lib.PlannedGroup) -> dict:
    """The resolved-rule fingerprint a group checkpoint must match."""
    r = pg.rule
    return {"pattern": r.pattern_str, "method": r.method,
            "warmstart": r.warmstart, "t_max": r.t_max, "eps": r.eps,
            "k_swaps": r.k_swaps}


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's elements as the reference's numpy arrays hold them (bf16
    as its 2-byte patterns), C order, as a flat uint8 view (hashed in
    place)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return np.ascontiguousarray(t.numpy()).reshape(-1).view(np.uint8)


def _data_fingerprint(g: sites_lib.SiteGroup) -> str:
    """Content hash of a group's refinement inputs (weights + Gram, or the
    Gram diagonal + feature means at the moments level): a rerun with other
    weights or calibration data into the same out dir recomputes instead
    of restoring masks of the old inputs."""
    h = hashlib.sha256()
    stats = ((g.gram.G,) if g.gram.G is not None
             else (g.gram.gram_diag, g.gram.mean))
    for arr in (g.weights, *stats):
        h.update(_raw_bytes(arr))
    return h.hexdigest()


def _walk(tree: dict, path: tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _nest(path: tuple[str, ...], leaf) -> dict:
    for k in reversed(path):
        leaf = {k: leaf}
    return leaf


def _summarize(values: list[str], *, empty: str = "-") -> str:
    uniq = sorted(set(values))
    return uniq[0] if len(uniq) == 1 else ("mixed" if uniq else empty)


class PruneExecutor:
    """Executes a ``PrunePlan`` with group-granular checkpoint/resume.

    Args:
        api/params: the model being pruned.
        plan: output of ``plan_pruning``.
        taps: precomputed calibration statistics (a taps dict); when both
            ``taps`` and ``stats`` are None, ``run(calib_batches)``
            accumulates a ``CalibStats`` through ``pruning.stats`` first
            (skip-aware, resumable under ``<ckpt_dir>/calib/``).
        stats: a ``pruning.stats.CalibStats``, validated against the plan.
        calib_spec: overrides the spec ``run`` calibrates with (e.g.
            ``plan.calib_spec(minimal=True)``); default: the skip-aware
            full-Gram spec.
        calib_ckpt_every: checkpoint the accumulator every k batches.
        ckpt_dir: enables per-group checkpoints under
            ``<ckpt_dir>/groups/<site>/`` and resume on rerun.
        callback: a ``PruneCallback``; None = silent.
        engine_mode: "batched" (default) or "reference" (per-instance
            loop, for verification).
    """

    def __init__(self, api: ModelApi, params: dict,
                 plan: plan_lib.PrunePlan, *, taps: dict | None = None,
                 stats: stats_lib.CalibStats | None = None,
                 calib_spec: stats_lib.CalibSpec | None = None,
                 calib_ckpt_every: int = 0,
                 ckpt_dir: str | Path | None = None,
                 callback: PruneCallback | None = None,
                 engine_mode: str = "batched"):
        if engine_mode not in ("batched", "reference"):
            raise ValueError(f"unknown engine_mode {engine_mode!r}")
        if taps is not None and stats is not None:
            raise ValueError("pass either taps= (a taps dict) or stats= "
                             "(CalibStats), not both")
        need = plan.calib_spec(minimal=True)
        if stats is not None:
            if not stats.spec.covers(need):
                raise ValueError(
                    "CalibStats were accumulated under a spec that does "
                    "not cover this plan — rebuild with plan.calib_spec() "
                    f"(stats has {stats.spec.levels}, plan needs "
                    f"{need.levels})")
            taps = stats.taps
        if calib_spec is not None and not calib_spec.covers(need):
            raise ValueError(
                "calib_spec does not cover this plan — build it with "
                f"plan.calib_spec() (spec has {calib_spec.levels}, plan "
                f"needs {need.levels})")
        self.api = api
        self.params = params
        self.plan = plan
        self.stats = stats
        self.calib_spec = calib_spec
        self.taps = taps
        self.calib_ckpt_every = calib_ckpt_every
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir is not None else None
        self.callback = callback or PruneCallback()
        self.engine_mode = engine_mode
        self._last_report: PruneReport | None = None

    # -- group checkpointing ------------------------------------------------

    def _group_dir(self, name: str) -> Path:
        return self.ckpt_dir / "groups" / name

    def _on_main(self, write) -> None:
        """Run ``write()`` on the rank that writes (every process without
        a mesh), then hold the mesh's ranks until it is done."""
        mesh = self.plan.mesh
        if groups_lib.is_main(mesh):
            write()
        if mesh is not None:
            groups_lib.axis_group(mesh, groups_lib.all_axes(mesh)).barrier()

    def _site_group(self, pg: plan_lib.PlannedGroup) -> sites_lib.SiteGroup:
        """Group ``pg`` with its statistics: a Gram-sharded group's Gram as
        this rank's column block, every other group's whole."""
        taps, mesh = self.taps, self.plan.mesh
        tpath = sites_lib.tap_path(self.api.cfg, pg.name)
        if pg.engine_path == "gram-sharded":
            if self.stats is not None:
                ent = self.stats.gram_block(tpath, mesh)
            else:
                ent = stats_lib.gram_block(_walk(taps, tpath), None, mesh)
            taps = _nest(tpath, ent)
        elif self.stats is not None and self.stats.model is not None:
            taps = _nest(tpath, self.stats.entry(tpath))
        return sites_lib.enumerate_sites(self.api.cfg, self.params, taps,
                                         only={pg.name})[0]

    def _fingerprint(self, pg: plan_lib.PlannedGroup,
                     g: sites_lib.SiteGroup) -> str:
        """``_data_fingerprint``; a Gram-sharded group hashes its weights
        and the digests of every rank's column block, in block order."""
        if self.ckpt_dir is None:
            return ""
        if pg.engine_path != "gram-sharded":
            return _data_fingerprint(g)
        mesh = self.plan.mesh
        cg = groups_lib.axis_group(mesh, distributed.gram_split(mesh)[1])
        mine = hashlib.sha256(_raw_bytes(g.gram.G)).digest()
        digests = cg.all_gather(torch.frombuffer(
            bytearray(mine), dtype=torch.uint8).to(g.gram.G.device))
        h = hashlib.sha256(_raw_bytes(g.weights))
        h.update(digests.cpu().numpy().tobytes())
        return h.hexdigest()

    def _restore_group(self, pg: plan_lib.PlannedGroup,
                       g: sites_lib.SiteGroup,
                       fingerprint: str) -> engine_lib.GroupResult | None:
        """Load a finished group's result iff its checkpoint matches the
        plan's resolved rule AND the current weights/Gram bytes."""
        if self.ckpt_dir is None:
            return None
        found = ckpt.restore_latest(self._group_dir(pg.name))
        if found is None:
            return None
        _, tree, man = found
        extra = man.get("extra", {})
        if (extra.get("rule") != _rule_tag(pg)
                or extra.get("data") != fingerprint
                or "masks" not in tree
                or tree["masks"].shape != tuple(g.weights.shape)):
            return None
        dev = g.weights.device
        t = lambda k: ckpt.to_tensor(tree[k], dev)
        return engine_lib.GroupResult(
            masks=t("masks"), loss_init=t("loss_init"),
            loss_final=t("loss_final"), swaps=t("swaps").long(),
            new_weights=t("new_weights") if "new_weights" in tree else None)

    def _save_group(self, pg: plan_lib.PlannedGroup, index: int,
                    res: engine_lib.GroupResult, fingerprint: str) -> None:
        if self.ckpt_dir is None:
            return
        # swaps as int32, the reference's dtype, so it reads them back
        tree = {"masks": res.masks, "loss_init": res.loss_init,
                "loss_final": res.loss_final,
                "swaps": res.swaps.to(torch.int32)}
        if res.new_weights is not None:
            tree["new_weights"] = res.new_weights
        gdir = self._group_dir(pg.name)

        def write():
            # a stale checkpoint (e.g. from an earlier recipe) may occupy
            # this step — publish past it, then drop all but the newest
            existing = ckpt.steps(gdir)
            step = index if not existing else max(max(existing) + 1, index)
            ft.retry(ckpt.save, gdir, step, tree, retries=3,
                     base_delay=0.05, max_delay=1.0,
                     extra={"rule": _rule_tag(pg), "data": fingerprint,
                            "engine_path": pg.engine_path})
            ckpt.gc(gdir, keep=1)

        self._on_main(write)

    # -- execution ----------------------------------------------------------

    @torch.no_grad()
    def run(self, calib_batches=None) -> PruneReport:
        """Execute the plan: calibrate -> refine per group -> report."""
        t_start = time.time()
        plan = self.plan
        self.callback.on_plan(plan)

        single = plan.single_device_groups()
        if single:
            # once a run: the plan's describe() already marked them
            warnings.warn(
                f"mesh= is only honored by method='sparseswaps'; "
                f"{len(single)} group(s) refine single-device: "
                + ", ".join(single))

        if self.taps is None:
            if calib_batches is None:
                raise ValueError("no taps and no calib_batches to "
                                 "accumulate them from")
            spec = (self.calib_spec if self.calib_spec is not None
                    else plan.calib_spec(minimal=False))
            self.stats = stats_lib.accumulate_stats(
                self.api, self.params, calib_batches, spec=spec,
                mesh=plan.mesh, ckpt_dir=(self.ckpt_dir / "calib"
                          if self.ckpt_dir is not None else None),
                checkpoint_every=self.calib_ckpt_every)
            self.taps = self.stats.taps
        active = [pg for pg in plan.groups if not pg.skip]
        run_fn = {"batched": engine_lib.refine_group,
                  "reference": engine_lib.refine_group_reference}[
                      self.engine_mode]
        new_params = None
        if any(pg.rule.method == "sparsegpt" for pg in active):
            new_params = _copy_tree(self.params)

        site_masks: dict[str, torch.Tensor] = {}
        reports: list[SiteReport] = []
        groups: dict[str, sites_lib.SiteGroup] = {}
        for i, pg in enumerate(active):
            # skip-listed groups never touch their (absent) taps
            g = self._site_group(pg)
            self.callback.on_group_start(pg, i, len(active))
            fp = self._fingerprint(pg, g)
            res = self._restore_group(pg, g, fp)
            restored = res is not None
            if res is None:
                res = run_fn(pg.rule.method, g, pg.rule.pattern,
                             plan.group_context(pg))
                if not masks_lib.validate_mask(res.masks, pg.rule.pattern):
                    raise ValueError(
                        f"refiner {pg.rule.method!r} produced masks "
                        f"violating {pg.rule.pattern_str!r} at group "
                        f"{pg.name!r}")
                self._save_group(pg, i, res, fp)
            site_masks[g.name] = res.masks
            rep = SiteReport(
                name=g.name, labels=g.labels(),
                loss_init=res.loss_init.sum(1),
                loss_final=res.loss_final.sum(1), swaps=res.swaps.sum(1),
                pattern=pg.rule.pattern_str, method=pg.rule.method,
                row_loss_init=res.loss_init, row_loss_final=res.loss_final)
            reports.append(rep)
            if res.new_weights is not None:
                _write_updated_weights(new_params, g, res.new_weights)
            self.callback.on_group_done(pg, rep, restored=restored)
            # the mask tree needs the group's layout, not its statistics
            groups[g.name] = dataclasses.replace(g, gram=None)

        mask_tree = sites_lib.build_mask_tree(
            self.api.cfg, site_masks, [groups[pg.name] for pg in active])
        # skip rules may empty a whole top-level family the model indexes
        # directly (masks["layers"]) — keep those keys present
        for pg in plan.groups:
            mask_tree.setdefault(pg.spec.name.split(".", 1)[0], {})

        report = PruneReport(
            masks=mask_tree, sites=reports,
            method=_summarize([pg.rule.method for pg in active]),
            warmstart=_summarize([pg.rule.warmstart for pg in active]),
            pattern=_summarize([pg.rule.pattern_str for pg in active]),
            wall_time_s=time.time() - t_start,
            updated_params=new_params, plan=plan)
        self._last_report = report
        self.callback.on_run_done(report)
        return report

    # -- post-prune recovery ------------------------------------------------

    def recover(self, spec=None, *, checkpoint_every: int = 0,
                batches=None, verbose: bool = False):
        """Run the PERP recovery pass on the last ``run()``'s masks.

        ``spec`` defaults to the plan's attached ``RecoverSpec`` (recipe
        ``recover=``), else ``RecoverSpec()``. Recovery trains on top of
        the report's ``updated_params`` when the refiner produced them
        (sparsegpt), checkpoints under ``<ckpt_dir>/recover``, and
        installs the recovered tree in the report: the next
        ``export_packed()`` ships it. On the plan's mesh it trains sharded
        (``pruning.recover``), and every rank ends with the whole tree.
        """
        # ``from . import recover`` would resolve to the re-exported
        # function on the package, not this submodule
        from .recover import RecoverSpec
        from .recover import recover as _recover

        report = self._last_report
        if report is None:
            raise ValueError("nothing to recover — call run() first")
        if spec is None:
            spec = self.plan.recover or RecoverSpec()
        base = (report.updated_params
                if report.updated_params is not None else self.params)
        res = _recover(self.api, base, report.masks, spec,
                       mesh=self.plan.mesh, ckpt_dir=self.ckpt_dir,
                       checkpoint_every=checkpoint_every, batches=batches,
                       verbose=verbose)
        report.updated_params = res.params
        return res

    # -- serving export -----------------------------------------------------

    def export_packed(self, out_dir: str | Path, fmt: str = "nm24",
                      *, report: PruneReport | None = None) -> Path:
        """Export the masks as a servable packed checkpoint.

        Packs the run's weights (``updated_params`` where the refiner or
        recovery changed them) under the last ``run()``'s masks, or an
        explicit ``report``'s, into ``core.packed`` format ``fmt`` and
        writes, each atomically: ``out_dir/packed`` (the values / idx
        trees, site metadata in the manifest), ``out_dir/masks`` (for
        masked-dense serving and re-packing) and, when leaves changed,
        ``out_dir/weights`` (every leaf that differs from the executor's
        params, by dotted name). ``core.packed.load_packed_tree`` and
        ``load_masks_and_weights`` (``launch.serve --masks-from``) read it.
        """
        from repro_torch.core import packed as packed_lib

        report = report if report is not None else self._last_report
        if report is None:
            raise ValueError("nothing to export — call run() first or "
                             "pass report=")
        params = (report.updated_params
                  if report.updated_params is not None else self.params)
        tree = packed_lib.pack_tree(self.api.cfg, params, report.masks, fmt)
        vals, idx, meta = {}, {}, {}
        for name, leaf in _flat_leaves(tree):
            if not isinstance(leaf, packed_lib.PackedWeight):
                continue
            vals[name] = leaf.values
            idx[name] = leaf.idx
            meta[name] = {"fmt": leaf.fmt, "d_in": leaf.d_in, "n": leaf.n,
                          "m": leaf.m,
                          "dtype": str(leaf.values.dtype).removeprefix(
                              "torch.")}
        out = Path(out_dir)
        ckpt.save(out / "packed", 0, {"values": vals, "idx": idx},
                  extra={"format": fmt, "sites": meta})
        ckpt.save(out / "masks", 0, report.masks)
        if report.updated_params is not None:
            upd = changed_leaves(self.params, params)
            if upd:
                ckpt.save(out / "weights", 0, upd)
        return out


def changed_leaves(base: dict, new: dict) -> dict:
    """Flat {dotted name: leaf} of every leaf in ``new`` that differs from
    ``base`` — the minimal weight dump (``<out>/weights``) the serving
    splice restores over a fresh init."""
    out = {}
    for (name, bleaf), (_, nleaf) in zip(_flat_leaves(base),
                                         _flat_leaves(new)):
        if nleaf is bleaf or torch.equal(nleaf, bleaf):
            continue
        out[name] = nleaf
    return out
