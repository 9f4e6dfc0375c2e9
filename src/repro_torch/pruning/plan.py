"""Pruning plans: resolve a recipe against a model before spending FLOPs.

``plan_pruning(api, params, recipe, mesh=...)`` maps every enumerated
``SiteSpec`` through the recipe's first-match resolution and precomputes,
per group, what executing it will cost and which engine path it will
take:

* ``batched``       — the engine's refiner over the stacked group (no
                      mesh);
* ``rows-sharded``  — ``distributed.refine_rows_sharded`` (G replicated);
* ``gram-sharded``  — column-sharded G past ``gram_budget_bytes``;
* ``single-device`` — a mesh was asked for but the method has no
                      distributed refiner (said here, in the dry run);
* ``skip``          — the rule leaves the site dense.

``PrunePlan.describe()`` renders the whole thing as a table — the dry-run
view ``launch/prune.py --plan-only`` prints. ``params`` may live on
``device="meta"``: planning reads shapes only, and a mapping of axis
sizes (``{"data": 8}``) stands in for a mesh.
"""
from __future__ import annotations

import dataclasses
import math
import warnings

from repro_torch.dist import groups as groups_lib
from repro_torch.dist import specs as specs_lib

from . import distributed
from . import engine as engine_lib
from . import recipe as recipe_lib
from . import sites as sites_lib
from . import stats as stats_lib


@dataclasses.dataclass(frozen=True)
class PlannedGroup:
    """One site group with its resolved rule and cost estimate."""

    spec: sites_lib.SiteSpec
    rule: recipe_lib.ResolvedRule
    engine_path: str             # batched | rows-sharded | gram-sharded |
                                 # single-device | skip

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def skip(self) -> bool:
        return self.rule.skip

    @property
    def weight_bytes(self) -> int:
        return 0 if self.skip else self.spec.weight_bytes

    @property
    def gram_bytes(self) -> int:
        return 0 if self.skip else self.spec.gram_bytes


def _engine_path(spec: sites_lib.SiteSpec, rule: recipe_lib.ResolvedRule,
                 mesh, gram_budget_bytes: int) -> str:
    if rule.skip:
        return "skip"
    if mesh is None:
        return "batched"
    if rule.method != "sparseswaps":
        return "single-device"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # execution owns the warning
        regime = engine_lib._sharded_regime(
            rule.pattern, spec.d_in, mesh, gram_budget_bytes)
    return {"rows": "rows-sharded", "gram": "gram-sharded"}[regime]


@dataclasses.dataclass(frozen=True)
class PrunePlan:
    """The resolved, costed execution order ``PruneExecutor`` runs."""

    groups: tuple[PlannedGroup, ...]
    recipe: recipe_lib.PruneRecipe
    compact_every: int | None = None   # active-row compaction period
    cfg: object = None                 # ArchConfig
    mesh: object = None                # launch.mesh's DeviceMesh
    gram_budget_bytes: int = engine_lib.DEFAULT_GRAM_BUDGET

    @property
    def active_groups(self) -> tuple[PlannedGroup, ...]:
        return tuple(g for g in self.groups if not g.skip)

    @property
    def recover(self):
        """The recipe's attached RecoverSpec (None = no recovery pass)."""
        return self.recipe.recover

    def total_weight_bytes(self) -> int:
        return sum(g.weight_bytes for g in self.groups)

    def total_gram_bytes(self) -> int:
        return sum(g.gram_bytes for g in self.groups)

    def single_device_groups(self) -> list[str]:
        """Groups that asked for the mesh but will refine single-device."""
        return [g.name for g in self.groups
                if g.engine_path == "single-device"]

    def base_context(self) -> engine_lib.RefineContext:
        """Run-wide knobs; the executor layers rule overrides per group."""
        return engine_lib.RefineContext(
            warmstart=self.recipe.warmstart, t_max=self.recipe.t_max,
            eps=self.recipe.eps, k_swaps=self.recipe.k_swaps,
            compact_every=self.compact_every, mesh=self.mesh,
            gram_budget_bytes=self.gram_budget_bytes)

    def group_context(self, g: PlannedGroup) -> engine_lib.RefineContext:
        return self.base_context().with_overrides(
            warmstart=g.rule.warmstart, t_max=g.rule.t_max, eps=g.rule.eps,
            k_swaps=g.rule.k_swaps)

    # -- calibration costing ------------------------------------------------

    def calib_spec(self, *, minimal: bool = True) -> stats_lib.CalibSpec:
        """The recipe-aware ``CalibSpec`` this plan needs (see stats)."""
        return stats_lib.CalibSpec.from_plan(self.cfg, self, minimal=minimal)

    def calib_costs(self, *, minimal: bool = True) -> list[tuple]:
        """(TapSpec, level) per calibration tap under the recipe."""
        spec = self.calib_spec(minimal=minimal)
        taps = sites_lib.tap_specs(self.cfg, [g.spec for g in self.groups])
        return [(t, spec.level(t.name)) for t in taps]

    def total_calib_bytes(self, *, minimal: bool = True) -> int:
        """Accumulator footprint during calibration (fp32)."""
        return sum(t.bytes_at(lvl)
                   for t, lvl in self.calib_costs(minimal=minimal))

    def _calib_device_bytes(self, tap: sites_lib.TapSpec, level: str) -> int:
        """Per-device accumulator bytes under the rule the accumulator
        uses (``dist.specs.calib_pspecs``): data axes replicate, Gram
        leaves split over "model" where the rule shards them."""
        if level == "none":
            return 0
        n, d = tap.n, tap.d_in
        leaves = {"s": (n, d), "n": (n,),
                  "g" if level == "gram" else "d":
                  (n, d, d) if level == "gram" else (n, d)}
        if self.mesh is None:
            return sum(4 * math.prod(s) for s in leaves.values())
        sizes = groups_lib.axis_sizes(self.mesh)
        shaped = {k: _Shape(s) for k, s in leaves.items()}
        specs = specs_lib.calib_pspecs(shaped, self.mesh)
        total = 0
        for k, shape in leaves.items():
            shards = 1
            for axes in specs[k]:
                if axes is None:
                    continue
                for a in ((axes,) if isinstance(axes, str) else axes):
                    shards *= sizes[a]
            total += 4 * math.prod(shape) // shards
        return total

    def calib_bytes_per_device(self, *, minimal: bool = True) -> int:
        """The calibration accumulator's bytes on one rank (Gram columns
        over "model", as ``calib_pspecs`` splits them). The refine's own
        bytes are ``refine_bytes_per_device``'s."""
        return sum(self._calib_device_bytes(t, lvl)
                   for t, lvl in self.calib_costs(minimal=minimal))

    def refine_costs(self) -> dict:
        """{group: ``distributed.refine_bytes`` of one instance on one
        rank} for every active group: the Gram regime's (d, d / n) column
        block, or G whole in the rows regime (and on one device), plus
        the carry and the ΔL blocks."""
        mesh = self.mesh if self.mesh is not None else {"data": 1}
        out = {}
        for g in self.active_groups:
            if g.engine_path in ("rows-sharded", "gram-sharded"):
                regime, on = g.engine_path.split("-")[0], mesh
            else:
                regime, on = "rows", {"data": 1}
            out[g.name] = distributed.refine_bytes(
                regime, g.spec.d_out, g.spec.d_in, on)
        return out

    def refine_bytes_per_device(self) -> int:
        """The largest group's refine reckoning on one rank (its Gram there
        plus the carry and the ΔL blocks, ``refine_costs``); 0 when no
        group refines."""
        return max((c["total"] for c in self.refine_costs().values()),
                   default=0)

    def describe(self) -> str:
        """The dry-run table: every group, its treatment, its cost."""
        hdr = (f"{'site':30s} {'n':>4s} {'d_out x d_in':>14s} "
               f"{'pattern':>8s} {'method':>11s} {'warm':>9s} {'t_max':>5s} "
               f"{'k':>4s} {'path':>13s} {'W MiB':>8s} {'G MiB':>8s}")
        lines = [hdr, "-" * len(hdr)]
        for g in self.groups:
            s, r = g.spec, g.rule
            if g.skip:
                lines.append(
                    f"{s.name:30s} {s.n_instances:4d} "
                    f"{f'{s.d_out} x {s.d_in}':>14s} {'-':>8s} {'skip':>11s} "
                    f"{'-':>9s} {'-':>5s} {'-':>4s} {'skip':>13s} {'-':>8s} "
                    f"{'-':>8s}")
                continue
            k_s = "auto" if r.k_swaps is None else str(r.k_swaps)
            lines.append(
                f"{s.name:30s} {s.n_instances:4d} "
                f"{f'{s.d_out} x {s.d_in}':>14s} {r.pattern_str:>8s} "
                f"{r.method:>11s} {r.warmstart:>9s} {r.t_max:5d} "
                f"{k_s:>4s} {g.engine_path:>13s} {g.weight_bytes/2**20:8.1f} "
                f"{g.gram_bytes/2**20:8.1f}")
        lines.append("-" * len(hdr))
        if self.mesh is None:
            mesh_s = "none"
        else:
            sizes = groups_lib.axis_sizes(self.mesh)
            mesh_s = (f"{'x'.join(str(v) for v in sizes.values())} "
                      f"({groups_lib.mesh_size(self.mesh)} devices)")
        lines.append(
            f"{len(self.active_groups)}/{len(self.groups)} groups to refine "
            f"| mesh: {mesh_s} | totals: W "
            f"{self.total_weight_bytes()/2**20:.1f} MiB, G "
            f"{self.total_gram_bytes()/2**20:.1f} MiB (budget "
            f"{self.gram_budget_bytes/2**20:.0f} MiB/device)")
        costs = self.refine_costs()
        if costs:
            name = max(costs, key=lambda k: costs[k]["total"])
            c = costs[name]
            lines.append(
                f"refine: {c['total']/2**20:.1f} MiB/device at the largest "
                f"group ({name}: G {c['gram']/2**20:.1f}, rows "
                f"{c['rows']/2**20:.1f}, carry {c['carry']/2**20:.1f}, "
                f"ΔL {c['delta']/2**20:.1f} MiB)")
        single = self.single_device_groups()
        if single:
            lines.append(
                f"NOTE: {len(single)} group(s) refine single-device despite "
                f"mesh= (no distributed refiner for their method): "
                + ", ".join(single))
        if self.cfg is not None:
            lines.append("")
            lines.extend(self._describe_calibration())
        if self.recover is not None:
            lines.append("")
            lines.extend(self._describe_recovery())
        return "\n".join(lines)

    def _describe_recovery(self) -> list[str]:
        """The post-prune recovery block: what retrains, for how long."""
        rec = self.recover
        warm = max(1, int(rec.warmup_frac * rec.steps))
        return [
            f"recovery (PERP): {rec.describe()}",
            f"  schedule: {warm}-step warmup -> cosine to "
            f"{rec.min_lr_frac:g}x lr | wd {rec.weight_decay:g} | "
            f"ckpt key {rec.fingerprint()} (under <ckpt_dir>/recover)"]

    def _describe_calibration(self) -> list[str]:
        """The calibration cost block: per-tap level + accumulator bytes.

        The table shows the *minimal* (recipe-aware) levels; the totals
        line also quotes the skip-aware full-Gram footprint (the executor
        and launcher default).
        """
        hdr = (f"{'calibration tap':30s} {'level':>8s} {'n x d':>12s} "
               f"{'MiB':>8s} {'MiB/dev':>8s}")
        lines = [hdr, "-" * len(hdr)]
        for tap, lvl in self.calib_costs(minimal=True):
            lines.append(
                f"{'.'.join(tap.path):30s} {lvl:>8s} "
                f"{f'{tap.n} x {tap.d_in}':>12s} "
                f"{tap.bytes_at(lvl)/2**20:8.2f} "
                f"{self._calib_device_bytes(tap, lvl)/2**20:8.2f}")
        lines.append("-" * len(hdr))
        minimal = self.total_calib_bytes(minimal=True)
        skip_full = self.total_calib_bytes(minimal=False)
        legacy = sum(t.bytes_at("gram") for t, _ in self.calib_costs())
        lines.append(
            f"calibration state: {skip_full/2**20:.2f} MiB skip-aware full "
            f"(executor default) | {minimal/2**20:.2f} MiB minimal "
            f"({self.calib_bytes_per_device(minimal=True)/2**20:.2f} "
            f"MiB/device) | {legacy/2**20:.2f} MiB legacy every-tap")
        return lines


def plan_pruning(api, params, recipe: recipe_lib.PruneRecipe, *,
                 mesh=None,
                 gram_budget_bytes: int = engine_lib.DEFAULT_GRAM_BUDGET,
                 compact_every: int | None = None) -> PrunePlan:
    """Resolve ``recipe`` against the model's sites into a ``PrunePlan``.

    Pure shape arithmetic: ``params`` may live on ``device="meta"`` and no
    calibration is required. A recipe's attached recovery (``recover=``)
    rides along as ``PrunePlan.recover``; on a mesh it trains sharded
    (``pruning.recover``).
    """
    specs = sites_lib.site_specs(api.cfg, params)
    recipe.validate(specs)
    groups = []
    for spec in specs:
        rule = recipe.resolve(spec.name, tuple(spec.labels()))
        groups.append(PlannedGroup(
            spec=spec, rule=rule,
            engine_path=_engine_path(spec, rule, mesh, gram_budget_bytes)))
    return PrunePlan(groups=tuple(groups), recipe=recipe,
                     compact_every=compact_every, cfg=api.cfg, mesh=mesh,
                     gram_budget_bytes=gram_budget_bytes)


@dataclasses.dataclass(frozen=True)
class _Shape:
    """A leaf stand-in for ``calib_pspecs``, which reads shapes only."""

    shape: tuple[int, ...]
