"""Declarative pruning recipes: per-site rules instead of one global knob.

The mask-selection problem is per-site, and the strongest results in the
literature are non-uniform — mixed 2:4 + unstructured placement (MaskLLM),
layer-dependent sparsity budgets (SparseLLM), skip-lists for fragile
projections. A ``PruneRecipe`` expresses all of that as an ordered list of
``SiteRule``s, each a glob over SiteGroup names/labels carrying its own
pattern / method / warmstart / t_max / eps (or a ``skip`` flag)::

    recipe = PruneRecipe(
        rules=(SiteRule("*.attn.*", pattern=masks.NM(2, 4)),
               SiteRule("*.mlp.w_down", skip=True),
               SiteRule("*", pattern=masks.PerRow(0.6))),
        method="sparseswaps", t_max=100)

Resolution is **first match wins** (like .gitignore): a site group takes
the first rule whose glob matches its name or any per-instance label;
unmatched sites fall back to the recipe-level defaults. Recipes round-trip
through JSON (``to_json`` / ``from_json``) with patterns in the same
``"0.6"`` / ``"2:4"`` syntax the CLI uses (``core.masks.parse_pattern``),
and ``validate()`` checks every rule against the model's enumerated sites
before a plan is built — a dead glob or an unknown method fails at plan
time, not after an hour of calibration.

A recipe's ``recover`` spec round-trips through JSON here; the plan
carries it, and ``PruneExecutor.recover`` runs it after the refinement.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json

from repro_torch.core import masks as masks_lib
from repro_torch.core.warmstart import CRITERIA as _WARMSTARTS

from .recover import RecoverSpec


def _coerce_int(v, name: str = "t_max") -> int:
    """JSON emitters often write ints as floats (50.0); accept those."""
    if isinstance(v, float) and not v.is_integer():
        raise ValueError(f"{name} must be an integer, got {v!r}")
    return int(v)


@dataclasses.dataclass(frozen=True)
class SiteRule:
    """One recipe entry: a glob selector plus the knobs it overrides.

    ``None`` fields inherit the recipe-level defaults; ``skip=True`` leaves
    every matched site dense (no mask computed, no entry in the tree).

    Selection is per *group*: a rule matching any per-instance label (e.g.
    the literal ``"layers.attn.wq[3]"``) applies to the whole group — mask
    refinement batches all instances of a site in one call. Labels contain
    ``[...]`` which fnmatch treats as a character class, so literal
    name/label equality is checked first.
    """

    select: str                                  # glob over names/labels
    pattern: masks_lib.Pattern | None = None
    method: str | None = None
    warmstart: str | None = None
    t_max: int | None = None
    eps: float | None = None
    k_swaps: int | None = None                   # swaps committed per pass
    skip: bool = False

    def matches(self, name: str, labels: tuple[str, ...] = ()) -> bool:
        if self.select == name or self.select in labels:
            return True
        return (fnmatch.fnmatchcase(name, self.select)
                or any(fnmatch.fnmatchcase(l, self.select) for l in labels))

    def to_json_dict(self) -> dict:
        d = {"select": self.select}
        if self.pattern is not None:
            d["pattern"] = masks_lib.format_pattern(self.pattern)
        for k in ("method", "warmstart", "t_max", "eps", "k_swaps"):
            if getattr(self, k) is not None:
                d[k] = getattr(self, k)
        if self.skip:
            d["skip"] = True
        return d

    @classmethod
    def from_json_dict(cls, d: dict) -> "SiteRule":
        d = dict(d)
        unknown = set(d) - {"select", "pattern", "method", "warmstart",
                            "t_max", "eps", "k_swaps", "skip"}
        if unknown:
            raise ValueError(f"unknown SiteRule keys {sorted(unknown)}")
        if "pattern" in d:
            d["pattern"] = masks_lib.parse_pattern(d["pattern"])
        if "eps" in d:
            d["eps"] = float(d["eps"])
        if "t_max" in d:
            d["t_max"] = _coerce_int(d["t_max"])
        if "k_swaps" in d:
            d["k_swaps"] = _coerce_int(d["k_swaps"], "k_swaps")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ResolvedRule:
    """A site's fully-resolved treatment (rule overrides + defaults)."""

    pattern: masks_lib.Pattern | None
    method: str
    warmstart: str
    t_max: int
    eps: float
    skip: bool
    selected_by: str | None       # the matching glob, None = defaults
    k_swaps: int | None = None    # None = auto (sparseswaps._pick_k)

    @property
    def pattern_str(self) -> str:
        return ("-" if self.pattern is None
                else masks_lib.format_pattern(self.pattern))


@dataclasses.dataclass(frozen=True)
class PruneRecipe:
    """Ordered per-site rules over recipe-level defaults.

    ``recover`` (optional) attaches a post-prune recovery pass
    (``pruning.recover.RecoverSpec``). It rides the recipe's JSON
    round-trip (top-level ``"recover"`` key) and the plan
    (``PrunePlan.recover``).
    """

    rules: tuple[SiteRule, ...] = ()
    pattern: masks_lib.Pattern | None = None
    method: str = "sparseswaps"
    warmstart: str = "wanda"
    t_max: int = 100
    eps: float = 0.0
    k_swaps: int | None = None    # swaps per search pass; None = auto
    recover: RecoverSpec | None = None

    def __post_init__(self):
        # tolerate list inputs; keep the dataclass hashable/comparable
        if not isinstance(self.rules, tuple):
            object.__setattr__(self, "rules", tuple(self.rules))

    @classmethod
    def single(cls, pattern: masks_lib.Pattern | str, *,
               method: str = "sparseswaps", warmstart: str = "wanda",
               t_max: int = 100, eps: float = 0.0,
               k_swaps: int | None = None,
               recover: RecoverSpec | None = None) -> "PruneRecipe":
        """The monolithic ``prune_model`` call as a zero-rule recipe."""
        return cls(rules=(), pattern=masks_lib.parse_pattern(pattern),
                   method=method, warmstart=warmstart, t_max=t_max, eps=eps,
                   k_swaps=k_swaps, recover=recover)

    # -- resolution ---------------------------------------------------------

    def resolve(self, name: str,
                labels: tuple[str, ...] = ()) -> ResolvedRule:
        """First-match resolution of one site group against the rules."""
        for rule in self.rules:
            if rule.matches(name, labels):
                return ResolvedRule(
                    pattern=rule.pattern if rule.pattern is not None
                    else self.pattern,
                    method=rule.method or self.method,
                    warmstart=rule.warmstart or self.warmstart,
                    t_max=self.t_max if rule.t_max is None else rule.t_max,
                    eps=self.eps if rule.eps is None else rule.eps,
                    skip=rule.skip,
                    selected_by=rule.select,
                    k_swaps=(self.k_swaps if rule.k_swaps is None
                             else rule.k_swaps))
        return ResolvedRule(pattern=self.pattern, method=self.method,
                            warmstart=self.warmstart, t_max=self.t_max,
                            eps=self.eps, skip=False, selected_by=None,
                            k_swaps=self.k_swaps)

    def validate(self, specs) -> None:
        """Check the recipe against the model's enumerated sites.

        ``specs``: ``sites.SiteSpec`` list (or bare name strings). Raises
        ``ValueError`` on a rule that never wins first-match resolution
        (dead glob or shadowed by an earlier rule), a non-skipped site
        with no pattern, an N:M pattern whose M does not divide the
        site's ``d_in``, or an unknown method/warmstart.
        """
        from . import engine as engine_lib  # late: avoid import cycle

        names, labels, d_ins = [], {}, {}
        for s in specs:
            name = s if isinstance(s, str) else s.name
            names.append(name)
            labels[name] = (() if isinstance(s, str) else tuple(s.labels()))
            if not isinstance(s, str):
                d_ins[name] = s.d_in
        # a rule must WIN first-match resolution for at least one site —
        # this catches both dead globs and rules shadowed by an earlier,
        # broader rule (e.g. a catch-all "*" placed first)
        winners = set()
        for n in names:
            for i, rule in enumerate(self.rules):
                if rule.matches(n, labels[n]):
                    winners.add(i)
                    break
        dead = [r.select for i, r in enumerate(self.rules)
                if i not in winners]
        if dead:
            raise ValueError(
                f"recipe rules never selected by any enumerated site "
                f"(dead glob, or shadowed by an earlier rule): {dead} "
                f"(sites: {sorted(names)})")
        for n in names:
            res = self.resolve(n, labels[n])
            if res.skip:
                continue
            if res.pattern is None:
                raise ValueError(
                    f"site {n!r} resolves to no pattern (rule "
                    f"{res.selected_by!r} and recipe defaults both unset)")
            d_in = d_ins.get(n)
            if (isinstance(res.pattern, masks_lib.NM) and d_in is not None
                    and d_in % res.pattern.m):
                raise ValueError(
                    f"site {n!r} (d_in={d_in}) not divisible by M={res.pattern.m} "
                    f"of its resolved pattern {res.pattern_str!r}")
            if res.method not in engine_lib.REFINERS:
                raise ValueError(
                    f"site {n!r} resolves to unknown method {res.method!r}; "
                    f"have {sorted(engine_lib.REFINERS)}")
            if res.warmstart not in _WARMSTARTS:
                raise ValueError(
                    f"site {n!r} resolves to unknown warmstart "
                    f"{res.warmstart!r}; have {list(_WARMSTARTS)}")
            if res.k_swaps is not None and res.k_swaps < 1:
                raise ValueError(
                    f"site {n!r} resolves to k_swaps={res.k_swaps}; "
                    "must be >= 1 (or null for auto)")

    # -- serialization ------------------------------------------------------

    def to_json(self, *, indent: int | None = 1) -> str:
        defaults = {"method": self.method, "warmstart": self.warmstart,
                    "t_max": self.t_max, "eps": self.eps}
        if self.k_swaps is not None:
            defaults["k_swaps"] = self.k_swaps
        if self.pattern is not None:
            defaults["pattern"] = masks_lib.format_pattern(self.pattern)
        doc = {"defaults": defaults,
               "rules": [r.to_json_dict() for r in self.rules]}
        if self.recover is not None:
            doc["recover"] = self.recover.to_json_dict()
        return json.dumps(doc, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "PruneRecipe":
        data = json.loads(text)
        unknown = set(data) - {"defaults", "rules", "recover"}
        if unknown:
            raise ValueError(f"unknown recipe keys {sorted(unknown)}")
        defaults = dict(data.get("defaults", {}))
        bad = set(defaults) - {"pattern", "method", "warmstart", "t_max",
                               "eps", "k_swaps"}
        if bad:
            raise ValueError(f"unknown recipe defaults keys {sorted(bad)}")
        if "pattern" in defaults:
            defaults["pattern"] = masks_lib.parse_pattern(defaults["pattern"])
        if "eps" in defaults:
            defaults["eps"] = float(defaults["eps"])
        if "t_max" in defaults:
            defaults["t_max"] = _coerce_int(defaults["t_max"])
        if "k_swaps" in defaults:
            defaults["k_swaps"] = _coerce_int(defaults["k_swaps"],
                                              "k_swaps")
        rules = tuple(SiteRule.from_json_dict(r)
                      for r in data.get("rules", []))
        recover = (RecoverSpec.from_json_dict(data["recover"])
                   if data.get("recover") is not None else None)
        return cls(rules=rules, recover=recover, **defaults)
