"""The port's recipes and plans vs the reference's, and the launcher's
recipe, plan-only and resume surfaces on the CPU.

* a recipe written by the reference (JSON) resolves site by site to the
  same rules in the port, and writes back the same JSON;
* the validation errors of the reference (dead or shadowed globs, unknown
  method or warmstart, no pattern, N:M divisibility, bad JSON keys and
  values) raise with the same messages;
* the plan's engine paths, weight/Gram bytes and calibration costs equal
  the reference's; ``--plan-only`` plans on ``device="meta"``;
* a recipe that asks for recovery plans it (``PrunePlan.recover``);
  a mesh raises ``NotImplementedError``.
"""
import json

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import jax  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models as jmodels  # noqa: E402
from repro import pruning as jpruning  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import pruning as tpruning  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.launch import prune as tlaunch  # noqa: E402

ARCH = "llama31-8b"


@pytest.fixture(scope="module")
def apis():
    japi = jmodels.build(jconfigs.get_tiny(ARCH))
    jabstract = jax.eval_shape(lambda: japi.init(jax.random.key(0)))
    tapi = tmodels.build(tconfigs.get_tiny(ARCH))
    return japi, jabstract, tapi, tapi.init(seed=0, device="meta")


def _rule_fields(r):
    return (r.pattern_str, r.method, r.warmstart, r.t_max, r.eps, r.skip,
            r.selected_by, r.k_swaps)


def test_reference_recipe_resolves_alike(apis):
    japi, jabstract, tapi, tmeta = apis
    jrec = jpruning.PruneRecipe(
        rules=(jpruning.SiteRule("layers.attn.wq[1]", pattern=jmasks.NM(2, 4),
                                 t_max=7),
               jpruning.SiteRule("*.attn.w[ko]", method="sparsegpt",
                                 warmstart="ria"),
               jpruning.SiteRule("*.attn.wv", skip=True),
               jpruning.SiteRule("*.mlp.w_down", method="dsnot", eps=1e-6),
               jpruning.SiteRule("*", k_swaps=4)),
        pattern=jmasks.PerRow(0.6), t_max=50, k_swaps=8,
        recover=jpruning.RecoverSpec(select="norms", steps=3))
    text = jrec.to_json()
    trec = tpruning.PruneRecipe.from_json(text)
    assert trec.to_json() == text
    assert trec.recover.fingerprint() == jrec.recover.fingerprint()
    jspecs = jpruning.site_specs(japi.cfg, jabstract)
    tspecs = tpruning.site_specs(tapi.cfg, tmeta)
    assert [(s.name, s.n_instances, s.d_out, s.d_in, s.stack_shape,
             s.labels()) for s in tspecs] == \
        [(s.name, s.n_instances, s.d_out, s.d_in, s.stack_shape, s.labels())
         for s in jspecs]
    for js, ts in zip(jspecs, tspecs):
        assert _rule_fields(trec.resolve(ts.name, tuple(ts.labels()))) == \
            _rule_fields(jrec.resolve(js.name, tuple(js.labels())))
    assert tpruning.prunable_param_count(tapi.cfg, tmeta) == \
        jpruning.prunable_param_count(japi.cfg, jabstract)


def _bad_recipes(pkg, masks):
    """(name, thunk) pairs that must raise ValueError, per package."""
    R, S = pkg.PruneRecipe, pkg.SiteRule
    return [
        ("dead glob", lambda: R(rules=(S("*.does_not_exist", skip=True),),
                                pattern=masks.PerRow(0.5))),
        ("shadowed", lambda: R(rules=(S("*", pattern=masks.PerRow(0.6)),
                                      S("*.attn.*", pattern=masks.NM(2, 4))))),
        ("unknown method", lambda: R(pattern=masks.PerRow(0.5),
                                     method="nope")),
        ("no pattern", lambda: R()),
        ("unknown warmstart", lambda: R(pattern=masks.PerRow(0.5),
                                        warmstart="nope")),
        ("nm divisibility", lambda: R.single(masks.NM(3, 7))),
        ("k_swaps", lambda: R(pattern=masks.PerRow(0.5), k_swaps=0)),
    ]


@pytest.mark.parametrize("case", range(7))
def test_validation_errors_match_reference(apis, case):
    japi, jabstract, tapi, tmeta = apis
    jname, jmake = _bad_recipes(jpruning, jmasks)[case]
    _, tmake = _bad_recipes(tpruning, tmasks)[case]
    with pytest.raises(ValueError) as want:
        jmake().validate(jpruning.site_specs(japi.cfg, jabstract))
    with pytest.raises(ValueError) as got:
        tmake().validate(tpruning.site_specs(tapi.cfg, tmeta))
    assert str(got.value) == str(want.value), jname
    with pytest.raises(ValueError):                 # and at plan time
        tpruning.plan_pruning(tapi, tmeta, tmake())


@pytest.mark.parametrize("text", [
    '{"defaults": {"tmax": 50}}', '{"defaults": {"t_max": 50.5}}',
    '{"rules": [{"select": "*", "bogus": 1}]}', '{"extra": {}}'])
def test_json_errors_match_reference(text):
    with pytest.raises(ValueError) as want:
        jpruning.PruneRecipe.from_json(text)
    with pytest.raises(ValueError) as got:
        tpruning.PruneRecipe.from_json(text)
    assert str(got.value) == str(want.value)
    r = tpruning.PruneRecipe.from_json(
        '{"defaults": {"pattern": "0.6", "t_max": 50.0},'
        ' "rules": [{"select": "*", "t_max": 7.0}]}')
    assert r.t_max == 50 and isinstance(r.rules[0].t_max, int)


def test_plan_costs_and_paths_match_reference(apis):
    japi, jabstract, tapi, tmeta = apis
    doc = json.dumps({"defaults": {"pattern": "0.6"},
                      "rules": [{"select": "*.mlp.w_down", "skip": True},
                                {"select": "*.attn.*", "method": "dsnot"},
                                {"select": "*.mlp.w_up", "pattern": "2:4",
                                 "t_max": 3}]})
    jplan = jpruning.plan_pruning(japi, jabstract,
                                  jpruning.PruneRecipe.from_json(doc),
                                  compact_every=2)
    tplan = tpruning.plan_pruning(tapi, tmeta,
                                  tpruning.PruneRecipe.from_json(doc),
                                  compact_every=2)
    assert [(g.name, g.engine_path, g.weight_bytes, g.gram_bytes, g.skip)
            for g in tplan.groups] == \
        [(g.name, g.engine_path, g.weight_bytes, g.gram_bytes, g.skip)
         for g in jplan.groups]
    for minimal in (True, False):
        assert tplan.calib_spec(minimal=minimal).levels == \
            jplan.calib_spec(minimal=minimal).levels
        assert tplan.total_calib_bytes(minimal=minimal) == \
            jplan.total_calib_bytes(minimal=minimal)
        assert [(t.path, t.name, t.d_in, t.n, t.sites, lvl)
                for t, lvl in tplan.calib_costs(minimal=minimal)] == \
            [(t.path, t.name, t.d_in, t.n, t.sites, lvl)
             for t, lvl in jplan.calib_costs(minimal=minimal)]
    for tg, jg in zip(tplan.groups, jplan.groups):
        assert tplan.group_context(tg) == tpruning.RefineContext(
            **{f: getattr(jplan.group_context(jg), f)
               for f in ("warmstart", "t_max", "eps", "k_swaps",
                         "compact_every")})
    text = tplan.describe()
    assert "calibration tap" in text and "skip-aware full" in text
    assert tplan.total_weight_bytes() == jplan.total_weight_bytes()


def test_recovery_and_mesh_raise(apis):
    """A recipe's recovery rides the plan (``PruneExecutor.recover`` runs
    it; ``tests/test_torch_recover.py``), with a mesh too: recovery trains
    sharded over it (``tests/test_torch_mesh_train.py``)."""
    _, _, tapi, tmeta = apis
    spec = tpruning.RecoverSpec(select="lora", steps=7)
    rec = tpruning.PruneRecipe.single("0.6", recover=spec)
    for mesh in (None, {"data": 2}):
        plan = tpruning.plan_pruning(tapi, tmeta, rec, mesh=mesh)
        assert plan.recover == spec
        assert "recovery (PERP): select=lora steps=7" in plan.describe()


def test_cli_recipe_plan_only_and_resume(tmp_path, capsys):
    recipe = tmp_path / "r.json"
    recipe.write_text(json.dumps(
        {"defaults": {"pattern": "0.6", "t_max": 4},
         "rules": [{"select": "*.attn.wq", "pattern": "2:4"},
                   {"select": "*.attn.wk", "method": "sparsegpt"},
                   {"select": "*.attn.wv", "skip": True},
                   {"select": "*.mlp.w_down", "method": "dsnot"},
                   {"select": "*"}]}))
    base = ["--arch", ARCH, "--tiny", "--device", "cpu", "--recipe",
            str(recipe), "--n-calib", "4"]
    tlaunch.main(base + ["--plan-only"])
    out = capsys.readouterr().out
    assert "skip" in out and "calibration tap" in out and "ppl" not in out
    run = base + ["--out-dir", str(tmp_path / "out"), "--calib-stats",
                  "minimal", "--calib-ckpt-every", "2", "--compact-every",
                  "2"]
    tlaunch.main(run)
    first = capsys.readouterr().out
    assert "(restored)" not in first and "pruned: ppl" in first
    tlaunch.main(run)
    second = capsys.readouterr().out
    assert second.count("(restored)") == 6          # every active group
    out = tmp_path / "out"
    assert tpruning.PruneRecipe.from_json(
        (out / "recipe.json").read_text()).rules[2].skip
    assert (out / "weights").is_dir()                # sparsegpt's weights
    assert sorted(p.name for p in (out / "prune_ckpt" / "groups").iterdir()) \
        == ["layers.attn.wk", "layers.attn.wo", "layers.attn.wq",
            "layers.mlp.w_down", "layers.mlp.w_gate", "layers.mlp.w_up"]
    doc = json.loads((out / "report.json").read_text())
    assert {s["method"] for s in doc["sites"]} == {"sparseswaps", "sparsegpt",
                                                   "dsnot"}
