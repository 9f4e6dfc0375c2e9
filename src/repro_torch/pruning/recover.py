"""Post-prune recovery (PERP): retrain ~1% of the params under the masks.

The reference's ``repro.pruning.recover`` on tensors. Full retraining
after one-shot pruning is what the paper calls prohibitive at scale; PERP
(Zimmer et al., 2024) retrains a tiny, chosen subset (norm scales,
biases, or low-rank adapters on the pruned projections) and recovers most
of the pruning-induced loss at a fraction of the cost:

* ``RecoverSpec`` — which params train (``select``), for how many steps,
  under what AdamW schedule, on which calibration stream. Round-trips
  through JSON (recipes embed it) and fingerprints (sha256) for
  checkpoint keying; both packages compute the same fingerprint.
* ``recover(api, params, masks, spec)`` — freezes everything outside the
  selection and runs masked-gradient AdamW over the calibration stream
  (the split and seed protocol of ``calibrate.calibration_batches``).
  ``ckpt_dir`` enables atomic checkpoint / resume under
  ``<ckpt_dir>/recover`` keyed by the spec's fingerprint, in the
  reference's format and leaf paths: a rerun with other knobs recomputes,
  never restores, and each package resumes the other's run.
* ``recover(mesh=)`` holds the selection's TrainState sharded by
  ``dist.specs.state_pspecs`` and splits each batch over the data axes
  (``batch_pspecs``): a step gathers the selection, runs its slice,
  all-reduces the gradients and updates the rank's shard
  (``train.steps.mesh_value_and_grad`` / ``sharded_update``). Its
  checkpoints are the sharded layout (``ckpt.save(shardings=)``), and a
  resume restores each rank's block. One rank, or a mesh whose data axes
  are 1, gives one device's recovery bitwise.
* The result's ``params`` is a full spliced tree: ``PruneExecutor.recover``
  installs it as the report's ``updated_params``, ``export_packed``
  dumps the changed leaves, and ``launch.serve --masks-from`` splices
  them back.

The mask invariant holds wherever a pruned coordinate could leak:
trainable site weights are masked at init, gradients, moments and decay
are masked inside ``adamw.update``, and LoRA deltas are masked at merge.
Leaf names join dict keys with "." in sorted key order, the order
``jax.tree_util`` flattens a dict in, so the LoRA draw index, the
``weights/`` dump and the splice name the same leaves in both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from pathlib import Path

import torch

from repro_torch import ckpt
from repro_torch.core.packed import _copy_dicts as _copy
from repro_torch.dist import groups as groups_lib
from repro_torch.dist import placement
from repro_torch.core.packed import _get, _set
from repro_torch.models import ModelApi
from repro_torch.optim import adamw
from repro_torch.train import steps as steps_lib

SELECTIONS = ("norms", "biases", "norms_biases", "all_masked", "lora")

# leaf names that identify norm / bias params across the model families
# (transformer ln1/ln2/ln_f {scale, bias}; mamba2's norm_scale / dt_bias
# come with that family)
_NORM_KEYS = ("scale", "norm_scale")
_BIAS_KEYS = ("bias", "dt_bias")

_SPEC_KEYS = ("select", "steps", "lr", "weight_decay", "clip_norm",
              "warmup_frac", "min_lr_frac", "b1", "b2", "batch_size",
              "seq_len", "seed", "lora_rank")


@dataclasses.dataclass(frozen=True)
class RecoverSpec:
    """What to retrain after pruning, and how.

    ``select``:
        * "norms"        — norm scales only;
        * "biases"       — bias vectors only;
        * "norms_biases" — both (the PERP default);
        * "all_masked"   — the pruned projections themselves, gradients
          masked so pruned coordinates stay exactly zero;
        * "lora"         — rank-``lora_rank`` adapters per pruned site;
          the merged ``(W + B@A) * mask`` is what gets spliced and served.

    ``batch_size`` / ``seq_len`` / ``seed`` pin the calibration stream:
    the accumulator's ``calibration_batches`` arguments replay the batches
    calibration consumed.
    """

    select: str = "norms_biases"
    steps: int = 50
    lr: float = 1e-3
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    warmup_frac: float = 0.1
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    batch_size: int = 4
    seq_len: int = 128
    seed: int = 0
    lora_rank: int = 4

    def __post_init__(self):
        if self.select not in SELECTIONS:
            raise ValueError(f"unknown select {self.select!r}; "
                             f"have {SELECTIONS}")
        if self.steps < 0:
            raise ValueError(f"steps must be >= 0, got {self.steps}")
        if self.lora_rank < 1:
            raise ValueError(f"lora_rank must be >= 1, got {self.lora_rank}")

    def opt_config(self) -> adamw.AdamWConfig:
        return adamw.AdamWConfig(
            lr=self.lr, b1=self.b1, b2=self.b2,
            weight_decay=self.weight_decay, clip_norm=self.clip_norm,
            warmup_steps=max(1, int(self.warmup_frac * self.steps)),
            total_steps=max(self.steps, 1),
            min_lr_frac=self.min_lr_frac)

    def to_json_dict(self) -> dict:
        return {k: getattr(self, k) for k in _SPEC_KEYS}

    @classmethod
    def from_json_dict(cls, d: dict) -> "RecoverSpec":
        unknown = set(d) - set(_SPEC_KEYS)
        if unknown:
            raise ValueError(f"unknown RecoverSpec keys {sorted(unknown)}")
        kw = dict(d)
        for k in ("steps", "batch_size", "seq_len", "seed", "lora_rank"):
            if k in kw:
                kw[k] = int(kw[k])
        return cls(**kw)

    def fingerprint(self) -> str:
        """Content hash keying the ``<ckpt_dir>/recover`` checkpoints."""
        return hashlib.sha256(json.dumps(
            self.to_json_dict(), sort_keys=True).encode()).hexdigest()[:16]

    def describe(self) -> str:
        return (f"select={self.select} steps={self.steps} lr={self.lr:.1e} "
                f"wd={self.weight_decay:g} clip={self.clip_norm:g} "
                f"batch={self.batch_size}x{self.seq_len} seed={self.seed}"
                + (f" rank={self.lora_rank}" if self.select == "lora"
                   else ""))


@dataclasses.dataclass
class RecoverResult:
    """Recovered params + the run's accounting."""

    params: dict                  # full tree, splice-ready (updated_params)
    spec: RecoverSpec
    trainable: dict               # the trained leaves (flat dotted names)
    trainable_count: int
    total_count: int
    steps_run: int                # steps executed by THIS call
    start_step: int               # where resume picked up (0 = fresh)
    ce_history: list              # per-step mean CE, this call only
    diverged: bool = False        # a non-finite CE halted the run; params
                                  # are the last checkpoint's (or the base
                                  # tree untouched), never the NaN state

    @property
    def trainable_frac(self) -> float:
        return self.trainable_count / max(self.total_count, 1)


# ---------------------------------------------------------------------------
# param selection
# ---------------------------------------------------------------------------

def _flat_leaves(tree, prefix: str = "") -> list:
    """[(dotted name, leaf)] in sorted key order — the naming
    ``export_packed``'s weight dump and ``core.packed._splice_weights``
    use."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flat_leaves(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _splice(base, flat: dict):
    """Copy of ``base`` with each dotted-name leaf replaced (cast to the
    base leaf's dtype)."""
    out = _copy(base)
    for name, leaf in flat.items():
        path = tuple(name.split("."))
        _set(out, path, leaf.to(_get(base, path).dtype))
    return out


@dataclasses.dataclass
class _Selection:
    trainable: dict               # flat {dotted name: leaf} to train
    merge: object                 # (base, trainable) -> full params
    opt_masks: dict | None        # masks for adamw.update (same keys)


def _norm_bias_selection(params, select: str) -> _Selection:
    keys = {"norms": _NORM_KEYS, "biases": _BIAS_KEYS,
            "norms_biases": _NORM_KEYS + _BIAS_KEYS}[select]
    trainable = {name: leaf.clone() for name, leaf in _flat_leaves(params)
                 if name.rsplit(".", 1)[-1] in keys}
    return _Selection(trainable=trainable, merge=_splice, opt_masks=None)


def _mask_sites(masks) -> dict:
    """Flat {dotted param name: mask leaf} of every masked site."""
    return dict(_flat_leaves(masks))


def _all_masked_selection(params, masks) -> _Selection:
    sites = _mask_sites(masks)
    # masked at init: the invariant holds from step 0, and
    # adamw.update(masks=) keeps it (gradients, moments, decay masked)
    trainable = {}
    for name, m in sites.items():
        w = _get(params, tuple(name.split(".")))
        trainable[name] = w * m.to(w.dtype)
    return _Selection(trainable=trainable, merge=_splice, opt_masks=sites)


def _lora_selection(params, masks, spec: RecoverSpec) -> _Selection:
    from repro_torch.serve import _threefry

    sites = _mask_sites(masks)
    trainable = {}
    for i, (name, _) in enumerate(sorted(sites.items())):
        w = _get(params, tuple(name.split(".")))
        *stack, d_out, d_in = w.shape
        r = min(spec.lora_rank, d_out, d_in)
        # the reference's 0.01 * jax.random.normal(fold_in(key(seed), i))
        key = _threefry.fold_in(
            _threefry.seed_key(torch.tensor([spec.seed], device=w.device)),
            torch.tensor([i], device=w.device))
        # B zero-initialised: the adapter starts as the identity delta
        trainable[name] = {
            "a": 0.01 * _threefry.normal(key, (*stack, r, d_in)),
            "b": torch.zeros((*stack, d_out, r), dtype=torch.float32,
                             device=w.device)}

    def merge(base, tr):
        out = _copy(base)
        for name, ab in tr.items():
            path = tuple(name.split("."))
            w = _get(base, path)
            delta = torch.matmul(ab["b"], ab["a"])
            m = sites[name].to(torch.float32)
            _set(out, path, ((w.to(torch.float32) + delta) * m).to(w.dtype))
        return out

    return _Selection(trainable=trainable, merge=merge, opt_masks=None)


def build_selection(params, masks, spec: RecoverSpec) -> _Selection:
    if spec.select in ("norms", "biases", "norms_biases"):
        sel = _norm_bias_selection(params, spec.select)
    elif spec.select == "all_masked":
        sel = _all_masked_selection(params, masks)
    else:
        sel = _lora_selection(params, masks, spec)
    if not sel.trainable:
        raise ValueError(
            f"select={spec.select!r} matched no params of this model "
            "(e.g. 'biases' on an rmsnorm family) — pick another rule")
    return sel


# ---------------------------------------------------------------------------
# the training step and the recovery loop
# ---------------------------------------------------------------------------

def _make_step(api: ModelApi, masks, sel: _Selection,
               opt_cfg: adamw.AdamWConfig,
               layout: placement.Layout | None = None):
    """(base, state, batch) -> (state, metrics); ``base`` is the frozen
    full tree, the state's params the trainable leaves (this rank's
    shards of them on ``layout``'s mesh)."""
    if layout is not None:
        mesh = layout.mesh

        def mesh_step(base, state, batch):
            tr = placement.gather(state.params, layout.specs.params, mesh)
            loss, aux, grads = steps_lib.mesh_value_and_grad(
                api, lambda t: sel.merge(base, t), tr, batch, mesh,
                masks=masks)
            new_state, om = steps_lib.sharded_update(
                opt_cfg, grads, state, layout, masks=sel.opt_masks)
            return new_state, {"loss": loss, "ce": aux["ce"], **om}

        return mesh_step

    def step(base, state, batch):
        def loss_fn(tr):
            return api.loss(sel.merge(base, tr), batch, masks=masks)

        (loss, aux), grads = steps_lib.value_and_grad(loss_fn, state.params)
        new_tr, new_opt, om = adamw.update(
            opt_cfg, grads, state.opt, state.params, masks=sel.opt_masks)
        metrics = {"loss": loss, "ce": aux["ce"].detach(), **om}
        return steps_lib.TrainState(new_tr, new_opt), metrics

    return step


def _calib_batch_fn(cfg, spec: RecoverSpec, device):
    """step -> batch, on the calibration split and seed protocol of
    ``calibrate.calibration_batches`` (frontend embeddings included)."""
    from repro_torch.data import synthetic

    corpus = synthetic.CorpusConfig(cfg.vocab_size, seed=spec.seed)
    pipe = synthetic.DataPipeline(corpus, spec.batch_size, spec.seq_len,
                                  split="calib", device=device)
    return lambda i: synthetic.with_modality(pipe.get(i), cfg, spec.seed, i)


def _try_resume(rdir: Path, spec: RecoverSpec, state, layout=None,
                like=None):
    """(start_step, state) from the newest matching recovery checkpoint;
    on ``layout``'s mesh each rank's block of it (``like``: the whole
    state's shapes)."""
    step = ckpt.latest_valid(rdir)
    if step is None:
        return 0, state
    man_path = rdir / f"step_{step:08d}" / "MANIFEST.json"
    try:
        man = json.loads(man_path.read_text())
    except (OSError, json.JSONDecodeError):
        return 0, state
    if man.get("extra", {}).get("recover_spec") != spec.fingerprint():
        return 0, state
    try:
        if layout is None:
            tree, _ = ckpt.restore_like(rdir, step, state)
        else:
            tree, _ = ckpt.restore_like(rdir, step, like,
                                        device=_device_of(state.params),
                                        shardings=layout)
    except (KeyError, ValueError, OSError):
        return 0, state
    return min(step, spec.steps), tree


def _device_of(tree) -> torch.device:
    return adamw.tree_leaves(tree)[0].device


def recover(api: ModelApi, params, masks, spec: RecoverSpec | None = None,
            *, mesh=None, ckpt_dir=None, checkpoint_every: int = 0,
            batches=None, verbose: bool = False) -> RecoverResult:
    """Masked-gradient recovery of a pruned model (see module docstring).

    Args:
        params: the pruning run's weights — pass the executed report's
            ``updated_params`` when set (sparsegpt), so recovery trains
            on top of the refiner's updates. Batches and the train state
            live on their device.
        masks: the executed plan's mask tree (``PruneReport.masks``).
        spec: a ``RecoverSpec``; default ``RecoverSpec()``.
        mesh: shard the train state (``state_pspecs``) and the batches
            (``batch_pspecs``) over this mesh; every rank calls it with
            the same arguments and ends with the whole result.
        ckpt_dir: the executor's checkpoint root; recovery state lives
            under ``<ckpt_dir>/recover`` keyed by ``spec.fingerprint()``.
        checkpoint_every: persist the TrainState every k steps (plus a
            final save), enabling mid-recovery resume.
        batches: optional explicit batch list (cycled); default draws
            the spec's calibration stream.
    """
    spec = spec if spec is not None else RecoverSpec()
    sel = build_selection(params, masks, spec)
    opt_cfg = spec.opt_config()
    state = steps_lib.TrainState(sel.trainable, adamw.init(sel.trainable))
    trainable_count = sum(t.numel() for t in adamw.tree_leaves(sel.trainable))
    total_count = sum(t.numel() for t in adamw.tree_leaves(params))
    layout = like = None
    if mesh is not None:
        layout = steps_lib.state_layout(api, mesh, state)
        like = placement.like(state)
        state = steps_lib.shard_state(state, layout)

    get_batch = _calib_batch_fn(api.cfg, spec, _device_of(params))
    if batches is not None:
        pool = list(batches)
        get_batch = lambda i: pool[i % len(pool)]  # noqa: E731

    step_fn = (_make_step(api, masks, sel, opt_cfg) if layout is None
               else _make_step(api, masks, sel, opt_cfg, layout))
    rdir = Path(ckpt_dir) / "recover" if ckpt_dir is not None else None
    start = 0
    if rdir is not None:
        start, state = _try_resume(rdir, spec, state, layout, like)
        if verbose and start:
            print(f"  recover: resumed at step {start}")

    def save(step_no: int):
        if rdir is None or not checkpoint_every:
            return
        if step_no in ckpt.steps(rdir):
            return
        ckpt.save(rdir, step_no, state,
                  extra={"recover_spec": spec.fingerprint()},
                  shardings=layout)
        if groups_lib.is_main(mesh):
            ckpt.gc(rdir, keep=2)

    ce_hist: list[float] = []
    diverged = False
    steps_run = 0
    for i in range(start, spec.steps):
        state, m = step_fn(params, state, get_batch(i))
        ce = float(m["ce"])
        if not math.isfinite(ce):
            # divergence guard: never splice a NaN/Inf state into
            # updated_params — halt and fall back below
            diverged = True
            if verbose:
                print(f"  recover: non-finite ce at step {i} — halting")
            break
        ce_hist.append(ce)
        steps_run += 1
        if verbose and (i % 10 == 0 or i == spec.steps - 1):
            print(f"  recover step {i:4d}  ce {ce:.4f}  "
                  f"lr {float(m['lr']):.2e}")
        if (i + 1) % max(checkpoint_every, 1) == 0:
            save(i + 1)
    if not diverged and spec.steps > start:
        save(spec.steps)

    restored = False
    if diverged and rdir is not None:
        # roll back to the newest fingerprint-matched checkpoint; the
        # poisoned in-flight state is discarded either way
        s2, state2 = _try_resume(rdir, spec, state, layout, like)
        if s2 > 0:
            state, restored = state2, True
            if verbose:
                print(f"  recover: restored checkpoint at step {s2}")

    if diverged and not restored:
        # no good checkpoint to fall back to: report the base tree
        # unchanged rather than garbage
        return RecoverResult(
            params=params, spec=spec, trainable={},
            trainable_count=trainable_count, total_count=total_count,
            steps_run=steps_run, start_step=start, ce_history=ce_hist,
            diverged=True)

    trained = state.params
    if layout is not None:
        trained = placement.gather(trained, layout.specs.params, mesh)
    with torch.no_grad():
        recovered = sel.merge(params, trained)
    return RecoverResult(
        params=recovered, spec=spec, trainable=trained,
        trainable_count=trainable_count, total_count=total_count,
        steps_run=steps_run, start_step=start, ce_history=ce_hist,
        diverged=diverged)
