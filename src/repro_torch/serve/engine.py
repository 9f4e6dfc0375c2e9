"""Batched sparse serving engine: pack once, serve from packed weights.

``ServeEngine`` takes a model and a mask source (an in-memory tree, a
``PruneReport``, or a masks checkpoint directory) and serves batched
prefill + greedy decode in one of four weight formats:

* ``dense``    — the unpruned baseline;
* ``masked``   — dense weights multiplied by 0/1 masks at every matmul
  (the arithmetic reference; zero bytes saved);
* ``nm24``     — N:M packed values + uint8 metadata through the spmm
  kernel (``kernels.ops.spmm``);
* ``gathered`` — per-row kept values + int32 columns through the same
  kernel.

Packing happens once, at construction (``core.packed.pack_tree``; its
time is ``pack_s``). ``generate`` runs one prefill and then a Python loop
of ``decode_step``s, greedy or sampled (``serve.sampling``); the cache
holds ``next_pow2(S + n_new)`` slots, as in the reference, whose extra
slots carry pos = -1 and are masked out. ``kernel_used`` records per
phase what the packed matmuls ran on, read from the launch counters:
"spmm" when the kernel launched, "plain" for a packed format on the CPU
(the kernel's plain version), "dense" for the dense and masked formats.

The continuous scheduler (``serve.scheduler``) drives three entry points
instead: ``prefill_session`` (one right-padded prompt), ``prefill_chunk``
(one window of a chunked prefill) and ``decode_chunk`` (``n_steps``
decode steps on the leading rows of the working cache). Torch has no jit;
the engine keeps the reference's compiled-function keys as its registry
of the shapes it has run (``compiled_fn_keys``), the keys under which a
decode loop would be captured as a CUDA graph. ``decode_chunk`` makes no
host read inside its loop: per-row clocks, sampling knobs and the
active mask stay on the device. Meshes are not ported (ROADMAP A5, item
2: serving on a mesh).

``bench_rows`` gives one prefill row and one decode row per format.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import torch

from repro_torch.core import packed as packed_lib
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import ModelApi
from repro_torch.models import attention as attn
from repro_torch.models.transformer import DecodeCache
from repro_torch.train import steps as steps_lib

from . import sampling as sampling_lib

FORMATS = ("dense", "masked", "nm24", "gathered")


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (the cache's size bucket)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class ServeResult:
    """One timed generate() call."""

    tokens: torch.Tensor       # (B, n_new) int64
    prefill_s: float
    decode_s: float
    n_new: int
    batch: int

    @property
    def tok_s(self) -> float:
        """Decode throughput (the serving steady state); with one new
        token there is no decode step, so end-to-end throughput."""
        steps = self.n_new - 1
        if steps <= 0:
            return self.batch * self.n_new / max(
                self.prefill_s + self.decode_s, 1e-9)
        return self.batch * steps / max(self.decode_s, 1e-9)


class ServeEngine:
    """Pack once at startup, then serve batched prefill/decode.

    Args:
        api/params: the model to serve (dense weights).
        masks: mask source for the sparse formats — a masks tree, a
            ``PruneReport`` (its ``updated_params`` served where set), or
            a pruning-run directory (a masks-tree checkpoint, executor
            ``groups/``, a launcher ``--out-dir`` or ``export_packed``
            root, with their updated weights spliced in; see
            ``core.packed.load_masks_and_weights``). Required for
            ``masked``, ``nm24`` and ``gathered``.
        fmt: one of ``FORMATS``.
        device: where to serve; "cuda" unless asked for the CPU. Params
            and masks move there; raises when the card is missing.
    """

    def __init__(self, api: ModelApi, params: dict, *, masks=None,
                 fmt: str = "masked", device="cuda"):
        if fmt not in FORMATS:
            raise ValueError(f"unknown serve format {fmt!r} "
                             f"(want one of {FORMATS})")
        self.api = api
        self.cfg = api.cfg
        self.fmt = fmt
        self.device = resolve_device(device)
        params = _to(params, self.device)
        if fmt == "dense":
            masks = None           # baseline: original weights, no masks
        else:
            masks, params = self._resolve_masks(params, masks)
            if masks is None:
                raise ValueError(f"format {fmt!r} needs masks "
                                 "(tree, PruneReport, or checkpoint dir)")
            masks = _to(masks, self.device)
        _sync(self.device)
        t0 = time.perf_counter()
        if fmt in ("nm24", "gathered"):
            self.params = packed_lib.pack_tree(self.cfg, params, masks, fmt)
            self.masks = None
        else:
            self.params = params
            self.masks = masks if fmt == "masked" else None
        _sync(self.device)
        self.pack_s = time.perf_counter() - t0
        self._prefill, self._decode = steps_lib.make_serve_steps(
            api, masks=self.masks)
        self.kernel_used: dict[str, str] = {}
        self._fns: set = set()          # shape keys of the scheduler entries
        # fault-injection seam: called as hook(phase) inside the timed
        # dispatch region of every scheduler-facing entry point, so an
        # injected slow step lands in the measured lane time exactly like
        # a real straggler (serve.faultinject)
        self.dispatch_hook = None

    def _resolve_masks(self, params, masks):
        """-> (masks tree | None, params): a checkpoint source may carry
        updated weights (sparsegpt, recovery), a report may too."""
        if masks is None or isinstance(masks, dict):
            return masks, params
        if isinstance(masks, (str, Path)):
            return packed_lib.load_masks_and_weights(self.cfg, params, masks)
        if hasattr(masks, "masks"):           # PruneReport
            if getattr(masks, "updated_params", None) is not None:
                params = _to(masks.updated_params, self.device)
            return masks.masks, params
        raise TypeError(f"cannot interpret masks source {type(masks)!r}")

    # -- accounting ---------------------------------------------------------

    def weight_bytes(self) -> int:
        """Resident weight bytes this engine serves from (masks included:
        the masked path keeps them in memory)."""
        total = packed_lib.packed_bytes(self.params)
        if self.masks is not None:
            total += packed_lib.packed_bytes(self.masks)
        return total

    # -- serving ------------------------------------------------------------

    @torch.no_grad()
    def _greedy_loop(self, prompt: dict, n_new: int, *,
                     want_logits: bool = False, sampling=None):
        """One prefill, then n_new - 1 decode steps.

        Returns (tokens (B, n_new), logits (n_new, B, V) fp32 or None,
        prefill_s, decode_s); each time ends in a device synchronize.
        ``sampling`` is None for greedy, else a ``SamplingParams`` (or one
        per batch row): the token at absolute position p draws from
        ``fold_in(key(seed), p)``, the key the continuous scheduler uses,
        so a request replays identically on both paths.
        """
        tokens = prompt["tokens"].to(self.device)
        batch = {"tokens": tokens}
        if "n_valid" in prompt:
            batch["n_valid"] = prompt["n_valid"]
        for key in ("img", "src"):      # a cross-attention family's states
            if key in prompt:
                batch[key] = prompt[key].to(self.device)
        B, S = tokens.shape
        samp = {"greedy": True}
        if sampling is not None:
            per_row = sampling if isinstance(sampling, (list, tuple)) \
                else [sampling] * B
            samp = sampling_lib.params_arrays(list(per_row), self.device)
        cache = self.api.init_cache(self.params, B, next_pow2(S + n_new))
        trace = []
        _sync(self.device)
        l0 = _spmm_launches()
        t0 = time.perf_counter()
        logits, cache = self._prefill(self.params, batch, cache)
        tok = sampling_lib.sample(logits[:, -1], samp, S)
        if want_logits:
            trace.append(logits[:, -1].float())
        _sync(self.device)
        t1 = time.perf_counter()
        l1 = _spmm_launches()
        toks = [tok]
        for _ in range(n_new - 1):
            logits, cache = self._decode(self.params, tok[:, None], cache)
            # the post-step clock is the absolute position of the token
            # being sampled (its PRNG key index)
            tok = sampling_lib.sample(logits[:, -1], samp, cache.t)
            toks.append(tok)
            if want_logits:
                trace.append(logits[:, -1].float())
        out = torch.stack(toks, dim=1)
        _sync(self.device)
        t2 = time.perf_counter()
        self.kernel_used["prefill"] = kernel_summary(self.fmt, l1 - l0)
        if n_new > 1:
            self.kernel_used["decode"] = kernel_summary(
                self.fmt, _spmm_launches() - l1)
        logits_trace = torch.stack(trace) if want_logits else None
        return out, logits_trace, t1 - t0, t2 - t1

    def generate(self, prompt: dict, n_new: int, *,
                 sampling=None) -> ServeResult:
        """Batched prefill + ``n_new`` tokens, timed: greedy when
        ``sampling`` is None, else sampled with per-request seeds (a
        ``SamplingParams``, or a list of one per batch row)."""
        tokens, _, prefill_s, decode_s = self._greedy_loop(
            prompt, n_new, sampling=sampling)
        return ServeResult(tokens=tokens, prefill_s=prefill_s,
                           decode_s=decode_s, n_new=n_new,
                           batch=tokens.shape[0])

    def logits_trace(self, prompt: dict, n_new: int) -> torch.Tensor:
        """(n_new, B, vocab) fp32 greedy logits — the parity-test surface."""
        return self._greedy_loop(prompt, n_new, want_logits=True)[1]

    # -- continuous-batching entry points (driven by serve.scheduler) -------

    @property
    def supports_continuous(self) -> bool:
        """Continuous batching needs the plain decoder-only KV layout:
        per-token pages and a per-row decode clock, which every model of
        ``models.transformer`` has, dense or MoE. The recurrent families
        (``models.zamba``, ``models.rwkv_model``) carry a state, not
        per-token KV, and are refused, as the reference refuses them; so
        are the cross-attention families: a VLM (this module, with
        ``cross_attn_every``) and an encoder-decoder (``models.encdec``),
        whose cross KV is a second cache no page holds.

        An MoE block dispatches per batch row (``models.moe``: groups of
        ``moe_group_size`` positions where that divides the row, else the
        whole row), so under the scheduler:

        * a decode step is one token a row: its group gets capacity(1) = 1
          slot an expert and never drops (a token's top-k experts are
          distinct); the buffer is (E, bucket, d) and inactive rows route
          on their own, so a row's result does not depend on its
          neighbours;
        * ``prefill_session`` pads to S_bucket and dispatches with
          capacity(S_bucket), or in groups of ``moe_group_size`` where that
          divides S_bucket; ``prefill_chunk`` dispatches each W-token
          window with capacity(W); ``generate`` with capacity(S);
        * padding sits after the real tokens and the stable sort ranks it
          last, so padding never takes a real token's slot.

        Where a group drops tokens (``models.moe.count_drops``), chunked
        and one-shot prefill therefore compute different functions, as in
        the reference."""
        from repro_torch.models import transformer
        return (self.api.module is transformer
                and not getattr(self.cfg, "cross_attn_every", 0))

    def _require_continuous(self):
        if not self.supports_continuous:
            raise NotImplementedError(
                f"continuous batching supports plain decoder-only "
                f"transformers; {self.cfg.name!r} is not one")

    def _scalar(self, n) -> torch.Tensor:
        """A () int64 tensor on the engine's device (no host read of a
        tensor argument)."""
        return torch.as_tensor(n, dtype=torch.int64).to(self.device)

    def _enter(self, key: tuple, phase: str) -> int:
        self._fns.add(key)
        if self.dispatch_hook is not None:
            self.dispatch_hook(phase)
        return _spmm_launches()

    def _leave(self, phase: str, launches0: int) -> None:
        _sync(self.device)
        self.kernel_used[phase] = kernel_summary(
            self.fmt, _spmm_launches() - launches0)

    @torch.no_grad()
    def prefill_session(self, tokens: torch.Tensor, n_valid, samp: dict):
        """Prefill ONE session from a right-padded prompt row.

        ``tokens`` is (1, S_bucket) with the real prompt in the first
        ``n_valid`` positions; ``samp`` holds (1,) sampling knobs
        (``sampling.params_arrays``). Returns ``(tok0 (1,), k (L,
        S_bucket, kvH, dh), v)``: the first generated token (sampled at
        PRNG position ``n_valid``) and the dense cache row to scatter
        into pages. One shape per S_bucket: ``n_valid`` goes to the
        device as a tensor.
        """
        self._require_continuous()
        s_bucket = tokens.shape[1]
        l0 = self._enter(("prefill_session", s_bucket), "prefill")
        nv = self._scalar(n_valid)
        cache = self.api.init_cache(self.params, 1, s_bucket)
        logits, cache = self.api.prefill(
            self.params, {"tokens": tokens.to(self.device), "n_valid": nv},
            cache, masks=self.masks)
        tok0 = sampling_lib.sample(logits[:, -1], samp, nv)
        self._leave("prefill", l0)
        return tok0, cache.kv.k[:, 0], cache.kv.v[:, 0]

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, offset, n_valid,
                      cache: DecodeCache, samp: dict):
        """One fixed-width window of a chunked prefill (B = 1).

        ``tokens`` is (1, W), the prompt slice at absolute positions
        ``[offset, offset + W)`` (the final window right-pads past
        ``n_valid``); ``cache`` is the session's continuation cache
        (B = 1, capacity = the prompt's pow2 bucket) holding the earlier
        windows' KV, written in place. Returns ``(tok0 (1,), cache')``:
        the token sampled from the last real position seen so far (only
        the FINAL window's is the request's first token). One shape per
        (W, capacity): ``offset`` and ``n_valid`` go to the device as
        tensors.
        """
        self._require_continuous()
        w = tokens.shape[1]
        capacity = cache.kv.k.shape[2]
        l0 = self._enter(("prefill_chunk", w, capacity), "prefill")
        nv = self._scalar(n_valid)
        logits, cache = self.api.prefill_window(
            self.params, {"tokens": tokens.to(self.device),
                          "offset": self._scalar(offset), "n_valid": nv},
            cache, masks=self.masks)
        tok0 = sampling_lib.sample(logits[:, -1], samp, nv)
        self._leave("prefill", l0)
        return tok0, cache

    @torch.no_grad()
    def decode_chunk(self, tok: torch.Tensor, cache: DecodeCache,
                     active: torch.Tensor, samp: dict, *, n_steps: int,
                     bucket: int):
        """Run ``n_steps`` decode steps on rows ``[:bucket]`` of the
        full-width working cache (in place); rows beyond the bucket are
        untouched.

        ``tok`` (B,) holds each slot's last token, ``active`` (B,) bool
        masks live slots: inactive rows hold their token and FREEZE their
        clock (their in-step KV write lands past their session length,
        where the contiguity contract says garbage lives). ``cache.t`` is
        the (B,) per-row clock. Returns ``(toks (n_steps, bucket),
        cache)``. The loop reads nothing back to the host.
        """
        self._require_continuous()
        l0 = self._enter(("chunk", n_steps, bucket), "decode")
        kv = cache.kv
        sub = DecodeCache(kv=attn.KVCache(kv.k[:, :bucket], kv.v[:, :bucket],
                                          kv.pos[:, :bucket]),
                          t=cache.t[:bucket])
        act = active[:bucket]
        tk = tok[:bucket]
        out = []
        for _ in range(n_steps):
            logits, c2 = self.api.decode_step(self.params, tk[:, None], sub,
                                              masks=self.masks)
            nxt = sampling_lib.sample(logits[:, -1], samp, c2.t,
                                      rows=bucket)
            tk = torch.where(act, nxt, tk)
            sub = c2._replace(t=torch.where(act, c2.t, sub.t))
            out.append(tk)
        cache.t[:bucket] = sub.t
        toks = torch.stack(out)
        self._leave("decode", l0)
        return toks, cache

    def compiled_fn_keys(self) -> list:
        """The shape keys the scheduler entry points have run, as the
        reference's compiled-function keys."""
        return sorted(self._fns, key=repr)


def _spmm_launches() -> int:
    """spmm kernel launches so far, stacked (MoE experts) included."""
    return ops.LAUNCHES["spmm"] + ops.LAUNCHES["spmm_stacked"]


def kernel_summary(fmt: str, launches: int) -> str:
    """What a phase's packed matmuls ran on, from its spmm launches:
    "spmm" when the kernel launched, "plain" for a packed format on the
    CPU, "dense" for the dense and masked formats."""
    if launches:
        return "spmm"
    return "plain" if fmt in ("nm24", "gathered") else "dense"


def bench_rows(api: ModelApi, params: dict, masks, prompt: dict,
               n_new: int, *, formats=("dense", "masked", "nm24"),
               repeats: int = 3, device="cuda") -> list:
    """Dense vs masked vs packed serving rows: a prefill row and a decode
    row per format.

    Shared keys: ``variant``, ``kernel`` ("spmm" for the packed formats,
    else "dense"), ``kernel_used`` (what the phase launched), ``tok_s``
    (best warm repeat), ``weight_bytes``, ``pack_s``. Prefill rows add
    ``prefill_s`` (best warm; tok_s = batch · prompt_len / prefill_s);
    decode rows add ``cold_tok_s`` (the first call). Repeats run
    round-robin over the engines, so drift biases no single format.
    """
    B, S = prompt["tokens"].shape
    engines, cold = {}, {}
    for fmt in formats:
        engines[fmt] = ServeEngine(api, params, fmt=fmt, device=device,
                                   masks=masks if fmt != "dense" else None)
        cold[fmt] = engines[fmt].generate(prompt, n_new)
    warm: dict = {fmt: [] for fmt in formats}
    for _ in range(repeats):
        for fmt in formats:
            warm[fmt].append(engines[fmt].generate(prompt, n_new))
    rows = []
    for fmt in formats:
        eng = engines[fmt]
        base = {"variant": fmt,
                "kernel": "spmm" if fmt in ("nm24", "gathered") else "dense",
                "weight_bytes": eng.weight_bytes(), "pack_s": eng.pack_s}
        prefill_s = min(r.prefill_s for r in warm[fmt])
        rows.append({**base, "phase": "prefill",
                     "kernel_used": eng.kernel_used.get("prefill", "dense"),
                     "prefill_s": prefill_s,
                     "tok_s": B * S / max(prefill_s, 1e-9)})
        rows.append({**base, "phase": "decode",
                     "kernel_used": eng.kernel_used.get("decode", "dense"),
                     "cold_tok_s": cold[fmt].tok_s,
                     "tok_s": max(r.tok_s for r in warm[fmt])})
    return rows
