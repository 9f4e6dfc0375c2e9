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
of ``decode_step``s; the cache holds ``next_pow2(S + n_new)`` slots, as
in the reference, whose extra slots carry pos = -1 and are masked out.
``kernel_used`` records per phase what the packed matmuls ran on, read
from the launch counters: "spmm" when the kernel launched, "plain" for a
packed format on the CPU (the kernel's plain version), "dense" for the
dense and masked formats. Capturing the decode loop in a CUDA graph,
continuous batching, sampling and meshes are not ported yet.

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
from repro_torch.train import steps as steps_lib

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
            ``PruneReport``, or a checkpoint directory (a masks-tree
            checkpoint or a launcher ``--out-dir`` root; see
            ``core.packed.load_mask_tree``). Required for ``masked``,
            ``nm24`` and ``gathered``.
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
            masks = self._resolve_masks(params, masks)
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

    def _resolve_masks(self, params, masks):
        if masks is None or isinstance(masks, dict):
            return masks
        if isinstance(masks, (str, Path)):
            return packed_lib.load_mask_tree(self.cfg, params, masks)
        if hasattr(masks, "masks"):           # PruneReport
            return masks.masks
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
                     want_logits: bool = False):
        """One prefill, then n_new - 1 greedy decode steps.

        Returns (tokens (B, n_new), logits (n_new, B, V) fp32 or None,
        prefill_s, decode_s); each time ends in a device synchronize.
        """
        tokens = prompt["tokens"].to(self.device)
        batch = {"tokens": tokens}
        if "n_valid" in prompt:
            batch["n_valid"] = prompt["n_valid"]
        B, S = tokens.shape
        cache = self.api.init_cache(self.params, B, next_pow2(S + n_new))
        trace = []
        _sync(self.device)
        l0 = ops.LAUNCHES["spmm"]
        t0 = time.perf_counter()
        logits, cache = self._prefill(self.params, batch, cache)
        tok = torch.argmax(logits[:, -1], dim=-1)
        if want_logits:
            trace.append(logits[:, -1].float())
        _sync(self.device)
        t1 = time.perf_counter()
        l1 = ops.LAUNCHES["spmm"]
        toks = [tok]
        for _ in range(n_new - 1):
            logits, cache = self._decode(self.params, tok[:, None], cache)
            tok = torch.argmax(logits[:, -1], dim=-1)
            toks.append(tok)
            if want_logits:
                trace.append(logits[:, -1].float())
        out = torch.stack(toks, dim=1)
        _sync(self.device)
        t2 = time.perf_counter()
        self.kernel_used["prefill"] = self._kernel_tag(l1 - l0)
        if n_new > 1:
            self.kernel_used["decode"] = self._kernel_tag(
                ops.LAUNCHES["spmm"] - l1)
        logits_trace = torch.stack(trace) if want_logits else None
        return out, logits_trace, t1 - t0, t2 - t1

    def _kernel_tag(self, launches: int) -> str:
        if launches:
            return "spmm"
        return "plain" if self.fmt in ("nm24", "gathered") else "dense"

    def generate(self, prompt: dict, n_new: int) -> ServeResult:
        """Batched prefill + ``n_new`` greedy tokens, timed."""
        tokens, _, prefill_s, decode_s = self._greedy_loop(prompt, n_new)
        return ServeResult(tokens=tokens, prefill_s=prefill_s,
                           decode_s=decode_s, n_new=n_new,
                           batch=tokens.shape[0])

    def logits_trace(self, prompt: dict, n_new: int) -> torch.Tensor:
        """(n_new, B, vocab) fp32 greedy logits — the parity-test surface."""
        return self._greedy_loop(prompt, n_new, want_logits=True)[1]


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
