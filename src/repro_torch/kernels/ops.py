"""Public wrappers around the hand-written CUDA kernels.

Each wrapper checks device, dtype and shapes, allocates its outputs with
``torch.empty`` and then:

* a CUDA tensor launches the kernel — or raises (no build, no launch, a
  bad argument): nothing falls back to the plain version on the card;
* a CPU tensor takes the kernel's plain PyTorch version, which lives
  beside the launcher in the kernel's module.

``LAUNCHES[name]`` counts kernel launches (never plain-version calls), so
a run can show which kernels its main path went through: one per wrapper
call that launched. The Gram counts its two input paths apart:
``gram_xtx`` (fp32, CUDA cores) and ``gram_xtx_bf16`` (tensor cores), and
its stacked calls (one launch for every expert of an MoE tap) apart again:
``gram_xtx_stacked`` and ``gram_xtx_stacked_bf16``; ``spmm_stacked`` counts
the stacked spmm calls (every expert in one launch). An
spmm call that splits d_in runs two CUDA kernels
(the product and the ordered sum of its fp32 partials) and counts one;
so does a swap_topk call (the Gram's preparation, the p-tiles' search and
the merge of their lists), a swap_argmin call (the same preparation and
search, then the selection of the best pair) and a swap_commit call (the
decisions, then their apply).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import swap_math as sm
from repro_torch.core.packed import PackedWeight

from . import gram as gram_mod
from . import spmm as spmm_mod
from . import swap_argmin as argmin_mod
from . import swap_topk as topk_mod

LAUNCHES: dict[str, int] = {"gram_xtx": 0, "gram_xtx_bf16": 0,
                            "gram_xtx_stacked": 0,
                            "gram_xtx_stacked_bf16": 0,
                            "swap_topk": 0, "swap_argmin": 0,
                            "swap_commit": 0, "spmm": 0, "spmm_stacked": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True when the inputs live on one CUDA device, False when all are on
    the CPU; raises on a mix."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def _check_swap_shapes(w, m, c, G) -> None:
    if w.ndim != 2 or w.shape != m.shape or w.shape != c.shape:
        raise ValueError(f"w, m, c must share one (R, d) shape: "
                         f"{tuple(w.shape)} {tuple(m.shape)} {tuple(c.shape)}")
    d = w.shape[1]
    if G.shape != (d, d):
        raise ValueError(f"G must be ({d}, {d}), got {tuple(G.shape)}")


def _swap_inputs(w, m, c, G):
    """a/b scoring and contiguous fp32 operands for the swap kernels."""
    w32 = w.float().contiguous()
    G32 = G.float().contiguous()
    a, b = sm.swap_scores(w32, m, c, torch.diagonal(G32))
    return a.contiguous(), b.contiguous(), w32, G32


def swap_argmin(w: torch.Tensor, m: torch.Tensor, c: torch.Tensor,
                G: torch.Tensor):
    """Jointly-best 1-swap per row: (ΔL*, u*, p*) each (R,); ties to the
    smallest flat index u·d + p; (+inf, 0, 0) where no pair is feasible;
    a NaN ΔL reads as +inf. On the card bitwise equal to the plain
    version. Indices are int64."""
    _check_swap_shapes(w, m, c, G)
    if not _on_cuda(w, m, c, G):
        return argmin_mod.swap_argmin_plain(w, m, c, G)
    a, b, w32, G32 = _swap_inputs(w, m, c, G)
    R = w.shape[0]
    best = torch.empty(R, dtype=torch.float32, device=w.device)
    u = torch.empty(R, dtype=torch.int32, device=w.device)
    p = torch.empty(R, dtype=torch.int32, device=w.device)
    argmin_mod.launch(a, b, w32, G32, best, u, p)
    LAUNCHES["swap_argmin"] += 1
    return best, u.long(), p.long()


def swap_topk(w: torch.Tensor, m: torch.Tensor, c: torch.Tensor,
              G: torch.Tensor, *, k: int):
    """k best candidate swaps per row: (ΔL, u, p) each (R, k), ascending by
    (ΔL, p). Equal to ``swap_math.topk_swaps_chunked`` on feasible entries;
    the +inf tail's indices are clamped into range. Indices are int64."""
    vals, u, p = _swap_topk(w, m, c, G, k=k)
    return vals, u.long(), p.long()


def _swap_topk(w, m, c, G, *, k: int):
    """``swap_topk`` with the indices as produced: int32 from the kernel,
    int64 from the plain version."""
    _check_swap_shapes(w, m, c, G)
    R, d = w.shape
    k = min(k, d)
    if not 1 <= k <= topk_mod.MAX_K:
        raise ValueError(f"swap_topk takes 1 <= k <= {topk_mod.MAX_K}, got {k}")
    if not _on_cuda(w, m, c, G):
        return topk_mod.swap_topk_plain(w, m, c, G, k=k)
    a, b, w32, G32 = _swap_inputs(w, m, c, G)
    vals = torch.empty((R, k), dtype=torch.float32, device=w.device)
    u = torch.empty((R, k), dtype=torch.int32, device=w.device)
    p = torch.empty((R, k), dtype=torch.int32, device=w.device)
    topk_mod.launch(a, b, w32, G32, vals, u, p, k=k)
    LAUNCHES["swap_topk"] += 1
    return vals, u, p


class GramFacts(NamedTuple):
    """What the candidate commit's apply kernel needs to know of G, taken
    once per refinement: whether G equals Gᵀ bit for bit (its columns are
    then read as contiguous rows) and max|G| (NaN or inf where G holds
    one), which bounds a rejected candidate's update."""

    symmetric: bool
    amax: float


def gram_facts(G: torch.Tensor) -> GramFacts:
    """``GramFacts`` of G: one compare of G with Gᵀ and one max-reduction
    pair over G (two host reads)."""
    G32 = G.float()
    amax = torch.maximum(G32.amax(), -G32.amin())       # NaN propagates
    return GramFacts(bool(torch.equal(G32, G32.T)), float(amax))


def swap_commit(w: torch.Tensor, m: torch.Tensor, c: torch.Tensor,
                G: torch.Tensor, dl: torch.Tensor, u: torch.Tensor,
                p: torch.Tensor, *, eps: float = 0.0,
                gram: GramFacts | None = None):
    """The candidate-space commit of a searched batch (dl, u, p) (R, k),
    u and p in [0, d): the greedy decisions
    (``swap_math.gather_candidate_stats`` + ``commit_decisions``, valid
    where dl is finite) and their apply (``apply_commits``' mask flips and
    Eq. 6 update). Returns (m', c', acc (R, k) 0/1 fp32, dls (R, k) fp32,
    0 where rejected). On the card one call of two kernels (the decisions
    read their sub-Grams from G; the apply streams c and m once), bitwise
    equal to the plain versions; m must be fp32 there. ``gram``: G's
    ``GramFacts``, taken here when not given."""
    _check_swap_shapes(w, m, c, G)
    R, d = w.shape
    k = dl.shape[-1]
    if dl.shape != (R, k) or not 1 <= k <= topk_mod.MAX_K:
        raise ValueError(f"swap_commit takes (R, k) = ({R}, k) candidates "
                         f"with 1 <= k <= {topk_mod.MAX_K}; got dl "
                         f"{tuple(dl.shape)}")
    for name, t in (("u", u), ("p", p)):
        if t.shape != (R, k):
            raise ValueError(f"{name} must be ({R}, {k}), got {tuple(t.shape)}")
    if not _on_cuda(w, m, c, G, dl, u, p):
        acc, dls = topk_mod.swap_commit_decide_plain(w, c, G, dl, u, p,
                                                     eps=eps)
        m2, c2 = topk_mod.swap_commit_apply_plain(w, m, c, G, acc, u, p)
        return m2, c2, acc, dls
    if m.dtype != torch.float32:
        raise ValueError(f"the commit kernel takes an fp32 mask, got {m.dtype}")
    w32, c32, G32 = (t.float().contiguous() for t in (w, c, G))
    m = m.contiguous()
    dl32 = dl.float().contiguous()
    u32, p32 = u.int().contiguous(), p.int().contiguous()
    if gram is None:
        gram = gram_facts(G32)
    acc = torch.empty((R, k), dtype=torch.float32, device=w.device)
    dls = torch.empty((R, k), dtype=torch.float32, device=w.device)
    m2, c2 = torch.empty_like(m), torch.empty_like(c32)
    if R:
        topk_mod.launch_commit(w32, m, c32, G32, u32, p32, dl32, acc, dls,
                               m2, c2, eps=eps, g_rows=gram.symmetric,
                               gmax=gram.amax)
        LAUNCHES["swap_commit"] += 1
    return m2, c2, acc, dls


def swap_topk_commit(w: torch.Tensor, m: torch.Tensor, c: torch.Tensor,
                     G: torch.Tensor, *, k: int, eps: float = 0.0,
                     gram: GramFacts | None = None):
    """One k-swap step with the candidate-space commit: the top-k search
    (``swap_topk``), then ``swap_commit`` on its candidates (on the card
    the two commit kernels, fed the search's int32 indices as they are).
    Returns (m', c', dl_sum (R,), n_accepted (R,)) like
    ``swap_math.commit_swaps``, and equal to it given the same candidates;
    the row sums are the plain version's torch ops. ``gram``: G's
    ``GramFacts``, taken once by the caller that refines over many passes
    (else in every call)."""
    dl, u, p = _swap_topk(w, m, c, G, k=k)
    m2, c2, acc, dls = swap_commit(w, m, c, G, dl, u, p, eps=eps, gram=gram)
    return m2, c2, dls.sum(1), acc.sum(1).to(torch.int64)


def gram_xtx(x: torch.Tensor) -> torch.Tensor:
    """Xᵀ X (fp32) for activations x: (..., tokens, d), fp32 or bf16; on
    the card exactly symmetric."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gram_xtx takes fp32 or bf16, got {x2.dtype}")
    if not _on_cuda(x2):
        return gram_mod.gram_xtx_plain(x2)
    d = x2.shape[1]
    if x2.numel() == 0:
        return torch.zeros((d, d), dtype=torch.float32, device=x2.device)
    out = torch.empty((d, d), dtype=torch.float32, device=x2.device)
    gram_mod.launch(x2[None], out[None])
    LAUNCHES["gram_xtx_bf16" if x2.dtype == torch.bfloat16
             else "gram_xtx"] += 1
    return out


def gram_xtx_stacked(x: torch.Tensor) -> torch.Tensor:
    """X_eᵀ X_e (fp32) per slice for x: (E, ..., tokens, d), fp32 or bf16
    -> (E, d, d): one Gram per MoE expert over its capacity buffer (zero
    slots add nothing). On the card one launch for all E, each slice
    bitwise ``gram_xtx`` of it and exactly symmetric."""
    if x.ndim < 2:
        raise ValueError(f"gram_xtx_stacked takes (E, ..., tokens, d), got "
                         f"{tuple(x.shape)}")
    x3 = x.reshape(x.shape[0], -1, x.shape[-1])
    if x3.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gram_xtx_stacked takes fp32 or bf16, got "
                         f"{x3.dtype}")
    if not _on_cuda(x3):
        return gram_mod.gram_xtx_stacked_plain(x3)
    E, T, d = x3.shape
    if x3.numel() == 0:
        return torch.zeros((E, d, d), dtype=torch.float32, device=x3.device)
    out = torch.empty((E, d, d), dtype=torch.float32, device=x3.device)
    gram_mod.launch(x3, out)
    LAUNCHES["gram_xtx_stacked_bf16" if x3.dtype == torch.bfloat16
             else "gram_xtx_stacked"] += 1
    return out


def _check_spmm_args(x: torch.Tensor, pw: PackedWeight, bias, act) -> None:
    """The checks ``spmm`` and ``spmm_stacked`` share (on the last two
    dims of values and idx)."""
    if pw.fmt not in ("nm24", "gathered"):
        raise ValueError(f"unknown packed format {pw.fmt!r}")
    d_out, k = pw.values.shape[-2:]
    if pw.idx.shape != pw.values.shape:
        raise ValueError(f"idx {tuple(pw.idx.shape)} and values "
                         f"{tuple(pw.values.shape)} differ in shape")
    if pw.fmt == "nm24" and (pw.d_in % pw.m or k != pw.d_in // pw.m * pw.n):
        raise ValueError(f"nm24 {pw.n}:{pw.m} over d_in={pw.d_in} needs "
                         f"k = {pw.d_in // max(pw.m, 1) * pw.n}, got {k}")
    if x.shape[-1] != pw.d_in:
        raise ValueError(f"x has {x.shape[-1]} features, the weight {pw.d_in}")
    if act not in spmm_mod._ACT_CODE:
        raise ValueError(f"unknown epilogue {act!r} "
                         f"(want one of {sorted(spmm_mod.EPILOGUES)} or None)")
    if bias is not None and bias.shape != (d_out,):
        raise ValueError(f"bias must be ({d_out},), got {tuple(bias.shape)}")


def _check_kernel_args(x2: torch.Tensor, pw: PackedWeight) -> None:
    """What the CUDA kernels take beyond ``_check_spmm_args``."""
    if x2.dtype not in (torch.float32, torch.bfloat16) or \
            pw.values.dtype != x2.dtype:
        raise ValueError(f"the spmm kernel takes fp32 or bf16 x with values "
                         f"of the same dtype, got {x2.dtype} and "
                         f"{pw.values.dtype}")
    want_idx = torch.uint8 if pw.fmt == "nm24" else torch.int32
    if pw.idx.dtype != want_idx:
        raise ValueError(f"{pw.fmt} idx must be {want_idx}, got {pw.idx.dtype}")
    if not (pw.values.is_contiguous() and pw.idx.is_contiguous()):
        raise ValueError("packed values and idx must be contiguous")
    if pw.fmt == "nm24" and pw.k % 8 == 0 and (pw.values.data_ptr() % 16
                                               or pw.idx.data_ptr() % 8):
        raise ValueError("nm24 values and idx with k % 8 == 0 must start "
                         "16 and 8 bytes aligned")


def spmm(x: torch.Tensor, pw: PackedWeight, *, bias=None,
         act: str | None = None) -> torch.Tensor:
    """act(x @ unpack(pw)ᵀ + bias) from an unstacked (d_out, k) packed
    leaf. x: (..., d_in) fp32 or bf16 -> (..., d_out) in x's dtype; the
    kernel takes values in x's dtype. ``bias`` (d_out,) and ``act`` (an
    ``EPILOGUES`` key) run on the fp32 sum. Each row's columns ascend
    strictly within [0, d_in) (nm24: positions below m, ascending within
    each block), as packing emits them; on the card a row that breaks
    this comes out NaN. With k % 8 == 0, nm24 values and idx start 16
    and 8 bytes aligned (the tensor cores' loader reads 8 slots at a
    time), as every per-layer slice of a packed tree does."""
    if pw.values.ndim != 2:
        raise ValueError(
            f"spmm wants an unstacked (d_out, k) PackedWeight; got values "
            f"of shape {tuple(pw.values.shape)} (a stack of experts goes to "
            f"spmm_stacked)")
    _check_spmm_args(x, pw, bias, act)
    d_out = pw.values.shape[0]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, pw.d_in)
    tensors = (x2, pw.values, pw.idx) + (() if bias is None else (bias,))
    if not _on_cuda(*tensors):
        return spmm_mod.spmm_plain(x2, pw, bias, act).reshape(*lead, d_out)
    _check_kernel_args(x2, pw)
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:                 # the kernel loads x 16 B at a time
        x2 = x2.clone()
    if bias is not None:
        bias = bias.float().contiguous()
    y = torch.empty((x2.shape[0], d_out), dtype=x2.dtype, device=x2.device)
    if x2.shape[0]:
        spmm_mod.launch(x2[None], pw, bias, act, y[None])
        LAUNCHES["spmm"] += 1
    return y.reshape(*lead, d_out)


def spmm_stacked(x: torch.Tensor, pw: PackedWeight, *, bias=None,
                 act: str | None = None) -> torch.Tensor:
    """Per-slice ``spmm`` over one stacked leading dim (MoE experts):
    x (E, ..., d_in), pw values / idx (E, d_out, k) -> (E, ..., d_out),
    y[e] = act(x[e] @ unpack(pw[e])ᵀ + bias) with one ``bias`` (d_out,)
    for every slice, as the reference's ``spmm_stacked``. On the card one
    launch for all E (each kernel takes the expert from its grid), each
    slice bitwise ``spmm`` of it; a CPU tensor takes
    ``spmm_stacked_plain``."""
    if pw.values.ndim != 3:
        raise ValueError(f"spmm_stacked wants a stacked (E, d_out, k) "
                         f"PackedWeight; got values of shape "
                         f"{tuple(pw.values.shape)}")
    _check_spmm_args(x, pw, bias, act)
    E, d_out = pw.values.shape[:2]
    if x.ndim < 2 or x.shape[0] != E:
        raise ValueError(f"x must be ({E}, ..., {pw.d_in}), got "
                         f"{tuple(x.shape)}")
    lead = x.shape[1:-1]
    x3 = x.reshape(E, -1, pw.d_in)
    tensors = (x3, pw.values, pw.idx) + (() if bias is None else (bias,))
    if not _on_cuda(*tensors):
        return spmm_mod.spmm_stacked_plain(x3, pw, bias, act).reshape(
            E, *lead, d_out)
    _check_kernel_args(x3, pw)
    x3 = x3.contiguous()
    if x3.data_ptr() % 16:
        x3 = x3.clone()
    if bias is not None:
        bias = bias.float().contiguous()
    y = torch.empty((E, x3.shape[1], d_out), dtype=x3.dtype,
                    device=x3.device)
    if x3.shape[1] and E:
        spmm_mod.launch(x3, pw, bias, act, y)
        LAUNCHES["spmm_stacked"] += 1
    return y.reshape(E, *lead, d_out)


def spmm_nm24(x: torch.Tensor, values: torch.Tensor, idx: torch.Tensor, *,
              n: int = 2, m: int = 4, d_in: int | None = None, bias=None,
              act: str | None = None) -> torch.Tensor:
    """x @ (packed N:M weight)ᵀ with the epilogue fused. ``values``:
    (d_out, nb·n) kept weights; ``idx``: uint8 within-block positions."""
    if d_in is None:
        d_in = values.shape[-1] * m // n
    pw = PackedWeight(values=values, idx=idx, fmt="nm24", d_in=d_in, n=n,
                      m=m)
    return spmm(x, pw, bias=bias, act=act)


def spmm_gather(x: torch.Tensor, values: torch.Tensor, idx: torch.Tensor, *,
                d_in: int, bias=None, act: str | None = None) -> torch.Tensor:
    """x @ (gathered weight)ᵀ with the epilogue fused. ``values``:
    (d_out, k) kept weights; ``idx``: absolute columns per row in any
    order — sorted here, since the kernel walks them ascending (packing
    emits them so)."""
    idx, order = torch.sort(idx.to(torch.int32), dim=-1, stable=True)
    pw = PackedWeight(values=torch.gather(values, -1, order).contiguous(),
                      idx=idx.contiguous(), fmt="gathered", d_in=d_in)
    return spmm(x, pw, bias=bias, act=act)
