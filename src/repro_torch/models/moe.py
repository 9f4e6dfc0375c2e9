"""Top-k MoE block with grouped, sort-based capacity dispatch.

The port of the reference's ``models/moe.py``, same semantics:

* the router (fp32, kept dense: never pruned) scores every token; each
  token goes to its ``top_k`` experts, ties to the lower expert index as
  ``jax.lax.top_k`` breaks them (a stable descending sort), with softmax
  gates over the k logits;
* tokens are dispatched per group of ``cfg.moe_group_size`` consecutive
  positions (where that divides the sequence, else the whole sequence):
  within a group a stable sort by expert id places each assignment in
  its expert's slots of capacity ``capacity(group)``; assignments past it
  are dropped (GShard semantics);
* each expert multiplies its capacity buffer; outputs are gathered back
  to token order and summed over k, gate-weighted;
* the aux loss is the switch-style load balance plus the router z-loss.

Layout: the capacity buffer is expert-major, ``(E, B·groups·C, d)``
(the reference's ``(B, groups, E, C, d)`` with the expert dim moved to
the front), so the stacked expert products (``kernels.ops.spmm_stacked``
for a packed leaf) and the per-expert Gram taps
(``TapPolicy.gram_experts``) read it without a transpose copy. The
reference's ``.at[dest].set(mode="drop")`` / ``.get(mode="fill")`` become
indexed copies through one extra row: dropped assignments write it (and
it is cut off) and read it as zeros in the combine, so nothing reads the
device from the host.

The backward adds no gradient in an order the device chooses: the
dispatch copies each token to its k assignments by a broadcast, whose
backward sums the k rows in a fixed order (an ``index_select`` by token
would backpropagate through an atomic ``index_add``), and the
``index_copy_`` into the buffer backpropagates as a gather. The combine's
``index_select`` backpropagates through an ``index_add`` into the buffer,
but every kept slot has exactly one reader, so each sum there has one
term; only the discarded drop row takes many. Training therefore resumes
bitwise on the card.

``count_drops()`` counts the assignments capacity dispatch drops, summed
on the device (no host read while it runs), for callers that need to
know whether a prefill dropped tokens: a chunked prefill's windows
compete for capacity(W) slots, not capacity(S), so where a group drops,
chunked and one-shot prefill compute different functions.

Expert weights are ``(E, d_ff, d)`` / ``(E, d, d_ff)``, prunable per
expert; each expert's calibration Gram comes from exactly the tokens
routed to it (empty slots are zero and add nothing).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.packed import PackedWeight
from repro_torch.kernels import ops

from . import common

def init_moe_params(gen, cfg, *, device) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = getattr(torch, cfg.dtype)
    return {
        "router": common.linear_init(gen, e, d, torch.float32, device),
        "w_gate": common.normal_init(gen, (e, f, d), d ** -0.5, dt, device),
        "w_up": common.normal_init(gen, (e, f, d), d ** -0.5, dt, device),
        "w_down": common.normal_init(gen, (e, d, f), f ** -0.5, dt, device),
    }


def capacity(group_tokens: int, cfg) -> int:
    c = int(group_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, 1)


def route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """(fp32 logits (B, S, E), expert ids (B, S, k) int64, gates (B, S, k)
    fp32): the k largest logits per token, equal logits in ascending
    expert order (``jax.lax.top_k``'s rule), softmax over them."""
    logits = x.float() @ router.float().T
    top, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    top, ids = top[..., :top_k], ids[..., :top_k]
    return logits, ids, torch.softmax(top, dim=-1)


def _dispatch_group(ids: torch.Tensor, *, n_experts: int, cap: int):
    """Slots of each assignment, for every group at once.

    ids: (NG, G, k) expert ids of NG groups of G tokens. Returns dest
    (NG, G·k) int64: assignment a of a group (token a // k, its
    (a % k)-th expert) goes to row ``dest`` of the group's (E·C, d)
    capacity buffer, ``e·C + (its rank among the group's assignments to
    e, in assignment order)``; ``dest == E·C`` marks a drop (rank >= C).
    """
    NG, G, k = ids.shape
    flat_e = ids.reshape(NG, G * k)
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    counts = torch.zeros((NG, n_experts), dtype=torch.int64,
                         device=ids.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    start = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(G * k, device=ids.device) - start.gather(1, sorted_e)
    dest_sorted = torch.where(pos < cap, sorted_e * cap + pos,
                              n_experts * cap)
    return torch.empty_like(dest_sorted).scatter_(1, order, dest_sorted)


def _dispatch(x2: torch.Tensor, dest: torch.Tensor, *, n_experts: int,
              cap: int):
    """The expert-major capacity buffer and each assignment's row in it.

    x2: (NG·G, d) tokens of NG groups in order; dest: (NG, G·k) from
    ``_dispatch_group``. Returns (buf (E, NG·C, d) in x2's dtype, zero in
    empty slots; rows (NG·G·k,)): assignment a of group g sits at row
    ``rows`` of ``buf.reshape(E·NG·C, d)``, and a drop at E·NG·C, one row
    past it (the extra row of the write, never read back)."""
    NG, Gk = dest.shape
    k = Gk * NG // x2.shape[0]
    g = torch.arange(NG, device=dest.device)[:, None]
    rows = (dest // cap) * (NG * cap) + g * cap + dest % cap
    n_slots = n_experts * NG * cap
    rows = torch.where(dest < n_experts * cap, rows, n_slots).reshape(-1)
    # each token to its k assignments by a broadcast (module docstring)
    src = x2[:, None].expand(-1, k, -1).reshape(-1, x2.shape[1])
    buf = x2.new_zeros((n_slots + 1, x2.shape[1]))
    buf.index_copy_(0, rows, src)
    return buf[:n_slots].view(n_experts, NG * cap, -1), rows


def _combine_group(out_buf: torch.Tensor, rows: torch.Tensor,
                   gates: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """Expert outputs back to token order: each assignment's row of the
    (E, NG·C, d) buffer (a drop reads zeros), times its gate, summed over
    the token's k experts. gates: (..., k) in assignment order -> (tokens,
    d) in out_buf's dtype."""
    d = out_buf.shape[-1]
    padded = torch.cat([out_buf.reshape(-1, d), out_buf.new_zeros((1, d))])
    got = padded.index_select(0, rows) * gates.reshape(-1, 1).to(
        out_buf.dtype)
    return got.reshape(-1, top_k, d).sum(1)


class DropCount:
    """Capacity drops of the ``moe_block`` calls made while it counts,
    summed on the device (``total()`` reads them back), beside the
    assignments dispatched (``assignments``, from shapes)."""

    def __init__(self):
        self._dropped = None
        self.assignments = 0

    def _add(self, dest: torch.Tensor, full: int) -> None:
        n = (dest == full).sum()
        self._dropped = n if self._dropped is None else self._dropped + n
        self.assignments += dest.numel()

    def total(self) -> int:
        """Dropped assignments so far (a host read)."""
        return 0 if self._dropped is None else int(self._dropped)


_COUNTERS: list[DropCount] = []


@contextlib.contextmanager
def count_drops():
    """``with count_drops() as c: ...`` counts the assignments every
    ``moe_block`` call inside drops (``c.total()``, ``c.assignments``)."""
    c = DropCount()
    _COUNTERS.append(c)
    try:
        yield c
    finally:
        _COUNTERS.remove(c)


def moe_block(p, x: torch.Tensor, cfg, *, masks=None,
              taps: common.Taps | None = None):
    """x: (B, S, d) -> (out (B, S, d), aux loss () fp32).

    Taps (calibration): ``moe_w_up`` over the capacity buffer (the input
    of w_gate and w_up), ``moe_w_down`` over the gated hidden buffer, each
    a per-expert entry {g (E, d, d), d | s (E, d), n (E,)} as the policy
    selects (``_moe_tap_entry``).
    """
    if cfg.moe_parallelism == "ep":
        raise NotImplementedError(
            "expert-parallel MoE shards experts over devices; the port runs "
            "one device (ROADMAP A5, item 2: moe_parallelism='ep')")
    B, S, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    gs = (cfg.moe_group_size if cfg.moe_group_size
          and S % cfg.moe_group_size == 0 else S)
    ng = S // gs
    cap = capacity(gs, cfg)
    m = (lambda n: None) if masks is None else masks.get

    logits, ids, gates = route(x, p["router"], k)
    dest = _dispatch_group(ids.reshape(B * ng, gs, k), n_experts=e, cap=cap)
    for c in _COUNTERS:
        c._add(dest, e * cap)
    buf, rows = _dispatch(x.reshape(B * S, d), dest, n_experts=e, cap=cap)

    n_e = None
    pol = taps.policy if taps is not None else None
    f_up = pol.fields("moe_w_up") if taps is not None else ()
    f_down = pol.fields("moe_w_down") if taps is not None else ()
    if "n" in f_up or "n" in f_down:
        filled = (dest < e * cap).float().reshape(-1)
        n_e = torch.zeros(e, device=x.device).index_add_(
            0, torch.clamp(dest // cap, max=e - 1).reshape(-1), filled)
    if f_up:
        _tap_add(taps, "moe_w_up", _moe_tap_entry(pol, f_up, buf, n_e))

    up = _expert_mm(buf, p["w_up"], m("w_up"))
    gate = _expert_mm(buf, p["w_gate"], m("w_gate"), act=cfg.act)
    h = gate * up
    if f_down:
        _tap_add(taps, "moe_w_down", _moe_tap_entry(pol, f_down, h, n_e))
    out_buf = _expert_mm(h, p["w_down"], m("w_down"))

    out = _combine_group(out_buf, rows, gates, top_k=k)
    out = out.reshape(B, S, d).to(x.dtype)

    # aux losses
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=(0, 1))
    frac = torch.zeros(e, device=x.device).index_add_(
        0, ids.reshape(-1), torch.ones(ids.numel(), device=x.device))
    frac = frac / (B * S * k)
    lb = e * torch.sum(me * frac)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = cfg.router_aux_coef * lb + cfg.router_z_coef * z
    return out, aux


def _expert_mm(x3: torch.Tensor, w, mask, act: str | None = None):
    """Per-expert product (E, N, d_in) · (E, d_out, d_in) -> (E, N, d_out),
    ``act`` fused: a packed leaf (stacked on the expert dim) runs
    ``ops.spmm_stacked`` with the activation on the fp32 sum; a dense or
    masked one a batched matmul with the activation in the compute dtype,
    as the reference's einsum path."""
    if isinstance(w, PackedWeight):
        if mask is not None:
            raise ValueError("PackedWeight already encodes its mask; "
                             "serve packed params with masks=None")
        return ops.spmm_stacked(x3, w, act=act)
    if mask is not None:
        w = w * mask.to(w.dtype)
    y = torch.bmm(x3, w.transpose(1, 2).to(x3.dtype))
    return common.apply_epilogue(y, None, act)


def _tap_add(taps: common.Taps, name: str, ent: dict) -> None:
    prev = taps.entries.get(name)
    taps.entries[name] = ent if prev is None else {
        key: prev[key] + v for key, v in ent.items()}


def _moe_tap_entry(pol: common.TapPolicy, fields, x3: torch.Tensor, n_e):
    """Per-expert tap entry over the expert-major buffer x3 (E, N, d) in
    the compute dtype: empty slots are zero and add nothing to any field.
    ``n`` counts the assignments each expert took (its filled slots)."""
    x32 = x3.float()
    ent = {}
    if "g" in fields:
        ent["g"] = pol.gram_experts(x3)
    if "d" in fields:
        ent["d"] = (x32 * x32).sum(1)
    if "s" in fields:
        ent["s"] = x32.sum(1)
    if "n" in fields:
        ent["n"] = n_e
    return ent
