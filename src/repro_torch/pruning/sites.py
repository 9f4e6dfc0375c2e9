"""Prunable-site enumeration: (params, calibration taps) -> SiteGroups.

A *site* is one prunable linear (d_out, d_in) plus its calibration Gram
statistics; a *SiteGroup* stacks every instance of the same logical site
across its stack dims (layers; layers x experts for MoE), so refinement
runs per group and masks write back into the tree
``loss(params, batch, masks=...)`` consumes.

The paper prunes all linear layers except the embedding and the head
(§3). For the dense transformer that is attention wq/wk/wv/wo and MLP
w_gate/w_up/w_down. wq/wk/wv (and w_gate/w_up) share their input, hence
their Gram; taps are accumulated per projection name anyway. An MoE
transformer has attention and per-expert w_gate/w_up/w_down (the router
stays dense), each expert with its own Gram over the tokens routed to it
(taps ``moe_w_up``, shared by w_gate and w_up, and ``moe_w_down``), so an
expert site has N = L·E instances, labelled ``layers.moe.w_up[l, e]``.
The hybrid (zamba) has mamba in_proj / out_proj per layer and the SHARED
block's attention and MLP, one instance each, whose Gram is the sum over
the block's invocation sites (the reference's ``"sum"`` rows; the model
hands that sum over already, ``models.zamba``, so they stack nothing).
RWKV6 has ten per layer: the time-mix wr/wk/wv/wg/wo, the decay LoRA
td_w1 / td_w2 (64 wide at full size) and the channel-mix cm_wk / cm_wv /
cm_wr, each with its own tap (its own input), stacked on L. The VLM's
self-layer sites stack on (G, NS) (groups, self layers a group), tapped
under "self"; its cross layers' q/k/v/o and MLP sites on G, tapped under
"cross" (the cross wk / wv Grams are over the image states). The
encoder-decoder has the encoder's attention and MLP (taps under "enc")
and the decoder's self attention, cross attention (``xattn``: taps
"x_wq" ... under "dec", emitted as "wq" ..., see ``_emission_name``) and
MLP, each stacked on its layers.

Shape-only views (``SiteSpec``, ``TapSpec``) let the planner resolve a
recipe and cost a run before any weight exists: ``site_specs`` reads
nothing but ``.shape``, so params on ``device="meta"`` do.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass
class GramStats:
    """Calibration statistics of one site instance.

    ``G`` is None at the moments level (a dsnot-only site never pays the
    (d, d) Gram); ``diag`` then carries Σx² per feature, all that Wanda/RIA
    warmstarts and DSnoT's feature variances need.
    """

    G: torch.Tensor | None   # (d_in, d_in) fp32, or None (moments level)
    count: torch.Tensor      # () token count
    mean: torch.Tensor       # (d_in,)
    diag: torch.Tensor | None = None   # (d_in,) Σx², set when G is None

    @property
    def gram_diag(self) -> torch.Tensor:
        return torch.diagonal(self.G) if self.G is not None else self.diag

    @property
    def ex2(self) -> torch.Tensor:
        return self.gram_diag / torch.clamp(self.count, min=1.0)

    @property
    def variance(self) -> torch.Tensor:
        return torch.clamp(self.ex2 - self.mean ** 2, min=0.0)


@dataclasses.dataclass
class GramBatch:
    """Stacked calibration statistics for all instances of a site group;
    as in ``GramStats``, ``G`` is None at the moments level and ``diag``
    holds the (N, d_in) Σx² stack instead."""

    # (N, d_in, d_in) fp32, or None (moments level); in a Gram-sharded
    # group on a mesh this rank's (N, d_in, d_in / n) column block
    G: torch.Tensor | None
    count: torch.Tensor      # (N,) token counts
    mean: torch.Tensor       # (N, d_in)
    diag: torch.Tensor | None = None   # (N, d_in) Σx², set when G is None

    @property
    def gram_diag(self) -> torch.Tensor:
        if self.G is not None:
            return torch.diagonal(self.G, dim1=-2, dim2=-1)
        return self.diag

    @property
    def ex2(self) -> torch.Tensor:
        return self.gram_diag / torch.clamp(self.count, min=1.0)[:, None]

    @property
    def variance(self) -> torch.Tensor:
        return torch.clamp(self.ex2 - self.mean ** 2, min=0.0)

    def instance(self, i: int) -> GramStats:
        return GramStats(
            G=None if self.G is None else self.G[i],
            count=self.count[i], mean=self.mean[i],
            diag=None if self.diag is None else self.diag[i])


@dataclasses.dataclass
class SiteGroup:
    """All instances of one logical prunable site.

    ``weights``: (N, d_out, d_in), N = the product of the stack dims
    (layers, or layers x experts); ``gram`` stacks the matching statistics
    on the same leading N. ``mask_path`` locates the stacked mask leaf in
    the masks tree; ``stack_shape`` restores the stack dims.
    """

    name: str                       # e.g. "layers.attn.wq"
    weights: torch.Tensor           # (N, d_out, d_in)
    gram: GramBatch
    mask_path: tuple[str, ...]
    stack_shape: tuple[int, ...]

    @property
    def n_instances(self) -> int:
        return self.weights.shape[0]

    def labels(self) -> list[str]:
        """Per-instance labels like 'layers.attn.wq[3]' or
        'layers.moe.w_up[1, 5]'."""
        return _instance_labels(self.name, self.stack_shape)

    @property
    def spec(self) -> "SiteSpec":
        return SiteSpec(name=self.name, n_instances=self.n_instances,
                        d_out=int(self.weights.shape[1]),
                        d_in=int(self.weights.shape[2]),
                        stack_shape=self.stack_shape)


def _instance_labels(name: str, stack_shape: tuple[int, ...]) -> list[str]:
    if not stack_shape:
        return [name]
    idx = [()]
    for d in stack_shape:
        idx = [(*i, j) for i in idx for j in range(d)]
    return [f"{name}{list(i)}" for i in idx]


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """Shape-only description of one SiteGroup — no weights, no Grams."""

    name: str
    n_instances: int
    d_out: int
    d_in: int
    stack_shape: tuple[int, ...]

    def labels(self) -> list[str]:
        return _instance_labels(self.name, self.stack_shape)

    @property
    def weight_bytes(self) -> int:
        """fp32 bytes of the stacked weights as the refiners see them."""
        return 4 * self.n_instances * self.d_out * self.d_in

    @property
    def gram_bytes(self) -> int:
        """fp32 bytes of the stacked (N, d_in, d_in) calibration Grams."""
        return 4 * self.n_instances * self.d_in * self.d_in


_ATTN = ("wq", "wk", "wv", "wo")
_MLP_GATED = ("w_gate", "w_up", "w_down")
_MLP_PLAIN = ("w_up", "w_down")


def _mlp_names(cfg: ArchConfig):
    return _MLP_GATED if cfg.mlp == "gated" else _MLP_PLAIN


def _zamba_table(cfg: ArchConfig):
    rows = [(f"layers.mamba.{k}", ("layers", "mamba", k), ("mamba", k), 1)
            for k in ("in_proj", "out_proj")]
    rows += [(f"shared.attn.{k}", ("shared", "attn", k), ("shared", k), 0)
             for k in _ATTN]
    rows += [(f"shared.mlp.{k}", ("shared", "mlp", k), ("shared", k), 0)
             for k in _mlp_names(cfg)]
    return rows


_RWKV_SITES = ("wr", "wk", "wv", "wg", "wo", "td_w1", "td_w2",
               "cm_wk", "cm_wv", "cm_wr")


def _rwkv_table(cfg: ArchConfig):
    return [(f"layers.tm.{k}", ("layers", "tm", k), (k,), 1)
            for k in _RWKV_SITES]


def _vlm_table(cfg: ArchConfig):
    rows = [(f"layers.{blk}.{k}", ("layers", blk, k), ("self", k), 2)
            for blk, names in (("attn", _ATTN), ("mlp", _mlp_names(cfg)))
            for k in names]
    rows += [(f"cross_layers.{blk}.{k}", ("cross_layers", blk, k),
              ("cross", k), 1)
             for blk, names in (("attn", _ATTN), ("mlp", _mlp_names(cfg)))
             for k in names]
    return rows


def _encdec_table(cfg: ArchConfig):
    rows = [(f"enc_layers.{blk}.{k}", ("enc_layers", blk, k), ("enc", k), 1)
            for blk, names in (("attn", _ATTN), ("mlp", _mlp_names(cfg)))
            for k in names]
    for k in _ATTN:
        rows.append((f"dec_layers.attn.{k}", ("dec_layers", "attn", k),
                     ("dec", k), 1))
        rows.append((f"dec_layers.xattn.{k}", ("dec_layers", "xattn", k),
                     ("dec", f"x_{k}"), 1))
    rows += [(f"dec_layers.mlp.{k}", ("dec_layers", "mlp", k), ("dec", k), 1)
             for k in _mlp_names(cfg)]
    return rows


def _table(cfg: ArchConfig):
    """(site name, param path, tap path, n stack dims) per prunable site;
    0 for a shared block's site (one instance, its tap summed over the
    block's invocation sites)."""
    if cfg.is_rwkv:
        return _rwkv_table(cfg)
    if cfg.is_encdec:
        return _encdec_table(cfg)
    if cfg.family == "hybrid":
        return _zamba_table(cfg)
    if cfg.cross_attn_every:
        return _vlm_table(cfg)
    rows = [(f"layers.attn.{k}", ("layers", "attn", k), (k,), 1)
            for k in _ATTN]
    if cfg.is_moe:
        for k in _MLP_GATED:
            tap = "moe_w_down" if k == "w_down" else "moe_w_up"
            rows.append((f"layers.moe.{k}", ("layers", "moe", k), (tap,), 2))
        return rows
    rows += [(f"layers.mlp.{k}", ("layers", "mlp", k), (k,), 1)
             for k in _mlp_names(cfg)]
    return rows


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _gram_batch(tap_entry: dict) -> GramBatch:
    """A stacked tap entry {g|d, s, n} (leading stack dims: layers, or
    layers x experts, or none for a shared block) -> GramBatch, the stack
    dims flattened into N."""
    s = tap_entry["s"]
    s = s.reshape(-1, s.shape[-1])
    N = s.shape[0]
    n = tap_entry["n"].reshape(-1).float()
    count = n.expand(N) if n.shape[0] == 1 else n
    g, d = tap_entry.get("g"), tap_entry.get("d")
    return GramBatch(
        G=None if g is None else g.reshape(-1, *g.shape[-2:]), count=count,
        mean=s / torch.clamp(count, min=1.0)[:, None],
        diag=None if d is None else d.reshape(-1, d.shape[-1]))


def enumerate_sites(cfg: ArchConfig, params: dict, taps: dict, *,
                    only: set | None = None) -> list[SiteGroup]:
    """Pair every prunable weight stack with its calibration statistics.

    ``only`` restricts to the named groups: skip-listed sites never touch
    their (possibly absent) taps."""
    groups = []
    for name, ppath, tpath, n_stack in _table(cfg):
        if only is not None and name not in only:
            continue
        w = _get(params, ppath)
        groups.append(SiteGroup(
            name=name,
            weights=w.reshape(-1, *w.shape[n_stack:]),
            gram=_gram_batch(_get(taps, tpath)),
            mask_path=ppath,
            stack_shape=tuple(w.shape[:n_stack]),
        ))
    return groups


def tap_path(cfg: ArchConfig, name: str) -> tuple[str, ...]:
    """The tap tree path whose statistics feed site group ``name``."""
    for site, _, tpath, _ in _table(cfg):
        if site == name:
            return tpath
    raise KeyError(name)


def site_specs(cfg: ArchConfig, params: dict) -> list[SiteSpec]:
    """Prunable sites from shapes alone (no taps, no FLOPs)."""
    specs = []
    for name, ppath, _, n_stack in _table(cfg):
        shape = tuple(_get(params, ppath).shape)
        stack_shape = tuple(int(d) for d in shape[:n_stack])
        n = 1
        for d in stack_shape:
            n *= d
        specs.append(SiteSpec(name=name, n_instances=n,
                              d_out=int(shape[n_stack]),
                              d_in=int(shape[n_stack + 1]),
                              stack_shape=stack_shape))
    return specs


@dataclasses.dataclass(frozen=True)
class TapSpec:
    """Shape-only description of one calibration tap (accumulator entry).

    ``path`` locates the entry in the taps tree, ``name`` is the key the
    model emits it under (the ``TapPolicy`` lookup key), ``n`` the stacked
    instance count during accumulation (1 for a shared block's tap, which
    the port sums as it goes where the reference stacks L entries),
    ``sites`` every site group fed by this tap.
    """

    path: tuple[str, ...]
    name: str
    d_in: int
    n: int
    sites: tuple[str, ...]

    def bytes_at(self, level: str) -> int:
        """fp32 accumulator bytes at a ``pruning.stats`` level."""
        if level == "none":
            return 0
        per = self.d_in * self.d_in if level == "gram" else self.d_in
        return 4 * self.n * (per + self.d_in + 1)      # g|d + s + n


def _emission_name(tpath: tuple[str, ...]) -> str:
    """The key the model emits a tap under: the encoder-decoder's cross
    attention emits "wq" ... and its decoder layer renames them "x_wq"
    ..., so a policy looks up the emitted name. As in the reference, a
    policy keys on that name alone: a tap skipped at one site and kept at
    another of the same emitted name accumulates at both."""
    leaf = tpath[-1]
    return leaf[2:] if leaf.startswith("x_") else leaf


def tap_specs(cfg: ArchConfig, specs: list[SiteSpec]) -> list[TapSpec]:
    """Calibration taps with their accumulation-time shapes."""
    by_name = {s.name: s for s in specs}
    out: dict[tuple[str, ...], TapSpec] = {}
    for name, _, tpath, _ in _table(cfg):
        s = by_name[name]
        prev = out.get(tpath)
        if prev is None:
            out[tpath] = TapSpec(path=tpath, name=_emission_name(tpath),
                                 d_in=s.d_in, n=s.n_instances, sites=(name,))
        else:
            out[tpath] = dataclasses.replace(prev, sites=(*prev.sites, name))
    return list(out.values())


def build_mask_tree(cfg: ArchConfig, site_masks: dict[str, torch.Tensor],
                    groups: list[SiteGroup]) -> dict:
    """Assemble the masks tree ``loss(params, batch, masks=...)`` expects:
    ``site_masks[name]`` (N, d_out, d_in) goes back to the stack dims at
    the group's param path."""
    tree: dict = {}
    for g in groups:
        m = site_masks[g.name]
        m = m.reshape(*g.stack_shape, *m.shape[1:]) if g.stack_shape else m[0]
        node = tree
        for k in g.mask_path[:-1]:
            node = node.setdefault(k, {})
        node[g.mask_path[-1]] = m
    return tree


def prunable_param_count(cfg: ArchConfig, params: dict) -> int:
    """Weights in scope for pruning (the paper's sparsity denominator)."""
    return sum(_get(params, ppath).numel() for _, ppath, _, _ in _table(cfg))
