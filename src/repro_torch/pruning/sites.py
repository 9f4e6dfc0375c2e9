"""Prunable-site enumeration: (params, calibration taps) -> SiteGroups.

A *site* is one prunable linear (d_out, d_in) plus its calibration Gram
statistics; a *SiteGroup* stacks every instance of the same logical site
across the layer axis, so refinement runs per group and masks write back
into the tree ``loss(params, batch, masks=...)`` consumes.

The paper prunes all linear layers except the embedding and the head
(§3). For the dense transformer that is attention wq/wk/wv/wo and MLP
w_gate/w_up/w_down. wq/wk/wv (and w_gate/w_up) share their input, hence
their Gram; taps are accumulated per projection name anyway.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass
class GramBatch:
    """Stacked calibration statistics for all instances of a site group."""

    G: torch.Tensor          # (N, d_in, d_in) fp32
    count: torch.Tensor      # (N,) token counts
    mean: torch.Tensor       # (N, d_in)


@dataclasses.dataclass
class SiteGroup:
    """All instances of one logical prunable site.

    ``weights``: (N, d_out, d_in), N = number of layers; ``gram`` stacks
    the matching statistics on the same leading N. ``mask_path`` locates
    the stacked mask leaf in the masks tree.
    """

    name: str                       # e.g. "layers.attn.wq"
    weights: torch.Tensor           # (N, d_out, d_in)
    gram: GramBatch
    mask_path: tuple[str, ...]
    stack_shape: tuple[int, ...]

    def labels(self) -> list[str]:
        """Per-instance labels like 'layers.attn.wq[3]'."""
        if not self.stack_shape:
            return [self.name]
        return [f"{self.name}[{i}]" for i in range(self.stack_shape[0])]


_ATTN = ("wq", "wk", "wv", "wo")
_MLP_GATED = ("w_gate", "w_up", "w_down")
_MLP_PLAIN = ("w_up", "w_down")


def _table(cfg: ArchConfig):
    """(site name, param path, tap path, n stack dims) per prunable site."""
    if cfg.family != "dense":
        raise NotImplementedError(f"no site table for family {cfg.family!r}")
    rows = [(f"layers.attn.{k}", ("layers", "attn", k), (k,), 1)
            for k in _ATTN]
    mlp = _MLP_GATED if cfg.mlp == "gated" else _MLP_PLAIN
    rows += [(f"layers.mlp.{k}", ("layers", "mlp", k), (k,), 1) for k in mlp]
    return rows


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _gram_batch(tap_entry: dict) -> GramBatch:
    """A stacked tap entry {g, s, n} (leading layer axis) -> GramBatch."""
    g = tap_entry["g"]
    s = tap_entry["s"]
    count = tap_entry["n"].reshape(-1).float().expand(s.shape[0])
    return GramBatch(G=g, count=count,
                     mean=s / torch.clamp(count, min=1.0)[:, None])


def enumerate_sites(cfg: ArchConfig, params: dict,
                    taps: dict) -> list[SiteGroup]:
    """Pair every prunable weight stack with its calibration Gram stats."""
    groups = []
    for name, ppath, tpath, n_stack in _table(cfg):
        w = _get(params, ppath)
        groups.append(SiteGroup(
            name=name,
            weights=w.reshape(-1, *w.shape[n_stack:]),
            gram=_gram_batch(_get(taps, tpath)),
            mask_path=ppath,
            stack_shape=tuple(w.shape[:n_stack]),
        ))
    return groups


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
