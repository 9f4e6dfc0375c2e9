"""Packed sparse weights: mask -> the formats serving runs from.

A refined mask pays off only when serving stops reading the zeros. This
module turns ``(W, mask)`` pairs into the two formats the spmm kernel
(``repro_torch.kernels.spmm``) executes:

* ``nm24`` — N:M semi-structured (2:4 first): per m-block of each row the
  n kept values, stored contiguously, plus a uint8 *within-block* column
  index — the metadata layout of sparse tensor cores. Bytes at rest:
  ``n/m`` of the values + 1 byte per kept weight.
* ``gathered`` — per-row kept values plus int32 absolute columns, for
  unstructured masks with an equal keep count in every row (SparseSwaps'
  1-swaps preserve the warmstart's per-row count, so every ``PerRow``
  mask it emits qualifies); unequal rows are rejected loudly.

Packing is bit-identical to the reference's ``repro.core.packed``: the
same values, the same indices in the same dtypes, and the same
``ValueError`` on a mask the format cannot hold. Kept entries are listed
in ascending column order in both formats, so the two packings of one
2:4 mask hold the same (column, value) sequence per row.

``PackedWeight`` keeps leading stack dims (layers), so a packed leaf
sits in the stacked param tree where the dense weight was, and the model
slices it per layer. Masks come from ``prune_model`` reports
(``from_report``) or from any pruning-run artifact either package writes
(``load_masks_and_weights``): a masks-tree checkpoint, executor
``groups/`` checkpoints (with sparsegpt's updated weights), or a launcher
``--out-dir`` / ``export_packed`` root whose ``weights/`` (updated or
recovered leaves) are spliced in; ``load_packed_tree`` reads an
``export_packed`` artifact's packed leaves without re-packing.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import NamedTuple

import torch

FORMATS = ("nm24", "gathered")


@dataclasses.dataclass
class PackedWeight:
    """One packed prunable linear, leading stack dims preserved.

    ``values``: (..., d_out, k) kept weights in ascending-column order;
    ``idx``: (..., d_out, k) column metadata — uint8 within-block
    positions for ``nm24``, int32 absolute columns for ``gathered``.
    """

    values: torch.Tensor
    idx: torch.Tensor
    fmt: str            # "nm24" | "gathered"
    d_in: int           # original input dim (the packed-away axis)
    n: int = 0          # kept per block (nm24 only)
    m: int = 0          # block size (nm24 only)

    @property
    def shape(self) -> tuple[int, ...]:
        """The dense (..., d_out, d_in) shape this leaf stands in for."""
        return (*self.values.shape[:-1], self.d_in)

    @property
    def k(self) -> int:
        """Kept weights per row."""
        return int(self.values.shape[-1])

    @property
    def nbytes(self) -> int:
        """Resident bytes of the packed representation."""
        return _nbytes(self.values) + _nbytes(self.idx)

    @property
    def dense_nbytes(self) -> int:
        """Bytes the dense (masked) weight would occupy at this dtype."""
        n = 1
        for s in self.shape:
            n *= s
        return self.values.element_size() * n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def _check_mask01(mask: torch.Tensor) -> torch.Tensor:
    if not bool(((mask == 0) | (mask == 1)).all()):
        raise ValueError("mask must be exactly 0/1")
    return mask.float()


def _kept_first(mk: torch.Tensor) -> torch.Tensor:
    """Positions along the last axis, kept entries first in ascending
    order: the reference's ``np.argsort(1 - m, kind="stable")``."""
    return torch.sort(1.0 - mk, dim=-1, stable=True).indices


# elements sorted at a time when packing: a whole stacked leaf's sort
# (fp32 keys and int64 indices, 12 bytes an element) would take 11 GB at
# mixtral-8x7b's two-layer w_gate stack (2 x 8 x 14336 x 4096)
_PACK_CHUNK = 1 << 24


def _gather_kept(w: torch.Tensor, mk: torch.Tensor, k: int, idx_dtype):
    """(values, idx) of each row along the last axis: its first k
    positions of ``_kept_first`` (the kept ones, ascending) in
    ``idx_dtype`` and the weights there, sorted a chunk of rows at a time
    (each row's sort is its own, so the result is the whole-leaf one)."""
    d = w.shape[-1]
    w2, m2 = w.reshape(-1, d), mk.reshape(-1, d)
    vals = w2.new_empty((w2.shape[0], k))
    idx = torch.empty((w2.shape[0], k), dtype=idx_dtype, device=w.device)
    step = max(1, _PACK_CHUNK // d)
    for lo in range(0, w2.shape[0], step):
        order = _kept_first(m2[lo:lo + step])[:, :k]
        vals[lo:lo + step] = torch.gather(w2[lo:lo + step], -1, order)
        idx[lo:lo + step] = order
    return (vals.reshape(*w.shape[:-1], k), idx.reshape(*w.shape[:-1], k))


def pack_nm(w: torch.Tensor, mask: torch.Tensor, *, n: int = 2,
            m: int = 4) -> PackedWeight:
    """Pack an N:M mask: (..., d_out, d_in) -> values + uint8 block idx.

    Every m-block of every row must keep exactly n entries; anything
    else is a corrupt mask for this format and raises.
    """
    d_in = int(w.shape[-1])
    if d_in % m:
        raise ValueError(f"d_in={d_in} not divisible by M={m}")
    mk = _check_mask01(mask.to(w.device))
    nb = d_in // m
    mb = mk.reshape(*mk.shape[:-1], nb, m)
    per_block = mb.sum(dim=-1)
    if not bool((per_block == n).all()):
        bad = int((per_block != n).sum())
        raise ValueError(
            f"mask is not {n}:{m}: {bad} block(s) keep != {n} entries")
    vals, idx = _gather_kept(w.reshape(*w.shape[:-1], nb, m), mb, n,
                             torch.uint8)             # within-block pos
    return PackedWeight(values=vals.reshape(*w.shape[:-1], nb * n),
                        idx=idx.reshape(*w.shape[:-1], nb * n),
                        fmt="nm24", d_in=d_in, n=n, m=m)


def pack_gathered(w: torch.Tensor, mask: torch.Tensor) -> PackedWeight:
    """Pack an equal-support unstructured mask: per-row column gather.

    Every row must keep the same number of entries R (SparseSwaps'
    ``PerRow`` masks guarantee this); rows with unequal support raise.
    """
    d_in = int(w.shape[-1])
    mk = _check_mask01(mask.to(w.device))
    per_row = mk.sum(dim=-1)
    k = int(per_row.reshape(-1)[0])
    if not bool((per_row == k).all()):
        lo, hi = int(per_row.min()), int(per_row.max())
        raise ValueError(
            f"gathered format needs equal per-row support; got rows "
            f"keeping between {lo} and {hi} entries")
    if k == 0:
        raise ValueError("gathered format cannot represent all-pruned rows")
    vals, idx = _gather_kept(w, mk, k, torch.int32)   # ascending columns
    return PackedWeight(values=vals, idx=idx, fmt="gathered", d_in=d_in)


def pack(w: torch.Tensor, mask: torch.Tensor, fmt: str, *, n: int = 2,
         m: int = 4) -> PackedWeight:
    """Dispatching packer; ``fmt`` in {"nm24", "gathered"}."""
    if fmt == "nm24":
        return pack_nm(w, mask, n=n, m=m)
    if fmt == "gathered":
        return pack_gathered(w, mask)
    raise ValueError(f"unknown packed format {fmt!r} (want one of {FORMATS})")


def abs_columns(pw: PackedWeight) -> torch.Tensor:
    """Absolute kept-column indices (..., d_out, k), int64, either format."""
    if pw.fmt == "nm24":
        slots = torch.arange(pw.k, device=pw.idx.device)
        return pw.idx.long() + (slots // pw.n) * pw.m
    return pw.idx.long()


def unpack(pw: PackedWeight) -> torch.Tensor:
    """Exact inverse: the dense ``w * mask`` this PackedWeight encodes."""
    dense = torch.zeros(pw.shape, dtype=pw.values.dtype,
                        device=pw.values.device)
    return dense.scatter_(-1, abs_columns(pw), pw.values)


def mask_of(pw: PackedWeight) -> torch.Tensor:
    """The 0/1 keep-mask this PackedWeight encodes (fp32)."""
    return unpack(dataclasses.replace(
        pw, values=torch.ones_like(pw.values, dtype=torch.float32)))


# ---------------------------------------------------------------------------
# whole-model packing
# ---------------------------------------------------------------------------

def _site_paths(cfg) -> list[tuple[str, tuple[str, ...]]]:
    """(site name, param path) for every prunable site of ``cfg``."""
    from repro_torch.pruning import sites as sites_lib
    return [(name, ppath) for name, ppath, _, _ in sites_lib._table(cfg)]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _maybe_get(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _copy_dicts(tree):
    return {k: _copy_dicts(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree


def _set(tree, path, leaf):
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = leaf


def pack_tree(cfg, params: dict, masks: dict, fmt: str = "nm24", *,
              n: int = 2, m: int = 4) -> dict:
    """Replace every masked prunable leaf of ``params`` with PackedWeight.

    Sites without a mask entry stay dense; ``fmt`` applies uniformly — a
    mask a format cannot represent raises with the site name, it is never
    silently served dense. For ``nm24`` the block shape (n, m) is inferred
    per site from the mask when it isn't 2:4. ``params`` is not modified.
    """
    out = _copy_dicts(params)
    for name, ppath in _site_paths(cfg):
        mask = _maybe_get(masks, ppath)
        if mask is None:
            continue
        w = _get(params, ppath)
        try:
            if fmt == "nm24":
                ni, mi = infer_nm(mask, default=(n, m))
                pw = pack_nm(w, mask, n=ni, m=mi)
            else:
                pw = pack(w, mask, fmt)
        except ValueError as e:
            raise ValueError(f"site {name!r}: {e}") from None
        _set(out, ppath, pw)
    return out


def infer_nm(mask: torch.Tensor, *, default=(2, 4),
             candidates=((2, 4), (4, 8), (1, 4), (2, 8), (1, 2),
                         (4, 16), (8, 16))) -> tuple[int, int]:
    """Smallest (n, m) block shape an N:M mask satisfies.

    Tries the default first (the hardware-native 2:4), then the usual
    suspects; raises when none fits — the caller reports the site.
    """
    d_in = mask.shape[-1]
    for ni, mi in (default, *candidates):
        if d_in % mi:
            continue
        blocks = mask.reshape(*mask.shape[:-1], d_in // mi, mi).sum(dim=-1)
        if bool((blocks == ni).all()):
            return ni, mi
    raise ValueError("mask is not N:M for any supported block shape")


def representable(cfg, masks: dict, fmt: str) -> bool:
    """Whether every masked site of ``cfg`` can be packed as ``fmt``.

    A mask property only — no weights are touched.
    """
    if fmt not in FORMATS:
        raise ValueError(f"unknown packed format {fmt!r}")
    for _, ppath in _site_paths(cfg):
        mask = _maybe_get(masks, ppath)
        if mask is None:
            continue
        if fmt == "nm24":
            try:
                infer_nm(mask)
            except ValueError:
                return False
        else:
            per_row = mask.sum(dim=-1)
            if per_row.min() != per_row.max() or per_row.max() == 0:
                return False
    return True


def packed_bytes(params) -> int:
    """Resident weight bytes of a (possibly packed) param tree."""
    if isinstance(params, dict):
        return sum(packed_bytes(v) for v in params.values())
    if isinstance(params, PackedWeight):
        return params.nbytes
    return _nbytes(params)


def from_report(cfg, params: dict, report, fmt: str = "nm24") -> dict:
    """Pack from an in-memory ``PruneReport`` (or a bare masks tree)."""
    masks = getattr(report, "masks", report)
    return pack_tree(cfg, params, masks, fmt)


# ---------------------------------------------------------------------------
# export_packed artifacts
# ---------------------------------------------------------------------------

def load_packed_tree(params: dict, out_dir: str | Path) -> dict:
    """Inverse of ``PruneExecutor.export_packed``: a pre-packed param tree.

    Restores the values / idx checkpoint under ``<out_dir>/packed`` and
    splices ``PackedWeight`` leaves into a copy of ``params`` (on their
    device) at the recorded site paths: serving needs no re-pack and never
    reads the masks.
    """
    from repro_torch import ckpt

    d = Path(out_dir) / "packed"
    found = ckpt.restore_latest(d)
    if found is None:
        raise FileNotFoundError(f"no valid packed checkpoint under {d}")
    _, restored, man = found
    dev = _device_of(params)
    out = _copy_dicts(params)
    for name, mt in man["extra"]["sites"].items():
        pw = PackedWeight(
            values=ckpt.to_tensor(restored[f"values/{name}"], dev),
            idx=ckpt.to_tensor(restored[f"idx/{name}"], dev),
            fmt=mt["fmt"], d_in=int(mt["d_in"]), n=int(mt["n"]),
            m=int(mt["m"]))
        _set(out, tuple(name.split(".")), pw)
    return out


# ---------------------------------------------------------------------------
# mask-checkpoint loading (the --masks-from path)
# ---------------------------------------------------------------------------

class MaskSource(NamedTuple):
    """A mask artifact resolved once: its masks and the weights they
    belong to — the fields of a ``PruneReport`` that ``ServeEngine``
    reads, so every engine built from it serves the same trees."""

    masks: dict
    updated_params: dict


def load_mask_tree(cfg, params: dict, ckpt_dir: str | Path) -> dict:
    """Assemble a masks tree from a pruning-run artifact directory (see
    ``load_masks_and_weights`` for what it accepts)."""
    return load_masks_and_weights(cfg, params, ckpt_dir)[0]


def load_masks_and_weights(cfg, params: dict,
                           ckpt_dir: str | Path) -> tuple[dict, dict]:
    """(masks tree, the weights the masks belong to) from any pruning-run
    artifact directory, in resolution order:

    * an executor checkpoint dir (``<dir>/groups/<site>/step_*``): the
      per-group masks; sparsegpt groups carry ``new_weights`` (the
      refiner updates the kept weights), spliced into a copy of
      ``params``; sites without a valid group checkpoint serve dense;
    * a masks-tree checkpoint (``<dir>/step_*``); ``params`` unchanged;
    * a launcher ``--out-dir`` or ``export_packed`` root: ``prune_ckpt/``
      then ``masks/`` by the rules above, with ``<dir>/weights`` (the
      changed leaves of a sparsegpt or recovery run) spliced over the
      result.

    Serving masks over weights they were not refined on would be silently
    wrong, so every weight source is applied. Each package reads the
    other's artifacts; the returned trees live on ``params``' device.
    """
    from repro_torch import ckpt

    d = Path(ckpt_dir)
    if (d / "groups").is_dir():
        return _masks_from_groups(cfg, params, d / "groups")
    if ckpt.steps(d):
        return _masks_from_tree_ckpt(cfg, params, d), params
    # executor checkpoints first: a launcher --out-dir root holds both a
    # masks tree (masks/) and the group checkpoints (prune_ckpt/), and
    # only the latter carry sparsegpt's updated weights
    for sub in ("prune_ckpt", "masks"):
        if (d / sub).exists():
            try:
                masks, params = load_masks_and_weights(cfg, params, d / sub)
            except FileNotFoundError:
                continue
            if (d / "weights").is_dir():
                params = _splice_weights(params, d / "weights")
            return masks, params
    raise FileNotFoundError(
        f"no mask checkpoint under {d} (want groups/<site>/step_* or "
        "step_* or masks/|prune_ckpt/)")


def _splice_weights(params: dict, d: Path) -> dict:
    """Overlay an exported weight checkpoint (a flat {dotted name: leaf}
    tree, as ``export_packed`` and the prune launcher write it) onto a
    copy of ``params``, each leaf in the dtype of the one it replaces."""
    from repro_torch import ckpt

    found = ckpt.restore_latest(d)
    if found is None:
        return params
    dev = _device_of(params)
    out = _copy_dicts(params)
    for name, arr in found[1].items():
        ppath = tuple(name.split("."))
        old = _get(params, ppath)
        _set(out, ppath, ckpt.to_tensor(arr, dev).to(old.dtype))
    return out


def _masks_from_groups(cfg, params: dict,
                       groups_dir: Path) -> tuple[dict, dict]:
    """Masks (and sparsegpt's updated weights) from executor group
    checkpoints, one ``groups/<site>/`` per site group."""
    from repro_torch import ckpt
    from repro_torch.pruning import sites as sites_lib

    specs = {s.name: s for s in sites_lib.site_specs(cfg, params)}
    dev = _device_of(params)
    tree: dict = {}
    new_params = params
    found = 0
    for name, ppath in _site_paths(cfg):
        found_g = ckpt.restore_latest(groups_dir / name)
        if found_g is None:
            continue
        restored, spec = found_g[1], specs[name]

        def unstack(arr):
            t = ckpt.to_tensor(arr, dev)
            return (t.reshape(*spec.stack_shape, spec.d_out, spec.d_in)
                    if spec.stack_shape else t[0])

        node = tree
        for k in ppath[:-1]:
            node = node.setdefault(k, {})
        node[ppath[-1]] = unstack(restored["masks"])
        if "new_weights" in restored:
            if new_params is params:
                new_params = _copy_dicts(params)
            old = _get(params, ppath)
            _set(new_params, ppath,
                 unstack(restored["new_weights"]).to(old.dtype))
        found += 1
    if not found:
        raise FileNotFoundError(
            f"no valid group mask checkpoints under {groups_dir}")
    # keep top-level family keys the models index unconditionally
    for name, _ in _site_paths(cfg):
        tree.setdefault(name.split(".", 1)[0], {})
    return tree, new_params


def _device_of(params: dict) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


def _masks_from_tree_ckpt(cfg, params: dict, d: Path) -> dict:
    """Restore a full masks-tree checkpoint from its own manifest, onto
    the device of ``params``. ``cfg`` backfills the top-level family keys
    the models index unconditionally."""
    from repro_torch import ckpt

    found = ckpt.restore_latest(d)
    if found is None:
        raise FileNotFoundError(f"no valid checkpoint under {d}")
    tree = ckpt.unflatten(found[1], _device_of(params))
    for name, _ in _site_paths(cfg):
        tree.setdefault(name.split(".", 1)[0], {})
    return tree
