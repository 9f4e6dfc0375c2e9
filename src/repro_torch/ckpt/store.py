"""Atomic checkpoints in the reference's on-disk format, numpy only.

Layout of one checkpoint directory (as ``repro.ckpt.store`` writes it)::

    step_000123/
      MANIFEST.json      step, time, extra, per-leaf {path, shape, dtype,
                         shards: [{file, key, index, sha256}]}
      shard_0_<k>.npz

Leaf paths join the nested dict keys with "/", in sorted key order (the
order JAX flattens a dict in); a NamedTuple's fields (a ``TrainState``)
join as ``.field`` in field order, and None is an empty subtree, as in
``jax.tree_util``. One process writes every leaf as a single shard
covering the whole array, so each package reads what the other writes.
A tree sharded over a mesh (``save(shardings=)``, a
``dist.placement.Layout``) is saved in the reference's multi-shard
layout: every rank writes ``shard_<rank>_0.npz`` with the blocks it
holds, each under its index slices, a block (a replicated leaf too)
written once, by the one holder at coordinate 0 on the axes it is not
split over; after a barrier the main rank writes the manifest and
publishes. ``restore_like(shardings=)`` assembles each rank's block from
the shards that overlap it, so a checkpoint restores onto any mesh, or
onto one device, whatever mesh wrote it. Every write (shards, manifest,
the publishing rename) goes through ``runtime.fault_tolerance.retry``,
as the reference's do. Writes land in ``step_X.tmp-<nonce>/`` first, are
fsync'd, then renamed, so a reader never sees a partial checkpoint; a
hash mismatch marks a checkpoint invalid and ``latest_valid`` skips it.

fp32, int32, uint8 and bf16 leaves travel both ways. bf16 leaves are
written byte for byte as the reference writes them: its ml_dtypes arrays
land in the .npz as raw 2-byte records (numpy reads them back as ``V2``)
under manifest dtype "bfloat16". ``restore`` returns them as those ``V2``
records, and ``to_tensor`` reads them through their 16-bit pattern as
``torch.bfloat16``.

Each leaf's sha256 is taken on a pool of threads, the leaves in
parallel, on save; a read (``validate``, ``restore``) gives each worker
one shard to read through its own handle on the .npz and hash
(``hashlib``, ``zlib``'s CRC check and file reads release the GIL on
large buffers), and ``validate`` drops each array in its worker, so it
holds no more than the pool's width of shards. A leaf that ``restore``
reads back as one whole-array shard is returned as read; a leaf of
several shards (the reference's layout for a sharded array) is
assembled from their index slices.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch.runtime import fault_tolerance as ft

# the retries of every write: transient OSErrors back off and retry
_RETRY = dict(retries=3, base_delay=0.05, max_delay=1.0)


def _children(tree) -> list[tuple[str, object]] | None:
    """(path component, child) of a dict (sorted keys) or a NamedTuple
    (``.field``, in field order); None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    return None


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    kids = _children(tree)
    if kids is None:
        return [] if tree is None else [(prefix[:-1], tree)]
    out = []
    for k, v in kids:
        out += _flatten(v, f"{prefix}{k}/")
    return out


def to_tensor(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """A restored leaf as a tensor on ``device``; ``V2`` records (bf16)
    through their 16-bit pattern."""
    if arr.dtype == np.dtype("V2"):
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.asarray(arr)).to(device)


def unflatten(flat: dict, device="cpu") -> dict:
    """{"a/b/c": array} -> nested dicts of tensors on ``device``."""
    tree: dict = {}
    for path, arr in flat.items():
        keys = path.split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = to_tensor(arr, device)
    return tree


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, manifest dtype); bf16 travels as raw 2-byte
    records, the bytes the reference's ml_dtypes arrays hold."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view("V2"), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _sha256(arr: np.ndarray) -> str:
    # hashed in place: a contiguous array is its own byte buffer
    return hashlib.sha256(
        np.ascontiguousarray(arr).reshape(-1).view(np.uint8)).hexdigest()


def _pooled(fn, items: list) -> list:
    """``fn`` of each item, on up to 8 threads, in order."""
    if len(items) < 2:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1, len(items))) as ex:
        return list(ex.map(fn, items))


def _write_fsync(path: Path, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def _publish(tmp: Path, final: Path, ckpt_dir: Path) -> None:
    """Rename ``tmp`` to ``final``; a rerun at the same step supersedes
    it: the old one moves aside (a .tmp- name readers skip) first."""
    if final.exists():
        old = Path(tempfile.mkdtemp(prefix=final.name + ".tmp-old-",
                                    dir=ckpt_dir))
        os.replace(final, old)
        ft.retry(os.replace, tmp, final, **_RETRY)
        shutil.rmtree(old, ignore_errors=True)
    else:
        ft.retry(os.replace, tmp, final, **_RETRY)     # atomic publish


def save(ckpt_dir: str | Path, step: int, tree, *,
         extra: dict | None = None, shardings=None) -> Path:
    """Write one atomic checkpoint of a nested dict of tensors/arrays.
    ``shardings`` (a ``dist.placement.Layout``): ``tree`` holds this
    rank's blocks; every rank of the mesh calls it."""
    if shardings is not None:
        return _save_sharded(Path(ckpt_dir), step, tree, shardings,
                             extra=extra)
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(prefix=final.name + ".tmp-", dir=ckpt_dir))
    try:
        manifest = {"step": step, "time": time.time(),
                    "extra": extra or {}, "leaves": []}
        fname = "shard_0_0.npz"
        bufs: dict[str, np.ndarray] = {}
        leaves = [(name, *_to_numpy(leaf)) for name, leaf in _flatten(tree)]
        hashes = _pooled(_sha256, [arr for _, arr, _ in leaves])
        for (name, arr, dtype), sha in zip(leaves, hashes):
            key = f"{name}__0"
            bufs[key] = arr
            manifest["leaves"].append({
                "path": name, "shape": list(arr.shape),
                "dtype": dtype,
                "shards": [{"file": fname, "key": key,
                            "index": [[0, -1]] * arr.ndim,
                            "sha256": sha}],
            })
        if bufs:
            ft.retry(_write_fsync, tmp / fname,
                     lambda f: np.savez(f, **bufs), **_RETRY)
        ft.retry(_write_fsync, tmp / "MANIFEST.json",
                 lambda f: f.write(json.dumps(manifest).encode()), **_RETRY)
        _publish(tmp, final, ckpt_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _flat_specs(tree, specs) -> list[tuple[str, object, tuple]]:
    """(path, leaf, spec) of a tree and its spec tree, in ``_flatten``'s
    order."""
    paths = dict(_flatten(tree))
    return [(p, paths[p], sp) for p, sp in _flatten(specs) if p in paths]


def _save_sharded(ckpt_dir: Path, step: int, tree, layout, *,
                  extra: dict | None) -> Path:
    """``save`` of a tree sharded over ``layout.mesh`` (collective)."""
    import torch.distributed as dist

    from repro_torch.dist import placement

    mesh = layout.mesh
    rank = dist.get_rank()
    final = ckpt_dir / f"step_{step:08d}"
    name = [None]
    if rank == 0:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        name[0] = tempfile.mkdtemp(prefix=final.name + ".tmp-",
                                   dir=ckpt_dir)
    dist.broadcast_object_list(name, src=0)
    tmp = Path(name[0])
    try:
        fname, bufs, metas, mine = f"shard_{rank}_0.npz", {}, [], []
        for path, leaf, spec in _flat_specs(tree, layout.specs):
            arr, dtype = _to_numpy(leaf)
            # the leaf's whole shape: the block's times its splits
            shape = [n * k for n, k in zip(
                arr.shape, placement.split_counts(spec, mesh))]
            metas.append((path, shape, dtype))
            if placement.writes_block(spec, mesh):
                key = f"{path}__{rank}"
                bufs[key] = arr
                mine.append({"path": path, "file": fname, "key": key,
                             "index": [[sl.start, sl.stop] for sl in
                                       placement.block_index(shape, spec,
                                                             mesh)]})
        hashes = _pooled(_sha256, list(bufs.values()))
        shards = [dict(e, sha256=h) for e, h in zip(mine, hashes)]
        if bufs:
            ft.retry(_write_fsync, tmp / fname,
                     lambda f: np.savez(f, **bufs), **_RETRY)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, shards)        # a barrier too
        if rank == 0:
            by_path: dict[str, list] = {}
            for part in every:
                for sh in part:
                    by_path.setdefault(sh.pop("path"), []).append(sh)
            manifest = {"step": step, "time": time.time(),
                        "extra": extra or {}, "leaves": [
                            {"path": p, "shape": shp, "dtype": dt,
                             "shards": by_path[p]} for p, shp, dt in metas]}
            ft.retry(_write_fsync, tmp / "MANIFEST.json",
                     lambda f: f.write(json.dumps(manifest).encode()),
                     **_RETRY)
            _publish(tmp, final, ckpt_dir)
    except BaseException:
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    dist.barrier()                   # published before anyone reads it
    return final


def _load_manifest(d: Path) -> dict | None:
    try:
        return json.loads((d / "MANIFEST.json").read_text())
    except (OSError, json.JSONDecodeError):
        return None


def _read_checked(d: Path, shards: list[dict], *, keep: bool) -> list:
    """(array, whether its sha256 matches) of each of ``shards`` ({file,
    key, sha256}) of checkpoint ``d``, on the pool: each worker opens its
    own handle on the shard's .npz, reads the shard and hashes it. Unless
    ``keep`` the array is dropped (None) in the worker, so no more than
    the pool's width of shards is held at once."""
    def one(sh: dict):
        with np.load(d / sh["file"]) as f:
            arr = f[sh["key"]]
        return (arr if keep else None), _sha256(arr) == sh["sha256"]

    return _pooled(one, shards)


def validate(d: str | Path) -> bool:
    """Full hash check of every shard (corruption detection)."""
    d = Path(d)
    man = _load_manifest(d)
    if man is None:
        return False
    try:
        checked = _read_checked(
            d, [sh for leaf in man["leaves"] for sh in leaf["shards"]],
            keep=False)
    except (OSError, KeyError, ValueError):
        return False
    return all(ok for _, ok in checked)


def steps(ckpt_dir: str | Path) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return []
    return sorted(int(d.name.split("_")[1]) for d in ckpt_dir.iterdir()
                  if d.is_dir() and d.name.startswith("step_")
                  and ".tmp" not in d.name)


def latest_valid(ckpt_dir: str | Path) -> int | None:
    """Newest step whose checkpoint passes the hash check; skips corrupt."""
    for s in reversed(steps(ckpt_dir)):
        if validate(Path(ckpt_dir) / f"step_{s:08d}"):
            return s
    return None


def restore_latest(ckpt_dir: str | Path) -> tuple[int, dict, dict] | None:
    """(step, {path: np.ndarray}, manifest) of the newest checkpoint whose
    every shard passes its hash check, or None: the step ``latest_valid``
    picks, restored, with each shard read once instead of twice."""
    for s in reversed(steps(ckpt_dir)):
        try:
            tree, man = restore(ckpt_dir, s)
        except (OSError, KeyError, ValueError):
            continue
        return s, tree, man
    return None


def gc(ckpt_dir: str | Path, keep: int = 3) -> None:
    """Remove stale .tmp dirs and every checkpoint but the newest ``keep``."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return
    for d in ckpt_dir.iterdir():
        if ".tmp-" in d.name:
            shutil.rmtree(d, ignore_errors=True)
    ss = steps(ckpt_dir)
    for s in ss[:-keep] if keep else []:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)


def _slices(index: list, shape: list) -> tuple:
    return tuple(slice(a, shape[i] if b == -1 else b)
                 for i, (a, b) in enumerate(index))


def _window(arr_index: tuple, window: tuple) -> tuple | None:
    """(source, destination) slices of the part of a shard at
    ``arr_index`` inside ``window`` (both in the leaf's coordinates), or
    None when they do not overlap."""
    inter = [slice(max(a.start, w.start), min(a.stop, w.stop))
             for a, w in zip(arr_index, window)]
    if any(i.start >= i.stop for i in inter):
        return None
    src = tuple(slice(i.start - a.start, i.stop - a.start)
                for i, a in zip(inter, arr_index))
    dst = tuple(slice(i.start - w.start, i.stop - w.start)
                for i, w in zip(inter, window))
    return src, dst


def restore(ckpt_dir: str | Path, step: int, paths=None, *,
            windows: dict | None = None) -> tuple[dict, dict]:
    """The leaves of one checkpoint (all of them, or those named in
    ``paths``), assembled from their shards' index slices: ({path:
    np.ndarray}, manifest); bf16 leaves as ``V2`` records. ``windows``
    ({path: slices}) asks for a block of a leaf: only the shards that
    overlap it are read. Raises ``IOError`` on a hash mismatch and
    ``KeyError`` on a missing path."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    man = _load_manifest(d)
    if man is None:
        raise FileNotFoundError(d)
    by_path = {e["path"]: e for e in man["leaves"]}
    entries = [by_path[p] for p in (by_path if paths is None else paths)]
    windows = windows or {}
    plan = []
    for e in entries:
        win = windows.get(e["path"])
        shards = [sh for sh in e["shards"] if win is None or _window(
            _slices(sh["index"], e["shape"]), win) is not None]
        plan.append((e, win, shards))
    checked = iter(_read_checked(
        d, [sh for _, _, shs in plan for sh in shs], keep=True))
    out = {}
    for e, win, shards in plan:
        dtype = np.dtype("V2" if e["dtype"] == "bfloat16" else e["dtype"])
        arrs = []
        for sh in shards:
            arr, ok = next(checked)
            if not ok:
                raise IOError(f"hash mismatch in {d}/{sh['file']}:"
                              f"{sh['key']}")
            arrs.append(arr)
        if win is not None:
            if (len(arrs) == 1 and arrs[0].dtype == dtype and _slices(
                    shards[0]["index"], e["shape"]) == tuple(win)):
                out[e["path"]] = arrs[0]    # one shard is the whole block
                continue
            block = np.zeros([w.stop - w.start for w in win], dtype=dtype)
            for sh, arr in zip(shards, arrs):
                src, dst = _window(_slices(sh["index"], e["shape"]), win)
                block[dst] = arr[src]
            out[e["path"]] = block
            continue
        one = arrs[0] if len(arrs) == 1 else None
        if (one is not None and one.dtype == dtype
                and list(one.shape) == e["shape"]
                and all(a == 0 and b in (-1, n) for (a, b), n in
                        zip(e["shards"][0]["index"], e["shape"]))):
            out[e["path"]] = one            # one shard is the whole leaf
            continue
        full = np.zeros(e["shape"], dtype=dtype)
        for sh, arr in zip(e["shards"], arrs):
            full[_slices(sh["index"], e["shape"])] = arr
        out[e["path"]] = full
    return out, man


def _rebuild(like, flat: dict, device, prefix: str = ""):
    kids = _children(like)
    if kids is None:
        if like is None:
            return None
        return to_tensor(flat[prefix[:-1]],
                         like.device if device is None else device)
    rebuilt = {k: _rebuild(v, flat, device, f"{prefix}{k}/") for k, v in kids}
    if isinstance(like, dict):
        return {k: rebuilt[str(k)] for k in like}
    return type(like)(*(rebuilt[f".{f}"] for f in like._fields))


def restore_like(ckpt_dir: str | Path, step: int, like, *,
                 device=None, shardings=None) -> tuple[object, dict]:
    """The counterpart of the reference's ``restore(dir, step, target,
    shardings=)``: the leaves ``like``'s structure names (nested dicts and
    NamedTuples, None an empty subtree), read and hash-checked, as tensors
    in that structure on ``device`` (default: each ``like`` leaf's
    device), with the dtypes the manifest records. ``shardings`` (a
    ``dist.placement.Layout`` of ``like``, whose leaves then have the
    whole shapes, on the meta device if need be): each leaf is this
    rank's block, assembled from the shards that overlap it. Returns
    (tree, manifest)."""
    windows = None
    if shardings is not None:
        from repro_torch.dist import placement

        windows = {p: placement.block_index(leaf.shape, spec,
                                            shardings.mesh)
                   for p, leaf, spec in _flat_specs(like, shardings.specs)}
    flat, man = restore(ckpt_dir, step, [p for p, _ in _flatten(like)],
                        windows=windows)
    return _rebuild(like, flat, device), man


def restore_latest_like(ckpt_dir: str | Path, like, *, device=None,
                        shardings=None):
    """(step, tree, manifest) of the newest checkpoint whose leaves that
    ``like`` names read back and pass their hash checks, or None. With
    ``shardings`` every rank of the mesh must read its block of the same
    step, or all move on to an older one."""
    for s in reversed(steps(ckpt_dir)):
        try:
            tree, man = restore_like(ckpt_dir, s, like, device=device,
                                     shardings=shardings)
            ok = True
        except (OSError, KeyError, ValueError):
            ok = False
        if shardings is not None:
            from repro_torch.dist import placement

            ok = placement.agree(ok, shardings.mesh)
        if ok:
            return s, tree, man
    return None
