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
Writes land in ``step_X.tmp-<nonce>/`` first, are fsync'd, then renamed,
so a reader never sees a partial checkpoint; a hash mismatch marks a
checkpoint invalid and ``latest_valid`` skips it.

fp32, int32, uint8 and bf16 leaves travel both ways. bf16 leaves are
written byte for byte as the reference writes them: its ml_dtypes arrays
land in the .npz as raw 2-byte records (numpy reads them back as ``V2``)
under manifest dtype "bfloat16". ``restore`` returns them as those ``V2``
records, and ``to_tensor`` reads them through their 16-bit pattern as
``torch.bfloat16``. Sharded, multi-host restores and the reference's
retry of transient I/O errors are not ported (ROADMAP A5).

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


def save(ckpt_dir: str | Path, step: int, tree, *,
         extra: dict | None = None) -> Path:
    """Write one atomic checkpoint of a nested dict of tensors/arrays."""
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
            _write_fsync(tmp / fname, lambda f: np.savez(f, **bufs))
        _write_fsync(tmp / "MANIFEST.json",
                     lambda f: f.write(json.dumps(manifest).encode()))
        if final.exists():
            # a rerun at the same step supersedes it: move the old one
            # aside (a .tmp- name readers skip), publish, then delete it
            old = Path(tempfile.mkdtemp(prefix=final.name + ".tmp-old-",
                                        dir=ckpt_dir))
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, final)                # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
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


def restore(ckpt_dir: str | Path, step: int,
            paths=None) -> tuple[dict, dict]:
    """The leaves of one checkpoint (all of them, or those named in
    ``paths``), assembled from their shards' index slices: ({path:
    np.ndarray}, manifest); bf16 leaves as ``V2`` records. Raises
    ``IOError`` on a hash mismatch and ``KeyError`` on a missing path."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    man = _load_manifest(d)
    if man is None:
        raise FileNotFoundError(d)
    by_path = {e["path"]: e for e in man["leaves"]}
    entries = [by_path[p] for p in (by_path if paths is None else paths)]
    checked = iter(_read_checked(
        d, [sh for e in entries for sh in e["shards"]], keep=True))
    out = {}
    for e in entries:
        dtype = np.dtype("V2" if e["dtype"] == "bfloat16" else e["dtype"])
        arrs = []
        for sh in e["shards"]:
            arr, ok = next(checked)
            if not ok:
                raise IOError(f"hash mismatch in {d}/{sh['file']}:"
                              f"{sh['key']}")
            arrs.append(arr)
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
                 device=None) -> tuple[object, dict]:
    """The counterpart of the reference's ``restore(dir, step, target)``:
    the leaves ``like``'s structure names (nested dicts and NamedTuples,
    None an empty subtree), read and hash-checked, as tensors in that
    structure on ``device`` (default: each ``like`` leaf's device), with
    the dtypes the manifest records. Returns (tree, manifest)."""
    flat, man = restore(ckpt_dir, step, [p for p, _ in _flatten(like)])
    return _rebuild(like, flat, device), man


def restore_latest_like(ckpt_dir: str | Path, like, *, device=None):
    """(step, tree, manifest) of the newest checkpoint whose leaves that
    ``like`` names read back and pass their hash checks, or None."""
    for s in reversed(steps(ckpt_dir)):
        try:
            tree, man = restore_like(ckpt_dir, s, like, device=device)
        except (OSError, KeyError, ValueError):
            continue
        return s, tree, man
    return None
