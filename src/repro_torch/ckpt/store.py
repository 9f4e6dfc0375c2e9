"""Atomic checkpoints in the reference's on-disk format, numpy only.

Layout of one checkpoint directory (as ``repro.ckpt.store`` writes it)::

    step_000123/
      MANIFEST.json      step, time, extra, per-leaf {path, shape, dtype,
                         shards: [{file, key, index, sha256}]}
      shard_0_<k>.npz

Leaf paths join the nested dict keys with "/", in sorted key order (the
order JAX flattens a dict in). One process writes every leaf as a single
shard covering the whole array, so each package reads what the other
writes. Writes land in ``step_X.tmp-<nonce>/`` first, are fsync'd, then
renamed, so a reader never sees a partial checkpoint; a hash mismatch
marks a checkpoint invalid and ``latest_valid`` skips it.

fp32, int32 and uint8 leaves travel both ways. bf16 leaves (a
``weights/`` dump of updated bf16 weights) are written byte for byte as
the reference writes them: its ml_dtypes arrays land in the .npz as raw
2-byte records under manifest dtype "bfloat16". Reading bf16 back waits
for the ``weights/`` splice (ROADMAP A2) and raises, as do sharded,
multi-host restores and the reference's retry of transient I/O errors.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


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
        for name, leaf in _flatten(tree):
            arr, dtype = _to_numpy(leaf)
            key = f"{name}__0"
            bufs[key] = arr
            manifest["leaves"].append({
                "path": name, "shape": list(arr.shape),
                "dtype": dtype,
                "shards": [{"file": fname, "key": key,
                            "index": [[0, -1]] * arr.ndim,
                            "sha256": _sha256(arr)}],
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


class _Shards:
    """Open .npz shard files of one checkpoint, closed on exit."""

    def __init__(self, d: Path):
        self.d, self.files = d, {}

    def get(self, sh: dict) -> np.ndarray:
        if sh["file"] not in self.files:
            self.files[sh["file"]] = np.load(self.d / sh["file"])
        return self.files[sh["file"]][sh["key"]]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for f in self.files.values():
            f.close()


def validate(d: str | Path) -> bool:
    """Full hash check of every shard (corruption detection)."""
    d = Path(d)
    man = _load_manifest(d)
    if man is None:
        return False
    try:
        with _Shards(d) as shards:
            for leaf in man["leaves"]:
                for sh in leaf["shards"]:
                    if _sha256(shards.get(sh)) != sh["sha256"]:
                        return False
    except (OSError, KeyError, ValueError):
        return False
    return True


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


def restore(ckpt_dir: str | Path, step: int) -> tuple[dict, dict]:
    """Every leaf of one checkpoint, assembled from its shards' index
    slices: ({path: np.ndarray}, manifest). Raises ``IOError`` on a hash
    mismatch."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    man = _load_manifest(d)
    if man is None:
        raise FileNotFoundError(d)
    out = {}
    with _Shards(d) as shards:
        for e in man["leaves"]:
            if e["dtype"] == "bfloat16":
                raise NotImplementedError(
                    f"leaf {e['path']!r} is bfloat16; bf16 checkpoints wait "
                    "for the weights/ rule (ROADMAP A2)")
            full = np.zeros(e["shape"], dtype=e["dtype"])
            for sh in e["shards"]:
                arr = shards.get(sh)
                if _sha256(arr) != sh["sha256"]:
                    raise IOError(f"hash mismatch in {d}/{sh['file']}:"
                                  f"{sh['key']}")
                full[_slices(sh["index"], e["shape"])] = arr
            out[e["path"]] = full
    return out, man
