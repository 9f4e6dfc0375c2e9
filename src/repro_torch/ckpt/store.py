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

fp32, int32 and uint8 leaves travel both ways. bf16 leaves (the
reference writes them through ml_dtypes) wait for the ``weights/`` rule
(ROADMAP A2) and raise here; so do sharded, multi-host restores, and the
reference's retry of transient I/O errors.
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


def _to_numpy(name: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise NotImplementedError(
                f"leaf {name!r} is bfloat16; bf16 checkpoints wait for the "
                "weights/ rule (ROADMAP A2)")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


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
            arr = _to_numpy(name, leaf)
            key = f"{name}__0"
            bufs[key] = arr
            manifest["leaves"].append({
                "path": name, "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "shards": [{"file": fname, "key": key,
                            "index": [[0, -1]] * arr.ndim,
                            "sha256": _sha256(arr)}],
            })
        if bufs:
            _write_fsync(tmp / fname, lambda f: np.savez(f, **bufs))
        _write_fsync(tmp / "MANIFEST.json",
                     lambda f: f.write(json.dumps(manifest).encode()))
        os.replace(tmp, final)                    # atomic publish
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


def _slices(index: list, shape: list) -> tuple:
    return tuple(slice(a, shape[i] if b == -1 else b)
                 for i, (a, b) in enumerate(index))


def restore(ckpt_dir: str | Path, step: int, *,
            check_hashes: bool = True) -> tuple[dict, dict]:
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
                if check_hashes and _sha256(arr) != sh["sha256"]:
                    raise IOError(f"hash mismatch in {d}/{sh['file']}:"
                                  f"{sh['key']}")
                full[_slices(sh["index"], e["shape"])] = arr
            out[e["path"]] = full
    return out, man
