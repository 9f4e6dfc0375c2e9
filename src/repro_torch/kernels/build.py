"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. Libraries land in ``build/repro_torch/``
at the repository root (ignored by git); the file name carries a hash of
the sources and flags, so a stale library never loads. Nothing here runs
at import: the first launch of a kernel builds it, and ``build`` starts
several builds at once.

A failed build raises. There is no fallback to the plain versions on a
CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# sm_90a: Hopper. No --use_fast_math: the swap kernels compare +inf.
_COMMON = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC")
_REPORT = ("-Xptxas", "-v")
# Per-library extra flags. -fmad=false: no multiply-add contraction, so
# the swap kernels and the commit evaluate ΔL exactly as the plain PyTorch
# versions do (the Gram has always been built alongside them with it).
# spmm allows contraction.
_EXTRA = {"gram": ("-fmad=false",), "swap_topk": ("-fmad=false",),
          "swap_commit": ("-fmad=false",)}


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The nvcc flags of library ``name``."""
    return (*_COMMON, *_EXTRA.get(name, ()), *_REPORT)

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of repro_torch build with the CUDA toolkit")
    return found


def _sources(name: str) -> list[Path]:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(src)
    return [src, *sorted(CSRC.glob("*.cuh"))]


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in _sources(name):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    return lib_path(name).with_suffix(".log")


def build(names) -> dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, all at
    once (one ``nvcc`` per source). Returns {name: library path}; the
    compiler's ``-Xptxas -v`` report lands beside each library (.log)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.is_file():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *nvcc_flags(name), "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: lib_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def ptxas_report(name: str) -> str:
    """Registers, shared memory and spills per kernel, from the build log."""
    path = log_path(name)
    if not path.is_file():
        return ""
    keep = ("Compiling entry", "Used", "spill", "bytes stack")
    return "\n".join(line.strip() for line in path.read_text().splitlines()
                     if any(k in line for k in keep))
