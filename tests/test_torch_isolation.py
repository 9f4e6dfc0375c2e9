"""The port stands alone: no JAX and nothing of the reference package.

An AST scan of every module under ``src/repro_torch`` and of
``chip_smoke.py`` finds no ``jax`` import and no ``repro`` import (as
opposed to ``repro_torch``); importing every module of the port in a
fresh interpreter leaves ``jax`` and ``repro`` out of ``sys.modules`` and
needs no CUDA toolchain.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports(path):
    bad = [name for name in _imports(path) if _foreign(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_port():
    names = {p.relative_to(PORT).as_posix() for p in FILES[:-1]}
    for must in ("launch/prune.py", "kernels/ops.py", "core/sparseswaps.py",
                 "pruning/pipeline.py", "convert.py", "kernels/spmm.py",
                 "serve/engine.py", "ckpt/store.py", "launch/serve.py",
                 "core/packed.py", "core/dsnot.py", "core/sparsegpt.py",
                 "pruning/recipe.py", "pruning/plan.py",
                 "pruning/executor.py", "pruning/stats.py",
                 "pruning/recover.py", "runtime/fault_tolerance.py",
                 "serve/sampling.py", "serve/_threefry.py",
                 "serve/kvcache.py", "serve/scheduler.py",
                 "serve/loadgen.py", "serve/faultinject.py",
                 "optim/adamw.py", "train/steps.py", "launch/train.py",
                 "models/moe.py", "configs/mixtral_8x7b.py",
                 "configs/granite_moe_3b.py", "models/rwkv6.py",
                 "models/rwkv_model.py", "configs/rwkv6_1b6.py",
                 "models/encdec.py", "configs/seamless_m4t_medium.py",
                 "configs/llama32_vision_90b.py"):
        assert must in names


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "repro_torch." + p.relative_to(PORT).with_suffix("").as_posix()
        .replace("/", ".").removesuffix(".__init__")
        for p in FILES[:-1])
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.'))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('FOREIGN', bad)\n"
        "from repro_torch.kernels import build\n"
        "print('BUILT', sorted(build._LIBS))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FOREIGN []" in out.stdout
    assert "BUILT []" in out.stdout          # nothing compiled at import
