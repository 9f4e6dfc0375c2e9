"""Mesh construction and logical-axis rules (the reference's
``repro.launch.mesh``), over ``torch.distributed``.

A mesh is a ``DeviceMesh`` over an initialised default process group:

    host        (data, model)            the world (tests, one card, CPU)
    single-pod  (16, 16)      ("data", "model")          256 ranks
    multi-pod   (2, 16, 16)   ("pod", "data", "model")   512 ranks

"pod" is the outermost data-parallel axis, "data" in-pod data parallel,
"model" tensor parallel. ``init_distributed`` makes the default group:
NCCL for a CUDA device, gloo for the CPU (two ranks on one card pass
``backend="gloo"``: NCCL refuses two ranks on one device). Every group
has a timeout (``dist.groups.TIMEOUT``), so a rank lost in a collective
fails the run instead of hanging it. Asking for a mesh without a process
group raises: nothing carries on as one device.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from repro_torch.dist import groups as groups_lib
from repro_torch.dist import sharding as sharding_lib

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device, *, backend: str | None = None,
                     init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None) -> bool:
    """Initialise the default process group for ``device``; False when one
    already exists (the caller then must not destroy it).

    Without ``init_method`` the rank, world size and address come from the
    environment, as ``torchrun`` sets them; a ``file://`` store takes
    ``rank`` and ``world_size``. On a CUDA device the current device is
    ``LOCAL_RANK`` (0 without it)."""
    if dist.is_initialized():
        return False
    dev = torch.device(device)
    if init_method is None:
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"a mesh needs a process group, and {', '.join(missing)} "
                "are not set: run under torchrun (torchrun --standalone "
                "--nproc-per-node N -m ...)")
        init_method = "env://"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method, rank=-1 if rank is None else rank,
        world_size=-1 if world_size is None else world_size,
        timeout=groups_lib.TIMEOUT)
    return True


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ("data", "model"), or (2, 16, 16) with "pod" in front."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return groups_lib.build_mesh(shape, names, device_type=_device_type())


def make_host_mesh(*, data: int | None = None, model: int = 1):
    """A ("data", "model") mesh over the whole world (tests, CPU runs, one
    card); ``data`` defaults to world // model."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialised process group: call "
            "init_distributed first")
    data = data if data is not None else dist.get_world_size() // model
    return groups_lib.build_mesh((data, model), ("data", "model"),
                                 device_type=_device_type())


@contextlib.contextmanager
def launcher_mesh(name: str | None, device):
    """A launcher's ``--mesh``: None without ``name``, else "production"
    (``make_production_mesh``) or "host" (``make_host_mesh``) over the
    process group from torchrun's environment. A group made here is
    destroyed on the way out; one that existed already is left for its
    owner."""
    if name is None:
        yield None
        return
    owned = init_distributed(device)
    try:
        yield (make_production_mesh() if name == "production"
               else make_host_mesh())
    finally:
        if owned:
            dist.destroy_process_group()


@contextlib.contextmanager
def activate(mesh, cfg_arch=None, *, seq_parallel: bool = True):
    """Install the logical-axis rules that match ``mesh`` and the config
    for the extent of the block."""
    sizes = groups_lib.axis_sizes(mesh)
    kv_ok = bool(cfg_arch and cfg_arch.n_kv_heads
                 and cfg_arch.n_kv_heads % sizes["model"] == 0)
    rules = sharding_lib.standard_rules(
        multi_pod="pod" in sizes, kv_shardable=kv_ok,
        moe_parallelism=(cfg_arch.moe_parallelism if cfg_arch else "tp"),
        seq_parallel=seq_parallel)
    with sharding_lib.use_rules(rules, mesh):
        yield mesh
