"""Where the device time of one ``prune_model`` call goes, by torch.profiler.

    PYTHONPATH=src python -m repro_torch.launch.profile_prune \
        --n-layers 2 --t-max 4

Builds llama31-8b at full width (``--tiny``: its tiny config) with the
depth cut to ``--n-layers`` and random weights from seed 0, calibrates
with the launcher's defaults (16 samples x 128 tokens, batches of 4) and
prunes with Wanda, PerRow(0.6) and k = 8 swaps per pass: once to build the
kernels and time the call unprofiled, then once more under
``torch.profiler``. Prints both wall times, the device-busy share of the
profiled call and the kernels with the most device time. Runs on the card
unless ``--device cpu``, where no device time exists to measure. TF32 is
off, as in the launcher.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, models, pruning
from repro_torch.core import masks as masks_lib

from repro_torch.device import disable_tf32, resolve_device

ARCH = "llama31-8b"
SEED = 0
TOP = 8          # kernels listed by device time


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_breakdown(prof, wall: float) -> list[str]:
    """Lines of the device-busy share and the TOP kernels by time."""
    from torch.autograd import DeviceType

    per_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = per_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us()
            acc[1] += 1
    if not per_name:
        return ["device time: not measured (the profiler saw no kernels)"]
    busy = sum(v[0] for v in per_name.values()) / 1e6
    lines = [f"profiled wall {wall:.2f} s, device busy {busy:.2f} s "
             f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%"]
    for name, (us, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
        lines.append(f"  {us / 1e3:10.1f} ms {100 * us / 1e6 / busy:5.1f}% "
                     f"{n:6d}x  {name[:80]}")
    return lines


def profile_prune(*, tiny: bool = False, n_layers: int | None = None,
                  t_max: int = 4, device="cuda") -> list[str]:
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    disable_tf32()
    cfg = configs.get_tiny(ARCH) if tiny else configs.get(ARCH)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    api = models.build(cfg)
    params = api.init(seed=SEED, device=dev)
    batches = list(pruning.calibration_batches(
        cfg, n_samples=16, seq_len=128, batch_size=4, seed=SEED, device=dev))

    def run():
        pruning.prune_model(api, params, batches, masks_lib.PerRow(0.6),
                            warmstart="wanda", method="sparseswaps",
                            t_max=t_max, k_swaps=8)
        _sync(dev)

    t0 = time.perf_counter()
    run()                                   # builds the kernels on the card
    first = time.perf_counter() - t0
    _sync(dev)
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    lines = [f"{cfg.name}: n_layers {cfg.n_layers}, t_max {t_max}, "
             f"device {dev}; first call {first:.2f} s, unprofiled {wall:.2f} s"]
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        run()
    lines += device_breakdown(prof, time.perf_counter() - t0)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--t-max", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for line in profile_prune(tiny=args.tiny, n_layers=args.n_layers,
                              t_max=args.t_max, device=args.device):
        print(line, flush=True)


if __name__ == "__main__":
    main()
