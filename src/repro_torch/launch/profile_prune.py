"""Where the device time of calibration and of one ``prune_model`` call
goes, by torch.profiler.

    PYTHONPATH=src python -m repro_torch.launch.profile_prune \
        --n-layers 2 --t-max 4 --n-calib 128

Builds llama31-8b at full width (``--tiny``: its tiny config) with the
depth cut to ``--n-layers`` and random weights from seed 0, and makes
``--n-calib`` calibration samples of 128 tokens in batches of 4 (the
launcher's defaults: 16 samples). First calibration alone
(``accumulate_stats``, every tap at the Gram level, as the pruning plan
asks): its wall time, then under the profiler the device time of the Gram
kernel and of the accumulator's in-place adds (``stats._add_into``, traced
as one span per batch). Then ``prune_model`` with Wanda, PerRow(0.6) and
k = 8 swaps per pass: once to build the kernels and time the call
unprofiled, then once more under ``torch.profiler``; prints both wall
times, the device-busy share of the profiled call and the kernels with
the most device time. Runs on the card unless ``--device cpu``, where no
device time exists to measure. TF32 is off, as in the launcher.
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
ADD_SPAN = "calibration _add_into"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_breakdown(prof, wall: float, label: str = "profiled") -> list[str]:
    """Lines of the device-busy share of ``wall`` (the ``label`` call's
    wall time) and the TOP kernels by time."""
    from torch.autograd import DeviceType

    per_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name != ADD_SPAN:
            acc = per_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us()
            acc[1] += 1
    if not per_name:
        return ["device time: not measured (the profiler saw no kernels)"]
    busy = sum(v[0] for v in per_name.values()) / 1e6
    lines = [f"{label} wall {wall:.2f} s, device busy {busy:.2f} s "
             f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%"]
    for name, (us, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
        lines.append(f"  {us / 1e3:10.1f} ms {100 * us / 1e6 / busy:5.1f}% "
                     f"{n:6d}x  {name[:80]}")
    return lines


def calibration_breakdown(api, params, batches, dev) -> list[str]:
    """Wall time of ``accumulate_stats`` over ``batches`` (after a warm-up
    call), then its device time under the profiler: the Gram kernel's
    (kernels named ``gram``), the accumulator adds', and the top kernels,
    with the device's busy share of the unprofiled wall time (the
    profiler's start-up would dominate the profiled call's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.pruning import stats as stats_mod

    def calibrate():
        pruning.accumulate_stats(api, params, batches)
        _sync(dev)

    calibrate()
    t0 = time.perf_counter()
    calibrate()
    wall = time.perf_counter() - t0
    line = (f"calibration: {len(batches)} batches of "
            f"{tuple(batches[0]['tokens'].shape)} tokens, wall {wall:.3f} s")
    if dev.type != "cuda":
        return [line + "; device time: not measured (no card)"]
    add_into = stats_mod._add_into

    def traced(acc, new):
        with record_function(ADD_SPAN):
            add_into(acc, new)

    stats_mod._add_into = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            calibrate()
    finally:
        stats_mod._add_into = add_into
    gram = [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA and "gram" in e.name]
    # _add_into recurses through the tap tree, so spans nest: count the
    # outermost one of each batch
    adds = [e.device_time_total for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name == ADD_SPAN
            and (e.cpu_parent is None or e.cpu_parent.name != ADD_SPAN)]
    return [line + "; device time (profiled call): Gram kernel "
            f"{sum(gram) / 1e3:.3f} ms ({len(gram)} launches), accumulator "
            f"adds (_add_into) {sum(adds) / 1e3:.3f} ms ({len(adds)} batches)",
            *device_breakdown(prof, wall, "unprofiled")]


def profile_prune(*, tiny: bool = False, n_layers: int | None = None,
                  t_max: int = 4, n_calib: int = 16,
                  device="cuda") -> list[str]:
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    disable_tf32()
    cfg = configs.get_tiny(ARCH) if tiny else configs.get(ARCH)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    api = models.build(cfg)
    params = api.init(seed=SEED, device=dev)
    batches = list(pruning.calibration_batches(
        cfg, n_samples=n_calib, seq_len=128, batch_size=4, seed=SEED,
        device=dev))
    calib = calibration_breakdown(api, params, batches, dev)

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
    lines = [f"{cfg.name}: n_layers {cfg.n_layers}, t_max {t_max}, n_calib "
             f"{n_calib}, device {dev}", *calib,
             f"prune_model: first call {first:.2f} s, unprofiled {wall:.2f} s"]
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
    ap.add_argument("--n-calib", type=int, default=16,
                    help="calibration samples of 128 tokens (batches of 4)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for line in profile_prune(tiny=args.tiny, n_layers=args.n_layers,
                              t_max=args.t_max, n_calib=args.n_calib,
                              device=args.device):
        print(line, flush=True)


if __name__ == "__main__":
    main()
