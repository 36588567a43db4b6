"""Device time of a decode under torch.profiler: the shared half of the
profile tools (profile_hevc_intra, profile_hevc_inter, profile_h264_intra,
profile_h264_inter) and of chip_smoke.py's launch counts. Needs a GPU."""

from __future__ import annotations

import os
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from jmcodec_tpu_torch.utils.device import gpu_name_power


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def raw_events(prof):
    """(name, device type, start us, end us) of every event a finished
    torch.profiler run recorded, read from its raw results: building the
    profiler's Python event tree costs minutes for the several hundred
    thousand launches of an H.264 decode."""
    return [(e.name(), e.device_type(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()]


def profile_decode(decode, title: str, trace=None, stages=()):
    """Run decode() once under torch.profiler (after a warm-up run) and
    print the card, the device's busy time, the launches and the top
    kernels. stages: names of record_function ranges that decode() opens
    and closes with a synchronise; each name gets its own line with the
    host wall time, launches and device busy time of all its ranges."""
    decode()                                        # warm-up: builds, tables
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode()
        torch.cuda.synchronize()
    events = raw_events(prof)
    # device-side events; a record_function range shows up there too
    kernels = [e for e in events if e[1] == DeviceType.CUDA
               and e[0] not in stages]
    busy_us = union_us(e[2:] for e in kernels)
    by_name = defaultdict(lambda: [0.0, 0])
    for name, _, t0, t1 in kernels:
        by_name[name][0] += t1 - t0
        by_name[name][1] += 1
    print(gpu_name_power())
    print(f"{title}: device busy {busy_us / 1e3:.2f} ms over {len(kernels)} "
          f"kernel launches (profiled decode)")
    for name in stages:
        ranges = sorted(e[2:] for e in events
                        if e[0] == name and e[1] == DeviceType.CPU)
        inside = [e for e in kernels
                  if any(t0 <= e[2] < t1 for t0, t1 in ranges)]
        print(f"  stage {name}: host wall "
              f"{sum(t1 - t0 for t0, t1 in ranges) / 1e3:.2f} ms (profiled, "
              f"{len(ranges)} calls), {len(inside)} launches, device busy "
              f"{union_us(e[2:] for e in inside) / 1e3:.2f} ms")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (us, n) in ranked[:15]:
        print(f"  {us / 1e3:9.2f} ms {n:6d}x  {name[:100]}")
    if trace:
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        prof.export_chrome_trace(trace)
        print(f"trace: {trace}")
