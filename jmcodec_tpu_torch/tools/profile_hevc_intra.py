"""Where the device time of the batched 1080p HEVC all-intra decode goes.

Decodes the committed fixture at the smoke's batch (tools/fixtures.py)
from device-resident plan tensors, once under torch.profiler, and prints
the card, the device's busy time (the union of kernel intervals), the
number of kernel launches, and the kernels ranked by device time. The
decode's wall time and fps come from chip_smoke.py, without the profiler.
With --trace, writes the chrome trace for a timeline viewer. Needs a GPU:

    python -m jmcodec_tpu_torch.tools.profile_hevc_intra \
        [--trace out/hevc_intra_trace.json]
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from jmcodec_tpu_torch.api.hevc_intra import parse_hevc_intra_plans
from jmcodec_tpu_torch.kernels import hevc_tiles as HTT
from jmcodec_tpu_torch.tools.fixtures import BATCH, fixture_batch_stream
from jmcodec_tpu_torch.utils.device import gpu_name_power, require_cuda


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


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
    events = list(prof.events())
    # device-side events; a record_function range shows up there too
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in stages]
    span = lambda e: (e.time_range.start, e.time_range.end)
    busy_us = _union_us(span(e) for e in kernels)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    print(gpu_name_power())
    print(f"{title}: device busy {busy_us / 1e3:.2f} ms over {len(kernels)} "
          f"kernel launches (profiled decode)")
    for name in stages:
        ranges = [span(e) for e in events if e.name == name
                  and e.device_type == DeviceType.CPU]
        inside = [e for e in kernels
                  if any(s <= e.time_range.start < t for s, t in ranges)]
        print(f"  stage {name}: host wall "
              f"{sum(t - s for s, t in ranges) / 1e3:.2f} ms (profiled, "
              f"{len(ranges)} calls), {len(inside)} launches, device busy "
              f"{_union_us(span(e) for e in inside) / 1e3:.2f} ms")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (us, n) in ranked[:15]:
        print(f"  {us / 1e3:9.2f} ms {n:6d}x  {name[:100]}")
    if trace:
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        prof.export_chrome_trace(trace)
        print(f"trace: {trace}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", help="write the chrome trace to this path")
    args = ap.parse_args(argv)
    dev = require_cuda()
    plans = parse_hevc_intra_plans(fixture_batch_stream(),
                                   workers=os.cpu_count() or 1)
    if len(plans) != BATCH:
        raise RuntimeError(f"{len(plans)} pictures parsed, want {BATCH}")
    tensors = HTT.stack_plans(plans, dev)
    profile_decode(lambda: HTT.decode_frames_hevc_batch(*tensors),
                   f"batch {BATCH} x {plans[0].width}x{plans[0].height}",
                   args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
