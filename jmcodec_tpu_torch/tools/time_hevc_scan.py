"""Where a step of the hevc_scan kernel's chain goes.

Builds csrc/hevc_scan.cu twice more: with -DJMX_SCAN_SMALL_CALLS (the 4x4
and 8x8 TUs' walks behind calls of their own, as the 16x16 and 32x32 TUs'
always are) and with -DJMX_SCAN_TIMING (the planner warp's lane 0 and the
walkers' thread 0 each sum the SM clock cycles of their phases of a CTB;
csrc/hevc_scan.cu lists the slots). Then runs the scans the decode gives
the kernel at the 1080p HEVC all-intra batch of 16 (luma; Cb + Cr) and at
the inter fixture's first P picture, and prints per scan: the wall of one
wrapper call with the normal build and with the calls build, and what the
calls cost (CUDA events, median of 5; the wrapper's allocation and fill
included); the CTBs and levels walked, and the mean cycles a walked CTB
spends in each phase with the timed build, the walkers' levels also per
level and the units of walker warp 0 per kind (each stamp adds a few tens
of cycles). Needs a GPU:

    python -m jmcodec_tpu_torch.tools.time_hevc_scan
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess

import torch

from jmcodec_tpu_torch.api.hevc_inter import DeviceRecon, decode_plans
from jmcodec_tpu_torch.api.hevc_intra import parse_hevc_intra_plans
from jmcodec_tpu_torch.codec.hevc.refdec import HevcRefDecoder
from jmcodec_tpu_torch.kernels import _build
from jmcodec_tpu_torch.kernels import hevc_scan as HSC
from jmcodec_tpu_torch.kernels import hevc_tiles as HTT
from jmcodec_tpu_torch.tools.fixtures import (fixture_batch_stream,
                                              inter_fixture_stream)
from jmcodec_tpu_torch.utils.device import (gpu_name_power, gpu_sm_clock_mhz,
                                            require_cuda)

# the stamps' slots (csrc/hevc_scan.cu)
PLANNER = {0: "stage", 1: "Z", 27: "TU list", 29: "writers",
           2: "cell tables, predecessors", 3: "levels", 4: "sort",
           5: "wait for the walkers"}
UNITS = ("two 4x4", "8x8", "16x16", "32x32")
WALKERS = {8: "F", 9: "wait on the lane above", 10: "row 0",
           17: "levels: warp 0's units", 18: "levels: the barrier",
           12: "stores, flag", 13: "wait for the planner"}


def build_variant(name: str, define: str):
    """The scan kernel built with -D<define>, as a library of its own,
    loaded with the normal build's argument types."""
    out = os.path.join(os.path.dirname(_build.LIB),
                       f"libjmx_hevc_scan_{name}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    obj = out + ".o"
    subprocess.run([_build._nvcc(), *_build.CFLAGS, f"-D{define}", "-c",
                    "-o", obj, os.path.join(_build._SRC, "hevc_scan.cu")],
                   check=True, capture_output=True, text=True)
    subprocess.run([_build._nvcc(), *_build.ARCH, "-shared", "-o", out, obj],
                   check=True, capture_output=True, text=True)
    os.remove(obj)
    lib, normal = ctypes.CDLL(out), HSC._load()
    for fn in ("hevc_scan_launch", "hevc_scan_resident"):
        getattr(lib, fn).argtypes = getattr(normal, fn).argtypes
    return lib


def with_lib(lib, fn):
    """fn() with scan_planes launching lib's kernel."""
    saved = HSC._lib
    HSC._lib = lib
    try:
        return fn()
    finally:
        HSC._lib = saved


def captured(fn):
    """The (args, kwargs) of each scan_planes call of fn()'s decode."""
    cap, saved = [], HTT.scan_planes

    def run(*a, **kw):
        cap.append((a, kw))
        return saved(*a, **kw)

    HTT.scan_planes = run
    try:
        fn()
    finally:
        HTT.scan_planes = saved
    torch.cuda.synchronize()
    return cap


def event_ms(fn, reps=5):
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def scans(dev):
    """{name: (args, kwargs)} of the four scans: the all-intra batch's and
    the first P picture's, luma and chroma."""
    plans = parse_hevc_intra_plans(fixture_batch_stream(),
                                   workers=os.cpu_count() or 1)
    args = HTT.stack_plans(plans, dev)
    out = dict(zip(("intra16 luma", "intra16 chroma"), captured(
        lambda: HTT.decode_frames_hevc_batch(*args))))
    pl, recon = [], DeviceRecon(dev)

    def recording(plan, ref_pixels):
        pl.append(plan)
        return recon(plan, ref_pixels)

    HevcRefDecoder(recording).decode(inter_fixture_stream())
    refs = [HTT.prep_hevc_ref(*decode_plans(pl[:1], dev)[0])]
    out.update(zip(("P1 luma", "P1 chroma"), captured(
        lambda: HTT.decode_plan_inter(pl[1], refs, dev))))
    return out


def main() -> None:
    dev = require_cuda()
    print(gpu_name_power())
    todo = scans(dev)
    calls, timed = (build_variant("calls", "JMX_SCAN_SMALL_CALLS"),
                    build_variant("timing", "JMX_SCAN_TIMING"))
    walls = {}
    for name, (a, kw) in todo.items():
        def one():
            return event_ms(lambda: HSC.scan_planes(*a, **kw))
        walls[name] = (one(), with_lib(calls, one))
    timed.hevc_scan_cycles.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 32)()
    torch.cuda._sleep(int(3e9))
    mhz = gpu_sm_clock_mhz()
    torch.cuda.synchronize()
    print(f"SM clock under load {mhz} MHz")
    for name, (wall, wall_calls) in walls.items():
        a, kw = todo[name]
        for _ in range(2):     # the second run's cycles
            timed.hevc_scan_cycles(buf)
            with_lib(timed, lambda: HSC.scan_planes(*a, **kw))
            torch.cuda.synchronize()
        timed.hevc_scan_cycles(buf)
        c = list(buf)
        ctbs, built, levels, tus = c[15], c[7], c[14], c[6]
        walk = c[11] + c[17] + c[18]
        print(f"{name}: {wall:.4f} ms a call; the small TUs' walks behind "
              f"calls {wall_calls:.4f} ms (the calls cost "
              f"{wall_calls - wall:+.4f} ms); {ctbs} CTBs walked, {levels} "
              f"levels, {tus} TUs, {c[16]} CTBs whose levels took the "
              f"general pass (overlapping TUs or reads before a later "
              f"write); cycles a CTB:")
        for slots, per in ((PLANNER, built), (WALKERS, ctbs)):
            print("   " + "; ".join(
                f"{what} {c[i] / max(per, 1):.0f}"
                for i, what in slots.items()))
        print(f"   the walkers' levels: {walk / max(levels, 1):.0f} "
              f"cycles a level ({walk / max(levels, 1) / mhz * 1e3:.0f}"
              f" ns at {mhz} MHz); warp 0's units: " + "; ".join(
                  f"{what} {c[19 + k] / max(c[23 + k], 1):.0f} cycles "
                  f"x {c[23 + k]}" for k, what in enumerate(UNITS)))


if __name__ == "__main__":
    main()
