"""Where a step of the H.264 scan kernels' chains goes.

Builds csrc/h264_intra.cu and csrc/h264_deblock.cu a second time with
-DJMX_SCAN_TIMING (the stamps of csrc/lane_chain.cuh: thread 0 of each
warp sums the SM clock cycles of each phase of a macroblock), then runs
both scans on the arguments the decode gives them at the 1080p batch of
32 and at the P fixture's first P picture (as chip_smoke.py phase 27) and
prints, per kernel and shape, the wall of one wrapper call with the
normal build (CUDA events, median of 5; the wrapper's allocations and
fills included: chip_smoke.py phase 27 gives the kernel's own time) and
the mean cycles and ns a macroblock spends in each phase with the timed
build (each stamp adds a few tens of cycles). A lane's 'wait' includes,
at its first macroblock, the wait for the lanes above to reach it. Needs
a GPU:

    python -m jmcodec_tpu_torch.tools.time_h264_scans
"""

from __future__ import annotations

import ctypes
import glob
import os
import statistics
import subprocess

import torch

from jmcodec_tpu_torch.api.h264_inter import (DeviceDPB, decode_symbols,
                                              parse_h264)
from jmcodec_tpu_torch.api.h264_intra import parse_h264_intra_symbols
from jmcodec_tpu_torch.kernels import _build
from jmcodec_tpu_torch.kernels import h264_scan as HS
from jmcodec_tpu_torch.kernels import recon as RC
from jmcodec_tpu_torch.kernels import recon_tiles as RT
from jmcodec_tpu_torch.tools.fixtures import (h264_fixture_batch_stream,
                                              h264_inter_fixture_stream)
from jmcodec_tpu_torch.utils.device import (gpu_name_power, gpu_sm_clock_mhz,
                                            require_cuda)

# the stamps' slots (lane_chain.cuh: 15 counts the macroblocks)
PHASES = {
    "h264_intra": {1: "left column, modes", 2: "wait", 3: "rows above",
                   4: "chroma", 5: "luma", 6: "last rows out, flag",
                   7: "rest of the tile out", 8: "next diagonal",
                   9: "prefetch issue", 10: "prefetch wait", 0: "call"},
    "h264_deblock": {1: "left tile, vertical edges", 2: "wait",
                     3: "rows above", 4: "horizontal edges",
                     5: "stores, flag", 8: "next diagonal",
                     9: "prefetch issue", 10: "prefetch wait", 0: "call"},
}


def build_timed() -> str:
    """The kernels with the timing stamps, as a library of their own."""
    out = os.path.join(os.path.dirname(_build.LIB),
                       "libjmx_scan_timing.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    objs = []
    for name in ("h264_intra.cu", "h264_deblock.cu"):
        obj = out + f".{name}.o"
        subprocess.run([_build._nvcc(), *_build.CFLAGS, "-DJMX_SCAN_TIMING",
                        "-c", "-o", obj, os.path.join(_build._SRC, name)],
                       check=True, capture_output=True, text=True)
        objs.append(obj)
    subprocess.run([_build._nvcc(), *_build.ARCH, "-shared", "-o", out,
                    *objs], check=True, capture_output=True, text=True)
    for obj in glob.glob(out + ".*.o"):
        os.remove(obj)
    return out


def captured(fn):
    """The arguments fn()'s decode gives RT.intra_tiles / deblock_tiles."""
    cap, saved = {}, (RT.intra_tiles, RT.deblock_tiles)

    def rec(key, kernel):
        def run(*a, group=None):
            cap[key] = a
            return kernel(*a)
        return run

    RT.intra_tiles = rec("h264_intra", saved[0])
    RT.deblock_tiles = rec("h264_deblock", saved[1])
    try:
        fn()
    finally:
        RT.intra_tiles, RT.deblock_tiles = saved
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


def busy_clock_mhz() -> int:
    """The SM clock read while a spin kernel keeps the card busy."""
    torch.cuda._sleep(int(3e9))
    mhz = gpu_sm_clock_mhz()
    torch.cuda.synchronize()
    return mhz


def main() -> None:
    dev = require_cuda()
    print(gpu_name_power())
    fss = [fs for fs, _ in parse_h264_intra_symbols(
        h264_fixture_batch_stream(), workers=os.cpu_count() or 1)]
    mbh, mbw = fss[0].mb_height, fss[0].mb_width
    args = RC.stack_symbols(fss, dev)
    shapes = {"batch of 32": captured(lambda: RT.decode_frames_batch(
        mbh, mbw, *args, deblock=True))}
    pics = list(parse_h264(h264_inter_fixture_stream()))
    dpb = DeviceDPB()
    decode_symbols(pics[:1], dev, dpb=dpb)
    refs, ids = dpb.list0(pics[1][0])
    shapes["first P picture"] = captured(
        lambda: RT.decode_frame_symbols_inter(pics[1][0], refs,
                                              ref_ids=ids))
    n_steps = mbw + 2 * (mbh - 1)
    calls = {"h264_intra": lambda a: HS.intra_tiles(*a),
             "h264_deblock": lambda a: HS.deblock_tiles(*a)}
    normal = {(s, k): event_ms(lambda: calls[k](cap[k]))
              for s, cap in shapes.items() for k in calls}

    lib = ctypes.CDLL(build_timed())
    saved = HS._lib
    for fn in ("h264_intra_set_tables", "h264_deblock_set_tables",
               "h264_intra_launch", "h264_deblock_launch"):
        getattr(lib, fn).argtypes = getattr(saved, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    HS._lib, on = lib, set(HS._tables_on)
    HS._tables_on.clear()               # set this library's own tables
    try:
        cycles = {}
        for s, cap in shapes.items():
            for k, call in calls.items():
                read = getattr(lib, f"{k}_cycles")
                buf = (ctypes.c_ulonglong * 16)()
                call(cap[k])
                torch.cuda.synchronize()
                read(buf)                               # zeroes the sums
                got = call(cap[k])
                torch.cuda.synchronize()
                read(buf)
                cycles[s, k] = list(buf)
                HS._lib = saved
                want = call(cap[k])
                HS._lib = lib
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise RuntimeError(f"{k}: the timed build differs")
    finally:
        HS._lib = saved
        HS._tables_on.clear()
        HS._tables_on.update(on)
    mhz = busy_clock_mhz()
    print(f"SM clock under load {mhz} MHz; chains of {n_steps} steps "
          f"({mbw} x {mbh} macroblocks)")
    for (s, k), c in cycles.items():
        n = max(c[15], 1)
        ms = normal[s, k]
        parts = ", ".join(
            f"{name} {c[i] / n:.0f} cyc / {c[i] / n / mhz * 1e3:.0f} ns"
            for i, name in PHASES[k].items())
        print(f"{k} at the {s}: {ms:.4f} ms a call; {c[15]} macroblocks; "
              f"per macroblock: {parts}")


if __name__ == "__main__":
    main()
