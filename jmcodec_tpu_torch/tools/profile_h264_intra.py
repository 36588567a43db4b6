"""Where the time of the batched 1080p H.264 all-intra decode goes.

Decodes the committed fixture at the smoke's batch (tools/fixtures.py)
from device-resident symbol tensors. First without the profiler: the wall
time of each stage (residuals; the intra and deblock scans, the
h264_intra and h264_deblock kernels, one launch a scan), each ended
by a synchronise, and the time the host took to parse and to stack and
copy the symbols. Then once under torch.profiler: per stage the launches and the
device's busy time, and the kernels ranked by device time. A stage whose
busy time is far below its wall time waits on the host's issue of
launches. --frames sets the batch (default: the smoke's). Needs a GPU:

    python -m jmcodec_tpu_torch.tools.profile_h264_intra \
        [--frames 32] [--trace out/h264_intra_trace.json]
"""

from __future__ import annotations

import argparse
import os
import time

import torch
from torch.profiler import record_function

from jmcodec_tpu_torch.api.h264_intra import parse_h264_intra_symbols
from jmcodec_tpu_torch.kernels import recon as RC
from jmcodec_tpu_torch.kernels import recon_tiles as RT
from jmcodec_tpu_torch.tools.fixtures import (H264_BATCH,
                                              h264_fixture_batch_stream)
from jmcodec_tpu_torch.tools.profiling import profile_decode
from jmcodec_tpu_torch.utils.device import gpu_name_power, require_cuda

STAGES = ("_residuals", "intra_tiles", "deblock_tiles")


def _staged(name, fn, walls):
    """fn as a named profiler range that ends with a synchronise; its wall
    time is added to walls[name]."""
    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function(name):
            out = fn(*a, **kw)
            torch.cuda.synchronize()
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        return out
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=H264_BATCH)
    ap.add_argument("--trace", help="write the chrome trace to this path")
    args = ap.parse_args(argv)
    dev = require_cuda()
    workers = os.cpu_count() or 1
    stream = h264_fixture_batch_stream()
    parse_h264_intra_symbols(stream, workers=workers)      # builds the parser
    t0 = time.perf_counter()
    pics = parse_h264_intra_symbols(stream, workers=workers)[:args.frames]
    t_parse = time.perf_counter() - t0
    fss = [fs for fs, _ in pics]
    mbh, mbw = fss[0].mb_height, fss[0].mb_width
    RC.stack_symbols(fss, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tensors = RC.stack_symbols(fss, dev)
    torch.cuda.synchronize()
    t_stack = time.perf_counter() - t0

    walls = {}
    for name in STAGES:
        setattr(RT, name, _staged(name, getattr(RT, name), walls))
    decode = lambda: RT.decode_frames_batch(mbh, mbw, *tensors, deblock=True)
    decode()                                   # warm-up: build, tables
    walls.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    print(gpu_name_power())
    print(f"batch {len(fss)} x {mbw * 16}x{mbh * 16} (H264_BATCH pictures "
          f"parsed on {workers} threads in {t_parse * 1e3:.1f} ms; "
          f"stack_symbols + H2D of {len(fss)} in {t_stack * 1e3:.1f} ms)")
    print(f"unprofiled decode, a synchronise after each stage: "
          f"{t_all * 1e3:.1f} ms; " + ", ".join(
              f"{n} {walls[n] * 1e3:.1f} ms" for n in STAGES))
    profile_decode(decode, f"batch {len(fss)} x {mbw * 16}x{mbh * 16} H.264",
                   args.trace, STAGES)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
