"""How long the encoders' host work takes, on this machine's CPU, in one
thread: the H.264 IDR encode (H264ReferenceEncoder.encode_idr, which the
device engine runs on the host too) and the host P encode in ms a
macroblock, the device engine's CAVLC pack of a P frame (its enc_pack
timer; the search runs on the CPU here, since it does not enter that
timer) in ms a macroblock, and the HEVC encoder's IDR and P frames in ms
a CTU (16x16). The content is tools/fixtures.pan_frames at --size: an
IDR, then --frames - 1 P frames, each timed alone; the best of --reps
runs. Needs no GPU:

    python -m jmcodec_tpu_torch.tools.time_encode_host --size 320x192
"""

from __future__ import annotations

import argparse
import os
import platform
import time

import numpy as np
import torch

from jmcodec_tpu_torch.codec.h264.devenc import DeviceH264Encoder
from jmcodec_tpu_torch.codec.h264.refenc import (EncoderConfig,
                                                 H264ReferenceEncoder)
from jmcodec_tpu_torch.codec.hevc.refenc import HevcEncoder
from jmcodec_tpu_torch.tools.fixtures import pan_frames
from jmcodec_tpu_torch.tools.time_hevc_host import cpu_name
from jmcodec_tpu_torch.utils.metrics import timers


def frame_times(enc, frames, stage=None) -> list:
    """Seconds of each encode_frame (or, with stage, of that timer)."""
    out = []
    for f in frames:
        before = timers.snapshot().get(stage, 0.0)
        t0 = time.perf_counter()
        enc.encode_frame(*f)
        dt = time.perf_counter() - t0
        out.append(timers.snapshot().get(stage, 0.0) - before if stage
                   else dt)
    return out


def best(runs) -> list:
    return [min(r[i] for r in runs) for i in range(len(runs[0]))]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="320x192")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--qp", type=int, default=28)
    ap.add_argument("--reps", type=int, default=1)
    a = ap.parse_args()
    W, H = map(int, a.size.split("x"))
    torch.set_num_threads(1)
    frames = pan_frames(W, H, a.frames)
    mbs = -(-W // 16) * -(-H // 16)
    print(f"CPU: {cpu_name()} ({os.cpu_count()} logical), Python "
          f"{platform.python_version()}, numpy {np.__version__}, one "
          f"thread; {W}x{H}, {mbs} macroblocks (CTUs of 16), qp {a.qp}, "
          f"IDR + {a.frames - 1} P, best of {a.reps}")
    cfg = lambda: EncoderConfig(W, H, qp=a.qp, gop_len=a.frames)
    ms = lambda ts: ", ".join(f"{t * 1000 / mbs:.3f}" for t in ts)
    host = best([frame_times(H264ReferenceEncoder(cfg()), frames)
                 for _ in range(a.reps)])
    print(f"H.264 host: IDR {host[0]:.2f} s, {ms(host[:1])} ms a "
          f"macroblock; P {ms(host[1:])} ms a macroblock")
    pack = best([frame_times(DeviceH264Encoder(cfg(), "cpu"), frames,
                             "enc_pack") for _ in range(a.reps)])
    print(f"H.264 device engine: CAVLC pack of a P frame {ms(pack[1:])} "
          f"ms a macroblock")
    hevc = best([frame_times(HevcEncoder(W, H, qp=a.qp,
                                         gop_len=a.frames), frames)
                 for _ in range(a.reps)])
    print(f"HEVC: IDR {ms(hevc[:1])} ms a CTU; P {ms(hevc[1:])} ms a CTU")
    print(f"at 1920x1088 (8160 macroblocks): H.264 host IDR "
          f"{host[0] / mbs * 8160:.1f} s, host P "
          f"{max(host[1:]) / mbs * 8160:.1f} s, device-engine pack "
          f"{max(pack[1:]) / mbs * 8160:.1f} s")


if __name__ == "__main__":
    main()
