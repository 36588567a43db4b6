"""How long the session's H.264 host path (the numpy H264ReferenceDecoder)
takes per macroblock and per picture, on this machine's CPU: the cost of a
picture that the device path does not take (B slices, the 8x8 transform,
PCM, POC type 0/1). Decodes the first --pictures pictures of each stream
--reps times and prints the best time. Needs no GPU:

    python -m jmcodec_tpu_torch.tools.time_h264_host \\
        tests/data/h264_session_b_96x64.h264 --pictures 6
"""

from __future__ import annotations

import argparse
import platform
import time

from jmcodec_tpu_torch.api.h264_intra import _picture_chunks
from jmcodec_tpu_torch.codec.h264.refdec import H264ReferenceDecoder


def time_stream(stream: bytes, pictures: int, reps: int):
    """(pictures decoded, macroblocks per picture, best seconds)."""
    head, chunks = _picture_chunks(stream)
    part = head + b"".join(chunks[:pictures])
    best, n, mbs = float("inf"), 0, 0
    for _ in range(reps):
        dec = H264ReferenceDecoder()
        t0 = time.perf_counter()
        n = len(dec.decode_annexb(part) + dec.flush())
        best = min(best, time.perf_counter() - t0)
        sps = list(dec.sps.values())[0]
        mbs = sps.mb_width * sps.mb_height
    return n, mbs, best


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("streams", nargs="+")
    ap.add_argument("--pictures", type=int, default=1 << 30)
    ap.add_argument("--reps", type=int, default=1)
    a = ap.parse_args()
    print(f"CPU: {platform.processor() or platform.machine()}, "
          f"Python {platform.python_version()}, one thread")
    for path in a.streams:
        with open(path, "rb") as f:
            n, mbs, dt = time_stream(f.read(), a.pictures, a.reps)
        print(f"{path}: {n} pictures of {mbs} macroblocks in "
              f"{dt * 1000:.1f} ms (best of {a.reps}): "
              f"{dt * 1000 / n:.1f} ms a picture, "
              f"{dt * 1000 / (n * mbs):.3f} ms a macroblock; at that rate a "
              f"1920x1088 picture (8160 macroblocks) "
              f"{dt / (n * mbs) * 8160:.1f} s")


if __name__ == "__main__":
    main()
