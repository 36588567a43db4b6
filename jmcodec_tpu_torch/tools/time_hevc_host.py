"""How long the HEVC host path takes per CTU, on this machine's CPU, in one
thread: the Python parse (a picture that the native parser refuses, such
as one of a cu_qp_delta stream, is parsed so into the device's plan), and
the numpy reconstruction of a picture that the device does not take (a
multi-slice or transform-skip picture, motion past the MC pad). For each
stream: the parse alone (HevcRefDecoder(use_native=False) with a hook
that takes the plan and returns blank planes), then the whole host decode
(DecoderSession(Codec.HEVC, use_device=False)); the reconstruction is
their difference (where every picture is within the device's scope).
Where tests/data holds the stream's libavcodec digests
it also says whether the host decode equals them. Best of --reps runs.
Needs no GPU:

    python -m jmcodec_tpu_torch.tools.time_hevc_host \\
        tests/data/hevc_cuqp_intra_192x128.h265 --reps 3
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import platform
import time

import numpy as np

from jmcodec_tpu_torch.api.session import Codec, DecoderSession
from jmcodec_tpu_torch.codec.hevc.refdec import HevcRefDecoder
from jmcodec_tpu_torch.utils.metrics import counters


def cpu_name() -> str:
    """The CPU's model name from /proc/cpuinfo; where a virtual machine
    reports it as unknown, its vendor, family and model numbers."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name != "unknown":
        return name
    ids = [f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model")
           if k in info]
    return ", ".join(ids) or platform.processor() or platform.machine()


def _blank(plan, ref_pixels):
    f = lambda h, w: np.zeros((h, w), np.uint8)
    return f(plan.ph, plan.pw), f(plan.ph // 2, plan.pw // 2), \
        f(plan.ph // 2, plan.pw // 2)


def _best(fn, reps):
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def _host_decode(stream: bytes) -> list:
    s = DecoderSession(Codec.HEVC, use_device=False)
    s.input_data(stream)
    s.set_eof()
    frames = []
    while (fr := s.get_frame()) is not None:
        frames.append(fr)
    return frames


def _parse(stream: bytes):
    c0 = counters.get("frames_host")
    dec = HevcRefDecoder(_blank, use_native=False)
    n = len(dec.decode(stream))
    return dec, n, n - int(counters.get("frames_host") - c0)


def time_stream(stream: bytes, reps: int):
    """(pictures, CTUs a picture, pictures the parse run parsed into a
    plan, best parse seconds, best host decode seconds, the host decode's
    frames). A picture outside the device's scope is decoded on the host
    in the parse run too."""
    t_parse, (dec, n, planned) = _best(lambda: _parse(stream), reps)
    sps = list(dec.sps.values())[0]
    ctb = 1 << sps.log2_ctb
    ctus = -(-sps.pic_width // ctb) * -(-sps.pic_height // ctb)
    t_host, host = _best(lambda: _host_decode(stream), reps)
    return n, ctus, planned, t_parse, t_host, host


def _bit_exact(path: str, frames: list) -> str:
    meta = os.path.splitext(path)[0] + ".sha256.json"
    if not os.path.exists(meta):
        return "no digests"
    with open(meta) as f:
        want = json.load(f)["frames"]
    got = [{k: hashlib.sha256(np.ascontiguousarray(p)).hexdigest()
            for k, p in zip("YUV", fr)} for fr in frames]
    return ("equal to the libavcodec digests" if got == want
            else "DIFFERS from the libavcodec digests")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("streams", nargs="+")
    ap.add_argument("--reps", type=int, default=1)
    a = ap.parse_args()
    # the host path is Python and numpy integer arithmetic: one thread
    print(f"CPU: {cpu_name()} ({os.cpu_count()} logical), Python "
          f"{platform.python_version()}, numpy {np.__version__}, one "
          f"thread")
    for path in a.streams:
        with open(path, "rb") as f:
            n, ctus, planned, t_parse, t_host, frames = time_stream(
                f.read(), a.reps)
        per = lambda t: t * 1000 / (n * ctus)
        parse = (f"Python parse {t_parse * 1000:.1f} ms, "
                 f"{per(t_parse):.2f} ms a CTU" if planned == n else
                 f"Python parse of the {planned} of {n} pictures within "
                 f"the device's scope, the others decoded on the host, "
                 f"{t_parse * 1000:.1f} ms")
        recon = (f", of which the numpy reconstruction "
                 f"{per(t_host - t_parse):.2f} ms a CTU"
                 if planned == n else "")
        print(f"{path}: {n} pictures of {ctus} CTUs (best of {a.reps}): "
              f"{parse}; host decode {t_host * 1000:.1f} ms, "
              f"{per(t_host):.2f} ms a CTU{recon}; host decode "
              f"{_bit_exact(path, frames)}")


if __name__ == "__main__":
    main()
