"""Scaling measurement: the port of tools/jmx_scaling.py. The same work,
the H.264 all-intra batch decode of a seeded clip, at 1..N ranks
(frame-parallel dp, parallel/distributed.measure_decode_scaling), fps and
efficiency against one rank.

    python -m jmcodec_tpu_torch.tools.jmx_scaling [--devices 1,2,4]
        [--frames 16] [--size 320x192] [--qp 30] [--device DEV]
        [--out FILE]

--device: the ranks' device (default: the card, one card a rank: a host
with one card measures one point; "cpu": gloo ranks sharing the host's
cores, whose efficiency is bounded by the cores, not by the sharding).
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from jmcodec_tpu_torch.parallel.distributed import measure_decode_scaling
from jmcodec_tpu_torch.utils.device import require_cuda


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default=None,
                    help="rank counts (default: 1, 2, 4, 8 up to the "
                         "cards, or the cores with --device cpu)")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--size", default="320x192")
    ap.add_argument("--qp", type=int, default=30)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from jmcodec_tpu_torch.codec.h264.fastdec import FastH264Parser
    from jmcodec_tpu_torch.codec.h264.refenc import encode_stream
    from jmcodec_tpu_torch.tools.fixtures import gradient_frame

    if args.device is None:
        require_cuda()
        avail, platform = torch.cuda.device_count(), \
            torch.cuda.get_device_name(0)
    else:
        avail, platform = os.cpu_count() or 1, "cpu"
    ranks = ([int(d) for d in args.devices.split(",")] if args.devices
             else [n for n in (1, 2, 4, 8) if n <= avail])
    W, H = (int(v) for v in args.size.split("x"))
    frames = [gradient_frame(W, H, seed=i) for i in range(args.frames)]
    stream, _ = encode_stream(frames, W, H, qp=args.qp)
    fss = [fs for fs, _ in FastH264Parser().parse_annexb(stream)]
    res = measure_decode_scaling(fss, ranks, device=args.device)
    report = {"metric": "h264_decode_frame_parallel_scaling",
              "size": args.size, "frames": args.frames,
              "platform": platform, "physical_cores": os.cpu_count() or 1,
              **res}
    line = json.dumps(report)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
