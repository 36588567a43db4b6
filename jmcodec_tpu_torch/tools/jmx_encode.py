"""Encode raw YUV (I420) to an H.264/HEVC Annex-B elementary stream: the
port of tools/jmx_encode.py (read a frame, encode, drain the bitstream
queue to the file, report fps) on the port's EncoderSession.

    python -m jmcodec_tpu_torch.tools.jmx_encode in.i420 WxH out.h264
        [--qp N | --bitrate KB] [--codec h264|hevc] [--gop N]
        [--engine host|device|auto] [--device DEV]

--engine auto is the device engine; --device: where it runs (default: the
card).
"""

from __future__ import annotations

import argparse

from jmcodec_tpu_torch.api.session import (Codec, EncoderParams,
                                           EncoderSession, PixFmt)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("size", help="WxH, e.g. 1920x1080")
    ap.add_argument("output")
    ap.add_argument("--qp", type=int, default=None)
    ap.add_argument("--bitrate", type=int, default=2000, help="kbit/s")
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--codec", default="h264", choices=("h264", "hevc"))
    ap.add_argument("--gop", type=int, default=1)
    ap.add_argument("--engine", default="auto",
                    choices=("host", "device", "auto"))
    ap.add_argument("--device", default=None,
                    help="device of the device engine (default: the card)")
    args = ap.parse_args(argv)
    W, H = map(int, args.size.lower().split("x"))

    params = EncoderParams(width=W, height=H, fps=args.fps,
                           bitrate_kb=args.bitrate, qp=args.qp,
                           gop_len=args.gop, engine=args.engine,
                           codec=Codec.HEVC if args.codec == "hevc"
                           else Codec.H264)
    enc = EncoderSession(params, device=args.device)
    frame_size = W * H * 3 // 2
    n = 0
    with open(args.input, "rb") as fi, open(args.output, "wb") as fo:
        while True:
            raw = fi.read(frame_size)
            if len(raw) < frame_size:
                break
            enc.encode_frame(raw, PixFmt.I420)
            while True:
                pkt = enc.output_bitstream()
                if pkt is None:
                    break
                fo.write(pkt[0])
            n += 1
    enc.set_eof()
    print(enc.info())
    print(f"encoded {n} frames")


if __name__ == "__main__":
    main()
