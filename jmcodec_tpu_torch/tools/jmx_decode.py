"""Decode an Annex-B elementary stream to raw YUV: the port of
tools/jmx_decode.py (a streaming read loop with backpressure, the frame
count and the fps line at EOF) on the port's DecoderSession.

    python -m jmcodec_tpu_torch.tools.jmx_decode in.h264 out.i420
        [--codec h264|hevc] [--fmt i420|nv12|yv12] [--host]
        [--device DEV]

--device: where the device path runs (default: the card; "cpu" runs the
same path in torch on the host).
"""

from __future__ import annotations

import argparse

from jmcodec_tpu_torch.api.session import Codec, DecoderSession, PixFmt


def decode_file(input_path: str, output_path: str, codec=None,
                fmt: str = "i420", host: bool = False, device=None) -> int:
    """Decode input_path into output_path; returns the frame count."""
    if codec is None:
        codec = "hevc" if input_path.lower().endswith(
            (".h265", ".hevc", ".265")) else "h264"
    pix = {"i420": PixFmt.I420, "nv12": PixFmt.NV12,
           "yv12": PixFmt.YV12}[fmt]
    dec = DecoderSession(Codec.HEVC if codec == "hevc" else Codec.H264,
                         pix, use_device=not host, device=device)
    n = 0
    with open(input_path, "rb") as fi, open(output_path, "wb") as fo:
        while not dec.is_exit():
            if dec.need_more_data():
                chunk = fi.read(dec.free_buf_len())
                if chunk:
                    dec.input_data(chunk)
                else:
                    dec.set_eof()
            frame = dec.output_frame()
            if frame is not None:
                fo.write(frame)
                n += 1
    print(dec.info())
    info = dec.get_stream_info()
    if info:
        print(f"stream: {info[0]}x{info[1]}, {n} frames")
    return n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--fmt", default="i420", choices=["i420", "nv12", "yv12"])
    ap.add_argument("--codec", default=None, choices=["h264", "hevc"],
                    help="default: by input extension (.h265/.hevc -> hevc)")
    ap.add_argument("--host", action="store_true",
                    help="force host (numpy) recon path")
    ap.add_argument("--device", default=None,
                    help="device of the device path (default: the card)")
    args = ap.parse_args(argv)
    decode_file(args.input, args.output, args.codec, args.fmt, args.host,
                args.device)


if __name__ == "__main__":
    main()
