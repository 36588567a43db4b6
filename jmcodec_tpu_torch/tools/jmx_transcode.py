"""Transcode an H.264 elementary stream (decode -> optional 2x rescale ->
encode) with resumable per-GOP jobs: the port of tools/jmx_transcode.py,
with its data flow (the session decode, the frames to the host, the numpy
downscale2, the EncoderSession, one segment per GOP, the manifest, resume
and the final concatenation) on the port's sessions. The manifest is the
JAX package's (pipeline/gop.py), so a job started by either tool resumes
under the other.

    python -m jmcodec_tpu_torch.tools.jmx_transcode in.h264 out_dir
        [--qp N] [--scale 2] [--gop N] [--worker NAME] [--device DEV]

--device: where the decode and the encoder's device engine run (default:
the card).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from jmcodec_tpu_torch.api.session import (DecoderSession, EncoderParams,
                                           EncoderSession)
from jmcodec_tpu_torch.codec.h264 import nal as NAL
from jmcodec_tpu_torch.pipeline.gop import TranscodeManifest


def downscale2(Y, U, V):
    def ds(P):
        P = P.astype(np.int32)
        return ((P[0::2, 0::2] + P[0::2, 1::2] + P[1::2, 0::2]
                 + P[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    return ds(Y), ds(U), ds(V)


def stream_head(data: bytes) -> bytes:
    """The SPS and PPS NAL units before the stream's first slice: they
    prefix every standalone GOP chunk (split_gops attaches the
    stream-leading headers to GOP 0 only)."""
    head = b""
    for s, e in NAL.split_annexb(data):
        typ = data[s] & 0x1F
        if typ in (7, 8):
            sc = s - 3
            if sc > 0 and data[sc - 1] == 0:
                sc -= 1
            head += data[sc:e]
        if typ in (1, 5):
            break
    return head


def _decode_gop(chunk: bytes, device) -> list:
    dec = DecoderSession(device=device)
    frames = []
    # feed-with-drain loop: input_data may partially accept when the chunk
    # exceeds the 10 MB ring; frames are drained between feeds
    fed = 0
    while fed < len(chunk):
        take = dec.input_data(chunk[fed:])
        fed += take
        while (fr := dec.get_frame()) is not None:
            frames.append(fr)
        if take == 0 and not dec._frames:
            raise RuntimeError("decoder stalled with full input ring")
    dec.set_eof()
    while (fr := dec.get_frame()) is not None:
        frames.append(fr)
    return frames


def transcode(input_path: str, out_dir: str, qp: int = 28, scale: int = 1,
              gop: int = 0, worker=None, device=None) -> list:
    """Run (or resume) the job of input_path in out_dir. Returns one
    record per GOP this call encoded: {"gop", "frames", "decode_s",
    "downscale_s", "encode_s", "wall_s"} (host walls; the decode's ends
    with its frames on the host)."""
    worker = worker or f"worker-{os.getpid()}"
    with open(input_path, "rb") as f:
        data = f.read()
    if os.path.exists(os.path.join(out_dir, "manifest.json")):
        manifest = TranscodeManifest.load(out_dir)
        print(f"resuming: {manifest.done()} done, {manifest.pending()} "
              f"pending")
    else:
        manifest = TranscodeManifest.create(input_path, out_dir, stream=data)
        manifest.save()
        print(f"created manifest with {len(manifest.jobs)} GOPs")
    head = stream_head(data)

    records = []
    while (job := manifest.claim(worker)) is not None:
        try:
            t0 = time.perf_counter()
            frames = _decode_gop(head + data[job.byte_start:job.byte_end],
                                 device)
            if not frames:
                raise RuntimeError("GOP decoded to zero frames")
            t1 = time.perf_counter()
            if scale == 2:
                frames = [downscale2(*fr) for fr in frames]
            t2 = time.perf_counter()
            H, W = frames[0][0].shape
            enc = EncoderSession(EncoderParams(
                width=W, height=H, qp=qp,
                gop_len=gop if gop else len(frames)), device=device)
            seg_path = os.path.join(out_dir, f"seg{job.index:05d}.h264")
            with open(seg_path, "wb") as f:
                for fr in frames:
                    enc.encode_frame(fr)
                    while (pkt := enc.output_bitstream()) is not None:
                        f.write(pkt[0])
            t3 = time.perf_counter()
            manifest.complete(job.index, os.path.basename(seg_path))
            records.append({"gop": job.index, "frames": len(frames),
                            "decode_s": t1 - t0, "downscale_s": t2 - t1,
                            "encode_s": t3 - t2, "wall_s": t3 - t0})
            print(f"GOP {job.index}: {len(frames)} frames -> {seg_path}")
        except Exception as e:  # noqa: BLE001 -- the job goes on
            manifest.fail(job.index)
            print(f"GOP {job.index} FAILED: {e!r}", file=sys.stderr)

    # concatenate completed segments in order
    if manifest.pending() == 0:
        out_path = os.path.join(out_dir, "out.h264")
        with open(out_path, "wb") as f:
            for j in manifest.jobs:
                with open(os.path.join(out_dir, j.output), "rb") as seg:
                    f.write(seg.read())
        print(f"transcode complete: {out_path}")
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("out_dir")
    ap.add_argument("--qp", type=int, default=28)
    ap.add_argument("--scale", type=int, default=1, choices=[1, 2])
    ap.add_argument("--gop", type=int, default=0,
                    help="re-encode GOP length (0 = one GOP per input GOP)")
    ap.add_argument("--worker", default=None)
    ap.add_argument("--device", default=None,
                    help="device of the decode and the encoder's device "
                         "engine (default: the card)")
    args = ap.parse_args(argv)
    transcode(args.input, args.out_dir, args.qp, args.scale, args.gop,
              args.worker, args.device)


if __name__ == "__main__":
    main()
