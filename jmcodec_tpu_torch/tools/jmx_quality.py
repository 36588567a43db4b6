"""Encode quality: RD curves and BD-rate of the port's H.264 encoder
against x264, the port of tools/jmx_quality.py (BASELINE.md: "PSNR/bitrate
>= QSV/NVENC operating points at matched bitrate"). Both encoders' streams
are decoded by the same independent decoder (the libavcodec oracle,
tools/oracle.py), so the PSNRs compare like with like; without the oracle
the tool raises.

Modes:
  QP sweep (default): encode at --qps, fit RD curves, report the BD-rate
      (negative: ours needs fewer bits than x264 for equal quality).
  --bitrate KBPS: the rate-controlled EncoderSession (VBR) against x264
      ABR at the same target.

    python -m jmcodec_tpu_torch.tools.jmx_quality [--size WxH] [--frames N]
        [--qps 22,27,32,37] [--gop N] [--engine host|device|auto]
        [--bitrate KBPS] [--fps FPS] [--out FILE] [--device DEV]

--engine auto is the device engine; --device: where it runs (default: the
card, which must be there; "cpu" runs it on the CPU). Prints a table and
one JSON line, whose "device" names where the device engine ran (null for
the host engine).
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from jmcodec_tpu_torch.api.session import EncoderParams, EncoderSession
from jmcodec_tpu_torch.codec.h264.devenc import DeviceH264Encoder
from jmcodec_tpu_torch.codec.h264.refenc import (EncoderConfig,
                                                 H264ReferenceEncoder)
from jmcodec_tpu_torch.tools.oracle import (make_frame, oracle_decode,
                                            oracle_encode)
from jmcodec_tpu_torch.utils.device import require_cuda


def psnr(a, b):
    mse = ((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2).mean()
    return float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def yuv_psnr(dec_frames, src_frames):
    """6:1:1-weighted YUV PSNR averaged over frames (the common convention)."""
    vals = []
    for d, s in zip(dec_frames, src_frames):
        py, pu, pv = (psnr(d[i], s[i]) for i in range(3))
        vals.append((6 * py + pu + pv) / 8)
    return sum(vals) / len(vals)


def bd_rate(r1, p1, r2, p2):
    """Bjontegaard delta rate of curve 2 vs curve 1 (negative: curve 2
    needs fewer bits at equal PSNR). r: bits, p: PSNR, >=4 points each."""
    lr1, lr2 = np.log(np.asarray(r1, float)), np.log(np.asarray(r2, float))
    f1 = np.polyfit(p1, lr1, 3)
    f2 = np.polyfit(p2, lr2, 3)
    lo = max(min(p1), min(p2))
    hi = min(max(p1), max(p2))
    if hi <= lo:
        return float("nan")
    i1 = np.polyint(f1)
    i2 = np.polyint(f2)
    avg1 = (np.polyval(i1, hi) - np.polyval(i1, lo)) / (hi - lo)
    avg2 = (np.polyval(i2, hi) - np.polyval(i2, lo)) / (hi - lo)
    return (math.exp(avg2 - avg1) - 1) * 100


def engine_device(engine, device=None):
    """Where the device engine runs: None for the host engine, else the
    torch device (device None: the card, which must be there)."""
    if engine == "host":
        return None
    return require_cuda() if device is None else torch.device(device)


def our_encoder(W, H, qp, gop, engine, device=None):
    cfg = EncoderConfig(W, H, qp=qp, gop_len=gop)
    dev = engine_device(engine, device)
    return H264ReferenceEncoder(cfg) if dev is None else \
        DeviceH264Encoder(cfg, dev)


def our_stream(frames, W, H, qp, gop, engine, device=None) -> bytes:
    """The port's encode of frames at a fixed qp (no oracle needed)."""
    enc = our_encoder(W, H, qp, gop, engine, device)
    stream = enc.headers_annexb()
    for fr in frames:
        stream += enc.encode_frame(*[np.asarray(p, np.int32) for p in fr])
    return stream


def run_point(frames, W, H, qp, gop, engine, device=None):
    ours_stream = our_stream(frames, W, H, qp, gop, engine, device)
    ours_dec, _, _ = oracle_decode(ours_stream)
    x_stream = oracle_encode(frames, W, H, qp=qp, gop=gop)
    x_dec, _, _ = oracle_decode(x_stream)
    return {
        "qp": qp,
        "ours_bits": len(ours_stream) * 8,
        "x264_bits": len(x_stream) * 8,
        "ours_psnr": round(yuv_psnr(ours_dec, frames), 3),
        "x264_psnr": round(yuv_psnr(x_dec, frames), 3),
    }


def run_bitrate_matched(frames, W, H, kbps, fps, gop, engine, device=None):
    """Rate-controlled session vs x264 ABR at the same target bitrate."""
    sess = EncoderSession(EncoderParams(
        width=W, height=H, fps=fps, bitrate_kb=kbps, gop_len=gop,
        rc_mode="vbr", engine=engine), device=engine_device(engine, device))
    ours = b""
    for fr in frames:
        sess.encode_frame(tuple(np.asarray(p, np.uint8) for p in fr))
        while True:
            out = sess.output_bitstream()
            if out is None:
                break
            ours += out[0]
    ours_dec, _, _ = oracle_decode(ours)
    ours_kbps = len(ours) * 8 * fps / len(frames) / 1000.0

    # x264 ABR at the target: qp 0 and a bitrate through x264's own
    # parameters
    x_stream = oracle_encode(
        frames, W, H, qp=0, gop=gop,
        extra=f"bitrate={kbps}:keyint={gop}:min-keyint={gop}:bframes=0")
    x_dec, _, _ = oracle_decode(x_stream)
    x_kbps = len(x_stream) * 8 * fps / len(frames) / 1000.0
    return {
        "target_kbps": kbps,
        "ours_kbps": round(ours_kbps, 1),
        "x264_kbps": round(x_kbps, 1),
        "ours_psnr": round(yuv_psnr(ours_dec, frames), 3),
        "x264_psnr": round(yuv_psnr(x_dec, frames), 3),
    }


def moving(W, H, n):
    """Panning content with bounded (wrapping) motion."""
    base = make_frame(W + 64, H + 64, seed=3)
    out = []
    for i in range(n):
        dy, dx = (i * 2) % 64, (i * 3) % 64
        out.append((base[0][dy:dy + H, dx:dx + W].copy(),
                    base[1][dy // 2:dy // 2 + H // 2,
                            dx // 2:dx // 2 + W // 2].copy(),
                    base[2][dy // 2:dy // 2 + H // 2,
                            dx // 2:dx // 2 + W // 2].copy()))
    return out


def device_name(dev):
    """The JSON line's "device": the card's name, "cpu", or None."""
    if dev is None:
        return None
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="320x240")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--gop", type=int, default=8)
    ap.add_argument("--engine", default="host",
                    choices=("host", "device", "auto"))
    ap.add_argument("--bitrate", type=int, default=0,
                    help="bitrate-matched mode (kbps) instead of QP sweep")
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--out", default=None,
                    help="also write the JSON result to this file")
    ap.add_argument("--device", default=None,
                    help="device of the device engine (default: the card)")
    args = ap.parse_args(argv)
    W, H = map(int, args.size.split("x"))
    dev = engine_device(args.engine, args.device)
    frames = moving(W, H, args.frames)

    if args.bitrate:
        r = run_bitrate_matched(frames, W, H, args.bitrate, args.fps,
                                args.gop, args.engine, dev)
        r["size"] = args.size
        r["engine"] = args.engine
        r["device"] = device_name(dev)
        print(f"target {r['target_kbps']} kbps: "
              f"ours {r['ours_psnr']:.2f} dB @ {r['ours_kbps']} kbps | "
              f"x264 {r['x264_psnr']:.2f} dB @ {r['x264_kbps']} kbps")
        result = r
    else:
        rows = []
        for qp in map(int, args.qps.split(",")):
            r = run_point(frames, W, H, qp, args.gop, args.engine, dev)
            rows.append(r)
            print(f"qp={qp}: ours {r['ours_psnr']:.2f} dB @ "
                  f"{r['ours_bits'] / 1000:.0f} kbit | x264 "
                  f"{r['x264_psnr']:.2f} dB @ {r['x264_bits'] / 1000:.0f} "
                  f"kbit")
        bd = float("nan")
        if len(rows) >= 4:
            bd = bd_rate([r["x264_bits"] for r in rows],
                         [r["x264_psnr"] for r in rows],
                         [r["ours_bits"] for r in rows],
                         [r["ours_psnr"] for r in rows])
            print(f"BD-rate vs x264 (medium, CQP): {bd:+.1f}% "
                  f"(negative = we need fewer bits for equal PSNR)")
        result = {"points": rows, "bd_rate_vs_x264_pct":
                  None if math.isnan(bd) else round(bd, 1),
                  "size": args.size, "engine": args.engine,
                  "device": device_name(dev)}
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
