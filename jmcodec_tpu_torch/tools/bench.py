"""Headline benchmark of the port on one NVIDIA card: the six 1080p
figures of the JAX package's bench.py, on the port's entry points, each
checked bit for bit.

  hevc       HEVC all-intra: threaded native parse -> stack_plans ->
             decode_frames_hevc_batch, end to end and device-only (the
             plan tensors already on the card)
  h264       H.264 all-intra: threaded native parse -> stack_symbols ->
             decode_frames_batch, end to end and device-only
  h264_inter H.264 I + P: decode_symbols with its DeviceDPB over the
             parsed pictures (the parse is outside the timing, as in the
             reference)
  cabac      the same stream through DecoderSession(), fed 1 MiB chunks,
             frames taken with get_frame_device
  hevc_inter the HEVC inter stream through DecoderSession(), the same way
  encode     EncoderSession(EncoderParams(1080p30, 2 Mb/s VBR, GOP 30,
             engine="device")): the IDR and the first P frame are the
             warm-up, then the steady-state P rate

Each figure is the best of its repeats (3 for hevc, 2 for the others),
every repeat and the median on stderr; each timed call ends in a
synchronise. Every figure is bit-exact or the bench raises: the decoded
planes against the committed libavcodec SHA-256 digests, the encoded
stream decoded by the port against the encoder's own reconstruction.

Streams are the committed fixtures (tools/fixtures.py). They cut the
reference's streams (bench.py's make_test_stream: N oracle-encoded
pictures a figure) only in length, GOP shape or content:
  - hevc: the 2-picture fixture (x265, qp 30, CTU 64, all IDR) repeated
    to JMX_BENCH_FRAMES (16) pictures, where the reference encodes 16
    distinct ones;
  - h264: the 2-picture fixture (x264 CAVLC, qp 30, all IDR) repeated to
    JMX_BENCH_FRAMES_H264 (twice JMX_BENCH_FRAMES) pictures;
  - h264_inter and cabac: the 1080p P fixture, an IDR and 4 P pictures
    (x264 CABAC, ref=3, weightp=2, a noisy pan with a block of new edges
    a picture) where the reference encodes 16 pictures IPPP of a pan (the
    inter figure's with x264's defaults, the session's with cabac=1); the
    port's DeviceDPB keeps the stream's reference list where the
    reference keeps one picture;
  - hevc_inter: the 16-picture HEVC inter fixture (I, P and B with
    bframes=3, weighted P, new edges a picture), where the reference
    encodes a plain 16-picture pan;
  - encode: tools/fixtures.encode_fixture_frames(min(N, 8)), the 1080p
    encode fixture's pan continued, where the reference makes min(N, 8)
    independent gradient-noise pictures; as there, frames 0 and 1 are the
    warm-up and frames 2 to min(N, 8) - 1 are timed, twice in one session.

    python -m jmcodec_tpu_torch.tools.bench [--device DEV]

--device: where it runs (default: the card, which must be there; "cpu"
runs the same code on the CPU, which gives no device figure). The last
line of stdout is one JSON object: the reference's keys (its TPU roofline
and note left out), plus "card" (nvidia-smi's name and power limit) and
"kernel_launches" (each figure's CUDA kernel launches in its checked run).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from jmcodec_tpu_torch.api.h264_inter import decode_h264, decode_symbols
from jmcodec_tpu_torch.api.h264_inter import parse_h264
from jmcodec_tpu_torch.api.h264_intra import parse_h264_intra_symbols
from jmcodec_tpu_torch.api.hevc_intra import parse_hevc_intra_plans
from jmcodec_tpu_torch.api.session import (Codec, DecoderSession,
                                           EncoderParams, EncoderSession,
                                           PixFmt)
from jmcodec_tpu_torch.kernels import h264_scan as HS
from jmcodec_tpu_torch.kernels import hevc_resid as HR
from jmcodec_tpu_torch.kernels import hevc_scan as HSC
from jmcodec_tpu_torch.kernels import hevc_walk as HW
from jmcodec_tpu_torch.kernels import idct as ID
from jmcodec_tpu_torch.kernels.hevc_tiles import (decode_frames_hevc_batch,
                                                  stack_plans)
from jmcodec_tpu_torch.kernels.recon import stack_symbols
from jmcodec_tpu_torch.kernels.recon_tiles import decode_frames_batch
from jmcodec_tpu_torch.tools.fixtures import (DIGESTS, H264_DIGESTS,
                                              H264_INTER_DIGESTS,
                                              INTER_DIGESTS,
                                              encode_fixture_frames,
                                              fixture_batch_stream,
                                              fixture_digests,
                                              h264_fixture_batch_stream,
                                              h264_inter_fixture_stream,
                                              inter_fixture_stream)
from jmcodec_tpu_torch.utils.device import gpu_name_power, require_cuda
from jmcodec_tpu_torch.utils.metrics import counters, timers

# BASELINE.md: "1080p HEVC decode > 60 fps/chip, bit-exact"
TARGET_FPS = 60.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _device(device):
    return require_cuda() if device is None else torch.device(device)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> dict:
    return {"hevc_walk": HW.LAUNCHES, "hevc_scan": HSC.LAUNCHES,
            "hevc_resid": HR.LAUNCHES, "dequant_idct": ID.LAUNCHES,
            "h264_intra": HS.INTRA_LAUNCHES,
            "h264_deblock": HS.DEBLOCK_LAUNCHES}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def _sha(plane) -> str:
    if isinstance(plane, torch.Tensor):
        plane = plane.cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(plane)).hexdigest()


def check_frames(frames, digests, what) -> None:
    """frames [(Y, U, V), ...] (tensors or arrays, one frame each), frame i
    against digests[i % len(digests)] (a fixture repeated to a batch):
    RuntimeError on a count or plane mismatch."""
    if not frames or len(frames) % len(digests):
        raise RuntimeError(f"{what}: {len(frames)} frames for "
                           f"{len(digests)} digests")
    for i, fr in enumerate(frames):
        for plane, p in zip("YUV", fr):
            if _sha(p) != digests[i % len(digests)][plane]:
                raise RuntimeError(f"{what}: frame {i} {plane} differs "
                                   f"from the libavcodec decode")


def _best(what, fps) -> float:
    log(f"{what}: best {max(fps):.4f} fps, median "
        f"{statistics.median(fps):.4f} over {len(fps)} runs")
    return max(fps)


def bench_hevc(stream, digests, device=None, reps=3) -> dict:
    """HEVC all-intra: native parse -> plans -> batched device decode."""
    dev = _device(device)
    workers = os.cpu_count() or 2
    t0 = time.perf_counter()
    plans = parse_hevc_intra_plans(stream)
    n = len(plans)
    log(f"hevc: {len(stream) / 1024:.0f} KB, {n} frames "
        f"{plans[0].width}x{plans[0].height}; single-thread host parse "
        f"{(time.perf_counter() - t0) / n * 1000:.1f} ms/frame")
    args = stack_plans(plans, dev)
    before = _launches()
    out = decode_frames_hevc_batch(*args)
    _sync(dev)
    launches = _since(before)
    check_frames(list(zip(*out)), digests, "hevc")
    e2e, dev_fps = [], []
    for rep in range(reps):
        t0 = time.perf_counter()
        plans = parse_hevc_intra_plans(stream, workers=workers)
        out = decode_frames_hevc_batch(*stack_plans(plans, dev))
        _sync(dev)
        dt = time.perf_counter() - t0
        t1 = time.perf_counter()
        out = decode_frames_hevc_batch(*args)
        _sync(dev)
        dtc = time.perf_counter() - t1
        e2e.append(n / dt)
        dev_fps.append(n / dtc)
        log(f"hevc rep {rep}: e2e {dt * 1000:.1f} ms = {n / dt:.2f} fps | "
            f"device {dtc * 1000:.1f} ms = {n / dtc:.2f} fps")
    check_frames(list(zip(*out)), digests, "hevc")
    return {"fps": _best("hevc e2e", e2e),
            "device_fps": _best("hevc device", dev_fps),
            "frames": n, "pixels": plans[0].width * plans[0].height,
            "launches": launches, "bit_exact": True}


def bench_h264(stream, digests, device=None, reps=2) -> dict:
    """H.264 all-intra: native parse -> symbols -> batched device decode."""
    dev = _device(device)
    workers = os.cpu_count() or 2
    pics = parse_h264_intra_symbols(stream)
    fss = [fs for fs, _ in pics]
    fs0, sps = pics[0]
    n, mbh, mbw = len(fss), fs0.mb_height, fs0.mb_width
    w, h = sps.width, sps.height
    crop = lambda Y, U, V: list(zip(Y[:, :h, :w], U[:, :h // 2, :w // 2],
                                    V[:, :h // 2, :w // 2]))

    def decode(args):
        return decode_frames_batch(mbh, mbw, *args,
                                   deblock=fs0.deblock_enabled)

    args = stack_symbols(fss, dev)
    before = _launches()
    out = decode(args)
    _sync(dev)
    launches = _since(before)
    check_frames(crop(*out), digests, "h264")
    e2e, dev_fps = [], []
    for rep in range(reps):
        t0 = time.perf_counter()
        ps = parse_h264_intra_symbols(stream, workers=workers)
        out = decode(stack_symbols([fs for fs, _ in ps], dev))
        _sync(dev)
        dt = time.perf_counter() - t0
        t1 = time.perf_counter()
        out = decode(args)
        _sync(dev)
        dtc = time.perf_counter() - t1
        e2e.append(n / dt)
        dev_fps.append(n / dtc)
        log(f"h264 rep {rep}: e2e {dt * 1000:.1f} ms = {n / dt:.3f} fps | "
            f"device {dtc * 1000:.1f} ms = {n / dtc:.3f} fps")
    check_frames(crop(*out), digests, "h264")
    return {"fps": _best("h264 e2e", e2e),
            "device_fps": _best("h264 device", dev_fps),
            "frames": n, "pixels": w * h, "launches": launches,
            "bit_exact": True}


def bench_h264_inter(stream, digests, device=None, reps=2) -> dict:
    """H.264 I + P through the production device path: the native parse
    once, then each run decodes the pictures in order against a fresh
    DeviceDPB (each P picture references the earlier recons)."""
    dev = _device(device)
    pics = list(parse_h264(stream))
    n = len(pics)
    log(f"h264 inter: {len(stream) / 1024:.0f} KB, {n} pictures")
    before = _launches()
    frames = decode_symbols(pics, dev)
    _sync(dev)
    launches = _since(before)
    check_frames(frames, digests, "h264 inter")
    fps = []
    for rep in range(reps):
        t0 = time.perf_counter()
        frames = decode_symbols(pics, dev)
        _sync(dev)
        dt = time.perf_counter() - t0
        fps.append(n / dt)
        log(f"h264 inter rep {rep}: {dt * 1000:.1f} ms = {n / dt:.3f} fps")
    check_frames(frames, digests, "h264 inter")
    return {"fps": _best("h264 inter", fps), "frames": n,
            "pixels": pics[0][1].width * pics[0][1].height,
            "launches": launches, "bit_exact": True}


def run_session(codec, stream, dev, step=1 << 20) -> list:
    """stream through DecoderSession(codec) on dev: fed in chunks of step
    bytes, frames taken with get_frame_device as they come, EOF, the rest
    taken, then a synchronise."""
    sess = DecoderSession(codec, device=dev)
    frames, pos = [], 0

    def drain():
        while (fr := sess.get_frame_device()) is not None:
            frames.append(fr)

    while pos < len(stream):
        pos += sess.input_data(stream[pos:pos + step])
        drain()
    sess.set_eof()
    drain()
    _sync(dev)
    return frames


def _session(what, codec, stream, digests, device, reps) -> dict:
    dev = _device(device)
    log(f"{what}: {len(stream) / 1024:.0f} KB")
    on_dev, before = counters.get("frames_device"), _launches()
    frames = run_session(codec, stream, dev)
    launches = _since(before)
    on_device = counters.get("frames_device") - on_dev >= len(frames)
    check_frames(frames, digests, what)
    fps, stages = [], {}
    for rep in range(reps):
        s0 = timers.snapshot()
        t0 = time.perf_counter()
        frames = run_session(codec, stream, dev)
        dt = time.perf_counter() - t0
        s1 = timers.snapshot()
        stages = {k: (v - s0.get(k, 0)) * 1000 for k, v in s1.items()
                  if v - s0.get(k, 0) > 1e-4}
        fps.append(len(frames) / dt)
        log(f"{what} rep {rep}: {dt * 1000:.1f} ms = {len(frames) / dt:.3f} "
            f"fps (device={on_device}) stages_ms={stages}")
    check_frames(frames, digests, what)
    h, w = frames[0][0].shape
    return {"fps": _best(what, fps), "on_device": on_device,
            "stages": stages, "frames": len(frames), "pixels": w * h,
            "launches": launches, "bit_exact": True}


def bench_h264_cabac_session(stream, digests, device=None, reps=2) -> dict:
    """A CABAC H.264 stream through the production DecoderSession (native
    parse -> device recon); on_device: every picture took the device
    path (frames_device)."""
    return _session("h264 cabac session", Codec.H264, stream, digests,
                    device, reps)


def bench_hevc_inter_session(stream, digests, device=None, reps=2) -> dict:
    """An HEVC inter stream through the production DecoderSession (native
    inter parse -> device MC and recon with the reference cache)."""
    return _session("hevc inter session", Codec.HEVC, stream, digests,
                    device, reps)


def bench_encode(frames, device=None, reps=2) -> dict:
    """Device-engine H.264 encode at the reference's default operating
    point (1080p30, 2 Mb/s VBR, GOP 30) in one session: frames[0] (the
    host IDR) and frames[1] (the first P) are the warm-up, frames[2:] are
    timed reps times over. The stream, decoded by the port, must equal
    the encoder's reconstruction frame by frame."""
    dev = _device(device)
    H, W = frames[0][0].shape
    raws = [b"".join(np.asarray(p, np.uint8).tobytes() for p in f)
            for f in frames]
    sess = EncoderSession(EncoderParams(
        width=W, height=H, fps=30, bitrate_kb=2000, gop_len=30,
        engine="device"), device=dev)
    packets, recons = [], []

    def feed(raw):
        sess.encode_frame(raw, PixFmt.I420)
        nbytes = 0
        while (pkt := sess.output_bitstream()) is not None:
            packets.append(pkt[0])
            nbytes += len(pkt[0])
        recons.append(sess._enc.recon_cropped())
        return nbytes

    before = _launches()
    feed(raws[0])
    feed(raws[1])
    fps = []
    for rep in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        nbytes = sum(feed(r) for r in raws[2:])
        _sync(dev)
        dt = time.perf_counter() - t0
        n = len(raws) - 2
        fps.append(n / dt)
        log(f"encode rep {rep}: {dt * 1000:.1f} ms = {n / dt:.4f} fps "
            f"steady-state P ({nbytes * 30 * 8 / n / 1000:.0f} kbps)")
    launches = _since(before)
    stream = b"".join(packets)
    decoded = decode_h264(stream, dev)
    if len(decoded) != len(recons):
        raise RuntimeError(f"encode: {len(decoded)} frames decoded of "
                           f"{len(recons)} encoded")
    for i, (got, want) in enumerate(zip(decoded, recons)):
        for plane, g, r in zip("YUV", got, want):
            if not np.array_equal(g.cpu().numpy(), r):
                raise RuntimeError(f"encode: frame {i} {plane}: the decode "
                                   f"differs from the encoder's recon")
    return {"fps": _best("encode", fps), "frames": len(recons),
            "bytes": len(stream), "pixels": W * H, "launches": launches,
            "bit_exact": True}


def bench_line(hevc, h264, h264_inter, cabac, hevc_inter, encode, card,
               platform) -> dict:
    """The bench's JSON line from the six figures' results."""
    figs = {"hevc_1080p_intra": hevc, "h264_1080p_intra": h264,
            "h264_1080p_inter": h264_inter, "h264_1080p_cabac_session": cabac,
            "hevc_1080p_inter_session": hevc_inter,
            "h264_1080p_encode": encode}
    return {
        "metric": "hevc_1080p_intra_decode_fps_per_chip",
        "value": hevc["fps"],
        "unit": "fps",
        "vs_baseline": hevc["fps"] / TARGET_FPS,
        "device_compute_fps": hevc["device_fps"],
        "bit_exact": all(f["bit_exact"] for f in figs.values()),
        "h264_1080p_intra_fps": h264["fps"],
        "h264_device_compute_fps": h264["device_fps"],
        "h264_1080p_inter_fps": h264_inter["fps"],
        "h264_1080p_cabac_session_fps": cabac["fps"],
        "h264_cabac_on_device_path": cabac["on_device"],
        "hevc_1080p_inter_session_fps": hevc_inter["fps"],
        "session_stage_ms": {"h264_cabac": cabac["stages"],
                             "hevc_inter": hevc_inter["stages"]},
        "h264_1080p_encode_fps": encode["fps"],
        "device_mpix_per_s": {
            "hevc": hevc["device_fps"] * hevc["pixels"] / 1e6,
            "h264": h264["device_fps"] * h264["pixels"] / 1e6},
        "kernel_launches": {k: f["launches"] for k, f in figs.items()},
        "card": card,
        "platform": platform,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where to run (default: the card)")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    card = gpu_name_power() if dev.type == "cuda" else None
    log(f"device: {dev} ({card or 'no card'})")
    N = int(os.environ.get("JMX_BENCH_FRAMES", "16"))
    N264 = int(os.environ.get("JMX_BENCH_FRAMES_H264", str(2 * N)))
    h264_inter_stream = h264_inter_fixture_stream()
    h264_inter_digests = fixture_digests(H264_INTER_DIGESTS)
    line = bench_line(
        bench_hevc(fixture_batch_stream(N), fixture_digests(DIGESTS), dev),
        bench_h264(h264_fixture_batch_stream(N264),
                   fixture_digests(H264_DIGESTS), dev),
        bench_h264_inter(h264_inter_stream, h264_inter_digests, dev),
        bench_h264_cabac_session(h264_inter_stream, h264_inter_digests,
                                 dev),
        bench_hevc_inter_session(inter_fixture_stream(),
                                 fixture_digests(INTER_DIGESTS), dev),
        bench_encode(encode_fixture_frames(min(N, 8)), dev),
        card, "gpu" if dev.type == "cuda" else dev.type)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
