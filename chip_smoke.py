#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's four paths at 1080p from the committed fixtures under
tests/data: the HEVC all-intra batched decode (batch of 16, CTU 64;
parse_hevc_intra_plans -> stack_plans -> decode_frames_hevc_batch), the
H.264 all-intra batched decode (batch of 32; parse_h264_intra_symbols ->
stack_symbols -> decode_frames_batch), the HEVC inter stream decode (16
pictures, I then P and B, CTU 64; decode_hevc: native parse, DPB, phase-
plane MC, the scan over the inter base, filters, output order) and the
H.264 P stream decode (an IDR and four P pictures; decode_h264: native
parse, device DPB, quarter-pel MC with explicit weights, the intra scan
over the MC tiles, the per-edge-bS deblock scan); then the streaming
DecoderSession, the user's entry point, over both codecs' device paths
and the H.264 host fallback with its DPB mirror, and the HEVC host parse
and recon (the Python parse into the device's plans, the numpy decode of
the pictures outside the device's scope); then the EncoderSession, the
encoder's entry point, with the H.264 device engine (the host IDR, the P
frames' motion search, transform and quantisation on the card, the host
CAVLC pack, the reconstruction through the P decode). Every kernel launch
count is set to 0 just before a path is driven and read just after.
Phases, one line each; any failure raises and the exit code is
non-zero:

  1. the card's name and power limit (nvidia-smi)
  2. build the CUDA kernels from jmcodec_tpu_torch/csrc
  3. the hevc_walk kernel against walk_reference, bit for bit, on seeded
     synthetic states at both of the slice's shapes: the usual ones (every
     TU size, all 35 modes, the strong filter) and the hard ones (all-4x4
     lanes, lanes without a TU, z-scan Z, unavailable border patches,
     residuals at the int16 extremes), also for one lane and an odd count
  4. decode the fixture on the card: the walk kernel launched twice per
     scan step, every frame/plane equal to the committed libavcodec
     SHA-256 digests, and equal to the same batch decoded with
     walk_reference
  5. timing (median of 3 after a warm-up): end-to-end fps; device-only
     fps, with the time at which the host had issued the decode's last
     launch (a device that finishes long after it is the bound, one that
     finishes just after it waited on the host); the walk kernel against
     walk_reference at the middle scan step, with that step's active TUs
     per lane and the kernel's cycles per active TU of its longest lane;
     and the kernel's time at every scan step
  6. the dequant_idct kernel against dequant_idct_reference, bit for bit,
     on seeded inputs: N = 700 and N = 1, every qp 0..51, levels over the
     full int16 range, with and without the DC splice, int16 and int32
  7. decode the H.264 fixture on the card: the dequant_idct kernel launched
     twice (luma, both chroma planes), every frame/plane equal to the
     committed libavcodec SHA-256 digests, and equal to the same batch
     decoded with dequant_idct_reference
  8. timing of the H.264 path as in phase 5, and the dequant_idct kernel
     against dequant_idct_reference at the path's two shapes
  9. decode the HEVC inter fixture on the card (decode_hevc): the walk
     kernel launched once per scan step that holds a TU and skipped on the
     others, all 48 planes in output order equal to the committed
     libavcodec SHA-256 digests
 10. timing of the inter path (median of 3): end-to-end fps (native parse
     + device decode, picture by picture in decode order); device-only fps
     (the plans the parse recorded, replayed through the device decode
     with its pyramid cache), with the time at which the host had issued
     the last launch; kernel launches per picture (one replay under
     torch.profiler); walk launches taken and skipped; and the walk kernel
     against walk_reference at the middle scan step of the first P picture
 11. decode the H.264 P fixture on the card (decode_h264): the
     dequant_idct kernel launched twice per picture, all 15 planes equal
     to the committed libavcodec SHA-256 digests; per picture the intra
     scan's diagonals walked and skipped
 12. timing of the H.264 P path over the IDR and the first two P
     pictures (one run each, REPS_H264_P; phase 11's decode is the
     warm-up): end-to-end fps (native parse + device decode, picture by
     picture); device-only fps (the parsed symbols replayed through
     decode_symbols), with the time at which the host had
     issued the last launch; the kernel launches of the first P picture
     (one decode under torch.profiler); and the dequant_idct kernel
     against dequant_idct_reference at the P picture's two shapes
 13. the H.264 session at 1080p: DecoderSession() fed the first three
     pictures of the H.264 P fixture (IDR + 2 P) in 1 MiB chunks, frames
     taken with get_frame_device as bench.py's session figures take them;
     all three decoded on the device (frames_device), dequant_idct
     launched twice a picture, all 9 planes equal to the libavcodec
     digests; end-to-end fps (one run) and the session's stage timers
 14. the HEVC session at 1080p: the HEVC inter fixture (16 pictures), then
     the HEVC all-intra fixture (2 pictures), the same way; every picture
     decoded on the device, every plane equal to its digest; fps and walk
     launches of each
 15. the small session fixtures through DecoderSession() (B with POC type
     0, High with CABAC and the 8x8 transform, I_PCM, three IDR): every
     plane equal to its digest, as many pictures on the device and on the
     host as the CPU tests assert (the B and High streams' IDR on the
     device, the rest on the host through the DPB mirror); then the
     bit-flip corpus of tests/test_robustness.py on the three-IDR stream:
     no exception escapes the session, no CUDA error, picture 1 and the
     picture after the corrupt one bit-exact; then the corpus on two I + P
     streams whose every picture takes the device path: a flipped P
     picture that parses is decoded on the device, and every trial gives
     the frames and counts of the same session on the CPU (which the CPU
     tests hold to jmcodec_tpu's)
 16. the HEVC host parse at 1080p: DecoderSession() fed the cu_qp_delta
     fixture (an I and two P pictures, QP varying from cell to cell) in
     1 MiB chunks; the native parser refuses cu_qp_delta, so every
     picture is parsed in Python (plans_python) and decoded on the device
     (frames_device), the walk kernel launched once per scan step that
     holds a TU, all 9 planes equal to the libavcodec digests; end-to-end
     fps and the stage timers per picture (host_parse: the Python parse;
     device_recon: the host's issue of the device decode)
 17. the small HEVC host-route fixtures through DecoderSession() (cu_qp_
     delta I, P and B; two slices a picture; transform skip; motion past
     the MC pad; five references): every plane equal to its digest, as
     many pictures on the device (frames_device) and on the host
     (frames_host) as the CPU tests assert

 18. the encoder at 1080p: EncoderSession(EncoderParams()) (1080p30, 2
     Mb/s VBR, GOP 30, engine auto: the device encoder on the card) fed
     the three frames of tools/fixtures.encode_fixture_frames as I420
     bytes: the reference planes on the card, the stream's SHA-256 and
     keyframe flags equal to the committed fixture's (jmcodec_tpu's
     stream), the port's decode_h264 of it on the card equal to the
     libavcodec digests and to the encoder's recon_cropped(), plane by
     plane, dequant_idct launched twice a P frame and equal to
     dequant_idct_reference at the P frame's shapes; per frame the wall
     and the stage timers (enc_idr: the host IDR; enc_search, enc_pull,
     enc_pack: the host pack, also in ms a macroblock; enc_recon: the
     recon's issue) and the steady-state P rate (frame 2, as bench.py's
     bench_encode takes it); the search and transform alone
     (synchronised) and its pull alone; one more P frame with a
     synchronise around each recon stage (the deblock scan's share), then
     one under torch.profiler: its kernel launches and the device's busy
     time
 19. the small encoder sessions of tools/fixtures.ENCODE_SESSIONS (rate
     control, GOPs crossing an IDR) on the card against the same sessions
     on the CPU: the same packets and keyframe flags, dequant_idct launched
     twice a P frame

With --only hevc, --only h264, --only hevc_inter, --only h264_inter,
--only session, --only hevc_host or --only encode just that path is
driven (phase 3 with either HEVC path, the session and the host route,
phase 6 with either H.264 path, the session and the encoder; for work on
one kernel or path, the run then prints no kernels' record that is
complete).

Each kernel's record also carries the least time the card could take for
its launch (bound_ms): the larger of its bytes (each input read once, each
output written once) over the HBM rate and its operations, counted from
this run's inputs, over the int32 ALU rate.

The line before the last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Needs no arguments and no network.

    python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import statistics
import sys
import time

import numpy as np
import torch

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from jmcodec_tpu_torch.api.h264_inter import (DeviceDPB, decode_h264,
                                              decode_symbols, parse_h264)
from jmcodec_tpu_torch.api.h264_intra import parse_h264_intra_symbols
from jmcodec_tpu_torch.api.hevc_inter import (DeviceRecon, decode_hevc,
                                              decode_plans)
from jmcodec_tpu_torch.api.hevc_intra import parse_hevc_intra_plans
from jmcodec_tpu_torch.api.session import (Codec, DecoderSession,
                                           EncoderParams, EncoderSession,
                                           PixFmt)
from jmcodec_tpu_torch.codec.h264.devenc import DeviceH264Encoder
from jmcodec_tpu_torch.codec.hevc.refdec import HevcRefDecoder
from jmcodec_tpu_torch.kernels import _build
from jmcodec_tpu_torch.kernels import encode_tiles as ET
from jmcodec_tpu_torch.kernels import hevc_tables as HT
from jmcodec_tpu_torch.kernels import hevc_tiles as HTT
from jmcodec_tpu_torch.kernels import hevc_walk as HW
from jmcodec_tpu_torch.kernels import idct as ID
from jmcodec_tpu_torch.kernels import recon as RC
from jmcodec_tpu_torch.kernels import recon_tiles as RT
from jmcodec_tpu_torch.tools.fixtures import (BATCH, CORPUS_FIXTURE,
                                              CUQP_DIGESTS,
                                              ENCODE_SESSIONS, FIXTURE,
                                              H264_BATCH,
                                              H264_DIGESTS,
                                              H264_INTER_DIGESTS,
                                              H264_SESSION_PICTURES,
                                              HEVC_HOST_FIXTURES,
                                              INTER_DIGESTS, INTER_FIXTURE,
                                              P_CORPUS_FIXTURES,
                                              SESSION_FIXTURES,
                                              cuqp_fixture_stream,
                                              encode_fixture,
                                              encode_fixture_frames,
                                              fixture_batch_stream,
                                              fixture_digests,
                                              h264_fixture_batch_stream,
                                              h264_inter_fixture_stream,
                                              h264_session_stream,
                                              inter_fixture_stream,
                                              pan_frames,
                                              session_corpus,
                                              session_fixture,
                                              synth_idct_blocks, synth_state,
                                              synth_state_hard,
                                              synth_state_inter)
from jmcodec_tpu_torch.tools.profile_h264_intra import _staged
from jmcodec_tpu_torch.tools.profiling import raw_events, union_us
from jmcodec_tpu_torch.utils.device import (gpu_name_power, gpu_sm_clock_mhz,
                                            require_cuda)
from jmcodec_tpu_torch.utils.metrics import counters, logger, timers

ROOT = os.path.dirname(os.path.abspath(__file__))
REPS = 3
# runs of each phase 12 timing: a 1080p P picture takes ~10 s, so its median
# of 3 would take most of the time limit (and phase 12 times the first
# three pictures of the fixture, not all five, to leave the encoder's
# phase 18 room)
REPS_H264_P = 1
# published peaks of one H100 SXM: HBM bytes/s, and int32 ALU operations/s
# (the data sheet's 67 TFLOP/s of float32 counts an FMA as two on 128 lanes
# per SM; an int32 operation counts once on 64)
HBM_BPS = 3.35e12
INT32_OPS = 67e12 / 4
# the slice's two walk shapes at CTU 64 (scan skew 2):
# (C, max_tu, is_chroma, strong, lanes)
SHAPES = {"luma": (64, 32, False, True, BATCH * 17),
          "chroma": (32, 16, True, False, 2 * BATCH * 17)}
# lanes of one 1080p picture at CTU 64, as the inter path walks them
INTER_LANES = {"luma": 17, "chroma": 34}


def say(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def sync_time(fn, reps):
    """Medians over reps runs of fn(), each ended by a sync: the wall time,
    and the time at which fn() returned to the host."""
    walls, rets = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        rets.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), statistics.median(rets)


def event_ms(fn, reps):
    """Mean device time of fn() in ms over reps back-to-back runs. The runs
    are queued behind a spin kernel of a few ms, so that the host's launch
    rate (tens of us a call from Python) does not pace a short kernel."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e5 * reps) + 4_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def walk_args(state, dev):
    return [torch.from_numpy(a).to(dev) for a in state]


def max_abs(a, b):
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item())


def active_tus(tu, C, max_tu):
    """Active TUs per lane of a walk state's TU map: [B] int64 (numpy)."""
    tu = np.asarray(tu)
    return sum((tu[:, y0 // 4, x0 // 4] == n.bit_length() - 1).astype(np.int64)
               for n, x0, y0 in HT.zorder_candidates(C, max_tu))


def check_walk_shapes(dev):
    """Phase 3: kernel == walk_reference on the usual synthetic states
    (every TU size and all 35 modes active, the strong filter taken) and on
    the hard ones, at the slice's lane counts, for one lane and for an odd
    number of lanes."""
    err = 0
    for name, (C, max_tu, chroma, strong, B) in SHAPES.items():
        kw = dict(C=C, max_tu=max_tu, is_chroma=chroma, strong=strong)
        st = synth_state(C, max_tu, B, seed=7)
        _, _, _, tu, mode = st
        sizes, modes = set(), set()
        for n, x0, y0 in HT.zorder_candidates(C, max_tu):
            on = tu[:, y0 // 4, x0 // 4] == n.bit_length() - 1
            if on.any():
                sizes.add(n)
                modes.update(mode[on, y0 // 4, x0 // 4].tolist())
        want_sizes = {n for n, _, _ in HT.zorder_candidates(C, max_tu)}
        check(sizes == want_sizes, f"{name}: TU sizes {sizes}")
        check(modes == set(range(35)), f"{name}: modes missing")
        hard = synth_state_hard(C, max_tu, B, seed=7)
        per_lane = active_tus(hard[3], C, max_tu)
        check(per_lane.max() == (C // 4) ** 2 and per_lane.min() == 0
              and int(hard[2].min()) == -32768
              and int(hard[2].max()) == 32767,
              f"{name}: hard state lacks a case")
        inter = synth_state_inter(C, max_tu, INTER_LANES[name], seed=7)
        inter_empty = active_tus(inter[3], C, max_tu) == 0
        check(inter_empty.any() and not inter_empty.all(),
              f"{name}: inter state lacks a case")
        for what, state in (("usual", st), ("hard", hard),
                            ("hard, 1 lane", synth_state_hard(C, max_tu, 1,
                                                              seed=8)),
                            ("hard, 7 lanes", synth_state_hard(C, max_tu, 7,
                                                               seed=9)),
                            ("inter", inter)):
            args = walk_args(state, dev)
            got = HW.walk(*args, **kw)
            want = HW.walk_reference(*args, **kw)
            torch.cuda.synchronize()
            e = max_abs(got, want)
            check(e == 0, f"{name} ({what}): kernel != walk_reference")
            err = max(err, e)
            if what == "usual" and strong:
                weak = HW.walk_reference(*args, **dict(kw, strong=False))
                check(not torch.equal(weak, want),
                      "strong filter never taken")
            if what in ("hard", "inter"):
                empty = per_lane == 0 if what == "hard" else inter_empty
                empty = torch.from_numpy(empty).to(dev)
                check(torch.equal(got[empty], args[0][empty]),
                      f"{name} ({what}): a lane without a TU changed F")
        say(f"phase 3 {name}: kernel == walk_reference on B={B} lanes, "
            f"F {tuple(args[0].shape[1:])}: usual states (TU sizes "
            f"{sorted(sizes)}, 35 modes) and hard states (up to "
            f"{per_lane.max()} TUs a lane, {int((per_lane == 0).sum())} "
            f"lanes without one), also B=1 and B=7; inter-seeded states on "
            f"B={INTER_LANES[name]} lanes ({int(inter_empty.sum())} without "
            f"a TU), max_abs_err {err}")
    return err


def bound_ms(nbytes, ops):
    """(the least time the card could take, which of the two sets it, a
    text with both times)."""
    by, op = nbytes / HBM_BPS * 1e3, ops / INT32_OPS * 1e3
    both = f"bytes {by:.5f} ms, operations {op:.5f} ms"
    return (by, "bytes", both) if by >= op else (op, "operations", both)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def walk_bound(F, Z, resid, tu, mode, C, max_tu):
    """Bound of one walk launch. Bytes: F, Z, resid, tu, mode in, F out.
    Operations, for the TUs this step's tu maps hold: per TU of size n, 7
    per reference sample (gather, availability, substitution, filter) and
    8 per predicted pixel (two-tap interpolation, residual add, clip)."""
    tu_h = tu.cpu().numpy()
    ops = 0
    for n, x0, y0 in HT.zorder_candidates(C, max_tu):
        k = int((tu_h[:, y0 // 4, x0 // 4] == n.bit_length() - 1).sum())
        ops += k * (7 * (4 * n + 1) + 8 * n * n)
    return bound_ms(nbytes(F, Z, resid, tu, mode, F), ops)


def idct_bound(coeffs, qp_blk, dc=None, dc_mask=None):
    """Bound of one dequant_idct launch. Bytes: levels, qp, dc, mask in,
    int32 residual out. Operations per block: 32 multiplies (scale, shift)
    and 80 adds and shifts (two butterfly passes, rounding)."""
    n = coeffs.shape[0]
    return bound_ms(nbytes(coeffs, qp_blk, dc, dc_mask) + n * 64, n * 112)


def check_digests(planes, digests, what):
    out = [t.cpu().numpy() if isinstance(t, torch.Tensor) else t
           for t in planes]
    for f in range(out[0].shape[0]):
        for k, plane in enumerate("YUV"):
            h = hashlib.sha256(np.ascontiguousarray(out[k][f])).hexdigest()
            check(h == digests[f % len(digests)][plane],
                  f"{what} frame {f} {plane}: digest mismatch")


def reset_counts():
    HW.LAUNCHES = 0
    ID.LAUNCHES = 0


def hevc_path(dev, card, err):
    """Phases 4-5 (err: phase 3's); returns the hevc_walk record and the
    path's figures."""
    # ---- phase 4: the path on the card ----
    digests = fixture_digests()
    stream = fixture_batch_stream()
    plans = parse_hevc_intra_plans(stream, workers=os.cpu_count() or 1)
    check(len(plans) == BATCH, f"{len(plans)} pictures parsed")
    p0 = plans[0]
    C = 1 << p0.log2_ctb
    ctb_h, ctb_w = p0.Hp // C, p0.Wp // C
    steps = ctb_w + HT.skew_for(C) * (ctb_h - 1)
    args = HTT.stack_plans(plans, dev)
    torch.cuda.synchronize()
    reset_counts()
    Y, U, V = HTT.decode_frames_hevc_batch(*args)
    torch.cuda.synchronize()
    launches = HW.LAUNCHES
    check(launches == 2 * steps, f"{launches} walk launches, {steps} steps")
    check(ID.LAUNCHES == 0, "dequant_idct launched on the HEVC path")
    check_digests((Y, U, V), digests, "hevc")
    ref = HTT.decode_frames_hevc_batch(*args, walk_fn=HW.walk_reference)
    torch.cuda.synchronize()
    for a, b, plane in zip((Y, U, V), ref, "YUV"):
        e = max_abs(a, b)
        err = max(err, e)
        check(e == 0, f"decode != walk_reference decode ({plane})")
    say(f"phase 4: {BATCH}x {p0.width}x{p0.height} CTU {C}: {steps} scan "
        f"steps, hevc_walk launched {launches} times; all {BATCH * 3} "
        f"planes match the libavcodec SHA-256 digests and the "
        f"walk_reference decode")
    del ref

    # ---- phase 5: timing ----
    workers = os.cpu_count() or 1

    def e2e():
        ps = parse_hevc_intra_plans(stream, workers=workers)
        HTT.decode_frames_hevc_batch(*HTT.stack_plans(ps, dev))

    def device_only():
        HTT.decode_frames_hevc_batch(*args)

    e2e()
    t_e2e, _ = sync_time(e2e, REPS)
    device_only()
    t_dev, t_issued = sync_time(device_only, REPS)

    # per-step walk time on the real states of the middle scan step
    captured = {}

    def capture(F, Z, resid, tu, mode, **kw):
        key = "chroma" if kw["is_chroma"] else "luma"
        captured.setdefault(key, []).append(((F, Z, resid, tu, mode), kw))
        return HW.walk(F, Z, resid, tu, mode, **kw)

    HTT.decode_frames_hevc_batch(*args, walk_fn=capture)
    step_ms, bounds, chain, every = {}, {}, {}, {}
    for key in ("luma", "chroma"):
        (wa, kw) = captured[key][steps // 2]
        got = HW.walk(*wa, **kw)
        want = HW.walk_reference(*wa, **kw)
        torch.cuda.synchronize()
        e = max_abs(got, want)
        err = max(err, e)
        check(e == 0, f"{key} step: kernel != walk_reference")
        step_ms[key] = (event_ms(lambda: HW.walk(*wa, **kw), 50),
                        event_ms(lambda: HW.walk_reference(*wa, **kw), 3))
        bounds[key] = walk_bound(*wa, kw["C"], kw["max_tu"])
        # the chain: the launch lasts as long as its longest lane
        per_lane = active_tus(wa[3].cpu().numpy(), kw["C"], kw["max_tu"])
        # keep the card busy for ~0.6 s while its clock is asked
        for _ in range(min(int(600 / step_ms[key][0]), 20000)):
            HW.walk(*wa, **kw)
        mhz = gpu_sm_clock_mhz()
        torch.cuda.synchronize()
        chain[key] = (int(per_lane.max()), float(per_lane.mean()), mhz,
                      step_ms[key][0] * 1e-3 * mhz * 1e6
                      / max(int(per_lane.max()), 1))
        every[key] = [event_ms(lambda: HW.walk(*a, **k), 10)
                      for a, k in captured[key]]
    say(f"phase 5 [{card}]: end-to-end {BATCH / t_e2e:.2f} fps "
        f"({t_e2e * 1000:.1f} ms per batch of {BATCH}, parse on {workers} "
        f"threads + stack_plans + H2D + decode); device-only "
        f"{BATCH / t_dev:.2f} fps ({t_dev * 1000:.1f} ms); the host had "
        f"issued the device-only decode's last launch at "
        f"{t_issued * 1000:.1f} ms, the device finished "
        f"{(t_dev - t_issued) * 1000:.1f} ms later")
    for key, (k_ms, p_ms) in step_ms.items():
        say(f"phase 5 [{card}]: walk step {key} (B="
            f"{captured[key][0][0][0].shape[0]}): kernel {k_ms:.4f} ms, "
            f"walk_reference {p_ms:.2f} ms, bound {bounds[key][0]:.5f} ms "
            f"({bounds[key][2]})")
        tus_max, tus_mean, mhz, cyc = chain[key]
        ev = every[key]
        say(f"phase 5 [{card}]: walk chain {key}: active TUs per lane at "
            f"the middle step max {tus_max}, mean {tus_mean:.1f}; at "
            f"{mhz} MHz the kernel takes {cyc:.0f} cycles per active TU of "
            f"the longest lane; over all {len(ev)} steps the kernel takes "
            f"min {min(ev):.4f}, median {statistics.median(ev):.4f}, max "
            f"{max(ev):.4f} ms, {sum(ev):.2f} ms in all (first "
            f"{ev[0]:.4f}, last {ev[-1]:.4f})")

    mean = lambda d, i: statistics.mean(v[i] for v in d.values())
    rec = {"name": "hevc_walk", "route": "cuda",
           "source": "jmcodec_tpu_torch/csrc/hevc_walk.cu",
           "replaces": "jmcodec_tpu/kernels/hevc_walk_pallas.py:560",
           "launches": launches, "launches_hevc_intra": launches,
           "max_abs_err": err,
           "ms": mean(step_ms, 0), "plain_ms": mean(step_ms, 1),
           "bound_ms": mean(bounds, 0),
           "bound_by": max(bounds.values())[1], "library_ms": None,
           "ms_luma": step_ms["luma"][0], "plain_ms_luma": step_ms["luma"][1],
           "bound_ms_luma": bounds["luma"][0],
           "ms_chroma": step_ms["chroma"][0],
           "plain_ms_chroma": step_ms["chroma"][1],
           "bound_ms_chroma": bounds["chroma"][0]}
    for key in ("luma", "chroma"):
        tus_max, tus_mean, mhz, cyc = chain[key]
        ev = every[key]
        rec.update({f"active_tus_max_{key}": tus_max,
                    f"active_tus_mean_{key}": tus_mean,
                    f"sm_mhz_{key}": mhz,
                    f"cycles_per_active_tu_{key}": cyc,
                    f"steps_ms_{key}": {"min": min(ev),
                                        "median": statistics.median(ev),
                                        "max": max(ev), "sum": sum(ev)}})
    figures = {"slice": "hevc 1080p all-intra batch decode",
               "batch": BATCH, "e2e_fps": BATCH / t_e2e,
               "device_fps": BATCH / t_dev,
               "device_only_issued_ms": t_issued * 1000,
               "device_only_wall_ms": t_dev * 1000, "card": card}
    return rec, figures


def check_idct_kernel(dev):
    """Phase 6: kernel == dequant_idct_reference on seeded inputs."""
    err = 0
    for N in (700, 1):
        c16, qp, dc, mask = (torch.from_numpy(a).to(dev)
                             for a in synth_idct_blocks(N, seed=5))
        if N == 700:
            check(set(qp.tolist()) == set(range(52)), "qp values missing")
            check(int(c16.min()) < -32000 and int(c16.max()) > 32000,
                  "levels do not span int16")
            check(not torch.equal(ID.dequant_idct_reference(c16, qp),
                                  ID.dequant_idct_reference(c16, qp, dc,
                                                            mask)),
                  "the DC splice changed nothing")
        for coeffs in (c16, c16.to(torch.int32)):
            for splice in ((), (dc, mask), (dc,)):
                got = ID.dequant_idct_blocks(coeffs, qp, *splice)
                want = ID.dequant_idct_reference(coeffs, qp, *splice)
                torch.cuda.synchronize()
                e = max_abs(got, want)
                check(e == 0, f"dequant_idct N={N} {coeffs.dtype} "
                              f"splice={len(splice)}: kernel != reference")
                err = max(err, e)
    say(f"phase 6: dequant_idct kernel == dequant_idct_reference at N=700 "
        f"and N=1, qp 0..51, int16 and int32 levels, with and without the "
        f"DC splice, max_abs_err {err}")
    return err


def idct_shapes(args):
    """The dequant_idct kernel against dequant_idct_reference at a path's
    two shapes (luma; both chroma planes), on the path's own inputs
    (stack_symbols tensors): {shape: (its arguments, kernel ms,
    reference ms, bound)} and the max_abs_err."""
    captured = []

    def capture(*a):
        captured.append(a)
        return ID.dequant_idct_blocks(*a)

    RC._residuals(*(args[k] for k in (5, 6, 7, 8)), args[1].to(torch.int32),
                  args[0].to(torch.int32), args[14], args[15], capture)
    check(len(captured) == 2, f"{len(captured)} residual stages")
    shapes, err = {}, 0
    for key, a in zip(("luma", "chroma"), captured):
        got = ID.dequant_idct_blocks(*a)
        want = ID.dequant_idct_reference(*a)
        torch.cuda.synchronize()
        e = max_abs(got, want)
        err = max(err, e)
        check(e == 0, f"{key}: kernel != dequant_idct_reference")
        del got, want
        shapes[key] = (a, event_ms(lambda: ID.dequant_idct_blocks(*a), 20),
                       event_ms(lambda: ID.dequant_idct_reference(*a), 3),
                       idct_bound(*a))
    return shapes, err


def say_idct_shapes(phase, card, shapes):
    for key, (a, k_ms, p_ms, bound) in shapes.items():
        say(f"{phase} [{card}]: dequant_idct {key} (N={a[0].shape[0]}, "
            f"{'dc + mask' if len(a) == 4 else 'dc'}): kernel "
            f"{k_ms:.4f} ms, dequant_idct_reference {p_ms:.2f} ms, bound "
            f"{bound[0]:.5f} ms ({bound[2]})")


def idct_record(shapes, launches, err):
    """The dequant_idct entry of the kernels' record from one path's
    shapes."""
    mean = lambda i: statistics.mean(v[i] for v in shapes.values())
    bounds = [v[3] for v in shapes.values()]
    rec = {"name": "dequant_idct", "route": "cuda",
           "source": "jmcodec_tpu_torch/csrc/dequant_idct.cu",
           "replaces": "jmcodec_tpu/kernels/pallas_idct.py:83",
           "launches": launches, "max_abs_err": err,
           "ms": mean(1), "plain_ms": mean(2),
           "bound_ms": statistics.mean(b[0] for b in bounds),
           "bound_by": max(bounds)[1], "library_ms": None}
    for key, (_, k_ms, p_ms, bound) in shapes.items():
        rec.update({f"ms_{key}": k_ms, f"plain_ms_{key}": p_ms,
                    f"bound_ms_{key}": bound[0]})
    return rec


def h264_path(dev, card, err):
    """Phases 7-8 (err: phase 6's); returns the dequant_idct record and
    the path's figures."""
    # ---- phase 7: the path on the card ----
    digests = fixture_digests(H264_DIGESTS)
    stream = h264_fixture_batch_stream()
    workers = os.cpu_count() or 1
    pics = parse_h264_intra_symbols(stream, workers=workers)
    check(len(pics) == H264_BATCH, f"{len(pics)} pictures parsed")
    fss = [fs for fs, _ in pics]
    fs0, sps = pics[0]
    mbh, mbw = fs0.mb_height, fs0.mb_width
    w, h = sps.width, sps.height
    crop = lambda Y, U, V: (Y[:, :h, :w], U[:, :h // 2, :w // 2],
                            V[:, :h // 2, :w // 2])
    args = RC.stack_symbols(fss, dev)
    torch.cuda.synchronize()
    reset_counts()
    out = RT.decode_frames_batch(mbh, mbw, *args, deblock=True)
    torch.cuda.synchronize()
    launches = ID.LAUNCHES
    check(launches == 2, f"{launches} dequant_idct launches, want 2 (luma, "
                         f"both chroma planes)")
    check(HW.LAUNCHES == 0, "hevc_walk launched on the H.264 path")
    check(out[0].dtype == torch.uint8
          and tuple(out[0].shape) == (H264_BATCH, mbh * 16, mbw * 16),
          f"Y {out[0].dtype} {tuple(out[0].shape)}")
    check_digests(crop(*out), digests, "h264")
    ref = RT.decode_frames_batch(mbh, mbw, *args, deblock=True,
                                 residual_fn=ID.dequant_idct_reference)
    torch.cuda.synchronize()
    for a, b, plane in zip(out, ref, "YUV"):
        e = max_abs(a, b)
        err = max(err, e)
        check(e == 0, f"decode != dequant_idct_reference decode ({plane})")
    steps = mbw + 2 * (mbh - 1)
    say(f"phase 7: {H264_BATCH}x {w}x{h} H.264: {steps} wavefront steps of "
        f"{mbh} lanes per frame, dequant_idct launched {launches} times; "
        f"all {H264_BATCH * 3} planes match the libavcodec SHA-256 digests "
        f"and the dequant_idct_reference decode")
    del ref, out

    # ---- phase 8: timing ----
    def e2e():
        ps = parse_h264_intra_symbols(stream, workers=workers)
        RT.decode_frames_batch(mbh, mbw, *RC.stack_symbols(
            [fs for fs, _ in ps], dev), deblock=True)

    def device_only():
        RT.decode_frames_batch(mbh, mbw, *args, deblock=True)

    e2e()
    t_e2e, _ = sync_time(e2e, REPS)
    t_dev, t_issued = sync_time(device_only, REPS)

    shapes, e = idct_shapes(args)
    err = max(err, e)
    say(f"phase 8 [{card}]: end-to-end {H264_BATCH / t_e2e:.2f} fps "
        f"({t_e2e * 1000:.1f} ms per batch of {H264_BATCH}, parse on "
        f"{workers} threads + stack_symbols + H2D + decode); device-only "
        f"{H264_BATCH / t_dev:.2f} fps ({t_dev * 1000:.1f} ms); the host "
        f"had issued the device-only decode's last launch at "
        f"{t_issued * 1000:.1f} ms, the device finished "
        f"{(t_dev - t_issued) * 1000:.1f} ms later")
    say_idct_shapes("phase 8", card, shapes)
    rec = idct_record(shapes, launches, err)
    rec["launches_h264_intra"] = launches
    figures = {"slice": "h264 1080p all-intra batch decode",
               "batch": H264_BATCH, "e2e_fps": H264_BATCH / t_e2e,
               "device_fps": H264_BATCH / t_dev,
               "device_only_issued_ms": t_issued * 1000,
               "device_only_wall_ms": t_dev * 1000, "card": card}
    return rec, figures


def kernel_busy(fn):
    """(CUDA kernel events, the device's busy ms: the union of their
    intervals) of one fn() run under torch.profiler."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e[2:] for e in raw_events(prof) if e[1] == DeviceType.CUDA]
    return len(kernels), union_us(kernels) / 1e3


def kernel_launches(fn):
    """CUDA kernel events of one fn() run under torch.profiler."""
    return kernel_busy(fn)[0]


def hevc_inter_path(dev, card, walk_rec, err):
    """Phases 9-10 (err: phase 3's). Returns the hevc_walk record (walk_rec
    with the inter path's launches and step times added, or a record of
    this path alone when the intra path was not driven) and the path's
    figures."""
    digests = fixture_digests(INTER_DIGESTS)
    stream = inter_fixture_stream()

    # ---- phase 9: the path on the card ----
    plans = []
    recon = DeviceRecon(dev)

    def recording(plan, ref_pixels):
        plans.append(plan)
        return recon(plan, ref_pixels)

    reset_counts()
    frames = HevcRefDecoder(recording).decode(stream)
    torch.cuda.synchronize()
    launches = HW.LAUNCHES
    check(ID.LAUNCHES == 0, "dequant_idct launched on the HEVC inter path")
    check(len(frames) == len(plans) == len(digests),
          f"{len(frames)} frames, {len(plans)} pictures")
    check_digests([torch.stack([f[k] for f in frames]) for k in range(3)],
                  digests, "hevc inter")
    steps = [HTT.walk_steps(p) for p in plans]
    n_steps = sum(len(y) + len(c) for y, c in steps)
    taken = sum(sum(y) + sum(c) for y, c in steps)
    check(launches == taken, f"{launches} walk launches, {taken} steps "
                             f"with a TU")
    p0 = plans[0]
    say(f"phase 9: {len(plans)} pictures {p0.width}x{p0.height} CTU "
        f"{1 << p0.log2_ctb} (decode order POC "
        f"{[p.poc for p in plans]}): hevc_walk launched {launches} times "
        f"over {n_steps} scan steps, {n_steps - launches} steps without a "
        f"TU skipped; all {3 * len(frames)} planes in output order match "
        f"the libavcodec SHA-256 digests")

    # ---- phase 10: timing ----
    def e2e():
        decode_hevc(stream, dev)

    def device_only():
        decode_plans(plans, dev)

    e2e()
    t_e2e, _ = sync_time(e2e, REPS)
    device_only()
    t_dev, t_issued = sync_time(device_only, REPS)
    n_kernels = kernel_launches(device_only)
    n = len(plans)

    # the walk at the middle scan step of the first P picture, on the
    # states the decode gives it
    check(plans[1].ref_pocs == [p0.poc], "picture 1 is not a P picture")
    i_planes = decode_plans(plans[:1], dev)[0]
    captured = {}

    def capture(F, Z, resid, tu, mode, **kw):
        key = "chroma" if kw["is_chroma"] else "luma"
        captured.setdefault(key, []).append(((F, Z, resid, tu, mode), kw))
        return HW.walk(F, Z, resid, tu, mode, **kw)

    HTT.decode_plan_inter(plans[1], [HTT.prep_hevc_ref(*i_planes)], dev,
                          walk_fn=capture)
    step_ms, bounds, tus = {}, {}, {}
    for key in ("luma", "chroma"):
        wa, kw = captured[key][len(captured[key]) // 2]
        got = HW.walk(*wa, **kw)
        want = HW.walk_reference(*wa, **kw)
        torch.cuda.synchronize()
        e = max_abs(got, want)
        err = max(err, e)
        check(e == 0, f"inter {key} step: kernel != walk_reference")
        step_ms[key] = (event_ms(lambda: HW.walk(*wa, **kw), 50),
                        event_ms(lambda: HW.walk_reference(*wa, **kw), 3))
        bounds[key] = walk_bound(*wa, kw["C"], kw["max_tu"])
        per_lane = active_tus(wa[3].cpu().numpy(), kw["C"], kw["max_tu"])
        tus[key] = (int(per_lane.max()), float(per_lane.mean()),
                    len(captured[key]))
    say(f"phase 10 [{card}]: end-to-end {n / t_e2e:.2f} fps "
        f"({t_e2e * 1000:.1f} ms for {n} pictures: native parse + device "
        f"decode in decode order); device-only {n / t_dev:.2f} fps "
        f"({t_dev * 1000:.1f} ms: the recorded plans, uploaded and decoded "
        f"with the pyramid cache); the host had issued the last launch at "
        f"{t_issued * 1000:.1f} ms, the device finished "
        f"{(t_dev - t_issued) * 1000:.1f} ms later; {n_kernels} kernel "
        f"launches ({n_kernels / n:.0f} per picture), hevc_walk {launches} "
        f"taken and {n_steps - launches} skipped")
    for key, (k_ms, p_ms) in step_ms.items():
        say(f"phase 10 [{card}]: walk step {key} of the first P picture "
            f"(B={captured[key][0][0][0].shape[0]}, step {tus[key][2] // 2} "
            f"of the {tus[key][2]} walked; active TUs per lane max "
            f"{tus[key][0]}, mean {tus[key][1]:.1f}): kernel {k_ms:.4f} "
            f"ms, walk_reference {p_ms:.2f} ms, bound {bounds[key][0]:.5f} "
            f"ms ({bounds[key][2]})")

    inter = {"launches_hevc_inter": launches,
             "skipped_hevc_inter": n_steps - launches}
    for key in ("luma", "chroma"):
        inter.update({f"ms_inter_{key}": step_ms[key][0],
                      f"plain_ms_inter_{key}": step_ms[key][1],
                      f"bound_ms_inter_{key}": bounds[key][0]})
    if walk_rec is None:
        mean = lambda d, i: statistics.mean(v[i] for v in d.values())
        walk_rec = {"name": "hevc_walk", "route": "cuda",
                    "source": "jmcodec_tpu_torch/csrc/hevc_walk.cu",
                    "replaces": "jmcodec_tpu/kernels/hevc_walk_pallas.py:560",
                    "launches": 0, "max_abs_err": 0,
                    "ms": mean(step_ms, 0), "plain_ms": mean(step_ms, 1),
                    "bound_ms": mean(bounds, 0),
                    "bound_by": max(bounds.values())[1], "library_ms": None}
    walk_rec.update(inter)
    walk_rec["launches"] += launches
    walk_rec["max_abs_err"] = max(walk_rec["max_abs_err"], err)
    figures = {"slice": "hevc 1080p inter stream decode", "pictures": n,
               "e2e_fps": n / t_e2e, "device_fps": n / t_dev,
               "device_only_issued_ms": t_issued * 1000,
               "device_only_wall_ms": t_dev * 1000,
               "kernel_launches_per_picture": n_kernels / n,
               "walk_launches": launches,
               "walk_skipped": n_steps - launches, "card": card}
    return walk_rec, figures


def h264_inter_path(dev, card, idct_rec, err):
    """Phases 11-12 (err: phase 6's). Returns the dequant_idct record
    (idct_rec with the P path's launches and shapes added, or a record of
    this path alone when the all-intra path was not driven) and the
    path's figures."""
    digests = fixture_digests(H264_INTER_DIGESTS)
    stream = h264_inter_fixture_stream()
    pics = list(parse_h264(stream))           # for the host's step counts

    # ---- phase 11: the path on the card ----
    reset_counts()
    frames = decode_h264(stream, dev)
    torch.cuda.synchronize()
    launches = ID.LAUNCHES
    n = len(pics)
    check(HW.LAUNCHES == 0, "hevc_walk launched on the H.264 P path")
    check(len(frames) == n == len(digests), f"{len(frames)} frames, {n} "
                                            f"pictures")
    check(launches == 2 * n, f"{launches} dequant_idct launches for {n} "
                             f"pictures, want 2 each")
    check(all(p.device == dev and p.dtype == torch.uint8
              for f in frames for p in f), "frames not uint8 on the card")
    check_digests([torch.stack([f[k] for f in frames]) for k in range(3)],
                  digests, "h264 inter")
    walks = [RT.intra_steps(fs.mb_class) for fs, _ in pics
             if fs.mv is not None]
    walked = sum(sum(w) for w in walks)
    steps = sum(len(w) for w in walks)
    sps = pics[0][1]
    say(f"phase 11: {n} pictures {sps.width}x{sps.height} H.264 (I, then "
        f"{len(walks)} P with {[fs.num_ref_l0 for fs, _ in pics[1:]]} "
        f"references): dequant_idct launched {launches} times (2 a "
        f"picture); the P pictures' intra scans walked "
        f"{[sum(w) for w in walks]} and skipped "
        f"{[len(w) - sum(w) for w in walks]} of {len(walks[0])} diagonals; "
        f"all {3 * n} planes match the libavcodec SHA-256 digests")
    del frames

    # ---- phase 12: timing, over the IDR and the first two P pictures ----
    n = H264_SESSION_PICTURES
    t_e2e, _ = sync_time(lambda: decode_h264(h264_session_stream(), dev),
                         REPS_H264_P)
    t_dev, t_issued = sync_time(lambda: decode_symbols(pics[:n], dev),
                                REPS_H264_P)
    dpb = DeviceDPB()
    decode_symbols(pics[:1], dev, dpb=dpb)
    fs1 = pics[1][0]
    refs, ids = dpb.list0(fs1)
    one_p = lambda: RT.decode_frame_symbols_inter(fs1, refs, ref_ids=ids)
    t_p, t_p_issued = sync_time(one_p, 1)
    n_kernels = kernel_launches(one_p)
    shapes, e = idct_shapes(RC.stack_symbols([fs1], dev))
    err = max(err, e)
    say(f"phase 12 [{card}]: end-to-end {n / t_e2e:.3f} fps "
        f"({t_e2e * 1000:.1f} ms for {n} pictures: native parse + device "
        f"decode, picture by picture); device-only {n / t_dev:.3f} fps "
        f"({t_dev * 1000:.1f} ms: the parsed symbols uploaded and decoded); "
        f"the host had issued the last launch at {t_issued * 1000:.1f} ms, "
        f"the device finished {(t_dev - t_issued) * 1000:.1f} ms later; the "
        f"first P picture alone {t_p * 1000:.1f} ms (last launch issued at "
        f"{t_p_issued * 1000:.1f} ms), {n_kernels} kernel launches")
    say_idct_shapes("phase 12", card, shapes)

    inter = {"launches_h264_inter": launches}
    for key, (_, k_ms, p_ms, bound) in shapes.items():
        inter.update({f"ms_inter_{key}": k_ms, f"plain_ms_inter_{key}": p_ms,
                      f"bound_ms_inter_{key}": bound[0]})
    if idct_rec is None:
        idct_rec = idct_record(shapes, 0, err)
    idct_rec.update(inter)
    idct_rec["launches"] += launches
    idct_rec["max_abs_err"] = max(idct_rec["max_abs_err"], err)
    figures = {"slice": "h264 1080p P stream decode", "pictures": n,
               "e2e_fps": n / t_e2e, "device_fps": n / t_dev,
               "device_only_issued_ms": t_issued * 1000,
               "device_only_wall_ms": t_dev * 1000,
               "first_p_ms": t_p * 1000,
               "first_p_issued_ms": t_p_issued * 1000,
               "first_p_kernel_launches": n_kernels,
               "intra_steps_walked": walked,
               "intra_steps_skipped": steps - walked, "card": card}
    return idct_rec, figures


def run_session(codec, stream, step=1 << 20):
    """Decode stream with DecoderSession(codec) on the card as bench.py's
    session figures do: fed in chunks of step bytes, frames taken with
    get_frame_device as they come, EOF, the rest taken, then a sync.
    Returns (the frames, seconds, the frames_device delta, the stage
    timers' delta in ms)."""
    c0, s0 = counters.get("frames_device"), timers.snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = DecoderSession(codec)
    frames, pos = [], 0

    def drain():
        while (fr := sess.get_frame_device()) is not None:
            frames.append(fr)

    while pos < len(stream):
        pos += sess.input_data(stream[pos:pos + step])
        drain()
    sess.set_eof()
    drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    s1 = timers.snapshot()
    stages = {k: round((v - s0.get(k, 0)) * 1000, 1) for k, v in s1.items()
              if v - s0.get(k, 0) > 1e-4}
    return frames, dt, int(counters.get("frames_device") - c0), stages


def check_session_frames(frames, digests, dev, what):
    check(len(frames) == len(digests), f"{what}: {len(frames)} frames, "
                                       f"{len(digests)} digests")
    check(all(isinstance(p, torch.Tensor) and p.device == dev
              and p.dtype == torch.uint8 for f in frames for p in f),
          f"{what}: frames not uint8 tensors on the card")
    check_digests([torch.stack([f[k] for f in frames]) for k in range(3)],
                  digests, what)


def session_h264_path(dev, card):
    """Phase 13. Returns the dequant_idct launches and the figures."""
    stream = h264_session_stream()
    n = H264_SESSION_PICTURES
    digests = fixture_digests(H264_INTER_DIGESTS)[:n]
    reset_counts()
    frames, dt, n_dev, stages = run_session(Codec.H264, stream)
    launches = ID.LAUNCHES
    check(HW.LAUNCHES == 0, "hevc_walk launched on the H.264 session")
    check(n_dev == n, f"{n_dev} of {n} pictures decoded on the device")
    check(launches == 2 * n, f"{launches} dequant_idct launches for {n} "
                             f"pictures, want 2 each")
    check_session_frames(frames, digests, dev, "h264 session")
    h, w = frames[0][0].shape
    say(f"phase 13 [{card}]: H.264 session, {n} pictures {w}x{h} (IDR + "
        f"{n - 1} P) in 1 MiB chunks: {n / dt:.3f} fps end to end "
        f"({dt * 1000:.1f} ms), frames_device {n_dev}, dequant_idct "
        f"launched {launches} times; all {3 * n} planes match the "
        f"libavcodec SHA-256 digests; stage timers (host issue, ms) "
        f"{stages}")
    return launches, {"slice": "h264 1080p session", "pictures": n,
                      "e2e_fps": n / dt, "wall_ms": dt * 1000,
                      "frames_device": n_dev, "dequant_idct_launches":
                      launches, "stages_ms": stages, "card": card}


def session_hevc_path(dev, card):
    """Phase 14. Returns the hevc_walk launches and the figures."""
    figures, total = [], 0
    for what, path, digests in (
            ("inter", INTER_FIXTURE, fixture_digests(INTER_DIGESTS)),
            ("intra", FIXTURE, fixture_digests())):
        with open(path, "rb") as f:
            stream = f.read()
        n = len(digests)
        reset_counts()
        frames, dt, n_dev, stages = run_session(Codec.HEVC, stream)
        launches = HW.LAUNCHES
        total += launches
        check(ID.LAUNCHES == 0, "dequant_idct launched on the HEVC session")
        check(n_dev == n, f"hevc {what}: {n_dev} of {n} pictures decoded "
                          f"on the device")
        check(launches > 0, f"hevc {what}: hevc_walk never launched")
        check_session_frames(frames, digests, dev, f"hevc {what} session")
        h, w = frames[0][0].shape
        say(f"phase 14 [{card}]: HEVC session, {what} fixture, {n} pictures "
            f"{w}x{h} in 1 MiB chunks: {n / dt:.2f} fps end to end "
            f"({dt * 1000:.1f} ms), frames_device {n_dev}, hevc_walk "
            f"launched {launches} times; all {3 * n} planes match the "
            f"libavcodec SHA-256 digests; stage timers (host issue, ms) "
            f"{stages}")
        figures.append({"slice": f"hevc 1080p {what} session",
                        "pictures": n, "e2e_fps": n / dt,
                        "wall_ms": dt * 1000, "frames_device": n_dev,
                        "walk_launches": launches, "stages_ms": stages,
                        "card": card})
    return total, figures


def session_small_streams(card):
    """Phase 15. Returns the dequant_idct launches and the figures."""
    reset_counts()
    paths = {}
    for name, (n_dev_want, n_host_want) in SESSION_FIXTURES.items():
        stream, digests = session_fixture(name)
        frames, n = session_decode(stream)
        n_dev = n["frames_device"]
        dropped = n["corrupt_chunks"] + n["unsupported_pictures"]
        check(n_dev == n_dev_want and len(frames) == n_dev_want + n_host_want
              and not dropped, f"{name}: {n_dev} pictures on the device, "
                               f"{len(frames)} in all, {dropped} dropped")
        check_digests([np.stack([f[k] for f in frames]) for k in range(3)],
                      digests, name)
        paths[name] = (n_dev, len(frames) - n_dev)
    launches = ID.LAUNCHES
    check(HW.LAUNCHES == 0, "hevc_walk launched on the H.264 session")
    check(launches == 2 * sum(d for d, _ in paths.values()),
          f"{launches} dequant_idct launches for the small streams")
    stream, digests = session_fixture(CORPUS_FIXTURE)
    outcomes = []
    logger.setLevel(logging.ERROR)       # a dropped picture warns
    for data in session_corpus(stream):
        frames, n = session_decode(data)
        check(len(frames) in (2, 3), f"corpus: {len(frames)} frames")
        check_digests([np.stack([frames[i][k] for i in (0, -1)])
                       for k in range(3)], [digests[0], digests[2]],
                      "corpus")
        outcomes.append((len(frames), n["corrupt_chunks"]))
    p_outcomes = {name: session_p_corpus(name) for name in P_CORPUS_FIXTURES}
    say(f"phase 15 [{card}]: session fixtures (pictures on the device, on "
        f"the host) {paths}, every plane matches its libavcodec digest; "
        f"dequant_idct launched {launches} times; bit-flip corpus of "
        f"{len(outcomes)} trials at 96x64 (frames out, corrupt pictures "
        f"dropped) {outcomes}: no exception, no CUDA error, pictures 1 and "
        f"3 bit-exact; on the I + P streams (frames out, corrupt pictures "
        f"dropped) {p_outcomes}: the flipped P picture decoded on the "
        f"device where it parses, frames and counts equal to the CPU "
        f"session's, picture 1 bit-exact")
    return launches, {"slice": "session small streams and corpus",
                      "paths": paths, "corpus": outcomes,
                      "p_corpus": p_outcomes, "card": card}


def session_decode(data, device=None, codec=Codec.H264):
    """data through DecoderSession(codec, device=device): the frames as
    numpy planes and the session counters' deltas."""
    keys = ("frames_device", "corrupt_chunks", "unsupported_pictures")
    c0 = counters.snapshot()
    sess = DecoderSession(codec, device=device)
    sess.input_data(data)
    sess.set_eof()
    frames = []
    while (fr := sess.get_frame()) is not None:
        frames.append(fr)
    torch.cuda.synchronize()               # raises on a CUDA error
    c1 = counters.snapshot()
    return frames, {k: int(c1.get(k, 0) - c0.get(k, 0)) for k in keys}


def session_p_corpus(name):
    """Phase 15's corpus on an I + P stream: each trial on the card against
    the same session on the CPU. Returns [(frames out, corrupt dropped)]."""
    stream, digests = session_fixture(name)
    outcomes = []
    for trial, data in enumerate(session_corpus(stream)):
        frames, n = session_decode(data)
        want, wn = session_decode(data, "cpu")
        what = f"{name} corpus trial {trial}"
        check(n == wn, f"{what}: counts {n} on the card, {wn} on the CPU")
        check(n["corrupt_chunks"] == (0 if trial in P_CORPUS_FIXTURES[name]
                                      else 1)
              and len(frames) == n["frames_device"],
              f"{what}: {n}, {len(frames)} frames")
        check(len(frames) == len(want) and all(
            np.array_equal(a, b) for f, g in zip(frames, want)
            for a, b in zip(f, g)), f"{what}: frames differ from the CPU's")
        check_digests([np.stack([frames[0][k]]) for k in range(3)],
                      digests[:1], what)
        outcomes.append((len(frames), n["corrupt_chunks"]))
    return outcomes


def hevc_cuqp_path(dev, card):
    """Phase 16. Returns the hevc_walk launches and the figures."""
    stream = cuqp_fixture_stream()
    digests = fixture_digests(CUQP_DIGESTS)
    n = len(digests)
    plans = []
    call = DeviceRecon.__call__

    def recording(self, plan, ref_pixels):
        plans.append(plan)
        return call(self, plan, ref_pixels)

    DeviceRecon.__call__ = recording
    try:
        c0 = counters.snapshot()
        reset_counts()
        frames, dt, n_dev, stages = run_session(Codec.HEVC, stream)
        launches = HW.LAUNCHES
        c1 = counters.snapshot()
    finally:
        DeviceRecon.__call__ = call
    n_py = int(c1.get("plans_python", 0) - c0.get("plans_python", 0))
    check(ID.LAUNCHES == 0, "dequant_idct launched on the HEVC session")
    check(n_dev == n == len(plans) and n_py == n,
          f"hevc cuqp: {n_dev} of {n} pictures on the device, {n_py} "
          f"parsed in Python")
    check(all(len(np.unique(p.qp_y)) > 1 for p in plans),
          "hevc cuqp: a picture with one QP")
    taken = sum(sum(y) + sum(c) for y, c in map(HTT.walk_steps, plans))
    check(launches == taken, f"hevc cuqp: {launches} walk launches, "
                             f"{taken} scan steps with a TU")
    check_session_frames(frames, digests, dev, "hevc cuqp session")
    h, w = frames[0][0].shape
    per_pic = {k: round(v / n, 1) for k, v in stages.items()}
    say(f"phase 16 [{card}]: HEVC session, cu_qp_delta fixture, {n} "
        f"pictures {w}x{h} (I + {n - 1} P, luma QP "
        f"{min(int(p.qp_y.min()) for p in plans)}-"
        f"{max(int(p.qp_y.max()) for p in plans)}) in 1 MiB chunks: every "
        f"picture parsed in Python and decoded on the device; {n / dt:.3f} "
        f"fps end to end ({dt * 1000:.1f} ms), hevc_walk launched "
        f"{launches} times (once per scan step with a TU); all {3 * n} "
        f"planes match the libavcodec SHA-256 digests; stage timers per "
        f"picture (ms; host_parse the Python parse, device_recon the "
        f"host's issue) {per_pic}")
    return launches, {"slice": "hevc 1080p cu_qp_delta session",
                      "pictures": n, "e2e_fps": n / dt,
                      "wall_ms": dt * 1000, "frames_device": n_dev,
                      "plans_python": n_py, "walk_launches": launches,
                      "stages_ms_per_picture": per_pic, "card": card}


def hevc_host_streams(card):
    """Phase 17. Returns the hevc_walk launches and the figures."""
    reset_counts()
    paths, t0 = {}, time.perf_counter()
    plans = []
    call = DeviceRecon.__call__

    def recording(self, plan, ref_pixels):
        plans.append(plan)
        return call(self, plan, ref_pixels)

    DeviceRecon.__call__ = recording
    try:
        for name, want in HEVC_HOST_FIXTURES.items():
            stream, digests = session_fixture(name, ".h265")
            c0 = counters.get("frames_host")
            frames, n = session_decode(stream, codec=Codec.HEVC)
            n_host = int(counters.get("frames_host") - c0)
            dropped = n["corrupt_chunks"] + n["unsupported_pictures"]
            check((n["frames_device"], n_host) == want
                  and len(frames) == sum(want) and not dropped,
                  f"{name}: {n['frames_device']} pictures on the device, "
                  f"{n_host} on the host, {len(frames)} in all, {dropped} "
                  f"dropped; want {want}")
            check_digests([np.stack([f[k] for f in frames])
                           for k in range(3)], digests, name)
            paths[name] = (n["frames_device"], n_host)
        launches = HW.LAUNCHES
    finally:
        DeviceRecon.__call__ = call
    check(ID.LAUNCHES == 0, "dequant_idct launched on the HEVC session")
    taken = sum(sum(y) + sum(c) for y, c in map(HTT.walk_steps, plans))
    check(launches == taken and launches > 0,
          f"host-route fixtures: {launches} walk launches, {taken} scan "
          f"steps with a TU in the plans the card took")
    dt = time.perf_counter() - t0
    say(f"phase 17 [{card}]: HEVC host-route fixtures (pictures on the "
        f"device, on the host) {paths}, as the CPU tests assert; every "
        f"plane matches its libavcodec digest; hevc_walk launched "
        f"{launches} times (once per scan step with a TU); {dt:.1f} s")
    return launches, {"slice": "hevc host-route small streams",
                      "paths": paths, "walk_launches": launches,
                      "wall_s": dt, "card": card}


def hevc_host_path(dev, card, walk_rec):
    """Phases 16-17: add their launches to the hevc_walk record."""
    launches_16, fig16 = hevc_cuqp_path(dev, card)
    say(json.dumps(fig16))
    torch.cuda.empty_cache()
    launches_17, fig17 = hevc_host_streams(card)
    say(json.dumps(fig17))
    if walk_rec is not None:
        walk_rec["launches_hevc_host"] = launches_16 + launches_17
        walk_rec["launches"] += launches_16 + launches_17


def session_path(dev, card, walk_rec, idct_rec):
    """Phases 13-15: add the session's launches to the kernels' records."""
    idct_13, fig13 = session_h264_path(dev, card)
    say(json.dumps(fig13))
    torch.cuda.empty_cache()
    walk_14, fig14 = session_hevc_path(dev, card)
    for fig in fig14:
        say(json.dumps(fig))
    torch.cuda.empty_cache()
    idct_15, fig15 = session_small_streams(card)
    say(json.dumps(fig15))
    for rec, n in ((walk_rec, walk_14), (idct_rec, idct_13 + idct_15)):
        if rec is not None:
            rec["launches_session"] = n
            rec["launches"] += n


ENC_STAGES = ("enc_idr", "enc_search", "enc_pull", "enc_pack", "enc_recon")


def drain_packets(sess, packets):
    while (p := sess.output_bitstream()) is not None:
        packets.append(p)


def staged_p_frame(enc, frame, qp, stages):
    """One more P frame through enc (after the stream is done) with a
    synchronise around each of RT's stages (names): the frame's wall and
    each stage's."""
    walls, saved = {}, {n: getattr(RT, n) for n in stages}
    try:
        for n in stages:
            setattr(RT, n, _staged(n, saved[n], walls))
        t_p, _ = sync_time(lambda: enc.encode_p(*frame, qp=qp), 1)
    finally:
        for n in stages:
            setattr(RT, n, saved[n])
    return t_p, walls


def encode_session_path(dev, card):
    """Phase 18. Returns the dequant_idct launches, its shapes and error
    at the P frame's, and the figures."""
    fx = encode_fixture()
    frames = encode_fixture_frames()
    raws = [Y.tobytes() + U.tobytes() + V.tobytes() for Y, U, V in frames]
    reset_counts()
    sess = EncoderSession(EncoderParams())
    enc = sess._enc
    check(isinstance(enc, DeviceH264Encoder) and enc.device == dev,
          f"engine {type(enc).__name__}, not the device encoder on the card")
    packets, per_frame, recons = [], [], []
    for i, raw in enumerate(raws):
        s0, n0 = timers.snapshot(), ID.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.encode_frame(raw, PixFmt.I420)
        drain_packets(sess, packets)
        t_ret = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t0
        s1 = timers.snapshot()
        st = {k: (s1.get(k, 0) - s0.get(k, 0)) * 1000 for k in ENC_STAGES
              if s1.get(k, 0) > s0.get(k, 0)}
        check(all(p.device == dev and p.dtype == torch.int32
                  for p in enc._dev_ref), f"frame {i}: reference planes "
                                          f"not on the card")
        per_frame.append({"frame": i, "wall_ms": t_all * 1000,
                          "returned_ms": t_ret * 1000, "stages_ms": st,
                          "dequant_idct_launches": ID.LAUNCHES - n0})
        recons.append(enc.recon_cropped())
    sess.set_eof()
    drain_packets(sess, packets)
    launches = ID.LAUNCHES
    check(HW.LAUNCHES == 0, "hevc_walk launched by the encoder")
    n_p = sum(1 for _, k in packets if not k)
    check(launches == 2 * n_p and all(
        f["dequant_idct_launches"] == (2 if f["frame"] else 0)
        for f in per_frame), f"{launches} dequant_idct launches for "
                             f"{n_p} P frames, want 2 each")
    stream = b"".join(b for b, _ in packets)
    sha = hashlib.sha256(stream).hexdigest()
    check({"sha256": sha, "length": len(stream)} == fx["stream"],
          f"stream {sha} ({len(stream)} bytes) is not the fixture's "
          f"{fx['stream']}")
    check([k for _, k in packets] == fx["keyframes"],
          f"keyframe flags {[k for _, k in packets]}")
    mbs = enc.mbw * enc.mbh

    # the stream through the port's decoder on the card
    decoded = decode_h264(stream, dev)
    torch.cuda.synchronize()
    check_digests([torch.stack([f[k] for f in decoded]) for k in range(3)],
                  fx["frames"], "encoded stream")
    for i, (f, r) in enumerate(zip(decoded, recons)):
        for k in range(3):
            check(np.array_equal(f[k].cpu().numpy(), r[k]),
                  f"frame {i} {'YUV'[k]}: decode != the encoder's recon")
    del decoded

    # dequant_idct at the P frame's shapes, on its symbols as parsed
    pics = list(parse_h264(stream))
    shapes, err = idct_shapes(RC.stack_symbols([pics[-1][0]], dev))

    # the search and transform alone (synchronised) on the last P frame's
    # source and qp against the current reference, and the copy down alone
    qp = int(pics[-1][0].qp[0, 0])
    src = [torch.from_numpy(enc._pad(np.asarray(p, np.int32), c=k > 0))
           .to(dev) for k, p in enumerate(frames[-1])]
    qpc = int(ET.T.chroma_qp(qp, enc.pps.chroma_qp_index_offset))
    lam = max(1, 1 << max(0, (qp - 12) // 6))
    search = lambda: ET.encode_p_frame(ET.SEARCH_RANGE, *src,
                                       *enc._dev_ref, qp, qpc, qpc, lam)
    search()
    t_search, _ = sync_time(search, REPS)
    out = search()[:4]
    torch.cuda.synchronize()
    t_pull, _ = sync_time(lambda: torch.cat(
        [p.reshape(-1) for p in out]).cpu(), REPS)
    del out

    # one more P frame: the deblock scan's share (a synchronise around
    # each recon stage), then its launches under torch.profiler
    stages = ("_residuals", "_mc_luma_batched", "_mc_chroma_batched",
              "_bs_planes", "_intra_tile_scan", "_deblock_tile_scan")
    t_p, walls = staged_p_frame(enc, frames[-1], qp, stages)
    n_kernels, busy = kernel_busy(lambda: enc.encode_p(*frames[-1], qp=qp))
    share = walls["_deblock_tile_scan"] / t_p
    steady = per_frame[2]["wall_ms"]
    say(f"phase 18 [{card}]: EncoderSession(EncoderParams()) on the card, "
        f"{len(frames)} frames {enc.cfg.width}x{enc.cfg.height} I420 "
        f"(1080p30, 2 Mb/s VBR, GOP 30): stream {len(stream)} bytes = the "
        f"fixture's SHA-256, keyframes {[k for _, k in packets]}; the "
        f"port's decode_h264 on the card equals the libavcodec digests and "
        f"the encoder's recon, plane by plane; dequant_idct launched "
        f"{launches} times (2 a P frame)")
    for f in per_frame:
        st = f["stages_ms"]
        pack = st.get("enc_pack")
        say(f"phase 18 [{card}]: frame {f['frame']}: {f['wall_ms']:.1f} ms "
            f"(returned at {f['returned_ms']:.1f} ms); stages (ms) "
            + ", ".join(f"{k} {v:.1f}" for k, v in st.items())
            + (f"; host pack {pack / mbs:.4f} ms a macroblock"
               if pack else ""))
    say(f"phase 18 [{card}]: steady-state P (frame 2, as bench_encode "
        f"takes it) {1000 / steady:.3f} fps; host IDR "
        f"{per_frame[0]['stages_ms']['enc_idr'] / 1000:.1f} s; search + "
        f"transform alone {t_search * 1000:.1f} ms (synchronised, median "
        f"of {REPS}), its pull alone {t_pull * 1000:.2f} ms; a further P "
        f"frame with a synchronise around each recon stage "
        f"{t_p * 1000:.1f} ms: " + ", ".join(
            f"{n} {walls.get(n, 0.0) * 1000:.1f} ms" for n in stages)
        + f"; deblock scan {100 * share:.1f}% of the frame; under "
        f"torch.profiler a P frame launches {n_kernels} kernels and keeps "
        f"the device busy {busy:.1f} ms (the search + transform's "
        f"{t_search * 1000:.1f} ms of it; the rest the recon's)")
    say_idct_shapes("phase 18", card, shapes)
    figures = {"slice": "h264 1080p encode session (device engine)",
               "frames": len(frames), "bytes": len(stream),
               "steady_p_fps": 1000 / steady,
               "idr_host_s": per_frame[0]["stages_ms"]["enc_idr"] / 1000,
               "per_frame": per_frame, "search_ms": t_search * 1000,
               "pull_ms": t_pull * 1000,
               "pack_ms_per_mb": per_frame[2]["stages_ms"]["enc_pack"] / mbs,
               "staged_p_ms": t_p * 1000,
               "staged_stage_ms": {n: walls.get(n, 0.0) * 1000
                                   for n in stages},
               "deblock_share": share, "p_frame_kernel_launches": n_kernels,
               "p_frame_device_busy_ms": busy,
               "dequant_idct_launches": launches, "card": card}
    return launches, shapes, err, figures


def encode_small_sessions(card):
    """Phase 19. Returns the dequant_idct launches and the figures."""
    t0, runs, launches = time.perf_counter(), {}, 0
    for name, (kw, n) in ENCODE_SESSIONS.items():
        got = []
        for device in (None, "cpu"):
            reset_counts()
            sess = EncoderSession(EncoderParams(**kw), device=device)
            packets = []
            for f in pan_frames(kw["width"], kw["height"], n):
                sess.encode_frame(f)
                drain_packets(sess, packets)
            sess.set_eof()
            drain_packets(sess, packets)
            got.append(packets)
            if device is None:
                torch.cuda.synchronize()
                launches += ID.LAUNCHES
        check(got[0] == got[1], f"{name}: the card's packets differ from "
                                f"the CPU's")
        keys = [k for _, k in got[0]]
        check(keys == [i % kw["gop_len"] == 0 for i in range(n)],
              f"{name}: keyframes {keys}")
        runs[name] = {"frames": n, "keyframes": keys,
                      "bytes": sum(len(b) for b, _ in got[0])}
    want = 2 * sum(sum(not k for k in r["keyframes"]) for r in runs.values())
    check(launches == want, f"{launches} dequant_idct launches, want {want}")
    dt = time.perf_counter() - t0
    say(f"phase 19 [{card}]: small encoder sessions with rate control "
        f"(GOPs crossing an IDR) {runs}: packets and keyframe flags on the "
        f"card equal the CPU session's; dequant_idct launched {launches} "
        f"times (2 a P frame); {dt:.1f} s")
    return launches, {"slice": "h264 small encode sessions", "runs": runs,
                      "dequant_idct_launches": launches, "wall_s": dt,
                      "card": card}


def encode_path(dev, card, idct_rec, err):
    """Phases 18-19 (err: phase 6's). Returns the dequant_idct record
    (idct_rec with the encoder's launches and shapes added, or a record
    of this path alone when no decode path was driven)."""
    launches_18, shapes, e, fig18 = encode_session_path(dev, card)
    say(json.dumps(fig18))
    torch.cuda.empty_cache()
    launches_19, fig19 = encode_small_sessions(card)
    say(json.dumps(fig19))
    err = max(err, e)
    enc = {"launches_encode": launches_18 + launches_19}
    for key, (_, k_ms, p_ms, bound) in shapes.items():
        enc.update({f"ms_encode_{key}": k_ms, f"plain_ms_encode_{key}": p_ms,
                    f"bound_ms_encode_{key}": bound[0]})
    if idct_rec is None:
        idct_rec = idct_record(shapes, 0, err)
    idct_rec.update(enc)
    idct_rec["launches"] += launches_18 + launches_19
    idct_rec["max_abs_err"] = max(idct_rec["max_abs_err"], err)
    return idct_rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("hevc", "h264", "hevc_inter",
                                       "h264_inter", "session",
                                       "hevc_host", "encode"),
                    help="drive one path only (no complete kernels' record)")
    only = ap.parse_args().only
    t_start = time.perf_counter()
    dev = require_cuda()
    card = gpu_name_power()
    say(card)
    say(f"phase 1: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = _build.build(force=True)
    ptxas = [ln.strip() for ln in _build.last_log.splitlines()
             if "registers" in ln or "spill" in ln]
    say(f"phase 2: built {os.path.relpath(lib, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s; " + " | ".join(ptxas))

    walk_rec, idct_rec = None, None
    if only in (None, "hevc", "hevc_inter", "session", "hevc_host"):
        walk_err = check_walk_shapes(dev)
    if only in (None, "hevc"):
        walk_rec, fig = hevc_path(dev, card, walk_err)
        say(json.dumps(fig))
        torch.cuda.empty_cache()
    if only in (None, "h264", "h264_inter", "session", "encode"):
        idct_err = check_idct_kernel(dev)
    if only in (None, "h264"):
        idct_rec, fig = h264_path(dev, card, idct_err)
        say(json.dumps(fig))
        torch.cuda.empty_cache()
    if only in (None, "hevc_inter"):
        walk_rec, fig = hevc_inter_path(dev, card, walk_rec, walk_err)
        say(json.dumps(fig))
        torch.cuda.empty_cache()
    if only in (None, "h264_inter"):
        idct_rec, fig = h264_inter_path(dev, card, idct_rec, idct_err)
        say(json.dumps(fig))
        torch.cuda.empty_cache()
    if only in (None, "session"):
        session_path(dev, card, walk_rec, idct_rec)
        torch.cuda.empty_cache()
    if only in (None, "hevc_host"):
        hevc_host_path(dev, card, walk_rec)
        torch.cuda.empty_cache()
    if only in (None, "encode"):
        idct_rec = encode_path(dev, card, idct_rec, idct_err)
    recs = [r for r in (walk_rec, idct_rec) if r is not None]
    say(f"smoke: {time.perf_counter() - t_start:.1f} s in all, the "
        f"kernels' build included")
    say(json.dumps({"kernels": recs}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
