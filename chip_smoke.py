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
CAVLC pack, the reconstruction through the P decode); then the parallel
layer at world size 1 (a one-rank NCCL group: the sharded H.264 decode
and transcode step, the two-stage HEVC pipeline, the row-sharded decode)
and the CLI tools (jmx_decode, jmx_transcode with its resume) and
device_trace. Every kernel launch count is set to 0 just before a path is
driven and read just after.
Phases, one line each; any failure raises and the exit code is
non-zero:

  1. the card's name and power limit (nvidia-smi)
  2. build the CUDA kernels from jmcodec_tpu_torch/csrc
  3. the hevc_walk kernel against walk_reference, bit for bit, on seeded
     synthetic states at both of the slice's shapes: the usual ones (every
     TU size, all 35 modes, the strong filter) and the hard ones (all-4x4
     lanes, lanes without a TU, z-scan Z, unavailable border patches,
     residuals at the int16 extremes), also for one lane and an odd count
  4. decode the fixture on the card: the hevc_scan kernel launched twice
     (one persistent launch a scan: luma, then Cb + Cr), hevc_walk never
     (its device code runs inside hevc_scan), every frame/plane equal to
     the committed libavcodec SHA-256 digests, and equal to the same batch
     decoded on the plain route (the torch scan with walk_reference a
     step), each scan's planes to that route's scan
  5. timing (median of 3 after a warm-up): end-to-end fps; device-only
     fps, with the time at which the host had issued the decode's last
     launch (a device that finishes long after it is the bound, one that
     finishes just after it waited on the host), the decode's kernel
     launches and device busy time (torch.profiler); each hevc_scan
     launch (against the plain scan, bit for bit): its device time (the
     median of 3 profiler runs) against its bound; its chain in
     dependency levels, with the same chain walked in z-order and the
     plane's TU critical path in TUs (tools/hevc_scan_chain.py on the
     launch's cell maps), the time of one level and of one CTB of the
     chain; its lanes against the CTAs the card holds at once; the plain
     scan's wall (phase 4's) and the walks alone of the torch scan (the
     steps x the walk kernel's step time);
     then, on the torch scan's route (one
     hevc_walk launch a step), the walk kernel against walk_reference at
     the middle scan step, with that step's active TUs per lane and the
     kernel's cycles per active TU of its longest lane, and the kernel's
     time at every scan step
  6. the dequant_idct kernel against dequant_idct_reference, bit for bit,
     on seeded inputs: N = 700 and N = 1, every qp 0..51, levels over the
     full int16 range, with and without the DC splice, int16 and int32
  7. decode the H.264 fixture on the card: the dequant_idct kernel launched
     twice (luma, both chroma planes), the h264_intra and h264_deblock
     kernels once each (the whole batch's scan in one launch), every
     frame/plane equal to the committed libavcodec SHA-256 digests, and
     equal to the same batch decoded with dequant_idct_reference
  8. timing of the H.264 path as in phase 5, the batch decode's kernel
     launches and device busy time (torch.profiler), and the dequant_idct
     kernel against dequant_idct_reference at the path's two shapes
  9. decode the HEVC inter fixture on the card (decode_hevc): hevc_scan
     launched twice a picture, hevc_walk never, all 48 planes in output
     order equal to the committed libavcodec SHA-256 digests
 10. timing of the inter path (median of 3): end-to-end fps (native parse
     + device decode, picture by picture in decode order); device-only fps
     (the plans the parse recorded, replayed through the device decode
     with its pyramid cache), with the time at which the host had issued
     the last launch; kernel launches per picture and the device's busy
     time (one replay under torch.profiler); the first P picture's two
     hevc_scan launches against scan_reference, as phase 5 times the
     intra batch's (bit for bit, device ms, chain, lanes,
     plain wall, bound); its four hevc_resid launches (inter luma and Cb +
     Cr, then intra), each against planes_reference and timed as phase 30
     times the batch's; and the walk kernel against walk_reference at the
     middle scan step of that picture on the torch scan's route
 11. decode the H.264 P fixture on the card (decode_h264): the
     dequant_idct kernel launched twice per picture, h264_intra once a
     picture that holds an intra macroblock (the IDR, a P picture with a
     walked diagonal), h264_deblock once a picture, all 15 planes equal
     to the committed libavcodec SHA-256 digests; per picture the intra
     scan's diagonals walked and skipped
 12. timing of the H.264 P path over the IDR and the first two P
     pictures (one run each, REPS_H264_P; phase 11's decode is the
     warm-up): end-to-end fps (native parse + device decode, picture by
     picture); device-only fps (the parsed symbols replayed through
     decode_symbols), with the time at which the host had
     issued the last launch; the kernel launches of the first P picture
     (one decode under torch.profiler; under 2,000) and its device busy
     time; and the dequant_idct kernel against dequant_idct_reference at
     the P picture's two shapes
 13. the H.264 session at 1080p: DecoderSession() fed the first three
     pictures of the H.264 P fixture (IDR + 2 P) in 1 MiB chunks, frames
     taken with get_frame_device as bench.py's session figures take them;
     all three decoded on the device (frames_device), dequant_idct
     launched twice a picture, all 9 planes equal to the libavcodec
     digests; end-to-end fps (one run) and the session's stage timers
 14. the HEVC session at 1080p: the HEVC inter fixture (16 pictures), then
     the HEVC all-intra fixture (2 pictures), the same way; every picture
     decoded on the device, every plane equal to its digest; fps and
     hevc_scan launches of each (two a picture)
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
     (frames_device), hevc_scan launched twice a picture, all 9 planes
     equal to the libavcodec digests; end-to-end
     fps and the stage timers per picture (host_parse: the Python parse;
     device_recon: the host's issue of the device decode)
 17. the small HEVC host-route fixtures through DecoderSession() (cu_qp_
     delta I, P and B; two slices a picture; transform skip; motion past
     the MC pad; five references): every plane equal to its digest, as
     many pictures on the device (frames_device) and on the host
     (frames_host) as the CPU tests assert, hevc_scan twice a picture on
     the card

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

 20. the sharded H.264 decode at world size 1 (a one-rank NCCL group):
     decode_symbols_sharded of phase 7's batch of 32, dequant_idct launched
     twice, every plane equal to the libavcodec digests and to the
     dequant_idct_reference decode; make_transcode_real_step on that batch
     (the decode, the all_gather row-band reshard, the halo downscale, the
     forward pass, the all_reduce of bits and ssd), dequant_idct twice, its
     levels, bits and ssd equal to the same step's arithmetic on CPU
     tensors of the card's frames; the fps (with the upload, the gather
     and the copy to the host) and a step's time, one run each; the
     dequant_idct kernel against dequant_idct_reference at the batch's
     shapes
 21. decode_plans_pipelined on phase 4's batch of 16 as two batches of 8
     with its default devices (one card: scan and filters on it, each
     stage on a stream of its own): hevc_scan launched twice a batch,
     every plane equal to the digests and to decode_frames_hevc_batch;
     the kernels by stream (profiled) and the fps
 22. the row-sharded decode at sp = 1 of the H.264 P fixture's IDR and
     of its second P picture (the first one's vertical MVs pass the halo
     budget and are refused, as in the reference, which is checked):
     dequant_idct twice a picture, the planes equal to the digests, the
     IDR to the dequant_idct_reference decode
 23. the CLIs on the card: jmx_decode of the HEVC inter fixture (the
     digests; hevc_scan twice a picture); jmx_transcode
     --scale 2 of the first three pictures of the H.264 P fixture (1080p
     to 960x540, one GOP) into the committed SHA-256 of the JAX package's
     transcode with its device engine (tests/data/transcode_1080p.
     sha256.json), dequant_idct twice a decoded picture and twice an
     encoded P frame; a second call resumes and encodes nothing; the GOP's
     wall and the shares of decode, downscale and encode in it
 24. device_trace around a small H.264 and a small HEVC decode: the
     Chrome trace exists and names both kernels' launches

 25. the bench's two batched figures at 1080p through the port's
     tools/bench.py (bench_hevc, bench_h264), one repeat each: the HEVC
     batch of 16 and the H.264 batch of 32, every plane equal to the
     digests, hevc_scan and dequant_idct launched twice each in the
     checked decode; end-to-end and device-only fps (the other four
     figures are timed by phases 12-14 and 18)
 26. jmx_quality --engine device at its default size (320x240), 4 frames,
     the four default QPs: the card's streams equal the committed SHA-256
     of the same tool's streams with --device cpu (tests/data/
     quality_320x240.sha256.json), dequant_idct launched twice a P frame;
     then, where the libavcodec oracle builds and runs here, the tool's
     table and BD-rate against x264 (its streams the digests' again);
     where it does not, one line saying so with make's or ldd's error

 27. the H.264 scan kernels (h264_intra, h264_deblock) against their plain
     versions (recon_tiles._intra_tile_scan, _deblock_tile_scan), bit for
     bit, on the arguments the decode gives them at phase 7's batch of 32
     (the all-intra scans: one bS pattern for every frame) and at phase
     11's first P picture (seeded with its MC tiles, its walk, its per-edge
     bS); per kernel and shape the ms of the scan, its one launch's device
     time in a torch.profiler trace (the median of REPS runs), the time of
     one step of its chain (the scan's ms over its mbw + 2(mbh - 1)
     diagonals) beside the launch floor, the plain version's wall for the
     scan, the bound of the whole scan and the launches a decode. Every
     H.264 path above also checks that both kernels ran (the encoder's P
     frames, all inter macroblocks, walk no intra diagonal and launch no
     intra scan; its device engine deblocks each P frame, one launch a
     frame), and their kernels' records count the launches of every path
     driven

 29. (run with phase 3, before the HEVC paths) the hevc_scan kernel
     against scan_reference, bit for bit, on the seeded planes
     of tools/fixtures.synth_scan_planes (synth_state_hard's kinds laid
     over whole planes: all-4x4 CTBs, CTBs without a TU, int16-extreme
     residuals and bases, z-scan Z, isolated CTBs, a partial right
     column) at CTU 64, 32 and 16, luma and Cb + Cr, with and without an
     inter base; on all-4x4 planes, 32x32 TUs under the strong filter and
     random TU maps and Z (overlapping TUs); then on more lanes than the
     card holds CTAs of the kernel at once. Every HEVC path checks that
     each scan was one hevc_scan launch and that hevc_walk was not
     launched; hevc_scan's
     record counts the launches of every path driven, hevc_walk's record
     (its times from phases 5 and 10, on the torch scan's route) none
 30. (run after phase 29, before the HEVC paths) the hevc_resid kernel
     (the residual stage: dequantisation and inverse DCT/DST, a TU at a
     time) against planes_reference (residual_reference, the float64
     GEMMs of every size), bit for bit, on the seeded planes of
     tools/fixtures.synth_resid_planes (every QP 0..51, levels at the
     int16 extremes, all-zero blocks, random per-cell TU maps whose
     blocks overlap, cells outside `sizes`): intra luma (the DST), inter
     luma, Cb + Cr with per-frame offsets (also on 48x80 planes, whose
     last areas lie half outside), maps of one TU size, levels all
     zero, a map without a TU; then at the main path's shapes, the 1080p
     batch of 16's luma planes and its Cb + Cr, as stack_plans gives them:
     each launch's ms by CUDA events (the median of REPS runs of
     RESID_RUN launches after a warm-up), with the profiler's device time
     of one launch beside it, against its bound and against the plain
     stage's device busy time; then the luma launch on maps and levels
     derived from the batch's that isolate one kind of work (without its
     32x32 TUs, with only those, with no zero level so that no block is
     DC-only, one TU size everywhere on dense seeded levels), each bit
     for bit and timed the same way. Every HEVC
     path checks that the residual stage was hevc_resid (one launch for
     the luma planes and one for Cb + Cr a decode_frames_hevc_scan, two
     more a picture for an inter picture's residuals) and that
     residual_reference did not run; hevc_resid's record counts the
     launches of every path driven

With --sp N (N > 1; needs N cards) only phases 1-2 and this one run:

 28. the row-sharded decode of phase 22 at sp = N, one process and card a
     rank (N NCCL ranks, parallel/distributed.launch): the H.264 P
     fixture's IDR and its second P picture, each rank's band through both
     scan kernels with the lane above it exchanged as a halo; on every
     rank all 6 planes equal the libavcodec digests, h264_intra launched
     once a walked diagonal and h264_deblock once a diagonal, dequant_idct
     twice a picture, no lane roll of the torch scans; each rank's walls

With --only hevc, --only h264, --only hevc_inter, --only h264_inter,
--only session, --only hevc_host, --only encode, --only parallel,
--only tools, --only bench, --only quality, --only h264_scan (phase 27
alone) or --only resid (phase 30 alone) just that path is driven
(phase 3 with either HEVC path, the session, the host route, the parallel
layer, the tools and the bench, phase 6 with either H.264 path, the
session, the encoder, the parallel layer, the tools, the bench and the
quality tool; for work on one kernel or path, the run then prints no
kernels' record that is complete).

Each kernel's record also carries the least time the card could take for
its launch (bound_ms): the larger of its bytes (each input read once, each
output written once) over the HBM rate and its operations, counted from
this run's inputs, over the int32 ALU rate; and launch_floor_ms, the time
an empty kernel (torch.cuda._sleep(0)) takes from launch to completion,
timed as the kernels' ms are (event_ms; the scan kernels' ms are device
times from the profiler, phase 27).

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
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

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
from jmcodec_tpu_torch.kernels import h264_scan as HS
from jmcodec_tpu_torch.kernels import hevc_resid as HR
from jmcodec_tpu_torch.kernels import hevc_scan as HSC
from jmcodec_tpu_torch.kernels import hevc_tables as HT
from jmcodec_tpu_torch.kernels import hevc_tiles as HTT
from jmcodec_tpu_torch.kernels import hevc_walk as HW
from jmcodec_tpu_torch.kernels import idct as ID
from jmcodec_tpu_torch.kernels import recon as RC
from jmcodec_tpu_torch.kernels import recon_tiles as RT
from jmcodec_tpu_torch.parallel.decode_sharded import (
    _synthetic_symbols, decode_symbols_sharded, run_transcode_real_step)
from jmcodec_tpu_torch.parallel.distributed import launch, with_counts
from jmcodec_tpu_torch.parallel.framepp import (decode_plans_pipelined,
                                                default_devices)
from jmcodec_tpu_torch.parallel.mesh import ShardingConfig, build_mesh
from jmcodec_tpu_torch.parallel.spatial import (
    decode_frame_rows_sharded, decode_frame_rows_sharded_inter)
from jmcodec_tpu_torch.parallel.transcode import (_downscale2x_with_halo,
                                                  _encode_forward)
from jmcodec_tpu_torch.tools import bench, jmx_decode, jmx_quality, oracle
from jmcodec_tpu_torch.tools import hevc_scan_chain, jmx_transcode
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
                                              quality_fixture,
                                              quality_streams,
                                              session_corpus,
                                              session_fixture,
                                              synth_idct_blocks,
                                              synth_resid_planes,
                                              synth_scan_planes, synth_state,
                                              synth_state_hard,
                                              synth_state_inter,
                                              transcode_fixture)
from jmcodec_tpu_torch.tools.profile_h264_intra import _staged
from jmcodec_tpu_torch.tools.profiling import raw_events, union_us
from jmcodec_tpu_torch.utils.device import (gpu_name_power, gpu_sm_clock_mhz,
                                            require_cuda)
from jmcodec_tpu_torch.utils.metrics import (counters, device_trace,
                                             logger, timers)

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
    HSC.LAUNCHES = 0
    HR.LAUNCHES = 0
    PLAIN_RESID["runs"] = 0
    ID.LAUNCHES = 0
    HS.INTRA_LAUNCHES = 0
    HS.DEBLOCK_LAUNCHES = 0


# the H.264 scan kernels' launches over every path this run drives (their
# records' "launches")
SCANS = {"h264_intra": 0, "h264_deblock": 0}


def scan_counts(what, intra=">0", deblock=">0"):
    """The H.264 scan kernels' launches since reset_counts(), added to
    SCANS. Each must be the given count, above 0 (">0": a path that
    decodes an H.264 picture on the card runs the kernel), or anything
    ("any": where a path's pictures may or may not hold an intra
    macroblock on the card). Returns (intra, deblock) launches."""
    got = (HS.INTRA_LAUNCHES, HS.DEBLOCK_LAUNCHES)
    for name, n, want in zip(SCANS, got, (intra, deblock)):
        ok = {">0": n > 0, "any": True}.get(want, n == want)
        check(ok, f"{what}: {name} launched {n} times, want {want}")
        SCANS[name] += n
    return got


# hevc_scan's and hevc_resid's launches over every path this run drives
# (their records' "launches"), and by phase
HEVC_SCAN = {"launches": 0, "by_phase": {}}
HEVC_RESID = {"launches": 0, "by_phase": {}}
# runs of hevc_resid.residual_reference since reset_counts() (main()
# counts them): no HEVC path on the card may run the plain residual stage
PLAIN_RESID = {"runs": 0}


def count_plain_residuals():
    """Make hevc_resid.residual_reference count its runs in PLAIN_RESID
    (planes_reference, the plain route, calls it through the module)."""
    plain = HR.residual_reference

    def counted(*a, **kw):
        PLAIN_RESID["runs"] += 1
        return plain(*a, **kw)

    HR.residual_reference = counted


def hevc_scan_counts(what, want, resid=None):
    """hevc_scan's and hevc_resid's launches since reset_counts(), added to
    HEVC_SCAN and HEVC_RESID. hevc_scan's must be `want` (two a
    decode_frames_hevc_scan: luma, then Cb + Cr), hevc_resid's `resid`
    (None: `want`, one for the luma planes and one for Cb + Cr a
    decode_frames_hevc_scan; an inter picture's residuals two more), the
    plain residual stage must not have run, and hevc_walk must not have
    been launched: on every HEVC path the walk runs inside the scan
    kernel. Returns hevc_scan's launches."""
    n, r = HSC.LAUNCHES, HR.LAUNCHES
    resid = want if resid is None else resid
    check(n == want, f"{what}: hevc_scan launched {n} times, want {want}")
    check(r == resid, f"{what}: hevc_resid launched {r} times, want {resid}")
    check(PLAIN_RESID["runs"] == 0,
          f"{what}: residual_reference ran {PLAIN_RESID['runs']} times")
    check(HW.LAUNCHES == 0, f"{what}: hevc_walk launched {HW.LAUNCHES} "
                            f"times, outside hevc_scan")
    HEVC_SCAN["launches"] += n
    HEVC_SCAN["by_phase"][what] = n
    HEVC_RESID["launches"] += r
    HEVC_RESID["by_phase"][what] = r
    return n


def calls_of(mod, name, fn):
    """fn() with mod.<name> (hevc_tiles' scan_planes, hevc_resid's
    resid_planes) recording its arguments: (fn's result, [(args, kwargs),
    ...] of its calls in order)."""
    cap, saved = [], getattr(mod, name)

    def run(*a, **kw):
        cap.append((a, kw))
        return saved(*a, **kw)

    setattr(mod, name, run)
    try:
        out = fn()
    finally:
        setattr(mod, name, saved)
    return out, cap


def hevc_plain_scans(fn):
    """fn() (a decode on the plain route) with each of its torch scans
    (hevc_tiles.scan_torch) timed: (fn's result, [(the scan's planes, its
    wall in ms), ...] in order)."""
    cap, saved = [], HTT.scan_torch

    def run(*a, **kw):
        out, dt = timed(lambda: saved(*a, **kw))
        cap.append((out, dt * 1e3))
        return out

    HTT.scan_torch = run
    try:
        out = fn()
    finally:
        HTT.scan_torch = saved
    return out, cap


def scan_bound(args, kw):
    """Bound of one hevc_scan launch on scan_planes' arguments. Bytes: the
    residual (and base) planes and the three cell maps in, the int32
    planes out. Operations, for the TUs the maps hold (on every plane of a
    map), counted as walk_bound counts them: per TU of size n, 7 per
    reference sample and 8 per predicted pixel."""
    resid, zidx, tu, mode = args
    P, G = resid.shape[0], zidx.shape[0]
    T = min(kw["C"], kw["max_tu"])
    tu_h = tu.cpu().numpy()
    ys, xs = np.indices(tu_h.shape[1:])
    ops = 0
    for v in range(2, T.bit_length()):
        n, n4 = 1 << v, 1 << (v - 2)
        k = int(((tu_h == v) & (ys % n4 == 0) & (xs % n4 == 0)).sum())
        ops += k * (P // G) * (7 * (4 * n + 1) + 8 * n * n)
    nb = nbytes(resid, zidx, tu, mode, kw.get("base")) + 4 * resid.numel()
    return bound_ms(nb, ops)


def scan_chains(args, kw):
    """The chains of one hevc_scan launch in TUs
    (tools/hevc_scan_chain.plane_chains), the longest over its distinct
    cell maps: "zorder" (each CTB's TUs one after another), "levels" (each
    CTB's TUs by dependency level: the kernel's chain) and "plane" (the
    whole plane's TU critical path)."""
    tu, zidx = args[2].cpu().numpy(), args[1].cpu().numpy()
    out, seen = {"zorder": 0, "levels": 0, "plane": 0}, set()
    for g in range(tu.shape[0]):
        digest = hashlib.sha1(tu[g].tobytes() + zidx[g].tobytes()).digest()
        if digest in seen:
            continue
        seen.add(digest)
        r = hevc_scan_chain.plane_chains(tu[g], zidx[g], kw["C"],
                                         kw["max_tu"], kw["skew"])
        out = {k: max(v, r[k]) for k, v in out.items()}
    return out


def scan_figures(args, kw, want, what, plain_ms):
    """One hevc_scan launch of a path against the plain scan's planes
    (want), bit for bit, and its device ms (the median of REPS traced
    launches); the launch's chain (scan_chains), lanes and resident CTAs;
    its bound."""
    f = {"plain_ms": plain_ms, "bound": scan_bound(args, kw)}
    got, f["ms"], f["runs_traced"] = scan_ms(
        lambda: HSC.scan_planes(*args, **kw), "hevc_scan_kernel")
    f["err"] = max_abs(got, want)
    check(f["err"] == 0, f"{what}: hevc_scan != the plain scan")
    P, G = args[0].shape[0], args[1].shape[0]
    ctb_h = args[0].shape[1] // kw["C"]
    f["lanes"] = HSC.lanes(P, G, ctb_h)
    f["ctas"], f["smem"], f["threads"] = HSC.resident_ctas(
        C=kw["C"], skew=kw["skew"], max_tu=kw["max_tu"],
        base=kw.get("base") is not None, planes_per_map=P // G)
    f["chain"] = scan_chains(args, kw)
    return f


def say_scan(head, f, ctbs, extra):
    """A line of scan_figures' figures; ctbs: the scan's chain in CTBs."""
    c = f["chain"]
    waits = (f"; {f['lanes'] - f['ctas']} lanes wait for a CTA"
             if f["lanes"] > f["ctas"] else "")
    say(f"{head}: {f['lanes']} lanes against {f['ctas']} resident CTAs of "
        f"{f['threads']} threads and {f['smem']} B shared memory{waits}; "
        f"kernel {f['ms']:.4f} ms a scan "
        f"({timing_of(f['runs_traced'])}); its chain "
        f"{c['levels']} levels of {ctbs} CTBs ({c['zorder']} TUs walked "
        f"in z-order, {c['plane']} the plane's TU critical path): "
        f"{f['ms'] / max(c['levels'], 1) * 1e3:.3f} us a level, "
        f"{f['ms'] / ctbs * 1e3:.2f} us a CTB{extra}; plain scan "
        f"{f['plain_ms']:.1f} ms (its wall); bound {f['bound'][0]:.5f} ms "
        f"({f['bound'][2]})")


def scan_keys(f, key, ctbs):
    """scan_figures' figures as the hevc_scan record's keys."""
    c = f["chain"]
    return {f"ms_{key}": f["ms"], f"plain_ms_{key}": f["plain_ms"],
            f"bound_ms_{key}": f["bound"][0],
            f"chain_levels_{key}": c["levels"],
            f"chain_zorder_tus_{key}": c["zorder"],
            f"chain_plane_tus_{key}": c["plane"],
            f"level_us_{key}": f["ms"] / max(c["levels"], 1) * 1e3,
            f"step_ms_{key}": f["ms"] / ctbs,
            f"runs_traced_{key}": f["runs_traced"],
            f"lanes_{key}": f["lanes"], f"resident_ctas_{key}": f["ctas"],
            f"smem_bytes_{key}": f["smem"]}


# phase 29's synthetic scans: (luma CTB size, plane, frames, ctb_h, ctb_w,
# inter base)
SCAN_CASES = [(64, "luma", 2, 3, 5, False), (64, "chroma", 2, 3, 5, False),
              (64, "luma", 1, 4, 4, True), (64, "chroma", 1, 4, 4, True),
              (32, "luma", 2, 3, 5, False), (32, "chroma", 3, 3, 4, True),
              (16, "luma", 3, 4, 5, True), (16, "chroma", 2, 4, 5, False)]


def check_scan_planes(dev):
    """Phase 29: hevc_scan == scan_reference, bit for bit, on the seeded
    planes of synth_scan_planes (every CTB kind of synth_state_hard, a
    partial right column) at CTU 64, 32 and 16, luma and Cb + Cr, with
    and without an inter base; on planes of all-4x4 CTBs (the widest
    levels), of 32x32 luma TUs on nearly flat references (the strong
    filter) and of random TU maps and Z (overlapping TUs, cells read before
    a later TU writes them); then on more lanes than the card holds CTAs
    of the kernel at once. Returns the largest error."""
    err, n = 0, 0

    def one(ctu, plane, frames, ctb_h, ctb_w, inter, seed, maps=None):
        C, max_tu = (ctu, 32) if plane == "luma" else (ctu // 2, 16)
        chroma = plane == "chroma"
        arrays = list(synth_scan_planes(C, max_tu, frames * (1 + chroma),
                                        frames, ctb_h, ctb_w, seed=seed,
                                        inter=inter, partial=True))
        if maps is not None:
            maps(arrays, np.random.default_rng(seed), min(C, max_tu))
        t = [None if a is None else torch.from_numpy(a).to(dev)
             for a in arrays]
        kw = dict(C=C, skew=HT.skew_for(ctu), max_tu=max_tu,
                  is_chroma=chroma, strong=not chroma, base=t[4])
        want = HSC.scan_reference(*t[:4], **kw)
        got = HSC.scan_planes(*t[:4], **kw)
        torch.cuda.synchronize()
        e = max_abs(got, want)
        check(e == 0, f"phase 29 CTU {ctu} {plane} x{frames} "
                      f"{'inter' if inter else 'intra'}"
                      f"{'' if maps is None else ' ' + maps.__name__}"
                      f": hevc_scan != scan_reference")
        return e, HSC.lanes(t[0].shape[0], t[1].shape[0], ctb_h)

    def all_4x4(arrays, rng, T):
        arrays[2][:] = 2

    def strong_32x32(arrays, rng, T):
        arrays[2][:] = 0
        arrays[2][:, ::8, ::8] = 5
        arrays[0][:] = rng.integers(-1, 2, arrays[0].shape)

    def random_maps(arrays, rng, T):
        arrays[2][:] = rng.choice(np.array([0, *range(2, T.bit_length())],
                                           np.int32), arrays[2].shape)
        arrays[1][:] = rng.integers(0, 1 << 12, arrays[1].shape)

    for i, case in enumerate(SCAN_CASES):
        e, _ = one(*case, seed=20 + i)
        err, n = max(err, e), n + 1
    for i, (ctu, plane, maps) in enumerate(
            [(64, "luma", all_4x4), (32, "chroma", all_4x4),
             (64, "luma", strong_32x32), (64, "luma", random_maps),
             (32, "chroma", random_maps)]):
        e, _ = one(ctu, plane, 2, 3, 4, False, seed=30 + i, maps=maps)
        err, n = max(err, e), n + 1
    ctas = HSC.resident_ctas(C=8, skew=HT.skew_for(16), max_tu=16,
                             planes_per_map=2)[0]
    e, lanes = one(16, "chroma", ctas // 3 + 1, 3, 2, False, seed=40)
    check(lanes > ctas, f"phase 29: {lanes} lanes, {ctas} resident CTAs")
    err = max(err, e)
    say(f"phase 29: hevc_scan == scan_reference on {n} seeded scans (CTU "
        f"64, 32 and 16; luma and Cb + Cr; 1-3 frames; with and without an "
        f"inter base; all-4x4, no-TU, extreme-residual and isolated CTBs, a "
        f"partial right column; all-4x4 planes, 32x32 TUs under the strong "
        f"filter, random TU maps and Z) and on {lanes} lanes of CTU-16 "
        f"chroma, more than the {ctas} CTAs that fit the card at once; "
        f"max_abs_err {err}")
    return err


# a partial butterfly's inverse transform of n points, a stage (HM's
# partialButterflyInverse4..32; fastInverseDst about as few as the 4-point
# DCT):
# its multiply-adds and its even/odd adds, per output sample, by log2 n
BUTTERFLY_MACS = {2: 2.0, 3: 3.0, 4: 5.5, 5: 10.75}
BUTTERFLY_ADDS = {2: 1.0, 3: 1.5, 4: 1.75, 5: 1.875}


def resid_bound(coeffs, tu, qp_y, offsets, sizes):
    """Bound of one hevc_resid launch. Bytes: the levels, the TU map, the
    QP of each cell (for chroma the luma cells (2 cy, 2 cx) only, a
    quarter of qp_y) and the offsets in, the int16 planes out. Operations, for the
    blocks this run's inputs need transformed (the origin cell holds a
    size of `sizes` and a level is not zero): per sample of an n x n block
    and stage, the partial butterfly's multiply-adds, two to an int32
    instruction (__dp2a: int16 levels or stage values against int8
    matrix entries), and its adds; and 8 for the dequantisation, the two
    roundings and clips and the sum."""
    F, H, W = coeffs[0].shape
    ops = 0
    for v in sizes:
        n, c4 = 1 << v, 1 << (v - 2)
        origin = tu[:, ::c4, ::c4] == v
        per = 2 * (BUTTERFLY_MACS[v] / 2 + BUTTERFLY_ADDS[v]) + 8
        for c in coeffs:
            nz = (c.reshape(F, H // n, n, W // n, n) != 0).any(4).any(2)
            ops += int((origin & nz).sum()) * n * n * per
    out = 2 * sum(c.numel() for c in coeffs)
    qp = qp_y if offsets is None else qp_y[:, ::2, ::2]
    return bound_ms(nbytes(*coeffs, tu, qp, *(offsets or ())) + out, ops)


LUMA_SIZES, CHROMA_SIZES = HR.LUMA_SIZES, HR.CHROMA_SIZES


def resid_once(args, kw, what):
    """One hevc_resid launch against planes_reference, bit for bit:
    (its planes, max_abs_err)."""
    want = HR.planes_reference(*args, **kw)
    got = HR.resid_planes(*args, **kw)
    torch.cuda.synchronize()
    e = max_abs(got, want)
    check(e == 0 and got.dtype == torch.int16,
          f"{what}: hevc_resid != planes_reference")
    return got, e


# hevc_resid launches a run of event_ms takes
RESID_RUN = 20


def resid_figures(args, kw, what):
    """One hevc_resid launch of a path against planes_reference, bit for
    bit, and its times: ms a launch by CUDA events (the median of REPS
    runs of RESID_RUN launches after a warm-up, queued behind a spin
    kernel), the profiler's device ms of one launch (scan_ms, with the
    launches it traced), and its bound."""
    _, e = resid_once(args, kw, what)
    fn = lambda: HR.resid_planes(*args, **kw)
    ms = statistics.median(event_ms(fn, RESID_RUN) for _ in range(REPS))
    _, traced_ms, traced = scan_ms(fn, "hevc_resid_butterfly")
    return {"err": e, "ms": ms, "traced_ms": traced_ms, "traced": traced,
            "bound": resid_bound(*args, kw.get("offsets"), kw["sizes"])}


def say_resid(head, f, extra=""):
    traced = (f"{f['traced_ms']:.4f} ms by the profiler, "
              f"{timing_of(f['traced'])}" if f["traced"] else
              f"the profiler traced none of {4 * REPS} runs")
    say(f"{head}: {f['ms']:.4f} ms a launch by CUDA events (the median of "
        f"{REPS} runs of {RESID_RUN}), {traced}; bound {f['bound'][0]:.5f} "
        f"ms ({f['bound'][2]}), {100 * f['bound'][0] / f['ms']:.1f}% of "
        f"it{extra}")


def resid_path(dev, card):
    """Phase 30: hevc_resid against planes_reference on seeded hard inputs,
    then at the 1080p batch of 16's shapes with its timings. Returns the
    hevc_resid record (its launches counted later, on the paths)."""
    err, n = 0, 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def synth(frames, H, W, seed, chroma, sizes, one):
        """(one: the map's TUs all of that size, under the full set)"""
        coeffs, tu, qp, offs = synth_resid_planes(frames, H, W, seed,
                                                  chroma=chroma, sizes=sizes)
        if one is not None:
            tu = np.where(np.isin(tu, sizes), one, tu).astype(np.int8)
        return ((tuple(map(t, coeffs)), t(tu), t(qp)),
                None if offs is None else tuple(map(t, offs)))

    cases = [("intra luma", 2, 96, 128, False, LUMA_SIZES, True, None),
             ("inter luma", 2, 96, 128, False, LUMA_SIZES, False, None),
             ("Cb + Cr", 3, 48, 64, True, CHROMA_SIZES, False, None),
             ("Cb + Cr 48x80", 2, 48, 80, True, CHROMA_SIZES, False, None)]
    cases += [(f"luma 2^{v}", 1, 64, 64, False, LUMA_SIZES, True, v)
              for v in LUMA_SIZES]
    cases += [(f"chroma 2^{v}", 2, 32, 32, True, CHROMA_SIZES, False, v)
              for v in CHROMA_SIZES]
    for i, (what, frames, H, W, chroma, sizes, dst4, one) in enumerate(
            cases):
        args, offs = synth(frames, H, W, 50 + i, chroma, sizes, one)
        if i == 0:
            check(set(args[2].unique().tolist()) == set(range(52)),
                  "phase 30: QPs missing")
            check(int(args[0][0].min()) == -32768
                  and int(args[0][0].max()) == 32767,
                  "phase 30: levels do not reach the int16 extremes")
        got, e = resid_once(args, dict(sizes=sizes, dst4=dst4,
                                       offsets=offs), f"phase 30 {what}")
        check(got.any(), f"phase 30 {what}: all zero")
        err, n = max(err, e), n + 1
        if i == 0:
            coeffs, tu, qp = args
            for kind, a in (("zero levels",
                             ((torch.zeros_like(coeffs[0]),), tu, qp)),
                            ("no TU", (coeffs, torch.where(tu >= 2, 0, tu),
                                       qp))):
                got, e = resid_once(a, dict(sizes=sizes, dst4=True),
                                    f"phase 30 {kind}")
                check(not got.any(), f"phase 30 {kind}: not zero")
                err, n = max(err, e), n + 1
    say(f"phase 30: hevc_resid == planes_reference on {n} seeded launches "
        f"(intra luma with the DST, inter luma, Cb + Cr with per-frame "
        f"offsets, also 48x80 (areas half outside the planes), maps of one "
        f"TU size; every QP 0..51, levels at the int16 extremes, all-zero "
        f"blocks, random overlapping TU maps, cells outside the sizes; "
        f"levels all zero; no TU), max_abs_err {err}")

    # the main path's shapes: the batch of 16's planes from stack_plans
    plans = parse_hevc_intra_plans(fixture_batch_stream(),
                                   workers=os.cpu_count() or 1)
    a = HTT.stack_plans(plans, dev)
    shapes = {"luma": (((a[9],), a[10], a[13]),
                       dict(sizes=LUMA_SIZES, dst4=True)),
              "chroma": (((a[14], a[15]), a[16], a[13]),
                         dict(sizes=CHROMA_SIZES, offsets=(a[19], a[20])))}
    figs = {}
    for key, (args, kw) in shapes.items():
        f = resid_figures(args, kw, f"phase 30 batch {key}")
        err = max(err, f["err"])
        f["plain"] = statistics.median(
            kernel_busy(lambda: HR.planes_reference(*args, **kw))[1]
            for _ in range(REPS))
        figs[key] = f
        F, H, W = args[0][0].shape
        say_resid(f"phase 30 [{card}]: hevc_resid {key} at the batch of {F} "
                  f"({len(args[0])} x {F} planes {W}x{H})", f,
                  f"; plain stage (planes_reference) {f['plain']:.3f} ms "
                  f"device busy (median of {REPS})")
    # where the luma launch's time goes: maps and levels derived from the
    # batch's that isolate one kind of work, timed the same way
    y, tu, qp = shapes["luma"][0][0][0], a[10], a[13]
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    dense = torch.randint(-400, 401, y.shape, device=dev, generator=g,
                          dtype=torch.int16)
    kinds = {"without its 32x32 TUs": (y, torch.where(tu == 5, 0, tu)),
             "with only its 32x32 TUs": (y, torch.where(tu == 5, tu, 0)),
             "without the DC shortcut (no zero level)":
                 (torch.where(y != 0, y, 1), tu)}
    kinds.update({f"all {1 << v}x{1 << v}, levels dense in -400..400":
                  (dense, torch.full_like(tu, v)) for v in LUMA_SIZES})
    for kind, (lev, m) in kinds.items():
        f = resid_figures(((lev,), m, qp), shapes["luma"][1],
                          f"phase 30 luma {kind}")
        err = max(err, f["err"])
        say_resid(f"phase 30 [{card}]: hevc_resid luma at the batch of 16, "
                  f"{kind}", f)
    mean = lambda k: statistics.mean(f[k] for f in figs.values())
    rec = {"name": "hevc_resid", "route": "cuda",
           "source": "jmcodec_tpu_torch/csrc/hevc_resid.cu",
           "replaces": "jmcodec_tpu/kernels/hevc_tiles.py:84",
           "launches": 0, "max_abs_err": err, "ms": mean("ms"),
           "plain_ms": mean("plain"),
           "bound_ms": statistics.mean(f["bound"][0] for f in figs.values()),
           "bound_by": max(f["bound"] for f in figs.values())[1],
           "library_ms": None, "ms_traced": mean("traced_ms"),
           "stage_ms": sum(f["ms"] for f in figs.values()),
           "plain_stage_ms": sum(f["plain"] for f in figs.values())}
    for key, f in figs.items():
        rec.update({f"ms_{key}": f["ms"], f"ms_traced_{key}": f["traced_ms"],
                    f"plain_ms_{key}": f["plain"],
                    f"bound_ms_{key}": f["bound"][0],
                    f"runs_traced_{key}": f["traced"]})
    return rec


def resid_inter(card, cap, rec):
    """Phase 10's hevc_resid launches of one inter picture (cap: their
    arguments, calls_of's; its inter residuals, luma and Cb + Cr, then its
    intra ones), each against planes_reference and timed as phase 30 times
    the batch's; added to rec (phase 30's record) when there is one."""
    check(len(cap) == 4, f"phase 10: {len(cap)} hevc_resid launches")
    keys = ("inter_luma", "inter_chroma", "intra_luma", "intra_chroma")
    figs = {k: resid_figures(a, kw, f"phase 10 {k}")
            for k, (a, kw) in zip(keys, cap)}
    for (k, f), (a, _) in zip(figs.items(), cap):
        F, H, W = a[0][0].shape
        say_resid(f"phase 10 [{card}]: hevc_resid {k.replace('_', ' ')} of "
                  f"the first P picture ({W}x{H})", f)
    total = sum(f["ms"] for f in figs.values())
    bound = sum(f["bound"][0] for f in figs.values())
    say(f"phase 10 [{card}]: hevc_resid's four launches of the first P "
        f"picture {total:.4f} ms, bound {bound:.5f} ms")
    if rec is not None:
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 max(f["err"] for f in figs.values()))
        rec["ms_p_picture"], rec["bound_ms_p_picture"] = total, bound
        rec.update({f"ms_p_{k}": f["ms"] for k, f in figs.items()})


def hevc_path(dev, card, err):
    """Phases 4-5 (err: phase 3's); returns the hevc_walk record, the
    hevc_scan record and the path's figures."""
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
    (Y, U, V), scans = calls_of(
        HTT, "scan_planes", lambda: HTT.decode_frames_hevc_batch(*args))
    torch.cuda.synchronize()
    launches = hevc_scan_counts("phase 4", 2)
    check(ID.LAUNCHES == 0, "dequant_idct launched on the HEVC path")
    check_digests((Y, U, V), digests, "hevc")
    # the plain route (the torch scan with walk_reference a step), each
    # scan's output and wall kept: the kernel's yardstick on the path's
    # own inputs
    ref, plain = hevc_plain_scans(
        lambda: HTT.decode_frames_hevc_batch(*args,
                                             walk_fn=HW.walk_reference))
    for a, b, plane in zip((Y, U, V), ref, "YUV"):
        e = max_abs(a, b)
        err = max(err, e)
        check(e == 0, f"decode != walk_reference decode ({plane})")
    scan_err = 0
    for (a, kw), (want, _), key in zip(scans, plain, ("luma", "chroma")):
        e = max_abs(HSC.scan_planes(*a, **kw), want)
        scan_err = max(scan_err, e)
        check(e == 0, f"hevc_scan {key} != the plain scan")
    say(f"phase 4: {BATCH}x {p0.width}x{p0.height} CTU {C}: two scans of "
        f"a {steps}-CTB chain, hevc_scan launched {launches} times (one a "
        f"scan), hevc_walk none; all {BATCH * 3} planes match the "
        f"libavcodec SHA-256 digests and the walk_reference decode, and "
        f"each scan's planes the plain scan's")
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
    n_kernels, busy = kernel_busy(device_only)

    # each scan kernel on the path's inputs: device ms of
    # its one launch; its chain; its lanes against the resident CTAs
    scan_t = {}
    for (a, kw), (want, p_ms), key in zip(scans, plain, ("luma", "chroma")):
        scan_t[key] = scan_figures(a, kw, want, f"phase 5 {key}", p_ms)
        scan_err = max(scan_err, scan_t[key]["err"])

    # per-step walk time on the real states of the middle scan step (the
    # torch scan's route, one hevc_walk launch a step)
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
        f"{(t_dev - t_issued) * 1000:.1f} ms later; the device-only decode "
        f"is {n_kernels} kernel launches, the device busy {busy:.2f} ms "
        f"(torch.profiler)")
    for key, f in scan_t.items():
        say_scan(f"phase 5 [{card}]: hevc_scan {key}", f, steps,
                 f"; the torch scan with the walk kernel a step took {steps} "
                 f"x {step_ms[key][0]:.4f} = {steps * step_ms[key][0]:.3f} "
                 f"ms of walks alone")
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
    # hevc_walk: no launch of its own on any path (its device code runs
    # inside hevc_scan); its times are those of the torch scan's steps
    rec = {"name": "hevc_walk", "route": "cuda",
           "source": "jmcodec_tpu_torch/csrc/hevc_walk.cu",
           "replaces": "jmcodec_tpu/kernels/hevc_walk_pallas.py:560",
           "launches": 0, "runs_inside": "hevc_scan",
           "launches_checks": HW.LAUNCHES, "max_abs_err": err,
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
    fmean = lambda k: statistics.mean(f[k] for f in scan_t.values())
    scan_rec = {"name": "hevc_scan", "route": "cuda",
                "source": "jmcodec_tpu_torch/csrc/hevc_scan.cu",
                "replaces": "jmcodec_tpu/kernels/hevc_tiles.py:712",
                "launches": 0, "max_abs_err": scan_err,
                "ms": fmean("ms"), "plain_ms": fmean("plain_ms"),
                "bound_ms": statistics.mean(f["bound"][0]
                                            for f in scan_t.values()),
                "bound_by": max(f["bound"] for f in scan_t.values())[1],
                "library_ms": None, "chain_ctbs": steps,
                "launches_per_decode": launches}
    for key, f in scan_t.items():
        scan_rec.update(scan_keys(f, key, steps))
        scan_rec[f"walk_steps_ms_{key}"] = steps * step_ms[key][0]
    figures = {"slice": "hevc 1080p all-intra batch decode",
               "batch": BATCH, "e2e_fps": BATCH / t_e2e,
               "device_fps": BATCH / t_dev,
               "device_only_issued_ms": t_issued * 1000,
               "device_only_wall_ms": t_dev * 1000,
               "kernel_launches": n_kernels, "device_busy_ms": busy,
               "card": card}
    return rec, scan_rec, figures


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
    steps = mbw + 2 * (mbh - 1)
    scans = scan_counts("phase 7", 1, 1)
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
    say(f"phase 7: {H264_BATCH}x {w}x{h} H.264: {steps} wavefront steps of "
        f"{mbh} lanes per frame, dequant_idct launched {launches} times, "
        f"h264_intra {scans[0]} and h264_deblock {scans[1]} (one launch a "
        f"scan, the {H264_BATCH * mbh} lanes of the batch chained in it); all "
        f"{H264_BATCH * 3} planes match the libavcodec SHA-256 digests and "
        f"the dequant_idct_reference decode")
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
    n_kernels, busy = kernel_busy(device_only)

    shapes, e = idct_shapes(args)
    err = max(err, e)
    say(f"phase 8 [{card}]: end-to-end {H264_BATCH / t_e2e:.2f} fps "
        f"({t_e2e * 1000:.1f} ms per batch of {H264_BATCH}, parse on "
        f"{workers} threads + stack_symbols + H2D + decode); device-only "
        f"{H264_BATCH / t_dev:.2f} fps ({t_dev * 1000:.1f} ms); the host "
        f"had issued the device-only decode's last launch at "
        f"{t_issued * 1000:.1f} ms, the device finished "
        f"{(t_dev - t_issued) * 1000:.1f} ms later; under torch.profiler "
        f"the batch's decode launches {n_kernels} kernels and keeps the "
        f"device busy {busy:.1f} ms")
    say_idct_shapes("phase 8", card, shapes)
    rec = idct_record(shapes, launches, err)
    rec["launches_h264_intra"] = launches
    figures = {"slice": "h264 1080p all-intra batch decode",
               "batch": H264_BATCH, "e2e_fps": H264_BATCH / t_e2e,
               "device_fps": H264_BATCH / t_dev,
               "device_only_issued_ms": t_issued * 1000,
               "device_only_wall_ms": t_dev * 1000,
               "kernel_launches": n_kernels, "device_busy_ms": busy,
               "scan_launches": scans, "card": card}
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


def hevc_inter_path(dev, card, walk_rec, scan_rec, err, resid_rec):
    """Phases 9-10 (err: phase 3's). Returns the hevc_walk and hevc_scan
    records (walk_rec and scan_rec with the inter path's times added, or
    records of this path alone when the intra path was not driven) and
    the path's figures; adds the first P picture's hevc_resid times to
    resid_rec (phase 30's record)."""
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
    check(len(frames) == len(plans) == len(digests),
          f"{len(frames)} frames, {len(plans)} pictures")
    launches = hevc_scan_counts("phase 9", 2 * len(plans), 4 * len(plans))
    check(ID.LAUNCHES == 0, "dequant_idct launched on the HEVC inter path")
    check_digests([torch.stack([f[k] for f in frames]) for k in range(3)],
                  digests, "hevc inter")
    steps = [HTT.walk_steps(p) for p in plans]
    n_steps = sum(len(y) + len(c) for y, c in steps)
    taken = sum(sum(y) + sum(c) for y, c in steps)
    p0 = plans[0]
    say(f"phase 9: {len(plans)} pictures {p0.width}x{p0.height} CTU "
        f"{1 << p0.log2_ctb} (decode order POC "
        f"{[p.poc for p in plans]}): hevc_scan launched {launches} times "
        f"(two a picture), hevc_walk none; {n_steps - taken} of the "
        f"{n_steps} scan steps hold no TU (the torch scan skips them, the "
        f"kernel passes over every CTB without a TU); all "
        f"{3 * len(frames)} planes in output order match the libavcodec "
        f"SHA-256 digests")

    # ---- phase 10: timing ----
    def e2e():
        decode_hevc(stream, dev)

    def device_only():
        decode_plans(plans, dev)

    e2e()
    t_e2e, _ = sync_time(e2e, REPS)
    device_only()
    t_dev, t_issued = sync_time(device_only, REPS)
    n_kernels, busy = kernel_busy(device_only)
    n = len(plans)

    # the first P picture: its two scans through the kernel, and the walk
    # at its middle scan step on the torch scan's route
    check(plans[1].ref_pocs == [p0.poc], "picture 1 is not a P picture")
    i_planes = decode_plans(plans[:1], dev)[0]
    refs = [HTT.prep_hevc_ref(*i_planes)]
    (_, scans), resids = calls_of(HR, "resid_planes", lambda: calls_of(
        HTT, "scan_planes", lambda: HTT.decode_plan_inter(plans[1], refs,
                                                          dev)))
    resid_inter(card, resids, resid_rec)
    C = 1 << p0.log2_ctb
    chain = p0.Wp // C + HT.skew_for(C) * (p0.Hp // C - 1)
    scan_t, scan_err = {}, 0
    for (a, kw), key in zip(scans, ("luma", "chroma")):
        want, t_plain = timed(lambda: HSC.scan_reference(*a, **kw))
        scan_t[key] = scan_figures(a, kw, want, f"phase 10 inter {key}",
                                   t_plain * 1e3)
        scan_err = max(scan_err, scan_t[key]["err"])
    captured = {}

    def capture(F, Z, resid, tu, mode, **kw):
        key = "chroma" if kw["is_chroma"] else "luma"
        captured.setdefault(key, []).append(((F, Z, resid, tu, mode), kw))
        return HW.walk(F, Z, resid, tu, mode, **kw)

    HTT.decode_plan_inter(plans[1], refs, dev, walk_fn=capture)
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
        f"launches ({n_kernels / n:.0f} per picture), the device busy "
        f"{busy:.2f} ms (torch.profiler)")
    for key, f in scan_t.items():
        say_scan(f"phase 10 [{card}]: hevc_scan {key} of the first P "
                 f"picture", f, chain, "")
    for key, (k_ms, p_ms) in step_ms.items():
        say(f"phase 10 [{card}]: walk step {key} of the first P picture "
            f"(B={captured[key][0][0][0].shape[0]}, step {tus[key][2] // 2} "
            f"of the {tus[key][2]} walked; active TUs per lane max "
            f"{tus[key][0]}, mean {tus[key][1]:.1f}): kernel {k_ms:.4f} "
            f"ms, walk_reference {p_ms:.2f} ms, bound {bounds[key][0]:.5f} "
            f"ms ({bounds[key][2]})")

    mean = lambda d, i: statistics.mean(v[i] for v in d.values())
    if walk_rec is None:
        walk_rec = {"name": "hevc_walk", "route": "cuda",
                    "source": "jmcodec_tpu_torch/csrc/hevc_walk.cu",
                    "replaces": "jmcodec_tpu/kernels/hevc_walk_pallas.py:560",
                    "launches": 0, "runs_inside": "hevc_scan",
                    "max_abs_err": 0,
                    "ms": mean(step_ms, 0), "plain_ms": mean(step_ms, 1),
                    "bound_ms": mean(bounds, 0),
                    "bound_by": max(bounds.values())[1], "library_ms": None}
    if scan_rec is None:
        scan_rec = {"name": "hevc_scan", "route": "cuda",
                    "source": "jmcodec_tpu_torch/csrc/hevc_scan.cu",
                    "replaces": "jmcodec_tpu/kernels/hevc_tiles.py:712",
                    "launches": 0, "max_abs_err": 0,
                    "ms": statistics.mean(f["ms"] for f in scan_t.values()),
                    "plain_ms": statistics.mean(f["plain_ms"]
                                                for f in scan_t.values()),
                    "bound_ms": statistics.mean(f["bound"][0]
                                                for f in scan_t.values()),
                    "bound_by": max(f["bound"]
                                    for f in scan_t.values())[1],
                    "library_ms": None}
    for key in ("luma", "chroma"):
        walk_rec.update({f"ms_inter_{key}": step_ms[key][0],
                         f"plain_ms_inter_{key}": step_ms[key][1],
                         f"bound_ms_inter_{key}": bounds[key][0]})
        scan_rec.update(scan_keys(scan_t[key], f"inter_{key}", chain))
    walk_rec["max_abs_err"] = max(walk_rec["max_abs_err"], err)
    scan_rec["max_abs_err"] = max(scan_rec["max_abs_err"], scan_err)
    figures = {"slice": "hevc 1080p inter stream decode", "pictures": n,
               "e2e_fps": n / t_e2e, "device_fps": n / t_dev,
               "device_only_issued_ms": t_issued * 1000,
               "device_only_wall_ms": t_dev * 1000,
               "kernel_launches_per_picture": n_kernels / n,
               "device_busy_ms": busy, "scan_launches": launches,
               "steps_without_tu": n_steps - taken, "card": card}
    return walk_rec, scan_rec, figures


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
    scans = scan_counts(
        "phase 11", sum(any(w) for w in walks)
        + sum(fs.mv is None for fs, _ in pics),
        sum(fs.deblock_enabled for fs, _ in pics))
    sps = pics[0][1]
    say(f"phase 11: {n} pictures {sps.width}x{sps.height} H.264 (I, then "
        f"{len(walks)} P with {[fs.num_ref_l0 for fs, _ in pics[1:]]} "
        f"references): dequant_idct launched {launches} times (2 a "
        f"picture); the P pictures' intra scans walked "
        f"{[sum(w) for w in walks]} and skipped "
        f"{[len(w) - sum(w) for w in walks]} of {len(walks[0])} diagonals "
        f"(h264_intra launched {scans[0]} times: once a picture with an "
        f"intra macroblock; h264_deblock {scans[1]}: once a picture); all "
        f"{3 * n} planes match the libavcodec SHA-256 digests")
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
    n_kernels, busy = kernel_busy(one_p)
    check(n_kernels < 2000, f"one P picture launches {n_kernels} kernels")
    shapes, e = idct_shapes(RC.stack_symbols([fs1], dev))
    err = max(err, e)
    say(f"phase 12 [{card}]: end-to-end {n / t_e2e:.3f} fps "
        f"({t_e2e * 1000:.1f} ms for {n} pictures: native parse + device "
        f"decode, picture by picture); device-only {n / t_dev:.3f} fps "
        f"({t_dev * 1000:.1f} ms: the parsed symbols uploaded and decoded); "
        f"the host had issued the last launch at {t_issued * 1000:.1f} ms, "
        f"the device finished {(t_dev - t_issued) * 1000:.1f} ms later; the "
        f"first P picture alone {t_p * 1000:.1f} ms (last launch issued at "
        f"{t_p_issued * 1000:.1f} ms), {n_kernels} kernel launches, the "
        f"device busy {busy:.1f} ms")
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
               "first_p_device_busy_ms": busy,
               "intra_steps_walked": walked,
               "intra_steps_skipped": steps - walked,
               "scan_launches": scans, "card": card}
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
    scans = scan_counts("phase 13")
    check_session_frames(frames, digests, dev, "h264 session")
    h, w = frames[0][0].shape
    say(f"phase 13 [{card}]: H.264 session, {n} pictures {w}x{h} (IDR + "
        f"{n - 1} P) in 1 MiB chunks: {n / dt:.3f} fps end to end "
        f"({dt * 1000:.1f} ms), frames_device {n_dev}, dequant_idct "
        f"launched {launches} times, h264_intra {scans[0]}, h264_deblock "
        f"{scans[1]}; all {3 * n} planes match the "
        f"libavcodec SHA-256 digests; stage timers (host issue, ms) "
        f"{stages}")
    return launches, {"slice": "h264 1080p session", "pictures": n,
                      "e2e_fps": n / dt, "wall_ms": dt * 1000,
                      "frames_device": n_dev, "dequant_idct_launches":
                      launches, "stages_ms": stages, "card": card}


def session_hevc_path(dev, card):
    """Phase 14. Returns the figures."""
    figures = []
    for what, path, digests in (
            ("inter", INTER_FIXTURE, fixture_digests(INTER_DIGESTS)),
            ("intra", FIXTURE, fixture_digests())):
        with open(path, "rb") as f:
            stream = f.read()
        n = len(digests)
        reset_counts()
        frames, dt, n_dev, stages = run_session(Codec.HEVC, stream)
        check(ID.LAUNCHES == 0, "dequant_idct launched on the HEVC session")
        check(n_dev == n, f"hevc {what}: {n_dev} of {n} pictures decoded "
                          f"on the device")
        # each picture through DeviceRecon: two scans a picture
        launches = hevc_scan_counts(f"phase 14 {what}", 2 * n_dev,
                                    4 * n_dev)
        check_session_frames(frames, digests, dev, f"hevc {what} session")
        h, w = frames[0][0].shape
        say(f"phase 14 [{card}]: HEVC session, {what} fixture, {n} pictures "
            f"{w}x{h} in 1 MiB chunks: {n / dt:.2f} fps end to end "
            f"({dt * 1000:.1f} ms), frames_device {n_dev}, hevc_scan "
            f"launched {launches} times; all {3 * n} planes match the "
            f"libavcodec SHA-256 digests; stage timers (host issue, ms) "
            f"{stages}")
        figures.append({"slice": f"hevc 1080p {what} session",
                        "pictures": n, "e2e_fps": n / dt,
                        "wall_ms": dt * 1000, "frames_device": n_dev,
                        "scan_launches": launches, "stages_ms": stages,
                        "card": card})
    return figures


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
    scan_counts("phase 15")
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
    """Phase 16. Returns the figures."""
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
    launches = hevc_scan_counts("phase 16", 2 * len(plans), 4 * len(plans))
    check_session_frames(frames, digests, dev, "hevc cuqp session")
    h, w = frames[0][0].shape
    per_pic = {k: round(v / n, 1) for k, v in stages.items()}
    say(f"phase 16 [{card}]: HEVC session, cu_qp_delta fixture, {n} "
        f"pictures {w}x{h} (I + {n - 1} P, luma QP "
        f"{min(int(p.qp_y.min()) for p in plans)}-"
        f"{max(int(p.qp_y.max()) for p in plans)}) in 1 MiB chunks: every "
        f"picture parsed in Python and decoded on the device; {n / dt:.3f} "
        f"fps end to end ({dt * 1000:.1f} ms), hevc_scan launched "
        f"{launches} times (two a picture); all {3 * n} "
        f"planes match the libavcodec SHA-256 digests; stage timers per "
        f"picture (ms; host_parse the Python parse, device_recon the "
        f"host's issue) {per_pic}")
    return {"slice": "hevc 1080p cu_qp_delta session", "pictures": n,
            "e2e_fps": n / dt, "wall_ms": dt * 1000, "frames_device": n_dev,
            "plans_python": n_py, "scan_launches": launches,
            "stages_ms_per_picture": per_pic, "card": card}


def hevc_host_streams(card):
    """Phase 17. Returns the figures."""
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
    finally:
        DeviceRecon.__call__ = call
    check(ID.LAUNCHES == 0, "dequant_idct launched on the HEVC session")
    check(plans, "host-route fixtures: no picture on the card")
    launches = hevc_scan_counts("phase 17", 2 * len(plans), 4 * len(plans))
    dt = time.perf_counter() - t0
    say(f"phase 17 [{card}]: HEVC host-route fixtures (pictures on the "
        f"device, on the host) {paths}, as the CPU tests assert; every "
        f"plane matches its libavcodec digest; hevc_scan launched "
        f"{launches} times (two a picture the card took); {dt:.1f} s")
    return {"slice": "hevc host-route small streams", "paths": paths,
            "scan_launches": launches, "wall_s": dt, "card": card}


def hevc_host_path(dev, card):
    """Phases 16-17 (their launches go to HEVC_SCAN)."""
    say(json.dumps(hevc_cuqp_path(dev, card)))
    torch.cuda.empty_cache()
    say(json.dumps(hevc_host_streams(card)))


def session_path(dev, card, idct_rec):
    """Phases 13-15: add the session's launches to the kernels' records
    (hevc_scan's to HEVC_SCAN)."""
    idct_13, fig13 = session_h264_path(dev, card)
    say(json.dumps(fig13))
    torch.cuda.empty_cache()
    for fig in session_hevc_path(dev, card):
        say(json.dumps(fig))
    torch.cuda.empty_cache()
    idct_15, fig15 = session_small_streams(card)
    say(json.dumps(fig15))
    if idct_rec is not None:
        idct_rec["launches_session"] = idct_13 + idct_15
        idct_rec["launches"] += idct_13 + idct_15


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
    # a P frame's recon deblocks it in one launch; its macroblocks are all
    # inter, so its intra scan walks no diagonal and launches nothing (the
    # IDR is encoded on the host)
    scans = scan_counts("phase 18", 0, n_p)
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
              "_bs_planes", "intra_tiles", "deblock_tiles")
    t_p, walls = staged_p_frame(enc, frames[-1], qp, stages)
    n_kernels, busy = kernel_busy(lambda: enc.encode_p(*frames[-1], qp=qp))
    share = walls["deblock_tiles"] / t_p
    steady = per_frame[2]["wall_ms"]
    say(f"phase 18 [{card}]: EncoderSession(EncoderParams()) on the card, "
        f"{len(frames)} frames {enc.cfg.width}x{enc.cfg.height} I420 "
        f"(1080p30, 2 Mb/s VBR, GOP 30): stream {len(stream)} bytes = the "
        f"fixture's SHA-256, keyframes {[k for _, k in packets]}; the "
        f"port's decode_h264 on the card equals the libavcodec digests and "
        f"the encoder's recon, plane by plane; dequant_idct launched "
        f"{launches} times (2 a P frame), h264_intra {scans[0]}, "
        f"h264_deblock {scans[1]} (one launch a P frame)")
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
                # the device engine rebuilds every P frame through the
                # deblock kernel, one launch a P frame
                check(isinstance(sess._enc, DeviceH264Encoder),
                      f"{name}: not on the device engine")
                n_p = sum(i % kw["gop_len"] != 0 for i in range(n))
                scan_counts(f"phase 19 {name}", "any", n_p)
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


def sharded_decode_path(dev, card):
    """Phase 20. Returns the dequant_idct launches, its shapes at the
    batch's and the figures."""
    digests = fixture_digests(H264_DIGESTS)
    workers = os.cpu_count() or 1
    pics = parse_h264_intra_symbols(h264_fixture_batch_stream(),
                                    workers=workers)
    fss = [fs for fs, _ in pics]
    fs0, sps = pics[0]
    mbh, mbw, w, h = fs0.mb_height, fs0.mb_width, sps.width, sps.height
    cfg = ShardingConfig(1, 1)
    mesh = build_mesh(cfg)                      # a one-rank NCCL group
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"process group {dist.get_backend()} of {dist.get_world_size()}")
    torch.cuda.synchronize()
    reset_counts()
    Y, U, V = decode_symbols_sharded(fss, cfg, mesh)
    launches = ID.LAUNCHES
    check(launches == 2, f"{launches} dequant_idct launches, want 2")
    scans = scan_counts("phase 20", 1, 1)
    check(Y.shape == (H264_BATCH, mbh * 16, mbw * 16), f"Y {Y.shape}")
    check_digests((Y[:, :h, :w], U[:, :h // 2, :w // 2],
                   V[:, :h // 2, :w // 2]), digests, "sharded h264")
    args = RC.stack_symbols(fss, dev)
    ref = RT.decode_frames_batch(mbh, mbw, *args, deblock=True,
                                 residual_fn=ID.dequant_idct_reference)
    err = max(max_abs(torch.from_numpy(a), b.cpu())
              for a, b in zip((Y, U, V), ref))
    check(err == 0, "sharded decode != dequant_idct_reference decode")
    del ref
    # the whole step: the decode, the row-band reshard, the halo
    # downscale, the forward pass, the summed statistics
    reset_counts()
    z, bits, ssd = run_transcode_real_step(fss, cfg)
    step_launches = ID.LAUNCHES
    check(step_launches == 2, f"{step_launches} dequant_idct launches in "
                              f"the transcode step, want 2")
    scan_counts("phase 20 step", 1, 1)
    zc, bc, sc = _encode_forward(_downscale2x_with_halo(
        torch.from_numpy(Y).to(torch.int32), mesh.get_group("sp")), 30)
    check(np.array_equal(z, zc.numpy()) and (bits, ssd) == (int(bc), int(sc)),
          "transcode step on the card != the same step on CPU tensors")
    del zc
    # one run each (the checked runs were the warm-up): a run takes ~8 s
    t_dec, _ = sync_time(lambda: decode_symbols_sharded(fss, cfg, mesh), 1)
    t_step, _ = sync_time(lambda: run_transcode_real_step(fss, cfg), 1)
    shapes, e = idct_shapes(args)
    say(f"phase 20 [{card}]: decode_symbols_sharded of {H264_BATCH}x "
        f"{w}x{h} H.264 at world 1 (one-rank NCCL group): dequant_idct "
        f"launched {launches} times, the scan kernels {scans[0]} + "
        f"{scans[1]} (the one-rank group runs the kernels), all "
        f"{3 * H264_BATCH} planes match the "
        f"libavcodec digests and the dequant_idct_reference decode; "
        f"{H264_BATCH / t_dec:.2f} fps ({t_dec * 1000:.1f} ms: the "
        f"symbols' upload, the decode, the all_gather and the copy to the "
        f"host; phase 8's device-only decode is the same decode without "
        f"the upload and the copy); make_transcode_real_step: levels "
        f"{tuple(z.shape)}, bits {bits}, ssd {ssd}, equal to the step on "
        f"CPU tensors of the card's frames, {t_step * 1000:.1f} ms a step")
    say_idct_shapes("phase 20", card, shapes)
    return launches + step_launches, shapes, max(err, e), {
        "slice": "sharded h264 1080p all-intra decode, world 1",
        "batch": H264_BATCH, "fps": H264_BATCH / t_dec,
        "wall_ms": t_dec * 1000, "transcode_step_ms": t_step * 1000,
        "bits": bits, "ssd": ssd, "dequant_idct_launches":
        launches + step_launches, "card": card}


def kernel_streams(fn):
    """{stream id: CUDA kernel events} of one fn() run under
    torch.profiler, and the streams of the hevc_scan kernel's events."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    streams, scan = {}, set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        sid = e.device_resource_id()
        streams[sid] = streams.get(sid, 0) + 1
        if "hevc_scan" in e.name():
            scan.add(sid)
    return streams, scan


def pipelined_path(dev, card):
    """Phase 21. Returns the figures."""
    digests = fixture_digests()
    workers = os.cpu_count() or 1
    plans = parse_hevc_intra_plans(fixture_batch_stream(), workers=workers)
    p0 = plans[0]
    half = BATCH // 2
    d_scan, d_filter = default_devices()
    torch.cuda.synchronize()
    reset_counts()
    outs = decode_plans_pipelined(plans, batch=half)
    torch.cuda.synchronize()
    check(len(outs) == 2, f"{len(outs)} batches")
    launches = hevc_scan_counts("phase 21", 2 * 2)
    check(ID.LAUNCHES == 0, "dequant_idct launched on the HEVC pipeline")
    got = [torch.cat([o[k] for o in outs]) for k in range(3)]
    check_digests(got, digests, "pipelined hevc")
    want = HTT.decode_frames_hevc_batch(*HTT.stack_plans(plans, dev))
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "pipelined decode != decode_frames_hevc_batch")
    del got, want, outs
    streams, scan_streams = kernel_streams(
        lambda: decode_plans_pipelined(plans, batch=half))
    t_pipe, t_issued = sync_time(
        lambda: decode_plans_pipelined(plans, batch=half), REPS)
    say(f"phase 21 [{card}]: decode_plans_pipelined of {BATCH}x "
        f"{p0.width}x{p0.height} HEVC as 2 batches of {half}: scan stage on "
        f"{d_scan}, filter stage on {d_filter} (one card: both stages on "
        f"it, each on its own stream); kernels by stream "
        f"{streams} (the scan kernel on {sorted(scan_streams)}); hevc_scan "
        f"launched {launches} times (two a batch); "
        f"all {3 * BATCH} planes match the libavcodec digests and "
        f"decode_frames_hevc_batch; {BATCH / t_pipe:.2f} fps "
        f"({t_pipe * 1000:.1f} ms with stack_plans' upload; the host had "
        f"issued the last launch at {t_issued * 1000:.1f} ms; phase 5's "
        f"device-only figure is the batch of 16 without the upload)")
    check(len(scan_streams) == 1 and len(streams) >= 2,
          "the scan and filter stages ran on one stream")
    return {"slice": "pipelined hevc 1080p all-intra decode",
                      "batches": 2, "batch": half, "fps": BATCH / t_pipe,
                      "wall_ms": t_pipe * 1000,
                      "issued_ms": t_issued * 1000,
                      "devices": [str(d_scan), str(d_filter)],
                      "kernels_by_stream": {str(k): v
                                            for k, v in streams.items()},
                      "scan_launches": launches, "card": card}


def row_sharded_path(dev, card):
    """Phase 22. Returns the dequant_idct launches and the figures."""
    digests = fixture_digests(H264_INTER_DIGESTS)
    pics = list(parse_h264(h264_session_stream()))
    cfg = ShardingConfig(1, 1)
    (fi, sps), (f1, _), (f2, _) = pics[:3]
    crop = lambda p, s: p[:sps.height // s, :sps.width // s]
    reset_counts()
    t0 = time.perf_counter()
    idr = decode_frame_rows_sharded(fi, cfg=cfg)
    t_idr = time.perf_counter() - t0
    n_idr = ID.LAUNCHES
    check(n_idr == 2, f"{n_idr} dequant_idct launches for the IDR")
    scan_counts("phase 22 IDR")
    check_digests([crop(p, s)[None] for p, s in zip(idr, (1, 2, 2))],
                  digests[:1], "row-sharded IDR")
    plain = RT.decode_frames_batch(
        fi.mb_height, fi.mb_width, *RC.stack_symbols([fi], dev),
        deblock=fi.deblock_enabled, residual_fn=ID.dequant_idct_reference)
    check(all(np.array_equal(a, b[0].cpu().numpy())
              for a, b in zip(idr, plain)),
          "row-sharded IDR != the dequant_idct_reference decode")
    # the first P picture's vertical MVs pass the halo budget: the row-
    # sharded decode refuses it, as the reference does; it is decoded
    # whole, and the second P picture row-sharded
    mvy = int(np.abs(f1.mv[..., 1]).max())
    try:
        decode_frame_rows_sharded_inter(f1, [], cfg=cfg)
        check(False, "a P picture past the halo budget was accepted")
    except NotImplementedError as e:
        check("halo budget" in str(e), str(e))
    dpb = DeviceDPB()
    dpb.add(fi, *(torch.from_numpy(a).to(dev) for a in idr))
    Y1, U1, V1 = RT.decode_frame_symbols_inter(f1, *dpb.list0(f1))
    dpb.add(f1, Y1, U1, V1)
    refs, ids = dpb.list0(f2)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    p2 = decode_frame_rows_sharded_inter(f2, refs, cfg=cfg, ref_ids=ids)
    t_p = time.perf_counter() - t0
    n_p = ID.LAUNCHES
    check(n_p == 2, f"{n_p} dequant_idct launches for the P picture")
    scan_counts("phase 22 P", "any", ">0")
    check_digests([crop(p, s)[None] for p, s in zip(p2, (1, 2, 2))],
                  digests[2:3], "row-sharded P")
    mvy2 = int(np.abs(f2.mv[..., 1]).max())
    say(f"phase 22 [{card}]: row-sharded decode at sp = 1 (one-rank NCCL "
        f"group) of the H.264 P fixture's IDR ({t_idr * 1000:.1f} ms) and "
        f"of its second P picture ({len(refs)} references, |mvy| <= {mvy2}"
        f" quarter samples; {t_p * 1000:.1f} ms): dequant_idct launched "
        f"{n_idr} + {n_p} times, all 6 planes match the libavcodec digests, "
        f"the IDR the dequant_idct_reference decode; the first P picture "
        f"(|mvy| up to {mvy} > {4 * (RT.MC_PAD - 8)}) is refused, as in "
        f"the reference")
    dist.destroy_process_group()
    return n_idr + n_p, {"slice": "row-sharded h264 1080p IDR + P, sp 1",
                         "idr_ms": t_idr * 1000, "p_ms": t_p * 1000,
                         "first_p_max_mvy": mvy, "second_p_max_mvy": mvy2,
                         "dequant_idct_launches": n_idr + n_p,
                         "card": card}


def parallel_path(dev, card, idct_rec, idct_err):
    """Phases 20-22: their launches added to the kernels' records (a
    dequant_idct record of phase 20's shapes when no other path made
    one)."""
    idct_20, shapes, err, fig20 = sharded_decode_path(dev, card)
    say(json.dumps(fig20))
    torch.cuda.empty_cache()
    say(json.dumps(pipelined_path(dev, card)))
    torch.cuda.empty_cache()
    idct_22, fig22 = row_sharded_path(dev, card)
    say(json.dumps(fig22))
    torch.cuda.empty_cache()
    if idct_rec is None:
        idct_rec = idct_record(shapes, 0, max(err, idct_err))
    idct_rec["launches_parallel"] = idct_20 + idct_22
    idct_rec["launches"] += idct_20 + idct_22
    idct_rec["max_abs_err"] = max(idct_rec["max_abs_err"], err)
    return idct_rec


def tools_path(dev, card, idct_rec):
    """Phases 23-24: their launches added to the kernels' records."""
    with tempfile.TemporaryDirectory(prefix="jmx_smoke_") as tmp:
        # ---- jmx_decode: the HEVC inter fixture ----
        plans = []
        call = DeviceRecon.__call__

        def recording(self, plan, ref_pixels):
            plans.append(plan)
            return call(self, plan, ref_pixels)

        out = os.path.join(tmp, "inter.i420")
        DeviceRecon.__call__ = recording
        try:
            reset_counts()
            t0 = time.perf_counter()
            n = jmx_decode.decode_file(INTER_FIXTURE, out)
            t_dec = time.perf_counter() - t0
        finally:
            DeviceRecon.__call__ = call
        digests = fixture_digests(INTER_DIGESTS)
        check(n == len(digests) == len(plans),
              f"jmx_decode: {n} frames, {len(plans)} on the card")
        scan_23 = hevc_scan_counts("phase 23", 2 * len(plans),
                                   4 * len(plans))
        raw = np.fromfile(out, np.uint8)
        with open(INTER_DIGESTS) as f:
            meta = json.load(f)
        w, h = meta["width"], meta["height"]
        size = w * h * 3 // 2
        check(raw.size == n * size, f"jmx_decode wrote {raw.size} bytes")
        frames = raw.reshape(n, size)
        check_digests((frames[:, :w * h].reshape(n, h, w),
                       frames[:, w * h:w * h * 5 // 4].reshape(n, h // 2,
                                                               w // 2),
                       frames[:, w * h * 5 // 4:].reshape(n, h // 2, w // 2)),
                      digests, "jmx_decode hevc inter")
        say(f"phase 23 [{card}]: jmx_decode of the HEVC inter fixture on the "
            f"card: {n} frames {w}x{h} in {t_dec:.2f} s ({n / t_dec:.2f} fps "
            f"with the file writes), all {3 * n} planes match the libavcodec "
            f"digests, hevc_scan launched {scan_23} times (two a picture)")

        # ---- jmx_transcode --scale 2: 1080p -> 960x540, then resume ----
        fx = transcode_fixture()
        src = os.path.join(tmp, "in.h264")
        with open(src, "wb") as f:
            f.write(h264_session_stream())
        job = os.path.join(tmp, "job")
        reset_counts()
        recs = jmx_transcode.transcode(src, job, qp=fx["qp"],
                                       scale=fx["scale"])
        idct_23 = ID.LAUNCHES
        scan_counts("phase 23 jmx_transcode")
        with open(os.path.join(job, "out.h264"), "rb") as f:
            stream = f.read()
        sha = hashlib.sha256(stream).hexdigest()
        check(sha == fx["stream"]["sha256"]
              and len(stream) == fx["stream"]["length"],
              f"transcode SHA-256 {sha[:12]}, {len(stream)} bytes")
        n_pics = H264_SESSION_PICTURES
        check(idct_23 == 2 * n_pics + 2 * (n_pics - 1),
              f"{idct_23} dequant_idct launches in the transcode, want 2 a "
              f"decoded picture and 2 an encoded P frame")
        again = jmx_transcode.transcode(src, job, qp=fx["qp"],
                                        scale=fx["scale"])
        with open(os.path.join(job, "out.h264"), "rb") as f:
            check(again == [] and f.read() == stream,
                  "the resumed transcode encoded again")
    for r in recs:
        share = {k: round(r[k] / r["wall_s"], 3)
                 for k in ("decode_s", "downscale_s", "encode_s")}
        say(f"phase 23 [{card}]: jmx_transcode --scale 2 GOP {r['gop']}: "
            f"{r['frames']} frames 1920x1080 -> 960x540 in "
            f"{r['wall_s']:.2f} s ({r['frames'] / r['wall_s']:.3f} fps); "
            f"share of the wall: {share}")
    say(f"phase 23: the transcode's stream equals the JAX package's "
        f"(SHA-256 {sha[:16]}..., {len(stream)} bytes); dequant_idct "
        f"launched {idct_23} times; a second call resumed and encoded "
        f"nothing")

    # ---- phase 24: device_trace around one decode ----
    with tempfile.TemporaryDirectory(prefix="jmx_trace_") as tmp:
        fss = _synthetic_symbols(4, 4, 2)
        with open(os.path.join(ROOT, "tests", "data",
                               "hevc_ctu16_64x64.h265"), "rb") as f:
            plans = parse_hevc_intra_plans(f.read())[:1]
        with device_trace(tmp):
            RT.decode_frames_batch(fss[0].mb_height, fss[0].mb_width,
                                   *RC.stack_symbols(fss, dev))
            HTT.decode_plans_batch(plans, dev)
        path = os.path.join(tmp, "trace.json")
        with open(path) as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
        n_idct = sum("dequant_idct_kernel" in n for n in names)
        n_scan = sum("hevc_scan_kernel" in n for n in names)
        check(n_idct > 0 and n_scan > 0,
              f"trace names dequant_idct {n_idct}, hevc_scan {n_scan} times")
        say(f"phase 24: device_trace wrote a Chrome trace "
            f"({os.path.getsize(path)} bytes, {len(names)} events) naming "
            f"dequant_idct_kernel {n_idct} and hevc_scan_kernel {n_scan} "
            f"times")
    if idct_rec is not None:
        idct_rec["launches_tools"] = idct_23
        idct_rec["launches"] += idct_23
    return {"slice": "jmx_decode and jmx_transcode on the card",
            "decode_frames": n, "decode_s": t_dec,
            "transcode_gops": recs, "transcode_sha256": sha,
            "scan_launches": scan_23, "dequant_idct_launches": idct_23,
            "card": card}


def bench_path(dev, card, idct_rec):
    """Phase 25: the bench's batched figures, their launches added to the
    kernels' records."""
    reset_counts()
    t0 = time.perf_counter()
    hevc = bench.bench_hevc(fixture_batch_stream(), fixture_digests(), dev,
                            reps=1)
    h264 = bench.bench_h264(h264_fixture_batch_stream(),
                            fixture_digests(H264_DIGESTS), dev, reps=1)
    dt = time.perf_counter() - t0
    idct = ID.LAUNCHES
    # each bench decodes its batch three times (checked, end to end,
    # device-only): two hevc_scan launches a HEVC decode, one launch of
    # each H.264 scan kernel a H.264 decode
    scan_counts("phase 25", 3, 3)
    scan = hevc_scan_counts("phase 25", 2 * 3)
    check(hevc["launches"] == {"hevc_walk": 0, "hevc_scan": 2,
                               "hevc_resid": 2, "dequant_idct": 0,
                               "h264_intra": 0, "h264_deblock": 0},
          f"bench_hevc launches {hevc['launches']}")
    check(h264["launches"] == {"hevc_walk": 0, "hevc_scan": 0,
                               "hevc_resid": 0, "dequant_idct": 2,
                               "h264_intra": 1, "h264_deblock": 1},
          f"bench_h264 launches {h264['launches']}")
    say(f"phase 25 [{card}]: tools/bench.py, one repeat each: bench_hevc "
        f"{hevc['frames']} frames {hevc['fps']:.2f} fps end to end, "
        f"{hevc['device_fps']:.2f} device-only, hevc_scan and hevc_resid "
        f"launched twice each in its checked decode; bench_h264 {h264['frames']} frames "
        f"{h264['fps']:.3f} fps end to end, {h264['device_fps']:.3f} "
        f"device-only, dequant_idct launched twice and the scan kernels "
        f"once each; every plane equals the libavcodec digests; "
        f"{dt:.1f} s; launches in all: hevc_scan {scan}, dequant_idct "
        f"{idct}")
    if idct_rec is not None:
        idct_rec["launches_bench"] = idct
        idct_rec["launches"] += idct
    return {"slice": "tools/bench.py batched figures", "hevc": hevc,
            "h264": h264, "wall_s": dt, "card": card}


def oracle_problem():
    """None where the libavcodec oracle builds and runs here; else one
    line: make's error, or the libraries ldd does not find."""
    if not oracle.have_oracle():
        r = subprocess.run(["make", "-C", oracle.ORACLE_DIR],
                           capture_output=True, text=True)
        err = [ln for ln in r.stderr.splitlines() if "error" in ln.lower()]
        return "make -C tests/oracle: " + " | ".join(err or [r.stderr[-300:]])
    r = subprocess.run(["ldd", oracle.ORACLE_BIN], capture_output=True,
                       text=True)
    missing = [ln.strip() for ln in r.stdout.splitlines()
               if "not found" in ln]
    return "ldd tests/oracle/oracle: " + " | ".join(missing) if missing \
        else None


def quality_path(dev, card, idct_rec):
    """Phase 26: jmx_quality --engine device on the card."""
    fx = quality_fixture()
    reset_counts()
    t0 = time.perf_counter()
    streams = quality_streams(fx, dev)
    dt = time.perf_counter() - t0
    launches = ID.LAUNCHES
    check(HW.LAUNCHES == 0, "hevc_walk launched by the encoder")
    scan_counts("phase 26", "any", ">0")
    n_p = sum(1 for i in range(fx["frames"]) if i % fx["gop"])
    check(launches == 2 * n_p * len(fx["qps"]),
          f"{launches} dequant_idct launches for {n_p} P frames a QP")
    for qp, stream in streams.items():
        got = {"sha256": hashlib.sha256(stream).hexdigest(),
               "length": len(stream)}
        check(got == fx["streams"][str(qp)],
              f"qp {qp}: the card's stream {got} is not the CPU's")
    say(f"phase 26 [{card}]: jmx_quality --engine device {fx['size']}, "
        f"{fx['frames']} frames, GOP {fx['gop']}, QPs {fx['qps']}: the "
        f"card's streams equal the --device cpu streams' SHA-256 "
        f"({dt:.1f} s); dequant_idct launched {launches} times (2 a P "
        f"frame)")
    problem = oracle_problem()
    result = None
    if problem:
        say(f"phase 26: no libavcodec oracle on this machine, so no PSNR "
            f"or BD-rate here: {problem}")
    else:
        reset_counts()
        result = jmx_quality.main(["--size", fx["size"], "--frames",
                                   str(fx["frames"]), "--gop",
                                   str(fx["gop"]), "--engine", "device"])
        launches += ID.LAUNCHES
        check(result["device"] == torch.cuda.get_device_name(0),
              f"device engine on {result['device']}")
        check([r["ours_bits"] for r in result["points"]]
              == [8 * fx["streams"][str(q)]["length"] for q in fx["qps"]],
              "the tool's streams are not the digests' streams")
        say(f"phase 26 [{card}]: BD-rate vs x264 "
            f"{result['bd_rate_vs_x264_pct']}% over {result['points']}")
    if idct_rec is not None:
        idct_rec["launches_quality"] = launches
        idct_rec["launches"] += launches
    return {"slice": "jmx_quality --engine device", "size": fx["size"],
            "frames": fx["frames"], "qps": fx["qps"], "wall_s": dt,
            "dequant_idct_launches": launches, "oracle": problem or "ok",
            "quality": result, "card": card}


def scan_capture(fn):
    """fn() with RT.intra_tiles / RT.deblock_tiles recording their
    arguments: (fn's result, {"intra": args, "deblock": args})."""
    cap, saved = {}, (RT.intra_tiles, RT.deblock_tiles)

    def rec(key, kernel):
        def run(*a, group=None):
            check(group is None, "phase 27 drives no process group")
            cap[key] = a
            return kernel(*a)
        return run

    RT.intra_tiles, RT.deblock_tiles = (rec("intra", saved[0]),
                                        rec("deblock", saved[1]))
    try:
        out = fn()
    finally:
        RT.intra_tiles, RT.deblock_tiles = saved
    return out, cap


def timed(fn):
    """(fn(), its wall in s, ended by a synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def kernel_ms(fn, name):
    """(fn()'s result, the device ms of each launch of the CUDA kernel
    whose name holds `name`) of one fn() run under torch.profiler (host
    and device activity, as the profile tools trace)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ms = [(e[3] - e[2]) / 1e3 for e in raw_events(prof)
          if e[1] == DeviceType.CUDA and name in e[0]]
    return out, ms


def intra_bound(ia, steps):
    """Bound of the h264_intra scan, over the walked diagonals `steps`.
    Bytes per macroblock it reconstructs (a valid lane that is not an inter
    macroblock of a P picture): the residual (1,536 B), modes and the six
    per-macroblock scalars (88 B) and the 71 neighbour samples (284 B) in,
    the tiles (1,536 B) out; per lane of a walked diagonal 8 B (valid,
    class). Operations: 8 per luma sample and 6 per chroma sample
    (prediction taps, residual, clip)."""
    cls, valid = ia[4][:, steps], ia[10][steps] == 1
    act = valid & (cls != 3) if ia[11] is not None else valid.expand_as(cls)
    n_mb = int(act.sum())
    nb = n_mb * (1536 + 88 + 284 + 1536) + 8 * int(valid.sum()) * cls.shape[0]
    return bound_ms(nb, n_mb * (256 * 8 + 128 * 6))


def deblock_bound(da):
    """Bound of the h264_deblock scan. Bytes per valid macroblock: its
    tiles in and out (3,072 B), the left tile's last four luma / two
    chroma columns and the top tile's last rows in and out where the
    neighbour exists (768 B each), 12 B of QP, 128 B of bS per lane (per
    frame unless one pattern serves every frame), the offsets. Operations:
    30 per luma line and 20 per chroma line of a sub-edge with bS > 0 on a
    valid lane."""
    nf, n_steps, lanes = da[3].shape
    valid = da[4] == 1
    t = torch.arange(n_steps, device=valid.device)[:, None]
    k = torch.arange(lanes, device=valid.device)[None, :]
    n_own = int(valid.sum())
    n_nb = int((valid & (t - 2 * k > 0)).sum() + (valid & (k > 0)).sum())
    bs_frames = da[9].shape[0]
    nb = (nf * (n_own * (3072 + 12) + n_nb * 768) + bs_frames * n_own * 128
          + 4 * valid.numel() + 16 * nf)
    on = lambda b: (b > 0) & valid[None, :, :, None, None]
    luma = sum(int(on(b).sum()) for b in da[9:11]) * 4
    chroma = sum(int(on(b)[..., (0, 2), :].sum()) for b in da[9:11]) * 2 * 2
    ops = (30 * luma + 20 * chroma) * (nf // bs_frames)
    return bound_ms(nb, ops)


def scan_ms(fn, name):
    """(fn()'s result, the median over REPS runs of fn() of the device ms
    of its one launch of the CUDA kernel whose name holds `name`, the
    launches traced). A run whose trace lost the launch's record (the
    profiler drops one now and then: on an H100 it kept 2 of 6 runs of an
    hevc_scan launch, and once none) is run again, at most 3 * REPS times
    more. If no run was traced, REPS runs of fn() timed by CUDA events
    behind a spin kernel stand in (the wrapper's allocations and scratch
    fill, a few us, included), and the launches traced are 0."""
    out, ms, traced = None, [], 0
    for _ in range(4 * REPS):
        out, got = kernel_ms(fn, name)
        check(len(got) <= 1, f"{name}: {len(got)} launches in one scan")
        traced += len(got)
        ms += got
        if len(ms) == REPS:
            break
    if not ms:
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(4_000_000)
            start.record()
            out = fn()
            stop.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(stop))
    return out, statistics.median(ms), traced


def timing_of(traced):
    """How scan_ms timed a kernel, for the phases' lines."""
    if traced:
        return f"median of {traced} traced runs"
    return (f"median of {REPS} runs timed by CUDA events around the call, "
            f"its scratch fill included: the profiler traced none of "
            f"{4 * REPS}")


def scan_shape(key, cap, card, floor):
    """Phase 27 at one shape: both kernels against their plain versions
    on the captured arguments, bit for bit; each kernel's ms a scan (its
    one launch), the time of one chain step, the plain version's wall for
    the scan, and the scan's bound. Returns {kernel: (ms, plain ms, bound,
    launches a decode, err, step ms)}."""
    ia, da = cap["intra"], cap["deblock"]
    walk = ia[12]
    n_steps = ia[10].shape[0]
    steps = [t for t in range(n_steps) if walk is None or walk[t]]
    out = {}
    got, ms, traced = scan_ms(lambda: HS.intra_tiles(*ia),
                              "h264_intra_kernel")
    want, t_plain = timed(lambda: RT._intra_tile_scan(*ia))
    err = max(max_abs(g, w) for g, w in zip(got, want))
    check(err == 0, f"phase 27 {key}: h264_intra != _intra_tile_scan")
    out["h264_intra"] = (ms, t_plain * 1e3, intra_bound(ia, steps), 1, err,
                         ms / n_steps, traced)
    del got, want

    got, ms, traced = scan_ms(lambda: HS.deblock_tiles(*da),
                              "h264_deblock_kernel")
    want, t_plain = timed(lambda: RT._deblock_tile_scan(*da))
    err = max(max_abs(g, w) for g, w in zip(got, want))
    check(err == 0, f"phase 27 {key}: h264_deblock != _deblock_tile_scan")
    out["h264_deblock"] = (ms, t_plain * 1e3, deblock_bound(da), 1, err,
                           ms / n_steps, traced)
    del got, want
    for name, (k_ms, p_ms, bound, n, e, step, traced) in out.items():
        say(f"phase 27 [{card}]: {name} at the {key} ({n} launch a "
            f"decode, F={ia[4].shape[0]}, {ia[4].shape[2]} lanes, "
            f"{len(steps) if name == 'h264_intra' else n_steps} of "
            f"{n_steps} diagonals): kernel {k_ms:.4f} ms a scan "
            f"({timing_of(traced)}), one step of its {n_steps}-step chain "
            f"{step * 1000:.2f} us (launch floor {floor * 1000:.2f} us), "
            f"plain version {p_ms:.1f} ms (its wall), bound {bound[0]:.5f} "
            f"ms ({bound[2]}), max_abs_err {e}")
    return out


def h264_scan_path(dev, card, floor):
    """Phase 27: the H.264 scan kernels at phase 7's batch of 32 and at
    phase 11's first P picture (floor: phase 2's launch floor). Returns
    their records (launch_floor_ms is added with the others')."""
    workers = os.cpu_count() or 1
    fss = [fs for fs, _ in parse_h264_intra_symbols(
        h264_fixture_batch_stream(), workers=workers)]
    mbh, mbw = fss[0].mb_height, fss[0].mb_width
    args = RC.stack_symbols(fss, dev)
    reset_counts()
    _, cap = scan_capture(lambda: RT.decode_frames_batch(
        mbh, mbw, *args, deblock=True))
    torch.cuda.synchronize()
    n_batch = scan_counts("phase 27 batch", 1, 1)
    check(cap["deblock"][9].shape[0] == 1 and cap["intra"][11] is None,
          "the batch's scans are not the all-intra ones")
    shapes = {"batch": scan_shape(f"batch of {len(fss)}", cap, card, floor)}
    del args, cap
    torch.cuda.empty_cache()

    pics = list(parse_h264(h264_inter_fixture_stream()))
    dpb = DeviceDPB()
    decode_symbols(pics[:1], dev, dpb=dpb)
    fs1 = pics[1][0]
    refs, ids = dpb.list0(fs1)
    torch.cuda.synchronize()
    reset_counts()
    _, cap = scan_capture(lambda: RT.decode_frame_symbols_inter(
        fs1, refs, ref_ids=ids))
    torch.cuda.synchronize()
    walked = sum(RT.intra_steps(fs1.mb_class))
    steps = mbw + 2 * (mbh - 1)
    n_p = scan_counts("phase 27 P picture", 1, 1)
    check(cap["intra"][11] is not None and 0 < walked < steps,
          "the P picture's intra scan skips nothing")
    shapes["p"] = scan_shape("first P picture", cap, card, floor)
    del cap, refs, dpb
    torch.cuda.empty_cache()

    recs = []
    for name, src, line in (("h264_intra", "h264_intra.cu", 256),
                            ("h264_deblock", "h264_deblock.cu", 787)):
        per = {k: v[name] for k, v in shapes.items()}
        mean = lambda i: statistics.mean(v[i] for v in per.values())
        bounds = [v[2] for v in per.values()]
        rec = {"name": name, "route": "cuda",
               "source": f"jmcodec_tpu_torch/csrc/{src}",
               "replaces": f"jmcodec_tpu/kernels/recon_tiles.py:{line}",
               "launches": 0, "max_abs_err": max(v[4] for v in per.values()),
               "ms": mean(0), "plain_ms": mean(1),
               "bound_ms": statistics.mean(b[0] for b in bounds),
               "bound_by": max(bounds)[1], "library_ms": None}
        for key, (k_ms, p_ms, bound, n, _, step, traced) in per.items():
            rec.update({f"ms_{key}": k_ms, f"plain_ms_{key}": p_ms,
                        f"bound_ms_{key}": bound[0],
                        f"launches_per_decode_{key}": n,
                        f"step_ms_{key}": step,
                        f"runs_traced_{key}": traced})
        recs.append(rec)
    say(f"phase 27 [{card}]: launches a decode: the batch of {len(fss)} "
        f"{n_batch} (intra, deblock), the first P picture {n_p}; a scan's "
        f"chain is {steps} macroblock steps at {mbw}x{mbh} macroblocks")
    return recs


def _row_sharded_rank(fi, f2, refs, ids, sp):
    """One rank of phase 28: the IDR and the P picture f2 (refs: its
    list-0 references on the host) row-sharded over sp ranks, each run
    twice (the second timed). Returns [(planes, counts, wall s)] of
    both."""
    dev = torch.device("cuda", dist.get_rank())
    cfg = ShardingConfig(1, sp)
    refs = [tuple(t.to(dev) for t in r) for r in refs]
    calls = ((decode_frame_rows_sharded, (fi, None, cfg)),
             (decode_frame_rows_sharded_inter, (f2, refs, None, cfg, None,
                                                ids)))
    out = []
    for fn, args in calls:
        fn(*args)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        planes, counts = with_counts(fn, *args)
        out.append((planes, counts, time.perf_counter() - t0))
    return out


def row_sharded_cards(dev, card, sp):
    """Phase 28: phase 22's pictures row-sharded over sp cards."""
    digests = fixture_digests(H264_INTER_DIGESTS)
    pics = list(parse_h264(h264_session_stream()))
    (fi, sps), (f1, _), (f2, _) = pics[:3]
    dpb = DeviceDPB()
    idr = RT.decode_frame_symbols_device(fi)
    dpb.add(fi, *idr)
    dpb.add(f1, *RT.decode_frame_symbols_inter(f1, *dpb.list0(f1)))
    refs, ids = dpb.list0(f2)
    refs = [tuple(t.cpu() for t in r) for r in refs]
    steps = fi.mb_width + 2 * (fi.mb_height - 1)
    walked = sum(RT.intra_steps(f2.mb_class))
    t0 = time.perf_counter()
    ranks = launch(_row_sharded_rank, sp, fi, f2, refs, ids, sp,
                   device="cuda")
    wall = time.perf_counter() - t0
    crop = lambda p, s: p[:sps.height // s, :sps.width // s]
    for r, rank in enumerate(ranks):
        for (planes, counts, _), want, what, intra in (
                (rank[0], digests[:1], "IDR", steps),
                (rank[1], digests[2:3], "P", walked)):
            check_digests([crop(p, s)[None] for p, s in zip(planes,
                                                            (1, 2, 2))],
                          want, f"rank {r} row-sharded {what} at sp {sp}")
            got = (counts["h264_intra"], counts["h264_deblock"],
                   counts["dequant_idct"], counts["lane_exchanges"])
            check(got == (intra, steps, 2, 0),
                  f"rank {r} {what}: (h264_intra, h264_deblock, "
                  f"dequant_idct, lane rolls) {got}, want "
                  f"{(intra, steps, 2, 0)}")
    fig = {"slice": f"row-sharded h264 1080p IDR + P, sp {sp}",
           "idr_ms": [rank[0][2] * 1000 for rank in ranks],
           "p_ms": [rank[1][2] * 1000 for rank in ranks],
           "launches_per_rank": {"h264_intra": [steps, walked],
                                 "h264_deblock": [steps, steps]},
           "wall_s": wall, "card": card}
    say(f"phase 28 [{card}]: row-sharded decode at sp = {sp} ({sp} NCCL "
        f"ranks, one card each) of the H.264 P fixture's IDR and second P "
        f"picture: on every rank all 6 planes match the libavcodec "
        f"digests; h264_intra launched {steps} / {walked} times a rank, "
        f"h264_deblock {steps} / {steps}, no lane roll of the torch scans; "
        f"IDR {min(fig['idr_ms']):.1f}-{max(fig['idr_ms']):.1f} ms, P "
        f"{min(fig['p_ms']):.1f}-{max(fig['p_ms']):.1f} ms a rank (the "
        f"second run); {wall:.1f} s with the ranks' start")
    return fig


def launch_floor_ms():
    """An empty kernel's launch to completion (torch.cuda._sleep(0): one
    thread that returns at once), timed as the kernels' ms are."""
    return statistics.median(event_ms(lambda: torch.cuda._sleep(0), 200)
                             for _ in range(5))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("hevc", "h264", "hevc_inter",
                                       "h264_inter", "session",
                                       "hevc_host", "encode", "parallel",
                                       "tools", "bench", "quality",
                                       "h264_scan", "resid"),
                    help="drive one path only (no complete kernels' record)")
    ap.add_argument("--sp", type=int, default=1,
                    help="N > 1: only the row-sharded decode on N cards "
                         "(phase 28)")
    opts = ap.parse_args()
    only = opts.only
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
    floor = launch_floor_ms()
    say(f"phase 2 [{card}]: an empty kernel (torch.cuda._sleep(0)) takes "
        f"{floor:.5f} ms from launch to completion behind a spin kernel "
        f"(median of 5 runs of 200 launches)")

    if opts.sp > 1:
        say(json.dumps(row_sharded_cards(dev, card, opts.sp)))
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    walk_rec, scan_rec, idct_rec, resid_rec = None, None, None, None
    count_plain_residuals()
    if only in (None, "hevc", "hevc_inter", "session", "hevc_host",
                "parallel", "tools", "bench"):
        walk_err = check_walk_shapes(dev)
        scan_err = check_scan_planes(dev)
    if only in (None, "hevc", "hevc_inter", "session", "hevc_host",
                "parallel", "tools", "bench", "resid"):
        resid_rec = resid_path(dev, card)
        torch.cuda.empty_cache()
    if only in (None, "hevc"):
        walk_rec, scan_rec, fig = hevc_path(dev, card, walk_err)
        say(json.dumps(fig))
        torch.cuda.empty_cache()
    if only in (None, "h264", "h264_inter", "session", "encode",
                "parallel", "tools", "bench", "quality"):
        idct_err = check_idct_kernel(dev)
    if only in (None, "h264"):
        idct_rec, fig = h264_path(dev, card, idct_err)
        say(json.dumps(fig))
        torch.cuda.empty_cache()
    if only in (None, "hevc_inter"):
        walk_rec, scan_rec, fig = hevc_inter_path(dev, card, walk_rec,
                                                  scan_rec, walk_err,
                                                  resid_rec)
        say(json.dumps(fig))
        torch.cuda.empty_cache()
    if only in (None, "h264_inter"):
        idct_rec, fig = h264_inter_path(dev, card, idct_rec, idct_err)
        say(json.dumps(fig))
        torch.cuda.empty_cache()
    if only in (None, "session"):
        session_path(dev, card, idct_rec)
        torch.cuda.empty_cache()
    if only in (None, "hevc_host"):
        hevc_host_path(dev, card)
        torch.cuda.empty_cache()
    if only in (None, "encode"):
        idct_rec = encode_path(dev, card, idct_rec, idct_err)
        torch.cuda.empty_cache()
    if only in (None, "parallel"):
        idct_rec = parallel_path(dev, card, idct_rec, idct_err)
    if only in (None, "tools"):
        say(json.dumps(tools_path(dev, card, idct_rec)))
        torch.cuda.empty_cache()
    if only in (None, "bench"):
        say(json.dumps(bench_path(dev, card, idct_rec)))
        torch.cuda.empty_cache()
    if only in (None, "quality"):
        say(json.dumps(quality_path(dev, card, idct_rec)))
        torch.cuda.empty_cache()
    scan_recs = []
    if only in (None, "h264_scan"):
        scan_recs = h264_scan_path(dev, card, floor)
        torch.cuda.empty_cache()
    for r in scan_recs:
        r["launches"] = SCANS[r["name"]]
    say(f"smoke: H.264 scan kernel launches over the paths driven {SCANS}")
    if scan_rec is not None:
        scan_rec["launches"] = HEVC_SCAN["launches"]
        scan_rec["launches_by_phase"] = HEVC_SCAN["by_phase"]
        scan_rec["max_abs_err"] = max(scan_rec["max_abs_err"], scan_err)
        say(f"smoke: hevc_scan launches over the paths driven "
            f"{HEVC_SCAN}; hevc_walk none on any path")
    if resid_rec is not None:
        resid_rec["launches"] = HEVC_RESID["launches"]
        resid_rec["launches_by_phase"] = HEVC_RESID["by_phase"]
        say(f"smoke: hevc_resid launches over the paths driven "
            f"{HEVC_RESID}; residual_reference on none")
    recs = [r for r in (walk_rec, scan_rec, resid_rec, idct_rec)
            if r is not None] + scan_recs
    for r in recs:
        r["launch_floor_ms"] = floor
    say(f"smoke: {time.perf_counter() - t_start:.1f} s in all, the "
        f"kernels' build included")
    say(json.dumps({"kernels": recs}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
