"""Frame-pipeline parallelism: the HEVC all-intra decode split into its two
stages, the wavefront SCAN and the in-loop FILTERS, each pinned to a
device of its own, so that batch t's filtering overlaps batch t+1's scan.
The port of jmcodec_tpu/parallel/framepp.py.

Each stage issues on a CUDA stream of its own; the hand-off of the int32
plane batch is a non_blocking copy onto the filter device, ordered after
the scan by an event, so the host goes on to issue the next batch's scan
while the filters run (the counterpart of JAX's asynchronous dispatch). On
the CPU both stages run in order on the host.

Bit-exactness: the stages are the same functions the one-device decode
runs (kernels/hevc_tiles.decode_frames_hevc_{scan,filters}), so the output
equals decode_frames_hevc_batch's by construction; the tests assert it.
"""

from __future__ import annotations

import contextlib

import torch

from ..kernels import hevc_tiles as HTT
from ..utils.device import require_cuda


def _stream(dev: torch.device):
    return torch.cuda.Stream(dev) if dev.type == "cuda" else None


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()


def default_devices():
    """The reference's defaults: device 0 for the scan, device 1 for the
    filters where there is one, else device 0 again (raises without a
    card)."""
    d0 = require_cuda()
    return d0, torch.device("cuda", min(1, torch.cuda.device_count() - 1))


def _hand_off(tensors, d_filter, s_scan, s_filter):
    """The scan stage's tensors on d_filter for the filter stream: that
    stream waits for the scan, a tensor of another device is copied
    (non_blocking) and each source is marked as in use by the stream that
    reads it, so that the allocator does not hand its memory to the next
    batch's scan too early."""
    if s_filter is None:
        return [a.to(d_filter) for a in tensors]
    s_filter.wait_stream(s_scan)
    with torch.cuda.stream(s_filter):
        moved = [a.to(d_filter, non_blocking=True) for a in tensors]
    for a in tensors:
        a.record_stream(s_filter if a.device == d_filter
                        else torch.cuda.current_stream(a.device))
    return moved


def decode_plans_pipelined(plans, d_scan=None, d_filter=None,
                           batch: int = 1):
    """Decode same-geometry all-intra HevcFramePlans with the scan stage on
    `d_scan` and the filter stage on `d_filter` (None: default_devices();
    both CUDA or both "cpu"). Returns a list of (Y, U, V) uint8 batches on
    d_filter, in input order, ready on its current stream; batch t's
    filtering is in flight while batch t+1 is being scanned."""
    HTT._check_plans(plans)
    if d_scan is None or d_filter is None:
        s0, f0 = default_devices()
        d_scan = s0 if d_scan is None else d_scan
        d_filter = f0 if d_filter is None else d_filter
    d_scan, d_filter = torch.device(d_scan), torch.device(d_filter)
    s_scan, s_filter = _stream(d_scan), _stream(d_filter)

    outs = []
    for i in range(0, len(plans), batch):
        with _on(s_scan):
            args = HTT.stack_plans(plans[i:i + batch], d_scan)
            (Hp, Wp, l2, strong, dbk, pw, ph, w, h) = args[:9]
            (coeff_y, tu_y, mode_y, zidx_y, qp_y, coeff_cb, coeff_cr, tu_c,
             mode_c, zidx_c, cbo, cro, bo, to, bs_v, bs_h, s_t, s_o, s_b,
             s_e) = args[9:]
            Y, U, V = HTT.decode_frames_hevc_scan(
                Hp, Wp, l2, strong, coeff_y, tu_y, mode_y, zidx_y, qp_y,
                coeff_cb, coeff_cr, tu_c, mode_c, zidx_c, cbo, cro)
        moved = _hand_off((Y, U, V, qp_y, cbo, cro, bo, to, bs_v, bs_h, s_t,
                           s_o, s_b, s_e), d_filter, s_scan, s_filter)
        with _on(s_filter):
            outs.append(HTT.decode_frames_hevc_filters(l2, dbk, pw, ph, w, h,
                                                       *moved))
    if s_filter is not None:
        cur = torch.cuda.current_stream(d_filter)
        cur.wait_stream(s_filter)
        for planes in outs:
            for a in planes:
                a.record_stream(cur)
    return outs

