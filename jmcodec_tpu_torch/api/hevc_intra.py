"""Host front end of the HEVC all-intra decode: Annex-B stream ->
HevcFramePlans, one per picture, filled by the native CABAC parser.

The plans feed kernels.hevc_tiles.decode_plans_batch.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from .. import native
from ..codec.hevc import nal as HN
from ..codec.hevc.params import parse_pps, parse_sps
from ..codec.hevc.plan import HevcFramePlan
from ..codec.hevc.refdec import _substream_offsets
from ..codec.hevc.slicehdr import I_SLICE, parse_slice_header


def parse_hevc_intra_plans(stream: bytes, workers: int = 1):
    """Parse an all-intra, one-slice-per-picture HEVC stream into
    HevcFramePlans in decode order. workers > 1 parses pictures on that
    many threads (the native parser releases the GIL). Raises ValueError
    on a non-intra slice."""
    sps, pps, slices = {}, {}, []
    for u in HN.parse_nal_units(stream):
        if u.nal_unit_type == HN.NAL_SPS:
            s = parse_sps(u.rbsp)
            sps[s.sps_id] = s
        elif u.nal_unit_type == HN.NAL_PPS:
            p = parse_pps(u.rbsp)
            pps[p.pps_id] = p
        elif u.is_slice:
            slices.append(u)
    p0 = pps[0]
    s0 = sps[p0.sps_id]

    def parse_one(u):
        hdr = parse_slice_header(u.rbsp, u.nal_unit_type, s0, p0)
        if hdr.slice_type != I_SLICE:
            raise ValueError("not an all-intra stream")
        plan = HevcFramePlan.create(s0)
        plan.record_slice(hdr, p0)
        native.hevc_fill_plan(plan, hdr, s0, p0, u.rbsp,
                              _substream_offsets(hdr, u.emu_positions))
        return plan

    if workers <= 1:
        return [parse_one(u) for u in slices]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(parse_one, slices))
