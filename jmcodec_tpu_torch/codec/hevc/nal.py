"""HEVC (H.265) NAL layer: 2-byte headers, Annex-B framing (spec 7.3.1.1).

Shares the start-code scanner and EBSP handling with the H.264 layer; the
header layout differs (6-bit type, layer id, temporal id)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..h264.nal import ebsp_to_rbsp, rbsp_to_ebsp, split_annexb

# nal_unit_type (Table 7-1)
NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_AUD = 35
NAL_EOS = 36
NAL_EOB = 37
NAL_FD = 38
NAL_PREFIX_SEI = 39
NAL_SUFFIX_SEI = 40


def ebsp_to_rbsp_pos(ebsp: bytes):
    """Like ebsp_to_rbsp but also returns the RBSP indices at which an
    emulation_prevention_three_byte was removed (needed to convert
    entry_point_offset values, which count EBSP bytes, spec 7.4.7.1)."""
    pos = ebsp.find(b"\x00\x00\x03")
    if pos == -1:
        return ebsp, []
    out = bytearray()
    removed = []
    start = 0
    while pos != -1:
        out += ebsp[start:pos + 2]
        removed.append(len(out))  # a 0x03 sat before out[len(out)]
        start = pos + 3
        pos = ebsp.find(b"\x00\x00\x03", start)
    out += ebsp[start:]
    return bytes(out), removed


def ebsp_offset_to_rbsp(ebsp_off: int, removed) -> int:
    """Map an EBSP byte offset to the RBSP offset given the removed-byte
    positions from ebsp_to_rbsp_pos. The i-th removed byte occupies EBSP
    index removed[i] + i."""
    r = ebsp_off
    for i, p in enumerate(removed):
        if p + i < ebsp_off:
            r -= 1
        else:
            break
    return r


@dataclass
class HevcNalUnit:
    nal_unit_type: int
    nuh_layer_id: int
    nuh_temporal_id: int  # = nuh_temporal_id_plus1 - 1
    rbsp: bytes
    emu_positions: List[int] = None

    @property
    def is_slice(self) -> bool:
        return self.nal_unit_type < 32

    @property
    def is_irap(self) -> bool:
        return 16 <= self.nal_unit_type <= 23

    @property
    def is_idr(self) -> bool:
        return self.nal_unit_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP)


def parse_nal_units(data: bytes) -> List[HevcNalUnit]:
    units = []
    for s, e in split_annexb(data):
        if e - s < 2:
            continue
        b0, b1 = data[s], data[s + 1]
        if b0 & 0x80:
            raise ValueError("forbidden_zero_bit set in HEVC NAL header")
        rbsp, removed = ebsp_to_rbsp_pos(data[s + 2:e])
        units.append(HevcNalUnit(
            nal_unit_type=(b0 >> 1) & 0x3F,
            nuh_layer_id=((b0 & 1) << 5) | (b1 >> 3),
            nuh_temporal_id=(b1 & 7) - 1,
            rbsp=rbsp, emu_positions=removed))
    return units


def write_nal_unit(nal_unit_type: int, rbsp: bytes, layer_id: int = 0,
                   temporal_id: int = 0, long_startcode: bool = True) -> bytes:
    sc = b"\x00\x00\x00\x01" if long_startcode else b"\x00\x00\x01"
    b0 = (nal_unit_type << 1) | (layer_id >> 5)
    b1 = ((layer_id & 0x1F) << 3) | (temporal_id + 1)
    return sc + bytes([b0, b1]) + rbsp_to_ebsp(rbsp)
