"""H.264 Annex-B NAL unit layer: start-code scan, RBSP (de)escaping, NAL headers.

Capability parity with the reference's hand-rolled NALU splitter
(test_nv_dec/test_nv_dec.cpp:30-86 find_nalu_prefix/find_nalu) and the EBSP
handling the vendor parsers did internally. The hot-path scanner also exists in
C++ (native/); this module is the reference implementation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple

# nal_unit_type values (spec Table 7-1)
NAL_SLICE_NON_IDR = 1
NAL_SLICE_PART_A = 2
NAL_SLICE_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_AUD = 9
NAL_END_SEQ = 10
NAL_END_STREAM = 11
NAL_FILLER = 12


@dataclass
class NalUnit:
    nal_ref_idc: int
    nal_unit_type: int
    rbsp: bytes  # payload with emulation-prevention bytes removed

    @property
    def is_slice(self) -> bool:
        return self.nal_unit_type in (NAL_SLICE_NON_IDR, NAL_SLICE_IDR)

    @property
    def is_idr(self) -> bool:
        return self.nal_unit_type == NAL_SLICE_IDR


def split_annexb(data: bytes) -> Iterator[Tuple[int, int]]:
    """Yield (start, end) byte ranges of NAL payloads (after the start code).

    Accepts both 3-byte (00 00 01) and 4-byte (00 00 00 01) start codes, like
    the reference splitter (test_nv_dec.cpp:30-61).
    """
    n = len(data)
    i = data.find(b"\x00\x00\x01")
    while i != -1 and i < n:
        payload_start = i + 3
        nxt = data.find(b"\x00\x00\x01", payload_start)
        if nxt == -1:
            end = n
        else:
            end = nxt
            # trailing zero of a 4-byte start code belongs to the next NAL
            if end > payload_start and data[end - 1] == 0:
                end -= 1
        # strip trailing zero padding (trailing_zero_8bits)
        while end > payload_start and data[end - 1] == 0:
            end -= 1
        if end > payload_start:
            yield (payload_start, end)
        i = nxt
    return


def ebsp_to_rbsp(ebsp: bytes) -> bytes:
    """Remove emulation_prevention_three_byte (spec 7.4.1.1).

    Splice-based (escapes are sparse), so large slices don't pay a per-byte
    Python loop."""
    pos = ebsp.find(b"\x00\x00\x03")
    if pos == -1:
        return ebsp
    out = bytearray()
    start = 0
    n = len(ebsp)
    while pos != -1:
        out += ebsp[start:pos + 2]
        start = pos + 3  # drop the 0x03
        # next escape cannot overlap the bytes we just consumed
        pos = ebsp.find(b"\x00\x00\x03", start)
    out += ebsp[start:n]
    return bytes(out)


def rbsp_to_ebsp(rbsp: bytes) -> bytes:
    """Insert emulation prevention bytes so no 00 00 0x (x<=3) sequence occurs."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def parse_nal_units(data: bytes) -> List[NalUnit]:
    """Split an Annex-B elementary stream into parsed NAL units."""
    units = []
    for s, e in split_annexb(data):
        hdr = data[s]
        if hdr & 0x80:
            raise ValueError("forbidden_zero_bit set in NAL header")
        units.append(
            NalUnit(
                nal_ref_idc=(hdr >> 5) & 3,
                nal_unit_type=hdr & 0x1F,
                rbsp=ebsp_to_rbsp(data[s + 1 : e]),
            )
        )
    return units


def write_nal_unit(nal_ref_idc: int, nal_unit_type: int, rbsp: bytes,
                   long_startcode: bool = True) -> bytes:
    """Serialize one NAL unit with an Annex-B start code."""
    sc = b"\x00\x00\x00\x01" if long_startcode else b"\x00\x00\x01"
    hdr = bytes([(nal_ref_idc << 5) | nal_unit_type])
    return sc + hdr + rbsp_to_ebsp(rbsp)
