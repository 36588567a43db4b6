"""H.264 CAVLC residual coding (spec 9.2): the decode half.

Tables are transcribed from ITU-T H.264 Tables 9-5/9-7/9-8/9-9a/9-10 as bit
strings and validated structurally at import (prefix-freeness + Kraft sums;
most of these codes are complete prefix codes with Kraft sum exactly 1, which
catches transcription typos).

This is the pure-Python path of the host decoder (refdec.py). The device
path's front end is the C++ slice parser (native/), which embeds the same
tables.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ...utils.bits import BitReader

# ---------------------------------------------------------------------------
# Table 9-5: coeff_token. Four VLC classes by nC plus chroma-DC class.
# Entry: (trailing_ones, total_coeff) -> bit string.
# ---------------------------------------------------------------------------

_CT0 = {  # 0 <= nC < 2
    (0, 0): "1",
    (0, 1): "000101", (1, 1): "01",
    (0, 2): "00000111", (1, 2): "000100", (2, 2): "001",
    (0, 3): "000000111", (1, 3): "00000110", (2, 3): "0000101", (3, 3): "00011",
    (0, 4): "0000000111", (1, 4): "000000110", (2, 4): "00000101", (3, 4): "000011",
    (0, 5): "00000000111", (1, 5): "0000000110", (2, 5): "000000101", (3, 5): "0000100",
    (0, 6): "0000000001111", (1, 6): "00000000110", (2, 6): "0000000101", (3, 6): "00000100",
    (0, 7): "0000000001011", (1, 7): "0000000001110", (2, 7): "00000000101", (3, 7): "000000100",
    (0, 8): "0000000001000", (1, 8): "0000000001010", (2, 8): "0000000001101", (3, 8): "0000000100",
    (0, 9): "00000000001111", (1, 9): "00000000001110", (2, 9): "0000000001001", (3, 9): "00000000100",
    (0, 10): "00000000001011", (1, 10): "00000000001010", (2, 10): "00000000001101", (3, 10): "0000000001100",
    (0, 11): "000000000001111", (1, 11): "000000000001110", (2, 11): "00000000001001", (3, 11): "00000000001100",
    (0, 12): "000000000001011", (1, 12): "000000000001010", (2, 12): "000000000001101", (3, 12): "00000000001000",
    (0, 13): "0000000000001111", (1, 13): "000000000000001", (2, 13): "000000000001001", (3, 13): "000000000001100",
    (0, 14): "0000000000001011", (1, 14): "0000000000001110", (2, 14): "0000000000001101", (3, 14): "000000000001000",
    (0, 15): "0000000000000111", (1, 15): "0000000000001010", (2, 15): "0000000000001001", (3, 15): "0000000000001100",
    (0, 16): "0000000000000100", (1, 16): "0000000000000110", (2, 16): "0000000000000101", (3, 16): "0000000000001000",
}

_CT1 = {  # 2 <= nC < 4
    (0, 0): "11",
    (0, 1): "001011", (1, 1): "10",
    (0, 2): "000111", (1, 2): "00111", (2, 2): "011",
    (0, 3): "0000111", (1, 3): "001010", (2, 3): "001001", (3, 3): "0101",
    (0, 4): "00000111", (1, 4): "000110", (2, 4): "000101", (3, 4): "0100",
    (0, 5): "00000100", (1, 5): "0000110", (2, 5): "0000101", (3, 5): "00110",
    (0, 6): "000000111", (1, 6): "00000110", (2, 6): "00000101", (3, 6): "001000",
    (0, 7): "00000001111", (1, 7): "000000110", (2, 7): "000000101", (3, 7): "000100",
    (0, 8): "00000001011", (1, 8): "00000001110", (2, 8): "00000001101", (3, 8): "0000100",
    (0, 9): "000000001111", (1, 9): "00000001010", (2, 9): "00000001001", (3, 9): "000000100",
    (0, 10): "000000001011", (1, 10): "000000001110", (2, 10): "000000001101", (3, 10): "00000001100",
    (0, 11): "000000001000", (1, 11): "000000001010", (2, 11): "000000001001", (3, 11): "00000001000",
    (0, 12): "0000000001111", (1, 12): "0000000001110", (2, 12): "0000000001101", (3, 12): "000000001100",
    (0, 13): "0000000001011", (1, 13): "0000000001010", (2, 13): "0000000001001", (3, 13): "0000000001100",
    (0, 14): "0000000000111", (1, 14): "00000000001011", (2, 14): "0000000000110", (3, 14): "0000000001000",
    (0, 15): "00000000001001", (1, 15): "00000000001000", (2, 15): "00000000001010", (3, 15): "0000000000001",
    (0, 16): "00000000000111", (1, 16): "00000000000110", (2, 16): "00000000000101", (3, 16): "00000000000100",
}

_CT2 = {  # 4 <= nC < 8
    (0, 0): "1111",
    (0, 1): "001111", (1, 1): "1110",
    (0, 2): "001011", (1, 2): "01111", (2, 2): "1101",
    (0, 3): "001000", (1, 3): "01100", (2, 3): "01110", (3, 3): "1100",
    (0, 4): "0001111", (1, 4): "01010", (2, 4): "01011", (3, 4): "1011",
    (0, 5): "0001011", (1, 5): "01000", (2, 5): "01001", (3, 5): "1010",
    (0, 6): "0001001", (1, 6): "001110", (2, 6): "001101", (3, 6): "1001",
    (0, 7): "0001000", (1, 7): "001010", (2, 7): "001001", (3, 7): "1000",
    (0, 8): "00001111", (1, 8): "0001110", (2, 8): "0001101", (3, 8): "01101",
    (0, 9): "00001011", (1, 9): "00001110", (2, 9): "0001010", (3, 9): "001100",
    (0, 10): "000001111", (1, 10): "00001010", (2, 10): "00001101", (3, 10): "0001100",
    (0, 11): "000001011", (1, 11): "000001110", (2, 11): "00001001", (3, 11): "00001100",
    (0, 12): "000001000", (1, 12): "000001010", (2, 12): "000001101", (3, 12): "00001000",
    (0, 13): "0000001101", (1, 13): "000000111", (2, 13): "000001001", (3, 13): "000001100",
    (0, 14): "0000001001", (1, 14): "0000001100", (2, 14): "0000001011", (3, 14): "0000001010",
    (0, 15): "0000000101", (1, 15): "0000001000", (2, 15): "0000000111", (3, 15): "0000000110",
    (0, 16): "0000000001", (1, 16): "0000000100", (2, 16): "0000000011", (3, 16): "0000000010",
}

_CT_CHROMA_DC = {  # nC == -1 (4:2:0), maxNumCoeff 4
    (0, 0): "01",
    (0, 1): "000111", (1, 1): "1",
    (0, 2): "000100", (1, 2): "000110", (2, 2): "001",
    (0, 3): "000011", (1, 3): "0000011", (2, 3): "0000010", (3, 3): "000101",
    (0, 4): "000010", (1, 4): "00000011", (2, 4): "00000010", (3, 4): "0000000",
}

# ---------------------------------------------------------------------------
# Tables 9-7/9-8: total_zeros for 4x4 blocks, indexed [TotalCoeff][total_zeros]
# ---------------------------------------------------------------------------

_TOTAL_ZEROS_4x4: Dict[int, List[str]] = {
    1: ["1", "011", "010", "0011", "0010", "00011", "00010", "000011",
        "000010", "0000011", "0000010", "00000011", "00000010", "000000011",
        "000000010", "000000001"],
    2: ["111", "110", "101", "100", "011", "0101", "0100", "0011", "0010",
        "00011", "00010", "000011", "000010", "000001", "000000"],
    3: ["0101", "111", "110", "101", "0100", "0011", "100", "011", "0010",
        "00011", "00010", "000001", "00001", "000000"],
    4: ["00011", "111", "0101", "0100", "110", "101", "100", "0011", "011",
        "0010", "00010", "00001", "00000"],
    5: ["0101", "0100", "0011", "111", "110", "101", "100", "011", "0010",
        "00001", "0001", "00000"],
    6: ["000001", "00001", "111", "110", "101", "100", "011", "010", "0001",
        "001", "000000"],
    7: ["000001", "00001", "101", "100", "011", "11", "010", "0001", "001",
        "000000"],
    8: ["000001", "0001", "00001", "011", "11", "10", "010", "001", "000000"],
    9: ["000001", "000000", "0001", "11", "10", "001", "01", "00001"],
    10: ["00001", "00000", "001", "11", "10", "01", "0001"],
    11: ["0000", "0001", "001", "010", "1", "011"],
    12: ["0000", "0001", "01", "1", "001"],
    13: ["000", "001", "1", "01"],
    14: ["00", "01", "1"],
    15: ["0", "1"],
}

# Table 9-9(a): total_zeros for chroma DC (4:2:0)
_TOTAL_ZEROS_CHROMA_DC: Dict[int, List[str]] = {
    1: ["1", "01", "001", "000"],
    2: ["1", "01", "00"],
    3: ["1", "0"],
}

# Table 9-10: run_before, indexed [min(zerosLeft,7)][run_before]
_RUN_BEFORE: Dict[int, List[str]] = {
    1: ["1", "0"],
    2: ["1", "01", "00"],
    3: ["11", "10", "01", "00"],
    4: ["11", "10", "01", "001", "000"],
    5: ["11", "10", "011", "010", "001", "000"],
    6: ["11", "000", "001", "011", "010", "101", "100"],
    7: ["111", "110", "101", "100", "011", "010", "001", "0001", "00001",
        "000001", "0000001", "00000001", "000000001", "0000000001",
        "00000000001"],
}


# ---------------------------------------------------------------------------
# Structural validation + fast decode LUT construction
# ---------------------------------------------------------------------------

class _VlcDecoder:
    """Prefix-code decoder via a peek table of width max_len."""

    __slots__ = ("max_len", "lut")

    def __init__(self, code_to_sym: Dict[str, object], name: str,
                 complete: bool = True):
        codes = list(code_to_sym)
        # prefix-freeness
        srt = sorted(codes)
        for a, b in zip(srt, srt[1:]):
            if b.startswith(a):
                raise ValueError(f"{name}: '{a}' is a prefix of '{b}'")
        self.max_len = max(len(c) for c in codes)
        self.lut = {}
        for code, sym in code_to_sym.items():
            pad = self.max_len - len(code)
            base = int(code, 2) << pad
            for fill in range(1 << pad):
                key = base | fill
                if key in self.lut:
                    raise ValueError(f"{name}: codeword collision")
                self.lut[key] = (len(code), sym)
        # Completeness: every peek value must decode, except (in several spec
        # tables) the deliberately unused all-zeros codeword prefix. Any other
        # hole indicates a transcription typo.
        holes = sorted(set(range(1 << self.max_len)) - set(self.lut))
        if holes and holes != list(range(len(holes))):
            raise ValueError(
                f"{name}: holes are not the all-zeros prefix (transcription bug?)")

    def decode(self, r: BitReader):
        key = r.peek(self.max_len)
        hit = self.lut.get(key)
        if hit is None:
            raise ValueError("invalid VLC code in bitstream")
        r.skip(hit[0])
        return hit[1]


def _invert(tab: Dict[Tuple[int, int], str]) -> Dict[str, Tuple[int, int]]:
    return {v: k for k, v in tab.items()}


_CT_DEC = [
    _VlcDecoder(_invert(_CT0), "coeff_token[0<=nC<2]", complete=False),
    _VlcDecoder(_invert(_CT1), "coeff_token[2<=nC<4]", complete=False),
    _VlcDecoder(_invert(_CT2), "coeff_token[4<=nC<8]", complete=False),
    None,  # nC >= 8: fixed-length, handled inline
    _VlcDecoder(_invert(_CT_CHROMA_DC), "coeff_token[chromaDC]"),
]

_TZ_DEC = {tc: _VlcDecoder({c: i for i, c in enumerate(codes)},
                           f"total_zeros[{tc}]")
           for tc, codes in _TOTAL_ZEROS_4x4.items()}
_TZC_DEC = {tc: _VlcDecoder({c: i for i, c in enumerate(codes)},
                            f"total_zeros_cdc[{tc}]")
            for tc, codes in _TOTAL_ZEROS_CHROMA_DC.items()}
_RB_DEC = {zl: _VlcDecoder({c: i for i, c in enumerate(codes)},
                           f"run_before[{zl}]", complete=(zl < 7))
           for zl, codes in _RUN_BEFORE.items()}


def _nc_class(nC: int) -> int:
    if nC < 0:
        return 4
    if nC < 2:
        return 0
    if nC < 4:
        return 1
    if nC < 8:
        return 2
    return 3


# ---------------------------------------------------------------------------
# Decode (spec 9.2.1-9.2.4)
# ---------------------------------------------------------------------------

def decode_residual_block(r: BitReader, nC: int, max_num_coeff: int) -> List[int]:
    """residual_block_cavlc: returns coefficients in scan order (len max_num_coeff).
    Also returns TotalCoeff via the second tuple element."""
    cls = _nc_class(nC)
    if cls == 3:
        code = r.u(6)
        if code == 3:
            trailing_ones, total_coeff = 0, 0
        else:
            trailing_ones = code & 3
            total_coeff = (code >> 2) + 1
    else:
        trailing_ones, total_coeff = _CT_DEC[cls].decode(r)

    coeffs = [0] * max_num_coeff
    if total_coeff == 0:
        return coeffs, 0

    # levels, bitstream order = highest frequency first
    levels = []
    for i in range(trailing_ones):
        levels.append(-1 if r.u(1) else 1)
    suffix_length = 1 if (total_coeff > 10 and trailing_ones < 3) else 0
    for i in range(trailing_ones, total_coeff):
        # level_prefix: leading zeros before a 1
        level_prefix = 0
        while r.u(1) == 0:
            level_prefix += 1
            if level_prefix > 32:
                raise ValueError("level_prefix too long")
        if level_prefix >= 15:
            level_suffix_size = level_prefix - 3
        elif level_prefix == 14 and suffix_length == 0:
            level_suffix_size = 4
        else:
            level_suffix_size = suffix_length
        level_suffix = r.u(level_suffix_size) if level_suffix_size else 0
        level_code = (min(15, level_prefix) << suffix_length) + level_suffix
        if level_prefix >= 15 and suffix_length == 0:
            level_code += 15
        if level_prefix >= 16:
            level_code += (1 << (level_prefix - 3)) - 4096
        if i == trailing_ones and trailing_ones < 3:
            level_code += 2
        if level_code % 2 == 0:
            level = (level_code + 2) >> 1
        else:
            level = (-level_code - 1) >> 1
        levels.append(level)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    # total_zeros
    if total_coeff < max_num_coeff:
        if nC < 0:
            total_zeros = _TZC_DEC[total_coeff].decode(r)
        else:
            total_zeros = _TZ_DEC[total_coeff].decode(r)
    else:
        total_zeros = 0

    # runs
    zeros_left = total_zeros
    pos = total_coeff - 1 + total_zeros
    for i in range(total_coeff):
        coeffs[pos] = levels[i]
        if i < total_coeff - 1:
            if zeros_left > 0:
                run = _RB_DEC[min(zeros_left, 7)].decode(r)
            else:
                run = 0
            zeros_left -= run
            pos -= 1 + run
    return coeffs, total_coeff
