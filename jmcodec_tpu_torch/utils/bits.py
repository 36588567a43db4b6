"""Bitstream reader/writer with Exp-Golomb coding (H.264/HEVC shared).

TPU-native rebuild of the byte-level plumbing the reference keeps inside its
growable bitstream buffers (ref: intel_dec/intel_dec.cpp:189-234 input ring,
nv_enc/nv_enc.cpp:162-230 bitstream lock/copy). Here the host-side entropy
front-end needs a real bit reader, since we implement the codec math ourselves.

Pure-Python implementation is the *reference* path (clear, testable); the hot
production path is the C++ slice parser in native/.
"""

from __future__ import annotations


class BitReader:
    """MSB-first bit reader over a bytes-like object (RBSP payload)."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position
        self.nbits = 8 * len(data)

    def bits_left(self) -> int:
        return self.nbits - self.pos

    def byte_aligned(self) -> bool:
        return (self.pos & 7) == 0

    def u(self, n: int) -> int:
        """Read n bits as unsigned int (n may be 0)."""
        if n == 0:
            return 0
        pos = self.pos
        if pos + n > self.nbits:
            raise EOFError(f"BitReader: read {n} bits at {pos}/{self.nbits}")
        self.pos = pos + n
        # Gather from the containing bytes.
        first = pos >> 3
        last = (pos + n - 1) >> 3
        chunk = int.from_bytes(self.data[first : last + 1], "big")
        total = (last + 1 - first) * 8
        shift = total - (pos & 7) - n
        return (chunk >> shift) & ((1 << n) - 1)

    def flag(self) -> int:
        return self.u(1)

    def peek(self, n: int) -> int:
        """Peek up to n bits without consuming; zero-pads past the end."""
        pos, left = self.pos, self.nbits - self.pos
        if left <= 0:
            return 0
        take = min(n, left)
        v = self.u(take)
        self.pos = pos
        return v << (n - take)

    def skip(self, n: int) -> None:
        if self.pos + n > self.nbits:
            raise EOFError("BitReader: skip past end")
        self.pos += n

    def ue(self) -> int:
        """Unsigned Exp-Golomb (ue(v), spec 9.1)."""
        zeros = 0
        while True:
            if self.pos >= self.nbits:
                raise EOFError("BitReader: ue() past end")
            if self.u(1):
                break
            zeros += 1
            if zeros > 32:
                raise ValueError("BitReader: ue() leading zeros > 32")
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        """Signed Exp-Golomb (se(v), spec 9.1.1): k -> (-1)^(k+1) * ceil(k/2)."""
        k = self.ue()
        if k & 1:
            return (k + 1) >> 1
        return -(k >> 1)

    def more_rbsp_data(self) -> bool:
        """True if there is RBSP data before the rbsp_stop_one_bit (spec 7.2)."""
        left = self.nbits - self.pos
        if left <= 0:
            return False
        # Find last set bit in the remaining stream = rbsp_stop_one_bit.
        pos = self.pos
        # Scan from the last byte backwards.
        for byte_idx in range(len(self.data) - 1, (pos >> 3) - 1, -1):
            b = self.data[byte_idx]
            if b:
                # lowest set bit of b
                low = b & (-b)
                stop_bit_pos = byte_idx * 8 + (7 - low.bit_length() + 1)
                return pos < stop_bit_pos
        return False


class BitWriter:
    """MSB-first bit writer producing RBSP payloads."""

    __slots__ = ("_buf", "_cur", "_curbits")

    def __init__(self):
        self._buf = bytearray()
        self._cur = 0
        self._curbits = 0

    def u(self, value: int, n: int) -> None:
        if n == 0:
            return
        if value < 0 or value >= (1 << n):
            raise ValueError(f"BitWriter: {value} does not fit in {n} bits")
        cur = (self._cur << n) | value
        curbits = self._curbits + n
        while curbits >= 8:
            curbits -= 8
            self._buf.append((cur >> curbits) & 0xFF)
        self._cur = cur & ((1 << curbits) - 1)
        self._curbits = curbits

    def flag(self, v) -> None:
        self.u(1 if v else 0, 1)

    def ue(self, k: int) -> None:
        if k < 0:
            raise ValueError("ue() needs k >= 0")
        kp1 = k + 1
        nbits = kp1.bit_length()
        self.u(0, nbits - 1)
        self.u(kp1, nbits)

    def se(self, v: int) -> None:
        if v > 0:
            self.ue(2 * v - 1)
        else:
            self.ue(-2 * v)

    def rbsp_trailing_bits(self) -> None:
        """rbsp_stop_one_bit + alignment zeros (spec 7.3.2.11)."""
        self.u(1, 1)
        self.align()

    def align(self) -> None:
        if self._curbits:
            self.u(0, 8 - self._curbits)

    def bitpos(self) -> int:
        return len(self._buf) * 8 + self._curbits

    def bytes(self) -> bytes:
        if self._curbits:
            raise ValueError("BitWriter: not byte-aligned; call rbsp_trailing_bits()")
        return bytes(self._buf)


def ue_len(k: int) -> int:
    """Bit length of ue(k)."""
    return 2 * (k + 1).bit_length() - 1


def se_len(v: int) -> int:
    k = 2 * v - 1 if v > 0 else -2 * v
    return ue_len(k)
