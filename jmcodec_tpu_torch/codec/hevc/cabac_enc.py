"""HEVC CABAC arithmetic encoder (H.265 9.3.4.4 counterpart of the
decoder engine in cabac.py; same context model and LPS/transition tables).

The reference delegates entropy ENCODING to vendor silicon
(nv_enc/nv_enc.cpp:121 nvEncEncodePicture; intel_enc/intel_enc.cpp:917);
with no silicon in the loop it becomes an explicit host component. The
byte-output discipline (buffered byte + 0xFF run carry propagation) follows
the well-known HM/x265 structure; produced bins round-trip through our own
decoder (cabac.py) bit-exactly, which the tests assert per stream.
"""

from __future__ import annotations

from ..h264.cabac_tables import LPS_RANGE, TRANS_IDX_LPS, TRANS_IDX_MPS
from . import cabac_tables as T

_LPS = [int(v) for v in LPS_RANGE.reshape(-1)]
_TMPS = [int(v) for v in TRANS_IDX_MPS]
_TLPS = [int(v) for v in TRANS_IDX_LPS]


class HevcCabacEncoder:
    """Binary arithmetic encoder over the HEVC context set."""

    def __init__(self, slice_qp: int, init_type: int):
        self.buf = bytearray()
        self.low = 0
        self.range = 510
        self.bits_left = 23
        self.n_buffered = 0
        self.buffered = 0xFF
        self.init_contexts(slice_qp, init_type)

    def init_contexts(self, slice_qp: int, init_type: int) -> None:
        qp = max(0, min(51, slice_qp))
        state, mps = [], []
        for iv in T.CTX_INIT[init_type]:
            iv = int(iv)
            m = (iv >> 4) * 5 - 45
            n = ((iv & 15) << 3) - 16
            pre = min(max(((m * qp) >> 4) + n, 1), 126)
            if pre > 63:
                mps.append(1)
                state.append(pre - 64)
            else:
                mps.append(0)
                state.append(63 - pre)
        self.state = state
        self.mps = mps

    # -- byte output (buffered-byte carry discipline) -----------------------

    def _write_out(self):
        lead = self.low >> (24 - self.bits_left)
        self.bits_left += 8
        self.low &= 0xFFFFFFFF >> self.bits_left
        if lead == 0xFF:
            self.n_buffered += 1
        elif self.n_buffered > 0:
            carry = lead >> 8
            self.buf.append((self.buffered + carry) & 0xFF)
            fill = (0xFF + carry) & 0xFF
            for _ in range(self.n_buffered - 1):
                self.buf.append(fill)
            self.buffered = lead & 0xFF
            self.n_buffered = 1
        else:
            self.n_buffered = 1
            self.buffered = lead & 0xFF

    def _test_write(self):
        if self.bits_left < 12:
            self._write_out()

    # -- bin coding ---------------------------------------------------------

    def encode(self, ctx: int, b: int) -> None:
        s = self.state[ctx]
        rng = self.range
        lps = _LPS[(s << 2) | ((rng >> 6) & 3)]
        rng -= lps
        if b != self.mps[ctx]:
            nbits = 0
            while (lps << nbits) < 256:
                nbits += 1
            self.low = (self.low + rng) << nbits
            self.range = lps << nbits
            if s == 0:
                self.mps[ctx] ^= 1
            self.state[ctx] = _TLPS[s]
            self.bits_left -= nbits
            self._test_write()
        else:
            self.state[ctx] = _TMPS[s]
            if rng >= 256:
                self.range = rng
                return
            self.low <<= 1
            self.range = rng << 1
            self.bits_left -= 1
            self._test_write()

    def bypass(self, b: int) -> None:
        self.low <<= 1
        if b:
            self.low += self.range
        self.bits_left -= 1
        self._test_write()

    def bypass_bits(self, v: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.bypass((v >> k) & 1)

    def terminate(self, b: int) -> None:
        self.range -= 2
        if b:
            self.low += self.range
            self.low <<= 7
            self.range = 2 << 7
            self.bits_left -= 7
        elif self.range >= 256:
            return
        else:
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        self._test_write()

    def finish(self) -> bytes:
        """Flush; returns the coded byte string (call once)."""
        if self.low >> (32 - self.bits_left):
            self.buf.append((self.buffered + 1) & 0xFF)
            for _ in range(self.n_buffered - 1):
                self.buf.append(0x00)
            self.low -= 1 << (32 - self.bits_left)
        else:
            if self.n_buffered > 0:
                self.buf.append(self.buffered)
            for _ in range(self.n_buffered - 1):
                self.buf.append(0xFF)
        # remaining 24-bits_left bits of low (then the caller adds the
        # rbsp stop bit + alignment)
        nbits = 24 - self.bits_left
        val = (self.low >> 8) & ((1 << nbits) - 1) if nbits else 0
        out = bytearray(self.buf)
        acc, accn = 0, 0
        for k in range(nbits - 1, -1, -1):
            acc = (acc << 1) | ((val >> k) & 1)
            accn += 1
            if accn == 8:
                out.append(acc)
                acc, accn = 0, 0
        # stop bit + byte alignment (rbsp_slice_segment_trailing_bits)
        acc = (acc << 1) | 1
        accn += 1
        acc <<= (8 - accn)
        out.append(acc)
        return bytes(out)

    # -- common binarizations ------------------------------------------------

    def tr_bypass(self, v: int, c_max: int) -> None:
        """Truncated unary via bypass (inverse of decoder tr_bypass)."""
        for _ in range(v):
            self.bypass(1)
        if v < c_max:
            self.bypass(0)

    def eg_bypass(self, v: int, k: int) -> None:
        """k-th order Exp-Golomb via bypass (inverse of decoder)."""
        while v >= (1 << k):
            self.bypass(1)
            v -= 1 << k
            k += 1
        self.bypass(0)
        self.bypass_bits(v, k)
