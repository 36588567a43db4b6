"""HEVC CABAC entropy decoding (H.265 spec 9.3): engine init + bin helpers.

The arithmetic decoding core (9.3.4.3) is identical to H.264's 9.3.3.2 —
same rangeTabLPS, state machine and renormalisation — so the engine class is
shared with codec/h264/cabac.py. What differs is context initialisation
(9.3.2.2: one uint8 initValue per context encodes (slope, offset)) and the
context layout, which come from cabac_tables.py.

The port's copy of jmcodec_tpu/codec/hevc/cabac.py: the entropy stage of
the Python parse (refdec.py), built on the port's own H.264 engine.
"""

from __future__ import annotations

from ..h264.cabac import CabacEngine
from . import cabac_tables as T


class HevcCabac(CabacEngine):
    """HEVC CABAC engine: shares decode/bypass/terminate with H.264 (the
    spec's arithmetic core is byte-for-byte the same); overrides context
    initialisation (H.265 9.3.2.2) and adds WPP state save/restore (9.3.1).
    """

    def __init__(self, data: bytes, bit_pos: int, slice_qp: int,
                 init_type: int):
        # do NOT call super().__init__ (H.264 table shape differs)
        self.data = data
        self.pos = ((bit_pos + 7) // 8) * 8  # byte alignment
        self.init_contexts(slice_qp, init_type)
        self._engine_init()

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

    # -- WPP (entropy_coding_sync): context storage, spec 9.3.1 --
    def save_states(self):
        return (list(self.state), list(self.mps))

    def load_states(self, saved) -> None:
        self.state = list(saved[0])
        self.mps = list(saved[1])

    def reposition(self, bit_pos: int) -> None:
        """Jump to an entry-point substream start and re-init the engine;
        contexts untouched (9.3.1)."""
        self.pos = bit_pos
        self._engine_init()

    def align_and_reinit(self) -> None:
        """Start a new substream after byte_alignment() (7.3.2.10): consume
        alignment_bit_equal_to_one + zero bits, then engine re-init;
        contexts untouched (9.3.1)."""
        self.pos = ((self.pos >> 3) + 1) << 3
        self._engine_init()

    # -- common binarizations --
    def tr_bypass(self, c_max: int) -> int:
        """Truncated-Rice(0) via bypass bins (unary capped at c_max)."""
        v = 0
        while v < c_max and self.bypass():
            v += 1
        return v
