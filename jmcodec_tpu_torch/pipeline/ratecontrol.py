"""Rate control: CBR / VBR with a leaky-bucket (HRD-style) buffer model.

Replaces the silicon rate controllers the reference configures but never
implements in-tree: QSV VBR default (intel_enc/intel_enc.cpp:512
MFX_RATECONTROL_VBR, TargetKbps from bitrate_kb) and NVENC CBR
(nv_enc/nv_enc.cpp:534-535 NV_ENC_PARAMS_RC_CBR). The controller is a host
loop: pick QP -> encode frame -> observe bits -> update model, exactly the
feedback shape those ASICs implement in firmware.

Model (x264-style qscale domain):
  qscale(qp)  = 0.85 * 2^((qp-12)/6)          (bits halve every +6 QP)
  bits(frame) ~ complexity / qscale
Per-frame-type complexity is tracked as an EMA of observed
bits * qscale_used; using ONE shared qscale across types then allocates
bits proportionally to complexity (constant-quality within the buffer's
slack, the standard ABR formulation).

Buffer model: a decoder-side leaky bucket of `buffer_ms` worth of target
bits. CBR drains strictly at the target rate and corrects hard against
fullness error; VBR uses a larger bucket and a gentler gain, allowing
short-term overshoot for complex content.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


def qscale_of(qp: float) -> float:
    return 0.85 * (2.0 ** ((qp - 12.0) / 6.0))


def qp_of(qscale: float) -> float:
    return 12.0 + 6.0 * math.log2(max(qscale, 1e-6) / 0.85)


@dataclass
class RateControlConfig:
    bitrate_kbps: int = 2000
    fps: float = 30.0
    mode: str = "vbr"            # "cbr" | "vbr"
    buffer_ms: int = 0           # 0 -> default per mode (cbr 500, vbr 2000)
    min_qp: int = 10
    max_qp: int = 51
    gop_len: int = 30            # I-period (for GOP-level bit allocation)
    # initial QP if no better guess: derived from bits/pixel by the caller
    init_qp: int = 30

    def resolved_buffer_ms(self) -> int:
        if self.buffer_ms:
            return self.buffer_ms
        return 500 if self.mode == "cbr" else 2000


class RateController:
    """Per-frame QP decisions toward a target bitrate.

    Usage per frame:
        qp = rc.frame_qp(is_key)
        bits = len(encoded) * 8
        rc.update(is_key, qp, bits)
    """

    def __init__(self, cfg: RateControlConfig):
        if cfg.mode not in ("cbr", "vbr"):
            raise ValueError(f"rc mode {cfg.mode!r}")
        self.cfg = cfg
        self.R = cfg.bitrate_kbps * 1000.0 / cfg.fps   # target bits/frame
        self.buf_size = (cfg.bitrate_kbps * 1000.0 *
                         cfg.resolved_buffer_ms() / 1000.0)
        self.fullness = self.buf_size / 2.0            # start mid-buffer
        q0 = qscale_of(cfg.init_qp)
        # complexity priors: assume I frames ~4x P bits at equal qscale
        self.comp = {"I": 4.0 * self.R * q0, "P": self.R * q0,
                     "B": 0.6 * self.R * q0}
        self._ema = 0.5 if cfg.mode == "cbr" else 0.3
        self._gain = 1.2 if cfg.mode == "cbr" else 0.5
        self._seen = {"I": 0, "P": 0, "B": 0}
        self.last_qp: float = float(cfg.init_qp)
        self.frames = 0
        self.total_bits = 0

    # -- decision ----------------------------------------------------------

    def frame_qp(self, frame_type: str = "P") -> int:
        """QP for the next frame of the given type ("I"/"P"/"B")."""
        # buffer feedback: positive error = bucket fuller than the midpoint
        # = we are over-spending -> raise qscale
        err = (self.fullness - self.buf_size / 2.0) / max(self.buf_size, 1.0)
        # steady-state qscale from the GOP-level rate equation: one I plus
        # G-1 P frames must fit G frame-budgets at a single shared qscale
        # (comp_I/qs + (G-1)*comp_P/qs == G*R)
        G = max(1, self.cfg.gop_len)
        qs = (self.comp["I"] + (G - 1) * self.comp["P"]) / (G * max(self.R, 1.0))
        qs *= (1.0 + self._gain * err * 2.0)
        # integral term: the leaky bucket saturates (forgives old error), so
        # also correct the cumulative average toward the target — the x264
        # ABR "overflow" factor. Stronger pull for CBR than VBR.
        if self.frames >= 3:
            want = self.R * self.frames
            drift = self.total_bits / max(want, 1.0)
            k = 1.0 if self.cfg.mode == "cbr" else 0.8
            qs *= min(max(drift ** k, 0.6), 1.8)
        qp = qp_of(qs)
        if frame_type == "B":
            qp += 2.0
        # clamp rate-of-change (keeps quality from pumping), then range;
        # during warmup the bits/pixel prior can be far off — let the first
        # frames re-anchor fast, then tighten
        step = 51.0 if self.frames < 2 else (8.0 if self.frames < 4 else 3.0)
        qp = min(max(qp, self.last_qp - step), self.last_qp + step)
        qp = min(max(qp, float(self.cfg.min_qp)), float(self.cfg.max_qp))
        if frame_type == "I":
            # I frames ride the same qscale track, slightly favored
            qp = max(qp - 2.0, float(self.cfg.min_qp))
        return int(round(qp))

    # -- observation -------------------------------------------------------

    def update(self, frame_type: str, qp_used: int, bits: int) -> None:
        t = "I" if frame_type == "I" else ("B" if frame_type == "B" else "P")
        obs = bits * qscale_of(qp_used)
        # first observation replaces the prior outright (the prior only
        # encodes "content hits target at init_qp", which can be far off);
        # the very first frame of the stream re-anchors every type's prior
        # by the same ratio so frame 2 doesn't repeat frame 1's miss
        if self.frames == 0 and self.comp[t] > 0:
            ratio = obs / self.comp[t]
            for k in self.comp:
                self.comp[k] *= ratio
        a = 1.0 if self._seen[t] == 0 else self._ema
        self._seen[t] += 1
        self.comp[t] = (1 - a) * self.comp[t] + a * obs
        if t != "I":
            self.last_qp = float(qp_used)
        self.fullness += bits - self.R
        # a real HRD would stall/pad; the controller just saturates and the
        # feedback term pulls it back inside
        self.fullness = min(max(self.fullness, 0.0), self.buf_size)
        self.frames += 1
        self.total_bits += bits

    # -- reporting ---------------------------------------------------------

    def achieved_kbps(self) -> float:
        if not self.frames:
            return 0.0
        return self.total_bits / 1000.0 * self.cfg.fps / self.frames
