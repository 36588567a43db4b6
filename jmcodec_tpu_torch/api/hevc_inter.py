"""Stream entry point of the HEVC decode on the device: an Annex-B stream of
I, P and B pictures -> its frames in output order.

The counterpart of jmcodec_tpu's session HEVC device path
(api/session.py, _hevc_device_recon and _decode_picture_hevc): the host
(codec/hevc/refdec.py) parses every picture, natively or in Python, and
keeps POC, reference lists, TMVP motion, the deblocking strengths and
output order; DeviceRecon decodes each plan within the device's scope on
the device against a cache of reference phase pyramids that never leave
it; the pictures outside that scope are decoded on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec.hevc.refdec import HevcRefDecoder
from ..kernels import hevc_tiles as HT
from ..utils.device import require_cuda

CACHE_MAX = 6   # phase pyramids kept, oldest dropped first


class DeviceRecon:
    """device_recon hook of HevcRefDecoder: decodes a plan on `device`
    (None: the card) against its references' phase pyramids and returns the coded-size
    (Y, U, V) uint8 planes there. The pyramids live in one cache keyed by
    POC, each entry beside the luma plane it was made from: an entry
    serves a reference only when that plane is the reference's own, so a
    picture of the same POC decoded on the host (an IDR there, which this
    hook never sees) is never predicted from an earlier one's pyramid. The
    cache is cleared on an IDR picture, filled from a reference's planes
    when it holds no entry of them (a picture decoded on the host, or one
    whose entry was dropped), and given every decoded picture's pyramid
    while the picture is on the device. A reference's numpy planes (a
    host-decoded picture) are uploaded there, where its entry is filled;
    planes on the device are read where they are. The caller keeps the
    plan within refdec.R_MAX references (HevcRefDecoder routes the others
    to the host)."""

    def __init__(self, device=None):
        self.device = (require_cuda() if device is None
                       else torch.device(device))
        self.cache = {}

    def _on_device(self, a):
        if isinstance(a, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return a

    def __call__(self, plan, ref_pixels):
        if plan.is_idr:
            self.cache.clear()
        for (p, y, cb, cr) in ref_pixels:
            if self.cache.get(p, (None,))[0] is not y:
                self.cache[p] = (y, HT.prep_hevc_ref(
                    *(self._on_device(a) for a in (y, cb, cr))))
        refs = [self.cache[p][1] for (p, _, _, _) in ref_pixels]
        Y, U, V = HT.decode_plan_inter(plan, refs, self.device, coded=True)
        self.cache[plan.poc] = (Y, HT.prep_hevc_ref(Y, U, V))
        while len(self.cache) > CACHE_MAX:
            self.cache.pop(next(iter(self.cache)))
        return Y, U, V


def decode_hevc(stream: bytes, device=None) -> list:
    """Decode an Annex-B HEVC stream on `device` (None: the card, which
    must be there), each picture routed as HevcRefDecoder routes it: on
    the device where its plan is within the device's scope, else on the
    host (a multi-slice or transform-skip picture, motion past the MC pad,
    more than refdec.R_MAX references). Returns [(Y, U, V), ...] uint8
    tensors on that device in output order, cropped to the conformance
    window: a host-decoded picture is uploaded at output, so every frame
    has the one type. Raises NotImplementedError where the JAX package
    drops the picture as unsupported (PCM, transquant bypass, tiles, not
    4:2:0 8-bit)."""
    recon = DeviceRecon(device)
    return [tuple(map(recon._on_device, fr))
            for fr in HevcRefDecoder(recon).decode(stream)]


def decode_plans(plans, device=None) -> list:
    """Device decode of plans a DeviceRecon received, in decode order: the
    device half of decode_hevc without the parse, its pyramid cache
    included. Returns the coded-size (Y, U, V) of each, in decode order."""
    recon = DeviceRecon(device)
    planes, out = {}, []
    for plan in plans:
        if plan.is_idr:
            planes.clear()
        refs = [(p, *planes[p]) for p in (plan.ref_pocs or [])]
        planes[plan.poc] = recon(plan, refs)
        out.append(planes[plan.poc])
    return out
