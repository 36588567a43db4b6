"""Stream entry point of the HEVC decode on the device: an Annex-B stream of
I, P and B pictures -> its frames in output order.

The counterpart of jmcodec_tpu's session HEVC device path
(api/session.py, _hevc_device_recon and _decode_picture_hevc): the host
(codec/hevc/refdec.py) parses every picture natively and keeps POC,
reference lists, TMVP motion, the deblocking strengths and output order;
DeviceRecon decodes each picture's plan on the device against a cache of
reference phase pyramids that never leave it.
"""

from __future__ import annotations

import torch

from ..codec.hevc.refdec import HevcRefDecoder
from ..kernels import hevc_tiles as HT
from ..utils.device import require_cuda

R_MAX = 4       # unique reference POCs a picture may use
CACHE_MAX = 6   # phase pyramids kept, oldest dropped first


class DeviceRecon:
    """device_recon hook of HevcRefDecoder: decodes a plan on `device`
    against its references' phase pyramids and returns the coded-size
    (Y, U, V) uint8 planes there. The pyramids live in one cache keyed by
    POC: cleared on an IDR picture (POCs restart), filled from a
    reference's planes only when its entry was dropped, and given every
    decoded picture's pyramid while the picture is on the device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cache = {}

    def __call__(self, plan, ref_pixels):
        if plan.ref_pocs and len(plan.ref_pocs) > R_MAX:
            raise NotImplementedError(
                f"more than {R_MAX} unique reference POCs")
        if plan.is_idr:
            self.cache.clear()
        for (p, y, cb, cr) in ref_pixels:
            if p not in self.cache:
                self.cache[p] = HT.prep_hevc_ref(y, cb, cr)
        refs = [self.cache[p] for (p, _, _, _) in ref_pixels]
        Y, U, V = HT.decode_plan_inter(plan, refs, self.device, coded=True)
        self.cache[plan.poc] = HT.prep_hevc_ref(Y, U, V)
        while len(self.cache) > CACHE_MAX:
            self.cache.pop(next(iter(self.cache)))
        return Y, U, V


def decode_hevc(stream: bytes, device=None) -> list:
    """Decode an Annex-B HEVC stream (one slice per picture, within the
    native parser's scope) on `device` (None: the card, which must be
    there). Returns [(Y, U, V), ...] uint8 tensors on that device in
    output order, cropped to the conformance window. Raises
    NotImplementedError where the JAX package would fall back to its host
    decode path."""
    if device is None:
        device = require_cuda()
    return HevcRefDecoder(DeviceRecon(device)).decode(stream)


def decode_plans(plans, device=None) -> list:
    """Device decode of plans a DeviceRecon received, in decode order: the
    device half of decode_hevc without the parse, its pyramid cache
    included. Returns the coded-size (Y, U, V) of each, in decode order."""
    if device is None:
        device = require_cuda()
    recon = DeviceRecon(device)
    planes, out = {}, []
    for plan in plans:
        if plan.is_idr:
            planes.clear()
        refs = [(p, *planes[p]) for p in (plan.ref_pocs or [])]
        planes[plan.poc] = recon(plan, refs)
        out.append(planes[plan.poc])
    return out
