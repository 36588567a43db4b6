"""On an NVIDIA GPU: the port's HEVC inter decode (decode_hevc on the
card, the CUDA scan kernel over the inter base, two launches a picture)
equals the libavcodec digests
of the committed small inter streams and of the 16-picture 1080p inter
fixture, and the hevc_walk kernel equals walk_reference bit for bit on
inter-seeded walk states (random base, inter cells numbered among the
intra TUs, lanes without a TU). Marked `cuda`; skips without a card.
Imports no jax:

    JMX_TEST_TPU=1 python -m pytest tests/test_torch_hevc_inter_cuda.py -m cuda
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from jmcodec_tpu_torch.api import hevc_inter
from jmcodec_tpu_torch.api.hevc_inter import decode_hevc
from jmcodec_tpu_torch.kernels import hevc_scan as HSC
from jmcodec_tpu_torch.kernels import hevc_walk as HW
from jmcodec_tpu_torch.tools.fixtures import (INTER_DIGESTS, fixture_digests,
                                              inter_fixture_stream,
                                              synth_state_inter)

pytestmark = pytest.mark.cuda
DATA = os.path.join(os.path.dirname(__file__), "data")
STREAMS = ["hevc_inter_p_64x64", "hevc_inter_b3_64x64",
           "hevc_inter_idr2_64x64", "hevc_inter_amp_64x64",
           "hevc_inter_100x60", "hevc_inter_weightp_64x64",
           "hevc_inter_ref3_64x64", "hevc_inter_ctu32_192x128"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _assert_digests(frames, digests, dev):
    assert len(frames) == len(digests)
    for i, (frame, want) in enumerate(zip(frames, digests)):
        for plane, a in zip("YUV", frame):
            assert a.device == dev and a.dtype == torch.uint8
            h = hashlib.sha256(np.ascontiguousarray(a.cpu().numpy()))
            assert h.hexdigest() == want[plane], f"frame {i} {plane}"


@pytest.mark.parametrize("name", STREAMS)
def test_stream_on_card_matches_digests(monkeypatch, dev, name):
    s = open(os.path.join(DATA, name + ".h265"), "rb").read()
    meta = json.load(open(os.path.join(DATA, name + ".sha256.json")))
    on_card = []
    call = hevc_inter.DeviceRecon.__call__

    def recording(self, plan, ref_pixels):
        on_card.append(plan.poc)
        return call(self, plan, ref_pixels)

    monkeypatch.setattr(hevc_inter.DeviceRecon, "__call__", recording)
    before = (HSC.LAUNCHES, HW.LAUNCHES)
    frames = decode_hevc(s, dev)
    torch.cuda.synchronize()
    # two scan kernel launches a picture on the card (luma, chroma), no
    # walk launch
    assert on_card
    assert (HSC.LAUNCHES, HW.LAUNCHES) == (before[0] + 2 * len(on_card),
                                           before[1])
    _assert_digests(frames, meta["frames"], dev)


def test_1080p_fixture_on_card_matches_digests(dev):
    frames = decode_hevc(inter_fixture_stream())
    torch.cuda.synchronize()
    _assert_digests(frames, fixture_digests(INTER_DIGESTS), dev)


# (C, max_tu, is_chroma, strong, lanes, skew): the 1080p inter picture's
# lanes (17 luma, 34 chroma), CTU 32, one lane, odd counts
@pytest.mark.parametrize("C,max_tu,chroma,strong,B,skew",
                         [(64, 32, False, True, 17, 2),
                          (32, 16, True, False, 34, 2),
                          (32, 32, False, True, 9, 3),
                          (16, 16, True, False, 18, 3),
                          (64, 32, False, True, 1, 2),
                          (32, 16, True, False, 7, 2)],
                         ids=["luma64", "chroma32", "luma32", "chroma16",
                              "luma64_one_lane", "chroma32_odd"])
def test_kernel_matches_reference_on_inter_states(dev, C, max_tu, chroma,
                                                  strong, B, skew):
    st = synth_state_inter(C, max_tu, B, seed=13, skew=skew)
    args = [torch.from_numpy(a).to(dev) for a in st]
    kw = dict(C=C, max_tu=max_tu, is_chroma=chroma, strong=strong)
    got = HW.walk(*args, **kw)
    want = HW.walk_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # a lane without a TU keeps its base
    empty = ~args[3].flatten(1).any(1)
    assert torch.equal(got[empty], args[0][empty])
