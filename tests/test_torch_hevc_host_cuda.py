"""On an NVIDIA GPU: the HEVC host-route fixtures
(tools/fixtures.HEVC_HOST_FIXTURES) through DecoderSession(Codec.HEVC) on
the card decode to their libavcodec digests, with the frames, routes and
counts of the same session on the CPU (held to jmcodec_tpu's by
tests/test_torch_hevc_host.py): the Python-parsed cu_qp_delta plans on the
card's TU walk, the host-decoded pictures uploaded as references and the
device-decoded ones copied down for the host's MC. Marked `cuda`; skips
without a card. Imports no jax:

    JMX_TEST_TPU=1 python -m pytest tests/test_torch_hevc_host_cuda.py -m cuda
"""

import hashlib

import numpy as np
import pytest
import torch

from jmcodec_tpu_torch.api import hevc_inter
from jmcodec_tpu_torch.api.hevc_inter import decode_hevc
from jmcodec_tpu_torch.api.session import Codec, DecoderSession
from jmcodec_tpu_torch.kernels import hevc_scan as HSC
from jmcodec_tpu_torch.kernels import hevc_walk as HW
from jmcodec_tpu_torch.tools.fixtures import (HEVC_HOST_FIXTURES,
                                              session_fixture)
from jmcodec_tpu_torch.utils.metrics import counters

pytestmark = pytest.mark.cuda
KEYS = ("frames_device", "corrupt_chunks", "unsupported_pictures")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


def _session(stream, device=None):
    """stream through DecoderSession(Codec.HEVC, device=device): the frames
    as get_frame_device gives them and the counters' deltas."""
    c0 = counters.snapshot()
    s = DecoderSession(Codec.HEVC, device=device)
    s.input_data(stream)
    s.set_eof()
    frames = []
    while (fr := s.get_frame_device()) is not None:
        frames.append(fr)
    c1 = counters.snapshot()
    return frames, {k: c1.get(k, 0) - c0.get(k, 0) for k in KEYS}


def _host(fr):
    return tuple(p.cpu().numpy() if isinstance(p, torch.Tensor) else p
                 for p in fr)


@pytest.mark.parametrize("name", list(HEVC_HOST_FIXTURES))
def test_host_route_fixture_on_the_card(monkeypatch, dev, name):
    """The scan kernel is launched twice for each plan the card took (luma,
    chroma; the walk runs inside it), hevc_walk never."""
    stream, digests = session_fixture(name, ".h265")
    plans = []
    call = hevc_inter.DeviceRecon.__call__

    def recording(self, plan, ref_pixels):
        plans.append(plan)
        return call(self, plan, ref_pixels)

    monkeypatch.setattr(hevc_inter.DeviceRecon, "__call__", recording)
    HW.LAUNCHES = HSC.LAUNCHES = 0
    frames, n = _session(stream)
    torch.cuda.synchronize()
    launches = (HSC.LAUNCHES, HW.LAUNCHES)
    n_dev, n_host = HEVC_HOST_FIXTURES[name]
    assert n == {"frames_device": n_dev, "corrupt_chunks": 0,
                 "unsupported_pictures": 0}
    assert len(frames) == len(digests) == n_dev + n_host
    assert len(plans) == n_dev
    assert launches == (2 * len(plans), 0)
    on_card = [isinstance(fr[0], torch.Tensor) for fr in frames]
    assert all(p.device == dev for fr, c in zip(frames, on_card) if c
               for p in fr)
    for fr, d in zip(frames, digests):
        assert [_sha(p) for p in _host(fr)] == [d[k] for k in "YUV"]
    want, wn = _session(stream, "cpu")
    assert wn == n
    assert [isinstance(fr[0], torch.Tensor) for fr in want] == on_card
    for a, b in zip(frames, want):
        assert all(np.array_equal(x, y) for x, y in zip(_host(a), _host(b)))


@pytest.mark.parametrize("name", ["hevc_tskip_128x96",
                                  "hevc_tskip_2gop_128x96",
                                  "hevc_far_mv_128x64"])
def test_decode_hevc_uploads_host_pictures(dev, name):
    """decode_hevc's frames are all tensors on the card, the host-decoded
    ones uploaded at output."""
    stream, digests = session_fixture(name, ".h265")
    frames = decode_hevc(stream)
    assert all(isinstance(p, torch.Tensor) and p.device == dev
               for fr in frames for p in fr)
    for fr, d in zip(frames, digests):
        assert [_sha(p.cpu().numpy()) for p in fr] == [d[k] for k in "YUV"]
