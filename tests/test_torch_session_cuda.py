"""On an NVIDIA GPU: the port's DecoderSession with no device argument (the
card) decodes the session fixtures to their libavcodec digests, with as
many pictures on the device and on the host as on the CPU, and the
device-decoded frames stay on the card until get_frame copies them; the
bit-flip corpus is contained without a CUDA error, and on the two I + P
streams the card's session gives the frames and counts of the port's CPU
session (held to jmcodec_tpu's by tests/test_torch_session.py). Marked `cuda`; skips
without a card. Imports no jax:

    JMX_TEST_TPU=1 python -m pytest tests/test_torch_session_cuda.py -m cuda
"""

import hashlib

import numpy as np
import pytest
import torch

from jmcodec_tpu_torch.api.session import DecoderSession
from jmcodec_tpu_torch.tools.fixtures import (CORPUS_FIXTURE,
                                              P_CORPUS_FIXTURES,
                                              SESSION_FIXTURES,
                                              session_corpus, session_fixture)
from jmcodec_tpu_torch.utils.metrics import counters

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


@pytest.mark.parametrize("name", list(SESSION_FIXTURES))
def test_session_fixture_on_the_card(dev, name):
    stream, digests = session_fixture(name)
    before = counters.get("frames_device")
    s = DecoderSession()
    s.input_data(stream)
    s.set_eof()
    frames = []
    while (fr := s.get_frame_device()) is not None:
        frames.append(fr)
    torch.cuda.synchronize()
    n_dev, n_host = SESSION_FIXTURES[name]
    assert counters.get("frames_device") - before == n_dev
    assert len(frames) == len(digests) == n_dev + n_host
    on_card = [isinstance(fr[0], torch.Tensor) for fr in frames]
    assert sum(on_card) == n_dev
    for fr, d in zip(frames, digests):
        if isinstance(fr[0], torch.Tensor):
            assert all(p.device == dev for p in fr)
            fr = tuple(p.cpu().numpy() for p in fr)
        assert [_sha(p) for p in fr] == [d[k] for k in "YUV"]


def test_bitflip_corpus_on_the_card(dev):
    stream, digests = session_fixture(CORPUS_FIXTURE)
    for data in session_corpus(stream):
        s = DecoderSession()
        s.input_data(data)
        s.set_eof()
        got = []
        while (fr := s.get_frame()) is not None:
            got.append(fr)
        torch.cuda.synchronize()
        assert len(got) in (2, 3)
        for fr, d in ((got[0], digests[0]), (got[-1], digests[2])):
            assert [_sha(p) for p in fr] == [d[k] for k in "YUV"]


def _decode(data, device=None):
    """data through a session on device: the frames as numpy planes and
    the counters' deltas."""
    keys = ("frames_device", "corrupt_chunks", "unsupported_pictures")
    c0 = counters.snapshot()
    s = DecoderSession(device=device)
    s.input_data(data)
    s.set_eof()
    got = []
    while (fr := s.get_frame()) is not None:
        got.append(fr)
    torch.cuda.synchronize()
    c1 = counters.snapshot()
    return got, {k: c1.get(k, 0) - c0.get(k, 0) for k in keys}


@pytest.mark.parametrize("name", list(P_CORPUS_FIXTURES))
def test_p_bitflip_corpus_on_the_card(dev, name):
    stream, digests = session_fixture(name)
    for trial, data in enumerate(session_corpus(stream)):
        got, n = _decode(data)
        want, wn = _decode(data, "cpu")
        assert n == wn, trial
        assert n["corrupt_chunks"] == (0 if trial in P_CORPUS_FIXTURES[name]
                                       else 1), trial
        assert len(got) == len(want) == n["frames_device"]
        for g, w in zip(got, want):
            assert all(np.array_equal(a, b) for a, b in zip(g, w)), trial
        assert [_sha(p) for p in got[0]] == [digests[0][k] for k in "YUV"]
