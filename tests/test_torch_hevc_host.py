"""The port's HEVC host parse and recon on the CPU, at tolerance 0, on the
small host-route fixtures (tools/fixtures.HEVC_HOST_FIXTURES: cu_qp_delta
I, P and B streams, two slices a picture, transform skip in one GOP and in
two, motion past the device's MC pad, five references):

- the port's host decode (HevcRefDecoder without device_recon) equals the
  libavcodec digests and jmcodec_tpu's HevcRefDecoder(use_native=False)
  and HevcRefDecoder() host decodes;
- decode_hevc(stream, "cpu") equals the digests, with as many pictures on
  the device and on the host as jmcodec_tpu routes there; the routing is
  read without compiling any JAX program: a device_recon hook that records
  the plan and raises NotImplementedError sends every jmcodec_tpu picture
  to its host decode (refdec.py:481-485), and a picture is on its device
  path where the hook saw a plan with at most four references;
- the port's Python-parsed plans equal jmcodec_tpu's, field by field
  (use_native=False on both sides);
- DecoderSession(Codec.HEVC, use_device=False) decodes every small HEVC
  stream under tests/data on the host, bit-exactly, and equals
  jmcodec_tpu's host-only session in frames and counters;
- an error inside device_recon leaves the session; a transquant-bypass
  picture is dropped and counted as jmcodec_tpu's session drops it.

Two faults of jmcodec_tpu show here. Its Python parse takes a block of an
earlier slice for an available neighbour (6.4.1 makes it unavailable) and
filters across slice boundaries that forbid it, so it loses sync in a
picture of two slices and drops it as corrupt. The port decodes such a
picture as libavcodec does (_Picture.start_slice, _filter_blocked);
test_two_slices_decode_where_jmcodec_tpu_fails holds both halves of that.
Its session's device cache of reference pyramids is keyed by POC alone,
so after an IDR decoded on the host (transform skip) a P picture on the
device is predicted from the previous GOP's POC 0; the port's DeviceRecon
uses an entry only for the planes it was made from, and the two-GOP
transform-skip fixture holds it to libavcodec's digests.

python tests/test_torch_hevc_host.py [name ...] rebuilds the fixtures from
their recipes (RECIPES below; the 1080p one only when named).
"""

import copy
import hashlib
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

from jmcodec_tpu.api.session import Codec as JaxCodec
from jmcodec_tpu.api.session import DecoderSession as JaxSession
from jmcodec_tpu.codec.hevc import refdec as JRD
from jmcodec_tpu.utils.metrics import counters as jax_counters
from jmcodec_tpu.utils.metrics import logger as jax_logger
from jmcodec_tpu_torch.api import hevc_inter
from jmcodec_tpu_torch.api.hevc_inter import DeviceRecon, decode_hevc
from jmcodec_tpu_torch.api.session import Codec, DecoderSession
from jmcodec_tpu_torch.codec.hevc import refdec as RD
from jmcodec_tpu_torch.tools.fixtures import (HEVC_HOST_FIXTURES,
                                              plan_from_reference)
from jmcodec_tpu_torch.utils.metrics import counters, logger

from util_oracle import (have_oracle, make_frame, oracle_decode,
                         oracle_encode)

DATA = os.path.join(os.path.dirname(__file__), "data")
KEYS = ("frames_device", "corrupt_chunks", "unsupported_pictures")
FIXTURES = list(HEVC_HOST_FIXTURES)
# every small HEVC stream under tests/data with its digests
SMALL = sorted(f[:-len(".sha256.json")] for f in os.listdir(DATA)
               if f.startswith("hevc_") and f.endswith(".sha256.json")
               and "1080p" not in f)
SLICES2 = "hevc_slices2_96x128"


@pytest.fixture(autouse=True, scope="module")
def _quiet():
    """The dropped pictures log a warning each."""
    levels = logger.level, jax_logger.level
    logger.setLevel(logging.ERROR)
    jax_logger.setLevel(logging.ERROR)
    yield
    logger.setLevel(levels[0])
    jax_logger.setLevel(levels[1])


def _stream(name):
    with open(os.path.join(DATA, name + ".h265"), "rb") as f:
        return f.read()


def _digests(name):
    with open(os.path.join(DATA, name + ".sha256.json")) as f:
        return json.load(f)["frames"]


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


def _np(frames):
    return [tuple(p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
                  for p in fr) for fr in frames]


def _assert_digests(frames, digests):
    assert len(frames) == len(digests)
    for i, (fr, want) in enumerate(zip(_np(frames), digests)):
        for k, a in zip("YUV", fr):
            assert a.dtype == np.uint8 and _sha(a) == want[k], f"{i} {k}"


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(_np(got), _np(want))):
        for k, a, b in zip("YUV", g, w):
            assert a.shape == b.shape and np.array_equal(a, b), f"{i} {k}"


def _const_hook(plans):
    """A device_recon hook that records each plan and returns constant
    planes: the parse reads no pixels, so the plans are those of a
    decode."""
    def hook(plan, ref_pixels):
        plans.append(copy.deepcopy(plan))
        f = lambda h, w: np.full((h, w), 128, np.uint8)
        return f(plan.ph, plan.pw), *[f(plan.ph // 2, plan.pw // 2)] * 2

    return hook


class _Indexed(JRD.HevcRefDecoder):
    """jmcodec_tpu's HevcRefDecoder that numbers its pictures in decode
    order (an all-intra stream's POCs are all 0)."""

    index = -1

    def _decode_picture(self, slices):
        self.index += 1
        return super()._decode_picture(slices)


def _jax_routed(stream, use_native=True):
    """jmcodec_tpu's HevcRefDecoder with a hook that records each plan and
    raises: the plans its hook saw, by picture (decode order), and the
    pictures its device path would have taken (a plan within R_MAX
    references; its session's hook raises for more). Every picture is
    then decoded on its host path."""
    plans = {}

    def hook(plan, ref_pixels):
        plans.setdefault(dec.index, []).append(copy.deepcopy(plan))
        raise NotImplementedError("recorded")

    dec = _Indexed(device_recon=hook, use_native=use_native)
    dec.decode(stream)
    device = sorted(i for i, lst in plans.items()
                    if any(len(q.ref_pocs or []) <= RD.R_MAX for q in lst))
    return plans, device


def _drive(session, cnt, stream, step=997):
    """stream through a session in chunks: its frames and counter deltas."""
    before = cnt.snapshot()
    frames = []
    for pos in range(0, len(stream), step):
        session.input_data(stream[pos:pos + step])
        while (fr := session.get_frame()) is not None:
            frames.append(fr)
    session.set_eof()
    while (fr := session.get_frame()) is not None:
        frames.append(fr)
    after = cnt.snapshot()
    return frames, {k: after.get(k, 0) - before.get(k, 0) for k in KEYS}


# ---------------------------------------------------------------------------
# host decode, device route, plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n in FIXTURES if n != SLICES2])
def test_host_decode_matches_libavcodec_and_jax(name):
    stream = _stream(name)
    got = RD.HevcRefDecoder().decode(stream)
    _assert_digests(got, _digests(name))
    _assert_same(got, JRD.HevcRefDecoder(use_native=False).decode(stream))
    _assert_same(got, JRD.HevcRefDecoder().decode(stream))


@pytest.mark.parametrize("name", FIXTURES)
def test_device_route_matches_libavcodec_and_jax_routing(monkeypatch, name):
    """The session on the CPU: the digests, and the pictures on the device
    (frames_device, and which ones) are jmcodec_tpu's."""
    n_dev, n_host = HEVC_HOST_FIXTURES[name]
    stream = _stream(name)
    taken = []
    call = hevc_inter.DeviceRecon.__call__

    def spy(self, plan, ref_pixels):
        taken.append(plan.poc)
        return call(self, plan, ref_pixels)

    monkeypatch.setattr(hevc_inter.DeviceRecon, "__call__", spy)
    got, n = _drive(DecoderSession(Codec.HEVC, device="cpu"), counters,
                    stream)
    _assert_digests(got, _digests(name))
    assert n == {"frames_device": n_dev, "corrupt_chunks": 0,
                 "unsupported_pictures": 0}
    assert len(got) - len(taken) == n_host
    if name != SLICES2:
        jplans, jdev = _jax_routed(stream)
        assert [jplans[i][-1].poc for i in jdev] == taken


@pytest.mark.parametrize("name", [n for n in FIXTURES if n != SLICES2])
def test_python_parsed_plans_match_jax(name):
    stream = _stream(name)
    ours = []
    RD.HevcRefDecoder(_const_hook(ours), use_native=False).decode(stream)
    theirs, jdev = _jax_routed(stream, use_native=False)
    assert len(ours) == len(jdev) == HEVC_HOST_FIXTURES[name][0]
    for a, i in zip(ours, jdev):
        b = plan_from_reference(theirs[i][-1])
        assert vars(a).keys() == vars(b).keys()
        for f, v in vars(b).items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(getattr(a, f), v), (a.poc, f)
            else:
                assert getattr(a, f) == v, (a.poc, f)


def test_fixtures_hold_what_they_are_there_for(monkeypatch):
    """cu_qp_delta with QPs that vary from cell to cell, B slices on the
    device, the three reasons of the scope tests (transform skip, motion
    past the gate, five references), and two GOPs whose POC-0 IDR is
    decoded on the host each time while the device takes their P
    pictures, which reference it: a device cache keyed by POC alone would
    predict the second GOP from the first one's IDR."""
    plans = []
    RD.HevcRefDecoder(_const_hook(plans)).decode(
        _stream("hevc_cuqp_b_64x64"))
    assert all(len(np.unique(p.qp_y)) > 1 for p in plans)
    assert any((p.pred_fl[0] & p.pred_fl[1]).any() for p in plans)
    plans.clear()
    RD.HevcRefDecoder(_const_hook(plans)).decode(
        _stream("hevc_tskip_2gop_128x96"))
    assert [(p.poc, p.ref_pocs) for p in plans] == [(1, [0]), (2, [1, 0]),
                                                    (1, [0]), (2, [1, 0])]
    scope = []
    takes = RD.HevcRefDecoder._device_takes

    def spy(plan):
        scope.append((plan.reason, len(plan.ref_pocs or [])))
        return takes(plan)

    monkeypatch.setattr(RD.HevcRefDecoder, "_device_takes",
                        staticmethod(spy))
    for name in ("hevc_tskip_128x96", "hevc_far_mv_128x64",
                 "hevc_ref5_64x64"):
        RD.HevcRefDecoder(_const_hook([])).decode(_stream(name))
    assert scope[0] == ("transform_skip", 0)
    assert [r for r, _ in scope[3:5]] == ["MV beyond device MC pad"] * 2
    assert sum(s == ("", 5) for s in scope[5:]) == 2


def test_two_slices_decode_where_jmcodec_tpu_fails():
    """Two slices a picture: the port decodes every picture on the host as
    libavcodec does; jmcodec_tpu's parse loses sync in the first picture
    and its session drops all three as corrupt."""
    stream = _stream(SLICES2)
    got = RD.HevcRefDecoder().decode(stream)
    _assert_digests(got, _digests(SLICES2))
    with pytest.raises(ValueError):
        JRD.HevcRefDecoder(use_native=False).decode(stream)
    _, n = _drive(JaxSession(JaxCodec.HEVC, use_device=False), jax_counters,
                  stream)
    assert n == {"frames_device": 0, "corrupt_chunks": 3,
                 "unsupported_pictures": 0}


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SMALL)
def test_host_only_session_decodes_every_small_stream(name):
    stream = _stream(name)
    got, n = _drive(DecoderSession(Codec.HEVC, use_device=False), counters,
                    stream)
    _assert_digests(got, _digests(name))
    assert n == {"frames_device": 0, "corrupt_chunks": 0,
                 "unsupported_pictures": 0}
    if name != SLICES2:
        want, wn = _drive(JaxSession(JaxCodec.HEVC, use_device=False),
                          jax_counters, stream)
        _assert_same(got, want)
        assert n == wn


@pytest.mark.parametrize("exc", [RuntimeError, NotImplementedError,
                                 ValueError])
def test_device_recon_error_propagates(monkeypatch, exc):
    """Only the scope tests route a picture: an error raised inside
    device_recon (a CUDA error, a kernel that fails to build, a shape
    error; or an error type the session would take for a fault of the
    stream) leaves the session, uncounted."""
    def broken(self, plan, ref_pixels):
        raise exc("device decode failed")

    monkeypatch.setattr(hevc_inter.DeviceRecon, "__call__", broken)
    before = counters.snapshot()
    s = DecoderSession(Codec.HEVC, device="cpu")
    with pytest.raises(RuntimeError, match="device decode failed"):
        s.input_data(_stream("hevc_cuqp_p_64x64"))
        s.set_eof()
    for k in KEYS:
        assert counters.get(k) == before.get(k, 0), k


@pytest.mark.skipif(not have_oracle(), reason="oracle unavailable")
def test_transquant_bypass_picture_dropped_as_jax_drops_it():
    """x265 lossless: cu_transquant_bypass in the I picture, which the
    host decoder does not support; the P picture after it lacks its
    reference. Both sessions drop both and count them alike."""
    frames = [make_frame(64, 64, seed=i) for i in range(2)]
    stream = oracle_encode(frames, 64, 64, qp=30, codec="libx265", gop=2,
                           extra="lossless=1")
    got, n = _drive(DecoderSession(Codec.HEVC, device="cpu"), counters,
                    stream)
    want, wn = _drive(JaxSession(JaxCodec.HEVC), jax_counters, stream)
    assert got == want == []
    assert n == wn == {"frames_device": 0, "corrupt_chunks": 1,
                       "unsupported_pictures": 1}


def test_host_reference_planes_cross_both_ways():
    """A host-decoded picture enters the DPB as numpy planes and the
    device decode of a later picture uploads them once (the
    transform-skip stream); a device-decoded reference of a host picture
    keeps its tensors, with a numpy copy beside them (the far-motion
    stream)."""
    seen = []
    recon = DeviceRecon("cpu")

    def hook(plan, ref_pixels):
        seen.append([type(y) for _, y, _, _ in ref_pixels])
        return recon(plan, ref_pixels)

    RD.HevcRefDecoder(hook).decode(_stream("hevc_tskip_128x96"))
    assert seen[0] == [np.ndarray] and len(seen) == 2
    assert len(recon.cache) == 3
    frames = decode_hevc(_stream("hevc_tskip_128x96"), "cpu")
    assert all(isinstance(p, torch.Tensor) for fr in frames for p in fr)
    _assert_digests(frames, _digests("hevc_tskip_128x96"))
    seen.clear()
    dec = RD.HevcRefDecoder(hook)
    dec.decode(_stream("hevc_far_mv_128x64"), flush=False)
    assert seen == [[]]
    i_pic = [rp for rp in dec.dpb if rp.poc == 0][0]
    assert isinstance(i_pic.y, torch.Tensor)
    assert np.array_equal(i_pic.host[0], i_pic.y.numpy())


# ---------------------------------------------------------------------------
# the fixtures' recipes
# ---------------------------------------------------------------------------

CUQP = "bitrate=150:aq-mode=2:vbv-bufsize=300:vbv-maxrate=150:ctu=32"


def _moving(W, H, n, seed=0):
    """The pan of make_frame(2W, 2H, seed) by (3i, 2i) px."""
    BY, BU, BV = make_frame(W * 2, H * 2, seed=seed)
    return [(BY[2 * i:2 * i + H, 3 * i:3 * i + W],
             BU[i:i + H // 2, 3 * i // 2:3 * i // 2 + W // 2],
             BV[i:i + H // 2, 3 * i // 2:3 * i // 2 + W // 2])
            for i in range(n)]


def _binary(W, H, n, seed=1):
    """One picture of black and white pixels, n times over."""
    rng = np.random.default_rng(seed)
    Y = (rng.integers(0, 2, (H, W)) * 255).astype(np.uint8)
    U = np.full((H // 2, W // 2), 128, np.uint8)
    return [(Y, U, U.copy()) for _ in range(n)]


def _far_pan(W, H, n, step, seed=11):
    """Uniform noise panned by step px a picture."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (H, W + n * step)).astype(np.uint8)
    bigc = rng.integers(0, 256, (H // 2, (W + n * step) // 2)).astype(
        np.uint8)
    return [(big[:, x:x + W], bigc[:, x // 2:x // 2 + W // 2],
             bigc[::-1, x // 2:x // 2 + W // 2].copy())
            for x in range(0, n * step, step)]


def _inter_content(n):
    """The first n pictures of the 1080p inter fixture's content (its
    recipe: tools/fixtures.inter_fixture_stream)."""
    BY, BU, BV = make_frame(1984, 1144, seed=0)
    out = []
    for i in range(n):
        Y = BY[2 * i:2 * i + 1080, 3 * i:3 * i + 1920].astype(np.int32)
        U = BU[i:i + 540, 3 * i // 2:3 * i // 2 + 960].astype(np.int32)
        V = BV[i:i + 540, 3 * i // 2:3 * i // 2 + 960].astype(np.int32)
        rng = np.random.default_rng(100 + i)
        Y = Y + rng.integers(-6, 7, Y.shape)
        U = U + rng.integers(-6, 7, U.shape)
        V = V + rng.integers(-6, 7, V.shape)
        EY, EU, EV = make_frame(256, 256, seed=i, kind="edges")
        flip = np.kron(np.random.default_rng(1000 + i).integers(
            0, 2, (32, 32)), np.ones((8, 8)))
        EY = np.where(flip == 1, 256 - EY.astype(np.int32), EY)
        by, bx = (197 * i) % 824 // 8 * 8, (421 * i) % 1664 // 8 * 8
        Y[by:by + 256, bx:bx + 256] = EY
        U[by // 2:by // 2 + 128, bx // 2:bx // 2 + 128] = EU
        V[by // 2:by // 2 + 128, bx // 2:bx // 2 + 128] = EV
        out.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                         for p in (Y, U, V)))
    return out


# name -> (frames, width, height, gop, x265 options), all at qp 30
RECIPES = {
    "hevc_cuqp_intra_192x128": (
        lambda: [make_frame(192, 128, seed=i) for i in range(3)], 192, 128,
        1, "bitrate=300:aq-mode=2:vbv-bufsize=600:vbv-maxrate=300"),
    "hevc_cuqp_p_64x64": (
        lambda: [(np.roll(Y, 2 * i, 1), U, V) for Y, U, V in
                 [make_frame(64, 64, seed=3)] for i in range(3)], 64, 64, 3,
        CUQP),
    "hevc_cuqp_b_64x64": (lambda: _moving(64, 64, 6, seed=4), 64, 64, 20,
                          CUQP + ":bframes=3"),
    "hevc_slices2_96x128": (lambda: _moving(96, 128, 3, seed=6), 96, 128,
                            20, "slices=2:ctu=32"),
    "hevc_tskip_128x96": (lambda: _binary(128, 96, 3), 128, 96, 3,
                          "tskip=1:ctu=16"),
    "hevc_tskip_2gop_128x96": (
        lambda: _binary(128, 96, 3) + _binary(128, 96, 3, seed=2), 128, 96,
        3, "tskip=1:ctu=16:open-gop=0"),
    "hevc_far_mv_128x64": (lambda: _far_pan(128, 64, 3, 64), 128, 64, 3,
                           "merange=100:ctu=32:me=full"),
    "hevc_ref5_64x64": (lambda: _moving(64, 64, 10, seed=2), 64, 64, 30,
                        "ref=5:bframes=3"),
    "hevc_1080p_cuqp": (
        lambda: _inter_content(3), 1920, 1080, 20,
        "bitrate=3000:vbv-maxrate=3000:vbv-bufsize=6000:aq-mode=2:"
        "bframes=0:merange=16"),
}


def build(name):
    """Encode a fixture from its recipe; write it and its libavcodec
    digests under tests/data."""
    frames, W, H, gop, extra = RECIPES[name]
    stream = oracle_encode(frames(), W, H, qp=30, codec="libx265", gop=gop,
                           extra=extra)
    want, w, h = oracle_decode(stream, suffix=".h265")
    with open(os.path.join(DATA, name + ".h265"), "wb") as f:
        f.write(stream)
    meta = {"width": w, "height": h, "frames": [
        {k: _sha(p) for k, p in zip("YUV", fr)} for fr in want]}
    with open(os.path.join(DATA, name + ".sha256.json"), "w") as f:
        json.dump(meta, f, indent=1)


if __name__ == "__main__":
    for fixture in sys.argv[1:] or [n for n in RECIPES if "1080p" not in n]:
        build(fixture)
