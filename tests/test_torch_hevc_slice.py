"""The port's HEVC all-intra slice end to end on the CPU: committed x265
streams -> parse_hevc_intra_plans -> decode_plans_batch(plans, cpu) equal
the host reference decoder (HevcRefDecoder) and, where the oracle is
built, libavcodec, bit for bit. Also: the committed 1080p fixture's
digests match libavcodec, and the port never imports jax.

The streams were made with tests/util_oracle.py (x265 via the oracle):
  hevc_128x96_ctu32.h265  make_frame(128, 96, seed=i) for i in 0..2,
                          qp 30, ctu=32, all-intra
  hevc_168x80.h265        make_frame(168, 80, seed=4) and
                          make_frame(168, 80, seed=5, kind="edges"),
                          qp 24, x265's default CTU 64 (partial CTUs)
  hevc_1080p_intra.h265   make_frame(1920, 1080, seed=0) and
                          make_frame(1920, 1080, seed=1, kind="edges"),
                          qp 30, all-intra (the GPU smoke's input)
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jmcodec_tpu import native as jax_native
from jmcodec_tpu.codec.hevc import nal as JHN
from jmcodec_tpu.codec.hevc import params as JHP
from jmcodec_tpu.codec.hevc import plan as JPLAN
from jmcodec_tpu.codec.hevc import slicehdr as JHS
from jmcodec_tpu.codec.hevc.refdec import HevcRefDecoder, _substream_offsets
from jmcodec_tpu_torch.api.hevc_intra import parse_hevc_intra_plans
from jmcodec_tpu_torch.codec.hevc.plan import HevcFramePlan
from jmcodec_tpu_torch.kernels import hevc_tiles as PT
from jmcodec_tpu_torch.tools.fixtures import plan_from_reference

from util_oracle import have_oracle, oracle_decode

DATA = os.path.join(os.path.dirname(__file__), "data")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMS = {"128x96_ctu32": ("hevc_128x96_ctu32.h265", 3, 5),
           "168x80_ctu64": ("hevc_168x80.h265", 2, 6)}


def _stream(name):
    return open(os.path.join(DATA, STREAMS[name][0]), "rb").read()


@pytest.fixture(scope="module")
def decoded():
    """name -> (stream, plans, port output (Y, U, V) numpy, reference)."""
    out = {}
    for name in STREAMS:
        s = _stream(name)
        plans = parse_hevc_intra_plans(s)
        Y, U, V = PT.decode_plans_batch(plans, torch.device("cpu"))
        out[name] = (s, plans, (Y.numpy(), U.numpy(), V.numpy()),
                     HevcRefDecoder().decode(s))
    return out


def _assert_frames(got, want):
    assert len(want) == got[0].shape[0]
    for i, frame in enumerate(want):
        for k, plane in enumerate("YUV"):
            assert np.array_equal(got[k][i], frame[k]), f"frame {i} {plane}"


@pytest.mark.parametrize("name", list(STREAMS))
def test_slice_matches_host_reference(decoded, name):
    _, plans, got, ref = decoded[name]
    n_frames, log2_ctb = STREAMS[name][1:]
    assert len(plans) == n_frames and plans[0].log2_ctb == log2_ctb
    assert got[0].dtype == np.uint8
    _assert_frames(got, ref)


@pytest.mark.parametrize("name", list(STREAMS))
def test_slice_matches_libavcodec(decoded, name):
    if not have_oracle():
        pytest.skip("libavcodec oracle unavailable")
    s, _, got, _ = decoded[name]
    want, _, _ = oracle_decode(s, suffix=".h265")
    _assert_frames(got, want)


def test_decode_plan_is_a_batch_of_one(decoded):
    _, plans, got, _ = decoded["168x80_ctu64"]
    p = plans[1]
    Y, U, V = PT.decode_plan(p, "cpu")
    assert Y.shape == (p.height, p.width)
    for k, a in enumerate((Y, U, V)):
        assert np.array_equal(a.numpy(), got[k][1])
    Yc, Uc, Vc = PT.decode_plan(p, "cpu", coded=True)
    assert Yc.shape == (p.ph, p.pw) and Uc.shape == (p.ph // 2, p.pw // 2)
    assert np.array_equal(Yc[:p.height, :p.width].numpy(), got[0][1])


def _reference_plans(stream):
    """HevcFramePlans filled by jmcodec_tpu's own host modules."""
    units = list(JHN.parse_nal_units(stream))
    sps = [JHP.parse_sps(u.rbsp) for u in units
           if u.nal_unit_type == JHN.NAL_SPS][0]
    pps = [JHP.parse_pps(u.rbsp) for u in units
           if u.nal_unit_type == JHN.NAL_PPS][0]
    plans = []
    for u in (u for u in units if u.is_slice):
        hdr = JHS.parse_slice_header(u.rbsp, u.nal_unit_type, sps, pps)
        plan = JPLAN.HevcFramePlan.create(sps)
        plan.record_slice(hdr, pps)
        jax_native.hevc_fill_plan(plan, hdr, sps, pps, u.rbsp,
                                  _substream_offsets(hdr, u.emu_positions))
        plans.append(plan)
    return plans


@pytest.mark.parametrize("name", list(STREAMS))
def test_parser_fills_the_same_plans(decoded, name):
    """The port's own copies of the host modules and the native parser
    fill the plans jmcodec_tpu's fill; plan_from_reference carries a
    jmcodec_tpu plan into the port's type, and it decodes the same."""
    s, plans, got, _ = decoded[name]
    theirs = _reference_plans(s)
    assert len(theirs) == len(plans)
    for a, b in zip(plans, theirs):
        assert vars(a).keys() == vars(b).keys()
        for f, v in vars(b).items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(getattr(a, f), v), f
            else:
                assert getattr(a, f) == v, f
    copies = [plan_from_reference(p) for p in theirs]
    assert all(type(c) is HevcFramePlan for c in copies)
    assert copies[0].coeff_y is not theirs[0].coeff_y
    Y, U, V = PT.decode_plans_batch(copies[:1], "cpu")
    for k, a in enumerate((Y, U, V)):
        assert np.array_equal(a[0].numpy(), got[k][0])


def test_entry_points_need_the_card_unless_told(decoded):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    plans = decoded["128x96_ctu32"][1]
    with pytest.raises(RuntimeError, match="CUDA"):
        PT.stack_plans(plans)
    with pytest.raises(RuntimeError, match="CUDA"):
        PT.decode_plans_batch(plans)
    with pytest.raises(RuntimeError, match="CUDA"):
        PT.decode_plan(plans[0])


def test_threaded_parse_matches_serial():
    s = _stream("128x96_ctu32")
    serial = parse_hevc_intra_plans(s)
    threaded = parse_hevc_intra_plans(s, workers=3)
    for a, b in zip(serial, threaded):
        for f in ("coeff_y", "tu_log2_y", "mode_y", "zidx_y", "coeff_cb",
                  "mode_c", "bs_ver", "sao_offsets"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_mixed_geometry_batch_rejected():
    a = parse_hevc_intra_plans(_stream("128x96_ctu32"))[:1]
    b = parse_hevc_intra_plans(_stream("168x80_ctu64"))[:1]
    with pytest.raises(NotImplementedError):
        PT.decode_plans_batch(a + b, "cpu")


def test_fixture_digests_match_libavcodec():
    if not have_oracle():
        pytest.skip("libavcodec oracle unavailable")
    s = open(os.path.join(DATA, "hevc_1080p_intra.h265"), "rb").read()
    meta = json.load(open(os.path.join(DATA, "hevc_1080p_intra.sha256.json")))
    frames, W, H = oracle_decode(s, suffix=".h265")
    assert (W, H) == (meta["width"], meta["height"]) == (1920, 1080)
    assert len(frames) == len(meta["frames"]) == 2
    for frame, want in zip(frames, meta["frames"]):
        for plane, a in zip("YUV", frame):
            got = hashlib.sha256(np.ascontiguousarray(a)).hexdigest()
            assert got == want[plane]


def test_port_never_imports_jax():
    code = (
        "import sys, torch\n"
        "import jmcodec_tpu_torch\n"
        "from jmcodec_tpu_torch.api.hevc_intra import parse_hevc_intra_plans\n"
        "from jmcodec_tpu_torch.kernels import hevc_tiles, hevc_walk, _build\n"
        "from jmcodec_tpu_torch.utils import device\n"
        f"s = open({os.path.join(DATA, STREAMS['168x80_ctu64'][0])!r}, "
        "'rb').read()\n"
        "Y, U, V = hevc_tiles.decode_plans_batch(parse_hevc_intra_plans(s), "
        "'cpu')\n"
        "assert Y.shape == (2, 80, 168), Y.shape\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
