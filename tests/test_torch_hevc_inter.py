"""The port's HEVC inter (P/B) decode on the CPU, at tolerance 0:

- motion compensation (prep_hevc_ref, _mc_hevc_luma, _mc_hevc_chroma,
  _combine_pred) equals jmcodec_tpu's on seeded inputs, every phase, MVs at
  the 56 px gate and beyond it (where both clamp the gather as XLA does);
- the port's HevcRefDecoder fills the same per-picture plans (bS maps,
  motion, weights, reference slots) as jmcodec_tpu's and emits the same
  output order, on a B-pyramid stream; parsing reads no pixels, so both
  decoders run with a hook that returns constant planes;
- decode_hevc(stream, "cpu") equals the libavcodec digests of committed
  small streams (P only, B pyramid, IDR every 2, AMP/rect, a conformance
  crop, weighted prediction, ref=3, CTU 32 over four CTB rows);
- every picture of the 1080p inter fixture parses natively in the device
  path's scope, and the fixture's digests are libavcodec's.

The JAX inter wavefront itself is not run: one eager decode of a small
stream takes minutes on the CPU backend.

The small streams were made with tests/util_oracle.py (x265 via the
oracle), with moving(W, H, n, seed) the pan of
make_frame(2W, 2H, seed) by (3i, 2i) px that tests/test_hevc_device_inter.py
uses:
  hevc_inter_p_64x64        moving(64, 64, 6), qp 30, gop 20
  hevc_inter_b3_64x64       the same, extra "bframes=3"
  hevc_inter_idr2_64x64     moving(64, 64, 4), qp 30, gop 2
  hevc_inter_amp_64x64      moving(64, 64, 4), qp 22, gop 20,
                            extra "amp=1:rect=1"
  hevc_inter_100x60         moving(100, 60, 4), qp 30, gop 20
  hevc_inter_weightp_64x64  make_frame(64, 64, seed=9) with luma scaled by
                            1 - 0.09 i for i in 0..4, qp 28, gop 20,
                            extra "weightp=1"
  hevc_inter_ref3_64x64     moving(64, 64, 6, seed=3), qp 30, gop 20,
                            extra "ref=3:bframes=2"
  hevc_inter_ctu32_192x128  moving(192, 128, 8, seed=5), frame i with
                            make_frame(32, 32, seed=i, kind="edges") at
                            ((40 i) % 96 // 8 * 8, (56 i) % 160 // 8 * 8)
                            (half that for chroma), qp 30, gop 20,
                            extra "ctu=32:bframes=3"
Each has a .sha256.json of its libavcodec decode.
"""

import copy
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jmcodec_tpu.codec.hevc.refdec import HevcRefDecoder as JaxRefDecoder
from jmcodec_tpu.kernels import hevc_tiles as JT
from jmcodec_tpu_torch.api.hevc_inter import decode_hevc
from jmcodec_tpu_torch.codec.hevc.refdec import HevcRefDecoder
from jmcodec_tpu_torch.kernels import hevc_tiles as PT
from jmcodec_tpu_torch.kernels import hevc_walk as HW
from jmcodec_tpu_torch.tools.fixtures import (INTER_DIGESTS,
                                              fixture_digests,
                                              inter_fixture_stream,
                                              plan_from_reference,
                                              synth_state_inter)

from util_oracle import have_oracle, oracle_decode

DATA = os.path.join(os.path.dirname(__file__), "data")
# name -> pictures
STREAMS = {"hevc_inter_p_64x64": 6, "hevc_inter_b3_64x64": 6,
           "hevc_inter_idr2_64x64": 4, "hevc_inter_amp_64x64": 4,
           "hevc_inter_100x60": 4, "hevc_inter_weightp_64x64": 5,
           "hevc_inter_ref3_64x64": 6, "hevc_inter_ctu32_192x128": 8}


def _stream(name):
    return open(os.path.join(DATA, name + ".h265"), "rb").read()


# ---------------------------------------------------------------------------
# motion compensation against jmcodec_tpu
# ---------------------------------------------------------------------------


def _planes(rng, H, W):
    return tuple(rng.integers(0, 256, s).astype(np.uint8)
                 for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))


@pytest.mark.parametrize("H,W", [(64, 64), (60, 100)])
def test_prep_hevc_ref_matches_jax(H, W):
    planes = _planes(np.random.default_rng(H + W), H, W)
    got = PT.prep_hevc_ref(*map(torch.from_numpy, planes))
    want = JT.prep_hevc_ref(*map(jnp.asarray, planes))
    for g, w in zip(got, want):
        assert g.dtype == torch.int16 and tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w))


def _motion(rng, Hc, Wc, R, reach):
    """Per-cell MVs (quarter-pel) over +-reach, the edge cells at +-reach,
    every luma phase and every chroma eighth-pel phase present among the
    other cells; slots over R references."""
    mv = rng.integers(-reach, reach + 1, (Hc, Wc, 2)).astype(np.int32)
    inner = mv[1:-1, 1:-1]
    k = np.arange(inner.shape[0] * inner.shape[1]).reshape(inner.shape[:2])
    inner[..., 0] = (inner[..., 0] & ~7) | (k & 7)
    inner[..., 1] = (inner[..., 1] & ~7) | ((k >> 3) & 7)
    for sl in ((0, slice(None)), (-1, slice(None)), (slice(None), 0),
               (slice(None), -1)):
        mv[sl] = np.where(rng.random(mv[sl].shape) < 0.5, reach, -reach)
    slot = rng.integers(0, R, (Hc, Wc)).astype(np.int32)
    return mv, slot


# reach in quarter-pel: the plan's gate (56 px), and beyond it
@pytest.mark.parametrize("reach", [224, 400], ids=["gate", "beyond"])
@pytest.mark.parametrize("H,W", [(64, 64), (60, 100)])
def test_mc_matches_jax(H, W, reach):
    rng = np.random.default_rng(reach + H)
    Hp, Wp = -(-H // 16) * 16, -(-W // 16) * 16
    refs = [JT.prep_hevc_ref(*map(jnp.asarray, _planes(rng, H, W)))
            for _ in range(3)]
    stacks = [jnp.stack([r[i] for r in refs]) for i in range(3)]
    mv, slot = _motion(rng, Hp // 4, Wp // 4, 3, reach)
    assert len({(x & 3, y & 3) for x, y in mv.reshape(-1, 2)}) == 16
    assert len({(x & 7, y & 7) for x, y in mv.reshape(-1, 2)}) == 64
    t = lambda a: torch.from_numpy(np.array(a))
    got = PT._mc_hevc_luma(t(stacks[0]), t(mv), t(slot))
    want = JT._mc_hevc_luma(stacks[0], jnp.asarray(mv), jnp.asarray(slot))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    for k in (1, 2):
        got = PT._mc_hevc_chroma(t(stacks[k]), t(mv), t(slot))
        want = JT._mc_hevc_chroma(stacks[k], jnp.asarray(mv),
                                  jnp.asarray(slot))
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("weights", ["identity", "explicit"])
def test_combine_pred_matches_jax(weights):
    rng = np.random.default_rng(17 if weights == "identity" else 18)
    Hc, Wc = 6, 7
    p0, p1 = (rng.integers(-2000, 18000, (Hc, Wc, 4, 4)).astype(np.int32)
              for _ in range(2))
    # uni L0, uni L1 and bi cells
    pred = rng.integers(1, 4, (Hc, Wc))
    fl0, fl1 = ((pred & 1).astype(np.int32), (pred >> 1).astype(np.int32))
    assert {1, 2, 3} == set(pred.ravel().tolist())
    for log2wd in range(6, 14):
        if weights == "identity":
            w0 = w1 = np.ones((Hc, Wc), np.int32)
            o0 = o1 = np.zeros((Hc, Wc), np.int32)
        else:
            w0, w1 = (rng.integers(-128, 256, (Hc, Wc)).astype(np.int32)
                      for _ in range(2))
            o0, o1 = (rng.integers(-128, 128, (Hc, Wc)).astype(np.int32)
                      for _ in range(2))
        args = (p0, p1, fl0, fl1, w0, o0, w1, o1)
        got = PT._combine_pred(*map(torch.from_numpy, args), log2wd)
        want = JT._combine_pred(*map(jnp.asarray, args), jnp.int32(log2wd))
        assert np.array_equal(got.numpy(), np.asarray(want)), log2wd


def test_cells_to_plane_matches_jax():
    cells = np.random.default_rng(2).integers(0, 99, (3, 5, 4, 4))
    got = PT._cells_to_plane_j(torch.from_numpy(cells)).numpy()
    assert np.array_equal(got, np.asarray(JT._cells_to_plane_j(
        jnp.asarray(cells))))


def test_deblock_bs1_matches_jax():
    """Inter pictures bring bS 1 (motion edges): luma filters with tc at
    qp + 0, chroma not at all."""
    rng = np.random.default_rng(4)
    Hp, Wp = 32, 48
    ramp = lambda h, w: ((np.mgrid[0:h, 0:w][1] // 8) * 9 % 40 + 100
                         + rng.integers(-2, 3, (h, w))).astype(np.int32)
    Y, U, V = ramp(Hp, Wp), ramp(Hp // 2, Wp // 2), ramp(Hp // 2, Wp // 2)
    bs = np.ones((Hp // 4, Wp // 4), np.int32)
    qp = np.full((Hp // 4, Wp // 4), 37, np.int32)
    t = lambda a: torch.from_numpy(a)[None]
    o = lambda v: torch.tensor([v], dtype=torch.int32)
    got = PT._deblock(t(Y), t(U), t(V), t(bs), t(bs), t(qp), o(0), o(0),
                      o(0), o(0))
    want = jax.jit(JT._deblock)(*map(jnp.asarray, (Y, U, V, bs, bs, qp)),
                                0, 0, 0, 0)
    for g, w in zip(got, want):
        assert np.array_equal(g[0].numpy(), np.asarray(w))
    assert not np.array_equal(got[0][0].numpy(), Y)
    assert np.array_equal(got[1][0].numpy(), U)


def test_walk_on_inter_states_matches_jax():
    """The plain walk (walk() on CPU tensors) equals jmcodec_tpu's XLA walk
    on inter-seeded states: the base passes through where no intra TU
    writes, and lanes without a TU come back unchanged."""
    C, max_tu = 16, 16
    st = synth_state_inter(C, max_tu, B=8, seed=6, skew=3)
    F, Z, R, T, M = st
    kw = dict(C=C, max_tu=max_tu, is_chroma=False, strong=False)
    got = HW.walk(*map(torch.from_numpy, st), **kw).numpy()
    jwalk = jax.jit(JT._make_walk(C, max_tu, False, False, unroll_below=8))
    want = np.asarray(jwalk(jnp.asarray(F.astype(np.int32)), jnp.asarray(Z),
                            jnp.asarray(R.astype(np.int32)), jnp.asarray(T),
                            jnp.asarray(M)))
    assert np.array_equal(got.astype(np.int32), want)
    assert np.array_equal(got[3], F[3]) and not T[3].any()
    assert T[:3].any() and not np.array_equal(got[:3], F[:3])


# ---------------------------------------------------------------------------
# host stream machinery against jmcodec_tpu
# ---------------------------------------------------------------------------


def _recorded(decoder_cls, stream):
    """Decode with a hook that records a copy of each plan and returns
    planes filled with the picture's POC: the plans in decode order, the
    POCs in output order."""
    plans = []

    def hook(plan, ref_pixels):
        assert [p for p, *_ in ref_pixels] == (plan.ref_pocs or [])
        plans.append(copy.deepcopy(plan))
        f = lambda h, w: np.full((h, w), plan.poc % 256, np.uint8)
        return f(plan.ph, plan.pw), *[f(plan.ph // 2, plan.pw // 2)] * 2

    frames = decoder_cls(device_recon=hook).decode(stream)
    return plans, [int(y[0, 0]) for y, _, _ in frames]


@pytest.mark.parametrize("name", ["hevc_inter_ctu32_192x128",
                                  "hevc_inter_idr2_64x64"])
def test_plans_and_order_match_jax(name):
    s = _stream(name)
    ours, order = _recorded(HevcRefDecoder, s)
    theirs, jorder = _recorded(JaxRefDecoder, s)
    assert order == jorder and len(order) == STREAMS[name]
    assert len(ours) == len(theirs) == STREAMS[name]
    for a, b in zip(ours, theirs):
        b = plan_from_reference(b)
        assert vars(a).keys() == vars(b).keys()
        for f, v in vars(b).items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(getattr(a, f), v), (a.poc, f)
            else:
                assert getattr(a, f) == v, (a.poc, f)
    if name == "hevc_inter_ctu32_192x128":
        # the stream holds what it is there for: B pictures with 4 refs,
        # weighted P slices, bS 1, intra TUs in inter pictures
        assert max(len(p.ref_pocs or []) for p in ours) == 4
        assert any(p.luma_log2wd for p in ours)
        assert any((p.bs_ver == 1).any() for p in ours)
        assert all((p.tu_log2_y > 0).any() for p in ours)
        assert sorted(order) == order != [p.poc for p in ours]


# ---------------------------------------------------------------------------
# the whole slice on the CPU against libavcodec
# ---------------------------------------------------------------------------


def _assert_digests(frames, digests):
    assert len(frames) == len(digests)
    for i, (frame, want) in enumerate(zip(frames, digests)):
        for plane, a in zip("YUV", frame):
            assert a.dtype == torch.uint8 and a.device.type == "cpu"
            h = hashlib.sha256(np.ascontiguousarray(a.numpy())).hexdigest()
            assert h == want[plane], f"frame {i} {plane}"


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_matches_libavcodec_digests(name):
    frames = decode_hevc(_stream(name), "cpu")
    meta = json.load(open(os.path.join(DATA, name + ".sha256.json")))
    assert frames[0][0].shape == (meta["height"], meta["width"])
    _assert_digests(frames, meta["frames"])


def test_scan_skips_steps_without_a_tu():
    """CTU 32 over four CTB rows: 15 scan steps a plane type; the walk runs
    on every step of the I picture and only on the steps that hold an
    intra TU of the inter pictures."""
    plans, _ = _recorded(HevcRefDecoder, _stream("hevc_inter_ctu32_192x128"))
    steps = [PT.walk_steps(p) for p in plans]
    assert all(len(y) == len(c) == 15 for y, c in steps)
    assert all(steps[0][0]) and all(steps[0][1])
    assert all(0 < sum(y) < 15 for y, _ in steps[1:])
    calls = []

    def counting(F, *a, **kw):
        calls.append(kw["is_chroma"])
        return HW.walk_reference(F, *a, **kw)

    p = plans[2]
    args = PT.stack_plans([p], "cpu")
    want = PT.decode_plan_inter(p, [], "cpu", coded=True)
    inter = [torch.from_numpy(np.asarray(getattr(p, f)))
             for f in ("inter4", "mv", "ref_slot", "pred_fl",
                       "tu_log2_inter_y", "tu_log2_inter_c", "wp_w")]
    zeros = [torch.zeros((1, n, p.ph + 128 >> k, p.pw + 128 >> k),
                         dtype=torch.int16) for n, k in ((16, 0), (8, 1),
                                                         (8, 1))]
    for has_tu in (steps[2], None):
        calls.clear()
        got = PT.decode_frame_hevc_inter(
            *args[:7], p.pw, p.ph, *args[9:], *inter, p.luma_log2wd,
            p.chroma_log2wd, *zeros, has_tu=has_tu, walk_fn=counting)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert len(calls) == (sum(map(sum, steps[2])) if has_tu else 30)


def test_entry_point_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_hevc(_stream("hevc_inter_p_64x64"))


def test_1080p_fixture_parses_in_device_scope():
    """Every picture of the 16-picture 1080p fixture parses natively with
    a supported plan (parse only: no CPU decode at 1080p)."""
    plans, order = _recorded(HevcRefDecoder, inter_fixture_stream())
    assert len(plans) == 16 and order == list(range(16))
    assert all(p.supported and (p.width, p.height) == (1920, 1080)
               for p in plans)
    assert sum(p.ref_pocs is None for p in plans) == 1
    assert all(len(p.ref_pocs) <= 4 for p in plans[1:])
    assert all((p.tu_log2_y > 0).any() for p in plans)
    assert max(int(np.abs(p.mv).max()) for p in plans) <= 4 * 56


def test_1080p_fixture_digests_match_libavcodec():
    if not have_oracle():
        pytest.skip("libavcodec oracle unavailable")
    frames, W, H = oracle_decode(inter_fixture_stream(), suffix=".h265")
    digests = fixture_digests(INTER_DIGESTS)
    assert (W, H) == (1920, 1080) and len(frames) == len(digests) == 16
    for frame, want in zip(frames, digests):
        for plane, a in zip("YUV", frame):
            got = hashlib.sha256(np.ascontiguousarray(a)).hexdigest()
            assert got == want[plane]
