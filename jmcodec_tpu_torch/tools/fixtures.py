"""Inputs for checks and timings of the port: the committed 1080p HEVC and
H.264 all-intra fixtures at the smoke's batches, the 1080p HEVC and H.264
inter fixtures, the 1080p HEVC cu_qp_delta fixture, the small session and
HEVC host-route fixtures and the bit-flip corpus, the 1080p encode
fixture's frames and the digests of their stream,
seeded synthetic inputs for holding each kernel against its plain version,
and copies of reference objects into the port's own types."""

from __future__ import annotations

import json
import os

import numpy as np

from ..api.h264_intra import _picture_chunks
from ..codec.h264.symbols import FrameSymbols
from ..codec.hevc.plan import ZIDX_NONE, HevcFramePlan

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURE = os.path.join(ROOT, "tests", "data", "hevc_1080p_intra.h265")
DIGESTS = os.path.join(ROOT, "tests", "data", "hevc_1080p_intra.sha256.json")
H264_FIXTURE = os.path.join(ROOT, "tests", "data", "h264_1080p_intra.h264")
H264_DIGESTS = os.path.join(ROOT, "tests", "data",
                            "h264_1080p_intra.sha256.json")
INTER_FIXTURE = os.path.join(ROOT, "tests", "data", "hevc_1080p_inter.h265")
INTER_DIGESTS = os.path.join(ROOT, "tests", "data",
                             "hevc_1080p_inter.sha256.json")
H264_INTER_FIXTURE = os.path.join(ROOT, "tests", "data",
                                  "h264_1080p_inter.h264")
H264_INTER_DIGESTS = os.path.join(ROOT, "tests", "data",
                                  "h264_1080p_inter.sha256.json")
CUQP_FIXTURE = os.path.join(ROOT, "tests", "data", "hevc_1080p_cuqp.h265")
CUQP_DIGESTS = os.path.join(ROOT, "tests", "data",
                            "hevc_1080p_cuqp.sha256.json")
ENCODE_DIGESTS = os.path.join(ROOT, "tests", "data",
                              "h264_enc_1080p.sha256.json")
# frames per decode batch, as bench.py's 1080p figures decode them
BATCH = 16
H264_BATCH = 32


def fixture_digests(path: str = DIGESTS) -> list[dict]:
    """Per-frame {"Y", "U", "V"} SHA-256 of a fixture's libavcodec decode."""
    with open(path) as f:
        return json.load(f)["frames"]


def _repeated(stream_path: str, digests_path: str, batch: int) -> bytes:
    with open(stream_path, "rb") as f:
        one = f.read()
    return one * (batch // len(fixture_digests(digests_path)))


def fixture_batch_stream() -> bytes:
    """The HEVC fixture repeated to BATCH pictures (all are IDR)."""
    return _repeated(FIXTURE, DIGESTS, BATCH)


def h264_fixture_batch_stream() -> bytes:
    """The H.264 fixture repeated to H264_BATCH pictures (all are IDR; the
    repeated parameter sets are the same ones)."""
    return _repeated(H264_FIXTURE, H264_DIGESTS, H264_BATCH)


def inter_fixture_stream() -> bytes:
    """The 1080p HEVC inter fixture: 16 pictures in one GOP, I then P and B
    (x265, CTU 64, WPP, no cu_qp_delta, num_reorder_pics 2, weighted
    prediction in the P slices, every |MV| within the plan's 56 px gate).
    Its libavcodec digests are in INTER_DIGESTS. Made with
    tests/util_oracle.py (make_frame, oracle_encode, oracle_decode):

        BY, BU, BV = make_frame(1984, 1144, seed=0)
        for i in range(16):                 # a pan by (3i, 2i) px
            Y = BY[2i:2i+1080, 3i:3i+1920]  (U, V: the same at half size)
            Y, U, V += default_rng(100 + i).integers(-6, 7, shape), drawn
                       in that order, one call per plane
            EY, EU, EV = make_frame(256, 256, seed=i, kind="edges")
            flip = np.kron(default_rng(1000 + i).integers(0, 2, (32, 32)),
                           np.ones((8, 8)))
            EY = where(flip == 1, 256 - EY, EY)   # new edges every frame
            by = (197 i) % 824 // 8 * 8; bx = (421 i) % 1664 // 8 * 8
            Y[by:by+256, bx:bx+256] = EY      (U, V: EU, EV at half)
            clip to 0..255, uint8
        oracle_encode(frames, 1920, 1080, qp=30, codec="libx265", gop=16,
                      extra="bframes=3:merange=16")

    The block of new content forces intra CUs into the P and B pictures,
    so the TU walk runs on the inter path. merange=16 keeps the motion
    within the gate (x265's default search, and merange=48, left a few
    cells of two pictures beyond it)."""
    with open(INTER_FIXTURE, "rb") as f:
        return f.read()


def cuqp_fixture_stream() -> bytes:
    """The 1080p HEVC fixture with cu_qp_delta: an I and two P pictures
    (x265 ABR with adaptive quantisation, CTU 64, luma QP 35-48 from cell
    to cell; every |MV| within the plan's 56 px gate). The native parser
    refuses cu_qp_delta, so every picture is parsed in Python and
    reconstructed on the device. Its libavcodec digests are in
    CUQP_DIGESTS. Made with tests/util_oracle.py from the first three
    frames of inter_fixture_stream's content:

        oracle_encode(frames, 1920, 1080, qp=30, codec="libx265", gop=20,
                      extra="bitrate=3000:vbv-maxrate=3000:"
                            "vbv-bufsize=6000:aq-mode=2:bframes=0:"
                            "merange=16")

    (tests/test_torch_hevc_host.py holds the recipe as code and rebuilds
    it.)"""
    with open(CUQP_FIXTURE, "rb") as f:
        return f.read()


def h264_inter_fixture_stream() -> bytes:
    """The 1080p H.264 P fixture: an IDR picture and four P pictures
    (x264, CABAC, main profile, ref=3 with weightp=2: explicit weights and
    one reference at two list indices, num_ref_idx_l0 1, 3, 4, 4; POC type
    2, no 8x8 transform, no PCM). Its libavcodec digests are in
    H264_INTER_DIGESTS. Made with tests/util_oracle.py (make_frame,
    oracle_encode, oracle_decode) from inter_fixture_stream's frames, five
    of them, each chroma plane cut at [i:i+540, 3i//2:3i//2+960]:

        oracle_encode(frames, 1920, 1080, qp=30, codec="libx264", gop=5,
                      extra="cabac=1:ref=3:weightp=2", profile="main")

    The block of new edges puts 283-507 intra macroblocks into each P
    picture, on 52-93 of the 254 diagonals of the intra scan."""
    with open(H264_INTER_FIXTURE, "rb") as f:
        return f.read()


def _gradient_noise_frame(W: int, H: int, seed: int):
    """tests/util_oracle.make_frame(W, H, seed, "gradient_noise"): a
    diagonal luma ramp with uniform noise, chroma ramps with noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    Y = np.clip((x * 3 + y * 2) % 256 + rng.integers(-24, 24, (H, W)), 0,
                255)
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    U = np.clip(((cx * 2) % 200 + 28)
                + rng.integers(-8, 8, (H // 2, W // 2)), 0, 255)
    V = np.clip(((cy * 2) % 200 + 28)
                + rng.integers(-8, 8, (H // 2, W // 2)), 0, 255)
    return Y.astype(np.uint8), U.astype(np.uint8), V.astype(np.uint8)


def pan_frames(W: int, H: int, n: int, step=(3, 2), seed: int = 3) -> list:
    """tests/test_inter_decode.moving_frames(W, H, n, seed, step): frame i
    [(Y, U, V) uint8] cut at row step[0] * i, column step[1] * i of
    make_frame(W + 64, H + 64, seed, "gradient_noise")."""
    BY, BU, BV = _gradient_noise_frame(W + 64, H + 64, seed)
    cut = lambda P, y, x, h, w: P[y:y + h, x:x + w].copy()
    out = []
    for i in range(n):
        dy, dx = i * step[0], i * step[1]
        out.append((cut(BY, dy, dx, H, W),
                    cut(BU, dy // 2, dx // 2, H // 2, W // 2),
                    cut(BV, dy // 2, dx // 2, H // 2, W // 2)))
    return out


def encode_fixture_frames(n: int = 3) -> list:
    """The 1080p encode fixture's frames: pan_frames(1920, 1080, n). The
    SHA-256 and length of the stream that jmcodec_tpu's
    EncoderSession(EncoderParams()) (1080p30, 2 Mb/s VBR, GOP 30, the
    device engine) makes of them, its keyframe flags and the libavcodec
    digests of its decode are in ENCODE_DIGESTS (tests/test_torch_encode.py
    holds the recipe as code and rebuilds them)."""
    return pan_frames(1920, 1080, n)


# small device-engine encoder sessions (chip_smoke.py's phase 19 and
# tests/test_torch_encode_cuda.py): name -> (EncoderParams keywords, frames
# of pan_frames); rate control over GOPs that cross an IDR
ENCODE_SESSIONS = {"cbr_gop3": (dict(width=96, height=64, bitrate_kb=300,
                                     gop_len=3, rc_mode="cbr"), 5),
                   "vbr_gop4": (dict(width=64, height=64, bitrate_kb=200,
                                     gop_len=4), 6)}


def encode_fixture() -> dict:
    """ENCODE_DIGESTS: {"stream": {"sha256", "length"}, "keyframes": [...],
    "frames": [{"Y", "U", "V"}, ...]}."""
    with open(ENCODE_DIGESTS) as f:
        return json.load(f)


# the session fixtures under tests/data (their recipes are in
# tests/test_torch_session_host.py) -> (pictures the session decodes on the
# device, on the host): the B stream's and the High stream's IDR on the
# device and the rest on the host through the DPB mirror, the I_PCM
# pictures on the host, the three IDR pictures on the device
SESSION_FIXTURES = {"h264_session_b_96x64": (1, 5),
                    "h264_session_high_96x64": (1, 5),
                    "h264_session_pcm_48x48": (0, 3),
                    "h264_session_idr3_96x64": (3, 0)}
# the streams of the bit-flip corpus: three IDR pictures; and two streams
# of I and P pictures that all take the device path (CAVLC, three slices a
# picture; CAVLC, ref=3), so that a flipped P picture reaches the device
# inter decode, with the trials whose flipped picture does (the others are
# dropped as corrupt)
CORPUS_FIXTURE = "h264_session_idr3_96x64"
P_CORPUS_FIXTURES = {"h264_inter_slices3_96x64": {0, 1, 2, 3, 6},
                     "h264_inter_veryslow_96x64": {4, 6}}
# pictures of the 1080p H.264 P fixture that the session phase decodes
H264_SESSION_PICTURES = 3
# the small HEVC fixtures of the host route under tests/data -> (pictures
# HevcRefDecoder with DeviceRecon decodes on the device, on the host), as
# jmcodec_tpu routes them. Each was made with tests/util_oracle.py's
# oracle_encode (x265, qp 30), from make_frame content; each has a
# .sha256.json of its libavcodec decode (tests/test_torch_hevc_host.py
# holds the recipes as code and rebuilds them):
#   hevc_cuqp_intra_192x128  make_frame(192, 128, seed=i), i < 3, gop 1,
#       "bitrate=300:aq-mode=2:vbv-bufsize=600:vbv-maxrate=300": cu_qp_delta
#       I pictures, parsed in Python, on the device
#   hevc_cuqp_p_64x64        make_frame(64, 64, seed=3), luma rolled 2i px,
#       i < 3, gop 3, CUQP (below): I + 2 P
#   hevc_cuqp_b_64x64        moving(64, 64, 6, seed=4), gop 20,
#       CUQP + ":bframes=3": B slices through the Python merge/TMVP/AMVP
#   hevc_slices2_96x128      moving(96, 128, 3, seed=6), gop 20,
#       "slices=2:ctu=32": two slices a picture, I and P, on the host
#   hevc_tskip_128x96        one 128x96 picture of 0/255 luma
#       (default_rng(1)), chroma 128, three times, gop 3, "tskip=1:ctu=16":
#       the transform-skip I picture on the host, the two P pictures
#       without one on the device against its numpy planes
#   hevc_tskip_2gop_128x96   that stream's content, then the same from
#       default_rng(2), gop 3, "tskip=1:ctu=16:open-gop=0": two GOPs, each
#       an IDR on the host (POC 0 both times) and two P pictures on the
#       device, the second GOP's against its own IDR's planes
#   hevc_far_mv_128x64       uniform noise (default_rng(11)) panned 64 px
#       a picture, 3 pictures, gop 3, "merange=100:ctu=32:me=full": the I
#       on the device, the P pictures (motion past the 56 px gate) on the
#       host against its device planes
#   hevc_ref5_64x64          moving(64, 64, 10, seed=2), gop 30,
#       "ref=5:bframes=3": the B pictures with five unique references
#       on the host
# with CUQP = "bitrate=150:aq-mode=2:vbv-bufsize=300:vbv-maxrate=150:ctu=32"
# and moving(W, H, n, seed) the pan of make_frame(2W, 2H, seed) by (3i, 2i)
# px (chroma by (3i//2, i)).
HEVC_HOST_FIXTURES = {"hevc_cuqp_intra_192x128": (3, 0),
                      "hevc_cuqp_p_64x64": (3, 0),
                      "hevc_cuqp_b_64x64": (6, 0),
                      "hevc_slices2_96x128": (0, 3),
                      "hevc_tskip_128x96": (2, 1),
                      "hevc_tskip_2gop_128x96": (4, 2),
                      "hevc_far_mv_128x64": (1, 2),
                      "hevc_ref5_64x64": (8, 2)}


def session_fixture(name: str, ext: str = ".h264") -> tuple[bytes,
                                                           list[dict]]:
    """A fixture's stream and its libavcodec digests."""
    path = os.path.join(ROOT, "tests", "data", name)
    with open(path + ext, "rb") as f:
        stream = f.read()
    return stream, fixture_digests(path + ".sha256.json")


def h264_session_stream() -> bytes:
    """The first H264_SESSION_PICTURES pictures of the 1080p H.264 P
    fixture (its IDR and P pictures), parameter sets included."""
    head, chunks = _picture_chunks(h264_inter_fixture_stream())
    return head + b"".join(chunks[:H264_SESSION_PICTURES])


def session_corpus(stream: bytes, trials: int = 8, seed: int = 1) -> list:
    """The bit-flip corpus of tests/test_robustness.py: per trial one bit
    flipped inside the second picture's bytes, away from its slice header
    (the corpus's rng and draws; on a stream of IDR pictures the second
    picture is the robustness test's second GOP)."""
    head, chunks = _picture_chunks(stream)
    lo = len(head) + len(chunks[0])
    hi = lo + len(chunks[1])
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(trials):
        b = bytearray(stream)
        pos = int(rng.integers(lo + 24, hi - 1))
        b[pos] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(b))
    return out


def synth_idct_blocks(N: int, seed: int = 0):
    """Seeded inputs of dequant_idct_blocks as numpy arrays: levels [N, 4,
    4] int16 over the full int16 range, qp [N] int32 cycling through every
    value 0..51 (shuffled), dc [N] int32 over +-2^20 and a mask [N] bool
    that sets about one block in three."""
    rng = np.random.default_rng(seed)
    coeffs = rng.integers(-32768, 32768, (N, 4, 4)).astype(np.int16)
    qp = rng.permutation(np.arange(N) % 52).astype(np.int32)
    dc = rng.integers(-(1 << 20), 1 << 20, N).astype(np.int32)
    mask = rng.integers(0, 3, N) == 0
    return coeffs, qp, dc, mask


def _copy_fields(src, dst):
    for name, val in vars(src).items():
        setattr(dst, name, val.copy()
                if isinstance(val, (np.ndarray, list, dict)) else val)
    return dst


def symbols_from_reference(fs) -> FrameSymbols:
    """A FrameSymbols-shaped object of another package (duck-typed: the
    same attributes) copied into the port's FrameSymbols, a P picture's
    motion, weights and list-0 modifications included."""
    return _copy_fields(fs, FrameSymbols(fs.mb_width, fs.mb_height))


def plan_from_reference(plan) -> HevcFramePlan:
    """A HevcFramePlan-shaped object of another package copied into the
    port's HevcFramePlan."""
    return _copy_fields(plan, HevcFramePlan.__new__(HevcFramePlan))


def synth_state(C: int, max_tu: int, B: int, seed: int = 0, skew: int = 2):
    """Seeded random walk state as numpy arrays (F int16, Z int32, resid
    int16, tu int32, mode int32), laid out as a scan step with the given
    skew (hevc_tables.skew_for(C) in the decode).
    Each lane's CTB quadrants take random TU sizes from 4 up to
    min(C/2, max_tu); modes are uniform over 0..34. Every fourth lane also
    has a TU of the largest size at (0, 0), in a mode that filters its
    references, and borders that are a linear ramp plus +-1 noise, so the
    32x32 strong-smoothing test (8.4.4.2.3) passes there and its bilinear
    output differs from the [1 2 1] filter's."""
    rng = np.random.default_rng(seed)
    C4, T = C // 4, min(C, max_tu)
    WF, WZ = 1 + skew * C, 1 + skew * C4
    F = np.zeros((B, 1 + C + T, WF), np.int16)
    F[:, 0, :] = rng.integers(0, 256, (B, WF))
    F[:, :, 0] = rng.integers(0, 256, (B, 1 + C + T))
    for b in range(0, B, 4):
        a, dx, dy = (int(rng.integers(80, 171)), int(rng.integers(-1, 2)),
                     int(rng.integers(-1, 2)))
        F[b, 0, :] = np.clip(a + dx * np.arange(WF)
                             + rng.integers(-1, 2, WF), 0, 255)
        F[b, :, 0] = np.clip(a + dy * np.arange(1 + C + T)
                             + rng.integers(-1, 2, 1 + C + T), 0, 255)
    Z = np.full((B, 1 + C4 + T // 4, WZ), ZIDX_NONE, np.int32)
    Z[:, 1:1 + C4, 1:1 + C4] = np.arange(C4 * C4).reshape(C4, C4)
    Z[:, 0, :] = -1
    Z[:, :, 0] = -1
    resid = rng.integers(-20, 21, (B, C, C)).astype(np.int16)
    tu = np.zeros((B, C4, C4), np.int32)
    top_log2 = min(C // 2, max_tu).bit_length() - 1
    h4 = C4 // 2
    for b in range(B):
        for qy in range(2):
            for qx in range(2):
                log2 = int(rng.integers(2, top_log2 + 1))
                n4 = (1 << log2) // 4
                tu[b, qy * h4:(qy + 1) * h4:n4, qx * h4:(qx + 1) * h4:n4] = \
                    log2
        if b % 4 == 0:
            tu[b, 0, 0] = T.bit_length() - 1
    mode = rng.integers(0, 35, (B, C4, C4)).astype(np.int32)
    mode[::4, 0, 0] = rng.choice([0, 2, 18, 34], len(range(0, B, 4)))
    return F, Z, resid, tu, mode


# what lane b of synth_state_hard holds, by b % 6
HARD_KINDS = ("all 4x4", "one largest TU", "no TU", "quadtree",
              "quadtree, extreme residuals", "quadtree, nothing available")


def synth_state_hard(C: int, max_tu: int, B: int, seed: int = 0,
                     skew: int = 2):
    """Seeded walk state in synth_state's layout that a decode seldom
    gives. Lane b is of kind HARD_KINDS[b % 6]: every cell a 4x4 TU (the
    longest chain); one TU of the largest size alone; no TU at all (F must
    come back unchanged); a random TU quadtree; the same with every
    residual at an int16 extreme or in between, so the clip is taken both
    ways; the same with no neighbour available (the first TU predicts from
    128). F is random everywhere, the CTB's own Z is the true z-scan
    order, and each 4-sample patch of the borders (top row with its
    top-right reach, left column with its below-left reach, corner) is
    unavailable with probability 0.3, so substitution meets leading,
    middle and trailing runs."""
    rng = np.random.default_rng(seed)
    C4, T = C // 4, min(C, max_tu)
    T4 = T // 4
    WF, WZ = 1 + skew * C, 1 + skew * C4
    F = rng.integers(0, 256, (B, 1 + C + T, WF)).astype(np.int16)
    bits = lambda v: sum(((v >> k) & 1) << (2 * k) for k in range(4))
    cs = np.arange(C4)
    zscan = bits(cs)[None, :] | (bits(cs)[:, None] << 1)
    Z = np.full((B, 1 + C4 + T4, WZ), ZIDX_NONE, np.int32)
    Z[:, 1:1 + C4, 1:1 + C4] = zscan
    patch = lambda shape: np.where(rng.random(shape) < 0.3, ZIDX_NONE, -1)
    Z[:, 0, :] = patch((B, WZ))
    Z[:, :, 0] = patch((B, 1 + C4 + T4))
    resid = rng.integers(-20, 21, (B, C, C)).astype(np.int16)
    tu = np.zeros((B, C4, C4), np.int32)

    def quadtree(t, x4, y4, n4):
        if n4 == 1 or rng.random() < 0.4:
            t[y4, x4] = (4 * n4).bit_length() - 1
            return
        h = n4 // 2
        for j in range(4):
            quadtree(t, x4 + (j & 1) * h, y4 + (j >> 1) * h, h)

    for b in range(B):
        kind = b % 6
        if kind == 0:
            tu[b] = 2
        elif kind == 1:
            tu[b, 0, 0] = T.bit_length() - 1
        elif kind >= 3:
            for y4 in range(0, C4, T4):
                for x4 in range(0, C4, T4):
                    quadtree(tu[b], x4, y4, T4)
        if kind == 4:
            resid[b] = rng.choice(
                np.array([-32768, -300, 0, 300, 32767], np.int16), (C, C))
        if kind == 5:
            Z[b, 0, :] = ZIDX_NONE
            Z[b, :, 0] = ZIDX_NONE
    mode = rng.integers(0, 35, (B, C4, C4)).astype(np.int32)
    return F, Z, resid, tu, mode


def synth_state_inter(C: int, max_tu: int, B: int, seed: int = 0,
                      skew: int = 2):
    """Seeded walk state of an inter picture's scan step, in synth_state's
    layout. F is random everywhere: its interior stands for the inter
    base, which must pass through where no intra TU writes. Each lane is a
    random TU quadtree whose leaves are intra TUs or, with probability 1/2,
    inter cells (TU 0); Z holds an inter picture's decode-order counters:
    every leaf, intra or inter, takes the next counter in z-scan order with
    a random gap (an inter CU is numbered after its prediction,
    plan.record_inter_cu_done), so the inter cells' counters lie above and
    below the intra TUs'. Every fourth lane is all inter, with no TU. Each
    4-sample patch of the borders is unavailable with probability 0.3."""
    rng = np.random.default_rng(seed)
    C4, T = C // 4, min(C, max_tu)
    T4 = T // 4
    WF, WZ = 1 + skew * C, 1 + skew * C4
    F = rng.integers(0, 256, (B, 1 + C + T, WF)).astype(np.int16)
    Z = np.full((B, 1 + C4 + T4, WZ), ZIDX_NONE, np.int32)
    patch = lambda shape: np.where(rng.random(shape) < 0.3, ZIDX_NONE, -1)
    Z[:, 0, :] = patch((B, WZ))
    Z[:, :, 0] = patch((B, 1 + C4 + T4))
    resid = rng.integers(-20, 21, (B, C, C)).astype(np.int16)
    tu = np.zeros((B, C4, C4), np.int32)

    def leaves(x4, y4, n4, out):
        if n4 == 1 or rng.random() < 0.4:
            out.append((x4, y4, n4))
            return out
        h = n4 // 2
        for j in range(4):
            leaves(x4 + (j & 1) * h, y4 + (j >> 1) * h, h, out)
        return out

    for b in range(B):
        ctr = 0
        for y0 in range(0, C4, T4):
            for x0 in range(0, C4, T4):
                for x4, y4, n4 in leaves(x0, y0, T4, []):
                    ctr += int(rng.integers(1, 4))
                    Z[b, 1 + y4:1 + y4 + n4, 1 + x4:1 + x4 + n4] = ctr
                    if b % 4 != 3 and rng.random() < 0.5:
                        tu[b, y4, x4] = (4 * n4).bit_length() - 1
    mode = rng.integers(0, 35, (B, C4, C4)).astype(np.int32)
    return F, Z, resid, tu, mode
