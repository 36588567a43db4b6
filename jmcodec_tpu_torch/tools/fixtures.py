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
from .oracle import make_frame

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
# the JAX package's transcode (device engine, --scale 2, --qp 28) of
# h264_session_stream(): tests/test_torch_tools.py holds the recipe
TRANSCODE_DIGESTS = os.path.join(ROOT, "tests", "data",
                                 "transcode_1080p.sha256.json")
# the SHA-256 of the streams jmx_quality's QP sweep makes with the device
# engine on the CPU (tests/test_torch_quality.py holds the recipe)
QUALITY_DIGESTS = os.path.join(ROOT, "tests", "data",
                               "quality_320x240.sha256.json")
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
    n, rest = divmod(batch, len(fixture_digests(digests_path)))
    if n < 1 or rest:
        raise ValueError(f"{batch} pictures: not a multiple of the "
                         f"fixture's {len(fixture_digests(digests_path))}")
    return one * n


def fixture_batch_stream(batch: int = BATCH) -> bytes:
    """The HEVC fixture repeated to batch pictures (all are IDR)."""
    return _repeated(FIXTURE, DIGESTS, batch)


def h264_fixture_batch_stream(batch: int = H264_BATCH) -> bytes:
    """The H.264 fixture repeated to batch pictures (all are IDR; the
    repeated parameter sets are the same ones)."""
    return _repeated(H264_FIXTURE, H264_DIGESTS, batch)


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


def gradient_frame(W: int, H: int, seed: int = 0):
    """util_oracle_free.make_gradient_frame(W, H, seed): a diagonal luma
    ramp with uniform noise and flat chroma, uint8 (Y, U, V) (the content
    of the multichip dryrun's row-sharded checks)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    Y = np.clip((x * 2 + y + seed * 7) % 256
                + rng.integers(-12, 13, (H, W)), 0, 255).astype(np.uint8)
    U = np.full((H // 2, W // 2), 96 + seed, np.uint8)
    V = np.full((H // 2, W // 2), 148, np.uint8)
    return Y, U, V


def pan_frames(W: int, H: int, n: int, step=(3, 2), seed: int = 3) -> list:
    """tests/test_inter_decode.moving_frames(W, H, n, seed, step): frame i
    [(Y, U, V) uint8] cut at row step[0] * i, column step[1] * i of
    make_frame(W + 64, H + 64, seed, "gradient_noise")."""
    BY, BU, BV = make_frame(W + 64, H + 64, seed)
    cut = lambda P, y, x, h, w: P[y:y + h, x:x + w].copy()
    out = []
    for i in range(n):
        dy, dx = i * step[0], i * step[1]
        out.append((cut(BY, dy, dx, H, W),
                    cut(BU, dy // 2, dx // 2, H // 2, W // 2),
                    cut(BV, dy // 2, dx // 2, H // 2, W // 2)))
    return out


def row_sharded_stream(W: int = 64, H: int = 128) -> bytes:
    """An IDR and a P picture of panning content (pan_frames, step (6,
    4)), encoded by the port's host H.264 encoder at qp 28; a checkerboard
    patch across rows 40-95 of the P picture, which motion search cannot
    match, makes intra macroblocks there, across the row bands of a
    row-sharded decode (tests/test_torch_spatial.py)."""
    from ..codec.h264.refenc import EncoderConfig, H264ReferenceEncoder
    enc = H264ReferenceEncoder(EncoderConfig(W, H, qp=28, gop_len=2))
    s = enc.headers_annexb()
    frames = pan_frames(W, H, 2, step=(6, 4))
    y, x = np.mgrid[40:96, 16:48]
    frames[1][0][40:96, 16:48] = ((x + y) % 2) * 255
    for planes in frames:
        s += enc.encode_frame(*(np.asarray(p, np.int32) for p in planes))
    return s


def encode_fixture_frames(n: int = 3) -> list:
    """The 1080p encode fixture's frames: pan_frames(1920, 1080, n). The
    SHA-256 and length of the stream that jmcodec_tpu's
    EncoderSession(EncoderParams()) (1080p30, 2 Mb/s VBR, GOP 30, the
    device engine) makes of them, its keyframe flags and the libavcodec
    digests of its decode are in ENCODE_DIGESTS (tests/test_torch_encode.py
    holds the recipe as code and rebuilds them)."""
    return pan_frames(1920, 1080, n)


def quality_fixture() -> dict:
    """QUALITY_DIGESTS: {"size", "frames", "gop", "qps", "streams": {qp:
    {"sha256", "length"}}, ...}."""
    with open(QUALITY_DIGESTS) as f:
        return json.load(f)


def quality_streams(fx: dict, device) -> dict:
    """{qp: the stream} that `jmx_quality --engine device` encodes for
    quality_fixture()'s size, frame count, GOP and QPs, on device."""
    from .jmx_quality import moving, our_stream
    W, H = map(int, fx["size"].split("x"))
    frames = moving(W, H, fx["frames"])
    return {qp: our_stream(frames, W, H, qp, fx["gop"], "device", device)
            for qp in fx["qps"]}


def transcode_fixture() -> dict:
    """TRANSCODE_DIGESTS: {"input_sha256", "qp", "scale", "gops",
    "stream": {"sha256", "length"}, ...}."""
    with open(TRANSCODE_DIGESTS) as f:
        return json.load(f)


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


def synth_resid_planes(frames: int, H: int, W: int, seed: int = 0, *,
                       chroma: bool = False, sizes=(2, 3, 4, 5)):
    """Seeded inputs of the HEVC residual stage (hevc_resid.resid_planes
    and planes_reference) as numpy arrays, for `frames` H x W planes:
    (coeffs, tu, qp_y, offsets). coeffs: one (luma) or two (Cb, Cr)
    [frames, H, W] int16 level planes, mostly within +-400, 2% at -32768
    or 32767, and about a third of the 8x8 blocks all zero; tu
    [frames, H/4, W/4] int8, each cell drawn from 0, `sizes` and a value
    outside them (5 for chroma's (2, 3, 4), else 1), so blocks of
    different sizes overlap; qp_y, the luma cell QP [frames, H/4, W/4]
    int8 (twice as many cells a side for chroma) cycling through every
    value 0..51, shuffled; offsets None, or for chroma the Cb and Cr QP
    offsets [frames] int32 in -12..12."""
    rng = np.random.default_rng(seed)
    s = 2 if chroma else 1
    coeffs = []
    for _ in range(1 + chroma):
        c = rng.integers(-400, 401, (frames, H, W))
        big = rng.random(c.shape) < 0.02
        c[big] = rng.choice([-32768, 32767], int(big.sum()))
        zero = rng.random((frames, H // 8, W // 8)) < 0.3
        c[zero.repeat(8, 1).repeat(8, 2)] = 0
        coeffs.append(c.astype(np.int16))
    outside = 5 if max(sizes) < 5 else 1
    tu = rng.choice(np.array([0, outside, *sizes]), (frames, H // 4, W // 4))
    n = frames * (s * H // 4) * (s * W // 4)
    qp = rng.permutation(np.arange(n) % 52).reshape(frames, s * H // 4,
                                                    s * W // 4)
    offsets = (tuple(rng.integers(-12, 13, frames).astype(np.int32)
                     for _ in range(2)) if chroma else None)
    return coeffs, tu.astype(np.int8), qp.astype(np.int8), offsets


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


def synth_scan_planes(C: int, max_tu: int, planes: int, groups: int,
                      ctb_h: int, ctb_w: int, seed: int = 0,
                      inter: bool = False, partial: bool = False):
    """Seeded inputs of the HEVC intra scan in plane layout (hevc_scan.
    scan_planes and scan_reference) as numpy arrays: resid [planes, H, W]
    int16, zidx / tu / mode [groups, H/4, W/4] int32 (plane p on map
    p % groups) and base [planes, H, W] int16 with inter, else None.
    synth_state_hard's kinds laid over whole planes: CTB (cy, cx) of map g
    is of kind HARD_KINDS[(cx + cy * ctb_w + g) % 6] (all 4x4, one TU of
    the largest size, no TU, a random quadtree, the same with residuals
    (and base) at the int16 extremes or in between, the same with no
    neighbour available: its cells numbered below those of every CTB
    before it); the first quadtree CTB holds a TU of every size below the
    largest. A map numbers its CTBs in raster order, each one's cells
    in z-scan order with a random gap between CTBs, as a picture's decode
    order does. With inter, every leaf of the quadtree is an intra TU or,
    with probability 1/2, an inter cell (TU 0), each leaf numbered in
    z-scan order with a random gap (plan.record_inter_cu_done), and the
    kind "no TU" makes a CTB all inter. partial: the right half of the
    last CTB column lies outside the picture (ZIDX_NONE, no TU), as when
    the picture's width is not a multiple of the CTB's."""
    rng = np.random.default_rng(seed)
    C4, T = C // 4, min(C, max_tu)
    T4 = T // 4
    zidx = np.full((groups, ctb_h * C4, ctb_w * C4), ZIDX_NONE, np.int32)
    tu = np.zeros(zidx.shape, np.int32)
    mode = rng.integers(0, 35, zidx.shape).astype(np.int32)
    resid = rng.integers(-20, 21, (planes, ctb_h * C, ctb_w * C)).astype(
        np.int16)
    base = (rng.integers(0, 256, resid.shape).astype(np.int16) if inter
            else None)
    extremes = np.array([-32768, -300, 0, 300, 32767], np.int16)
    bits = lambda v: sum(((v >> k) & 1) << (2 * k) for k in range(4))
    cs = np.arange(C4)
    zscan = bits(cs)[None, :] | (bits(cs)[:, None] << 1)

    def leaves(x4, y4, n4, out, ladder=False):
        # ladder: split down to 4x4 through the first quadrant, so that a
        # TU of every size below the block's is a leaf
        if n4 == 1 or (not ladder and rng.random() < 0.4):
            out.append((x4, y4, n4))
            return out
        h = n4 // 2
        for j in range(4):
            leaves(x4 + (j & 1) * h, y4 + (j >> 1) * h, h, out,
                   ladder and j == 0)
        return out

    for g in range(groups):
        ctr, low = 0, -(1 << 24)
        for cy in range(ctb_h):
            for cx in range(ctb_w):
                kind = (cx + cy * ctb_w + g) % 6
                t = np.zeros((C4, C4), np.int32)
                z = zscan + ctr
                if kind >= 3 or (inter and kind != 2):
                    ls = [lf for y0 in range(0, C4, T4)
                          for x0 in range(0, C4, T4)
                          for lf in leaves(x0, y0, T4, [],
                                           kind == 3 and x0 == y0 == 0)]
                    for x4, y4, n4 in ls:
                        if not inter or rng.random() < 0.5:
                            t[y4, x4] = (4 * n4).bit_length() - 1
                        if inter:
                            ctr += int(rng.integers(1, 4))
                            z[y4:y4 + n4, x4:x4 + n4] = ctr
                elif kind == 0:
                    t[:] = 2
                elif kind == 1:
                    t[0, 0] = T.bit_length() - 1
                if kind == 5:
                    z = zscan + low
                    low += C4 * C4
                ctr = max(ctr, int(z.max()) + 1) + int(rng.integers(0, 9))
                if kind == 4:
                    ys = slice(cy * C, (cy + 1) * C)
                    xs = slice(cx * C, (cx + 1) * C)
                    for p in range(g, planes, groups):
                        resid[p, ys, xs] = rng.choice(extremes, (C, C))
                        if inter:
                            base[p, ys, xs] = rng.choice(extremes, (C, C))
                if partial and cx == ctb_w - 1:
                    h4 = C4 // 2
                    for y4, x4 in zip(*np.nonzero(t)):
                        if x4 + (1 << int(t[y4, x4])) // 4 > h4:
                            t[y4, x4] = 0
                    z[:, h4:] = ZIDX_NONE
                sl = (g, slice(cy * C4, (cy + 1) * C4),
                      slice(cx * C4, (cx + 1) * C4))
                zidx[sl], tu[sl] = z, t
    return resid, zidx, tu, mode, base


def _scan_geometry(mbh: int, mbw: int):
    """(n_steps, mxs, valid) of the H.264 scans' skew (recon_tiles'
    _skew_geometry): lane k of diagonal d is macroblock (d - 2k, k)."""
    n_steps = mbw + 2 * (mbh - 1)
    mxs = np.arange(n_steps)[:, None] - 2 * np.arange(mbh)[None, :]
    valid = ((mxs >= 0) & (mxs < mbw)).astype(np.int32)
    return n_steps, mxs, valid


def synth_intra_scan(mbh: int, mbw: int, nf: int, seed: int = 0,
                     inter: bool = False):
    """Seeded inputs of the H.264 intra scan (recon_tiles._intra_tile_scan
    and h264_scan.intra_tiles) as numpy int32 arrays, in the scan's
    argument order: residual tiles (Y, U, V), I4 modes 0..8, class, I16
    mode, chroma mode, availability left / top / top-right, valid; with
    inter, then the inter tiles (Y, U, V) and a walk that skips about one
    diagonal in three. Every class, mode and availability pattern occurs,
    except that lane 0 (the top macroblock row) has neither top nor
    top-right, as in every picture; classes are 0-2 (intra) or, with
    inter, 0-3 (3: inter)."""
    rng = np.random.default_rng(seed)
    n_steps, _, valid = _scan_geometry(mbh, mbw)
    g = (nf, n_steps, mbh)
    ri = lambda lo, hi, shape: rng.integers(lo, hi, shape).astype(np.int32)
    resid = [ri(-48, 49, (*g, n, n)) for n in (16, 8, 8)]
    modes = ri(0, 9, (*g, 4, 4))
    cls = ri(0, 4 if inter else 3, g)
    i16, cmode = ri(0, 4, g), ri(0, 4, g)
    a_l, a_t, a_tr = ri(0, 2, g), ri(0, 2, g), ri(0, 2, g)
    a_t[:, :, 0] = 0
    a_tr[:, :, 0] = 0
    out = [*resid, modes, cls, i16, cmode, a_l, a_t, a_tr, valid]
    if inter:
        out += [ri(0, 256, (*g, n, n)) for n in (16, 8, 8)]
        walk = rng.random(n_steps) > 0.33
        walk[[0, -1]] = True, False
        out.append(walk.tolist())
    return out


def synth_deblock_scan(mbh: int, mbw: int, nf: int, seed: int = 0):
    """Seeded inputs of the H.264 deblock scan (recon_tiles.
    _deblock_tile_scan and h264_scan.deblock_tiles) as numpy int32 arrays,
    in the scan's argument order: recon tiles (Y, U, V) of low and mixed
    contrast (so that most edges pass the alpha/beta tests, strong ones
    too; invalid lanes 0), qp 0..51, valid, per frame alpha and beta
    offsets in -12..12 and both chroma QP offsets in -12..12, and bS 0-4
    per sub-edge of every edge (bs_v, bs_h [nf, n_steps, lanes, 4, 4]),
    0 on the picture's boundary (mx == 0 left, lane 0 top) and on invalid
    lanes, as in every picture."""
    rng = np.random.default_rng(seed)
    n_steps, mxs, valid = _scan_geometry(mbh, mbw)
    g = (nf, n_steps, mbh)
    vm = valid[None, ..., None, None]
    base = rng.integers(40, 200, (*g, 1, 1))
    amp = rng.choice([1, 3, 6, 12, 40], (*g, 1, 1))

    def tile(n):
        noise = rng.integers(-1 << 10, 1 << 10, (*g, n, n)) * amp >> 10
        return (np.clip(base + noise, 0, 255) * vm).astype(np.int32)

    qp = (rng.integers(0, 52, g) * valid).astype(np.int32)
    offs = [rng.integers(-6, 7, nf).astype(np.int32) * 2 for _ in range(2)]
    offs += [rng.integers(-12, 13, nf).astype(np.int32) for _ in range(2)]
    bs_v, bs_h = (rng.integers(0, 5, (*g, 4, 4)).astype(np.int32)
                  * valid[None, ..., None, None] for _ in range(2))
    bs_v[:, :, :, 0, :] *= (mxs > 0)[None, ..., None]
    bs_h[:, :, 0, 0, :] = 0
    return [tile(16), tile(8), tile(8), qp, valid, *offs, bs_v, bs_h]
