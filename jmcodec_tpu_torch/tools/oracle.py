"""The libavcodec conformance oracle (tests/oracle/oracle, built with
`make -C tests/oracle` against libavcodec and libavutil) for the port's
tools: decode a stream into I420 frames, encode frames with x264 (preset
medium), and the seeded gradient-noise frames the tools encode. The port's
copy of what jmx_quality takes from tests/util_oracle.py.

Without the binary (and with no libavcodec to build it from) every call
raises RuntimeError naming it: there is no other decoder to fall back to.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ORACLE_DIR = os.path.join(ROOT, "tests", "oracle")
ORACLE_BIN = os.path.join(ORACLE_DIR, "oracle")


def have_oracle() -> bool:
    """Whether the oracle binary is there, building it first if need be."""
    if os.path.exists(ORACLE_BIN):
        return True
    try:
        subprocess.run(["make", "-C", ORACLE_DIR], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return False
    return os.path.exists(ORACLE_BIN)


def require_oracle() -> str:
    """The oracle binary's path; RuntimeError naming it when it is not
    there and cannot be built."""
    if not have_oracle():
        raise RuntimeError(f"no libavcodec oracle: {ORACLE_BIN} is missing "
                           f"and `make -C {ORACLE_DIR}` failed")
    return ORACLE_BIN


def oracle_decode(stream: bytes, suffix: str = ".h264"):
    """Decode an elementary stream -> (frames [(Y, U, V) uint8], W, H)."""
    binary = require_oracle()
    with tempfile.TemporaryDirectory() as d:
        inp = os.path.join(d, "in" + suffix)
        outp = os.path.join(d, "out.i420")
        with open(inp, "wb") as f:
            f.write(stream)
        res = subprocess.run([binary, "decode", inp, outp],
                             capture_output=True, text=True, check=True)
        W, H, N = map(int, res.stdout.split())
        raw = np.fromfile(outp, np.uint8)
    frames = []
    fs = W * H * 3 // 2
    for i in range(N):
        f = raw[i * fs:(i + 1) * fs]
        Y = f[:W * H].reshape(H, W)
        U = f[W * H:W * H + W * H // 4].reshape(H // 2, W // 2)
        V = f[W * H + W * H // 4:].reshape(H // 2, W // 2)
        frames.append((Y, U, V))
    return frames, W, H


def oracle_encode(frames, W, H, qp=30, gop=1, extra=None) -> bytes:
    """Encode frames [(Y, U, V), ...] with libx264, preset medium, at a
    fixed qp (qp 0 with a bitrate= in extra: x264's ABR). extra: x264's
    own parameters, as "key=value:key=value"."""
    binary = require_oracle()
    with tempfile.TemporaryDirectory() as d:
        inp = os.path.join(d, "in.i420")
        outp = os.path.join(d, "out.es")
        with open(inp, "wb") as f:
            for planes in frames:
                for p in planes:
                    f.write(np.asarray(p, np.uint8).tobytes())
        cmd = [binary, "encode", inp, str(W), str(H), str(qp), outp,
               "libx264", str(gop), "medium"]
        if extra:
            cmd.append(extra)
        subprocess.run(cmd, capture_output=True, check=True)
        with open(outp, "rb") as f:
            return f.read()


def make_frame(W: int, H: int, seed: int = 0):
    """tests/util_oracle.make_frame(W, H, seed, "gradient_noise"): a
    diagonal luma ramp with uniform noise, chroma ramps with noise; uint8
    (Y, U, V)."""
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
