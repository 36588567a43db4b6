"""The port's entry points on the CPU: the CLIs
(jmcodec_tpu_torch/tools/jmx_{decode,encode,transcode,scaling}.py) with
--device cpu against the JAX package's tools and sessions on small clips,
at tolerance 0 (bytes of the output files); the transcode job resumed,
also across the two packages' tools; entry() against __graft_entry__.entry()
(dryrun_multichip is tests/test_torch_parallel.py's, beside the JAX step
it shares); device_trace on the CPU.

The port's encoder engine "auto" is its device engine, so the transcode is
held against the JAX package's transcode with engine="device"
(_jax_transcode: tools/jmx_transcode.py's data flow, whose own encoder
takes the host engine on the CPU backend). All-IDR GOPs encode the same on
either engine, so there the JAX tool itself is the reference.

Run as a script, this file rebuilds tests/data/transcode_1080p.sha256.json
(a few minutes on the CPU):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_tools.py
"""

import hashlib
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from jmcodec_tpu.api.session import DecoderSession as JDecoder  # noqa: E402
from jmcodec_tpu.api.session import EncoderParams as JParams  # noqa: E402
from jmcodec_tpu.api.session import EncoderSession as JEncoder  # noqa: E402
from jmcodec_tpu.pipeline import gop as JG  # noqa: E402
from jmcodec_tpu_torch import entry as E  # noqa: E402
from jmcodec_tpu_torch.tools import jmx_decode, jmx_encode  # noqa: E402
from jmcodec_tpu_torch.tools import jmx_scaling, jmx_transcode  # noqa: E402
from jmcodec_tpu_torch.tools.fixtures import (fixture_digests,  # noqa: E402
                                              gradient_frame, pan_frames)
from jmcodec_tpu_torch.utils.metrics import device_trace  # noqa: E402

DATA = os.path.join(ROOT, "tests", "data")
TRANSCODE_DIGEST = os.path.join(DATA, "transcode_1080p.sha256.json")


def _jax_tool(name):
    """tools/<name>.py, the JAX package's CLI, as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(name, argv):
    mod = _jax_tool(name)
    saved = sys.argv
    sys.argv = [name] + list(argv)
    try:
        mod.main()
    finally:
        sys.argv = saved


def _jax_transcode(data: bytes, qp: int, scale: int) -> bytes:
    """The JAX package's transcode of `data` with the device engine:
    tools/jmx_transcode.py's data flow (the GOPs of split_gops, each with
    the stream's SPS/PPS, decoded by its DecoderSession, downscale2, one
    EncoderSession a GOP), the segments concatenated. The decode takes the
    host path: its frames are the device path's, bit for bit."""
    downscale2 = _jax_tool("jmx_transcode").downscale2
    head = jmx_transcode.stream_head(data)
    out = b""
    for s, e in JG.split_gops(data):
        dec = JDecoder(use_device=False)
        dec.input_data(head + data[s:e])
        dec.set_eof()
        frames = []
        while (fr := dec.get_frame()) is not None:
            frames.append(fr)
        if scale == 2:
            frames = [downscale2(*fr) for fr in frames]
        H, W = frames[0][0].shape
        enc = JEncoder(JParams(width=W, height=H, qp=qp,
                               gop_len=len(frames), engine="device"))
        for fr in frames:
            enc.encode_frame(fr)
            while (pkt := enc.output_bitstream()) is not None:
                out += pkt[0]
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# jmx_decode
# ---------------------------------------------------------------------------

DECODE_CASES = {"h264_p_2gop_i420": ("h264_inter_idr2_64x64.h264", "i420"),
                "h264_idr3_nv12": ("h264_session_idr3_96x64.h264", "nv12"),
                "hevc_p_yv12": ("hevc_inter_p_64x64.h265", "yv12")}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_cli_matches_the_jax_tool(case, tmp_path):
    name, fmt = DECODE_CASES[case]
    src = os.path.join(DATA, name)
    ours, theirs = tmp_path / "ours.yuv", tmp_path / "theirs.yuv"
    jmx_decode.main([src, str(ours), "--fmt", fmt, "--device", "cpu"])
    _run_jax_tool("jmx_decode", [src, str(theirs), "--fmt", fmt, "--host"])
    got = ours.read_bytes()
    assert got == theirs.read_bytes() and len(got) > 0
    if fmt == "i420":
        digests = fixture_digests(src.rsplit(".", 1)[0] + ".sha256.json")
        w, h = 64, 64
        size = w * h * 3 // 2
        for f, d in enumerate(digests):
            y = got[f * size:f * size + w * h]
            assert hashlib.sha256(y).hexdigest() == d["Y"]


# ---------------------------------------------------------------------------
# jmx_encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["h264", "hevc"])
def test_encode_cli_matches_the_jax_tool(codec, tmp_path):
    raw = tmp_path / "in.i420"
    raw.write_bytes(b"".join(y.tobytes() + u.tobytes() + v.tobytes()
                             for y, u, v in pan_frames(64, 48, 4)))
    ours, theirs = tmp_path / "ours.es", tmp_path / "theirs.es"
    args = ["--qp", "28", "--gop", "3", "--codec", codec]
    jmx_encode.main([str(raw), "64x48", str(ours), *args,
                     "--device", "cpu"])
    _run_jax_tool("jmx_encode", [str(raw), "64x48", str(theirs), *args,
                                 "--engine", "device"])
    assert ours.read_bytes() == theirs.read_bytes()
    assert len(ours.read_bytes()) > 100


# ---------------------------------------------------------------------------
# jmx_transcode
# ---------------------------------------------------------------------------


def test_transcode_cli_matches_jax_with_the_device_engine(tmp_path):
    """Two GOPs of an IDR and two P pictures, 64x64 -> 32x32: the P frames
    take the device engine's motion search."""
    src = os.path.join(DATA, "h264_inter_idr2_64x64.h264")
    out = tmp_path / "job"
    recs = jmx_transcode.transcode(src, str(out), qp=28, scale=2,
                                   device="cpu")
    assert [(r["gop"], r["frames"]) for r in recs] == [(0, 3), (1, 3)]
    got = (out / "out.h264").read_bytes()
    assert got == _jax_transcode(_read(src), 28, 2)
    # a second call resumes, finds nothing to do, and keeps the output
    assert jmx_transcode.transcode(src, str(out), qp=28, scale=2,
                                   device="cpu") == []
    assert (out / "out.h264").read_bytes() == got


def test_transcode_cli_matches_the_jax_tool_on_idr_gops(tmp_path):
    src = os.path.join(DATA, "h264_session_idr3_96x64.h264")
    jmx_transcode.main([src, str(tmp_path / "ours"), "--qp", "30",
                        "--device", "cpu"])
    _run_jax_tool("jmx_transcode", [src, str(tmp_path / "theirs"),
                                    "--qp", "30"])
    assert (tmp_path / "ours" / "out.h264").read_bytes() == \
        (tmp_path / "theirs" / "out.h264").read_bytes()


@pytest.mark.parametrize("first", ["jax", "port"])
def test_transcode_job_resumes_under_the_other_tool(first, tmp_path):
    """One tool runs the whole job; GOP 1 is then marked pending again (a
    worker that died) and its segment removed; the other tool resumes it,
    encodes GOP 1 alone and writes the same output."""
    src = os.path.join(DATA, "h264_session_idr3_96x64.h264")
    job = tmp_path / "job"
    port = lambda: jmx_transcode.main([src, str(job), "--scale", "2",
                                       "--device", "cpu", "--worker", "p"])
    jax_ = lambda: _run_jax_tool("jmx_transcode", [src, str(job), "--scale",
                                                   "2", "--worker", "j"])
    (jax_ if first == "jax" else port)()
    whole = (job / "out.h264").read_bytes()
    m = JG.TranscodeManifest.load(str(job))
    m.jobs[1].status, m.jobs[1].output = "pending", None
    m.save()
    (job / "seg00001.h264").unlink()
    (job / "out.h264").unlink()
    (port if first == "jax" else jax_)()
    m = JG.TranscodeManifest.load(str(job))
    assert [j.worker for j in m.jobs] == (["j", "p", "j"] if first == "jax"
                                          else ["p", "j", "p"])
    assert (job / "out.h264").read_bytes() == whole


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_entry_matches_the_graft_entry():
    import __graft_entry__ as G

    fn, args = E.entry("cpu")
    got = fn(*args)
    jfn, jargs = G.entry()
    want = jax.jit(jfn)(*jargs)
    assert len(args) == len(jargs)
    for a, b in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got, want):
        assert a.dtype == torch.uint8
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        E.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        E.dryrun_multichip(2)


# ---------------------------------------------------------------------------
# device_trace and the scaling tool
# ---------------------------------------------------------------------------


def _decode_once():
    from jmcodec_tpu_torch.kernels import recon_tiles as RT
    from jmcodec_tpu_torch.parallel.decode_sharded import _synthetic_symbols
    RT.decode_frame_symbols(_synthetic_symbols(2, 2, 1)[0], device="cpu")


def test_device_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("JMX_TRACE", raising=False)
    with device_trace(str(tmp_path / "a")):
        _decode_once()
    monkeypatch.setenv("JMX_TRACE", str(tmp_path / "b"))
    with device_trace():
        _decode_once()
    for d in ("a", "b"):
        with open(tmp_path / d / "trace.json") as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        assert any(n.startswith("aten::") for n in names)


def test_device_trace_without_a_target_is_a_noop(tmp_path, monkeypatch):
    monkeypatch.delenv("JMX_TRACE", raising=False)
    monkeypatch.chdir(tmp_path)
    with device_trace():
        _decode_once()
    assert os.listdir(tmp_path) == []


def test_scaling_cli_on_cpu_ranks(capsys):
    jmx_scaling.main(["--devices", "1,2", "--frames", "4", "--size",
                      "64x32", "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["platform"] == "cpu"
    assert sorted(rep["fps"]) == ["1", "2"] and rep["efficiency"]["1"] == 1.0
    assert all(v > 0 for v in rep["fps"].values())


def test_gradient_frame_is_the_dryrun_content():
    from util_oracle_free import make_gradient_frame
    for seed in (0, 1, 5):
        for a, b in zip(gradient_frame(48, 32, seed),
                        make_gradient_frame(48, 32, seed)):
            assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the 1080p transcode fixture
# ---------------------------------------------------------------------------


def build_transcode_digest():
    """tests/data/transcode_1080p.sha256.json: the JAX package's transcode
    (_jax_transcode, the device engine) of the first three pictures of the
    1080p H.264 P fixture (tools.fixtures.h264_session_stream: its IDR and
    two P pictures, one GOP), --scale 2 (960x540), --qp 28."""
    from jmcodec_tpu_torch.tools.fixtures import h264_session_stream
    data = h264_session_stream()
    out = _jax_transcode(data, 28, 2)
    rec = {"input": "tools.fixtures.h264_session_stream()",
           "input_sha256": hashlib.sha256(data).hexdigest(),
           "qp": 28, "scale": 2, "gops": len(JG.split_gops(data)),
           "stream": {"sha256": hashlib.sha256(out).hexdigest(),
                      "length": len(out)},
           "recipe": "PYTHONPATH=. JAX_PLATFORMS=cpu python "
                     "tests/test_torch_tools.py"}
    with open(TRANSCODE_DIGEST, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    return rec


def test_transcode_digest_records_its_input():
    from jmcodec_tpu_torch.tools.fixtures import h264_session_stream
    with open(TRANSCODE_DIGEST) as f:
        rec = json.load(f)
    assert rec["input_sha256"] == \
        hashlib.sha256(h264_session_stream()).hexdigest()
    assert (rec["qp"], rec["scale"], rec["gops"]) == (28, 2, 1)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(build_transcode_digest()))
