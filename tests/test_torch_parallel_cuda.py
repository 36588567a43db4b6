"""On an NVIDIA GPU: the parallel layer and the entry points at world size
1 (a one-rank NCCL group; one card cannot hold two NCCL ranks) equal the
same computations on the CPU, with the CUDA kernels launched on the way:
decode_symbols_sharded and make_transcode_real_step (dequant_idct twice),
decode_plans_pipelined with its default devices (the walk twice a scan
step), the row-sharded intra and P decodes at sp = 1, the transcode CLI,
entry(), and device_trace naming the kernels. The multi-rank exchanges are
the CPU tests' (tests/test_torch_parallel.py, tests/test_torch_spatial.py,
gloo at world 2 and 4). Marked `cuda`; skips without a card. Imports no
jax:

    JMX_TEST_TPU=1 python -m pytest tests/test_torch_parallel_cuda.py -m cuda
"""

import json
import os

import numpy as np
import pytest
import torch

from jmcodec_tpu_torch import entry as E
from jmcodec_tpu_torch.api.hevc_intra import parse_hevc_intra_plans
from jmcodec_tpu_torch.codec.h264.fastdec import FastH264Parser
from jmcodec_tpu_torch.kernels import hevc_scan as HSC
from jmcodec_tpu_torch.kernels import hevc_tiles as HTT
from jmcodec_tpu_torch.kernels import hevc_walk as HW
from jmcodec_tpu_torch.kernels import idct as ID
from jmcodec_tpu_torch.kernels import recon_tiles as RT
from jmcodec_tpu_torch.kernels.recon import stack_symbols
from jmcodec_tpu_torch.parallel import decode_sharded as DS
from jmcodec_tpu_torch.parallel import framepp as FP
from jmcodec_tpu_torch.parallel import spatial as SP
from jmcodec_tpu_torch.parallel.mesh import ShardingConfig, build_mesh
from jmcodec_tpu_torch.parallel.transcode import (_downscale2x_with_halo,
                                                  _encode_forward)
from jmcodec_tpu_torch.tools import jmx_transcode
from jmcodec_tpu_torch.tools.fixtures import row_sharded_stream
from jmcodec_tpu_torch.utils.metrics import device_trace

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
W1 = ShardingConfig(1, 1)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    yield torch.device("cuda", 0)
    # the one-rank NCCL group the world-1 paths made
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_decode_symbols_sharded_world1(dev):
    fss = DS._synthetic_symbols(4, 4, 8)
    ID.LAUNCHES = 0
    got = DS.decode_symbols_sharded(fss, W1)
    assert ID.LAUNCHES == 2
    assert torch.distributed.get_backend() == "nccl"
    want = RT.decode_frames_batch(4, 4, *stack_symbols(fss, "cpu"))
    for a, b in zip(got, want):
        assert np.array_equal(a, b.numpy())


def test_transcode_real_step_world1(dev):
    """Levels, bits and ssd equal the step's arithmetic on CPU tensors of
    the card's decoded frames (at world 1 the collectives move nothing)."""
    fss = DS._synthetic_symbols(4, 4, 8)
    mesh = build_mesh(W1)
    Y, _, _ = DS.decode_symbols_sharded(fss, W1, mesh)
    ID.LAUNCHES = 0
    z, bits, ssd = DS.run_transcode_real_step(fss, W1)
    assert ID.LAUNCHES == 2
    zc, bc, sc = _encode_forward(_downscale2x_with_halo(
        torch.from_numpy(Y).to(torch.int32), mesh.get_group("sp")), 30)
    assert np.array_equal(z, zc.numpy())
    assert (bits, ssd) == (int(bc), int(sc))


def test_decode_plans_pipelined_default_devices(dev):
    with open(os.path.join(DATA, "hevc_ctu16_64x64.h265"), "rb") as f:
        plans = parse_hevc_intra_plans(f.read())
    HW.LAUNCHES = HSC.LAUNCHES = 0
    outs = FP.decode_plans_pipelined(plans, batch=2)
    torch.cuda.synchronize()
    # two scan launches a batch of two pictures, the walk inside them
    assert (HSC.LAUNCHES, HW.LAUNCHES) == (2 * 2, 0)
    assert all(o[0].device.type == "cuda" for o in outs)
    want = HTT.decode_plans_batch(plans, "cpu")
    for k in range(3):
        got = torch.cat([o[k] for o in outs]).cpu()
        assert torch.equal(got, want[k])


def test_row_sharded_decodes_at_sp1(dev):
    (fi, _), (fp, _) = FastH264Parser().parse_annexb(row_sharded_stream())[:2]
    ID.LAUNCHES = 0
    idr = SP.decode_frame_rows_sharded(fi, cfg=W1)
    assert ID.LAUNCHES == 2
    refs = [RT.pad_ref_device(*(torch.from_numpy(a).to(dev) for a in idr))]
    p = SP.decode_frame_rows_sharded_inter(fp, refs, cfg=W1)
    assert ID.LAUNCHES == 4
    want_i = RT.decode_frame_symbols(fi, device="cpu")
    want_p = RT.decode_frame_symbols_inter(
        fp, [RT.pad_ref_device(*(torch.from_numpy(a) for a in want_i))], [0])
    for a, b in zip(idr, want_i):
        assert np.array_equal(a, b)
    for a, b in zip(p, want_p):
        assert np.array_equal(a, b.numpy())


def test_transcode_cli_on_the_card(dev, tmp_path):
    src = os.path.join(DATA, "h264_inter_idr2_64x64.h264")
    jmx_transcode.main([src, str(tmp_path / "card"), "--scale", "2"])
    jmx_transcode.main([src, str(tmp_path / "cpu"), "--scale", "2",
                        "--device", "cpu"])
    assert (tmp_path / "card" / "out.h264").read_bytes() == \
        (tmp_path / "cpu" / "out.h264").read_bytes()


def test_entry_on_the_card(dev):
    fn, args = E.entry()
    got = fn(*args)
    fc, ac = E.entry("cpu")
    for a, b in zip(got, fc(*ac)):
        assert torch.equal(a.cpu(), b)


def test_device_trace_names_the_kernels(dev, tmp_path):
    fss = DS._synthetic_symbols(4, 4, 2)
    with open(os.path.join(DATA, "hevc_ctu16_64x64.h265"), "rb") as f:
        plans = parse_hevc_intra_plans(f.read())[:1]
    with device_trace(str(tmp_path)):
        RT.decode_frames_batch(4, 4, *stack_symbols(fss, dev))
        HTT.decode_plans_batch(plans, dev)
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("dequant_idct_kernel" in n for n in names)
    assert any("hevc_scan_kernel" in n for n in names)
