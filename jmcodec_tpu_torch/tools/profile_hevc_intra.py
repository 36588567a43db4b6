"""Where the device time of the batched 1080p HEVC all-intra decode goes.

Decodes the committed fixture at the smoke's batch (tools/fixtures.py)
from device-resident plan tensors, once under torch.profiler, and prints
the card, the device's busy time (the union of kernel intervals), the
number of kernel launches, and the kernels ranked by device time. Then
with a synchronise around each stage (resid_planes: the hevc_resid
kernel, one launch for the luma planes and one for Cb + Cr; the two scan
kernels; deblocking; SAO): each stage's unprofiled wall, and under the
profiler its launches and device busy time. The decode's wall time and
fps come from chip_smoke.py, without the profiler. With --trace, writes
the chrome trace of the first profile for a timeline viewer. Needs a GPU:

    python -m jmcodec_tpu_torch.tools.profile_hevc_intra \
        [--trace out/hevc_intra_trace.json]
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from jmcodec_tpu_torch.api.hevc_intra import parse_hevc_intra_plans
from jmcodec_tpu_torch.kernels import hevc_resid as HR
from jmcodec_tpu_torch.kernels import hevc_tiles as HTT
from jmcodec_tpu_torch.tools.fixtures import BATCH, fixture_batch_stream
from jmcodec_tpu_torch.tools.profile_h264_intra import _staged
from jmcodec_tpu_torch.tools.profiling import profile_decode
from jmcodec_tpu_torch.utils.device import require_cuda

# (module, function): each a stage of the decode
STAGES = ((HR, "resid_planes"), (HTT, "scan_planes"), (HTT, "_deblock"),
          (HTT, "_sao_plane"))
NAMES = tuple(name for _, name in STAGES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", help="write the chrome trace to this path")
    args = ap.parse_args(argv)
    dev = require_cuda()
    plans = parse_hevc_intra_plans(fixture_batch_stream(),
                                   workers=os.cpu_count() or 1)
    if len(plans) != BATCH:
        raise RuntimeError(f"{len(plans)} pictures parsed, want {BATCH}")
    tensors = HTT.stack_plans(plans, dev)
    decode = lambda: HTT.decode_frames_hevc_batch(*tensors)
    title = f"batch {BATCH} x {plans[0].width}x{plans[0].height}"
    profile_decode(decode, title, args.trace)

    walls = {}
    for mod, name in STAGES:
        setattr(mod, name, _staged(name, getattr(mod, name), walls))
    decode()                                   # warm-up with the stages
    walls.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    print(f"unprofiled decode of the batch, a synchronise around each "
          f"stage: {t_all * 1e3:.1f} ms; " + ", ".join(
              f"{n} {walls.get(n, 0.0) * 1e3:.1f} ms" for n in NAMES))
    profile_decode(decode, title + ", by stage", None, NAMES)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
