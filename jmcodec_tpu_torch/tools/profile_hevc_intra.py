"""Where the device time of the batched 1080p HEVC all-intra decode goes.

Decodes the committed fixture at the smoke's batch (tools/fixtures.py)
from device-resident plan tensors, once under torch.profiler, and prints
the card, the device's busy time (the union of kernel intervals), the
number of kernel launches, and the kernels ranked by device time. The
decode's wall time and fps come from chip_smoke.py, without the profiler.
With --trace, writes the chrome trace for a timeline viewer. Needs a GPU:

    python -m jmcodec_tpu_torch.tools.profile_hevc_intra \
        [--trace out/hevc_intra_trace.json]
"""

from __future__ import annotations

import argparse
import os

from jmcodec_tpu_torch.api.hevc_intra import parse_hevc_intra_plans
from jmcodec_tpu_torch.kernels import hevc_tiles as HTT
from jmcodec_tpu_torch.tools.fixtures import BATCH, fixture_batch_stream
from jmcodec_tpu_torch.tools.profiling import profile_decode
from jmcodec_tpu_torch.utils.device import require_cuda


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
    profile_decode(lambda: HTT.decode_frames_hevc_batch(*tensors),
                   f"batch {BATCH} x {plans[0].width}x{plans[0].height}",
                   args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
