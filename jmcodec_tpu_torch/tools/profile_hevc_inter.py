"""Where the device time of the 1080p HEVC inter stream decode goes.

Parses the committed 16-picture inter fixture once through decode_hevc on
the card, recording each picture's plan, then replays the device half
(api.hevc_inter.decode_plans: plan upload, phase-pyramid cache, MC, the
scan over the inter base, filters) in decode order. First once under
torch.profiler as it runs: the card, the device's busy time, the kernel
launches in all and per picture, and the kernels ranked by device time.
Then with a synchronise around each stage (plan upload, pyramid prep,
luma and chroma MC, resid_planes (four hevc_resid launches a picture:
the intra and the inter residuals, luma and Cb + Cr), the two scan
kernels, deblocking, SAO): the
unprofiled wall of each stage summed over the stream, and under the
profiler each stage's launches and device busy time. A stage whose busy
time is far below its wall waits on the host's issue of launches. The
decode's fps come from chip_smoke.py, without the profiler. With --trace,
writes the chrome trace of the first profile. Needs a GPU:

    python -m jmcodec_tpu_torch.tools.profile_hevc_inter \
        [--trace out/hevc_inter_trace.json]
"""

from __future__ import annotations

import argparse
import time

import torch

from jmcodec_tpu_torch.api import hevc_inter as HI
from jmcodec_tpu_torch.codec.hevc.refdec import HevcRefDecoder
from jmcodec_tpu_torch.kernels import hevc_resid as HR
from jmcodec_tpu_torch.kernels import hevc_tiles as HTT
from jmcodec_tpu_torch.tools.fixtures import inter_fixture_stream
from jmcodec_tpu_torch.tools.profile_h264_intra import _staged
from jmcodec_tpu_torch.tools.profiling import profile_decode
from jmcodec_tpu_torch.utils.device import require_cuda

# (module, function): each a stage of the decode
STAGES = tuple((HR, n) if n == "resid_planes" else (HTT, n) for n in (
    "stack_plans", "prep_hevc_ref", "_mc_hevc_luma", "_mc_hevc_chroma",
    "resid_planes", "scan_planes", "_deblock", "_sao_plane"))
NAMES = tuple(name for _, name in STAGES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", help="write the chrome trace to this path")
    args = ap.parse_args(argv)
    dev = require_cuda()
    plans = []
    recon = HI.DeviceRecon(dev)

    def recording(plan, ref_pixels):
        plans.append(plan)
        return recon(plan, ref_pixels)

    HevcRefDecoder(recording).decode(inter_fixture_stream())
    p0 = plans[0]
    title = f"{len(plans)} pictures {p0.width}x{p0.height} HEVC inter"
    decode = lambda: HI.decode_plans(plans, dev)
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
    print(f"unprofiled decode of {len(plans)} pictures, a synchronise "
          f"around each stage: {t_all * 1e3:.1f} ms; " + ", ".join(
              f"{n} {walls.get(n, 0.0) * 1e3:.1f} ms" for n in NAMES))
    profile_decode(decode, title + ", by stage", None, NAMES)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
