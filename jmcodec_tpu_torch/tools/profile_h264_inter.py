"""Where the time of one 1080p H.264 P picture goes.

Parses the committed 1080p P fixture (tools/fixtures.py), decodes the
pictures before the chosen one on the card to fill the DPB, then decodes
the chosen P picture (recon_tiles.decode_frame_symbols_inter: symbol
upload, luma and chroma MC, residuals, bS, the intra scan over the inter
tiles and the per-edge-bS deblock scan, each a CUDA kernel launched once
a scan) from its parsed symbols. First
without the profiler: the picture's wall, then the wall of each stage,
each ended by a synchronise. Then once under torch.profiler: per stage
the launches and the device's busy time, and the kernels ranked by device
time. A stage whose busy time is far below its wall waits on the host's
issue of launches. The stream's fps come from chip_smoke.py. Needs a GPU:

    python -m jmcodec_tpu_torch.tools.profile_h264_inter [--picture 1] \
        [--trace out/h264_inter_trace.json]
"""

from __future__ import annotations

import argparse
import time

import torch

from jmcodec_tpu_torch.api.h264_inter import (DeviceDPB, decode_symbols,
                                              parse_h264)
from jmcodec_tpu_torch.kernels import recon_tiles as RT
from jmcodec_tpu_torch.tools.fixtures import h264_inter_fixture_stream
from jmcodec_tpu_torch.tools.profile_h264_intra import _staged
from jmcodec_tpu_torch.tools.profiling import profile_decode
from jmcodec_tpu_torch.utils.device import gpu_name_power, require_cuda

STAGES = ("stack_symbols", "stack_motion", "_mc_luma_batched",
          "_mc_chroma_batched", "_residuals", "_bs_planes",
          "intra_tiles", "deblock_tiles")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--picture", type=int, default=1,
                    help="which P picture, in decode order (default 1)")
    ap.add_argument("--trace", help="write the chrome trace to this path")
    args = ap.parse_args(argv)
    dev = require_cuda()
    pics = list(parse_h264(h264_inter_fixture_stream()))
    fs, sps = pics[args.picture]
    if fs.mv is None:
        raise SystemExit(f"picture {args.picture} is not a P picture")
    dpb = DeviceDPB()
    decode_symbols(pics[:args.picture], dev, dpb=dpb)
    refs, ids = dpb.list0(fs)
    walk = RT.intra_steps(fs.mb_class)
    decode = lambda: RT.decode_frame_symbols_inter(fs, refs, ref_ids=ids)
    decode()                                   # warm-up: build, tables
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    torch.cuda.synchronize()
    t_pic = time.perf_counter() - t0

    walls = {}
    for name in STAGES:
        setattr(RT, name, _staged(name, getattr(RT, name), walls))
    decode()
    walls.clear()
    decode()
    title = (f"P picture {args.picture} of {sps.width}x{sps.height} H.264 "
             f"({len(refs)} references, {int((fs.mb_class != 3).sum())} "
             f"intra macroblocks, the intra scan walks {sum(walk)} of "
             f"{len(walk)} diagonals)")
    print(gpu_name_power())
    print(f"{title}: unprofiled decode {t_pic * 1e3:.1f} ms; with a "
          f"synchronise around each stage " + ", ".join(
              f"{n} {walls.get(n, 0.0) * 1e3:.1f} ms" for n in STAGES))
    profile_decode(decode, title, args.trace, STAGES)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
