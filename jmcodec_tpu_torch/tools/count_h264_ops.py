"""How many ATen calls the host issues per wavefront step of the H.264
all-intra decode: the decode is bound by their issue, and their number
does not depend on the picture size or the batch, so a small stream on the
CPU counts them. Prints the top-level calls per intra step and per deblock
step, views (no kernel) apart from the rest. Needs no GPU:

    python -m jmcodec_tpu_torch.tools.count_h264_ops tests/data/h264_80x64.h264
"""

from __future__ import annotations

import argparse
from collections import Counter

from torch.profiler import ProfilerActivity, profile

from jmcodec_tpu_torch.api.h264_intra import parse_h264_intra_symbols
from jmcodec_tpu_torch.kernels import recon as RC
from jmcodec_tpu_torch.kernels import recon_tiles as RT

VIEWS = {"aten::" + n for n in (
    "slice", "select", "unsqueeze", "expand", "reshape", "view", "narrow",
    "unbind", "split", "transpose", "permute", "alias", "squeeze")}


def _calls(fn) -> Counter:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return Counter(e.name for e in prof.events()
                   if e.name.startswith("aten::") and e.cpu_parent is None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("stream", help="an all-intra H.264 Annex-B file")
    args = ap.parse_args(argv)
    with open(args.stream, "rb") as f:
        fss = [fs for fs, _ in parse_h264_intra_symbols(f.read())]
    mbh, mbw = fss[0].mb_height, fss[0].mb_width
    tensors = RC.stack_symbols(fss, "cpu")
    steps = mbw + 2 * (mbh - 1)
    run = lambda deblock: _calls(lambda: RT.decode_frames_batch(
        mbh, mbw, *tensors, deblock=deblock))
    intra = run(False)
    deblock = run(True) - intra
    for name, c, n in (("intra", intra, steps), ("deblock", deblock,
                                                 steps + 2)):
        views = sum(v for k, v in c.items() if k in VIEWS)
        total = sum(c.values())
        print(f"{name}: {n} steps, {total / n:.0f} ATen calls per step, "
              f"{views / n:.0f} of them views; most frequent: " + ", ".join(
                  f"{k[6:]} {v / n:.0f}" for k, v in c.most_common(8)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
