"""The chain of TU steps of the hevc_scan kernel's scans, counted on the CPU
from an all-intra HEVC stream's plans (kernels/hevc_levels.py).

For every plane of every picture (luma; chroma, whose Cb and Cr share one
map) it prints three lengths, in TUs:
  zorder  the longest path through the scan's CTB chain (CTB (cy, cx)
          after (cy, cx - 1) and, when it holds a TU, after CTB
          cx + skew - 1 of the row above), each CTB costing its active TUs:
          the chain of a walk in z-order, one TU after another;
  levels  the same path, each CTB costing its dependency levels: the
          chain of the kernel's walk by level;
  plane   the TU critical path of the whole plane (the level rule over the
          plane's TUs in decode order, across CTBs): what a schedule
          across CTBs and lanes could reach;
with the most TUs and levels of one CTB. A scan's time over its chain
length in levels is the time of one chain step.

    python -m jmcodec_tpu_torch.tools.hevc_scan_chain STREAM [--frames N]
        [--json]
"""

from __future__ import annotations

import argparse
import json

from ..api.hevc_intra import parse_hevc_intra_plans
from ..kernels import hevc_levels as HL
from ..kernels import hevc_tables as HT


def plane_chains(tu, zidx, C: int, max_tu: int, skew: int) -> dict:
    """The three chain lengths and the CTB maxima of one plane's maps."""
    n_tus, n_lvl = HL.level_counts(tu, zidx, C, max_tu)
    has = n_tus > 0
    return {"zorder": HL.ctb_chain(n_tus, has, skew),
            "levels": HL.ctb_chain(n_lvl, has, skew),
            "plane": HL.plane_levels(tu, zidx, C, max_tu),
            "tus": int(n_tus.sum()), "max_tus_ctb": int(n_tus.max()),
            "max_levels_ctb": int(n_lvl.max())}


def stream_chains(stream: bytes, frames: int | None = None) -> list[dict]:
    """One record a plane: {"frame", "plane", "zorder", "levels", "plane",
    ...} for the first `frames` pictures (None: all)."""
    plans = parse_hevc_intra_plans(stream)
    out = []
    for f, p in enumerate(plans[:frames]):
        C = 1 << p.log2_ctb
        skew = HT.skew_for(C)
        for name, tu, zidx, c, max_tu in (
                ("luma", p.tu_log2_y, p.zidx_y, C, 32),
                ("chroma", p.tu_log2_c, p.zidx_c, C // 2, 16)):
            out.append({"frame": f, "plane_name": name,
                        **plane_chains(tu, zidx, c, max_tu, skew)})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stream")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--json", action="store_true",
                    help="one JSON object a plane")
    a = ap.parse_args(argv)
    with open(a.stream, "rb") as fh:
        recs = stream_chains(fh.read(), a.frames)
    for r in recs:
        if a.json:
            print(json.dumps(r))
        else:
            print(f"frame {r['frame']} {r['plane_name']}: zorder "
                  f"{r['zorder']}, levels {r['levels']}, plane "
                  f"{r['plane']} TUs (TUs {r['tus']}; a CTB at most "
                  f"{r['max_tus_ctb']} TUs, {r['max_levels_ctb']} levels)")


if __name__ == "__main__":
    main()
