"""Multi-process GOP-DP run: the port of tools/jmx_multiproc.py. n ranks,
each a process of its own (parallel/distributed.launch), join one process
group through init_from_env (JMX_COORD on localhost), share one on-disk
TranscodeManifest, claim GOPs from it work-stealing style, decode them
with the DecoderSession on their device, and prove the cross-process
boundary with an all_reduce of the decoded frame counts.

    python -m jmcodec_tpu_torch.tools.jmx_multiproc [--nproc 2]
        [--gops 8] [--frames-per-gop 3] [--size 192x96] [--device DEV]
        [--workdir DIR] [--out FILE]

--device: the ranks' device (default: the card, one card a rank, NCCL;
"cpu": gloo ranks). Prints one JSON line; exits 1 unless every frame was
decoded once and every rank saw the same total.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from jmcodec_tpu_torch.api.session import DecoderSession
from jmcodec_tpu_torch.parallel.distributed import init_from_env, launch
from jmcodec_tpu_torch.parallel.mesh import rank_device
from jmcodec_tpu_torch.pipeline.gop import TranscodeManifest
from jmcodec_tpu_torch.tools.jmx_transcode import stream_head


def free_port() -> int:
    """A TCP port on localhost that is free at this moment."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child(outdir: str, coord: str, device) -> dict:
    """One rank: bring-up from the environment, GOP claims until the
    manifest has none, the frame total by all_reduce."""
    os.environ["JMX_COORD"] = coord
    boot = init_from_env(device)
    pid = boot["process_id"]
    dev = rank_device(device)
    man = TranscodeManifest.load(outdir)
    with open(man.input_path, "rb") as f:
        stream = f.read()
    head = stream_head(stream)
    t0 = time.time()
    frames, gops = 0, []
    while (job := man.claim(f"proc{pid}")) is not None:
        dec = DecoderSession(device=dev)
        dec.input_data(head + stream[job.byte_start:job.byte_end])
        dec.set_eof()
        while dec.get_frame() is not None:
            frames += 1
        gops.append(job.index)
        man.complete(job.index, f"mem://proc{pid}/{job.index}")
    dt = time.time() - t0
    total = torch.tensor([frames], dtype=torch.int64, device=dev)
    dist.all_reduce(total)
    return {"process_id": pid, "processes": boot["processes"],
            "global_devices": boot["devices"],
            "local_devices": boot["local_devices"], "device": str(dev),
            "frames_local": frames, "gops_local": gops,
            "frames_global_allreduce": int(total.item()),
            "seconds": round(dt, 3)}


def run(nproc: int = 2, gops: int = 8, frames_per_gop: int = 3,
        size: str = "192x96", device=None, workdir=None) -> dict:
    """The whole run; returns the report (its "ok" says whether it
    passed)."""
    from jmcodec_tpu_torch.codec.h264.refenc import encode_stream
    from jmcodec_tpu_torch.tools.fixtures import gradient_frame

    W, H = (int(v) for v in size.split("x"))
    # encode_stream emits IDR-only pictures: every frame is a closed
    # one-picture GOP, the unit the manifest splits on
    frames = [gradient_frame(W, H, seed=i)
              for i in range(gops * frames_per_gop)]
    stream, _ = encode_stream(frames, W, H, qp=30)
    with tempfile.TemporaryDirectory(prefix="jmx_multiproc_",
                                     dir=workdir) as outdir:
        inp = os.path.join(outdir, "in.h264")
        with open(inp, "wb") as f:
            f.write(stream)
        man = TranscodeManifest.create(inp, outdir)
        man.save()
        n_jobs = len(man.jobs)
        t0 = time.time()
        reports = launch(child, nproc, outdir, f"127.0.0.1:{free_port()}",
                         device, device="cuda" if device is None else device,
                         init=False)
        wall = time.time() - t0
    total = gops * frames_per_gop
    ok = (all(r["frames_global_allreduce"] == total for r in reports)
          and sum(r["frames_local"] for r in reports) == total
          and all(r["processes"] == nproc for r in reports)
          and sorted(g for r in reports for g in r["gops_local"])
          == list(range(n_jobs)))
    return {"metric": "multiprocess_gop_dp", "ok": ok, "nproc": nproc,
            "gops": n_jobs, "total_frames": total, "wall_s": round(wall, 2),
            "per_process": reports,
            "note": ("torch.distributed across OS processes on one host: "
                     "shared-manifest GOP claims and an all_reduce of the "
                     "decoded frame counts")}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--gops", type=int, default=8)
    ap.add_argument("--frames-per-gop", type=int, default=3)
    ap.add_argument("--size", default="192x96")
    ap.add_argument("--device", default=None)
    ap.add_argument("--workdir", default=None,
                    help="parent of the run's temporary directory")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rep = run(args.nproc, args.gops, args.frames_per_gop, args.size,
              args.device, args.workdir)
    line = json.dumps(rep)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    sys.exit(0 if rep["ok"] else 1)


if __name__ == "__main__":
    main()
