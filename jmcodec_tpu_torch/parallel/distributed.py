"""Multi-process bring-up and the GOP-DP work split: the port of
jmcodec_tpu/parallel/distributed.py on torch.distributed.

One process per rank. init_from_env joins a process group described by
the environment (JMX_COORD / JMX_NPROC / JMX_PROC_ID, as in the JAX
package); launch runs a function on n local ranks, each in a process of
its own started with torch.multiprocessing's spawn, joined through a
FileStore in a temporary directory (the JAX package needs no launcher: one
controller drives every device of its mesh).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.device import require_cuda
from .mesh import backend_for, rank_device


def init_from_env(device=None) -> dict:
    """Join the process group of JMX_COORD ("host:port" of rank 0),
    JMX_NPROC and JMX_PROC_ID; single-process when they are unset. device:
    this rank's device (None: the card, NCCL; "cpu": gloo).

    Returns the bring-up report {processes, process_id, devices,
    local_devices}: one device per process, so devices is the number of
    processes."""
    coord = os.environ.get("JMX_COORD")
    nproc = int(os.environ.get("JMX_NPROC", "1"))
    multi = bool(coord) and nproc > 1
    if multi:
        rank = int(os.environ.get("JMX_PROC_ID", "0"))
        if device is None:
            require_cuda()
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        else:
            dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend_for(dev), init_method=f"tcp://{coord}",
                                world_size=nproc, rank=rank)
    return {
        "processes": nproc if multi else 1,
        "process_id": dist.get_rank() if multi else 0,
        "devices": nproc if multi else 1,
        "local_devices": 1,
    }


def assign_gops(n_gops: int, n_workers: int, worker: int) -> List[int]:
    """Static GOP-DP split: contiguous stripes (locality for streaming IO);
    the manifest (pipeline/gop.py) handles resume/reclaim on top."""
    per = -(-n_gops // n_workers)
    return list(range(worker * per, min(n_gops, (worker + 1) * per)))


def _rank_main(rank, nprocs, fn, args, device, store_path, out_dir, init):
    os.environ["JMX_PROC_ID"] = str(rank)
    os.environ["JMX_NPROC"] = str(nprocs)
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    if init:
        dist.init_process_group(backend_for(dev),
                                store=dist.FileStore(store_path, nprocs),
                                rank=rank, world_size=nprocs)
    try:
        result = fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def launch(fn, nprocs: int, *args, device="cpu", init: bool = True,
           timeout: float = 600.0) -> list:
    """Run fn(*args) on nprocs local ranks, one spawned process each, and
    return their results in rank order. fn must be importable by name (a
    module-level function of this package) and return picklable host
    objects (numpy arrays, CPU tensors, numbers). device "cpu": gloo, one
    intra-op thread a rank; "cuda": NCCL, rank r on card r (raises with
    fewer cards than ranks). init False leaves the bring-up to fn (the
    ranks get JMX_PROC_ID and JMX_NPROC; init_from_env). A rank that
    raises, or a run past `timeout` seconds, raises here."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < nprocs:
        raise RuntimeError(f"{nprocs} ranks need {nprocs} cards, have "
                           f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="jmx_launch_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(nprocs, fn, args, dev.type,
                              os.path.join(tmp, "store"), tmp, init),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        out = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def run_calls(calls) -> list:
    """Rank function for launch: [(fn, args), ...] called in order, their
    results in a list (several checks for the price of one launch)."""
    return [fn(*args) for fn, args in calls]


def with_counts(fn, *args):
    """(fn(*args), the counts it made): {"dequant_idct", "hevc_walk",
    "hevc_scan", "hevc_resid", "h264_intra", "h264_deblock"} kernel
    launches and "lane_exchanges" (the row-sharded scans' boundary-lane
    exchanges) on this rank."""
    from ..kernels import (h264_scan, hevc_resid, hevc_scan, hevc_walk, idct,
                           recon_tiles)

    read = lambda: {"dequant_idct": idct.LAUNCHES,
                    "hevc_walk": hevc_walk.LAUNCHES,
                    "hevc_scan": hevc_scan.LAUNCHES,
                    "hevc_resid": hevc_resid.LAUNCHES,
                    "h264_intra": h264_scan.INTRA_LAUNCHES,
                    "h264_deblock": h264_scan.DEBLOCK_LAUNCHES,
                    "lane_exchanges": recon_tiles.LANE_EXCHANGES}
    before = read()
    out = fn(*args)
    return out, {k: v - before[k] for k, v in read().items()}


def _scaling_rank(fss, reps: int, device) -> float:
    from .decode_sharded import decode_symbols_sharded
    from .mesh import ShardingConfig, build_mesh

    n = dist.get_world_size()
    cfg = ShardingConfig(dp=n, sp=1)
    mesh = build_mesh(cfg, device)
    dev = rank_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    decode_symbols_sharded(fss, cfg, mesh, device=device)     # warm-up
    best = 0.0
    for _ in range(reps):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        decode_symbols_sharded(fss, cfg, mesh, device=device)
        sync()
        best = max(best, len(fss) / (time.perf_counter() - t0))
    return best


def measure_decode_scaling(fss, n_devices_list, reps: int = 3,
                           device=None) -> dict:
    """Frames/s of the H.264 all-intra batch decode at each rank count
    (frame-parallel dp, decode_symbols_sharded), the same total work per
    point: one launch of n ranks per point. device None: the card, one
    card a rank; "cpu": gloo ranks on the host's cores.

    Returns {"fps": {n: fps}, "efficiency": {n: fps / (n * fps at 1)}}."""
    launch_dev = "cuda" if device is None else device
    results = {}
    for n in n_devices_list:
        fps = launch(_scaling_rank, n, fss, reps, device, device=launch_dev)
        results[n] = round(min(fps), 3)
    base = results.get(1)
    eff = {n: round(results[n] / (base * n), 3)
           for n in results} if base else {}
    return {"fps": results, "efficiency": eff}
