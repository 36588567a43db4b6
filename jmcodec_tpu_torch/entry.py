"""The port's entry points, the counterparts of __graft_entry__.py:

entry(device=None)             -> (fn, example_args): the device H.264
                                  intra-frame reconstruction (symbol planes
                                  -> decoded frame) on seeded symbols
dryrun_multichip(n, device=None) -> the three multichip checks on n ranks:
                                  ONE sharded transcode step of the real
                                  decode (dp x sp, the all_gather reshard,
                                  the halo downscale, the summed rate
                                  statistics), and the row-sharded intra and
                                  P decodes of a real bitstream, each
                                  bit-exact

device None is the card (n cards under NCCL for the dryrun; it raises with
fewer); "cpu" runs the same code in torch on the host (n gloo ranks).
There is no quiet switch to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def _example_symbols(mbh=4, mbw=4, qp=30, seed=0):
    """Small synthetic-but-valid symbol planes for one intra frame (the
    symbols of __graft_entry__._example_symbols)."""
    from .codec.h264.symbols import FrameSymbols
    rng = np.random.default_rng(seed)
    fs = FrameSymbols(mbw, mbh)
    fs.mb_class[:] = rng.integers(0, 2, (mbh, mbw))
    fs.qp[:] = qp
    fs.i4_modes[:] = 2  # DC everywhere keeps modes legal for any availability
    fs.i16_mode[:] = 2
    fs.chroma_mode[:] = 0
    fs.luma_coeffs[:] = rng.integers(-8, 9, fs.luma_coeffs.shape)
    fs.luma_dc[:] = rng.integers(-16, 17, fs.luma_dc.shape)
    fs.chroma_coeffs[:] = rng.integers(-4, 5, fs.chroma_coeffs.shape)
    fs.chroma_dc[:] = rng.integers(-8, 9, fs.chroma_dc.shape)
    fs.fill_availability(np.zeros((mbh, mbw), np.int32))
    return fs


def entry(device=None):
    """(fn, example_args): fn(*example_args) -> (Y, U, V) uint8 tensors of
    one 64x64 intra frame, decoded by recon_tiles.decode_frame (the port's
    one-frame decode; the dequant+IDCT kernel on the card)."""
    from .kernels import recon_tiles
    from .kernels.recon import _NARROW
    from .utils.device import require_cuda

    dev = require_cuda() if device is None else torch.device(device)
    fs = _example_symbols()
    mbh, mbw = fs.mb_height, fs.mb_width
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def fn(*planes):
        return recon_tiles.decode_frame(mbh, mbw, *planes, zero, zero, zero,
                                        zero, deblock=True)

    example_args = tuple(torch.from_numpy(getattr(fs, name)).to(dev)
                         for name in _NARROW)
    return fn, example_args


def _dryrun_rank(n: int, device) -> dict:
    """One rank of dryrun_multichip: the three checks; raises on a
    mismatch."""
    from .codec.h264.fastdec import FastH264Parser
    from .codec.h264.refenc import (EncoderConfig, H264ReferenceEncoder,
                                    encode_stream)
    from .kernels import recon_tiles as RT
    from .parallel.decode_sharded import run_decode_sharded_dryrun
    from .parallel.mesh import ShardingConfig, build_mesh, rank_device
    from .parallel.spatial import (decode_frame_rows_sharded,
                                   decode_frame_rows_sharded_inter)
    from .tools.fixtures import gradient_frame

    # ONE full sharded step of the real codec: the H.264 decode (frames
    # over dp x sp), the all_gather frame->row reshard, the halo-exchange
    # downscale, the intra-encode forward pass, the summed rate statistics
    z, bits, ssd, cfg = run_decode_sharded_dryrun(n, device=device)
    if z.ndim != 5 or bits <= 0:
        raise RuntimeError("sharded codec step produced no output")

    # the row-sharded decode of a real bitstream's IDR picture: MB rows
    # banded over sp, the boundary-lane exchange of the wavefront and the
    # deblock, bit-exact against the encoder's own reconstruction
    W, H = 64, 16 * max(4, n)
    stream, recons = encode_stream([gradient_frame(W, H, seed=1)], W, H,
                                   qp=30)
    fss = [fs for fs, _ in FastH264Parser().parse_annexb(stream)]
    sp_cfg = ShardingConfig(dp=1, sp=n)
    mesh = build_mesh(sp_cfg, device)
    Y, _, _ = decode_frame_rows_sharded(fss[0], mesh=mesh, cfg=sp_cfg,
                                        device=device)
    ry = recons[0][0]
    if not np.array_equal(Y[:ry.shape[0], :ry.shape[1]], ry):
        raise RuntimeError("row-sharded recon of a real bitstream is not "
                           "bit-exact")

    # a row-sharded P picture: MC against a reference whose rows are
    # banded across the ranks, the halo strips sent by the neighbouring
    # bands, bit-exact against the unsharded P decode
    H2 = 32 * max(4, n)       # a band must cover the MC_PAD halo
    enc = H264ReferenceEncoder(EncoderConfig(W, H2, qp=30, gop_len=2))
    ippp = enc.headers_annexb()
    for fy, fu, fv in [gradient_frame(W, H2, seed=1)] * 2:
        ippp += enc.encode_frame(np.asarray(fy, np.int32),
                                 np.asarray(fu, np.int32),
                                 np.asarray(fv, np.int32))
    (fs_i, _), (fs_p, _) = FastH264Parser().parse_annexb(ippp)[:2]
    Yi, Ui, Vi = decode_frame_rows_sharded(fs_i, mesh=mesh, cfg=sp_cfg,
                                           device=device)
    dev = rank_device(device)
    dpb = [RT.pad_ref_device(*(torch.from_numpy(a).to(dev)
                               for a in (Yi, Ui, Vi)))]
    Yp, _, _ = decode_frame_rows_sharded_inter(fs_p, dpb, mesh=mesh,
                                               cfg=sp_cfg)
    want = RT.decode_frame_symbols_inter(fs_p, dpb, [0])
    if not np.array_equal(Yp, want[0].cpu().numpy()):
        raise RuntimeError("row-sharded P recon is not bit-exact against "
                           "the unsharded decode")
    return {"dp": cfg.dp, "sp": cfg.sp, "levels_shape": z.shape,
            "bits": bits, "ssd": ssd, "levels": z}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The three checks on n_devices ranks (one process each); returns rank
    0's summary and prints a line. device None: n cards under NCCL (raises
    with fewer); "cpu": n gloo ranks."""
    from .parallel.distributed import launch
    from .utils.device import require_cuda

    if device is None:
        require_cuda()
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun on {n_devices} cards: have "
                               f"{torch.cuda.device_count()}")
    res = launch(_dryrun_rank, n_devices, n_devices, device,
                 device="cuda" if device is None else device)[0]
    print(f"dryrun ok: {n_devices} ranks mesh=(dp={res['dp']}, "
          f"sp={res['sp']}) levels{res['levels_shape']} bits={res['bits']} "
          f"ssd={res['ssd']}; row-sharded real-bitstream decode "
          f"sp={n_devices} bit-exact; row-sharded INTER decode (ref-window "
          f"halo exchange) bit-exact")
    return res
