"""The H.264 reconstruction scans as CUDA kernels: the intra wavefront
(csrc/h264_intra.cu) and the deblock wavefront (csrc/h264_deblock.cu), one
persistent launch a scan, on skewed macroblock tiles (recon_tiles' layout).

    intra_tiles(...)   == recon_tiles._intra_tile_scan(...)
    deblock_tiles(...) == recon_tiles._deblock_tile_scan(...)

Each takes its plain torch version's arguments and returns what it
returns, bit for bit. They are the counterparts of the two jax.lax.scans
of jmcodec_tpu's jitted H.264 decode (kernels/recon_tiles.py:
_intra_tile_scan with the body _intra_step, and _deblock_tile_scan with
_deblock_step / _deblock_tile_scan_intra). recon_tiles._reconstruct
routes a decode on the card here; CPU tensors take the torch versions
there, and these wrappers raise on them.

Both kernels read the picture's neighbours from the tiles of earlier
diagonals. One launch walks a range of diagonals: each warp of it takes a
(frame, lane) and walks that lane's macroblocks in order, waiting before
each one on the lane above's progress flag (csrc/lane_chain.cuh). The
flags and the lanes' ticket are scratch that the wrapper zeroes (with the
walk mask of a P picture after them, copied up from the host): one fill
and one kernel a scan. Lane 0 is the picture's top macroblock row and a
macroblock at mx == 0 has none to its left: the kernels never read past
them (the torch versions roll the lanes and mask what wraps), so their
inputs must hold what every picture holds there: no top availability on
lane 0, and bS 0 on the picture's boundary edges.

Row-sharded decode (parallel/spatial.py): with `group`, a process group of
n > 1 ranks that hold equal bands of consecutive lanes in rank order, each
rank passes its band and the kernels take the lane above it as a halo, one
tile per diagonal, filled by a point-to-point exchange with the rank above
after each launch (ring_pass). A kernel cannot wait on NCCL, so this route
keeps one launch a diagonal: rank i runs diagonal d once rank i-1 has
sent its last lane's tile of diagonal d-1, so the ranks keep in step. The
deblock kernel filters the halo's last rows as the top edge of its lane 0;
those rows go back to the rank above at the end, which holds the tile's
final state until then (it writes a tile of its last lane only as that
tile's own macroblock and as the left neighbour of the next diagonal's).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.distributed as dist

from ..codec.h264 import macroblock as MB
from ..ops import deblock as DB
from ..ops import transform as T
from .recon import _I4_ABC, _TR_SRC

_I32 = torch.int32

# Kernel launches: one a scan on one rank, one a diagonal on a band of a
# row-sharded group; read by callers that must show the main path went
# through the kernels.
INTRA_LAUNCHES = 0
DEBLOCK_LAUNCHES = 0

# the tensor arguments of each scan, in its order (intra_tiles: then
# inter_t and walk)
INTRA_ARGS = ("resid_y_t", "resid_u_t", "resid_v_t", "modes_t", "cls_t",
              "i16_t", "cmode_t", "a_l_t", "a_t_t", "a_tr_t", "valid_t")
DEBLOCK_ARGS = ("Yt", "Ut", "Vt", "qp_t", "valid_t", "alpha_off", "beta_off",
                "chroma_qp_off", "second_chroma_qp_off", "bs_v_t", "bs_h_t")

# the halo's packing of one tile of a lane: Y (256), then U and V (64 each)
HALO = 256 + 64 + 64


def _i4_wave():
    """The Intra_4x4 wavefront of csrc/h264_intra.cu: [10 steps, 2] int32,
    the sub-blocks (decode order index) of each step, -1 in the second
    slot of a step that holds one. Sub-block (bx, by) goes at step bx/4 +
    2 by/4, after its left, top, top-left and top-right sub-blocks."""
    wave = np.full((10, 2), -1, np.int32)
    for blk in range(16):
        step = int(MB.BLK_X[blk]) // 4 + 2 * (int(MB.BLK_Y[blk]) // 4)
        wave[step, int(wave[step, 0] >= 0)] = blk
    return wave


I4_WAVE = _i4_wave()

_lib = None
_tables_on = set()      # devices whose constant tables are set


def _load():
    global _lib
    if _lib is None:
        from . import _build
        lib = ctypes.CDLL(_build.build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.h264_intra_set_tables.argtypes = [p] * 5
        lib.h264_deblock_set_tables.argtypes = [p] * 4
        lib.h264_intra_launch.argtypes = ([p] * 14 + [i, p, p, i, p, p]
                                          + [i] * 5 + [p])
        lib.h264_deblock_launch.argtypes = ([p] * 11 + [ctypes.c_longlong]
                                            + [p, p, i, p, p] + [i] * 5
                                            + [p])
        for fn in (lib.h264_intra_set_tables, lib.h264_deblock_set_tables,
                   lib.h264_intra_launch, lib.h264_deblock_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _host(a):
    """A table as a contiguous int32 numpy array, kept alive by the
    caller."""
    return np.ascontiguousarray(np.asarray(a), dtype=np.int32)


def _tables(device):
    """The kernels' library with its constant tables set on `device` (once
    per device): the port's own arrays, copied up from the host."""
    lib = _load()
    if device.index not in _tables_on:
        intra = [_host(a) for a in (MB.BLK_X, MB.BLK_Y, _TR_SRC, _I4_ABC,
                                    I4_WAVE)]
        deblock = [_host(a) for a in (DB.ALPHA_TABLE, DB.BETA_TABLE,
                                      DB.TC0_TABLE, T.CHROMA_QP)]
        with torch.cuda.device(device):
            for fn, arrs in ((lib.h264_intra_set_tables, intra),
                             (lib.h264_deblock_set_tables, deblock)):
                err = fn(*(a.ctypes.data for a in arrs))
                if err != 0:
                    raise RuntimeError(f"setting the H.264 scan tables "
                                       f"failed: CUDA error {err}")
        _tables_on.add(device.index)
    return lib


def _check(named, device, shapes):
    """named {name: tensor}, shapes {name: shape}: every tensor int32,
    contiguous and of its shape (checked first, so a CPU call shows a wrong
    argument too), then all on `device`, a CUDA device, each tensor of
    tiles starting on a 16-byte boundary (the kernels copy tiles 16 bytes
    at a time)."""
    for name, t in named.items():
        if t.dtype != _I32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != tuple(shapes[name]):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(shapes[name])}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if device.type != "cuda":
        raise ValueError(f"the H.264 scan kernels take CUDA tensors, not "
                         f"{device}: the plain torch versions are "
                         f"recon_tiles._intra_tile_scan / _deblock_tile_scan")
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, not {device}")
        if t.dim() >= 4 and t.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary")


def _scratch(nf, lanes, tickets, device, walk=None):
    """The kernels' scratch, int32: the lanes' progress flags [nf * lanes],
    then `tickets` lane counters, all 0, then with `walk` its diagonals as
    0/1 (one copy from the host; else one fill)."""
    n = nf * lanes + tickets
    if walk is None:
        return torch.zeros(n, dtype=_I32, device=device)
    host = np.zeros(n + len(walk), np.int32)
    host[n:] = np.asarray(walk, dtype=bool)
    return torch.from_numpy(host).to(device, non_blocking=True)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def ring_pass(x, group, k: int = 1):
    """Send the contiguous tensor x to the rank k places after this one in
    `group`'s ring and return what the rank k places before sent (a
    tensor of x's shape and dtype); every rank of the group calls it
    together."""
    n = dist.get_world_size(group)
    me = dist.get_group_rank(group, dist.get_rank())
    peer = lambda r: dist.get_global_rank(group, r % n)
    recv = torch.empty_like(x)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, peer(me + k), group),
            dist.P2POp(dist.irecv, recv, peer(me - k), group)]):
        req.wait()
    return recv


def _band(group, lanes: int):
    """(this rank's first global lane, the ranks) of a band of `lanes`
    lanes under `group` (None: the whole picture)."""
    n = 1 if group is None else dist.get_world_size(group)
    if n == 1:
        return 0, 1
    return dist.get_group_rank(group, dist.get_rank()) * lanes, n


def _lane_tiles(out, d):
    """The last lane's tiles of diagonal d (an int or a slice) of out (Y,
    U, V), packed as the halo is: [F, HALO] or [F, n, HALO]."""
    return torch.cat([t[:, d, -1].flatten(-2) for t in out], -1).contiguous()


def intra_tiles(resid_y_t, resid_u_t, resid_v_t, modes_t, cls_t, i16_t,
                cmode_t, a_l_t, a_t_t, a_tr_t, valid_t, inter_t=None,
                walk=None, group=None):
    """recon_tiles._intra_tile_scan on the card: skewed inputs [F, n_steps,
    lanes, ...] int32 (valid_t [n_steps, lanes]); inter_t the P picture's
    inter tiles (Y, U, V) that seed the output, walk (only with inter_t)
    the diagonals to launch on. group: the row-sharded decode's process
    group (this rank's band of lanes; None: every lane). Returns new skewed
    (Y, U, V) tiles."""
    nf, n_steps, lanes = cls_t.shape
    g = (nf, n_steps, lanes)
    named = dict(zip(INTRA_ARGS, (resid_y_t, resid_u_t, resid_v_t, modes_t,
                                  cls_t, i16_t, cmode_t, a_l_t, a_t_t,
                                  a_tr_t, valid_t)))
    shapes = {"resid_y_t": (*g, 16, 16), "resid_u_t": (*g, 8, 8),
              "resid_v_t": (*g, 8, 8), "modes_t": (*g, 4, 4),
              "valid_t": (n_steps, lanes)}
    shapes.update({n: g for n in named if n not in shapes})
    if inter_t is not None:
        named.update(zip(("inter_y", "inter_u", "inter_v"), inter_t))
        shapes.update(inter_y=shapes["resid_y_t"],
                      inter_u=shapes["resid_u_t"],
                      inter_v=shapes["resid_v_t"])
    elif walk is not None:
        raise ValueError("walk without inter_t: a skipped diagonal is its "
                         "inter tiles")
    if walk is not None and len(walk) != n_steps:
        raise ValueError(f"walk has {len(walk)} diagonals, not {n_steps}")
    _check(named, cls_t.device, shapes)
    if inter_t is None:
        out = tuple(torch.zeros_like(r) for r in (resid_y_t, resid_u_t,
                                                  resid_v_t))
    else:
        vm = (valid_t == 1)[..., None, None]
        out = tuple(torch.where(vm, t, 0) for t in inter_t)
    has_inter = inter_t is not None
    k0, n = _band(group, lanes)
    if n == 1:
        _launch_intra(out, named, has_inter, walk, 0, n_steps)
        return out
    # the lane above the band: first its seed, then each walked diagonal
    # as the rank above finishes it
    halo = ring_pass(_lane_tiles(out, slice(None)), group)
    scratch = _scratch(nf, lanes, n_steps, cls_t.device)
    for d in range(n_steps):
        if walk is None or walk[d]:
            _launch_intra(out, named, has_inter, None, d, d + 1, halo, k0,
                          scratch, d)
            halo[:, d] = ring_pass(_lane_tiles(out, d), group)
    return out


def _launch_intra(out, named, has_inter, walk, d0, d1, halo=None, k0=0,
                  scratch=None, ticket=0):
    """Launch the intra kernel once on diagonals d0 .. d1-1 (those walk
    marks; none: no launch) in place on out (Y, U, V), with intra_tiles'
    checked inputs `named`; halo [F, n_steps, HALO] the lane above a band
    whose first lane is k0 > 0. scratch: _scratch's flags and counters,
    shared by the launches of one scan (ticket: this launch's counter;
    only without walk); None: its own."""
    Y = out[0]
    nf, n_steps, lanes = named["cls_t"].shape
    if walk is not None and not any(walk[d0:d1]):
        return
    if scratch is None:
        scratch = _scratch(nf, lanes, 1, Y.device, walk)
    base = scratch.data_ptr()
    lib = _tables(Y.device)
    with torch.cuda.device(Y.device):
        err = lib.h264_intra_launch(
            *(t.data_ptr() for t in out),
            *(named[k].data_ptr() for k in INTRA_ARGS),
            int(has_inter),
            None if walk is None else base + 4 * (nf * lanes + 1),
            None if halo is None else halo.data_ptr(), k0,
            base, base + 4 * (nf * lanes + ticket),
            nf, n_steps, lanes, d0, d1, _stream(Y.device))
    if err != 0:
        raise RuntimeError(f"h264_intra kernel launch failed: CUDA error "
                           f"{err}")
    global INTRA_LAUNCHES
    INTRA_LAUNCHES += 1


def deblock_tiles(Yt, Ut, Vt, qp_t, valid_t, alpha_off, beta_off,
                  chroma_qp_off, second_chroma_qp_off, bs_v_t, bs_h_t,
                  group=None):
    """recon_tiles._deblock_tile_scan on the card: skewed recon tiles
    [F, n_steps, lanes, ...] int32, qp_t [F, n_steps, lanes], valid_t
    [n_steps, lanes], the offsets [F], bs_v_t / bs_h_t [F or 1, n_steps,
    lanes, 4 (edge), 4 (sub-edge)] (one frame's pattern serves every
    frame). group: as intra_tiles'. Returns new deblocked tiles; the
    inputs stay as they were."""
    nf, n_steps, lanes = qp_t.shape
    g = (nf, n_steps, lanes)
    nb = bs_v_t.shape[0] if bs_v_t.dim() == 5 else -1
    named = dict(zip(DEBLOCK_ARGS, (Yt, Ut, Vt, qp_t, valid_t, alpha_off,
                                    beta_off, chroma_qp_off,
                                    second_chroma_qp_off, bs_v_t, bs_h_t)))
    bs_shape = (nb if nb in (1, nf) else nf, n_steps, lanes, 4, 4)
    shapes = {"Yt": (*g, 16, 16), "Ut": (*g, 8, 8), "Vt": (*g, 8, 8),
              "qp_t": g, "valid_t": (n_steps, lanes), "alpha_off": (nf,),
              "beta_off": (nf,), "chroma_qp_off": (nf,),
              "second_chroma_qp_off": (nf,), "bs_v_t": bs_shape,
              "bs_h_t": bs_shape}
    _check(named, qp_t.device, shapes)
    out = tuple(t.clone() for t in (Yt, Ut, Vt))
    k0, n = _band(group, lanes)
    if n == 1:
        _launch_deblock(out, named, 0, n_steps)
        return out
    # the lane above the band, each tile as the rank above leaves it: after
    # its launch t, tile t-1 of its last lane is final there
    hqp = ring_pass(qp_t[:, :, -1].contiguous(), group)
    halo = torch.zeros((nf, n_steps, HALO), dtype=_I32, device=Yt.device)
    scratch = _scratch(nf, lanes, n_steps, Yt.device)
    for t in range(n_steps):
        _launch_deblock(out, named, t, t + 1, halo, hqp, k0, scratch, t)
        if t > 0:
            halo[:, t - 1] = ring_pass(_lane_tiles(out, t - 1), group)
    halo[:, -1] = ring_pass(_lane_tiles(out, n_steps - 1), group)
    # our lane 0 filtered the halo's last rows (its top edge): they go back
    # to the rank above, and the rank below's come back to our last lane
    back = ring_pass(halo, group, -1)
    if k0 + lanes < n * lanes:
        y, u, v = back.split((256, 64, 64), -1)
        out[0][:, :, -1, 12:] = y.unflatten(-1, (16, 16))[..., 12:, :]
        out[1][:, :, -1, 6:] = u.unflatten(-1, (8, 8))[..., 6:, :]
        out[2][:, :, -1, 6:] = v.unflatten(-1, (8, 8))[..., 6:, :]
    return out


def _launch_deblock(out, named, t0, t1, halo=None, hqp=None, k0=0,
                    scratch=None, ticket=0):
    """Launch the deblock kernel once on diagonals t0 .. t1-1 in place on
    out (Y, U, V), with deblock_tiles' checked inputs `named`; halo [F,
    n_steps, HALO] and hqp [F, n_steps] the lane above a band whose first
    lane is k0 > 0, filtered in place. scratch, ticket: as
    _launch_intra's."""
    Y = out[0]
    nf, n_steps, lanes = named["qp_t"].shape
    bs_v = named["bs_v_t"]
    fstride = 0 if bs_v.shape[0] == 1 else n_steps * lanes * 16
    if scratch is None:
        scratch = _scratch(nf, lanes, 1, Y.device)
    base = scratch.data_ptr()
    lib = _tables(Y.device)
    with torch.cuda.device(Y.device):
        err = lib.h264_deblock_launch(
            *(t.data_ptr() for t in out),
            *(named[k].data_ptr() for k in DEBLOCK_ARGS[3:]),
            fstride, None if halo is None else halo.data_ptr(),
            None if hqp is None else hqp.data_ptr(), k0,
            base, base + 4 * (nf * lanes + ticket),
            nf, n_steps, lanes, t0, t1, _stream(Y.device))
    if err != 0:
        raise RuntimeError(f"h264_deblock kernel launch failed: CUDA error "
                           f"{err}")
    global DEBLOCK_LAUNCHES
    DEBLOCK_LAUNCHES += 1
