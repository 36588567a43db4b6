"""Front end of the H.264 all-intra decode: Annex-B stream -> one
FrameSymbols per picture (native slice-data parser), and the whole decode
from a stream to cropped planes.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from ..codec.h264 import nal as NAL
from ..codec.h264.fastdec import FastH264Parser
from ..kernels.recon import stack_symbols
from ..kernels.recon_tiles import decode_frames_batch


def _picture_chunks(stream: bytes):
    """Cut an Annex-B stream at every slice NAL with first_mb_in_slice ==
    0 (its first payload bit set: ue(0)). Returns (head, chunks): the bytes
    before the first picture (parameter sets) and one chunk per picture,
    start code included."""
    starts = []
    for s, _ in NAL.split_annexb(stream):
        if (stream[s] & 0x1F) in (1, 5) and (stream[s + 1] & 0x80):
            sc = s - 3
            if sc > 0 and stream[sc - 1] == 0:
                sc -= 1
            starts.append(sc)
    if not starts:
        return stream, []
    starts.append(len(stream))
    return stream[:starts[0]], [stream[a:b]
                                for a, b in zip(starts, starts[1:])]


def parse_h264_intra_symbols(stream: bytes, workers: int = 1):
    """Parse an all-intra H.264 stream into [(FrameSymbols, SPS), ...] in
    decode order. workers > 1 parses pictures on that many threads (the
    native parser releases the GIL). Parameter sets must precede the first
    picture. Raises NotImplementedError for what the all-intra batch does
    not cover (P and B pictures, the 8x8 transform, MMCO, per-slice
    deblocking control)."""
    head, chunks = _picture_chunks(stream)
    parser = FastH264Parser()
    parser.parse_annexb(head)

    def parse_one(chunk):
        fs, sps = parser.parse_annexb(chunk)[0]
        if fs.mv is not None:
            raise NotImplementedError("P picture: decode it with "
                                      "api.h264_inter.decode_h264")
        return fs, sps

    if workers <= 1:
        return [parse_one(c) for c in chunks]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(parse_one, chunks))


def decode_h264_intra(stream: bytes, device=None, workers: int = 1):
    """Decode an all-intra, one-geometry H.264 stream on `device` (None:
    the card). Returns (Y, U, V) uint8 tensors [F, height, width] (chroma
    half size), cropped to the SPS size."""
    pics = parse_h264_intra_symbols(stream, workers)
    if not pics:
        raise ValueError("no picture in the stream")
    fss = [fs for fs, _ in pics]
    fs0, sps = pics[0]
    for fs in fss:
        if fs.has_pcm:
            raise NotImplementedError("PCM macroblocks are not on the "
                                      "device path")
        if (fs.mb_height, fs.mb_width, fs.deblock_enabled) != (
                fs0.mb_height, fs0.mb_width, fs0.deblock_enabled):
            raise NotImplementedError("mixed-geometry picture batch")
    Y, U, V = decode_frames_batch(fs0.mb_height, fs0.mb_width,
                                  *stack_symbols(fss, device),
                                  deblock=fs0.deblock_enabled)
    w, h = sps.width, sps.height
    return Y[:, :h, :w], U[:, :h // 2, :w // 2], V[:, :h // 2, :w // 2]
