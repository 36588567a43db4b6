// H.264 intra reconstruction (spec 8.3) of skewed macroblock tiles: one
// launch per wavefront diagonal that holds an intra macroblock.
//
// Replaces the intra wavefront that jmcodec_tpu runs as a jax.lax.scan on
// the device (kernels/recon_tiles.py: _intra_tile_scan, body _intra_step);
// its plain torch version is recon_tiles._intra_tile_scan. Layout (int32):
//     Y [F, n_steps, lanes, 16, 16], U and V [F, n_steps, lanes, 8, 8]:
//         the output, seeded by the caller (zeros, or in a P picture the
//         inter tiles with invalid lanes zeroed) and written in place
//     resid_y/u/v in the output's shapes; modes [F, n_steps, lanes, 4, 4]
//     cls, i16, cmode, a_l, a_t, a_tr [F, n_steps, lanes]
//     valid [n_steps, lanes]
// Tile (d, k) is macroblock (mx, my) = (d - 2k, k); its neighbours are the
// left (d-1, k), top (d-2, k-1), top-right (d-1, k-1) and top-left
// (d-3, k-1) tiles, all of earlier diagonals, so the launch of diagonal d
// reads only what earlier launches finished and writes only its own tiles.
// They are unfiltered samples: deblocking runs after the whole scan, as in
// jmcodec_tpu's split scans. A neighbour outside the diagonals (d < 0, or
// lane -1: lane 0 is the picture's top row, whose top availability is 0)
// reads as 0; the torch version's lane roll wraps there and masks it.
// A band of lanes (the row-sharded decode: rank i of n holds global lanes
// k0 .. k0 + lanes - 1) with k0 > 0 reads lane -1 from its halo, the lane
// above the band: halo [F, n_steps, 384] holds per diagonal that lane's Y
// tile (256), then U and V (64 each), filled by the caller for d-1, d-2
// and d-3 before launch d.
//
// Per macroblock: Intra_4x4 (class 0, and 2 as in the torch version) runs
// its 16 sub-blocks in decode order, the 16 threads of a sub-block each
// predicting one sample from the 13 neighbours (top-right per the
// per-block source table and 8.3.1.2's substitution, unavailable ones 0)
// and the sub-blocks before it in shared memory; Intra_16x16 (class 1)
// predicts all 256 samples at once; chroma (4 modes, a_tl = a_t & a_l)
// takes 128 threads; then + residual, clipped to 0..255. With inter tiles
// (has_inter) a class 3 macroblock keeps its seeded inter tile, and an
// invalid lane keeps its 0.
//
// Bound on this card: at one picture, the launch floor. A walked diagonal
// of a 1080p picture is at most 68 macroblocks, about 3.3 KB each read and
// written and a few thousand integer operations; the 16 dependent
// sub-blocks of Intra_4x4 are the chain inside a launch. The design is the
// simple one: one CTA of 256 threads (one per luma sample) per (frame,
// lane), the neighbour rows and columns and the macroblock staged in shared
// memory, a barrier between sub-blocks.
//
// The tables (the block scan BLK_X/BLK_Y, the top-right source of each
// block, the Intra_4x4 A/B/C neighbour indices per mode) are set once per
// device from the port's numpy arrays (codec/h264/macroblock.py,
// kernels/recon.py) by h264_intra_set_tables.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int c_blk_x[16];
__constant__ int c_blk_y[16];
__constant__ int c_tr_src[16];       // 0 always, 1 a_t, 2 a_tr, 3 never
__constant__ int c_i4_abc[9][48];    // per mode: A[16], B[16], C[16]

struct IntraArgs {
    int *Y, *U, *V;
    const int *resid_y, *resid_u, *resid_v, *modes;
    const int *cls, *i16, *cmode, *a_l, *a_t, *a_tr, *valid;
    int n_steps, lanes, has_inter;
    const int *halo;            // [F, n_steps, 384], or null (k0 == 0)
    int k0;
};

// the halo's packing of one tile: Y, then U, then V
constexpr int HALO = 256 + 64 + 64;

__device__ __forceinline__ int clip255(int x) { return min(max(x, 0), 255); }

// DC from the sums of 2^log2n top and left samples (8.3.1.2.3, 8.3.3.3,
// 8.3.4.1-3)
__device__ __forceinline__ int dc_value(int st, int sl, bool at, bool al,
                                        int log2n) {
    const int r = 1 << (log2n - 1);
    if (at && al) return (st + sl + 2 * r) >> (log2n + 1);
    if (al) return (sl + r) >> log2n;
    if (at) return (st + r) >> log2n;
    return 128;
}

// plane prediction (8.3.3.4 for size 16, 8.3.4.4 for 8) of sample (y, x)
// from the top row t, the left column l and the corner tl
__device__ int plane_value(const int *t, const int *l, int tl, int size,
                           int y, int x) {
    const int half = size / 2;
    int gh = 0, gv = 0;
    for (int i = 0; i < half; ++i) {
        const int tb = i == half - 1 ? tl : t[half - 2 - i];
        const int lb = i == half - 1 ? tl : l[half - 2 - i];
        gh += (i + 1) * (t[half + i] - tb);
        gv += (i + 1) * (l[half + i] - lb);
    }
    const int a = 16 * (l[size - 1] + t[size - 1]);
    int b, c;
    if (size == 16) {
        b = (5 * gh + 32) >> 6;
        c = (5 * gv + 32) >> 6;
    } else {
        b = (17 * gh + 16) >> 5;
        c = (17 * gv + 16) >> 5;
    }
    const int ramp = half - 1;
    return clip255((a + b * (x - ramp) + c * (y - ramp) + 16) >> 5);
}

__global__ void __launch_bounds__(256)
h264_intra_kernel(IntraArgs a, int d) {
    const int k = blockIdx.x, f = blockIdx.y, tid = threadIdx.x;
    if (a.valid[d * a.lanes + k] != 1) return;
    const long long own = ((long long)f * a.n_steps + d) * a.lanes + k;
    const int cls = a.cls[own];
    if (a.has_inter && cls == 3) return;     // the seeded inter tile stays
    const bool al = a.a_l[own] == 1, at = a.a_t[own] == 1,
               atr = a.a_tr[own] == 1, atl = at && al;

    // a neighbour's tile in plane p (0 Y, 1 U, 2 V): (dd, kk) of the
    // diagonals, lane -1 from the halo when the band has one; null where
    // outside them (reads as 0)
    const long long row0 = (long long)f * a.n_steps;
    const int *planes[3] = {a.Y, a.U, a.V};
    auto nb = [&](int p, int dd, int kk) -> const int * {
        const int size = p == 0 ? 256 : 64;
        if (dd < 0) return nullptr;
        if (kk >= 0) return planes[p] + ((row0 + dd) * a.lanes + kk) * size;
        if (a.k0 == 0) return nullptr;
        return a.halo + (row0 + dd) * HALO + (p == 0 ? 0 : 192 + 64 * p);
    };

    __shared__ int sR[16][16];
    __shared__ int sTop[16], sLeft[16], sTR[4], sTL;
    __shared__ int cTop[2][8], cLeft[2][8], cTL[2];
    const int *cres[2] = {a.resid_u, a.resid_v};
    int *cdst[2] = {a.U, a.V};

    const int y = tid / 16, x = tid % 16;
    sR[y][x] = 0;
    if (tid < 16) {
        const int *tp = nb(0, d - 2, k - 1), *lt = nb(0, d - 1, k);
        sTop[tid] = tp ? tp[15 * 16 + tid] : 0;
        sLeft[tid] = lt ? lt[tid * 16 + 15] : 0;
    } else if (tid < 20) {
        const int *tr = nb(0, d - 1, k - 1);
        sTR[tid - 16] = tr ? tr[15 * 16 + tid - 16] : 0;
    } else if (tid == 20) {
        const int *tl = nb(0, d - 3, k - 1);
        sTL = tl ? tl[255] : 0;
    } else if (tid >= 32 && tid < 64) {
        const int j = tid - 32, c = j / 16, i = j % 8;
        if (j % 16 < 8) {
            const int *tp = nb(1 + c, d - 2, k - 1);
            cTop[c][i] = tp ? tp[7 * 8 + i] : 0;
        } else {
            const int *lt = nb(1 + c, d - 1, k);
            cLeft[c][i] = lt ? lt[i * 8 + 7] : 0;
        }
    } else if (tid == 64 || tid == 65) {
        const int c = tid - 64;
        const int *tl = nb(1 + c, d - 3, k - 1);
        cTL[c] = tl ? tl[63] : 0;
    }
    __syncthreads();

    // ---- chroma: threads 0-127, sample (cy, cx) of plane c ----
    if (tid < 128) {
        const int c = tid / 64, cy = (tid % 64) / 8, cx = tid % 8;
        int t8[8], l8[8];
        for (int i = 0; i < 8; ++i) {
            t8[i] = at ? cTop[c][i] : 0;
            l8[i] = al ? cLeft[c][i] : 0;
        }
        const int tl = atl ? cTL[c] : 0;
        const int m = a.cmode[own];
        int pred;
        if (m == 0) {                                   // DC per quadrant
            const int bx = cx / 4, by = cy / 4;
            int ts = 0, ls = 0;
            for (int i = 0; i < 4; ++i) {
                ts += t8[4 * bx + i];
                ls += l8[4 * by + i];
            }
            if (bx == by)
                pred = dc_value(ts, ls, at, al, 2);
            else if (bx == 1)
                pred = at ? (ts + 2) >> 2 : al ? (ls + 2) >> 2 : 128;
            else
                pred = al ? (ls + 2) >> 2 : at ? (ts + 2) >> 2 : 128;
        } else if (m == 1) {
            pred = l8[cy];
        } else if (m == 2) {
            pred = t8[cx];
        } else {
            pred = plane_value(t8, l8, tl, 8, cy, cx);
        }
        const int v = clip255(pred + cres[c][own * 64 + cy * 8 + cx]);
        cdst[c][own * 64 + cy * 8 + cx] = v;
    }

    // ---- luma ----
    const int res = a.resid_y[own * 256 + tid];
    if (cls == 1) {                                     // Intra_16x16
        int t16[16], l16[16];
        for (int i = 0; i < 16; ++i) {
            t16[i] = at ? sTop[i] : 0;
            l16[i] = al ? sLeft[i] : 0;
        }
        const int m = a.i16[own];
        int pred;
        if (m == 0) {
            pred = t16[x];
        } else if (m == 1) {
            pred = l16[y];
        } else if (m == 2) {
            int st = 0, sl = 0;
            for (int i = 0; i < 16; ++i) {
                st += t16[i];
                sl += l16[i];
            }
            pred = dc_value(st, sl, at, al, 4);
        } else {
            pred = plane_value(t16, l16, atl ? sTL : 0, 16, y, x);
        }
        a.Y[own * 256 + tid] = clip255(pred + res);
        return;
    }

    // Intra_4x4: 16 sub-blocks in decode order
    for (int i = 0; i < 16; ++i) {
        const int bx = c_blk_x[i], by = c_blk_y[i];
        if (x >= bx && x < bx + 4 && y >= by && y < by + 4) {
            // n = [l3, l2, l1, l0, tl, t0 .. t7]
            int n[13];
            const int *above = by == 0 ? sTop : sR[by - 1];
            int t8[8];
            for (int j = 0; j < 4; ++j) t8[j] = above[bx + j];
            const int src = c_tr_src[i];
            for (int j = 0; j < 4; ++j) {
                int v;
                if (src == 3)
                    v = t8[3];
                else
                    v = bx < 12 ? above[bx + 4 + j] : sTR[j];
                if (src == 2 && !atr) v = t8[3];
                t8[4 + j] = v;
            }
            if (by == 0 && !at)
                for (int j = 0; j < 8; ++j) t8[j] = 0;
            int l4[4];
            for (int j = 0; j < 4; ++j)
                l4[j] = bx == 0 ? (al ? sLeft[by + j] : 0)
                                : sR[by + j][bx - 1];
            int tl;
            if (bx == 0 && by == 0)
                tl = atl ? sTL : 0;
            else if (by == 0)
                tl = at ? sTop[bx - 1] : 0;
            else if (bx == 0)
                tl = al ? sLeft[by - 1] : 0;
            else
                tl = sR[by - 1][bx - 1];
            for (int j = 0; j < 4; ++j) n[j] = l4[3 - j];
            n[4] = tl;
            for (int j = 0; j < 8; ++j) n[5 + j] = t8[j];

            const bool bt = by == 0 ? at : true, bl = bx == 0 ? al : true;
            const int m = a.modes[own * 16 + (by / 4) * 4 + bx / 4];
            int pred;
            if (m == 2) {                               // DC
                pred = dc_value(n[5] + n[6] + n[7] + n[8],
                                n[0] + n[1] + n[2] + n[3], bt, bl, 2);
            } else {
                const int p = (y - by) * 4 + (x - bx);
                const int *abc = c_i4_abc[min(max(m, 0), 8)];
                pred = (n[abc[p]] + 2 * n[abc[16 + p]] + n[abc[32 + p]] + 2)
                       >> 2;
            }
            sR[y][x] = clip255(pred + res);
        }
        __syncthreads();
    }
    a.Y[own * 256 + tid] = sR[y][x];
}

}  // namespace

// The tables from the host (int32): blk_x[16], blk_y[16], tr_src[16],
// i4_abc[9 * 48]. Call once per device before the first launch there.
// Returns the copies' cudaError_t (0 = success).
extern "C" int h264_intra_set_tables(const int *blk_x, const int *blk_y,
                                     const int *tr_src, const int *i4_abc) {
    cudaError_t e;
    if ((e = cudaMemcpyToSymbol(c_blk_x, blk_x, sizeof(c_blk_x)))) return e;
    if ((e = cudaMemcpyToSymbol(c_blk_y, blk_y, sizeof(c_blk_y)))) return e;
    if ((e = cudaMemcpyToSymbol(c_tr_src, tr_src, sizeof(c_tr_src))))
        return e;
    return cudaMemcpyToSymbol(c_i4_abc, i4_abc, sizeof(c_i4_abc));
}

// Reconstruct the diagonals d of [0, n_steps) whose walk[d] (host bytes;
// null: every diagonal) is set, in order, one launch each, in place on Y,
// U, V (layout above; has_inter: class 3 keeps its seeded tile; halo with
// k0 > 0 only, else null). Launches on `stream`, does not synchronise.
// Returns the first failed launch's cudaError_t, or 0.
extern "C" int h264_intra_launch(int *Y, int *U, int *V, const int *resid_y,
                                 const int *resid_u, const int *resid_v,
                                 const int *modes, const int *cls,
                                 const int *i16, const int *cmode,
                                 const int *a_l, const int *a_t,
                                 const int *a_tr, const int *valid,
                                 int has_inter, const uint8_t *walk,
                                 const int *halo, int k0, int nf,
                                 int n_steps, int lanes, int d0, int d1,
                                 void *stream) {
    IntraArgs a{Y, U, V, resid_y, resid_u, resid_v, modes, cls, i16,
                cmode, a_l, a_t, a_tr, valid, n_steps, lanes, has_inter,
                halo, k0};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    for (int d = d0; d < d1; ++d) {
        if (walk != nullptr && !walk[d]) continue;
        h264_intra_kernel<<<dim3(lanes, nf), 256, 0, s>>>(a, d);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    return 0;
}
