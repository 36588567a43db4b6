// H.264 intra reconstruction (spec 8.3) of skewed macroblock tiles: one
// persistent launch for the whole wavefront, the lanes chained by progress
// flags (lane_chain.cuh).
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
// (d-3, k-1) tiles. They are unfiltered samples: deblocking runs after the
// whole scan, as in jmcodec_tpu's split scans. A neighbour outside the
// diagonals (d < 0, or lane -1: lane 0 is the picture's top row, whose top
// availability is 0) reads as 0; the torch version's lane roll wraps there
// and masks it. A band of lanes (the row-sharded decode: rank i of n holds
// global lanes k0 .. k0 + lanes - 1) with k0 > 0 reads lane -1 from its
// halo, the lane above the band: halo [F, n_steps, 384] holds per diagonal
// that lane's Y tile (256), then U and V (64 each), all filled by the
// caller before the launch.
//
// What bounds it on this card: the chain, not the bytes. Macroblock (x, k)
// needs (x-1, k), (x, k-1) and (x+1, k-1) finished, so a scan is a chain of
// mbw + 2(mbh - 1) macroblock steps (254 at 1080p) whatever the batch, and
// a 1080p picture moves ~3.4 KB a macroblock. One launch a diagonal paid a
// launch, a ramp-up and a tail for every step of the chain. Here one launch
// walks the diagonals [d0, d1): a warp takes one (frame, lane) at a time
// and reconstructs its macroblocks in order, waiting before each one only
// until the lane above has finished the top-right macroblock (its flag >=
// d; only what the macroblock reads of it: nothing without a_t, d - 1
// without a_tr), so a step of the chain costs one macroblock's latency.
// Per macroblock:
//   - its residual, class, modes and availability are staged in
//     shared memory with cp.async while the macroblock before it is
//     computed (two buffers);
//   - the left column is this warp's previous macroblock, still in shared
//     memory; only when that tile was not reconstructed in this launch (an
//     inter macroblock, a skipped diagonal, the first of the walk) does it
//     come from device memory;
//   - the lane above's bottom row, top-right and top-left samples come
//     from device memory through L2 after the acquire;
//   - Intra_4x4 runs as a 10-step wavefront over its 16 sub-blocks (step
//     bx/4 + 2 by/4, at most two sub-blocks a step, one sample a thread,
//     the order in c_wave), its 16 modes packed in two registers and the
//     place of each sub-block's 13 neighbours in shared memory (or a 0
//     where one is not available) resolved before the first step; a
//     top-right that decode order makes unavailable stays so (c_tr_src),
//     even where the wavefront has computed it;
//   - Intra_16x16 and chroma take 12 samples a thread.
// With inter tiles (has_inter) a class 3 macroblock keeps its seeded inter
// tile, and an invalid lane or a diagonal the walk skips keeps its seed:
// the lane passes over them without a wait.
//
// The tables (the block scan BLK_X/BLK_Y, the top-right source of each
// block, the Intra_4x4 A/B/C neighbour indices per mode, the wavefront
// order) are set once per device from the port's numpy arrays
// (codec/h264/macroblock.py, kernels/recon.py, kernels/h264_scan.py) by
// h264_intra_set_tables.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_chain.cuh"

namespace {

using namespace lane_chain;

__constant__ int c_blk_x[16];
__constant__ int c_blk_y[16];
__constant__ int c_tr_src[16];       // 0 always, 1 a_t, 2 a_tr, 3 never
__constant__ int c_i4_abc[9][48];    // per mode: A[16], B[16], C[16]
__constant__ int c_wave[10][2];      // sub-blocks of each step, -1 none

struct IntraArgs {
    int *Y, *U, *V;
    const int *resid_y, *resid_u, *resid_v, *modes;
    const int *cls, *i16, *cmode, *a_l, *a_t, *a_tr, *valid;
    int nf, n_steps, lanes, has_inter;
    const int *halo;            // [F, n_steps, 384], or null (k0 == 0)
    int k0, d0, d1;
    int *flags;                 // [F * lanes] progress
    int *ticket;                // the lanes' hand-out counter
    const int *walk;            // [n_steps] 0/1, or null: every diagonal
};

// the halo's packing of one tile: Y, then U, then V
constexpr int HALO = 256 + 64 + 64;

// one macroblock's inputs, staged by cp.async
struct Stage {
    int res_y[256];
    int res_c[128];             // U, then V
    int modes[16];
    int sc[8];                  // cls, i16, cmode, a_l, a_t, a_tr
};

// the samples a macroblock's luma reads, in one array: its own
// reconstruction R (row-major), then above it T (Y row 15, U row 7, V row
// 7 of the tile above), left of it L (Y column 15, U column 7, V column 7
// of the left tile) and X (the top-right tile's Y row 15 [0..3], the
// top-left tiles' last Y, U and V samples), each 0 where not available
constexpr int T_OFF = 256, L_OFF = 288, X_OFF = 320;

struct Smem {
    Stage st[2];
    int U[X_OFF + 16];
    int C[128];                 // chroma: U, then V
    unsigned short nidx[16][14];  // i4_source of each sub-block's 13
    int abc[9 * 16];            // A | B << 4 | C << 8 per mode and sample
    int wave[10][2];            // blk | bx << 8 | by << 16 | src << 24, -1
};

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

// plane prediction (8.3.3.4 for size 16, 8.3.4.4 for 8) from the top row
// t and the left column l (0 where not available) and the corner tl: its
// (a, b, c), once a macroblock, then plane_at for each sample
__device__ int3 plane_params(const int *t, bool at, const int *l, bool al,
                             int tl, int size) {
    const int half = size / 2;
    int gh = 0, gv = 0;
    for (int i = 0; i < half; ++i) {
        const int tb = i == half - 1 ? tl : (at ? t[half - 2 - i] : 0);
        const int lb = i == half - 1 ? tl : (al ? l[half - 2 - i] : 0);
        gh += (i + 1) * ((at ? t[half + i] : 0) - tb);
        gv += (i + 1) * ((al ? l[half + i] : 0) - lb);
    }
    const int a = 16 * ((al ? l[size - 1] : 0) + (at ? t[size - 1] : 0));
    if (size == 16)
        return make_int3(a, (5 * gh + 32) >> 6, (5 * gv + 32) >> 6);
    return make_int3(a, (17 * gh + 16) >> 5, (17 * gv + 16) >> 5);
}

__device__ __forceinline__ int plane_at(int3 p, int size, int y, int x) {
    const int ramp = size / 2 - 1;
    return clip255((p.x + p.y * (x - ramp) + p.z * (y - ramp) + 16) >> 5);
}

// Where neighbour i of the Intra_4x4 sub-block at (bx, by) with top-right
// source src lies in Smem::U: n = [l3, l2, l1, l0, tl, t0 .. t7]
// (8.3.1.2). The same for every macroblock: what is not available is in
// the data (T, L, X hold 0 there, and X's top-right t3 where the top
// macroblock is available and the top-right one is not); a top-right that
// decode order makes unavailable (src 3) is t3 of the row above.
__device__ int i4_source(int i, int bx, int by, int src) {
    if (i < 4) {
        const int row = by + 3 - i;
        return bx == 0 ? L_OFF + row : row * 16 + bx - 1;
    }
    if (i == 4) {
        if (bx == 0 && by == 0) return X_OFF + 4;
        if (by == 0) return T_OFF + bx - 1;
        if (bx == 0) return L_OFF + by - 1;
        return (by - 1) * 16 + bx - 1;
    }
    const int above = by == 0 ? T_OFF : (by - 1) * 16;
    if (i < 9) return above + bx + i - 5;
    if (src == 3) return above + bx + 3;
    return bx < 12 ? above + bx + 4 + i - 9 : X_OFF + i - 9;
}

// Stage tile `own`'s inputs into st (cp.async, not committed).
__device__ void prefetch(const IntraArgs &a, Stage &st, long long own) {
    const int t = threadIdx.x;
    cp16(st.res_y + 4 * t, a.resid_y + own * 256 + 4 * t);
    cp16(st.res_y + 128 + 4 * t, a.resid_y + own * 256 + 128 + 4 * t);
    cp16(st.res_c + 4 * t, t < 16 ? a.resid_u + own * 64 + 4 * t
                                  : a.resid_v + own * 64 + 4 * (t - 16));
    if (t < 4) {
        cp16(st.modes + 4 * t, a.modes + own * 16 + 4 * t);
    } else if (t < 10) {
        const int *src = t == 4 ? a.cls : t == 5 ? a.i16 : t == 6 ? a.cmode
                         : t == 7 ? a.a_l : t == 8 ? a.a_t : a.a_tr;
        cp4(st.sc + t - 4, src + own);
    }
}

// Reconstruct tile (d, k) of frame f (flat index own) from its staged
// inputs; have_left: this warp reconstructed tile (d-1, k) just before, so
// R and C hold it; above: the lane above's flag (null: none in this launch).
__device__ void macroblock(const IntraArgs &a, Smem &s, const Stage &st,
                           int f, int d, int k, long long own,
                           bool have_left, const int *above) {
    const int t = threadIdx.x;
    SCAN_STAMP(0);
    SCAN_COUNT();
    const int cls = st.sc[0];
    const bool al = st.sc[3] == 1, at = st.sc[4] == 1, atr = st.sc[5] == 1,
               atl = at && al;
    const long long row0 = (long long)f * a.n_steps;
    // a neighbour's tile in plane p (0 Y, 1 U, 2 V): (dd, kk) of the
    // diagonals, lane -1 from the halo when the band has one; null where
    // outside them (reads as 0)
    auto nb = [&](int p, int dd, int kk) -> const int * {
        if (dd < 0) return nullptr;
        if (kk >= 0) {
            const int *plane = p == 0 ? a.Y : p == 1 ? a.U : a.V;
            return plane + ((row0 + dd) * a.lanes + kk) * (p == 0 ? 256 : 64);
        }
        if (a.k0 == 0) return nullptr;
        return a.halo + (row0 + dd) * HALO + (p == 0 ? 0 : 192 + 64 * p);
    };
    // sample t of the 32 of a tile's last row (Y 16, U 8, V 8) or last
    // column: plane and offset in the tile
    const int p = t < 16 ? 0 : t < 24 ? 1 : 2;
    const int j = t < 16 ? t : (t - 16) & 7;
    const int n = p == 0 ? 16 : 8;
    int *R = s.U, *T = s.U + T_OFF, *L = s.U + L_OFF, *X = s.U + X_OFF;

    // the left column: this warp's previous macroblock, or device memory
    int lv = 0;
    if (al) {
        if (have_left) {
            lv = t < 16 ? R[t * 16 + 15] : s.C[(t - 16) * 8 + 7];
        } else {
            const int *lt = nb(p, d - 1, k);
            lv = lt ? __ldcg(lt + j * n + n - 1) : 0;
        }
    }
    // the modes in two registers, 4 bits each, by the sub-block's place
    // (by/4) * 4 + bx/4 (clamped as the table's index; 2, DC, stays 2)
    unsigned mlo = 0, mhi = 0;
    if (cls != 1)
        for (int b = 0; b < 8; ++b) {
            mlo |= (unsigned)min(max(st.modes[b], 0), 8) << (4 * b);
            mhi |= (unsigned)min(max(st.modes[8 + b], 0), 8) << (4 * b);
        }

    // the lane above: wait until it has finished what this macroblock
    // reads of it (tiles of diagonals below `need`), then read through L2
    SCAN_STAMP(1);
    const int need = at ? (atr ? d : d - 1) : 0;
    if (above != nullptr && need > a.d0) wait_progress(above, need);
    SCAN_STAMP(2);
    int tv = 0, xv = 0;
    if (at) {
        const int *tp = nb(p, d - 2, k - 1);
        tv = tp ? __ldcg(tp + (n - 1) * n + j) : 0;
    }
    if (t < 4 && at && atr) {
        const int *tr = nb(0, d - 1, k - 1);
        xv = tr ? __ldcg(tr + 15 * 16 + t) : 0;
    } else if (t < 4 && at) {
        xv = -1;                // the top-right MB unavailable: t3, below
    } else if (t >= 4 && t < 7 && atl) {
        const int *tl = nb(t - 4, d - 3, k - 1);
        xv = tl ? __ldcg(tl + (t == 4 ? 255 : 63)) : 0;
    }
    __syncwarp();               // R and C are read: they may be rewritten
    const int t3 = __shfl_sync(FULL, tv, 15);       // the top row's last
    L[t] = lv;
    T[t] = tv;
    if (t < 7) X[t] = xv == -1 ? t3 : xv;
    __syncwarp();
    SCAN_STAMP(3);

    // ---- chroma: plane c = t / 16, samples (t % 16) + 16 q ----
    {
        const int c = t >> 4, cx = t & 7, m = st.sc[2];
        const int *t8 = T + 16 + 8 * c, *l8 = L + 16 + 8 * c;
        // DC of this thread's two quadrants, (cx / 4, 0) and (cx / 4, 1)
        int dc0 = 0, dc1 = 0;
        int3 pl = make_int3(0, 0, 0);
        if (m == 0) {
            const int bx = cx >> 2;
            int ts = 0, ls0 = 0, ls1 = 0;
            for (int j = 0; j < 4; ++j) {
                ts += at ? t8[4 * bx + j] : 0;
                ls0 += al ? l8[j] : 0;
                ls1 += al ? l8[4 + j] : 0;
            }
            const int top = at ? (ts + 2) >> 2 : -1;
            dc0 = bx == 0 ? dc_value(ts, ls0, at, al, 2)
                          : top >= 0 ? top : al ? (ls0 + 2) >> 2 : 128;
            dc1 = bx == 1 ? dc_value(ts, ls1, at, al, 2)
                          : al ? (ls1 + 2) >> 2 : top >= 0 ? top : 128;
        } else if (m == 3) {
            pl = plane_params(t8, at, l8, al, atl ? X[5 + c] : 0, 8);
        }
        for (int q = 0; q < 4; ++q) {         // rows cy / 4 = q / 2
            const int cy = ((t & 15) >> 3) + 2 * q, i = 64 * c + 8 * cy + cx;
            const int pred = m == 0 ? (q < 2 ? dc0 : dc1)
                             : m == 1 ? (al ? l8[cy] : 0)
                             : m == 2 ? (at ? t8[cx] : 0)
                                      : plane_at(pl, 8, cy, cx);
            s.C[i] = clip255(pred + st.res_c[i]);
        }
    }

    SCAN_STAMP(4);
    // ---- luma ----
    if (cls == 1) {                                     // Intra_16x16
        const int m = st.sc[1];
        int dc = 0;
        if (m == 2) {
            int sum_t = 0, sum_l = 0;
            for (int i = 0; i < 16; ++i) {
                sum_t += at ? T[i] : 0;
                sum_l += al ? L[i] : 0;
            }
            dc = dc_value(sum_t, sum_l, at, al, 4);
        }
        const int3 pl = m == 3 ? plane_params(T, at, L, al,
                                              atl ? X[4] : 0, 16)
                               : make_int3(0, 0, 0);
        for (int q = 0; q < 8; ++q) {
            const int i = t + 32 * q, y = i >> 4, x = i & 15;
            const int pred = m == 0 ? (at ? T[x] : 0)
                             : m == 1 ? (al ? L[y] : 0)
                             : m == 2 ? dc : plane_at(pl, 16, y, x);
            R[i] = clip255(pred + st.res_y[i]);
        }
    } else {                                            // Intra_4x4
        const int half = t >> 4, ps = t & 15;
        for (int step = 0; step < 10; ++step) {
            const int w = s.wave[step][half];
            if (w >= 0) {
                const int bx = (w >> 8) & 255, by = (w >> 16) & 255;
                const unsigned short *ni = s.nidx[w & 255];
                const int at4 = (by >> 2) * 4 + (bx >> 2);
                const int m = ((at4 < 8 ? mlo >> (4 * at4)
                                        : mhi >> (4 * (at4 - 8)))) & 15;
                const int y = by + (ps >> 2), x = bx + (ps & 3);
                int pred;
                if (m == 2) {
                    pred = dc_value(s.U[ni[5]] + s.U[ni[6]] + s.U[ni[7]]
                                        + s.U[ni[8]],
                                    s.U[ni[0]] + s.U[ni[1]] + s.U[ni[2]]
                                        + s.U[ni[3]],
                                    by == 0 ? at : true,
                                    bx == 0 ? al : true, 2);
                } else {
                    const int abc = s.abc[m * 16 + ps];
                    pred = (s.U[ni[abc & 15]] + 2 * s.U[ni[(abc >> 4) & 15]]
                            + s.U[ni[abc >> 8]] + 2) >> 2;
                }
                R[y * 16 + x] = clip255(pred + st.res_y[y * 16 + x]);
            }
            __syncwarp();
        }
    }
    __syncwarp();

    SCAN_STAMP(5);
    // ---- out first: the last rows, all the lane below reads ----
    if (t < 8) {
        // Y row 15 (4 x 16 B), then U and V row 7 (2 x 16 B each)
        const int q = t < 4 ? 60 + t : 14 + (t & 1);
        int *g = t < 4 ? a.Y + own * 256 : (t < 6 ? a.U : a.V) + own * 64;
        const int *r = t < 4 ? R : s.C + (t < 6 ? 0 : 64);
        reinterpret_cast<int4 *>(g)[q] = reinterpret_cast<const int4 *>(r)[q];
    }
}

// The rest of tile `own` (stored after the flag: only the lane below reads
// a tile during the launch, and only its last rows).
__device__ void store_tile(const IntraArgs &a, const Smem &s, long long own) {
    const int t = threadIdx.x;
    int4 *gy = reinterpret_cast<int4 *>(a.Y + own * 256);
    const int4 *sy = reinterpret_cast<const int4 *>(s.U);
    gy[t] = sy[t];
    if (t < 28) gy[t + 32] = sy[t + 32];
    if ((t & 15) < 14) {
        int *gc = (t < 16 ? a.U : a.V) + own * 64 + 4 * (t & 15);
        *reinterpret_cast<int4 *>(gc) = reinterpret_cast<const int4 *>(s.C)[t];
    }
}

__global__ void __launch_bounds__(32, 32) h264_intra_kernel(IntraArgs a) {
    __shared__ __align__(16) Smem s;
    const int t = threadIdx.x;
    for (int i = t; i < 9 * 16; i += 32) {
        const int m = i / 16, q = i % 16;
        s.abc[i] = c_i4_abc[m][q] | c_i4_abc[m][16 + q] << 4
                   | c_i4_abc[m][32 + q] << 8;
    }
    if (t < 20) {
        const int blk = c_wave[t / 2][t % 2];
        s.wave[t / 2][t % 2] = blk < 0 ? -1
            : blk | c_blk_x[blk] << 8 | c_blk_y[blk] << 16
                  | c_tr_src[blk] << 24;
    }
    for (int e = t; e < 16 * 13; e += 32)
        s.nidx[e / 13][e % 13] = static_cast<unsigned short>(i4_source(
            e % 13, c_blk_x[e / 13], c_blk_y[e / 13], c_tr_src[e / 13]));
    __syncwarp();
    SCAN_TIMING_BEGIN();

    const int total = a.nf * a.lanes;
    for (int id = next_lane(a.ticket); id < total; id = next_lane(a.ticket)) {
        const int f = id / a.lanes, k = id % a.lanes;
        const long long row0 = (long long)f * a.n_steps;
        auto own_of = [&](int d) { return (row0 + d) * a.lanes + k; };
        // a tile this launch reconstructs: valid, on a walked diagonal,
        // and not an inter macroblock of a P picture
        auto work = [&](int d) {
            if (__ldg(a.valid + d * a.lanes + k) != 1) return false;
            if (a.walk != nullptr && __ldcg(a.walk + d) == 0) return false;
            return !(a.has_inter && __ldg(a.cls + own_of(d)) == 3);
        };
        int *flag = a.flags + id;
        const int *above = k > 0 ? flag - 1 : nullptr;
        Diagonals diags(a.d0, a.d1);
        int cur = diags.next(a.d0, work);
        publish(flag, cur < 0 ? a.d1 : cur);    // nothing to do below cur
        if (cur < 0) continue;
        prefetch(a, s.st[0], own_of(cur));
        commit();
        int buf = 0, prev = -2;
        while (cur >= 0) {
            const int nxt = diags.next(cur + 1, work);
            SCAN_STAMP(8);
            if (nxt >= 0) prefetch(a, s.st[buf ^ 1], own_of(nxt));
            commit();
            SCAN_STAMP(9);
            wait_groups(nxt >= 0 ? 1 : 0);
            __syncwarp();
            SCAN_STAMP(10);
            macroblock(a, s, s.st[buf], f, cur, k, own_of(cur),
                       prev == cur - 1, above);
            publish(flag, nxt < 0 ? a.d1 : nxt);
            SCAN_STAMP(6);
            store_tile(a, s, own_of(cur));
            SCAN_STAMP(7);
            prev = cur;
            cur = nxt;
            buf ^= 1;
        }
    }
    SCAN_TIMING_END();
}

int g_resident[64];

}  // namespace

SCAN_TIMING_READER(h264_intra_cycles)

// The tables from the host (int32): blk_x[16], blk_y[16], tr_src[16],
// i4_abc[9 * 48], wave[10 * 2]. Call once per device before the first
// launch there. Returns the copies' cudaError_t (0 = success).
extern "C" int h264_intra_set_tables(const int *blk_x, const int *blk_y,
                                     const int *tr_src, const int *i4_abc,
                                     const int *wave) {
    cudaError_t e;
    if ((e = cudaMemcpyToSymbol(c_blk_x, blk_x, sizeof(c_blk_x)))) return e;
    if ((e = cudaMemcpyToSymbol(c_blk_y, blk_y, sizeof(c_blk_y)))) return e;
    if ((e = cudaMemcpyToSymbol(c_tr_src, tr_src, sizeof(c_tr_src))))
        return e;
    if ((e = cudaMemcpyToSymbol(c_wave, wave, sizeof(c_wave)))) return e;
    return cudaMemcpyToSymbol(c_i4_abc, i4_abc, sizeof(c_i4_abc));
}

// Reconstruct the diagonals [d0, d1) (those walk marks, a device array
// [n_steps] of 0/1; null: all) in one launch, in place on Y, U, V (layout
// above; has_inter: class 3 keeps its seeded tile; halo with k0 > 0 only,
// else null). flags [nf * lanes] and *ticket are scratch: the ticket 0,
// each flag at most d0 (zeros, or what an earlier launch of the same scan
// on diagonals below d0 left). Launches min(nf * lanes, the CTAs that fit
// the card) CTAs of one warp on `stream`, does not synchronise. Returns the
// launch's cudaError_t, or 0.
extern "C" int h264_intra_launch(int *Y, int *U, int *V, const int *resid_y,
                                 const int *resid_u, const int *resid_v,
                                 const int *modes, const int *cls,
                                 const int *i16, const int *cmode,
                                 const int *a_l, const int *a_t,
                                 const int *a_tr, const int *valid,
                                 int has_inter, const int *walk,
                                 const int *halo, int k0, int *flags,
                                 int *ticket, int nf, int n_steps, int lanes,
                                 int d0, int d1, void *stream) {
    IntraArgs a{Y, U, V, resid_y, resid_u, resid_v, modes, cls, i16,
                cmode, a_l, a_t, a_tr, valid, nf, n_steps, lanes,
                has_inter, halo, k0, d0, d1, flags, ticket, walk};
    cudaError_t e = cudaSuccess;
    const int cap = lane_chain::resident_ctas(h264_intra_kernel, 32,
                                              g_resident, &e);
    if (cap == 0) return e;
    const int grid = nf * lanes < cap ? nf * lanes : cap;
    h264_intra_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return cudaGetLastError();
}
