// H.264 in-loop deblocking (spec 8.7) of skewed macroblock tiles, in
// place: one persistent launch for the whole wavefront, the lanes chained
// by progress flags (lane_chain.cuh).
//
// Replaces the deblock wavefront that jmcodec_tpu runs as a jax.lax.scan on
// the device (kernels/recon_tiles.py: _deblock_tile_scan, body
// _deblock_step, and the all-intra _deblock_tile_scan_intra); its plain
// torch version is recon_tiles._deblock_tile_scan. Layout (int32):
//     Y [F, n_steps, lanes, 16, 16], U and V [F, n_steps, lanes, 8, 8]
//     qp [F, n_steps, lanes]; valid [n_steps, lanes]
//     bs_v, bs_h [Fb, n_steps, lanes, 4 (edge), 4 (sub-edge)], Fb = F or 1
//     (a frame stride of 0 broadcasts the all-intra pattern over a batch)
//     alpha_off, beta_off, chroma_qp_off, second_chroma_qp_off [F]
// Tile (t, k) is macroblock (mx, my) = (t - 2k, k). Its deblock filters
// luma vertical edges 0, 4, 8, 12, then horizontal edges 0, 4, 8, 12;
// chroma edges 0 and 4 (luma edges 0 and 2's bS) each way. Edge 0 is the
// macroblock boundary: against the left tile (t-1, k) and the top tile
// (t-2, k-1), whose last four columns / rows it rewrites, with
// indexA/indexB from the averaged QP; inside the macroblock, from its own
// QP.
//
// A band of lanes (the row-sharded decode: rank i of n holds global lanes
// k0 .. k0 + lanes - 1): macroblock (mx, my) = (t - 2(k0 + k), k0 + k), and
// with k0 > 0 the top tile of local lane 0 is the band's halo, the lane
// above it: halo [F, n_steps, 384] holds per diagonal that lane's Y tile
// (256), then U and V (64 each), hqp [F, n_steps] its QP, filled by the
// caller before the launch; this kernel filters the halo's last rows in
// place, as it does a top tile of its own (kernels/h264_scan.py hands them
// back).
//
// Order: (x, k)'s top edge rewrites rows 12-15 of (x, k-1), whose columns
// 13-15 (x+1, k-1)'s left edge rewrites first in the spec's raster order;
// so a lane waits before each macroblock until the lane above has finished
// the macroblock above-right (its flag >= t). Nothing else is shared: a
// lane's left tile is its own previous macroblock, and the lane below
// touches this lane's tile only once this lane is past the next one. The
// picture's lane 0 has no macroblock above it and a lane's macroblock with
// mx == 0 none to its left: those edges are never filtered and nothing
// outside the diagonals is read (the torch version rolls lanes, wrapping
// lane 0 to the last lane, and masks the result with bS 0 there).
//
// What bounds it on this card: the chain, not the bytes. A scan is a chain
// of mbw + 2(mbh - 1) macroblock steps (254 at 1080p) whatever the batch,
// each ~4.6 KB of tiles and ~8,000 integer operations. One launch a
// diagonal paid a launch, a ramp-up and a tail for every step. Here one
// launch walks the diagonals [t0, t1): a warp takes one (frame, lane) at a
// time and deblocks its macroblocks in order. Per macroblock:
//   - its tile, QPs and bS are staged in shared memory with cp.async while
//     the macroblock before it is filtered (two buffers of the 20x20 luma
//     and 10x10 chroma neighbourhoods);
//   - the left tile's last columns are the warp's previous macroblock's,
//     copied within shared memory; only the first macroblock of a walk in
//     a launch reads them from device memory;
//   - only the top tile's last rows come from device memory, through L2
//     after the acquire; the vertical edges, which touch only this tile
//     and the left one, are filtered before the wait;
//   - one thread per line of an edge (0-15 luma, 16-23 Cb, 24-31 Cr), a
//     __syncwarp() between the 8 edge phases.
//
// The tables (alpha, beta, tc0, the chroma QP map) are set once per device
// from the port's own numpy arrays (ops/deblock.py, ops/transform.py) by
// h264_deblock_set_tables.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_chain.cuh"

namespace {

using namespace lane_chain;

__constant__ int c_alpha[52];
__constant__ int c_beta[52];
__constant__ int c_tc0[3][52];
__constant__ int c_chroma_qp[52];

struct DeblockArgs {
    int *Y, *U, *V;
    const int *qp, *valid;
    const int *alpha_off, *beta_off, *cqp_off, *cqp2_off;
    const int *bs_v, *bs_h;
    long long bs_fstride;
    int nf, n_steps, lanes;
    int *halo;                  // [F, n_steps, 384], or null (k0 == 0)
    const int *hqp;             // [F, n_steps]
    int k0, t0, t1;
    int *flags;                 // [F * lanes] progress
    int *ticket;                // the lanes' hand-out counter
};

// the halo's packing of one tile: Y, then U, then V
constexpr int HALO = 256 + 64 + 64;

// luma staging: rows 0-3 the top tile's rows 12-15, columns 0-3 the left
// tile's columns 12-15, [4 + y][4 + x] the macroblock's own sample (y, x)
constexpr int LS = 20;
// chroma staging, per plane, 10 rows of 12: rows 0-1 the top tile's rows
// 6-7, columns 2-3 the left tile's columns 6-7, [2 + y][4 + x] the own
// sample (y, x) (every own row 16-byte aligned)
constexpr int CS = 12;

// one macroblock's neighbourhood and inputs
struct Stage {
    int y[LS * LS];
    int c[2][10 * CS];
    int bs[32];                 // bs_v [edge][sub-edge], then bs_h
    int qp[4];                  // own, left, top
};

__device__ __forceinline__ int clip3(int lo, int hi, int x) {
    return min(max(x, lo), hi);
}

__device__ __forceinline__ int clip51(int x) { return clip3(0, 51, x); }

// One luma line across an edge: q points at q0, st is the distance between
// two samples across the edge (8.7.2.3 for bS < 4, 8.7.2.4 for bS == 4).
__device__ void filter_luma(int *q, int st, int bs, int ia, int ib) {
    if (bs <= 0) return;
    const int p0 = q[-st], p1 = q[-2 * st], p2 = q[-3 * st], p3 = q[-4 * st];
    const int q0 = q[0], q1 = q[st], q2 = q[2 * st], q3 = q[3 * st];
    const int alpha = c_alpha[ia], beta = c_beta[ib];
    if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta
          && abs(q1 - q0) < beta))
        return;
    const bool ap = abs(p2 - p0) < beta, aq = abs(q2 - q0) < beta;
    if (bs != 4) {
        const int tc0 = c_tc0[min(bs, 3) - 1][ia];
        const int tc = tc0 + ap + aq;
        const int delta =
            clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
        const int avg = (p0 + q0 + 1) >> 1;
        q[-st] = clip3(0, 255, p0 + delta);
        q[0] = clip3(0, 255, q0 - delta);
        if (ap) q[-2 * st] = p1 + clip3(-tc0, tc0, (p2 + avg - 2 * p1) >> 1);
        if (aq) q[st] = q1 + clip3(-tc0, tc0, (q2 + avg - 2 * q1) >> 1);
        return;
    }
    const bool strong = abs(p0 - q0) < ((alpha >> 2) + 2);
    if (ap && strong) {
        q[-st] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
        q[-2 * st] = (p2 + p1 + p0 + q0 + 2) >> 2;
        q[-3 * st] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
        q[-st] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (aq && strong) {
        q[0] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
        q[st] = (q2 + q1 + q0 + p0 + 2) >> 2;
        q[2 * st] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
        q[0] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
}

// One chroma line across an edge (8.7.2.3 / 8.7.2.4 with chromaEdgeFlag).
__device__ void filter_chroma(int *q, int st, int bs, int ia, int ib) {
    if (bs <= 0) return;
    const int p0 = q[-st], p1 = q[-2 * st], q0 = q[0], q1 = q[st];
    if (!(abs(p0 - q0) < c_alpha[ia] && abs(p1 - p0) < c_beta[ib]
          && abs(q1 - q0) < c_beta[ib]))
        return;
    if (bs == 4) {
        q[-st] = (2 * p1 + p0 + q1 + 2) >> 2;
        q[0] = (2 * q1 + q0 + p1 + 2) >> 2;
        return;
    }
    const int tc = c_tc0[min(bs, 3) - 1][ia] + 1;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    q[-st] = clip3(0, 255, p0 + delta);
    q[0] = clip3(0, 255, q0 - delta);
}

// Tile (t, k)'s top tile in plane p (0 Y, 1 U, 2 V): (t-2, k-1), or for
// lane 0 of a band the halo's tile t-2.
__device__ __forceinline__ int *top_tile(const DeblockArgs &a, int p, int f,
                                         int t, int k, long long own) {
    if (k > 0) {
        int *plane = p == 0 ? a.Y : p == 1 ? a.U : a.V;
        return plane + (own - 2 * a.lanes - 1) * (p == 0 ? 256 : 64);
    }
    return a.halo + ((long long)f * a.n_steps + t - 2) * HALO
           + (p == 0 ? 0 : 192 + 64 * p);
}

// Stage tile (t, k)'s own samples, bS and QPs into st (cp.async, not
// committed). Nothing writes them before this lane's deblock of the tile.
__device__ void prefetch(const DeblockArgs &a, Stage &st, int f, int t,
                         int k, long long own) {
    const int i = threadIdx.x;
    for (int q = i; q < 64; q += 32)            // 16 rows of 4 x 16 B
        cp16(st.y + (4 + q / 4) * LS + 4 + 4 * (q % 4),
             a.Y + own * 256 + q * 4);
    {                                           // 2 planes x 8 rows x 2
        const int p = i / 16, r = (i % 16) / 2, h = i % 2;
        cp16(st.c[p] + (2 + r) * CS + 4 + 4 * h,
             (p == 0 ? a.U : a.V) + own * 64 + r * 8 + 4 * h);
    }
    const int my = a.k0 + k;
    if (i < 8) {
        const int *bs = (i < 4 ? a.bs_v : a.bs_h) + f * a.bs_fstride
                        + ((long long)t * a.lanes + k) * 16;
        cp16(st.bs + 4 * i, bs + 4 * (i % 4));
    } else if (i == 8) {
        cp4(st.qp, a.qp + own);
    } else if (i == 9 && t - 2 * my > 0) {
        cp4(st.qp + 1, a.qp + own - a.lanes);
    } else if (i == 10 && my > 0) {
        cp4(st.qp + 2, k > 0 ? a.qp + own - 2 * a.lanes - 1
                             : a.hqp + (long long)f * a.n_steps + t - 2);
    }
}

// Deblock tile (t, k) of frame f (flat index own) in its stage S; have_left:
// S's columns left of the tile already hold the left tile's last columns
// (the warp's previous macroblock). above: the lane above's flag (null:
// none in this launch). offs: the frame's alpha, beta, chroma and second
// chroma QP offsets.
__device__ void macroblock(const DeblockArgs &a, Stage &S, int f, int t,
                           int k, long long own, bool have_left,
                           const int *above, int4 offs) {
    const int i = threadIdx.x;
    SCAN_STAMP(0);
    SCAN_COUNT();
    const int my = a.k0 + k;
    const bool left = t - 2 * my > 0;       // mx > 0: the left MB exists
    const bool top = my > 0;                // my > 0: the top MB exists
    const long long lt = own - a.lanes;                 // (t-1, k)
    int *planes[2] = {a.U, a.V};

    if (left && !have_left) {       // the left tile from device memory
        if (i < 16) {
            *reinterpret_cast<int4 *>(S.y + (4 + i) * LS) =
                __ldcg(reinterpret_cast<const int4 *>(
                    a.Y + lt * 256 + i * 16 + 12));
        } else {
            const int p = (i - 16) / 8, r = (i - 16) % 8;
            *reinterpret_cast<int2 *>(S.c[p] + (2 + r) * CS + 2) =
                __ldcg(reinterpret_cast<const int2 *>(
                    planes[p] + lt * 64 + r * 8 + 6));
        }
    }
    // indexA / indexB: edge 0 from the averaged QP, inside from our own
    const int qp = S.qp[0];
    const int q_nb[2] = {left ? S.qp[1] : 0, top ? S.qp[2] : 0};
    const bool luma = i < 16;
    const int c = (i - 16) / 8;             // chroma plane of threads 16-31
    const int line = luma ? i : (i - 16) % 8;
    int q_in, q_edge[2];
    if (luma) {
        q_in = qp;
        q_edge[0] = (qp + q_nb[0] + 1) >> 1;
        q_edge[1] = (qp + q_nb[1] + 1) >> 1;
    } else {
        const int off = c == 0 ? offs.z : offs.w;
        q_in = c_chroma_qp[clip51(qp + off)];
        q_edge[0] = (q_in + c_chroma_qp[clip51(q_nb[0] + off)] + 1) >> 1;
        q_edge[1] = (q_in + c_chroma_qp[clip51(q_nb[1] + off)] + 1) >> 1;
    }
    // the four edges of one direction (dir 0: vertical edges 0, 4, 8, 12;
    // 1: horizontal). Chroma takes the first two (its edges 0 and 4 with
    // luma edges 0 and 2's bS).
    auto edges = [&](int dir, bool nb_exists) {
        for (int e = 0; e < 4; ++e) {
            if (e > 0 || nb_exists) {
                const int q = e == 0 ? q_edge[dir] : q_in;
                const int *bs = S.bs + 16 * dir;
                const int ia = clip51(q + offs.x), ib = clip51(q + offs.y);
                if (luma) {
                    int *p = dir == 0 ? &S.y[(4 + line) * LS + 4 + 4 * e]
                                      : &S.y[(4 + 4 * e) * LS + 4 + line];
                    filter_luma(p, dir == 0 ? 1 : LS, bs[e * 4 + line / 4],
                                ia, ib);
                } else if (e < 2) {
                    int *p = dir == 0 ? &S.c[c][(2 + line) * CS + 4 + 4 * e]
                                      : &S.c[c][(2 + 4 * e) * CS + 4 + line];
                    filter_chroma(p, dir == 0 ? 1 : CS,
                                  bs[2 * e * 4 + line / 2], ia, ib);
                }
            }
            __syncwarp();
        }
    };
    // The vertical edges touch only this tile and the left one: they run
    // before the wait on the lane above. The left tile is final then; its
    // rows 12-15, which the lane below reads next, go out first (its
    // columns 12-15 / 6-7 changed here), so that they are stored by the
    // time this macroblock's flag goes out.
    __syncwarp();
    edges(0, left);
    if (left && i < 8) {
        if (i < 4) {
            *reinterpret_cast<int4 *>(a.Y + lt * 256 + (12 + i) * 16 + 12) =
                *reinterpret_cast<const int4 *>(S.y + (16 + i) * LS);
        } else {
            const int p = (i - 4) / 2, r = 6 + (i - 4) % 2;
            *reinterpret_cast<int2 *>(planes[p] + lt * 64 + r * 8 + 6) =
                *reinterpret_cast<const int2 *>(S.c[p] + (2 + r) * CS + 2);
        }
    }

    // the top tile once the lane above is past (t-1, k-1)
    SCAN_STAMP(1);
    if (top) {
        if (above != nullptr && t - 1 >= a.t0) wait_progress(above, t);
        SCAN_STAMP(2);
        if (i < 16) {                           // rows 12-15, 4 x 16 B each
            *reinterpret_cast<int4 *>(S.y + (i / 4) * LS + 4 + 4 * (i % 4)) =
                __ldcg(reinterpret_cast<const int4 *>(
                    top_tile(a, 0, f, t, k, own) + 192 + 4 * i));
        } else if (i < 24) {                    // rows 6-7, 2 x 16 B each
            const int p = (i - 16) / 4, q = (i - 16) % 4;
            *reinterpret_cast<int4 *>(S.c[p] + (q / 2) * CS + 4 + 4 * (q % 2))
                = __ldcg(reinterpret_cast<const int4 *>(
                    top_tile(a, 1 + p, f, t, k, own) + 48 + 4 * q));
        }
    }
    __syncwarp();
    SCAN_STAMP(3);
    edges(1, top);
    SCAN_STAMP(4);
}

// The rest of tile (t, k)'s deblock out of its stage S, stored after the
// flag: the tile, the left tile's columns, the top tile's rows (no other
// lane reads them before this lane's next flag, which orders them first).
__device__ void store_rest(const DeblockArgs &a, const Stage &S, int f,
                           int t, int k, long long own) {
    const int i = threadIdx.x;
    const int my = a.k0 + k;
    int *planes[2] = {a.U, a.V};
    for (int q = i; q < 64; q += 32)
        *reinterpret_cast<int4 *>(a.Y + own * 256 + q * 4) =
            *reinterpret_cast<const int4 *>(S.y + (4 + q / 4) * LS + 4
                                            + 4 * (q % 4));
    {
        const int p = i / 16, r = (i % 16) / 2, h = i % 2;
        *reinterpret_cast<int4 *>(planes[p] + own * 64 + r * 8 + 4 * h) =
            *reinterpret_cast<const int4 *>(S.c[p] + (2 + r) * CS + 4
                                            + 4 * h);
    }
    if (t - 2 * my > 0) {                       // the left tile's columns
        const long long lt = own - a.lanes;
        if (i < 12) {
            *reinterpret_cast<int4 *>(a.Y + lt * 256 + i * 16 + 12) =
                *reinterpret_cast<const int4 *>(S.y + (4 + i) * LS);
        } else if (i >= 16) {
            const int p = (i - 16) / 8, r = (i - 16) % 8;
            if (r < 6)
                *reinterpret_cast<int2 *>(planes[p] + lt * 64 + r * 8 + 6) =
                    *reinterpret_cast<const int2 *>(S.c[p] + (2 + r) * CS
                                                    + 2);
        }
    }
    if (my > 0) {                               // the top tile's rows
        if (i < 16) {
            *reinterpret_cast<int4 *>(top_tile(a, 0, f, t, k, own) + 192
                                      + 4 * i) =
                *reinterpret_cast<const int4 *>(S.y + (i / 4) * LS + 4
                                                + 4 * (i % 4));
        } else if (i < 24) {
            const int p = (i - 16) / 4, q = (i - 16) % 4;
            *reinterpret_cast<int4 *>(top_tile(a, 1 + p, f, t, k, own) + 48
                                      + 4 * q) =
                *reinterpret_cast<const int4 *>(S.c[p] + (q / 2) * CS + 4
                                                + 4 * (q % 2));
        }
    }
    __syncwarp();               // S is read: the next prefetch may refill it
}

// The next macroblock's left columns: this one's last columns (own columns
// 12-15 / 6-7), from stage S to stage N.
__device__ void pass_left(const Stage &S, Stage &N) {
    const int i = threadIdx.x;
    if (i < 16) {
        *reinterpret_cast<int4 *>(N.y + (4 + i) * LS) =
            *reinterpret_cast<const int4 *>(S.y + (4 + i) * LS + 16);
    } else {
        const int p = (i - 16) / 8, r = (i - 16) % 8;
        *reinterpret_cast<int2 *>(N.c[p] + (2 + r) * CS + 2) =
            *reinterpret_cast<const int2 *>(S.c[p] + (2 + r) * CS + 10);
    }
}

__global__ void __launch_bounds__(32, 32)
h264_deblock_kernel(DeblockArgs a) {
    __shared__ __align__(16) Stage st[2];
    SCAN_TIMING_BEGIN();
    const int total = a.nf * a.lanes;
    for (int id = next_lane(a.ticket); id < total; id = next_lane(a.ticket)) {
        const int f = id / a.lanes, k = id % a.lanes;
        const long long row0 = (long long)f * a.n_steps;
        auto own_of = [&](int t) { return (row0 + t) * a.lanes + k; };
        auto work = [&](int t) {
            return __ldg(a.valid + t * a.lanes + k) == 1;
        };
        const int4 offs = make_int4(__ldg(a.alpha_off + f),
                                    __ldg(a.beta_off + f),
                                    __ldg(a.cqp_off + f),
                                    __ldg(a.cqp2_off + f));
        int *flag = a.flags + id;
        const int *above = k > 0 ? flag - 1 : nullptr;
        Diagonals diags(a.t0, a.t1);
        int cur = diags.next(a.t0, work);
        publish(flag, cur < 0 ? a.t1 : cur);    // nothing to do below cur
        if (cur < 0) continue;
        prefetch(a, st[0], f, cur, k, own_of(cur));
        commit();
        int buf = 0;
        bool have_left = false;
        while (cur >= 0) {
            const int nxt = diags.next(cur + 1, work);
            SCAN_STAMP(8);
            if (nxt >= 0) prefetch(a, st[buf ^ 1], f, nxt, k, own_of(nxt));
            commit();
            SCAN_STAMP(9);
            wait_groups(nxt >= 0 ? 1 : 0);
            __syncwarp();
            SCAN_STAMP(10);
            macroblock(a, st[buf], f, cur, k, own_of(cur), have_left, above,
                       offs);
            // the next macroblock finishes this tile's last columns, and
            // the lane below reads it only after that one's flag; the last
            // of a run is final now and goes out before the flag
            have_left = nxt == cur + 1;
            if (have_left) {
                pass_left(st[buf], st[buf ^ 1]);
                publish(flag, nxt);
                store_rest(a, st[buf], f, cur, k, own_of(cur));
            } else {
                store_rest(a, st[buf], f, cur, k, own_of(cur));
                publish(flag, nxt < 0 ? a.t1 : nxt);
            }
            SCAN_STAMP(5);
            cur = nxt;
            buf ^= 1;
        }
    }
    SCAN_TIMING_END();
}

int g_resident[64];

}  // namespace

SCAN_TIMING_READER(h264_deblock_cycles)

// The tables from the host: alpha[52], beta[52], tc0[3 * 52], chroma_qp[52]
// (int32). Call once per device before the first launch there. Returns the
// copies' cudaError_t (0 = success).
extern "C" int h264_deblock_set_tables(const int *alpha, const int *beta,
                                       const int *tc0, const int *chroma_qp) {
    cudaError_t e;
    if ((e = cudaMemcpyToSymbol(c_alpha, alpha, sizeof(c_alpha)))) return e;
    if ((e = cudaMemcpyToSymbol(c_beta, beta, sizeof(c_beta)))) return e;
    if ((e = cudaMemcpyToSymbol(c_tc0, tc0, sizeof(c_tc0)))) return e;
    return cudaMemcpyToSymbol(c_chroma_qp, chroma_qp, sizeof(c_chroma_qp));
}

// Deblock the diagonals [t0, t1) in one launch, in place on Y, U, V (layout
// above; bs_fstride is bs_v's frame stride in elements, 0 for a pattern
// shared by every frame; halo and hqp with k0 > 0 only, else null). flags
// [nf * lanes] and *ticket are scratch: the ticket 0, each flag at most t0
// (zeros, or what an earlier launch of the same scan on diagonals below t0
// left). Launches min(nf * lanes, the CTAs that fit the card) CTAs of one
// warp on `stream`, does not synchronise. Returns the launch's cudaError_t,
// or 0.
extern "C" int h264_deblock_launch(int *Y, int *U, int *V, const int *qp,
                                   const int *valid, const int *alpha_off,
                                   const int *beta_off, const int *cqp_off,
                                   const int *cqp2_off, const int *bs_v,
                                   const int *bs_h, long long bs_fstride,
                                   int *halo, const int *hqp, int k0,
                                   int *flags, int *ticket, int nf,
                                   int n_steps, int lanes, int t0, int t1,
                                   void *stream) {
    DeblockArgs a{Y, U, V, qp, valid, alpha_off, beta_off, cqp_off,
                  cqp2_off, bs_v, bs_h, bs_fstride, nf, n_steps, lanes,
                  halo, hqp, k0, t0, t1, flags, ticket};
    cudaError_t e = cudaSuccess;
    const int cap = lane_chain::resident_ctas(h264_deblock_kernel, 32,
                                              g_resident, &e);
    if (cap == 0) return e;
    const int grid = nf * lanes < cap ? nf * lanes : cap;
    h264_deblock_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        a);
    return cudaGetLastError();
}
