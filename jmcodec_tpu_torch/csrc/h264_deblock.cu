// H.264 in-loop deblocking (spec 8.7) of skewed macroblock tiles: one
// launch per wavefront diagonal, in place.
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
// Tile (t, k) is macroblock (mx, my) = (t - 2k, k). Launch t filters the
// macroblocks of diagonal t: luma vertical edges 0, 4, 8, 12, then
// horizontal edges 0, 4, 8, 12; chroma edges 0 and 4 (luma edges 0 and 2's
// bS) each way. Edge 0 is the macroblock boundary: against the left tile
// (t-1, k) and the top tile (t-2, k-1), with indexA/indexB from the
// averaged QP; inside the macroblock, from its own QP.
//
// A band of lanes (the row-sharded decode: rank i of n holds global lanes
// k0 .. k0 + lanes - 1): macroblock (mx, my) = (t - 2(k0 + k), k0 + k), and
// with k0 > 0 the top tile of local lane 0 is the band's halo, the lane
// above it: halo [F, n_steps, 384] holds per diagonal that lane's Y tile
// (256), then U and V (64 each), hqp [F, n_steps] its QP. The caller fills
// halo[t-2] before launch t, and this kernel filters its last rows in place,
// as it does a top tile of its own (kernels/h264_scan.py hands them back).
//
// Race freedom: a CTA (f, k) of launch t writes only tiles (t, k), (t-1, k)
// (the left tile's last four columns) and (t-2, k-1) (the top tile's last
// four rows). Tile (t-1, k) is the left tile of lane k alone, and tile
// (t-2, k-1) the top tile of lane k alone, so no two CTAs of a launch touch
// the same tile; what launch t reads of diagonals t-1 and t-2 was finished
// by launches t-1 and t-2 (the halo's tile t-2 likewise, by the rank above
// and its exchange). The picture's lane 0 has no macroblock above it and a
// lane's macroblock with mx == 0 none to its left: those edges are never
// filtered and nothing outside the diagonals is read (the torch version
// rolls lanes, wrapping lane 0 to the last lane, and masks the result with
// bS 0 there).
//
// Bound on this card: at one picture, the launch floor. A diagonal of a
// 1080p picture is at most 68 macroblocks, about 4.6 KB each read and
// written, against about 8,000 integer operations: far under a
// microsecond of HBM time either way. The design is the simple one: one CTA
// of 32 threads per (frame, lane), the macroblock's 20x20 luma and 10x10
// chroma neighbourhoods (own tile, the left tile's last columns, the top
// tile's last rows) staged in shared memory, one thread per line of an
// edge (threads 0-15 luma, 16-23 Cb, 24-31 Cr), a barrier between edges.
//
// The tables (alpha, beta, tc0, the chroma QP map) are set once per device
// from the port's own numpy arrays (ops/deblock.py, ops/transform.py) by
// h264_deblock_set_tables.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
    int n_steps, lanes;
    int *halo;                  // [F, n_steps, 384], or null (k0 == 0)
    const int *hqp;             // [F, n_steps]
    int k0;
};

// the halo's packing of one tile: Y, then U, then V
constexpr int HALO = 256 + 64 + 64;

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

// luma staging: rows 0-3 the top tile's rows 12-15, columns 0-3 the left
// tile's columns 12-15, [4 + y][4 + x] the macroblock's own sample (y, x)
constexpr int LS = 20;
// chroma staging, per plane: the same with two rows and columns
constexpr int CS = 10;

__global__ void __launch_bounds__(32)
h264_deblock_kernel(DeblockArgs a, int t) {
    const int k = blockIdx.x, f = blockIdx.y, tid = threadIdx.x;
    if (a.valid[t * a.lanes + k] != 1) return;
    const int my = a.k0 + k;
    const bool left = t - 2 * my > 0;       // mx > 0: the left MB exists
    const bool top = my > 0;                // my > 0: the top MB exists
    const long long own = ((long long)f * a.n_steps + t) * a.lanes + k;
    const long long lt = own - a.lanes;                 // (t-1, k)
    const long long tp = own - 2 * a.lanes - 1;         // (t-2, k-1)

    __shared__ int sY[LS * LS];
    __shared__ int sC[2][CS * CS];
    int *planes[2] = {a.U, a.V};
    // the top tile: (t-2, k-1), or for lane 0 of a band the halo's t-2
    int *topY = nullptr, *topC[2] = {nullptr, nullptr};
    int q_top = 0;
    if (top && k > 0) {
        topY = a.Y + tp * 256;
        topC[0] = a.U + tp * 64;
        topC[1] = a.V + tp * 64;
        q_top = a.qp[tp];
    } else if (top) {
        const long long h = (long long)f * a.n_steps + t - 2;
        topY = a.halo + h * HALO;
        topC[0] = topY + 256;
        topC[1] = topY + 320;
        q_top = a.hqp[h];
    }

    for (int i = tid; i < 256; i += 32)
        sY[(4 + i / 16) * LS + 4 + i % 16] = a.Y[own * 256 + i];
    for (int i = tid; i < 128; i += 32) {
        const int c = i / 64, j = i % 64;
        sC[c][(2 + j / 8) * CS + 2 + j % 8] = planes[c][own * 64 + j];
    }
    if (left)
        for (int i = tid; i < 64 + 32; i += 32) {
            if (i < 64) {
                const int y = i / 4, x = i % 4;
                sY[(4 + y) * LS + x] = a.Y[lt * 256 + y * 16 + 12 + x];
            } else {
                const int j = i - 64, c = j / 16, y = (j % 16) / 2, x = j % 2;
                sC[c][(2 + y) * CS + x] = planes[c][lt * 64 + y * 8 + 6 + x];
            }
        }
    if (top)
        for (int i = tid; i < 64 + 32; i += 32) {
            if (i < 64) {
                const int y = i / 16, x = i % 16;
                sY[y * LS + 4 + x] = topY[(12 + y) * 16 + x];
            } else {
                const int j = i - 64, c = j / 16, y = (j % 16) / 8, x = j % 8;
                sC[c][y * CS + 2 + x] = topC[c][(6 + y) * 8 + x];
            }
        }

    // indexA / indexB: edge 0 from the averaged QP, inside from our own
    const int qp = a.qp[own];
    const int q_nb[2] = {left ? a.qp[lt] : 0, q_top};
    const int aoff = a.alpha_off[f], boff = a.beta_off[f];
    const bool luma = tid < 16;
    const int c = (tid - 16) / 8;            // chroma plane of threads 16-31
    const int line = luma ? tid : (tid - 16) % 8;
    int q_in, q_edge[2];
    if (luma) {
        q_in = qp;
        q_edge[0] = (qp + q_nb[0] + 1) >> 1;
        q_edge[1] = (qp + q_nb[1] + 1) >> 1;
    } else {
        const int off = c == 0 ? a.cqp_off[f] : a.cqp2_off[f];
        q_in = c_chroma_qp[clip51(qp + off)];
        q_edge[0] = (q_in + c_chroma_qp[clip51(q_nb[0] + off)] + 1) >> 1;
        q_edge[1] = (q_in + c_chroma_qp[clip51(q_nb[1] + off)] + 1) >> 1;
    }
    const int *bsv = a.bs_v + (long long)f * a.bs_fstride
        + ((long long)t * a.lanes + k) * 16;
    const int *bsh = a.bs_h + (long long)f * a.bs_fstride
        + ((long long)t * a.lanes + k) * 16;
    __syncthreads();

    // phases 0-3: vertical edges 0, 4, 8, 12; 4-7: horizontal ones. Chroma
    // takes phases 0-1 and 4-5 (its edges 0 and 4 with luma edges 0 and
    // 2's bS).
    for (int ph = 0; ph < 8; ++ph) {
        const int dir = ph / 4, e = ph % 4;      // dir 0: vertical
        const bool mb_edge = e == 0;
        if (!(mb_edge && !(dir == 0 ? left : top))) {
            const int q = mb_edge ? q_edge[dir] : q_in;
            const int *bs = dir == 0 ? bsv : bsh;
            if (luma) {
                const int ia = clip51(q + aoff), ib = clip51(q + boff);
                int *p = dir == 0 ? &sY[(4 + line) * LS + 4 + 4 * e]
                                  : &sY[(4 + 4 * e) * LS + 4 + line];
                filter_luma(p, dir == 0 ? 1 : LS, bs[e * 4 + line / 4], ia,
                            ib);
            } else if (e < 2) {
                const int ia = clip51(q + aoff), ib = clip51(q + boff);
                int *p = dir == 0 ? &sC[c][(2 + line) * CS + 2 + 4 * e]
                                  : &sC[c][(2 + 4 * e) * CS + 2 + line];
                filter_chroma(p, dir == 0 ? 1 : CS, bs[2 * e * 4 + line / 2],
                              ia, ib);
            }
        }
        __syncthreads();
    }

    for (int i = tid; i < 256; i += 32)
        a.Y[own * 256 + i] = sY[(4 + i / 16) * LS + 4 + i % 16];
    for (int i = tid; i < 128; i += 32) {
        const int cc = i / 64, j = i % 64;
        planes[cc][own * 64 + j] = sC[cc][(2 + j / 8) * CS + 2 + j % 8];
    }
    if (left)
        for (int i = tid; i < 64 + 32; i += 32) {
            if (i < 64) {
                const int y = i / 4, x = i % 4;
                a.Y[lt * 256 + y * 16 + 12 + x] = sY[(4 + y) * LS + x];
            } else {
                const int j = i - 64, cc = j / 16, y = (j % 16) / 2,
                          x = j % 2;
                planes[cc][lt * 64 + y * 8 + 6 + x] = sC[cc][(2 + y) * CS + x];
            }
        }
    if (top)
        for (int i = tid; i < 64 + 32; i += 32) {
            if (i < 64) {
                const int y = i / 16, x = i % 16;
                topY[(12 + y) * 16 + x] = sY[y * LS + 4 + x];
            } else {
                const int j = i - 64, cc = j / 16, y = (j % 16) / 8,
                          x = j % 8;
                topC[cc][(6 + y) * 8 + x] = sC[cc][y * CS + 2 + x];
            }
        }
}

}  // namespace

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

// Deblock diagonals t0 .. t1-1 in order, one launch each, in place on Y, U,
// V (layout above; bs_fstride is bs_v's frame stride in elements, 0 for a
// pattern shared by every frame; halo and hqp with k0 > 0 only, else null).
// Launches on `stream`, does not synchronise. Returns the first failed
// launch's cudaError_t, or 0.
extern "C" int h264_deblock_launch(int *Y, int *U, int *V, const int *qp,
                                   const int *valid, const int *alpha_off,
                                   const int *beta_off, const int *cqp_off,
                                   const int *cqp2_off, const int *bs_v,
                                   const int *bs_h, long long bs_fstride,
                                   int *halo, const int *hqp, int k0,
                                   int nf, int n_steps, int lanes, int t0,
                                   int t1, void *stream) {
    DeblockArgs a{Y, U, V, qp, valid, alpha_off, beta_off, cqp_off,
                  cqp2_off, bs_v, bs_h, bs_fstride, n_steps, lanes,
                  halo, hqp, k0};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    for (int t = t0; t < t1; ++t) {
        h264_deblock_kernel<<<dim3(lanes, nf), 32, 0, s>>>(a, t);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    return 0;
}
