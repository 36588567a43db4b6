/* Shared host-parser plumbing for the H.264 native front-ends (CAVLC and
 * CABAC): slice context planes, neighbor fetches, MV prediction. Extracted
 * from h264_parse.cc so both translation units stay in lockstep. */
#pragma once
#include <stdint.h>
#include <string.h>
#include "h264_tables.h"

/* ---------- slice-level context ---------- */

typedef struct {
    int mbw, mbh;
    int32_t *nz_luma;      /* [mbh*4][mbw*4] */
    int32_t *nz_chroma;    /* [2][mbh*2][mbw*2] */
    int32_t *i4_grid;      /* [mbh*4][mbw*4] mode or -1 */
    int32_t *slice_map;    /* [mbh][mbw]; -1 undecoded */
    /* outputs (FrameSymbols layout) */
    int32_t *mb_class;     /* [mbh][mbw] */
    int32_t *qp;           /* [mbh][mbw] */
    int32_t *i4_modes;     /* [mbh*4][mbw*4] (0 where not I4) */
    int32_t *i16_mode;     /* [mbh][mbw] */
    int32_t *chroma_mode;  /* [mbh][mbw] */
    int32_t *luma_coeffs;  /* [mbh*4][mbw*4][16] raster */
    int32_t *luma_dc;      /* [mbh][mbw][16] raster */
    int32_t *chroma_coeffs;/* [2][mbh*2][mbw*2][16] raster */
    int32_t *chroma_dc;    /* [2][mbh][mbw][4] */
    uint8_t *pcm_y;        /* [mbh*16][mbw*16] or NULL */
    uint8_t *pcm_c;        /* [2][mbh*8][mbw*8] or NULL */
    int cur_slice;
} Ctx;

static inline int blk_nz(const Ctx *c, const int32_t *grid, int by, int bx,
                         int cur_slice, int per_mb, int gw, int gh) {
    if (bx < 0 || by < 0 || bx >= gw || by >= gh) return -1;
    int my = by / per_mb, mx = bx / per_mb;
    if (c->slice_map[my * c->mbw + mx] != cur_slice) return -1;
    return grid[by * gw + bx];
}

static inline int combine_nc(int na, int nb) {
    if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
    if (na >= 0) return na;
    if (nb >= 0) return nb;
    return 0;
}

static inline int luma_nc(const Ctx *c, int by, int bx, int cur_slice) {
    int gw = c->mbw * 4, gh = c->mbh * 4;
    return combine_nc(blk_nz(c, c->nz_luma, by, bx - 1, cur_slice, 4, gw, gh),
                      blk_nz(c, c->nz_luma, by - 1, bx, cur_slice, 4, gw, gh));
}

static inline int chroma_nc(const Ctx *c, int comp, int by, int bx,
                            int cur_slice) {
    int gw = c->mbw * 2, gh = c->mbh * 2;
    const int32_t *g = c->nz_chroma + comp * gw * gh;
    return combine_nc(blk_nz(c, g, by, bx - 1, cur_slice, 2, gw, gh),
                      blk_nz(c, g, by - 1, bx, cur_slice, 2, gw, gh));
}

static inline int i4_mode_at(const Ctx *c, int by, int bx, int cur_slice) {
    /* -1 if unavailable; DC(2) if available but not I4x4 */
    int gw = c->mbw * 4, gh = c->mbh * 4;
    if (bx < 0 || by < 0 || bx >= gw || by >= gh) return -1;
    int my = by / 4, mx = bx / 4;
    if (c->slice_map[my * c->mbw + mx] != cur_slice) return -1;
    int m = c->i4_grid[by * gw + bx];
    return m < 0 ? 2 : m;
}

static inline int predict_i4(const Ctx *c, int by, int bx, int cur_slice) {
    int ma = i4_mode_at(c, by, bx - 1, cur_slice);
    int mb = i4_mode_at(c, by - 1, bx, cur_slice);
    if (ma < 0 || mb < 0) return 2;
    return ma < mb ? ma : mb;
}

static void store_raster(int32_t *dst, const int32_t *scan, int n_ac,
                         int skip_dc) {
    /* scan-order -> raster 16; if skip_dc, scan has 15 AC coeffs (pos 1..15) */
    for (int k = 0; k < 16; k++) dst[k] = 0;
    if (skip_dc) {
        for (int k = 0; k < 15; k++) dst[zigzag4x4[k + 1]] = scan[k];
    } else {
        for (int k = 0; k < 16; k++) dst[zigzag4x4[k]] = scan[k];
    }
}

/* ---------- inter (P) support: motion grids + MV prediction ---------- */

typedef struct {
    int32_t *mv;    /* [mbh*4][mbw*4][2] */
    int32_t *ref;   /* [mbh*4][mbw*4]; -1 = intra/unset */
    uint8_t *done;  /* [mbh*4][mbw*4] */
} Mot;

/* neighbor motion fetch (mirrors inter._neighbor): returns avail flag;
 * *ref=-1 for intra-but-available. */
static inline int mot_neighbor(const Ctx *c, const Mot *m, int by, int bx,
                               int cur_slice, int32_t mv[2], int *ref) {
    int gw = c->mbw * 4, gh = c->mbh * 4;
    mv[0] = mv[1] = 0;
    *ref = -1;
    if (bx < 0 || by < 0 || bx >= gw || by >= gh) return 0;
    int my = by >> 2, mx = bx >> 2;
    if (c->slice_map[my * c->mbw + mx] != cur_slice) return 0;
    if (!m->done[by * gw + bx]) return 0;
    int r = m->ref[by * gw + bx];
    if (r < 0) return 1;  /* intra: available, no motion */
    *ref = r;
    mv[0] = m->mv[(by * gw + bx) * 2];
    mv[1] = m->mv[(by * gw + bx) * 2 + 1];
    return 1;
}

static inline int32_t med3(int32_t a, int32_t b, int32_t c3) {
    if (a > b) { int32_t t = a; a = b; b = t; }
    if (b > c3) b = c3;
    return a > b ? a : b;
}

enum { PK_OTHER = 0, PK_16x8_TOP, PK_16x8_BOT, PK_8x16_L, PK_8x16_R };

/* luma MV predictor (8.4.1.3), mirrors inter.predict_mv */
static void predict_mv(const Ctx *c, const Mot *m, int by, int bx,
                       int w4, int h4, int ref_idx, int cur_slice,
                       int kind, int32_t out[2]) {
    int32_t mvA[2], mvB[2], mvC[2];
    int refA, refB, refC;
    int availA = mot_neighbor(c, m, by, bx - 1, cur_slice, mvA, &refA);
    int availB = mot_neighbor(c, m, by - 1, bx, cur_slice, mvB, &refB);
    int availC = mot_neighbor(c, m, by - 1, bx + w4, cur_slice, mvC, &refC);
    if (!availC)
        availC = mot_neighbor(c, m, by - 1, bx - 1, cur_slice, mvC, &refC);
    if (kind == PK_16x8_TOP && refB == ref_idx) {
        out[0] = mvB[0]; out[1] = mvB[1]; return;
    }
    if (kind == PK_16x8_BOT && refA == ref_idx) {
        out[0] = mvA[0]; out[1] = mvA[1]; return;
    }
    if (kind == PK_8x16_L && refA == ref_idx) {
        out[0] = mvA[0]; out[1] = mvA[1]; return;
    }
    if (kind == PK_8x16_R && refC == ref_idx) {
        out[0] = mvC[0]; out[1] = mvC[1]; return;
    }
    if (!availB && !availC && availA) {
        out[0] = mvA[0]; out[1] = mvA[1]; return;
    }
    int match = (refA == ref_idx) + (refB == ref_idx) + (refC == ref_idx);
    if (match == 1) {
        const int32_t *src = refA == ref_idx ? mvA
                            : (refB == ref_idx ? mvB : mvC);
        out[0] = src[0]; out[1] = src[1]; return;
    }
    out[0] = med3(mvA[0], mvB[0], mvC[0]);
    out[1] = med3(mvA[1], mvB[1], mvC[1]);
}

/* P_Skip motion (8.4.1.1), mirrors inter.pskip_mv */
static void pskip_mv(const Ctx *c, const Mot *m, int my, int mx,
                     int cur_slice, int32_t out[2]) {
    int by = my * 4, bx = mx * 4;
    int32_t mvA[2], mvB[2];
    int refA, refB;
    int availA = mot_neighbor(c, m, by, bx - 1, cur_slice, mvA, &refA);
    int availB = mot_neighbor(c, m, by - 1, bx, cur_slice, mvB, &refB);
    out[0] = out[1] = 0;
    if (!availA || !availB) return;
    if (refA == 0 && mvA[0] == 0 && mvA[1] == 0) return;
    if (refB == 0 && mvB[0] == 0 && mvB[1] == 0) return;
    predict_mv(c, m, by, bx, 4, 4, 0, cur_slice, PK_OTHER, out);
}

static inline void put_partition(const Ctx *c, Mot *m, int by, int bx,
                                 int w4, int h4, int ref_idx,
                                 int32_t mvdx, int32_t mvdy, int kind,
                                 int cur_slice) {
    int32_t mvp[2];
    predict_mv(c, m, by, bx, w4, h4, ref_idx, cur_slice, kind, mvp);
    int32_t mvx = mvp[0] + mvdx, mvy = mvp[1] + mvdy;
    int gw = c->mbw * 4;
    for (int y = by; y < by + h4; y++)
        for (int x = bx; x < bx + w4; x++) {
            m->mv[(y * gw + x) * 2] = mvx;
            m->mv[(y * gw + x) * 2 + 1] = mvy;
            m->ref[y * gw + x] = ref_idx;
            m->done[y * gw + x] = 1;
        }
}

