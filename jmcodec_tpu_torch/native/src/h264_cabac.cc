/* Native H.264 CABAC slice parser: the hardware-CABAC twin (the reference
 * delegates this to the vendor parser/ASIC, nv_dec/nv_dec.cpp:278-366,:394).
 * Parses slice_data of one I or P slice (CABAC, 4x4 transform) into the
 * dense FrameSymbols planes + per-4x4 motion consumed by the device recon
 * kernel. Mirrors jmcodec_tpu/codec/h264/cabac.py symbol-for-symbol; the
 * Python engine is the tested oracle twin.
 *
 * Out-of-scope -> negative return, caller falls back to the host path:
 *   -21 transform_size_8x8_flag == 1 (8x8 residuals)
 */

#include <stdint.h>
#include <string.h>

#include "h264_tables.h"
#include "h264_cabac_tables.h"
#include "h264_shared.h"

extern "C" {

/* ---------------- arithmetic engine (spec 9.3.3.2) ---------------- */

typedef struct {
    const uint8_t *data;
    int64_t nbytes;
    int64_t pos;        /* absolute bit position */
    uint32_t range, offset;
    uint8_t state[1024], mps[1024];
    int error;
} CE;

static inline int ce_bit(CE *e) {
    int64_t p = e->pos++;
    int64_t i = p >> 3;
    if (i >= e->nbytes) return 0;
    return (e->data[i] >> (7 - (p & 7))) & 1;
}

static void ce_engine_init(CE *e) {
    e->range = 510;
    e->offset = 0;
    for (int i = 0; i < 9; i++) e->offset = (e->offset << 1) | ce_bit(e);
}

static void ce_init(CE *e, const uint8_t *d, int64_t nbytes, int64_t bitpos,
                    int qp, int tab) {
    e->data = d;
    e->nbytes = nbytes;
    e->error = 0;
    e->pos = (bitpos + 7) & ~7LL;   /* cabac_alignment_one_bit */
    if (qp < 0) qp = 0;
    if (qp > 51) qp = 51;
    const int8_t *init = h264_ctx_init + (int64_t)tab * 1024 * 2;
    for (int c = 0; c < 1024; c++) {
        int pre = (((int)init[2 * c] * qp) >> 4) + init[2 * c + 1];
        if (pre < 1) pre = 1;
        if (pre > 126) pre = 126;
        if (pre > 63) { e->mps[c] = 1; e->state[c] = (uint8_t)(pre - 64); }
        else          { e->mps[c] = 0; e->state[c] = (uint8_t)(63 - pre); }
    }
    ce_engine_init(e);
}

static inline int ce_decode(CE *e, int ctx) {
    int s = e->state[ctx];
    uint32_t rng = e->range;
    uint32_t lps = h264_lps_range[(s << 2) | ((rng >> 6) & 3)];
    rng -= lps;
    int b;
    if (e->offset >= rng) {
        b = 1 - e->mps[ctx];
        e->offset -= rng;
        rng = lps;
        if (s == 0) e->mps[ctx] ^= 1;
        e->state[ctx] = h264_trans_lps[s];
    } else {
        b = e->mps[ctx];
        e->state[ctx] = h264_trans_mps[s];
    }
    while (rng < 256) {
        rng <<= 1;
        e->offset = (e->offset << 1) | ce_bit(e);
    }
    e->range = rng;
    return b;
}

static inline int ce_bypass(CE *e) {
    e->offset = (e->offset << 1) | ce_bit(e);
    if (e->offset >= e->range) { e->offset -= e->range; return 1; }
    return 0;
}

static inline int ce_terminate(CE *e) {
    e->range -= 2;
    if (e->offset >= e->range) return 1;
    uint32_t rng = e->range;
    while (rng < 256) {
        rng <<= 1;
        e->offset = (e->offset << 1) | ce_bit(e);
    }
    e->range = rng;
    return 0;
}

static inline int ce_eg_bypass(CE *e, int k) {
    int v = 0;
    while (ce_bypass(e)) {
        v += 1 << k;
        k++;
        if (k > 30) { e->error = 1; return 0; }
    }
    while (k) {
        k--;
        v += ce_bypass(e) << k;
    }
    return v;
}

/* ---------------- per-picture CABAC neighbor state ---------------- */

typedef struct {
    int32_t *skip;        /* [mbh][mbw] */
    int32_t *t8;
    int32_t *cbp_luma;    /* derived (PCM=15) */
    int32_t *cbp_chroma;  /* derived (PCM=2) */
    int32_t *cbf_dc;      /* [mbh][mbw] luma DC (I16; PCM=1) */
    int32_t *cbf_luma;    /* [mbh*4][mbw*4] */
    int32_t *cbf_cdc;     /* [2][mbh][mbw] */
    int32_t *cbf_cac;     /* [2][mbh*2][mbw*2] */
    int32_t *mvd;         /* [mbh*4][mbw*4][2] list-0 abs components */
    int prev_dqp_nz;
} CS;

/* residual ctx bases per ctxBlockCat (cabac.py CBF/SIG/LAST/ABS_BASE) */
static const int CBF_BASE[5] = {85, 89, 93, 97, 101};
static const int SIG_BASE[6] = {105, 120, 134, 149, 152, 402};
static const int LAST_BASE[6] = {166, 181, 195, 210, 213, 417};
static const int ABS_BASE[6] = {227, 237, 247, 257, 266, 426};

static inline int mb_avail(const Ctx *c, int my, int mx, int cur_slice) {
    if (mx < 0 || my < 0 || mx >= c->mbw || my >= c->mbh) return 0;
    return c->slice_map[my * c->mbw + mx] == cur_slice;
}

static inline int propv(const Ctx *c, const int32_t *grid, int my, int mx,
                        int cur_slice) {
    if (!mb_avail(c, my, mx, cur_slice)) return 0;
    return grid[my * c->mbw + mx];
}

/* ---------------- macroblock-level syntax elements ---------------- */

static int se_mb_skip_flag(CE *e, const Ctx *c, const CS *cs, int my, int mx,
                           int cur_slice, int base) {
    int inc = 0;
    if (mb_avail(c, my, mx - 1, cur_slice) &&
        !cs->skip[my * c->mbw + mx - 1]) inc++;
    if (mb_avail(c, my - 1, mx, cur_slice) &&
        !cs->skip[(my - 1) * c->mbw + mx]) inc++;
    return ce_decode(e, base + inc);
}

static int intra_mbtype_tail(CE *e, const int ctxs[5]) {
    int cbp_l = ce_decode(e, ctxs[0]) ? 15 : 0;
    int cbp_c = 0;
    if (ce_decode(e, ctxs[1])) cbp_c = ce_decode(e, ctxs[2]) ? 2 : 1;
    int p0 = ce_decode(e, ctxs[3]);
    int p1 = ce_decode(e, ctxs[4]);
    /* MB.i16_mb_type(mode, cbp_l, cbp_c) = 1 + mode + 4*cbp_c + 12*(l!=0) */
    return 1 + (2 * p0 + p1) + 4 * cbp_c + 12 * (cbp_l ? 1 : 0);
}

static int se_i_mbtype(CE *e, const Ctx *c, const CS *cs, int my, int mx,
                       int cur_slice) {
    int inc = 0;
    const int ny[2] = {my, my - 1}, nx[2] = {mx - 1, mx};
    for (int k = 0; k < 2; k++) {
        if (mb_avail(c, ny[k], nx[k], cur_slice)) {
            int cls = c->mb_class[ny[k] * c->mbw + nx[k]];
            if (cls != 0) inc++;   /* not intra-I4x4 */
        }
    }
    if (!ce_decode(e, 3 + inc)) return 0;
    if (ce_terminate(e)) return 25;
    static const int ctxs[5] = {6, 7, 8, 9, 10};
    return intra_mbtype_tail(e, ctxs);
}

static int se_p_mbtype(CE *e) {
    if (ce_decode(e, 14)) {
        if (!ce_decode(e, 17)) return 5 + 0;
        if (ce_terminate(e)) return 5 + 25;
        static const int ctxs[5] = {18, 19, 19, 20, 20};
        return 5 + intra_mbtype_tail(e, ctxs);
    }
    if (!ce_decode(e, 15)) return 3 * ce_decode(e, 16);
    return 2 - ce_decode(e, 17);
}

static int se_p_sub_mbtype(CE *e) {
    if (ce_decode(e, 21)) return 0;
    if (!ce_decode(e, 22)) return 1;
    return ce_decode(e, 23) ? 2 : 3;
}

static int se_transform8x8(CE *e, const Ctx *c, const CS *cs, int my, int mx,
                           int cur_slice) {
    int inc = propv(c, cs->t8, my, mx - 1, cur_slice) +
              propv(c, cs->t8, my - 1, mx, cur_slice);
    return ce_decode(e, 399 + inc);
}

static int se_i4_mode(CE *e, int pred) {
    if (ce_decode(e, 68)) return pred;
    int rem = ce_decode(e, 69);
    rem += 2 * ce_decode(e, 69);
    rem += 4 * ce_decode(e, 69);
    return rem >= pred ? rem + 1 : rem;
}

static int se_chroma_mode(CE *e, const Ctx *c, const CS *cs, int my, int mx,
                          int cur_slice) {
    int inc = 0;
    const int ny[2] = {my, my - 1}, nx[2] = {mx - 1, mx};
    for (int k = 0; k < 2; k++) {
        if (mb_avail(c, ny[k], nx[k], cur_slice)) {
            int cls = c->mb_class[ny[k] * c->mbw + nx[k]];
            int is_intra = cls == 0 || cls == 1;   /* not PCM, not inter */
            if (is_intra && c->chroma_mode[ny[k] * c->mbw + nx[k]] != 0)
                inc++;
        }
    }
    if (!ce_decode(e, 64 + inc)) return 0;
    if (!ce_decode(e, 67)) return 1;
    return 2 + ce_decode(e, 67);
}

static void se_cbp(CE *e, const Ctx *c, const CS *cs, int my, int mx,
                   int cur_slice, int *cbp_luma, int *cbp_chroma) {
    int cbp = 0;
    for (int b8 = 0; b8 < 4; b8++) {
        int y8 = my * 2 + (b8 >> 1);
        int x8 = mx * 2 + (b8 & 1);
        int a = -1, b = -1;
        /* left neighbor 8x8 block */
        {
            int nx8 = x8 - 1, ny8 = y8;
            if (nx8 >= 0) {
                int nmy = ny8 >> 1, nmx = nx8 >> 1;
                int nb8 = (ny8 & 1) * 2 + (nx8 & 1);
                if (nmy == my && nmx == mx) a = (cbp >> nb8) & 1;
                else if (mb_avail(c, nmy, nmx, cur_slice))
                    a = (cs->cbp_luma[nmy * c->mbw + nmx] >> nb8) & 1;
            }
        }
        {
            int nx8 = x8, ny8 = y8 - 1;
            if (ny8 >= 0) {
                int nmy = ny8 >> 1, nmx = nx8 >> 1;
                int nb8 = (ny8 & 1) * 2 + (nx8 & 1);
                if (nmy == my && nmx == mx) b = (cbp >> nb8) & 1;
                else if (mb_avail(c, nmy, nmx, cur_slice))
                    b = (cs->cbp_luma[nmy * c->mbw + nmx] >> nb8) & 1;
            }
        }
        int inc = (a == 0 ? 1 : 0) + 2 * (b == 0 ? 1 : 0);
        if (ce_decode(e, 73 + inc)) cbp |= 1 << b8;
    }
    int ca = propv(c, cs->cbp_chroma, my, mx - 1, cur_slice);
    int cb = propv(c, cs->cbp_chroma, my - 1, mx, cur_slice);
    int inc = (ca != 0 ? 1 : 0) + 2 * (cb != 0 ? 1 : 0);
    int cc = 0;
    if (ce_decode(e, 77 + inc)) {
        inc = (ca == 2 ? 1 : 0) + 2 * (cb == 2 ? 1 : 0);
        cc = ce_decode(e, 81 + inc) ? 2 : 1;
    }
    *cbp_luma = cbp;
    *cbp_chroma = cc;
}

static int se_mb_qp_delta(CE *e, CS *cs) {
    if (!ce_decode(e, 60 + (cs->prev_dqp_nz ? 1 : 0))) {
        cs->prev_dqp_nz = 0;
        return 0;
    }
    int k = 1;
    while (ce_decode(e, k == 1 ? 62 : 63)) {
        k++;
        if (k > 52) { e->error = 1; return 0; }
    }
    cs->prev_dqp_nz = 1;
    return (k & 1) ? (k + 1) / 2 : -(k / 2);
}

static int ref_cond(const Ctx *c, const CS *cs, const Mot *m, int ny, int nx,
                    int cur_slice) {
    int gw = c->mbw * 4, gh = c->mbh * 4;
    if (nx < 0 || ny < 0 || nx >= gw || ny >= gh) return 0;
    int nmy = ny >> 2, nmx = nx >> 2;
    if (!mb_avail(c, nmy, nmx, cur_slice)) return 0;
    if (cs->skip[nmy * c->mbw + nmx]) return 0;
    return m->ref[ny * gw + nx] > 0 ? 1 : 0;
}

static int se_ref_idx(CE *e, const Ctx *c, const CS *cs, const Mot *m,
                      int by, int bx, int cur_slice) {
    int inc = ref_cond(c, cs, m, by, bx - 1, cur_slice) +
              2 * ref_cond(c, cs, m, by - 1, bx, cur_slice);
    if (!ce_decode(e, 54 + inc)) return 0;
    int k = 1;
    while (ce_decode(e, k == 1 ? 58 : 59)) {
        k++;
        if (k > 32) { e->error = 1; return 0; }
    }
    return k;
}

static int abs_mvd_sum(const Ctx *c, const CS *cs, int by, int bx, int comp,
                       int cur_slice) {
    int gw = c->mbw * 4, gh = c->mbh * 4;
    int total = 0;
    const int ny[2] = {by, by - 1}, nx[2] = {bx - 1, bx};
    for (int k = 0; k < 2; k++) {
        if (nx[k] < 0 || ny[k] < 0 || nx[k] >= gw || ny[k] >= gh) continue;
        if (!mb_avail(c, ny[k] >> 2, nx[k] >> 2, cur_slice)) continue;
        int v = cs->mvd[(ny[k] * gw + nx[k]) * 2 + comp];
        total += v < 0 ? -v : v;
    }
    return total;
}

static int se_mvd(CE *e, const Ctx *c, const CS *cs, int by, int bx,
                  int comp, int cur_slice) {
    int s = abs_mvd_sum(c, cs, by, bx, comp, cur_slice);
    int inc = s < 3 ? 0 : (s <= 32 ? 1 : 2);
    int base = comp == 0 ? 40 : 47;
    if (!ce_decode(e, base + inc)) return 0;
    int k = 1;
    while (k < 9 && ce_decode(e, base + (k + 2 < 6 ? k + 2 : 6))) k++;
    if (k == 9) k += ce_eg_bypass(e, 3);
    return ce_bypass(e) ? -k : k;
}

/* ---------------- residual blocks ---------------- */

static inline int sig_inc(int cat, int i) {
    if (cat == 3) return i < 2 ? i : 2;
    if (cat == 5) return h264_sig8[i];
    return i;
}

static inline int last_inc(int cat, int i) {
    if (cat == 3) return i < 2 ? i : 2;
    if (cat == 5) return h264_last8[i];
    return i;
}

/* Decode one residual block into scan-order coeffs[n]. cbf_inc < 0 => cbf
 * not coded. Returns nonzero count. */
static int residual_block(CE *e, int cat, int n, int cbf_inc,
                          int32_t *coeffs) {
    memset(coeffs, 0, sizeof(int32_t) * n);
    if (cbf_inc >= 0) {
        if (!ce_decode(e, CBF_BASE[cat] + cbf_inc)) return 0;
    }
    int sig_base = SIG_BASE[cat];
    int last_base = LAST_BASE[cat];
    int pos[64];
    int npos = 0;
    int done = 0;
    for (int i = 0; i < n - 1; i++) {
        if (ce_decode(e, sig_base + sig_inc(cat, i))) {
            pos[npos++] = i;
            if (ce_decode(e, last_base + last_inc(cat, i))) { done = 1; break; }
        }
    }
    if (!done) pos[npos++] = n - 1;
    int base = ABS_BASE[cat];
    int eq1 = 0, gt1 = 0;
    for (int j = npos - 1; j >= 0; j--) {
        int level;
        int inc0 = gt1 ? 0 : (1 + eq1 < 4 ? 1 + eq1 : 4);
        if (!ce_decode(e, base + inc0)) {
            level = 1;
            eq1++;
        } else {
            int cap = 4 - (cat == 3 ? 1 : 0);
            int incn = 5 + (gt1 < cap ? gt1 : cap);
            int m1 = 1;
            while (m1 < 14 && ce_decode(e, base + incn)) m1++;
            if (m1 == 14) m1 += ce_eg_bypass(e, 0);
            level = m1 + 1;
            gt1++;
        }
        if (ce_bypass(e)) level = -level;
        coeffs[pos[j]] = level;
    }
    return npos;
}

/* coded_block_flag ctxIdxInc (9.3.3.1.1.9). kind: 0 dc, 1 luma4x4,
 * 2 chroma dc, 3 chroma ac. */
static int cbf_cond(const Ctx *c, const CS *cs, int kind, int ny, int nx,
                    int nmy, int nmx, int comp, int cur_slice,
                    int cur_intra) {
    /* ny/nx < 0 at frame edges: C's truncating division would have mapped
     * (-1)/4 to MB 0 (Python floors to -1) — guard on the block coords
     * before anything derived from them */
    if (nx < 0 || ny < 0 || nmx < 0 || nmy < 0 ||
        nmx >= c->mbw || nmy >= c->mbh ||
        !mb_avail(c, nmy, nmx, cur_slice))
        return cur_intra ? 1 : 0;
    if (c->mb_class[nmy * c->mbw + nmx] == 2) return 1;   /* I_PCM */
    int mbw = c->mbw;
    switch (kind) {
        case 0: return cs->cbf_dc[nmy * mbw + nmx];
        case 1: return cs->cbf_luma[ny * mbw * 4 + nx];
        case 2: return cs->cbf_cdc[comp * c->mbh * mbw + nmy * mbw + nmx];
        default:
            return cs->cbf_cac[comp * c->mbh * 2 * mbw * 2 +
                               ny * mbw * 2 + nx];
    }
}

static int cbf_inc(const Ctx *c, const CS *cs, int cat, int my, int mx,
                   int by, int bx, int comp, int cur_slice, int cur_intra) {
    int a, b;
    if (cat == 0) {
        a = cbf_cond(c, cs, 0, 0, 0, my, mx - 1, 0, cur_slice, cur_intra);
        b = cbf_cond(c, cs, 0, 0, 0, my - 1, mx, 0, cur_slice, cur_intra);
    } else if (cat == 1 || cat == 2 || cat == 5) {
        a = cbf_cond(c, cs, 1, by, bx - 1, by / 4, (bx - 1) / 4, 0,
                     cur_slice, cur_intra);
        b = cbf_cond(c, cs, 1, by - 1, bx, (by - 1) / 4, bx / 4, 0,
                     cur_slice, cur_intra);
    } else if (cat == 3) {
        a = cbf_cond(c, cs, 2, 0, 0, my, mx - 1, comp, cur_slice, cur_intra);
        b = cbf_cond(c, cs, 2, 0, 0, my - 1, mx, comp, cur_slice, cur_intra);
    } else {
        a = cbf_cond(c, cs, 3, by, bx - 1, by / 2, (bx - 1) / 2, comp,
                     cur_slice, cur_intra);
        b = cbf_cond(c, cs, 3, by - 1, bx, (by - 1) / 2, bx / 2, comp,
                     cur_slice, cur_intra);
    }
    return a + 2 * b;
}

/* CABAC twin of parse_residual: fills coeff planes + cbf/nz grids for one
 * MB with cbp already known. cls: 0 I4x4, 1 I16x16, 3 P. */
static void parse_mb_residual(CE *e, Ctx *c, CS *cs, int my, int mx,
                              int cur_slice, int cls, int cbp_luma,
                              int cbp_chroma) {
    int mbw = c->mbw, mbh = c->mbh;
    int gw4 = mbw * 4, gw2 = mbw * 2;
    int cur_intra = cls != 3;
    int32_t scan[16];

    if (cls == 1) {
        int inc = cbf_inc(c, cs, 0, my, mx, 0, 0, 0, cur_slice, cur_intra);
        int ndc = residual_block(e, 0, 16, inc, scan);
        store_raster(c->luma_dc + (my * mbw + mx) * 16, scan, 0, 0);
        cs->cbf_dc[my * mbw + mx] = ndc ? 1 : 0;
    } else {
        for (int k = 0; k < 16; k++) c->luma_dc[(my * mbw + mx) * 16 + k] = 0;
    }

    int n_ac = cls == 1 ? 15 : 16;
    int cat = cls == 1 ? 1 : 2;
    for (int i = 0; i < 16; i++) {
        int by = my * 4 + blk_y[i] / 4;
        int bx = mx * 4 + blk_x[i] / 4;
        int32_t *dst = c->luma_coeffs + (by * gw4 + bx) * 16;
        if (cbp_luma & (1 << (i >> 2))) {
            int inc = cbf_inc(c, cs, cat, my, mx, by, bx, 0, cur_slice,
                              cur_intra);
            int tc = residual_block(e, cat, n_ac, inc, scan);
            store_raster(dst, scan, n_ac, cls == 1);
            cs->cbf_luma[by * gw4 + bx] = tc ? 1 : 0;
            c->nz_luma[by * gw4 + bx] = tc;
        } else {
            for (int k = 0; k < 16; k++) dst[k] = 0;
            cs->cbf_luma[by * gw4 + bx] = 0;
            c->nz_luma[by * gw4 + bx] = 0;
        }
    }

    for (int comp = 0; comp < 2; comp++) {
        int32_t *dst = c->chroma_dc + (comp * mbh * mbw + my * mbw + mx) * 4;
        if (cbp_chroma) {
            int32_t cdc[4];
            int inc = cbf_inc(c, cs, 3, my, mx, 0, 0, comp, cur_slice,
                              cur_intra);
            int ndc = residual_block(e, 3, 4, inc, cdc);
            for (int k = 0; k < 4; k++) dst[k] = cdc[k];
            cs->cbf_cdc[comp * mbh * mbw + my * mbw + mx] = ndc ? 1 : 0;
        } else {
            for (int k = 0; k < 4; k++) dst[k] = 0;
            cs->cbf_cdc[comp * mbh * mbw + my * mbw + mx] = 0;
        }
    }

    static const int cblk_x[4] = {0, 4, 0, 4};
    static const int cblk_y[4] = {0, 0, 4, 4};
    for (int comp = 0; comp < 2; comp++) {
        for (int i = 0; i < 4; i++) {
            int by = my * 2 + cblk_y[i] / 4;
            int bx = mx * 2 + cblk_x[i] / 4;
            int32_t *dst = c->chroma_coeffs +
                (comp * mbh * 2 * gw2 + by * gw2 + bx) * 16;
            int32_t *nz = c->nz_chroma + comp * mbh * 2 * gw2 + by * gw2 + bx;
            int32_t *cac = cs->cbf_cac + comp * mbh * 2 * gw2 + by * gw2 + bx;
            if (cbp_chroma == 2) {
                int inc = cbf_inc(c, cs, 4, my, mx, by, bx, comp, cur_slice,
                                  cur_intra);
                int tc = residual_block(e, 4, 15, inc, scan);
                store_raster(dst, scan, 15, 1);
                *cac = tc ? 1 : 0;
                *nz = tc;
            } else {
                for (int k = 0; k < 16; k++) dst[k] = 0;
                *cac = 0;
                *nz = 0;
            }
        }
    }
}

/* post-parse bookkeeping shared by all MB kinds (record_mb) */
static void record_mb(Ctx *c, CS *cs, int my, int mx, int cls, int skip,
                      int cbp_luma, int cbp_chroma, int chroma_mode, int t8) {
    int mbw = c->mbw, mbh = c->mbh;
    cs->skip[my * mbw + mx] = skip;
    if (cls == 2) {   /* I_PCM */
        cs->cbp_luma[my * mbw + mx] = 15;
        cs->cbp_chroma[my * mbw + mx] = 2;
        cs->cbf_dc[my * mbw + mx] = 1;
        for (int r = 0; r < 4; r++)
            for (int s = 0; s < 4; s++)
                cs->cbf_luma[(my * 4 + r) * mbw * 4 + mx * 4 + s] = 1;
        for (int comp = 0; comp < 2; comp++) {
            cs->cbf_cdc[comp * mbh * mbw + my * mbw + mx] = 1;
            for (int r = 0; r < 2; r++)
                for (int s = 0; s < 2; s++)
                    cs->cbf_cac[comp * mbh * 2 * mbw * 2 +
                                (my * 2 + r) * mbw * 2 + mx * 2 + s] = 1;
        }
        return;
    }
    cs->cbp_luma[my * mbw + mx] = cbp_luma;
    cs->cbp_chroma[my * mbw + mx] = cbp_chroma;
    c->chroma_mode[my * mbw + mx] = chroma_mode;
    cs->t8[my * mbw + mx] = t8;
}

/* zero one MB's coeff planes (skip MBs) */
static void zero_mb_coeffs(Ctx *c, int my, int mx) {
    int mbw = c->mbw, mbh = c->mbh;
    int gw4 = mbw * 4, gw2 = mbw * 2;
    for (int r = 0; r < 4; r++)
        for (int s = 0; s < 4; s++) {
            int by = my * 4 + r, bx = mx * 4 + s;
            c->nz_luma[by * gw4 + bx] = 0;
            for (int t = 0; t < 16; t++)
                c->luma_coeffs[(by * gw4 + bx) * 16 + t] = 0;
        }
    for (int t = 0; t < 16; t++) c->luma_dc[(my * mbw + mx) * 16 + t] = 0;
    for (int comp = 0; comp < 2; comp++) {
        for (int t = 0; t < 4; t++)
            c->chroma_dc[(comp * mbh * mbw + my * mbw + mx) * 4 + t] = 0;
        for (int r = 0; r < 2; r++)
            for (int s = 0; s < 2; s++) {
                int by = my * 2 + r, bx = mx * 2 + s;
                c->nz_chroma[comp * mbh * 2 * gw2 + by * gw2 + bx] = 0;
                for (int t = 0; t < 16; t++)
                    c->chroma_coeffs[(comp * mbh * 2 * gw2 +
                                      by * gw2 + bx) * 16 + t] = 0;
            }
    }
}

/* one intra MB body (mb_type in I-slice numbering). Returns 0 or <0. */
static int parse_intra_mb_cabac(CE *e, Ctx *c, CS *cs, int my, int mx,
                                int mb_type, int *qp, int cur_slice,
                                int t8_allowed) {
    int mbw = c->mbw, mbh = c->mbh;
    int gw4 = mbw * 4;

    if (mb_type == 25) {   /* I_PCM: raw bytes, then engine re-init */
        e->pos = (e->pos + 7) & ~7LL;
        int64_t p = e->pos >> 3;
        if (p + 384 > e->nbytes) return -4;
        if (!c->pcm_y || !c->pcm_c) return -5;
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++)
                c->pcm_y[(my * 16 + y) * (mbw * 16) + mx * 16 + x] =
                    e->data[p + y * 16 + x];
        for (int comp = 0; comp < 2; comp++)
            for (int y = 0; y < 8; y++)
                for (int x = 0; x < 8; x++)
                    c->pcm_c[comp * mbh * 8 * mbw * 8 +
                             (my * 8 + y) * (mbw * 8) + mx * 8 + x] =
                        e->data[p + 256 + comp * 64 + y * 8 + x];
        e->pos = (p + 384) * 8;
        ce_engine_init(e);
        cs->prev_dqp_nz = 0;
        c->mb_class[my * mbw + mx] = 2;
        c->slice_map[my * mbw + mx] = cur_slice;
        c->qp[my * mbw + mx] = *qp;
        for (int r = 0; r < 4; r++)
            for (int s = 0; s < 4; s++) {
                c->nz_luma[(my * 4 + r) * gw4 + mx * 4 + s] = 16;
                c->i4_grid[(my * 4 + r) * gw4 + mx * 4 + s] = -1;
            }
        for (int comp = 0; comp < 2; comp++)
            for (int r = 0; r < 2; r++)
                for (int s = 0; s < 2; s++)
                    c->nz_chroma[comp * mbh * 2 * mbw * 2 +
                                 (my * 2 + r) * mbw * 2 + mx * 2 + s] = 16;
        record_mb(c, cs, my, mx, 2, 0, 0, 0, 0, 0);
        return 0;
    }

    int cls, i16m = 0, cbp_luma = 0, cbp_chroma = 0, cm;
    if (mb_type == 0) {
        cls = 0;
        c->mb_class[my * mbw + mx] = 0;
        c->slice_map[my * mbw + mx] = cur_slice;
        if (t8_allowed && se_transform8x8(e, c, cs, my, mx, cur_slice))
            return -21;   /* 8x8 residuals: host path */
        for (int i = 0; i < 16; i++) {
            int by = my * 4 + blk_y[i] / 4;
            int bx = mx * 4 + blk_x[i] / 4;
            int pred = predict_i4(c, by, bx, cur_slice);
            int mode = se_i4_mode(e, pred);
            c->i4_grid[by * gw4 + bx] = mode;
            c->i4_modes[by * gw4 + bx] = mode;
        }
        cm = se_chroma_mode(e, c, cs, my, mx, cur_slice);
        c->chroma_mode[my * mbw + mx] = cm;
        se_cbp(e, c, cs, my, mx, cur_slice, &cbp_luma, &cbp_chroma);
        if (cbp_chroma == 3) return -9;
    } else if (mb_type <= 24) {
        cls = 1;
        c->mb_class[my * mbw + mx] = 1;
        c->slice_map[my * mbw + mx] = cur_slice;
        int t = mb_type - 1;
        cbp_luma = t >= 12 ? 15 : 0;
        t %= 12;
        i16m = t % 4;
        cbp_chroma = t / 4;
        c->i16_mode[my * mbw + mx] = i16m;
        cm = se_chroma_mode(e, c, cs, my, mx, cur_slice);
        c->chroma_mode[my * mbw + mx] = cm;
        for (int r = 0; r < 4; r++)
            for (int s = 0; s < 4; s++)
                c->i4_grid[(my * 4 + r) * gw4 + mx * 4 + s] = -1;
    } else {
        return -10;
    }

    if (cbp_luma || cbp_chroma || cls == 1) {
        int dq = se_mb_qp_delta(e, cs);
        if (dq < -26 || dq > 25) return -11;
        *qp = ((*qp + dq) % 52 + 52) % 52;
    } else {
        cs->prev_dqp_nz = 0;
    }
    c->qp[my * mbw + mx] = *qp;
    parse_mb_residual(e, c, cs, my, mx, cur_slice, cls, cbp_luma, cbp_chroma);
    record_mb(c, cs, my, mx, cls, 0, cbp_luma, cbp_chroma, cm, 0);
    return e->error ? -12 : 0;
}

/* Parse slice_data of one I or P slice (CABAC). Planes as jmx_parse_p_slice
 * plus the CABAC neighbor-state planes (persisted per picture by the
 * caller). Returns #MBs parsed or a negative error code. */
int jmx_parse_cabac_slice(
        const uint8_t *rbsp, int64_t nbytes, int64_t bit_offset,
        int mbw, int mbh, int first_mb, int slice_qp, int cur_slice,
        int is_p, int num_ref, int t8_allowed, int cabac_init_idc,
        int32_t *nz_luma, int32_t *nz_chroma, int32_t *i4_grid,
        int32_t *slice_map, int32_t *mb_class, int32_t *qp_out,
        int32_t *i4_modes, int32_t *i16_mode, int32_t *chroma_mode,
        int32_t *luma_coeffs, int32_t *luma_dc, int32_t *chroma_coeffs,
        int32_t *chroma_dc, uint8_t *pcm_y, uint8_t *pcm_c,
        int32_t *mv, int32_t *ref, uint8_t *done_scratch,
        int32_t *skip, int32_t *t8, int32_t *cbp_luma_cs,
        int32_t *cbp_chroma_cs, int32_t *cbf_dc, int32_t *cbf_luma,
        int32_t *cbf_cdc, int32_t *cbf_cac, int32_t *mvd) {
    Ctx c = {mbw, mbh, nz_luma, nz_chroma, i4_grid, slice_map, mb_class,
             qp_out, i4_modes, i16_mode, chroma_mode, luma_coeffs, luma_dc,
             chroma_coeffs, chroma_dc, pcm_y, pcm_c, cur_slice};
    CS cs = {skip, t8, cbp_luma_cs, cbp_chroma_cs, cbf_dc, cbf_luma,
             cbf_cdc, cbf_cac, mvd, 0};
    Mot m = {mv, ref, done_scratch};
    static CE e;   /* 2KB of context state; parser is not re-entrant per
                    * thread — but each call gets a fresh init. Use a local
                    * to stay thread-safe. */
    CE eng;
    (void)e;
    ce_init(&eng, rbsp, nbytes, bit_offset, slice_qp,
            is_p ? 1 + cabac_init_idc : 0);
    int qp = slice_qp;
    int addr = first_mb;
    int n_mbs = 0;
    int n_total = mbw * mbh;
    int gw4 = mbw * 4;

    while (1) {
        if (addr >= n_total) return -2;
        int my = addr / mbw, mx = addr % mbw;
        if (is_p && se_mb_skip_flag(&eng, &c, &cs, my, mx, cur_slice, 11)) {
            /* P_Skip */
            c.mb_class[my * mbw + mx] = 3;
            c.slice_map[my * mbw + mx] = cur_slice;
            c.qp[my * mbw + mx] = qp;
            int32_t smv[2];
            pskip_mv(&c, &m, my, mx, cur_slice, smv);
            for (int r = 0; r < 4; r++)
                for (int s = 0; s < 4; s++) {
                    int by = my * 4 + r, bx = mx * 4 + s;
                    c.i4_grid[by * gw4 + bx] = -1;
                    c.i4_modes[by * gw4 + bx] = 0;
                    m.mv[(by * gw4 + bx) * 2] = smv[0];
                    m.mv[(by * gw4 + bx) * 2 + 1] = smv[1];
                    m.ref[by * gw4 + bx] = 0;
                    m.done[by * gw4 + bx] = 1;
                    cs.cbf_luma[by * gw4 + bx] = 0;
                }
            zero_mb_coeffs(&c, my, mx);
            for (int comp = 0; comp < 2; comp++) {
                cs.cbf_cdc[comp * mbh * mbw + my * mbw + mx] = 0;
                for (int r = 0; r < 2; r++)
                    for (int s = 0; s < 2; s++)
                        cs.cbf_cac[comp * mbh * 2 * mbw * 2 +
                                   (my * 2 + r) * mbw * 2 + mx * 2 + s] = 0;
            }
            cs.prev_dqp_nz = 0;
            record_mb(&c, &cs, my, mx, 3, 1, 0, 0, 0, 0);
        } else if (is_p) {
            int mb_type = se_p_mbtype(&eng);
            if (eng.error) return -3;
            if (mb_type >= 5) {
                int rc = parse_intra_mb_cabac(&eng, &c, &cs, my, mx,
                                              mb_type - 5, &qp, cur_slice,
                                              t8_allowed);
                if (rc) return rc;
                for (int r = 0; r < 4; r++)
                    for (int s = 0; s < 4; s++) {
                        int by = my * 4 + r, bx = mx * 4 + s;
                        m.ref[by * gw4 + bx] = -1;
                        m.mv[(by * gw4 + bx) * 2] = 0;
                        m.mv[(by * gw4 + bx) * 2 + 1] = 0;
                        m.done[by * gw4 + bx] = 1;
                    }
            } else {
                /* inter P MB */
                c.mb_class[my * mbw + mx] = 3;
                c.slice_map[my * mbw + mx] = cur_slice;
                for (int r = 0; r < 4; r++)
                    for (int s = 0; s < 4; s++) {
                        c.i4_grid[(my * 4 + r) * gw4 + mx * 4 + s] = -1;
                        c.i4_modes[(my * 4 + r) * gw4 + mx * 4 + s] = 0;
                    }
                int by0 = my * 4, bx0 = mx * 4;
                int subt[4] = {0, 0, 0, 0};

                /* partition helper: ref first (pre-written into m.ref so
                 * within-MB ref ctx sees it), then mvd + MV prediction */
                #define READ_REF(by, bx, h4, w4)                           \
                    ({                                                     \
                        int rr = num_ref > 1                               \
                            ? se_ref_idx(&eng, &c, &cs, &m, (by), (bx),    \
                                         cur_slice)                        \
                            : 0;                                           \
                        for (int yy = (by); yy < (by) + (h4); yy++)        \
                            for (int xx = (bx); xx < (bx) + (w4); xx++)    \
                                m.ref[yy * gw4 + xx] = rr;                 \
                        rr;                                                \
                    })
                #define PUT_PART(by, bx, w4, h4, ref_i, kind)              \
                    do {                                                   \
                        int mdx = se_mvd(&eng, &c, &cs, (by), (bx), 0,     \
                                         cur_slice);                      \
                        int mdy = se_mvd(&eng, &c, &cs, (by), (bx), 1,     \
                                         cur_slice);                      \
                        put_partition(&c, &m, (by), (bx), (w4), (h4),      \
                                      (ref_i), mdx, mdy, (kind),           \
                                      cur_slice);                          \
                        for (int yy = (by); yy < (by) + (h4); yy++)        \
                            for (int xx = (bx); xx < (bx) + (w4); xx++) {  \
                                cs.mvd[(yy * gw4 + xx) * 2] = mdx;         \
                                cs.mvd[(yy * gw4 + xx) * 2 + 1] = mdy;     \
                            }                                              \
                    } while (0)

                if (mb_type == 0) {          /* P_16x16 */
                    int r0 = READ_REF(by0, bx0, 4, 4);
                    PUT_PART(by0, bx0, 4, 4, r0, PK_OTHER);
                } else if (mb_type == 1) {   /* P_16x8 */
                    int r0 = READ_REF(by0, bx0, 2, 4);
                    int r1 = READ_REF(by0 + 2, bx0, 2, 4);
                    PUT_PART(by0, bx0, 4, 2, r0, PK_16x8_TOP);
                    PUT_PART(by0 + 2, bx0, 4, 2, r1, PK_16x8_BOT);
                } else if (mb_type == 2) {   /* P_8x16 */
                    int r0 = READ_REF(by0, bx0, 4, 2);
                    int r1 = READ_REF(by0, bx0 + 2, 4, 2);
                    PUT_PART(by0, bx0, 2, 4, r0, PK_8x16_L);
                    PUT_PART(by0, bx0 + 2, 2, 4, r1, PK_8x16_R);
                } else {                     /* P_8x8 (no ref0 variant in
                                              * CABAC mb_type space) */
                    for (int i = 0; i < 4; i++)
                        subt[i] = se_p_sub_mbtype(&eng);
                    int refs[4] = {0, 0, 0, 0};
                    if (num_ref > 1)
                        for (int b8 = 0; b8 < 4; b8++) {
                            int oy = by0 + (b8 / 2) * 2;
                            int ox = bx0 + (b8 % 2) * 2;
                            refs[b8] = READ_REF(oy, ox, 2, 2);
                        }
                    for (int b8 = 0; b8 < 4; b8++) {
                        int oy = by0 + (b8 / 2) * 2;
                        int ox = bx0 + (b8 % 2) * 2;
                        int st = subt[b8];
                        int n_parts = st == 0 ? 1 : (st == 3 ? 4 : 2);
                        int pw = (st == 0 || st == 1) ? 2 : 1;
                        int ph = (st == 0 || st == 2) ? 2 : 1;
                        for (int p = 0; p < n_parts; p++) {
                            int py, px;
                            if (st == 1) { py = oy + p; px = ox; }
                            else if (st == 2) { py = oy; px = ox + p; }
                            else if (st == 3) { py = oy + p / 2;
                                                px = ox + p % 2; }
                            else { py = oy; px = ox; }
                            PUT_PART(py, px, pw, ph, refs[b8], PK_OTHER);
                        }
                    }
                }
                #undef READ_REF
                #undef PUT_PART

                int cbp_luma, cbp_chroma;
                se_cbp(&eng, &c, &cs, my, mx, cur_slice, &cbp_luma,
                       &cbp_chroma);
                if (cbp_chroma == 3) return -9;
                if (cbp_luma && t8_allowed &&
                        (mb_type < 3 ||
                         (subt[0] | subt[1] | subt[2] | subt[3]) == 0)) {
                    if (se_transform8x8(&eng, &c, &cs, my, mx, cur_slice))
                        return -21;
                }
                if (cbp_luma || cbp_chroma) {
                    int dq = se_mb_qp_delta(&eng, &cs);
                    if (dq < -26 || dq > 25) return -11;
                    qp = ((qp + dq) % 52 + 52) % 52;
                } else {
                    cs.prev_dqp_nz = 0;
                }
                c.qp[my * mbw + mx] = qp;
                for (int t_ = 0; t_ < 16; t_++)
                    luma_dc[(my * mbw + mx) * 16 + t_] = 0;
                parse_mb_residual(&eng, &c, &cs, my, mx, cur_slice, 3,
                                  cbp_luma, cbp_chroma);
                record_mb(&c, &cs, my, mx, 3, 0, cbp_luma, cbp_chroma, 0, 0);
            }
        } else {
            int mb_type = se_i_mbtype(&eng, &c, &cs, my, mx, cur_slice);
            if (eng.error) return -3;
            int rc = parse_intra_mb_cabac(&eng, &c, &cs, my, mx, mb_type,
                                          &qp, cur_slice, t8_allowed);
            if (rc) return rc;
        }
        if (eng.error) return -12;
        addr++;
        n_mbs++;
        if (ce_terminate(&eng)) break;   /* end_of_slice_flag */
    }
    return n_mbs;
}

} /* extern "C" */
