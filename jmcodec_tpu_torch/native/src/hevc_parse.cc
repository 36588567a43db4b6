/* Fast HEVC CABAC I-slice parser: the host entropy front-end of the TPU
 * HEVC decode pipeline (SURVEY §7.2 L1a). Parses slice_data of one HEVC
 * I slice (WPP supported) into the HevcFramePlan tensors consumed by the
 * device CTB-wavefront recon kernel (kernels/hevc_tiles.py).
 *
 * Mirrors jmcodec_tpu/codec/hevc/refdec.py (the tested oracle twin)
 * exactly; tested for byte-for-byte equality of the produced plan tensors
 * and for bit-exact stream decode. Context tables are generated from the
 * Python source of truth (gen_hevc_native_tables.py).
 *
 * Capability analog: the hardware CABAC front-end of a GPU decoder behind
 * cuvidParseVideoData (nv_dec/nv_dec.cpp:278-366,394).
 *
 * Built as a shared library, bound via ctypes (no pybind11 in the image).
 */

#include <stdint.h>
#include <string.h>

#include "hevc_tables.h"

namespace {

/* ---- CABAC engine (H.265 9.3.4.3 == H.264 9.3.3.2) -------------------- */

struct Cabac {
    const uint8_t *data;
    int64_t nbytes;
    int64_t pos;          /* absolute bit position */
    uint32_t range, offset;
    uint8_t state[HEVC_NCTX];
    uint8_t mps[HEVC_NCTX];
    int error;

    inline int bit() {
        int64_t p = pos++;
        int64_t i = p >> 3;
        if (i >= nbytes) return 0;
        return (data[i] >> (7 - (p & 7))) & 1;
    }
    inline uint32_t bits(int n) {
        uint32_t v = 0;
        for (int k = 0; k < n; k++) v = (v << 1) | bit();
        return v;
    }
    void engine_init() {
        range = 510;
        offset = bits(9);
    }
    void init_contexts(int slice_qp, int init_type) {
        int qp = slice_qp < 0 ? 0 : (slice_qp > 51 ? 51 : slice_qp);
        const uint8_t *row = hevc_ctx_init + init_type * HEVC_NCTX;
        for (int i = 0; i < HEVC_NCTX; i++) {
            int iv = row[i];
            int m = (iv >> 4) * 5 - 45;
            int n = ((iv & 15) << 3) - 16;
            int pre = ((m * qp) >> 4) + n;
            if (pre < 1) pre = 1;
            if (pre > 126) pre = 126;
            if (pre > 63) { mps[i] = 1; state[i] = (uint8_t)(pre - 64); }
            else          { mps[i] = 0; state[i] = (uint8_t)(63 - pre); }
        }
    }
    void start(const uint8_t *d, int64_t nb, int64_t bit_pos,
               int slice_qp, int init_type) {
        data = d; nbytes = nb; error = 0;
        pos = ((bit_pos + 7) / 8) * 8;
        init_contexts(slice_qp, init_type);
        engine_init();
    }
    inline int decode(int ctx) {
        int s = state[ctx];
        uint32_t rng = range;
        uint32_t lps = lps_range[(s << 2) | ((rng >> 6) & 3)];
        rng -= lps;
        int b;
        if (offset >= rng) {
            b = 1 - mps[ctx];
            offset -= rng;
            rng = lps;
            if (s == 0) mps[ctx] ^= 1;
            state[ctx] = trans_idx_lps[s];
        } else {
            b = mps[ctx];
            state[ctx] = trans_idx_mps[s];
        }
        while (rng < 256) {
            rng <<= 1;
            offset = (offset << 1) | bit();
        }
        range = rng;
        return b;
    }
    inline int bypass() {
        offset = (offset << 1) | bit();
        if (offset >= range) { offset -= range; return 1; }
        return 0;
    }
    inline int terminate() {
        range -= 2;
        if (offset >= range) return 1;
        uint32_t rng = range;
        while (rng < 256) {
            rng <<= 1;
            offset = (offset << 1) | bit();
        }
        range = rng;
        return 0;
    }
    inline int tr_bypass(int cmax) {
        int v = 0;
        while (v < cmax && bypass()) v++;
        return v;
    }
    void save(uint8_t *st, uint8_t *mp) const {
        memcpy(st, state, HEVC_NCTX);
        memcpy(mp, mps, HEVC_NCTX);
    }
    void load(const uint8_t *st, const uint8_t *mp) {
        memcpy(state, st, HEVC_NCTX);
        memcpy(mps, mp, HEVC_NCTX);
    }
    void reposition(int64_t bit_pos) {   /* entry-point jump (9.3.1) */
        pos = bit_pos;
        engine_init();
    }
    void align_and_reinit() {            /* byte_alignment() (7.3.2.10) */
        pos = ((pos >> 3) + 1) << 3;
        engine_init();
    }
};

/* ---- scan orders (6.5.3-6.5.5); scanIdx: 0 diag, 1 hor, 2 ver --------- */

struct Scans {
    /* (x, y) pairs; for sizes 1, 2, 4, 8 */
    uint8_t xy[3][4][64][2];  /* [scan][log2size 0..3][pos][xy] */
    Scans() {
        for (int l = 0; l < 4; l++) {
            int n = 1 << l;
            int k = 0;
            for (int d = 0; d < 2 * n - 1; d++)       /* diag up-right */
                for (int x = 0; x <= d; x++) {
                    int y = d - x;
                    if (x < n && y < n) {
                        xy[0][l][k][0] = (uint8_t)x;
                        xy[0][l][k][1] = (uint8_t)y;
                        k++;
                    }
                }
            k = 0;
            for (int y = 0; y < n; y++)               /* horizontal */
                for (int x = 0; x < n; x++) {
                    xy[1][l][k][0] = (uint8_t)x;
                    xy[1][l][k][1] = (uint8_t)y;
                    k++;
                }
            k = 0;
            for (int x = 0; x < n; x++)               /* vertical */
                for (int y = 0; y < n; y++) {
                    xy[2][l][k][0] = (uint8_t)x;
                    xy[2][l][k][1] = (uint8_t)y;
                    k++;
                }
        }
    }
};
static const Scans SC;

/* 4x4 sig_coeff_flag ctx map (9.3.4.2.5 ctxIdxMap) */
static const uint8_t CTX_IDX_MAP[16] = {0, 1, 4, 5, 2, 3, 4, 5,
                                        6, 6, 8, 8, 7, 7, 8, 8};

/* intra modes */
enum { IP_PLANAR = 0, IP_DC = 1, IP_HOR = 10, IP_VER = 26 };

/* error codes */
enum {
    E_OK = 0,
    E_BITS = -1,
    E_PCM = -2,
    E_TQBYPASS = -3,
    E_TSKIP = -4,
    E_OVERRUN = -5,
    E_SUBSET = -6,
    E_NOTINTRA = -7,
};

/* ---- parser state ------------------------------------------------------ */

struct Ctx {
    /* geometry */
    int w, h;                /* coded picture size */
    int log2_ctb, log2_min_cb, log2_min_tb, log2_max_tb, max_tdepth_intra;
    int ctb_w, ctb_h;
    int Wp, Hp;              /* CTB-padded plane size */
    int cw, ch;              /* cell grid (coded): ceil(w/4), ceil(h/4) */
    int Wc, Hc;              /* padded cell grid: Wp/4, Hp/4 */
    /* slice */
    int qp, init_type, sao_luma, sao_chroma, wpp;
    int sdh, tskip_enabled, tqbypass_enabled;
    /* plan outputs (padded strides) */
    int32_t *coeff_y;                       /* [Hp, Wp] */
    int32_t *tu_log2_y, *mode_y_o, *zidx_y, *qp_y;   /* [Hc, Wc] */
    int32_t *coeff_cb, *coeff_cr;           /* [Hp/2, Wp/2] */
    int32_t *tu_log2_c, *mode_c_o, *zidx_c; /* [Hc/2, Wc/2] */
    int32_t *bs_ver, *bs_hor;               /* [Hc, Wc] */
    int32_t *sao_type, *sao_band, *sao_eo;  /* [ctb_h, ctb_w, 3] */
    int32_t *sao_offsets;                   /* [ctb_h, ctb_w, 3, 4] */
    int zctr;
    /* parse-side cell state (coded-size cell grid, row-major [ch][cw]) */
    uint8_t *avail_y;     /* recon availability (marked per luma TU) */
    uint8_t *mode_avail;  /* parse-order PU mode availability (MPM) */
    uint8_t *mode_y;      /* per-cell luma mode for MPM */
    uint8_t *ct_depth;    /* per-cell coding-tree depth */
    /* current CU */
    int cu_modes[4];
    int cu_cmode;
    int cu_part_nxn;
    int cu_x0, cu_y0, cu_log2;
    int cu_is_inter;
    struct InterCtx *it;   /* NULL on the intra-only entry */
    Cabac c;
    int err;
};

/* ---- inter slice context (P/B slices, 7.3.8.5-7.3.8.6) ----------------- */

struct InterCtx {
    int slice_type;          /* 0 B, 1 P */
    int num_ref[2];
    int max_merge;
    int tmvp_on, col_from_l0, col_ref_idx, mvd_l1_zero, no_backward;
    int cur_poc;
    int max_tdepth_inter, amp_enabled;
    int32_t ref_poc_l[2][16];
    int32_t ref_slot_l[2][16];
    /* collocated picture motion (coded cell grid [ch][cw]) */
    const uint8_t *col_pred0, *col_pred1, *col_intra;
    const int32_t *col_mv0, *col_mv1;         /* [..][2] */
    const int32_t *col_refpoc0, *col_refpoc1;
    int col_poc, has_col;
    /* current-picture motion/deblock state (coded cell grid, outputs) */
    uint8_t *pred0, *pred1;
    int32_t *mv0, *mv1;                       /* [..][2] */
    int32_t *refidx0, *refidx1;
    int32_t *refpoc0, *refpoc1;
    uint8_t *mot_done, *intra4, *skip4, *cbf4;
    uint8_t *tu_ev, *tu_eh, *pu_ev, *pu_eh;
    /* plan outputs (padded cell grid [Hc][Wc]) */
    uint8_t *inter4;
    int32_t *pmv;            /* [2][Hc][Wc][2] */
    int32_t *ref_slot_o;     /* [2][Hc][Wc] */
    uint8_t *pred_fl;        /* [2][Hc][Wc] */
    int32_t *tu_inter_y;     /* [Hc][Wc] */
    int32_t *tu_inter_c;     /* [Hc/2][Wc/2] */
    int mv_overflow;         /* |mv| beyond the device MC pad budget */
};

struct MotCand {
    int pred;                /* bit0 L0, bit1 L1 */
    int mv[2][2];
    int ref_idx[2];
};

static inline int same_motion(const MotCand &a, const MotCand &b) {
    if (a.pred != b.pred) return 0;
    for (int lx = 0; lx < 2; lx++)
        if (a.pred & (1 << lx)) {
            if (a.mv[lx][0] != b.mv[lx][0] ||
                a.mv[lx][1] != b.mv[lx][1] ||
                a.ref_idx[lx] != b.ref_idx[lx]) return 0;
        }
    return 1;
}

static inline void fail(Ctx *t, int e) { if (!t->err) t->err = e; }

/* ---- residual coding (7.3.8.11), mirrors refdec._residual ------------- */

static int last_prefix(Ctx *t, int base, int log2size, int cidx) {
    int off, shift;
    if (cidx == 0) {
        off = 3 * (log2size - 2) + ((log2size - 1) >> 2);
        shift = (log2size + 1) >> 2;
    } else {
        off = 15;
        shift = log2size - 2;
    }
    int cmax = (log2size << 1) - 1;
    int v = 0;
    while (v < cmax && t->c.decode(base + off + (v >> shift))) v++;
    return v;
}

static int last_suffix(Ctx *t, int prefix) {
    if (prefix <= 3) return prefix;
    int nbits = (prefix >> 1) - 1;
    int suf = 0;
    for (int i = 0; i < nbits; i++) suf = (suf << 1) | t->c.bypass();
    return ((2 + (prefix & 1)) << nbits) + suf;
}

static int abs_remaining(Ctx *t, int rice) {
    int prefix = 0;
    while (prefix < 32 && t->c.bypass()) prefix++;
    if (prefix <= 3) {
        int suf = 0;
        for (int i = 0; i < rice; i++) suf = (suf << 1) | t->c.bypass();
        return (prefix << rice) + suf;
    }
    int nbits = prefix - 3 + rice;
    int suf = 0;
    for (int i = 0; i < nbits; i++) suf = (suf << 1) | t->c.bypass();
    return (((1 << (prefix - 3)) + 3 - 1) << rice) + suf;
}

static inline int sig_ctx(int xc, int yc, int sx, int sy,
                          const uint8_t *csbf, int sb_n, int log2size,
                          int cidx, int scan_idx) {
    int sig;
    if (log2size == 2) {
        sig = CTX_IDX_MAP[(yc << 2) + xc];
    } else if (xc + yc == 0) {
        sig = 0;
    } else {
        int right = (sx + 1 < sb_n) ? csbf[sy * sb_n + sx + 1] : 0;
        int below = (sy + 1 < sb_n) ? csbf[(sy + 1) * sb_n + sx] : 0;
        int prev = right | (below << 1);
        int xp = xc & 3, yp = yc & 3;
        if (prev == 0)      sig = (xp + yp == 0) ? 2 : (xp + yp < 3 ? 1 : 0);
        else if (prev == 1) sig = (yp == 0) ? 2 : (yp == 1 ? 1 : 0);
        else if (prev == 2) sig = (xp == 0) ? 2 : (xp == 1 ? 1 : 0);
        else                sig = 2;
        if (cidx == 0) {
            if (sx != 0 || sy != 0) sig += 3;
            sig += (log2size == 3) ? (scan_idx == 0 ? 9 : 15) : 21;
        } else {
            sig += (log2size == 3) ? 9 : 12;
        }
    }
    return sig + (cidx ? 27 : 0);
}

/* Decode one TU's coefficients into out (int32, `stride` row pitch),
 * positioned at (x0, y0) of that plane. */
static void residual(Ctx *t, int log2size, int cidx, int scan_idx,
                     int32_t *out, int stride, int x0, int y0) {
    Cabac &c = t->c;
    int n = 1 << log2size;
    if (t->tskip_enabled && log2size == 2) {
        if (c.decode(CTX_TRANSFORM_SKIP + (cidx ? 1 : 0))) {
            fail(t, E_TSKIP);
            return;
        }
    }
    int lx = last_prefix(t, CTX_LAST_SIG_X_PREFIX, log2size, cidx);
    int ly = last_prefix(t, CTX_LAST_SIG_Y_PREFIX, log2size, cidx);
    lx = last_suffix(t, lx);
    ly = last_suffix(t, ly);
    if (scan_idx == 2) { int tmp = lx; lx = ly; ly = tmp; }
    int sb_n = n >> 2; if (sb_n < 1) sb_n = 1;
    int sb_l = 0; while ((1 << sb_l) < sb_n) sb_l++;
    const uint8_t (*sb_scan)[2] = SC.xy[scan_idx][sb_l];
    const uint8_t (*in_scan)[2] = SC.xy[scan_idx][2];
    /* position-of lookup */
    int sb_pos[64], in_pos[16];
    for (int i = 0; i < sb_n * sb_n; i++)
        sb_pos[sb_scan[i][1] * sb_n + sb_scan[i][0]] = i;
    for (int i = 0; i < 16; i++)
        in_pos[in_scan[i][1] * 4 + in_scan[i][0]] = i;
    int i_last = sb_pos[(ly >> 2) * sb_n + (lx >> 2)];
    int k_last = in_pos[(ly & 3) * 4 + (lx & 3)];
    uint8_t csbf[64];
    memset(csbf, 0, sizeof csbf);
    int c1 = 1;
    for (int i = i_last; i >= 0; i--) {
        int sx = sb_scan[i][0], sy = sb_scan[i][1];
        int coded, infer_dc;
        if (i == i_last || i == 0) {
            coded = 1; infer_dc = 0;
        } else {
            int right = (sx + 1 < sb_n) ? csbf[sy * sb_n + sx + 1] : 0;
            int below = (sy + 1 < sb_n) ? csbf[(sy + 1) * sb_n + sx] : 0;
            int ctx = (right + below > 0 ? 1 : 0) + (cidx ? 2 : 0);
            coded = c.decode(CTX_SIG_COEFF_GROUP + ctx);
            infer_dc = 1;
        }
        csbf[sy * sb_n + sx] = (uint8_t)coded;
        if (!coded) continue;
        /* sig_coeff_flags: inner scan indices with sig, descending */
        int sig[16], nsig = 0;
        int start = (i == i_last) ? k_last - 1 : 15;
        if (i == i_last) sig[nsig++] = k_last;
        int found = nsig > 0;
        for (int k = start; k >= 0; k--) {
            if (k == 0 && infer_dc && !found) { sig[nsig++] = 0; break; }
            int xin = in_scan[k][0], yin = in_scan[k][1];
            int xc = (sx << 2) + xin, yc = (sy << 2) + yin;
            int ctx = sig_ctx(xc, yc, sx, sy, csbf, sb_n, log2size, cidx,
                              scan_idx);
            if (c.decode(CTX_SIG_COEFF_FLAG + ctx)) {
                sig[nsig++] = k;
                found = 1;
            }
        }
        if (!nsig) continue;
        /* greater1 / greater2 */
        int ctx_set = (i == 0 || cidx > 0) ? 0 : 2;
        if (c1 == 0) ctx_set += 1;
        c1 = 1;
        int base_g1 = CTX_COEFF_ABS_GREATER1 + (cidx ? 16 : 0) + 4 * ctx_set;
        int g1[8], first_g1 = -1;
        int ng1 = nsig < 8 ? nsig : 8;
        for (int j = 0; j < ng1; j++) {
            int b = c.decode(base_g1 + c1);
            g1[j] = b;
            if (b) {
                if (first_g1 < 0) first_g1 = j;
                c1 = 0;
            } else if (c1 > 0 && c1 < 3) {
                c1++;
            }
        }
        int g2 = 0;
        if (first_g1 >= 0)
            g2 = c.decode(CTX_COEFF_ABS_GREATER2 + (cidx ? 4 : 0) + ctx_set);
        /* signs */
        int hidden = t->sdh && (sig[0] - sig[nsig - 1] > 3);
        int nsigns = hidden ? nsig - 1 : nsig;
        int signs[16];
        for (int j = 0; j < nsigns; j++) signs[j] = c.bypass();
        /* levels */
        int rice = 0;
        long total = 0;
        int levels[16];
        for (int j = 0; j < nsig; j++) {
            int base = 1, thresh;
            if (j < 8) {
                base += g1[j];
                if (j == first_g1) base += g2;
                thresh = (j == first_g1) ? 3 : 2;
            } else {
                thresh = 1;
            }
            int level = base;
            if (base == thresh) {
                int rem = abs_remaining(t, rice);
                level += rem;
                if (level > (3 << rice)) rice = rice < 4 ? rice + 1 : 4;
            }
            total += level;
            levels[j] = level;
        }
        for (int j = 0; j < nsig; j++) {
            int k = sig[j];
            int xin = in_scan[k][0], yin = in_scan[k][1];
            int xc = (sx << 2) + xin, yc = (sy << 2) + yin;
            int neg = (j < nsigns) ? signs[j] : (int)(total & 1);
            out[(int64_t)(y0 + yc) * stride + (x0 + xc)] =
                neg ? -levels[j] : levels[j];
        }
    }
}

/* ---- plan recording (mirrors plan.record_luma_tu / record_chroma_tu) -- */

static void fill_cells(int32_t *grid, int stride, int cx, int cy,
                       int ncells, int32_t v) {
    for (int y = cy; y < cy + ncells; y++)
        for (int x = cx; x < cx + ncells; x++)
            grid[(int64_t)y * stride + x] = v;
}

static void record_luma_tu(Ctx *t, int x0, int y0, int n, int mode) {
    int cx = x0 >> 2, cy = y0 >> 2, nc = n >> 2;
    int log2 = 0; while ((1 << log2) < n) log2++;
    fill_cells(t->tu_log2_y, t->Wc, cx, cy, nc, log2);
    fill_cells(t->mode_y_o, t->Wc, cx, cy, nc, mode);
    fill_cells(t->zidx_y, t->Wc, cx, cy, nc, t->zctr++);
    fill_cells(t->qp_y, t->Wc, cx, cy, nc, t->qp);
    /* availability + intra deblock bS (bS 2 at TU edges off picture edge) */
    for (int y = cy; y < cy + nc; y++)
        for (int x = cx; x < cx + nc; x++)
            t->avail_y[y * t->cw + x] = 1;
    if (x0 > 0)
        for (int y = cy; y < cy + nc; y++)
            t->bs_ver[(int64_t)y * t->Wc + cx] = 2;
    if (y0 > 0)
        for (int x = cx; x < cx + nc; x++)
            t->bs_hor[(int64_t)cy * t->Wc + x] = 2;
}

static void record_chroma_tu(Ctx *t, int xc, int yc, int n, int mode) {
    int cx = xc >> 2, cy = yc >> 2, nc = n >> 2;
    int wc2 = t->Wc >> 1;
    int log2 = 0; while ((1 << log2) < n) log2++;
    fill_cells(t->tu_log2_c, wc2, cx, cy, nc, log2);
    fill_cells(t->mode_c_o, wc2, cx, cy, nc, mode);
    fill_cells(t->zidx_c, wc2, cx, cy, nc, t->zctr++);
}

/* ---- inter motion derivation (8.5.3.2), mirrors refdec.py ------------- */

static const int COMB_L0[12] = {0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3};
static const int COMB_L1[12] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2};
enum { PRED_L0 = 1, PRED_L1 = 2, PRED_BI = 3 };
enum { PART_2Nx2N = 0, PART_2NxN, PART_Nx2N, PART_NxN,
       PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N };

static inline int trunc_div(int a, int b) {
    int q = (a < 0 ? -a : a) / (b < 0 ? -b : b);
    return ((a < 0) != (b < 0)) ? -q : q;
}

static void scale_mv(int mv[2], int tb, int td) {
    if (td > 127) td = 127; if (td < -128) td = -128;
    if (tb > 127) tb = 127; if (tb < -128) tb = -128;
    int tx = trunc_div(16384 + ((td < 0 ? -td : td) >> 1), td);
    int dsf = (tb * tx + 32) >> 6;
    if (dsf > 4095) dsf = 4095; if (dsf < -4096) dsf = -4096;
    for (int k = 0; k < 2; k++) {
        long long v = (long long)dsf * mv[k];
        int s = v < 0 ? -1 : 1;
        long long av = v < 0 ? -v : v;
        long long out = s * ((av + 127) >> 8);
        if (out > 32767) out = 32767; if (out < -32768) out = -32768;
        mv[k] = (int)out;
    }
}

static inline int wrap16(int v) {
    return (int)(int16_t)(uint16_t)(v & 0xFFFF);
}

static inline int pb_avail(Ctx *t, int x, int y) {
    if (x < 0 || y < 0 || x >= t->w || y >= t->h) return 0;
    int cx = x >> 2, cy = y >> 2;
    InterCtx *it = t->it;
    return it->mot_done[cy * t->cw + cx] && !it->intra4[cy * t->cw + cx];
}

static void cell_motion(Ctx *t, int cx, int cy, MotCand *m) {
    InterCtx *it = t->it;
    int64_t i = (int64_t)cy * t->cw + cx;
    m->pred = 0;
    m->mv[0][0] = m->mv[0][1] = m->mv[1][0] = m->mv[1][1] = 0;
    m->ref_idx[0] = m->ref_idx[1] = -1;
    if (it->pred0[i]) {
        m->pred |= 1;
        m->mv[0][0] = it->mv0[i * 2]; m->mv[0][1] = it->mv0[i * 2 + 1];
        m->ref_idx[0] = it->refidx0[i];
    }
    if (it->pred1[i]) {
        m->pred |= 2;
        m->mv[1][0] = it->mv1[i * 2]; m->mv[1][1] = it->mv1[i * 2 + 1];
        m->ref_idx[1] = it->refidx1[i];
    }
}

/* TMVP (8.5.3.2.7/8). Returns 1 + fills mv when available. */
static int tmvp(Ctx *t, int xcb, int ycb, int xp, int yp, int w, int h,
                int lx, int ref_idx, int mv[2]) {
    InterCtx *it = t->it;
    if (!it->has_col) return 0;
    int target_poc = it->ref_poc_l[lx][ref_idx];
    for (int which = 0; which < 2; which++) {
        int xc, yc;
        if (which == 0) {
            xc = xp + w; yc = yp + h;
            if ((ycb >> t->log2_ctb) != (yc >> t->log2_ctb)) continue;
            if (xc >= t->w || yc >= t->h) continue;
        } else {
            xc = xp + (w >> 1); yc = yp + (h >> 1);
        }
        int cx = ((xc >> 4) << 4) >> 2, cy = ((yc >> 4) << 4) >> 2;
        if (cy >= t->ch || cx >= t->cw) continue;
        int64_t i = (int64_t)cy * t->cw + cx;
        if (it->col_intra[i]) continue;
        int p0 = it->col_pred0[i] != 0, p1 = it->col_pred1[i] != 0;
        if (!p0 && !p1) continue;
        int use;
        if (!p0) use = 1;
        else if (!p1) use = 0;
        else if (it->no_backward) use = lx;
        else use = it->col_from_l0 ? 1 : 0;
        const int32_t *cmv = use ? it->col_mv1 : it->col_mv0;
        const int32_t *crp = use ? it->col_refpoc1 : it->col_refpoc0;
        mv[0] = cmv[i * 2]; mv[1] = cmv[i * 2 + 1];
        int col_diff = it->col_poc - crp[i];
        int cur_diff = it->cur_poc - target_poc;
        if (col_diff != cur_diff) scale_mv(mv, cur_diff, col_diff);
        return 1;
    }
    return 0;
}

static void merge_cands(Ctx *t, int xcb, int ycb, int ncb, int xp, int yp,
                        int w, int h, int part_idx, int part, int want,
                        MotCand *out) {
    InterCtx *it = t->it;
    int is_b = it->slice_type == 0;
    MotCand cands[8];
    int n = 0;
    int max_merge = it->max_merge;
#define DONE() (n > want || n >= max_merge)
    MotCand a1m, b1m;
    int have_a1 = 0, have_b1 = 0;
    if (!((part == PART_Nx2N || part == PART_nLx2N || part == PART_nRx2N)
          && part_idx == 1)) {
        if (pb_avail(t, xp - 1, yp + h - 1)) {
            cell_motion(t, (xp - 1) >> 2, (yp + h - 1) >> 2, &a1m);
            have_a1 = 1;
            cands[n++] = a1m;
        }
    }
    if (!DONE() && !((part == PART_2NxN || part == PART_2NxnU ||
                      part == PART_2NxnD) && part_idx == 1)) {
        if (pb_avail(t, xp + w - 1, yp - 1)) {
            cell_motion(t, (xp + w - 1) >> 2, (yp - 1) >> 2, &b1m);
            have_b1 = 1;
            if (!have_a1 || !same_motion(b1m, a1m)) cands[n++] = b1m;
        }
    }
    if (!DONE() && pb_avail(t, xp + w, yp - 1)) {
        MotCand b0;
        cell_motion(t, (xp + w) >> 2, (yp - 1) >> 2, &b0);
        if (!have_b1 || !same_motion(b0, b1m)) cands[n++] = b0;
    }
    if (!DONE() && pb_avail(t, xp - 1, yp + h)) {
        MotCand a0;
        cell_motion(t, (xp - 1) >> 2, (yp + h) >> 2, &a0);
        if (!have_a1 || !same_motion(a0, a1m)) cands[n++] = a0;
    }
    if (!DONE() && n < 4 && pb_avail(t, xp - 1, yp - 1)) {
        MotCand b2;
        cell_motion(t, (xp - 1) >> 2, (yp - 1) >> 2, &b2);
        if ((!have_a1 || !same_motion(b2, a1m)) &&
            (!have_b1 || !same_motion(b2, b1m))) cands[n++] = b2;
    }
    if (!DONE() && it->tmvp_on) {
        MotCand tm;
        tm.pred = 0;
        tm.mv[0][0] = tm.mv[0][1] = tm.mv[1][0] = tm.mv[1][1] = 0;
        tm.ref_idx[0] = tm.ref_idx[1] = -1;
        int mv[2];
        if (tmvp(t, xcb, ycb, xp, yp, w, h, 0, 0, mv)) {
            tm.pred |= 1; tm.mv[0][0] = mv[0]; tm.mv[0][1] = mv[1];
            tm.ref_idx[0] = 0;
        }
        if (is_b && tmvp(t, xcb, ycb, xp, yp, w, h, 1, 0, mv)) {
            tm.pred |= 2; tm.mv[1][0] = mv[0]; tm.mv[1][1] = mv[1];
            tm.ref_idx[1] = 0;
        }
        if (tm.pred) cands[n++] = tm;
    }
    if (is_b && !DONE() && n > 1) {
        int norig = n;
        for (int k = 0; k < norig * (norig - 1) && !DONE(); k++) {
            int i0 = COMB_L0[k], i1 = COMB_L1[k];
            if (i0 >= norig || i1 >= norig) break;
            const MotCand &c0 = cands[i0], &c1 = cands[i1];
            if (!(c0.pred & 1) || !(c1.pred & 2)) continue;
            int p0 = it->ref_poc_l[0][c0.ref_idx[0]];
            int p1 = it->ref_poc_l[1][c1.ref_idx[1]];
            if (p0 == p1 && c0.mv[0][0] == c1.mv[1][0] &&
                c0.mv[0][1] == c1.mv[1][1]) continue;
            MotCand m;
            m.pred = PRED_BI;
            m.mv[0][0] = c0.mv[0][0]; m.mv[0][1] = c0.mv[0][1];
            m.mv[1][0] = c1.mv[1][0]; m.mv[1][1] = c1.mv[1][1];
            m.ref_idx[0] = c0.ref_idx[0]; m.ref_idx[1] = c1.ref_idx[1];
            cands[n++] = m;
        }
    }
    int nrefs = is_b ? (it->num_ref[0] < it->num_ref[1] ? it->num_ref[0]
                                                        : it->num_ref[1])
                     : it->num_ref[0];
    int zidx = 0;
    while (!DONE()) {
        MotCand m;
        int r = zidx < nrefs ? zidx : 0;
        m.pred = is_b ? PRED_BI : PRED_L0;
        m.mv[0][0] = m.mv[0][1] = m.mv[1][0] = m.mv[1][1] = 0;
        m.ref_idx[0] = r;
        m.ref_idx[1] = is_b ? r : -1;
        cands[n++] = m;
        zidx++;
    }
#undef DONE
    *out = cands[want];
}

/* AMVP (8.5.3.2.6): fills mvp[2][2]. */
static void amvp(Ctx *t, int xcb, int ycb, int ncb, int xp, int yp,
                 int w, int h, int part_idx, int part, int lx, int ref_idx,
                 int mvp_out[2][2]) {
    InterCtx *it = t->it;
    int target_poc = it->ref_poc_l[lx][ref_idx];

    /* same-ref-poc mv at cell, checking lx then 1-lx */
    auto same_ref_mv = [&](int x, int y, int mv[2]) -> int {
        int cx = x >> 2, cy = y >> 2;
        int64_t i = (int64_t)cy * t->cw + cx;
        const uint8_t *pr[2] = {it->pred0, it->pred1};
        const int32_t *mvs[2] = {it->mv0, it->mv1};
        const int32_t *rps[2] = {it->refpoc0, it->refpoc1};
        for (int pass = 0; pass < 2; pass++) {
            int ly = pass == 0 ? lx : 1 - lx;
            if (pr[ly][i] && rps[ly][i] == target_poc) {
                mv[0] = mvs[ly][i * 2]; mv[1] = mvs[ly][i * 2 + 1];
                return 1;
            }
        }
        return 0;
    };
    auto scaled = [&](int x, int y, int mv[2]) -> int {
        int cx = x >> 2, cy = y >> 2;
        int64_t i = (int64_t)cy * t->cw + cx;
        const uint8_t *pr[2] = {it->pred0, it->pred1};
        const int32_t *mvs[2] = {it->mv0, it->mv1};
        const int32_t *rps[2] = {it->refpoc0, it->refpoc1};
        for (int pass = 0; pass < 2; pass++) {
            int ly = pass == 0 ? lx : 1 - lx;
            if (pr[ly][i]) {
                mv[0] = mvs[ly][i * 2]; mv[1] = mvs[ly][i * 2 + 1];
                int col_diff = it->cur_poc - rps[ly][i];
                int cur_diff = it->cur_poc - target_poc;
                if (col_diff != cur_diff) scale_mv(mv, cur_diff, col_diff);
                return 1;
            }
        }
        return 0;
    };

    int pa[2][2] = {{xp - 1, yp + h}, {xp - 1, yp + h - 1}};
    int avail_p[2] = {pb_avail(t, pa[0][0], pa[0][1]),
                      pb_avail(t, pa[1][0], pa[1][1])};
    int is_scaled = avail_p[0] || avail_p[1];
    int mv_a[2], avail_a = 0;
    for (int k = 0; k < 2 && !avail_a; k++)
        if (avail_p[k] && same_ref_mv(pa[k][0], pa[k][1], mv_a)) avail_a = 1;
    if (!avail_a)
        for (int k = 0; k < 2 && !avail_a; k++)
            if (avail_p[k] && scaled(pa[k][0], pa[k][1], mv_a)) avail_a = 1;

    int pbs[3][2] = {{xp + w, yp - 1}, {xp + w - 1, yp - 1},
                     {xp - 1, yp - 1}};
    int mv_b[2], avail_b = 0;
    for (int k = 0; k < 3 && !avail_b; k++)
        if (pb_avail(t, pbs[k][0], pbs[k][1]) &&
            same_ref_mv(pbs[k][0], pbs[k][1], mv_b)) avail_b = 1;
    if (!is_scaled) {
        avail_a = avail_b;
        mv_a[0] = mv_b[0]; mv_a[1] = mv_b[1];
        avail_b = 0;
        for (int k = 0; k < 3 && !avail_b; k++)
            if (pb_avail(t, pbs[k][0], pbs[k][1]) &&
                scaled(pbs[k][0], pbs[k][1], mv_b)) avail_b = 1;
    }
    int nout = 0;
    if (avail_a) {
        mvp_out[nout][0] = mv_a[0]; mvp_out[nout][1] = mv_a[1]; nout++;
    }
    if (avail_b && (!avail_a || mv_b[0] != mv_a[0] || mv_b[1] != mv_a[1])) {
        mvp_out[nout][0] = mv_b[0]; mvp_out[nout][1] = mv_b[1]; nout++;
    }
    if (nout < 2 && it->tmvp_on) {
        int mv[2];
        if (tmvp(t, xcb, ycb, xp, yp, w, h, lx, ref_idx, mv)) {
            mvp_out[nout][0] = mv[0]; mvp_out[nout][1] = mv[1]; nout++;
        }
    }
    while (nout < 2) {
        mvp_out[nout][0] = 0; mvp_out[nout][1] = 0; nout++;
    }
}

static int eg_bypass_k(Cabac &c, int k) {
    int prefix = 0;
    while (c.bypass()) { prefix++; if (prefix > 30) return 0; }
    int suf = 0;
    for (int i = 0; i < prefix + k; i++) suf = (suf << 1) | c.bypass();
    return (((1 << prefix) - 1) << k) + suf;
}

static void mvd_coding(Ctx *t, int out[2]) {
    Cabac &c = t->c;
    int g0x = c.decode(CTX_ABS_MVD_GREATER0);
    int g0y = c.decode(CTX_ABS_MVD_GREATER0);
    int g1x = g0x ? c.decode(CTX_ABS_MVD_GREATER1 + 1) : 0;
    int g1y = g0y ? c.decode(CTX_ABS_MVD_GREATER1 + 1) : 0;
    int g0[2] = {g0x, g0y}, g1[2] = {g1x, g1y};
    for (int k = 0; k < 2; k++) {
        if (!g0[k]) { out[k] = 0; continue; }
        int v = 1;
        if (g1[k]) v = 2 + eg_bypass_k(c, 1);
        out[k] = c.bypass() ? -v : v;
    }
}

/* prediction unit (7.3.8.6): parse + derive motion + record. Returns
 * merge_flag of the PU. */
static int prediction_unit(Ctx *t, int xcb, int ycb, int ncb, int xp,
                           int yp, int w, int h, int part_idx, int part,
                           int skip) {
    Cabac &c = t->c;
    InterCtx *it = t->it;
    int is_b = it->slice_type == 0;
    int merge = 1;
    int pred = 0, mv[2][2] = {{0, 0}, {0, 0}}, ref_idx[2] = {-1, -1};
    if (!skip) merge = c.decode(CTX_MERGE_FLAG);
    if (merge) {
        int midx = 0;
        if (it->max_merge > 1) {
            if (c.decode(CTX_MERGE_IDX)) {
                midx = 1;
                while (midx < it->max_merge - 1 && c.bypass()) midx++;
            }
        }
        MotCand cand;
        merge_cands(t, xcb, ycb, ncb, xp, yp, w, h, part_idx, part, midx,
                    &cand);
        pred = cand.pred;
        for (int lx = 0; lx < 2; lx++) {
            mv[lx][0] = cand.mv[lx][0]; mv[lx][1] = cand.mv[lx][1];
            ref_idx[lx] = cand.ref_idx[lx];
        }
        if (pred == PRED_BI && w + h == 12) {
            pred = PRED_L0;
            ref_idx[1] = -1;
        }
    } else {
        if (is_b) {
            if (w + h != 12) {
                int depth = t->ct_depth[(yp >> 2) * t->cw + (xp >> 2)];
                if (c.decode(CTX_INTER_PRED_IDC + depth)) pred = PRED_BI;
                else pred = c.decode(CTX_INTER_PRED_IDC + 4) ? PRED_L1
                                                             : PRED_L0;
            } else {
                pred = c.decode(CTX_INTER_PRED_IDC + 4) ? PRED_L1 : PRED_L0;
            }
        } else {
            pred = PRED_L0;
        }
        for (int lx = 0; lx < 2; lx++) {
            if (!(pred & (1 << lx))) continue;
            int nref = it->num_ref[lx];
            int ridx = 0;
            if (nref > 1) {
                if (c.decode(CTX_REF_IDX_L0)) {
                    ridx = 1;
                    if (nref > 2 && c.decode(CTX_REF_IDX_L0 + 1)) {
                        ridx = 2;
                        while (ridx < nref - 1 && c.bypass()) ridx++;
                    }
                }
            }
            ref_idx[lx] = ridx;
            int mvd[2] = {0, 0};
            if (!(lx == 1 && it->mvd_l1_zero && pred == PRED_BI))
                mvd_coding(t, mvd);
            int mvp_flag = c.decode(CTX_MVP_LX_FLAG);
            int mvps[2][2];
            amvp(t, xcb, ycb, ncb, xp, yp, w, h, part_idx, part, lx, ridx,
                 mvps);
            mv[lx][0] = wrap16(mvps[mvp_flag][0] + mvd[0]);
            mv[lx][1] = wrap16(mvps[mvp_flag][1] + mvd[1]);
        }
    }
    /* store motion + record the plan PU */
    int cx0 = xp >> 2, cy0 = yp >> 2, cw4 = w >> 2, ch4 = h >> 2;
    for (int cy = cy0; cy < cy0 + ch4; cy++)
        for (int cx = cx0; cx < cx0 + cw4; cx++) {
            int64_t i = (int64_t)cy * t->cw + cx;
            it->pred0[i] = (pred & 1) != 0;
            it->pred1[i] = (pred & 2) != 0;
            it->mv0[i * 2] = (pred & 1) ? mv[0][0] : 0;
            it->mv0[i * 2 + 1] = (pred & 1) ? mv[0][1] : 0;
            it->mv1[i * 2] = (pred & 2) ? mv[1][0] : 0;
            it->mv1[i * 2 + 1] = (pred & 2) ? mv[1][1] : 0;
            it->refidx0[i] = (pred & 1) ? ref_idx[0] : -1;
            it->refidx1[i] = (pred & 2) ? ref_idx[1] : -1;
            it->refpoc0[i] = (pred & 1) ? it->ref_poc_l[0][ref_idx[0]] : 0;
            it->refpoc1[i] = (pred & 2) ? it->ref_poc_l[1][ref_idx[1]] : 0;
            it->mot_done[i] = 1;
            it->intra4[i] = 0;
            t->avail_y[i] = 1;
        }
    /* plan tensors (padded strides) */
    for (int cy = cy0; cy < cy0 + ch4; cy++)
        for (int cx = cx0; cx < cx0 + cw4; cx++) {
            int64_t ip = (int64_t)cy * t->Wc + cx;
            int64_t plane = (int64_t)t->Hc * t->Wc;
            t->it->inter4[ip] = 1;
            for (int lx = 0; lx < 2; lx++) {
                int on = (pred >> lx) & 1;
                it->pred_fl[lx * plane + ip] = (uint8_t)on;
                it->pmv[(lx * plane + ip) * 2] = on ? mv[lx][0] : 0;
                it->pmv[(lx * plane + ip) * 2 + 1] = on ? mv[lx][1] : 0;
                it->ref_slot_o[lx * plane + ip] =
                    on ? it->ref_slot_l[lx][ref_idx[lx]] : 0;
            }
        }
    for (int lx = 0; lx < 2; lx++) {
        if (!((pred >> lx) & 1)) continue;
        int ax = mv[lx][0] < 0 ? -mv[lx][0] : mv[lx][0];
        int ay = mv[lx][1] < 0 ? -mv[lx][1] : mv[lx][1];
        if (ax > 4 * 56 || ay > 4 * 56) it->mv_overflow = 1;
    }
    return merge;
}

static void mark_cu_edges(Ctx *t, int x0, int y0, int n) {
    InterCtx *it = t->it;
    int cx0 = x0 >> 2, cy0 = y0 >> 2, nc = n >> 2;
    for (int cy = cy0; cy < cy0 + nc && cy < t->ch; cy++) {
        it->pu_ev[cy * t->cw + cx0] = 1;
        it->tu_ev[cy * t->cw + cx0] = 1;
    }
    for (int cx = cx0; cx < cx0 + nc && cx < t->cw; cx++) {
        it->pu_eh[cy0 * t->cw + cx] = 1;
        it->tu_eh[cy0 * t->cw + cx] = 1;
    }
}

static void record_inter_cu_done(Ctx *t, int x0, int y0, int n) {
    int cx = x0 >> 2, cy = y0 >> 2, nc = n >> 2;
    fill_cells(t->zidx_y, t->Wc, cx, cy, nc, t->zctr++);
    fill_cells(t->zidx_c, t->Wc >> 1, cx >> 1, cy >> 1, nc >> 1, t->zctr++);
}

static int part_mode_inter(Ctx *t, int log2size) {
    Cabac &c = t->c;
    if (c.decode(CTX_PART_MODE)) return PART_2Nx2N;
    int at_min = log2size == t->log2_min_cb;
    int hor = c.decode(CTX_PART_MODE + 1);
    if (at_min) {
        if (hor) return PART_2NxN;
        if (log2size == 3) return PART_Nx2N;
        return c.decode(CTX_PART_MODE + 2) ? PART_Nx2N : PART_NxN;
    }
    if (!t->it->amp_enabled) return hor ? PART_2NxN : PART_Nx2N;
    if (c.decode(CTX_PART_MODE + 3)) return hor ? PART_2NxN : PART_Nx2N;
    int second = c.bypass();
    if (hor) return second ? PART_2NxnD : PART_2NxnU;
    return second ? PART_nRx2N : PART_nLx2N;
}

static int pu_geometry(int part, int x0, int y0, int n, int out[4][4]) {
    int h = n >> 1, q = n >> 2;
    switch (part) {
        case PART_2Nx2N:
            out[0][0]=x0; out[0][1]=y0; out[0][2]=n; out[0][3]=n; return 1;
        case PART_2NxN:
            out[0][0]=x0; out[0][1]=y0; out[0][2]=n; out[0][3]=h;
            out[1][0]=x0; out[1][1]=y0+h; out[1][2]=n; out[1][3]=h; return 2;
        case PART_Nx2N:
            out[0][0]=x0; out[0][1]=y0; out[0][2]=h; out[0][3]=n;
            out[1][0]=x0+h; out[1][1]=y0; out[1][2]=h; out[1][3]=n; return 2;
        case PART_NxN:
            out[0][0]=x0; out[0][1]=y0; out[0][2]=h; out[0][3]=h;
            out[1][0]=x0+h; out[1][1]=y0; out[1][2]=h; out[1][3]=h;
            out[2][0]=x0; out[2][1]=y0+h; out[2][2]=h; out[2][3]=h;
            out[3][0]=x0+h; out[3][1]=y0+h; out[3][2]=h; out[3][3]=h;
            return 4;
        case PART_2NxnU:
            out[0][0]=x0; out[0][1]=y0; out[0][2]=n; out[0][3]=q;
            out[1][0]=x0; out[1][1]=y0+q; out[1][2]=n; out[1][3]=n-q;
            return 2;
        case PART_2NxnD:
            out[0][0]=x0; out[0][1]=y0; out[0][2]=n; out[0][3]=n-q;
            out[1][0]=x0; out[1][1]=y0+n-q; out[1][2]=n; out[1][3]=q;
            return 2;
        case PART_nLx2N:
            out[0][0]=x0; out[0][1]=y0; out[0][2]=q; out[0][3]=n;
            out[1][0]=x0+q; out[1][1]=y0; out[1][2]=n-q; out[1][3]=n;
            return 2;
        default:
            out[0][0]=x0; out[0][1]=y0; out[0][2]=n-q; out[0][3]=n;
            out[1][0]=x0+n-q; out[1][1]=y0; out[1][2]=q; out[1][3]=n;
            return 2;
    }
}


/* ---- intra CU syntax (mirrors refdec._intra_cu + _transform_tree) ----- */

static void mpm(Ctx *t, int px, int py, int *cands) {
    int cx = px >> 2, cy = py >> 2;
    int a = IP_DC, b = IP_DC;
    if (px > 0 && t->mode_avail[cy * t->cw + cx - 1])
        a = t->mode_y[cy * t->cw + cx - 1];
    if (py > 0 && t->mode_avail[(cy - 1) * t->cw + cx] &&
            (py % (1 << t->log2_ctb)) != 0)
        b = t->mode_y[(cy - 1) * t->cw + cx];
    if (a == b) {
        if (a < 2) {
            cands[0] = IP_PLANAR; cands[1] = IP_DC; cands[2] = IP_VER;
        } else {
            cands[0] = a;
            cands[1] = 2 + ((a + 29) % 32);
            cands[2] = 2 + ((a - 2 + 1) % 32);
        }
        return;
    }
    cands[0] = a;
    cands[1] = b;
    if (a != IP_PLANAR && b != IP_PLANAR) cands[2] = IP_PLANAR;
    else if (a != IP_DC && b != IP_DC)    cands[2] = IP_DC;
    else                                  cands[2] = IP_VER;
}

static inline int scan_for(int mode, int log2size, int cidx) {
    if (log2size == 2 || (log2size == 3 && cidx == 0)) {
        if (mode >= 6 && mode <= 14) return 2;
        if (mode >= 22 && mode <= 30) return 1;
    }
    return 0;
}

static int luma_mode_at(Ctx *t, int x0, int y0) {
    if (!t->cu_part_nxn) return t->cu_modes[0];
    int half = 1 << (t->cu_log2 - 1);
    int j = ((y0 - t->cu_y0) >= half) * 2 + ((x0 - t->cu_x0) >= half);
    return t->cu_modes[j];
}

static void chroma_unit(Ctx *t, int xc, int yc, int log2size,
                        int cbf_cb, int cbf_cr) {
    int mode = t->cu_cmode;
    if (cbf_cb) {
        int scan = scan_for(mode, log2size, 1);
        residual(t, log2size, 1, scan, t->coeff_cb, t->Wp >> 1, xc, yc);
        if (t->err) return;
    }
    if (cbf_cr) {
        int scan = scan_for(mode, log2size, 2);
        residual(t, log2size, 2, scan, t->coeff_cr, t->Wp >> 1, xc, yc);
        if (t->err) return;
    }
    record_chroma_tu(t, xc, yc, 1 << log2size, mode);
}

static void inter_chroma_unit(Ctx *t, int xc, int yc, int log2size,
                              int cbf_cb, int cbf_cr) {
    int n = 1 << log2size;
    if (cbf_cb) {
        residual(t, log2size, 1, 0, t->coeff_cb, t->Wp >> 1, xc, yc);
        if (t->err) return;
    }
    if (cbf_cr) {
        residual(t, log2size, 2, 0, t->coeff_cr, t->Wp >> 1, xc, yc);
        if (t->err) return;
    }
    if (cbf_cb || cbf_cr)
        fill_cells(t->it->tu_inter_c, t->Wc >> 1, xc >> 2, yc >> 2, n >> 2,
                   log2size);
}

static void transform_unit(Ctx *t, int x0, int y0, int x_base, int y_base,
                           int log2size, int blk_idx, int cbf_luma,
                           int cbf_cb, int cbf_cr) {
    int n = 1 << log2size;
    if (t->it) {
        /* deblock state (finish_bs runs in Python over these cells) */
        InterCtx *it = t->it;
        int cx0 = x0 >> 2, cy0 = y0 >> 2, nc = n >> 2;
        for (int cy = cy0; cy < cy0 + nc && cy < t->ch; cy++)
            if (cx0 < t->cw) it->tu_ev[cy * t->cw + cx0] = 1;
        for (int cx = cx0; cx < cx0 + nc && cx < t->cw; cx++)
            if (cy0 < t->ch) it->tu_eh[cy0 * t->cw + cx] = 1;
        for (int cy = cy0; cy < cy0 + nc && cy < t->ch; cy++)
            for (int cx = cx0; cx < cx0 + nc && cx < t->cw; cx++)
                it->cbf4[cy * t->cw + cx] = (uint8_t)cbf_luma;
    }
    if (t->cu_is_inter) {
        if (cbf_luma) {
            residual(t, log2size, 0, 0, t->coeff_y, t->Wp, x0, y0);
            if (t->err) return;
            fill_cells(t->it->tu_inter_y, t->Wc, x0 >> 2, y0 >> 2, n >> 2,
                       log2size);
        }
        if (log2size > 2)
            inter_chroma_unit(t, x0 >> 1, y0 >> 1, log2size - 1,
                              cbf_cb, cbf_cr);
        else if (blk_idx == 3)
            inter_chroma_unit(t, x_base >> 1, y_base >> 1, 2,
                              cbf_cb, cbf_cr);
        return;
    }
    int mode = luma_mode_at(t, x0, y0);
    if (cbf_luma) {
        int scan = scan_for(mode, log2size, 0);
        residual(t, log2size, 0, scan, t->coeff_y, t->Wp, x0, y0);
        if (t->err) return;
    }
    record_luma_tu(t, x0, y0, 1 << log2size, mode);
    if (log2size > 2)
        chroma_unit(t, x0 >> 1, y0 >> 1, log2size - 1, cbf_cb, cbf_cr);
    else if (blk_idx == 3)
        chroma_unit(t, x_base >> 1, y_base >> 1, 2, cbf_cb, cbf_cr);
}

static void transform_tree(Ctx *t, int x0, int y0, int x_base, int y_base,
                           int log2size, int depth, int blk_idx,
                           int max_depth, int intra_split,
                           int parent_cbf_cb, int parent_cbf_cr) {
    if (t->err) return;
    Cabac &c = t->c;
    int split;
    if (log2size <= t->log2_max_tb && log2size > t->log2_min_tb &&
            depth < max_depth && !(intra_split && depth == 0)) {
        split = c.decode(CTX_SPLIT_TRANSFORM_FLAG + 5 - log2size);
    } else {
        split = (log2size > t->log2_max_tb) || (intra_split && depth == 0);
        if (log2size <= t->log2_min_tb) split = 0;
    }
    int cbf_cb = parent_cbf_cb, cbf_cr = parent_cbf_cr;
    if (log2size > 2) {
        if (depth == 0 || parent_cbf_cb)
            cbf_cb = c.decode(CTX_CBF_CB_CR + depth);
        else
            cbf_cb = 0;
        if (depth == 0 || parent_cbf_cr)
            cbf_cr = c.decode(CTX_CBF_CB_CR + depth);
        else
            cbf_cr = 0;
    }
    if (split) {
        int half = 1 << (log2size - 1);
        static const int DXY[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
        for (int i = 0; i < 4; i++)
            transform_tree(t, x0 + DXY[i][0] * half, y0 + DXY[i][1] * half,
                           x0, y0, log2size - 1, depth + 1, i, max_depth,
                           intra_split, cbf_cb, cbf_cr);
        return;
    }
    int cbf_luma;
    if (!t->cu_is_inter || depth != 0 || cbf_cb || cbf_cr)
        cbf_luma = c.decode(CTX_CBF_LUMA + (depth == 0 ? 1 : 0));
    else
        cbf_luma = 1;   /* inferred for an inter CU with rqt_root_cbf */
    transform_unit(t, x0, y0, x_base, y_base, log2size, blk_idx,
                   cbf_luma, cbf_cb, cbf_cr);
}

static void intra_cu(Ctx *t, int x0, int y0, int log2size) {
    Cabac &c = t->c;
    int n = 1 << log2size;
    t->cu_is_inter = 0;
    if (t->it) {
        int cx0 = x0 >> 2, cy0 = y0 >> 2, nc = n >> 2;
        for (int cy = cy0; cy < cy0 + nc && cy < t->ch; cy++)
            for (int cx = cx0; cx < cx0 + nc && cx < t->cw; cx++)
                t->it->intra4[cy * t->cw + cx] = 1;
        /* CU edges == outer TU edges for intra (marked per leaf TU);
         * mot_done stays 0, matching refdec (intra cells are never
         * merge/AMVP sources) */
    }
    int part_nxn = 0;
    if (log2size == t->log2_min_cb)
        if (!c.decode(CTX_PART_MODE)) part_nxn = 1;
    int npu = part_nxn ? 2 : 1;
    int pb = n >> (npu - 1);
    int prev_flags[4];
    for (int j = 0; j < npu * npu; j++)
        prev_flags[j] = c.decode(CTX_PREV_INTRA_LUMA_PRED);
    int modes[4];
    for (int j = 0; j < npu * npu; j++) {
        int px = x0 + (j & 1) * pb;
        int py = y0 + (j >> 1) * pb;
        int cands[3];
        mpm(t, px, py, cands);
        int mode;
        if (prev_flags[j]) {
            mode = cands[c.tr_bypass(2)];
        } else {
            int rem = 0;
            for (int k = 0; k < 5; k++) rem = (rem << 1) | c.bypass();
            mode = rem;
            /* add 1 for each candidate <= mode, in ascending cand order */
            int s0 = cands[0], s1 = cands[1], s2 = cands[2], tmp;
            if (s0 > s1) { tmp = s0; s0 = s1; s1 = tmp; }
            if (s1 > s2) { tmp = s1; s1 = s2; s2 = tmp; }
            if (s0 > s1) { tmp = s0; s0 = s1; s1 = tmp; }
            if (mode >= s0) mode++;
            if (mode >= s1) mode++;
            if (mode >= s2) mode++;
        }
        modes[j] = mode;
        int cx = px >> 2, cy = py >> 2, nc = pb >> 2;
        for (int y = cy; y < cy + nc; y++)
            for (int x = cx; x < cx + nc; x++) {
                t->mode_y[y * t->cw + x] = (uint8_t)mode;
                t->mode_avail[y * t->cw + x] = 1;
            }
    }
    int cmode;
    if (c.decode(CTX_INTRA_CHROMA_PRED_MODE)) {
        int idx = (c.bypass() << 1) | c.bypass();
        static const int CAND[4] = {IP_PLANAR, IP_VER, IP_HOR, IP_DC};
        int cand = CAND[idx];
        cmode = (cand == modes[0]) ? 34 : cand;
    } else {
        cmode = modes[0];
    }
    t->cu_cmode = cmode;
    for (int j = 0; j < npu * npu; j++) t->cu_modes[j] = modes[j];
    t->cu_part_nxn = part_nxn;
    t->cu_x0 = x0; t->cu_y0 = y0; t->cu_log2 = log2size;
    int max_depth = t->max_tdepth_intra + (part_nxn ? 1 : 0);
    transform_tree(t, x0, y0, x0, y0, log2size, 0, 0, max_depth,
                   part_nxn, 1, 1);
}

static void inter_cu(Ctx *t, int x0, int y0, int log2size) {
    Cabac &c = t->c;
    int n = 1 << log2size;
    t->cu_is_inter = 1;
    int part = part_mode_inter(t, log2size);
    int geo[4][4];
    int npu = pu_geometry(part, x0, y0, n, geo);
    int first_merge = 0;
    for (int i = 0; i < npu; i++) {
        int m = prediction_unit(t, x0, y0, n, geo[i][0], geo[i][1],
                                geo[i][2], geo[i][3], i, part, 0);
        if (i == 0) first_merge = m;
    }
    mark_cu_edges(t, x0, y0, n);
    if (part != PART_2Nx2N) {
        InterCtx *it = t->it;
        for (int i = 1; i < npu; i++) {
            int xp = geo[i][0], yp = geo[i][1], w = geo[i][2], h = geo[i][3];
            for (int cy = yp >> 2; cy < (yp + h) >> 2 && cy < t->ch; cy++)
                it->pu_ev[cy * t->cw + (xp >> 2)] = 1;
            for (int cx = xp >> 2; cx < (xp + w) >> 2 && cx < t->cw; cx++)
                it->pu_eh[(yp >> 2) * t->cw + cx] = 1;
        }
    }
    int rqt_root_cbf = 1;
    if (!(part == PART_2Nx2N && first_merge))
        rqt_root_cbf = c.decode(CTX_NO_RESIDUAL_DATA);
    if (rqt_root_cbf) {
        int inter_split = (t->it->max_tdepth_inter == 0 &&
                           part != PART_2Nx2N);
        t->cu_x0 = x0; t->cu_y0 = y0; t->cu_log2 = log2size;
        transform_tree(t, x0, y0, x0, y0, log2size, 0, 0,
                       t->it->max_tdepth_inter, inter_split, 1, 1);
    }
    record_inter_cu_done(t, x0, y0, n);
}

static void coding_unit(Ctx *t, int x0, int y0, int log2size, int depth) {
    if (t->err) return;
    int n = 1 << log2size;
    int cx = x0 >> 2, cy = y0 >> 2, nc = n >> 2;
    for (int y = cy; y < cy + nc; y++)
        for (int x = cx; x < cx + nc; x++)
            t->ct_depth[y * t->cw + x] = (uint8_t)depth;
    if (t->tqbypass_enabled) {
        if (t->c.decode(CTX_CU_TRANSQUANT_BYPASS)) {
            fail(t, E_TQBYPASS);
            return;
        }
    }
    if (t->it) {
        InterCtx *it = t->it;
        int ctx = 0;
        if (x0 > 0 && t->avail_y[cy * t->cw + cx - 1])
            ctx += it->skip4[cy * t->cw + cx - 1];
        if (y0 > 0 && t->avail_y[(cy - 1) * t->cw + cx])
            ctx += it->skip4[(cy - 1) * t->cw + cx];
        if (t->c.decode(CTX_SKIP_FLAG + ctx)) {
            for (int y = cy; y < cy + nc && y < t->ch; y++)
                for (int x = cx; x < cx + nc && x < t->cw; x++)
                    it->skip4[y * t->cw + x] = 1;
            t->cu_is_inter = 1;
            prediction_unit(t, x0, y0, n, x0, y0, n, n, 0, PART_2Nx2N, 1);
            mark_cu_edges(t, x0, y0, n);
            record_inter_cu_done(t, x0, y0, n);
            return;
        }
        if (!t->c.decode(CTX_PRED_MODE_FLAG)) {
            inter_cu(t, x0, y0, log2size);
            return;
        }
    }
    intra_cu(t, x0, y0, log2size);
}

static void coding_quadtree(Ctx *t, int x0, int y0, int log2size,
                            int depth) {
    if (t->err) return;
    int inside = (x0 + (1 << log2size) <= t->w) &&
                 (y0 + (1 << log2size) <= t->h);
    int split;
    if (inside && log2size > t->log2_min_cb) {
        int ctx = 0;
        int cx = x0 >> 2, cy = y0 >> 2;
        if (x0 > 0 && t->avail_y[cy * t->cw + cx - 1])
            ctx += t->ct_depth[cy * t->cw + cx - 1] > depth;
        if (y0 > 0 && t->avail_y[(cy - 1) * t->cw + cx])
            ctx += t->ct_depth[(cy - 1) * t->cw + cx] > depth;
        split = t->c.decode(CTX_SPLIT_CU_FLAG + ctx);
    } else {
        split = log2size > t->log2_min_cb;
    }
    if (split) {
        int half = 1 << (log2size - 1);
        static const int DXY[4][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}};
        for (int i = 0; i < 4; i++) {
            int nx = x0 + DXY[i][0] * half, ny = y0 + DXY[i][1] * half;
            if (nx < t->w && ny < t->h)
                coding_quadtree(t, nx, ny, log2size - 1, depth + 1);
        }
    } else {
        coding_unit(t, x0, y0, log2size, depth);
    }
}

/* ---- SAO syntax per CTB (mirrors refdec._sao_syntax) ------------------- */

static void sao_copy(Ctx *t, int dst, int src) {
    for (int ci = 0; ci < 3; ci++) {
        t->sao_type[dst * 3 + ci] = t->sao_type[src * 3 + ci];
        t->sao_band[dst * 3 + ci] = t->sao_band[src * 3 + ci];
        t->sao_eo[dst * 3 + ci] = t->sao_eo[src * 3 + ci];
        for (int k = 0; k < 4; k++)
            t->sao_offsets[(dst * 3 + ci) * 4 + k] =
                t->sao_offsets[(src * 3 + ci) * 4 + k];
    }
}

static void sao_syntax(Ctx *t, int xc, int yc, const uint8_t *done) {
    Cabac &c = t->c;
    int idx = yc * t->ctb_w + xc;
    /* single-slice picture: left/up in-slice iff already processed */
    if (xc > 0 && done[idx - 1]) {
        if (c.decode(CTX_SAO_MERGE_FLAG)) { sao_copy(t, idx, idx - 1); return; }
    }
    if (yc > 0 && done[idx - t->ctb_w]) {
        if (c.decode(CTX_SAO_MERGE_FLAG)) {
            sao_copy(t, idx, idx - t->ctb_w);
            return;
        }
    }
    enum { OFF = 0, BAND = 1, EDGE = 2 };
    int type[3] = {OFF, OFF, OFF};
    for (int ci = 0; ci < 3; ci++) {
        if ((ci == 0 && !t->sao_luma) || (ci > 0 && !t->sao_chroma))
            continue;
        if (ci <= 1) {
            if (!c.decode(CTX_SAO_TYPE_IDX)) type[ci] = OFF;
            else type[ci] = c.bypass() ? EDGE : BAND;
        } else {
            type[2] = type[1];
        }
        t->sao_type[idx * 3 + ci] = type[ci];
        if (type[ci] == OFF) continue;
        int absv[4];
        for (int k = 0; k < 4; k++) absv[k] = c.tr_bypass(7);
        if (type[ci] == BAND) {
            for (int k = 0; k < 4; k++) {
                int v = absv[k];
                if (v && c.bypass()) v = -v;
                t->sao_offsets[(idx * 3 + ci) * 4 + k] = v;
            }
            t->sao_band[idx * 3 + ci] =
                (c.bypass() << 4) | (c.bypass() << 3) | (c.bypass() << 2) |
                (c.bypass() << 1) | c.bypass();
        } else {
            t->sao_offsets[(idx * 3 + ci) * 4 + 0] = absv[0];
            t->sao_offsets[(idx * 3 + ci) * 4 + 1] = absv[1];
            t->sao_offsets[(idx * 3 + ci) * 4 + 2] = -absv[2];
            t->sao_offsets[(idx * 3 + ci) * 4 + 3] = -absv[3];
            if (ci == 0) {
                t->sao_eo[idx * 3 + 0] = (c.bypass() << 1) | c.bypass();
            } else if (ci == 1) {
                int eo = (c.bypass() << 1) | c.bypass();
                t->sao_eo[idx * 3 + 1] = eo;
                t->sao_eo[idx * 3 + 2] = eo;
            }
        }
    }
}

}  /* namespace */

/* ---- entry point ------------------------------------------------------- */

extern "C" {

/* iparams layout (int32):
 *  0 coded width   1 coded height  2 log2_ctb      3 log2_min_cb
 *  4 log2_min_tb   5 log2_max_tb   6 max_transform_hierarchy_depth_intra
 *  7 slice_qp      8 init_type     9 sao_luma     10 sao_chroma
 * 11 wpp          12 sign_data_hiding             13 transform_skip_enabled
 * 14 transquant_bypass_enabled    15 pcm_enabled  16 segment_address
 * 17 n_substreams
 * Returns number of CTBs parsed (>0) or a negative error code. */
int jmx_hevc_parse_i_slice(
        const uint8_t *rbsp, int64_t nbytes, int64_t bit_pos,
        const int32_t *iparams, const int64_t *substream_byte_off,
        int32_t *coeff_y, int32_t *tu_log2_y, int32_t *mode_y,
        int32_t *zidx_y, int32_t *qp_y,
        int32_t *coeff_cb, int32_t *coeff_cr,
        int32_t *tu_log2_c, int32_t *mode_c, int32_t *zidx_c,
        int32_t *bs_ver, int32_t *bs_hor,
        int32_t *sao_type, int32_t *sao_offsets, int32_t *sao_band,
        int32_t *sao_eo,
        uint8_t *scratch /* >= 5 * cw * ch bytes */) {
    Ctx t;
    memset((void *)&t, 0, sizeof(Ctx));
    t.w = iparams[0]; t.h = iparams[1];
    t.log2_ctb = iparams[2]; t.log2_min_cb = iparams[3];
    t.log2_min_tb = iparams[4]; t.log2_max_tb = iparams[5];
    t.max_tdepth_intra = iparams[6];
    t.qp = iparams[7]; t.init_type = iparams[8];
    t.sao_luma = iparams[9]; t.sao_chroma = iparams[10];
    t.wpp = iparams[11]; t.sdh = iparams[12];
    t.tskip_enabled = iparams[13];
    t.tqbypass_enabled = iparams[14];
    int pcm_enabled = iparams[15];
    int seg_addr = iparams[16];
    int n_sub = iparams[17];
    if (pcm_enabled) return E_PCM;
    if (seg_addr != 0) return E_NOTINTRA;  /* single-slice pictures only */
    int ctb = 1 << t.log2_ctb;
    t.ctb_w = (t.w + ctb - 1) >> t.log2_ctb;
    t.ctb_h = (t.h + ctb - 1) >> t.log2_ctb;
    t.Wp = t.ctb_w * ctb; t.Hp = t.ctb_h * ctb;
    t.Wc = t.Wp >> 2; t.Hc = t.Hp >> 2;
    t.cw = (t.w + 3) >> 2; t.ch = (t.h + 3) >> 2;
    t.coeff_y = coeff_y; t.tu_log2_y = tu_log2_y; t.mode_y_o = mode_y;
    t.zidx_y = zidx_y; t.qp_y = qp_y;
    t.coeff_cb = coeff_cb; t.coeff_cr = coeff_cr;
    t.tu_log2_c = tu_log2_c; t.mode_c_o = mode_c; t.zidx_c = zidx_c;
    t.bs_ver = bs_ver; t.bs_hor = bs_hor;
    t.sao_type = sao_type; t.sao_offsets = sao_offsets;
    t.sao_band = sao_band; t.sao_eo = sao_eo;
    t.zctr = 0;
    size_t cells = (size_t)t.cw * t.ch;
    t.avail_y = scratch;
    t.mode_avail = scratch + cells;
    t.mode_y = scratch + 2 * cells;
    t.ct_depth = scratch + 3 * cells;
    uint8_t *ctb_done = scratch + 4 * cells;  /* ctb_w*ctb_h <= cells */
    memset(scratch, 0, 5 * cells);
    memset(t.mode_y, IP_DC, cells);

    t.c.start(rbsp, nbytes, bit_pos, t.qp, t.init_type);
    uint8_t saved_state[HEVC_NCTX], saved_mps[HEVC_NCTX];
    int have_saved = 0;
    int addr = seg_addr;
    int sub_idx = 0;
    int n_ctbs = 0;
    for (;;) {
        int xc = addr % t.ctb_w, yc = addr / t.ctb_w;
        if (t.wpp && xc == 0 && addr != seg_addr) {
            /* row start: sync from storage after top-right CTB (9.3.1) */
            int top_right = (t.ctb_w > 1 ? 1 : 0);
            if (t.ctb_w > 1 &&
                    ctb_done[(yc - 1) * t.ctb_w + top_right] && have_saved)
                t.c.load(saved_state, saved_mps);
            else
                t.c.init_contexts(t.qp, t.init_type);
        }
        if (t.sao_luma || t.sao_chroma)
            sao_syntax(&t, xc, yc, ctb_done);
        coding_quadtree(&t, xc << t.log2_ctb, yc << t.log2_ctb,
                        t.log2_ctb, 0);
        if (t.err) return t.err;
        ctb_done[yc * t.ctb_w + xc] = 1;
        n_ctbs++;
        if (t.wpp && xc == 1) {
            t.c.save(saved_state, saved_mps);
            have_saved = 1;
        }
        int end = t.c.terminate();
        addr++;
        if (end) break;
        if (addr >= t.ctb_w * t.ctb_h) return E_OVERRUN;
        if (t.wpp && addr % t.ctb_w == 0) {
            if (!t.c.terminate()) return E_SUBSET;
            if (sub_idx < n_sub) {
                t.c.reposition(substream_byte_off[sub_idx] * 8);
                sub_idx++;
            } else {
                t.c.align_and_reinit();
            }
        }
    }
    return n_ctbs;
}


/* P/B slice parse: intra layout + inter params/pointers.
 * ip2 layout (int32):
 *  0 slice_type(0 B,1 P)  1 num_ref_l0   2 num_ref_l1  3 max_merge
 *  4 tmvp_on   5 col_from_l0  6 col_ref_idx  7 mvd_l1_zero
 *  8 no_backward  9 cur_poc  10 max_tdepth_inter  11 amp_enabled
 * 12 has_col  13 col_poc
 * ref_poc / ref_slot: [2][16] int32.
 * state grids are coded-cell-sized [ch][cw] (outputs, zero-initialised by
 * the caller); plan grids padded [Hc][Wc].
 * Returns n_ctbs (>0), or <0; -40 = motion beyond the device MC pad (the
 * parse is still complete and correct — caller marks plan unsupported). */
int jmx_hevc_parse_pb_slice(
        const uint8_t *rbsp, int64_t nbytes, int64_t bit_pos,
        const int32_t *iparams, const int64_t *substream_byte_off,
        int32_t *coeff_y, int32_t *tu_log2_y, int32_t *mode_y,
        int32_t *zidx_y, int32_t *qp_y,
        int32_t *coeff_cb, int32_t *coeff_cr,
        int32_t *tu_log2_c, int32_t *mode_c, int32_t *zidx_c,
        int32_t *bs_ver, int32_t *bs_hor,
        int32_t *sao_type, int32_t *sao_offsets, int32_t *sao_band,
        int32_t *sao_eo,
        uint8_t *scratch,
        const int32_t *ip2, const int32_t *ref_poc, const int32_t *ref_slot,
        const uint8_t *col_pred0, const uint8_t *col_pred1,
        const uint8_t *col_intra,
        const int32_t *col_mv0, const int32_t *col_mv1,
        const int32_t *col_refpoc0, const int32_t *col_refpoc1,
        uint8_t *pred0, uint8_t *pred1, int32_t *mv0, int32_t *mv1,
        int32_t *refidx0, int32_t *refidx1,
        int32_t *refpoc0, int32_t *refpoc1,
        uint8_t *mot_done, uint8_t *intra4, uint8_t *skip4, uint8_t *cbf4,
        uint8_t *tu_ev, uint8_t *tu_eh, uint8_t *pu_ev, uint8_t *pu_eh,
        uint8_t *inter4, int32_t *pmv, int32_t *ref_slot_o,
        uint8_t *pred_fl, int32_t *tu_inter_y, int32_t *tu_inter_c) {
    Ctx t;
    memset((void *)&t, 0, sizeof(Ctx));
    InterCtx it;
    memset((void *)&it, 0, sizeof(InterCtx));
    t.it = &it;
    t.w = iparams[0]; t.h = iparams[1];
    t.log2_ctb = iparams[2]; t.log2_min_cb = iparams[3];
    t.log2_min_tb = iparams[4]; t.log2_max_tb = iparams[5];
    t.max_tdepth_intra = iparams[6];
    t.qp = iparams[7]; t.init_type = iparams[8];
    t.sao_luma = iparams[9]; t.sao_chroma = iparams[10];
    t.wpp = iparams[11]; t.sdh = iparams[12];
    t.tskip_enabled = iparams[13];
    t.tqbypass_enabled = iparams[14];
    int pcm_enabled = iparams[15];
    int seg_addr = iparams[16];
    int n_sub = iparams[17];
    if (pcm_enabled) return E_PCM;
    if (seg_addr != 0) return E_NOTINTRA;
    int ctb = 1 << t.log2_ctb;
    t.ctb_w = (t.w + ctb - 1) >> t.log2_ctb;
    t.ctb_h = (t.h + ctb - 1) >> t.log2_ctb;
    t.Wp = t.ctb_w * ctb; t.Hp = t.ctb_h * ctb;
    t.Wc = t.Wp >> 2; t.Hc = t.Hp >> 2;
    t.cw = (t.w + 3) >> 2; t.ch = (t.h + 3) >> 2;
    t.coeff_y = coeff_y; t.tu_log2_y = tu_log2_y; t.mode_y_o = mode_y;
    t.zidx_y = zidx_y; t.qp_y = qp_y;
    t.coeff_cb = coeff_cb; t.coeff_cr = coeff_cr;
    t.tu_log2_c = tu_log2_c; t.mode_c_o = mode_c; t.zidx_c = zidx_c;
    t.bs_ver = bs_ver; t.bs_hor = bs_hor;
    t.sao_type = sao_type; t.sao_offsets = sao_offsets;
    t.sao_band = sao_band; t.sao_eo = sao_eo;
    t.zctr = 0;
    it.slice_type = ip2[0];
    it.num_ref[0] = ip2[1]; it.num_ref[1] = ip2[2];
    it.max_merge = ip2[3];
    it.tmvp_on = ip2[4]; it.col_from_l0 = ip2[5];
    it.col_ref_idx = ip2[6]; it.mvd_l1_zero = ip2[7];
    it.no_backward = ip2[8]; it.cur_poc = ip2[9];
    it.max_tdepth_inter = ip2[10]; it.amp_enabled = ip2[11];
    it.has_col = ip2[12]; it.col_poc = ip2[13];
    for (int lx = 0; lx < 2; lx++)
        for (int k = 0; k < 16; k++) {
            it.ref_poc_l[lx][k] = ref_poc[lx * 16 + k];
            it.ref_slot_l[lx][k] = ref_slot[lx * 16 + k];
        }
    it.col_pred0 = col_pred0; it.col_pred1 = col_pred1;
    it.col_intra = col_intra;
    it.col_mv0 = col_mv0; it.col_mv1 = col_mv1;
    it.col_refpoc0 = col_refpoc0; it.col_refpoc1 = col_refpoc1;
    it.pred0 = pred0; it.pred1 = pred1; it.mv0 = mv0; it.mv1 = mv1;
    it.refidx0 = refidx0; it.refidx1 = refidx1;
    it.refpoc0 = refpoc0; it.refpoc1 = refpoc1;
    it.mot_done = mot_done; it.intra4 = intra4; it.skip4 = skip4;
    it.cbf4 = cbf4;
    it.tu_ev = tu_ev; it.tu_eh = tu_eh; it.pu_ev = pu_ev; it.pu_eh = pu_eh;
    it.inter4 = inter4; it.pmv = pmv; it.ref_slot_o = ref_slot_o;
    it.pred_fl = pred_fl; it.tu_inter_y = tu_inter_y;
    it.tu_inter_c = tu_inter_c;

    size_t cells = (size_t)t.cw * t.ch;
    t.avail_y = scratch;
    t.mode_avail = scratch + cells;
    t.mode_y = scratch + 2 * cells;
    t.ct_depth = scratch + 3 * cells;
    uint8_t *ctb_done = scratch + 4 * cells;
    memset(scratch, 0, 5 * cells);
    memset(t.mode_y, IP_DC, cells);

    t.c.start(rbsp, nbytes, bit_pos, t.qp, t.init_type);
    uint8_t saved_state[HEVC_NCTX], saved_mps[HEVC_NCTX];
    int have_saved = 0;
    int addr = seg_addr;
    int sub_idx = 0;
    int n_ctbs = 0;
    for (;;) {
        int xc = addr % t.ctb_w, yc = addr / t.ctb_w;
        if (t.wpp && xc == 0 && addr != seg_addr) {
            int top_right = (t.ctb_w > 1 ? 1 : 0);
            if (t.ctb_w > 1 &&
                    ctb_done[(yc - 1) * t.ctb_w + top_right] && have_saved)
                t.c.load(saved_state, saved_mps);
            else
                t.c.init_contexts(t.qp, t.init_type);
        }
        if (t.sao_luma || t.sao_chroma)
            sao_syntax(&t, xc, yc, ctb_done);
        coding_quadtree(&t, xc << t.log2_ctb, yc << t.log2_ctb,
                        t.log2_ctb, 0);
        if (t.err) return t.err;
        ctb_done[yc * t.ctb_w + xc] = 1;
        n_ctbs++;
        if (t.wpp && xc == 1) {
            t.c.save(saved_state, saved_mps);
            have_saved = 1;
        }
        int end = t.c.terminate();
        addr++;
        if (end) break;
        if (addr >= t.ctb_w * t.ctb_h) return E_OVERRUN;
        if (t.wpp && addr % t.ctb_w == 0) {
            if (!t.c.terminate()) return E_SUBSET;
            if (sub_idx < n_sub) {
                t.c.reposition(substream_byte_off[sub_idx] * 8);
                sub_idx++;
            } else {
                t.c.align_and_reinit();
            }
        }
    }
    if (it.mv_overflow) return -40;
    return n_ctbs;
}

}  /* extern "C" */
