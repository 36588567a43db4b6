/* Fast CAVLC I-slice parser: the host entropy front-end of the TPU decode
 * pipeline (SURVEY §7.2 L1a). Parses slice_data of one H.264 I slice (CAVLC)
 * into dense symbol planes consumed by the device recon kernel.
 *
 * Mirrors jmcodec_tpu/codec/h264/{cavlc,macroblock}.py exactly; tested for
 * byte-for-byte equality of the produced symbol planes. VLC tables are
 * generated from the Python source of truth (gen_tables.py).
 *
 * Built as a shared library, bound via ctypes (no pybind11 in the image).
 */

#include <stdint.h>
#include <string.h>

#include "h264_tables.h"
#include "h264_shared.h"

extern "C" {

/* 64-bit buffered MSB-first bit reader: `cache` is top-aligned (the next
 * unread bit is bit 63); refilled a byte at a time. */
typedef struct {
    const uint8_t *data;
    int64_t nbits;     /* total payload bits */
    int64_t nbytes;
    int64_t bytepos;   /* next byte to load into the cache */
    int64_t pos;       /* absolute consumed-bit position */
    uint64_t cache;
    int cbits;         /* valid bits in cache */
    int error;
} BR;

static inline void br_refill(BR *b) {
    while (b->cbits <= 56) {
        uint64_t d = b->bytepos < b->nbytes ? b->data[b->bytepos] : 0;
        b->bytepos++;
        b->cache |= d << (56 - b->cbits);
        b->cbits += 8;
    }
}

static inline uint32_t br_peek(BR *b, int n) {
    br_refill(b);
    return (uint32_t)(b->cache >> (64 - n));
}

static inline void br_skip(BR *b, int n) {
    b->cache <<= n;
    b->cbits -= n;
    b->pos += n;
}

static inline uint32_t br_read(BR *b, int n) {
    if (n == 0) return 0;
    if (b->pos + n > b->nbits) { b->error = 1; return 0; }
    uint32_t v = br_peek(b, n);
    br_skip(b, n);
    return v;
}

static inline uint32_t br_ue(BR *b) {
    br_refill(b);
    uint64_t c = b->cache;
    if (c == 0) { b->error = 1; return 0; }
    int zeros = __builtin_clzll(c);
    if (zeros > 32 || b->pos + 2 * zeros + 1 > b->nbits) { b->error = 1; return 0; }
    if (zeros == 0) { br_skip(b, 1); return 0; }
    if (2 * zeros + 1 <= 57) {
        uint32_t v = (uint32_t)(c >> (64 - (2 * zeros + 1)));
        br_skip(b, 2 * zeros + 1);
        return v - 1;
    }
    br_skip(b, zeros + 1);
    return ((1u << zeros) - 1) + br_read(b, zeros);
}

static inline int32_t br_se(BR *b) {
    uint32_t k = br_ue(b);
    if (k & 1) return (int32_t)((k + 1) >> 1);
    return -(int32_t)(k >> 1);
}

static inline int br_more_rbsp(BR *b) {
    if (b->pos >= b->nbits) return 0;
    /* find last set bit (rbsp_stop_one_bit) */
    int64_t last = (b->nbits >> 3) - 1;
    while (last >= (b->pos >> 3) && b->data[last] == 0) last--;
    if (last < 0) return 0;
    uint8_t v = b->data[last];
    int low = 0;
    while (!((v >> low) & 1)) low++;
    int64_t stop = last * 8 + (7 - low);
    return b->pos < stop;
}

/* ---- VLC decode helpers ---- */
#define VLC_DECODE(b, PFX)                                            \
    ({                                                                 \
        uint32_t key = br_peek(b, PFX##_BITS);                         \
        uint8_t ln = PFX##_len[key];                                   \
        if (!ln) { (b)->error = 1; }                                   \
        br_skip(b, ln);                                                \
        PFX##_sym[key];                                                \
    })

static int decode_residual(BR *b, int nC, int max_coeff, int32_t *coeffs) {
    /* returns TotalCoeff; coeffs filled in SCAN order, length max_coeff */
    memset(coeffs, 0, sizeof(int32_t) * max_coeff);
    int total_coeff, trailing_ones;
    if (nC >= 8) {
        uint32_t code = br_read(b, 6);
        if (code == 3) { total_coeff = 0; trailing_ones = 0; }
        else { trailing_ones = code & 3; total_coeff = (int)(code >> 2) + 1; }
    } else {
        uint16_t sym;
        if (nC < 0)      sym = VLC_DECODE(b, ct4);
        else if (nC < 2) sym = VLC_DECODE(b, ct0);
        else if (nC < 4) sym = VLC_DECODE(b, ct1);
        else             sym = VLC_DECODE(b, ct2);
        trailing_ones = sym & 3;
        total_coeff = sym >> 2;
    }
    if (b->error || total_coeff == 0) return total_coeff;

    int32_t levels[16];
    for (int i = 0; i < trailing_ones; i++)
        levels[i] = br_read(b, 1) ? -1 : 1;
    int suffix_length = (total_coeff > 10 && trailing_ones < 3) ? 1 : 0;
    for (int i = trailing_ones; i < total_coeff; i++) {
        br_refill(b);
        if (b->cache == 0) { b->error = 1; return 0; }
        int level_prefix = __builtin_clzll(b->cache);
        if (level_prefix > 32 || b->pos + level_prefix + 1 > b->nbits) {
            b->error = 1;
            return 0;
        }
        br_skip(b, level_prefix + 1);
        int suffix_size;
        if (level_prefix >= 15) suffix_size = level_prefix - 3;
        else if (level_prefix == 14 && suffix_length == 0) suffix_size = 4;
        else suffix_size = suffix_length;
        int64_t level_suffix = suffix_size ? br_read(b, suffix_size) : 0;
        int64_t level_code =
            ((int64_t)(level_prefix < 15 ? level_prefix : 15) << suffix_length)
            + level_suffix;
        if (level_prefix >= 15 && suffix_length == 0) level_code += 15;
        if (level_prefix >= 16) level_code += (1LL << (level_prefix - 3)) - 4096;
        if (i == trailing_ones && trailing_ones < 3) level_code += 2;
        int64_t level = (level_code % 2 == 0) ? (level_code + 2) >> 1
                                              : (-level_code - 1) >> 1;
        levels[i] = (int32_t)level;
        if (suffix_length == 0) suffix_length = 1;
        int64_t al = level < 0 ? -level : level;
        if (al > (3 << (suffix_length - 1)) && suffix_length < 6)
            suffix_length++;
    }

    int total_zeros = 0;
    if (total_coeff < max_coeff) {
        if (nC < 0) {
            switch (total_coeff) {
                case 1: total_zeros = VLC_DECODE(b, tzc1); break;
                case 2: total_zeros = VLC_DECODE(b, tzc2); break;
                case 3: total_zeros = VLC_DECODE(b, tzc3); break;
            }
        } else {
            switch (total_coeff) {
                case 1: total_zeros = VLC_DECODE(b, tz1); break;
                case 2: total_zeros = VLC_DECODE(b, tz2); break;
                case 3: total_zeros = VLC_DECODE(b, tz3); break;
                case 4: total_zeros = VLC_DECODE(b, tz4); break;
                case 5: total_zeros = VLC_DECODE(b, tz5); break;
                case 6: total_zeros = VLC_DECODE(b, tz6); break;
                case 7: total_zeros = VLC_DECODE(b, tz7); break;
                case 8: total_zeros = VLC_DECODE(b, tz8); break;
                case 9: total_zeros = VLC_DECODE(b, tz9); break;
                case 10: total_zeros = VLC_DECODE(b, tz10); break;
                case 11: total_zeros = VLC_DECODE(b, tz11); break;
                case 12: total_zeros = VLC_DECODE(b, tz12); break;
                case 13: total_zeros = VLC_DECODE(b, tz13); break;
                case 14: total_zeros = VLC_DECODE(b, tz14); break;
                case 15: total_zeros = VLC_DECODE(b, tz15); break;
            }
        }
    }

    int zeros_left = total_zeros;
    int pos = total_coeff - 1 + total_zeros;
    for (int i = 0; i < total_coeff; i++) {
        if (pos < 0 || pos >= max_coeff) { b->error = 1; return 0; }
        coeffs[pos] = levels[i];
        if (i < total_coeff - 1) {
            int run = 0;
            if (zeros_left > 0) {
                int zl = zeros_left < 7 ? zeros_left : 7;
                switch (zl) {
                    case 1: run = VLC_DECODE(b, rb1); break;
                    case 2: run = VLC_DECODE(b, rb2); break;
                    case 3: run = VLC_DECODE(b, rb3); break;
                    case 4: run = VLC_DECODE(b, rb4); break;
                    case 5: run = VLC_DECODE(b, rb5); break;
                    case 6: run = VLC_DECODE(b, rb6); break;
                    case 7: run = VLC_DECODE(b, rb7); break;
                }
            }
            zeros_left -= run;
            pos -= 1 + run;
        }
    }
    return total_coeff;
}

static inline int br_te(BR *b, int max_val) {
    if (max_val == 1) return 1 - (int)br_read(b, 1);
    return (int)br_ue(b);
}

/* Parse slice_data of one I slice. Returns #MBs parsed, or -1 on error. */

static void setup_br(BR *b, const uint8_t *rbsp, int64_t nbytes,
                     int64_t bit_offset) {
    b->data = rbsp;
    b->nbits = nbytes * 8;
    b->nbytes = nbytes;
    b->bytepos = bit_offset >> 3;
    b->pos = bit_offset & ~7LL;
    b->cache = 0;
    b->cbits = 0;
    b->error = 0;
    if (bit_offset & 7) br_read(b, (int)(bit_offset & 7));
}

/* Parse one intra macroblock (mb_type already read; I-slice numbering,
 * 0..25). Updates *qp. Returns 0 or a negative error code. */
static int parse_intra_mb(Ctx *c, BR *b, int my, int mx, uint32_t mb_type,
                          int *qp) {
    int mbw = c->mbw, mbh = c->mbh;
    int cur_slice = c->cur_slice;
    int gw4 = mbw * 4, gw2 = mbw * 2;
    int32_t *luma_coeffs = c->luma_coeffs;
    int32_t *luma_dc = c->luma_dc;
    int32_t *chroma_coeffs = c->chroma_coeffs;
    int32_t *chroma_dc = c->chroma_dc;
    int32_t *nz_luma = c->nz_luma, *nz_chroma = c->nz_chroma;
    int32_t *i4_grid = c->i4_grid;

    if (mb_type == 25) { /* I_PCM */
        while (b->pos & 7) {
            if (br_read(b, 1)) return -4;
        }
        if (!c->pcm_y || !c->pcm_c) return -5;
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++)
                c->pcm_y[(my * 16 + y) * (mbw * 16) + mx * 16 + x] =
                    (uint8_t)br_read(b, 8);
        for (int comp = 0; comp < 2; comp++)
            for (int y = 0; y < 8; y++)
                for (int x = 0; x < 8; x++)
                    c->pcm_c[comp * mbh * 8 * mbw * 8 +
                             (my * 8 + y) * (mbw * 8) + mx * 8 + x] =
                        (uint8_t)br_read(b, 8);
        c->mb_class[my * mbw + mx] = 2;
        c->slice_map[my * mbw + mx] = cur_slice;
        c->qp[my * mbw + mx] = *qp;
        for (int r = 0; r < 4; r++)
            for (int s = 0; s < 4; s++) {
                nz_luma[(my * 4 + r) * gw4 + mx * 4 + s] = 16;
                i4_grid[(my * 4 + r) * gw4 + mx * 4 + s] = -1;
            }
        for (int comp = 0; comp < 2; comp++)
            for (int r = 0; r < 2; r++)
                for (int s = 0; s < 2; s++)
                    nz_chroma[comp * mbh * 2 * gw2 + (my * 2 + r) * gw2 +
                              mx * 2 + s] = 16;
        if (b->error) return -6;
        return 0;
    }

    int cls, i16m = 0, cbp_luma = 0, cbp_chroma = 0;
    if (mb_type == 0) {
        cls = 0;
        c->slice_map[my * mbw + mx] = cur_slice;
        c->mb_class[my * mbw + mx] = 0;
        int rem[16];
        for (int i = 0; i < 16; i++) {
            if (br_read(b, 1)) rem[i] = -1;
            else rem[i] = (int)br_read(b, 3);
        }
        uint32_t cm = br_ue(b);
        if (cm > 3) return -7;
        c->chroma_mode[my * mbw + mx] = (int32_t)cm;
        uint32_t code = br_ue(b);
        if (code > 47) return -8;
        int cbp = cbp_intra_from_code[code];
        cbp_luma = cbp & 15;
        cbp_chroma = cbp >> 4;
        if (cbp_chroma == 3) return -9;
        for (int i = 0; i < 16; i++) {
            int by = my * 4 + blk_y[i] / 4;
            int bx = mx * 4 + blk_x[i] / 4;
            int pred = predict_i4(c, by, bx, cur_slice);
            int mode = rem[i] < 0 ? pred
                      : (rem[i] >= pred ? rem[i] + 1 : rem[i]);
            i4_grid[by * gw4 + bx] = mode;
            c->i4_modes[by * gw4 + bx] = mode;
        }
    } else if (mb_type <= 24) {
        cls = 1;
        c->slice_map[my * mbw + mx] = cur_slice;
        c->mb_class[my * mbw + mx] = 1;
        int t = (int)mb_type - 1;
        cbp_luma = t >= 12 ? 15 : 0;
        t %= 12;
        i16m = t % 4;
        cbp_chroma = t / 4;
        c->i16_mode[my * mbw + mx] = i16m;
        uint32_t cm = br_ue(b);
        if (cm > 3) return -7;
        c->chroma_mode[my * mbw + mx] = (int32_t)cm;
        for (int r = 0; r < 4; r++)
            for (int s = 0; s < 4; s++)
                i4_grid[(my * 4 + r) * gw4 + mx * 4 + s] = -1;
    } else {
        return -10;
    }

    if (cbp_luma || cbp_chroma || cls == 1) {
        int32_t dq = br_se(b);
        if (dq < -26 || dq > 25) return -11;
        *qp = ((*qp + dq) % 52 + 52) % 52;
    }
    c->qp[my * mbw + mx] = *qp;

    int32_t scan[16];
    /* luma DC (I16) */
    if (cls == 1) {
        int nc = luma_nc(c, my * 4, mx * 4, cur_slice);
        decode_residual(b, nc, 16, scan);
        store_raster(luma_dc + (my * mbw + mx) * 16, scan, 0, 0);
    } else {
        for (int k = 0; k < 16; k++)
            luma_dc[(my * mbw + mx) * 16 + k] = 0;
    }
    /* luma blocks */
    int n_ac = cls == 1 ? 15 : 16;
    for (int i = 0; i < 16; i++) {
        int by = my * 4 + blk_y[i] / 4;
        int bx = mx * 4 + blk_x[i] / 4;
        int32_t *dst = luma_coeffs + (by * gw4 + bx) * 16;
        if (cbp_luma & (1 << (i >> 2))) {
            int nc = luma_nc(c, by, bx, cur_slice);
            int tc = decode_residual(b, nc, n_ac, scan);
            store_raster(dst, scan, n_ac, cls == 1);
            nz_luma[by * gw4 + bx] = tc;
        } else {
            for (int k = 0; k < 16; k++) dst[k] = 0;
            nz_luma[by * gw4 + bx] = 0;
        }
    }
    /* chroma DC */
    for (int comp = 0; comp < 2; comp++) {
        int32_t *dst = chroma_dc + (comp * mbh * mbw + my * mbw + mx) * 4;
        if (cbp_chroma) {
            int32_t cdc[4];
            decode_residual(b, -1, 4, cdc);
            for (int k = 0; k < 4; k++) dst[k] = cdc[k];
        } else {
            for (int k = 0; k < 4; k++) dst[k] = 0;
        }
    }
    /* chroma AC */
    static const int cblk_x[4] = {0, 4, 0, 4};
    static const int cblk_y[4] = {0, 0, 4, 4};
    for (int comp = 0; comp < 2; comp++) {
        for (int i = 0; i < 4; i++) {
            int by = my * 2 + cblk_y[i] / 4;
            int bx = mx * 2 + cblk_x[i] / 4;
            int32_t *dst = chroma_coeffs +
                (comp * mbh * 2 * gw2 + by * gw2 + bx) * 16;
            int32_t *nz = nz_chroma + comp * mbh * 2 * gw2 + by * gw2 + bx;
            if (cbp_chroma == 2) {
                int nc = chroma_nc(c, comp, by, bx, cur_slice);
                int tc = decode_residual(b, nc, 15, scan);
                store_raster(dst, scan, 15, 1);
                *nz = tc;
            } else {
                for (int k = 0; k < 16; k++) dst[k] = 0;
                *nz = 0;
            }
        }
    }
    if (b->error) return -12;
    return 0;
}

int jmx_parse_i_slice(const uint8_t *rbsp, int64_t nbytes, int64_t bit_offset,
                      int mbw, int mbh, int first_mb, int slice_qp,
                      int cur_slice,
                      int32_t *nz_luma, int32_t *nz_chroma, int32_t *i4_grid,
                      int32_t *slice_map, int32_t *mb_class, int32_t *qp_out,
                      int32_t *i4_modes, int32_t *i16_mode,
                      int32_t *chroma_mode, int32_t *luma_coeffs,
                      int32_t *luma_dc, int32_t *chroma_coeffs,
                      int32_t *chroma_dc, uint8_t *pcm_y, uint8_t *pcm_c) {
    Ctx c = {mbw, mbh, nz_luma, nz_chroma, i4_grid, slice_map, mb_class,
             qp_out, i4_modes, i16_mode, chroma_mode, luma_coeffs, luma_dc,
             chroma_coeffs, chroma_dc, pcm_y, pcm_c, cur_slice};
    BR b;
    setup_br(&b, rbsp, nbytes, bit_offset);
    int qp = slice_qp;
    int addr = first_mb;
    int n_mbs = 0;
    while (1) {
        int my = addr / mbw, mx = addr % mbw;
        if (my >= mbh) return -2;
        uint32_t mb_type = br_ue(&b);
        if (b.error) return -3;
        int rc = parse_intra_mb(&c, &b, my, mx, mb_type, &qp);
        if (rc) return rc;
        addr++;
        n_mbs++;
        if (!br_more_rbsp(&b)) break;
    }
    return n_mbs;
}

/* Parse slice_data of one P slice (CAVLC). Outputs the I-slice planes plus
 * per-4x4 motion (mv quarter-pel, ref index; ref=-1 for intra blocks).
 * done_scratch: [mbh*4*mbw*4] uint8 zero-initialised by the caller.
 * Returns #MBs parsed or a negative error code (-20 bad P mb syntax,
 * -21 8x8 transform flag [unsupported on the fast path]). */
int jmx_parse_p_slice(const uint8_t *rbsp, int64_t nbytes, int64_t bit_offset,
                      int mbw, int mbh, int first_mb, int slice_qp,
                      int cur_slice, int num_ref, int t8_allowed,
                      int32_t *nz_luma, int32_t *nz_chroma, int32_t *i4_grid,
                      int32_t *slice_map, int32_t *mb_class, int32_t *qp_out,
                      int32_t *i4_modes, int32_t *i16_mode,
                      int32_t *chroma_mode, int32_t *luma_coeffs,
                      int32_t *luma_dc, int32_t *chroma_coeffs,
                      int32_t *chroma_dc, uint8_t *pcm_y, uint8_t *pcm_c,
                      int32_t *mv, int32_t *ref, uint8_t *done_scratch) {
    Ctx c = {mbw, mbh, nz_luma, nz_chroma, i4_grid, slice_map, mb_class,
             qp_out, i4_modes, i16_mode, chroma_mode, luma_coeffs, luma_dc,
             chroma_coeffs, chroma_dc, pcm_y, pcm_c, cur_slice};
    Mot m = {mv, ref, done_scratch};
    BR b;
    setup_br(&b, rbsp, nbytes, bit_offset);
    int qp = slice_qp;
    int addr = first_mb;
    int n_mbs = 0;
    int n_total = mbw * mbh;
    int gw4 = mbw * 4, gw2 = mbw * 2;

    while (1) {
        uint32_t skip_run = br_ue(&b);
        if (b.error) return -3;
        for (uint32_t k = 0; k < skip_run; k++) {
            if (addr >= n_total) return -2;
            int my = addr / mbw, mx = addr % mbw;
            /* P_Skip (8.4.1.1): derived motion, zero residual */
            c.mb_class[my * mbw + mx] = 3;
            c.slice_map[my * mbw + mx] = cur_slice;
            c.qp[my * mbw + mx] = qp;
            int32_t smv[2];
            pskip_mv(&c, &m, my, mx, cur_slice, smv);
            for (int r = 0; r < 4; r++)
                for (int s = 0; s < 4; s++) {
                    int by = my * 4 + r, bx = mx * 4 + s;
                    i4_grid[by * gw4 + bx] = -1;
                    c.i4_modes[by * gw4 + bx] = 0;
                    nz_luma[by * gw4 + bx] = 0;
                    m.mv[(by * gw4 + bx) * 2] = smv[0];
                    m.mv[(by * gw4 + bx) * 2 + 1] = smv[1];
                    m.ref[by * gw4 + bx] = 0;
                    m.done[by * gw4 + bx] = 1;
                    for (int t = 0; t < 16; t++)
                        luma_coeffs[(by * gw4 + bx) * 16 + t] = 0;
                }
            for (int t = 0; t < 16; t++)
                luma_dc[(my * mbw + mx) * 16 + t] = 0;
            for (int comp = 0; comp < 2; comp++) {
                for (int t = 0; t < 4; t++)
                    chroma_dc[(comp * mbh * mbw + my * mbw + mx) * 4 + t] = 0;
                for (int r = 0; r < 2; r++)
                    for (int s = 0; s < 2; s++) {
                        int by = my * 2 + r, bx = mx * 2 + s;
                        nz_chroma[comp * mbh * 2 * gw2 + by * gw2 + bx] = 0;
                        for (int t = 0; t < 16; t++)
                            chroma_coeffs[(comp * mbh * 2 * gw2 +
                                           by * gw2 + bx) * 16 + t] = 0;
                    }
            }
            addr++;
            n_mbs++;
        }
        if (!br_more_rbsp(&b)) break;
        if (addr >= n_total) return -2;
        int my = addr / mbw, mx = addr % mbw;
        uint32_t mb_type = br_ue(&b);
        if (b.error) return -3;
        if (mb_type >= 5) {
            /* intra MB in a P slice */
            int rc = parse_intra_mb(&c, &b, my, mx, mb_type - 5, &qp);
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
            c.mb_class[my * mbw + mx] = 3;
            c.slice_map[my * mbw + mx] = cur_slice;
            for (int r = 0; r < 4; r++)
                for (int s = 0; s < 4; s++) {
                    i4_grid[(my * 4 + r) * gw4 + mx * 4 + s] = -1;
                    c.i4_modes[(my * 4 + r) * gw4 + mx * 4 + s] = 0;
                }
            int by0 = my * 4, bx0 = mx * 4;
            int subt[4] = {0, 0, 0, 0};
            if (mb_type == 0) {            /* P_16x16 */
                int r0 = num_ref > 1 ? br_te(&b, num_ref - 1) : 0;
                int32_t dx = br_se(&b), dy = br_se(&b);
                put_partition(&c, &m, by0, bx0, 4, 4, r0, dx, dy, PK_OTHER,
                              cur_slice);
            } else if (mb_type == 1) {     /* P_16x8 */
                int r0 = num_ref > 1 ? br_te(&b, num_ref - 1) : 0;
                int r1 = num_ref > 1 ? br_te(&b, num_ref - 1) : 0;
                int32_t d0x = br_se(&b), d0y = br_se(&b);
                int32_t d1x = br_se(&b), d1y = br_se(&b);
                put_partition(&c, &m, by0, bx0, 4, 2, r0, d0x, d0y,
                              PK_16x8_TOP, cur_slice);
                put_partition(&c, &m, by0 + 2, bx0, 4, 2, r1, d1x, d1y,
                              PK_16x8_BOT, cur_slice);
            } else if (mb_type == 2) {     /* P_8x16 */
                int r0 = num_ref > 1 ? br_te(&b, num_ref - 1) : 0;
                int r1 = num_ref > 1 ? br_te(&b, num_ref - 1) : 0;
                int32_t d0x = br_se(&b), d0y = br_se(&b);
                int32_t d1x = br_se(&b), d1y = br_se(&b);
                put_partition(&c, &m, by0, bx0, 2, 4, r0, d0x, d0y,
                              PK_8x16_L, cur_slice);
                put_partition(&c, &m, by0, bx0 + 2, 2, 4, r1, d1x, d1y,
                              PK_8x16_R, cur_slice);
            } else {                       /* P_8x8 / P_8x8ref0 */
                for (int i = 0; i < 4; i++) {
                    subt[i] = (int)br_ue(&b);
                    if (subt[i] > 3) return -20;
                }
                int refs[4] = {0, 0, 0, 0};
                if (mb_type == 3 && num_ref > 1)
                    for (int i = 0; i < 4; i++)
                        refs[i] = br_te(&b, num_ref - 1);
                /* sub shapes: 0=8x8(1 part 2x2), 1=8x4(2 parts 2x1),
                 * 2=4x8(2 parts 1x2), 3=4x4(4 parts 1x1); in 4x4-grid units */
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
                        else if (st == 3) { py = oy + p / 2; px = ox + p % 2; }
                        else { py = oy; px = ox; }
                        int32_t dx = br_se(&b), dy = br_se(&b);
                        put_partition(&c, &m, py, px, pw, ph, refs[b8],
                                      dx, dy, PK_OTHER, cur_slice);
                    }
                }
            }
            /* coded_block_pattern (inter mapping) */
            uint32_t code = br_ue(&b);
            if (code > 47) return -8;
            int cbp = cbp_inter_from_code[code];
            int cbp_luma = cbp & 15;
            int cbp_chroma = cbp >> 4;
            if (cbp_chroma == 3) return -9;
            if (t8_allowed && cbp_luma &&
                    (mb_type < 3 || (subt[0] | subt[1] | subt[2] | subt[3])
                     == 0)) {
                if (br_read(&b, 1)) return -21;  /* 8x8 transform: host path */
            }
            if (cbp_luma || cbp_chroma) {
                int32_t dq = br_se(&b);
                if (dq < -26 || dq > 25) return -11;
                qp = ((qp + dq) % 52 + 52) % 52;
            }
            c.qp[my * mbw + mx] = qp;
            int32_t scan[16];
            for (int t = 0; t < 16; t++)
                luma_dc[(my * mbw + mx) * 16 + t] = 0;
            for (int i = 0; i < 16; i++) {
                int by = my * 4 + blk_y[i] / 4;
                int bx = mx * 4 + blk_x[i] / 4;
                int32_t *dst = luma_coeffs + (by * gw4 + bx) * 16;
                if (cbp_luma & (1 << (i >> 2))) {
                    int nc = luma_nc(&c, by, bx, cur_slice);
                    int tc = decode_residual(&b, nc, 16, scan);
                    store_raster(dst, scan, 16, 0);
                    nz_luma[by * gw4 + bx] = tc;
                } else {
                    for (int k = 0; k < 16; k++) dst[k] = 0;
                    nz_luma[by * gw4 + bx] = 0;
                }
            }
            for (int comp = 0; comp < 2; comp++) {
                int32_t *dst = chroma_dc +
                    (comp * mbh * mbw + my * mbw + mx) * 4;
                if (cbp_chroma) {
                    int32_t cdc[4];
                    decode_residual(&b, -1, 4, cdc);
                    for (int k = 0; k < 4; k++) dst[k] = cdc[k];
                } else {
                    for (int k = 0; k < 4; k++) dst[k] = 0;
                }
            }
            static const int cblk_x[4] = {0, 4, 0, 4};
            static const int cblk_y[4] = {0, 0, 4, 4};
            for (int comp = 0; comp < 2; comp++) {
                for (int i = 0; i < 4; i++) {
                    int by = my * 2 + cblk_y[i] / 4;
                    int bx = mx * 2 + cblk_x[i] / 4;
                    int32_t *dst = chroma_coeffs +
                        (comp * mbh * 2 * gw2 + by * gw2 + bx) * 16;
                    int32_t *nz = nz_chroma + comp * mbh * 2 * gw2 +
                        by * gw2 + bx;
                    if (cbp_chroma == 2) {
                        int nc = chroma_nc(&c, comp, by, bx, cur_slice);
                        int tc = decode_residual(&b, nc, 15, scan);
                        store_raster(dst, scan, 15, 1);
                        *nz = tc;
                    } else {
                        for (int k = 0; k < 16; k++) dst[k] = 0;
                        *nz = 0;
                    }
                }
            }
            if (b.error) return -12;
        }
        addr++;
        n_mbs++;
        if (!br_more_rbsp(&b)) break;
    }
    return n_mbs;
}

} /* extern "C" */
