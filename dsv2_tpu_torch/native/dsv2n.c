/* dsv2n — native host runtime for the serial paths of dsv2_tpu.
 *
 * Two things genuinely resist data-parallel execution in this codec and
 * live here instead of on the TPU:
 *   1. the per-coefficient entropy scan (adaptive Rice / exp-Golomb state
 *      feeds back across the whole scan; ref: src/hzcc.c:234-583)
 *   2. the raster-sequential 4x4 in-loop filters, whose reads overlap the
 *      writes of previously processed tiles (ref: src/bmc.c:51-659)
 *
 * The quantization decisions themselves are made on the TPU; this code only
 * serializes/deserializes already-quantized values and applies the
 * sequential pixel filters. Semantics match the DSV2 v2.8 reference
 * bit-for-bit.
 */
#include <stdint.h>
#include <string.h>
#include <stdlib.h>

#define API __attribute__((visibility("default")))

static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }
static inline int iclamp(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }
static inline uint8_t u8(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }
static inline int iabs(int v) { return v < 0 ? -v : v; }

/* ------------------------------------------------------------------ */
/* bit I/O (MSB first over a flat buffer; writer assumes zeroed bytes) */
/* ------------------------------------------------------------------ */

typedef struct {
    uint8_t *base;
    uint32_t bit;
    uint32_t lim;   /* capacity in bits; writes beyond set ovf */
    int ovf;
} BW;

static void bw_one(BW *w)
{
    if (w->bit >= w->lim) { w->ovf = 1; return; }
    w->base[w->bit >> 3] |= (uint8_t)(1u << (7 - (w->bit & 7)));
    w->bit++;
}

static void bw_bit(BW *w, int v)
{
    if (w->bit >= w->lim) { w->ovf = 1; return; }
    if (v) {
        w->base[w->bit >> 3] |= (uint8_t)(1u << (7 - (w->bit & 7)));
    }
    w->bit++;
}

static void bw_bits(BW *w, unsigned n, unsigned v)
{
    while (n) {
        unsigned take = 8 - (w->bit & 7);
        if (w->bit + n > w->lim) { w->ovf = 1; return; }
        if (take > n) take = n;
        {
            unsigned shift = (7 - (w->bit & 7)) - take + 1;
            w->base[w->bit >> 3] |= (uint8_t)(((v >> (n - take))
                & ((1u << take) - 1u)) << shift);
        }
        n -= take;
        w->bit += take;
    }
}

static void bw_align(BW *w) { w->bit = (w->bit + 7u) & ~7u; }

static void bw_ueg(BW *w, unsigned v)
{
    unsigned x;
    int nb, i;
    v++;
    for (nb = -1, x = v; x; x >>= 1) nb++;
    for (i = 0; i < nb; i++) {
        w->bit++; /* zero */
        bw_bit(w, (int)(v & (1u << (nb - 1 - i))));
    }
    bw_one(w);
}

static void bw_neg(BW *w, int v)
{
    int s = 0;
    if (v < 0) { s = 1; v = -v; }
    bw_ueg(w, (unsigned)(v - 1));
    if (v) bw_bit(w, s);
}

static void bw_rice(BW *w, unsigned v, int *rk, int damp)
{
    unsigned k = (unsigned)(*rk) >> damp;
    unsigned q = v >> k;
    if (q) (*rk)++;
    else if (*rk > 0) (*rk)--;
    if (w->bit + q >= w->lim) { w->ovf = 1; return; }
    w->bit += q; /* zeroes */
    bw_one(w);
    bw_bits(w, k, v);
}

static void bw_nrice(BW *w, int v, int *rk, int damp)
{
    unsigned u = v >= 0 ? (unsigned)(2 * v) : (unsigned)(-2 * v - 1);
    bw_rice(w, u - 1u, rk, damp);
}

typedef struct {
    const uint8_t *base;
    uint32_t bit;
} BR;

static unsigned br_bit(BR *r)
{
    unsigned out = (r->base[r->bit >> 3] >> (7 - (r->bit & 7))) & 1u;
    r->bit++;
    return out;
}

static unsigned br_bits(BR *r, unsigned n)
{
    unsigned out = 0;
    while (n) {
        unsigned take = 8 - (r->bit & 7);
        if (take > n) take = n;
        unsigned shift = (7 - (r->bit & 7)) - take + 1;
        out = (out << take) | ((r->base[r->bit >> 3] >> shift) & ((1u << take) - 1u));
        n -= take;
        r->bit += take;
    }
    return out;
}

static void br_align(BR *r) { r->bit = (r->bit + 7u) & ~7u; }

static unsigned br_ueg(BR *r)
{
    unsigned v = 1;
    while (!br_bit(r)) {
        v = (v << 1) | br_bit(r);
    }
    return v - 1;
}

static int br_neg(BR *r)
{
    int v = (int)br_ueg(r) + 1;
    if (v && br_bit(r)) return -v;
    return v;
}

static unsigned br_rice(BR *r, int *rk, int damp)
{
    unsigned k = (unsigned)(*rk) >> damp;
    unsigned q = 0;
    while (!br_bit(r)) q++;
    if (q) (*rk)++;
    else if (*rk > 0) (*rk)--;
    return (q << k) | (k ? br_bits(r, k) : 0);
}

static int br_nrice(BR *r, int *rk, int damp)
{
    unsigned u = br_rice(r, rk, damp) + 1u;
    return (int)(u >> 1) ^ -(int)(u & 1u);
}

/* ------------------------------------------------------------------ */
/* Coefficient scan (ref: src/hzcc.c hzcc_enc/hzcc_dec bit structure)  */
/* ------------------------------------------------------------------ */

typedef struct {
    int32_t count; /* number of coefs in this segment */
    int32_t damp;  /* rice damp, or < 0 for NEG coding (LL segment) */
} DSVN_SEG;

#define RUN_BITS 24

/* v: already-quantized coefficients in scan order (0 = not coded).
 * out must be zero-filled. Returns bytes written. */
API int64_t dsvn_scan_enc(const int32_t *v, int64_t total,
                          const DSVN_SEG *segs, int nsegs,
                          uint8_t *out, int64_t cap)
{
    BW w = { out, 0, 0, 0 };
    w.lim = (uint32_t)(cap * 8);
    int run = 0, nruns = 0, vk = 0, s;
    int64_t i = 0;
    uint32_t endbit;

    bw_bits(&w, RUN_BITS, 0);
    bw_align(&w);
    (void)total;
    for (s = 0; s < nsegs; s++) {
        int32_t n = segs[s].count;
        int damp = segs[s].damp;
        int32_t j;
        for (j = 0; j < n; j++, i++) {
            int32_t val = v[i];
            if (val) {
                bw_ueg(&w, (unsigned)run);
                if (damp < 0) bw_neg(&w, val);
                else bw_nrice(&w, val, &vk, damp);
                run = -1;
                nruns++;
            }
            run++;
        }
    }
    bw_align(&w);
    endbit = w.bit;
    w.bit = 0;
    bw_bits(&w, RUN_BITS, (unsigned)nruns);
    w.bit = endbit;
    bw_align(&w);
    if (w.ovf) return -1;
    return (int64_t)(w.bit >> 3);
}

/* buf points at the aligned start of the scan (the RUN_BITS slot);
 * lim = byte limit (exclusive) relative to buf for the overrun guard.
 * v (zero-filled) receives raw quantized values in scan order.
 * Returns the final bit position (pre-alignment), matching where the
 * reference's serial reader would stand before the EOP check. */
API uint32_t dsvn_scan_dec(const uint8_t *buf, uint32_t lim,
                           int32_t *v, const DSVN_SEG *segs, int nsegs)
{
    BR r = { buf, 0 };
    int vk = 0, s;
    int64_t i = 0;
    int runs;
    int64_t run;

    runs = (int)br_bits(&r, RUN_BITS);
    br_align(&r);
    run = (runs-- > 0) ? (int64_t)br_ueg(&r) : (int64_t)0x7fffffff;
    for (s = 0; s < nsegs; s++) {
        int32_t n = segs[s].count;
        int damp = segs[s].damp;
        int32_t j;
        for (j = 0; j < n; j++, i++) {
            if (!run--) {
                int32_t val;
                if (damp < 0) val = br_neg(&r);
                else val = br_nrice(&r, &vk, damp);
                run = (runs-- > 0) ? (int64_t)br_ueg(&r) : (int64_t)0x7fffffff;
                if ((r.bit >> 3) >= lim) {
                    return r.bit;
                }
                v[i] = val;
            }
        }
    }
    br_align(&r);
    return r.bit;
}

/* ------------------------------------------------------------------ */
/* 4x4 in-loop filters (ref: src/bmc.c:51-659). Sequential raster scan */
/* over tiles; each tile's test window overlaps prior tiles' writes.   */
/* ------------------------------------------------------------------ */

#define FDIM 4

/* Six-tap flatness test + boundary smoothing shared by both filter
 * orientations. Taps t[0..5] run across the boundary, three per side;
 * when every tap sits within `thr` of the lowpass estimate, c[0..4]
 * receives the smoothed tap band (the edge pass writes c[0..3] onto
 * taps 1..4, the interior pass writes c[1..4]). Returns nonzero when
 * the smoothing fired. (ref: bmc.c:51-119 bit layout) */
static int filt6(const int t[6], int thr, int c[5])
{
    int lp = (5 * (t[2] + t[3]) + 3 * (t[1] + t[4]) + 8) >> 4;
    int k, lp5;

    for (k = 0; k < 6; k++)
        if (iabs(t[k] - lp) >= thr) return 0;
    lp5 = 5 * lp;
    c[0] = (3 * (lp + t[1]) + 2 * t[0] + 4) >> 3;
    c[1] = (lp5 + 2 * t[1] + t[0] + 4) >> 3;
    c[2] = lp;
    c[3] = (lp5 + 2 * t[4] + t[5] + 4) >> 3;
    c[4] = (3 * (lp + t[4]) + 2 * t[5] + 4) >> 3;
    return 1;
}

static void hfilt(uint8_t *b, int w, int h, int s,
                  int x, int y, int edge, int thE, int thM)
{
    int yy, y0, y1, in_edge;

    if (x < FDIM || x > w - FDIM || (edge && thE <= 0) || thM <= 0) return;
    y0 = iclamp(y, 0, h - 1);
    y1 = iclamp(y + FDIM, 0, h - 1);
    in_edge = x < (w - 2 * FDIM);
    if (!edge) thE = thM;
    for (yy = y0; yy < y1; yy++) {
        uint8_t *row = b + yy * s + x;
        int t[6], c[5], k;

        for (k = 0; k < 6; k++) t[k] = row[k - 3];
        if (filt6(t, thE, c))
            for (k = 0; k < 4; k++) row[k - 2] = (uint8_t)c[k];
        if (in_edge) {
            uint8_t *mid = row + FDIM;

            for (k = 0; k < 6; k++) t[k] = mid[k - 2];
            if (filt6(t, thM, c))
                for (k = 0; k < 4; k++) mid[k - 1] = (uint8_t)c[k + 1];
        }
    }
}

static void vfilt(uint8_t *b, int w, int h, int s,
                  int x, int y, int edge, int thE, int thM)
{
    int xx, x0, x1, in_edge;

    if (y < FDIM || y > h - FDIM || (edge && thE <= 0) || thM <= 0) return;
    x0 = iclamp(x, 0, w - 1);
    x1 = iclamp(x + FDIM, 0, w - 1);
    in_edge = y < (h - 2 * FDIM);
    if (!edge) thE = thM;
    for (xx = x0; xx < x1; xx++) {
        uint8_t *col = b + y * s + xx;
        int t[6], c[5], k;

        for (k = 0; k < 6; k++) t[k] = col[(k - 3) * s];
        if (filt6(t, thE, c))
            for (k = 0; k < 4; k++) col[(k - 2) * s] = (uint8_t)c[k];
        if (in_edge) {
            uint8_t *mid = col + FDIM * s;

            for (k = 0; k < 6; k++) t[k] = mid[(k - 2) * s];
            if (filt6(t, thM, c))
                for (k = 0; k < 4; k++) mid[(k - 1) * s] = (uint8_t)c[k + 1];
        }
    }
}

/* four 2x2 quadrant averages of a 4x4 tile */
static void quad4(const uint8_t *a, int as, int q[4])
{
    int i;
    for (i = 0; i < 4; i++) {
        const uint8_t *p = a + (i >> 1) * 2 * as + (i & 1) * 2;
        q[i] = (p[0] + p[1] + p[as] + p[as + 1] + 2) >> 2;
    }
}

/* downsampled smoothing factor (ref: bmc.c:193-222) */
static unsigned dsfactor(const uint8_t *a, int as)
{
    int q[4];
    unsigned g1, g2, rise, fall;

    quad4(a, as, q);
    g1 = (unsigned)iabs((q[0] + q[1]) - (q[3] + q[2]));
    g2 = (unsigned)iabs((q[2] + q[1]) - (q[3] + q[0]));
    if ((g1 > g2 ? g1 : g2) < 8) return 0;
    q[2] = 255 - q[2];
    q[3] = 255 - q[3];
    rise = (unsigned)iabs(q[0] - q[1] + q[2] - q[3]);
    fall = (unsigned)iabs(q[0] + q[1] - q[2] - q[3]) >> 2;
    if (rise > fall) return (3 * rise + fall + 2) >> 2;
    return (3 * fall + rise + 2) >> 2;
}

/* 4x4 haar energy + downsampled energy (ref: bmc.c:224-270) */
static void tile_energy(const uint8_t *a, int as,
                        int *psh, int *psv, int *pslh, int *pslv)
{
    int i, sh = 0, sv = 0, q[4], d;

    for (i = 0; i < 4; i++) {
        const uint8_t *p = a + (i >> 1) * 2 * as + (i & 1) * 2;
        int w0 = p[0], w1 = p[1], w2 = p[as], w3 = p[as + 1];

        d = iabs(w0 - w1 - w2 + w3) >> 1;
        sh += iabs(w0 - w1 + w2 - w3) + d;
        sv += iabs(w0 + w1 - w2 - w3) + d;
    }
    *psh = sh;
    *psv = sv;
    quad4(a, as, q);
    d = iabs(q[0] - q[1] - q[2] + q[3]) >> 1;
    *pslh = iabs(q[0] - q[1] + q[2] - q[3]) + d;
    *pslv = iabs(q[0] + q[1] - q[2] - q[3]) + d;
}

/* histogram de-gradient sharpener (ref: bmc.c:272-337) */
#define NHIST 16

static void degrad(uint8_t *a, int as)
{
    int count[NHIST], total[NHIST];
    int i, b, first = -1, last = -1, mid;
    int lo_avg, hi_avg, lo_n, hi_n;

    memset(count, 0, sizeof(count));
    memset(total, 0, sizeof(total));
    for (i = 0; i < 16; i++) {
        int px = a[(i >> 2) * as + (i & 3)];
        count[px >> 4]++;
        total[px >> 4] += px;
    }
    for (b = 0; b < NHIST; b++) {
        if (!count[b]) continue;
        if (first < 0) first = b;
        last = b;
    }
    if (first >= last) return;
    lo_n = count[first];
    hi_n = count[last];
    lo_avg = total[first] / lo_n;
    hi_avg = total[last] / hi_n;
    if (!lo_avg) lo_avg = 1;
    if (!hi_avg) hi_avg = 1;
    mid = (lo_avg + hi_avg + 1) >> 1;
    for (i = 0; i < 16; i++) {
        uint8_t *px = a + (i >> 2) * as + (i & 3);
        int v = *px;

        if (v < mid) *px = (uint8_t)(v + lo_n * (lo_avg - v) / 16);
        else if (v > mid) *px = (uint8_t)(v + hi_n * (hi_avg - v) / 16);
    }
}

API void dsvn_post_process(uint8_t *plane, int w, int h, int s)
{
    int i, j;
    for (j = 0; j < h / FDIM; j++) {
        int y = j * FDIM;
        if (y + FDIM >= h) continue;
        for (i = 0; i < w / FDIM; i++) {
            int x = i * FDIM;
            if (x + FDIM >= w) continue;
            degrad(plane + x + y * s, s);
        }
    }
}

static int curve_tex(int tt)
{
    if (tt < 8) return (8 - tt) * 8;
    if (tt > 192) return 0;
    return tt - 7;
}

/* blockdata flag bits (ref: src/dsv_internal.h:96-110) */
#define F_STABLE   (1 << 0)
#define F_MAINTAIN (1 << 1)
#define F_SKIP     (1 << 2)
#define F_RINGING  (1 << 3)
#define F_INTRA    (1 << 4)
#define F_EPRM     (1 << 5)

/* intra-frame dering filter (ref: bmc.c:390-457); fq = compute_filter_q,
 * fthresh = 32*(14-lb2(fq)), both precomputed host-side */
API void dsvn_intra_filter(uint8_t *plane, int w, int h, int s,
                           const uint8_t *blockdata, int nbh, int nbv,
                           int fq, int fthresh, int lossless, int do_filter)
{
    int i, j, nsbx = w / FDIM, nsby = h / FDIM;

    if (lossless || !do_filter) return;
    for (j = 0; j < nsby; j++) {
        int fy = j * nbv / nsby;
        int y = j * FDIM;
        if (y + FDIM >= h) continue;
        for (i = 0; i < nsbx; i++) {
            int fx = i * nbh / nsbx;
            int flags = blockdata[fx + fy * nbh];
            int tt = 32;
            int x = i * FDIM;
            if (x + FDIM >= w) continue;
            if (!(flags & F_RINGING)) {
                int sh, sv, shl, svl;
                uint8_t *tile = plane + x + y * s;
                tile_energy(tile, s, &sh, &sv, &shl, &svl);
                if (imax(sh, sv) < 256 && imax(sh, sv) > 8) {
                    if (flags & (F_MAINTAIN | F_STABLE)) {
                        tt = (int)dsfactor(tile, s);
                        if (flags & F_STABLE) tt = tt * 5 >> 2;
                    } else {
                        tt >>= 2;
                    }
                    tt = tt * 2 / 3;
                    tt = (tt * fq) >> 12;
                    tt = iclamp(tt, 0, fthresh);
                    hfilt(plane, w, h, s, x, y, 0, tt, tt);
                    vfilt(plane, w, h, s, x, y, 0, tt, tt);
                    if (sh > sv) tt = 3 * sh + sv;
                    else tt = 3 * sv + sh;
                    tt = curve_tex(tt);
                    tt = 16 + ((tt + 2) >> 2);
                    tt = (tt * fq) >> 12;
                    tt = iclamp(tt, 0, fthresh);
                    hfilt(plane, w, h, s, x, y, 0, tt, tt);
                    vfilt(plane, w, h, s, x, y, 0, tt, tt);
                }
            }
        }
    }
}

/* MV helpers over int16 x/y arrays + flag bytes */
#define MVF_INTRA  (1u << 0)
#define MVF_EPRM   (1u << 1)
#define MVF_SKIP   (1u << 3)

static void neighbordif2(const int16_t *mvx, const int16_t *mvy,
                         const uint32_t *mvflags, int nbh,
                         int x, int y, int *dx, int *dy)
{
    int cmx = mvx[x + y * nbh], cmy = mvy[x + y * nbh];
    int vx0, vy0, vx1, vy1;

    if (iabs(cmx) < 2 && iabs(cmy) < 2) {
        *dx = *dy = 0;
        return;
    }
    vx0 = vx1 = cmx;
    vy0 = vy1 = cmy;
    if (x > 0) {
        int k = (x - 1) + y * nbh;
        if ((mvx[k] || mvy[k]) && !(mvflags[k] & MVF_SKIP)) {
            vx0 = mvx[k];
            vy0 = mvy[k];
        }
    }
    if (y > 0) {
        int k = x + (y - 1) * nbh;
        if ((mvx[k] || mvy[k]) && !(mvflags[k] & MVF_SKIP)) {
            vx1 = mvx[k];
            vy1 = mvy[k];
        }
    }
    *dx = iabs(vx0 - cmx) + iabs(vy0 - cmy);
    *dy = iabs(vx1 - cmx) + iabs(vy1 - cmy);
}

/* inter-frame luma cleanup filter (ref: bmc.c:459-602) */
API void dsvn_luma_filter(uint8_t *plane, int w, int h, int s,
                          const int16_t *mvx, const int16_t *mvy,
                          const uint32_t *mvflags, const uint8_t *submask,
                          int nbh, int nbv, int blk_w, int blk_h,
                          int fq, int fthresh, int lossless, int do_filter,
                          int temporal_mc, int inter_sharpen)
{
    int i, j, nsbx = w / FDIM, nsby = h / FDIM;
    int sharpen = inter_sharpen ? temporal_mc : 0;

    if (lossless) return;
    for (j = 0; j < nsby; j++) {
        int fy = j * nbv / nsby;
        int edgev = ((j * FDIM) % blk_h) == 0;
        int edgevs = ((j * FDIM) % (blk_h / 2)) == 0;
        int y = j * FDIM;
        if (y + FDIM >= h) continue;
        for (i = 0; i < nsbx; i++) {
            int fx = i * nbh / nsbx;
            int edgeh = ((i * FDIM) % blk_w) == 0;
            int edgehs = ((i * FDIM) % (blk_w / 2)) == 0;
            int bi = fx + fy * nbh;
            uint32_t fl = mvflags[bi];
            int x = i * FDIM, ndx = -1, ndy = -1, amx, amy;
            uint8_t *dxy;

            if (fl & MVF_SKIP) continue;
            if (x + FDIM >= w) continue;
            amx = iabs(mvx[bi]);
            amy = iabs(mvy[bi]);
            if (do_filter) {
                neighbordif2(mvx, mvy, mvflags, nbh, fx, fy, &ndx, &ndy);
            }
            dxy = plane + x + y * s;
            if (fl & MVF_INTRA) {
                int thH = iclamp((64 * fq) >> 12, 2, 32);
                int thL = iclamp((32 * fq) >> 12, 2, 32);
                int teh = edgeh, tev = edgev;
                if (submask[bi] != 0xf) {
                    teh |= edgehs;
                    tev |= edgevs;
                }
                hfilt(plane, w, h, s, x, y, teh, thH, thL);
                vfilt(plane, w, h, s, x, y, tev, thH, thL);
                continue;
            }
            if (do_filter && (ndx || ndy)) {
                int tt, addx, addy, sh, sv, shl, svl, tndc;
                int eprm = (fl & MVF_EPRM) != 0;
                int teh = edgeh || eprm;
                int tev = edgev || eprm;
                /* intra is false on this path; submask split cannot apply */
                tndc = (ndx + ndy + 1) >> 1;
                tile_energy(dxy, s, &sh, &sv, &shl, &svl);
                if (sh < 2 * sv && sv < 2 * sh) {
                    int ix, iy;
                    if (ndx < amx) ndx >>= 1;
                    if (ndy < amy) ndy >>= 1;
                    shl = (shl > 128) ? 0 : (128 - shl);
                    svl = (svl > 128) ? 0 : (128 - svl);
                    ix = imin(amx, 32);
                    iy = imin(amy, 32);
                    tt = ((sh * (32 - iy) + shl * iy) + 16) >> 5;
                    tt += ((sv * (32 - ix) + svl * ix) + 16) >> 5;
                    tt = (tt + 1) >> 1;
                    if (ndx < amy && ndy < amx) tt = 0;
                } else {
                    tt = (sh + sv + 1) >> 1;
                }
                tt = (tt * tndc + 4) >> 3;
                tt = (imin(tt, fthresh) * fq) >> 12;
                addx = (imin(ndy, fthresh) * fq) >> 12;
                addy = (imin(ndx, fthresh) * fq) >> 12;
                if (sh > 2 * sv || amy > 2 * amx) {
                    vfilt(plane, w, h, s, x, y, tev, tt + addy, tt);
                } else if (sv > 2 * sh || amx > 2 * amy) {
                    hfilt(plane, w, h, s, x, y, teh, tt + addx, tt);
                } else {
                    hfilt(plane, w, h, s, x, y, teh, tt + addx, tt);
                    vfilt(plane, w, h, s, x, y, tev, tt + addy, tt);
                }
            }
            if (sharpen && ((mvx[bi] & 3) && (mvy[bi] & 3)) &&
                ((mvx[bi] | mvy[bi]) & 1) && amx < 8 && amy < 8) {
                degrad(dxy, s);
            }
        }
    }
}

/* inter-frame chroma filter (ref: bmc.c:604-659); q is the raw quant */
API void dsvn_chroma_filter(uint8_t *plane, int w, int h, int s,
                            const int16_t *mvx, const int16_t *mvy,
                            const uint32_t *mvflags,
                            int nbh, int nbv, int bw, int bh,
                            int q, int lossless)
{
    int i, j, z;
    int ith = iclamp((64 * q) >> 12, 2, 32);

    if (lossless) return;
    for (j = 0; j < nbv; j++) {
        int y = j * bh;
        for (i = 0; i < nbh; i++) {
            int x = i * bw;
            int bi = i + j * nbh;
            uint32_t fl = mvflags[bi];
            int tx, ty;

            if (fl & MVF_SKIP) continue;
            tx = ty = ith;
            if (!(fl & MVF_INTRA)) {
                int ndx, ndy, amx, amy;
                neighbordif2(mvx, mvy, mvflags, nbh, i, j, &ndx, &ndy);
                amx = iabs(mvx[bi]);
                amy = iabs(mvy[bi]);
                if (ndx < amy && ndy < amx) {
                    tx = ty = 0;
                } else {
                    tx = (imin(ndy, 64) * q) >> 12;
                    ty = (imin(ndx, 64) * q) >> 12;
                }
            }
            for (z = 0; z < bh; z += FDIM) {
                if (y + z + FDIM < h) hfilt(plane, w, h, s, x, y + z, 0, tx, tx);
            }
            for (z = 0; z < bw; z += FDIM) {
                if (x + z + FDIM < w) vfilt(plane, w, h, s, x + z, y, 0, ty, ty);
            }
        }
    }
}

/* ------------------------------------------------------------------ */
/* HME metric primitives (ref: src/hme.c:80-366, 775-837).            */
/* Hot per-block math for the host motion-search orchestrator; the    */
/* TPU wavefront implementation supersedes these for bulk throughput. */
/* ------------------------------------------------------------------ */

static uint32_t nat_isqrt(uint32_t n)
{
    uint32_t pos = 1u << 30, res = 0, rem = n;
    if (n == 0) return 0;
    while (pos > rem) pos >>= 2;
    while (pos) {
        uint32_t dif = res + pos;
        res >>= 1;
        if (rem >= dif) { rem -= dif; res += pos; }
        pos >>= 2;
    }
    return res;
}

#define NAT_AVG2(a, b) (((a) + (b) + 1) >> 1)
#define NAT_UAVG4(a, b, c, d) ((unsigned)((a) + (b) + (c) + (d) + 2) >> 2)

static uint32_t metr_ret(uint32_t acc, int w, int h)
{
    return nat_isqrt(acc) * (uint32_t)(w * h) / (uint32_t)NAT_AVG2(w, h);
}

static uint32_t metr_acc(const uint8_t *a, int as, const uint8_t *b, int bs,
                         int w, int h, int ew, int tw, int aw)
{
    uint32_t acc = 0;
    int i, j;
    for (j = 0; j < h / 2; j++) {
        int bp = 0;
        for (i = 0; i < w / 2; i++) {
            int a1 = a[bp], a2 = a[bp + 1], a3 = a[bp + as], a4 = a[bp + 1 + as];
            int b1 = b[bp], b2 = b[bp + 1], b3 = b[bp + bs], b4 = b[bp + 1 + bs];
            int s0 = NAT_UAVG4(a1, a2, a3, a4);
            int s1 = NAT_UAVG4(b1, b2, b3, b4);
            int se = NAT_UAVG4(iabs(a1 - b1), iabs(a2 - b2), iabs(a3 - b3), iabs(a4 - b4));
            int ta = NAT_UAVG4(iabs(a1 - a2), iabs(a2 - a3), iabs(a3 - a4), iabs(a4 - a1));
            int tb = NAT_UAVG4(iabs(b1 - b2), iabs(b2 - b3), iabs(b3 - b4), iabs(b4 - b1));
            acc += (uint32_t)(se * se) << ew;
            acc += (uint32_t)((ta - tb) * (ta - tb)) << tw;
            acc += (uint32_t)((s0 - s1) * (s0 - s1)) << aw;
            bp += 2;
        }
        a += 2 * as;
        b += 2 * bs;
    }
    return acc;
}

API uint32_t dsvn_metr(const uint8_t *a, int as, const uint8_t *b, int bs,
                       int w, int h, int ew, int tw, int aw)
{
    if (w == 0 || h == 0) return 0x7FFFFFFF;
    return metr_ret(metr_acc(a, as, b, bs, w, h, ew, tw, aw), w, h);
}

API uint32_t dsvn_umetr(const uint8_t *a, int as, const uint8_t *b, int bs,
                        int w, int h, int ew, int tw, int aw)
{
    return metr_acc(a, as, b, bs, w, h, ew, tw, aw);
}

API uint32_t dsvn_sse(const uint8_t *a, int as, const uint8_t *b, int bs,
                      int w, int h)
{
    uint32_t acc = 0;
    int i, j;
    if (w == 0 || h == 0) return 0x7FFFFFFF;
    for (j = 0; j < h; j++) {
        for (i = 0; i < w; i++) {
            int d = a[i] - b[i];
            acc += (uint32_t)(d * d);
        }
        a += as;
        b += bs;
    }
    return acc;
}

/* batched candidate scoring: hier_metr over n (dx, dy) offsets */
API void dsvn_cand_scores(const uint8_t *src, int ss,
                          const uint8_t *refbase, int rs,
                          int w, int h, int level,
                          int ew, int tw, int aw,
                          const int32_t *dxs, const int32_t *dys, int n,
                          uint32_t *scores)
{
    int k;
    for (k = 0; k < n; k++) {
        const uint8_t *rp = refbase + dxs[k] + dys[k] * rs;
        if (level > 1) scores[k] = dsvn_sse(src, ss, rp, rs, w, h);
        else scores[k] = dsvn_metr(src, ss, rp, rs, w, h, ew, tw, aw);
    }
}

/* half+quarter-pel probe grid (ref: hme.c:787-837).
 * refwin: 21x21 window with stride rws whose (1,1) sample is the probe
 * origin. qout: 68*68 grid. */
#define SPD 17
#define HPD 34
#define QPD 68

API void dsvn_make_qpel_grid(const uint8_t *refwin, int rws, uint8_t *qout)
{
    int32_t hbuf[(SPD + 3) * SPD];
    int32_t hg[(HPD + 1) * (HPD + 1)];
    int i, j;

    for (j = 0; j < SPD + 3; j++) {
        const uint8_t *r = refwin + j * rws;
        for (i = 0; i < SPD; i++) {
            hbuf[i + j * SPD] = 5 * (r[i + 1] + r[i + 2]) - (r[i] + r[i + 3]);
        }
    }
    memset(hg, 0, sizeof(hg));
    for (j = 0; j < SPD; j++) {
        const uint8_t *r0 = refwin + (j + 0) * rws + 1; /* row j-1 rel probe */
        const uint8_t *r1 = refwin + (j + 1) * rws + 1;
        const uint8_t *r2 = refwin + (j + 2) * rws + 1;
        const uint8_t *r3 = refwin + (j + 3) * rws + 1;
        for (i = 0; i < SPD; i++) {
            int fp = r1[i];
            int hh = (5 * (r1[i] + r1[i + 1]) - (r1[i - 1] + r1[i + 2]) + 4) >> 3;
            int vv = (5 * (r1[i] + r2[i]) - (r0[i] + r3[i]) + 4) >> 3;
            int x = i + j * SPD;
            int dg = (5 * (hbuf[x + SPD] + hbuf[x + 2 * SPD])
                      - (hbuf[x] + hbuf[x + 3 * SPD]) + 32) >> 6;
            hg[(2 * j) * (HPD + 1) + 2 * i] = fp;
            hg[(2 * j) * (HPD + 1) + 2 * i + 1] = u8(hh);
            hg[(2 * j + 1) * (HPD + 1) + 2 * i] = u8(vv);
            hg[(2 * j + 1) * (HPD + 1) + 2 * i + 1] = u8(dg);
        }
    }
    for (j = 0; j < HPD; j++) {
        const int32_t *h0 = hg + j * (HPD + 1);
        const int32_t *h1 = hg + (j + 1) * (HPD + 1);
        uint8_t *qa = qout + (2 * j) * QPD;
        uint8_t *qb = qout + (2 * j + 1) * QPD;
        for (i = 0; i < HPD; i++) {
            qa[2 * i] = (uint8_t)h0[i];
            qa[2 * i + 1] = (uint8_t)NAT_AVG2(h0[i], h0[i + 1]);
            qb[2 * i] = (uint8_t)NAT_AVG2(h0[i], h1[i]);
            qb[2 * i + 1] = (uint8_t)NAT_UAVG4(h0[i], h0[i + 1], h1[i], h1[i + 1]);
        }
    }
}

/* qpsad over the probe grid (ref: hme.c:244-269) */
API uint32_t dsvn_qpsad(const uint8_t *a, int as, const uint8_t *q,
                        int t0, int t1, int ew, int tw, int aw)
{
    const uint8_t *b = q + (4 + t1) * QPD + 4 + t0;
    uint32_t acc = 0;
    int i, j;
    for (j = 0; j < 8; j++) {
        int ap = 0;
        for (i = 0; i < 8; i++) {
            int a1 = a[ap], a2 = a[ap + 1], a3 = a[ap + as], a4 = a[ap + 1 + as];
            int b1 = b[(8 * i) * 1 + (8 * j) * QPD];
            int b2 = b[(8 * i + 4) + (8 * j) * QPD];
            int b3 = b[(8 * i) + (8 * j + 4) * QPD];
            int b4 = b[(8 * i + 4) + (8 * j + 4) * QPD];
            int s0 = NAT_UAVG4(a1, a2, a3, a4);
            int s1 = NAT_UAVG4(b1, b2, b3, b4);
            int se = NAT_UAVG4(iabs(a1 - b1), iabs(a2 - b2), iabs(a3 - b3), iabs(a4 - b4));
            int ta = NAT_UAVG4(iabs(a1 - a2), iabs(a2 - a3), iabs(a3 - a4), iabs(a4 - a1));
            int tb = NAT_UAVG4(iabs(b1 - b2), iabs(b2 - b3), iabs(b3 - b4), iabs(b4 - b1));
            acc += (uint32_t)(se * se) << ew;
            acc += (uint32_t)((ta - tb) * (ta - tb)) << tw;
            acc += (uint32_t)((s0 - s1) * (s0 - s1)) << aw;
            ap += 2;
        }
        a += 2 * as;
    }
    return metr_ret(acc, 16, 16);
}

/* err_intra (ref: hme.c:839-889) */
API void dsvn_err_intra(const uint8_t *a, int as, const uint8_t *b, int bs,
                        int avg_sb, int avg_src, int w, int h,
                        int ew, int tw, int aw, uint32_t ratio,
                        uint32_t *out3)
{
    uint32_t intra_sb = 0, intra_src = 0, inter = 0;
    int i, j;
    for (j = 0; j < h / 2; j++) {
        int bp = 0;
        for (i = 0; i < w / 2; i++) {
            int a1 = a[bp], a2 = a[bp + 1], a3 = a[bp + as], a4 = a[bp + 1 + as];
            int b1 = b[bp], b2 = b[bp + 1], b3 = b[bp + bs], b4 = b[bp + 1 + bs];
            int s0 = NAT_UAVG4(a1, a2, a3, a4);
            int s1 = NAT_UAVG4(b1, b2, b3, b4);
            int ta = NAT_UAVG4(iabs(a1 - a2), iabs(a2 - a3), iabs(a3 - a4), iabs(a4 - a1));
            int tb = NAT_UAVG4(iabs(b1 - b2), iabs(b2 - b3), iabs(b3 - b4), iabs(b4 - b1));
            int ae = NAT_UAVG4(iabs(a1 - b1), iabs(a2 - b2), iabs(a3 - b3), iabs(a4 - b4));
            inter += ((uint32_t)(ae * ae) * ratio) >> (5 - ew);
            inter += (uint32_t)((ta - tb) * (ta - tb)) << tw;
            inter += (uint32_t)((s0 - s1) * (s0 - s1)) << aw;
            ae = NAT_UAVG4(iabs(a1 - avg_sb), iabs(a2 - avg_sb), iabs(a3 - avg_sb), iabs(a4 - avg_sb));
            intra_sb += (uint32_t)(ae * ae) << ew;
            intra_sb += (uint32_t)(ta * ta) << tw;
            intra_sb += (uint32_t)((s0 - avg_sb) * (s0 - avg_sb)) << (aw + 1);
            ae = NAT_UAVG4(iabs(a1 - avg_src), iabs(a2 - avg_src), iabs(a3 - avg_src), iabs(a4 - avg_src));
            intra_src += (uint32_t)(ae * ae) << ew;
            intra_src += (uint32_t)(ta * ta) << tw;
            intra_src += (uint32_t)((s0 - avg_src) * (s0 - avg_src)) << (aw + 1);
            bp += 2;
        }
        a += 2 * as;
        b += 2 * bs;
    }
    out3[0] = intra_sb;
    out3[1] = intra_src;
    out3[2] = (inter * ratio) >> 5;
}

/* block features for the search path (ref: hme.c:492-749) */
API void dsvn_block_features(const uint8_t *a, int as, int w, int h,
                             int32_t *out)
{
    /* out: detail, avg, var, tex, qtex, hvar, npeaks */
    int i, j, x;
    int64_t s = 0;
    uint32_t sh = 0, sv = 0, sh2 = 0, sv2 = 0;
    int avg, var = 0, tex, detail;
    uint16_t hist[NHIST];
    int area = w * h;

    for (j = 0; j < h; j++) {
        const uint8_t *row = a + j * as;
        const uint8_t *prev = j ? row - as : row;
        s += row[0];
        sv += iabs(row[0] - prev[0]);
        for (i = 1; i < w; i++) {
            s += row[i];
            sh += iabs(row[i] - row[i - 1]);
            sv += iabs(row[i] - prev[i]);
        }
    }
    avg = (int)(s / area);
    for (j = 0; j < h; j++) {
        const uint8_t *row = a + j * as;
        for (i = 0; i < w; i++) var += iabs(row[i] - avg);
    }
    out[1] = avg;
    out[2] = var;
    out[3] = (int32_t)imax(sh, sv);
    tex = (int)imax(sh, sv) - (var >> 1);
    detail = (var >> 1) + imax(tex, 0);
    out[0] = detail;
    /* quant_tex */
    for (j = 0; j < h; j++) {
        const uint8_t *row = a + j * as;
        const uint8_t *prev = j ? row - as : row;
        int pr = row[w - 1] >> 4;
        for (i = w - 1; i >= 0; i--) {
            int px = row[i] >> 4;
            int d = px - pr;
            sh2 += (uint32_t)(d * d);
            d = px - (prev[i] >> 4);
            sv2 += (uint32_t)(d * d);
            pr = px;
        }
    }
    out[4] = (int32_t)(nat_isqrt(sh2 > sv2 ? sh2 : sv2) / (uint32_t)NAT_AVG2(w, h));
    /* hist var */
    {
        int havg = avg ? avg : 1;
        uint32_t q16 = (uint32_t)((8 << 16) / havg);
        uint32_t hvar = 0;
        int hm;
        memset(hist, 0, sizeof(hist));
        for (j = 0; j < h; j++) {
            const uint8_t *row = a + j * as;
            for (i = 0; i < w; i++) {
                int hi = (int)((row[i] * q16) >> 16);
                hist[iclamp(hi, 0, NHIST - 1)]++;
            }
        }
        hm = area / NHIST;
        for (x = 0; x < NHIST; x++) {
            int d = hist[x] - hm;
            hvar += (uint32_t)(d * d);
        }
        out[5] = (int32_t)(((uint64_t)hvar * 256) / ((uint64_t)NHIST * area * area));
    }
    /* peaks */
    {
        int havg = avg ? avg : 1;
        uint32_t q16 = (uint32_t)((8 << 16) / havg);
        int w2 = w / 2, h2 = h / 2, maxv = 0, pavg = 0, npeaks = 0;
        memset(hist, 0, sizeof(hist));
        for (j = 0; j < h2; j++) {
            const uint8_t *ra = a + (2 * j) * as;
            const uint8_t *rb = ra + as;
            for (i = 0; i < w2; i++) {
                int ds = NAT_UAVG4(ra[2 * i], ra[2 * i + 1], rb[2 * i], rb[2 * i + 1]);
                int hi = (int)((ds * q16) >> 16);
                hist[imin(hi, NHIST - 1)]++;
            }
        }
        for (x = 0; x < NHIST; x++) {
            if (hist[x] > maxv) maxv = hist[x];
            pavg += hist[x];
        }
        pavg /= NHIST;
        maxv >>= 2;
        for (x = 0; x < NHIST; x++) {
            int c = hist[x];
            int pk = 1;
            if (x > 0) pk &= c > hist[x - 1];
            if (x < NHIST - 1) pk &= c > hist[x + 1];
            pk &= (c > maxv) || (c > pavg);
            if (pk) npeaks++;
        }
        out[6] = npeaks;
    }
}

/* MV cost model + neighborhood metric (ref: src/dsv.c:324-447) */

static int seg_bits_c(int v)
{
    int nb = -1, len;
    unsigned x;
    if (v < 0) v = -v;
    v++;
    for (x = (unsigned)v; x; x >>= 1) nb++;
    len = nb * 2 + 1;
    return len + 1;
}

static int pred3(int left, int top, int topleft)
{
    int dif = left + top - topleft;
    if (iabs(dif - left) < iabs(dif - top)) return left;
    return top;
}

API void dsvn_movec_pred(const int16_t *mvx, const int16_t *mvy, int nbh,
                         int x, int y, int32_t *out2)
{
    int vx0 = 0, vy0 = 0, vx1 = 0, vy1 = 0, vx2 = 0, vy2 = 0;
    if (x > 0) { vx0 = mvx[(x - 1) + y * nbh]; vy0 = mvy[(x - 1) + y * nbh]; }
    if (y > 0) { vx1 = mvx[x + (y - 1) * nbh]; vy1 = mvy[x + (y - 1) * nbh]; }
    if (x > 0 && y > 0) {
        vx2 = mvx[(x - 1) + (y - 1) * nbh];
        vy2 = mvy[(x - 1) + (y - 1) * nbh];
    }
    out2[0] = pred3(vx0, vx1, vx2);
    out2[1] = pred3(vy0, vy1, vy2);
}

API int32_t dsvn_mv_cost(const int16_t *mvx, const int16_t *mvy, int nbh,
                         int blk_w, int blk_h, int vid_w, int vid_h,
                         int i, int j, int mx, int my, int q, int sqr)
{
    int32_t pr[2];
    int32_t bits, b2sr;
    dsvn_movec_pred(mvx, mvy, nbh, i, j, pr);
    bits = seg_bits_c(mx - pr[0]) + seg_bits_c(my - pr[1]);
    b2sr = (int32_t)((256 * ((q * q) >> 12) * blk_w * blk_h)
                     / ((int64_t)vid_w * vid_h));
    bits += bits * b2sr >> 7;
    if (sqr) bits *= bits;
    return bits;
}

API void dsvn_neighbordif2(const int16_t *mvx, const int16_t *mvy,
                           const uint8_t *skip, int nbh, int x, int y,
                           int32_t *out2)
{
    int k = x + y * nbh;
    int cmx = mvx[k], cmy = mvy[k];
    int vx0, vy0, vx1, vy1;
    if (iabs(cmx) < 2 && iabs(cmy) < 2) {
        out2[0] = out2[1] = 0;
        return;
    }
    vx0 = vx1 = cmx;
    vy0 = vy1 = cmy;
    if (x > 0) {
        int k2 = (x - 1) + y * nbh;
        if ((mvx[k2] || mvy[k2]) && !skip[k2]) { vx0 = mvx[k2]; vy0 = mvy[k2]; }
    }
    if (y > 0) {
        int k2 = x + (y - 1) * nbh;
        if ((mvx[k2] || mvy[k2]) && !skip[k2]) { vx1 = mvx[k2]; vy1 = mvy[k2]; }
    }
    out2[0] = iabs(vx0 - cmx) + iabs(vy0 - cmy);
    out2[1] = iabs(vx1 - cmx) + iabs(vy1 - cmy);
}

/* ---- ZBRLE encode (ref: bs.c:284-318): bits[i] in {0,1}, optionally
 * inverted; returns blob byte length written to out. */
API int32_t dsvn_zbrle_enc(const uint8_t *bits, int32_t n, int inv,
                           uint8_t *out, int64_t cap)
{
    BW w = { out, 0, 0, 0 };
    w.lim = (uint32_t)(cap * 8);
    int nz = 0;
    int32_t i;
    for (i = 0; i < n; i++) {
        int b = bits[i] & 1;
        if (inv) b = 1 - b;
        if (b) {
            bw_ueg(&w, (unsigned)nz);
            nz = 0;
        } else {
            nz++;
        }
    }
    bw_ueg(&w, (unsigned)nz);
    bw_align(&w);
    if (w.ovf) return -1;
    return (int32_t)(w.bit >> 3);
}

/* ---- Packed sparse-scan segment -> dense scan array.
 * Layout (little-endian): u32 n, u16 nexc_v, u16 nexc_p,
 * then n bytes of truncated values, n bytes of truncated position
 * deltas, then at (8 + 2n rounded up to 4): nexc_v x {u32 idx, i32 val},
 * nexc_p x {u32 idx, u32 delta}. Exceptions patch the truncated arrays
 * by prefix index. v (length total) must be zero-filled by the caller.
 * Returns 0 on success, -1 on a bounds violation. */
API int32_t dsvn_unpack_scan(const uint8_t *seg, int64_t seglen,
                             int32_t *v, int64_t total)
{
    uint32_t n, ev, ep, i;
    const uint8_t *vals8, *dpos8, *exc;
    int64_t acc = 0, excoff;
    if (seglen < 8) return -1;
    n = (uint32_t)seg[0] | ((uint32_t)seg[1] << 8)
        | ((uint32_t)seg[2] << 16) | ((uint32_t)seg[3] << 24);
    ev = (uint32_t)seg[4] | ((uint32_t)seg[5] << 8);
    ep = (uint32_t)seg[6] | ((uint32_t)seg[7] << 8);
    if ((int64_t)n > total) return -1;
    excoff = (8 + 2 * (int64_t)n + 3) & ~(int64_t)3;
    if (excoff + 8 * (int64_t)(ev + ep) > seglen) return -1;
    vals8 = seg + 8;
    dpos8 = seg + 8 + n;
    exc = seg + excoff;
    {
        /* widen into scratch, patch exceptions, then scatter */
        int64_t pos;
        int32_t *wv = (int32_t *)malloc((size_t)n * sizeof(int32_t));
        uint32_t *wd = (uint32_t *)malloc((size_t)n * sizeof(uint32_t));
        if ((!wv || !wd) && n) { free(wv); free(wd); return -1; }
        for (i = 0; i < n; i++) {
            wv[i] = (int32_t)(int8_t)vals8[i];
            wd[i] = dpos8[i];
        }
        for (i = 0; i < ev; i++, exc += 8) {
            uint32_t idx = (uint32_t)exc[0] | ((uint32_t)exc[1] << 8)
                | ((uint32_t)exc[2] << 16) | ((uint32_t)exc[3] << 24);
            int32_t val = (int32_t)((uint32_t)exc[4] | ((uint32_t)exc[5] << 8)
                | ((uint32_t)exc[6] << 16) | ((uint32_t)exc[7] << 24));
            if (idx >= n) { free(wv); free(wd); return -1; }
            wv[idx] = val;
        }
        for (i = 0; i < ep; i++, exc += 8) {
            uint32_t idx = (uint32_t)exc[0] | ((uint32_t)exc[1] << 8)
                | ((uint32_t)exc[2] << 16) | ((uint32_t)exc[3] << 24);
            uint32_t dp = (uint32_t)exc[4] | ((uint32_t)exc[5] << 8)
                | ((uint32_t)exc[6] << 16) | ((uint32_t)exc[7] << 24);
            if (idx >= n) { free(wv); free(wd); return -1; }
            wd[idx] = dp;
        }
        pos = 0;
        for (i = 0; i < n; i++) {
            pos += wd[i];
            if (pos < 0 || pos >= total) { free(wv); free(wd); return -1; }
            v[pos] = wv[i];
        }
        free(wv);
        free(wd);
    }
    return 0;
}

/* ---- Motion-field sub-section blob writers (ref: dsv_encoder.c:692-794
 * serialization): values are precomputed by the (vectorized) host; these
 * just run the serial bit layout. */
API int32_t dsvn_seg_blob(const int32_t *vals, int32_t n, uint8_t *out,
                          int64_t cap)
{
    BW w = { out, 0, 0, 0 };
    w.lim = (uint32_t)(cap * 8);
    int32_t i;
    for (i = 0; i < n; i++) {
        int32_t v = vals[i];
        int s = 0;
        unsigned x;
        if (v < 0) { s = 1; v = -v; }
        bw_ueg(&w, (unsigned)v);
        if (v) bw_bit(&w, s);
        (void)x;
    }
    bw_align(&w);
    if (w.ovf) return -1;
    return (int32_t)(w.bit >> 3);
}

/* Sub-block intra masks + DC section: for each listed intra block,
 * 1 bit all-intra else 4-bit submask, then 1 bit dc-present + 8-bit dc. */
API int32_t dsvn_sbim_blob(const uint8_t *submask, const uint16_t *dc,
                           int32_t n, int32_t mask_all, int32_t dc_pred_bit,
                           uint8_t *out, int64_t cap)
{
    BW w = { out, 0, 0, 0 };
    w.lim = (uint32_t)(cap * 8);
    int32_t i;
    for (i = 0; i < n; i++) {
        if (submask[i] == (uint8_t)mask_all) {
            bw_bit(&w, 1);
        } else {
            bw_bit(&w, 0);
            bw_bits(&w, 4, submask[i]);
        }
        if (dc[i] & (uint16_t)dc_pred_bit) {
            bw_bit(&w, 1);
            bw_bits(&w, 8, dc[i] & 0xFF);
        } else {
            bw_bit(&w, 0);
        }
    }
    bw_align(&w);
    if (w.ovf) return -1;
    return (int32_t)(w.bit >> 3);
}

/* ---- HZCC scan encode straight from a packed sparse segment (the format
 * dsvn_unpack_scan reads): walks only the nonzero coefficients, with run
 * lengths derived from the position deltas. Bit-identical to expanding the
 * segment and running dsvn_scan_enc on the dense array.
 * Core variant writes into a caller-owned bit writer at its current
 * (byte-aligned) position, so whole packets assemble in one buffer. */
static int scan_packed_bw(BW *w, const uint8_t *seg, int64_t seglen,
                          int64_t total, const DSVN_SEG *segs, int nsegs)
{
    uint32_t n, ev, ep, i;
    const uint8_t *vals8, *dpos8, *exc;
    int64_t excoff;
    int32_t *wv;
    uint32_t *wd;
    int vk = 0, nruns = 0, s = 0;
    int64_t pos = 0, prev = -1, seg_end;
    uint32_t endbit, blob_start = w->bit;

    if (seglen < 8) return -1;
    n = (uint32_t)seg[0] | ((uint32_t)seg[1] << 8)
        | ((uint32_t)seg[2] << 16) | ((uint32_t)seg[3] << 24);
    ev = (uint32_t)seg[4] | ((uint32_t)seg[5] << 8);
    ep = (uint32_t)seg[6] | ((uint32_t)seg[7] << 8);
    if ((int64_t)n > total) return -1;
    excoff = (8 + 2 * (int64_t)n + 3) & ~(int64_t)3;
    if (excoff + 8 * (int64_t)(ev + ep) > seglen) return -1;
    vals8 = seg + 8;
    dpos8 = seg + 8 + n;
    exc = seg + excoff;
    wv = (int32_t *)malloc((size_t)n * sizeof(int32_t));
    wd = (uint32_t *)malloc((size_t)n * sizeof(uint32_t));
    if ((!wv || !wd) && n) { free(wv); free(wd); return -1; }
    for (i = 0; i < n; i++) {
        wv[i] = (int32_t)(int8_t)vals8[i];
        wd[i] = dpos8[i];
    }
    for (i = 0; i < ev; i++, exc += 8) {
        uint32_t idx = (uint32_t)exc[0] | ((uint32_t)exc[1] << 8)
            | ((uint32_t)exc[2] << 16) | ((uint32_t)exc[3] << 24);
        int32_t val = (int32_t)((uint32_t)exc[4] | ((uint32_t)exc[5] << 8)
            | ((uint32_t)exc[6] << 16) | ((uint32_t)exc[7] << 24));
        if (idx >= n) { free(wv); free(wd); return -1; }
        wv[idx] = val;
    }
    for (i = 0; i < ep; i++, exc += 8) {
        uint32_t idx = (uint32_t)exc[0] | ((uint32_t)exc[1] << 8)
            | ((uint32_t)exc[2] << 16) | ((uint32_t)exc[3] << 24);
        uint32_t dp = (uint32_t)exc[4] | ((uint32_t)exc[5] << 8)
            | ((uint32_t)exc[6] << 16) | ((uint32_t)exc[7] << 24);
        if (idx >= n) { free(wv); free(wd); return -1; }
        wd[idx] = dp;
    }

    bw_bits(w, RUN_BITS, 0);
    bw_align(w);
    seg_end = (nsegs > 0) ? (int64_t)segs[0].count : total;
    for (i = 0; i < n; i++) {
        int damp;
        pos += wd[i];
        if (pos < 0 || pos >= total) { free(wv); free(wd); return -1; }
        while (pos >= seg_end && s + 1 < nsegs) {
            s++;
            seg_end += segs[s].count;
        }
        damp = segs[s].damp;
        bw_ueg(w, (unsigned)(pos - prev - 1));
        if (damp < 0) bw_neg(w, wv[i]);
        else bw_nrice(w, wv[i], &vk, damp);
        nruns++;
        prev = pos;
    }
    free(wv);
    free(wd);
    bw_align(w);
    endbit = w->bit;
    w->bit = blob_start;
    bw_bits(w, RUN_BITS, (unsigned)nruns);
    w->bit = endbit;
    bw_align(w);
    if (w->ovf) return -1;
    return 0;
}

API int64_t dsvn_scan_enc_packed(const uint8_t *seg, int64_t seglen,
                                 int64_t total, const DSVN_SEG *segs,
                                 int nsegs, uint8_t *out, int64_t cap)
{
    BW w = { out, 0, 0, 0 };
    w.lim = (uint32_t)(cap * 8);
    if (scan_packed_bw(&w, seg, seglen, total, segs, nsegs) != 0) return -1;
    return (int64_t)(w.bit >> 3);
}

/* ---- HZCC scan encode from the device's dense split-band transfer
 * format: the LL band (segment 0, NEG-coded, holds the wide values) as
 * int32, every HF band as int8. With the d2h link at ~40-175 MB/s the
 * ~1-byte-per-coefficient dense form beats on-device sparse packing,
 * whose scatter/sort programs dominated the device profile. Bit-identical
 * to dsvn_scan_enc on the recombined array. */
static int scan_dense8_bw(BW *w, const int32_t *ll, const int8_t *rest,
                          const DSVN_SEG *segs, int nsegs)
{
    int run = 0, nruns = 0, vk = 0, s;
    uint32_t endbit, blob_start = w->bit;

    bw_bits(w, RUN_BITS, 0);
    bw_align(w);
    for (s = 0; s < nsegs; s++) {
        int32_t n = segs[s].count, j;
        int damp = segs[s].damp;
        for (j = 0; j < n; j++) {
            int32_t val = (s == 0) ? ll[j] : (int32_t)*rest++;
            if (val) {
                bw_ueg(w, (unsigned)run);
                if (damp < 0) bw_neg(w, val);
                else bw_nrice(w, val, &vk, damp);
                run = -1;
                nruns++;
            }
            run++;
        }
    }
    bw_align(w);
    endbit = w->bit;
    w->bit = blob_start;
    bw_bits(w, RUN_BITS, (unsigned)nruns);
    w->bit = endbit;
    bw_align(w);
    return w->ovf ? -1 : 0;
}

API int64_t dsvn_scan_enc_d8(const int32_t *ll, const int8_t *rest,
                             const DSVN_SEG *segs, int nsegs,
                             uint8_t *out, int64_t cap)
{
    BW w = { out, 0, 0, 0 };
    w.lim = (uint32_t)(cap * 8);
    if (scan_dense8_bw(&w, ll, rest, segs, nsegs) != 0) return -1;
    return (int64_t)(w.bit >> 3);
}

/* Expand segment-compacted HF rows back into the flat dense int8 layout:
 * the device ships only the rows containing nonzeros (row-gathered to the
 * buffer front) plus their original row ids; all-zero rows are implied.
 * dense (total bytes) is fully rewritten. Returns 0, or -1 on a row id
 * out of range. */
API int32_t dsvn_expand_rows(const int8_t *packed, const int32_t *rowids,
                             int64_t nrows, int32_t segb,
                             int8_t *dense, int64_t total)
{
    int64_t k;
    memset(dense, 0, (size_t)total);
    for (k = 0; k < nrows; k++) {
        int64_t off = (int64_t)rowids[k] * segb;
        if (off < 0 || off + segb > total) return -1;
        memcpy(dense + off, packed + k * segb, (size_t)segb);
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* Whole-packet assembly: intra picture packets for a frame batch.    */
/* The bit layout mirrors the encoder session's Python serializer      */
/* (ref: dsv_encoder.c:1046-1126 packet body, bs.c codes); moving it   */
/* here removes the per-frame host serialization floor.                */
/* ------------------------------------------------------------------ */

static void bw_seg(BW *w, int32_t v)
{
    int s = 0;
    if (v < 0) { s = 1; v = -v; }
    bw_ueg(w, (unsigned)v);
    if (v) bw_bit(w, s);
}

/* byte-aligned raw copy into the writer */
static void bw_bytes(BW *w, const uint8_t *p, int64_t nbytes)
{
    if ((int64_t)w->bit + nbytes * 8 > (int64_t)w->lim) { w->ovf = 1; return; }
    memcpy(w->base + (w->bit >> 3), p, (size_t)nbytes);
    w->bit += (uint32_t)(nbytes * 8);
}

/* ZBRLE sub-blob framed as the encoder writes it: align, UEG length,
 * align, payload bytes. scratch must hold 4*nbits + 64 bytes. */
static int blob_zbrle(BW *w, const uint8_t *bits, int32_t nbits, int inv,
                      uint8_t *scratch, int64_t scap)
{
    int32_t bl;
    memset(scratch, 0, (size_t)scap);
    bl = dsvn_zbrle_enc(bits, nbits, inv, scratch, scap);
    if (bl < 0) return -1;
    bw_align(w);
    bw_ueg(w, (unsigned)bl);
    bw_align(w);
    bw_bytes(w, scratch, bl);
    return 0;
}

/* One coded plane: align, 32-bit length slot, SEG(ll), align, packed
 * scan blob, EOP byte, align, then patch the length slot. */
static int plane_packed_bw(BW *w, int32_t ll, const uint8_t *seg,
                           int64_t seglen, int64_t total,
                           const DSVN_SEG *segs, int nsegs, int eop)
{
    uint32_t startp, endp;
    bw_align(w);
    startp = w->bit >> 3;
    bw_bits(w, 32, 0);
    bw_seg(w, ll);
    bw_align(w);
    if (scan_packed_bw(w, seg, seglen, total, segs, nsegs) != 0) return -1;
    bw_bits(w, 8, (unsigned)eop);
    bw_align(w);
    if (w->ovf) return -1;
    endp = w->bit >> 3;
    {
        uint32_t plen = (endp - startp) - 4;
        w->base[startp + 0] = (uint8_t)(plen >> 24);
        w->base[startp + 1] = (uint8_t)(plen >> 16);
        w->base[startp + 2] = (uint8_t)(plen >> 8);
        w->base[startp + 3] = (uint8_t)plen;
    }
    return 0;
}

/* plane_packed_bw twin for a device-built scan blob: the entropy coding
 * already happened on device (ops/scan_pl); the framing here is just the
 * length slot, SEG(ll), the blob bytes, and the EOP marker. */
static int plane_blob_bw(BW *w, int32_t ll, const uint8_t *blob,
                         int64_t nbytes, int eop)
{
    uint32_t startp, endp;
    bw_align(w);
    startp = w->bit >> 3;
    bw_bits(w, 32, 0);
    bw_seg(w, ll);
    bw_align(w);
    bw_bytes(w, blob, nbytes);
    bw_bits(w, 8, (unsigned)eop);
    bw_align(w);
    if (w->ovf) return -1;
    endp = w->bit >> 3;
    {
        uint32_t plen = (endp - startp) - 4;
        w->base[startp + 0] = (uint8_t)(plen >> 24);
        w->base[startp + 1] = (uint8_t)(plen >> 16);
        w->base[startp + 2] = (uint8_t)(plen >> 8);
        w->base[startp + 3] = (uint8_t)plen;
    }
    return 0;
}

/* plane_packed_bw twin for the dense split-band format */
static int plane_dense8_bw(BW *w, int32_t ll, const int32_t *llband,
                           const int8_t *rest,
                           const DSVN_SEG *segs, int nsegs, int eop)
{
    uint32_t startp, endp;
    bw_align(w);
    startp = w->bit >> 3;
    bw_bits(w, 32, 0);
    bw_seg(w, ll);
    bw_align(w);
    if (scan_dense8_bw(w, llband, rest, segs, nsegs) != 0) return -1;
    bw_bits(w, 8, (unsigned)eop);
    bw_align(w);
    if (w->ovf) return -1;
    endp = w->bit >> 3;
    {
        uint32_t plen = (endp - startp) - 4;
        w->base[startp + 0] = (uint8_t)(plen >> 24);
        w->base[startp + 1] = (uint8_t)(plen >> 16);
        w->base[startp + 2] = (uint8_t)(plen >> 8);
        w->base[startp + 3] = (uint8_t)plen;
    }
    return 0;
}

/* Assemble nfr complete intra picture packets into out (zero-filled).
 * hdr6 = fourcc(4) + version + packet type. statbits per frame:
 * {stable, maintain, ringing} markers (also the ZBRLE inversion flags).
 * Packed plane segments are indexed [c*nfr + fi] in offs/lens/lls; the
 * per-plane scan segment tables are concatenated in segs with seg_n[c]
 * entries each. When d8rest is non-NULL the planes use the dense
 * split-band format instead: d8ll + offs_ll (LL band, int32) and
 * d8rest + offs (HF bands, int8), both ELEMENT offsets; packed/lens are
 * ignored. Writes per-packet byte offsets/lengths; returns total
 * bytes or -1 (overflow / malformed segment). */
API int64_t dsvn_intra_packets(
    int32_t nfr, const uint8_t *hdr6,
    const uint32_t *fnums, const int32_t *quants,
    int32_t blkw_code, int32_t blkh_code, int32_t qp_bits,
    const uint8_t *statbits, int32_t intra_filter_bit,
    const uint8_t *stable_bits, const uint8_t *ring_bits,
    const uint8_t *maint_bits, int32_t nblk,
    const uint8_t *packed,
    const int32_t *d8ll, const int8_t *d8rest, const int64_t *offs_ll,
    const int64_t *offs, const int64_t *lens,
    const int32_t *lls,
    const DSVN_SEG *segs, const int32_t *seg_n, int32_t eop,
    int32_t blobmode,
    uint8_t *out, int64_t cap, int64_t *pkt_off, int64_t *pkt_len)
{
    BW w = { out, 0, 0, 0 };
    int32_t fi, c;
    int64_t scap = 4 * (int64_t)nblk + 64;
    uint8_t *scratch = (uint8_t *)malloc((size_t)scap);
    const DSVN_SEG *ptab[3];
    int64_t ptot[3];
    int32_t psegn[3];

    if (!scratch) return -1;
    w.lim = (uint32_t)(cap > 0x1FFFFFFF ? 0xFFFFFFF0u : (uint32_t)(cap * 8));
    {
        const DSVN_SEG *t = segs;
        for (c = 0; c < 3; c++) {
            int32_t k;
            ptab[c] = t;
            psegn[c] = seg_n[c];
            ptot[c] = 0;
            for (k = 0; k < seg_n[c]; k++) ptot[c] += t[k].count;
            t += seg_n[c];
        }
    }
    for (fi = 0; fi < nfr; fi++) {
        const uint8_t *st = statbits + 3 * fi;
        int64_t start = (int64_t)(w.bit >> 3);
        pkt_off[fi] = start;
        bw_bytes(&w, hdr6, 6);
        bw_bits(&w, 32, 0);           /* prev link */
        bw_bits(&w, 32, 0);           /* next link */
        bw_bits(&w, 32, fnums[fi]);
        bw_ueg(&w, (unsigned)blkw_code);
        bw_ueg(&w, (unsigned)blkh_code);
        bw_align(&w);
        bw_bit(&w, st[0]);
        bw_bit(&w, st[1]);
        bw_bit(&w, st[2]);
        bw_bit(&w, intra_filter_bit);
        bw_bits(&w, (unsigned)qp_bits, (unsigned)quants[fi]);
        bw_bit(&w, 0);
        bw_align(&w);
        if (blob_zbrle(&w, stable_bits + (int64_t)fi * nblk, nblk,
                       st[0] != 0, scratch, scap) != 0) goto fail;
        if (blob_zbrle(&w, ring_bits + (int64_t)fi * nblk, nblk,
                       st[2] != 0, scratch, scap) != 0) goto fail;
        if (blob_zbrle(&w, maint_bits + (int64_t)fi * nblk, nblk,
                       st[1] != 0, scratch, scap) != 0) goto fail;
        bw_align(&w);
        for (c = 0; c < 3; c++) {
            int64_t k = (int64_t)c * nfr + fi;
            if (blobmode) {
                if (plane_blob_bw(&w, lls[k], packed + offs[k],
                                  lens[k], eop) != 0)
                    goto fail;
            } else if (d8rest) {
                if (plane_dense8_bw(&w, lls[k], d8ll + offs_ll[k],
                                    d8rest + offs[k],
                                    ptab[c], psegn[c], eop) != 0)
                    goto fail;
            } else if (plane_packed_bw(&w, lls[k], packed + offs[k],
                                       lens[k], ptot[c], ptab[c],
                                       psegn[c], eop) != 0) {
                goto fail;
            }
        }
        if (w.ovf) goto fail;
        pkt_len[fi] = (int64_t)(w.bit >> 3) - start;
    }
    free(scratch);
    return (int64_t)(w.bit >> 3);
fail:
    free(scratch);
    return -1;
}

/* ------------------------------------------------------------------ */
/* Rate-control helper: average luma of the coarsest ME-pyramid level. */
/* Repeated 2x box downsample with +2>>2 rounding (every intermediate  */
/* dimension must be even — caller checks), then the truncating        */
/* row-average-of-row-averages (ref: dsv_encoder.c:108-127, frame.c:   */
/* 210-234 pyramid build it replaces).                                 */
/* ------------------------------------------------------------------ */
API int32_t dsvn_luma_avg_ds(const uint8_t *px, int64_t stride,
                             int32_t w, int32_t h, int32_t levels)
{
    uint8_t *a = NULL, *b = NULL;
    const uint8_t *src = px;
    int64_t sstride = stride;
    int32_t lw = w, lh = h, l;
    int64_t rowsum, total;
    int32_t y, x;

    for (l = 0; l < levels; l++) {
        int32_t dw = lw >> 1, dh = lh >> 1;
        uint8_t *dst;
        if (!a) {
            a = (uint8_t *)malloc((size_t)dw * dh);
            b = (uint8_t *)malloc((size_t)((dw >> 1) ? (dw >> 1) * (dh >> 1)
                                                     : 1));
            if (!a || !b) { free(a); free(b); return -1; }
            dst = a;
        } else {
            dst = (src == a) ? b : a;
        }
        for (y = 0; y < dh; y++) {
            const uint8_t *r0 = src + (int64_t)(2 * y) * sstride;
            const uint8_t *r1 = r0 + sstride;
            uint8_t *d = dst + (int64_t)y * dw;
            for (x = 0; x < dw; x++) {
                d[x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1]
                                  + r1[2 * x] + r1[2 * x + 1] + 2) >> 2);
            }
        }
        src = dst;
        sstride = dw;
        lw = dw;
        lh = dh;
    }
    total = 0;
    for (y = 0; y < lh; y++) {
        rowsum = 0;
        for (x = 0; x < lw; x++) rowsum += src[(int64_t)y * sstride + x];
        total += rowsum / lw;
    }
    free(a);
    free(b);
    return (int32_t)(total / lh);
}
