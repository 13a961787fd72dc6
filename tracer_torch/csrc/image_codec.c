/* Image decoding work that must not run one byte or one symbol at a time in
 * Python: the PNG row unfilter, and the JPEG entropy decoder, IDCT,
 * upsampling and colour conversion. The marker parsing lives in
 * tracer_torch/render/jpeg.py and tracer_torch/io.py.
 *
 * The JPEG stages follow libjpeg-turbo's default decompression path (the one
 * PIL takes), so the output equals PIL's decode bit for bit:
 *   - the accurate integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2, the
 *     IDCT range-limit table of jdmaster.c);
 *   - "fancy" triangle-filter upsampling for h2v1, h1v2 and h2v2 chroma
 *     (jdsample.c), with edge samples replicated as libjpeg-turbo's SIMD
 *     upsamplers do, and plain replication when the chroma plane is at most
 *     two samples wide (h2v1 and h2v2), as jinit_upsampler chooses;
 *   - YCbCr -> RGB with the fixed-point tables of jdcolor.c (SCALEBITS 16).
 *
 * Compile: gcc -O3 -shared -fPIC image_codec.c -o libimage_codec.so
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------------ */
/* PNG                                                                      */
/* ------------------------------------------------------------------------ */

/* Undo the per-row filters (PNG spec, section 9) of h rows of stride bytes
 * (each preceded by its filter byte) into out (h * stride bytes). Returns 0,
 * or -(y + 1) for the first row y with a filter type above 4. */
int64_t png_unfilter(const uint8_t *raw, int64_t h, int64_t stride, int64_t bpp,
                     uint8_t *out) {
  for (int64_t y = 0; y < h; y++) {
    const uint8_t *line = raw + y * (stride + 1);
    uint8_t kind = line[0];
    line++;
    uint8_t *cur = out + y * stride;
    const uint8_t *up = y ? cur - stride : NULL;
    switch (kind) {
      case 0:
        memcpy(cur, line, (size_t)stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; i++)
          cur[i] = (uint8_t)(line[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; i++)
          cur[i] = (uint8_t)(line[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = up ? up[i] : 0;
          cur[i] = (uint8_t)(line[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = up ? up[i] : 0;
          int c = (up && i >= bpp) ? up[i - bpp] : 0;
          int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(line[i] + pred);
        }
        break;
      default:
        return -(y + 1);
    }
  }
  return 0;
}

/* ------------------------------------------------------------------------ */
/* JPEG entropy decoding                                                    */
/* ------------------------------------------------------------------------ */

static const int ZIGZAG[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    /* extra entries for a corrupt run past the end, as libjpeg's table */
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

#define LOOK 9

typedef struct {
  int32_t maxcode[18];  /* largest code of each length, -1 if none */
  int32_t valoff[18];   /* huffval index of a code of that length */
  uint8_t vals[256];
  uint8_t look_len[1 << LOOK]; /* 0: longer than LOOK bits */
  uint8_t look_val[1 << LOOK];
} Huff;

static int build_huff(const uint8_t *bits, const uint8_t *vals, Huff *t) {
  int code = 0, k = 0;
  int huffcode[257];
  uint8_t huffsize[257];
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l - 1]; i++) {
      if (k >= 256) return -1;
      huffsize[k++] = (uint8_t)l;
    }
  int n = k;
  memcpy(t->vals, vals, 256);
  k = 0;
  int si = n ? huffsize[0] : 0;
  while (k < n) {
    while (k < n && huffsize[k] == si) huffcode[k++] = code++;
    if (code >= (1 << si)) return -1;
    code <<= 1;
    si++;
  }
  k = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l - 1]) {
      t->valoff[l] = k - huffcode[k];
      k += bits[l - 1];
      t->maxcode[l] = huffcode[k - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->maxcode[17] = 0x7FFFFFFF;
  memset(t->look_len, 0, sizeof t->look_len);
  k = 0;
  for (int l = 1; l <= LOOK; l++)
    for (int i = 0; i < bits[l - 1]; i++, k++) {
      int lookbits = huffcode[k] << (LOOK - l);
      for (int c = 0; c < (1 << (LOOK - l)); c++) {
        t->look_len[lookbits + c] = (uint8_t)l;
        t->look_val[lookbits + c] = vals[k];
      }
    }
  return 0;
}

typedef struct {
  const uint8_t *data;
  int64_t len, pos;
  uint64_t buf; /* bits, most significant first */
  int nbits;
  int hit_marker; /* a marker stopped the fill: zeros are shifted in */
} Bits;

static void fill(Bits *b) {
  while (b->nbits <= 56) {
    int byte = 0;
    if (!b->hit_marker && b->pos < b->len) {
      byte = b->data[b->pos];
      if (byte == 0xFF) {
        int next = b->pos + 1 < b->len ? b->data[b->pos + 1] : 0xD9;
        if (next == 0x00) {
          b->pos += 2;
        } else {
          b->hit_marker = 1;
          byte = 0;
        }
      } else {
        b->pos++;
      }
    }
    b->buf |= (uint64_t)byte << (56 - b->nbits);
    b->nbits += 8;
  }
}

static inline int get_bits(Bits *b, int n) {
  if (n == 0) return 0;
  if (b->nbits < n) fill(b);
  int v = (int)(b->buf >> (64 - n));
  b->buf <<= n;
  b->nbits -= n;
  return v;
}

static inline int get_bit(Bits *b) { return get_bits(b, 1); }

static inline int decode(Bits *b, const Huff *t) {
  if (b->nbits < 16) fill(b);
  int look = (int)(b->buf >> (64 - LOOK));
  int l = t->look_len[look];
  if (l) {
    b->buf <<= l;
    b->nbits -= l;
    return t->look_val[look];
  }
  int code = get_bits(b, LOOK);
  l = LOOK;
  while (code > t->maxcode[l]) {
    code = (code << 1) | get_bit(b);
    if (++l > 16) return 0; /* corrupt data: libjpeg also substitutes 0 */
  }
  return t->vals[(t->valoff[l] + code) & 0xFF];
}

static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + ((-1) << s) + 1 : v;
}

/* Skip to the marker after the bits of a restart interval or a scan, and
 * return its offset. */
static int64_t next_marker(Bits *b) {
  int64_t p = b->pos;
  while (p + 1 < b->len && !(b->data[p] == 0xFF && b->data[p + 1] != 0x00 &&
                             b->data[p + 1] != 0xFF))
    p++;
  return p;
}

/* One scan of a sequential or progressive JPEG into the coefficient planes.
 *
 * comps: ncomp rows of 8 int32: h, v (sampling factors), bw (blocks per row
 * of the component's coefficient plane), cw, ch (the component's own blocks
 * per row and column: what a non-interleaved scan visits), coef offset into
 * coefs (in int16 units), DC table id, AC table id (0..3).
 * huff_bits (8, 16) and huff_vals (8, 256): DC tables 0..3 then AC 0..3.
 * Coefficients are stored in natural order, 64 per block.
 * Returns the offset of the marker that ends the scan, or a negative error
 * code (-1 bad Huffman table). */
int64_t jpeg_decode_scan(const uint8_t *data, int64_t len, int64_t pos,
                         int32_t progressive, int32_t ncomp, const int32_t *comps,
                         int32_t mcus_x, int32_t mcus_y, int32_t Ss, int32_t Se,
                         int32_t Ah, int32_t Al, int32_t restart,
                         const uint8_t *huff_bits, const uint8_t *huff_vals,
                         int16_t *coefs) {
  Huff tables[8];
  int used[8] = {0};
  for (int c = 0; c < ncomp; c++) {
    used[comps[c * 8 + 6]] = 1;
    used[4 + comps[c * 8 + 7]] = 1;
  }
  for (int i = 0; i < 8; i++)
    if (used[i] && build_huff(huff_bits + i * 16, huff_vals + i * 256, &tables[i]))
      return -1;

  Bits b = {data, len, pos, 0, 0, 0};
  int pred[4] = {0, 0, 0, 0};
  int eobrun = 0;
  int64_t n_mcu;
  if (ncomp == 1) {
    n_mcu = (int64_t)comps[3] * comps[4];
  } else {
    n_mcu = (int64_t)mcus_x * mcus_y;
  }
  int todo = restart;
  for (int64_t m = 0; m < n_mcu; m++) {
    if (restart && todo == 0) {
      /* restart marker: drop the padding bits, skip RSTn, reset state */
      b.pos = next_marker(&b);
      if (b.pos + 1 < len && b.data[b.pos + 1] >= 0xD0 && b.data[b.pos + 1] <= 0xD7)
        b.pos += 2;
      b.buf = 0;
      b.nbits = 0;
      b.hit_marker = 0;
      memset(pred, 0, sizeof pred);
      eobrun = 0;
      todo = restart;
    }
    if (restart) todo--;
    for (int c = 0; c < ncomp; c++) {
      const int32_t *cp = comps + c * 8;
      int h = cp[0], v = cp[1], bw = cp[2];
      int nbx = ncomp == 1 ? 1 : h, nby = ncomp == 1 ? 1 : v;
      const Huff *dc = &tables[cp[6]], *ac = &tables[4 + cp[7]];
      for (int by = 0; by < nby; by++)
        for (int bx = 0; bx < nbx; bx++) {
          int64_t row, col;
          if (ncomp == 1) {
            row = m / cp[3];
            col = m % cp[3];
          } else {
            row = (m / mcus_x) * v + by;
            col = (m % mcus_x) * h + bx;
          }
          int16_t *blk = coefs + cp[5] + (row * bw + col) * 64;
          if (!progressive) {
            int s = decode(&b, dc);
            int diff = s ? extend(get_bits(&b, s), s) : 0;
            pred[c] += diff;
            blk[0] = (int16_t)pred[c];
            for (int k = 1; k < 64; k++) {
              int rs = decode(&b, ac), r = rs >> 4;
              s = rs & 15;
              if (s) {
                k += r;
                blk[ZIGZAG[k]] = (int16_t)extend(get_bits(&b, s), s);
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
          } else if (Ss == 0) {
            if (Ah == 0) { /* DC first */
              int s = decode(&b, dc);
              int diff = s ? extend(get_bits(&b, s), s) : 0;
              pred[c] += diff;
              blk[0] = (int16_t)(pred[c] * (1 << Al));
            } else if (get_bit(&b)) { /* DC refinement */
              blk[0] |= (int16_t)(1 << Al);
            }
          } else if (Ah == 0) { /* AC first */
            if (eobrun > 0) {
              eobrun--;
              continue;
            }
            for (int k = Ss; k <= Se; k++) {
              int rs = decode(&b, ac), r = rs >> 4, s = rs & 15;
              if (s) {
                k += r;
                blk[ZIGZAG[k]] = (int16_t)(extend(get_bits(&b, s), s) * (1 << Al));
              } else if (r == 15) {
                k += 15;
              } else {
                eobrun = 1 << r;
                if (r) eobrun += get_bits(&b, r);
                eobrun--;
                break;
              }
            }
          } else { /* AC refinement (jdphuff.c decode_mcu_AC_refine) */
            int p1 = 1 << Al, m1 = (-1) * (1 << Al);
            int k = Ss;
            if (eobrun == 0) {
              for (; k <= Se; k++) {
                int rs = decode(&b, ac), r = rs >> 4, s = rs & 15;
                if (s) {
                  s = get_bit(&b) ? p1 : m1;
                } else if (r != 15) {
                  eobrun = 1 << r;
                  if (r) eobrun += get_bits(&b, r);
                  break;
                }
                do {
                  int16_t *coef = blk + ZIGZAG[k];
                  if (*coef != 0) {
                    if (get_bit(&b) && (*coef & p1) == 0)
                      *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
                  } else if (--r < 0) {
                    break;
                  }
                  k++;
                } while (k <= Se);
                if (s) blk[ZIGZAG[k]] = (int16_t)s;
              }
            }
            if (eobrun > 0) {
              for (; k <= Se; k++) {
                int16_t *coef = blk + ZIGZAG[k];
                if (*coef != 0 && get_bit(&b) && (*coef & p1) == 0)
                  *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
              }
              eobrun--;
            }
          }
        }
    }
  }
  return next_marker(&b);
}

/* ------------------------------------------------------------------------ */
/* IDCT (jidctint.c, jpeg_idct_islow)                                       */
/* ------------------------------------------------------------------------ */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

/* The post-IDCT range limit of jdmaster.c, indexed by (x & 1023). */
static uint8_t IDCT_LIMIT[1024];

static void init_limit(void) {
  for (int i = 0; i < 1024; i++) {
    int x = i < 512 ? i : i - 1024;
    int y = x + 128;
    IDCT_LIMIT[i] = (uint8_t)(y < 0 ? 0 : y > 255 ? 255 : y);
  }
}

static void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out,
                       int64_t stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t *ip = in + c;
    const uint16_t *qp = q + c;
    int64_t *w = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int64_t dc = ((int64_t)ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) w[r * 8] = dc;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = (int64_t)ip[16] * qp[16];
    z3 = (int64_t)ip[48] * qp[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    t2 = z1 + z3 * (-FIX_1_847759065);
    t3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    t0 = (z2 + z3) * (1 << CONST_BITS);
    t1 = (z2 - z3) * (1 << CONST_BITS);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = (int64_t)ip[56] * qp[56];
    t1 = (int64_t)ip[40] * qp[40];
    t2 = (int64_t)ip[24] * qp[24];
    t3 = (int64_t)ip[8] * qp[8];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * FIX_1_175875602;
    t0 = t0 * FIX_0_298631336;
    t1 = t1 * FIX_2_053119869;
    t2 = t2 * FIX_3_072711026;
    t3 = t3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    /* jidctint.c keeps the pass-1 results in int */
    w[0] = (int)DESCALE(t10 + t3, CONST_BITS - PASS1_BITS);
    w[56] = (int)DESCALE(t10 - t3, CONST_BITS - PASS1_BITS);
    w[8] = (int)DESCALE(t11 + t2, CONST_BITS - PASS1_BITS);
    w[48] = (int)DESCALE(t11 - t2, CONST_BITS - PASS1_BITS);
    w[16] = (int)DESCALE(t12 + t1, CONST_BITS - PASS1_BITS);
    w[40] = (int)DESCALE(t12 - t1, CONST_BITS - PASS1_BITS);
    w[24] = (int)DESCALE(t13 + t0, CONST_BITS - PASS1_BITS);
    w[32] = (int)DESCALE(t13 - t0, CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; r++) {
    const int64_t *w = ws + r * 8;
    uint8_t *o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = IDCT_LIMIT[(int)DESCALE(w[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; c++) o[c] = v;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    t2 = z1 + z3 * (-FIX_1_847759065);
    t3 = z1 + z2 * FIX_0_765366865;
    t0 = (w[0] + w[4]) * (1 << CONST_BITS);
    t1 = (w[0] - w[4]) * (1 << CONST_BITS);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = w[7];
    t1 = w[5];
    t2 = w[3];
    t3 = w[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * FIX_1_175875602;
    t0 = t0 * FIX_0_298631336;
    t1 = t1 * FIX_2_053119869;
    t2 = t2 * FIX_3_072711026;
    t3 = t3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    o[0] = IDCT_LIMIT[(int)DESCALE(t10 + t3, sh) & 1023];
    o[7] = IDCT_LIMIT[(int)DESCALE(t10 - t3, sh) & 1023];
    o[1] = IDCT_LIMIT[(int)DESCALE(t11 + t2, sh) & 1023];
    o[6] = IDCT_LIMIT[(int)DESCALE(t11 - t2, sh) & 1023];
    o[2] = IDCT_LIMIT[(int)DESCALE(t12 + t1, sh) & 1023];
    o[5] = IDCT_LIMIT[(int)DESCALE(t12 - t1, sh) & 1023];
    o[3] = IDCT_LIMIT[(int)DESCALE(t13 + t0, sh) & 1023];
    o[4] = IDCT_LIMIT[(int)DESCALE(t13 - t0, sh) & 1023];
  }
}

/* ------------------------------------------------------------------------ */
/* Upsampling (jdsample.c) and colour conversion (jdcolor.c)                */
/* ------------------------------------------------------------------------ */

/* Upsample plane p (cw x ch samples used, row stride ps) by (fx, fy) in
 * {1, 2} into dst (W x H, row stride W). */
static void upsample(const uint8_t *p, int64_t ps, int64_t cw, int64_t ch, int fx,
                     int fy, uint8_t *dst, int64_t W, int64_t H) {
  int fancy_h = fx == 2 && cw > 2; /* jinit_upsampler: downsampled_width > 2 */
  for (int64_t y = 0; y < H; y++) {
    uint8_t *o = dst + y * W;
    int64_t iy = y / fy;
    const uint8_t *near = p + iy * ps;
    if (fx == 1 && fy == 1) {
      memcpy(o, near, (size_t)W);
    } else if (fy == 1 || (fx == 2 && !fancy_h)) {
      if (fx == 1) {
        memcpy(o, near, (size_t)W);
      } else if (!fancy_h) { /* h2v1_upsample / h2v2_upsample: replicate */
        for (int64_t x = 0; x < W; x++) o[x] = near[x / 2];
      } else { /* h2v1_fancy_upsample */
        for (int64_t x = 0; x < W; x++) {
          int64_t i = x / 2;
          int v3 = near[i] * 3;
          if (x & 1)
            o[x] = (uint8_t)((v3 + near[i + 1 < cw ? i + 1 : cw - 1] + 2) >> 2);
          else
            o[x] = (uint8_t)((v3 + near[i > 0 ? i - 1 : 0] + 1) >> 2);
        }
      }
    } else {
      /* vertical context: the row above for even output rows, below for odd */
      int64_t jy = (y & 1) ? (iy + 1 < ch ? iy + 1 : ch - 1) : (iy > 0 ? iy - 1 : 0);
      const uint8_t *far = p + jy * ps;
      if (fx == 1) { /* h1v2_fancy_upsample */
        int bias = (y & 1) ? 2 : 1;
        for (int64_t x = 0; x < W; x++)
          o[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
      } else { /* h2v2_fancy_upsample */
        for (int64_t x = 0; x < W; x++) {
          int64_t i = x / 2;
          int ci = near[i] * 3 + far[i];
          if (x & 1) {
            int64_t k = i + 1 < cw ? i + 1 : cw - 1;
            o[x] = (uint8_t)((ci * 3 + near[k] * 3 + far[k] + 7) >> 4);
          } else {
            int64_t k = i > 0 ? i - 1 : 0;
            o[x] = (uint8_t)((ci * 3 + near[k] * 3 + far[k] + 8) >> 4);
          }
        }
      }
    }
  }
}

#define SCALEBITS 16
#define ONE_HALF ((int64_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))

static inline uint8_t clamp255(int64_t v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

/* Dequantise, inverse-transform, upsample and colour-convert the coefficient
 * planes into out: (H, W) grey or (H, W, 3) RGB uint8.
 * comps: ncomp rows of 8 int32: h, v, bw, bh (coefficient plane blocks),
 * coef offset (int16 units), quant table id (0..3), 0, 0.
 * qt: (4, 64) quantisation tables in natural order. Returns 0, or -1 when a
 * sampling ratio is not 1 or 2, -2 when memory runs out. */
int64_t jpeg_output(const int16_t *coefs, const uint16_t *qt, int32_t ncomp,
                    const int32_t *comps, int32_t W, int32_t H, uint8_t *out) {
  static int limit_ready = 0;
  if (!limit_ready) {
    init_limit();
    limit_ready = 1;
  }
  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; c++) {
    if (comps[c * 8] > hmax) hmax = comps[c * 8];
    if (comps[c * 8 + 1] > vmax) vmax = comps[c * 8 + 1];
  }
  uint8_t *full[3] = {NULL, NULL, NULL};
  int64_t npx = (int64_t)W * H;
  int rc = 0;
  for (int c = 0; c < ncomp && !rc; c++) {
    const int32_t *cp = comps + c * 8;
    int h = cp[0], v = cp[1], fx = hmax / h, fy = vmax / v;
    if (hmax % h || vmax % v || fx > 2 || fy > 2) {
      rc = -1;
      break;
    }
    int64_t bw = cp[2], bh = cp[3];
    int64_t ps = bw * 8;
    /* the component's own size: ceil(W * h / hmax) x ceil(H * v / vmax) */
    int64_t cw = ((int64_t)W * h + hmax - 1) / hmax;
    int64_t ch = ((int64_t)H * v + vmax - 1) / vmax;
    int64_t nbx = (cw + 7) / 8, nby = (ch + 7) / 8;
    uint8_t *plane = malloc((size_t)(ps * bh * 8));
    full[c] = malloc((size_t)npx);
    if (!plane || !full[c]) {
      free(plane);
      rc = -2;
      break;
    }
    const uint16_t *q = qt + cp[5] * 64;
    for (int64_t by = 0; by < nby && by < bh; by++)
      for (int64_t bx = 0; bx < nbx && bx < bw; bx++)
        idct_islow(coefs + cp[4] + (by * bw + bx) * 64, q, plane + by * 8 * ps + bx * 8,
                   ps);
    upsample(plane, ps, cw, ch, fx, fy, full[c], W, H);
    free(plane);
  }
  if (!rc) {
    if (ncomp == 1) {
      memcpy(out, full[0], (size_t)npx);
    } else {
      int cr_r[256], cb_b[256];
      int64_t cr_g[256], cb_g[256];
      for (int i = 0, x = -128; i < 256; i++, x++) {
        cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
        cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
        cr_g[i] = (-FIX(0.71414)) * x;
        cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
      }
      for (int64_t i = 0; i < npx; i++) {
        int y = full[0][i], cb = full[1][i], cr = full[2][i];
        out[i * 3 + 0] = clamp255(y + cr_r[cr]);
        out[i * 3 + 1] = clamp255(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
        out[i * 3 + 2] = clamp255(y + cb_b[cb]);
      }
    }
  }
  for (int c = 0; c < 3; c++) free(full[c]);
  return rc;
}
