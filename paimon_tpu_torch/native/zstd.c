/* Zstandard (RFC 8878) for paimon_tpu_torch: a decoder of the whole format
 * except dictionaries, and a simple encoder.
 *
 * Decoder: Zstandard and skippable frames; Raw, RLE and Compressed blocks;
 * Raw, RLE, Compressed and Treeless literals (1 or 4 Huffman streams,
 * weights FSE-compressed or direct); Predefined, RLE, FSE_Compressed and
 * Repeat sequence tables; repeat offsets; matches that reach back across
 * blocks or overlap their own output; the XXH64 content checksum. Every
 * read of the input and every write of the output is bounds-checked: a
 * malformed frame returns a negative error code, never reads or writes
 * outside the buffers it was given.
 *
 * Encoder: greedy LZ77 over a hash table of 4-byte prefixes, raw or RLE
 * literals, sequences under the predefined FSE tables, blocks of at most
 * 128 KiB that fall back to Raw when they would not shrink; the frame
 * carries its content size and no checksum. It has one strength.
 *
 * The interface is plain C for ctypes; every function is reentrant (no
 * global state).
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define ZSTD_MAGIC 0xFD2FB528u
#define SKIPPABLE_MASK 0xFFFFFFF0u
#define SKIPPABLE_MAGIC 0x184D2A50u
#define BLOCK_MAX (128 * 1024)
#define WINDOW_LOG_MAX 27 /* encoder: frames above 2^27 bytes use this window */
#define HUF_MAX_BITS 11
#define LL_MAX_SYM 35
#define ML_MAX_SYM 52
#define OF_MAX_SYM 31

enum {
    E_TRUNCATED = 1,
    E_MAGIC,
    E_HEADER,
    E_DICTIONARY,
    E_BLOCK_TYPE,
    E_BLOCK_SIZE,
    E_LITERALS,
    E_HUFFMAN,
    E_FSE,
    E_SEQUENCES,
    E_OFFSET,
    E_DST_TOO_SMALL,
    E_CONTENT_SIZE,
    E_CHECKSUM,
    E_NO_MEMORY,
    E_EMPTY,
    E_COUNT
};

static const char *const ERROR_TEXT[E_COUNT] = {
    "no error",
    "truncated input",
    "unknown frame magic",
    "malformed frame header",
    "frame needs a dictionary",
    "reserved block type",
    "block larger than 128 KiB",
    "malformed literals section",
    "malformed Huffman table or stream",
    "malformed FSE table",
    "malformed sequences section",
    "match offset reaches before the frame",
    "output larger than the buffer",
    "content size differs from the frame header",
    "content checksum mismatch",
    "out of memory",
    "empty input",
};

#define FAIL(e) return -(int64_t)(e)
#define TRY(x)                   \
    do {                         \
        int64_t r_ = (x);        \
        if (r_ < 0) return r_;   \
    } while (0)

const char *pz_error(int64_t code) {
    int64_t e = -code;
    return (e > 0 && e < E_COUNT) ? ERROR_TEXT[e] : "unknown error";
}

/* ------------------------------------------------------------------------ */
/* little-endian loads                                                       */
/* ------------------------------------------------------------------------ */

static inline uint32_t rd16(const uint8_t *p) { return (uint32_t)p[0] | ((uint32_t)p[1] << 8); }
static inline uint32_t rd24(const uint8_t *p) { return rd16(p) | ((uint32_t)p[2] << 16); }
static inline uint32_t rd32(const uint8_t *p) { return rd16(p) | (rd16(p + 2) << 16); }
static inline uint64_t rd64(const uint8_t *p) { return (uint64_t)rd32(p) | ((uint64_t)rd32(p + 4) << 32); }

static inline uint64_t rd_le(const uint8_t *p, size_t n) {
    uint64_t v = 0;
    for (size_t i = 0; i < n; i++) v |= (uint64_t)p[i] << (8 * i);
    return v;
}

/* eight bytes at `byte`, zeros past `len` */
static inline uint64_t load64_padded(const uint8_t *p, size_t len, size_t byte) {
    if (byte + 8 <= len) return rd64(p + byte);
    return byte < len ? rd_le(p + byte, len - byte) : 0;
}

/* `nb` <= 56 bits at bit offset `bit`, LSB first, zeros past `len` */
static inline uint64_t bits_at(const uint8_t *p, size_t len, size_t bit, int nb) {
    if (nb == 0) return 0;
    return (load64_padded(p, len, bit >> 3) >> (bit & 7)) & ((1ULL << nb) - 1);
}

static inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); } /* v > 0 */

/* ------------------------------------------------------------------------ */
/* XXH64                                                                     */
/* ------------------------------------------------------------------------ */

#define P64_1 0x9E3779B185EBCA87ULL
#define P64_2 0xC2B2AE3D27D4EB4FULL
#define P64_3 0x165667B19E3779F9ULL
#define P64_4 0x85EBCA77C2B2AE63ULL
#define P64_5 0x27D4EB2F165667C5ULL

static inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
static inline uint64_t xxh_round(uint64_t acc, uint64_t in) { return rotl64(acc + in * P64_2, 31) * P64_1; }
static inline uint64_t xxh_merge(uint64_t acc, uint64_t v) { return (acc ^ xxh_round(0, v)) * P64_1 + P64_4; }

static uint64_t xxh64(const uint8_t *p, size_t len, uint64_t seed) {
    const uint8_t *end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = seed + P64_1 + P64_2, v2 = seed + P64_2, v3 = seed, v4 = seed - P64_1;
        do {
            v1 = xxh_round(v1, rd64(p));
            v2 = xxh_round(v2, rd64(p + 8));
            v3 = xxh_round(v3, rd64(p + 16));
            v4 = xxh_round(v4, rd64(p + 24));
            p += 32;
        } while (end - p >= 32);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        h = xxh_merge(h, v1);
        h = xxh_merge(h, v2);
        h = xxh_merge(h, v3);
        h = xxh_merge(h, v4);
    } else {
        h = seed + P64_5;
    }
    h += (uint64_t)len;
    while (end - p >= 8) {
        h ^= xxh_round(0, rd64(p));
        h = rotl64(h, 27) * P64_1 + P64_4;
        p += 8;
    }
    if (end - p >= 4) {
        h ^= (uint64_t)rd32(p) * P64_1;
        h = rotl64(h, 23) * P64_2 + P64_3;
        p += 4;
    }
    while (p < end) {
        h ^= (uint64_t)(*p++) * P64_5;
        h = rotl64(h, 11) * P64_1;
    }
    h ^= h >> 33;
    h *= P64_2;
    h ^= h >> 29;
    h *= P64_3;
    h ^= h >> 32;
    return h;
}

/* ------------------------------------------------------------------------ */
/* sequence code tables (RFC 8878 3.1.1.3.2.1)                               */
/* ------------------------------------------------------------------------ */

static const uint32_t LL_BASE[LL_MAX_SYM + 1] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,   10,  11,  12,  13,   14,   15,   16,   18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[LL_MAX_SYM + 1] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                                                1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[ML_MAX_SYM + 1] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,  34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[ML_MAX_SYM + 1] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                                0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                                2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

/* predefined distributions (RFC 8878 3.1.1.3.2.2) */
static const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                       2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,  1,  1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
#define LL_DEFAULT_LOG 6
#define ML_DEFAULT_LOG 6
#define OF_DEFAULT_LOG 5

/* ------------------------------------------------------------------------ */
/* backward bit stream (FSE and Huffman payloads)                            */
/* ------------------------------------------------------------------------ */

typedef struct {
    const uint8_t *p;
    size_t len;
    int64_t bit; /* bits not yet consumed, counted from the stream's start */
} bitrev;

static int64_t bitrev_init(bitrev *b, const uint8_t *p, size_t len) {
    if (len == 0 || p[len - 1] == 0) FAIL(E_TRUNCATED); /* no padding marker */
    b->p = p;
    b->len = len;
    b->bit = (int64_t)(len - 1) * 8 + highbit32(p[len - 1]);
    return 0;
}

/* the next `nb` <= 56 bits, most recent first; past the stream's start the
 * missing low bits read as zeros and `bit` goes negative */
static inline uint64_t bitrev_read(bitrev *b, int nb) {
    b->bit -= nb;
    if (b->bit >= 0) return bits_at(b->p, b->len, (size_t)b->bit, nb);
    int64_t have = nb + b->bit;
    if (have <= 0) return 0;
    return bits_at(b->p, b->len, 0, (int)have) << (-b->bit);
}

/* ------------------------------------------------------------------------ */
/* FSE decoding tables (RFC 8878 4.1)                                        */
/* ------------------------------------------------------------------------ */

typedef struct {
    uint16_t base;
    uint8_t sym;
    uint8_t nbits;
} fse_cell;

typedef struct {
    int log;
    fse_cell cell[1 << 9];
} fse_table;

static int64_t fse_build(fse_table *t, const int16_t *norm, int nsym, int log) {
    int size = 1 << log, high = size - 1, total = 0;
    uint16_t next[256];
    for (int s = 0; s < nsym; s++) {
        if (norm[s] < -1) FAIL(E_FSE);
        total += norm[s] == -1 ? 1 : norm[s];
    }
    if (total != size) FAIL(E_FSE);
    for (int s = 0; s < nsym; s++) {
        if (norm[s] == -1) {
            t->cell[high--].sym = (uint8_t)s;
            next[s] = 1;
        } else {
            next[s] = (uint16_t)norm[s];
        }
    }
    int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
    for (int s = 0; s < nsym; s++) {
        for (int i = 0; i < norm[s]; i++) {
            t->cell[pos].sym = (uint8_t)s;
            do pos = (pos + step) & mask;
            while (pos > high);
        }
    }
    if (pos != 0) FAIL(E_FSE);
    for (int i = 0; i < size; i++) {
        uint32_t x = next[t->cell[i].sym]++;
        int nb = log - highbit32(x);
        t->cell[i].nbits = (uint8_t)nb;
        t->cell[i].base = (uint16_t)((x << nb) - (uint32_t)size);
    }
    t->log = log;
    return 0;
}

/* an FSE table description (RFC 8878 4.1.1) -> table; *used = its bytes */
static int64_t fse_read(fse_table *t, const uint8_t *src, size_t n, int max_log, int max_sym, size_t *used) {
    if (n == 0) FAIL(E_TRUNCATED);
    int16_t norm[256];
    size_t bit = 4;
    int log = (int)bits_at(src, n, 0, 4) + 5;
    if (log > max_log) FAIL(E_FSE);
    int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, sym = 0, prev0 = 0;
    while (remaining > 1 && sym <= max_sym) {
        if (prev0) {
            for (;;) {
                int rep = (int)bits_at(src, n, bit, 2);
                bit += 2;
                for (int i = 0; i < rep; i++) {
                    if (sym > max_sym) FAIL(E_FSE);
                    norm[sym++] = 0;
                }
                if (rep != 3) break;
                if (bit > n * 8) FAIL(E_TRUNCATED);
            }
            if (sym > max_sym) FAIL(E_FSE);
            prev0 = 0;
        }
        int max = (2 * threshold - 1) - remaining;
        int v = (int)bits_at(src, n, bit, nbits), count;
        if ((v & (threshold - 1)) < max) {
            count = v & (threshold - 1);
            bit += (size_t)nbits - 1;
        } else {
            count = v & (2 * threshold - 1);
            if (count >= threshold) count -= max;
            bit += (size_t)nbits;
        }
        count--; /* -1: a "less than 1" probability */
        remaining -= count < 0 ? -count : count;
        norm[sym++] = (int16_t)count;
        prev0 = count == 0;
        if (remaining < 1) FAIL(E_FSE);
        while (remaining < threshold) {
            nbits--;
            threshold >>= 1;
        }
    }
    if (remaining != 1 || bit > n * 8) FAIL(E_FSE);
    *used = (bit + 7) / 8;
    return fse_build(t, norm, sym, log);
}

static void fse_rle(fse_table *t, uint8_t sym) {
    t->log = 0;
    t->cell[0].sym = sym;
    t->cell[0].nbits = 0;
    t->cell[0].base = 0;
}

static inline void fse_update(const fse_table *t, bitrev *b, uint32_t *state) {
    const fse_cell *c = &t->cell[*state];
    *state = c->base + (uint32_t)bitrev_read(b, c->nbits);
}

/* ------------------------------------------------------------------------ */
/* Huffman literals (RFC 8878 4.2)                                           */
/* ------------------------------------------------------------------------ */

typedef struct {
    int max_bits;
    uint8_t sym[1 << HUF_MAX_BITS];
    uint8_t nbits[1 << HUF_MAX_BITS];
} huf_table;

/* Huffman tree description -> table; *used = its bytes */
static int64_t huf_read(huf_table *h, const uint8_t *src, size_t n, size_t *used) {
    uint8_t w[256];
    int nw = 0;
    if (n == 0) FAIL(E_TRUNCATED);
    int hdr = src[0];
    if (hdr >= 128) { /* direct: 4-bit weights */
        nw = hdr - 127;
        size_t bytes = ((size_t)nw + 1) / 2;
        if (1 + bytes > n) FAIL(E_TRUNCATED);
        for (int i = 0; i < nw; i++) w[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
        *used = 1 + bytes;
    } else { /* FSE-compressed weights, two interleaved states */
        size_t csize = (size_t)hdr, tused;
        if (csize == 0 || 1 + csize > n) FAIL(E_TRUNCATED);
        fse_table t;
        TRY(fse_read(&t, src + 1, csize, 6, 255, &tused));
        if (tused >= csize) FAIL(E_HUFFMAN);
        bitrev b;
        TRY(bitrev_init(&b, src + 1 + tused, csize - tused));
        uint32_t s1 = (uint32_t)bitrev_read(&b, t.log), s2 = (uint32_t)bitrev_read(&b, t.log);
        for (;;) {
            if (nw >= 255) FAIL(E_HUFFMAN);
            w[nw++] = t.cell[s1].sym;
            fse_update(&t, &b, &s1);
            if (b.bit < 0) {
                if (nw >= 255) FAIL(E_HUFFMAN);
                w[nw++] = t.cell[s2].sym;
                break;
            }
            if (nw >= 255) FAIL(E_HUFFMAN);
            w[nw++] = t.cell[s2].sym;
            fse_update(&t, &b, &s2);
            if (b.bit < 0) {
                if (nw >= 255) FAIL(E_HUFFMAN);
                w[nw++] = t.cell[s1].sym;
                break;
            }
        }
        *used = 1 + csize;
    }
    uint32_t sum = 0;
    for (int i = 0; i < nw; i++) {
        if (w[i] > HUF_MAX_BITS) FAIL(E_HUFFMAN);
        if (w[i]) sum += 1u << (w[i] - 1);
    }
    if (sum == 0) FAIL(E_HUFFMAN);
    int max_bits = highbit32(sum) + 1;
    if (max_bits > HUF_MAX_BITS) FAIL(E_HUFFMAN);
    uint32_t left = (1u << max_bits) - sum;
    if (left & (left - 1)) FAIL(E_HUFFMAN); /* the implied last weight must complete the tree */
    w[nw] = (uint8_t)(highbit32(left) + 1);
    int nsym = nw + 1;
    int rank_count[HUF_MAX_BITS + 2] = {0};
    uint8_t bits[256];
    for (int i = 0; i < nsym; i++) {
        bits[i] = w[i] ? (uint8_t)(max_bits + 1 - w[i]) : 0;
        rank_count[bits[i]]++;
    }
    if (rank_count[max_bits] < 2 || (rank_count[max_bits] & 1)) FAIL(E_HUFFMAN);
    uint32_t rank_idx[HUF_MAX_BITS + 2];
    rank_idx[max_bits] = 0;
    for (int nb = max_bits; nb >= 1; nb--) {
        rank_idx[nb - 1] = rank_idx[nb] + (uint32_t)rank_count[nb] * (1u << (max_bits - nb));
        memset(h->nbits + rank_idx[nb], nb, rank_idx[nb - 1] - rank_idx[nb]);
    }
    if (rank_idx[0] != (1u << max_bits)) FAIL(E_HUFFMAN);
    for (int i = 0; i < nsym; i++) {
        if (!bits[i]) continue;
        uint32_t len = 1u << (max_bits - bits[i]);
        memset(h->sym + rank_idx[bits[i]], i, len);
        rank_idx[bits[i]] += len;
    }
    h->max_bits = max_bits;
    return 0;
}

/* one Huffman stream -> exactly `count` symbols, consuming it exactly */
static int64_t huf_stream(const huf_table *h, const uint8_t *src, size_t n, uint8_t *out, size_t count) {
    bitrev b;
    TRY(bitrev_init(&b, src, n));
    const int mb = h->max_bits;
    const uint32_t mask = (1u << mb) - 1;
    uint32_t state = (uint32_t)bitrev_read(&b, mb);
    for (size_t i = 0; i < count; i++) {
        int nb = h->nbits[state];
        out[i] = h->sym[state];
        state = ((state << nb) | (uint32_t)bitrev_read(&b, nb)) & mask;
    }
    if (b.bit != -mb) FAIL(E_HUFFMAN);
    return 0;
}

/* ------------------------------------------------------------------------ */
/* frame decoding                                                            */
/* ------------------------------------------------------------------------ */

typedef struct {
    fse_table ll, of, ml;
    int have_ll, have_of, have_ml, have_huf;
    huf_table huf;
    uint32_t rep[3];
    uint8_t lit[BLOCK_MAX];
} dctx;

typedef struct {
    size_t header_size;
    uint64_t content_size;
    int has_size, checksum;
} frame_header;

static int64_t parse_frame_header(const uint8_t *src, size_t n, frame_header *h) {
    if (n < 5) FAIL(E_TRUNCATED);
    if (rd32(src) != ZSTD_MAGIC) FAIL(E_MAGIC);
    int fhd = src[4], fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, did_flag = fhd & 3;
    if (fhd & 8) FAIL(E_HEADER); /* reserved bit */
    size_t p = 5 + (single ? 0 : 1);
    static const size_t did_bytes[4] = {0, 1, 2, 4};
    size_t fcs_bytes = fcs_flag == 0 ? (size_t)single : (size_t)1 << fcs_flag;
    if (p + did_bytes[did_flag] + fcs_bytes > n) FAIL(E_TRUNCATED);
    if (rd_le(src + p, did_bytes[did_flag]) != 0) FAIL(E_DICTIONARY);
    p += did_bytes[did_flag];
    h->has_size = fcs_bytes != 0;
    h->content_size = rd_le(src + p, fcs_bytes) + (fcs_bytes == 2 ? 256 : 0);
    h->checksum = (fhd >> 2) & 1;
    h->header_size = p + fcs_bytes;
    return 0;
}

static int64_t decode_literals(dctx *c, const uint8_t *src, size_t n, size_t *used, const uint8_t **lit,
                               size_t *lit_size) {
    if (n == 0) FAIL(E_TRUNCATED);
    int type = src[0] & 3, sf = (src[0] >> 2) & 3;
    if (type <= 1) { /* Raw or RLE */
        size_t hs, size;
        if ((sf & 1) == 0) {
            hs = 1;
            size = src[0] >> 3;
        } else if (sf == 1) {
            hs = 2;
            if (n < hs) FAIL(E_TRUNCATED);
            size = rd16(src) >> 4;
        } else {
            hs = 3;
            if (n < hs) FAIL(E_TRUNCATED);
            size = rd24(src) >> 4;
        }
        if (size > BLOCK_MAX) FAIL(E_LITERALS);
        if (type == 0) {
            if (hs + size > n) FAIL(E_TRUNCATED);
            *lit = src + hs;
            *used = hs + size;
        } else {
            if (hs + 1 > n) FAIL(E_TRUNCATED);
            memset(c->lit, src[hs], size);
            *lit = c->lit;
            *used = hs + 1;
        }
        *lit_size = size;
        return 0;
    }
    /* Compressed or Treeless */
    size_t hs = sf <= 1 ? 3 : (size_t)sf + 2, regen, csize;
    if (n < hs) FAIL(E_TRUNCATED);
    uint64_t hv = rd_le(src, hs);
    int streams = sf == 0 ? 1 : 4;
    if (hs == 3) {
        regen = (hv >> 4) & 0x3FF;
        csize = (hv >> 14) & 0x3FF;
    } else if (hs == 4) {
        regen = (hv >> 4) & 0x3FFF;
        csize = (hv >> 18) & 0x3FFF;
    } else {
        regen = (hv >> 4) & 0x3FFFF;
        csize = (hv >> 22) & 0x3FFFF;
    }
    if (regen > BLOCK_MAX) FAIL(E_LITERALS);
    if (hs + csize > n) FAIL(E_TRUNCATED);
    const uint8_t *p = src + hs;
    size_t plen = csize;
    if (type == 2) {
        size_t tused;
        c->have_huf = 0;
        TRY(huf_read(&c->huf, p, plen, &tused));
        c->have_huf = 1;
        p += tused;
        plen -= tused;
    } else if (!c->have_huf) {
        FAIL(E_HUFFMAN); /* Treeless with no earlier table */
    }
    if (streams == 1) {
        TRY(huf_stream(&c->huf, p, plen, c->lit, regen));
    } else {
        if (plen < 6) FAIL(E_TRUNCATED);
        size_t s1 = rd16(p), s2 = rd16(p + 2), s3 = rd16(p + 4);
        if (6 + s1 + s2 + s3 > plen) FAIL(E_LITERALS);
        size_t s4 = plen - 6 - s1 - s2 - s3, seg = (regen + 3) / 4;
        if (3 * seg > regen) FAIL(E_LITERALS);
        const uint8_t *q = p + 6;
        TRY(huf_stream(&c->huf, q, s1, c->lit, seg));
        TRY(huf_stream(&c->huf, q + s1, s2, c->lit + seg, seg));
        TRY(huf_stream(&c->huf, q + s1 + s2, s3, c->lit + 2 * seg, seg));
        TRY(huf_stream(&c->huf, q + s1 + s2 + s3, s4, c->lit + 3 * seg, regen - 3 * seg));
    }
    *lit = c->lit;
    *lit_size = regen;
    *used = hs + csize;
    return 0;
}

/* one of the LL/OF/ML tables by its compression mode; *used = its bytes */
static int64_t seq_table(fse_table *t, int *have, int mode, const int16_t *def, int def_n, int def_log,
                         int max_log, int max_sym, const uint8_t *src, size_t n, size_t *used) {
    *used = 0;
    switch (mode) {
    case 0: /* Predefined */
        *have = 0;
        TRY(fse_build(t, def, def_n, def_log));
        break;
    case 1: /* RLE */
        if (n < 1) FAIL(E_TRUNCATED);
        if (src[0] > max_sym) FAIL(E_SEQUENCES);
        fse_rle(t, src[0]);
        *used = 1;
        break;
    case 2: /* FSE_Compressed */
        *have = 0;
        TRY(fse_read(t, src, n, max_log, max_sym, used));
        break;
    default: /* Repeat */
        if (!*have) FAIL(E_SEQUENCES);
        return 0;
    }
    *have = 1;
    return 0;
}

/* copy `n` bytes from `off` back; an overlapping match repeats its period */
static inline void copy_match(uint8_t *d, size_t off, size_t n) {
    const uint8_t *s = d - off;
    if (off >= n) {
        memcpy(d, s, n);
    } else if (off == 1) {
        memset(d, s[0], n);
    } else {
        for (size_t k = 0; k < n; k++) d[k] = s[k];
    }
}

static int64_t decode_sequences(dctx *c, const uint8_t *src, size_t n, const uint8_t *lit, size_t lit_size,
                                uint8_t *dst, size_t cap, size_t *pos, size_t frame_start) {
    if (n == 0) FAIL(E_TRUNCATED);
    size_t nseq, hs;
    int b0 = src[0];
    if (b0 == 0) {
        if (n != 1) FAIL(E_SEQUENCES);
        nseq = 0;
    } else {
        if (b0 < 128) {
            nseq = (size_t)b0;
            hs = 1;
        } else if (b0 < 255) {
            if (n < 2) FAIL(E_TRUNCATED);
            nseq = ((size_t)(b0 - 128) << 8) + src[1];
            hs = 2;
        } else {
            if (n < 3) FAIL(E_TRUNCATED);
            nseq = rd16(src + 1) + 0x7F00;
            hs = 3;
        }
        if (hs >= n) FAIL(E_TRUNCATED);
        int modes = src[hs++];
        if (modes & 3) FAIL(E_SEQUENCES);
        const uint8_t *p = src + hs;
        size_t rem = n - hs, used;
        TRY(seq_table(&c->ll, &c->have_ll, modes >> 6, LL_DEFAULT, 36, LL_DEFAULT_LOG, 9, LL_MAX_SYM, p, rem, &used));
        p += used, rem -= used;
        TRY(seq_table(&c->of, &c->have_of, (modes >> 4) & 3, OF_DEFAULT, 29, OF_DEFAULT_LOG, 8, OF_MAX_SYM, p, rem,
                      &used));
        p += used, rem -= used;
        TRY(seq_table(&c->ml, &c->have_ml, (modes >> 2) & 3, ML_DEFAULT, 53, ML_DEFAULT_LOG, 9, ML_MAX_SYM, p, rem,
                      &used));
        p += used, rem -= used;
        bitrev b;
        TRY(bitrev_init(&b, p, rem));
        uint32_t sll = (uint32_t)bitrev_read(&b, c->ll.log);
        uint32_t sof = (uint32_t)bitrev_read(&b, c->of.log);
        uint32_t sml = (uint32_t)bitrev_read(&b, c->ml.log);
        size_t lp = 0;
        uint32_t *rep = c->rep;
        for (size_t i = 0; i < nseq; i++) {
            int llc = c->ll.cell[sll].sym, ofc = c->of.cell[sof].sym, mlc = c->ml.cell[sml].sym;
            uint32_t ofv = (1u << ofc) + (uint32_t)bitrev_read(&b, ofc);
            size_t ml = ML_BASE[mlc] + (size_t)bitrev_read(&b, ML_BITS[mlc]);
            size_t ll = LL_BASE[llc] + (size_t)bitrev_read(&b, LL_BITS[llc]);
            size_t off;
            if (ofv > 3) {
                off = ofv - 3;
                rep[2] = rep[1];
                rep[1] = rep[0];
                rep[0] = (uint32_t)off;
            } else {
                uint32_t idx = ofv - 1 + (ll == 0); /* 0..3; 3 = rep[0] - 1 */
                if (idx == 0) {
                    off = rep[0];
                } else {
                    off = idx == 3 ? (size_t)rep[0] - 1 : rep[idx];
                    if (off == 0) FAIL(E_OFFSET);
                    if (idx != 1) rep[2] = rep[1];
                    rep[1] = rep[0];
                    rep[0] = (uint32_t)off;
                }
            }
            if (i + 1 < nseq) { /* state updates: LL, ML, OF */
                fse_update(&c->ll, &b, &sll);
                fse_update(&c->ml, &b, &sml);
                fse_update(&c->of, &b, &sof);
            }
            if (ll > lit_size - lp) FAIL(E_LITERALS);
            if (ll + ml > cap - *pos) FAIL(E_DST_TOO_SMALL);
            memcpy(dst + *pos, lit + lp, ll);
            *pos += ll;
            lp += ll;
            if (off > *pos - frame_start) FAIL(E_OFFSET);
            copy_match(dst + *pos, off, ml);
            *pos += ml;
        }
        if (b.bit > 0) FAIL(E_SEQUENCES); /* stream not consumed */
        lit += lp;
        lit_size -= lp;
    }
    if (lit_size > cap - *pos) FAIL(E_DST_TOO_SMALL);
    memcpy(dst + *pos, lit, lit_size);
    *pos += lit_size;
    return 0;
}

static int64_t decode_frame(dctx *c, const uint8_t *src, size_t n, uint8_t *dst, size_t cap, size_t *pos,
                            size_t *used) {
    frame_header h;
    TRY(parse_frame_header(src, n, &h));
    c->have_ll = c->have_of = c->have_ml = c->have_huf = 0;
    c->rep[0] = 1, c->rep[1] = 4, c->rep[2] = 8;
    size_t p = h.header_size, start = *pos;
    for (;;) {
        if (p + 3 > n) FAIL(E_TRUNCATED);
        uint32_t bh = rd24(src + p);
        p += 3;
        int last = bh & 1, type = (bh >> 1) & 3;
        size_t bs = bh >> 3;
        if (bs > BLOCK_MAX) FAIL(E_BLOCK_SIZE);
        if (type == 0) { /* Raw */
            if (bs > n - p) FAIL(E_TRUNCATED);
            if (bs > cap - *pos) FAIL(E_DST_TOO_SMALL);
            memcpy(dst + *pos, src + p, bs);
            *pos += bs;
            p += bs;
        } else if (type == 1) { /* RLE */
            if (p >= n) FAIL(E_TRUNCATED);
            if (bs > cap - *pos) FAIL(E_DST_TOO_SMALL);
            memset(dst + *pos, src[p], bs);
            *pos += bs;
            p += 1;
        } else if (type == 2) { /* Compressed */
            if (bs > n - p) FAIL(E_TRUNCATED);
            if (bs >= BLOCK_MAX) FAIL(E_BLOCK_SIZE);
            const uint8_t *lit;
            size_t lit_size, lused, block_start = *pos;
            TRY(decode_literals(c, src + p, bs, &lused, &lit, &lit_size));
            TRY(decode_sequences(c, src + p + lused, bs - lused, lit, lit_size, dst, cap, pos, start));
            if (*pos - block_start > BLOCK_MAX) FAIL(E_BLOCK_SIZE);
            p += bs;
        } else {
            FAIL(E_BLOCK_TYPE);
        }
        if (last) break;
    }
    if (h.has_size && *pos - start != h.content_size) FAIL(E_CONTENT_SIZE);
    if (h.checksum) {
        if (p + 4 > n) FAIL(E_TRUNCATED);
        if ((uint32_t)xxh64(dst + start, *pos - start, 0) != rd32(src + p)) FAIL(E_CHECKSUM);
        p += 4;
    }
    *used = p;
    return 0;
}

/* bytes of a skippable frame at src, or 0 when src holds no skippable magic */
static int64_t skippable_size(const uint8_t *src, size_t n) {
    if (n < 4 || (rd32(src) & SKIPPABLE_MASK) != SKIPPABLE_MAGIC) return 0;
    if (n < 8) FAIL(E_TRUNCATED);
    uint64_t size = rd32(src + 4);
    if (size > n - 8) FAIL(E_TRUNCATED);
    return (int64_t)(8 + size);
}

/* Walk the frames' headers and block headers without decoding. Returns an
 * upper bound of the decompressed size, or an error; *declared = the sum of
 * the frames' content sizes when every frame declares one, else -1. */
int64_t pz_frame_bound(const uint8_t *src, size_t n, int64_t *declared) {
    uint64_t bound = 0, total = 0;
    int all = 1;
    size_t p = 0;
    if (n == 0) FAIL(E_EMPTY);
    while (p < n) {
        int64_t skip = skippable_size(src + p, n - p);
        TRY(skip);
        if (skip) {
            p += (size_t)skip;
            continue;
        }
        frame_header h;
        TRY(parse_frame_header(src + p, n - p, &h));
        size_t q = p + h.header_size;
        uint64_t fbound = 0;
        for (;;) {
            if (q + 3 > n) FAIL(E_TRUNCATED);
            uint32_t bh = rd24(src + q);
            q += 3;
            int type = (bh >> 1) & 3;
            size_t bs = bh >> 3;
            if (bs > BLOCK_MAX) FAIL(E_BLOCK_SIZE);
            if (type == 3) FAIL(E_BLOCK_TYPE);
            size_t body = type == 1 ? 1 : bs;
            if (body > n - q) FAIL(E_TRUNCATED);
            q += body;
            fbound += type == 2 ? BLOCK_MAX : bs;
            if (bh & 1) break;
        }
        if (h.checksum) {
            if (q + 4 > n) FAIL(E_TRUNCATED);
            q += 4;
        }
        if (h.has_size) {
            if (h.content_size > fbound) FAIL(E_CONTENT_SIZE);
            total += h.content_size;
        } else {
            all = 0;
        }
        bound += fbound;
        p = q;
    }
    *declared = all ? (int64_t)total : -1;
    return (int64_t)bound;
}

/* Decode every frame of src into dst; returns the bytes written or an error
 * (E_DST_TOO_SMALL when dst cannot hold the output). */
int64_t pz_decompress(uint8_t *dst, size_t cap, const uint8_t *src, size_t n) {
    if (n == 0) FAIL(E_EMPTY);
    dctx *c = (dctx *)malloc(sizeof(dctx));
    if (c == NULL) FAIL(E_NO_MEMORY);
    size_t p = 0, pos = 0;
    int64_t r = 0;
    while (p < n && r >= 0) {
        r = skippable_size(src + p, n - p);
        if (r > 0) {
            p += (size_t)r;
        } else if (r == 0) {
            size_t used = 0;
            r = decode_frame(c, src + p, n - p, dst, cap, &pos, &used);
            p += used;
        }
    }
    free(c);
    return r < 0 ? r : (int64_t)pos;
}

/* ------------------------------------------------------------------------ */
/* encoder                                                                   */
/* ------------------------------------------------------------------------ */

typedef struct {
    int log;
    uint16_t state[1 << 6];
    struct {
        int32_t find;
        uint32_t nbits;
    } tt[64];
} fse_ctable;

static void fse_build_ctable(fse_ctable *ct, const int16_t *norm, int nsym, int log) {
    int size = 1 << log, high = size - 1, mask = size - 1, step = (size >> 1) + (size >> 3) + 3, pos = 0;
    uint8_t table_sym[1 << 6];
    uint32_t cumul[65];
    cumul[0] = 0;
    for (int s = 0; s < nsym; s++) {
        if (norm[s] == -1) {
            cumul[s + 1] = cumul[s] + 1;
            table_sym[high--] = (uint8_t)s;
        } else {
            cumul[s + 1] = cumul[s] + (uint32_t)norm[s];
        }
    }
    for (int s = 0; s < nsym; s++) {
        for (int i = 0; i < norm[s]; i++) {
            table_sym[pos] = (uint8_t)s;
            do pos = (pos + step) & mask;
            while (pos > high);
        }
    }
    for (int u = 0; u < size; u++) ct->state[cumul[table_sym[u]]++] = (uint16_t)(size + u);
    int total = 0;
    for (int s = 0; s < nsym; s++) {
        if (norm[s] == -1 || norm[s] == 1) {
            ct->tt[s].nbits = ((uint32_t)log << 16) - (uint32_t)size;
            ct->tt[s].find = total - 1;
            total++;
        } else {
            int max_out = log - highbit32((uint32_t)norm[s] - 1);
            ct->tt[s].nbits = ((uint32_t)max_out << 16) - ((uint32_t)norm[s] << max_out);
            ct->tt[s].find = total - norm[s];
            total += norm[s];
        }
    }
    ct->log = log;
}

typedef struct {
    uint8_t *out;
    size_t cap, pos;
    uint64_t acc;
    int n, overflow;
} bitwriter;

static inline void bw_add(bitwriter *w, uint64_t v, int nb) { /* nb <= 32 */
    w->acc |= (v & ((1ULL << nb) - 1)) << w->n;
    w->n += nb;
    while (w->n >= 8) {
        if (w->pos < w->cap)
            w->out[w->pos++] = (uint8_t)w->acc;
        else
            w->overflow = 1;
        w->acc >>= 8;
        w->n -= 8;
    }
}

static inline void bw_close(bitwriter *w) { /* the padding marker, then the last partial byte */
    bw_add(w, 1, 1);
    if (w->n > 0) bw_add(w, 0, 8 - w->n);
}

static inline uint32_t cs_init(const fse_ctable *ct, int sym) {
    uint32_t nb = (ct->tt[sym].nbits + (1 << 15)) >> 16;
    uint32_t v = (nb << 16) - ct->tt[sym].nbits;
    return ct->state[(int32_t)(v >> nb) + ct->tt[sym].find];
}

static inline void cs_encode(bitwriter *w, const fse_ctable *ct, uint32_t *state, int sym) {
    uint32_t nb = (*state + ct->tt[sym].nbits) >> 16;
    bw_add(w, *state, (int)nb);
    *state = ct->state[(int32_t)(*state >> nb) + ct->tt[sym].find];
}

static inline int ll_code(uint32_t ll) {
    if (ll < 16) return (int)ll;
    if (ll >= 64) return highbit32(ll) + 19;
    int c = 16;
    while (c < 25 && LL_BASE[c + 1] <= ll) c++;
    return c;
}

static inline int ml_code(uint32_t ml) { /* ml >= 3 */
    uint32_t b = ml - 3;
    if (b < 32) return (int)b;
    if (b >= 128) return highbit32(b) + 36;
    int c = 32;
    while (c < 43 && ML_BASE[c + 1] <= ml) c++;
    return c;
}

typedef struct {
    uint32_t ll, ml, ofv;
} sequence;

typedef struct {
    fse_ctable ll, of, ml;
    size_t *table; /* hash of 4 bytes -> position + 1 */
    int hlog;
    uint32_t rep[3];
    sequence *seqs;
    uint8_t *lits;
} ectx;

static inline uint32_t hash4(uint32_t v, int hlog) { return (v * 2654435761u) >> (32 - hlog); }

static inline size_t match_length(const uint8_t *a, const uint8_t *b, const uint8_t *end) {
    const uint8_t *start = b;
    while (b + 8 <= end) {
        uint64_t x = rd64(a) ^ rd64(b);
        if (x) return (size_t)(b - start) + (size_t)(__builtin_ctzll(x) >> 3);
        a += 8, b += 8;
    }
    while (b < end && *a == *b) a++, b++;
    return (size_t)(b - start);
}

/* the body of a Compressed block for src[start, end), or 0 when it would not
 * be smaller than the raw bytes */
static size_t compress_block(ectx *e, const uint8_t *src, size_t start, size_t end, uint8_t *out) {
    size_t bs = end - start, nseq = 0, nlit = 0, anchor = start, p = start;
    uint32_t rep[3] = {e->rep[0], e->rep[1], e->rep[2]};
    const size_t max_dist = (size_t)1 << WINDOW_LOG_MAX;
    while (p + 4 <= end) {
        uint32_t v = rd32(src + p), h = hash4(v, e->hlog);
        size_t cand = e->table[h];
        e->table[h] = p + 1;
        if (cand && p + 1 - cand <= max_dist && rd32(src + cand - 1) == v) {
            cand -= 1;
            size_t len = 4 + match_length(src + cand + 4, src + p + 4, src + end);
            while (p > anchor && cand > 0 && src[p - 1] == src[cand - 1]) p--, cand--, len++;
            uint32_t ll = (uint32_t)(p - anchor), off = (uint32_t)(p - cand), ofv;
            if (ll > 0 && off == rep[0]) {
                ofv = 1;
            } else {
                ofv = off + 3;
                rep[2] = rep[1];
                rep[1] = rep[0];
                rep[0] = off;
            }
            memcpy(e->lits + nlit, src + anchor, ll);
            nlit += ll;
            e->seqs[nseq].ll = ll;
            e->seqs[nseq].ml = (uint32_t)len;
            e->seqs[nseq].ofv = ofv;
            nseq++;
            p += len;
            anchor = p;
            if (p - 2 + 4 <= end) e->table[hash4(rd32(src + p - 2), e->hlog)] = p - 2 + 1;
            continue;
        }
        p += 1 + ((p - anchor) >> 6); /* step faster through data that does not match */
    }
    memcpy(e->lits + nlit, src + anchor, end - anchor);
    nlit += end - anchor;

    /* literals section: RLE when every literal is the same byte, else Raw */
    size_t o = 0;
    int rle = nlit > 1;
    for (size_t i = 1; rle && i < nlit; i++) rle = e->lits[i] == e->lits[0];
    int type = rle ? 1 : 0;
    if (nlit < 32) {
        out[o++] = (uint8_t)((nlit << 3) | (size_t)type);
    } else if (nlit < 4096) {
        out[o++] = (uint8_t)((nlit << 4) | (1 << 2) | (size_t)type);
        out[o++] = (uint8_t)(nlit >> 4);
    } else {
        out[o++] = (uint8_t)((nlit << 4) | (3 << 2) | (size_t)type);
        out[o++] = (uint8_t)(nlit >> 4);
        out[o++] = (uint8_t)(nlit >> 12);
    }
    if (rle) {
        out[o++] = e->lits[0];
    } else {
        if (o + nlit + 4 >= bs) return 0;
        memcpy(out + o, e->lits, nlit);
        o += nlit;
    }
    /* sequences section: predefined tables for all three codes */
    if (nseq < 128) {
        out[o++] = (uint8_t)nseq;
    } else if (nseq < 0x7F00) {
        out[o++] = (uint8_t)((nseq >> 8) + 128);
        out[o++] = (uint8_t)nseq;
    } else {
        out[o++] = 255;
        out[o++] = (uint8_t)(nseq - 0x7F00);
        out[o++] = (uint8_t)((nseq - 0x7F00) >> 8);
    }
    if (nseq > 0) {
        out[o++] = 0;
        if (o >= bs) return 0;
        bitwriter w = {out + o, bs - o, 0, 0, 0, 0};
        const sequence *s = &e->seqs[nseq - 1];
        int llc = ll_code(s->ll), mlc = ml_code(s->ml), ofc = highbit32(s->ofv);
        uint32_t sml = cs_init(&e->ml, mlc), sof = cs_init(&e->of, ofc), sll = cs_init(&e->ll, llc);
        bw_add(&w, s->ll - LL_BASE[llc], LL_BITS[llc]);
        bw_add(&w, s->ml - ML_BASE[mlc], ML_BITS[mlc]);
        bw_add(&w, s->ofv - (1u << ofc), ofc);
        for (size_t i = nseq - 1; i-- > 0 && !w.overflow;) {
            s = &e->seqs[i];
            llc = ll_code(s->ll), mlc = ml_code(s->ml), ofc = highbit32(s->ofv);
            cs_encode(&w, &e->of, &sof, ofc);
            cs_encode(&w, &e->ml, &sml, mlc);
            cs_encode(&w, &e->ll, &sll, llc);
            bw_add(&w, s->ll - LL_BASE[llc], LL_BITS[llc]);
            bw_add(&w, s->ml - ML_BASE[mlc], ML_BITS[mlc]);
            bw_add(&w, s->ofv - (1u << ofc), ofc);
        }
        bw_add(&w, sml, e->ml.log);
        bw_add(&w, sof, e->of.log);
        bw_add(&w, sll, e->ll.log);
        bw_close(&w);
        if (w.overflow) return 0;
        o += w.pos;
    }
    if (o >= bs) return 0;
    memcpy(e->rep, rep, sizeof rep);
    return o;
}

int64_t pz_compress_bound(size_t n) { return (int64_t)(18 + n + 3 * (n / BLOCK_MAX + 1)); }

/* One frame of src into dst (cap >= pz_compress_bound(n)); returns its size
 * or an error. */
int64_t pz_compress(uint8_t *dst, size_t cap, const uint8_t *src, size_t n) {
    if (cap < (size_t)pz_compress_bound(n)) FAIL(E_DST_TOO_SMALL);
    ectx e;
    e.hlog = 10;
    while (e.hlog < 17 && ((size_t)1 << e.hlog) < n) e.hlog++;
    e.table = (size_t *)calloc((size_t)1 << e.hlog, sizeof(size_t));
    e.seqs = (sequence *)malloc((BLOCK_MAX / 4 + 2) * sizeof(sequence));
    e.lits = (uint8_t *)malloc(BLOCK_MAX);
    if (!e.table || !e.seqs || !e.lits) {
        free(e.table), free(e.seqs), free(e.lits);
        FAIL(E_NO_MEMORY);
    }
    fse_build_ctable(&e.ll, LL_DEFAULT, 36, LL_DEFAULT_LOG);
    fse_build_ctable(&e.of, OF_DEFAULT, 29, OF_DEFAULT_LOG);
    fse_build_ctable(&e.ml, ML_DEFAULT, 53, ML_DEFAULT_LOG);
    e.rep[0] = 1, e.rep[1] = 4, e.rep[2] = 8;

    size_t o = 0;
    int single = n <= ((size_t)1 << WINDOW_LOG_MAX);
    int fcs_flag = n < 256 ? 0 : n < 65536 + 256 ? 1 : n <= 0xFFFFFFFFu ? 2 : 3;
    size_t fcs_bytes = fcs_flag == 0 ? 1 : (size_t)1 << fcs_flag;
    uint64_t fcs = fcs_flag == 1 ? n - 256 : n;
    dst[o++] = 0x28, dst[o++] = 0xB5, dst[o++] = 0x2F, dst[o++] = 0xFD;
    dst[o++] = (uint8_t)((fcs_flag << 6) | (single << 5));
    if (!single) dst[o++] = (uint8_t)((WINDOW_LOG_MAX - 10) << 3);
    for (size_t i = 0; i < fcs_bytes; i++) dst[o++] = (uint8_t)(fcs >> (8 * i));

    size_t start = 0;
    do {
        size_t end = n - start > BLOCK_MAX ? start + BLOCK_MAX : n, bs = end - start;
        uint32_t last = end == n;
        size_t body = bs >= 16 ? compress_block(&e, src, start, end, dst + o + 3) : 0;
        uint32_t bh = body ? last | (2u << 1) | (uint32_t)(body << 3) : last | (uint32_t)(bs << 3);
        dst[o] = (uint8_t)bh, dst[o + 1] = (uint8_t)(bh >> 8), dst[o + 2] = (uint8_t)(bh >> 16);
        o += 3;
        if (body) {
            o += body;
        } else {
            memcpy(dst + o, src + start, bs);
            o += bs;
        }
        start = end;
    } while (start < n);
    free(e.table), free(e.seqs), free(e.lits);
    return (int64_t)o;
}
