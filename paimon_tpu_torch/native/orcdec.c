/* ORC's run-length codes, both directions (the streams of format/orc.py).
 *
 * Integer RLE v2 (ORC 0.12, DIRECT_V2 and DICTIONARY_V2 columns): runs of
 * up to 512 values, each led by a header whose top two bits name one of
 * four sub-encodings:
 *   SHORT_REPEAT  one byte: value width in bytes less 1 (3 bits), repeat
 *                 count less 3 (3 bits); then the value, big-endian
 *   DIRECT        two bytes: width code (5 bits), length less 1 (9 bits);
 *                 then the values bit-packed at that width, MSB first
 *   PATCHED_BASE  four bytes: width code, length less 1, base width in
 *                 bytes less 1 (3 bits), patch width code (5 bits), patch
 *                 gap width less 1 (3 bits), patch count (5 bits); then the
 *                 base (big-endian, sign in its top bit), the values less
 *                 the base, and the patch list of (gap, high bits) entries;
 *                 a gap of 255 with a zero patch only moves the position on
 *   DELTA         two bytes: width code (0: every delta is the same),
 *                 length less 1; then the first value and the first delta
 *                 as varints, and the magnitudes of the other deltas packed,
 *                 their sign that of the first delta
 * A width code maps 0..23 to 1..24 bits, then 26, 28, 30, 32, 40, 48, 56
 * and 64. Signed columns zigzag the values of SHORT_REPEAT and DIRECT and
 * the first value of DELTA.
 * Integer RLE v1 (DIRECT and DICTIONARY columns): a control byte 0..127 is
 * a run of control + 3 values from a varint base with a signed byte step;
 * -1..-128 are that many varints.
 * Byte RLE: a control byte 0..127 repeats the next byte control + 3 times;
 * -1..-128 are that many bytes. Booleans are byte RLE over bytes packed
 * eight values each, most significant bit first.
 * DECIMAL values are zigzag base-128 varints without a length bound; here
 * they must fit 64 bits (precision 18 at most).
 *
 * The encoder writes RLE v2 with SHORT_REPEAT for repeats of 3 to 10,
 * DELTA for longer repeats and monotone runs, and DIRECT otherwise; it
 * writes no PATCHED_BASE, which every reader takes as optional.
 *
 * Built at first use with `cc -O3 -shared -fPIC` and loaded via ctypes
 * (paimon_tpu_torch/native/__init__.py), which releases the GIL during each
 * call. A decoder returns the values it decoded; errors are negative:
 *   -1 malformed or truncated stream   -2 destination too small
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define PO_E_MALFORMED (-1)
#define PO_E_DST_TOO_SMALL (-2)
#define RUN_MAX 512

static const int WIDTHS[32] = {1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                               17, 18, 19, 20, 21, 22, 23, 24, 26, 28, 30, 32, 40, 48, 56, 64};

static int closest_fixed_bits(int n) {
    if (n <= 1) return 1;
    if (n <= 24) return n;
    if (n <= 26) return 26;
    if (n <= 28) return 28;
    if (n <= 30) return 30;
    if (n <= 32) return 32;
    if (n <= 40) return 40;
    if (n <= 48) return 48;
    if (n <= 56) return 56;
    return 64;
}

static int width_code(int width) {
    for (int c = 0; c < 32; c++)
        if (WIDTHS[c] == width) return c;
    return 31;
}

static inline int64_t unzigzag(uint64_t v) { return (int64_t)(v >> 1) ^ -(int64_t)(v & 1); }
static inline uint64_t zigzag(int64_t v) { return ((uint64_t)v << 1) ^ (uint64_t)(v >> 63); }

typedef struct {
    const uint8_t *src;
    size_t n, pos;
} reader;

static int read_byte(reader *r, uint8_t *b) {
    if (r->pos >= r->n) return PO_E_MALFORMED;
    *b = r->src[r->pos++];
    return 0;
}

static int read_uvarint(reader *r, uint64_t *out) {
    uint64_t v = 0;
    for (int shift = 0; shift < 64; shift += 7) {
        uint8_t b;
        if (read_byte(r, &b)) return PO_E_MALFORMED;
        v |= (uint64_t)(b & 0x7f) << shift;
        if (!(b & 0x80)) {
            *out = v;
            return 0;
        }
    }
    return PO_E_MALFORMED; /* longer than 64 bits */
}

static int read_be(reader *r, int bytes, uint64_t *out) {
    if (r->n - r->pos < (size_t)bytes) return PO_E_MALFORMED;
    uint64_t v = 0;
    for (int i = 0; i < bytes; i++) v = (v << 8) | r->src[r->pos++];
    *out = v;
    return 0;
}

/* `len` values of `width` bits, MSB first, from a byte boundary; the run
 * ends on a byte boundary too. */
static int read_packed(reader *r, uint64_t *out, int len, int width) {
    size_t bits = (size_t)len * (size_t)width;
    if (r->n - r->pos < (bits + 7) / 8) return PO_E_MALFORMED;
    const uint8_t *p = r->src + r->pos;
    if ((width & 7) == 0) {
        int bytes = width >> 3;
        for (int i = 0; i < len; i++) {
            uint64_t v = 0;
            for (int b = 0; b < bytes; b++) v = (v << 8) | *p++;
            out[i] = v;
        }
    } else {
        uint64_t acc = 0; /* holds `have` unread bits, right-aligned */
        int have = 0;
        for (int i = 0; i < len; i++) {
            uint64_t v = 0;
            int need = width;
            while (need > 0) {
                if (have == 0) {
                    acc = *p++;
                    have = 8;
                }
                int take = need < have ? need : have;
                v = (v << take) | ((acc >> (have - take)) & ((1u << take) - 1));
                have -= take;
                need -= take;
            }
            out[i] = v;
        }
    }
    r->pos += (bits + 7) / 8;
    return 0;
}

/* One RLE v2 run into buf; returns its length or an error. */
static int v2_run(reader *r, int is_signed, int64_t *buf) {
    uint8_t first;
    if (read_byte(r, &first)) return PO_E_MALFORMED;
    int kind = first >> 6;
    if (kind == 0) { /* SHORT_REPEAT */
        int bytes = ((first >> 3) & 7) + 1;
        int len = (first & 7) + 3;
        uint64_t v;
        if (read_be(r, bytes, &v)) return PO_E_MALFORMED;
        int64_t x = is_signed ? unzigzag(v) : (int64_t)v;
        for (int i = 0; i < len; i++) buf[i] = x;
        return len;
    }
    uint8_t second;
    if (read_byte(r, &second)) return PO_E_MALFORMED;
    int code = (first >> 1) & 0x1f;
    int len = (((first & 1) << 8) | second) + 1;
    uint64_t tmp[RUN_MAX];
    if (kind == 1) { /* DIRECT */
        if (read_packed(r, tmp, len, WIDTHS[code])) return PO_E_MALFORMED;
        for (int i = 0; i < len; i++) buf[i] = is_signed ? unzigzag(tmp[i]) : (int64_t)tmp[i];
        return len;
    }
    if (kind == 2) { /* PATCHED_BASE */
        int width = WIDTHS[code];
        uint8_t third, fourth;
        if (read_byte(r, &third) || read_byte(r, &fourth)) return PO_E_MALFORMED;
        int base_bytes = ((third >> 5) & 7) + 1;
        int patch_width = WIDTHS[third & 0x1f];
        int gap_width = ((fourth >> 5) & 7) + 1;
        int patches = fourth & 0x1f;
        uint64_t ub;
        if (read_be(r, base_bytes, &ub)) return PO_E_MALFORMED;
        uint64_t sign = 1ull << (base_bytes * 8 - 1);
        int64_t base = (ub & sign) ? -(int64_t)(ub & ~sign) : (int64_t)ub;
        if (read_packed(r, tmp, len, width)) return PO_E_MALFORMED;
        if (patch_width + gap_width > 64) return PO_E_MALFORMED;
        uint64_t plist[32];
        if (patches && read_packed(r, plist, patches, closest_fixed_bits(patch_width + gap_width)))
            return PO_E_MALFORMED;
        uint64_t pmask = patch_width >= 64 ? ~0ull : (1ull << patch_width) - 1;
        int pi = 0;
        size_t at = 0;
        while (pi < patches) {
            uint64_t gap = plist[pi] >> patch_width, patch = plist[pi] & pmask;
            at += gap;
            if (gap == 255 && patch == 0) { /* a long gap: only moves on */
                pi++;
                continue;
            }
            if (at >= (size_t)len) return PO_E_MALFORMED;
            tmp[at] |= width >= 64 ? 0 : patch << width;
            pi++;
        }
        for (int i = 0; i < len; i++) buf[i] = (int64_t)((uint64_t)base + tmp[i]);
        return len;
    }
    /* DELTA */
    int width = code ? WIDTHS[code] : 0;
    len -= 1; /* the stored length counts the values after the first */
    uint64_t u;
    if (read_uvarint(r, &u)) return PO_E_MALFORMED;
    int64_t first_value = is_signed ? unzigzag(u) : (int64_t)u;
    if (read_uvarint(r, &u)) return PO_E_MALFORMED;
    int64_t delta = unzigzag(u);
    buf[0] = first_value;
    if (width == 0) {
        for (int i = 1; i <= len; i++) buf[i] = (int64_t)((uint64_t)buf[i - 1] + (uint64_t)delta);
        return len + 1;
    }
    if (len < 1) return PO_E_MALFORMED;
    buf[1] = (int64_t)((uint64_t)first_value + (uint64_t)delta);
    if (read_packed(r, tmp, len - 1, width)) return PO_E_MALFORMED;
    for (int i = 0; i < len - 1; i++) {
        uint64_t prev = (uint64_t)buf[i + 1];
        buf[i + 2] = (int64_t)(delta < 0 ? prev - tmp[i] : prev + tmp[i]);
    }
    return len + 1;
}

/* One RLE v1 run into buf; returns its length or an error. */
static int v1_run(reader *r, int is_signed, int64_t *buf) {
    uint8_t control;
    if (read_byte(r, &control)) return PO_E_MALFORMED;
    uint64_t u;
    if (control < 128) {
        int len = control + 3;
        uint8_t step;
        if (read_byte(r, &step) || read_uvarint(r, &u)) return PO_E_MALFORMED;
        int64_t base = is_signed ? unzigzag(u) : (int64_t)u;
        for (int i = 0; i < len; i++) buf[i] = (int64_t)((uint64_t)base + (uint64_t)((int64_t)(int8_t)step * i));
        return len;
    }
    int len = 256 - control;
    for (int i = 0; i < len; i++) {
        if (read_uvarint(r, &u)) return PO_E_MALFORMED;
        buf[i] = is_signed ? unzigzag(u) : (int64_t)u;
    }
    return len;
}

/* `count` integers of RLE `version` (1 or 2); returns count or an error.
 * `runs`, when not NULL, counts the RLE v2 runs of each sub-encoding
 * (SHORT_REPEAT, DIRECT, PATCHED_BASE, DELTA). */
int64_t po_int_decode(const uint8_t *src, size_t n, int64_t count, int version, int is_signed, int64_t *out,
                      int64_t *runs) {
    reader r = {src, n, 0};
    int64_t done = 0;
    int64_t buf[RUN_MAX + 1];
    while (done < count) {
        if (runs && version == 2 && r.pos < r.n) runs[r.src[r.pos] >> 6]++;
        int len = version == 1 ? v1_run(&r, is_signed, buf) : v2_run(&r, is_signed, buf);
        if (len < 0) return len;
        int64_t take = len < count - done ? len : count - done;
        memcpy(out + done, buf, (size_t)take * sizeof(int64_t));
        done += take;
    }
    return done;
}

int64_t po_byte_decode(const uint8_t *src, size_t n, int64_t count, uint8_t *out) {
    reader r = {src, n, 0};
    int64_t done = 0;
    while (done < count) {
        uint8_t control, b;
        if (read_byte(&r, &control)) return PO_E_MALFORMED;
        if (control < 128) {
            int64_t len = control + 3;
            if (read_byte(&r, &b)) return PO_E_MALFORMED;
            if (len > count - done) len = count - done;
            memset(out + done, b, (size_t)len);
            done += len;
        } else {
            int64_t len = 256 - control;
            if (r.n - r.pos < (size_t)len) return PO_E_MALFORMED;
            int64_t take = len < count - done ? len : count - done;
            memcpy(out + done, r.src + r.pos, (size_t)take);
            r.pos += len;
            done += take;
        }
    }
    return done;
}

/* `count` booleans, one byte (0 or 1) each. */
int64_t po_bool_decode(const uint8_t *src, size_t n, int64_t count, uint8_t *out) {
    int64_t bytes = (count + 7) / 8;
    /* the packed bytes go to the tail of `out`, then spread forwards: byte
     * k's bits land at 8k..8k+7, never past the byte still to be read */
    uint8_t *packed = out + (count - bytes);
    int64_t got = po_byte_decode(src, n, bytes, packed);
    if (got < 0) return got;
    for (int64_t k = 0; k < bytes; k++) {
        uint8_t b = packed[k];
        int64_t base = 8 * k;
        int m = count - base < 8 ? (int)(count - base) : 8;
        for (int j = 0; j < m; j++) out[base + j] = (b >> (7 - j)) & 1;
    }
    return count;
}

/* `count` zigzag base-128 varints (DECIMAL's unscaled values). */
int64_t po_varint_decode(const uint8_t *src, size_t n, int64_t count, int64_t *out) {
    reader r = {src, n, 0};
    for (int64_t i = 0; i < count; i++) {
        uint64_t u;
        if (read_uvarint(&r, &u)) return PO_E_MALFORMED;
        out[i] = unzigzag(u);
    }
    return count;
}

/* ------------------------------------------------------------------ */
/* encoders                                                            */
/* ------------------------------------------------------------------ */

typedef struct {
    uint8_t *dst;
    size_t cap, pos;
    int overflow;
} writer;

static inline void put(writer *w, uint8_t b) {
    if (w->pos < w->cap)
        w->dst[w->pos++] = b;
    else
        w->overflow = 1;
}

static void put_uvarint(writer *w, uint64_t v) {
    while (v >= 0x80) {
        put(w, (uint8_t)(v | 0x80));
        v >>= 7;
    }
    put(w, (uint8_t)v);
}

static void put_packed(writer *w, const uint64_t *v, int len, int width) {
    uint64_t acc = 0;
    int have = 0; /* bits in acc, right-aligned */
    for (int i = 0; i < len; i++) {
        int left = width;
        while (left > 0) {
            int take = left < 8 - have ? left : 8 - have;
            uint64_t bits = (v[i] >> (left - take)) & ((1u << take) - 1);
            acc = (acc << take) | bits;
            have += take;
            left -= take;
            if (have == 8) {
                put(w, (uint8_t)acc);
                acc = 0;
                have = 0;
            }
        }
    }
    if (have) put(w, (uint8_t)(acc << (8 - have)));
}

static int bits_of(uint64_t v) { return v ? 64 - __builtin_clzll(v) : 0; }

static void put_header2(writer *w, int kind, int code, int len) {
    put(w, (uint8_t)((kind << 6) | (code << 1) | ((len - 1) >> 8)));
    put(w, (uint8_t)((len - 1) & 0xff));
}

static void encode_direct(writer *w, const int64_t *v, int len, int is_signed) {
    uint64_t u[RUN_MAX], most = 0;
    for (int i = 0; i < len; i++) {
        u[i] = is_signed ? zigzag(v[i]) : (uint64_t)v[i];
        most |= u[i];
    }
    int width = closest_fixed_bits(bits_of(most));
    put_header2(w, 1, width_code(width), len);
    put_packed(w, u, len, width);
}

/* DELTA when the run is monotone and its deltas fit: returns 1 if written. */
static int encode_delta(writer *w, const int64_t *v, int len, int is_signed, int direct_width) {
    if (len < 2) return 0;
    __int128 d0 = (__int128)v[1] - v[0];
    if (d0 > INT64_MAX || d0 < INT64_MIN) return 0;
    int fixed = 1, up = d0 >= 0;
    uint64_t mags[RUN_MAX], most = 0;
    for (int i = 1; i < len; i++) {
        __int128 d = (__int128)v[i] - v[i - 1];
        if (d > INT64_MAX || d < INT64_MIN) return 0;
        if (d != d0) fixed = 0;
        if ((up && d < 0) || (!up && d > 0)) return 0;
        if (i >= 2) {
            mags[i - 2] = (uint64_t)(d < 0 ? -d : d);
            most |= mags[i - 2];
        }
    }
    int width = 0;
    if (!fixed) {
        width = closest_fixed_bits(bits_of(most));
        if (width == 1) width = 2; /* code 0 means a fixed delta */
        if (width > direct_width) return 0;
    }
    put_header2(w, 3, width ? width_code(width) : 0, len);
    put_uvarint(w, is_signed ? zigzag(v[0]) : (uint64_t)v[0]);
    put_uvarint(w, zigzag((int64_t)d0));
    if (width) put_packed(w, mags, len - 2, width);
    return 1;
}

static void encode_repeat(writer *w, int64_t x, int len, int is_signed) {
    uint64_t u = is_signed ? zigzag(x) : (uint64_t)x;
    if (len <= 10) {
        int bytes = (bits_of(u) + 7) / 8;
        if (bytes == 0) bytes = 1;
        put(w, (uint8_t)(((bytes - 1) << 3) | (len - 3)));
        for (int b = bytes - 1; b >= 0; b--) put(w, (uint8_t)(u >> (8 * b)));
        return;
    }
    put_header2(w, 3, 0, len);
    put_uvarint(w, u);
    put_uvarint(w, 0);
}

/* `count` integers as RLE v2; returns the bytes written or an error. */
int64_t po_int_encode(const int64_t *in, int64_t count, int is_signed, uint8_t *dst, size_t cap) {
    writer w = {dst, cap, 0, 0};
    int64_t i = 0;
    while (i < count) {
        int64_t rep = 1;
        while (i + rep < count && rep < RUN_MAX && in[i + rep] == in[i]) rep++;
        if (rep >= 3) {
            encode_repeat(&w, in[i], (int)rep, is_signed);
            i += rep;
            continue;
        }
        /* a literal run: up to the next repeat of three, at most 512 */
        int64_t j = i;
        while (j < count && j - i < RUN_MAX) {
            if (j + 2 < count && in[j] == in[j + 1] && in[j] == in[j + 2]) break;
            j++;
        }
        int len = (int)(j - i);
        uint64_t most = 0;
        for (int k = 0; k < len; k++) most |= is_signed ? zigzag(in[i + k]) : (uint64_t)in[i + k];
        if (!encode_delta(&w, in + i, len, is_signed, closest_fixed_bits(bits_of(most))))
            encode_direct(&w, in + i, len, is_signed);
        i = j;
    }
    return w.overflow ? PO_E_DST_TOO_SMALL : (int64_t)w.pos;
}

/* Byte RLE of `count` bytes. */
int64_t po_byte_encode(const uint8_t *in, int64_t count, uint8_t *dst, size_t cap) {
    writer w = {dst, cap, 0, 0};
    int64_t i = 0;
    while (i < count) {
        int64_t rep = 1;
        while (i + rep < count && rep < 130 && in[i + rep] == in[i]) rep++;
        if (rep >= 3) {
            put(&w, (uint8_t)(rep - 3));
            put(&w, in[i]);
            i += rep;
            continue;
        }
        int64_t j = i;
        while (j < count && j - i < 128) {
            if (j + 2 < count && in[j] == in[j + 1] && in[j] == in[j + 2]) break;
            j++;
        }
        put(&w, (uint8_t)(256 - (j - i)));
        for (int64_t k = i; k < j; k++) put(&w, in[k]);
        i = j;
    }
    return w.overflow ? PO_E_DST_TOO_SMALL : (int64_t)w.pos;
}

/* `count` booleans (one byte each, nonzero true), packed MSB first, then
 * byte RLE. `dst` must also hold the packed bytes: cap >= 2 * (count+7)/8
 * + (count+7)/8/128 + 2. */
int64_t po_bool_encode(const uint8_t *in, int64_t count, uint8_t *dst, size_t cap) {
    int64_t bytes = (count + 7) / 8;
    if (cap < (size_t)bytes) return PO_E_DST_TOO_SMALL;
    uint8_t *packed = dst + cap - bytes;
    memset(packed, 0, (size_t)bytes);
    for (int64_t i = 0; i < count; i++)
        if (in[i]) packed[i >> 3] |= (uint8_t)(0x80 >> (i & 7));
    /* the RLE output stays behind the packed bytes it has read */
    int64_t n = po_byte_encode(packed, bytes, dst, cap - bytes);
    return n;
}

/* `count` zigzag base-128 varints. */
int64_t po_varint_encode(const int64_t *in, int64_t count, uint8_t *dst, size_t cap) {
    writer w = {dst, cap, 0, 0};
    for (int64_t i = 0; i < count; i++) put_uvarint(&w, zigzag(in[i]));
    return w.overflow ? PO_E_DST_TOO_SMALL : (int64_t)w.pos;
}
