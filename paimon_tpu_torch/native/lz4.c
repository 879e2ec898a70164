/* LZ4 raw block codec of the port (the format of Parquet's LZ4_RAW pages
 * and of ORC's LZ4 chunks: no frame, no checksums, no declared size).
 *
 * A block is a run of sequences. Each starts with a token byte: the upper
 * four bits are the literal count, the lower four the match length less 4.
 * A nibble of 15 means that more length follows, in bytes added to it until
 * one is below 255. Then come the literals, then (except in the last
 * sequence, which holds literals only) a 16-bit little-endian offset and the
 * match length's extra bytes. A match copies `length` bytes starting
 * `offset` bytes back in the output; the offset may be shorter than the
 * length (offset 1 repeats one byte), so the copy goes byte by byte there.
 *
 * The encoder keeps the format's end rules: the last 5 bytes are literals
 * and no match starts within the last 12 bytes, so any decoder takes its
 * blocks. A hash table of 4-byte sequences finds earlier occurrences within
 * the 64 KiB window; the search step grows over incompressible stretches.
 * Its output is valid LZ4, not byte-identical to another encoder's.
 *
 * Built at first use with `cc -O3 -shared -fPIC` and loaded via ctypes
 * (paimon_tpu_torch/native/__init__.py). Errors are negative returns:
 *   -1 malformed input   -2 destination too small
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define PL_E_MALFORMED (-1)
#define PL_E_DST_TOO_SMALL (-2)

#define MIN_MATCH 4
#define LAST_LITERALS 5
#define MATCH_FIND_LIMIT 12
#define MAX_OFFSET 65535
#define HASH_BITS 15

int64_t pl_compress_bound(size_t n) { return (int64_t)(n + n / 255 + 16); }

/* Reads a length extension: bytes added while they are 255. */
static int read_extra(const uint8_t *src, size_t n, size_t *pos, size_t *len) {
    for (;;) {
        if (*pos >= n) return PL_E_MALFORMED;
        uint8_t b = src[(*pos)++];
        *len += b;
        if (b != 255) return 0;
    }
}

int64_t pl_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap) {
    size_t pos = 0, out = 0;
    if (n == 0) return 0;
    for (;;) {
        if (pos >= n) return PL_E_MALFORMED;
        uint8_t token = src[pos++];
        size_t lit = token >> 4;
        if (lit == 15 && read_extra(src, n, &pos, &lit)) return PL_E_MALFORMED;
        if (lit > n - pos) return PL_E_MALFORMED;
        if (lit > cap - out) return PL_E_DST_TOO_SMALL;
        memcpy(dst + out, src + pos, lit);
        pos += lit;
        out += lit;
        if (pos == n) return (int64_t)out; /* the last sequence: literals only */
        if (n - pos < 2) return PL_E_MALFORMED;
        size_t off = (size_t)src[pos] | ((size_t)src[pos + 1] << 8);
        pos += 2;
        if (off == 0 || off > out) return PL_E_MALFORMED;
        size_t len = token & 15;
        if (len == 15 && read_extra(src, n, &pos, &len)) return PL_E_MALFORMED;
        len += MIN_MATCH;
        if (len > cap - out) return PL_E_DST_TOO_SMALL;
        uint8_t *d = dst + out;
        const uint8_t *s = d - off;
        if (off >= len) {
            memcpy(d, s, len);
        } else {
            for (size_t i = 0; i < len; i++) d[i] = s[i];
        }
        out += len;
    }
}

static inline uint32_t load32(const uint8_t *p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

static inline uint32_t hash4(uint32_t v) { return (v * 2654435761u) >> (32 - HASH_BITS); }

static size_t put_length(uint8_t *dst, size_t out, size_t extra) {
    while (extra >= 255) {
        dst[out++] = 255;
        extra -= 255;
    }
    dst[out++] = (uint8_t)extra;
    return out;
}

/* One sequence: `lit` literals from `src`, then a match (len >= 4) at
 * `off`, or no match when len == 0 (the last sequence). */
static size_t put_sequence(uint8_t *dst, size_t out, const uint8_t *src, size_t lit, size_t off, size_t len) {
    size_t token = out++;
    uint8_t hi = lit >= 15 ? 15 : (uint8_t)lit;
    if (lit >= 15) out = put_length(dst, out, lit - 15);
    memcpy(dst + out, src, lit);
    out += lit;
    uint8_t lo = 0;
    if (len) {
        dst[out++] = (uint8_t)(off & 0xff);
        dst[out++] = (uint8_t)(off >> 8);
        size_t m = len - MIN_MATCH;
        lo = m >= 15 ? 15 : (uint8_t)m;
        if (m >= 15) out = put_length(dst, out, m - 15);
    }
    dst[token] = (uint8_t)((hi << 4) | lo);
    return out;
}

int64_t pl_compress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap) {
    if ((int64_t)cap < pl_compress_bound(n)) return PL_E_DST_TOO_SMALL;
    size_t out = 0, anchor = 0;
    if (n > MATCH_FIND_LIMIT) {
        uint32_t *table = calloc((size_t)1 << HASH_BITS, sizeof(uint32_t));
        if (table == NULL) return PL_E_DST_TOO_SMALL;
        size_t ip = 0;
        size_t last_start = n - MATCH_FIND_LIMIT; /* a match starts before this */
        size_t match_end = n - LAST_LITERALS;     /* and ends at or before this */
        unsigned misses = 0;
        while (ip < last_start) {
            uint32_t v = load32(src + ip);
            uint32_t h = hash4(v);
            size_t cand = table[h];
            table[h] = (uint32_t)(ip + 1);
            if (cand == 0 || ip + 1 - cand > MAX_OFFSET || load32(src + cand - 1) != v) {
                ip += 1 + (misses++ >> 6);
                continue;
            }
            misses = 0;
            size_t ref = cand - 1;
            size_t len = MIN_MATCH;
            while (ip + len < match_end && src[ref + len] == src[ip + len]) len++;
            while (ip > anchor && ref > 0 && src[ip - 1] == src[ref - 1]) {
                ip--;
                ref--;
                len++;
            }
            out = put_sequence(dst, out, src + anchor, ip - anchor, ip - ref, len);
            ip += len;
            anchor = ip;
            if (ip >= 2 && ip - 2 < last_start) table[hash4(load32(src + ip - 2))] = (uint32_t)(ip - 1);
        }
        free(table);
    }
    out = put_sequence(dst, out, src + anchor, n - anchor, 0, 0);
    return (int64_t)out;
}
