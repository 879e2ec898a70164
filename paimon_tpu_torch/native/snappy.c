/* Snappy raw block codec of the port (the format Parquet's SNAPPY pages
 * carry: no framing, no checksums).
 *
 * A block is the uncompressed length as a little-endian base-128 varint,
 * then elements, each led by a tag byte whose low two bits give its kind:
 *   00 literal   length-1 in the upper six bits; 60..63 there mean that
 *                1..4 little-endian bytes of length-1 follow; then the bytes
 *   01 copy      length 4..11 in bits 2..4, offset bits 8..10 in bits 5..7,
 *                offset bits 0..7 in the next byte
 *   10 copy      length 1..64 in the upper six bits, 16-bit offset
 *   11 copy      length 1..64 in the upper six bits, 32-bit offset
 * A copy repeats `length` bytes starting `offset` bytes back in the output;
 * offset may be shorter than length (the copied bytes then repeat).
 *
 * The encoder works on 64 KiB fragments, as the reference implementation
 * does: a hash table of 4-byte sequences finds earlier occurrences within
 * the fragment, so every offset fits the 16-bit copy. Its output is valid
 * snappy, not byte-identical to another encoder's.
 *
 * Built at first use with `cc -O3 -shared -fPIC` and loaded via ctypes
 * (paimon_tpu_torch/native/__init__.py). Errors are negative returns:
 *   -1 malformed input   -2 destination too small
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define PS_E_MALFORMED (-1)
#define PS_E_DST_TOO_SMALL (-2)

#define FRAGMENT (1 << 16)
#define HASH_BITS 14

int64_t ps_compress_bound(size_t n) { return (int64_t)(32 + n + n / 6); }

/* The declared uncompressed length, or a negative error. */
int64_t ps_uncompressed_length(const uint8_t *src, size_t n) {
    uint64_t v = 0;
    for (size_t i = 0; i < n && i < 10; i++) {
        v |= (uint64_t)(src[i] & 0x7f) << (7 * i);
        if (!(src[i] & 0x80)) return v > 0x7fffffffffffffffULL ? PS_E_MALFORMED : (int64_t)v;
    }
    return PS_E_MALFORMED;
}

int64_t ps_decompress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap) {
    size_t pos = 0;
    uint64_t want = 0;
    int shift = 0;
    for (;;) {
        if (pos >= n || shift > 63) return PS_E_MALFORMED;
        uint8_t b = src[pos++];
        want |= (uint64_t)(b & 0x7f) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    if (want > cap) return PS_E_DST_TOO_SMALL;
    size_t out = 0;
    while (pos < n) {
        uint8_t tag = src[pos++];
        size_t len, off;
        switch (tag & 3) {
        case 0: {
            len = tag >> 2;
            if (len >= 60) {
                size_t extra = len - 59;
                if (pos + extra > n) return PS_E_MALFORMED;
                len = 0;
                for (size_t i = 0; i < extra; i++) len |= (size_t)src[pos + i] << (8 * i);
                pos += extra;
            }
            len += 1;
            if (len > n - pos || len > want - out) return PS_E_MALFORMED;
            memcpy(dst + out, src + pos, len);
            pos += len;
            out += len;
            continue;
        }
        case 1:
            if (pos + 1 > n) return PS_E_MALFORMED;
            len = 4 + ((tag >> 2) & 7);
            off = ((size_t)(tag >> 5) << 8) | src[pos];
            pos += 1;
            break;
        case 2:
            if (pos + 2 > n) return PS_E_MALFORMED;
            len = 1 + (tag >> 2);
            off = (size_t)src[pos] | ((size_t)src[pos + 1] << 8);
            pos += 2;
            break;
        default:
            if (pos + 4 > n) return PS_E_MALFORMED;
            len = 1 + (tag >> 2);
            off = (size_t)src[pos] | ((size_t)src[pos + 1] << 8) | ((size_t)src[pos + 2] << 16) |
                  ((size_t)src[pos + 3] << 24);
            pos += 4;
            break;
        }
        if (off == 0 || off > out || len > want - out) return PS_E_MALFORMED;
        uint8_t *d = dst + out;
        const uint8_t *s = d - off;
        if (off >= len) {
            memcpy(d, s, len);
        } else {
            for (size_t i = 0; i < len; i++) d[i] = s[i]; /* the pattern repeats */
        }
        out += len;
    }
    return out == want ? (int64_t)out : PS_E_MALFORMED;
}

static size_t put_literal(uint8_t *dst, size_t out, const uint8_t *src, size_t len) {
    size_t n = len - 1;
    if (n < 60) {
        dst[out++] = (uint8_t)(n << 2);
    } else {
        int bytes = n < (1u << 8) ? 1 : n < (1u << 16) ? 2 : n < (1u << 24) ? 3 : 4;
        dst[out++] = (uint8_t)((59 + bytes) << 2);
        for (int i = 0; i < bytes; i++) dst[out++] = (uint8_t)(n >> (8 * i));
    }
    memcpy(dst + out, src, len);
    return out + len;
}

static size_t put_copy_upto64(uint8_t *dst, size_t out, size_t off, size_t len) {
    if (len >= 4 && len <= 11 && off < 2048) {
        dst[out++] = (uint8_t)(1 | ((len - 4) << 2) | ((off >> 8) << 5));
        dst[out++] = (uint8_t)(off & 0xff);
    } else {
        dst[out++] = (uint8_t)(2 | ((len - 1) << 2));
        dst[out++] = (uint8_t)(off & 0xff);
        dst[out++] = (uint8_t)(off >> 8);
    }
    return out;
}

static size_t put_copy(uint8_t *dst, size_t out, size_t off, size_t len) {
    while (len >= 68) {
        out = put_copy_upto64(dst, out, off, 64);
        len -= 64;
    }
    if (len > 64) { /* 65..67: leave at least 4 for the last element */
        out = put_copy_upto64(dst, out, off, 60);
        len -= 60;
    }
    return put_copy_upto64(dst, out, off, len);
}

static inline uint32_t load32(const uint8_t *p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

static inline uint32_t hash4(uint32_t v) { return (v * 0x1e35a7bdu) >> (32 - HASH_BITS); }

int64_t ps_compress(const uint8_t *src, size_t n, uint8_t *dst, size_t cap) {
    if ((int64_t)cap < ps_compress_bound(n)) return PS_E_DST_TOO_SMALL;
    size_t out = 0;
    uint64_t v = n;
    while (v >= 0x80) {
        dst[out++] = (uint8_t)(v | 0x80);
        v >>= 7;
    }
    dst[out++] = (uint8_t)v;
    uint16_t table[1 << HASH_BITS];
    for (size_t base = 0; base < n; base += FRAGMENT) {
        size_t end = n - base < FRAGMENT ? n : base + FRAGMENT;
        const uint8_t *frag = src + base;
        size_t flen = end - base;
        size_t lit = 0; /* start of the pending literal, relative to frag */
        if (flen >= 15) {
            memset(table, 0, sizeof(table));
            size_t limit = flen - 4; /* last position a 4-byte load may start */
            size_t i = 1;
            while (i <= limit) {
                uint32_t cur = load32(frag + i);
                uint32_t h = hash4(cur);
                size_t cand = table[h];
                table[h] = (uint16_t)i;
                if (cand >= i || load32(frag + cand) != cur) {
                    i++;
                    continue;
                }
                size_t len = 4;
                while (i + len < flen && frag[cand + len] == frag[i + len]) len++;
                if (i > lit) out = put_literal(dst, out, frag + lit, i - lit);
                out = put_copy(dst, out, i - cand, len);
                i += len;
                lit = i;
                if (i - 1 <= limit) table[hash4(load32(frag + i - 1))] = (uint16_t)(i - 1);
            }
        }
        if (flen > lit) out = put_literal(dst, out, frag + lit, flen - lit);
    }
    return (int64_t)out;
}
