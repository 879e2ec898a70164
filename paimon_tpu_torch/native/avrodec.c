/* Avro block codec of the port (the counterpart of the JAX package's
 * native/avrodec.c): one decompressed Avro block of flat records walked in
 * C, into columnar buffers and back.
 *   - int-family fields  -> int64 values + uint8 validity
 *   - float/double       -> float64 values + uint8 validity
 *   - boolean            -> uint8 values + uint8 validity
 *   - string/bytes       -> int32 offsets (n+1) + contiguous data bytes +
 *                           uint8 validity
 *
 * Built at first use with `cc -O3 -shared -fPIC` and loaded via ctypes
 * (paimon_tpu_torch/native/__init__.py). format/avro.py sends a block here
 * when every field is one of the types above, and to its Python loop
 * otherwise.
 *
 * Field type codes (must match native/__init__.py):
 *   0 int/long   1 float   2 double   3 boolean   4 string/bytes
 * Each field additionally carries a nullable flag (["null", T] union with
 * null as branch 0, the layout format/avro.py writes).
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

/* zigzag varint; returns new position or (size_t)-1 on overrun */
static size_t read_long(const uint8_t *buf, size_t pos, size_t len, int64_t *out) {
    uint64_t acc = 0;
    int shift = 0;
    while (pos < len) {
        uint8_t b = buf[pos++];
        acc |= ((uint64_t)(b & 0x7f)) << shift;
        if (!(b & 0x80)) {
            *out = (int64_t)(acc >> 1) ^ -(int64_t)(acc & 1);
            return pos;
        }
        shift += 7;
        if (shift > 63) return (size_t)-1;
    }
    return (size_t)-1;
}

/* Decode `count` records of `nfields` fields from buf[0:len].
 *
 * type_codes[f], nullable[f]: per-field schema.
 * num_out[f]: int64* or double* or uint8* target (length count), or NULL for
 *             string fields.
 * valid_out[f]: uint8* validity target (length count).
 * str_offsets[f]: int32* (length count+1), only for string fields.
 * str_data[f]: uint8* contiguous string bytes target, capacity str_cap[f].
 *
 * Returns 0 on success, -1 on malformed input, -2 if a string data buffer
 * would overflow (caller retries with a larger buffer).
 */
int decode_block(const uint8_t *buf, size_t len, int64_t count, int nfields,
                 const int32_t *type_codes, const uint8_t *nullable,
                 void **num_out, uint8_t **valid_out,
                 int32_t **str_offsets, uint8_t **str_data,
                 const int64_t *str_cap) {
    size_t pos = 0;
    for (int f = 0; f < nfields; f++) {
        if (type_codes[f] == 4 && str_offsets[f]) str_offsets[f][0] = 0;
    }
    for (int64_t r = 0; r < count; r++) {
        for (int f = 0; f < nfields; f++) {
            int present = 1;
            if (nullable[f]) {
                int64_t branch;
                pos = read_long(buf, pos, len, &branch);
                if (pos == (size_t)-1) return -1;
                present = branch != 0;
            }
            valid_out[f][r] = (uint8_t)present;
            switch (type_codes[f]) {
            case 0: { /* int/long */
                int64_t v = 0;
                if (present) {
                    pos = read_long(buf, pos, len, &v);
                    if (pos == (size_t)-1) return -1;
                }
                ((int64_t *)num_out[f])[r] = v;
                break;
            }
            case 1: { /* float -> double */
                double v = 0;
                if (present) {
                    if (pos + 4 > len) return -1;
                    float fv;
                    memcpy(&fv, buf + pos, 4);
                    pos += 4;
                    v = (double)fv;
                }
                ((double *)num_out[f])[r] = v;
                break;
            }
            case 2: { /* double */
                double v = 0;
                if (present) {
                    if (pos + 8 > len) return -1;
                    memcpy(&v, buf + pos, 8);
                    pos += 8;
                }
                ((double *)num_out[f])[r] = v;
                break;
            }
            case 3: { /* boolean */
                uint8_t v = 0;
                if (present) {
                    if (pos + 1 > len) return -1;
                    v = buf[pos++] ? 1 : 0;
                }
                ((uint8_t *)num_out[f])[r] = v;
                break;
            }
            case 4: { /* string/bytes */
                int64_t n = 0;
                int64_t used = str_offsets[f][r]; /* bytes of the rows before */
                if (present) {
                    pos = read_long(buf, pos, len, &n);
                    if (pos == (size_t)-1 || n < 0 || pos + (size_t)n > len) return -1;
                    if (used + n > str_cap[f]) return -2;
                    if (used + n > 0x7fffffff) return -1; /* int32 offsets */
                    memcpy(str_data[f] + used, buf + pos, (size_t)n);
                    pos += (size_t)n;
                    used += n;
                }
                str_offsets[f][r + 1] = (int32_t)used;
                break;
            }
            default:
                return -1;
            }
        }
    }
    return 0;
}

/* Encode `count` records into out[0:out_cap]. Inputs mirror decode_block:
 * numeric columns as int64/double/uint8 arrays + validity, strings as
 * offsets + contiguous data. Writes the block body (no count/size header).
 * Returns bytes written, or -1 if out_cap is too small. */
static size_t write_long(uint8_t *out, size_t pos, int64_t v) {
    uint64_t z = ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
    while (z & ~0x7fULL) {
        out[pos++] = (uint8_t)(z & 0x7f) | 0x80;
        z >>= 7;
    }
    out[pos++] = (uint8_t)z;
    return pos;
}

int64_t encode_block(uint8_t *out, size_t out_cap, int64_t count, int nfields,
                     const int32_t *type_codes, const uint8_t *nullable,
                     void **num_in, uint8_t **valid_in,
                     int32_t **str_offsets, uint8_t **str_data) {
    size_t pos = 0;
    /* worst case per scalar is 10 varint bytes + 1 branch byte */
    for (int64_t r = 0; r < count; r++) {
        for (int f = 0; f < nfields; f++) {
            int present = valid_in[f] ? valid_in[f][r] : 1;
            if (pos + 32 > out_cap) return -1;
            if (nullable[f]) pos = write_long(out, pos, present ? 1 : 0);
            if (!present) continue;
            switch (type_codes[f]) {
            case 0:
                pos = write_long(out, pos, ((const int64_t *)num_in[f])[r]);
                break;
            case 1: { /* float */
                float fv = (float)((const double *)num_in[f])[r];
                memcpy(out + pos, &fv, 4);
                pos += 4;
                break;
            }
            case 2:
                memcpy(out + pos, &((const double *)num_in[f])[r], 8);
                pos += 8;
                break;
            case 3:
                out[pos++] = ((const uint8_t *)num_in[f])[r] ? 1 : 0;
                break;
            case 4: {
                int32_t lo = str_offsets[f][r];
                int32_t hi = str_offsets[f][r + 1];
                int64_t n = hi - lo;
                pos = write_long(out, pos, n);
                if (pos + (size_t)n > out_cap) return -1;
                memcpy(out + pos, str_data[f] + lo, (size_t)n);
                pos += (size_t)n;
                break;
            }
            default:
                return -1;
            }
        }
    }
    return (int64_t)pos;
}
