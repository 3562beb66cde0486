/* FLAC bit-level hot kernels: rice encode/decode + CRC-16.
 *
 * The Python encoder (acestep_torch/utils/flac.py) handles all format
 * structure; these kernels only do the per-sample bit twiddling that is
 * slow in Python. Compiled on demand by utils/flac_native.py with the
 * system compiler; the pure-Python fallbacks produce identical bytes.
 *
 * Bit order is FLAC's: most-significant bit first within each byte.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* CRC-16, polynomial 0x8005, init 0 (FLAC frame footer). */
uint16_t crc16(const unsigned char *data, size_t n) {
    uint16_t c = 0;
    for (size_t i = 0; i < n; i++) {
        c ^= (uint16_t)data[i] << 8;
        for (int b = 0; b < 8; b++)
            c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005)
                             : (uint16_t)(c << 1);
    }
    return c;
}

/* Append one value of `bits` bits (MSB-first) at bit position *pos. */
static inline void put_bits(uint8_t *out, size_t *pos, uint64_t val,
                            int bits) {
    while (bits > 0) {
        size_t byte = *pos >> 3;
        int avail = 8 - (int)(*pos & 7);
        int take = bits < avail ? bits : avail;
        uint8_t chunk = (uint8_t)((val >> (bits - take)) & ((1u << take) - 1));
        out[byte] |= (uint8_t)(chunk << (avail - take));
        *pos += (size_t)take;
        bits -= take;
    }
}

/* Rice-encode `n` zigzagged values with parameter `param` into `out`
 * (zero-initialized, starting at bit 0). Returns the bit length written,
 * or 0 if the buffer would overflow. Unary = q zero bits then a 1. */
size_t rice_encode(const uint64_t *u, size_t n, int param, uint8_t *out,
                   size_t out_bytes) {
    size_t pos = 0;
    size_t cap = out_bytes * 8;
    for (size_t i = 0; i < n; i++) {
        uint64_t q = u[i] >> param;
        if (pos + q + 1 + (size_t)param > cap)
            return 0;
        pos += q;                /* q zero bits (buffer pre-zeroed) */
        put_bits(out, &pos, 1, 1);
        if (param)
            put_bits(out, &pos, u[i], param);
    }
    return pos;
}

/* Read one bit at position pos. */
static inline int get_bit(const unsigned char *data, size_t pos) {
    return (data[pos >> 3] >> (7 - (pos & 7))) & 1;
}

/* Decode `count` rice values with parameter `param` from `data` starting
 * at bit `bitpos`. Returns the new bit position (0 on overrun). */
size_t rice_decode(const unsigned char *data, size_t nbytes, size_t bitpos,
                   uint64_t *out, size_t count, int param) {
    size_t cap = nbytes * 8;
    for (size_t i = 0; i < count; i++) {
        uint64_t q = 0;
        while (bitpos < cap && get_bit(data, bitpos) == 0) {
            q++;
            bitpos++;
        }
        if (bitpos >= cap)
            return 0;
        bitpos++;                /* the terminating 1 */
        uint64_t low = 0;
        for (int b = 0; b < param; b++) {
            if (bitpos >= cap)
                return 0;
            low = (low << 1) | (uint64_t)get_bit(data, bitpos);
            bitpos++;
        }
        out[i] = (q << param) | low;
    }
    return bitpos;
}

/* LPC reconstruction: s[0..order) hold warmup samples, s[order..n) hold
 * residuals on entry and reconstructed samples on exit.
 * s[i] += (sum_j coefs[j] * s[i-1-j]) >> shift  (arithmetic shift). */
void lpc_reconstruct(int64_t *s, size_t n, const int64_t *coefs, int order,
                     int shift) {
    for (size_t i = (size_t)order; i < n; i++) {
        int64_t pred = 0;
        for (int j = 0; j < order; j++)
            pred += coefs[j] * s[i - 1 - j];
        s[i] += pred >> shift;
    }
}
