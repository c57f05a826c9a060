/* Keccak-256 (Ethereum/Stone variant, 0x01 domain padding) — native host
 * implementation for the PyTorch port.
 *
 * Role: the Fiat–Shamir transcript, proof-of-work grinding, and Merkle
 * proof verification are sequential host-side byte protocols.  The
 * reference runs them on the native `sha3` crate
 * (crypto/src/fiat_shamir/default_transcript.rs:9, provers/stark/src/
 * grinding.rs); this file is the equivalent native component.  The bulk
 * batched Keccak runs on the card (csrc/keccak.cu, hashes/keccak.py).
 * The JAX package carries the same source as
 * lambda_elliptic_curves_tpu/native/keccak.c; the port keeps its own copy
 * so that it needs no file of that package.
 *
 * Written from the Keccak specification (FIPS 202 / Keccak reference):
 * 24 rounds of theta/rho/pi/chi/iota over a 5x5 lane state.
 *
 * Build: cc -O2 -shared -fPIC -o libkeccak.so keccak.c  (done at first use
 * by lambda_elliptic_curves_tpu_torch/native/__init__.py).  It lives in
 * csrc/host/, outside the csrc/*.cu glob of the CUDA build.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#define RATE 136 /* keccak-256 rate in bytes */

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

/* rho rotation offsets, indexed [x][y] (lane (x, y) at state x + 5y) */
static const int ROT[5][5] = {{0, 36, 3, 41, 18},
                              {1, 44, 10, 45, 2},
                              {62, 6, 43, 15, 61},
                              {28, 55, 25, 21, 56},
                              {27, 20, 39, 8, 14}};

static inline uint64_t rotl64(uint64_t v, int n) {
    n &= 63;
    return n ? (v << n) | (v >> (64 - n)) : v;
}

static void keccak_f(uint64_t s[25]) {
    uint64_t c[5], d[5], b[25];
    for (int r = 0; r < 24; r++) {
        for (int x = 0; x < 5; x++)
            c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
        for (int x = 0; x < 5; x++)
            d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
        for (int i = 0; i < 25; i++) s[i] ^= d[i % 5];
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(s[x + 5 * y], ROT[x][y]);
        for (int y = 0; y < 5; y++)
            for (int x = 0; x < 5; x++)
                s[x + 5 * y] = b[x + 5 * y] ^
                               (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
        s[0] ^= RC[r];
    }
}

static void absorb_block(uint64_t s[25], const uint8_t *block) {
    for (int i = 0; i < RATE / 8; i++) {
        uint64_t lane = 0;
        for (int t = 7; t >= 0; t--) lane = (lane << 8) | block[8 * i + t];
        s[i] ^= lane;
    }
    keccak_f(s);
}

void lw_keccak256(const uint8_t *data, size_t len, uint8_t out[32]) {
    uint64_t s[25];
    memset(s, 0, sizeof(s));
    size_t off = 0;
    while (len - off >= RATE) {
        absorb_block(s, data + off);
        off += RATE;
    }
    uint8_t last[RATE];
    memset(last, 0, RATE);
    memcpy(last, data + off, len - off);
    last[len - off] ^= 0x01; /* keccak (not sha3) domain padding */
    last[RATE - 1] ^= 0x80;
    absorb_block(s, last);
    for (int i = 0; i < 4; i++)
        for (int t = 0; t < 8; t++) out[8 * i + t] = (uint8_t)(s[i] >> (8 * t));
}

/* Proof-of-work search (provers/stark/src/grinding.rs:40 parity):
 * find nonce in [start, start+count) with
 * BE64(keccak256(inner32 || nonce_be8)[0..8]) < 2^(64-factor).
 * Returns the nonce, or -1 if none found in the range. */
int64_t lw_grind(const uint8_t inner[32], int factor, uint64_t start,
                 uint64_t count) {
    uint8_t msg[40], dig[32];
    memcpy(msg, inner, 32);
    uint64_t limit_hi = (factor >= 64) ? 0 : (1ULL << (64 - factor));
    for (uint64_t n = start; n < start + count; n++) {
        for (int t = 0; t < 8; t++) msg[32 + t] = (uint8_t)(n >> (8 * (7 - t)));
        lw_keccak256(msg, 40, dig);
        uint64_t head = 0;
        for (int t = 0; t < 8; t++) head = (head << 8) | dig[t];
        if (head < limit_hi) return (int64_t)n;
    }
    return -1;
}

/* Merkle parent build over a binary heap of 32-byte keccak-256 digests
 * (crypto/src/merkle_tree/merkle.rs:33 parity: parent = H(left || right)).
 * nodes: 32*2n bytes; leaves pre-filled at nodes[32*n .. 32*2n); this fills
 * nodes[32 .. 32*n) bottom-up (node i's children are 2i and 2i+1, which sit
 * contiguously at byte offset 64*i).  nodes[0..32) is left untouched. */
void lw_merkle_levels(uint8_t *nodes, size_t n) {
    for (size_t i = n - 1; i >= 1; i--)
        lw_keccak256(nodes + 64 * i, 64, nodes + 32 * i);
}
