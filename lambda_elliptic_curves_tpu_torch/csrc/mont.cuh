// Stark252 Montgomery arithmetic on eight 32-bit limbs: the one
// implementation that field.cu, ntt.cuh and batch_inverse.cuh share.
//
// Replaces the XLA digit core of lambda_elliptic_curves_tpu/ops/limbs.py
// (mont_mul :750, mont_square :829, add :600, sub :610, and the lazy
// variants that poly/ntt_pallas.py inlines into its kernel body).  The JAX
// package works on sixteen 16-bit digits because the TPU has no widening
// multiply; Hopper has 32x32->64 products, so a value is eight u32 limbs,
// least significant first.  R = 2^256 as in the JAX package, so a
// Montgomery value here has the same bits as the JAX value.
//
// p = 2^251 + 17*2^192 + 1: limbs {1,0,0,0,0,0,17,0x08000000}.  Every
// function here is strict: inputs and outputs are canonical (< p).
//
// The product (lw_mont_mul, lw_mont_sqr): the 512-bit a*b in 64-bit
// multiply-adds, then the Montgomery reduction and the sums in the card's
// carry-chain instructions (mad.lo/hi and add with carry in and out), p's
// sparse limbs (m*p = m + 17m*2^192 + m*2^251) folded into a few words.  On
// the host each carry instruction is emulated with a carry flag, so that
// the same code compiles with g++ and the host tests run the same sequence
// of values; they do not show that the card's carry flag behaves as the
// emulation's does (the card's kernel tests check that).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define LW_HD __host__ __device__ __forceinline__
#else
#define LW_HD static inline
#endif

#define LW_LIMBS 8

#ifdef __CUDA_ARCH__
#define LW_ASM3(name, op)                                                       \
    __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b, uint32_t c) { \
        uint32_t d;                                                             \
        asm volatile(op " %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));  \
        return d;                                                               \
    }
#define LW_ASM2(name, op)                                                       \
    __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {           \
        uint32_t d;                                                             \
        asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));              \
        return d;                                                               \
    }
LW_ASM3(lw_mad_lo_cc, "mad.lo.cc.u32")
LW_ASM3(lw_madc_lo_cc, "madc.lo.cc.u32")
LW_ASM3(lw_mad_hi_cc, "mad.hi.cc.u32")
LW_ASM3(lw_madc_hi_cc, "madc.hi.cc.u32")
LW_ASM3(lw_madc_hi, "madc.hi.u32")
LW_ASM2(lw_add_cc, "add.cc.u32")
LW_ASM2(lw_addc_cc, "addc.cc.u32")
LW_ASM2(lw_addc, "addc.u32")
#else
static uint32_t lw_cf;  // the emulated carry flag
static inline uint32_t lw_set_cf(uint64_t v) {
    lw_cf = (uint32_t)(v >> 32);
    return (uint32_t)v;
}
static inline uint32_t lw_mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return lw_set_cf((uint64_t)(uint32_t)(a * b) + c);
}
static inline uint32_t lw_madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return lw_set_cf((uint64_t)(uint32_t)(a * b) + c + lw_cf);
}
static inline uint32_t lw_mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return lw_set_cf((((uint64_t)a * b) >> 32) + c);
}
static inline uint32_t lw_madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return lw_set_cf((((uint64_t)a * b) >> 32) + c + lw_cf);
}
static inline uint32_t lw_madc_hi(uint32_t a, uint32_t b, uint32_t c) {
    return (uint32_t)((((uint64_t)a * b) >> 32) + c + lw_cf);
}
static inline uint32_t lw_add_cc(uint32_t a, uint32_t b) { return lw_set_cf((uint64_t)a + b); }
static inline uint32_t lw_addc_cc(uint32_t a, uint32_t b) {
    return lw_set_cf((uint64_t)a + b + lw_cf);
}
static inline uint32_t lw_addc(uint32_t a, uint32_t b) { return a + b + lw_cf; }
#endif

LW_HD uint32_t lw_p_limb(int i) {
    // constant-folded after unrolling
    return i == 0 ? 1u : (i == 6 ? 17u : (i == 7 ? 0x08000000u : 0u));
}

// r = a - p if a >= p (a < 2p), else a
LW_HD void lw_reduce_once(uint32_t a[LW_LIMBS]) {
    uint32_t d[LW_LIMBS];
    int64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < LW_LIMBS; i++) {
        int64_t t = (int64_t)a[i] - (int64_t)lw_p_limb(i) + borrow;
        d[i] = (uint32_t)t;
        borrow = t >> 32;  // 0 or -1
    }
    if (borrow == 0) {
#pragma unroll
        for (int i = 0; i < LW_LIMBS; i++) a[i] = d[i];
    }
}

LW_HD void lw_add(const uint32_t a[LW_LIMBS], const uint32_t b[LW_LIMBS],
                  uint32_t r[LW_LIMBS]) {
    uint64_t carry = 0;
#pragma unroll
    for (int i = 0; i < LW_LIMBS; i++) {
        uint64_t t = (uint64_t)a[i] + b[i] + carry;
        r[i] = (uint32_t)t;
        carry = t >> 32;
    }
    // a + b < 2p < 2^256: no carry out of the top limb
    lw_reduce_once(r);
}

LW_HD void lw_sub(const uint32_t a[LW_LIMBS], const uint32_t b[LW_LIMBS],
                  uint32_t r[LW_LIMBS]) {
    int64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < LW_LIMBS; i++) {
        int64_t t = (int64_t)a[i] - (int64_t)b[i] + borrow;
        r[i] = (uint32_t)t;
        borrow = t >> 32;
    }
    if (borrow) {  // a < b: add p back (wraps to the right value mod 2^256)
        uint64_t carry = 0;
#pragma unroll
        for (int i = 0; i < LW_LIMBS; i++) {
            uint64_t t = (uint64_t)r[i] + lw_p_limb(i) + carry;
            r[i] = (uint32_t)t;
            carry = t >> 32;
        }
    }
}

LW_HD void lw_neg(const uint32_t a[LW_LIMBS], uint32_t r[LW_LIMBS]) {
    const uint32_t zero[LW_LIMBS] = {0, 0, 0, 0, 0, 0, 0, 0};
    lw_sub(zero, a, r);
}

// r = T * 2^-256 mod p for a 512-bit T < p * 2^256 (T = a*b with a, b < p)
LW_HD void lw_mont_reduce(const uint32_t T[2 * LW_LIMBS], uint32_t r[LW_LIMBS]) {
    // -p^-1 = -1 mod 2^192, so reduce 192 bits at once: m = -T mod 2^192
    // and X = (T + m p) / 2^192 = T[6..15] + (T mod 2^192 != 0) + 17m + m 2^59
    // (-T = ~T + 1, whose carry out is 1 exactly when T mod 2^192 = 0)
    uint32_t m[6], X[10];
    m[0] = lw_add_cc(~T[0], 1u);
#pragma unroll
    for (int k = 1; k < 6; k++) m[k] = lw_addc_cc(~T[k], 0);
    const uint32_t c1 = lw_addc(0, 0) ^ 1u;
    X[0] = lw_mad_lo_cc(m[0], 17u, T[6]);
#pragma unroll
    for (int k = 1; k < 6; k++) X[k] = lw_madc_lo_cc(m[k], 17u, T[6 + k]);
#pragma unroll
    for (int k = 6; k < 9; k++) X[k] = lw_addc_cc(T[6 + k], 0);
    X[9] = lw_addc(T[15], 0);
    X[1] = lw_mad_hi_cc(m[0], 17u, X[1]);
#pragma unroll
    for (int k = 1; k < 6; k++) X[k + 1] = lw_madc_hi_cc(m[k], 17u, X[k + 1]);
    X[7] = lw_addc_cc(X[7], 0);
    X[8] = lw_addc_cc(X[8], 0);
    X[9] = lw_addc(X[9], 0);
    X[0] = lw_add_cc(X[0], c1);  // m 2^59: m << 27 on limbs 1..7
    X[1] = lw_addc_cc(X[1], m[0] << 27);
#pragma unroll
    for (int k = 1; k < 6; k++) X[k + 1] = lw_addc_cc(X[k + 1], (m[k] << 27) | (m[k - 1] >> 5));
    X[7] = lw_addc_cc(X[7], m[5] >> 5);
    X[8] = lw_addc_cc(X[8], 0);
    X[9] = lw_addc(X[9], 0);
    // then 64 bits: n = -X mod 2^64, r = (X + n p) / 2^64
    //   = X[2..9] + (X mod 2^64 != 0) + 17n 2^128 + n 2^187
    const uint32_t n0 = lw_add_cc(~X[0], 1u);
    const uint32_t n1 = lw_addc_cc(~X[1], 0);
    const uint32_t c2 = lw_addc(0, 0) ^ 1u;
    r[0] = lw_add_cc(X[2], c2);
    r[1] = lw_addc_cc(X[3], 0);
    r[2] = lw_addc_cc(X[4], 0);
    r[3] = lw_addc_cc(X[5], 0);
    r[4] = lw_madc_lo_cc(n0, 17u, X[6]);
    r[5] = lw_madc_lo_cc(n1, 17u, X[7]);
    r[6] = lw_addc_cc(X[8], 0);
    r[7] = lw_addc(X[9], 0);
    r[5] = lw_mad_hi_cc(n0, 17u, r[5]);
    r[6] = lw_madc_hi_cc(n1, 17u, r[6]);
    r[7] = lw_addc(r[7], 0);
    r[5] = lw_add_cc(r[5], n0 << 27);
    r[6] = lw_addc_cc(r[6], (n1 << 27) | (n0 >> 5));
    r[7] = lw_addc(r[7], n1 >> 5);
    // r < 2p: d = r - p = r + (2^256 - p), taken when it carries out (r >= p)
    uint32_t d[LW_LIMBS];
    d[0] = lw_add_cc(r[0], 0xFFFFFFFFu);
#pragma unroll
    for (int k = 1; k < 6; k++) d[k] = lw_addc_cc(r[k], 0xFFFFFFFFu);
    d[6] = lw_addc_cc(r[6], 0xFFFFFFEEu);
    d[7] = lw_addc_cc(r[7], 0xF7FFFFFFu);
    const uint32_t take = 0u - lw_addc(0, 0);  // all ones if r >= p
#pragma unroll
    for (int k = 0; k < LW_LIMBS; k++) r[k] = (d[k] & take) | (r[k] & ~take);
}

// Montgomery product a*b*2^-256 mod p (r may alias a or b)
LW_HD void lw_mont_mul(const uint32_t a[LW_LIMBS], const uint32_t b[LW_LIMBS],
                       uint32_t r[LW_LIMBS]) {
    // T = a*b, 16 limbs, row by row in 64-bit multiply-adds (t + a_j b_i + c
    // < 2^64); carry chains measured slower for this part
    uint32_t T[2 * LW_LIMBS];
#pragma unroll
    for (int j = 0; j < 2 * LW_LIMBS; j++) T[j] = 0;
#pragma unroll
    for (int i = 0; i < LW_LIMBS; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < LW_LIMBS; j++) {
            const uint64_t w = (uint64_t)a[j] * b[i] + T[i + j] + c;
            T[i + j] = (uint32_t)w;
            c = w >> 32;
        }
        T[i + 8] = (uint32_t)c;
    }
    lw_mont_reduce(T, r);
}

// Montgomery square a*a*2^-256 mod p: 36 limb products instead of 64, the
// 28 below the diagonal summed once and doubled (r may alias a)
LW_HD void lw_mont_sqr(const uint32_t a[LW_LIMBS], uint32_t r[LW_LIMBS]) {
    uint32_t T[2 * LW_LIMBS];
#pragma unroll
    for (int j = 0; j < 2 * LW_LIMBS; j++) T[j] = 0;
#pragma unroll
    for (int i = 0; i < LW_LIMBS - 1; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = i + 1; j < LW_LIMBS; j++) {
            const uint64_t w = (uint64_t)a[j] * a[i] + T[i + j] + c;
            T[i + j] = (uint32_t)w;
            c = w >> 32;
        }
        T[i + 8] = (uint32_t)c;
    }
    // twice the sum below the diagonal (< 2^511), then the squares a_i^2
    // at limbs 2i, 2i + 1 in one carry chain (a^2 < 2^512: no carry out)
#pragma unroll
    for (int k = 2 * LW_LIMBS - 1; k > 0; k--) T[k] = (T[k] << 1) | (T[k - 1] >> 31);
    T[0] <<= 1;
    T[0] = lw_mad_lo_cc(a[0], a[0], T[0]);
    T[1] = lw_madc_hi_cc(a[0], a[0], T[1]);
#pragma unroll
    for (int i = 1; i < LW_LIMBS - 1; i++) {
        T[2 * i] = lw_madc_lo_cc(a[i], a[i], T[2 * i]);
        T[2 * i + 1] = lw_madc_hi_cc(a[i], a[i], T[2 * i + 1]);
    }
    T[14] = lw_madc_lo_cc(a[7], a[7], T[14]);
    T[15] = lw_madc_hi(a[7], a[7], T[15]);
    lw_mont_reduce(T, r);
}

// R mod p, the Montgomery one
LW_HD void lw_mont_one(uint32_t r[LW_LIMBS]) {
    // R mod p = 2^256 - 31p, since 31p < 2^256 < 32p: negate 31p limb by
    // limb, carrying the product's high word and the borrow together
    uint64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < LW_LIMBS; i++) {
        uint64_t prod = (uint64_t)lw_p_limb(i) * 31u + borrow;
        r[i] = 0u - (uint32_t)prod;
        borrow = (prod >> 32) + ((uint32_t)prod != 0u ? 1u : 0u);
    }
}

LW_HD bool lw_is_zero(const uint32_t a[LW_LIMBS]) {
    uint32_t any = 0;
#pragma unroll
    for (int i = 0; i < LW_LIMBS; i++) any |= a[i];
    return any == 0;
}

LW_HD void lw_copy(const uint32_t a[LW_LIMBS], uint32_t r[LW_LIMBS]) {
#pragma unroll
    for (int i = 0; i < LW_LIMBS; i++) r[i] = a[i];
}

// a^e for an exponent given as LW_LIMBS little-endian words and its bit
// length (left-to-right square and multiply).  e = 0 gives R mod p, the
// Montgomery one.
LW_HD void lw_mont_pow(const uint32_t a[LW_LIMBS], const uint32_t e[LW_LIMBS],
                       int nbits, uint32_t r[LW_LIMBS]) {
    uint32_t acc[LW_LIMBS];
    lw_mont_one(acc);
    for (int bit = nbits - 1; bit >= 0; bit--) {
        lw_mont_sqr(acc, acc);
        if ((e[bit >> 5] >> (bit & 31)) & 1u) lw_mont_mul(acc, a, acc);
    }
    lw_copy(acc, r);
}

// a -= b, and whether a >= b (when it is not, a wraps mod 2^256)
LW_HD bool lw_sub_raw(uint32_t a[LW_LIMBS], const uint32_t b[LW_LIMBS]) {
    int64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < LW_LIMBS; i++) {
        const int64_t t = (int64_t)a[i] - (int64_t)b[i] + borrow;
        a[i] = (uint32_t)t;
        borrow = t >> 32;
    }
    return borrow == 0;
}

LW_HD bool lw_is_one(const uint32_t a[LW_LIMBS]) {
    uint32_t any = a[0] ^ 1u;
#pragma unroll
    for (int i = 1; i < LW_LIMBS; i++) any |= a[i];
    return any == 0;
}

LW_HD int lw_ctz(uint32_t x) {  // x != 0
#ifdef __CUDA_ARCH__
    return __ffs(x) - 1;
#else
    return __builtin_ctz(x);
#endif
}

// u >>= s and x <- x / 2^s mod p, for 1 <= s <= 31 and x < p: with m = -x
// mod 2^s, x + m p = 0 mod 2^s (p = 1 mod 2^192), and (x + m p) / 2^s < 2p
// (x + m p < 2^283: nine limbs; m p = m + 17m 2^192 + m 2^251)
LW_HD void lw_inv_shift(uint32_t u[LW_LIMBS], uint32_t x[LW_LIMBS], int s) {
#pragma unroll
    for (int i = 0; i < LW_LIMBS - 1; i++) u[i] = (u[i] >> s) | (u[i + 1] << (32 - s));
    u[LW_LIMBS - 1] >>= s;
    const uint32_t m = (0u - x[0]) & ((1u << s) - 1u);
    uint32_t y[LW_LIMBS + 1];
    uint64_t c = (uint64_t)x[0] + m;
    y[0] = (uint32_t)c;
#pragma unroll
    for (int i = 1; i < 6; i++) {
        c = (c >> 32) + x[i];
        y[i] = (uint32_t)c;
    }
    c = (c >> 32) + x[6] + 17ull * m;
    y[6] = (uint32_t)c;
    c = (c >> 32) + x[7] + ((uint64_t)m << 27);
    y[7] = (uint32_t)c;
    y[8] = (uint32_t)(c >> 32);
#pragma unroll
    for (int i = 0; i < LW_LIMBS; i++) x[i] = (y[i] >> s) | (y[i + 1] << (32 - s));
    lw_reduce_once(x);
}

// divide u (nonzero) by 2 until it is odd, and x by as many 2s mod p
LW_HD void lw_inv_make_odd(uint32_t u[LW_LIMBS], uint32_t x[LW_LIMBS]) {
    while (!(u[0] & 1u)) lw_inv_shift(u, x, u[0] ? lw_ctz(u[0]) : 31);
}

// a^-1 in Montgomery form (a canonical; 0 gives 0) by the binary extended
// Euclid, variable time (the values are public): u = a, v = p, x1 = R^2
// mod p, x2 = 0 keep x1 a = R^2 u and x2 a = R^2 v (mod p); u and v are
// kept odd, dividing out each run of trailing zeros at once, and the
// larger loses the smaller until one of them is 1, where x1 (or x2) = R^2
// / a, the Montgomery form of (a / R)^-1.  No products.  tools/
// sweep_batch_inverse.py times it in one thread on the card against a
// fixed addition chain for a^(p-2) (266 squarings and 17 products).
LW_HD void lw_mont_inv(const uint32_t a[LW_LIMBS], uint32_t r[LW_LIMBS]) {
    if (lw_is_zero(a)) {
        lw_copy(a, r);
        return;
    }
    const uint32_t r2[LW_LIMBS] = {0x7E000401u, 0xFFFFFD73u, 0x330FFFFFu, 0x00000001u,
                                   0xFF6F8000u, 0xFFFFFFFFu, 0x5E008810u, 0x07FFD4ABu};
    uint32_t u[LW_LIMBS], v[LW_LIMBS], x1[LW_LIMBS], x2[LW_LIMBS], t[LW_LIMBS];
#pragma unroll
    for (int i = 0; i < LW_LIMBS; i++) {
        u[i] = a[i];
        v[i] = lw_p_limb(i);
        x1[i] = r2[i];
        x2[i] = 0;
    }
    lw_inv_make_odd(u, x1);
    // u, v odd and coprime: u = v only at 1, so a difference is never 0
    while (!lw_is_one(u) && !lw_is_one(v)) {
        lw_copy(u, t);
        if (lw_sub_raw(t, v)) {  // u >= v
            lw_copy(t, u);
            lw_sub(x1, x2, x1);
            lw_inv_make_odd(u, x1);
        } else {
            lw_sub_raw(v, u);
            lw_sub(x2, x1, x2);
            lw_inv_make_odd(v, x2);
        }
    }
    lw_copy(lw_is_one(u) ? x1 : x2, r);
}
