// Stark252 Montgomery arithmetic on eight 32-bit limbs: the one
// implementation that field.cu and ntt.cu share.
//
// Replaces the XLA digit core of lambda_elliptic_curves_tpu/ops/limbs.py
// (mont_mul :750, add :600, sub :610, and the lazy variants that
// poly/ntt_pallas.py inlines into its kernel body).  The JAX package works
// on sixteen 16-bit digits because the TPU has no widening multiply; Hopper
// has 32x32->64 products, so a value is eight u32 limbs, least significant
// first.  R = 2^256 as in the JAX package, so a Montgomery value here has
// the same bits as the JAX value.
//
// p = 2^251 + 17*2^192 + 1: limbs {1,0,0,0,0,0,17,0x08000000} and
// -p^-1 mod 2^32 = 0xFFFFFFFF.  Five of p's eight limbs are zero, and the
// reduction's products by them fold away at compile time.  Since 4p < R a
// CIOS product of two values below p stays below 2p, so one conditional
// subtraction makes it canonical.  Every function here is strict: inputs
// and outputs are canonical (< p).
//
// The functions are __host__ __device__ so that the same code can be
// compiled for the host and checked against Python integers without a card.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define LW_HD __host__ __device__ __forceinline__
#else
#define LW_HD static inline
#endif

#define LW_LIMBS 8

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

// CIOS Montgomery product a*b*2^-256 mod p
LW_HD void lw_mont_mul(const uint32_t a[LW_LIMBS], const uint32_t b[LW_LIMBS],
                       uint32_t r[LW_LIMBS]) {
    uint32_t t[LW_LIMBS + 2];
#pragma unroll
    for (int j = 0; j < LW_LIMBS + 2; j++) t[j] = 0;
#pragma unroll
    for (int i = 0; i < LW_LIMBS; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < LW_LIMBS; j++) {
            uint64_t s = (uint64_t)t[j] + (uint64_t)a[j] * b[i] + c;
            t[j] = (uint32_t)s;
            c = s >> 32;
        }
        uint64_t s = (uint64_t)t[LW_LIMBS] + c;
        t[LW_LIMBS] = (uint32_t)s;
        t[LW_LIMBS + 1] = (uint32_t)(s >> 32);
        // m = t0 * (-p^-1) mod 2^32 = -t0
        uint32_t m = 0u - t[0];
        s = (uint64_t)t[0] + (uint64_t)m * lw_p_limb(0);
        c = s >> 32;
#pragma unroll
        for (int j = 1; j < LW_LIMBS; j++) {
            s = (uint64_t)t[j] + (uint64_t)m * lw_p_limb(j) + c;
            t[j - 1] = (uint32_t)s;
            c = s >> 32;
        }
        s = (uint64_t)t[LW_LIMBS] + c;
        t[LW_LIMBS - 1] = (uint32_t)s;
        t[LW_LIMBS] = t[LW_LIMBS + 1] + (uint32_t)(s >> 32);
    }
    // result < 2p < 2^256, so t[LW_LIMBS] is 0 here
#pragma unroll
    for (int j = 0; j < LW_LIMBS; j++) r[j] = t[j];
    lw_reduce_once(r);
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

// a^e for an exponent given as LW_LIMBS little-endian words and its bit
// length (left-to-right square and multiply).  e = 0 gives R mod p, the
// Montgomery one.
LW_HD void lw_mont_pow(const uint32_t a[LW_LIMBS], const uint32_t e[LW_LIMBS],
                       int nbits, uint32_t r[LW_LIMBS]) {
    uint32_t acc[LW_LIMBS];
    lw_mont_one(acc);
    for (int bit = nbits - 1; bit >= 0; bit--) {
        lw_mont_mul(acc, acc, acc);
        if ((e[bit >> 5] >> (bit & 31)) & 1u) lw_mont_mul(acc, a, acc);
    }
#pragma unroll
    for (int i = 0; i < LW_LIMBS; i++) r[i] = acc[i];
}
