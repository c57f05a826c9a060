// Montgomery arithmetic over dense moduli on W 64-bit words (2 W 32-bit
// limbs): BN254 Fr and Fq and BLS12-377 Fr at W = 4, BLS12-377 Fq at
// W = 6.  The product of the curve kernels (kernels 10 and 11), and the
// reference that dense32.cuh's product is held against; kernels 1, 8 and 9
// (ntt.cu's dense entry, dense_field.cu, dense_inverse.cu) run dense32.cuh's
// product and sums on these parameters, and this header's inversion.
//
// Replaces the XLA digit code of lambda_elliptic_curves_tpu/ops/limbs.py for
// these fields (mont_mul :750, mont_square :829, add :600, sub :610, neg
// :624, mont_pow :860) as the reference of dense32.cuh, and is the product
// that the curve kernels run for them.  A value is x * R
// mod p with R = 2^(64 W), the JAX package's R (2^256 for the 4-word
// fields, 2^384 for BLS12-377 Fq's 24 digits), held as 2 W u32 limbs, least
// significant first (the JAX digits' bits); the arithmetic packs them into
// W u64 words.  Every function is strict: canonical in and out.
//
// The product is CIOS Montgomery multiplication on 64-bit words with
// n0 = -p^-1 mod 2^64.  It is plain C++: the high half of a 64x64-bit
// product is __umul64hi on the card and unsigned __int128 on the host, and
// carries are comparisons, not carry-flag instructions, so g++ compiles
// the same code and the host tests (tests/test_torch_bn254.py) run exactly
// what the card runs.  p < 2^(64 W - 2) (254 of 256 bits, 377 of 384), so
// every sum below stays under 2^(64 W) and the CIOS result is below 2p
// before its one conditional subtraction.  The word count is the field's
// (Q::W), so every loop below unrolls to straight-line code.
#pragma once

#include <stdint.h>

#include "mont.cuh"

LW_HD uint64_t lw_dn_mulhi(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
    return __umul64hi(a, b);
#else
    return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

// a * b + c + carry: the low word returned, the high word into carry
LW_HD uint64_t lw_dn_mac(uint64_t a, uint64_t b, uint64_t c, uint64_t& carry) {
    uint64_t lo = a * b, hi = lw_dn_mulhi(a, b);
    lo += c;
    hi += lo < c;
    lo += carry;
    hi += lo < carry;
    carry = hi;
    return lo;
}

// BN254's scalar field Fr (the Plonk field; two-adicity 28)
struct LwBn254FrParams {
    static constexpr int W = 4;
    LW_HDM static constexpr uint64_t p(int i) {
        return i == 0 ? 0x43E1F593F0000001ull : i == 1 ? 0x2833E84879B97091ull
             : i == 2 ? 0xB85045B68181585Dull : 0x30644E72E131A029ull;
    }
    LW_HDM static constexpr uint64_t one(int i) {  // R mod p
        return i == 0 ? 0xAC96341C4FFFFFFBull : i == 1 ? 0x36FC76959F60CD29ull
             : i == 2 ? 0x666EA36F7879462Eull : 0x0E0A77C19A07DF2Full;
    }
    LW_HDM static constexpr uint64_t r2(int i) {  // R^2 mod p
        return i == 0 ? 0x1BB8E645AE216DA7ull : i == 1 ? 0x53FE3AB1E35C59E3ull
             : i == 2 ? 0x8C49833D53BB8085ull : 0x0216D0B17F4E44A5ull;
    }
    static constexpr uint64_t N0 = 0xC2E1F593EFFFFFFFull;  // -p^-1 mod 2^64
};

// BN254's base field Fq (the G1 coordinates)
struct LwBn254FqParams {
    static constexpr int W = 4;
    LW_HDM static constexpr uint64_t p(int i) {
        return i == 0 ? 0x3C208C16D87CFD47ull : i == 1 ? 0x97816A916871CA8Dull
             : i == 2 ? 0xB85045B68181585Dull : 0x30644E72E131A029ull;
    }
    LW_HDM static constexpr uint64_t one(int i) {
        return i == 0 ? 0xD35D438DC58F0D9Dull : i == 1 ? 0x0A78EB28F5C70B3Dull
             : i == 2 ? 0x666EA36F7879462Cull : 0x0E0A77C19A07DF2Full;
    }
    LW_HDM static constexpr uint64_t r2(int i) {
        return i == 0 ? 0xF32CFC5B538AFA89ull : i == 1 ? 0xB5E71911D44501FBull
             : i == 2 ? 0x47AB1EFF0A417FF6ull : 0x06D89F71CAB8351Full;
    }
    static constexpr uint64_t N0 = 0x87D20782E4866389ull;
};

// BLS12-377's scalar field Fr (the Groth16 field; 253 bits, two-adicity 47)
struct LwBls12377FrParams {
    static constexpr int W = 4;
    LW_HDM static constexpr uint64_t p(int i) {
        return i == 0 ? 0x0A11800000000001ull : i == 1 ? 0x59AA76FED0000001ull
             : i == 2 ? 0x60B44D1E5C37B001ull : 0x12AB655E9A2CA556ull;
    }
    LW_HDM static constexpr uint64_t one(int i) {
        return i == 0 ? 0x7D1C7FFFFFFFFFF3ull : i == 1 ? 0x7257F50F6FFFFFF2ull
             : i == 2 ? 0x16D81575512C0FEEull : 0x0D4BDA322BBB9A9Dull;
    }
    LW_HDM static constexpr uint64_t r2(int i) {
        return i == 0 ? 0x25D577BAB861857Bull : i == 1 ? 0xCC2C27B58860591Full
             : i == 2 ? 0xA7CC008FE5DC8593ull : 0x011FDAE7EFF1C939ull;
    }
    static constexpr uint64_t N0 = 0x0A117FFFFFFFFFFFull;
};

// BLS12-377's base field Fq (the G1 and G2 coordinates; 377 bits, six
// words, R = 2^384)
struct LwBls12377FqParams {
    static constexpr int W = 6;
    LW_HDM static constexpr uint64_t p(int i) {
        return i == 0 ? 0x8508C00000000001ull : i == 1 ? 0x170B5D4430000000ull
             : i == 2 ? 0x1EF3622FBA094800ull : i == 3 ? 0x1A22D9F300F5138Full
             : i == 4 ? 0xC63B05C06CA1493Bull : 0x01AE3A4617C510EAull;
    }
    LW_HDM static constexpr uint64_t one(int i) {
        return i == 0 ? 0x02CDFFFFFFFFFF68ull : i == 1 ? 0x51409F837FFFFFB1ull
             : i == 2 ? 0x9F7DB3A98A7D3FF2ull : i == 3 ? 0x7B4E97B76E7C6305ull
             : i == 4 ? 0x4CF495BF803C84E8ull : 0x008D6661E2FDF49Aull;
    }
    LW_HDM static constexpr uint64_t r2(int i) {
        return i == 0 ? 0xB786686C9400CD22ull : i == 1 ? 0x0329FCAAB00431B1ull
             : i == 2 ? 0x22A5F11162D6B46Dull : i == 3 ? 0xBFDF7D03827DC3ACull
             : i == 4 ? 0x837E92F041790BF9ull : 0x006DFCCB1E914B88ull;
    }
    static constexpr uint64_t N0 = 0x8508BFFFFFFFFFFFull;
};

// The field interface that the curve kernels take (as LwStark252 in
// mont.cuh): mul, butterfly, one, inv on LIMBS = 2 W u32
// limbs; dense32.cuh's LwDense32 derives from it.
template <class Q>
struct LwDense {
    static constexpr int W = Q::W;
    static constexpr int LIMBS = 2 * W;
    static_assert(W == 4 || W == 6, "dense fields on four or six words");

    LW_HDM static void pack(const uint32_t a[LIMBS], uint64_t w[W]) {
#pragma unroll
        for (int i = 0; i < W; i++) w[i] = (uint64_t)a[2 * i] | ((uint64_t)a[2 * i + 1] << 32);
    }
    LW_HDM static void unpack(const uint64_t w[W], uint32_t a[LIMBS]) {
#pragma unroll
        for (int i = 0; i < W; i++) {
            a[2 * i] = (uint32_t)w[i];
            a[2 * i + 1] = (uint32_t)(w[i] >> 32);
        }
    }
    // w - p when w >= p, else w (w < 2^(64 W))
    LW_HDM static void reduce_once(uint64_t w[W]) {
        uint64_t d[W], borrow = 0;
#pragma unroll
        for (int i = 0; i < W; i++) {
            const uint64_t pi = Q::p(i);
            const uint64_t t = w[i] - pi;
            const uint64_t b1 = w[i] < pi;
            d[i] = t - borrow;
            borrow = b1 | (t < borrow);
        }
        if (!borrow) {
#pragma unroll
            for (int i = 0; i < W; i++) w[i] = d[i];
        }
    }
    LW_HDM static void add_w(const uint64_t a[W], const uint64_t b[W], uint64_t r[W]) {
        uint64_t carry = 0;
#pragma unroll
        for (int i = 0; i < W; i++) {
            const uint64_t s = a[i] + carry;
            const uint64_t c1 = s < carry;
            r[i] = s + b[i];
            carry = c1 | (r[i] < b[i]);
        }
        reduce_once(r);  // a + b < 2p < 2^(64 W - 1): no carry out
    }
    LW_HDM static void sub_w(const uint64_t a[W], const uint64_t b[W], uint64_t r[W]) {
        uint64_t borrow = 0;
#pragma unroll
        for (int i = 0; i < W; i++) {
            const uint64_t t = a[i] - b[i];
            const uint64_t b1 = a[i] < b[i];
            r[i] = t - borrow;
            borrow = b1 | (t < borrow);
        }
        if (borrow) {  // a < b: add p back (wraps to the right value)
            uint64_t carry = 0;
#pragma unroll
            for (int i = 0; i < W; i++) {
                const uint64_t s = r[i] + carry;
                const uint64_t c1 = s < carry;
                r[i] = s + Q::p(i);
                carry = c1 | (r[i] < Q::p(i));
            }
        }
    }
    // CIOS: a * b * 2^(-64 W) mod p
    LW_HDM static void mul_w(const uint64_t a[W], const uint64_t b[W], uint64_t r[W]) {
        uint64_t t[W + 1] = {};
#pragma unroll
        for (int i = 0; i < W; i++) {
            uint64_t c = 0;
#pragma unroll
            for (int j = 0; j < W; j++) t[j] = lw_dn_mac(a[j], b[i], t[j], c);
            const uint64_t tw = t[W] + c;
            const uint64_t tw1 = tw < c;
            const uint64_t m = t[0] * Q::N0;
            c = 0;
            (void)lw_dn_mac(m, Q::p(0), t[0], c);
#pragma unroll
            for (int j = 1; j < W; j++) t[j - 1] = lw_dn_mac(m, Q::p(j), t[j], c);
            t[W - 1] = tw + c;
            t[W] = tw1 + (t[W - 1] < c);
        }
        // t < 2p < 2^(64 W - 1): t[W] is 0
#pragma unroll
        for (int i = 0; i < W; i++) r[i] = t[i];
        reduce_once(r);
    }

    LW_HDM static void mul(const uint32_t a[LIMBS], const uint32_t b[LIMBS],
                           uint32_t r[LIMBS]) {
        uint64_t x[W], y[W], z[W];
        pack(a, x);
        pack(b, y);
        mul_w(x, y, z);
        unpack(z, r);
    }
    LW_HDM static void add(const uint32_t a[LIMBS], const uint32_t b[LIMBS],
                           uint32_t r[LIMBS]) {
        uint64_t x[W], y[W], z[W];
        pack(a, x);
        pack(b, y);
        add_w(x, y, z);
        unpack(z, r);
    }
    LW_HDM static void sub(const uint32_t a[LIMBS], const uint32_t b[LIMBS],
                           uint32_t r[LIMBS]) {
        uint64_t x[W], y[W], z[W];
        pack(a, x);
        pack(b, y);
        sub_w(x, y, z);
        unpack(z, r);
    }
    LW_HDM static void neg(const uint32_t a[LIMBS], uint32_t r[LIMBS]) {
        const uint32_t zero[LIMBS] = {};
        sub(zero, a, r);
    }
    // u, v <- u + v, u - v
    LW_HDM static void butterfly(uint32_t u[LIMBS], uint32_t v[LIMBS]) {
        uint64_t x[W], y[W], s[W], d[W];
        pack(u, x);
        pack(v, y);
        add_w(x, y, s);
        sub_w(x, y, d);
        unpack(s, u);
        unpack(d, v);
    }
    LW_HDM static void one(uint32_t r[LIMBS]) {
        uint64_t w[W];
#pragma unroll
        for (int i = 0; i < W; i++) w[i] = Q::one(i);
        unpack(w, r);
    }
    // a^e, e as little-endian u32 words and its bit length (left to
    // right square and multiply; e = 0 gives the Montgomery one)
    LW_HDM static void pow(const uint32_t a[LIMBS], const uint32_t e[LIMBS], int nbits,
                           uint32_t r[LIMBS]) {
        uint64_t x[W], acc[W];
        pack(a, x);
#pragma unroll
        for (int i = 0; i < W; i++) acc[i] = Q::one(i);
        for (int bit = nbits - 1; bit >= 0; bit--) {
            mul_w(acc, acc, acc);
            if ((e[bit >> 5] >> (bit & 31)) & 1u) mul_w(acc, x, acc);
        }
        unpack(acc, r);
    }

    // whether w is 0, or 1: the 4-word expressions are the ones the BN254
    // kernels were first compiled from, so their machine code stays the same
    LW_HDM static bool w_is_zero(const uint64_t w[W]) {
        if constexpr (W == 4) return (w[0] | w[1] | w[2] | w[3]) == 0;
        else return (w[0] | w[1] | w[2] | w[3] | w[4] | w[5]) == 0;
    }
    LW_HDM static bool w_is_one(const uint64_t w[W]) {
        if constexpr (W == 4) return w[0] == 1 && (w[1] | w[2] | w[3]) == 0;
        else return w[0] == 1 && (w[1] | w[2] | w[3] | w[4] | w[5]) == 0;
    }
    // w >>= 1 and x <- x / 2 mod p (x < p, so x + p < 2^(64 W - 1))
    LW_HDM static void halve(uint64_t w[W], uint64_t x[W]) {
#pragma unroll
        for (int i = 0; i < W - 1; i++) w[i] = (w[i] >> 1) | (w[i + 1] << 63);
        w[W - 1] >>= 1;
        if (x[0] & 1) {
            uint64_t carry = 0;
#pragma unroll
            for (int i = 0; i < W; i++) {
                const uint64_t s = x[i] + carry;
                const uint64_t c1 = s < carry;
                x[i] = s + Q::p(i);
                carry = c1 | (x[i] < Q::p(i));
            }
        }
#pragma unroll
        for (int i = 0; i < W - 1; i++) x[i] = (x[i] >> 1) | (x[i + 1] << 63);
        x[W - 1] >>= 1;
    }
    // a -= b, and whether a >= b
    LW_HDM static bool sub_raw(uint64_t a[W], const uint64_t b[W]) {
        uint64_t borrow = 0;
#pragma unroll
        for (int i = 0; i < W; i++) {
            const uint64_t t = a[i] - b[i];
            const uint64_t b1 = a[i] < b[i];
            a[i] = t - borrow;
            borrow = b1 | (t < borrow);
        }
        return borrow == 0;
    }
    // a^-1 in Montgomery form (0 gives 0) by the binary extended Euclid,
    // variable time (the values are public): u = a, v = p, x1 = R^2, x2 = 0
    // keep x1 a = R^2 u and x2 a = R^2 v (mod p); at u = 1, x1 = R^2 / a,
    // the Montgomery form of (a / R)^-1.  One bit a step, no products.
    LW_HDM static void inv(const uint32_t a[LIMBS], uint32_t r[LIMBS]) {
        uint64_t u[W], v[W], x1[W], x2[W], t[W];
        pack(a, u);
        if (w_is_zero(u)) {
            unpack(u, r);
            return;
        }
#pragma unroll
        for (int i = 0; i < W; i++) {
            v[i] = Q::p(i);
            x1[i] = Q::r2(i);
            x2[i] = 0;
        }
        while (!w_is_one(u) && !w_is_one(v)) {
            while (!(u[0] & 1)) halve(u, x1);
            while (!(v[0] & 1)) halve(v, x2);
            if (w_is_one(u) || w_is_one(v)) break;
#pragma unroll
            for (int i = 0; i < W; i++) t[i] = u[i];
            if (sub_raw(t, v)) {  // u >= v (odd and coprime: never equal)
#pragma unroll
                for (int i = 0; i < W; i++) u[i] = t[i];
                sub_w(x1, x2, x1);
            } else {
                sub_raw(v, u);
                sub_w(x2, x1, x2);
            }
        }
        unpack(w_is_one(u) ? x1 : x2, r);
    }
};

typedef LwDense<LwBn254FrParams> LwBn254Fr;
typedef LwDense<LwBn254FqParams> LwBn254Fq;
typedef LwDense<LwBls12377FrParams> LwBls12377Fr;
typedef LwDense<LwBls12377FqParams> LwBls12377Fq;

// the fields' numbers in the C entries of the dense kernels
enum { LW_DENSE_BN254_FR = 0, LW_DENSE_BN254_FQ = 1, LW_DENSE_BLS12_377_FR = 2,
       LW_DENSE_BLS12_377_FQ = 3 };
// the most 32-bit limbs of a dense field (BLS12-377 Fq)
#define LW_DENSE_MAX_LIMBS 12
