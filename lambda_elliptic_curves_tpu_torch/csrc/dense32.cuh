// Montgomery arithmetic over the dense moduli of dense.cuh, written for the
// card: 2 W 32-bit limbs in the card's carry-chain multiply-adds.  Kernel 1
// over BN254 Fr and BLS12-377 Fr (ntt.cu's dense entry, ntt_dense.cuh),
// kernels 8 and 9 over the four dense fields (dense_field.cu,
// dense_inverse.cu) and the curve kernels 10 and 11 (curve.cuh's group
// law) run on it; dense.cuh's CIOS on 64-bit words stays the reference
// that this product is held against (tools/dense_mul.py, on the card and
// with g++).
//
// Why not dense.cuh's product on the card: sm_90 has no 64-bit multiplier,
// so each of its 32 64x64-bit products is several 32-bit multiply-adds and
// __umul64hi, and every carry is a compare.  Here the a * b_i row and the
// m * p row are each two chains of 32-bit multiply-adds with the carry flag
// (mad.lo.cc / madc.hi.cc: one instruction a half product, no compares).
//
// The even / odd split: a * b_i over the even limbs a_0, a_2, .. puts each
// 64-bit product a_j b_i at limbs j and j + 1 without overlap, so one
// carry chain of n instructions adds it to an accumulator E; the odd limbs
// go the same way to a second accumulator O of weight 2^32.  The running
// value is T = E + O 2^32.  After m = E_0 (-p^-1) mod 2^32 and m p added
// the same way, E_0 = 0 and T / 2^32 = O + E_1 + (E >> 64) 2^32: O is the
// next step's E (E_1 added to its lowest limb, whose carry goes into the
// next odd chain) and E >> 64 the next step's O, added in the same chain
// as the next odd products.  The two chains of a step are independent, so
// the card can issue them side by side.
//
// No chain loses a carry: with p < 2^(32 n - 1), a, b < p, CIOS keeps T /
// 2^32 < 2p after every step, and each accumulator, read as an integer,
// stays below T / 2^32 < 2^(32 n) (the chains whose carry out is dropped
// are those whose sum the bound already holds below 2^(32 n)).  The result
// E + (O >> 32) < 2p, then one conditional subtraction: strict, canonical
// in and out, bitwise equal to dense.cuh's product.
//
// Chosen over dense.cuh's product and over the same CIOS in plain C++ with
// 64-bit accumulators (32 x 32 -> 64-bit products, carries in the
// accumulator's high word) by SASS count, registers and a timed chain of
// products (tools/dense_mul.py; the numbers are in PERF.md): the compiler
// fuses each lo / hi pair of a chain into one IMAD.WIDE.U32.X where it
// can.
//
// On the host the carry flag is mont.cuh's emulation, so g++ compiles the
// same sequence (tests/test_torch_bn254.py, test_torch_bls12_377.py); the
// emulation once passed code that failed on the card (ROADMAP queue 3), so
// the card's check against dense.cuh's product is the one that counts.
#pragma once

#include <stdint.h>

#include "dense.cuh"

LW_HD uint32_t lw_d32_mulhi(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
    return __umulhi(a, b);
#else
    return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// limb i of p (and of the constant 2^(32 n) - p that subtracts p)
template <class Q>
LW_HD constexpr uint32_t lw_d32_p(int i) {
    return (uint32_t)(Q::p(i >> 1) >> (32 * (i & 1)));
}
template <class Q>
LW_HD constexpr uint32_t lw_d32_minus_p(int i) {  // limb i of 2^(64 W) - p (p odd)
    return i == 0 ? 0u - lw_d32_p<Q>(0) : ~lw_d32_p<Q>(i);
}

// acc = a_0 b, a_2 b, ..: the even limbs' products, side by side (no carry)
template <int N>
LW_HD void lw_d32_mul_even(uint32_t acc[N], const uint32_t* a, uint32_t b) {
#pragma unroll
    for (int j = 0; j < N; j += 2) {
        acc[j] = a[j] * b;
        acc[j + 1] = lw_d32_mulhi(a[j], b);
    }
}

// acc += a_0 b, a_2 b, ..; the carry out is left in the flag
template <int N>
LW_HD void lw_d32_mad_even(uint32_t acc[N], const uint32_t* a, uint32_t b) {
    acc[0] = lw_mad_lo_cc(a[0], b, acc[0]);
    acc[1] = lw_madc_hi_cc(a[0], b, acc[1]);
#pragma unroll
    for (int j = 2; j < N; j += 2) {
        acc[j] = lw_madc_lo_cc(a[j], b, acc[j]);
        acc[j + 1] = lw_madc_hi_cc(a[j], b, acc[j + 1]);
    }
}

// acc = (acc >> 64) + a_0 b, a_2 b, .. + the flag (no carry out)
template <int N>
LW_HD void lw_d32_madc_even_shift(uint32_t acc[N], const uint32_t* a, uint32_t b) {
#pragma unroll
    for (int j = 0; j < N - 2; j += 2) {
        acc[j] = lw_madc_lo_cc(a[j], b, acc[j + 2]);
        acc[j + 1] = lw_madc_hi_cc(a[j], b, acc[j + 3]);
    }
    acc[N - 2] = lw_madc_lo_cc(a[N - 2], b, 0u);
    acc[N - 1] = lw_madc_hi(a[N - 2], b, 0u);
}

// One step of the product: T <- (T + a b_i + m p) / 2^32 on T = E + O 2^32;
// after it the step's E is O's role and O is E's (the caller swaps them).
template <class Q, int N>
LW_HD void lw_d32_step(uint32_t E[N], uint32_t O[N], const uint32_t a[N], uint32_t bi,
                       bool first) {
    if (first) {
        lw_d32_mul_even<N>(O, a + 1, bi);
        lw_d32_mul_even<N>(E, a, bi);
    } else {
        E[0] = lw_add_cc(E[0], O[1]);
        lw_d32_madc_even_shift<N>(O, a + 1, bi);
        lw_d32_mad_even<N>(E, a, bi);
        O[N - 1] = lw_addc(O[N - 1], 0u);
    }
    uint32_t pl[N];
#pragma unroll
    for (int j = 0; j < N; j++) pl[j] = lw_d32_p<Q>(j);
    const uint32_t m = E[0] * (uint32_t)Q::N0;
    lw_d32_mad_even<N>(O, pl + 1, m);
    lw_d32_mad_even<N>(E, pl, m);
    O[N - 1] = lw_addc(O[N - 1], 0u);
}

// r - p when r >= p, else r (r < 2p < 2^(32 n))
template <class Q, int N>
LW_HD void lw_d32_reduce_once(uint32_t r[N]) {
    uint32_t d[N];
    d[0] = lw_add_cc(r[0], lw_d32_minus_p<Q>(0));
#pragma unroll
    for (int k = 1; k < N; k++) d[k] = lw_addc_cc(r[k], lw_d32_minus_p<Q>(k));
    const uint32_t take = 0u - lw_addc(0u, 0u);  // all ones if r >= p
#pragma unroll
    for (int k = 0; k < N; k++) r[k] = (d[k] & take) | (r[k] & ~take);
}

// a * b * 2^(-32 n) mod p on n = 2 W limbs (r may alias a or b)
template <class Q>
LW_HD void lw_d32_mul(const uint32_t* a, const uint32_t* b, uint32_t* r) {
    constexpr int N = 2 * Q::W;
    uint32_t E[N], O[N], bb[N];
#pragma unroll
    for (int i = 0; i < N; i++) bb[i] = b[i];
#pragma unroll
    for (int i = 0; i < N; i += 2) {
        lw_d32_step<Q, N>(E, O, a, bb[i], i == 0);
        lw_d32_step<Q, N>(O, E, a, bb[i + 1], false);
    }
    // T = O + E 2^32 with O_0 = 0: T / 2^32 = E + (O >> 32)
    E[0] = lw_add_cc(E[0], O[1]);
#pragma unroll
    for (int i = 1; i < N - 1; i++) E[i] = lw_addc_cc(E[i], O[i + 1]);
    E[N - 1] = lw_addc(E[N - 1], 0u);
    lw_d32_reduce_once<Q, N>(E);
#pragma unroll
    for (int i = 0; i < N; i++) r[i] = E[i];
}

// r = a + b (canonical in and out) in a carry chain: a + b < 2p, then
// + (2^(32 n) - p) taken when it carries out (r may alias a or b)
template <class Q>
LW_HD void lw_d32_add(const uint32_t* a, const uint32_t* b, uint32_t* r) {
    constexpr int N = 2 * Q::W;
    uint32_t s[N];
    s[0] = lw_add_cc(a[0], b[0]);
#pragma unroll
    for (int k = 1; k < N; k++) s[k] = lw_addc_cc(a[k], b[k]);
    lw_d32_reduce_once<Q, N>(s);
#pragma unroll
    for (int k = 0; k < N; k++) r[k] = s[k];
}

// r = a - b (canonical in and out): a + ~b + 1, then + p when that does
// not carry out (a < b); r may alias a or b
template <class Q>
LW_HD void lw_d32_sub(const uint32_t* a, const uint32_t* b, uint32_t* r) {
    constexpr int N = 2 * Q::W;
    uint32_t d[N];
    (void)lw_add_cc(0xFFFFFFFFu, 1u);  // the flag set: the + 1 of a + ~b + 1
#pragma unroll
    for (int k = 0; k < N; k++) d[k] = lw_addc_cc(a[k], ~b[k]);
    const uint32_t add_p = lw_addc(0u, 0u) - 1u;  // all ones if a < b
    r[0] = lw_add_cc(d[0], add_p & lw_d32_p<Q>(0));
#pragma unroll
    for (int k = 1; k < N - 1; k++) r[k] = lw_addc_cc(d[k], add_p & lw_d32_p<Q>(k));
    r[N - 1] = lw_addc(d[N - 1], add_p & lw_d32_p<Q>(N - 1));
}

// u, v <- u + v, u - v, the two chains above one after the other
template <class Q>
LW_HD void lw_d32_butterfly(uint32_t* u, uint32_t* v) {
    constexpr int N = 2 * Q::W;
    uint32_t s[N];
    lw_d32_add<Q>(u, v, s);
    lw_d32_sub<Q>(u, v, v);
#pragma unroll
    for (int k = 0; k < N; k++) u[k] = s[k];
}

// The field interface of ntt_dense.cuh and of kernels 8 and 9
// (dense_field.cuh, dense_inverse.cuh): LwDense<Q>'s, with this header's
// product, sums and butterfly in place of its 64-bit ones; inv stays
// LwDense<Q>'s binary Euclid (no products)
template <class Q>
struct LwDense32 : LwDense<Q> {
    static constexpr int LIMBS = 2 * Q::W;
    LW_HDM static void mul(const uint32_t a[LIMBS], const uint32_t b[LIMBS],
                           uint32_t r[LIMBS]) {
        lw_d32_mul<Q>(a, b, r);
    }
    LW_HDM static void add(const uint32_t a[LIMBS], const uint32_t b[LIMBS],
                           uint32_t r[LIMBS]) {
        lw_d32_add<Q>(a, b, r);
    }
    LW_HDM static void sub(const uint32_t a[LIMBS], const uint32_t b[LIMBS],
                           uint32_t r[LIMBS]) {
        lw_d32_sub<Q>(a, b, r);
    }
    LW_HDM static void neg(const uint32_t a[LIMBS], uint32_t r[LIMBS]) {
        const uint32_t zero[LIMBS] = {};
        lw_d32_sub<Q>(zero, a, r);
    }
    LW_HDM static void butterfly(uint32_t u[LIMBS], uint32_t v[LIMBS]) {
        lw_d32_butterfly<Q>(u, v);
    }
    // a^e, e as little-endian u32 words and its bit length (left to right
    // square and multiply; e = 0 gives the Montgomery one)
    LW_HDM static void pow(const uint32_t a[LIMBS], const uint32_t e[LIMBS], int nbits,
                           uint32_t r[LIMBS]) {
        uint32_t x[LIMBS], acc[LIMBS];
#pragma unroll
        for (int k = 0; k < LIMBS; k++) x[k] = a[k];
        LwDense<Q>::one(acc);
        for (int bit = nbits - 1; bit >= 0; bit--) {
            lw_d32_mul<Q>(acc, acc, acc);
            if ((e[bit >> 5] >> (bit & 31)) & 1u) lw_d32_mul<Q>(acc, x, acc);
        }
#pragma unroll
        for (int k = 0; k < LIMBS; k++) r[k] = acc[k];
    }
};

typedef LwDense32<LwBn254FrParams> LwBn254Fr32;
typedef LwDense32<LwBn254FqParams> LwBn254Fq32;
typedef LwDense32<LwBls12377FrParams> LwBls12377Fr32;
typedef LwDense32<LwBls12377FqParams> LwBls12377Fq32;
