// One Stockham pass of the Stark252 NTT, as the work of one thread block:
// the body of ntt_pass_kernel (ntt.cu).
//
// Each loop below runs `for (idx = tid; idx < count; idx += nt)`, and no two
// iterations of one loop touch the same shared-memory word, so the same
// function compiled for the host with tid = 0, nt = 1 (and LW_NTT_SYNC a
// no-op) computes what the block computes: tests/test_torch_ntt_pass.py
// builds it with g++ and holds it against ntt_pass_plain.
//
// The pass (poly/ntt.py): radix r = 2^s, Ns = 2^ns_log the product of the
// earlier radices, N = 2^log_n points per row, cols = N / r columns per row.
// Column j of a row reads x[j + t*cols] for t < r, multiplies point t by the
// twist w^((j mod Ns) * t * N / (Ns r)), runs a DFT of r points (radix-2 DIT
// stages from bit-reversed positions, two stages per synchronisation) and
// writes point k to (j div Ns)*Ns*r + (j mod Ns) + k*Ns.  A block takes C =
// 2^log_c consecutive columns (of the rows laid end to end), so every read
// and write touches runs of consecutive words in every limb plane.
//
// Shared memory, in 32-bit words: the tile [8][r][C + 1] (one pad column,
// so that threads walking the r axis meet distinct banks), the DFT's roots
// w_r^u for u < r/2 [r/2][8], and per column the twist tables
// Z_lo[c][u] = z_c^u, u < 2^a, and Z_hi[c][v] = z_c^(v 2^a), v < 2^(s-a),
// a = ceil(s/2), z_c = w^((j mod Ns) N / (Ns r)); the twist of point t is
// Z_hi[t >> a] * Z_lo[t mod 2^a].  Every table entry is one product of
// the two global root tables: w^e = T_hi[e >> h] * T_lo[e mod 2^h].
#pragma once

#include <stdint.h>

#include "mont.cuh"

#ifdef __CUDA_ARCH__
#define LW_NTT_SYNC() __syncthreads()
#else
#define LW_NTT_SYNC() ((void)0)
#endif

struct LwNttPass {
    const uint32_t* x;     // (8, rows, N) canonical Montgomery limbs
    uint32_t* out;         // (8, rows, N), distinct from x
    const uint32_t* t_lo;  // [2^h][8]: w^a
    const uint32_t* t_hi;  // [2^(log_n - h)][8]: w^(b 2^h)
    long rows;
    int log_n, ns_log, s, log_c;
};

// The pass's arithmetic (lw_ntt_mul, lw_ntt_butterfly): the product a*b
// in 64-bit multiply-adds, then the Montgomery reduction and the sums in
// the card's carry-chain instructions (mad.lo/hi and add with carry in
// and out), p's sparse limbs (m*p = m + 17m*2^192 + m*2^251) folded into
// a few words.  On the host each carry instruction is emulated with a
// carry flag, so the host tests run the same sequence of values; they do
// not show that the card's carry flag behaves as the emulation's does
// (the card's kernel tests check that).

#ifdef __CUDA_ARCH__
#define LW_NTT_ASM3(name, op)                                                   \
    __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b, uint32_t c) { \
        uint32_t d;                                                             \
        asm volatile(op " %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));  \
        return d;                                                               \
    }
#define LW_NTT_ASM2(name, op)                                                   \
    __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {           \
        uint32_t d;                                                             \
        asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));              \
        return d;                                                               \
    }
LW_NTT_ASM3(lw_mad_lo_cc, "mad.lo.cc.u32")
LW_NTT_ASM3(lw_madc_lo_cc, "madc.lo.cc.u32")
LW_NTT_ASM3(lw_mad_hi_cc, "mad.hi.cc.u32")
LW_NTT_ASM3(lw_madc_hi_cc, "madc.hi.cc.u32")
LW_NTT_ASM2(lw_add_cc, "add.cc.u32")
LW_NTT_ASM2(lw_addc_cc, "addc.cc.u32")
LW_NTT_ASM2(lw_addc, "addc.u32")
#else
static uint32_t lw_ntt_cf;  // the emulated carry flag
static inline uint32_t lw_ntt_set(uint64_t v) {
    lw_ntt_cf = (uint32_t)(v >> 32);
    return (uint32_t)v;
}
static inline uint32_t lw_mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return lw_ntt_set((uint64_t)(uint32_t)(a * b) + c);
}
static inline uint32_t lw_madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return lw_ntt_set((uint64_t)(uint32_t)(a * b) + c + lw_ntt_cf);
}
static inline uint32_t lw_mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return lw_ntt_set((((uint64_t)a * b) >> 32) + c);
}
static inline uint32_t lw_madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return lw_ntt_set((((uint64_t)a * b) >> 32) + c + lw_ntt_cf);
}
static inline uint32_t lw_add_cc(uint32_t a, uint32_t b) {
    return lw_ntt_set((uint64_t)a + b);
}
static inline uint32_t lw_addc_cc(uint32_t a, uint32_t b) {
    return lw_ntt_set((uint64_t)a + b + lw_ntt_cf);
}
static inline uint32_t lw_addc(uint32_t a, uint32_t b) { return a + b + lw_ntt_cf; }
#endif

// a*b*2^-256 mod p for canonical a, b: the same value as lw_mont_mul
LW_HD void lw_ntt_mul(const uint32_t a[LW_LIMBS], const uint32_t b[LW_LIMBS],
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

LW_HD int lw_ntt_twist_split(int s) { return (s + 1) >> 1; }

// words of shared memory that one block of the pass takes
LW_HD long lw_ntt_pass_smem_words(int s, int log_c) {
    const long r = 1L << s, c = 1L << log_c;
    const int a = lw_ntt_twist_split(s);
    return LW_LIMBS * (r * (c + 1) + (r >> 1) + (c << a) + (c << (s - a)));
}

LW_HD int lw_ntt_brev(int t, int s) {
#ifdef __CUDA_ARCH__
    return (int)(__brev((unsigned)t) >> (32 - s));
#else
    int r = 0;
    for (int b = 0; b < s; b++) r |= ((t >> b) & 1) << (s - 1 - b);
    return r;
#endif
}

LW_HD void lw_ntt_load(const uint32_t* p, uint32_t v[LW_LIMBS]) {
#pragma unroll
    for (int k = 0; k < LW_LIMBS; k++) v[k] = p[k];
}

// w^e for e < 2^log_n, into r[8]: one product of the two table entries
LW_HD void lw_ntt_twiddle(const LwNttPass& P, uint64_t e, uint32_t r[LW_LIMBS]) {
    const int h = (P.log_n + 1) >> 1;
    uint32_t hi[LW_LIMBS], lo[LW_LIMBS];
    lw_ntt_load(P.t_hi + LW_LIMBS * (e >> h), hi);
    lw_ntt_load(P.t_lo + LW_LIMBS * (e & ((1ull << h) - 1)), lo);
    lw_ntt_mul(hi, lo, r);
}

// point `pos` of column c of the tile, limb by limb (stride (r)(C+1))
LW_HD void lw_ntt_tile_get(const uint32_t* tile, int r, int cs, int pos, int c,
                           uint32_t v[LW_LIMBS]) {
#pragma unroll
    for (int k = 0; k < LW_LIMBS; k++) v[k] = tile[(k * r + pos) * cs + c];
}

LW_HD void lw_ntt_tile_put(uint32_t* tile, int r, int cs, int pos, int c,
                           const uint32_t v[LW_LIMBS]) {
#pragma unroll
    for (int k = 0; k < LW_LIMBS; k++) tile[(k * r + pos) * cs + c] = v[k];
}

// u, v <- u + v, u - v (canonical in and out): u + v, then + (2^256 - p)
// taken when that carries out; u + ~v + 1, then + p when that does not
LW_HD void lw_ntt_butterfly(uint32_t u[LW_LIMBS], uint32_t v[LW_LIMBS]) {
    uint32_t s[LW_LIMBS], d[LW_LIMBS];
    s[0] = lw_add_cc(u[0], v[0]);  // u + v < 2p < 2^256
#pragma unroll
    for (int k = 1; k < LW_LIMBS; k++) s[k] = lw_addc_cc(u[k], v[k]);
    d[0] = lw_add_cc(s[0], 0xFFFFFFFFu);  // s - p = s + (2^256 - p)
#pragma unroll
    for (int k = 1; k < 6; k++) d[k] = lw_addc_cc(s[k], 0xFFFFFFFFu);
    d[6] = lw_addc_cc(s[6], 0xFFFFFFEEu);
    d[7] = lw_addc_cc(s[7], 0xF7FFFFFFu);
    const uint32_t take = 0u - lw_addc(0, 0);  // all ones if s >= p
#pragma unroll
    for (int k = 0; k < LW_LIMBS; k++) s[k] = (d[k] & take) | (s[k] & ~take);
    // u - v = u + ~v + 1 (the 1 as carry in), which carries out unless u < v
    (void)lw_add_cc(0xFFFFFFFFu, 1u);
#pragma unroll
    for (int k = 0; k < LW_LIMBS; k++) d[k] = lw_addc_cc(u[k], ~v[k]);
    const uint32_t add_p = lw_addc(0, 0) - 1u;  // all ones if u < v
    v[0] = lw_add_cc(d[0], add_p & 1u);
#pragma unroll
    for (int k = 1; k < 6; k++) v[k] = lw_addc_cc(d[k], 0);
    v[6] = lw_addc_cc(d[6], add_p & 17u);
    v[7] = lw_addc(d[7], add_p & 0x08000000u);
#pragma unroll
    for (int k = 0; k < LW_LIMBS; k++) u[k] = s[k];
}

LW_HD void lw_ntt_pass_block(const LwNttPass& P, long block, int tid, int nt,
                             uint32_t* sm) {
    const int s = P.s, r = 1 << s, C = 1 << P.log_c, cs = C + 1;
    const int a = lw_ntt_twist_split(s);
    const int log_cols = P.log_n - s;
    const long n = 1L << P.log_n, plane = P.rows * n;
    const long cols_mask = (1L << log_cols) - 1, ns_mask = (1L << P.ns_log) - 1;
    const long total = P.rows << log_cols;
    const long col0 = block << P.log_c;
    const bool twist = P.ns_log > 0;
    const int shift = P.log_n - P.ns_log - s;  // twist root w^(N / (Ns r))
    uint32_t* tile = sm;
    uint32_t* w_r = tile + LW_LIMBS * r * cs;
    uint32_t* z_lo = w_r + LW_LIMBS * (r >> 1);
    uint32_t* z_hi = z_lo + ((long)LW_LIMBS * C << a);

    // tables: the DFT's roots, and each column's twist powers
    for (int u = tid; u < (r >> 1); u += nt)
        lw_ntt_twiddle(P, (uint64_t)u << log_cols, w_r + LW_LIMBS * u);
    if (twist) {
        for (int idx = tid; idx < (C << a); idx += nt) {
            const uint64_t i = (uint64_t)((col0 + (idx >> a)) & ns_mask);
            const uint64_t u = (uint64_t)(idx & ((1 << a) - 1));
            lw_ntt_twiddle(P, (i * u) << shift, z_lo + LW_LIMBS * idx);
        }
        for (int idx = tid; idx < (C << (s - a)); idx += nt) {
            const uint64_t i = (uint64_t)((col0 + (idx >> (s - a))) & ns_mask);
            const uint64_t v = (uint64_t)(idx & ((1 << (s - a)) - 1));
            lw_ntt_twiddle(P, (i * v) << (a + shift), z_hi + LW_LIMBS * idx);
        }
    }
    LW_NTT_SYNC();

    // load column c's point t (neighbouring threads: neighbouring columns),
    // twist it, and put it at the bit-reversed position of t
    for (int idx = tid; idx < (C << s); idx += nt) {
        const int c = idx & (C - 1), t = idx >> P.log_c;
        const long J = col0 + c;
        if (J >= total) continue;
        const long src = (J >> log_cols) * n + (J & cols_mask) + ((long)t << log_cols);
        uint32_t v[LW_LIMBS];
#pragma unroll
        for (int k = 0; k < LW_LIMBS; k++) v[k] = P.x[k * plane + src];
        if (twist) {
            uint32_t zh[LW_LIMBS], zl[LW_LIMBS], w[LW_LIMBS];
            lw_ntt_load(z_hi + LW_LIMBS * ((c << (s - a)) + (t >> a)), zh);
            lw_ntt_load(z_lo + LW_LIMBS * ((c << a) + (t & ((1 << a) - 1))), zl);
            lw_ntt_mul(zh, zl, w);
            lw_ntt_mul(v, w, v);
        }
        lw_ntt_tile_put(tile, r, cs, lw_ntt_brev(t, s), c, v);
    }
    LW_NTT_SYNC();

    // radix-2 DIT stages two at a time: stages st and st + 1 on the points
    // base + {0, half, 2 half, 3 half} of a group of 4 half
    int st = 1;
    for (; st + 1 <= s; st += 2) {
        const int half = 1 << (st - 1);
        for (int idx = tid; idx < (C << (s - 2)); idx += nt) {
            const int c = idx & (C - 1), q = idx >> P.log_c;
            const int jj = q & (half - 1);
            const int base = ((q >> (st - 1)) << (st + 1)) + jj;
            uint32_t a0[LW_LIMBS], a1[LW_LIMBS], a2[LW_LIMBS], a3[LW_LIMBS], w[LW_LIMBS];
            lw_ntt_tile_get(tile, r, cs, base, c, a0);
            lw_ntt_tile_get(tile, r, cs, base + half, c, a1);
            lw_ntt_tile_get(tile, r, cs, base + 2 * half, c, a2);
            lw_ntt_tile_get(tile, r, cs, base + 3 * half, c, a3);
            if (st > 1) {  // stage 1 multiplies by w^0 = 1
                lw_ntt_load(w_r + LW_LIMBS * (jj << (s - st)), w);
                lw_ntt_mul(a1, w, a1);
                lw_ntt_mul(a3, w, a3);
            }
            lw_ntt_butterfly(a0, a1);
            lw_ntt_butterfly(a2, a3);
            if (st > 1) {  // stage 2 multiplies a2 by w^0 = 1
                lw_ntt_load(w_r + LW_LIMBS * (jj << (s - st - 1)), w);
                lw_ntt_mul(a2, w, a2);
            }
            lw_ntt_load(w_r + LW_LIMBS * ((jj + half) << (s - st - 1)), w);
            lw_ntt_mul(a3, w, a3);
            lw_ntt_butterfly(a0, a2);
            lw_ntt_butterfly(a1, a3);
            lw_ntt_tile_put(tile, r, cs, base, c, a0);
            lw_ntt_tile_put(tile, r, cs, base + half, c, a1);
            lw_ntt_tile_put(tile, r, cs, base + 2 * half, c, a2);
            lw_ntt_tile_put(tile, r, cs, base + 3 * half, c, a3);
        }
        LW_NTT_SYNC();
    }
    if (st == s) {  // odd s: one radix-2 stage left
        const int half = 1 << (st - 1);
        for (int idx = tid; idx < (C << (s - 1)); idx += nt) {
            const int c = idx & (C - 1), q = idx >> P.log_c;
            const int jj = q & (half - 1);
            const int i0 = ((q >> (st - 1)) << st) + jj;
            uint32_t u[LW_LIMBS], v[LW_LIMBS], w[LW_LIMBS];
            lw_ntt_tile_get(tile, r, cs, i0, c, u);
            lw_ntt_tile_get(tile, r, cs, i0 + half, c, v);
            if (st > 1) {
                lw_ntt_load(w_r + LW_LIMBS * (jj << (s - st)), w);
                lw_ntt_mul(v, w, v);
            }
            lw_ntt_butterfly(u, v);
            lw_ntt_tile_put(tile, r, cs, i0, c, u);
            lw_ntt_tile_put(tile, r, cs, i0 + half, c, v);
        }
        LW_NTT_SYNC();
    }

    // write point k of column j = g Ns + i to g Ns r + k Ns + i; neighbouring
    // threads take neighbouring i (runs of min(C, Ns) words), then k
    const int log_cw = P.log_c < P.ns_log ? P.log_c : P.ns_log;
    for (int idx = tid; idx < (C << s); idx += nt) {
        const int ii = idx & ((1 << log_cw) - 1);
        const int k = (idx >> log_cw) & (r - 1);
        const int c = ((idx >> (log_cw + s)) << log_cw) + ii;
        const long J = col0 + c;
        if (J >= total) continue;
        const long j = J & cols_mask;
        const long dst = (J >> log_cols) * n + ((j >> P.ns_log) << (P.ns_log + s))
                         + (j & ns_mask) + ((long)k << P.ns_log);
#pragma unroll
        for (int kk = 0; kk < LW_LIMBS; kk++)
            P.out[kk * plane + dst] = tile[(kk * r + k) * cs + c];
    }
}
