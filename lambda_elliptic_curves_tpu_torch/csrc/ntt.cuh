// One Stockham pass of the NTT over Stark252, as the work of one thread
// block: the body of ntt_pass_kernel (ntt.cu).  The field is a template
// parameter F (mul, butterfly): LwStark252 (mont.cuh, p's sparse limbs in a
// carry-chain product); the pass itself does not depend on it.  The dense
// fields run the same pass on ntt_dense.cuh's block, which reads its root
// powers from one table instead of building them here.
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
template <class F = LwStark252>
LW_HD void lw_ntt_twiddle(const LwNttPass& P, uint64_t e, uint32_t r[LW_LIMBS]) {
    const int h = (P.log_n + 1) >> 1;
    uint32_t hi[LW_LIMBS], lo[LW_LIMBS];
    lw_ntt_load(P.t_hi + LW_LIMBS * (e >> h), hi);
    lw_ntt_load(P.t_lo + LW_LIMBS * (e & ((1ull << h) - 1)), lo);
    F::mul(hi, lo, r);
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

// The DFT of r = 2^s points in each of the tile's C = 2^log_c columns, from
// bit-reversed positions, with w_r[u] = w_r^u for u < r/2 (8 limbs each):
// radix-2 DIT stages two at a time (stages st and st + 1 on the points
// base + {0, half, 2 half, 3 half} of a group of 4 half), then one radix-2
// stage if s is odd.  Shared by both pass blocks (ntt_dense.cuh's too).
template <class F>
LW_HD void lw_ntt_tile_dft(uint32_t* tile, const uint32_t* w_r, int s, int log_c, int tid,
                           int nt) {
    const int r = 1 << s, C = 1 << log_c, cs = C + 1;
    int st = 1;
    for (; st + 1 <= s; st += 2) {
        const int half = 1 << (st - 1);
        for (int idx = tid; idx < (C << (s - 2)); idx += nt) {
            const int c = idx & (C - 1), q = idx >> log_c;
            const int jj = q & (half - 1);
            const int base = ((q >> (st - 1)) << (st + 1)) + jj;
            uint32_t a0[LW_LIMBS], a1[LW_LIMBS], a2[LW_LIMBS], a3[LW_LIMBS], w[LW_LIMBS];
            lw_ntt_tile_get(tile, r, cs, base, c, a0);
            lw_ntt_tile_get(tile, r, cs, base + half, c, a1);
            lw_ntt_tile_get(tile, r, cs, base + 2 * half, c, a2);
            lw_ntt_tile_get(tile, r, cs, base + 3 * half, c, a3);
            if (st > 1) {  // stage 1 multiplies by w^0 = 1
                lw_ntt_load(w_r + LW_LIMBS * (jj << (s - st)), w);
                F::mul(a1, w, a1);
                F::mul(a3, w, a3);
            }
            F::butterfly(a0, a1);
            F::butterfly(a2, a3);
            if (st > 1) {  // stage 2 multiplies a2 by w^0 = 1
                lw_ntt_load(w_r + LW_LIMBS * (jj << (s - st - 1)), w);
                F::mul(a2, w, a2);
            }
            lw_ntt_load(w_r + LW_LIMBS * ((jj + half) << (s - st - 1)), w);
            F::mul(a3, w, a3);
            F::butterfly(a0, a2);
            F::butterfly(a1, a3);
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
            const int c = idx & (C - 1), q = idx >> log_c;
            const int jj = q & (half - 1);
            const int i0 = ((q >> (st - 1)) << st) + jj;
            uint32_t u[LW_LIMBS], v[LW_LIMBS], w[LW_LIMBS];
            lw_ntt_tile_get(tile, r, cs, i0, c, u);
            lw_ntt_tile_get(tile, r, cs, i0 + half, c, v);
            if (st > 1) {
                lw_ntt_load(w_r + LW_LIMBS * (jj << (s - st)), w);
                F::mul(v, w, v);
            }
            F::butterfly(u, v);
            lw_ntt_tile_put(tile, r, cs, i0, c, u);
            lw_ntt_tile_put(tile, r, cs, i0 + half, c, v);
        }
        LW_NTT_SYNC();
    }
}

// The pass's output from the tile: point k of column j = g Ns + i goes to
// g Ns r + k Ns + i; neighbouring threads take neighbouring i (runs of
// min(C, Ns) words), then k.  ntt_dense.cuh's block calls it with the
// geometry it computed for its loads: (8, rows, n) planes of `plane`
// words, 2^log_cols columns a row (cols_mask), Ns = 2^ns_log (ns_mask),
// `total` columns in all, the block's first col0.  lw_ntt_pass_block keeps
// its own copy of this loop: as a call, even with the same arguments,
// ptxas allocates the Stark252 kernel's registers differently.
LW_HD void lw_ntt_tile_scatter(uint32_t* out, const uint32_t* tile, int s, int log_c,
                               int ns_log, int log_cols, long n, long plane, long cols_mask,
                               long ns_mask, long total, long col0, int tid, int nt) {
    const int r = 1 << s, C = 1 << log_c, cs = C + 1;
    const int log_cw = log_c < ns_log ? log_c : ns_log;
    for (int idx = tid; idx < (C << s); idx += nt) {
        const int ii = idx & ((1 << log_cw) - 1);
        const int k = (idx >> log_cw) & (r - 1);
        const int c = ((idx >> (log_cw + s)) << log_cw) + ii;
        const long J = col0 + c;
        if (J >= total) continue;
        const long j = J & cols_mask;
        const long dst = (J >> log_cols) * n + ((j >> ns_log) << (ns_log + s)) + (j & ns_mask)
                         + ((long)k << ns_log);
#pragma unroll
        for (int kk = 0; kk < LW_LIMBS; kk++) out[kk * plane + dst] = tile[(kk * r + k) * cs + c];
    }
}

// F: the field (LwStark252, mont.cuh, or a dense field, dense.cuh)
template <class F = LwStark252>
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
        lw_ntt_twiddle<F>(P, (uint64_t)u << log_cols, w_r + LW_LIMBS * u);
    if (twist) {
        for (int idx = tid; idx < (C << a); idx += nt) {
            const uint64_t i = (uint64_t)((col0 + (idx >> a)) & ns_mask);
            const uint64_t u = (uint64_t)(idx & ((1 << a) - 1));
            lw_ntt_twiddle<F>(P, (i * u) << shift, z_lo + LW_LIMBS * idx);
        }
        for (int idx = tid; idx < (C << (s - a)); idx += nt) {
            const uint64_t i = (uint64_t)((col0 + (idx >> (s - a))) & ns_mask);
            const uint64_t v = (uint64_t)(idx & ((1 << (s - a)) - 1));
            lw_ntt_twiddle<F>(P, (i * v) << (a + shift), z_hi + LW_LIMBS * idx);
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
            F::mul(zh, zl, w);
            F::mul(v, w, v);
        }
        lw_ntt_tile_put(tile, r, cs, lw_ntt_brev(t, s), c, v);
    }
    LW_NTT_SYNC();

    lw_ntt_tile_dft<F>(tile, w_r, s, P.log_c, tid, nt);

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
