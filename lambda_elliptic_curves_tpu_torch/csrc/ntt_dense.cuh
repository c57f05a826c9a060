// One Stockham pass of the NTT over a dense field (BN254 Fr, BLS12-377 Fr)
// as the work of one thread block: the body of ntt.cu's dense kernel.  The
// pass is ntt.cuh's (the same gather and twist, and ntt.cuh's own DFT
// stages and scatter, lw_ntt_tile_dft and lw_ntt_tile_scatter: the same
// output bit for bit); what differs is where its root powers come from,
// since a dense product costs about twice Stark252's:
//
//  * one table of every root power, pw[e] = w^e for e < N (entry-major,
//    8 limbs a 32-byte run; poly/ntt.py builds it once per (root, N) and
//    caches it), read straight from device memory: the twist of point t
//    of column j is pw[((j mod Ns) t) N / (Ns r)], one product to apply;
//    ntt.cuh builds each column's twist tables per block and spends one
//    product to combine them and one to apply it;
//  * the DFT's roots w_r^u = pw[u N / r] are copied into shared memory, not
//    computed (ntt.cuh: r/2 products a block).
//
// So a point of a pass after the first costs one product for its twist
// and, at radix 2^6, 2.25 for its butterflies (ntt.cuh: 2 + 2.25 + 0.3 for
// the tables).  The tile's columns C = 2^log_c are the caller's choice per
// pass (poly/ntt.py's dense_cols_log), so that a pass of few columns still
// runs on many blocks.
//
// Each loop runs `for (idx = tid; idx < count; idx += nt)` and no two
// iterations of one loop touch the same shared-memory word, so the same
// function compiled for the host with tid = 0, nt = 1 computes what the
// block computes (tests/test_torch_bn254.py builds it with g++).
#pragma once

#include <stdint.h>

#include "dense32.cuh"
#include "ntt.cuh"

struct LwDenseNttPass {
    const uint32_t* x;   // (8, rows, N) canonical Montgomery limbs
    uint32_t* out;       // (8, rows, N), distinct from x
    const uint32_t* pw;  // [N][8]: w^e
    long rows;
    int log_n, ns_log, s, log_c;
};

// words of shared memory that one block of the pass takes: the tile
// [8][r][C + 1] and the DFT's roots [r/2][8]
LW_HD long lw_dense_ntt_smem_words(int s, int log_c) {
    const long r = 1L << s, c = 1L << log_c;
    return LW_LIMBS * (r * (c + 1) + (r >> 1));
}

// w^e into v: one 32-byte run of the power table
LW_HD void lw_dense_ntt_power(const uint32_t* pw, long e, uint32_t v[LW_LIMBS]) {
#ifdef __CUDA_ARCH__
    const uint4* q = reinterpret_cast<const uint4*>(pw + LW_LIMBS * e);
    const uint4 lo = __ldg(q), hi = __ldg(q + 1);
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
#else
    lw_ntt_load(pw + LW_LIMBS * e, v);
#endif
}

// F: a field of dense32.cuh (LwBn254Fr32, LwBls12377Fr32)
template <class F>
LW_HD void lw_dense_ntt_pass_block(const LwDenseNttPass& P, long block, int tid, int nt,
                                   uint32_t* sm) {
    static_assert(F::LIMBS == LW_LIMBS, "the tile holds 8-limb values");
    const int s = P.s, r = 1 << s, C = 1 << P.log_c, cs = C + 1;
    const int log_cols = P.log_n - s;
    const long n = 1L << P.log_n, plane = P.rows * n;
    const long cols_mask = (1L << log_cols) - 1, ns_mask = (1L << P.ns_log) - 1;
    const long total = P.rows << log_cols;
    const long col0 = block << P.log_c;
    const bool twist = P.ns_log > 0;
    const int shift = P.log_n - P.ns_log - s;  // twist root w^(N / (Ns r))
    uint32_t* tile = sm;
    uint32_t* w_r = tile + LW_LIMBS * r * cs;

    for (int idx = tid; idx < LW_LIMBS * (r >> 1); idx += nt)
        w_r[idx] = P.pw[((long)(idx >> 3) << log_cols) * LW_LIMBS + (idx & 7)];

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
            uint32_t w[LW_LIMBS];
            lw_dense_ntt_power(P.pw, ((J & ns_mask) * t) << shift, w);
            F::mul(v, w, v);
        }
        lw_ntt_tile_put(tile, r, cs, lw_ntt_brev(t, s), c, v);
    }
    LW_NTT_SYNC();

    lw_ntt_tile_dft<F>(tile, w_r, s, P.log_c, tid, nt);
    lw_ntt_tile_scatter(P.out, tile, s, P.log_c, P.ns_log, log_cols, n, plane, cols_mask, ns_mask,
                        total, col0, tid, nt);
}
