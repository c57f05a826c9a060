// One Stockham pass of the NTT over Goldilocks or BabyBear, as the work of
// one thread block: the body of small_ntt_pass_kernel (small_ntt.cu).
//
// The pass is poly/ntt.py's (ntt_pass_plain): radix r = 2^s, Ns = 2^ns_log
// the product of the earlier radices, N = 2^log_n points per row, cols =
// N / r columns per row.  Column j of a row reads x[j + t*cols] for t < r,
// multiplies point t by the twist z^t, z = w^((j mod Ns) * N / (Ns r)),
// runs a DFT of r points and writes point k to (j div Ns)*Ns*r + (j mod Ns)
// + k*Ns.  A block takes C = 2^log_c consecutive columns of the rows laid
// end to end; neighbouring threads take neighbouring columns, so every
// limb plane is read and written in runs of C words.
//
// The DFT is split r = r1 r2 (s1 = ceil(s/2), s2 = floor(s/2)), t = t2 +
// r2 t1, k = k1 + r1 k2:
//
//   step A  thread (c, t2) loads the r1 points t2 + r2 t1 of column c into
//           registers, twists them (z^t2 from the two root tables, then
//           one product by z^r2 a point), runs their r1-point DFT in
//           registers and multiplies output k1 by w_r^(t2 k1);
//           output k1 goes to slot k1 + r1 t2 of the column in shared
//           memory;
//   step B  thread (c, k1) reads slots k1 + r1 t2, t2 < r2, runs their
//           r2-point DFT in registers and has point k1 + r1 k2 of the
//           column: it writes it to device memory when Ns >= C (runs of C
//           words), else back to the slots it read, and after one more
//           barrier the block writes the tile out in runs of Ns words.
//
// So a pass synchronises once (twice when Ns < C), and no block builds a
// table: the DFT roots w_r^e come from `dft`, 2^dft_log entries built once
// per (root, N) on the host.  Registers hold the points (r1 <= 16: radix
// up to 2^8).  Each loop runs `for (idx = tid; idx < count; idx += nt)`
// with nothing carried across a barrier but shared memory, so the function
// compiled for the host with tid = 0, nt = 1 computes what the block
// computes: tests/test_torch_small_fields.py builds it with g++ and holds
// it against ntt_pass_plain pass by pass.
#pragma once

#include <stdint.h>

#include "small_field.cuh"

// largest radix (log2) of a pass
#define LW_SNTT_MAX_S 8

struct LwSmallNttPass {
    const int32_t* x;     // (L, rows, N) canonical Montgomery limbs
    int32_t* out;         // (L, rows, N), distinct from x
    const int32_t* t_lo;  // [2^h][L]: w^a
    const int32_t* t_hi;  // [2^(log_n - h)][L]: w^(b 2^h)
    const int32_t* dft;   // [2^dft_log][L]: w^(e N / 2^dft_log), dft_log >= s
    long rows;
    int log_n, ns_log, s, log_c, dft_log;
};

// base values of shared memory that one block of the pass takes: the tile
// [r][C + 1] (one pad column)
LW_SF long lw_sntt_smem_values(int s, int log_c) { return (1L << s) * ((1L << log_c) + 1); }

// threads of a block: C r2
LW_SF int lw_sntt_threads(int s, int log_c) { return 1 << (log_c + s / 2); }

// the bit reversal of t < 2^s, s <= 5, as one expression: constant where t
// is (an unrolled loop's index), so register arrays stay in registers
LW_SF constexpr int lw_sntt_brev(int t, int s) {
    return (s > 0 ? ((t & 1) << (s - 1)) : 0) | (s > 1 ? (((t >> 1) & 1) << (s - 2)) : 0)
           | (s > 2 ? (((t >> 2) & 1) << (s - 3)) : 0) | (s > 3 ? (((t >> 3) & 1) << (s - 4)) : 0)
           | (s > 4 ? (((t >> 4) & 1) << (s - 5)) : 0);
}

// w^e for e < 2^log_n: one product of the two table entries
template <class F>
LW_SF typename F::T lw_sntt_twiddle(const LwSmallNttPass& P, uint64_t e) {
    const int h = (P.log_n + 1) >> 1;
    return F::mul(F::load(P.t_hi, 1, (long)(e >> h) * F::LIMBS),
                  F::load(P.t_lo, 1, (long)(e & ((1ull << h) - 1)) * F::LIMBS));
}

// w_r^e = w^(e N / r), r = 2^S, e < r
template <class F, int S>
LW_SF typename F::T lw_sntt_root(const LwSmallNttPass& P, int e) {
    return F::load(P.dft, 1, ((long)e << (P.dft_log - S)) * F::LIMBS);
}

// the DFT of 2^L points in registers, in place: y[brev(t)] holds point t
// on entry, y[k] holds output k on exit; radix-2 DIT stages (a twiddle of
// one is skipped)
template <class F, int L>
LW_SF void lw_sntt_dft(const LwSmallNttPass& P, typename F::T* y) {
    typedef typename F::T T;
    constexpr int R = 1 << L;
    if constexpr (L > 0) {
        T w[R / 2 > 1 ? R / 2 : 1];
        LW_SF_UNROLL
        for (int u = 1; u < R / 2; u++) w[u] = lw_sntt_root<F, L>(P, u);
        LW_SF_UNROLL
        for (int st = 1; st <= L; st++) {
            const int half = 1 << (st - 1);
            LW_SF_UNROLL
            for (int g = 0; g < R; g += 2 * half) {
                LW_SF_UNROLL
                for (int jj = 0; jj < half; jj++) {
                    const T a = y[g + jj];
                    T b = y[g + jj + half];
                    if (jj) b = F::mul(b, w[jj << (L - st)]);
                    y[g + jj] = F::add(a, b);
                    y[g + jj + half] = F::sub(a, b);
                }
            }
        }
    }
}

template <class F, int S>
LW_SF void lw_sntt_pass_block_s(const LwSmallNttPass& P, long block, int tid, int nt,
                                typename F::T* tile) {
    typedef typename F::T T;
    constexpr int S1 = (S + 1) / 2, S2 = S / 2, R1 = 1 << S1, R2 = 1 << S2;
    const int C = 1 << P.log_c, cs = C + 1;
    const int log_cols = P.log_n - S;
    const long n = 1L << P.log_n, plane = P.rows * n;
    const long cols_mask = (1L << log_cols) - 1, ns_mask = (1L << P.ns_log) - 1;
    const long total = P.rows << log_cols;
    const long col0 = block << P.log_c;
    const int shift = P.log_n - P.ns_log - S;  // the twist's root is w^(N / (Ns r))

    for (int idx = tid; idx < (C << S2); idx += nt) {
        const int c = idx & (C - 1), t2 = idx >> P.log_c;
        const long J = col0 + c;
        if (J >= total) continue;
        const long src = (J >> log_cols) * n + (J & cols_mask);
        T v[R1];  // point t1 at v[brev(t1)], as the DFT takes it
        LW_SF_UNROLL
        for (int t1 = 0; t1 < R1; t1++)
            v[lw_sntt_brev(t1, S1)] =
                F::load(P.x, plane, src + ((long)(t2 + (t1 << S2)) << log_cols));
        if (P.ns_log > 0) {
            const uint64_t i = (uint64_t)(J & ns_mask);
            T z = lw_sntt_twiddle<F>(P, (i * (uint64_t)t2) << shift);
            const T step = lw_sntt_twiddle<F>(P, (i << S2) << shift);
            LW_SF_UNROLL
            for (int t1 = 0; t1 < R1; t1++) {
                v[lw_sntt_brev(t1, S1)] = F::mul(v[lw_sntt_brev(t1, S1)], z);
                if (t1 + 1 < R1) z = F::mul(z, step);
            }
        }
        lw_sntt_dft<F, S1>(P, v);
        if (t2) {
            LW_SF_UNROLL
            for (int k1 = 1; k1 < R1; k1++) v[k1] = F::mul(v[k1], lw_sntt_root<F, S>(P, t2 * k1));
        }
        LW_SF_UNROLL
        for (int k1 = 0; k1 < R1; k1++) tile[(long)(k1 + R1 * t2) * cs + c] = v[k1];
    }
    LW_SF_SYNC();

    const bool direct = P.ns_log >= P.log_c;
    for (int idx = tid; idx < (C << S1); idx += nt) {
        const int c = idx & (C - 1), k1 = idx >> P.log_c;
        const long J = col0 + c;
        if (J >= total) continue;
        T v[R2];
        LW_SF_UNROLL
        for (int t2 = 0; t2 < R2; t2++)
            v[lw_sntt_brev(t2, S2)] = tile[(long)(k1 + R1 * t2) * cs + c];
        lw_sntt_dft<F, S2>(P, v);
        if (direct) {
            const long j = J & cols_mask;
            const long dst = (J >> log_cols) * n + ((j >> P.ns_log) << (P.ns_log + S))
                             + (j & ns_mask) + ((long)k1 << P.ns_log);
            LW_SF_UNROLL
            for (int k2 = 0; k2 < R2; k2++)
                F::store(P.out, plane, dst + ((long)(R1 * k2) << P.ns_log), v[k2]);
        } else {
            LW_SF_UNROLL
            for (int k2 = 0; k2 < R2; k2++) tile[(long)(k1 + R1 * k2) * cs + c] = v[k2];
        }
    }
    if (direct) return;
    LW_SF_SYNC();

    // write point k of column j = g Ns + i to g Ns r + k Ns + i; neighbouring
    // threads take neighbouring i (runs of min(C, Ns) words), then k
    const int log_cw = P.log_c < P.ns_log ? P.log_c : P.ns_log;
    for (int idx = tid; idx < (C << S); idx += nt) {
        const int ii = idx & ((1 << log_cw) - 1);
        const int k = (idx >> log_cw) & ((1 << S) - 1);
        const int c = ((idx >> (log_cw + S)) << log_cw) + ii;
        const long J = col0 + c;
        if (J >= total) continue;
        const long j = J & cols_mask;
        const long dst = (J >> log_cols) * n + ((j >> P.ns_log) << (P.ns_log + S))
                         + (j & ns_mask) + ((long)k << P.ns_log);
        F::store(P.out, plane, dst, tile[(long)k * cs + c]);
    }
}

// the block of a pass of any radix 2^1 .. 2^LW_SNTT_MAX_S (the host tests'
// entry; the card launches lw_sntt_pass_block_s<F, S> for each s)
template <class F>
LW_SF void lw_sntt_pass_block(const LwSmallNttPass& P, long block, int tid, int nt,
                              typename F::T* tile) {
    switch (P.s) {
        case 1: lw_sntt_pass_block_s<F, 1>(P, block, tid, nt, tile); break;
        case 2: lw_sntt_pass_block_s<F, 2>(P, block, tid, nt, tile); break;
        case 3: lw_sntt_pass_block_s<F, 3>(P, block, tid, nt, tile); break;
        case 4: lw_sntt_pass_block_s<F, 4>(P, block, tid, nt, tile); break;
        case 5: lw_sntt_pass_block_s<F, 5>(P, block, tid, nt, tile); break;
        case 6: lw_sntt_pass_block_s<F, 6>(P, block, tid, nt, tile); break;
        case 7: lw_sntt_pass_block_s<F, 7>(P, block, tid, nt, tile); break;
        default: lw_sntt_pass_block_s<F, 8>(P, block, tid, nt, tile); break;
    }
}
