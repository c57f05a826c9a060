// Batch inversion over a dense field F = LwDense32<Q> (kernel 9): the work
// of one block of dense_inverse_kernel, kept in a header of __host__
// __device__ code so that g++ compiles the same code for the host
// (tests/test_torch_dense_kernels.py, tests/test_torch_bn254.py,
// tests/test_torch_bls12_377.py).
//
// Montgomery's trick inside a block of `threads` threads (a power of two),
// each taking `rounds` rounds of K elements of the (LIMBS, n) planes:
// element k of round r of thread t of block b is element (b rounds K + r K
// + k) threads + t, so that neighbouring threads read neighbouring words of
// every plane.
//
//   1. each thread loads a round's K elements (all loads first; one for a
//      zero element or one past n), keeps them and their prefix products in
//      registers, and carries the running product into the next round; the
//      prefix a round starts from is stored to out at the round's first
//      element.  Its total goes to leaf t of `tree` (2 threads nodes of
//      shared memory, limb-major);
//   2. a product tree over the leaves, level by level: node 1 is the
//      block's product;
//   3. one thread inverts it with F::inv, dense.cuh's binary extended
//      Euclid (no products);
//   4. down the tree, node m's inverse times its sibling's product is its
//      child's inverse: each leaf ends as 1 / (its thread's total);
//   5. each thread walks back over its rounds, the last still in registers,
//      each earlier one loaded again with its stored start and its
//      prefixes recomputed: 1/x_k = 1/prefix_k * prefix_(k-1),
//      1/prefix_(k-1) = 1/prefix_k * x_k; it writes 1/x_k (0 for a zero
//      element).
//
// With one round, each value is read once and written once and a nonzero
// element costs 3 products; each further round reads its elements twice
// and costs a fourth product an element, so that a call's n / (threads K
// rounds) blocks, each with its one inversion (one thread's chain of about
// 2 log2 p Euclid steps), fit one wave of the card.  Each loop runs over
// thread indices in the form t = tid, tid + nt, ...: on the card SLOTS = 1
// and nt = threads, and a thread keeps its elements in registers across
// the barriers; on the host SLOTS = threads with tid = 0, nt = 1, so one
// thread computes what the block computes.
#pragma once

#include <stdint.h>

#include "dense32.cuh"

#ifdef __CUDA_ARCH__
#define LW_DI_SYNC() __syncthreads()
#else
#define LW_DI_SYNC() ((void)0)
#endif

template <int L>
LW_HD void lw_di_node_get(const uint32_t* tree, int threads, int node, uint32_t v[L]) {
#pragma unroll
    for (int k = 0; k < L; k++) v[k] = tree[k * 2 * threads + node];
}

template <int L>
LW_HD void lw_di_node_put(uint32_t* tree, int threads, int node, const uint32_t v[L]) {
#pragma unroll
    for (int k = 0; k < L; k++) tree[k * 2 * threads + node] = v[k];
}

// words of shared memory a block takes: the tree's 2 threads nodes
LW_HD long lw_di_smem_words(int threads, int limbs) { return 2L * limbs * threads; }

// a round of one thread from the prefix `acc` (updated to the round's
// total; one when `first`): its K elements from element i0 on, strided by
// `threads`, into v (one for a zero element, flagged in `zero`, or one past
// n), and their prefix products into pre
template <class F, int K>
LW_HD void lw_di_round(const int32_t* x, long n, long i0, int threads, bool first,
                       uint32_t acc[F::LIMBS], uint32_t v[K][F::LIMBS], uint32_t pre[K][F::LIMBS],
                       uint32_t& zero) {
    constexpr int L = F::LIMBS;
#pragma unroll
    for (int k = 0; k < K; k++) {
        const long i = i0 + (long)k * threads;
        if (i < n) {
#pragma unroll
            for (int l = 0; l < L; l++) v[k][l] = (uint32_t)x[l * n + i];
        } else {
            F::one(v[k]);
        }
    }
    zero = 0;
#pragma unroll
    for (int k = 0; k < K; k++) {
        uint32_t any = 0;
#pragma unroll
        for (int l = 0; l < L; l++) any |= v[k][l];
        if (any == 0) {
            zero |= 1u << k;
            F::one(v[k]);
        }
        if (k || !first) {
            F::mul(k ? pre[k - 1] : acc, v[k], pre[k]);
        } else {
#pragma unroll
            for (int l = 0; l < L; l++) pre[0][l] = v[0][l];
        }
    }
#pragma unroll
    for (int l = 0; l < L; l++) acc[l] = pre[K - 1][l];
}

template <class F, int K, int SLOTS>
LW_HD void lw_dn_inv_block(const int32_t* x, int32_t* out, long n, long block, int threads,
                           int rounds, int tid, int nt, uint32_t* tree) {
    constexpr int L = F::LIMBS;
    uint32_t v[SLOTS][K][L], pre[SLOTS][K][L];
    uint32_t zero[SLOTS];
    const long e0 = block * (long)threads * K * rounds;

    for (int q = 0, t = tid; q < SLOTS && t < threads; q++, t += nt) {
        uint32_t acc[L];
        F::one(acc);
        for (int r = 0; r < rounds; r++) {
            const long i0 = e0 + (long)r * K * threads + t;
            if (r && i0 < n) {
#pragma unroll
                for (int l = 0; l < L; l++) out[l * n + i0] = (int32_t)acc[l];
            }
            lw_di_round<F, K>(x, n, i0, threads, r == 0, acc, v[q], pre[q], zero[q]);
        }
        lw_di_node_put<L>(tree, threads, threads + t, acc);
    }
    for (int h = threads >> 1; h >= 1; h >>= 1) {
        LW_DI_SYNC();
        for (int idx = tid; idx < h; idx += nt) {
            const int m = h + idx;
            uint32_t l[L], r[L];
            lw_di_node_get<L>(tree, threads, 2 * m, l);
            lw_di_node_get<L>(tree, threads, 2 * m + 1, r);
            F::mul(l, r, l);
            lw_di_node_put<L>(tree, threads, m, l);
        }
    }
    LW_DI_SYNC();
    for (int idx = tid; idx < 1; idx += nt) {
        uint32_t root[L];
        lw_di_node_get<L>(tree, threads, 1, root);
        F::inv(root, root);
        lw_di_node_put<L>(tree, threads, 1, root);
    }
    for (int h = 1; h < threads; h <<= 1) {
        LW_DI_SYNC();
        for (int idx = tid; idx < h; idx += nt) {
            const int m = h + idx;
            uint32_t iv[L], l[L], r[L];
            lw_di_node_get<L>(tree, threads, m, iv);
            lw_di_node_get<L>(tree, threads, 2 * m, l);
            lw_di_node_get<L>(tree, threads, 2 * m + 1, r);
            F::mul(iv, r, r);
            F::mul(iv, l, l);
            lw_di_node_put<L>(tree, threads, 2 * m, r);
            lw_di_node_put<L>(tree, threads, 2 * m + 1, l);
        }
    }
    LW_DI_SYNC();
    for (int q = 0, t = tid; q < SLOTS && t < threads; q++, t += nt) {
        uint32_t acc[L], start[L];
        lw_di_node_get<L>(tree, threads, threads + t, acc);
        for (int r = rounds - 1; r >= 0; r--) {
            const long i0 = e0 + (long)r * K * threads + t;
            if (i0 >= n) continue;  // past n: ones, nothing to write
            if (r) {
#pragma unroll
                for (int l = 0; l < L; l++) start[l] = (uint32_t)out[l * n + i0];
            } else {
                F::one(start);
            }
            if (r < rounds - 1) {  // the round again, from its start
                uint32_t s[L];
#pragma unroll
                for (int l = 0; l < L; l++) s[l] = start[l];
                lw_di_round<F, K>(x, n, i0, threads, r == 0, s, v[q], pre[q], zero[q]);
            }
#pragma unroll
            for (int k = K - 1; k >= 0; k--) {
                const long i = i0 + (long)k * threads;
                uint32_t w[L];
                if (k || r) {
                    F::mul(acc, k ? pre[q][k - 1] : start, w);
                    F::mul(acc, v[q][k], acc);
                } else {
#pragma unroll
                    for (int l = 0; l < L; l++) w[l] = acc[l];
                }
                if (i < n) {
                    const bool z = (zero[q] >> k) & 1u;
#pragma unroll
                    for (int l = 0; l < L; l++) out[l * n + i] = z ? 0 : (int32_t)w[l];
                }
            }
        }
    }
}
