// Batch inversion as a tiled Montgomery trick over Stark252: the work of
// one thread block of batch_inverse.cu, and the schedule of its launches,
// kept in a header so that g++ compiles the same code for the host
// (tests/test_torch_batch_inverse.py).  The field is a template parameter F
// (mul, one, inv on F::LIMBS u32 limbs; the card instantiates LwStark252,
// mont.cuh); the schedule does not depend on it, only the words a level
// takes.  The dense fields invert on a kernel of their own
// (dense_inverse.cuh).
//
// Each loop over threads below runs `for (t = tid; t < T; t += nt)` over
// iterations that touch distinct shared-memory words, with LW_INV_SYNC
// between loops, so the block's work compiled for the host and called with
// tid = 0, nt = 1 for every block in turn computes what the card computes.
//
// Levels.  Level 0 holds the n elements, (LIMBS, n) int32 limb planes in
// Montgomery form.  A tile is T x L elements: thread t of tile b walks the
// elements b T L + j T + t for j < L, so that at each step neighbouring
// threads touch neighbouring words of every plane.  The product of tile
// b's nonzero elements is element b of level 1, and so on up to a level
// that fits in one tile (the top).  Zeros count as one and map to zero.
// The launches (lw_inv_launch), each one per level:
//  * up, for each level below the top: every thread walks forward with a
//    running product and stores each prefix to out; the threads' totals
//    are multiplied pairwise up a binary tree in shared memory, and the
//    root, the tile's total, becomes an element of the next level;
//  * top: the same, then one inversion of the root (lw_mont_inv), then as
//    a down pass;
//  * down, for each level from the top down: the tree is built again from
//    each thread's last prefix, the root's inverse is the next level's
//    output, and inverses go down the tree (inv(left) = inv(parent) *
//    right, inv(right) = inv(parent) * left); each thread walks back from
//    its leaf's inverse r: out = r * (prefix before), r = r * x.
// Products per element: 1 forward, 2 back, and about 4 / L for the trees.
#pragma once

#include "mont.cuh"

#ifdef __CUDA_ARCH__
#define LW_INV_SYNC() __syncthreads()
#else
#define LW_INV_SYNC() ((void)0)
#endif

#define LW_INV_MAX_LEVELS 64
// The kernel's tile: T threads per block and L elements per thread from the
// batch size, with no register cap; the fastest of
// tools/sweep_batch_inverse.py's sweep at n = 2^18 .. 2^24 on an H100
// (PERF.md).
#define LW_INV_THREADS 256

LW_HD int lw_inv_walk(long n) {
    return n < (1L << 19) ? 8 : n < (1L << 21) ? 16 : n < (1L << 22) ? 32 : n < (1L << 23) ? 64 : 128;
}

enum { LW_INV_UP = 0, LW_INV_TOP = 1, LW_INV_DOWN = 2 };

struct LwInvLevel {
    const int32_t* x;         // (8, m) this level's elements
    int32_t* out;             // (8, m): running prefixes, then the inverses
    int32_t* next;            // (8, tiles) up: the tile totals (the next level's x)
    const int32_t* next_inv;  // (8, tiles) down: their inverses (the next level's out)
    long m, tiles;
    int T, L;
};

struct LwInvPlan {
    int levels, launches;
    long m[LW_INV_MAX_LEVELS];  // elements of each level
    long scratch_words;         // levels 1 and up: x and out, 2 LIMBS m words each
    int limbs;                  // the field's u32 limbs (F::LIMBS)
};

struct LwInvLaunch {
    LwInvLevel lev;  // a grid of lev.tiles blocks
    int mode;
};

// T threads per block (a power of two, for the tree), L elements each
LW_HD bool lw_inv_shape_ok(int T, int L) {
    return T >= 1 && T <= LW_INV_THREADS && (T & (T - 1)) == 0 && L >= 1 && (long)T * L >= 2;
}

LW_HD LwInvPlan lw_inv_plan(long n, int T, int L, int limbs = LW_LIMBS) {
    LwInvPlan P;
    P.limbs = limbs;
    const long tile = (long)T * L;
    P.m[0] = n;
    P.levels = 1;
    P.scratch_words = 0;
    while (P.m[P.levels - 1] > tile) {
        P.m[P.levels] = (P.m[P.levels - 1] + tile - 1) / tile;
        P.scratch_words += 2L * limbs * P.m[P.levels];
        P.levels++;
    }
    P.launches = n > 0 ? 2 * P.levels - 1 : 0;
    return P;
}

// level k >= 1 in scratch: its elements, then its output, (LIMBS, m_k) each
LW_HD int32_t* lw_inv_scratch(const LwInvPlan& P, int k, int32_t* scratch) {
    long off = 0;
    for (int j = 1; j < k; j++) off += 2L * P.limbs * P.m[j];
    return scratch + off;
}

// launch i of P.launches: up at levels 0 .. top-1, the top, down at top-1 .. 0
LW_HD LwInvLaunch lw_inv_launch(const LwInvPlan& P, int i, const int32_t* x, int32_t* out,
                                int32_t* scratch, int T, int L) {
    const int top = P.levels - 1;
    const int k = i <= top ? i : 2 * top - i;
    LwInvLaunch r;
    r.mode = i < top ? LW_INV_UP : (i == top ? LW_INV_TOP : LW_INV_DOWN);
    LwInvLevel& V = r.lev;
    V.x = x;
    V.out = out;
    if (k > 0) {
        int32_t* level = lw_inv_scratch(P, k, scratch);
        V.x = level;
        V.out = level + P.limbs * P.m[k];
    }
    V.next = nullptr;
    V.next_inv = nullptr;
    V.tiles = 1;
    if (k < top) {
        V.next = lw_inv_scratch(P, k + 1, scratch);
        V.next_inv = V.next + P.limbs * P.m[k + 1];
        V.tiles = P.m[k + 1];
    }
    V.m = P.m[k];
    V.T = T;
    V.L = L;
    return r;
}

// words of shared memory a block takes: the tree's 2T nodes, limb-major
LW_HD long lw_inv_smem_words(int T, int limbs = LW_LIMBS) { return 2L * limbs * T; }

// NL: the field's limbs (F::LIMBS); below, a value of NL u32 limbs
template <int NL = LW_LIMBS>
LW_HD void lw_load_plane(const int32_t* x, long n, long i, uint32_t v[NL]) {
#pragma unroll
    for (int k = 0; k < NL; k++) v[k] = (uint32_t)x[k * n + i];
}

template <int NL = LW_LIMBS>
LW_HD void lw_store_plane(int32_t* x, long n, long i, const uint32_t v[NL]) {
#pragma unroll
    for (int k = 0; k < NL; k++) x[k * n + i] = (int32_t)v[k];
}

template <int NL = LW_LIMBS>
LW_HD void lw_inv_node_get(const uint32_t* sm, int T, int node, uint32_t v[NL]) {
#pragma unroll
    for (int k = 0; k < NL; k++) v[k] = sm[k * 2 * T + node];
}

template <int NL = LW_LIMBS>
LW_HD void lw_inv_node_put(uint32_t* sm, int T, int node, const uint32_t v[NL]) {
#pragma unroll
    for (int k = 0; k < NL; k++) sm[k * 2 * T + node] = v[k];
}

template <int NL>
LW_HD bool lw_inv_is_zero(const uint32_t a[NL]) {
    uint32_t any = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) any |= a[i];
    return any == 0;
}

template <int NL>
LW_HD void lw_inv_copy(const uint32_t a[NL], uint32_t r[NL]) {
#pragma unroll
    for (int i = 0; i < NL; i++) r[i] = a[i];
}

// elements in thread t's walk of tile b
LW_HD int lw_inv_count(const LwInvLevel& V, long b, int t) {
    const long first = b * V.T * V.L + t;
    if (first >= V.m) return 0;
    const long c = (V.m - first + V.T - 1) / V.T;
    return c < V.L ? (int)c : V.L;
}

// each thread's running product of its nonzero elements, each prefix
// stored to out, the total to its leaf T + t; the next element is loaded
// before the product of this one
template <class F = LwStark252>
LW_HD void lw_inv_forward(const LwInvLevel& V, long b, int tid, int nt, uint32_t* sm) {
    const long base = b * V.T * V.L;
    for (int t = tid; t < V.T; t += nt) {
        uint32_t run[F::LIMBS], v[F::LIMBS], next[F::LIMBS];
        F::one(run);
        bool started = false;  // run is still one: copy, do not multiply
        const int cnt = lw_inv_count(V, b, t);
        if (cnt) lw_load_plane<F::LIMBS>(V.x, V.m, base + t, next);
        for (int j = 0; j < cnt; j++) {
            const long i = base + (long)j * V.T + t;
            lw_inv_copy<F::LIMBS>(next, v);
            if (j + 1 < cnt) lw_load_plane<F::LIMBS>(V.x, V.m, i + V.T, next);
            if (!lw_inv_is_zero<F::LIMBS>(v)) {
                if (started) F::mul(run, v, run);
                else lw_inv_copy<F::LIMBS>(v, run);
                started = true;
            }
            lw_store_plane<F::LIMBS>(V.out, V.m, i, run);
        }
        lw_inv_node_put<F::LIMBS>(sm, V.T, V.T + t, run);
    }
}

// the leaves again, from each thread's last prefix
template <class F = LwStark252>
LW_HD void lw_inv_leaves(const LwInvLevel& V, long b, int tid, int nt, uint32_t* sm) {
    const long base = b * V.T * V.L;
    for (int t = tid; t < V.T; t += nt) {
        uint32_t v[F::LIMBS];
        const int cnt = lw_inv_count(V, b, t);
        if (cnt) lw_load_plane<F::LIMBS>(V.out, V.m, base + (long)(cnt - 1) * V.T + t, v);
        else F::one(v);
        lw_inv_node_put<F::LIMBS>(sm, V.T, V.T + t, v);
    }
}

// node k = node 2k * node 2k+1, from the leaves up to the root, node 1
template <class F = LwStark252>
LW_HD void lw_inv_tree_up(int T, int tid, int nt, uint32_t* sm) {
    for (int h = T >> 1; h >= 1; h >>= 1) {
        for (int idx = tid; idx < h; idx += nt) {
            const int k = h + idx;
            uint32_t l[F::LIMBS], r[F::LIMBS];
            lw_inv_node_get<F::LIMBS>(sm, T, 2 * k, l);
            lw_inv_node_get<F::LIMBS>(sm, T, 2 * k + 1, r);
            F::mul(l, r, l);
            lw_inv_node_put<F::LIMBS>(sm, T, k, l);
        }
        LW_INV_SYNC();
    }
}

// node 1 holds the root's inverse; each node's inverse replaces it, from
// the root down to the leaves
template <class F = LwStark252>
LW_HD void lw_inv_tree_down(int T, int tid, int nt, uint32_t* sm) {
    for (int h = 1; h < T; h <<= 1) {
        for (int idx = tid; idx < h; idx += nt) {
            const int k = h + idx;
            uint32_t iv[F::LIMBS], l[F::LIMBS], r[F::LIMBS];
            lw_inv_node_get<F::LIMBS>(sm, T, k, iv);
            lw_inv_node_get<F::LIMBS>(sm, T, 2 * k, l);
            lw_inv_node_get<F::LIMBS>(sm, T, 2 * k + 1, r);
            F::mul(iv, r, r);
            F::mul(iv, l, l);
            lw_inv_node_put<F::LIMBS>(sm, T, 2 * k, r);
            lw_inv_node_put<F::LIMBS>(sm, T, 2 * k + 1, l);
        }
        LW_INV_SYNC();
    }
}

// each thread from its leaf's inverse back over its walk: out = r * (the
// prefix before), r = r * x; zeros give zero.  The element and prefix of
// the next step are loaded before the products of this one.
template <class F = LwStark252>
LW_HD void lw_inv_backward(const LwInvLevel& V, long b, int tid, int nt, const uint32_t* sm) {
    const long base = b * V.T * V.L;
    for (int t = tid; t < V.T; t += nt) {
        uint32_t r[F::LIMBS], v[F::LIMBS], w[F::LIMBS], nv[F::LIMBS], nw[F::LIMBS] = {0};
        lw_inv_node_get<F::LIMBS>(sm, V.T, V.T + t, r);
        const int cnt = lw_inv_count(V, b, t);
        long i = base + (long)(cnt - 1) * V.T + t;
        if (cnt) lw_load_plane<F::LIMBS>(V.x, V.m, i, nv);
        if (cnt > 1) lw_load_plane<F::LIMBS>(V.out, V.m, i - V.T, nw);
        for (int j = cnt - 1; j >= 0; j--, i -= V.T) {
            lw_inv_copy<F::LIMBS>(nv, v);
            lw_inv_copy<F::LIMBS>(nw, w);
            if (j > 0) lw_load_plane<F::LIMBS>(V.x, V.m, i - V.T, nv);
            if (j > 1) lw_load_plane<F::LIMBS>(V.out, V.m, i - 2 * V.T, nw);
            if (lw_inv_is_zero<F::LIMBS>(v)) {
                lw_store_plane<F::LIMBS>(V.out, V.m, i, v);
            } else if (j == 0) {
                lw_store_plane<F::LIMBS>(V.out, V.m, i, r);
            } else {
                F::mul(r, w, w);
                lw_store_plane<F::LIMBS>(V.out, V.m, i, w);
                F::mul(r, v, r);
            }
        }
    }
}

// tile b of one launch; sm holds lw_inv_smem_words(T) words
template <class F = LwStark252>
LW_HD void lw_inv_block(const LwInvLevel& V, int mode, long b, int tid, int nt, uint32_t* sm) {
    if (mode == LW_INV_DOWN) lw_inv_leaves<F>(V, b, tid, nt, sm);
    else lw_inv_forward<F>(V, b, tid, nt, sm);
    LW_INV_SYNC();
    lw_inv_tree_up<F>(V.T, tid, nt, sm);
    for (int idx = tid; idx < 1; idx += nt) {
        uint32_t v[F::LIMBS];
        lw_inv_node_get<F::LIMBS>(sm, V.T, 1, v);
        if (mode == LW_INV_UP) {
            lw_store_plane<F::LIMBS>(V.next, V.tiles, b, v);
        } else {
            if (mode == LW_INV_TOP) F::inv(v, v);
            else lw_load_plane<F::LIMBS>(V.next_inv, V.tiles, b, v);
            lw_inv_node_put<F::LIMBS>(sm, V.T, 1, v);
        }
    }
    if (mode == LW_INV_UP) return;
    LW_INV_SYNC();
    lw_inv_tree_down<F>(V.T, tid, nt, sm);
    lw_inv_backward<F>(V, b, tid, nt, sm);
}
