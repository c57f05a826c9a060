// Montgomery arithmetic over the fields below 2^64, Goldilocks and
// BabyBear, and over their quadratic and quartic towers: the one
// implementation that small_field.cu and small_ntt.cuh share.
//
// Replaces the XLA digit code of lambda_elliptic_curves_tpu/ops/limbs.py at
// K = 4 and K = 2 sixteen-bit digits (add :600, sub :610, mont_mul :750,
// mont_pow :860) and the tower ops of fields/extensions.py
// (DeviceQuadraticField.mul :355, inv :365, batch_inverse :372).
//
// A value is x * R mod p with R = 2^64 (Goldilocks, one u64, two u32 limbs)
// or R = 2^32 (BabyBear, one u32 limb): the JAX package's R, so the limbs
// hold the JAX digits' bits.  Every function is strict: canonical in and
// out.  The code is plain C++ (the high product is __umul64hi on the card
// and unsigned __int128 on the host, and no inline carry chains), so the
// same functions compile with g++ and the host tests run exactly what the
// card runs.
//
// The product is Montgomery's with a subtraction: for t = a*b and
// m = t * p^-1 mod R, t - m*p is a multiple of R, so (t - m*p) / R =
// hi(t) - hi(m*p) in (-p, p), plus p when negative.  For Goldilocks m and
// hi(m*p) follow from p's shape with shifts and adds.
//
// Towers (provers/stark/extension.py _tower): E2 = F[u]/(u^2 - nr) with nr
// the least non-square of F, E4 = E2[v]/(v^2 - u).  An element of E_D is D
// base values, components depth-first: E4's (a0 + a1 v) is a0.c0, a0.c1,
// a1.c0, a1.c1.  Products are Karatsuba's (3 products of the half field),
// inverses go through the norm: 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 -
// nr a1^2), down to an inverse in F.
//
// Batch inversion (lw_sf_inv_block, kernel 6's small_field_inv_kernel) is
// Montgomery's trick inside a block: each thread takes the base norms of
// K elements and keeps their prefix products in registers, a product tree
// over the threads' totals in shared memory leaves one Fermat power a
// block, and the walk back lifts every inverse to E_D.
#pragma once

#include <stdint.h>

// LW_SF marks a function, LW_SFM a member function; LW_SF_SYNC is a
// block's barrier on the card and nothing on the host, where one thread
// (tid = 0, nt = 1) runs a block's loops one after the other
#ifdef __CUDACC__
#define LW_SF __host__ __device__ __forceinline__
#define LW_SFM __host__ __device__ __forceinline__
#else
#define LW_SF static inline
#define LW_SFM inline
#endif
#ifdef __CUDA_ARCH__
#define LW_SF_SYNC() __syncthreads()
#define LW_SF_UNROLL _Pragma("unroll")
#else
#define LW_SF_SYNC() ((void)0)
#define LW_SF_UNROLL
#endif

LW_SF uint64_t lw_sf_mulhi64(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
    return __umul64hi(a, b);
#else
    return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

// p = 2^64 - 2^32 + 1, R = 2^64
struct LwGoldilocks {
    typedef uint64_t T;
    static constexpr int LIMBS = 2;
    static constexpr uint64_t P = 0xFFFFFFFF00000001ull;
    static constexpr uint64_t ONE = 0x00000000FFFFFFFFull;    // R mod p

    LW_SFM static T add(T a, T b) {
        const T s = a + b;  // a + b < 2p < 2^65: the carry is the 2^64 bit
        return (s < a || s >= P) ? s - P : s;
    }
    LW_SFM static T sub(T a, T b) { return a >= b ? a - b : a - b + P; }
    LW_SFM static T neg(T a) { return a ? P - a : 0; }
    // m = lo p^-1 = lo (2^32 + 1) mod 2^64 is lo + (lo << 32), carry e
    // dropped, and the high word of m p = m 2^64 - m (2^32 - 1) is
    // m - (m >> 32) - e: no second 64-bit product
    LW_SFM static T mul(T a, T b) {
        const T lo = a * b, hi = lw_sf_mulhi64(a, b);
        const T m = lo + (lo << 32);
        const T mh = m - (m >> 32) - (T)(m < lo);  // (m p) >> 64; (m p) mod 2^64 == lo
        return hi >= mh ? hi - mh : hi - mh + P;
    }
    LW_SFM static T sqn(T x, int k) {
        for (int i = 0; i < k; i++) x = mul(x, x);
        return x;
    }
    // 1/x = x^(p-2) (0 for x = 0): p - 2 = (2^31 - 1) 2^33 + (2^32 - 1), an
    // addition chain of 64 squarings and 9 products (e_k = x^(2^k - 1))
    LW_SFM static T inv(T x) {
        const T e2 = mul(sqn(x, 1), x), e3 = mul(sqn(e2, 1), x);
        const T e6 = mul(sqn(e3, 3), e3), e12 = mul(sqn(e6, 6), e6);
        const T e24 = mul(sqn(e12, 12), e12), e30 = mul(sqn(e24, 6), e6);
        const T e31 = mul(sqn(e30, 1), x), e32 = mul(sqn(e31, 1), x);
        return mul(sqn(e31, 33), e32);
    }
    LW_SFM static T load(const int32_t* x, long ls, long off) {
        return (uint64_t)(uint32_t)x[off] | ((uint64_t)(uint32_t)x[off + ls] << 32);
    }
    LW_SFM static void store(int32_t* x, long ls, long off, T v) {
        x[off] = (int32_t)(uint32_t)v;
        x[off + ls] = (int32_t)(uint32_t)(v >> 32);
    }
};

// p = 15 * 2^27 + 1, R = 2^32
struct LwBabyBear {
    typedef uint32_t T;
    static constexpr int LIMBS = 1;
    static constexpr uint32_t P = 0x78000001u;
    static constexpr uint32_t P_INV = 0x88000001u;  // p^-1 mod 2^32
    static constexpr uint32_t ONE = 0x0FFFFFFEu;    // R mod p

    LW_SFM static T add(T a, T b) {
        const T s = a + b;  // < 2p < 2^32
        return s >= P ? s - P : s;
    }
    LW_SFM static T sub(T a, T b) { return a >= b ? a - b : a - b + P; }
    LW_SFM static T neg(T a) { return a ? P - a : 0; }
    LW_SFM static T mul(T a, T b) {
        const uint64_t t = (uint64_t)a * b;
        const uint32_t m = (uint32_t)t * P_INV;
        const uint32_t th = (uint32_t)(t >> 32), mh = (uint32_t)(((uint64_t)m * P) >> 32);
        return th >= mh ? th - mh : th - mh + P;
    }
    // 1/x = x^(p-2) (0 for x = 0), bit by bit: 30 squarings, 29 products
    LW_SFM static T inv(T x) {
        T acc = x;
        for (int b = 29; b >= 0; b--) {
            acc = mul(acc, acc);
            if (((P - 2) >> b) & 1) acc = mul(acc, x);
        }
        return acc;
    }
    LW_SFM static T load(const int32_t* x, long, long off) { return (uint32_t)x[off]; }
    LW_SFM static void store(int32_t* x, long, long off, T v) { x[off] = (int32_t)v; }
};

// an exponent of up to 256 bits, least significant word first
struct LwSfExponent {
    uint32_t w[8];
};

// Elements of the degree-D tower over F (D = 1, 2, 4) as arrays of D base
// values; nr is the level-1 non-residue in Montgomery form.
template <class F, int D>
struct LwExt {
    typedef typename F::T T;
    static constexpr int H = D / 2;

    LW_SFM static void add(const T* a, const T* b, T* r) {
        for (int c = 0; c < D; c++) r[c] = F::add(a[c], b[c]);
    }
    LW_SFM static void sub(const T* a, const T* b, T* r) {
        for (int c = 0; c < D; c++) r[c] = F::sub(a[c], b[c]);
    }
    LW_SFM static void neg(const T* a, T* r) {
        for (int c = 0; c < D; c++) r[c] = F::neg(a[c]);
    }
    LW_SFM static void one(T* r) {
        r[0] = F::ONE;
        for (int c = 1; c < D; c++) r[c] = 0;
    }

    // r = x * (the non-residue of level D), x in the half field
    LW_SFM static void mul_res(const T* x, T* r, T nr) {
        if constexpr (H == 1) {
            r[0] = F::mul(nr, x[0]);
        } else {  // (x0 + x1 u) u = nr x1 + x0 u
            const T x0 = x[0];
            r[0] = F::mul(nr, x[1]);
            r[1] = x0;
        }
    }

    LW_SFM static void mul(const T* a, const T* b, T* r, T nr) {
        if constexpr (D == 1) {
            r[0] = F::mul(a[0], b[0]);
        } else {
            typedef LwExt<F, H> Half;
            T t0[H], t1[H], sa[H], sb[H], mid[H];
            Half::mul(a, b, t0, nr);
            Half::mul(a + H, b + H, t1, nr);
            Half::add(a, a + H, sa);
            Half::add(b, b + H, sb);
            Half::mul(sa, sb, mid, nr);
            Half::sub(mid, t0, mid);
            Half::sub(mid, t1, mid);
            mul_res(t1, t1, nr);
            Half::add(t0, t1, r);
            for (int c = 0; c < H; c++) r[H + c] = mid[c];
        }
    }

    LW_SFM static void pow(const T* a, const LwSfExponent& e, int nbits, T* r, T nr) {
        T acc[D], x[D];
        for (int c = 0; c < D; c++) x[c] = a[c];
        one(acc);
        for (int b = nbits - 1; b >= 0; b--) {
            mul(acc, acc, acc, nr);
            if ((e.w[b >> 5] >> (b & 31)) & 1) mul(acc, x, acc, nr);
        }
        for (int c = 0; c < D; c++) r[c] = acc[c];
    }

    // the norm of a down to F, zero only for a = 0 (D = 1: a itself); for
    // D = 4 also n1, the E2 norm a0^2 - u a1^2 that lift needs
    LW_SFM static T norm(const T* a, T* n1, T nr) {
        if constexpr (D == 1) {
            return a[0];
        } else {
            typedef LwExt<F, H> Half;
            T s0[H], s1[H];
            Half::mul(a, a, s0, nr);
            Half::mul(a + H, a + H, s1, nr);
            mul_res(s1, s1, nr);
            Half::sub(s0, s1, s0);  // a0^2 - res a1^2
            if constexpr (H == 1) {
                return s0[0];
            } else {
                for (int c = 0; c < H; c++) n1[c] = s0[c];
                return Half::norm(s0, nullptr, nr);
            }
        }
    }

    // r = 1/a from ninv = 1/norm(a): 1/(a0 + a1 x) = (a0 - a1 x) / (a0^2 -
    // res a1^2) at each level
    LW_SFM static void lift(const T* a, const T* n1, T ninv, T* r, T nr) {
        if constexpr (D == 1) {
            r[0] = ninv;
        } else {
            typedef LwExt<F, H> Half;
            T hinv[H], t[H];
            if constexpr (H == 1) {
                hinv[0] = ninv;
            } else {
                Half::lift(n1, nullptr, ninv, hinv, nr);
            }
            Half::mul(a, hinv, r, nr);
            Half::neg(a + H, t);
            Half::mul(t, hinv, r + H, nr);
        }
    }
};

enum { LW_SF_ADD = 0, LW_SF_SUB = 1, LW_SF_MUL = 2, LW_SF_NEG = 3, LW_SF_SQUARE = 4,
       LW_SF_POW = 5, LW_SF_INV = 6 };

// The work of one thread of small_field_op_kernel: `op` (not LW_SF_INV,
// which lw_sf_inv_block does) on element i of
// the (D*L, n) operands, component c, limb l of an operand at
// (c*L + l) * ls + i * es, the result into the contiguous (D*L, n) out.
template <class F, int D>
LW_SF void lw_sf_op_element(int op, const int32_t* a, long a_ls, long a_es, const int32_t* b,
                            long b_ls, long b_es, int32_t* out, long n, long i,
                            typename F::T nr, const LwSfExponent& e, int nbits) {
    typedef typename F::T T;
    typedef LwExt<F, D> E;
    T x[D], y[D], r[D];
    for (int c = 0; c < D; c++) x[c] = F::load(a, a_ls, (long)c * F::LIMBS * a_ls + i * a_es);
    if (op <= LW_SF_MUL) {
        for (int c = 0; c < D; c++) y[c] = F::load(b, b_ls, (long)c * F::LIMBS * b_ls + i * b_es);
    }
    switch (op) {
        case LW_SF_ADD: E::add(x, y, r); break;
        case LW_SF_SUB: E::sub(x, y, r); break;
        case LW_SF_MUL: E::mul(x, y, r, nr); break;
        case LW_SF_NEG: E::neg(x, r); break;
        case LW_SF_SQUARE: E::mul(x, x, r, nr); break;
        default: E::pow(x, e, nbits, r, nr); break;
    }
    for (int c = 0; c < D; c++) F::store(out, n, (long)c * F::LIMBS * n + i, r[c]);
}

// Batch inversion, zeros to zero: the work of block `block` of `threads`
// threads (a power of two) of small_field_inv_kernel, over the same
// operand layout as lw_sf_op_element.  The block takes threads * K
// elements; thread t takes elements e0 + k * threads + t, k < K, so that
// neighbouring threads read neighbouring words.
//
//   1. each thread loads its K elements, takes each one's base norm (1 for
//      a zero element or one past n) and keeps the norms' prefix products
//      in registers; its total goes to leaf t of `tree` (2 * threads
//      values of shared memory);
//   2. a product tree over the leaves, level by level: tree[1] is the
//      block's product;
//   3. one Fermat power inverts it (F::inv);
//   4. down the tree, node m's inverse times its sibling's product is its
//      child's inverse: each leaf ends as 1 / (its thread's total).  The
//      nodes of a level are computed by the block's first threads, so few
//      warps issue the tree's products (a tree whose levels inside a warp
//      took only the warp's barrier, each node computed by the thread of
//      its first leaf, spread them over every warp and ran slower);
//   5. each thread walks back over its elements: 1/norm_k = 1/prefix_k *
//      prefix_(k-1), 1/prefix_(k-1) = 1/prefix_k * norm_k, lifts 1/norm_k
//      to E_D and writes it (0 for a zero element).
//
// Each value is read once and written once; a nonzero element costs 3 base
// products and its tower's norm and lift.  Each loop runs over thread
// indices in the form t = tid, tid + nt, ...: on the card SLOTS = 1 and nt
// = threads, and a thread keeps its elements in registers across the
// barriers; on the host SLOTS = threads with tid = 0, nt = 1, so one
// thread computes what the block computes
// (tests/test_torch_small_fields.py builds it with g++).
template <class F, int D, int K, int SLOTS>
LW_SF void lw_sf_inv_block(const int32_t* a, long a_ls, long a_es, int32_t* out, long n,
                           typename F::T nr, long block, int threads, int tid, int nt,
                           typename F::T* tree) {
    typedef typename F::T T;
    typedef LwExt<F, D> E;
    constexpr int N1 = D > 2 ? D / 2 : 1;
    T x[SLOTS][K][D], n1[SLOTS][K][N1], nrm[SLOTS][K], pre[SLOTS][K];
    unsigned zero[SLOTS];
    const long e0 = block * (long)threads * K;

    for (int q = 0, t = tid; q < SLOTS && t < threads; q++, t += nt) {
        T acc = F::ONE;
        zero[q] = 0;
        LW_SF_UNROLL
        for (int k = 0; k < K; k++) {
            const long i = e0 + (long)k * threads + t;
            T v = F::ONE;
            if (i < n) {
                for (int c = 0; c < D; c++)
                    x[q][k][c] = F::load(a, a_ls, (long)c * F::LIMBS * a_ls + i * a_es);
                v = E::norm(x[q][k], n1[q][k], nr);
                if (v == 0) {
                    zero[q] |= 1u << k;
                    v = F::ONE;
                }
            }
            nrm[q][k] = v;
            acc = k ? F::mul(acc, v) : v;
            pre[q][k] = acc;
        }
        tree[threads + t] = acc;
    }
    for (int h = threads >> 1; h >= 1; h >>= 1) {
        LW_SF_SYNC();
        for (int idx = tid; idx < h; idx += nt)
            tree[h + idx] = F::mul(tree[2 * (h + idx)], tree[2 * (h + idx) + 1]);
    }
    LW_SF_SYNC();
    for (int idx = tid; idx < 1; idx += nt) tree[1] = F::inv(tree[1]);
    for (int h = 1; h < threads; h <<= 1) {
        LW_SF_SYNC();
        for (int idx = tid; idx < h; idx += nt) {
            const int m = h + idx;
            const T inv = tree[m], l = tree[2 * m], r = tree[2 * m + 1];
            tree[2 * m] = F::mul(inv, r);
            tree[2 * m + 1] = F::mul(inv, l);
        }
    }
    LW_SF_SYNC();
    for (int q = 0, t = tid; q < SLOTS && t < threads; q++, t += nt) {
        T acc = tree[threads + t];
        LW_SF_UNROLL
        for (int k = K - 1; k >= 0; k--) {
            const long i = e0 + (long)k * threads + t;
            const T ninv = k ? F::mul(acc, pre[q][k - 1]) : acc;
            if (k) acc = F::mul(acc, nrm[q][k]);
            if (i < n) {
                T r[D];
                if ((zero[q] >> k) & 1) {
                    for (int c = 0; c < D; c++) r[c] = 0;
                } else {
                    E::lift(x[q][k], n1[q][k], ninv, r, nr);
                }
                for (int c = 0; c < D; c++) F::store(out, n, (long)c * F::LIMBS * n + i, r[c]);
            }
        }
    }
}
