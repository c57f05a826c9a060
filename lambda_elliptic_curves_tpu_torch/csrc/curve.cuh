// The Jacobian group law of the port's four curve groups, once: BN254 G1
// (over Fq, 4 words), BN254 G2 (over Fp2 = Fq[u]/(u^2 + 1)), BLS12-377 G1
// (over Fq, 6 words) and BLS12-377 G2 (over Fp2 = Fq[u]/(u^2 + 5)).  The
// group law that curve.cu (kernel 10: one op a lane, and the fixed-base
// comb, one lane's whole sum of table entries) and msm_bucket.cuh (kernel
// 11, Pippenger's bucket phase) run.
//
// Replaces the composition of kernel 8 launches in curves/weierstrass.py
// (JacobianOps.double, add, add_mixed and _complete; the JAX package's
// lambda_elliptic_curves_tpu/curves/weierstrass.py:253, :284, :322, XLA code
// and not a Pallas kernel), and for G2 the Fp2 products of
// fields/extensions.py DeviceQuadraticField.mul.  The formulas are exactly
// the plain version's: dbl-2007-bl with a = 0, the add-2007-bl core and
// the madd-2007-bl core, and the special cases resolved in _complete's
// precedence (p2 at infinity -> p1; p1 at infinity -> p2; same x, other
// y -> the neutral point (1, 1, 0); same x and y -> double(p1)).  Every
// field op is strict (dense32.cuh: canonical in and out), so every value
// here is the plain composition's, limb for limb, and the host tests
// (tests/test_torch_curve_kernels.py) compare bitwise.  The doubling of an
// addition is a branch, taken only on the lanes that need it.
//
// The field arithmetic is dense32.cuh's: the carry-chain Montgomery
// product on 2 W 32-bit limbs (184 SASS instructions at four words and
// 504 at six, against the 680 and 1608 of dense.cuh's 64-bit CIOS: sm_90
// has no 64-bit multiplier) and its carry-chain sums.  A value is held in
// registers as the tensors' own 32-bit limbs, so a load or a store is a
// copy; an Fp2 value is component 0, then component 1, as the
// DeviceQuadraticField layout has them in a tensor.  A point is the
// Jacobian triple (x, y, z), infinity z = 0.
#pragma once

#include <stdint.h>

#include "dense32.cuh"

// The product of two base-field values and the three group ops are
// functions of their own, called from every formula and every kernel:
// inlined, one G2 instance of kernel 11 was tens of thousands of
// instructions long and ptxas took minutes over it.
#ifdef __CUDACC__
#define LW_CURVE_MUL __host__ __device__ __noinline__
#define LW_CURVE_FN __host__ __device__ __noinline__
#else
#define LW_CURVE_MUL static inline
#define LW_CURVE_FN inline
#endif

template <class Q>
struct LwFqValue {
    uint32_t w[2 * Q::W];
};

template <class Q>
LW_CURVE_MUL LwFqValue<Q> lw_fq_mul(LwFqValue<Q> a, LwFqValue<Q> b) {
    LwFqValue<Q> r;
    lw_d32_mul<Q>(a.w, b.w, r.w);
    return r;
}

// 16 bytes at p (16-byte aligned) as four limbs: one vector load on the card
LW_HD void lw_load16(const int32_t* p, uint32_t* r) {
#ifdef __CUDA_ARCH__
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
#else
    for (int k = 0; k < 4; k++) r[k] = (uint32_t)p[k];
#endif
}

// a base field (BN254 Fq, BLS12-377 Fq) as the group law takes it
template <class Q>
struct LwFq {
    typedef LwFqValue<Q> E;
    static constexpr int ROWS = 2 * Q::W;  // int32 rows of a value in a tensor

    LW_HDM static void add(const E& a, const E& b, E& r) { lw_d32_add<Q>(a.w, b.w, r.w); }
    LW_HDM static void sub(const E& a, const E& b, E& r) { lw_d32_sub<Q>(a.w, b.w, r.w); }
    LW_HDM static void mul(const E& a, const E& b, E& r) { r = lw_fq_mul<Q>(a, b); }
    LW_HDM static bool is_zero(const E& a) {
        uint32_t acc = 0;
#pragma unroll
        for (int i = 0; i < ROWS; i++) acc |= a.w[i];
        return acc == 0;
    }
    LW_HDM static void set_one(E& r) {  // R mod p
#pragma unroll
        for (int i = 0; i < ROWS; i++) r.w[i] = (uint32_t)(Q::one(i >> 1) >> (32 * (i & 1)));
    }
    LW_HDM static void set_zero(E& r) {
#pragma unroll
        for (int i = 0; i < ROWS; i++) r.w[i] = 0;
    }
    // row k of the value at p[k * ls + off]
    LW_HDM static void load(const int32_t* p, long ls, long off, E& r) {
#pragma unroll
        for (int i = 0; i < ROWS; i++) r.w[i] = (uint32_t)p[i * ls + off];
    }
    // the value's limbs contiguous at p, 16-byte aligned (a comb table entry)
    LW_HDM static void load_entry(const int32_t* p, E& r) {
#pragma unroll
        for (int i = 0; i < ROWS; i += 4) lw_load16(p + i, r.w + i);
    }
    LW_HDM static void store(int32_t* p, long ls, long off, const E& a) {
#pragma unroll
        for (int i = 0; i < ROWS; i++) p[i * ls + off] = (int32_t)a.w[i];
    }
};

// Fp2 = Fq[u] / (u^2 - NR), NR a small negative integer (-1 for BN254,
// -5 for BLS12-377, the non-residues that curves/twists.py builds)
template <class Q, int NR>
struct LwFp2 {
    static_assert(NR < 0 && NR >= -8, "a small negative non-residue");
    typedef LwFq<Q> B;
    struct E {
        typename B::E c0, c1;
    };
    static constexpr int ROWS = 2 * B::ROWS;

    LW_HDM static void add(const E& a, const E& b, E& r) {
        B::add(a.c0, b.c0, r.c0);
        B::add(a.c1, b.c1, r.c1);
    }
    LW_HDM static void sub(const E& a, const E& b, E& r) {
        B::sub(a.c0, b.c0, r.c0);
        B::sub(a.c1, b.c1, r.c1);
    }
    // Karatsuba, as DeviceQuadraticField.mul: t0 = a0 b0, t1 = a1 b1,
    // (a0 b1 + a1 b0) = (a0 + a1)(b0 + b1) - t0 - t1, a0 b0 + NR a1 b1
    LW_HDM static void mul(const E& a, const E& b, E& r) {
        typename B::E t0, t1, sa, sb, s, k;
        B::mul(a.c0, b.c0, t0);
        B::mul(a.c1, b.c1, t1);
        B::add(a.c0, a.c1, sa);
        B::add(b.c0, b.c1, sb);
        B::mul(sa, sb, s);
        B::sub(s, t0, s);
        B::sub(s, t1, r.c1);
        k = t1;  // k = -NR t1
#pragma unroll
        for (int j = 1; j < -NR; j++) B::add(k, t1, k);
        B::sub(t0, k, r.c0);
    }
    LW_HDM static bool is_zero(const E& a) { return B::is_zero(a.c0) && B::is_zero(a.c1); }
    LW_HDM static void set_one(E& r) {
        B::set_one(r.c0);
        B::set_zero(r.c1);
    }
    LW_HDM static void set_zero(E& r) {
        B::set_zero(r.c0);
        B::set_zero(r.c1);
    }
    LW_HDM static void load(const int32_t* p, long ls, long off, E& r) {
        B::load(p, ls, off, r.c0);
        B::load(p + B::ROWS * ls, ls, off, r.c1);
    }
    LW_HDM static void load_entry(const int32_t* p, E& r) {
        B::load_entry(p, r.c0);
        B::load_entry(p + B::ROWS, r.c1);
    }
    LW_HDM static void store(int32_t* p, long ls, long off, const E& a) {
        B::store(p, ls, off, a.c0);
        B::store(p + B::ROWS * ls, ls, off, a.c1);
    }
};

// Jacobian points over the field F (a = 0: every curve here is y^2 = x^3 + b)
template <class Fld>
struct LwJacobian {
    typedef Fld F;
    typedef typename F::E E;
    struct P {
        E x, y, z;
    };
    static constexpr int ROWS = F::ROWS;

    LW_HDM static void neutral(P& r) {
        F::set_one(r.x);
        F::set_one(r.y);
        F::set_zero(r.z);
    }
    LW_HDM static bool is_inf(const P& p) { return F::is_zero(p.z); }

    // dbl-2007-bl, a = 0 (JacobianOps.double_plain): infinity (1, 1, 0) maps
    // to itself, a point with y = 0 to z = 0
    LW_CURVE_FN static void dbl(const P& p, P& r) {
        E xx, yy, yyyy, zz, s, m, t, u;
        F::mul(p.x, p.x, xx);
        F::mul(p.y, p.y, yy);
        F::mul(yy, yy, yyyy);
        F::mul(p.z, p.z, zz);
        F::add(p.x, yy, t);
        F::mul(t, t, s);
        F::add(xx, yyyy, t);
        F::sub(s, t, s);
        F::add(s, s, s);  // s = 2 ((x + yy)^2 - xx - yyyy)
        F::add(xx, xx, m);
        F::add(xx, m, m);  // m = 3 xx
        E x3, y3, z3;
        F::mul(m, m, x3);
        F::add(s, s, t);
        F::sub(x3, t, x3);  // x3 = m^2 - 2 s
        F::add(yyyy, yyyy, t);
        F::add(t, t, t);
        F::add(t, t, t);  // 8 yyyy
        F::sub(s, x3, u);
        F::mul(m, u, y3);
        F::sub(y3, t, y3);  // y3 = m (s - x3) - 8 yyyy
        F::add(p.y, p.z, u);
        F::mul(u, u, z3);
        F::add(yy, zz, t);
        F::sub(z3, t, z3);  // z3 = (y + z)^2 - yy - zz
        r.x = x3;
        r.y = y3;
        r.z = z3;
    }

    // The generic result from u1, s1, h, r (the shared tail of add-2007-bl
    // and madd-2007-bl), and the special cases of _complete for h = 0:
    // same y -> double(p1), other y -> the neutral point.  z1z2 is Z1 Z2
    // (add) or Z1 (mixed).
    LW_HDM static void finish(const P& p1, const E& u1, const E& s1, const E& h, const E& rr,
                              const E& z1z2, P& out) {
        if (F::is_zero(h)) {
            if (F::is_zero(rr)) dbl(p1, out);
            else neutral(out);
            return;
        }
        E hh, hhh, v, t, x3, y3, z3;
        F::mul(h, h, hh);
        F::mul(h, hh, hhh);
        F::mul(u1, hh, v);
        F::mul(rr, rr, x3);
        F::sub(x3, hhh, x3);
        F::add(v, v, t);
        F::sub(x3, t, x3);  // x3 = r^2 - hhh - 2 v
        F::sub(v, x3, t);
        F::mul(rr, t, y3);
        F::mul(s1, hhh, t);
        F::sub(y3, t, y3);  // y3 = r (v - x3) - s1 hhh
        F::mul(z1z2, h, z3);
        out.x = x3;
        out.y = y3;
        out.z = z3;
    }

    // complete addition, add-2007-bl core (JacobianOps.add_plain)
    LW_CURVE_FN static void add(const P& p1, const P& p2, P& out) {
        if (is_inf(p2)) {
            out = p1;
            return;
        }
        if (is_inf(p1)) {
            out = p2;
            return;
        }
        E z1z1, z2z2, u1, u2, s1, s2, h, rr, t;
        F::mul(p1.z, p1.z, z1z1);
        F::mul(p2.z, p2.z, z2z2);
        F::mul(p1.x, z2z2, u1);
        F::mul(p2.x, z1z1, u2);
        F::mul(p1.y, p2.z, t);
        F::mul(t, z2z2, s1);
        F::mul(p2.y, p1.z, t);
        F::mul(t, z1z1, s2);
        F::sub(u2, u1, h);
        F::sub(s2, s1, rr);
        F::mul(p1.z, p2.z, t);
        finish(p1, u1, s1, h, rr, t, out);
    }

    // complete mixed addition, madd-2007-bl core (JacobianOps.add_mixed_plain):
    // p2 affine (z = 1) or infinity (z = 0)
    LW_CURVE_FN static void add_mixed(const P& p1, const P& p2, P& out) {
        if (is_inf(p2)) {
            out = p1;
            return;
        }
        if (is_inf(p1)) {
            out = p2;
            return;
        }
        E z1z1, u2, s2, h, rr, t;
        F::mul(p1.z, p1.z, z1z1);
        F::mul(p2.x, z1z1, u2);
        F::mul(p2.y, p1.z, t);
        F::mul(t, z1z1, s2);
        F::sub(u2, p1.x, h);
        F::sub(s2, p1.y, rr);
        finish(p1, p1.x, p1.y, h, rr, p1.z, out);
    }
};

typedef LwJacobian<LwFq<LwBn254FqParams>> LwBn254G1;
typedef LwJacobian<LwFp2<LwBn254FqParams, -1>> LwBn254G2;
typedef LwJacobian<LwFq<LwBls12377FqParams>> LwBls12377G1;
typedef LwJacobian<LwFp2<LwBls12377FqParams, -5>> LwBls12377G2;

// the groups' numbers in the C entries of kernels 10 and 11
enum { LW_CURVE_BN254_G1 = 0, LW_CURVE_BN254_G2 = 1, LW_CURVE_BLS12_377_G1 = 2,
       LW_CURVE_BLS12_377_G2 = 3 };
// kernel 10's ops
enum { LW_CURVE_ADD = 0, LW_CURVE_ADD_MIXED = 1, LW_CURVE_DOUBLE = 2 };

// A set of points in three (ROWS, ...) int32 tensors, one a coordinate:
// row k of element i of coordinate c at p[c][k * ls[c] + i * es[c]]
// (es = 0 broadcasts one point).  As C arguments: 9 longs, the three
// pointers, the three row strides, the three element strides.
struct LwPoints {
    const int32_t* p[3];
    long ls[3];
    long es[3];
};

LW_HD LwPoints lw_points_arg(const long* d) {
    LwPoints r;
    for (int c = 0; c < 3; c++) {
        r.p[c] = (const int32_t*)(uintptr_t)d[c];
        r.ls[c] = d[3 + c];
        r.es[c] = d[6 + c];
    }
    return r;
}

template <class G>
LW_HD void lw_load_point(const LwPoints& a, long i, typename G::P& r) {
    G::F::load(a.p[0], a.ls[0], i * a.es[0], r.x);
    G::F::load(a.p[1], a.ls[1], i * a.es[1], r.y);
    G::F::load(a.p[2], a.ls[2], i * a.es[2], r.z);
}

// element i of three contiguous (ROWS, n) planes
template <class G>
LW_HD void lw_store_point(int32_t* const out[3], long n, long i, const typename G::P& r) {
    G::F::store(out[0], n, i, r.x);
    G::F::store(out[1], n, i, r.y);
    G::F::store(out[2], n, i, r.z);
}

// Kernel 10's work on lane i: out_i = a_i op b_i (b unused by the doubling)
template <class G>
LW_HD void lw_curve_op_lane(int op, const LwPoints& a, const LwPoints& b, int32_t* const out[3],
                            long n, long i) {
    typename G::P p, q, r;
    lw_load_point<G>(a, i, p);
    if (op == LW_CURVE_DOUBLE) {
        G::dbl(p, r);
    } else {
        lw_load_point<G>(b, i, q);
        if (op == LW_CURVE_ADD) G::add(p, q, r);
        else G::add_mixed(p, q, r);
    }
    lw_store_point<G>(out, n, i, r);
}

// The fixed-base comb (kernel 10's comb entry): lane i is [s_i] G as the
// sum over windows w of table entry w 2^c + id_w(s_i), where entry
// w 2^c + d is d 2^(c w) G, affine.  The table is entry-major: entry e's x
// limbs, then its y limbs, contiguous (2 ROWS int32, a multiple of 16
// bytes, read with 16-byte loads), and inf[e] = 1 where the entry is the
// point at infinity (its x and y hold the neutral point's, 1 and 1).  The
// scalars are the (digit_rows, n) int64 16-bit digits, from which a lane
// takes window w's id, bits [w c, (w + 1) c), itself.  As C arguments, 7
// longs: table, inf, digits, the digits' row stride, c, windows,
// digit_rows.
struct LwComb {
    const int32_t* table;
    const uint8_t* inf;
    const int64_t* digits;
    long ls;
    int c, windows, digit_rows;
};

LW_HD LwComb lw_comb_arg(const long* d) {
    LwComb a;
    a.table = (const int32_t*)(uintptr_t)d[0];
    a.inf = (const uint8_t*)(uintptr_t)d[1];
    a.digits = (const int64_t*)(uintptr_t)d[2];
    a.ls = d[3];
    a.c = (int)d[4];
    a.windows = (int)d[5];
    a.digit_rows = (int)d[6];
    return a;
}

// window w's id of lane i (curves/msm.py's window_ids)
LW_HD long lw_comb_id(const LwComb& a, int w, long i) {
    const int bit = w * a.c, k = bit >> 4, s = bit & 15;
    long v = (long)(a.digits[k * a.ls + i] >> s);
    if (k + 1 < a.digit_rows) v |= (long)(a.digits[(k + 1) * a.ls + i] << (16 - s));
    return v & ((1L << a.c) - 1);
}

template <class G>
LW_HD void lw_comb_entry(const LwComb& a, long e, typename G::P& r) {
    const int32_t* p = a.table + e * (2 * G::ROWS);
    G::F::load_entry(p, r.x);
    G::F::load_entry(p + G::ROWS, r.y);
    if (a.inf[e]) G::F::set_zero(r.z);
    else G::F::set_one(r.z);
}

// The comb's work on lane i: window 0's entry, then one complete mixed
// addition a window in registers (fixed_base_multiples' order and special
// cases), the sum stored once
template <class G>
LW_HD void lw_curve_comb_lane(const LwComb& a, int32_t* const out[3], long n, long i) {
    typename G::P acc, q;
    lw_comb_entry<G>(a, lw_comb_id(a, 0, i), acc);
    for (int w = 1; w < a.windows; w++) {
        lw_comb_entry<G>(a, ((long)w << a.c) + lw_comb_id(a, w, i), q);
        G::add_mixed(acc, q, acc);
    }
    lw_store_point<G>(out, n, i, acc);
}

// Threads a block and the launch bound's least blocks an SM of kernel 10's
// instances, both entries, in every group: 128 threads with no bound.
// tools/sweep_curve.py (PERF.md) found no shape that ran the comb,
// the entry's work on the main path, more than a few percent faster
// (BN254 G1 and BLS12-377 G1 at 256 threads, and those lost on the op
// entry); a lower register cap spills in the G2 groups and was slower
enum { LW_CURVE_THREADS = 128, LW_CURVE_MIN_BLOCKS = 1 };

#ifdef __CUDACC__
#include <cuda_runtime.h>

// Kernel 10 (curve.cu): one group op over n lanes, one thread a lane
template <class G, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    curve_point_op_kernel(int op, LwPoints a, LwPoints b, int32_t* ox, int32_t* oy, int32_t* oz,
                          long n) {
    const long i = (long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    int32_t* const out[3] = {ox, oy, oz};
    lw_curve_op_lane<G>(op, a, b, out, n, i);
}

// Kernel 10's comb entry: the fixed-base comb over n lanes, one thread a lane
template <class G, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    curve_comb_kernel(LwComb a, int32_t* ox, int32_t* oy, int32_t* oz, long n) {
    const long i = (long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    int32_t* const out[3] = {ox, oy, oz};
    lw_curve_comb_lane<G>(a, out, n, i);
}

template <class G, int THREADS = LW_CURVE_THREADS, int MIN_BLOCKS = LW_CURVE_MIN_BLOCKS>
int lw_curve_op_run(int op, const LwPoints& a, const LwPoints& b, int32_t* ox, int32_t* oy,
                    int32_t* oz, long n, cudaStream_t stream) {
    const long blocks = (n + THREADS - 1) / THREADS;
    curve_point_op_kernel<G, THREADS, MIN_BLOCKS>
        <<<blocks, THREADS, 0, stream>>>(op, a, b, ox, oy, oz, n);
    return (int)cudaGetLastError();
}

template <class G, int THREADS = LW_CURVE_THREADS, int MIN_BLOCKS = LW_CURVE_MIN_BLOCKS>
int lw_curve_comb_run(const LwComb& a, int32_t* ox, int32_t* oy, int32_t* oz, long n,
                      cudaStream_t stream) {
    const long blocks = (n + THREADS - 1) / THREADS;
    curve_comb_kernel<G, THREADS, MIN_BLOCKS><<<blocks, THREADS, 0, stream>>>(a, ox, oy, oz, n);
    return (int)cudaGetLastError();
}

// kind 0 (the op entry) or 1 (the comb entry): out[0] threads a block,
// out[1] blocks an SM at once (the occupancy calculator), out[2] registers
// a thread, out[3] local memory bytes a thread (spills and stack)
template <class G, int THREADS = LW_CURVE_THREADS, int MIN_BLOCKS = LW_CURVE_MIN_BLOCKS>
int lw_curve_info_run(int kind, long* out) {
    const void* fn = kind == 0 ? (const void*)curve_point_op_kernel<G, THREADS, MIN_BLOCKS>
                               : (const void*)curve_comb_kernel<G, THREADS, MIN_BLOCKS>;
    cudaFuncAttributes attr;
    int blocks = 0;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    out[0] = THREADS;
    out[1] = blocks;
    out[2] = attr.numRegs;
    out[3] = (long)attr.localSizeBytes;
    return 0;
}

// kernel 10's G2 instances, built in a translation unit of their own
// (curve_g2.cu) beside the G1 instances (curve.cu)
int lw_curve_op_g2(int group, int op, const LwPoints& a, const LwPoints& b, int32_t* ox,
                   int32_t* oy, int32_t* oz, long n, cudaStream_t stream);
int lw_curve_comb_g2(int group, const LwComb& a, int32_t* ox, int32_t* oy, int32_t* oz, long n,
                     cudaStream_t stream);
int lw_curve_info_g2(int group, int kind, long* out);
#endif
