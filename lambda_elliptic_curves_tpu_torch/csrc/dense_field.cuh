// Kernel 8's work on one thread, over a dense field F = LwDense32<Q>
// (dense32.cuh: BN254 Fr and Fq and BLS12-377 Fr on 8 limbs, BLS12-377 Fq
// on 12): one op on E elements, or one element through a straight-line
// program of ops.  Kept in a header of __host__ __device__ functions so that
// g++ compiles the same code for the host (tests/test_torch_dense_kernels.py).
//
// Layout: an operand is (LIMBS, n) int32 limbs of x * R mod p; limb k of
// element i sits at k * ls + i * es, so a value that is broadcast over the
// batch is read with element stride es = 0 and never materialised.  The
// output is contiguous (LIMBS, n).
#pragma once

#include <stdint.h>

#include "dense32.cuh"

enum { LW_DN_ADD = 0, LW_DN_SUB = 1, LW_DN_MUL = 2, LW_DN_NEG = 3, LW_DN_SQUARE = 4,
       LW_DN_POW = 5 };

// an exponent of N u32 words, least significant first (a kernel parameter)
template <int N>
struct LwDnExponent {
    uint32_t w[N];
};

// limb k of element i at x[k * ls + i * es]
struct LwDnOperand {
    const int32_t* x;
    long ls, es;
};

template <class F>
LW_HD void lw_dn_load(const LwDnOperand& a, long i, uint32_t v[F::LIMBS]) {
#pragma unroll
    for (int k = 0; k < F::LIMBS; k++) v[k] = (uint32_t)a.x[k * a.ls + i * a.es];
}

template <class F>
LW_HD void lw_dn_store(int32_t* out, long n, long i, const uint32_t v[F::LIMBS]) {
#pragma unroll
    for (int k = 0; k < F::LIMBS; k++) out[k * n + i] = (int32_t)v[k];
}

// the E elements i0 + j * stride (j < E, those below n) of operand a: every
// limb load is issued before the caller's first product; a broadcast
// operand (es = 0) is read once
template <class F, int E>
LW_HD void lw_dn_load_elements(const LwDnOperand& a, long n, long i0, long stride,
                               uint32_t v[E][F::LIMBS]) {
#pragma unroll
    for (int j = 0; j < E; j++) {
        if (i0 + j * stride >= n) break;
        if (j == 0 || a.es != 0) {
            lw_dn_load<F>(a, i0 + j * stride, v[j]);
        } else {
#pragma unroll
            for (int k = 0; k < F::LIMBS; k++) v[j][k] = v[0][k];
        }
    }
}

// One op (LW_DN_ADD .. LW_DN_POW) on the E elements i0 + j * stride of a
// and b (b unused by neg, square and pow), into the contiguous (LIMBS, n)
// out.  e and nbits: LW_DN_POW's exponent.
template <class F, int OP, int E>
LW_HD void lw_dn_op_elements(const LwDnOperand& a, const LwDnOperand& b, int32_t* out, long n,
                             long i0, long stride, const uint32_t* e, int nbits) {
    constexpr int L = F::LIMBS;
    constexpr bool binary = OP == LW_DN_ADD || OP == LW_DN_SUB || OP == LW_DN_MUL;
    uint32_t x[E][L], y[binary ? E : 1][L];
    lw_dn_load_elements<F, E>(a, n, i0, stride, x);
    if (binary) lw_dn_load_elements<F, binary ? E : 1>(b, n, i0, stride, y);
#pragma unroll
    for (int j = 0; j < E; j++) {
        const long i = i0 + j * stride;
        if (i >= n) break;
        uint32_t r[L];
        switch (OP) {
            case LW_DN_ADD: F::add(x[j], y[binary ? j : 0], r); break;
            case LW_DN_SUB: F::sub(x[j], y[binary ? j : 0], r); break;
            case LW_DN_MUL: F::mul(x[j], y[binary ? j : 0], r); break;
            case LW_DN_NEG: F::neg(x[j], r); break;
            case LW_DN_SQUARE: F::mul(x[j], x[j], r); break;
            default: F::pow(x[j], e, nbits, r); break;
        }
        lw_dn_store<F>(out, n, i, r);
    }
}

// A straight-line program (kernel 8's program entry): steps of add, sub,
// mul, neg and square over up to LW_DN_PROG_INPUTS input operands, whose
// results go to `slots` (at most LW_DN_PROG_SLOTS) slots of a thread: limb
// l of slot s at slot[(s LIMBS + l) stride], in shared memory on the card
// (a dynamic index cannot name a register, and a thread's local memory
// does not stay in L1 at a full SM's threads).  An operand index k names
// input k below `inputs`, else slot k - inputs; a step of neg or square
// reads its a only.  The output is slot `out`.
#define LW_DN_PROG_INPUTS 32
#define LW_DN_PROG_STEPS 64
#define LW_DN_PROG_SLOTS 16

struct LwDnProgram {
    LwDnOperand in[LW_DN_PROG_INPUTS];
    uint8_t op[LW_DN_PROG_STEPS], dst[LW_DN_PROG_STEPS], a[LW_DN_PROG_STEPS],
        b[LW_DN_PROG_STEPS];
    int inputs, steps, out, slots;
};

template <class F>
LW_HD void lw_dn_prog_operand(const LwDnProgram& P, int k, long i, const uint32_t* slot,
                              int stride, uint32_t v[F::LIMBS]) {
    if (k < P.inputs) {
        lw_dn_load<F>(P.in[k], i, v);
    } else {
        const uint32_t* s = slot + (k - P.inputs) * F::LIMBS * stride;
#pragma unroll
        for (int l = 0; l < F::LIMBS; l++) v[l] = s[l * stride];
    }
}

// element i of the program's output into the contiguous (LIMBS, n) out,
// on the thread's P.slots slots at slot (see above)
template <class F>
LW_HD void lw_dn_program_element(const LwDnProgram& P, int32_t* out, long n, long i,
                                 uint32_t* slot, int stride) {
    constexpr int L = F::LIMBS;
    for (int s = 0; s < P.steps; s++) {
        const int op = P.op[s];
        uint32_t x[L], y[L], r[L];
        // neg is 0 - a and square a * a: three code paths
        if (op == LW_DN_NEG) {
#pragma unroll
            for (int l = 0; l < L; l++) x[l] = 0;
            lw_dn_prog_operand<F>(P, P.a[s], i, slot, stride, y);
        } else {
            lw_dn_prog_operand<F>(P, P.a[s], i, slot, stride, x);
            if (op == LW_DN_SQUARE) {
#pragma unroll
                for (int l = 0; l < L; l++) y[l] = x[l];
            } else {
                lw_dn_prog_operand<F>(P, P.b[s], i, slot, stride, y);
            }
        }
        if (op == LW_DN_ADD) F::add(x, y, r);
        else if (op == LW_DN_MUL || op == LW_DN_SQUARE) F::mul(x, y, r);
        else F::sub(x, y, r);
        uint32_t* d = slot + P.dst[s] * L * stride;
#pragma unroll
        for (int l = 0; l < L; l++) d[l * stride] = r[l];
    }
    uint32_t r[L];
    lw_dn_prog_operand<F>(P, P.inputs + P.out, i, slot, stride, r);
    lw_dn_store<F>(out, n, i, r);
}

// P from the C entry's arrays (see lw_dense_field_program), its slots the
// highest written one plus one, and whether it is well formed: sizes in
// range, every operand an input or a slot already written, the output a
// written slot
LW_HD bool lw_dn_program_make(LwDnProgram& P, int n_inputs, const int32_t* const* inputs,
                              const long* ls, const long* es, int steps, const uint8_t* op,
                              const uint8_t* dst, const uint8_t* a, const uint8_t* b,
                              int out_slot) {
    if (n_inputs < 0 || n_inputs > LW_DN_PROG_INPUTS || steps < 1 || steps > LW_DN_PROG_STEPS)
        return false;
    P.inputs = n_inputs;
    P.steps = steps;
    P.out = out_slot;
    for (int k = 0; k < n_inputs; k++) P.in[k] = {inputs[k], ls[k], es[k]};
    uint32_t written = 0;
    P.slots = 0;
    for (int s = 0; s < steps; s++) {
        P.op[s] = op[s];
        P.dst[s] = dst[s];
        P.a[s] = a[s];
        P.b[s] = b[s];
        if (op[s] > LW_DN_SQUARE || dst[s] >= LW_DN_PROG_SLOTS) return false;
        const int n_src = op[s] == LW_DN_NEG || op[s] == LW_DN_SQUARE ? 1 : 2;
        for (int q = 0; q < n_src; q++) {
            const int k = q ? b[s] : a[s];
            if (k >= n_inputs && (k - n_inputs >= LW_DN_PROG_SLOTS ||
                                  !((written >> (k - n_inputs)) & 1u)))
                return false;
        }
        written |= 1u << dst[s];
        if (dst[s] >= P.slots) P.slots = dst[s] + 1;
    }
    return out_slot >= 0 && out_slot < LW_DN_PROG_SLOTS && ((written >> out_slot) & 1u);
}
