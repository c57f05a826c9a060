// Elementwise Stark252 arithmetic on (8, N) limb planes (kernel 3).
//
// Replaces XLA code, not a Pallas kernel: the JAX package runs field
// arithmetic as fused 16-bit-digit XLA programs
// (lambda_elliptic_curves_tpu/ops/limbs.py: add :600, sub :610, neg :624,
// mont_mul :750, mont_square :829, mont_pow :860, mont_inv :890).  Built
// from torch ops, one 256-bit multiply would be dozens of launches; here it
// is one thread per element.  Batch inversion is batch_inverse.cu.
//
// Bound on this card: a multiply reads 64 bytes and writes 32 for about
// 170 integer instructions, so mul is close to the memory roofline and add /
// sub are memory bound; pow (a^(p-2): 252 squarings and 194 multiplies per
// element) is bound by the 32-bit multiply rate.  Design:
// one thread per element, limbs read plane by plane so that neighbouring
// threads read neighbouring words; an operand that is one value broadcast
// over the batch is read with element stride 0, so constants are never
// materialised.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mont.cuh"

enum { OP_ADD = 0, OP_SUB = 1, OP_MUL = 2, OP_NEG = 3, OP_SQUARE = 4 };

struct Exponent {
    uint32_t w[LW_LIMBS];
};

__device__ __forceinline__ void load(const int32_t* x, long ls, long es,
                                     long i, uint32_t v[LW_LIMBS]) {
#pragma unroll
    for (int k = 0; k < LW_LIMBS; k++) v[k] = (uint32_t)x[k * ls + i * es];
}

__global__ void field_op_kernel(int op, const int32_t* a, long a_ls,
                                long a_es, const int32_t* b, long b_ls,
                                long b_es, int32_t* out, long n) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t x[LW_LIMBS], y[LW_LIMBS], r[LW_LIMBS];
    load(a, a_ls, a_es, i, x);
    switch (op) {
        case OP_ADD: load(b, b_ls, b_es, i, y); lw_add(x, y, r); break;
        case OP_SUB: load(b, b_ls, b_es, i, y); lw_sub(x, y, r); break;
        case OP_MUL: load(b, b_ls, b_es, i, y); lw_mont_mul(x, y, r); break;
        case OP_NEG: lw_neg(x, r); break;
        default: lw_mont_sqr(x, r); break;
    }
#pragma unroll
    for (int k = 0; k < LW_LIMBS; k++) out[k * n + i] = (int32_t)r[k];
}

__global__ void field_pow_kernel(const int32_t* a, long a_ls, long a_es,
                                 int32_t* out, long n, Exponent e,
                                 int nbits) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t x[LW_LIMBS], r[LW_LIMBS];
    load(a, a_ls, a_es, i, x);
    lw_mont_pow(x, e.w, nbits, r);
#pragma unroll
    for (int k = 0; k < LW_LIMBS; k++) out[k * n + i] = (int32_t)r[k];
}

static const int kThreads = 256;

extern "C" int lw_field_op(int op, const int32_t* a, long a_ls, long a_es,
                           const int32_t* b, long b_ls, long b_es,
                           int32_t* out, long n, void* stream) {
    if (n > 0) {
        long blocks = (n + kThreads - 1) / kThreads;
        field_op_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            op, a, a_ls, a_es, b, b_ls, b_es, out, n);
    }
    return (int)cudaGetLastError();
}

extern "C" int lw_field_pow(const int32_t* a, long a_ls, long a_es,
                            int32_t* out, long n, const uint32_t* exponent,
                            int nbits, void* stream) {
    Exponent e;
    for (int k = 0; k < LW_LIMBS; k++) e.w[k] = exponent[k];
    if (n > 0) {
        long blocks = (n + kThreads - 1) / kThreads;
        field_pow_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
            a, a_ls, a_es, out, n, e, nbits);
    }
    return (int)cudaGetLastError();
}
