// Elementwise arithmetic over the dense fields (kernel 8,
// dense_field_op_kernel): BN254 Fr and Fq and BLS12-377 Fr on 4 64-bit
// words, BLS12-377 Fq on 6 (dense.cuh).
//
// Replaces XLA code, not a Pallas kernel: the JAX package runs these fields
// as 16-bit-digit XLA programs (lambda_elliptic_curves_tpu/ops/limbs.py
// mont_mul :750, add :600, sub :610, neg :624, mont_square :829, mont_pow
// :860).  Plonk's round-3 quotient runs on it over BN254 Fr, Groth16's QAP
// over BLS12-377 Fr, and the curves' elementwise Fq work (affine
// conversions, the comb's table; G2's Fp2 ops compose it,
// fields/extensions.py).  The group law runs on kernels 10 and 11
// (curve.cu, msm_bucket.cu).
//
// Layout: an operand is (LIMBS, n) int32 limbs of x * R mod p (LIMBS = 8,
// R = 2^256, or LIMBS = 12, R = 2^384); limb k of
// element i sits at k * ls + i * es, so a value that is broadcast over the
// batch is read with element stride es = 0 and never materialised.  The
// output is contiguous (LIMBS, n).  One thread an element.
//
// Bound on this card: bytes for add, sub and neg (96 or 64 bytes an
// element at 4 words, 144 or 96 at 6, against a few dozen integer
// instructions); for a product, 2 W^2 64x64-bit products of dense.cuh's
// CIOS (32 at 4 words, 72 at 6; each about four 32-bit multiply-adds)
// against 96 or 144 bytes, close to the line between the two.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense.cuh"

enum { LW_DN_ADD = 0, LW_DN_SUB = 1, LW_DN_MUL = 2, LW_DN_NEG = 3, LW_DN_SQUARE = 4,
       LW_DN_POW = 5 };

// an exponent of N u32 words, least significant first (a kernel parameter)
template <int N>
struct LwDnExponent {
    uint32_t w[N];
};

template <class F>
__global__ void dense_field_op_kernel(int op, const int32_t* a, long a_ls, long a_es,
                                      const int32_t* b, long b_ls, long b_es, int32_t* out,
                                      long n, LwDnExponent<F::LIMBS> e, int nbits) {
    const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t x[F::LIMBS], y[F::LIMBS], r[F::LIMBS];
#pragma unroll
    for (int k = 0; k < F::LIMBS; k++) x[k] = (uint32_t)a[k * a_ls + i * a_es];
    if (op <= LW_DN_MUL) {
#pragma unroll
        for (int k = 0; k < F::LIMBS; k++) y[k] = (uint32_t)b[k * b_ls + i * b_es];
    }
    switch (op) {
        case LW_DN_ADD: F::add(x, y, r); break;
        case LW_DN_SUB: F::sub(x, y, r); break;
        case LW_DN_MUL: F::mul(x, y, r); break;
        case LW_DN_NEG: F::neg(x, r); break;
        case LW_DN_SQUARE: F::mul(x, x, r); break;
        default: F::pow(x, e.w, nbits, r); break;
    }
#pragma unroll
    for (int k = 0; k < F::LIMBS; k++) out[k * n + i] = (int32_t)r[k];
}

static const int kThreads = 256;

template <class F>
static int run(int op, const int32_t* a, long a_ls, long a_es, const int32_t* b, long b_ls,
               long b_es, int32_t* out, long n, const uint32_t* exponent, int nbits,
               cudaStream_t stream) {
    if (nbits > 32 * F::LIMBS) return (int)cudaErrorInvalidValue;
    LwDnExponent<F::LIMBS> e;
    for (int k = 0; k < F::LIMBS; k++) e.w[k] = exponent[k];
    const long blocks = (n + kThreads - 1) / kThreads;
    dense_field_op_kernel<F><<<blocks, kThreads, 0, stream>>>(op, a, a_ls, a_es, b, b_ls, b_es,
                                                              out, n, e, nbits);
    return (int)cudaGetLastError();
}

// One op (LW_DN_ADD .. LW_DN_POW) over n elements of `field` (dense.cuh's
// LW_DENSE_*): a op b into out (b unused by neg, square and pow).  exponent
// (LW_DENSE_MAX_LIMBS words, least significant first; the field's LIMBS
// are read) and nbits: the power of LW_DN_POW.
extern "C" int lw_dense_field_op(int field, int op, const int32_t* a, long a_ls, long a_es,
                                 const int32_t* b, long b_ls, long b_es, int32_t* out, long n,
                                 const uint32_t* exponent, int nbits, void* stream) {
    if (op < LW_DN_ADD || op > LW_DN_POW || nbits < 0) return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    const uint32_t* e = exponent;
    switch (field) {
        case LW_DENSE_BN254_FR:
            return run<LwBn254Fr>(op, a, a_ls, a_es, b, b_ls, b_es, out, n, e, nbits, s);
        case LW_DENSE_BN254_FQ:
            return run<LwBn254Fq>(op, a, a_ls, a_es, b, b_ls, b_es, out, n, e, nbits, s);
        case LW_DENSE_BLS12_377_FR:
            return run<LwBls12377Fr>(op, a, a_ls, a_es, b, b_ls, b_es, out, n, e, nbits, s);
        case LW_DENSE_BLS12_377_FQ:
            return run<LwBls12377Fq>(op, a, a_ls, a_es, b, b_ls, b_es, out, n, e, nbits, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
