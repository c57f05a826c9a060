// Elementwise arithmetic over the dense fields (kernel 8): BN254 Fr and Fq
// and BLS12-377 Fr on 8 32-bit limbs, BLS12-377 Fq on 12, on dense32.cuh's
// carry-chain product and sums.  Two entries:
//  * lw_dense_field_op: one op (add, sub, mul, neg, square, pow) a launch,
//    dense_field_op_kernel, E elements a thread;
//  * lw_dense_field_program: a straight-line program of add, sub, mul, neg
//    and square steps over up to LW_DN_PROG_INPUTS input operands, one
//    output plane, one launch (dense_field_program_kernel): Plonk's round-3
//    quotient and Groth16's h run as one launch each, their intermediates
//    in a thread's slots in shared memory, not in device memory.
//
// Replaces XLA code, not a Pallas kernel: the JAX package runs these fields
// as 16-bit-digit XLA programs (lambda_elliptic_curves_tpu/ops/limbs.py
// mont_mul :750, add :600, sub :610, neg :624, mont_square :829, mont_pow
// :860), a chain of them as one fused XLA program
// (lambda_elliptic_curves_tpu/provers/plonk/prover.py:124).  The group law
// runs on kernels 10 and 11 (curve.cu, msm_bucket.cu).
//
// Layout and the element work: dense_field.cuh.  A block of kThreads
// threads takes kThreads * E elements; thread t takes b kThreads E + j
// kThreads + t for j < E, so that neighbouring threads touch neighbouring
// words of every plane.  E = 1 below LW_DN_WIDE_N elements and 4 from it
// (tools/sweep_dense.py, PERF.md: at four words 1, 2 and 4 within a few
// per cent of each other at 2^16 - 2^22; at six, 4 the fastest product at
// 2^22 and 1 at 2^16 - 2^18, where 4 leaves SMs without a block).
//
// Bound on this card: bytes for add, sub and neg (96 B an element at 4
// words, 144 at 6); a product is 184 SASS instructions at 4 words and 504
// at 6 (tools/dense_mul.py), close to the line between the two at 4 words
// and above it at 6.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_field.cuh"

static const int kThreads = 256;
#define LW_DN_WIDE_N (1L << 20)

template <class F, int OP, int E>
__global__ void __launch_bounds__(kThreads)
dense_field_op_kernel(LwDnOperand a, LwDnOperand b, int32_t* out, long n,
                      LwDnExponent<F::LIMBS> e, int nbits) {
    const long i0 = (long)blockIdx.x * kThreads * E + threadIdx.x;
    lw_dn_op_elements<F, OP, E>(a, b, out, n, i0, kThreads, e.w, nbits);
}

template <class F>
__global__ void __launch_bounds__(kThreads)
dense_field_program_kernel(const __grid_constant__ LwDnProgram P, int32_t* out, long n) {
    extern __shared__ uint32_t slots[];
    const long i = (long)blockIdx.x * kThreads + threadIdx.x;
    if (i < n) lw_dn_program_element<F>(P, out, n, i, slots + threadIdx.x, kThreads);
}

template <class F, int OP, int E>
static int launch_op(LwDnOperand a, LwDnOperand b, int32_t* out, long n,
                     const LwDnExponent<F::LIMBS>& e, int nbits, cudaStream_t stream) {
    const long per_block = (long)kThreads * E;
    dense_field_op_kernel<F, OP, E><<<(n + per_block - 1) / per_block, kThreads, 0, stream>>>(
        a, b, out, n, e, nbits);
    return (int)cudaGetLastError();
}

template <class F, int E>
static int run_e(int op, LwDnOperand a, LwDnOperand b, int32_t* out, long n,
                 const LwDnExponent<F::LIMBS>& e, int nbits, cudaStream_t s) {
    switch (op) {
        case LW_DN_ADD: return launch_op<F, LW_DN_ADD, E>(a, b, out, n, e, nbits, s);
        case LW_DN_SUB: return launch_op<F, LW_DN_SUB, E>(a, b, out, n, e, nbits, s);
        case LW_DN_MUL: return launch_op<F, LW_DN_MUL, E>(a, b, out, n, e, nbits, s);
        case LW_DN_NEG: return launch_op<F, LW_DN_NEG, E>(a, b, out, n, e, nbits, s);
        case LW_DN_SQUARE: return launch_op<F, LW_DN_SQUARE, E>(a, b, out, n, e, nbits, s);
        default: return launch_op<F, LW_DN_POW, 1>(a, b, out, n, e, nbits, s);
    }
}

template <class F>
static int run(int op, LwDnOperand a, LwDnOperand b, int32_t* out, long n,
               const uint32_t* exponent, int nbits, cudaStream_t s) {
    if (nbits > 32 * F::LIMBS) return (int)cudaErrorInvalidValue;
    LwDnExponent<F::LIMBS> e;
    for (int k = 0; k < F::LIMBS; k++) e.w[k] = exponent[k];
    if (n >= LW_DN_WIDE_N && op != LW_DN_POW) return run_e<F, 4>(op, a, b, out, n, e, nbits, s);
    return run_e<F, 1>(op, a, b, out, n, e, nbits, s);
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
    const LwDnOperand x = {a, a_ls, a_es}, y = {b, b_ls, b_es};
    switch (field) {
        case LW_DENSE_BN254_FR: return run<LwBn254Fr32>(op, x, y, out, n, exponent, nbits, s);
        case LW_DENSE_BN254_FQ: return run<LwBn254Fq32>(op, x, y, out, n, exponent, nbits, s);
        case LW_DENSE_BLS12_377_FR:
            return run<LwBls12377Fr32>(op, x, y, out, n, exponent, nbits, s);
        case LW_DENSE_BLS12_377_FQ:
            return run<LwBls12377Fq32>(op, x, y, out, n, exponent, nbits, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// the slots' shared memory: P.slots x LIMBS words a thread, up to 192 KB a
// block (16 slots at 12 limbs), above the 48 KB a launch gets unasked
template <class F>
static int run_program(const LwDnProgram& P, int32_t* out, long n, cudaStream_t stream) {
    static bool raised = false;
    if (!raised) {
        const cudaError_t err = cudaFuncSetAttribute(
            dense_field_program_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            4 * LW_DN_PROG_SLOTS * F::LIMBS * kThreads);
        if (err != cudaSuccess) return (int)err;
        raised = true;
    }
    const size_t smem = 4 * (size_t)P.slots * F::LIMBS * kThreads;
    dense_field_program_kernel<F><<<(n + kThreads - 1) / kThreads, kThreads, smem, stream>>>(
        P, out, n);
    return (int)cudaGetLastError();
}

// A program of `steps` steps over n elements of `field` into the
// contiguous (LIMBS, n) out: inputs[k] with limb stride ls[k] and element
// stride es[k] for k < n_inputs; step s computes op[s] (LW_DN_ADD ..
// LW_DN_SQUARE) of operands a[s] and b[s] into slot dst[s] (dense_field.cuh
// names the operands); the output is slot out_slot.
extern "C" int lw_dense_field_program(int field, int n_inputs, const int32_t* const* inputs,
                                      const long* ls, const long* es, int steps,
                                      const uint8_t* op, const uint8_t* dst, const uint8_t* a,
                                      const uint8_t* b, int out_slot, int32_t* out, long n,
                                      void* stream) {
    LwDnProgram P = {};
    if (!lw_dn_program_make(P, n_inputs, inputs, ls, es, steps, op, dst, a, b, out_slot))
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    switch (field) {
        case LW_DENSE_BN254_FR: return run_program<LwBn254Fr32>(P, out, n, st);
        case LW_DENSE_BN254_FQ: return run_program<LwBn254Fq32>(P, out, n, st);
        case LW_DENSE_BLS12_377_FR: return run_program<LwBls12377Fr32>(P, out, n, st);
        case LW_DENSE_BLS12_377_FQ: return run_program<LwBls12377Fq32>(P, out, n, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
