// Elementwise arithmetic over Goldilocks and BabyBear and their quadratic
// and quartic towers (kernel 6: small_field_op_kernel, and
// small_field_inv_kernel for batch inversion).
//
// Replaces XLA code, not a Pallas kernel: the JAX package runs these
// fields as 16-bit-digit XLA programs (lambda_elliptic_curves_tpu/ops/
// limbs.py mont_mul :750 and add / sub at K = 4 and 2 digits, mont_pow
// :860) and their towers as compositions of those
// (fields/extensions.py DeviceQuadraticField.mul :355, inv :365,
// batch_inverse :372).  Built from torch ops a Goldilocks product needs
// 32-bit halves and carries, dozens of launches, and an E product is 3 to
// 9 base products; here every op is one launch, one thread per element.
//
// Layout: an operand is (D*L, n) int32 limbs, D the tower degree (1, 2, 4),
// L the limbs of a base value (2 Goldilocks, 1 BabyBear); component c,
// limb l of element i sits at (c*L + l) * ls + i * es, so a value that is
// broadcast over the batch is read with element stride es = 0 and never
// materialised.  The output is contiguous (D*L, n).
//
// Batch inversion has a kernel of its own, small_field_inv_kernel (block
// work lw_sf_inv_block in small_field.cuh): Montgomery's trick inside each
// block, one launch a call, no round trip through device memory.  What
// bounds it: its bytes.  Each value is read once and written once (16 B an
// element of Goldilocks, 32 B of Goldilocks Fp2), against 3 base products
// an element plus the tower's norm and lift (Fp2: 5 more) of about 22
// instructions each: at the prover's 2^23 base elements the bytes take
// 0.040 ms and the products 0.017 ms of issue, at its 2^24 Fp2 elements
// 0.160 ms and 0.088 ms.  A Fermat power an element (127 products, 17x the
// bytes' time) was the first design.  Each block's one Fermat power (73
// products by an addition chain for Goldilocks) and its tree's 2
// log2(threads) barriers are a chain of a few microseconds, which the other
// blocks on the SM hide.
#include <cuda_runtime.h>
#include <stdint.h>

#include "small_field.cuh"

enum { SF_GOLDILOCKS = 0, SF_BABYBEAR = 1 };

template <class F, int D>
__global__ void small_field_op_kernel(int op, const int32_t* a, long a_ls, long a_es,
                                      const int32_t* b, long b_ls, long b_es, int32_t* out,
                                      long n, typename F::T nr, LwSfExponent e, int nbits) {
    const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) lw_sf_op_element<F, D>(op, a, a_ls, a_es, b, b_ls, b_es, out, n, i, nr, e, nbits);
}

static const int kThreads = 256;

// batch inversion: a block of LW_SF_INV_THREADS threads takes
// LW_SF_INV_THREADS * lw_sf_inv_k(D) elements (tools/sweep_ntt.py --small:
// 128 threads and 8 elements of state a thread at or near the fastest for
// every field and degree)
#define LW_SF_INV_THREADS 128

template <class F, int D, int K, int THREADS>
__global__ void __launch_bounds__(THREADS) small_field_inv_kernel(const int32_t* a, long a_ls,
                                                                   long a_es, int32_t* out,
                                                                   long n, typename F::T nr) {
    __shared__ typename F::T tree[2 * THREADS];
    lw_sf_inv_block<F, D, K, 1>(a, a_ls, a_es, out, n, nr, blockIdx.x, THREADS, threadIdx.x,
                                THREADS, tree);
}

// elements a thread of the inversion takes: 8 in the base field, 16 / D in
// a tower (each element's D components, its norm and its prefix stay in
// registers)
constexpr int lw_sf_inv_k(int degree) { return degree == 1 ? 8 : 16 / degree; }

template <class F, int D, int K, int THREADS>
static int run_inv(const int32_t* a, long a_ls, long a_es, int32_t* out, long n, uint64_t nr,
                   cudaStream_t stream) {
    const long per_block = (long)THREADS * K;
    const long blocks = (n + per_block - 1) / per_block;
    small_field_inv_kernel<F, D, K, THREADS><<<blocks, THREADS, 0, stream>>>(
        a, a_ls, a_es, out, n, (typename F::T)nr);
    return (int)cudaGetLastError();
}

template <class F, int D>
static int run(int op, const int32_t* a, long a_ls, long a_es, const int32_t* b, long b_ls,
               long b_es, int32_t* out, long n, uint64_t nr, const LwSfExponent& e, int nbits,
               cudaStream_t stream) {
    if (op == LW_SF_INV)
        return run_inv<F, D, lw_sf_inv_k(D), LW_SF_INV_THREADS>(a, a_ls, a_es, out, n, nr,
                                                                 stream);
    const long blocks = (n + kThreads - 1) / kThreads;
    small_field_op_kernel<F, D><<<blocks, kThreads, 0, stream>>>(
        op, a, a_ls, a_es, b, b_ls, b_es, out, n, (typename F::T)nr, e, nbits);
    return (int)cudaGetLastError();
}

template <class F>
static int run_degree(int degree, int op, const int32_t* a, long a_ls, long a_es,
                      const int32_t* b, long b_ls, long b_es, int32_t* out, long n,
                      uint64_t nr, const LwSfExponent& e, int nbits, cudaStream_t stream) {
    switch (degree) {
        case 1: return run<F, 1>(op, a, a_ls, a_es, b, b_ls, b_es, out, n, nr, e, nbits, stream);
        case 2: return run<F, 2>(op, a, a_ls, a_es, b, b_ls, b_es, out, n, nr, e, nbits, stream);
        case 4: return run<F, 4>(op, a, a_ls, a_es, b, b_ls, b_es, out, n, nr, e, nbits, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// One op (LW_SF_ADD .. LW_SF_INV, small_field.cuh) over n elements of the
// degree-`degree` tower over `field`: a op b into out (b unused by neg,
// square, pow and inv); LW_SF_INV is one launch of small_field_inv_kernel,
// every other op one of small_field_op_kernel.  nr: the tower's level-1
// non-residue in Montgomery form; exponent (8 words, least significant
// first) and nbits: the power of SF_POW.
extern "C" int lw_small_field_op(int field, int degree, int op, const int32_t* a, long a_ls,
                                 long a_es, const int32_t* b, long b_ls, long b_es,
                                 int32_t* out, long n, uint64_t nr, const uint32_t* exponent,
                                 int nbits, void* stream) {
    if (op < LW_SF_ADD || op > LW_SF_INV || nbits < 0 || nbits > 256) return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaGetLastError();
    LwSfExponent e;
    for (int k = 0; k < 8; k++) e.w[k] = exponent[k];
    cudaStream_t s = (cudaStream_t)stream;
    switch (field) {
        case SF_GOLDILOCKS:
            return run_degree<LwGoldilocks>(degree, op, a, a_ls, a_es, b, b_ls, b_es, out, n,
                                            nr, e, nbits, s);
        case SF_BABYBEAR:
            return run_degree<LwBabyBear>(degree, op, a, a_ls, a_es, b, b_ls, b_es, out, n, nr,
                                          e, nbits, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <class K>
static int info_of(K kernel, int threads, int* info) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
    info[0] = threads;
    info[1] = blocks;
    info[2] = attr.numRegs;
    info[3] = (int)attr.localSizeBytes;
    return (int)err;
}

template <class F, int D>
static int info_degree(int inv, int* info) {
    if (inv) {
        info[4] = LW_SF_INV_THREADS * lw_sf_inv_k(D);
        return info_of(small_field_inv_kernel<F, D, lw_sf_inv_k(D), LW_SF_INV_THREADS>,
                       LW_SF_INV_THREADS, info);
    }
    info[4] = kThreads;
    return info_of(small_field_op_kernel<F, D>, kThreads, info);
}

template <class F>
static int info_field(int degree, int inv, int* info) {
    switch (degree) {
        case 1: return info_degree<F, 1>(inv, info);
        case 2: return info_degree<F, 2>(inv, info);
        case 4: return info_degree<F, 4>(inv, info);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Kernel 6 at one degree: the inversion kernel (inv != 0) or the op
// kernel: info = {threads a block, blocks an SM can hold (the occupancy
// calculator), registers a thread, local (spilled) bytes a thread,
// elements a block}
extern "C" int lw_small_field_info(int field, int degree, int inv, int* info) {
    switch (field) {
        case SF_GOLDILOCKS: return info_field<LwGoldilocks>(degree, inv, info);
        case SF_BABYBEAR: return info_field<LwBabyBear>(degree, inv, info);
        default: return (int)cudaErrorInvalidValue;
    }
}
