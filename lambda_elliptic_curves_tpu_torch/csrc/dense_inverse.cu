// Batch inversion over the dense fields (kernel 9): BN254 Fr and Fq and
// BLS12-377 Fr on 8 32-bit limbs, BLS12-377 Fq on 12, one launch a call.
// A block runs Montgomery's trick over its threads' rounds of K elements,
// each round's elements and prefixes in registers, a product tree in
// shared memory and one binary-Euclid inversion (dense_inverse.cuh); the
// products are dense32.cuh's carry-chain ones.  Zeros map to zero.
//
// Replaces XLA code, not a Pallas kernel: the JAX package's
// lambda_elliptic_curves_tpu/ops/limbs.py:895 batch_inverse (an
// associative scan, or chunk scans for large n).  Same values, bit for bit:
// each element's inverse in Montgomery form.
//
// Bound on this card: each value read once and written once (64 B an
// element at 4 words, 96 at 6) against 3 products a nonzero element at
// dense32.cuh's SASS.  What holds it is the one inversion a block: one
// thread's chain of about 2 log2 p one-bit Euclid steps (56 us at 4 words,
// 112 at 6; tools/sweep_dense.py), during which the block's other threads
// wait.  So a call takes as few rounds as fill one wave of the card (plan):
// below that, more blocks only add inversions and waves; at one round a
// block (the registers-only trick) 2^22 elements took 1.5 ms at the best
// tile, against 0.39 with rounds.  The tile, 256 threads and one element a
// round at both widths: the fastest or within 4% of it at 2^16-2^18, 5 x
// 2^16 and 2^22 (tools/sweep_dense.py: T 64-256, K 1-8; PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_inverse.cuh"

#define LW_DI_THREADS 256
// elements a thread a round: K at 4 words, at 6 words
#define LW_DI_K4 1
#define LW_DI_K6 1

template <class F, int K, int T>
__global__ void __launch_bounds__(T) dense_inverse_kernel(const int32_t* x, int32_t* out,
                                                          long n, int rounds) {
    extern __shared__ uint32_t tree[];
    lw_dn_inv_block<F, K, 1>(x, out, n, blockIdx.x, T, rounds, threadIdx.x, T, tree);
}

// rounds a thread takes so that the call's blocks fit one wave of the card
// (at least one), and the blocks an SM holds
template <class F, int K, int T>
static int plan(long n, int* rounds, int* per_sm) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            per_sm, dense_inverse_kernel<F, K, T>, T, 4 * lw_di_smem_words(T, F::LIMBS));
    if (err != cudaSuccess) return (int)err;
    const long wave = (long)sms * (*per_sm > 0 ? *per_sm : 1) * T * K;
    *rounds = (int)((n + wave - 1) / wave);
    if (*rounds < 1) *rounds = 1;
    return 0;
}

template <class F, int K, int T>
static int run(const int32_t* x, int32_t* out, long n, cudaStream_t stream) {
    int rounds = 1, per_sm = 0;
    const int err = plan<F, K, T>(n, &rounds, &per_sm);
    if (err) return err;
    const long per_block = (long)T * K * rounds;
    const size_t smem = 4 * lw_di_smem_words(T, F::LIMBS);
    dense_inverse_kernel<F, K, T><<<(n + per_block - 1) / per_block, T, smem, stream>>>(
        x, out, n, rounds);
    return (int)cudaGetLastError();
}

// (LIMBS, n) planes x of `field` (dense.cuh's LW_DENSE_*) into out (both
// contiguous, distinct): every element's inverse, zeros to zero, in one
// launch.
extern "C" int lw_dense_inverse(int field, const int32_t* x, int32_t* out, long n,
                                void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    constexpr int T = LW_DI_THREADS;
    switch (field) {
        case LW_DENSE_BN254_FR: return run<LwBn254Fr32, LW_DI_K4, T>(x, out, n, s);
        case LW_DENSE_BN254_FQ: return run<LwBn254Fq32, LW_DI_K4, T>(x, out, n, s);
        case LW_DENSE_BLS12_377_FR: return run<LwBls12377Fr32, LW_DI_K4, T>(x, out, n, s);
        case LW_DENSE_BLS12_377_FQ: return run<LwBls12377Fq32, LW_DI_K6, T>(x, out, n, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <class F, int K, int T>
static int info_of(long n, int* info) {
    int rounds = 1, per_sm = 0;
    const int err = plan<F, K, T>(n, &rounds, &per_sm);
    if (err) return err;
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, dense_inverse_kernel<F, K, T>);
    if (e != cudaSuccess) return (int)e;
    const long per_block = (long)T * K * rounds;
    info[0] = T;
    info[1] = K;
    info[2] = rounds;
    info[3] = (int)((n + per_block - 1) / per_block);
    info[4] = per_sm;
    info[5] = a.numRegs;
    info[6] = (int)a.localSizeBytes;
    return 0;
}

// lw_dense_inverse's launch for n elements of `field`: threads a block, K,
// rounds, blocks, blocks an SM holds, registers and local bytes a thread
extern "C" int lw_dense_inverse_info(int field, long n, int* info) {
    constexpr int T = LW_DI_THREADS;
    switch (field) {
        case LW_DENSE_BN254_FR: return info_of<LwBn254Fr32, LW_DI_K4, T>(n, info);
        case LW_DENSE_BN254_FQ: return info_of<LwBn254Fq32, LW_DI_K4, T>(n, info);
        case LW_DENSE_BLS12_377_FR: return info_of<LwBls12377Fr32, LW_DI_K4, T>(n, info);
        case LW_DENSE_BLS12_377_FQ: return info_of<LwBls12377Fq32, LW_DI_K6, T>(n, info);
        default: return (int)cudaErrorInvalidValue;
    }
}
