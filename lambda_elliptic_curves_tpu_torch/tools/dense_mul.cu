// Kernels of tools/dense_mul.py: the dense Montgomery products and
// butterflies side by side on the card.  Variant 0 is dense.cuh's (CIOS on
// 64-bit words: kernels 8-11, and the reference), 1 dense32.cuh's (carry
// chains on 32-bit limbs: kernel 1 over the dense fields).  Fields: 0 BN254
// Fr, 2 BLS12-377 Fr (four words), 3 BLS12-377 Fq (six words).  Values are
// entry-major: element i is words [L i, L i + L).
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense32.cuh"

template <class Q, int V>
__device__ __forceinline__ void dn_mul(const uint32_t* a, const uint32_t* b, uint32_t* r) {
    if (V == 0) LwDense<Q>::mul(a, b, r);
    else lw_d32_mul<Q>(a, b, r);
}

// r_i = a_i b_i
template <class Q, int V>
__global__ void dn_mul_pairs(const uint32_t* a, const uint32_t* b, uint32_t* r, long n) {
    constexpr int L = 2 * Q::W;
    for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
         i += (long)gridDim.x * blockDim.x) {
        uint32_t x[L], y[L], z[L];
#pragma unroll
        for (int k = 0; k < L; k++) {
            x[k] = a[L * i + k];
            y[k] = b[L * i + k];
        }
        dn_mul<Q, V>(x, y, z);
#pragma unroll
        for (int k = 0; k < L; k++) r[L * i + k] = z[k];
    }
}

// one product a thread: the kernel whose instructions, less dn_copy's, are
// the product's
template <class Q, int V>
__global__ void dn_mul_one(const uint32_t* a, const uint32_t* b, uint32_t* r) {
    constexpr int L = 2 * Q::W;
    const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
    uint32_t x[L], y[L], z[L];
#pragma unroll
    for (int k = 0; k < L; k++) {
        x[k] = a[L * i + k];
        y[k] = b[L * i + k];
    }
    dn_mul<Q, V>(x, y, z);
#pragma unroll
    for (int k = 0; k < L; k++) r[L * i + k] = z[k];
}

// one butterfly a thread, u ^ v of its outputs stored (dn_copy's xor and
// store): the kernel whose instructions, less dn_copy's, are the butterfly's
template <class Q, int V>
__global__ void dn_bfly_one(const uint32_t* a, const uint32_t* b, uint32_t* r) {
    constexpr int L = 2 * Q::W;
    const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
    uint32_t x[L], y[L];
#pragma unroll
    for (int k = 0; k < L; k++) {
        x[k] = a[L * i + k];
        y[k] = b[L * i + k];
    }
    if (V == 0) LwDense<Q>::butterfly(x, y);
    else lw_d32_butterfly<Q>(x, y);
#pragma unroll
    for (int k = 0; k < L; k++) r[L * i + k] = x[k] ^ y[k];
}

template <class Q>
__global__ void dn_copy(const uint32_t* a, const uint32_t* b, uint32_t* r) {
    constexpr int L = 2 * Q::W;
    const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
#pragma unroll
    for (int k = 0; k < L; k++) r[L * i + k] = a[L * i + k] ^ b[L * i + k];
}

// a chain of `iters` dependent products a thread: x <- x y
template <class Q, int V>
__global__ void dn_mul_chain(const uint32_t* a, uint32_t* r, int iters) {
    constexpr int L = 2 * Q::W;
    const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
    const long n = (long)gridDim.x * blockDim.x;
    uint32_t x[L], y[L];
#pragma unroll
    for (int k = 0; k < L; k++) {
        x[k] = a[L * i + k];
        y[k] = a[L * (i + n) + k];
    }
    for (int it = 0; it < iters; it++) dn_mul<Q, V>(x, y, x);
#pragma unroll
    for (int k = 0; k < L; k++) r[L * i + k] = x[k];
}

template <class Q>
static int run(int kind, int variant, const uint32_t* a, const uint32_t* b, uint32_t* r, long n,
               int blocks, int threads, int iters, cudaStream_t s) {
#define DN_VARIANTS(V)                                                                   \
    if (variant == V) {                                                                  \
        if (kind == 0) dn_mul_pairs<Q, V><<<blocks, threads, 0, s>>>(a, b, r, n);        \
        else if (kind == 1) dn_mul_chain<Q, V><<<blocks, threads, 0, s>>>(a, r, iters);  \
        else if (kind == 2) dn_mul_one<Q, V><<<blocks, threads, 0, s>>>(a, b, r);        \
        else dn_bfly_one<Q, V><<<blocks, threads, 0, s>>>(a, b, r);                      \
        return (int)cudaGetLastError();                                                  \
    }
    DN_VARIANTS(0)
    DN_VARIANTS(1)
#undef DN_VARIANTS
    if (variant == 2) {
        dn_copy<Q><<<blocks, threads, 0, s>>>(a, b, r);
        return (int)cudaGetLastError();
    }
    return (int)cudaErrorInvalidValue;
}

// kind 0: r_i = a_i b_i for i < n (blocks x threads threads striding);
// kind 1: each of the blocks x threads threads runs `iters` dependent
// products of a_i by a_(i + blocks threads) into r_i; kind 2: one product
// a thread, kind 3 one butterfly a thread (variant 2: dn_copy)
extern "C" int dn_mul_run(int field, int kind, int variant, const uint32_t* a,
                          const uint32_t* b, uint32_t* r, long n, int blocks, int threads,
                          int iters, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == LW_DENSE_BN254_FR)
        return run<LwBn254FrParams>(kind, variant, a, b, r, n, blocks, threads, iters, s);
    if (field == LW_DENSE_BLS12_377_FR)
        return run<LwBls12377FrParams>(kind, variant, a, b, r, n, blocks, threads, iters, s);
    if (field == LW_DENSE_BLS12_377_FQ)
        return run<LwBls12377FqParams>(kind, variant, a, b, r, n, blocks, threads, iters, s);
    return (int)cudaErrorInvalidValue;
}
