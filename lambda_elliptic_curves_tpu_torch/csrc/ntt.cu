// Local Stark252 NTT: one block transforms one row of n <= 2^11 points in
// shared memory (kernel 1).
//
// Replaces the Pallas kernel lambda_elliptic_curves_tpu/poly/ntt_pallas.py
// :108 _kernel_for (pallas_call at :164; driven by _local_fft :183), which
// runs every butterfly stage of a local transform on a VMEM-resident block.
// On the TPU that kernel is a DIF network built from lane rotates; here it
// is a plain radix-2 Cooley-Tukey DIT network over shared memory.
//
// Bound on this card: per butterfly one Montgomery product, an add and a
// subtract (about 200 integer instructions) against 64 bytes of shared
// memory traffic, so the kernel is bound by the 32-bit multiply rate once
// the row is in shared memory; device memory is read and written once.
// Design:
//  * the row is held as 8 limb planes of n words in dynamic shared memory
//    (2^11 points = 64 KB, above the 48 KB default, hence the attribute);
//    neighbouring threads touch neighbouring words of a plane;
//  * the input is loaded to bit-reversed positions, so the DIT stages leave
//    the spectrum in natural order and nothing is permuted afterwards;
//  * every butterfly reduces strictly (canonical values in and out), so the
//    output is canonical: the lazy bounds of ntt_pallas.py :121-126 are not
//    carried over;
//  * twiddles root^0 .. root^(n/2-1) come from a table in device memory
//    that the caller builds once per (n, root); stage s reads every
//    (n >> s)-th entry;
//  * a longer transform is split by the caller (poly/ntt.py, four-step).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mont.cuh"

#define LW_NTT_MAX_LOG 11

__global__ void ntt_kernel(const int32_t* x, int32_t* out, const int32_t* tw,
                           long rows, int log_n) {
    extern __shared__ uint32_t sm[];  // [LW_LIMBS][n]
    const int n = 1 << log_n;
    const int half_n = n >> 1;
    const long row = blockIdx.x;

    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        int rj = (int)(__brev((unsigned)j) >> (32 - log_n));
#pragma unroll
        for (int k = 0; k < LW_LIMBS; k++)
            sm[k * n + rj] = (uint32_t)x[((long)k * rows + row) * n + j];
    }
    __syncthreads();

    for (int s = 1; s <= log_n; s++) {
        const int half = 1 << (s - 1);
        const int tw_step = n >> s;
        for (int b = threadIdx.x; b < half_n; b += blockDim.x) {
            int j = b & (half - 1);
            int i0 = ((b >> (s - 1)) << s) + j;
            int i1 = i0 + half;
            int ti = j * tw_step;
            uint32_t u[LW_LIMBS], v[LW_LIMBS], w[LW_LIMBS], t[LW_LIMBS];
#pragma unroll
            for (int k = 0; k < LW_LIMBS; k++) {
                u[k] = sm[k * n + i0];
                v[k] = sm[k * n + i1];
                w[k] = (uint32_t)tw[(long)k * half_n + ti];
            }
            lw_mont_mul(w, v, t);
            lw_add(u, t, w);
            lw_sub(u, t, v);
#pragma unroll
            for (int k = 0; k < LW_LIMBS; k++) {
                sm[k * n + i0] = w[k];
                sm[k * n + i1] = v[k];
            }
        }
        __syncthreads();
    }

    for (int j = threadIdx.x; j < n; j += blockDim.x) {
#pragma unroll
        for (int k = 0; k < LW_LIMBS; k++)
            out[((long)k * rows + row) * n + j] = (int32_t)sm[k * n + j];
    }
}

// x, out: (8, rows, n) limb planes; tw: (8, n/2) Montgomery root powers.
extern "C" int lw_ntt(const int32_t* x, int32_t* out, const int32_t* tw,
                      long rows, int log_n, void* stream) {
    static bool attr_set = false;
    if (log_n < 1 || log_n > LW_NTT_MAX_LOG) return (int)cudaErrorInvalidValue;
    if (!attr_set) {
        cudaError_t err = cudaFuncSetAttribute(
            ntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)(LW_LIMBS * sizeof(uint32_t)) << LW_NTT_MAX_LOG);
        if (err != cudaSuccess) return (int)err;
        attr_set = true;
    }
    const int n = 1 << log_n;
    const int threads = n / 2 < 256 ? (n / 2 < 32 ? 32 : n / 2) : 256;
    const size_t smem = (size_t)LW_LIMBS * sizeof(uint32_t) * n;
    if (rows > 0)
        ntt_kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(
            x, out, tw, rows, log_n);
    return (int)cudaGetLastError();
}
