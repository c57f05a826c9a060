// keccak-f[1600] and the fixed-length Keccak-256 sponge, one state per
// thread (kernel 2).
//
// Replaces the Pallas kernel lambda_elliptic_curves_tpu/hashes/
// keccak_pallas.py :82 _permute_fn (pallas_call at :109, round at :48),
// which keeps a (50, T) tile of states in VMEM across all 24 rounds, and
// the sponge around it (hashes/keccak.py :248 _sponge_words_impl).
//
// Bound on this card: 24 rounds of about 100 64-bit xor / and-not / rotate
// operations per state against 32-64 message bytes read and 32 digest bytes
// written, so hashing is bound by integer instruction throughput, not by
// memory.
// Design: a thread holds its 25 64-bit lanes in registers for the whole
// permutation (the rounds unroll, so lane indices are compile-time and the
// rotates become funnel shifts); the sponge kernel pads and absorbs the
// message itself, so a Merkle level is one launch that reads the words and
// writes the digests.  Words are (W, B) planes: neighbouring threads read
// neighbouring words.
#include <cuda_runtime.h>
#include <stdint.h>

#ifdef __CUDACC__
#define LW_HD __host__ __device__ __forceinline__
#else
#define LW_HD static inline
#endif

#define LW_RATE_WORDS 34  // keccak-256 rate: 136 bytes

LW_HD uint64_t lw_rotl64(uint64_t v, int n) {
    return n ? (v << n) | (v >> (64 - n)) : v;
}

LW_HD uint64_t lw_keccak_rc(int r) {
    const uint64_t RC[24] = {
        0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
        0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
        0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
        0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
        0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
        0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
        0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
        0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};
    return RC[r];
}

// rho offsets indexed by lane x + 5y
LW_HD int lw_keccak_rot(int i) {
    const int ROT[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                         25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
    return ROT[i];
}

// 24 rounds in place; lane (x, y) at s[x + 5y].  Fully unrolled, so every
// table index is a compile-time constant.
LW_HD void lw_keccak_permute(uint64_t s[25]) {
#pragma unroll
    for (int r = 0; r < 24; r++) {
        uint64_t c[5], b[25];
#pragma unroll
        for (int x = 0; x < 5; x++)
            c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
#pragma unroll
        for (int x = 0; x < 5; x++) {
            uint64_t d = c[(x + 4) % 5] ^ lw_rotl64(c[(x + 1) % 5], 1);
#pragma unroll
            for (int y = 0; y < 5; y++) s[x + 5 * y] ^= d;
        }
#pragma unroll
        for (int x = 0; x < 5; x++)
#pragma unroll
            for (int y = 0; y < 5; y++)
                b[y + 5 * ((2 * x + 3 * y) % 5)] =
                    lw_rotl64(s[x + 5 * y], lw_keccak_rot(x + 5 * y));
#pragma unroll
        for (int y = 0; y < 5; y++)
#pragma unroll
            for (int x = 0; x < 5; x++)
                s[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] &
                                               b[(x + 2) % 5 + 5 * y]);
        s[0] ^= lw_keccak_rc(r);
    }
}

#ifdef __CUDACC__

// state: (25, 2, B) words, [i][0] the low and [i][1] the high half of lane i
__global__ void keccak_f_kernel(const int32_t* st, int32_t* out, long B) {
    long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    uint64_t s[25];
#pragma unroll
    for (int i = 0; i < 25; i++)
        s[i] = (uint64_t)(uint32_t)st[(2 * i) * B + b] |
               ((uint64_t)(uint32_t)st[(2 * i + 1) * B + b] << 32);
    lw_keccak_permute(s);
#pragma unroll
    for (int i = 0; i < 25; i++) {
        out[(2 * i) * B + b] = (int32_t)(uint32_t)s[i];
        out[(2 * i + 1) * B + b] = (int32_t)(uint32_t)(s[i] >> 32);
    }
}

// Keccak-256 (0x01 domain padding) of B messages of msg_bytes each, given
// as (W, B) little-endian words (bytes past msg_bytes in the last word are
// zero).  Writes (8, B) digest words.
__global__ void keccak256_words_kernel(const int32_t* words, int W, long B,
                                       int msg_bytes, int32_t* out) {
    long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int nblocks = msg_bytes / (4 * LW_RATE_WORDS) + 1;
    const int msg_words = (msg_bytes + 3) / 4;
    const int pad_word = msg_bytes / 4;
    const uint32_t pad_bits = 0x01u << (8 * (msg_bytes % 4));
    uint64_t s[25];
#pragma unroll
    for (int i = 0; i < 25; i++) s[i] = 0;
    for (int blk = 0; blk < nblocks; blk++) {
        const int base = blk * LW_RATE_WORDS;
#pragma unroll
        for (int i = 0; i < LW_RATE_WORDS / 2; i++) {
            uint32_t w2[2];
#pragma unroll
            for (int h = 0; h < 2; h++) {
                int w = base + 2 * i + h;
                uint32_t v = w < msg_words && w < W
                                 ? (uint32_t)words[(long)w * B + b] : 0u;
                if (w == pad_word) v ^= pad_bits;
                if (w == nblocks * LW_RATE_WORDS - 1) v ^= 0x80000000u;
                w2[h] = v;
            }
            s[i] ^= (uint64_t)w2[0] | ((uint64_t)w2[1] << 32);
        }
        lw_keccak_permute(s);
    }
#pragma unroll
    for (int i = 0; i < 4; i++) {
        out[(2 * i) * B + b] = (int32_t)(uint32_t)s[i];
        out[(2 * i + 1) * B + b] = (int32_t)(uint32_t)(s[i] >> 32);
    }
}

static const int kThreads = 128;

extern "C" int lw_keccak_f(const int32_t* st, int32_t* out, long B,
                           void* stream) {
    if (B > 0)
        keccak_f_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                          (cudaStream_t)stream>>>(st, out, B);
    return (int)cudaGetLastError();
}

extern "C" int lw_keccak256_words(const int32_t* words, int W, long B,
                                  int msg_bytes, int32_t* out, void* stream) {
    if (B > 0)
        keccak256_words_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                                 (cudaStream_t)stream>>>(words, W, B,
                                                         msg_bytes, out);
    return (int)cudaGetLastError();
}

#endif  // __CUDACC__
