// Pippenger's bucket phase on curve.cuh's group law, one tile of a window a
// block: what msm_bucket.cu (kernel 11) runs on the card, and what the host
// tests (tests/test_torch_curve_kernels.py) build with g++ and run block by
// block, a step of every thread at a time (lw_bucket_*_block_seq).
// curves/msm.py holds the plain version, the same sequence of steps in
// PyTorch, and drives the levels of both.
//
// A block is a tile of P leaves (P a power of two, one thread a leaf) and
// a binary tree over them in shared memory: log2 P steps, a step a
// barrier, so the dependent chain of a level is a leaf's work plus log2 P
// combines, whatever the skew of the ids.
//
// Accumulate (bucket j of window w = the sum of the points whose window-w
// id is j).  The ids of a window are sorted (stably); leaf t of tile b
// walks T consecutive positions, reading the points through the sort's
// permutation (no sorted copy is made), and skips id 0.  A run of equal
// ids that closes inside the leaf and is not its first is complete: it
// goes straight to the bucket table.  The leaf keeps its first run and
// its last (open) run in the tile: a node of the tree is (the id and
// partial sum of its first run, those of its last run), both one run when
// the node holds one.  A combine of two neighbouring nodes adds the left's
// last run to the right's first when their ids match (one addition), and
// sends to the table a run that is now neither the node's first nor its
// last.  The root's two runs go to two slots, (id, partial sum), id 0 for
// an empty slot; the slots of a window are again sorted by id (zeros
// aside), so the next level is the same tree over them (T = 2, full
// additions) until one tile holds a window and its root's runs are
// complete.  A run's additions stay one per point or slot merged.
//
// Reduce (sum_j j B_j of each window).  With A_i = B_(i+1), sum_j j B_j =
// sum_i (i + 1) A_i.  Level 0: leaf k walks its segment [k m, (k + 1) m)
// down with a running sum R_k and the sum of the running sums L_k (2
// additions an entry), L_k = sum_(i in k) (i - k m + 1) A_i; the total is
// sum_k L_k + m sum_k k R_k.  A node of the tree over leaves [a, b) holds
// V = sum_k (L_k + M (k - a) R_k) and R~ = M (b - a) R, R the sum of its
// R's and M the leaves' scale (m at level 0): a leaf is (L_k, M R_k), M R_k
// by log2 m doublings, and a combine is V = V_l + (V_r + R~_r), R~ =
// 2 (R~_l + R~_r), the two on two threads.  A tile's root (V, R~) is a leaf
// of the next level, at scale M P, until one tile holds a window: its V is
// the window's sum.
//
// Every addition is curve.cuh's complete one, in a fixed order of
// operands, so a block's results are bitwise the plain version's.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "curve.cuh"

// leaves (threads) of a tile at most: the blocks' size and launch bound
static const int kBucketTileMax = 128;

// One accumulate level.  As C arguments, 23 longs: W (windows), S (ids a
// window), T (positions a leaf), N (buckets a window), P (leaves a tile, a
// power of two), the (W, S) int64 ids, the (W, S) int64 permutation or 0
// (then entry w S + s is element w S + s of the points), the points'
// LwPoints (9 longs), the table's three (ROWS, W N) planes, and the next
// level's (W, 2 K) int64 slot ids and three (ROWS, W 2 K) point planes (0
// at the last level, K = 1), K = ceil(S / (P T)) tiles a window.
struct LwBucketAcc {
    long W, S, T, N, P, K;
    const int64_t* ids;
    const int64_t* order;
    LwPoints in;
    int32_t* table[3];
    int64_t* slot_ids;
    int32_t* slots[3];
};

LW_HD LwBucketAcc lw_bucket_acc_arg(const long* d) {
    LwBucketAcc a;
    a.W = d[0];
    a.S = d[1];
    a.T = d[2];
    a.N = d[3];
    a.P = d[4];
    a.K = a.P > 0 && a.T > 0 ? (a.S + a.P * a.T - 1) / (a.P * a.T) : 0;
    a.ids = (const int64_t*)(uintptr_t)d[5];
    a.order = (const int64_t*)(uintptr_t)d[6];
    a.in = lw_points_arg(d + 7);
    for (int c = 0; c < 3; c++) {
        a.table[c] = (int32_t*)(uintptr_t)d[16 + c];
        a.slots[c] = (int32_t*)(uintptr_t)d[20 + c];
    }
    a.slot_ids = (int64_t*)(uintptr_t)d[19];
    return a;
}

// An accumulate tile in shared memory: 2 P points (leaf t's first run at
// 2 t, its later runs at 2 t + 1), and by a node's first leaf the ids of
// its first and last runs (0: the node is empty) and where their sums are
// (pf == pl: the node holds one run)
template <class G>
struct LwAccTile {
    typename G::P* pt;
    int64_t* fid;
    int64_t* lid;
    int* pf;
    int* pl;
};

template <class G>
LW_HD size_t lw_acc_tile_bytes(long P) {
    return (size_t)P * (2 * sizeof(typename G::P) + 2 * sizeof(int64_t) + 2 * sizeof(int));
}

template <class G>
LW_HD LwAccTile<G> lw_acc_tile(void* mem, long P) {
    LwAccTile<G> s;
    s.pt = (typename G::P*)mem;
    s.fid = (int64_t*)(s.pt + 2 * P);
    s.lid = s.fid + P;
    s.pf = (int*)(s.lid + P);
    s.pl = s.pf + P;
    return s;
}

template <class G>
LW_HD void lw_bucket_to_table(const LwBucketAcc& a, long w, int64_t id, const typename G::P& pt) {
    lw_store_point<G>(a.table, a.W * a.N, w * a.N + id, pt);
}

// leaf t of tile b of window w: positions [(b P + t) T, + T) of the S
template <class G, bool MIXED>
LW_HD void lw_bucket_acc_leaf(const LwBucketAcc& a, const LwAccTile<G>& s, long w, long b,
                              int t) {
    typedef typename G::P P;
    const long lo = (b * a.P + t) * a.T;
    const long hi = lo + a.T < a.S ? lo + a.T : a.S;
    P q;
    P* acc = &s.pt[2 * t];  // the open run's sum: the first run's slot until it closes
    int64_t acc_id = 0, first_id = 0;
    for (long pos = lo; pos < hi; pos++) {
        const int64_t id = a.ids[w * a.S + pos];
        if (id == 0) continue;
        const long e = a.order ? (long)a.order[w * a.S + pos] : w * a.S + pos;
        lw_load_point<G>(a.in, e, q);
        if (id == acc_id) {
            if (MIXED) G::add_mixed(*acc, q, *acc);
            else G::add(*acc, q, *acc);
            continue;
        }
        if (acc_id != 0) {  // the open run closes
            if (first_id == 0) {
                first_id = acc_id;
                acc = &s.pt[2 * t + 1];
            } else {
                lw_bucket_to_table<G>(a, w, acc_id, *acc);
            }
        }
        *acc = q;
        acc_id = id;
    }
    if (first_id == 0) {  // one run, or none
        s.fid[t] = s.lid[t] = acc_id;
        s.pf[t] = s.pl[t] = 2 * t;
    } else {
        s.fid[t] = first_id;
        s.lid[t] = acc_id;
        s.pf[t] = 2 * t;
        s.pl[t] = 2 * t + 1;
    }
}

// step d of the tree, combine c: the nodes of 2^d leaves at l = c 2^(d+1)
// and r = l + 2^d become one node at l
template <class G>
LW_HD void lw_bucket_acc_combine(const LwBucketAcc& a, const LwAccTile<G>& s, long w, int d,
                                 int c) {
    const int l = c << (d + 1), r = l + (1 << d);
    const int64_t rf = s.fid[r];
    if (rf == 0) return;  // the right node is empty: the node is the left
    const int64_t lf = s.fid[l];
    if (lf == 0) {
        s.fid[l] = rf;
        s.lid[l] = s.lid[r];
        s.pf[l] = s.pf[r];
        s.pl[l] = s.pl[r];
        return;
    }
    const int64_t ll = s.lid[l];
    const int lpl = s.pl[l], rpf = s.pf[r];
    const bool lone = s.pf[l] == lpl, rone = rpf == s.pl[r];
    if (ll == rf) {  // the left's last run continues in the right's first
        G::add(s.pt[lpl], s.pt[rpf], s.pt[lpl]);
        if (rone) return;  // the merged run is the node's last, at lpl
        if (!lone) lw_bucket_to_table<G>(a, w, ll, s.pt[lpl]);  // in the middle: complete
    } else {
        if (!lone) lw_bucket_to_table<G>(a, w, ll, s.pt[lpl]);
        if (!rone) lw_bucket_to_table<G>(a, w, rf, s.pt[rpf]);
    }
    s.lid[l] = s.lid[r];
    s.pl[l] = s.pl[r];
}

// the root of tile b: its runs to the table at the last level (K = 1),
// else to slots 2 b (the first run) and 2 b + 1 (the last, when another)
template <class G>
LW_HD void lw_bucket_acc_root(const LwBucketAcc& a, const LwAccTile<G>& s, long w, long b) {
    typedef typename G::P P;
    const int64_t fid = s.fid[0];
    const bool two = fid != 0 && s.pf[0] != s.pl[0];
    if (a.K == 1) {
        if (fid != 0) lw_bucket_to_table<G>(a, w, fid, s.pt[s.pf[0]]);
        if (two) lw_bucket_to_table<G>(a, w, s.lid[0], s.pt[s.pl[0]]);
        return;
    }
    P none;
    G::neutral(none);
    const long n = a.W * 2 * a.K, e = w * 2 * a.K + 2 * b;
    a.slot_ids[e] = fid;
    lw_store_point<G>(a.slots, n, e, fid != 0 ? s.pt[s.pf[0]] : none);
    a.slot_ids[e + 1] = two ? s.lid[0] : 0;
    lw_store_point<G>(a.slots, n, e + 1, two ? s.pt[s.pl[0]] : none);
}

// One reduce level.  As C arguments, 28 longs: W, N (entries a window), m
// (level 0: buckets a leaf, a power of two; 0 at the later levels, whose
// entries are the last level's tile roots, a leaf each), P (leaves a tile,
// a power of two), the entries' LwPoints (9 longs: level 0 the buckets,
// entry j of window w element w N + j; later the V's), the later levels'
// R~'s LwPoints (a null first pointer at level 0), and the three (ROWS, W
// K) planes of the tiles' V and of their R~, K = ceil(leaves / P) tiles a
// window (leaves = ceil(N / m) at level 0, N later).
struct LwBucketReduce {
    long W, N, m, P, K;
    int dbl;  // log2 m: the doublings that scale a level-0 leaf's R
    LwPoints in, in_r;
    int32_t* v_out[3];
    int32_t* r_out[3];
};

LW_HD LwBucketReduce lw_bucket_reduce_arg(const long* d) {
    LwBucketReduce a;
    a.W = d[0];
    a.N = d[1];
    a.m = d[2];
    a.P = d[3];
    const long leaves = a.m > 0 ? (a.N + a.m - 1) / a.m : a.N;
    a.K = a.P > 0 ? (leaves + a.P - 1) / a.P : 0;
    a.dbl = 0;
    while (a.m > 0 && (1L << a.dbl) < a.m) a.dbl++;
    a.in = lw_points_arg(d + 4);
    a.in_r = lw_points_arg(d + 13);
    for (int c = 0; c < 3; c++) {
        a.v_out[c] = (int32_t*)(uintptr_t)d[22 + c];
        a.r_out[c] = (int32_t*)(uintptr_t)d[25 + c];
    }
    return a;
}

// A reduce tile in shared memory: P points V, then P points R~
template <class G>
LW_HD size_t lw_reduce_tile_bytes(long P) {
    return (size_t)P * 2 * sizeof(typename G::P);
}

// leaf t of tile b of window w
template <class G>
LW_HD void lw_bucket_reduce_leaf(const LwBucketReduce& a, typename G::P* v, long w, long b,
                                 int t) {
    typedef typename G::P P;
    P* rt = v + a.P;
    const long k = b * a.P + t;
    if (a.m == 0) {
        if (k < a.N) {
            lw_load_point<G>(a.in, w * a.N + k, v[t]);
            lw_load_point<G>(a.in_r, w * a.N + k, rt[t]);
        } else {
            G::neutral(v[t]);
            G::neutral(rt[t]);
        }
        return;
    }
    P e;
    G::neutral(v[t]);
    G::neutral(rt[t]);
    const long lo = k * a.m;
    const long hi = lo + a.m < a.N - 1 ? lo + a.m : a.N - 1;
    for (long i = hi - 1; i >= lo; i--) {  // A_i = B_(i+1), walked down
        lw_load_point<G>(a.in, w * a.N + i + 1, e);
        G::add(rt[t], e, rt[t]);
        G::add(v[t], rt[t], v[t]);
    }
    for (int j = 0; j < a.dbl; j++) G::dbl(rt[t], rt[t]);
}

// step d of the tree, thread u: combine u / 2 of the nodes of 2^d leaves
// at l and r = l + 2^d; u even: V_l = V_l + (V_r + R~_r), u odd: R~_l =
// 2 (R~_l + R~_r)
template <class G>
LW_HD void lw_bucket_reduce_combine(const LwBucketReduce& a, typename G::P* v, int d, int u) {
    typename G::P* rt = v + a.P;
    const int l = (u >> 1) << (d + 1), r = l + (1 << d);
    if ((u & 1) == 0) {
        G::add(v[r], rt[r], v[r]);
        G::add(v[l], v[r], v[l]);
    } else {
        G::add(rt[l], rt[r], rt[l]);
        G::dbl(rt[l], rt[l]);
    }
}

template <class G>
LW_HD void lw_bucket_reduce_root(const LwBucketReduce& a, const typename G::P* v, long w,
                                 long b) {
    const long n = a.W * a.K;
    lw_store_point<G>(a.v_out, n, w * a.K + b, v[0]);
    lw_store_point<G>(a.r_out, n, w * a.K + b, v[a.P]);
}

#ifndef __CUDACC__
// One block of either kernel on the host, each step over every thread
// before the next, as the barriers order them on the card; `mem` holds
// the tile (lw_acc_tile_bytes / lw_reduce_tile_bytes of P)
template <class G, bool MIXED>
void lw_bucket_acc_block_seq(const LwBucketAcc& a, void* mem, long blk) {
    const LwAccTile<G> s = lw_acc_tile<G>(mem, a.P);
    const long w = blk / a.K, b = blk % a.K;
    for (int t = 0; t < a.P; t++) lw_bucket_acc_leaf<G, MIXED>(a, s, w, b, t);
    for (int d = 0; (1L << d) < a.P; d++)
        for (int c = 0; c < (a.P >> (d + 1)); c++) lw_bucket_acc_combine<G>(a, s, w, d, c);
    lw_bucket_acc_root<G>(a, s, w, b);
}

template <class G>
void lw_bucket_reduce_block_seq(const LwBucketReduce& a, void* mem, long blk) {
    typename G::P* v = (typename G::P*)mem;
    const long w = blk / a.K, b = blk % a.K;
    for (int t = 0; t < a.P; t++) lw_bucket_reduce_leaf<G>(a, v, w, b, t);
    for (int d = 0; (1L << d) < a.P; d++)
        for (int u = 0; u < (a.P >> d); u++) lw_bucket_reduce_combine<G>(a, v, d, u);
    lw_bucket_reduce_root<G>(a, v, w, b);
}
#endif

#ifdef __CUDACC__
#include <cuda_runtime.h>

extern __shared__ uint64_t lw_bucket_smem[];

// Kernel 11 (msm_bucket.cu): a block a tile of P leaves, blockIdx.x = w K
// + b, a level a launch
template <class G, bool MIXED>
__global__ void __launch_bounds__(kBucketTileMax) msm_bucket_accumulate_kernel(LwBucketAcc a) {
    const LwAccTile<G> s = lw_acc_tile<G>(lw_bucket_smem, a.P);
    const long w = blockIdx.x / a.K, b = blockIdx.x % a.K;
    const int t = threadIdx.x;
    lw_bucket_acc_leaf<G, MIXED>(a, s, w, b, t);
    for (int d = 0; (1L << d) < a.P; d++) {
        __syncthreads();
        if (t < (a.P >> (d + 1))) lw_bucket_acc_combine<G>(a, s, w, d, t);
    }
    __syncthreads();
    if (t == 0) lw_bucket_acc_root<G>(a, s, w, b);
}

template <class G>
__global__ void __launch_bounds__(kBucketTileMax) msm_bucket_reduce_kernel(LwBucketReduce a) {
    typename G::P* v = (typename G::P*)lw_bucket_smem;
    const long w = blockIdx.x / a.K, b = blockIdx.x % a.K;
    const int t = threadIdx.x;
    lw_bucket_reduce_leaf<G>(a, v, w, b, t);
    for (int d = 0; (1L << d) < a.P; d++) {
        __syncthreads();
        if (t < (a.P >> d)) lw_bucket_reduce_combine<G>(a, v, d, t);
    }
    __syncthreads();
    if (t == 0) lw_bucket_reduce_root<G>(a, v, w, b);
}

// the dynamic shared memory of a tile of kBucketTileMax leaves: above the
// 48 KB default for the G2 groups (BLS12-377 G2: 2 x 128 points of 288 B)
template <class K>
int lw_bucket_smem_limit(K kernel, size_t bytes) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

template <class G>
int lw_bucket_accumulate_run(const LwBucketAcc& a, bool mixed, cudaStream_t s) {
    if (a.P > kBucketTileMax || (a.P & (a.P - 1))) return (int)cudaErrorInvalidValue;
    const size_t max_bytes = lw_acc_tile_bytes<G>(kBucketTileMax);
    const size_t bytes = lw_acc_tile_bytes<G>(a.P);
    int err;
    if (mixed) {
        static const int set = lw_bucket_smem_limit(msm_bucket_accumulate_kernel<G, true>,
                                                    max_bytes);
        if ((err = set)) return err;
        msm_bucket_accumulate_kernel<G, true><<<a.W * a.K, a.P, bytes, s>>>(a);
    } else {
        static const int set = lw_bucket_smem_limit(msm_bucket_accumulate_kernel<G, false>,
                                                    max_bytes);
        if ((err = set)) return err;
        msm_bucket_accumulate_kernel<G, false><<<a.W * a.K, a.P, bytes, s>>>(a);
    }
    return (int)cudaGetLastError();
}

template <class G>
int lw_bucket_reduce_run(const LwBucketReduce& a, cudaStream_t s) {
    if (a.P > kBucketTileMax || (a.P & (a.P - 1))) return (int)cudaErrorInvalidValue;
    static const int set = lw_bucket_smem_limit(msm_bucket_reduce_kernel<G>,
                                                lw_reduce_tile_bytes<G>(kBucketTileMax));
    if (set) return set;
    msm_bucket_reduce_kernel<G><<<a.W * a.K, a.P, lw_reduce_tile_bytes<G>(a.P), s>>>(a);
    return (int)cudaGetLastError();
}

// blocks of `threads` threads that an SM holds at once (the occupancy
// calculator: registers, shared memory, the launch bound) of kind 0 (the
// mixed accumulate), 1 (the accumulate) or 2 (the reduce); out[0] the
// blocks, out[1] the block's dynamic shared bytes
template <class G>
int lw_bucket_occupancy_run(int kind, int threads, long* out) {
    int blocks = 0;
    cudaError_t err;
    size_t bytes;
    if (kind == 2) {
        bytes = lw_reduce_tile_bytes<G>(threads);
        lw_bucket_smem_limit(msm_bucket_reduce_kernel<G>, lw_reduce_tile_bytes<G>(kBucketTileMax));
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, msm_bucket_reduce_kernel<G>,
                                                            threads, bytes);
    } else {
        bytes = lw_acc_tile_bytes<G>(threads);
        const size_t max_bytes = lw_acc_tile_bytes<G>(kBucketTileMax);
        if (kind == 0) {
            lw_bucket_smem_limit(msm_bucket_accumulate_kernel<G, true>, max_bytes);
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, msm_bucket_accumulate_kernel<G, true>, threads, bytes);
        } else {
            lw_bucket_smem_limit(msm_bucket_accumulate_kernel<G, false>, max_bytes);
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, msm_bucket_accumulate_kernel<G, false>, threads, bytes);
        }
    }
    out[0] = blocks;
    out[1] = (long)bytes;
    return (int)err;
}

// kernel 11's G2 instances, built in translation units of their own
// beside the G1 instances (msm_bucket.cu): BN254 G2 in msm_bucket_g2.cu,
// BLS12-377 G2, the longest to build, in msm_bucket_bls12_377_g2.cu
int lw_bucket_accumulate_g2(int group, const LwBucketAcc& a, bool mixed, cudaStream_t s);
int lw_bucket_reduce_g2(int group, const LwBucketReduce& a, cudaStream_t s);
int lw_bucket_occupancy_g2(int group, int kind, int threads, long* out);
int lw_bucket_accumulate_bls12_377_g2(const LwBucketAcc& a, bool mixed, cudaStream_t s);
int lw_bucket_reduce_bls12_377_g2(const LwBucketReduce& a, cudaStream_t s);
int lw_bucket_occupancy_bls12_377_g2(int kind, int threads, long* out);
#endif
