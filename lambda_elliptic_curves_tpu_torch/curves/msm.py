"""Multi-scalar multiplication over G1 (BN254, BLS12-377) and G2 (their
twists), and batched scalar multiplications of one base point.

Counterpart of ``lambda_elliptic_curves_tpu/curves/msm.py`` (``msm`` :437,
``msm_naive_host`` :58, ``_make_ops`` :71, ``msm_double_and_add`` :79,
``msm_pippenger`` :240, ``scalars_to_digits`` :39, ``optimum_window_size``
:224; parity ``msm/naive.rs:34``, ``msm/pippenger.rs:19``).

Device routes, on the curve's batched group law (:func:`make_ops`:
:class:`.weierstrass.JacobianOps` for G1, :class:`.twists.TwistJacobianOps`
for G2; every group op a launch of kernel 10 on the card):

* ``msm_double_and_add``: every scalar multiplies its point in parallel,
  one bit a step (a doubling and a mixed addition over the batch), then one
  tree reduction;
* ``msm_pippenger``: the bucket method with its windows vectorised: the
  (windows, points) matrix of bucket ids is sorted stably row by row, and
  the bucket phase (:func:`bucket_sums`, :func:`weighted_bucket_sums`) runs
  in tiles, on the card a block a tile (kernel 11, ``csrc/msm_bucket.cuh``):
  a thread walks a leaf of 16 buckets or of 16 or more sorted positions
  (enough that the first level takes one wave of the card), and the block
  merges its tile's leaves by a tree of log2 128 steps in shared memory;
  about one mixed addition a point and two additions a bucket,
  with chains of dependent additions that stay short whatever the skew
  of the scalars (the JAX package's
  ``bucket_accumulate_chunked`` :107 scans rows of columns, then runs a
  segmented scan over the columns).  The window sums go affine on the host
  and combine there, most significant first (c doublings and an add
  each), where the JAX package runs that in a small device scan.

``msm`` sends instances of ``HOST_MSM_MAX`` points or fewer to the host
(``msm_naive_host``, or ``twists.msm_g2_naive_host`` for G2), as the JAX
package does.

``fixed_base_multiples`` computes [s_i] G for one base point G and many
scalars, as Groth16's setup and KZG's ``insecure_setup`` need (the JAX
package runs one host scalar multiplication a point there,
``provers/groth16/setup.py:65-96``, ``commitments/kzg.py:32``): a comb
over ``FIXED_BASE_WINDOW``-bit windows, whose table d 2^(c w) G is built
once on the host, so each lane takes one mixed addition a window (31 for
the 32 windows of a 253- or 254-bit order) and no doubling; on the card
the whole comb is one launch of kernel 10's comb entry.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import native
from .weierstrass import JacobianOps

#: instances of this many points or fewer run on the host (the JAX
#: package's ``LWT_MSM_HOST_MAX`` default)
HOST_MSM_MAX = 64

#: scalars are held as 16-bit digits (bit containers, no field arithmetic)
DIGIT_BITS = 16

#: the bucket phase's leaves: the least positions a leaf walks at the
#: accumulate's first level (mixed additions from the affine points), the
#: slots a leaf takes at its later levels, and the buckets a leaf walks at
#: the reduce's first level (a power of two); and its tiles: leaves a block of
#: kernel 11 merges by a tree, in both phases (a power of two, at most
#: ``TILE_MAX``, ``csrc/msm_bucket.cuh``'s kBucketTileMax).  Kernel 11 and
#: its plain version take the same, so their results are bitwise equal
BUCKET_CHUNK = 16
MERGE_CHUNK = 2
REDUCE_CHUNK = 16
BUCKET_TILE = 128
TILE_MAX = 128

#: blocks of kernel 11 (128 threads) that an H100's 132 SMs hold at once,
#: by curve group (curve.cuh's LW_CURVE_*), as the occupancy calculator
#: gave them when the tiles were sized: 3 an SM for BN254 G1 (138 and 168
#: registers a thread), 2 for the others (182-255).  On dense32.cuh's
#: product BN254 G1 holds 4 and BLS12-377 G1 3 (119-168 registers;
#: ``chip_smoke.py`` phase 2m), which these waves do not use yet.  The
#: accumulate's first leaves grow until the windows' tiles take one such
#: wave: one wave of longer walks ends sooner than two or three of short
#: ones
WAVE_BLOCKS = {0: 3 * 132, 1: 2 * 132, 2: 2 * 132, 3: 2 * 132}

#: bits of a window of ``fixed_base_multiples``: a table of 2^c points a
#: window, built on the host; c = 8 takes 32 windows over a 253-bit order
FIXED_BASE_WINDOW = 8


def make_ops(curve):
    """The curve's batched group law: ``JacobianOps`` unless the curve
    names its own (a twist's ``TwistJacobianOps``)."""
    return getattr(curve, "jacobian_ops_class", JacobianOps)(curve)


def scalars_to_digits(curve, scalars, device) -> torch.Tensor:
    """Host ints -> ``(Ks, B)`` int64 tensor of the 16-bit digits of each
    scalar reduced mod the subgroup order (canonical, not Montgomery)."""
    order = getattr(curve, "order", 0) or curve.field.p
    ks = max(1, -(-order.bit_length() // DIGIT_BITS))
    nbytes = 2 * ks
    buf = b"".join((int(s) % order).to_bytes(nbytes, "little") for s in scalars)
    d = np.frombuffer(buf, dtype="<u2").reshape(len(scalars), ks).T.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(d)).to(device)


def msm_naive_host(scalars, points):
    """Exact host MSM (``msm/naive.rs:34``): the oracle."""
    if not points:
        raise ValueError("empty MSM")
    acc = points[0].curve.neutral()
    for s, pt in zip(scalars, points):
        acc = acc.operate_with(pt.operate_with_self(int(s)))
    return acc


def _scalar_bits(curve) -> int:
    order = getattr(curve, "order", 0)
    return order.bit_length() if order else curve.field.params.nbits


def _bit(digits: torch.Tensor, b: int) -> torch.Tensor:
    return ((digits[b // DIGIT_BITS] >> (b % DIGIT_BITS)) & 1).bool()


def scalar_multiples(curve, digits: torch.Tensor, points_dev, ops=None):
    """[s_i] P_i for every lane i (points affine-or-infinity, as
    ``from_host`` gives; one point broadcasts over all scalars): msb-first
    double-and-add, one doubling and one mixed addition over the batch a
    bit."""
    ops = ops or make_ops(curve)
    nbits = _scalar_bits(curve)
    acc = ops.neutral((digits.shape[-1],), digits.device)
    for b in range(nbits - 1, -1, -1):
        acc = ops.double(acc)
        acc = ops.select(_bit(digits, b), ops.add_mixed(acc, points_dev), acc)
    return acc


def msm_double_and_add(curve, digits: torch.Tensor, points_dev, ops=None):
    """Batched double-and-add, then one tree reduction; returns (x, y, z)
    of shape (8, 1)."""
    ops = ops or make_ops(curve)
    return ops.tree_reduce(scalar_multiples(curve, digits, points_dev, ops))


def optimum_window_size(n: int) -> int:
    """4 + log2(n)*4/5, the reference's auto-tune (``pippenger.rs:34``)."""
    return max(1, int(4 + 0.8 * math.log2(max(n, 2))))


def window_ids(digits: torch.Tensor, c: int, n_windows: int) -> torch.Tensor:
    """``(W, B)`` bucket ids: bits [w c, (w + 1) c) of every scalar (c <= 16),
    all windows at once."""
    dev = digits.device
    starts = torch.arange(n_windows, dtype=torch.int64) * c
    k, shift = (starts // DIGIT_BITS).to(dev), (starts % DIGIT_BITS).to(dev)
    padded = torch.cat([digits, torch.zeros_like(digits[:1])])
    lo = padded[k] >> shift[:, None]
    hi = padded[k + 1] << (DIGIT_BITS - shift)[:, None]
    return (lo | hi) & ((1 << c) - 1)


# -- the bucket phase: kernel 11 on the card, its plain version on the CPU ------

def _neutral_planes(ops, n: int, dev):
    """The neutral point over ``n`` lanes, three contiguous (L, n) planes."""
    return tuple(c.contiguous() for c in ops.neutral((n,), dev))


def _tile(leaves: int, tile: int) -> int:
    """Leaves of a level's tiles: ``tile``, or the least power of two that
    holds the level's ``leaves`` when that is fewer."""
    return min(tile, 1 << max(0, leaves - 1).bit_length())


def _leaf_length(least: int, per_window: int, W: int, tile: int, ops) -> int:
    """Positions a first-level accumulate leaf walks over ``per_window`` of
    each of W windows: ``least``, or more when the windows' tiles of
    ``tile`` leaves would fill more than one wave of the card's blocks
    (``WAVE_BLOCKS`` of the group)."""
    tiles = WAVE_BLOCKS.get(getattr(ops.curve, "kernel_group", -1), 0) // W
    return max(least, -(-per_window // (tile * tiles))) if tiles else least


def _check_tile(tile: int) -> None:
    if tile < 2 or tile & (tile - 1) or tile > TILE_MAX:
        raise ValueError(f"a tile is a power of two from 2 to {TILE_MAX} leaves")


def _gather(pt, idx):
    return tuple(c[:, idx] for c in pt)


def _add_where(add, mask, p1, p2):
    """``add(p1, p2)`` on the lanes of ``mask`` (the others keep p1), the
    addition run on those lanes alone."""
    if not bool(mask.any()):
        return p1
    out = tuple(c.clone() for c in p1)
    for o, v in zip(out, add(tuple(c[:, mask] for c in p1), tuple(c[:, mask] for c in p2))):
        o[:, mask] = v
    return out


def _accumulate_level_native(ops, call, ids, order, pts, chunk, tile, table, nbuckets, mixed):
    """One accumulate level of ``csrc/msm_bucket.cuh``: its 23 arguments
    handed to ``call(args, mixed)`` (on the card one launch of kernel 11);
    the next level's slots, or None at the last level."""
    W, S = ids.shape
    P = _tile(-(-S // chunk), tile)
    K = -(-S // (P * chunk))
    L, dev = ops.f.num_limbs, ids.device
    ids = ids.contiguous()
    order = None if order is None else order.contiguous()
    n_in = pts[0].shape[-1]
    pts_arg, keep = ops.points_arg(pts, (n_in,), n_in, dev.type)
    slots = None
    if K > 1:
        slots = (torch.empty((W, 2 * K), dtype=torch.int64, device=dev),
                 tuple(torch.empty((L, W * 2 * K), dtype=torch.int32, device=dev)
                       for _ in range(3)))
    desc = ([W, S, chunk, nbuckets, P, ids.data_ptr(),
             0 if order is None else order.data_ptr()]
            + pts_arg + [t.data_ptr() for t in table]
            + ([0] * 4 if slots is None else [slots[0].data_ptr()]
               + [t.data_ptr() for t in slots[1]]))
    call((ctypes.c_long * 23)(*desc), mixed)
    return slots


def _accumulate_level_plain(ops, ids, order, pts, chunk, tile, table, nbuckets, mixed):
    """Kernel 11's accumulate level in PyTorch, every tile side by side:
    the leaves' walks (one position of every leaf a step), the tree's steps
    (every combine of a step at once, on the tiles' point stores), then the
    roots: the same additions, in the same order of operands, as
    ``csrc/msm_bucket.cuh``."""
    W, S = ids.shape
    P = _tile(-(-S // chunk), tile)
    K = -(-S // (P * chunk))
    n, dev = K * P, ids.device  # leaves a window
    pad = n * chunk - S
    idv = torch.nn.functional.pad(ids, (0, pad)).reshape(W, n, chunk)
    elem = (torch.arange(W * S, device=dev).reshape(W, S) if order is None else order)
    elemv = torch.nn.functional.pad(elem, (0, pad)).reshape(W, n, chunk)
    add = ops.add_mixed if mixed else ops.add
    zero = torch.zeros((W, n), dtype=torch.int64, device=dev)

    def to_table(mask, pt, pt_id, rows):
        cols = (rows + pt_id)[mask]
        for t, c in zip(table, pt):
            t[:, cols] = c[:, mask]

    # the walks: the first run's sum, and the open run's
    rows = (torch.arange(W, device=dev)[:, None] * nbuckets).expand(W, n)
    first, acc = ops.neutral((W, n), dev), ops.neutral((W, n), dev)
    first_id, acc_id = zero, zero
    for step in range(chunk):
        cur = idv[:, :, step]
        valid = cur != 0
        q = tuple(c[:, elemv[:, :, step]] for c in pts)
        same = valid & (cur == acc_id)
        new = valid & ~same
        close = new & (acc_id != 0)
        to_first = close & (first_id == 0)
        first = ops.select(to_first, acc, first)
        first_id = torch.where(to_first, acc_id, first_id)
        to_table(close & ~to_first, acc, acc_id, rows)
        acc = ops.select(new, q, _add_where(add, same, acc, q))
        acc_id = torch.where(new, cur, acc_id)
    # the leaves as tree nodes: the tiles' stores of 2 P points, and by a
    # node's first leaf its runs' ids and where their sums are
    one = first_id == 0
    store = tuple(torch.stack([a, b], dim=-1).reshape(a.shape[0], W * K * 2 * P)
                  for a, b in zip(ops.select(one, acc, first), acc))
    fid = torch.where(one, acc_id, first_id).reshape(W * K, P)
    lid = acc_id.reshape(W * K, P)
    pos = 2 * torch.arange(P, device=dev).expand(W * K, P)
    pf, pl = pos, torch.where(one.reshape(W * K, P), pos, pos + 1)
    base = torch.arange(W * K, device=dev)[:, None] * (2 * P)
    rows = (torch.arange(W * K, device=dev)[:, None] // K) * nbuckets
    d = 0
    while (1 << d) < P:
        lo = torch.arange(0, P, 2 << d, device=dev)
        hi = lo + (1 << d)
        lf, ll, lpf, lpl = fid[:, lo], lid[:, lo], pf[:, lo], pl[:, lo]
        rf, rl, rpf, rpl = fid[:, hi], lid[:, hi], pf[:, hi], pl[:, hi]
        both = (lf != 0) & (rf != 0)
        take_r = (lf == 0) & (rf != 0)
        merge = both & (ll == rf)
        lone, rone = lpf == lpl, rpf == rpl
        gl, gr = base + lpl, base + rpf
        if bool(merge.any()):
            at = gl[merge]
            for c, v in zip(store, ops.add(_gather(store, at), _gather(store, gr[merge]))):
                c[:, at] = v
        keep_last = merge & rone  # the merged run is the node's last
        rows_d = rows.expand_as(lf)
        to_table(both & ~lone & ~keep_last, _gather(store, gl), ll, rows_d)
        to_table(both & ~merge & ~rone, _gather(store, gr), rf, rows_d)
        right_last = take_r | (both & ~keep_last)
        fid[:, lo] = torch.where(take_r, rf, lf)
        pf[:, lo] = torch.where(take_r, rpf, lpf)
        lid[:, lo] = torch.where(right_last, rl, ll)
        pl[:, lo] = torch.where(right_last, rpl, lpl)
        d += 1
    fid0, lid0 = fid[:, 0], lid[:, 0]
    two = (fid0 != 0) & (pf[:, 0] != pl[:, 0])
    f_pt = _gather(store, base[:, 0] + pf[:, 0])
    l_pt = _gather(store, base[:, 0] + pl[:, 0])
    if K == 1:
        to_table(fid0 != 0, f_pt, fid0, rows[:, 0])
        to_table(two, l_pt, lid0, rows[:, 0])
        return None
    none = ops.neutral((W * K,), dev)
    slot0 = ops.select(fid0 != 0, f_pt, none)
    slot1 = ops.select(two, l_pt, none)
    slot1_id = torch.where(two, lid0, torch.zeros_like(lid0))
    return (torch.stack([fid0, slot1_id], dim=-1).reshape(W, 2 * K),
            tuple(torch.stack([a, b], dim=-1).reshape(a.shape[0], W * 2 * K)
                  for a, b in zip(slot0, slot1)))


def _bucket_sums(ops, level, ids, points_dev, nbuckets: int, chunk: int, tile: int = 0):
    """The accumulate levels, ``level`` (kernel 11's or the plain version's)
    run on each: level 0 over the sorted ids and the points read through
    the sort's permutation (leaves of ``chunk`` positions or more,
    ``_leaf_length``; mixed additions), each next level over the slots of
    the last (leaves of
    ``MERGE_CHUNK`` slots, full additions), until one tile holds a
    window (tiles of ``tile`` leaves, by default ``BUCKET_TILE``)."""
    if chunk < 1:
        raise ValueError("the accumulate's chunk is 1 position or more")
    tile = tile or BUCKET_TILE
    _check_tile(tile)
    W, S = ids.shape
    chunk = _leaf_length(chunk, S, W, tile, ops)
    dev = ids.device
    sorted_ids, order = torch.sort(ids, dim=-1, stable=True)
    table = _neutral_planes(ops, W * nbuckets, dev)
    seq_ids, seq_order, seq_pts, mixed = sorted_ids, order, points_dev, True
    while True:
        slots = level(seq_ids, seq_order, seq_pts, chunk, tile, table, nbuckets, mixed)
        if slots is None:
            return tuple(t.reshape(t.shape[0], W, nbuckets) for t in table)
        seq_ids, seq_order, seq_pts, mixed = slots[0], None, slots[1], False
        chunk = MERGE_CHUNK


def bucket_sums(ops, ids: torch.Tensor, points_dev, nbuckets: int, chunk: int = BUCKET_CHUNK):
    """(x, y, z) of shape (L, W, nbuckets): bucket j of window w is the sum
    of the points whose id in window w is j (bucket 0 neutral).  Each row
    is sorted stably by id and walked in leaves of ``chunk`` positions,
    tiles of ``BUCKET_TILE`` leaves merged by a tree (``csrc/
    msm_bucket.cuh``): kernel 11 on the card, a launch a level; the plain
    version on the CPU."""
    group = ops.kernel_group(points_dev)
    if group is None:
        return _bucket_sums(ops, functools.partial(_accumulate_level_plain, ops), ids,
                            points_dev, nbuckets, chunk)

    def call(args, mixed):
        native.launch(ops.counter("msm_bucket"), "lw_msm_bucket_accumulate", group,
                      int(mixed), args)
    return _bucket_sums(ops, functools.partial(_accumulate_level_native, ops, call), ids,
                        points_dev, nbuckets, chunk)


def bucket_sums_plain(ops, ids: torch.Tensor, points_dev, nbuckets: int,
                      chunk: int = BUCKET_CHUNK):
    """:func:`bucket_sums`' plain version on any device (the plain group
    law, ``ops.plain()``): what kernel 11 is held against on the card."""
    ops = ops.plain()
    return _bucket_sums(ops, functools.partial(_accumulate_level_plain, ops), ids, points_dev,
                        nbuckets, chunk)


def _reduce_shape(N: int, chunk: int, tile: int, first: bool) -> tuple:
    """(leaves a window, leaves a tile, tiles a window) of a reduce level
    over N entries a window: at the first level a leaf is ``chunk``
    buckets, later an entry."""
    leaves = -(-N // chunk) if first else N
    P = _tile(leaves, tile)
    return leaves, P, -(-leaves // P)


def _reduce_level_native(ops, call, v, r, chunk, tile):
    """One reduce level of ``csrc/msm_bucket.cuh``: its 28 arguments handed
    to ``call(args)`` (on the card one launch of kernel 11); the tiles' (V,
    R~), three (L, W, K) planes each.  At the first level ``v`` holds the
    buckets and ``r`` is None."""
    L, W, N = v[0].shape
    _, P, K = _reduce_shape(N, chunk, tile, r is None)
    dev = v[0].device
    flat = lambda pt: tuple(c.reshape(L, W * N) for c in pt)  # noqa: E731
    v_arg, keep = ops.points_arg(flat(v), (W * N,), W * N, dev.type)
    r_arg = [0] * 9
    if r is not None:
        r_arg, keep_r = ops.points_arg(flat(r), (W * N,), W * N, dev.type)
    vo = tuple(torch.empty((L, W * K), dtype=torch.int32, device=dev) for _ in range(3))
    ro = tuple(torch.empty((L, W * K), dtype=torch.int32, device=dev) for _ in range(3))
    desc = ([W, N, chunk if r is None else 0, P] + v_arg + r_arg
            + [t.data_ptr() for t in vo] + [t.data_ptr() for t in ro])
    call((ctypes.c_long * 28)(*desc))
    return tuple(t.reshape(L, W, K) for t in vo), tuple(t.reshape(L, W, K) for t in ro)


def _reduce_level_plain(ops, v, r, chunk, tile):
    """Kernel 11's reduce level in PyTorch, every tile side by side.  The
    leaves: at the first level A_i = B_(i+1) walked down a leaf's ``chunk``
    entries with a running sum R and the sum of the running sums V (a step
    in which every leaf adds only neutral points, which the complete
    addition returns exactly, is left out), then R doubled log2(chunk)
    times; later the last level's (V, R~).  Then the tree: V_l = V_l + (V_r
    + R~_r) and R~_l = 2 (R~_l + R~_r) at every step."""
    L, W, N = v[0].shape
    leaves, P, K = _reduce_shape(N, chunk, tile, r is None)
    n, dev = K * P, v[0].device

    def padded(pt, start, count, width):
        fill = ops.neutral((W, n * width - count), dev)
        return tuple(torch.cat([c[..., start:start + count], f], dim=-1)
                     for c, f in zip(pt, fill))

    if r is None:
        A = tuple(c.reshape(L, W, n, chunk) for c in padded(v, 1, N - 1, chunk))
        finite = lambda pt: ~ops.f.is_zero(pt[2])  # noqa: E731
        run, acc = ops.neutral((W, n), dev), ops.neutral((W, n), dev)
        for step in reversed(range(chunk)):
            a = tuple(c[..., step] for c in A)
            if not bool((finite(a) | finite(run)).any()):
                continue  # run and a neutral everywhere: run, acc stay
            run = ops.add(run, a)
            acc = ops.add(acc, run)
        for _ in range(chunk.bit_length() - 1):
            run = ops.double(run)
        v, r = acc, run
    else:
        v, r = padded(v, 0, N, 1), padded(r, 0, N, 1)
    v = tuple(c.reshape(L, W * K, P).clone() for c in v)
    r = tuple(c.reshape(L, W * K, P).clone() for c in r)
    d = 0
    while (1 << d) < P:
        lo = torch.arange(0, P, 2 << d, device=dev)
        hi = lo + (1 << d)
        at = lambda pt, i: tuple(c[..., i] for c in pt)  # noqa: E731
        v_hi = ops.add(at(v, hi), at(r, hi))
        v_lo = ops.add(at(v, lo), v_hi)
        r_lo = ops.double(ops.add(at(r, lo), at(r, hi)))
        for c, x, y in zip(v, v_lo, v_hi):
            c[..., lo], c[..., hi] = x, y
        for c, x in zip(r, r_lo):
            c[..., lo] = x
        d += 1
    return (tuple(c[..., 0].reshape(L, W, K) for c in v),
            tuple(c[..., 0].reshape(L, W, K) for c in r))


def _weighted_bucket_sums(level, buckets, chunk: int, tile: int = 0):
    """The reduce levels, ``level`` (kernel 11's or the plain version's) run
    on each, the first over leaves of ``chunk`` buckets, until one tile (of
    ``tile`` leaves, by default ``BUCKET_TILE``) holds a window: its V is
    the window's sum."""
    if chunk < 1 or chunk & (chunk - 1):
        raise ValueError("the reduce's chunk is a power of two")
    tile = tile or BUCKET_TILE
    _check_tile(tile)
    v, r = buckets, None
    while True:
        v, r = level(v, r, chunk, tile)
        if v[0].shape[-1] == 1:
            return v


def weighted_bucket_sums(ops, buckets, chunk: int = REDUCE_CHUNK):
    """sum_j j B_j along the last axis of (L, W, N) buckets: (L, W, 1), by
    leaves of ``chunk`` buckets' running sums and a tree over tiles of
    ``BUCKET_TILE`` leaves (``csrc/msm_bucket.cuh``): kernel 11 on the
    card, a launch a level; the plain version on the CPU."""
    group = ops.kernel_group(buckets)
    if group is None:
        return _weighted_bucket_sums(functools.partial(_reduce_level_plain, ops), buckets, chunk)

    def call(args):
        native.launch(ops.counter("msm_bucket"), "lw_msm_bucket_reduce", group, args)
    return _weighted_bucket_sums(functools.partial(_reduce_level_native, ops, call), buckets,
                                 chunk)


def weighted_bucket_sums_plain(ops, buckets, chunk: int = REDUCE_CHUNK):
    """:func:`weighted_bucket_sums`' plain version on any device: what
    kernel 11 is held against on the card."""
    return _weighted_bucket_sums(functools.partial(_reduce_level_plain, ops.plain()), buckets,
                                 chunk)


def msm_pippenger(curve, digits: torch.Tensor, points_dev, window_size: int | None = None,
                  ops=None):
    """Bucket-method MSM over device tensors (``pippenger.rs:42``); returns
    a host point."""
    ops = ops or make_ops(curve)
    B = digits.shape[-1]
    nbits = _scalar_bits(curve)
    c = min(window_size or optimum_window_size(B), 15)
    n_windows = -(-nbits // c)
    ids = window_ids(digits, c, n_windows)
    values = weighted_bucket_sums(ops, bucket_sums(ops, ids, points_dev, 1 << c))
    windows = ops.to_host_exact(tuple(v.reshape(v.shape[0], n_windows) for v in values))
    acc = curve.neutral()
    for value in reversed(windows):  # most significant window first
        for _ in range(c):
            acc = acc.double()
        acc = acc + value
    return acc


def msm(curve, scalars, points, window_size=None, method: str = "pippenger", *,
        device="cuda", points_dev=None):
    """Host scalars and host points -> host point (``pippenger::msm``,
    ``msm/pippenger.rs:19``).  Above ``HOST_MSM_MAX`` points it runs on
    ``device`` by ``method`` ("pippenger" or "naive", the double-and-add);
    ``points_dev``, when given, holds ``points`` as ``from_host`` tensors
    (the KZG caches its SRS so)."""
    if len(scalars) != len(points):
        raise ValueError("scalars and points must have the same length")
    if not points:
        return None
    if len(points) <= HOST_MSM_MAX:
        if hasattr(curve, "jacobian_ops_class"):  # G2
            from .twists import msm_g2_naive_host

            return msm_g2_naive_host([int(s) for s in scalars], points)
        return msm_naive_host([int(s) for s in scalars], points)
    ops = make_ops(curve)
    pts = points_dev if points_dev is not None else ops.from_host(points, device)
    digits = scalars_to_digits(curve, scalars, pts[0].device)
    if method == "naive":
        return ops.to_host(msm_double_and_add(curve, digits, pts, ops))[0]
    return msm_pippenger(curve, digits, pts, window_size, ops)


_comb_tables: dict = {}


def _comb_table(ops, base, c: int, windows: int, device):
    """The comb's table, built with host point arithmetic and cached per
    (curve, base, c, windows, device): entry w 2^c + d is d 2^(c w) base,
    affine (infinity at d = 0).  Returned as (x, y, z) planes of shape (L,
    windows * 2^c), the plain version's, and entry-major for kernel 10's
    comb entry: an (entries, 2 L) int32 tensor of each entry's x limbs then
    its y limbs, and an (entries,) uint8 tensor, 1 at infinity."""
    if hasattr(base, "to_affine"):  # G1
        aff = base.to_affine()
        coords = (aff.x, aff.y, aff.z)
    else:  # G2
        coords = (base.x.value, base.y.value, base.inf)
    key = (ops.curve.name, coords, c, windows, str(device))
    hit = _comb_tables.get(key)
    if hit is not None:
        return hit
    points, step = [], base
    for _ in range(windows):
        row = [ops.curve.neutral()]
        for _ in range((1 << c) - 1):
            row.append(row[-1] + step)
        points += row
        for _ in range(c):
            step = step.double()
    planes = ops.from_host(points, device)
    entries = torch.cat(planes[:2]).T.contiguous()
    inf = (planes[2] == 0).all(dim=0).to(torch.uint8)
    _comb_tables[key] = (planes, entries, inf)
    return _comb_tables[key]


def comb_args(table, digits: torch.Tensor, c: int, windows: int):
    """Kernel 10's comb entry's 7 arguments (``csrc/curve.cuh``'s
    ``LwComb``) over ``table`` (``_comb_table``) and ``digits``, the
    scalars' (digit rows, n) 16-bit digits, from which a lane takes its
    window ids itself."""
    _, entries, inf = table
    return (ctypes.c_long * 7)(entries.data_ptr(), inf.data_ptr(), digits.data_ptr(),
                               digits.stride(0), c, windows, digits.shape[0])


def _comb_native(ops, call, table, digits: torch.Tensor, c: int, windows: int):
    """Kernel 10's comb entry over the lanes of ``digits``, the window ids
    taken from the digits: its arguments handed to ``call(args, outputs,
    n)``, on the card one launch; three contiguous (L, n) planes."""
    n, dev = digits.shape[-1], digits.device
    digits = digits.contiguous()
    out = tuple(torch.empty((ops.f.num_limbs, n), dtype=torch.int32, device=dev)
                for _ in range(3))
    if n:
        call(comb_args(table, digits, c, windows), out, n)
    return out


def fixed_base_multiples(curve, digits: torch.Tensor, base, ops=None,
                         window: int = FIXED_BASE_WINDOW):
    """[s_i] base for every lane i of ``digits`` (``scalars_to_digits``),
    ``base`` a host point: lane i sums the table entries of its scalar's
    c-bit windows, one complete mixed addition a window; (x, y, z) of the
    lanes' shape.  On the card one launch of kernel 10's comb entry; on
    CPU tensors, or with a plain group law, the plain version: a window
    at a time, the entries gathered and added over every lane."""
    ops = ops or make_ops(curve)
    n_windows = -(-_scalar_bits(curve) // window)
    table = _comb_table(ops, base, window, n_windows, digits.device)
    group = ops.kernel_group(table[0])
    if group is not None:
        def call(args, out, n):
            native.launch(ops.counter("curve_op"), "lw_curve_comb", group, args,
                          *(o.data_ptr() for o in out), n)
        return _comb_native(ops, call, table, digits, window, n_windows)
    ids = window_ids(digits, window, n_windows)
    acc = None
    for w in range(n_windows):
        pt = tuple(t[:, ids[w] + (w << window)] for t in table[0])
        acc = pt if acc is None else ops.add_mixed(acc, pt)
    return acc
