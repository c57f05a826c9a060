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
  in chunks, one thread a chunk on the card (kernel 11,
  ``csrc/msm_bucket.cuh``): about one mixed addition a point and two
  additions a bucket, whatever the skew of the scalars (the JAX package's
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
once on the host, so each lane takes one mixed addition a window (32 for a
253-bit order) and no doubling.
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

#: positions of a chunk of the bucket phase's accumulate, and buckets of a
#: chunk of its reduce (a power of two): kernel 11 and its plain version
#: take the same, so their results are bitwise equal
BUCKET_CHUNK = 16
REDUCE_CHUNK = 16

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


def _accumulate_level_native(ops, call, ids, order, pts, chunk, table, nbuckets, mixed):
    """One accumulate level of ``csrc/msm_bucket.cuh``: its 22 arguments
    handed to ``call(args, mixed)`` (on the card one launch of kernel 11);
    the next level's slots, or None at the last level."""
    W, S = ids.shape
    K = -(-S // chunk)
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
    desc = ([W, S, chunk, nbuckets, ids.data_ptr(), 0 if order is None else order.data_ptr()]
            + pts_arg + [t.data_ptr() for t in table]
            + ([0] * 4 if slots is None else [slots[0].data_ptr()]
               + [t.data_ptr() for t in slots[1]]))
    call((ctypes.c_long * 22)(*desc), mixed)
    return slots


def _accumulate_level_plain(ops, ids, order, pts, chunk, table, nbuckets, mixed):
    """Kernel 11's accumulate level in PyTorch: the chunks' walks side by
    side, one position of every chunk a step."""
    W, S = ids.shape
    K = -(-S // chunk)
    dev = ids.device
    pad = K * chunk - S
    idv = torch.nn.functional.pad(ids, (0, pad)).reshape(W, K, chunk)
    elem = (torch.arange(W * S, device=dev).reshape(W, S) if order is None else order)
    elemv = torch.nn.functional.pad(elem, (0, pad)).reshape(W, K, chunk)
    last_level = K == 1
    rows = (torch.arange(W, device=dev)[:, None] * nbuckets).expand(W, K)
    acc = ops.neutral((W, K), dev)
    acc_id = torch.zeros((W, K), dtype=torch.int64, device=dev)
    have = torch.zeros((W, K), dtype=torch.bool, device=dev)
    first_open = torch.ones((W, K), dtype=torch.bool, device=dev)
    slot0, slot0_id = ops.neutral((W, K), dev), torch.zeros_like(acc_id)
    add = ops.add_mixed if mixed else ops.add

    def to_table(mask, pt, pt_id):
        cols = (rows + pt_id)[mask]
        for t, c in zip(table, pt):
            t[:, cols] = c[:, mask]

    for step in range(chunk):
        cur = idv[:, :, step]
        valid = cur != 0
        q = tuple(c[:, elemv[:, :, step]] for c in pts)
        same = valid & have & (cur == acc_id)
        new = valid & ~same
        close = new & have
        to_slot = close & first_open if not last_level else torch.zeros_like(close)
        slot0 = ops.select(to_slot, acc, slot0)
        slot0_id = torch.where(to_slot, acc_id, slot0_id)
        to_table(close & ~to_slot, acc, acc_id)
        first_open = first_open & ~close
        if bool(same.any()):
            acc = ops.select(same, add(acc, q), acc)
        acc = ops.select(new, q, acc)
        acc_id = torch.where(new, cur, acc_id)
        have = have | valid
    if last_level:
        to_table(have, acc, acc_id)
        return None
    one_run, more = have & first_open, have & ~first_open
    slot0 = ops.select(one_run, acc, slot0)
    slot0_id = torch.where(one_run, acc_id, slot0_id)
    slot1 = ops.select(more, acc, ops.neutral((W, K), dev))
    slot1_id = torch.where(more, acc_id, torch.zeros_like(acc_id))
    return (torch.stack([slot0_id, slot1_id], dim=-1).reshape(W, 2 * K),
            tuple(torch.stack([a, b], dim=-1).reshape(a.shape[0], W * 2 * K)
                  for a, b in zip(slot0, slot1)))


def _bucket_sums(ops, level, ids, points_dev, nbuckets: int, chunk: int):
    """The accumulate levels, ``level`` (kernel 11's or the plain version's)
    run on each: level 0 over the sorted ids and the points read through
    the sort's permutation (mixed additions), each next level over the
    slots of the last (full additions), until one chunk holds a window."""
    if chunk < 4:  # 2 ceil(S / chunk) slots: fewer than S positions only from 4 on
        raise ValueError("the accumulate's chunk is 4 positions or more")
    W = ids.shape[0]
    dev = ids.device
    sorted_ids, order = torch.sort(ids, dim=-1, stable=True)
    table = _neutral_planes(ops, W * nbuckets, dev)
    seq_ids, seq_order, seq_pts, mixed = sorted_ids, order, points_dev, True
    while True:
        slots = level(seq_ids, seq_order, seq_pts, chunk, table, nbuckets, mixed)
        if slots is None:
            return tuple(t.reshape(t.shape[0], W, nbuckets) for t in table)
        seq_ids, seq_order, seq_pts, mixed = slots[0], None, slots[1], False


def bucket_sums(ops, ids: torch.Tensor, points_dev, nbuckets: int, chunk: int = BUCKET_CHUNK):
    """(x, y, z) of shape (L, W, nbuckets): bucket j of window w is the sum
    of the points whose id in window w is j (bucket 0 neutral).  Each row
    is sorted stably by id and walked in chunks of ``chunk`` positions
    (``csrc/msm_bucket.cuh``): kernel 11 on the card, a launch a level; the
    plain version on the CPU."""
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


def _reduce_level_native(ops, call, bk, carry, chunk, dbl):
    """One reduce level of ``csrc/msm_bucket.cuh``: its 28 arguments handed
    to ``call(args)`` (on the card one launch of kernel 11); (R, C), three
    (L, W, K) planes each."""
    L, W, N = bk[0].shape
    K = -(-N // chunk)
    dev = bk[0].device
    flat = lambda pt: tuple(c.reshape(L, W * N) for c in pt)  # noqa: E731
    bk_arg, keep = ops.points_arg(flat(bk), (W * N,), W * N, dev.type)
    carry_arg = [0] * 9
    if carry is not None:
        carry_arg, keep_carry = ops.points_arg(flat(carry), (W * N,), W * N, dev.type)
    r = tuple(torch.empty((L, W * K), dtype=torch.int32, device=dev) for _ in range(3))
    c = tuple(torch.empty((L, W * K), dtype=torch.int32, device=dev) for _ in range(3))
    desc = ([W, N, chunk, dbl] + bk_arg + carry_arg + [t.data_ptr() for t in r]
            + [t.data_ptr() for t in c])
    call((ctypes.c_long * 28)(*desc))
    return tuple(t.reshape(L, W, K) for t in r), tuple(t.reshape(L, W, K) for t in c)


def _reduce_level_plain(ops, bk, carry, chunk, dbl):
    """Kernel 11's reduce level in PyTorch, the chunks side by side: A_i =
    B_(i+1) walked down a chunk with a running sum and the sum of the
    running sums; the carried C's summed up; C = that sum + the sum of
    running sums doubled ``dbl`` times.  A step in which no chunk adds
    anything but the neutral point (the complete addition returns the other
    operand exactly) is left out."""
    L, W, N = bk[0].shape
    K = -(-N // chunk)
    dev = bk[0].device

    def chunked(pt, start, count):
        pad = K * chunk - count
        fill = ops.neutral((W, pad), dev)
        return tuple(torch.cat([c[..., start:], f], dim=-1).reshape(L, W, K, chunk)
                     for c, f in zip(pt, fill))

    finite = lambda pt: ~ops.f.is_zero(pt[2])  # noqa: E731
    A = chunked(bk, 1, N - 1)
    run, acc = ops.neutral((W, K), dev), ops.neutral((W, K), dev)
    for step in reversed(range(min(chunk, N - 1) if K == 1 else chunk)):
        a = tuple(c[..., step] for c in A)
        if not bool((finite(a) | finite(run)).any()):
            continue  # run and a neutral everywhere: run, acc stay
        run = ops.add(run, a)
        acc = ops.add(acc, run)
    if carry is not None:
        C = chunked(carry, 0, N)
        d = ops.neutral((W, K), dev)
        for step in range(min(chunk, N) if K == 1 else chunk):
            c_step = tuple(c[..., step] for c in C)
            if bool(finite(c_step).any()):
                d = ops.add(d, c_step)
        for _ in range(dbl):
            acc = ops.double(acc)
        acc = ops.add(d, acc)
    return run, acc


def _weighted_bucket_sums(level, buckets, chunk: int):
    """The reduce levels, ``level`` (kernel 11's or the plain version's) run
    on each, until one chunk holds a window: its C is the window's sum."""
    if chunk < 2 or chunk & (chunk - 1):
        raise ValueError("the reduce's chunk is a power of two")
    bk, carry, depth = buckets, None, 0
    while True:
        N = bk[0].shape[-1]
        r, c = level(bk, carry, chunk, depth * (chunk.bit_length() - 1))
        if N <= chunk:
            return c
        bk, carry, depth = r, c, depth + 1


def weighted_bucket_sums(ops, buckets, chunk: int = REDUCE_CHUNK):
    """sum_j j B_j along the last axis of (L, W, N) buckets: (L, W, 1), by
    chunked running sums (``csrc/msm_bucket.cuh``): kernel 11 on the card,
    a launch a level; the plain version on the CPU."""
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
    """(x, y, z) of shape (L, windows * 2^c): entry w 2^c + d is
    d 2^(c w) base, affine (infinity at d = 0), built with host point
    arithmetic; cached per (curve, base, c, windows, device)."""
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
    table = ops.from_host(points, device)
    _comb_tables[key] = table
    return table


def fixed_base_multiples(curve, digits: torch.Tensor, base, ops=None,
                         window: int = FIXED_BASE_WINDOW):
    """[s_i] base for every lane i of ``digits`` (``scalars_to_digits``),
    ``base`` a host point: lane i sums the table entries of its scalar's
    c-bit windows, one complete mixed addition a window; (x, y, z) of the
    lanes' shape."""
    ops = ops or make_ops(curve)
    n_windows = -(-_scalar_bits(curve) // window)
    table = _comb_table(ops, base, window, n_windows, digits.device)
    ids = window_ids(digits, window, n_windows)
    acc = None
    for w in range(n_windows):
        pt = tuple(t[:, ids[w] + (w << window)] for t in table)
        acc = pt if acc is None else ops.add_mixed(acc, pt)
    return acc
