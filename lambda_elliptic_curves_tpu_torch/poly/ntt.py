"""Number-theoretic transform over the port's prime fields' limb tensors.

Counterpart of ``lambda_elliptic_curves_tpu/poly/ntt.py``, with the same
conventions (``math/src/fft/polynomial.rs:25,74,87,121``):

* ``fft`` maps natural-order coefficients to natural-order evaluations
  out[i] = P(w^i), w the 2^k-th root derived from the field's pinned
  two-adic generator; ``ifft`` is its exact inverse;
* offset variants scale the coefficients by powers of the offset.

Execution: a transform of N = 2^L points runs as a Stockham autosort in
``ceil(L / max_pass_log)`` passes of radix 2^s (:func:`pass_plan`).  Pass
q, with Ns the product of the earlier radices, takes for every column
j < N / 2^s the points x[j + t*N/2^s], t < 2^s, multiplies point t by the
twist w_(Ns*2^s)^((j mod Ns)*t), runs a DFT of 2^s points and writes
point k to (j div Ns)*Ns*2^s + (j mod Ns) + k*Ns.  Every pass reads and
writes each point once, natural order in and out; the last pass leaves
the spectrum in natural order.  On a CUDA tensor each pass is one launch
of the pass kernel (``csrc/ntt.cu``, which replaces the Pallas kernel of
``poly/ntt_pallas.py`` for Stark252 and, for BN254 Fr and BLS12-377 Fr,
computes what that kernel computes where the JAX ``fft`` runs the XLA
``_fft_pease``;
``csrc/small_ntt.cu``, which
replaces the JAX package's XLA ``_fft_pease``, for Goldilocks and
BabyBear: :func:`small_pass_plan`'s passes on :func:`small_cols_log`
columns a block, DFT roots from ``Twiddles.dft``), all passes of a
transform from one call of its C entry; on a
CPU tensor it is :func:`ntt_pass_plain`, the same pass in torch ops over
the field's plain arithmetic.  Root powers come from two tables of about
2^(L/2) entries per (root, L) (:func:`twiddle_tables`): w^e =
T_hi[e >> h] * T_lo[e mod 2^h]; over BN254 Fr and BLS12-377 Fr the
kernel reads them from one table of all 2^L powers built from those two
(:func:`power_rows`), and runs :func:`dense_pass_plan`'s passes on
:func:`dense_cols_log` columns a block.  All outputs are canonical
Montgomery limbs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..fields.field import PrimeField
from ..ops import dense, limbs, small
from ..utils.errors import FFTError
from .. import native

#: largest radix (log2) of one pass.  With the kernel's 8 columns per block
#: (``LW_NTT_TILE_COLS_LOG`` in ``csrc/ntt.cu``) a tile of 2^8 points x 8
#: columns is 84 KB of shared memory, two blocks per SM; 2^22 points take
#: three passes [8, 7, 7].  The sweep (``tools/sweep_ntt.py``) found radix
#: 2^8 faster at 2^22 than 2^7 (four passes) at any tile width, and 4
#: columns per block within 1% of 8; 8 were kept for their 32-byte runs
MAX_PASS_LOG = 8

#: the dense fields' passes (``csrc/ntt_dense.cuh``): radix at most 2^7
#: (:func:`dense_pass_plan`: [6, 5, 5] at 2^16, [6, 6, 6] at 2^18, [6, 6, 5,
#: 5] at 2^22), and the columns a block takes set pass by pass
#: (:func:`dense_cols_log`): at most 2^3 (32-byte runs of every limb
#: plane), fewer when the pass would otherwise run on fewer than
#: ``DENSE_BLOCKS_PER_SM`` blocks for each SM of the card.  The sweep
#: (``tools/sweep_ntt.py --dense``) found radix 2^6 passes on this rule
#: best or within its noise at 2^16-2^18 (one row, and the QAP's three) and
#: 5% faster than [8, 7, 7] at 2^22
DENSE_MAX_PASS_LOG = 7
DENSE_MAX_COLS_LOG = 3
DENSE_BLOCKS_PER_SM = 2

#: the small fields' passes (``csrc/small_ntt.cuh``): the kernel takes a
#: radix up to 2^``SMALL_DFT_LOG`` (``LW_SNTT_MAX_S``: its DFT roots'
#: table holds that many), each a DFT of r1 x r2 points in registers; the
#: fft's plan takes at most 2^6 (:func:`small_pass_plan`: [6, 6, 5, 5] at
#: 2^22, [5, 5, 5, 5] at 2^20, [6, 6, 6, 6] at 2^24); the columns a block
#: takes are set pass by pass (:func:`small_cols_log`): at most 2^5
#: (128-byte runs of every BabyBear limb plane), fewer while the pass
#: would otherwise run on fewer than ``SMALL_BLOCKS_PER_SM`` blocks for
#: each SM.  The sweep (``tools/sweep_ntt.py --small``) found radix-2^6
#: plans 13-19% faster than [8, 7, 7] at 2^22 and [8, 8, 8] at 2^24 (a
#: radix-2^8 pass holds 16 points a thread and 100-128 registers), and
#: this rule within its noise of the fastest width at every prover shape
SMALL_DFT_LOG = 8
SMALL_MAX_PASS_LOG = 6
SMALL_MAX_COLS_LOG = 5
SMALL_BLOCKS_PER_SM = 2


# ---------------------------------------------------------------------------
# roots / twiddles
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bitrev_indices(n: int) -> np.ndarray:
    """Bit reversal of 0 .. n-1 (n a power of two), from that of n/2:
    rev_n = [2 rev_(n/2), 2 rev_(n/2) + 1]."""
    if n == 1:
        return np.zeros(1, dtype=np.int64)
    half = 2 * _bitrev_indices(n // 2)
    return np.concatenate([half, half + 1])


_index_cache: dict = {}


def _bitrev_tensor(n: int, device) -> torch.Tensor:
    key = (n, str(device))
    if key not in _index_cache:
        _index_cache[key] = torch.from_numpy(_bitrev_indices(n)).to(device)
    return _index_cache[key]


def bit_reverse_permute(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Bit-reverse gather along ``axis`` (``in_place_bit_reverse_permute``,
    ``math/src/fft/cpu/bit_reversing.rs:2``)."""
    return torch.index_select(x, axis, _bitrev_tensor(x.shape[axis], x.device))


_powers_cache: dict = {}


def powers(field: PrimeField, base_int: int, count: int, offset_int: int = 1, *,
           device, cache: bool = True) -> torch.Tensor:
    """``(L, count)`` Montgomery limbs of offset * base^i, i in 0..count,
    by doubling: log2(count) field multiplies of the known prefix by one
    host constant.  Cached per (base, count, offset, device) unless
    ``cache`` is false (one-off bases such as challenge points)."""
    p = field.p
    key = (field, base_int % p, count, offset_int % p, str(device))
    hit = _powers_cache.get(key)
    if hit is not None:
        return hit
    out = field.constant(offset_int % p, (1,), device)
    while out.shape[-1] < count:
        m = out.shape[-1]
        step = field.constant(pow(base_int, m, p), (1,), device)
        out = torch.cat([out, field.mul(out, step)], dim=-1)
    out = out[:, :max(count, 1)].contiguous()
    if cache:
        _powers_cache[key] = out
    return out


def get_powers_of_primitive_root(field: PrimeField, order: int, count: int,
                                 config: str = "natural", *, device):
    """Powers of the 2^order primitive root in one of the four reference
    configurations (``RootsConfig``, ``math/src/field/traits.rs:10``):
    natural | natural_inversed | bit_reverse | bit_reverse_inversed."""
    root = field.params.primitive_root_of_unity(order)
    if config in ("natural_inversed", "bit_reverse_inversed"):
        root = pow(root, field.p - 2, field.p)
    if not config.startswith("bit_reverse"):
        return powers(field, root, count, device=device)[..., :count]
    n = max(1, 1 << (count - 1).bit_length()) if count > 1 else 1
    return bit_reverse_permute(powers(field, root, n, device=device))


def get_twiddles(field: PrimeField, order: int, config: str = "bit_reverse", *,
                 device):
    """n/2 twiddle factors for a 2^order transform (cf. ``get_twiddles``,
    ``roots_of_unity.rs:66``)."""
    if order > field.two_adicity:
        raise FFTError(
            f"{field.name}: order {order} exceeds two-adicity {field.two_adicity}"
        )
    return get_powers_of_primitive_root(field, order, (1 << order) // 2, config,
                                        device=device)


_table_cache: dict = {}


class Twiddles(NamedTuple):
    """The two root-power tables of one (root, L): ``lo`` ``(8, 2^h)`` holds
    root^a and ``hi`` ``(8, 2^(L - h))`` root^(b * 2^h), h = ceil(L / 2), so
    that root^e = hi[e >> h] * lo[e mod 2^h] for every e < 2^L (one
    product); ``lo_rows`` / ``hi_rows`` are the same tables entry-major,
    one run per entry, as the kernel reads them.  ``ops``: the field's
    arithmetic (:mod:`..ops.limbs`, or an :class:`..ops.small.SmallField`
    whose tables have its limb count in place of 8).  ``powers``: for a
    dense field on the card, every root^e, e < 2^L, entry-major ``(2^L,
    8)`` (:func:`power_rows`), which the dense pass kernel reads; else
    None.  ``dft``: for a small field, the DFT roots root^(e 2^L / R), e <
    R = 2^min(L, ``SMALL_DFT_LOG``), entry-major ``(R, L)``, which the
    small pass kernel reads; else None."""
    lo: torch.Tensor
    hi: torch.Tensor
    lo_rows: torch.Tensor
    hi_rows: torch.Tensor
    ops: object
    powers: torch.Tensor | None = None
    dft: torch.Tensor | None = None


def _dense_ntt(ops) -> bool:
    """Whether ``ops`` is a dense field, whose passes run on kernel 1's
    dense entry (BN254 Fr and BLS12-377 Fr: the others have no roots)."""
    return isinstance(ops, dense.DenseField)


def _small_ntt(ops) -> bool:
    """Whether ``ops`` is a small field, whose passes run on kernel 7."""
    return isinstance(ops, small.SmallField)


def twiddle_tables(field: PrimeField, root_int: int, log_n: int, device) -> Twiddles:
    """:class:`Twiddles` of ``root_int`` for 2^log_n points, built on the
    host with Python ints (over a small field also ``dft``); over a dense
    field on the card also ``powers`` (:func:`power_rows`: one launch of
    kernel 8).  Cached per (root, log_n, device)."""
    key = (field, root_int % field.p, log_n, str(device))
    hit = _table_cache.get(key)
    if hit is not None:
        return hit
    p = field.p
    h = (log_n + 1) // 2

    def run(base: int, count: int) -> np.ndarray:
        vals, acc = [], field.params.r % p  # Montgomery form of base^i: base^i * R
        for _ in range(count):
            vals.append(acc)
            acc = acc * base % p
        return field.ops.ints_to_limbs(vals, "cpu").numpy()

    lo, hi = run(root_int % p, 1 << h), run(pow(root_int, 1 << h, p), 1 << (log_n - h))
    tabs = Twiddles(*(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                      for t in (lo, hi, lo.T, hi.T)), field.ops)
    if _small_ntt(field.ops):
        dft_log = min(log_n, SMALL_DFT_LOG)
        dft = run(pow(root_int, 1 << (log_n - dft_log), p), 1 << dft_log)
        tabs = tabs._replace(dft=torch.from_numpy(np.ascontiguousarray(dft.T)).to(device))
    if _dense_ntt(field.ops) and tabs.lo.device.type != "cpu":
        tabs = tabs._replace(powers=power_rows(tabs))
    _table_cache[key] = tabs
    return tabs


def power_rows(tables: Twiddles) -> torch.Tensor:
    """root^e for every e < 2^L, entry-major ``(2^L, 8)``: one product of
    the two tables' entries each, on the tables' device (one launch of
    kernel 8 on the card, the plain product on the CPU); the table that the
    dense pass kernel reads its twists and DFT roots from."""
    if tables.powers is not None:
        return tables.powers
    lo, hi = tables.lo, tables.hi
    h = lo.shape[1].bit_length() - 1
    e = torch.arange(lo.shape[1] * hi.shape[1], device=lo.device)
    return tables.ops.mont_mul(hi[:, e >> h], lo[:, e & ((1 << h) - 1)]).T.contiguous()


def twiddle_plain(tables: Twiddles, e: torch.Tensor) -> torch.Tensor:
    """root^e for an int64 tensor of exponents e < 2^L: one product of the
    two table entries (the kernel's ``lw_ntt_twiddle``)."""
    h = tables.lo.shape[1].bit_length() - 1
    e = e.to(tables.lo.device)
    return tables.ops.mont_mul_plain(tables.hi[:, e >> h], tables.lo[:, e & ((1 << h) - 1)])


# ---------------------------------------------------------------------------
# one pass: the kernel and its plain version
# ---------------------------------------------------------------------------

def pass_plan(log_n: int, max_pass_log: int = MAX_PASS_LOG) -> list:
    """Radix logs s of the passes of a 2^log_n transform: as few passes as
    ``max_pass_log`` allows, their radices as even as possible, the larger
    first."""
    if max_pass_log < 1:
        raise ValueError("max_pass_log must be at least 1")
    if log_n == 0:
        return []
    count = -(-log_n // max_pass_log)
    base, extra = divmod(log_n, count)
    return [base + 1] * extra + [base] * (count - extra)


def dense_pass_plan(log_n: int, max_pass_log: int = MAX_PASS_LOG) -> list:
    """The passes of a dense field's 2^log_n transform: :func:`pass_plan`
    with the radix at most 2^``DENSE_MAX_PASS_LOG``."""
    return pass_plan(log_n, min(max_pass_log, DENSE_MAX_PASS_LOG))


def small_pass_plan(log_n: int, max_pass_log: int = MAX_PASS_LOG) -> list:
    """The passes of a small field's 2^log_n transform: :func:`pass_plan`
    with the radix at most 2^``SMALL_MAX_PASS_LOG``."""
    return pass_plan(log_n, min(max_pass_log, SMALL_MAX_PASS_LOG))


def small_cols_log(rows: int, log_n: int, s: int, sms: int) -> int:
    """log2 of the columns a block of a small-field pass takes (radix 2^s
    over ``rows`` rows of 2^log_n points) on a card of ``sms``
    multiprocessors: ``SMALL_MAX_COLS_LOG`` (at most 8 - s // 2: 256
    threads a block), less while the pass would have fewer than
    ``SMALL_BLOCKS_PER_SM`` blocks an SM."""
    cols, lc = rows << (log_n - s), min(SMALL_MAX_COLS_LOG, 8 - s // 2)
    while lc > 0 and (cols >> lc) < SMALL_BLOCKS_PER_SM * sms:
        lc -= 1
    return lc


def dense_cols_log(rows: int, log_n: int, s: int, sms: int) -> int:
    """log2 of the columns a block of a dense pass takes (radix 2^s over
    ``rows`` rows of 2^log_n points) on a card of ``sms`` multiprocessors:
    ``DENSE_MAX_COLS_LOG``, less while the pass would have fewer than
    ``DENSE_BLOCKS_PER_SM`` blocks an SM."""
    cols, lc = rows << (log_n - s), DENSE_MAX_COLS_LOG
    while lc > 0 and (cols >> lc) < DENSE_BLOCKS_PER_SM * sms:
        lc -= 1
    return lc


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _twist_split(s: int) -> int:
    """log2 of the low twist table per column: the twist of point t is
    Z_hi[t >> a] * Z_lo[t mod 2^a]."""
    return (s + 1) // 2


def ntt_pass_plain(x: torch.Tensor, tables, ns_log: int, s: int) -> torch.Tensor:
    """One Stockham pass of radix 2^s over ``(L, rows, N)`` canonical limbs,
    after passes whose radices multiply to 2^ns_log, in torch ops on any
    device (the arithmetic of ``tables.ops``).  The same pass as the kernels: the same gather
    (x[j + t*N/2^s]) and scatter; the twists from per-column tables Z_lo /
    Z_hi built from the two-table root powers, and the DFT as bit-reversed
    radix-2 DIT stages (the first multiplies by one and is skipped), where
    the small fields' kernel splits it into two DFTs in registers: field
    values are exact, so the outputs are the same bits."""
    ar = tables.ops
    lim, rows, n = x.shape
    log_n = n.bit_length() - 1
    log_cols = log_n - s
    r, cols = 1 << s, 1 << log_cols
    dev = x.device
    y = x.reshape(lim, rows, r, cols)  # [t, j] holds x[j + t * cols]
    if ns_log:
        a = _twist_split(s)
        i = torch.arange(cols, dtype=torch.int64) & ((1 << ns_log) - 1)
        shift = log_n - ns_log - s  # the twist root is w^(N / (Ns 2^s))
        z_lo = twiddle_plain(tables, (i[:, None] * torch.arange(1 << a)) << shift)
        z_hi = twiddle_plain(tables, (i[:, None] * torch.arange(1 << (s - a))) << (a + shift))
        t = torch.arange(r, device=dev)
        tw = ar.mont_mul_plain(z_hi[:, :, t >> a], z_lo[:, :, t & ((1 << a) - 1)])
        y = ar.mont_mul_plain(y, tw.transpose(1, 2).unsqueeze(1))
    w_r = twiddle_plain(tables, torch.arange(r // 2, dtype=torch.int64) << log_cols)
    y = torch.index_select(y, 2, _bitrev_tensor(r, dev))
    for st in range(1, s + 1):
        half = 1 << (st - 1)
        y = y.reshape(lim, rows, r >> st, 2, half, cols)
        u, v = y[:, :, :, 0], y[:, :, :, 1]
        if st > 1:
            w = w_r[:, ::r >> st][:, :half].reshape(lim, 1, 1, half, 1)
            v = ar.mont_mul_plain(v, w)
        y = torch.stack([ar.add_plain(u, v), ar.sub_plain(u, v)], dim=3)
    # point k of column j = g*Ns + i goes to g*Ns*r + k*Ns + i
    y = y.reshape(lim, rows, r, cols >> ns_log, 1 << ns_log)
    return y.permute(0, 1, 3, 2, 4).reshape(lim, rows, n)


def _check_operands(x: torch.Tensor, out: torch.Tensor, tables: Twiddles, ns_log: int,
                    plan: list) -> None:
    lim = tables.ops.LIMBS
    if (x.dtype != torch.int32 or out.dtype != torch.int32 or not x.is_cuda
            or x.dim() != 3 or x.shape[0] != lim or out.shape != x.shape
            or out.device != x.device or not x.is_contiguous()
            or not out.is_contiguous() or x.data_ptr() == out.data_ptr()):
        raise ValueError(f"NTT pass takes distinct contiguous ({lim}, rows, N) int32 CUDA "
                         "tensors")
    n = x.shape[2]
    if (n & (n - 1) or ns_log < 0 or min(plan) < 1 or ns_log + sum(plan) > n.bit_length() - 1
            or tables.lo.shape[1] * tables.hi.shape[1] != n
            or tables.lo_rows.device != x.device
            or (_dense_ntt(tables.ops) and tables.powers is None)
            or (_small_ntt(tables.ops) and max(plan) > tables.dft.shape[0].bit_length() - 1)):
        raise ValueError(f"NTT pass: bad passes {plan} after 2^{ns_log}, or tables, for N={n}")


def _launch(x: torch.Tensor, out: torch.Tensor, buf, tables: Twiddles, ns_log: int,
            plan: list) -> torch.Tensor:
    """The passes ``plan`` in one call of the C entry, one kernel launch
    each, x into out (through buf when there are two or more): kernel 1
    for Stark252 and (its dense entry, each pass on
    :func:`dense_cols_log` columns a block) BN254 Fr and BLS12-377 Fr,
    kernel 7 for the small fields (each pass on :func:`small_cols_log`
    columns a block)."""
    if x.shape[1] and _dense_ntt(tables.ops):
        log_n, sms = x.shape[2].bit_length() - 1, sm_count(x.device)
        cols_log = [dense_cols_log(x.shape[1], log_n, s, sms) for s in plan]
        native.launch(tables.ops.ntt_counter, "lw_dense_ntt_passes", tables.ops.kernel_id,
                      x.data_ptr(), out.data_ptr(), None if buf is None else buf.data_ptr(),
                      tables.powers.data_ptr(), x.shape[1], log_n, ns_log,
                      (ctypes.c_int * len(plan))(*plan),
                      (ctypes.c_int * len(plan))(*cols_log), len(plan), count=len(plan))
    elif x.shape[1] and tables.ops is not limbs:
        log_n, sms = x.shape[2].bit_length() - 1, sm_count(x.device)
        cols_log = [small_cols_log(x.shape[1], log_n, s, sms) for s in plan]
        native.launch("small_ntt", "lw_small_ntt_passes", tables.ops.kernel_id,
                      x.data_ptr(), out.data_ptr(), None if buf is None else buf.data_ptr(),
                      tables.lo_rows.data_ptr(), tables.hi_rows.data_ptr(),
                      tables.dft.data_ptr(), x.shape[1], log_n, ns_log,
                      tables.dft.shape[0].bit_length() - 1, (ctypes.c_int * len(plan))(*plan),
                      (ctypes.c_int * len(plan))(*cols_log), len(plan), count=len(plan))
    elif x.shape[1]:
        native.launch("ntt", "lw_ntt_passes", x.data_ptr(), out.data_ptr(),
                      None if buf is None else buf.data_ptr(), tables.lo_rows.data_ptr(),
                      tables.hi_rows.data_ptr(), x.shape[1], x.shape[2].bit_length() - 1,
                      ns_log, (ctypes.c_int * len(plan))(*plan), len(plan), count=len(plan))
    return out


def ntt_pass(x: torch.Tensor, out: torch.Tensor, tables: Twiddles, ns_log: int,
             s: int) -> torch.Tensor:
    """One launch of the pass kernel (``csrc/ntt.cu``, or
    ``csrc/small_ntt.cu`` for tables of a small field): the pass of
    :func:`ntt_pass_plain` from ``x`` into ``out``, both ``(L, rows, N)``
    contiguous int32 CUDA tensors."""
    _check_operands(x, out, tables, ns_log, [s])
    return _launch(x, out, None, tables, ns_log, [s])


# ---------------------------------------------------------------------------
# core transform
# ---------------------------------------------------------------------------

def plan_for(field: PrimeField, log_n: int, max_pass_log: int = MAX_PASS_LOG) -> list:
    """The passes that :func:`fft_with_root` runs over ``field`` at
    2^log_n points: :func:`dense_pass_plan` over a dense field,
    :func:`small_pass_plan` over a small one, else :func:`pass_plan`."""
    if _dense_ntt(field.ops):
        return dense_pass_plan(log_n, max_pass_log)
    if _small_ntt(field.ops):
        return small_pass_plan(log_n, max_pass_log)
    return pass_plan(log_n, max_pass_log)


def _transform(x: torch.Tensor, field: PrimeField, root_int: int, max_pass_log: int,
               on_card: bool) -> torch.Tensor:
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    plan = plan_for(field, log_n, max_pass_log)
    if not plan:
        return x.clone()
    tables = twiddle_tables(field, root_int, log_n, x.device)
    cur = x.reshape(field.num_limbs, -1, n)
    if on_card:
        cur = cur.contiguous()
        out = torch.empty_like(cur)
        _check_operands(cur, out, tables, 0, plan)
        buf = torch.empty_like(cur) if len(plan) > 1 else None
        return _launch(cur, out, buf, tables, 0, plan).reshape(x.shape)
    ns_log = 0
    for s in plan:
        cur = ntt_pass_plain(cur, tables, ns_log, s)
        ns_log += s
    return cur.reshape(x.shape)


def fft_with_root(x: torch.Tensor, field: PrimeField, root_int: int,
                  max_pass_log: int = MAX_PASS_LOG) -> torch.Tensor:
    """Natural-order transform along the last axis with an explicit
    primitive root (any power-of-two length, any batch dims): the passes of
    :func:`plan_for`, each
    one kernel launch on a CUDA tensor and :func:`ntt_pass_plain` on a CPU
    tensor."""
    return _transform(x, field, root_int, max_pass_log, x.device.type != "cpu")


def fft_with_root_plain(x: torch.Tensor, field: PrimeField, root_int: int,
                        max_pass_log: int = MAX_PASS_LOG) -> torch.Tensor:
    """:func:`fft_with_root` through :func:`ntt_pass_plain` on any device:
    the CPU path, which the kernel path is held against on the card."""
    return _transform(x, field, root_int, max_pass_log, False)


def _check(field: PrimeField, n: int) -> int:
    if n & (n - 1) or n == 0:
        raise FFTError(f"size {n} is not a power of two")
    order = n.bit_length() - 1
    if order > field.two_adicity:
        raise FFTError(
            f"{field.name}: order {order} exceeds two-adicity {field.two_adicity}"
        )
    return order


def fft(coeffs: torch.Tensor, field: PrimeField, max_pass_log: int = MAX_PASS_LOG):
    """Forward transform: natural-order coefficients -> natural-order
    evaluations P(w^i) over the size-n domain (n = last-axis length)."""
    order = _check(field, coeffs.shape[-1])
    return fft_with_root(coeffs, field, field.params.primitive_root_of_unity(order),
                         max_pass_log)


def ifft(evals: torch.Tensor, field: PrimeField, max_pass_log: int = MAX_PASS_LOG):
    """Inverse transform: natural-order evaluations -> coefficients (the
    1/n scaling is one field launch after the passes)."""
    n = evals.shape[-1]
    order = _check(field, n)
    root = field.params.primitive_root_of_unity(order)
    out = fft_with_root(evals, field, pow(root, field.p - 2, field.p), max_pass_log)
    return field.mul(out, field.constant(pow(n, field.p - 2, field.p),
                                         (1,) * (out.dim() - 1), out.device))


# ---------------------------------------------------------------------------
# polynomial-level API (reference parity)
# ---------------------------------------------------------------------------

def evaluate_fft(field: PrimeField, coeffs, blowup_factor: int = 1,
                 domain_size: int | None = None):
    """Pad to next_power_of_two(max(len, domain_size)) * blowup and evaluate
    (``Polynomial::evaluate_fft``, ``math/src/fft/polynomial.rs:25``)."""
    return fft(_pad_coeffs(coeffs, blowup_factor, domain_size), field)


def evaluate_offset_fft(field: PrimeField, coeffs, blowup_factor: int = 1,
                        domain_size: int | None = None, offset: int = 1):
    """Evaluations over the coset offset*<w> (``fft/polynomial.rs:74``)."""
    scaled = scale_coeffs(field, coeffs, offset)
    return evaluate_fft(field, scaled, blowup_factor, domain_size)


def interpolate_fft(field: PrimeField, evals):
    """Coefficients of the polynomial interpolating (w^i, evals[i])
    (``fft/polynomial.rs:87``)."""
    return ifft(evals, field)


def interpolate_offset_fft(field: PrimeField, evals, offset: int):
    """Inverse of evaluate_offset_fft (``fft/polynomial.rs:121``)."""
    coeffs = ifft(evals, field)
    return scale_coeffs(field, coeffs, pow(int(offset), field.p - 2, field.p))


def scale_coeffs(field: PrimeField, coeffs, factor: int):
    """coeffs[i] *= factor^i (``Polynomial::scale``, ``polynomial/mod.rs:259``)."""
    factor = int(factor) % field.p
    if factor == 1:
        return coeffs
    n = coeffs.shape[-1]
    pows = powers(field, factor, n, device=coeffs.device)
    return field.mul(coeffs, pows.reshape((field.num_limbs,) + (1,) * (coeffs.dim() - 2)
                                          + (n,)))


def _pad_coeffs(coeffs, blowup_factor, domain_size):
    n = coeffs.shape[-1]
    target = max(n, domain_size or 0)
    target = 1 << (target - 1).bit_length() if target > 1 else 1
    target *= blowup_factor
    if target < n:
        raise FFTError("domain smaller than polynomial")
    if target == n:
        return coeffs
    pad = torch.zeros(coeffs.shape[:-1] + (target - n,), dtype=coeffs.dtype,
                      device=coeffs.device)
    return torch.cat([coeffs, pad], dim=-1)
