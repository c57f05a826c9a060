"""Number-theoretic transform over Stark252 limb tensors.

Counterpart of ``lambda_elliptic_curves_tpu/poly/ntt.py``, with the same
conventions (``math/src/fft/polynomial.rs:25,74,87,121``):

* ``fft`` maps natural-order coefficients to natural-order evaluations
  out[i] = P(w^i), w the 2^k-th root derived from the field's pinned
  two-adic generator; ``ifft`` is its exact inverse;
* offset variants scale the coefficients by powers of the offset.

Execution: a transform of up to :data:`MAX_LOCAL` points is one launch of
the local NTT kernel (``csrc/ntt.cu``, which replaces the Pallas kernel of
``poly/ntt_pallas.py``); a longer one is split four-step as N = N1*N2 into
two batched local transforms around one cross-twiddle multiply (the field
kernel) and three transposes.  A CPU tensor runs the plain version of the
local transform, :func:`local_ntt_plain`, under the same split.  All
outputs are canonical Montgomery limbs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.field import PrimeField
from ..ops import limbs
from ..utils.errors import FFTError
from .. import native

#: largest transform the local kernel holds in shared memory (8 limbs x
#: 4 bytes x 2^11 points = 64 KB); longer ones are split four-step
MAX_LOCAL = 1 << 11


# ---------------------------------------------------------------------------
# roots / twiddles
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bitrev_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


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
    """``(8, count)`` Montgomery limbs of offset * base^i, i in 0..count,
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


_mat_cache: dict = {}


def _twiddle_matrix(field: PrimeField, root_int: int, n2: int, n1: int, device):
    """(8, N2, N1) table with [j2, k1] = root^(j2*k1): the cross twiddles of
    the four-step split, built by log2(N1) doubling steps over the column
    of root^j2 (cached per root/size/device)."""
    key = (field, root_int, n2, n1, str(device))
    hit = _mat_cache.get(key)
    if hit is not None:
        return hit
    step = powers(field, root_int, n2, device=device)[:, :, None]  # root^j2
    acc = field.ones((n2, 1), device)
    while acc.shape[-1] < n1:
        acc = torch.cat([acc, field.mul(acc, step)], dim=-1)
        step = field.square(step)
    out = acc[..., :n1].contiguous()
    _mat_cache[key] = out
    return out


# ---------------------------------------------------------------------------
# the local transform: kernel 1 and its plain version
# ---------------------------------------------------------------------------

def local_ntt_plain(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Plain version of the local kernel: natural-order ``(8, rows, n)`` in,
    natural-order spectrum out.  The input is permuted to bit-reversed
    order, then log2(n) radix-2 DIT stages run, stage s (group size
    m = 2^s) multiplying by ``tw[j * n/m]``; ``tw`` holds root^0 ..
    root^(n/2-1)."""
    n = x.shape[-1]
    rows = x.shape[1]
    y = torch.index_select(x, -1, _bitrev_tensor(n, x.device))
    m = 2
    while m <= n:
        half = m // 2
        y = y.reshape(limbs.LIMBS, rows, n // m, 2, half)
        w = tw[:, ::n // m][:, :half].reshape(limbs.LIMBS, 1, 1, half)
        u, v = y[..., 0, :], y[..., 1, :]
        t = limbs.mont_mul_plain(v, w)
        y = torch.stack([limbs.add_plain(u, t), limbs.sub_plain(u, t)], dim=3)
        m *= 2
    return y.reshape(limbs.LIMBS, rows, n)


def _local_ntt_cuda(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if x.dtype != torch.int32 or not x.is_cuda or n > MAX_LOCAL or n < 2:
        raise ValueError("local NTT kernel takes (8, rows, 2..2^11) int32 CUDA tensors")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.shape[1] == 0:
        return out
    native.launch("ntt", "lw_ntt", x.data_ptr(), out.data_ptr(), tw.data_ptr(),
                  x.shape[1], n.bit_length() - 1)
    return out


def _on_rows(x: torch.Tensor, field: PrimeField, root_int: int, transform):
    """``transform(rows, twiddles)`` on the (8, rows, n) view of ``x``."""
    n = x.shape[-1]
    if n == 1:
        return x.clone()
    tw = powers(field, root_int, n // 2, device=x.device)
    return transform(x.reshape(limbs.LIMBS, -1, n), tw).reshape(x.shape)


def local_ntt(x: torch.Tensor, field: PrimeField, root_int: int) -> torch.Tensor:
    """Transform of length n <= MAX_LOCAL along the last axis, any batch:
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    transform = local_ntt_plain if x.device.type == "cpu" else _local_ntt_cuda
    return _on_rows(x, field, root_int, transform)


def _local_plain_any(x: torch.Tensor, field: PrimeField, root_int: int) -> torch.Tensor:
    return _on_rows(x, field, root_int, local_ntt_plain)


# ---------------------------------------------------------------------------
# core transform
# ---------------------------------------------------------------------------

def _four_step(x, field, root_int, max_local, local, mul):
    n = x.shape[-1]
    if n <= max_local:
        return local(x, field, root_int)
    log_n = n.bit_length() - 1
    n1 = 1 << ((log_n + 1) // 2)
    n2 = n // n1
    batch = tuple(x.shape[1:-1])
    xt = x.reshape((limbs.LIMBS,) + batch + (n1, n2)).transpose(-1, -2).contiguous()
    a = _four_step(xt, field, pow(root_int, n2, field.p), max_local, local, mul)
    t = _twiddle_matrix(field, root_int, n2, n1, x.device)
    t = t.reshape((limbs.LIMBS,) + (1,) * len(batch) + (n2, n1))
    bt = mul(a, t).transpose(-1, -2).contiguous()  # (..., k1, j2)
    c = _four_step(bt, field, pow(root_int, n1, field.p), max_local, local, mul)
    return c.transpose(-1, -2).contiguous().reshape((limbs.LIMBS,) + batch + (n,))


def fft_with_root(x: torch.Tensor, field: PrimeField, root_int: int,
                  max_local: int = MAX_LOCAL) -> torch.Tensor:
    """Natural-order transform along the last axis with an explicit
    primitive root (any power-of-two length, any batch dims).

    Above ``max_local`` points it splits four-step, N = N1*N2 with
    N1 = 2^ceil(log2(N)/2):
    X[k2*N1 + k1] = sum_j2 w_N2^(j2 k2) [w^(j2 k1) sum_j1 w_N1^(j1 k1) x[j1*N2 + j2]]
    (legs A[j2, k1] and C[k1, k2]), recursing on both legs."""
    return _four_step(x, field, root_int, max_local, local_ntt, limbs.mont_mul)


def fft_with_root_plain(x: torch.Tensor, field: PrimeField, root_int: int,
                        max_local: int = MAX_LOCAL) -> torch.Tensor:
    """:func:`fft_with_root` with the plain local transform and multiply on
    any device: what the kernel path is held against on the card."""
    return _four_step(x, field, root_int, max_local, _local_plain_any,
                      limbs.mont_mul_plain)


def _check(field: PrimeField, n: int) -> int:
    if n & (n - 1) or n == 0:
        raise FFTError(f"size {n} is not a power of two")
    order = n.bit_length() - 1
    if order > field.two_adicity:
        raise FFTError(
            f"{field.name}: order {order} exceeds two-adicity {field.two_adicity}"
        )
    return order


def fft(coeffs: torch.Tensor, field: PrimeField, max_local: int = MAX_LOCAL):
    """Forward transform: natural-order coefficients -> natural-order
    evaluations P(w^i) over the size-n domain (n = last-axis length)."""
    order = _check(field, coeffs.shape[-1])
    return fft_with_root(coeffs, field, field.params.primitive_root_of_unity(order),
                         max_local)


def ifft(evals: torch.Tensor, field: PrimeField, max_local: int = MAX_LOCAL):
    """Inverse transform: natural-order evaluations -> coefficients."""
    n = evals.shape[-1]
    order = _check(field, n)
    root = field.params.primitive_root_of_unity(order)
    out = fft_with_root(evals, field, pow(root, field.p - 2, field.p), max_local)
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
    return field.mul(coeffs, pows.reshape((limbs.LIMBS,) + (1,) * (coeffs.dim() - 2)
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
