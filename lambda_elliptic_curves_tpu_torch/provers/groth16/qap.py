"""Quadratic arithmetic programs, with the matrices stored sparse.

Counterpart of ``lambda_elliptic_curves_tpu/provers/groth16/qap.py``
(parity ``provers/groth16/src/qap.rs``).  The JAX package pads the R1CS
rows densely, ``[gate][var]``, and its setup interpolates every variable's
column (``variable_polynomials``, a (vars, gates) array: 2^32 entries for
2^16 constraints and 2^16 variables).  Here each of A, B, C is the list of
its nonzero entries (gate, var, coef), and both uses run on the device:

* ``calculate_h_coefficients``: the three products A w, B w, C w (gather
  w at the entries' variables, one field product, then a segmented sum by
  gate), then the JAX package's transforms (``qap.py:82-96``) on the NTT
  kernel: interpolate at n, evaluate on the coset 7 <w_2n> at 2n, divide
  (L R - O) by t(x) = x^n - 1 there (one batch inversion), interpolate
  back;
* ``evaluate_at``: the variables' polynomials at tau without building
  them: L_i(tau) = sum_g A[g][i] l_g(tau), with the Lagrange basis of the
  gate domain l_g(tau) = w^g (tau^n - 1) / (n (tau - w^g)) from one batch
  inversion, then a segmented sum by variable.  These are the integers
  that interpolating and then evaluating give (``setup.py:51-54``).

A segmented sum sorts its entries once (on the host, when the QAP is
built) and runs log2(entries) levels of field additions over them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...poly import ntt
from .r1cs import R1CS

H_OFFSET = 7  # ORDER_R_MINUS_1_ROOT_UNITY in the reference


def segment_sum(field, values: torch.Tensor, seg: torch.Tensor, n_out: int) -> torch.Tensor:
    """``(L, n_out)``: out[:, k] = the field sum of the columns of ``values``
    (``(L, nnz)``) whose ``seg`` is k, ``seg`` sorted; a Hillis-Steele
    segmented scan of field additions, then each segment's last column."""
    L, nnz = values.shape
    dev = values.device
    out = field.zeros((n_out,), dev)
    if nnz == 0:
        return out
    change = seg[1:] != seg[:-1]
    flags = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), change])
    x, shift = values, 1
    while shift < nnz:
        prev = torch.cat([torch.zeros((L, shift), dtype=x.dtype, device=dev), x[:, :-shift]], 1)
        x = field.select(flags, x, field.add(x, prev))
        flags = flags | torch.cat([torch.ones(shift, dtype=torch.bool, device=dev),
                                   flags[:-shift]])
        shift *= 2
    last = torch.cat([change, torch.ones(1, dtype=torch.bool, device=dev)])
    out[:, seg[last]] = x[:, last]
    return out


@dataclasses.dataclass
class SparseMatrix:
    """The nonzero entries of one of A, B, C over Fr, sorted by gate."""

    gates: np.ndarray  # int64
    vars: np.ndarray   # int64
    coefs: list        # ints in [1, p)

    @classmethod
    def from_rows(cls, rows, p: int) -> "SparseMatrix":
        entries = [(g, v, c % p) for g, row in enumerate(rows) for v, c in row if c % p]
        g, v, c = zip(*entries) if entries else ((), (), ())
        return cls(np.asarray(g, dtype=np.int64), np.asarray(v, dtype=np.int64), list(c))


class QuadraticArithmeticProgram:
    """The QAP of an R1CS over the scalar field ``field`` (gates padded to
    a power of two), with A, B, C as :class:`SparseMatrix`."""

    def __init__(self, field, num_of_public_inputs: int, num_of_gates: int,
                 witness_size: int, a: SparseMatrix, b: SparseMatrix, c: SparseMatrix):
        self.field = field
        self.num_of_public_inputs = num_of_public_inputs
        self.num_of_gates = num_of_gates
        self.witness_size = witness_size
        self.a, self.b, self.c = a, b, c
        self._dev: dict = {}

    @classmethod
    def from_r1cs(cls, field, r1cs: R1CS):
        n = r1cs.number_of_constraints
        padded = 1 << (n - 1).bit_length() if n > 1 else 1
        mats = (SparseMatrix.from_rows(m, field.p) for m in (r1cs.a, r1cs.b, r1cs.c))
        return cls(field, r1cs.number_of_inputs, padded, r1cs.witness_size, *mats)

    @property
    def num_of_private_inputs(self):
        return self.witness_size - self.num_of_public_inputs

    # ------------------------------------------------------------------
    def _on(self, device):
        """Per matrix, on ``device``: (gate ids, var ids, coefficients in
        Montgomery form, the entries' order by variable, var ids in that
        order); built once per device."""
        key = str(device)
        if key not in self._dev:
            mats = []
            for m in (self.a, self.b, self.c):
                by_var = np.argsort(m.vars, kind="stable")
                t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
                mats.append((t(m.gates), t(m.vars), self.field.array(m.coefs, device),
                             t(by_var), t(m.vars[by_var])))
            self._dev[key] = mats
        return self._dev[key]

    def matvecs(self, w: torch.Tensor) -> torch.Tensor:
        """``(L, 3, n)``: A w, B w and C w over the gate domain, for the
        witness ``w`` as ``(L, vars)`` Montgomery limbs."""
        f = self.field
        rows = [segment_sum(f, f.mul(coef, w[:, var]), gate, self.num_of_gates)
                for gate, var, coef, _, _ in self._on(w.device)]
        return torch.stack(rows, dim=1)

    def lagrange_basis_at(self, tau: int, device) -> torch.Tensor:
        """``(L, n)``: l_g(tau) for every gate g of the domain <w>."""
        f, n = self.field, self.num_of_gates
        p = f.p
        omega = f.params.primitive_root_of_unity(n.bit_length() - 1)
        z_tau = (pow(tau, n, p) - 1) % p
        if z_tau == 0:  # tau is a point of the domain
            return f.array([int(pow(omega, g, p) == tau % p) for g in range(n)], device)
        w_g = ntt.powers(f, omega, n, device=device)
        inv = f.batch_inverse(f.sub(f.constant(tau, (1,), device), w_g))
        scale = f.constant(z_tau * pow(n, -1, p) % p, (1,), device)
        return f.mul(f.mul(w_g, inv), scale)

    def evaluate_at(self, tau: int, device) -> list:
        """[L_i(tau)], [R_i(tau)], [O_i(tau)] for every variable i, as host
        ints (the JAX package's ``_eval_all`` of ``variable_polynomials``)."""
        f = self.field
        ell = self.lagrange_basis_at(tau, device)
        out = []
        for gate, _, coef, by_var, var_sorted in self._on(device):
            vals = f.mul(coef[:, by_var], ell[:, gate[by_var]])
            col = segment_sum(f, vals, var_sorted, self.witness_size)
            out.append([int(v) for v in f.to_ints(col)])
        return out

    def calculate_h_coefficients(self, witness, *, device="cuda") -> list:
        """h(x) = (L R - O) / Z_H (``qap.rs:15``): its 2n coefficients as
        host ints, the JAX package's form, computed on ``device``."""
        f = self.field
        p = f.p
        n = self.num_of_gates
        degree = 2 * n
        w = f.array([int(x) % p for x in witness], device)
        coeffs = ntt.interpolate_fft(f, self.matvecs(w))
        lrc = ntt.evaluate_offset_fft(f, coeffs, 1, degree, H_OFFSET)
        l_e, r_e, o_e = lrc[:, 0], lrc[:, 1], lrc[:, 2]
        # t(x) = x^n - 1 on the offset domain, inverted
        t_vals = ntt.powers(f, pow(f.params.primitive_root_of_unity(degree.bit_length() - 1),
                                   n, p), degree, device=device)
        # t and h as programs of field ops: on the card one launch of kernel
        # 8's program entry each, and 1 / t one launch of kernel 9
        ch = f.ops.chain()
        t_vals = ch.run(ch.sub(ch.mul(ch.input(t_vals), ch.input(
            f.constant(pow(H_OFFSET, n, p), (1,), device))), ch.input(f.ones((1,), device))))
        t_inv = f.batch_inverse(t_vals)
        ch = f.ops.chain()
        h_evals = ch.run(ch.mul(ch.sub(ch.mul(ch.input(l_e), ch.input(r_e)), ch.input(o_e)),
                                ch.input(t_inv)))
        return [int(v) for v in f.to_ints(ntt.interpolate_offset_fft(f, h_evals, H_OFFSET))]
