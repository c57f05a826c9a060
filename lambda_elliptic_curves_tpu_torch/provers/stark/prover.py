"""STARK prover (stark-platinum parity) over limb tensors.

Counterpart of ``lambda_elliptic_curves_tpu/provers/stark/prover.py``.
Protocol parity: the round structure of ``IsStarkProver``
(``provers/stark/src/prover.rs``): round 1 RAP commit (:335), round 2
composition polynomial (:428), round 3 OOD evaluations (:487), round 4
DEEP + FRI + queries (:536), orchestrated like ``prove`` (:871), with the
same challenge/append ordering against ``DefaultTranscript``.

Execution model:
* all bulk math is batched tensor work on the prover's device: trace
  interpolation and LDEs are batched NTTs over all columns at once (the NTT
  kernel), constraint evaluation is one vector expression over the whole
  LDE coset (columns shifted by ``torch.roll``), field arithmetic is the
  field kernel and every Merkle level is one Keccak kernel launch;
* the JAX package's jitted "programs" are plain functions here: PyTorch
  runs eagerly, so there is nothing to compile or cache but static tables;
* quotients (DEEP composition) are formed in evaluation space, then
  converted to coefficients with one inverse NTT;
* the transcript is host state; each round boundary is a device->host
  sync, which is exactly the protocol-mandated sequencing.

Grinding (``grinding_factor > 0``) and extension-field challenges are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import time

import torch

from ...fields.element import FieldElement
from ...merkle import MerkleTree, KeccakBatchBackend
from ...poly import ntt
from ...utils.errors import ProvingError
from .air import DeviceCtx, device_frame
from .domain import Domain
from .extension import ChallengeBundle
from .proof import (
    DeepPolynomialOpening, FriDecommitment, PolynomialOpenings, StarkProof,
)

last_timings: dict = {}  # phase -> seconds, refreshed per prove() call


def _mark(label: str, t0: float, device) -> float:
    """Per-round wall time (parity with the reference's ``instruments``
    feature, ``provers/stark/src/prover.rs:885-897``), recorded in
    :data:`last_timings`.  On a card the phase ends with a synchronise, so
    its time includes the device work it queued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    last_timings[label] = round(now - t0, 6)
    return now


def _powers_host(field, base: FieldElement, count: int):
    out, acc = [], field(1)
    for _ in range(count):
        out.append(acc)
        acc = acc * base
    return out


def _index(values, device) -> torch.Tensor:
    return torch.tensor([int(v) for v in values], dtype=torch.int64, device=device)


class Prover:
    """Holds per-proof state; ``prove`` is the public entry point."""

    # (air class, field, n, blowup, offset, device) -> (zerofier inverses,
    # periodic LDEs): static per-domain tensors.  Keyed on the AIR class
    # OBJECT: generated AIR classes share __name__ across fields.
    _round2_static_cache: dict = {}

    def __init__(self, air_class, device):
        self.air_class = air_class
        self.device = torch.device(device)

    # -- round 1 -----------------------------------------------------------
    @staticmethod
    def _round1(f, backend, cols, blowup, n, offset):
        """Interpolate -> coset LDE -> bit-reverse -> leaf keccak
        (``prover.rs:208`` interpolate_and_commit)."""
        tpolys = ntt.interpolate_fft(f, cols)
        lde = ntt.evaluate_offset_fft(f, tpolys, blowup, n, offset)
        lde_br = ntt.bit_reverse_permute(lde)
        return tpolys, lde, lde_br, backend.hash_leaves(lde_br)

    # -- round 2 -----------------------------------------------------------
    @staticmethod
    def _round2_commit(ext, backend, ce_evals, nparts, offset):
        """Interpolate H over the coset -> break_in_parts -> parts LDE ->
        component-major leaves -> keccak (``prover.rs:428`` round_2)."""
        h_coeffs = ext.interpolate_offset_fft(ce_evals, offset)
        parts = torch.stack([h_coeffs[..., i::nparts] for i in range(nparts)], dim=-2)
        N = ce_evals.shape[-1]
        parts_lde = ext.evaluate_offset_fft(parts, N // parts.shape[-1], None, offset)
        parts_br = ntt.bit_reverse_permute(parts_lde)
        comp_leaves = torch.cat([ext.as_base_columns(parts_br[..., 0::2]),
                                 ext.as_base_columns(parts_br[..., 1::2])], dim=1)
        return parts, parts_lde, comp_leaves, backend.hash_leaves(comp_leaves)

    def _round2_static(self, air, domain, device):
        """Zerofier-inverse evaluations and periodic-column LDEs: functions
        of (AIR structure, domain) only, computed once per shape."""
        key = (type(air), air.field, domain.trace_length, domain.blowup_factor,
               domain.coset_offset, str(device))
        hit = self._round2_static_cache.get(key)
        if hit is not None:
            return hit
        f = air.field
        n = domain.trace_length
        zinv = self._zerofier_inverse_evals(air, domain, device)
        periodic_lde = []
        for values in air.get_periodic_column_values():
            vals = [int(v) for v in values]
            cycled = (vals * (n // len(vals) + 1))[:n]
            pcoeffs = ntt.interpolate_fft(f, f.array(cycled, device))
            periodic_lde.append(ntt.evaluate_offset_fft(
                f, pcoeffs, domain.blowup_factor, n, domain.coset_offset))
        hit = (tuple(zinv), tuple(periodic_lde))
        self._round2_static_cache[key] = hit
        return hit

    def _composition_evaluations(self, air, ext, domain, lde_all,
                                 transition_coeffs, boundary, boundary_coeffs,
                                 rap_challenges):
        """Numerator of H over the LDE coset (ConstraintEvaluator parity,
        ``constraints/evaluator.rs:33``), vectorised over the whole coset."""
        f = air.field
        N = domain.lde_size
        dev = lde_all.device
        zinv, periodic_lde = self._round2_static(air, domain, dev)
        terms = []
        if boundary:
            pts = f.array([pow(domain.trace_primitive_root, bc.step, f.p)
                           for bc in boundary], dev)  # (8, Bd)
            lde_points = domain.lde_points(dev)
            inv = f.batch_inverse(f.sub(lde_points[:, None, :], pts[..., None]))
            bvals = f.array([bc.value.value if hasattr(bc.value, "value")
                             else int(bc.value) for bc in boundary], dev)
            betas_b = f.array([ext.value_of(c) for c in boundary_coeffs], dev)
            for i, bc in enumerate(boundary):
                col = lde_all[:, bc.col + (air.trace_columns if bc.is_aux else 0)]
                num = f.sub(col, bvals[:, i:i + 1])
                terms.append(f.mul(f.mul(num, inv[:, i]), betas_b[:, i:i + 1]))
        frame = device_frame(lde_all, air.transition_offsets,
                             domain.blowup_factor, air.step_size)
        ctx = DeviceCtx(f, N, dev)
        evaluations = air.compute_transition(ctx, frame, periodic_lde,
                                             rap_challenges)
        if transition_coeffs:
            betas_t = f.array([ext.value_of(c) for c in transition_coeffs], dev)
            for t, (ev, zv) in enumerate(zip(evaluations, zinv)):
                terms.append(f.mul(f.mul(ev, zv), betas_t[:, t:t + 1]))
        acc = f.zeros((N,), dev)
        for term in terms:
            acc = f.add(acc, term)
        return acc

    def _zerofier_inverse_evals(self, air, domain, device):
        """Per-constraint inverse zerofier over the LDE coset
        (``transition.rs:108``): the base zerofier is cyclic with period
        blowup*period, so one short cycle is computed on the host (exact
        ints) and tiled; end exemptions multiply back in on the device."""
        f = air.field
        p = f.p
        N = domain.lde_size
        n = domain.trace_length
        blowup = domain.blowup_factor
        g = domain.trace_primitive_root
        w = domain.lde_primitive_root
        offs = domain.coset_offset
        cache = {}
        out = [None] * air.num_transition_constraints
        for c in air.transition_constraints():
            key = c.zerofier_key()
            if key not in cache:
                if c.exemptions_period is not None:
                    period = c.exemptions_period
                    cycle_len = blowup * period
                    off_exp = n * c.periodic_exemptions_offset // period
                    cycle = []
                    for e in range(cycle_len):
                        x = offs * pow(w, e, p) % p
                        numr = (pow(x, n // period, p) - pow(g, off_exp, p)) % p
                        den = (pow(x, n // c.period, p)
                               - pow(g, c.offset * n // c.period, p)) % p
                        cycle.append(numr * pow(den, -1, p) % p)
                else:
                    cycle_len = blowup * c.period
                    cycle = []
                    for e in range(cycle_len):
                        x = offs * pow(w, e, p) % p
                        v = (pow(x, n // c.period, p)
                             - pow(g, c.offset * n // c.period, p)) % p
                        cycle.append(pow(v, -1, p))
                tiled = f.array(cycle, device).repeat(1, N // cycle_len)
                if c.end_exemptions > 0:
                    points = domain.lde_points(device)
                    for r in c.end_exemptions_points(g, n, p):
                        tiled = f.mul(tiled, f.sub(points, f.constant(r, (1,), device)))
                cache[key] = tiled
            out[c.constraint_idx] = cache[key]
        return out

    # -- round 3 -----------------------------------------------------------
    @staticmethod
    def _round3_ood(ext, tpolys_all, parts, trace_points, parts_point):
        """Every out-of-domain evaluation the protocol needs, t_j(z*g^off)
        for all columns and offsets, then H_i(z^nparts), pulled to the host
        in one transfer (``prover.rs:487`` round_3)."""
        outs = [ext.evaluate_coeffs_at(tpolys_all, pt) for pt in trace_points]
        outs.append(ext.evaluate_coeffs_at(parts, parts_point))
        return ext.host_values(torch.cat(outs, dim=-1))

    # -- round 4 -----------------------------------------------------------
    @staticmethod
    def _deep(ext, lde_all, parts_lde, lde_points, num_ood, den_pts, gammas,
              n_terms):
        """DEEP composition over the LDE coset: every quotient term in one
        (8, T, N) batch inversion, summed by a log-depth fold
        (``prover.rs:643`` compute_deep_composition_poly)."""
        fd = ext.fd
        nparts = parts_lde.shape[1]
        cols = [parts_lde[:, i] for i in range(nparts)]
        num_cols = lde_all.shape[1]
        n_offs = (n_terms - nparts) // num_cols
        for j in range(num_cols):
            cols.extend([lde_all[:, j]] * n_offs)
        terms = torch.stack(cols, dim=1)  # (8, T, N)
        inv = fd.batch_inverse(fd.sub(lde_points[:, None, :], den_pts[..., None]))
        num = fd.sub(terms, num_ood[..., None])
        quot = fd.mul(fd.mul(num, inv), gammas[..., None])
        while quot.shape[1] > 1:
            half = quot.shape[1] // 2
            quot = torch.cat([fd.add(quot[:, :half], quot[:, half:2 * half]),
                              quot[:, 2 * half:]], dim=1)
        return quot[:, 0]

    # ------------------------------------------------------------------
    def prove(self, trace, pub_inputs, proof_options, transcript) -> StarkProof:
        last_timings.clear()
        if proof_options.grinding_factor > 0:
            raise NotImplementedError(
                "grinding is not ported yet (ROADMAP queue 1: provers/stark/grinding.py)")
        dev = self.device
        trace = trace.to(dev)
        air = self.air_class(trace.num_rows, pub_inputs, proof_options)
        f = air.field
        ext = ChallengeBundle(f, air.extension_degree)
        domain = Domain(air)
        backend = KeccakBatchBackend(f)
        blowup = domain.blowup_factor
        n = domain.trace_length
        N = domain.lde_size

        # =========================== Round 1 ===========================
        _t = time.perf_counter()
        tpolys, lde, lde_br, leaf_words = self._round1(
            f, backend, trace.columns, blowup, n, domain.coset_offset)
        main_tree = MerkleTree.from_leaf_digests(backend, leaf_words)
        transcript.append_bytes(main_tree.root)
        _t = _mark('round1 commit', _t, dev)

        rap_challenges = []
        aux_lde = aux_tree = None
        lde_all, tpolys_all = lde, tpolys
        if air.has_trace_interaction:
            rap_challenges = air.build_rap_challenges(transcript)
            aux = air.build_auxiliary_trace(trace, rap_challenges).to(dev)
            aux_polys = ntt.interpolate_fft(f, aux)
            aux_lde = ntt.evaluate_offset_fft(f, aux_polys, blowup, n,
                                              domain.coset_offset)
            aux_tree = MerkleTree.build(backend, ntt.bit_reverse_permute(aux_lde))
            transcript.append_bytes(aux_tree.root)
            lde_all = torch.cat([lde, aux_lde], dim=1)
            tpolys_all = torch.cat([tpolys, aux_polys], dim=1)

        # ======================= challenges: beta ======================
        beta = ext.sample(transcript)
        n_transition = air.num_transition_constraints
        boundary = air.boundary_constraints(rap_challenges)
        coeffs = _powers_host(ext.host, beta, n_transition + len(boundary))
        transition_coeffs = coeffs[:n_transition]
        boundary_coeffs = coeffs[n_transition:]

        # =========================== Round 2 ===========================
        ce_evals = self._composition_evaluations(
            air, ext, domain, lde_all, transition_coeffs, boundary,
            boundary_coeffs, rap_challenges,
        )  # (8, N)
        _t = _mark('round2 constraint eval', _t, dev)
        nparts = air.composition_poly_degree_bound() // n
        parts, parts_lde, comp_leaves, comp_leaf_words = self._round2_commit(
            ext, backend, ce_evals, nparts, domain.coset_offset)
        comp_tree = MerkleTree.from_leaf_digests(backend, comp_leaf_words)
        transcript.append_bytes(comp_tree.root)
        _t = _mark('round2 commit', _t, dev)

        # =========================== Round 3 ===========================
        z = ext.sample_z_ood(transcript, domain.coset_offset, N,
                             domain.root_order)
        z_power = z**nparts
        g = ext.host(domain.trace_primitive_root)
        offsets = air.transition_offsets
        num_cols = lde_all.shape[1]
        vals = self._round3_ood(ext, tpolys_all, parts,
                                [z * g**off for off in offsets], z_power)
        trace_ood = [vals[k * num_cols:(k + 1) * num_cols]
                     for k in range(len(offsets))]
        parts_ood = vals[len(offsets) * num_cols:]
        if len(parts_ood) != nparts:
            raise ProvingError(
                f"{len(parts_ood)} composition-part OOD values for {nparts} parts")
        # transcript order matches the reference: column-major
        for j in range(num_cols):
            for k in range(len(offsets)):
                ext.append(transcript, ext.host(trace_ood[k][j]))
        for v in parts_ood:
            ext.append(transcript, ext.host(v))
        _t = _mark('round3 ood', _t, dev)

        # =========================== Round 4 ===========================
        gamma = ext.sample(transcript)
        n_trace_terms = len(offsets) * air.step_size * num_cols
        all_gammas = _powers_host(ext.host, gamma, n_trace_terms + nparts)
        trace_gammas = all_gammas[:n_trace_terms]
        comp_gammas = all_gammas[n_trace_terms:]

        n_offs = len(offsets)
        n_terms = nparts + num_cols * n_offs
        num_ood_vals = list(parts_ood) + [
            trace_ood[k][j] for j in range(num_cols) for k in range(n_offs)]
        den_vals = [ext.value_of(z_power)] * nparts + [
            ext.value_of(z * g**offsets[k])
            for _j in range(num_cols) for k in range(n_offs)]
        gamma_vals = ([ext.value_of(v) for v in comp_gammas]
                      + [ext.value_of(v) for v in trace_gammas])
        fd = ext.fd
        deep_evals = self._deep(
            ext, lde_all, parts_lde, domain.lde_points(dev),
            fd.array(num_ood_vals, dev), fd.array(den_vals, dev),
            fd.array(gamma_vals, dev), n_terms)
        # p0 has degree < n: drop the provably-zero high coefficients so FRI
        # folds operate on the true degree bound
        p0 = ext.interpolate_offset_fft(deep_evals, domain.coset_offset)[..., :n]
        _t = _mark('round4 deep', _t, dev)

        fri_roots, fri_layers, last_value = self._fri_commit(
            ext, domain, p0, transcript, backend)
        _t = _mark('round4 fri commit', _t, dev)

        iotas = [transcript.sample_u64(N >> 1)
                 for _ in range(proof_options.fri_number_of_queries)]
        query_list = self._fri_query(ext, fri_layers, iotas)
        _t = _mark('round4 fri query', _t, dev)
        deep_openings = self._open_deep(
            f, main_tree, aux_tree, comp_tree, lde_br,
            ntt.bit_reverse_permute(aux_lde) if aux_lde is not None else None,
            comp_leaves, iotas, nparts)
        _t = _mark('round4 open deep', _t, dev)
        return StarkProof(
            trace_length=n,
            lde_trace_main_merkle_root=main_tree.root,
            lde_trace_aux_merkle_root=aux_tree.root if aux_tree else None,
            trace_ood_evaluations=trace_ood,
            composition_poly_root=comp_tree.root,
            composition_poly_parts_ood_evaluation=parts_ood,
            fri_layers_merkle_roots=fri_roots,
            fri_last_value=last_value,
            query_list=query_list,
            deep_poly_openings=deep_openings,
            nonce=None,
        )

    # ------------------------------------------------------------------
    def _fri_commit(self, ext, domain, p0, transcript, backend):
        """FRI commit phase (``fri/mod.rs:22``): fold p' = 2*(even + z*odd),
        evaluate each layer over the squared-offset coset, commit pairs of
        bit-reversed evaluations."""
        f = ext.f
        poly = p0
        offset = domain.coset_offset
        size = domain.lde_size
        layers = []  # (evals_br (8, size), tree)
        roots = []
        for _ in range(1, domain.root_order):
            zeta = ext.sample(transcript)
            offset = offset * offset % f.p
            size //= 2
            poly, evals_br, leaf_words = self._fri_layer_step(
                ext, backend, poly, zeta, size, offset)
            tree = MerkleTree.from_leaf_digests(backend, leaf_words)
            layers.append((evals_br, tree))
            roots.append(tree.root)
            transcript.append_bytes(tree.root)
        zeta = ext.sample(transcript)
        poly = self._fold(ext, poly, zeta)
        last_value = ext.host_value(poly[..., 0])
        ext.append(transcript, ext.host(last_value))
        return roots, layers, last_value

    def _fri_layer_step(self, ext, backend, poly, zeta, size: int, offset: int):
        """One layer: fold, coset NTT, bit-reverse, pairing, leaf keccak."""
        folded = self._fold(ext, poly, zeta)
        evals = ext.evaluate_offset_fft(folded, 1, size, offset)
        evals_br = ntt.bit_reverse_permute(evals)
        pairs = torch.cat([ext.as_base_columns(evals_br[:, None, 0::2]),
                           ext.as_base_columns(evals_br[:, None, 1::2])],
                          dim=1)  # (8, 2, size/2)
        return folded, evals_br, backend.hash_leaves(pairs)

    @staticmethod
    def _fold(ext, poly, zeta):
        """p' = 2 * (p_even + zeta * p_odd)  (``fri_functions.rs:7`` with the
        factor 2 from ``fri/mod.rs:51``)."""
        fd = ext.fd
        zc = fd.constant(ext.value_of(zeta), (1,), poly.device)
        two = fd.constant(2, (1,), poly.device)
        return fd.mul(two, fd.add(poly[..., 0::2], fd.mul(zc, poly[..., 1::2])))

    def _fri_query(self, ext, layers, iotas):
        """FRI decommitments (``fri/mod.rs:77``): one gather and one host
        transfer per layer for all queries."""
        indexes = list(iotas)
        layer_vals, layer_paths = [], []
        for evals_br, tree in layers:
            sym = _index([i ^ 1 for i in indexes], evals_br.device)
            layer_vals.append(ext.host_values(torch.index_select(evals_br, -1, sym)))
            layer_paths.append(tree.gather_proofs([i >> 1 for i in indexes]))
            indexes = [i >> 1 for i in indexes]
        return [
            FriDecommitment(
                layers_auth_paths=[paths[q] for paths in layer_paths],
                layers_evaluations_sym=[vals[q] for vals in layer_vals],
            )
            for q in range(len(iotas))
        ]

    # ------------------------------------------------------------------
    @staticmethod
    def _open_deep(f, main_tree, aux_tree, comp_tree, lde_br, aux_lde_br,
                   comp_leaves, iotas, nparts):
        """Open trace rows and composition leaves at each iota pair
        (``prover.rs:752-860``), one gather per tensor."""
        dev = lde_br.device
        pair_positions = [2 * i + b for i in iotas for b in (0, 1)]
        pair_idx = _index(pair_positions, dev)

        def rows(arr, idx):  # (8, C, Q) -> [Q][C] ints
            vals = f.to_ints(torch.index_select(arr, -1, idx))
            return [[int(v) for v in vals[:, q]] for q in range(vals.shape[-1])]

        main_vals = rows(lde_br, pair_idx)
        aux_vals = rows(aux_lde_br, pair_idx) if aux_lde_br is not None else None
        comp_vals = rows(comp_leaves, _index(iotas, dev))

        main_proofs = main_tree.gather_proofs(pair_positions)
        aux_proofs = (aux_tree.gather_proofs(pair_positions)
                      if aux_tree is not None else None)
        comp_proofs = comp_tree.gather_proofs(list(iotas))

        openings = []
        for q in range(len(iotas)):
            main_open = PolynomialOpenings(
                proof=main_proofs[2 * q],
                proof_sym=main_proofs[2 * q + 1],
                evaluations=main_vals[2 * q],
                evaluations_sym=main_vals[2 * q + 1],
            )
            aux_open = None
            if aux_tree is not None:
                aux_open = PolynomialOpenings(
                    proof=aux_proofs[2 * q],
                    proof_sym=aux_proofs[2 * q + 1],
                    evaluations=aux_vals[2 * q],
                    evaluations_sym=aux_vals[2 * q + 1],
                )
            comp_open = PolynomialOpenings(
                proof=comp_proofs[q],
                proof_sym=comp_proofs[q],
                evaluations=comp_vals[q][:nparts],
                evaluations_sym=comp_vals[q][nparts:],
            )
            openings.append(DeepPolynomialOpening(
                composition_poly=comp_open,
                main_trace_polys=main_open,
                aux_trace_polys=aux_open,
            ))
        return openings


def prove(air_class, trace, pub_inputs, proof_options, transcript, *, device="cuda"):
    """``IsStarkProver::prove`` parity: prove on ``device`` (the trace is
    moved there), the card unless the caller asks for ``"cpu"``."""
    return Prover(air_class, device).prove(trace, pub_inputs, proof_options,
                                           transcript)
