"""STARK verifier (parity: ``IsStarkVerifier``,
``provers/stark/src/verifier.rs:62``): replay challenges (:75), check the
composition polynomial claim at z (:215), verify FRI folds (:318) and the
DEEP openings at the query points (:477).

Counterpart of ``lambda_elliptic_curves_tpu/provers/stark/verifier.py``.
The verifier is exact host math over Python ints — it touches O(queries *
log n) values, never bulk data, so no tensor is involved; Merkle paths are
checked with the host Keccak.  Grinding is not ported yet: options with
``grinding_factor > 0`` raise ``NotImplementedError``.
"""

from __future__ import annotations

from ...merkle import KeccakBatchBackend
from .air import HostCtx, host_frame
from .domain import Domain
from .extension import ChallengeBundle
from .proof import StarkProof


class Verifier:
    def __init__(self, air_class):
        self.air_class = air_class

    def verify(self, proof: StarkProof, pub_inputs, proof_options,
               transcript) -> bool:
        if proof_options.grinding_factor > 0:
            raise NotImplementedError(
                "grinding is not ported yet (ROADMAP queue 1: provers/stark/grinding.py)")
        air = self.air_class(proof.trace_length, pub_inputs, proof_options)
        ext = ChallengeBundle(air.field, air.extension_degree)
        domain = Domain(air)
        challenges = self._step_1_replay_rounds(air, ext, domain, proof,
                                                transcript)
        if challenges is None:
            return False
        if not self._step_2_composition_claim(air, ext, domain, proof,
                                              challenges):
            return False
        if not self._step_3_and_4_fri_and_deep(air, ext, domain, proof,
                                               challenges):
            return False
        return True

    # ------------------------------------------------------------------
    def _step_1_replay_rounds(self, air, ext, domain, proof, transcript):
        E = ext.host
        N = domain.lde_size
        transcript.append_bytes(proof.lde_trace_main_merkle_root)
        rap_challenges = []
        if air.has_trace_interaction:
            rap_challenges = air.build_rap_challenges(transcript)
            if proof.lde_trace_aux_merkle_root is None:
                return None
            transcript.append_bytes(proof.lde_trace_aux_merkle_root)

        beta = ext.sample(transcript)
        boundary = air.boundary_constraints(rap_challenges)
        n_transition = air.num_transition_constraints
        coeffs, acc = [], E(1)
        for _ in range(n_transition + len(boundary)):
            coeffs.append(acc)
            acc = acc * beta
        transition_coeffs = coeffs[:n_transition]
        boundary_coeffs = coeffs[n_transition:]

        transcript.append_bytes(proof.composition_poly_root)
        z = ext.sample_z_ood(transcript, domain.coset_offset, N,
                             domain.root_order)

        num_cols = len(proof.trace_ood_evaluations[0])
        for j in range(num_cols):
            for k in range(len(air.transition_offsets)):
                ext.append(transcript,
                           E(proof.trace_ood_evaluations[k][j]))
        for v in proof.composition_poly_parts_ood_evaluation:
            ext.append(transcript, E(v))

        gamma = ext.sample(transcript)
        nparts = len(proof.composition_poly_parts_ood_evaluation)
        n_trace_terms = len(air.transition_offsets) * air.step_size * num_cols
        gammas, acc = [], E(1)
        for _ in range(n_trace_terms + nparts):
            gammas.append(acc)
            acc = acc * gamma
        trace_gammas = gammas[:n_trace_terms]
        comp_gammas = gammas[n_trace_terms:]

        # FRI challenge replay
        zetas = []
        for root in proof.fri_layers_merkle_roots:
            zetas.append(ext.sample(transcript))
            transcript.append_bytes(root)
        zetas.append(ext.sample(transcript))
        ext.append(transcript, E(proof.fri_last_value))

        iotas = [transcript.sample_u64(N >> 1)
                 for _ in range(air.options.fri_number_of_queries)]

        return {
            "rap_challenges": rap_challenges,
            "boundary": boundary,
            "transition_coeffs": transition_coeffs,
            "boundary_coeffs": boundary_coeffs,
            "z": z,
            "trace_gammas": trace_gammas,
            "comp_gammas": comp_gammas,
            "zetas": zetas,
            "iotas": iotas,
        }

    # ------------------------------------------------------------------
    def _step_2_composition_claim(self, air, ext, domain, proof, ch) -> bool:
        """H(z) from the parts' OOD values must equal the boundary +
        transition combination evaluated on the OOD frame
        (``verifier.rs:215``) — all host math in the challenge field E."""
        E = ext.host
        z = ch["z"]
        g = E(domain.trace_primitive_root)
        n = domain.trace_length
        nparts = len(proof.composition_poly_parts_ood_evaluation)

        # left side: sum_i H_i(z^nparts) * z^i
        z_pow = E(1)
        lhs = E(0)
        for v in proof.composition_poly_parts_ood_evaluation:
            lhs = lhs + E(v) * z_pow
            z_pow = z_pow * z

        # right side
        rhs = E(0)
        frame0 = proof.trace_ood_evaluations[0]
        for bc, beta_c in zip(ch["boundary"], ch["boundary_coeffs"]):
            col = bc.col + (air.trace_columns if bc.is_aux else 0)
            t_z = E(frame0[col])
            value = E(bc.value.value if hasattr(bc.value, "value")
                      else int(bc.value))
            rhs = rhs + beta_c * (t_z - value) / (z - g**bc.step)

        # periodic columns at z: P(z) via the cycled interpolation
        periodic_at_z = []
        for values in air.get_periodic_column_values():
            vals = [int(v) for v in values]
            cycled = (vals * (n // len(vals) + 1))[:n]
            periodic_at_z.append(self._interpolate_eval_host(E, cycled, z,
                                                             domain))
        ctx = HostCtx(E)
        frame = host_frame([[E(v) for v in row]
                            for row in proof.trace_ood_evaluations])
        evaluations = air.compute_transition(ctx, frame, periodic_at_z,
                                             ch["rap_challenges"])
        for c in air.transition_constraints():
            zinv = c.evaluate_zerofier_host(z, g, n)
            rhs = rhs + ch["transition_coeffs"][c.constraint_idx] \
                * evaluations[c.constraint_idx] * zinv
        return lhs == rhs

    @staticmethod
    def _interpolate_eval_host(f, values, z, domain):
        """Evaluate at z the low-degree interpolation of ``values`` over the
        trace domain, via the barycentric identity
        P(z) = (z^n - 1)/n * sum_i v_i * g^i / (z - g^i)."""
        n = len(values)
        g = domain.trace_primitive_root
        zn = z**n - f(1)
        total = f(0)
        for i, v in enumerate(values):
            gi = f(pow(g, i, f.p))
            total = total + f(v) * gi / (z - gi)
        return zn * total / f(n)

    # ------------------------------------------------------------------
    def _step_3_and_4_fri_and_deep(self, air, ext, domain, proof, ch) -> bool:
        f = air.field
        E = ext.host
        backend = KeccakBatchBackend(f)
        N = domain.lde_size
        w_int = domain.lde_primitive_root
        offs_int = domain.coset_offset
        z = ch["z"]
        g = E(domain.trace_primitive_root)
        nparts = len(proof.composition_poly_parts_ood_evaluation)
        z_power = z**nparts
        num_main = air.trace_columns

        rev = _bitrev_fn(N)

        # soundness: the proof must answer EVERY sampled query — a stripped
        # query_list/deep_poly_openings must reject, not silently pass an
        # empty loop (reference checks arity via iota zip in
        # verifier.rs:318,477 over exactly n_queries entries)
        if len(proof.query_list) != len(ch["iotas"]) or \
                len(proof.deep_poly_openings) != len(ch["iotas"]):
            return False

        for iota, decommit, opening in zip(ch["iotas"], proof.query_list,
                                           proof.deep_poly_openings):
            idx, idx_sym = 2 * iota, 2 * iota + 1
            # ---- verify merkle openings (step 3 part, verifier.rs:477) ----
            main = opening.main_trace_polys
            row = main.evaluations[:num_main]
            row_sym = main.evaluations_sym[:num_main]
            if air.has_trace_interaction and opening.aux_trace_polys:
                aux = opening.aux_trace_polys
                if not aux.proof.verify(backend,
                                        proof.lde_trace_aux_merkle_root,
                                        idx, aux.evaluations):
                    return False
                if not aux.proof_sym.verify(backend,
                                            proof.lde_trace_aux_merkle_root,
                                            idx_sym, aux.evaluations_sym):
                    return False
                row = row + aux.evaluations
                row_sym = row_sym + aux.evaluations_sym
            if not main.proof.verify(backend, proof.lde_trace_main_merkle_root,
                                     idx, main.evaluations):
                return False
            if not main.proof_sym.verify(backend,
                                         proof.lde_trace_main_merkle_root,
                                         idx_sym, main.evaluations_sym):
                return False
            comp = opening.composition_poly
            comp_leaf = comp.evaluations + comp.evaluations_sym
            if not comp.proof.verify(backend, proof.composition_poly_root,
                                     iota, comp_leaf):
                return False
            # leaf base ints -> E part values (component-major layout)
            comp_vals = ext.unflatten_leaf(comp.evaluations, nparts)
            comp_vals_sym = ext.unflatten_leaf(comp.evaluations_sym, nparts)

            # ---- step 4: reconstruct DEEP values at x0 and -x0 ----
            x0 = E(offs_int * pow(w_int, rev(idx), f.p) % f.p)
            v0 = self._deep_value(E, air, proof, ch, row, comp_vals,
                                  x0, z, z_power, g)
            v0_sym = self._deep_value(E, air, proof, ch, row_sym,
                                      comp_vals_sym, -x0, z, z_power, g)

            # ---- step 3: walk the FRI layers ----
            # Index algebra: bit-reversed layouts make the fold of the pair
            # at positions (2i, 2i+1) of layer k land exactly at position i
            # of layer k+1, with evaluation point squared — so the walk is
            # index -> index >> 1 with x -> x^2, no sign bookkeeping.
            def fold(a, b, x, zeta):
                # p'(x^2) = (p(x) + p(-x)) + zeta * (p(x) - p(-x)) / x
                return (a + b) + zeta * (a - b) / x

            cur = fold(v0, v0_sym, x0, ch["zetas"][0])
            x = x0 * x0  # point of `cur` in the first committed layer
            index = iota
            for li, root in enumerate(proof.fri_layers_merkle_roots):
                ev_sym = E(decommit.layers_evaluations_sym[li])
                even, odd = (cur, ev_sym) if index % 2 == 0 else (ev_sym, cur)
                pair = ext.flat(even) + ext.flat(odd)
                if not decommit.layers_auth_paths[li].verify(
                    backend, root, index >> 1, pair
                ):
                    return False
                cur = fold(cur, ev_sym, x, ch["zetas"][li + 1])
                x = x * x
                index >>= 1
            if cur != E(proof.fri_last_value):
                return False
        return True

    @staticmethod
    def _deep_value(E, air, proof, ch, trace_row, comp_values, x, z, z_power,
                    g):
        """p0(x) from opened values (``verifier.rs:533`` reconstruction).
        ``trace_row`` holds base ints; ``comp_values`` holds E elements."""
        acc = E(0)
        offsets = air.transition_offsets
        gi = 0
        for j, t_x in enumerate(trace_row):
            for k, off in enumerate(offsets):
                ood = E(proof.trace_ood_evaluations[k][j])
                acc = acc + ch["trace_gammas"][gi] * (E(t_x) - ood) \
                    / (x - z * g**off)
                gi += 1
        for i, h_x in enumerate(comp_values):
            ood = E(proof.composition_poly_parts_ood_evaluation[i])
            acc = acc + ch["comp_gammas"][i] * (h_x - ood) / (x - z_power)
        return acc


def _bitrev_fn(n):
    bits = n.bit_length() - 1

    def rev(i):
        out = 0
        for b in range(bits):
            out |= ((i >> b) & 1) << (bits - 1 - b)
        return out

    return rev


def verify(air_class, proof, pub_inputs, proof_options, transcript) -> bool:
    """``IsStarkVerifier::verify`` parity wrapper.

    Robustness contract (the role of the reference's proof-deserializer
    fuzz target, ``fuzz/no_gpu_fuzz/fuzz_targets/deserialize_stark_proof
    .rs:1``): a structurally-malformed proof — wrong list arities, wrong
    leaf types, absurd lengths — must *reject*, never crash the caller.
    Structural exceptions therefore map to ``False``.
    """
    try:
        return Verifier(air_class).verify(proof, pub_inputs, proof_options,
                                          transcript)
    except (IndexError, KeyError, TypeError, ValueError, AttributeError,
            ZeroDivisionError, OverflowError):
        return False
