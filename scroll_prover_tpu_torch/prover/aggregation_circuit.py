"""AggregationCircuit: verifies N inner SNARKs IN-CIRCUIT and folds their
deferred pairings into one 12-cell KZG accumulator.

This is the layer3/layer5 "45-way aggregation" of the reference aggregator
crate (SURVEY.md section 3.2: BatchCircuit aggregates <= MAX_AGG_SNARKS
chunk SNARKs via snark-verifier's KZG accumulation scheme + halo2-ecc
loader). Round-2's VerifierCircuit handles one inner proof; this circuit
runs one VerifierGadget per inner proof sharing a single Builder/ECC chip,
then:

  * binds ALL inner instances + a context vector with an in-circuit duplex
    Poseidon sponge -> one exposed digest cell,
  * squeezes a fold challenge mu (the sponge also absorbs every per-proof
    accumulator limb first, so mu commits to all of them),
  * folds accumulators: lhs = sum mu^i lhs_i, rhs = sum mu^i rhs_i (two
    non-native MSMs), composing with each gadget's OWN inner-accumulator
    fold (chunk layer2 proofs carry 12 acc cells of their own),
  * enforces caller-declared equality links between inner instance cells
    (chunk chaining: post_state_root(i) == prev_state_root(i+1)).

Instance layout: [12 accumulator limb cells || digest || context...].
Verifying THIS circuit's proof plus one pairing on its accumulator
transitively verifies every aggregated inner proof and everything below
them.
"""
from __future__ import annotations

import logging
import time

from ..curves.bn254_curve import G1
from ..fields.bn254 import FR_MOD
from ..gadgets.builder import Builder
from ..gadgets.ecc import EccChip
from ..gadgets.nonnative import NonNativeChip
from ..gadgets.plonk_verifier import VerifierGadget
from ..gadgets.transcript import InCircuitTranscript
from ..proof_system.plonk.cs import Circuit, ConstraintSystem, empty_assignment
from ..proof_system.plonk.keygen import VerifyingKey
from ..proof_system.plonk.verifier import (
    acc_from_limbs,
    acc_limbs,
    accumulator_for,
)
from ..proof_system.transcript import PoseidonTranscript
from ..zkevm.subcircuits import PoseidonSubCircuit
from .compression import _canonical_k
from .verifier_circuit import (
    ACC_CELLS, LOOKUP_BITS, collector_off, fit_record, recording_pass, register_copies, replay_record,
)

log = logging.getLogger(__name__)


class AggregationCircuit(Circuit):
    def __init__(
        self,
        inners: list[tuple[VerifyingKey, bytes, list[int]]],
        context: list[int],
        inners_have_acc: bool = True,
        links: list[tuple[int, int, int, int]] | None = None,
        expose: list[tuple[int, int]] | None = None,
        blob_bytes: bytes | None = None,
        blob_zy: tuple[int, int, int, int] = (2, 3, 4, 5),
        blob_width: int = 4096,
        inner_multiopen: str = "gwc",
    ):
        """inners: [(vk, proof, instances)] per aggregated SNARK;
        context: public values bound by the digest and exposed after it;
        links: [(item_a, off_a, item_b, off_b)] instance-cell equalities
        enforced with copy constraints (chunk chaining);
        expose: [(item, off)] inner instance cells copied into THIS
        circuit's instance after the context (statement pass-through:
        state roots, data hashes — the verifier reads them from the PI);
        blob_bytes: when given (layer3/BatchCircuit use), the 4096-coeff
        blob polynomial is evaluated IN-CIRCUIT at the context's (z, y)
        cells (gadgets/blob_eval.py barycentric form) and the
        coefficients' Poseidon digest is exposed as one extra instance
        cell right after the context — the verifier recomputes it from
        the actual blob bytes (in-circuit blob consistency); blob_zy: context offsets of (z_hi, z_lo, y_hi,
        y_lo); blob_width: domain size (tests shrink it)."""
        assert inners
        self.inners = [
            (vk, proof, [int(v) % FR_MOD for v in ins])
            for vk, proof, ins in inners
        ]
        for vk, _p, ins in self.inners:
            assert vk.cs.num_instance <= 1, "single instance column expected"
            if inners_have_acc:
                assert len(ins) >= ACC_CELLS
        self.context = [int(v) % FR_MOD for v in context]
        self.inners_have_acc = inners_have_acc
        self.links = list(links or [])
        self.expose = list(expose or [])
        for item, off in self.expose:
            assert 0 <= item < len(self.inners)
            assert 0 <= off < len(self.inners[item][2])
        self.blob_bytes = blob_bytes
        self.blob_zy = blob_zy
        self.blob_width = blob_width
        self.inner_multiopen = inner_multiopen
        self._min_k: int | None = None
        self._record = None  # min_k()'s pass, which assign() takes its tables from
        self._assign_cache: dict[int, tuple] = {}

    # -- layout ------------------------------------------------------------

    def num_instance(self) -> int:
        blob = 1 if self.blob_bytes is not None else 0
        return ACC_CELLS + 1 + len(self.context) + blob + len(self.expose)

    def configure(self, cs: ConstraintSystem):
        self.instance = cs.instance_column()
        cs.enable_permutation(self.instance)
        self.b = Builder().configure(cs, lookup_bits=LOOKUP_BITS)
        self.pos = PoseidonSubCircuit().configure(cs)
        for col in (self.pos.s[0], self.pos.elem[0], self.pos.elem[1]):
            cs.enable_permutation(col)
        return self

    # -- the gadget program ------------------------------------------------

    def _run(self, cs, fixed, adv, n: int):
        t0 = time.time()
        log.info("aggregation-gadget build start (n=%d)", n)
        with collector_off():  # millions of long-lived cells, almost no cyclic garbage
            out = self._program(cs, fixed, adv, n)
        log.info("aggregation-gadget build done: %d rows, %.1fs", out[0].rows_used(), time.time() - t0)
        return out

    def _program(self, cs, fixed, adv, n: int):
        b = self.b.begin(cs, fixed, adv, n, 0)
        ec = EccChip(NonNativeChip(b))

        all_inst_cells = []
        pair_cells = []  # (lhs EcPointNN, rhs EcPointNN) per inner
        row = 0
        for vk, proof, ins in self.inners:
            inst_cells = [b.witness(v) for v in ins]
            all_inst_cells.append(inst_cells)
            vg = VerifierGadget(
                b, self.pos, ec, vk, [inst_cells], proof,
                inner_acc_cells=(
                    inst_cells[:ACC_CELLS] if self.inners_have_acc else None
                ),
                multiopen=self.inner_multiopen,
            )
            lhs_i, rhs_i = vg.run(transcript_row0=row)
            row = vg.transcript_rows
            pair_cells.append((lhs_i, rhs_i))

        # equality links between inner instance cells (chunk chaining)
        for ia, oa, ib, ob in self.links:
            ca = all_inst_cells[ia][oa]
            cb = all_inst_cells[ib][ob]
            b.assert_equal(ca, cb)

        # digest + fold sponge (host mirror: _host_sponge below)
        ctx_cells = [b.witness(v) for v in self.context]
        tr = InCircuitTranscript(b, self.pos, b"", row0=row)
        for inst_cells in all_inst_cells:
            for c in inst_cells:
                tr.common_scalar_cell(c)
        for c in ctx_cells:
            tr.common_scalar_cell(c)
        digest = tr.squeeze()
        for lhs_i, rhs_i in pair_cells:
            for p in (lhs_i, rhs_i):
                for coord in (p.x, p.y):
                    for limb in coord.limbs:
                        tr.common_scalar_cell(limb)
        mu = tr.squeeze()

        # blob consistency (layer3): in-circuit barycentric evaluation at
        # the context (z, y) + coefficient digest via a dedicated sponge
        blob_digest = None
        if self.blob_bytes is not None:
            from ..aggregator.blob import blob_to_coefficients
            from ..gadgets.blob_eval import BlobEvalGadget

            coeffs = blob_to_coefficients(self.blob_bytes)[: self.blob_width]
            zi0, zi1, yi0, yi1 = self.blob_zy
            gadget = BlobEvalGadget(b, width=self.blob_width)
            pairs = gadget.run(
                coeffs, ctx_cells[zi0], ctx_cells[zi1],
                ctx_cells[yi0], ctx_cells[yi1],
            )
            btr = InCircuitTranscript(b, self.pos, b"", row0=tr.rows_used())
            for hi, lo in pairs:
                btr.common_scalar_cell(hi)
                btr.common_scalar_cell(lo)
            blob_digest = btr.squeeze()
            tr = btr  # rows accounting continues from the blob sponge
        self._sponge_rows = tr.rows_used()

        # fold: sum mu^i (lhs_i, rhs_i)
        one = b.const(1)
        scalars = [one]
        for _ in range(1, len(pair_cells)):
            scalars.append(b.mul(scalars[-1], mu))
        lhs = ec.msm(scalars, [p for p, _ in pair_cells])
        rhs = ec.msm(scalars, [q for _, q in pair_cells])
        exp_cells = [all_inst_cells[i][off] for i, off in self.expose]
        if blob_digest is not None:
            ctx_cells = ctx_cells + [blob_digest]
        return b, lhs, rhs, digest, ctx_cells, exp_cells

    def min_k(self) -> int:
        if self._min_k is None:
            (b, *_rest), record = recording_pass(self)
            rows = max(b.rows_used(), self._sponge_rows, 1 << LOOKUP_BITS)
            self._rows = rows
            self._min_k = _canonical_k(max((rows + 64).bit_length(), 8))
            self._record = fit_record(record, 1 << self._min_k)
        return self._min_k

    def assign(self, cs: ConstraintSystem, n: int, instance):
        cached = self._assign_cache.get(n)
        if cached is not None:
            out, copies = cached
            if not getattr(cs, "_agg_copies_done", False):
                # a constraint system that has not seen this circuit's copies
                # (a second keygen of the same circuit, a mock run): the
                # record went to the first assignment, its copies stay here
                register_copies(cs, copies)
                cs._agg_copies_done = True
            return out
        copies_start = len(cs.copies)
        had_copies = getattr(cs, "_agg_copies_done", False)
        replayed = replay_record(cs, self._record, n, "aggregation-gadget")
        self._record = None
        if replayed is not None:
            fixed, adv, (_b, lhs, rhs, digest, ctx_cells, exp_cells) = replayed
        else:
            fixed = empty_assignment(cs.num_fixed, n)
            adv = empty_assignment(cs.num_advice, n)
            _b, lhs, rhs, digest, ctx_cells, exp_cells = self._run(cs, fixed, adv, n)
        limb_cells = [*lhs.x.limbs, *lhs.y.limbs, *rhs.x.limbs, *rhs.y.limbs]
        assert len(limb_cells) == ACC_CELLS
        for i, c in enumerate(limb_cells):
            cs.copy(self.instance, i, c.col, c.row)
        cs.copy(self.instance, ACC_CELLS, digest.col, digest.row)
        for i, c in enumerate(ctx_cells):
            cs.copy(self.instance, ACC_CELLS + 1 + i, c.col, c.row)
        base = ACC_CELLS + 1 + len(ctx_cells)
        for i, c in enumerate(exp_cells):
            cs.copy(self.instance, base + i, c.col, c.row)
        copies = cs.copies[copies_start:]
        if had_copies:
            del cs.copies[copies_start:]
        else:
            cs._agg_copies_done = True
        out = {"fixed": fixed, "advice": adv}
        self._assign_cache[n] = (out, copies)
        return out

    # -- host twin -----------------------------------------------------------

    def _host_sponge(self, pairs):
        """Mirror of the in-circuit digest+fold sponge; returns (digest, mu)."""
        tr = PoseidonTranscript(b"")
        for _vk, _p, ins in self.inners:
            for v in ins:
                tr.common_scalar(v)
        for v in self.context:
            tr.common_scalar(v)
        digest = tr.squeeze_challenge()
        for lhs, rhs in pairs:
            for limb in acc_limbs(lhs, rhs):
                tr.common_scalar(limb)
        mu = tr.squeeze_challenge()
        return digest, mu

    def instance_for(self) -> list[list[int]]:
        pairs = []
        for vk, proof, ins in self.inners:
            inner_acc = (
                acc_from_limbs(ins[:ACC_CELLS]) if self.inners_have_acc else None
            )
            pairs.append(
                accumulator_for(
                    vk, [ins], proof, inner_acc,
                    multiopen=self.inner_multiopen,
                )
            )
        digest, mu = self._host_sponge(pairs)
        lhs = rhs = None
        mp = 1
        for i, (li, ri) in enumerate(pairs):
            lhs = G1.add(lhs, li if i == 0 else G1.mul(li, mp))
            rhs = G1.add(rhs, ri if i == 0 else G1.mul(ri, mp))
            mp = mp * mu % FR_MOD
        exposed = [self.inners[i][2][off] for i, off in self.expose]
        blob = (
            [self.host_blob_digest(self.blob_bytes, self.blob_width)]
            if self.blob_bytes is not None
            else []
        )
        return [[*acc_limbs(lhs, rhs), digest, *self.context, *blob, *exposed]]

    @staticmethod
    def host_blob_digest(blob_bytes: bytes, width: int = 4096) -> int:
        """Host twin of the in-circuit blob-coefficient sponge: the value
        the verifier recomputes from the ACTUAL blob bytes and compares to
        the exposed instance cell (fail-closed byte binding)."""
        from ..aggregator.blob import blob_to_coefficients

        m = (1 << 128) - 1
        tr = PoseidonTranscript(b"")
        for cv in blob_to_coefficients(blob_bytes)[:width]:
            tr.common_scalar(cv >> 128)
            tr.common_scalar(cv & m)
        return tr.squeeze_challenge()
