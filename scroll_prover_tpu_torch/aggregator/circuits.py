"""Aggregation circuits: BatchCircuit (layer3) and RecursionCircuit (layer5).

Role parity with the reference aggregator crate (SURVEY.md section 3.2):
layer3 aggregates <= MAX_AGG_SNARKS chunk SNARKs and binds the batch data
(blob + header); layer5 folds a sequence of batch proofs into one.

Binding model (same as prover/compression.py): a fully-constrained Poseidon
sponge absorbs every aggregated proof string + instance + the header bytes;
cross-chunk state-root chaining is enforced IN-CIRCUIT with copy
constraints between the absorbed cells of consecutive chunks. In-circuit
KZG accumulation of the chunk SNARKs is the designated next deepening
(reference does it with halo2-ecc non-native arithmetic, layer3.config
shapes).
"""
from __future__ import annotations

from ..fields.bn254 import FR_MOD
from ..proof_system.plonk.cs import Circuit, ConstraintSystem, empty_assignment
from ..zkevm.subcircuits import PoseidonSubCircuit
from ..prover.compression import proof_to_field_elems
from .constants import MAX_AGG_SNARKS

# chunk layer2 instance layout: [digest2, digest1, chain_id, prev_hi,
# prev_lo, post_hi, post_lo, withdraw_hi, withdraw_lo, datahash_hi,
# datahash_lo] — offsets of the root fields within a chunk's element run
_OFF_PREV = 3
_OFF_POST = 5


def _sponge_digest(inputs: list[int]) -> int:
    from ..hashes.poseidon import poseidon_fr

    msg = [v % FR_MOD for v in inputs] or [0]
    if len(msg) % 2:
        msg = msg + [0]
    state = [0, 0, 0]
    for i in range(0, len(msg), 2):
        state[0] = (state[0] + msg[i]) % FR_MOD
        state[1] = (state[1] + msg[i + 1]) % FR_MOD
        state = poseidon_fr.permute(state)
    return state[0]


class _SpongeAggCircuit(Circuit):
    """Common core: sponge over per-item [instances || proof elems] runs plus
    trailing context elements; instance = [digest, *context_values]."""

    def __init__(self, items: list[tuple[list[int], bytes]], context: list[int]):
        self.items = [([int(v) % FR_MOD for v in ins], pf) for ins, pf in items]
        self.context = [int(v) % FR_MOD for v in context]
        # element runs: start index of each item's elements
        self.runs: list[int] = []
        pos = 0
        self._elems: list[int] = []
        for ins, pf in self.items:
            self.runs.append(pos)
            es = list(ins) + proof_to_field_elems(pf)
            self._elems += es
            pos += len(es)
        self.ctx_start = pos
        self._elems += self.context

    def all_elems(self) -> list[int]:
        return list(self._elems)

    def digest(self) -> int:
        return _sponge_digest(self._elems)

    def num_instance(self) -> int:
        return 1 + len(self.context)

    def min_k(self) -> int:
        from ..prover.compression import _canonical_k

        blocks = (len(self._elems) + 2) // 2
        return _canonical_k(max((blocks * 67 + 24).bit_length(), 8))

    def configure(self, cs: ConstraintSystem):
        self.instance = cs.instance_column()
        self.poseidon = PoseidonSubCircuit().configure(cs)
        cs.enable_permutation(self.instance)
        cs.enable_permutation(self.poseidon.s[0])
        cs.enable_permutation(self.poseidon.elem[0])
        cs.enable_permutation(self.poseidon.elem[1])

    def _elem_cell(self, j: int):
        """(column, row) of absorbed element j in the sponge layout."""
        return self.poseidon.elem[j % 2], (j // 2) * 66

    def assign(self, cs: ConstraintSystem, n: int, instance):
        fixed = empty_assignment(cs.num_fixed, n)
        adv = empty_assignment(cs.num_advice, n)
        rows, digest_row, digest = self.poseidon.assign_sponge(
            cs, fixed, adv, n, self._elems, 0
        )
        cs.copy(self.instance, 0, self.poseidon.s[0], digest_row)
        # context values are instance-bound to their absorbed cells
        for i in range(len(self.context)):
            col, row = self._elem_cell(self.ctx_start + i)
            cs.copy(self.instance, 1 + i, col, row)
        self._extra_copies(cs)
        return {"fixed": fixed, "advice": adv}

    def _extra_copies(self, cs: ConstraintSystem):
        pass

    def instance_for(self) -> list[list[int]]:
        return [[self.digest()] + self.context]


class BatchCircuit(_SpongeAggCircuit):
    """layer3: aggregate chunk (layer2) proofs + bind batch header bytes.

    items = [(chunk_layer2_instances, chunk_layer2_proof)] (<= 45);
    context = [batch_hash_hi, batch_hash_lo, z_hi, z_lo, y_hi, y_lo]
    (the blob point-evaluation pair from the header).
    In-circuit chunk chaining: post_state_root(i) == prev_state_root(i+1)
    via copy constraints on the absorbed instance cells.
    """

    def __init__(self, chunk_payloads, batch_header):
        assert 0 < len(chunk_payloads) <= MAX_AGG_SNARKS
        bh = batch_header.batch_hash()
        z, y = batch_header.blob_data_proof
        context = [
            int.from_bytes(bh[:16], "big"), int.from_bytes(bh[16:], "big"),
            z >> 128, z & ((1 << 128) - 1), y >> 128, y & ((1 << 128) - 1),
        ]
        super().__init__(chunk_payloads, context)
        self.batch_header = batch_header

    def _extra_copies(self, cs: ConstraintSystem):
        for i in range(len(self.items) - 1):
            post_hi = self.runs[i] + _OFF_POST
            next_prev_hi = self.runs[i + 1] + _OFF_PREV
            for off in (0, 1):  # hi, lo
                ca, ra = self._elem_cell(post_hi + off)
                cb, rb = self._elem_cell(next_prev_hi + off)
                cs.copy(ca, ra, cb, rb)


class RecursionCircuit(_SpongeAggCircuit):
    """layer5: fold batch (layer4) proofs chain-wise.

    items = [(batch_layer4_instances, batch_layer4_proof)];
    context = [first_parent_batch_hash_hi/lo, last_batch_hash_hi/lo,
    num_batches].
    """

    def __init__(self, batch_payloads, first_parent_hash: bytes, last_hash: bytes):
        context = [
            int.from_bytes(first_parent_hash[:16], "big"),
            int.from_bytes(first_parent_hash[16:], "big"),
            int.from_bytes(last_hash[:16], "big"),
            int.from_bytes(last_hash[16:], "big"),
            len(batch_payloads),
        ]
        super().__init__(batch_payloads, context)
