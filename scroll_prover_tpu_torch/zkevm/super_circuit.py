"""ScrollSuperCircuit: all 15 subcircuits over one constraint system.

Mirrors the reference's `ScrollSuperCircuit` as consumed by mock proving and
chunk proving (integration/src/mock.rs:21 `new_from_block`, SURVEY.md L3a).
The production inner degree is 2^20 (reference README.md:21, `INNER_DEGREE`
at mock.rs:9); tests auto-shrink the domain to fit the witness.

Public input (instance column 0) — the chunk-info layout consumed by the
aggregation layer (ChunkInfo, SURVEY.md section 2.3):
  [chain_id,
   prev_state_root_hi, prev_state_root_lo,
   post_state_root_hi, post_state_root_lo,
   withdraw_root_hi,   withdraw_root_lo,
   data_hash_hi,       data_hash_lo]
"""
from __future__ import annotations

from ..fields.bn254 import FR_MOD
from ..proof_system.plonk.cs import Circuit, ConstraintSystem, empty_assignment
from ..witness.block import WitnessBlock
from ..witness.capacity import row_usage_of_witness_block
import os

from .keccak_circuit import KeccakFSubCircuit
from .rlp_circuit import RlpSubCircuit
from .sha256_circuit import Sha256SubCircuit
from .subcircuits import (
    BytecodeSubCircuit, CopySubCircuit, EccSubCircuit, EvmSubCircuit,
    ExpSubCircuit, KeccakSubCircuit, ModExpSubCircuit, MptSubCircuit,
    PiSubCircuit, PoseidonSubCircuit, SigSubCircuit, StateSubCircuit,
    TxSubCircuit,
)

INNER_DEGREE = 20  # production inner-circuit degree (reference README.md:21)


def _sha256_cap() -> int:
    """Constrained SHA-256 compression capacity (512-bit blocks)."""
    return int(os.environ.get("SPT_SHA256_CAP", "0"))


def _modexp_cap() -> int:
    """In-circuit modexp verification capacity (events, ~90k rows each)."""
    return int(os.environ.get("SPT_MODEXP_CAP", "1"))


def _ecc_cap() -> int:
    """In-circuit BN254 precompile verification capacity (events)."""
    return int(os.environ.get("SPT_ECC_CAP", "2"))


def _keccak_cap() -> int:
    """Constrained keccak-f permutation capacity (permutations per chunk,
    ~6.3k rows each). Default 0 keeps test domains small; when enabled,
    bound events' bytecode-table hashes are PROVEN keccak digests of their
    bytes (keccak_circuit.py)."""
    return int(os.environ.get("SPT_KECCAK_CAP", "0"))


def _sig_cap() -> int:
    """In-circuit ECDSA verification capacity (signatures per chunk).
    One verification is ~295k builder rows (k >= 19), the reference sig
    circuit's scale — default 0 keeps test domains small; production
    raises it with the degree. Every signature still gets a REAL table
    row (recovered + host-verified) regardless."""
    return int(os.environ.get("SPT_SIG_CAP", "0"))


def _mpt_cap() -> int:
    """In-circuit MPT verification capacity (proofs per chunk). Like the
    reference's fixed per-degree circuit capacities, the cap is a circuit
    parameter: tests keep domains small; production raises it with the
    degree (CCC tracks the full demand either way)."""
    return int(os.environ.get("SPT_MPT_CAP", "4"))

# placeholder-table subcircuits assign a bounded sample region in test-scale
# domains (full production capacity is the CCC-reported row_usages metadata)
_TABLE_REGION_CAP = 512


def _hex_halves(h: str) -> tuple[int, int]:
    v = int(h, 16) if h and h.startswith("0x") else int(h or "0", 16)
    return (v >> 128) % FR_MOD, v & ((1 << 128) - 1)


def chunk_instance(wb: WitnessBlock) -> list[int]:
    ph, pl = _hex_halves(wb.prev_state_root)
    oh, ol = _hex_halves(wb.post_state_root)
    wh, wl = _hex_halves(wb.withdraw_root)
    dh = int.from_bytes(wb.data_hash(), "big")
    return [
        wb.chain_id % FR_MOD, ph, pl, oh, ol, wh, wl,
        (dh >> 128), dh & ((1 << 128) - 1),
    ]


# rows the EVM word-arithmetic builder places per step, by opcode byte
# (one lane; the same for every operand). The JAX package counts MUL alone,
# at 60 rows, so a block of comparisons or divisions outgrows the domain its
# min_k gives and the builder's region overflows there.
_WORD_ROWS = {
    0x02: 101,  # MUL
    0x04: 193, 0x06: 193,  # DIV, MOD
    0x10: 135, 0x11: 135,  # LT, GT
    0x14: 81,  # EQ
    0x15: 55, 0x19: 50,  # ISZERO, NOT
}


class ScrollSuperCircuit(Circuit):
    def __init__(self, wb: WitnessBlock):
        self.wb = wb
        self._row_cap_hint = None

    @classmethod
    def new_from_block(cls, wb: WitnessBlock) -> "ScrollSuperCircuit":
        return cls(wb)

    # -- shape -------------------------------------------------------------
    def min_k(self) -> int:
        """Smallest domain exponent that fits this witness (test shrink)."""
        usage = row_usage_of_witness_block(self.wb)
        wb = self.wb
        mpt_rows, mpt_pos_rows = MptSubCircuit().rows_for(wb, cap=_mpt_cap())
        sig_rows, sig_builder_rows = SigSubCircuit().rows_for(wb, cap=_sig_cap())
        kf_state_rows, kf_bit_rows = KeccakFSubCircuit().rows_for(wb, _keccak_cap())
        ecc_rows, ecc_builder_rows = EccSubCircuit().rows_for(wb, _ecc_cap())
        mx_rows, mx_builder_rows = ModExpSubCircuit().rows_for(wb, _modexp_cap())
        rlp_rows = RlpSubCircuit.rows_for(RlpSubCircuit(), wb)
        sh_rows, sh_grid = Sha256SubCircuit().rows_for(wb, _sha256_cap())
        rows = max(
            max(min(d.row_number, _TABLE_REGION_CAP) for d in usage.row_usage_details),
            # real-table regions are assigned in full, never capped
            # (+256-row push-length fixed table after the code bytes)
            sum(len(c) for c in wb.bytecode_map.values()) + 258,
            CopySubCircuit().rows_for(wb) + 2,
            len(wb.rw_rows) + 2,
            len(wb.keccak_events) + 2,
            wb.num_steps + 258,  # +256-row opcode-properties fixed table
            # evm word-arithmetic builder (its rows per MUL, DIV/MOD, LT/GT,
            # EQ, ISZERO and NOT step) + its 256-row range table
            sum(_WORD_ROWS.get(s.op_byte, 0) for s in wb.steps if s.sp >= 0)
            + 320,
            mpt_rows + 2,
            sig_rows + 2,
            sig_builder_rows + 64,
            kf_state_rows + 64,
            kf_bit_rows + 64,
            ecc_rows + 2,
            ecc_builder_rows + 64,
            mx_rows + 2,
            mx_builder_rows + 64,
            rlp_rows + 2,
            sh_rows + sh_grid + 64,
            1200 + mpt_pos_rows,  # poseidon sponge region + mpt permutations
        )
        k = max((rows + 16).bit_length(), 8)
        # SPT_INNER_K pins the inner domain to the production degree
        # (INNER_DEGREE=20, reference README.md:21 / mock.rs:9) instead of
        # the test-shrink minimum; min_k still wins if the witness
        # genuinely needs more rows.
        forced = int(os.environ.get("SPT_INNER_K", "0"))
        return max(k, forced) if forced else k

    # -- circuit interface -------------------------------------------------
    def configure(self, cs: ConstraintSystem):
        self.instance = cs.instance_column()
        self.byte_table = cs.fixed_column()
        self.pi = PiSubCircuit().configure(cs, self.instance)
        self.tx = TxSubCircuit().configure(cs)
        self.keccak = KeccakSubCircuit().configure(cs)
        self.bytecode = BytecodeSubCircuit().configure(
            cs, self.byte_table, self.keccak
        )
        self.state = StateSubCircuit().configure(cs, self.byte_table)
        self.evm = EvmSubCircuit().configure(cs, self.bytecode, self.state)
        self.copy = CopySubCircuit().configure(
            cs, self.byte_table, self.bytecode, self.keccak, self.tx
        )
        self.exp = ExpSubCircuit().configure(cs)
        self.poseidon = PoseidonSubCircuit().configure(cs)
        self.mpt = MptSubCircuit().configure(cs, self.state, self.poseidon)
        self.sig = SigSubCircuit().configure(cs, cap=_sig_cap())
        self.ecc = EccSubCircuit().configure(cs, cap=_ecc_cap())
        self.mod_exp = ModExpSubCircuit().configure(cs, cap=_modexp_cap())
        self.keccak_f = KeccakFSubCircuit().configure(
            cs, self.bytecode, self.keccak, cap=_keccak_cap()
        )
        self.rlp = RlpSubCircuit().configure(cs, self.byte_table, self.tx)
        self.sha256 = Sha256SubCircuit().configure(cs, cap=_sha256_cap())
        self.row_usages_: dict[str, int] = {}

    def assign(self, cs: ConstraintSystem, n: int, instance):
        fixed = empty_assignment(cs.num_fixed, n)
        adv = empty_assignment(cs.num_advice, n)
        wb = self.wb
        for b in range(256):
            fixed[self.byte_table.index][b] = b

        used = {}
        # pi table is assigned from the WITNESS (not the passed instance):
        # the copy constraints are what bind instance == witness chunk info
        used["pi"] = self.pi.assign(cs, adv, n, wb, chunk_instance(wb), 0)
        used["tx"] = self.tx.assign(cs, fixed, adv, n, wb, 0)
        used["keccak"] = self.keccak.assign(cs, fixed, adv, n, wb, 0)
        used["bytecode"] = self.bytecode.assign(cs, fixed, adv, n, wb, 0)
        used["evm"] = self.evm.assign(cs, fixed, adv, n, wb, 0)
        used["copy"] = self.copy.assign(cs, fixed, adv, n, wb, 0)
        used["state"] = self.state.assign(cs, fixed, adv, n, wb, 0)
        used["exp"] = self.exp.assign(cs, fixed, adv, n, wb, 0)
        used["poseidon"] = self.poseidon.assign(cs, fixed, adv, n, wb, 0)
        used["mpt"], mpt_pos = self.mpt.assign(
            cs, fixed, adv, n, wb, 0, pos_row0=used["poseidon"], cap=_mpt_cap()
        )
        used["poseidon"] += mpt_pos
        used["sig"] = self.sig.assign(cs, fixed, adv, n, wb, 0)
        used["ecc"] = self.ecc.assign(cs, fixed, adv, n, wb, 0)
        used["mod_exp"] = self.mod_exp.assign(cs, fixed, adv, n, wb, 0)
        used["keccak"] += self.keccak_f.assign(
            cs, fixed, adv, n, wb, 0, self.keccak,
            lambda dig: self.keccak.row_of_[dig],
        )
        used["rlp"] = self.rlp.assign(cs, fixed, adv, n, wb, 0)
        used["sha256"] = self.sha256.assign(cs, fixed, adv, n, wb, 0)
        self.row_usages_ = used
        return {"fixed": fixed, "advice": adv}

    def instance_for(self) -> list[list[int]]:
        return [chunk_instance(self.wb)]
