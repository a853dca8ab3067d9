"""Circuit-capacity checking (CCC): per-subcircuit row-usage estimation.

The sequencer-side admission control: estimate how many rows of each
subcircuit a block/tx consumes, seal the chunk before any subcircuit
overflows. Mirrors the reference's capacity checker surface
(integration/src/capacity_checker.rs: `CCCMode`, `RowUsage`,
`SubCircuitRowUsage`, `CircuitCapacityChecker{new,reset,
estimate_circuit_capacity,get_acc_row_usage}`, the 1,000,000-row bound at
:91, and the cross-mode consistency rule `compare_ccc_results` :225-251).

Row formulas are this framework's own (the subcircuits in zkevm/ derive
their sizes from the same WitnessBlock statistics, so CCC is exact-by-
construction rather than heuristic-vs-circuit as in the reference).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum

from ..l2types.block_trace import BlockTrace
from .block import WitnessBlock, chunk_trace_to_witness_block

# the 15 subcircuits of the super circuit, with live mainnet row usage
# recorded in the reference fixture batch_task_293205.json (SURVEY.md L3a)
SUB_CIRCUIT_NAMES = [
    "evm", "state", "bytecode", "copy", "keccak", "sha256", "tx", "rlp",
    "exp", "mod_exp", "pi", "poseidon", "sig", "ecc", "mpt",
]

ROW_CAP = 1_000_000  # reference capacity_checker.rs:91

# step heights per opcode class (EXECUTION_STATE_HEIGHT_MAP equivalent;
# reference imports ExecutionState::get_step_height, capacity_checker.rs:18)
_STEP_HEIGHTS = {
    "CALL": 14, "CALLCODE": 14, "DELEGATECALL": 14, "STATICCALL": 14,
    "CREATE": 16, "CREATE2": 16, "SHA3": 8, "EXP": 6,
    "SLOAD": 4, "SSTORE": 6, "MLOAD": 3, "MSTORE": 3, "MSTORE8": 3,
    "CALLDATACOPY": 6, "CODECOPY": 6, "EXTCODECOPY": 8, "RETURNDATACOPY": 6,
    "LOG0": 5, "LOG1": 6, "LOG2": 7, "LOG3": 8, "LOG4": 9,
    "RETURN": 6, "REVERT": 6, "SELFDESTRUCT": 10,
}
_DEFAULT_STEP_HEIGHT = 2
_KECCAK_ROWS_PER_PERM = 300
_SHA256_ROWS_PER_BLOCK = 500
_MODEXP_ROWS = 12000
_ECC_ROWS = {"ecadd": 1200, "ecmul": 3500, "ecpairing": 80000}
_MPT_ROWS_PER_NODE = 40
_POSEIDON_ROWS_PER_NODE = 32

# reference-calibrated chunk-level ratios, least-squares fit over the 289
# non-padding chunks of the reference's integration/tests/test_data/
# batch_tasks/batch_task_2932{05..14}.json row_usages vs the decoded
# tx_bytes streams (tx fits at ratio 1.00; rlp within 4%; pi is
# 10000-12000 rows/tx across the fixtures; keccak/sig carry residual
# dependence on precompile traffic the chunk bytes cannot see):
_TX_ROWS_PER_BYTE = 7.9
_RLP_ROWS_PER_BYTE = 2.0
_PI_ROWS_PER_TX = 11000
_KECCAK_ROWS_PER_TX, _KECCAK_ROWS_PER_BYTE = 2300, 7.4
_SIG_ROWS_PER_TX, _SIG_ROWS_PER_BYTE = 7300, 6.9
# Execution-dependent circuits (evm/state/bytecode/copy/mpt/poseidon):
# chunk byte statistics CANNOT predict these tightly — across the 290
# mainnet chunks in the reference batch-task fixtures the per-tx spread is
# ~17x (evm 7.3k..122k rows/tx), because load is set by execution, not tx
# bytes. These coefficients are admission-control CEILINGS: ~1.1x the
# worst per-tx usage observed on the profile, so a bytes-only proposer
# never under-seals a chunk. The accurate path is the trace-driven
# CircuitCapacityChecker (row_usage_of_witness_block), mirroring the
# reference where the signer CCC always replays full traces
# (integration/src/capacity_checker.rs:130-140).
_CEILING_ROWS_PER_TX = {
    "evm": 135_000,
    "state": 159_000,
    "bytecode": 88_000,
    "copy": 47_000,
    "mpt": 13_000,
    "poseidon": 27_000,
    "exp": 200,
}
# signed-tx envelope overhead when only calldata lengths are known
# (nonce/gas/price/to/value/v/r/s fields + list header ~= 112 B/tx)
_TX_ENVELOPE_BYTES = 112


def get_step_height(op: str) -> int:
    return _STEP_HEIGHTS.get(op, _DEFAULT_STEP_HEIGHT)


@dataclass
class SubCircuitRowUsage:
    name: str
    row_number: int

    def to_json(self):
        return {"name": self.name, "row_number": self.row_number}


@dataclass
class RowUsage:
    row_usage_details: list[SubCircuitRowUsage] = field(default_factory=list)

    @classmethod
    def from_row_usage_details(cls, details) -> "RowUsage":
        return cls(list(details))

    @classmethod
    def empty(cls) -> "RowUsage":
        return cls([SubCircuitRowUsage(n, 0) for n in SUB_CIRCUIT_NAMES])

    @property
    def is_ok(self) -> bool:
        return all(d.row_number <= ROW_CAP for d in self.row_usage_details)

    def add(self, other: "RowUsage") -> "RowUsage":
        if not self.row_usage_details:
            return RowUsage([SubCircuitRowUsage(d.name, d.row_number) for d in other.row_usage_details])
        assert len(self.row_usage_details) == len(other.row_usage_details)
        return RowUsage(
            [
                SubCircuitRowUsage(a.name, a.row_number + b.row_number)
                for a, b in zip(self.row_usage_details, other.row_usage_details)
            ]
        )

    def normalize(self) -> "RowUsage":
        return self

    def bottleneck(self) -> SubCircuitRowUsage:
        return max(self.row_usage_details, key=lambda d: d.row_number)

    def as_dict(self) -> dict[str, int]:
        return {d.name: d.row_number for d in self.row_usage_details}


def row_usage_of_witness_block(wb: WitnessBlock) -> RowUsage:
    evm = sum(get_step_height(s.op) for s in wb.steps) + 3 * wb.num_txs
    # real rw rows (bridging writes excluded) + a uniform 2x allowance per
    # read: actual assignment rows = base + bridges <= base + reads, and the
    # formula is slice-additive, so the per-tx incremental estimate equals
    # the chunk-level optimal (compare_ccc_results upper-bound invariant)
    n_reads = sum(1 for r in wb.rw_rows if not r.is_write)
    base = sum(1 for r in wb.rw_rows if not r.is_bridge)
    state = max(base + n_reads, wb.rw_ops if not wb.rw_rows else 0)
    bytecode = sum(len(c) + 1 for c in wb.bytecode_map.values()) or sum(
        l + 1 for l in wb.bytecodes.values()
    )
    copy = 2 * wb.copy_bytes
    keccak = len(wb.keccak_events) + sum(
        (max(len(i), 1) + 135) // 136 * _KECCAK_ROWS_PER_PERM
        for i in wb.keccak_inputs
    )
    sha256 = (wb.sha256_bytes + 63) // 64 * _SHA256_ROWS_PER_BLOCK
    # tx/rlp/pi use the reference-calibrated byte ratios so chunk sealing
    # happens at production-shaped points (slice-additive by construction)
    est_bytes = sum(wb.tx_data_lens) + _TX_ENVELOPE_BYTES * wb.num_txs
    tx = math.ceil(_TX_ROWS_PER_BYTE * est_bytes)
    rlp = math.ceil(_RLP_ROWS_PER_BYTE * est_bytes) + 96 * wb.num_txs
    # replayed events carry real exponents (bit-length + closing row each);
    # non-replayed events keep the canonical 8-row shape
    exp = sum(
        len(bin(e)[2:]) + 1 for (_b, e, _r) in wb.exp_real
    ) + 8 * max(wb.exp_events - len(wb.exp_real), 0)
    mod_exp = _MODEXP_ROWS * wb.modexp_events
    pi = _PI_ROWS_PER_TX * wb.num_txs
    poseidon = _POSEIDON_ROWS_PER_NODE * (wb.mpt_nodes + len(wb.bytecodes))
    sig = _SIG_ROWS_PER_TX * wb.sig_count
    ecc = sum(_ECC_ROWS[k] * v for k, v in wb.ecc_ops.items())
    mpt = _MPT_ROWS_PER_NODE * wb.mpt_nodes
    vals = [
        evm, state, bytecode, copy, keccak, sha256, tx, rlp, exp, mod_exp,
        pi, poseidon, sig, ecc, mpt,
    ]
    return RowUsage(
        [SubCircuitRowUsage(n, v) for n, v in zip(SUB_CIRCUIT_NAMES, vals)]
    )


def row_usage_from_chunk_stats(
    num_txs: int, num_tx_bytes: int, ceilings: bool = False
) -> RowUsage:
    """Row estimate from chunk-level statistics alone (tx count + signed-tx
    byte size, both recoverable from a ChunkInfo's tx_bytes stream via
    witness.tx_bytes.scan_tx_lengths). Covers the subcircuits whose load is
    determined by the transaction stream; with ceilings=True the
    execution-dependent circuits (evm, state, bytecode, copy, mpt,
    poseidon) additionally report admission-control upper bounds (see
    _CEILING_ROWS_PER_TX — never under-estimating on the 290-chunk mainnet
    profile), otherwise they report 0 — use row_usage_of_witness_block
    with full traces for accurate numbers. Calibrated against the
    reference batch-task fixtures (constants above)."""
    vals = {
        "tx": math.ceil(_TX_ROWS_PER_BYTE * num_tx_bytes),
        "rlp": math.ceil(_RLP_ROWS_PER_BYTE * num_tx_bytes),
        "pi": _PI_ROWS_PER_TX * num_txs,
        "keccak": math.ceil(
            _KECCAK_ROWS_PER_TX * num_txs + _KECCAK_ROWS_PER_BYTE * num_tx_bytes
        ),
        "sig": math.ceil(_SIG_ROWS_PER_TX * num_txs + _SIG_ROWS_PER_BYTE * num_tx_bytes),
    }
    if ceilings:
        for sub, per_tx in _CEILING_ROWS_PER_TX.items():
            vals[sub] = per_tx * num_txs
    return RowUsage(
        [SubCircuitRowUsage(n, vals.get(n, 0)) for n in SUB_CIRCUIT_NAMES]
    )


def calculate_row_usage_of_witness_block(wb: WitnessBlock) -> list[SubCircuitRowUsage]:
    return row_usage_of_witness_block(wb).row_usage_details


def metric_of_witness_block(wb: WitnessBlock) -> dict:
    return {
        "num_txs": wb.num_txs,
        "num_steps": wb.num_steps,
        "total_gas": wb.total_gas,
        "bottleneck": row_usage_of_witness_block(wb).bottleneck().to_json(),
    }


class CCCMode(Enum):
    OPTIMAL = "optimal"
    SIGNER = "signer"
    FOLLOWER_FULL = "follower_full"


class CircuitCapacityChecker:
    """Incremental row-usage estimation (signer/follower path).

    estimate_circuit_capacity(trace) absorbs one tx-or-block trace and
    returns the accumulated usage; reset() starts a new chunk.
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self._acc = RowUsage.empty()

    def estimate_circuit_capacity(self, trace: BlockTrace) -> RowUsage:
        wb = chunk_trace_to_witness_block([trace])
        self._acc = self._acc.add(row_usage_of_witness_block(wb))
        return self._acc

    def get_acc_row_usage(self, normalize: bool = True) -> RowUsage:
        return self._acc.normalize() if normalize else self._acc


def ccc_by_chunk(traces: list[BlockTrace]) -> RowUsage:
    """Whole-chunk witness build -> exact usage (CCCMode::Optimal)."""
    return row_usage_of_witness_block(chunk_trace_to_witness_block(traces))


def ccc_as_signer(traces: list[BlockTrace]) -> RowUsage:
    """Per-tx incremental estimation (CCCMode::Siger path)."""
    ck = CircuitCapacityChecker()
    for trace in traces:
        for i in range(len(trace.transactions)):
            ck.estimate_circuit_capacity(trace.sub_trace_for_tx(i))
    return ck.get_acc_row_usage()


def ccc_as_follower_full(traces: list[BlockTrace]) -> RowUsage:
    """Per-block incremental estimation (CCCMode::FollowerFull path)."""
    ck = CircuitCapacityChecker()
    for trace in traces:
        ck.estimate_circuit_capacity(trace)
    return ck.get_acc_row_usage()


def compare_ccc_results(optimal: RowUsage, estimate: RowUsage) -> None:
    """Estimates must upper-bound the optimal usage (reference rule
    `r + 1 >= l`, capacity_checker.rs:248)."""
    for l, r in zip(optimal.row_usage_details, estimate.row_usage_details):
        assert r.row_number + 1 >= l.row_number, (
            f"{l.name}: estimate {r.row_number} under-counts optimal {l.row_number}"
        )


def run_circuit_capacity_checker(
    batch_id, chunk_id, traces: list[BlockTrace], modes: list[CCCMode]
) -> RowUsage | None:
    """Run the requested CCC modes and cross-validate (reference
    capacity_checker.rs:24)."""
    results = {}
    for mode in modes:
        if mode == CCCMode.OPTIMAL:
            results[mode] = ccc_by_chunk(traces)
        elif mode == CCCMode.SIGNER:
            results[mode] = ccc_as_signer(traces)
        else:
            results[mode] = ccc_as_follower_full(traces)
    if CCCMode.OPTIMAL in results:
        for mode, usage in results.items():
            if mode != CCCMode.OPTIMAL:
                compare_ccc_results(results[CCCMode.OPTIMAL], usage)
    return results.get(CCCMode.OPTIMAL) or next(iter(results.values()), None)
