"""Witness generation: trace replay -> witness block -> circuit tables.

Capability parity with the reference's `bus-mapping` crate + prover-crate
witness surface (SURVEY.md sections 2.2/2.3): `chunk_trace_to_witness_block`
(integration/src/mock.rs:12), `calculate_row_usage_of_witness_block` /
`CircuitCapacityChecker` (integration/src/capacity_checker.rs), and the
per-subcircuit row accounting the sequencer uses for chunk admission.
"""
from .block import WitnessBlock, chunk_trace_to_witness_block  # noqa: F401
from .capacity import (  # noqa: F401
    CircuitCapacityChecker, RowUsage, SubCircuitRowUsage, SUB_CIRCUIT_NAMES,
    calculate_row_usage_of_witness_block, metric_of_witness_block,
)
