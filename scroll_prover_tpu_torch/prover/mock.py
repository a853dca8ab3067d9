"""Mock proving entry points (reference integration/src/mock.rs).

`mock_prove_target_circuit_chunk(traces)` / `mock_prove_witness_block(wb)`:
build the ScrollSuperCircuit and run the MockProver constraint checker
(mock.rs:11-28), logging `metric_of_witness_block` like the reference.
"""
from __future__ import annotations

import logging

from ..proof_system.plonk import MockProver
from ..l2types.block_trace import BlockTrace
from ..witness.block import WitnessBlock, chunk_trace_to_witness_block
from ..witness.capacity import metric_of_witness_block
from ..zkevm import ScrollSuperCircuit, chunk_instance

log = logging.getLogger(__name__)


def mock_prove_witness_block(wb: WitnessBlock) -> None:
    log.info("mock proving chunk: %s", metric_of_witness_block(wb))
    circuit = ScrollSuperCircuit.new_from_block(wb)
    k = circuit.min_k()
    prover = MockProver.run(k, circuit, [chunk_instance(wb)])
    prover.assert_satisfied()


def mock_prove_target_circuit_chunk(traces: list[BlockTrace]) -> None:
    mock_prove_witness_block(chunk_trace_to_witness_block(traces))
