"""Prover facade: ChunkInfo, the proving tasks, ChunkProver and
ChunkVerifier (inner proof, then the two compression layers), BatchProver
and BatchVerifier (layer 3, the AggregationCircuit with the in-circuit blob
evaluation, then layer 4), ChunkProofV2 and BatchProofV2, params io and
mock proving of a witness block through the super circuit. The bundle
layers come with the EVM verifier."""
from .chunk_info import ChunkInfo, mock_padded_chunk_info_for_testing  # noqa: F401
from .tasks import BatchProvingTask, ChunkProvingTask  # noqa: F401
from .proofs import BatchProofV2, ChunkProofV2  # noqa: F401
from .provers import (  # noqa: F401
    BATCH_PROVER_DEGREES, CHUNK_PROVER_DEGREES, BatchProver, BatchVerifier,
    ChunkProver, ChunkVerifier, load_params, load_params_map,
)
from .aggregation_circuit import AggregationCircuit  # noqa: F401
from .mock import mock_prove_target_circuit_chunk, mock_prove_witness_block  # noqa: F401
from ..zkevm import INNER_DEGREE  # noqa: F401
