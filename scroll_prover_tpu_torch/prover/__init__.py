"""Prover facade: ChunkInfo, the proving tasks, ChunkProver and
ChunkVerifier (inner proof, then the two compression layers), BatchProver
and BatchVerifier (layer 3, the AggregationCircuit with the in-circuit blob
evaluation, then layer 4) and the bundle (layer 5, an AggregationCircuit
over batch proofs, then layer 6 with the Keccak transcript and GWC, the
release artifacts and the in-EVM verification), ChunkProofV2, BatchProofV2
and BundleProof, params io and mock proving of a witness block through the
super circuit."""
from .chunk_info import ChunkInfo, mock_padded_chunk_info_for_testing  # noqa: F401
from .tasks import BatchProvingTask, BundleProvingTask, ChunkProvingTask  # noqa: F401
from .proofs import BatchProofV2, BundleProof, ChunkProofV2  # noqa: F401
from .provers import (  # noqa: F401
    BATCH_PROVER_DEGREES, CHUNK_PROVER_DEGREES, BatchProver, BatchVerifier,
    ChunkProver, ChunkVerifier, load_params, load_params_map,
)
from .aggregation_circuit import AggregationCircuit  # noqa: F401
from .mock import mock_prove_target_circuit_chunk, mock_prove_witness_block  # noqa: F401
from ..zkevm import INNER_DEGREE  # noqa: F401
