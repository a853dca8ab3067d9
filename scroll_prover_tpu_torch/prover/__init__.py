"""Prover facade, chunk side: ChunkInfo, ChunkProvingTask, ChunkProver and
ChunkVerifier (inner proof, then the two compression layers), ChunkProofV2,
params io and mock proving of a witness block through the super circuit."""
from .chunk_info import ChunkInfo, mock_padded_chunk_info_for_testing  # noqa: F401
from .tasks import ChunkProvingTask  # noqa: F401
from .proofs import ChunkProofV2  # noqa: F401
from .provers import (  # noqa: F401
    CHUNK_PROVER_DEGREES, ChunkProver, ChunkVerifier, load_params, load_params_map,
)
from .mock import mock_prove_target_circuit_chunk, mock_prove_witness_block  # noqa: F401
from ..zkevm import INNER_DEGREE  # noqa: F401
