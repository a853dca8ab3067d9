"""Prover facade, chunk side: ChunkInfo, ChunkProvingTask and mock proving
of a witness block through the super circuit."""
from .chunk_info import ChunkInfo, mock_padded_chunk_info_for_testing  # noqa: F401
from .tasks import ChunkProvingTask  # noqa: F401
from .mock import mock_prove_target_circuit_chunk, mock_prove_witness_block  # noqa: F401
from ..zkevm import INNER_DEGREE  # noqa: F401
