"""Aggregation layer: batch data/headers, EIP-4844 blobs, and the
layer3/layer5 aggregation circuits.

Capability parity with the reference `aggregator` crate (SURVEY.md section
2.2): `BatchData`, `BatchHeader` (versioned, `construct_from_chunks`),
blob codec `get_blob_bytes` (envelope layout decoded in SURVEY.md section
2.4), `MAX_AGG_SNARKS` = 45, the BatchCircuit (aggregation + blob
consistency) and RecursionCircuit.
"""
from .constants import (  # noqa: F401
    BLOB_WIDTH, MAX_AGG_SNARKS, N_BLOB_BYTES, N_DATA_BYTES_PER_COEFFICIENT,
)
from .batch_data import BatchData, get_blob_bytes, decode_blob_bytes  # noqa: F401
from .batch_header import BatchHeader  # noqa: F401
from .blob import (  # noqa: F401
    BLS_MODULUS, barycentric_evaluate, blob_to_coefficients,
    blob_versioned_hash, point_evaluation,
)
