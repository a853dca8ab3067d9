"""Orchestration layer (reference integration/src/): prove-and-verify for
each pipeline stage and blob construction; `bench_circuit` holds the
circuit that drives the port's main path end to end."""
from .prove import (  # noqa: F401
    get_blob_from_chunks, new_batch_prover, prove_and_verify_batch,
    prove_and_verify_bundle, prove_and_verify_chunk,
)
