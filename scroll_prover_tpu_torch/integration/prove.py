"""Stage orchestration, chunk side (reference integration/src/prove.rs):
`prove_and_verify_chunk` (prove.rs:23). The batch and bundle stages come
with the aggregator."""
from __future__ import annotations

import logging
import time

from ..prover import ChunkProver, ChunkVerifier
from ..prover.tasks import ChunkProvingTask

log = logging.getLogger(__name__)


def prove_and_verify_chunk(
    params_map, assets_dir: str, traces, chunk_id: str | None = None,
    output_dir: str | None = None, device=None,
):
    prover = ChunkProver.from_params_and_assets(params_map, assets_dir, device)
    task = ChunkProvingTask.new(traces)
    t0 = time.perf_counter()
    proof = prover.gen_halo2_chunk_proof(task, chunk_id, None, output_dir)
    log.info("chunk proof generated in %.1fs", time.perf_counter() - t0)
    verifier = ChunkVerifier.from_params_and_assets(params_map, assets_dir, device)
    assert verifier.verify_chunk_proof(proof), "chunk proof verification failed"
    return proof
