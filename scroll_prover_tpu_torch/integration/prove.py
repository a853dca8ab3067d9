"""Stage orchestration (reference integration/src/prove.rs):
`prove_and_verify_chunk` (prove.rs:23), `prove_and_verify_batch` (:57),
`prove_and_verify_bundle` (:88), `get_blob_from_chunks` (:112, pads to
MAX_AGG_SNARKS with padding chunk infos), `new_batch_prover` (:11). Every
stage runs on `device` (the card unless the caller passes device="cpu")."""
from __future__ import annotations

import logging
import time

from ..aggregator import BatchData, MAX_AGG_SNARKS, get_blob_bytes
from ..prover import (
    BatchProver, BatchVerifier, ChunkProver, ChunkVerifier,
    mock_padded_chunk_info_for_testing,
)
from ..prover.tasks import BatchProvingTask, BundleProvingTask, ChunkProvingTask

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


def get_blob_from_chunks(chunk_infos: list) -> bytes:
    """Pad to MAX_AGG_SNARKS, build BatchData, envelope the payload
    (reference prove.rs:112-127)."""
    num_valid = len(chunk_infos)
    padded = list(chunk_infos)
    last = chunk_infos[-1]
    while len(padded) < MAX_AGG_SNARKS:
        padded.append(mock_padded_chunk_info_for_testing(last))
    bd = BatchData.new(num_valid, padded)
    return get_blob_bytes(bd.get_batch_data_bytes())


def new_batch_prover(params_map, assets_dir: str = "", chunk_protocol: str = "", device=None) -> BatchProver:
    """Mirrors prove.rs:11-16: records the chunk protocol the batch prover
    must aggregate against (HALO2_CHUNK_PROTOCOL / SP1_CHUNK_PROTOCOL)."""
    import os

    if chunk_protocol:
        os.environ.setdefault("HALO2_CHUNK_PROTOCOL", chunk_protocol)
        os.environ.setdefault("SP1_CHUNK_PROTOCOL", chunk_protocol)
    return BatchProver.from_params_and_assets(params_map, assets_dir, device)


def prove_and_verify_batch(
    params_map, assets_dir: str, task: BatchProvingTask,
    output_dir: str | None = None, device=None,
):
    prover = new_batch_prover(params_map, assets_dir, device=device)
    t0 = time.perf_counter()
    proof = prover.gen_batch_proof(task, output_dir)
    log.info("batch proof generated in %.1fs", time.perf_counter() - t0)
    verifier = BatchVerifier.from_params_and_assets(params_map, assets_dir, device)
    assert verifier.verify_batch_proof(proof), "batch proof verification failed"
    return proof


def prove_and_verify_bundle(
    params_map, assets_dir: str, task: BundleProvingTask,
    output_dir: str | None = None, device=None,
):
    prover = new_batch_prover(params_map, assets_dir, device=device)
    t0 = time.perf_counter()
    proof = prover.gen_bundle_proof(task, output_dir)
    log.info("bundle proof generated in %.1fs", time.perf_counter() - t0)
    verifier = BatchVerifier.from_params_and_assets(params_map, assets_dir, device)
    assert verifier.verify_bundle_proof(proof), "bundle proof verification failed"
    return proof
