"""Panic-isolated prove wrappers (reference bin/src/prove_utils.rs).

A prover failure on one chunk/batch must not kill a chain scan: every
wrapper catches, logs, and returns None (the reference's
catch_unwind(AssertUnwindSafe(..)) at prove_utils.rs:27,45). The CIRCUIT
env selects none|ccc|real dispatch like chain_prover.rs:250-257.

`device` goes to ChunkProver/BatchProver: the card unless the caller passes
"cpu" (a prover made without a card and without "cpu" raises, and the
wrapper isolates that like any other failure).
"""
from __future__ import annotations

import logging
import traceback

from ..utils.env import read_env_var

log = logging.getLogger(__name__)


def prove_chunk(params_map, assets_dir, traces, chunk_id=None, output_dir=None, device=None):
    """CIRCUIT=none -> skip; CIRCUIT=ccc -> capacity-check only (mock
    tier); otherwise real chunk proving. Exceptions are isolated."""
    circuit = read_env_var("CIRCUIT", "real")
    try:
        if circuit == "none":
            return None
        if circuit in ("ccc", "mock"):
            from ..prover.mock import mock_prove_target_circuit_chunk

            mock_prove_target_circuit_chunk(traces)
            return None
        from ..prover import ChunkProver
        from ..prover.provers import apply_production_cap_profile
        from ..prover.tasks import ChunkProvingTask

        apply_production_cap_profile(traces)
        prover = ChunkProver.from_params_and_assets(params_map, assets_dir, device)
        return prover.gen_halo2_chunk_proof(
            ChunkProvingTask.new(traces), chunk_id, None, output_dir
        )
    except Exception:
        log.error("chunk proving failed (isolated):\n%s", traceback.format_exc())
        return None


def prove_batch(params_map, assets_dir, task, output_dir=None, device=None):
    try:
        from ..prover import BatchProver

        prover = BatchProver.from_params_and_assets(params_map, assets_dir, device)
        return prover.gen_batch_proof(task, output_dir)
    except Exception:
        log.error("batch proving failed (isolated):\n%s", traceback.format_exc())
        return None


def mock_prove(traces) -> bool:
    try:
        from ..prover.mock import mock_prove_target_circuit_chunk

        mock_prove_target_circuit_chunk(traces)
        return True
    except Exception:
        log.error("mock prove failed:\n%s", traceback.format_exc())
        return False
