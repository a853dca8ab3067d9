"""ChunkBuilder / BatchBuilder: production-shaped proposers.

ChunkBuilder seals a chunk when adding the next block would overflow any
subcircuit's row capacity (CCC-driven; reference bin/src/chain_prover.rs:
112-157). BatchBuilder seals a batch on chunk-count, compressed-blob-size,
or uncompressed-payload overflow (chain_prover.rs:27-110).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field

from ..aggregator import BatchData, MAX_AGG_SNARKS, N_BLOB_BYTES, get_blob_bytes
from ..l2types.block_trace import BlockTrace
from ..prover.chunk_info import ChunkInfo, mock_padded_chunk_info_for_testing
from ..witness.capacity import CircuitCapacityChecker, RowUsage

log = logging.getLogger(__name__)


class ChunkBuilder:
    """Accumulate blocks; seal the chunk when CCC says the next block
    doesn't fit."""

    def __init__(self):
        self._ccc = CircuitCapacityChecker()
        self._blocks: list[BlockTrace] = []

    def add(self, trace: BlockTrace) -> list[BlockTrace] | None:
        """Returns a sealed chunk (list of blocks) when full, else None.
        The triggering block starts the next chunk."""
        usage = self._ccc.estimate_circuit_capacity(trace)
        if usage.is_ok or not self._blocks:
            if not usage.is_ok:
                log.warning(
                    "single block %d overflows a chunk (bottleneck %s); sealing solo",
                    trace.number, usage.bottleneck().to_json(),
                )
                self._ccc.reset()
                return [trace]
            self._blocks.append(trace)
            return None
        sealed = self._blocks
        log.info(
            "sealing chunk of %d blocks (bottleneck %s)",
            len(sealed), self._ccc.get_acc_row_usage().bottleneck().to_json(),
        )
        self._ccc.reset()
        self._ccc.estimate_circuit_capacity(trace)
        self._blocks = [trace]
        return sealed

    def flush(self) -> list[BlockTrace] | None:
        if not self._blocks:
            return None
        sealed = self._blocks
        self._blocks = []
        self._ccc.reset()
        return sealed


@dataclass
class BatchBuilder:
    """Accumulate chunk infos; seal on any overflow condition."""

    batch_index: int = 0
    chunks: list[ChunkInfo] = field(default_factory=list)

    def _would_overflow(self, infos: list[ChunkInfo]) -> bool:
        if len(infos) > MAX_AGG_SNARKS:
            return True
        bd = BatchData.new(len(infos), infos)
        raw = bd.get_batch_data_bytes()
        payload = sum(len(ci.tx_bytes) for ci in infos)
        if payload > bd.n_rows_data():  # uncompressed capacity
            return True
        try:
            blob = get_blob_bytes(raw)
        except AssertionError:
            return True
        return len(blob) > N_BLOB_BYTES

    def add(self, info: ChunkInfo) -> list[ChunkInfo] | None:
        """Returns the sealed batch's chunk infos when full, else None."""
        candidate = self.chunks + [info]
        if self._would_overflow(candidate):
            sealed = self.chunks
            log.info(
                "sealing batch %d with %d chunks", self.batch_index, len(sealed)
            )
            self.batch_index += 1
            self.chunks = [info]
            return sealed
        self.chunks = candidate
        return None

    def flush(self) -> list[ChunkInfo] | None:
        if not self.chunks:
            return None
        sealed = self.chunks
        self.chunks = []
        return sealed

    @staticmethod
    def padded(infos: list[ChunkInfo]) -> list[ChunkInfo]:
        out = list(infos)
        while len(out) < MAX_AGG_SNARKS:
            out.append(mock_padded_chunk_info_for_testing(out[-1]))
        return out
