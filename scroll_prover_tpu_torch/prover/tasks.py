"""Proving tasks (reference prover crate, SURVEY.md section 2.3):
ChunkProvingTask::new(Vec<BlockTrace>) + identifier(),
BatchProvingTask{chunk_proofs, batch_header, blob_bytes},
BundleProvingTask{batch_proofs}."""
from __future__ import annotations

from dataclasses import dataclass, field

from ..hashes.keccak import keccak256
from ..l2types.block_trace import BlockTrace


@dataclass
class ChunkProvingTask:
    block_traces: list[BlockTrace]

    @classmethod
    def new(cls, traces: list[BlockTrace]) -> "ChunkProvingTask":
        return cls(list(traces))

    def is_empty(self) -> bool:
        return not self.block_traces

    def identifier(self) -> str:
        """First-block-number-based id (used to name cached vks/proofs)."""
        if not self.block_traces:
            return "empty"
        return str(self.block_traces[0].number)


@dataclass
class BatchProvingTask:
    chunk_proofs: list  # list[ChunkProofV2]
    batch_header: object  # aggregator.BatchHeader
    blob_bytes: bytes

    def identifier(self) -> str:
        h = keccak256(
            b"".join(p.inner.proof[:32] for p in self.chunk_proofs)
            + self.blob_bytes[:64]
        )
        return h.hex()[:16]

    def to_json(self) -> dict:
        return {
            "chunk_proofs": [p.to_json() for p in self.chunk_proofs],
            "batch_header": self.batch_header.to_json(),
            "blob_bytes": "0x" + self.blob_bytes.hex(),
        }


@dataclass
class BundleProvingTask:
    batch_proofs: list  # list[BatchProofV2]

    def identifier(self) -> str:
        h = keccak256(b"".join(p.inner.proof[:32] for p in self.batch_proofs))
        return h.hex()[:16]
