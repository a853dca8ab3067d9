"""BatchHeader: the versioned on-chain batch commitment header.

Field set mirrors the reference (SURVEY.md section 2.3:
`BatchHeader::<N>{version, batch_index, l1_message_popped,
total_l1_message_popped, data_hash, blob_versioned_hash, parent_batch_hash,
last_block_timestamp, blob_data_proof}` + `construct_from_chunks` +
`batch_hash()`, used at integration/tests/e2e_tests.rs:217-228).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..hashes.keccak import keccak256
from .blob import point_evaluation, blob_versioned_hash


@dataclass
class BatchHeader:
    version: int
    batch_index: int
    l1_message_popped: int
    total_l1_message_popped: int
    data_hash: bytes
    blob_versioned_hash: bytes
    parent_batch_hash: bytes
    last_block_timestamp: int
    blob_data_proof: tuple[int, int]  # (z, y)

    @classmethod
    def construct_from_chunks(
        cls,
        version: int,
        batch_index: int,
        l1_message_popped: int,
        total_l1_message_popped: int,
        parent_batch_hash: bytes,
        last_block_timestamp: int,
        chunk_infos: list,
        blob_bytes: bytes,
    ) -> "BatchHeader":
        # batch data hash = keccak(concat(chunk data hashes)) over real chunks
        preimage = b"".join(
            bytes.fromhex(ci.data_hash[2:]) for ci in chunk_infos if not ci.is_padding
        )
        data_hash = keccak256(preimage)
        z, y = point_evaluation(blob_bytes, data_hash)
        return cls(
            version=version,
            batch_index=batch_index,
            l1_message_popped=l1_message_popped,
            total_l1_message_popped=total_l1_message_popped,
            data_hash=data_hash,
            blob_versioned_hash=blob_versioned_hash(blob_bytes),
            parent_batch_hash=parent_batch_hash,
            last_block_timestamp=last_block_timestamp,
            blob_data_proof=(z, y),
        )

    def encode(self) -> bytes:
        """Canonical byte encoding (hashed by batch_hash)."""
        out = bytearray()
        out.append(self.version)
        out += self.batch_index.to_bytes(8, "big")
        out += self.l1_message_popped.to_bytes(8, "big")
        out += self.total_l1_message_popped.to_bytes(8, "big")
        out += self.data_hash
        out += self.blob_versioned_hash
        out += self.parent_batch_hash
        out += self.last_block_timestamp.to_bytes(8, "big")
        out += self.blob_data_proof[0].to_bytes(32, "big")
        out += self.blob_data_proof[1].to_bytes(32, "big")
        return bytes(out)

    def batch_hash(self) -> bytes:
        return keccak256(self.encode())

    def to_json(self) -> dict:
        return {
            "version": self.version,
            "batch_index": self.batch_index,
            "l1_message_popped": self.l1_message_popped,
            "total_l1_message_popped": self.total_l1_message_popped,
            "data_hash": "0x" + self.data_hash.hex(),
            "blob_versioned_hash": "0x" + self.blob_versioned_hash.hex(),
            "parent_batch_hash": "0x" + self.parent_batch_hash.hex(),
            "last_block_timestamp": self.last_block_timestamp,
            "blob_data_proof": [
                hex(self.blob_data_proof[0]),
                hex(self.blob_data_proof[1]),
            ],
        }

    @classmethod
    def from_json(cls, d: dict) -> "BatchHeader":
        return cls(
            version=d["version"],
            batch_index=d["batch_index"],
            l1_message_popped=d["l1_message_popped"],
            total_l1_message_popped=d["total_l1_message_popped"],
            data_hash=bytes.fromhex(d["data_hash"][2:]),
            blob_versioned_hash=bytes.fromhex(d["blob_versioned_hash"][2:]),
            parent_batch_hash=bytes.fromhex(d["parent_batch_hash"][2:]),
            last_block_timestamp=d["last_block_timestamp"],
            blob_data_proof=(
                int(d["blob_data_proof"][0], 16),
                int(d["blob_data_proof"][1], 16),
            ),
        )
