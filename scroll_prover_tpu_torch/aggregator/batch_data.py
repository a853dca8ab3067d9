"""BatchData + blob byte codec.

Layout (decoded from the reference fixture batch-task-with-blob-raw.json,
SURVEY.md section 2.4):
  blob_bytes = envelope_byte || metadata || payload
  metadata   = u16_be num_valid_chunks || MAX_AGG_SNARKS x u32_be chunk_size
  payload    = concat(chunk_data)
  envelope   = 0x00 raw | 0x01 zstd-compressed(metadata || payload)
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..hashes.keccak import keccak256
from .constants import (
    ENVELOPE_RAW, ENVELOPE_ZSTD, MAX_AGG_SNARKS, N_BLOB_BYTES,
)
from ..native.zstd_codec import zstd_available, zstd_compress, zstd_decompress


@dataclass
class BatchData:
    """Metadata + concatenated chunk payloads for <= MAX_AGG_SNARKS chunks
    (reference aggregator::BatchData, consumed at
    bin/src/chain_prover.rs:36-44)."""

    num_valid_chunks: int
    chunk_sizes: list[int]
    chunk_data: list[bytes]

    @classmethod
    def new(cls, num_valid_chunks: int, chunk_infos: list) -> "BatchData":
        """chunk_infos: ChunkInfo-likes with .tx_bytes; padded chunks add
        empty payloads."""
        data = [bytes(ci.tx_bytes) for ci in chunk_infos[:num_valid_chunks]]
        sizes = [len(d) for d in data]
        while len(sizes) < MAX_AGG_SNARKS:
            sizes.append(0)
            data.append(b"")
        return cls(num_valid_chunks, sizes, data)

    def get_batch_data_bytes(self) -> bytes:
        out = bytearray(struct.pack(">H", self.num_valid_chunks))
        for s in self.chunk_sizes[:MAX_AGG_SNARKS]:
            out += struct.pack(">I", s)
        for d in self.chunk_data:
            out += d
        return bytes(out)

    def n_rows_data(self) -> int:
        """Blob-payload capacity bound for uncompressed data (reference
        overflow rule at bin/src/chain_prover.rs:90-94)."""
        return N_BLOB_BYTES - (1 + 2 + 4 * MAX_AGG_SNARKS)

    def data_hash(self) -> bytes:
        return keccak256(self.get_batch_data_bytes())

    @classmethod
    def parse(cls, batch_bytes: bytes) -> "BatchData":
        """Inverse of get_batch_data_bytes (verifier-side blob binding:
        decode the metadata and slice the per-chunk payload segments)."""
        meta = 2 + 4 * MAX_AGG_SNARKS
        assert len(batch_bytes) >= meta, "batch bytes shorter than metadata"
        (n,) = struct.unpack(">H", batch_bytes[:2])
        sizes = [
            struct.unpack(">I", batch_bytes[2 + 4 * i : 6 + 4 * i])[0]
            for i in range(MAX_AGG_SNARKS)
        ]
        assert 0 < n <= MAX_AGG_SNARKS, f"invalid num_valid_chunks {n}"
        assert all(sz == 0 for sz in sizes[n:]), "padded chunk with size"
        off = meta
        data = []
        for sz in sizes:
            data.append(batch_bytes[off : off + sz])
            off += sz
        assert off == len(batch_bytes), "trailing bytes after payload"
        return cls(n, sizes, data)


def get_blob_bytes(batch_bytes: bytes, compress: bool | None = None) -> bytes:
    """batch bytes (metadata||payload) -> enveloped blob bytes (reference
    aggregator::eip4844::get_blob_bytes, used at prove.rs:124)."""
    if compress is None:
        compress = zstd_available()
    if compress:
        body = zstd_compress(batch_bytes)
        blob = bytes([ENVELOPE_ZSTD]) + body
    else:
        blob = bytes([ENVELOPE_RAW]) + batch_bytes
    assert len(blob) <= N_BLOB_BYTES, (
        f"blob overflow: {len(blob)} > {N_BLOB_BYTES}"
    )
    return blob


def decode_blob_bytes(blob: bytes) -> bytes:
    """Inverse of get_blob_bytes -> batch bytes."""
    if not blob:
        return b""
    env, body = blob[0], blob[1:]
    if env == ENVELOPE_RAW:
        return body
    if env == ENVELOPE_ZSTD:
        return zstd_decompress(body)
    raise ValueError(f"unknown blob envelope {env}")
