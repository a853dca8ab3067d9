"""ChunkInfo: the chunk-level public data (reference prover crate,
SURVEY.md section 2.3: `ChunkInfo{chain_id, prev_state_root,
post_state_root, withdraw_root, data_hash, is_padding, tx_bytes}`)."""
from __future__ import annotations

from dataclasses import dataclass, field

from ..witness.block import WitnessBlock


@dataclass
class ChunkInfo:
    chain_id: int
    prev_state_root: str
    post_state_root: str
    withdraw_root: str
    data_hash: str
    is_padding: bool = False
    tx_bytes: bytes = b""

    @classmethod
    def from_witness_block(cls, wb: WitnessBlock, is_padding: bool = False) -> "ChunkInfo":
        return cls(
            chain_id=wb.chain_id,
            prev_state_root=wb.prev_state_root,
            post_state_root=wb.post_state_root,
            withdraw_root=wb.withdraw_root,
            data_hash="0x" + wb.data_hash().hex(),
            is_padding=is_padding,
            tx_bytes=wb.tx_bytes,
        )

    def to_json(self) -> dict:
        return {
            "chain_id": self.chain_id,
            "prev_state_root": self.prev_state_root,
            "post_state_root": self.post_state_root,
            "withdraw_root": self.withdraw_root,
            "data_hash": self.data_hash,
            "is_padding": self.is_padding,
            "tx_bytes": "0x" + self.tx_bytes.hex(),
        }

    @classmethod
    def from_json(cls, d: dict) -> "ChunkInfo":
        tb = d.get("tx_bytes", "0x")
        return cls(
            chain_id=d["chain_id"],
            prev_state_root=d["prev_state_root"],
            post_state_root=d["post_state_root"],
            withdraw_root=d["withdraw_root"],
            data_hash=d["data_hash"],
            is_padding=d.get("is_padding", False),
            tx_bytes=bytes.fromhex(tb[2:]) if tb.startswith("0x") else b"",
        )


def mock_padded_chunk_info_for_testing(last: ChunkInfo) -> ChunkInfo:
    """Padding chunk: clone of the last real chunk with is_padding=true and
    no txs (reference integration/src/prove.rs:115-121)."""
    return ChunkInfo(
        chain_id=last.chain_id,
        prev_state_root=last.post_state_root,
        post_state_root=last.post_state_root,
        withdraw_root=last.withdraw_root,
        data_hash=last.data_hash,
        is_padding=True,
        tx_bytes=b"",
    )
