"""Chunk tx_bytes scanner: split the concatenated signed-transaction RLP
stream of a ChunkInfo back into per-transaction byte lengths.

The reference's `ChunkInfo.tx_bytes` is the concatenation of every L2
transaction's signed encoding — legacy txs as one RLP list, typed (EIP-2930
/ EIP-1559) txs as `type_byte || rlp_list` (eth-types l2 tx encoding,
SURVEY.md section 2.3 Data/DA). CCC parity estimation
(`capacity.row_usage_from_chunk_stats`) needs only the transaction count
and total byte size, both recoverable with a plain RLP length scan — no
signature or field decoding required.
"""
from __future__ import annotations


def _rlp_item_len(b: bytes, i: int) -> int:
    """Total encoded length (prefix included) of the RLP item at offset i."""
    p = b[i]
    if p < 0x80:
        return 1
    if p < 0xB8:
        return 1 + (p - 0x80)
    if p < 0xC0:
        ll = p - 0xB7
        return 1 + ll + int.from_bytes(b[i + 1 : i + 1 + ll], "big")
    if p < 0xF8:
        return 1 + (p - 0xC0)
    ll = p - 0xF7
    return 1 + ll + int.from_bytes(b[i + 1 : i + 1 + ll], "big")


def scan_tx_lengths(b: bytes) -> list[int]:
    """Per-transaction byte lengths of a chunk tx_bytes stream.

    Raises ValueError if the stream does not partition exactly.
    """
    out: list[int] = []
    i = 0
    n = len(b)
    while i < n:
        # typed transaction envelope: 0x01 (2930) / 0x02 (1559) / 0x7e (L1)
        if b[i] <= 0x7E and b[i] >= 0x01 and b[i] < 0xC0:
            ln = 1 + _rlp_item_len(b, i + 1)
        else:
            ln = _rlp_item_len(b, i)
        if ln <= 0 or i + ln > n:
            raise ValueError(f"tx_bytes scan failed at offset {i}")
        out.append(ln)
        i += ln
    return out
