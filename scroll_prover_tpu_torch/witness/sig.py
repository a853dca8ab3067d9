"""Signature witness: per-tx ECDSA events recovered from the trace.

For every signed L2 transaction the builder reconstructs the EIP-155/2718
signing hash from the trace fields (RLP re-encoding), recovers the public
key from (v, r, s), and cross-checks keccak(pubkey)[12:] against the
trace's `from` address — so each SigEvent carries a REAL, verified
(msg_hash, r, s, pubkey, address) tuple for the sig subcircuit
(reference scope: zkevm-circuits sig/tx circuits, SURVEY.md section 2.2).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..curves import secp256k1
from ..hashes.keccak import keccak256
from ..l2types.block_trace import TransactionTrace


def rlp_encode(item) -> bytes:
    """Minimal RLP: ints (big-endian minimal), bytes, nested lists."""
    if isinstance(item, int):
        item = b"" if item == 0 else item.to_bytes((item.bit_length() + 7) // 8, "big")
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _rlp_len(len(item), 0x80) + item
    payload = b"".join(rlp_encode(x) for x in item)
    return _rlp_len(len(payload), 0xC0) + payload


def _rlp_len(n: int, offset: int) -> bytes:
    if n < 56:
        return bytes([offset + n])
    nb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(nb)]) + nb


def _addr_bytes(a: str | None) -> bytes:
    return bytes.fromhex(a[2:]) if a and a.startswith("0x") else b""


def _access_list(al: list) -> list:
    out = []
    for e in al or []:
        out.append([
            _addr_bytes(e.get("address")),
            [bytes.fromhex(k[2:]) for k in (e.get("storageKeys") or [])],
        ])
    return out


def tx_sig_payload(tx: TransactionTrace) -> bytes:
    """The full signing payload (RLP bytes, with the EIP-2718 type prefix
    for typed txs) whose keccak is the signing hash."""
    to = _addr_bytes(tx.to_addr)
    data = tx.call_data
    if tx.type == 0:
        fields = [tx.nonce, tx.gas_price, tx.gas, to, tx.value, data]
        if tx.v >= 35:  # EIP-155
            fields += [tx.chain_id, 0, 0]
        return rlp_encode(fields)
    if tx.type == 1:
        body = [tx.chain_id, tx.nonce, tx.gas_price, tx.gas, to, tx.value,
                data, _access_list(tx.access_list)]
        return b"\x01" + rlp_encode(body)
    if tx.type == 2:
        body = [tx.chain_id, tx.nonce, tx.gas_tip_cap, tx.gas_fee_cap,
                tx.gas, to, tx.value, data, _access_list(tx.access_list)]
        return b"\x02" + rlp_encode(body)
    raise ValueError(f"unsupported signed tx type {tx.type}")


def tx_sig_hash(tx: TransactionTrace) -> bytes:
    """EIP-155 (type 0) / EIP-2930 (1) / EIP-1559 (2) signing hash."""
    return keccak256(tx_sig_payload(tx))


def recovery_parity(tx: TransactionTrace) -> int:
    """y-parity bit from the trace's v encoding."""
    if tx.type in (1, 2):
        return tx.v & 1
    if tx.v >= 35:
        return (tx.v - 35) & 1
    return (tx.v - 27) & 1


def pubkey_address(q: tuple[int, int]) -> int:
    pk = q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")
    return int.from_bytes(keccak256(pk)[12:], "big")


@dataclass
class SigEvent:
    msg_hash: int  # signing hash as a 256-bit int
    r: int
    s: int
    pubkey: tuple[int, int]
    address: int  # keccak(pubkey)[12:] — equals the trace's `from`


def tx_sig_event(tx: TransactionTrace) -> SigEvent | None:
    """Recover + verify one tx's signature; None for unsigned (L1 msg) or
    unrecoverable txs."""
    if tx.is_l1_msg:
        return None
    try:
        z = int.from_bytes(tx_sig_hash(tx), "big")
    except ValueError:
        return None
    r, s = int(tx.r, 16), int(tx.s, 16)
    q = secp256k1.ecrecover(z % secp256k1.N, recovery_parity(tx), r, s)
    if q is None:
        return None
    ev = SigEvent(z, r, s, q, pubkey_address(q))
    want = int(tx.from_addr, 16) if tx.from_addr.startswith("0x") else -1
    if ev.address != want:
        # synthetic/fuzzed traces carry fabricated signatures; a real trace
        # whose recovery diverges would be a sighash-encoding bug — tested
        # against every fixture tx in tests/test_sig_witness.py
        import logging

        logging.getLogger(__name__).warning(
            "sig recovery mismatch for tx %s (got %s) — event dropped",
            tx.tx_hash, hex(ev.address),
        )
        return None
    return ev


def block_sig_events(traces, cap: int | None = None) -> list[SigEvent]:
    """Signature events for a chunk's signed txs (first `cap` of them —
    the in-circuit verification capacity)."""
    out = []
    for trace in traces:
        for tx in trace.transactions:
            if cap is not None and len(out) >= cap:
                return out
            ev = tx_sig_event(tx)
            if ev is not None:
                out.append(ev)
    return out
