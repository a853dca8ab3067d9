"""Signed Ethereum transactions for the traffic generators, on plain
integers: RLP, secp256k1 signing (EIP-155, low s) and the sender's
address, written from the Yellow Paper and SEC 2."""
from __future__ import annotations

import hashlib

from benchref.keccak import keccak256

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)


def _add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    if a[0] == b[0]:
        if (a[1] + b[1]) % P == 0:
            return None
        lam = 3 * a[0] * a[0] * pow(2 * a[1], -1, P) % P
    else:
        lam = (b[1] - a[1]) * pow(b[0] - a[0], -1, P) % P
    x = (lam * lam - a[0] - b[0]) % P
    return x, (lam * (a[0] - x) - a[1]) % P


def _mul(k: int, pt=G):
    acc = None
    while k:
        if k & 1:
            acc = _add(acc, pt)
        pt = _add(pt, pt)
        k >>= 1
    return acc


def rlp(item) -> bytes:
    if isinstance(item, int):
        item = b"" if item == 0 else item.to_bytes((item.bit_length() + 7) // 8, "big")
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _len(len(item), 0x80) + item
    body = b"".join(rlp(x) for x in item)
    return _len(len(body), 0xC0) + body


def _len(n: int, offset: int) -> bytes:
    if n < 56:
        return bytes([offset + n])
    nb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(nb)]) + nb


def address(key: int) -> str:
    q = _mul(key)
    return "0x" + keccak256(q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big"))[12:].hex()


def sign_legacy(key: int, chain_id: int, nonce: int, gas_price: int, gas: int, to: str, value: int,
                data: bytes) -> dict:
    """v, r, s and the hash of an EIP-155 legacy transaction."""
    fields = [nonce, gas_price, gas, bytes.fromhex(to[2:]), value, data]
    z = int.from_bytes(keccak256(rlp(fields + [chain_id, 0, 0])), "big")
    k = int.from_bytes(hashlib.sha256(key.to_bytes(32, "big") + z.to_bytes(32, "big")).digest(), "big") % (N - 1) + 1
    pt = _mul(k)
    r = pt[0] % N
    s = pow(k, -1, N) * (z + r * key) % N
    parity = pt[1] & 1
    if s > N // 2:
        s, parity = N - s, parity ^ 1
    v = 35 + 2 * chain_id + parity
    return {"v": hex(v), "r": hex(r), "s": hex(s), "txHash": "0x" + keccak256(rlp(fields + [v, r, s])).hex()}
