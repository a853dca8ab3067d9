"""Keccak-256 (the pre-NIST padding variant used by Ethereum).

Host implementation of Keccak-f[1600] + sponge with rate 1088, pad 0x01.
Python's hashlib sha3_256 uses the NIST 0x06 padding and therefore does NOT
match Ethereum; this does.

Used for: batch data hashes, BatchHeader.batch_hash, the layer-6 EVM
transcript (SURVEY.md section 3.2: "layer6 CompressionCircuit, Keccak
transcript"), and address/code hashing in witness generation.
"""
from __future__ import annotations

from ..trace import spanned

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


def _rol(x: int, s: int) -> int:
    return ((x << s) | (x >> (64 - s))) & _MASK


def keccak_f(state: list[int]) -> list[int]:
    """Keccak-f[1600] on a 5x5 lane list (state[x + 5*y])."""
    a = state
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[x + 5 * y] ^ d[x] for y in range(5) for x in range(5)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y], _ROTATIONS[x][y])
        # chi
        a = [
            b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]) & _MASK
            for y in range(5)
            for x in range(5)
        ]
        # iota
        a[0] ^= rc
    return a


def keccak_f_trace(state: list[int]) -> tuple[list[list[int]], list[list[int]]]:
    """Per-round witness states for the keccak-f subcircuit:
    (states, thetas) with states[r] = 25-lane state entering round r
    (states[24] = permutation output) and thetas[r] = states[r] after the
    theta step (pre-rho/pi/chi) — the two materialized row blocks."""
    a = list(state)
    states = [list(a)]
    thetas = []
    for rc in _ROUND_CONSTANTS:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[x + 5 * y] ^ d[x] for y in range(5) for x in range(5)]
        thetas.append(list(a))
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y], _ROTATIONS[x][y])
        a = [
            b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]) & _MASK
            for y in range(5)
            for x in range(5)
        ]
        a[0] ^= rc
        states.append(list(a))
    return states, thetas


def chi_sources(x: int, y: int) -> list[tuple[int, int]]:
    """For chi output lane (x, y): the three (src_lane, rotation) pairs
    whose rho/pi images are b[(x,y)], b[(x+1,y)], b[(x+2,y)] — bit z of
    b = bit (z - rot) mod 64 of the post-theta src lane."""
    out = []
    for i in ((x, y), ((x + 1) % 5, y), ((x + 2) % 5, y)):
        bx, by = i
        yp = bx
        xp = (by - 3 * bx) * 3 % 5  # inverse of j = (2x + 3y) mod 5
        out.append((xp + 5 * yp, _ROTATIONS[xp][yp]))
    return out


def pad_blocks(data: bytes, rate: int = 136) -> list[bytes]:
    """pad10*1 (Ethereum 0x01 domain) message blocks."""
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x00" * pad_len
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    return [bytes(padded[o : o + rate]) for o in range(0, len(padded), rate)]


ROUND_CONSTANTS = _ROUND_CONSTANTS


@spanned("keccak")
def keccak256(data: bytes) -> bytes:
    rate = 136  # bytes (1088 bits)
    # pad10*1 with the 0x01 domain byte (Ethereum Keccak)
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x00" * pad_len
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80

    state = [0] * 25
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out
