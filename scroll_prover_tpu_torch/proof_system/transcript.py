"""Fiat-Shamir transcripts (host).

Three flavors, mirroring the reference stack's usage (SURVEY.md L1/L2):
  * PoseidonTranscript — SNARK layers (in-circuit-friendly; the reference's
    snark-verifier uses Poseidon for layers 1-5, SURVEY.md section 2.2).
  * KeccakTranscript — the EVM-facing final layer (layer6 "Keccak
    transcript", SURVEY.md section 3.2) and the YUL verifier.
  * Blake2bTranscript — halo2's native Blake2bWrite/Read equivalent.

Each has a writer mode (prover: absorb + emit bytes into a proof blob) and a
reader mode (verifier: re-absorb from the blob). Proof wire format:
  * Fr scalar: 32 bytes LE
  * G1 point: 64 bytes (x || y, each 32B LE, standard form); identity is
    64 zero bytes.
"""
from __future__ import annotations

import hashlib

from ..fields.bn254 import FQ_MOD, FR_MOD
from ..hashes.keccak import keccak256
from ..hashes.poseidon import Poseidon


def fr_from_bytes_wide(b: bytes) -> int:
    return int.from_bytes(b, "little") % FR_MOD


def encode_point(pt) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return pt[0].to_bytes(32, "little") + pt[1].to_bytes(32, "little")


def decode_point(b: bytes):
    x = int.from_bytes(b[:32], "little")
    y = int.from_bytes(b[32:], "little")
    if x == 0 and y == 0:
        return None
    assert x < FQ_MOD and y < FQ_MOD, "point coordinates out of range"
    assert (y * y - x * x * x - 3) % FQ_MOD == 0, "point not on curve"
    return (x, y)


class _TranscriptBase:
    """Shared writer/reader plumbing over an absorb/squeeze core."""

    def __init__(self, proof: bytes | None = None):
        self._buf = bytearray()
        self._read = memoryview(proof) if proof is not None else None
        self._pos = 0

    # -- wire I/O ---------------------------------------------------------
    def write_point(self, pt):
        assert self._read is None
        self.common_point(pt)
        self._buf += encode_point(pt)

    def write_scalar(self, s: int):
        assert self._read is None
        self.common_scalar(s)
        self._buf += (s % FR_MOD).to_bytes(32, "little")

    def read_point(self):
        b = bytes(self._read[self._pos : self._pos + 64])
        self._pos += 64
        pt = decode_point(b)
        self.common_point(pt)
        return pt

    def read_scalar(self) -> int:
        b = bytes(self._read[self._pos : self._pos + 32])
        self._pos += 32
        s = int.from_bytes(b, "little")
        assert s < FR_MOD, "scalar out of range"
        self.common_scalar(s)
        return s

    def finalize(self) -> bytes:
        return bytes(self._buf)

    # subclasses: common_point, common_scalar, squeeze_challenge


class PoseidonTranscript(_TranscriptBase):
    """Duplex Poseidon sponge over Fr (t=3, rate 2)."""

    def __init__(self, proof: bytes | None = None, domain: int = 0):
        super().__init__(proof)
        self._h = Poseidon()
        self._state = [0, 0, domain % FR_MOD]
        self._queue: list[int] = []

    def _absorb(self, v: int):
        self._queue.append(v % FR_MOD)

    def _drain(self):
        rate = 2
        q = self._queue
        for i in range(0, len(q), rate):
            chunk = q[i : i + rate]
            for j, v in enumerate(chunk):
                self._state[j] = (self._state[j] + v) % FR_MOD
            self._state = self._h.permute(self._state)
        self._queue = []

    def common_point(self, pt):
        if pt is None:
            self._absorb(0)
            self._absorb(0)
            self._absorb(0)
            self._absorb(0)
            return
        for coord in pt:
            self._absorb(coord & ((1 << 128) - 1))
            self._absorb(coord >> 128)

    def common_scalar(self, s: int):
        self._absorb(s)

    def squeeze_challenge(self) -> int:
        self._absorb(1)  # padding/separation marker before squeeze
        self._drain()
        return self._state[0]


class KeccakTranscript(_TranscriptBase):
    """EVM-friendly transcript: challenge = keccak256(running state)."""

    def __init__(self, proof: bytes | None = None):
        super().__init__(proof)
        self._state = bytearray()

    def common_point(self, pt):
        if pt is None:
            self._state += b"\x00" * 64
        else:
            # big-endian coords, as EVM calldata words
            self._state += pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")

    def common_scalar(self, s: int):
        self._state += (s % FR_MOD).to_bytes(32, "big")

    def squeeze_challenge(self) -> int:
        d = keccak256(bytes(self._state))
        c = int.from_bytes(d, "big") % FR_MOD
        self._state = bytearray(d)
        return c


class Blake2bTranscript(_TranscriptBase):
    """halo2 Blake2bWrite-shaped transcript (personalized, 512-bit squeeze)."""

    PERSONA = b"Halo2-Transcript"

    def __init__(self, proof: bytes | None = None):
        super().__init__(proof)
        self._h = hashlib.blake2b(person=self.PERSONA)

    def common_point(self, pt):
        self._h.update(b"\x00")
        self._h.update(encode_point(pt))

    def common_scalar(self, s: int):
        self._h.update(b"\x01")
        self._h.update((s % FR_MOD).to_bytes(32, "little"))

    def squeeze_challenge(self) -> int:
        self._h.update(b"\x02")
        d = self._h.copy().digest()  # 64 bytes
        c = fr_from_bytes_wide(d)
        self._h.update(d[:32])
        return c
