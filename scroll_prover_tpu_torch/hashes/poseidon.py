"""Poseidon permutation over BN254 Fr (host reference).

Parameters in the P128Pow5T3 family: width t=3 (rate 2), x^5 S-box, 8 full
rounds, 57 partial rounds; round constants and the Cauchy MDS matrix are
generated with the Grain LFSR procedure from the Poseidon reference design
(the same procedure halo2_gadgets/poseidon-base use), so the construction is
standard and reproducible from the parameters alone.

Role parity with the reference's poseidon crates (SURVEY.md section 2.2,
Cargo.lock:2927-2957): transcript hashing for SNARK layers 1-5, zktrie node
hashing, Poseidon code hash. The batched device kernel lives in
ops/poseidon_dev.py (hot path: zktrie / many-leaf hashing).
"""
from __future__ import annotations

from functools import lru_cache

from ..fields.bn254 import FR_MOD


class _Grain:
    """Grain LFSR stream from the Poseidon reference parameter generator."""

    def __init__(self, t: int, r_f: int, r_p: int, n: int = 254):
        bits = []

        def push(val: int, width: int):
            for i in reversed(range(width)):
                bits.append((val >> i) & 1)

        push(1, 2)      # field type: prime
        push(0, 4)      # s-box: power
        push(n, 12)     # field size in bits
        push(t, 12)
        push(r_f, 10)
        push(r_p, 10)
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._bit()

    def _bit(self) -> int:
        s = self.state
        # taps per the reference generator: b62 ^ b51 ^ b38 ^ b23 ^ b13 ^ b0
        # (b0 = oldest bit; register shifts left)
        new = s[0] ^ s[13] ^ s[23] ^ s[38] ^ s[51] ^ s[62]
        self.state = s[1:] + [new]
        return new

    def _sampled_bit(self) -> int:
        # rejection sampling: a 1 bit means the next bit is used
        while True:
            b1 = self._bit()
            b2 = self._bit()
            if b1:
                return b2

    def field_element(self, modulus: int, n_bits: int = 254) -> int:
        while True:
            v = 0
            for _ in range(n_bits):
                v = (v << 1) | self._sampled_bit()
            if v < modulus:
                return v


@lru_cache(maxsize=None)
def _constants(t: int, r_f: int, r_p: int, p: int):
    g = _Grain(t, r_f, r_p)
    rounds = r_f + r_p
    rc = [[g.field_element(p) for _ in range(t)] for _ in range(rounds)]
    # Cauchy MDS from fresh x/y vectors (securely regenerated on collision in
    # the reference procedure; collisions are cosmically unlikely here)
    xs = [g.field_element(p) for _ in range(t)]
    ys = [g.field_element(p) for _ in range(t)]
    mds = [[pow((xs[i] + ys[j]) % p, p - 2, p) for j in range(t)] for i in range(t)]
    return rc, mds


class Poseidon:
    """Poseidon permutation + sponge over a prime field."""

    def __init__(self, p: int = FR_MOD, t: int = 3, r_f: int = 8, r_p: int = 57):
        self.p, self.t, self.r_f, self.r_p = p, t, r_f, r_p
        self.rc, self.mds = _constants(t, r_f, r_p, p)

    def _sbox(self, x: int) -> int:
        p = self.p
        x2 = x * x % p
        x4 = x2 * x2 % p
        return x4 * x % p

    def permute(self, state: list[int]) -> list[int]:
        p, t = self.p, self.t
        assert len(state) == t
        s = [x % p for x in state]
        half = self.r_f // 2
        rnd = 0
        for phase, count in ((0, half), (1, self.r_p), (0, half)):
            for _ in range(count):
                c = self.rc[rnd]
                s = [(x + c[i]) % p for i, x in enumerate(s)]
                if phase == 0:
                    s = [self._sbox(x) for x in s]
                else:
                    s[0] = self._sbox(s[0])
                s = [
                    sum(self.mds[i][j] * s[j] for j in range(t)) % p
                    for i in range(t)
                ]
                rnd += 1
        return s

    def hash(self, inputs: list[int], capacity_tag: int | None = None) -> int:
        """Sponge hash, rate = t-1. capacity_tag seeds the capacity element
        (domain separation, e.g. zktrie domain values)."""
        rate = self.t - 1
        state = [0] * self.t
        if capacity_tag is not None:
            state[self.t - 1] = capacity_tag % self.p
        msg = [x % self.p for x in inputs]
        if not msg:
            msg = [0]
        for i in range(0, len(msg), rate):
            chunk = msg[i : i + rate]
            for j, v in enumerate(chunk):
                state[j] = (state[j] + v) % self.p
            state = self.permute(state)
        return state[0]

    def hash2(self, a: int, b: int, domain: int = 0) -> int:
        """2-to-1 compression (zktrie node hash shape)."""
        state = self.permute([a % self.p, b % self.p, domain % self.p])
        return state[0]


poseidon_fr = Poseidon()
