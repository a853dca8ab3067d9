"""BN254 (alt_bn128) field and curve parameters + host-side modular arithmetic.

Host reference layer (pure Python ints). The device layer lives in
ops/field_ops.py as limb-plane JAX arithmetic; this module is the ground truth
it is tested against, and also serves host-side logic (transcript hashing,
pairing-based verification, serialization).

Capability parity: the reference consumes `halo2curves::bn256::{Fr, Fq, G1,
G2, Bn256}` (reference: integration/src/prove.rs:1, SURVEY.md L0). BLS12-381
scalars (EIP-4844 blobs) are in fields/bls12_381.py.
"""
from __future__ import annotations

# --- BN254 parameters -------------------------------------------------------
# Base field modulus (Fq)
FQ_MOD = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# Scalar field modulus (Fr)
FR_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN parameter x: p(x), r(x) per the BN family; used by the pairing.
BN_X = 4965661367192848881

# Fr multiplicative generator and 2-adicity (matches halo2curves bn256::Fr:
# GENERATOR = 7, S = 28; needed for NTT roots of unity).
FR_GENERATOR = 7
FR_TWO_ADICITY = 28
# 2^28-th primitive root of unity: g^((r-1)/2^28)
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (FR_MOD - 1) >> FR_TWO_ADICITY, FR_MOD)

# Curve: y^2 = x^3 + 3 over Fq; G1 generator
CURVE_B = 3
G1_GEN = (1, 2)

# G2 over Fq2 = Fq[i]/(i^2+1): y^2 = x^3 + 3/(9+i)
G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)


class Fp:
    """Generic prime-field helper bound to a modulus (plain int ops)."""

    __slots__ = ("p",)

    def __init__(self, p: int):
        self.p = p

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError("inverse of 0")
        return pow(a, self.p - 2, self.p)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def sqrt(self, a: int) -> int | None:
        """Tonelli-Shanks square root; None if non-residue."""
        p = self.p
        a %= p
        if a == 0:
            return 0
        if pow(a, (p - 1) // 2, p) != 1:
            return None
        if p % 4 == 3:
            return pow(a, (p + 1) // 4, p)
        # general Tonelli-Shanks
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t, r = t * c % p, r * b % p
        return r

    def rand(self, rng) -> int:
        return rng.randrange(self.p)


Fq = Fp(FQ_MOD)
Fr = Fp(FR_MOD)
