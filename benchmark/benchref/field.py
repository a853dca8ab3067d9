"""BN254 constants and plain field arithmetic on Python integers.

The constants are the published ones of alt_bn128 (EIP-196/197) and of
halo2curves' bn256::Fr (multiplicative generator 7, two-adicity 28).
"""
from __future__ import annotations

import numpy as np

# base field Fq and scalar field Fr
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
GENERATOR = 7
TWO_ADICITY = 28
ROOT_OF_UNITY = pow(GENERATOR, (R - 1) >> TWO_ADICITY, R)  # of order 2^28

MONT_R = 1 << 256  # Montgomery radix of the port's 16 x 16-bit limbs
MONT_R_INV = pow(MONT_R, -1, R)


def omega(n: int) -> int:
    """The primitive n-th root of unity of Fr (n a power of two <= 2^28)."""
    k = n.bit_length() - 1
    assert n == 1 << k and k <= TWO_ADICITY
    return pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - k), R)


def limbs_to_ints(arr) -> list[int]:
    """(n, 16) 16-bit limbs, little-endian, in any integer dtype -> ints."""
    a = np.ascontiguousarray(np.asarray(arr).astype(np.uint16))
    buf = a.tobytes()
    return [int.from_bytes(buf[i:i + 32], "little") for i in range(0, len(buf), 32)]


def horner(coeffs: list[int], z: int, p: int = R) -> int:
    """sum_j coeffs[j] z^j mod p."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % p
    return acc


def batch_inverse(xs: list[int], p: int = R) -> list[int]:
    """Inverses of non-zero xs with one exponentiation (Montgomery's trick)."""
    prefix = [1] * (len(xs) + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % p
    inv = pow(prefix[-1], -1, p)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = inv * prefix[i] % p
        inv = inv * xs[i] % p
    return out
