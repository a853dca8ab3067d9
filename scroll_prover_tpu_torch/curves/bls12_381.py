"""BLS12-381 G1 arithmetic + blob KZG commitments (host).

Replaces the commitment side of the reference's c-kzg + blst linkage
(SURVEY.md section 2.2 native component #3): blob -> G1 commitment over the
Lagrange-basis SRS, point-evaluation witness, EIP-4844 48-byte compressed
encoding. Verification of the opening currently re-evaluates the blob
polynomial (the verifier holds the blob); the pairing-based check is the
remaining piece of this component.

Curve: y^2 = x^3 + 4 over Fq (381-bit); group order r = BLS_MODULUS.
"""
from __future__ import annotations

import hashlib

# field + curve parameters
Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
B = 4
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
# order-r G2 generator on the M-twist y^2 = x^3 + 4(1+u); coords are Fq2
# pairs (c0, c1) meaning c0 + c1*u. Derived by clearing the twist cofactor
# h2 = (q^2 + 1 + (3f - t2)/2)/r off the first curve point with x = 1 + u
# (any order-r generator serves our locally-generated SRS; a production
# deployment loads the ceremony's points instead — download_setup.sh role).
G2_GEN = (
    (
        0x4D1CC4AD56B68CDB595ADB46CAD2CC82E3D0DA9A75EF283B6BBD91DF14533E1A45128EC26F8AB25072DA969D7628B70,
        0x13A471D5149813B306FE76921CFF7BB8D5C03FDC24A613F3E7A7FB8DEB8097699751485A0BD2AD391718AAA4419CE75B,
    ),
    (
        0xA3D002CAC5C50EB9E97E8B62CA30FFC5BF5AAACEC121CDB63E19A5E358C4804439EDB98366C02FD2840C7B9004F8B99,
        0x1834907430540701FA8AA597F79E63960EC77037A7D9A06606C4C58BD8019969EDABB81B77FAE18489A80D47BAB79D25,
    ),
)


def _inv(a: int) -> int:
    return pow(a, Q - 2, Q)


def _jdouble(j):
    if j is None or j[2] == 0:
        return j
    x, y, z = j
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) * (x + b) % Q - a - c) % Q
    e = 3 * a % Q
    f = e * e % Q
    x3 = (f - 2 * d) % Q
    return (x3, (e * (d - x3) - 8 * c) % Q, 2 * y * z % Q)


def _jadd(j1, j2):
    if j1 is None or j1[2] == 0:
        return j2
    if j2 is None or j2[2] == 0:
        return j1
    x1, y1, z1 = j1
    x2, y2, z2 = j2
    z1z1 = z1 * z1 % Q
    z2z2 = z2 * z2 % Q
    u1 = x1 * z2z2 % Q
    u2 = x2 * z1z1 % Q
    s1 = y1 * z2 % Q * z2z2 % Q
    s2 = y2 * z1 % Q * z1z1 % Q
    if u1 == u2:
        if s1 != s2:
            return (0, 1, 0)
        return _jdouble(j1)
    h = (u2 - u1) % Q
    i = 4 * h * h % Q
    jj = h * i % Q
    r = 2 * (s2 - s1) % Q
    v = u1 * i % Q
    x3 = (r * r - jj - 2 * v) % Q
    y3 = (r * (v - x3) - 2 * s1 * jj) % Q
    z3 = ((z1 + z2) % Q) ** 2 % Q
    z3 = (z3 - z1z1 - z2z2) % Q * h % Q
    return (x3, y3, z3)


def _jaffine(j):
    if j is None or j[2] % Q == 0:
        return None
    zi = _inv(j[2])
    z2 = zi * zi % Q
    return (j[0] * z2 % Q, j[1] * z2 % Q * zi % Q)


def _jfrom(p):
    return None if p is None else (p[0], p[1], 1)


def g1_add(p1, p2):
    return _jaffine(_jadd(_jfrom(p1), _jfrom(p2)))


def g1_mul(p, k: int):
    k %= R
    j = _jfrom(p)
    acc = None
    while k:
        if k & 1:
            acc = _jadd(acc, j)
        j = _jdouble(j)
        k >>= 1
    return _jaffine(acc)


def g1_neg(p):
    return None if p is None else (p[0], (-p[1]) % Q)


def is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - B) % Q == 0


def g1_compress(p) -> bytes:
    """48-byte EIP-2537/BLS compressed encoding (c-kzg wire shape)."""
    if p is None:
        out = bytearray(48)
        out[0] = 0xC0
        return bytes(out)
    x, y = p
    flag_sign = 0x20 if y > (Q - 1) // 2 else 0
    header = 0x80 | flag_sign
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= header
    return bytes(out)


def g1_decompress(b: bytes):
    assert len(b) == 48
    if b[0] & 0x40:
        return None
    x = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:], "big")
    y2 = (pow(x, 3, Q) + B) % Q
    y = pow(y2, (Q + 1) // 4, Q)  # q ≡ 3 mod 4
    assert y * y % Q == y2, "not a square: invalid point"
    if (y > (Q - 1) // 2) != bool(b[0] & 0x20):
        y = (-y) % Q
    return (x, y)


class _FixedBase:
    """Multiples of one point by 8-bit windows: a table of d * 2^(8j) * P
    (d = 1..255, j = 0..31), then 32 additions per scalar in place of
    g1_mul's ~255 doublings and ~128 additions; the same points."""

    def __init__(self, p):
        self.rows = []
        base = _jfrom(p)
        for _ in range(32):
            row = [None, base]
            for _d in range(2, 256):
                row.append(_jadd(row[-1], base))
            self.rows.append(row)
            base = _jadd(row[128], row[128])  # 256 * base

    def __call__(self, k: int):
        k %= R
        acc = None
        j = 0
        while k:
            d = k & 0xFF
            if d:
                acc = _jadd(acc, self.rows[j][d])
            k >>= 8
            j += 1
        return _jaffine(acc)


class BlobKzg:
    """Toy-SRS blob KZG (Lagrange basis over the bit-reversed 4096 domain)."""

    def __init__(self, seed: bytes = b"spt-bls-srs"):
        from ..aggregator.blob import BLOB_WIDTH, ROOT_OF_UNITY_4096, _domain

        self.tau = int.from_bytes(hashlib.sha512(seed).digest(), "little") % R
        self._lagrange: list | None = None
        self._domain = _domain()
        self.width = BLOB_WIDTH

    def _lagrange_basis(self):
        """[L_i(tau)]*G over the bit-reversal-permuted domain."""
        if self._lagrange is not None:
            return self._lagrange
        n = self.width
        tau = self.tau
        vanish = (pow(tau, n, R) - 1) % R
        ninv = pow(n, -1, R)
        mul = _FixedBase(G1_GEN)
        pts = []
        for w in self._domain:
            denom = (tau - w) % R
            s = w * vanish % R * ninv % R * pow(denom, -1, R) % R
            pts.append(mul(s))
        self._lagrange = pts
        return pts

    def commit(self, coeffs: list[int]):
        """Evaluation-form blob -> G1 commitment (real MSM, Jacobian
        Pippenger with 8-bit windows)."""
        basis = self._lagrange_basis()
        pairs = [(pt, c % R) for pt, c in zip(basis, coeffs) if c % R and pt]
        if not pairs:
            return None
        acc = None
        cw = 8
        for w in reversed(range(256 // cw)):
            if acc is not None:
                for _ in range(cw):
                    acc = _jdouble(acc)
            buckets: dict[int, tuple] = {}
            for pt, s in pairs:
                d = (s >> (cw * w)) & ((1 << cw) - 1)
                if d:
                    buckets[d] = _jadd(buckets.get(d), _jfrom(pt))
            if buckets:
                running = total = None
                for d in range(max(buckets), 0, -1):
                    b = buckets.get(d)
                    if b is not None:
                        running = _jadd(running, b)
                    if running is not None:
                        total = _jadd(total, running)
                acc = _jadd(acc, total)
        return _jaffine(acc)

    def open_at(self, coeffs: list[int], z: int):
        """(y, W): evaluation + witness commitment for the quotient
        (f(X) - y) / (X - z) in evaluation form (standard EIP-4844 math)."""
        from ..aggregator.blob import barycentric_evaluate

        y = barycentric_evaluate(coeffs, z)
        # standard quotient q_i = (f_i - y) / (w_i - z)
        qs = [
            (coeffs[i] - y) % R * pow((self._domain[i] - z) % R, -1, R) % R
            if (self._domain[i] - z) % R
            else 0
            for i in range(self.width)
        ]
        return y, self.commit(qs)

    def verify_by_reeval(self, blob_coeffs: list[int], z: int, y: int) -> bool:
        from ..aggregator.blob import barycentric_evaluate

        return barycentric_evaluate(blob_coeffs, z) == y

    def tau_g2(self):
        """[tau]_2 — the only G2 element a verifier needs (c-kzg's
        kzg_settings.g2_values[1])."""
        from .bls12_381_pairing import g2_generator, g2_mul

        if not hasattr(self, "_tau_g2"):
            self._tau_g2 = g2_mul(g2_generator(), self.tau)
        return self._tau_g2

    def verify(self, commitment, z: int, y: int, proof) -> bool:
        """EIP-4844 verify_kzg_proof: e(W, [tau - z]_2) == e(C - [y]_1, G2)
        — a REAL BLS12-381 pairing check (reference c-kzg/blst linkage,
        SURVEY.md native component #3). Uses only [tau]_2 + group ops, as a
        ceremony-based verifier would."""
        from .bls12_381_pairing import (
            g2_add,
            g2_generator,
            g2_mul,
            pairing_check,
        )

        g2 = g2_generator()
        tau_minus_z = g2_add(self.tau_g2(), g2_mul(g2, (-int(z)) % R))
        c_minus_y = g1_add(commitment, g1_neg(g1_mul(G1_GEN, y % R)))
        return pairing_check(
            [(proof, tau_minus_z), (g1_neg(c_minus_y) if c_minus_y else None, g2)]
        )
