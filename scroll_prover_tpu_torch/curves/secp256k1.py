"""secp256k1 host arithmetic + ECDSA verify/recover.

Host twin of the sig-circuit gadget (reference scope: the zkevm sig
circuit's ECDSA verification over secp256k1 via halo2-ecc, SURVEY.md
section 2.2). Affine arithmetic over Python ints — witness generation and
cross-checking only; the in-circuit side lives in gadgets/ecdsa.py.
"""
from __future__ import annotations

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
B = 7
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (GX, GY)

Point = tuple[int, int] | None  # None = identity


def is_on_curve(pt: Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


def add(p1: Point, p2: Point) -> Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def mul(pt: Point, k: int) -> Point:
    k %= N
    acc: Point = None
    while k:
        if k & 1:
            acc = add(acc, pt)
        pt = add(pt, pt)
        k >>= 1
    return acc


def lift_x(x: int, odd_y: bool) -> Point:
    """Curve point with the given x and y parity, or None."""
    y2 = (pow(x, 3, P) + B) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if (y & 1) != odd_y:
        y = P - y
    return (x, y)


def ecdsa_verify(z: int, r: int, s: int, q: Point) -> bool:
    if not (0 < r < N and 0 < s < N) or q is None or not is_on_curve(q):
        return False
    w = pow(s, -1, N)
    u1, u2 = z * w % N, r * w % N
    pt = add(mul(G, u1), mul(q, u2))
    return pt is not None and pt[0] % N == r


def ecrecover(z: int, v: int, r: int, s: int) -> Point:
    """Recovered public key, or None. v in {0, 1} (y parity; callers
    normalize 27/28 and EIP-155 encodings first)."""
    if not (0 < r < N and 0 < s < N):
        return None
    rp = lift_x(r, bool(v & 1))
    if rp is None:
        return None
    r_inv = pow(r, -1, N)
    # Q = r^-1 (s*R - z*G)
    s_r = mul(rp, s)
    z_g = mul(G, z)
    q = mul(add(s_r, (z_g[0], P - z_g[1]) if z_g else None), r_inv)
    if q is None or not ecdsa_verify(z, r, s, q):
        return None
    return q


# --- GLV endomorphism (in-circuit ECDSA cost halver, gadgets/ecdsa.py) ------
# phi(x, y) = (BETA*x, y) satisfies phi(P) = LAMBDA*P; constants from the
# curve's CM structure (BETA^3 = 1 mod P, LAMBDA^3 = 1 mod N).
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
_G1A = 0x3086D221A7D46BCDE86C90E49284EB15
_G1B = -0xE4437ED6010E88286F547FA90ABFE4C3
_G2A = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
_G2B = _G1A


def glv_split(u: int) -> tuple[int, int]:
    """u mod N -> (k1, k2) with u ≡ k1 + k2*LAMBDA (mod N) and
    |k1|, |k2| <= 2^128 (round-to-nearest lattice reduction)."""
    u = u % N
    c1 = (_G2B * u + N // 2) // N
    c2 = (-_G1B * u + N // 2) // N
    k1 = u - c1 * _G1A - c2 * _G2A
    k2 = -c1 * _G1B - c2 * _G2B
    assert (k1 + k2 * LAMBDA - u) % N == 0
    assert abs(k1).bit_length() <= 128 and abs(k2).bit_length() <= 128
    return k1, k2
