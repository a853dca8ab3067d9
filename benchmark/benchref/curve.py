"""BN254 G1 (y^2 = x^3 + 3 over Fq) in Jacobian coordinates, plain ints."""
from __future__ import annotations

from .field import Q, R

G1 = (1, 2)


def on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - 3) % Q == 0


def _double(j):
    x, y, z = j
    if z == 0:
        return j
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) * (x + b) - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    return (x3, (e * (d - x3) - 8 * c) % Q, 2 * y * z % Q)


def _add(j1, j2):
    if j1[2] == 0:
        return j2
    if j2[2] == 0:
        return j1
    x1, y1, z1 = j1
    x2, y2, z2 = j2
    z1z1, z2z2 = z1 * z1 % Q, z2 * z2 % Q
    u1, u2 = x1 * z2z2 % Q, x2 * z1z1 % Q
    s1, s2 = y1 * z2 * z2z2 % Q, y2 * z1 * z1z1 % Q
    if u1 == u2:
        return _double(j1) if s1 == s2 else (1, 1, 0)
    h = (u2 - u1) % Q
    i = 4 * h * h % Q
    jj = h * i % Q
    r = 2 * (s2 - s1) % Q
    v = u1 * i % Q
    x3 = (r * r - jj - 2 * v) % Q
    y3 = (r * (v - x3) - 2 * s1 * jj) % Q
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % Q
    return (x3, y3, z3)


def mul(pt, k: int):
    """k * pt for an affine pt (None is the point at infinity); affine out."""
    k %= R
    acc = (1, 1, 0)
    if pt is not None:
        base = (pt[0], pt[1], 1)
        while k:
            if k & 1:
                acc = _add(acc, base)
            base = _double(base)
            k >>= 1
    if acc[2] == 0:
        return None
    zi = pow(acc[2], -1, Q)
    return (acc[0] * zi * zi % Q, acc[1] * zi * zi * zi % Q)
