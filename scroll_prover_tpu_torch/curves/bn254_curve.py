"""Host-side BN254 group arithmetic (affine, plain ints).

Ground truth for the device EC kernels (ops/ec.py, ops/msm.py) and the
verifier's pairing-side point handling. Mirrors the consumed surface of
halo2curves bn256 (reference: integration/src/prove.rs:1; SURVEY.md L0).

G1: y^2 = x^3 + 3 over Fq.           Points: (x, y) tuples or None = infinity.
G2: y^2 = x^3 + 3/(9+u) over Fq2.    Fq2 elements: (c0, c1) = c0 + c1*u.
"""
from __future__ import annotations

from ..fields.bn254 import FQ_MOD, FR_MOD, G2_GEN_X, G2_GEN_Y

P = FQ_MOD
R = FR_MOD

# b' = 3 / (9 + u) in Fq2 for the G2 twist curve
def _fq2_inv(a):
    c0, c1 = a
    t = pow((c0 * c0 + c1 * c1) % P, P - 2, P)
    return (c0 * t % P, (-c1 * t) % P)


def _fq2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def _fq2_scalar(a, k):
    return (a[0] * k % P, a[1] * k % P)


TWIST_B = _fq2_scalar(_fq2_inv((9, 1)), 3)  # 3/(9+u)


class _Group:
    """Generic short-Weierstrass affine group over a field interface."""

    def __init__(self, add, sub, mul, inv, b, zero, name):
        self.fadd, self.fsub, self.fmul, self.finv = add, sub, mul, inv
        self.b = b
        self.fzero = zero
        self.name = name

    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        lhs = self.fmul(y, y)
        rhs = self.fadd(self.fmul(self.fmul(x, x), x), self.b)
        return lhs == rhs

    def neg(self, pt):
        if pt is None:
            return None
        x, y = pt
        return (x, self.fsub(self.fzero, y))

    def double(self, pt):
        if pt is None:
            return None
        x, y = pt
        if y == self.fzero:
            return None
        # l = 3x^2 / 2y
        num = self.fmul(self.fmul(x, x), self._three)
        den = self.finv(self.fadd(y, y))
        l = self.fmul(num, den)
        x3 = self.fsub(self.fmul(l, l), self.fadd(x, x))
        y3 = self.fsub(self.fmul(l, self.fsub(x, x3)), y)
        return (x3, y3)

    def add(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        if x1 == x2:
            if y1 == y2:
                return self.double(p1)
            return None
        l = self.fmul(self.fsub(y2, y1), self.finv(self.fsub(x2, x1)))
        x3 = self.fsub(self.fsub(self.fmul(l, l), x1), x2)
        y3 = self.fsub(self.fmul(l, self.fsub(x1, x3)), y1)
        return (x3, y3)

    def mul(self, pt, k: int):
        k %= R
        acc = None
        while k:
            if k & 1:
                acc = self.add(acc, pt)
            pt = self.double(pt)
            k >>= 1
        return acc


def _mk_g1():
    g = _Group(
        add=lambda a, b: (a + b) % P,
        sub=lambda a, b: (a - b) % P,
        mul=lambda a, b: a * b % P,
        inv=lambda a: pow(a, P - 2, P),
        b=3,
        zero=0,
        name="G1",
    )
    g._three = 3
    return g


def _mk_g2():
    g = _Group(
        add=lambda a, b: ((a[0] + b[0]) % P, (a[1] + b[1]) % P),
        sub=lambda a, b: ((a[0] - b[0]) % P, (a[1] - b[1]) % P),
        mul=_fq2_mul,
        inv=_fq2_inv,
        b=TWIST_B,
        zero=(0, 0),
        name="G2",
    )
    g._three = (3, 0)
    return g


G1 = _mk_g1()
G2 = _mk_g2()


def g1_generator():
    return (1, 2)


def g2_generator():
    return (G2_GEN_X, G2_GEN_Y)


def msm_naive(points, scalars):
    """Host reference MSM: sum scalars[i] * points[i] over G1."""
    acc = None
    for pt, s in zip(points, scalars):
        acc = G1.add(acc, G1.mul(pt, s))
    return acc


# --- Jacobian host arithmetic (no per-op inversion; ~8x faster than affine)


def jac_from_affine(pt):
    return None if pt is None else (pt[0], pt[1], 1)


def jac_to_affine(j):
    if j is None or j[2] == 0:
        return None
    zinv = pow(j[2], P - 2, P)
    z2 = zinv * zinv % P
    return (j[0] * z2 % P, j[1] * z2 % P * zinv % P)


def jac_double(j):
    if j is None or j[2] == 0:
        return j
    x, y, z = j
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) % P - a - c) % P
    e = 3 * a % P
    f = e * e % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y * z % P
    return (x3, y3, z3)


def jac_add(j1, j2):
    if j1 is None or j1[2] == 0:
        return j2
    if j2 is None or j2[2] == 0:
        return j1
    x1, y1, z1 = j1
    x2, y2, z2 = j2
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 % P * z2z2 % P
    s2 = y2 * z1 % P * z1z1 % P
    if u1 == u2:
        if s1 != s2:
            return (0, 1, 0)
        return jac_double(j1)
    h = (u2 - u1) % P
    i = 4 * h * h % P
    jj = h * i % P
    r = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (r * r - jj - 2 * v) % P
    y3 = (r * (v - x3) - 2 * s1 * jj) % P
    z3 = (z1 + z2) % P
    z3 = (z3 * z3 - z1z1 - z2z2) % P * h % P
    return (x3, y3, z3)


def jac_add_affine(j, pt):
    """Mixed addition j + affine pt."""
    if pt is None:
        return j
    return jac_add(j, (pt[0], pt[1], 1))


def jac_mul(pt, k: int):
    k %= R
    j = jac_from_affine(pt)
    acc = None
    while k:
        if k & 1:
            acc = jac_add(acc, j)
        j = jac_double(j)
        k >>= 1
    return acc


def host_msm_jac(points, scalars, c: int = 8):
    """Host Pippenger over Jacobian coordinates; returns affine (or None)."""
    nw = 256 // c
    acc = None
    for w in reversed(range(nw)):
        if acc is not None:
            for _ in range(c):
                acc = jac_double(acc)
        buckets: dict[int, tuple] = {}
        for pt, s in zip(points, scalars):
            if pt is None:
                continue
            d = (int(s) >> (c * w)) & ((1 << c) - 1)
            if d:
                buckets[d] = jac_add_affine(buckets.get(d), pt)
        if buckets:
            running = None
            total = None
            for d in range(max(buckets), 0, -1):
                b = buckets.get(d)
                if b is not None:
                    running = jac_add(running, b)
                total = jac_add(total, running) if running is not None else total
            acc = jac_add(acc, total)
    return jac_to_affine(acc)
