"""BN254 optimal-ate pairing (host, plain ints).

Verify-side only: the prover never pairs (KZG openings are MSMs); the
verifier's final check is a product-of-pairings == 1. Mirrors the consumed
surface of halo2curves' Bn256 engine (reference: integration/src/prove.rs:1,
SURVEY.md L0 "pairings (verify-side)").

Tower: Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - xi) with xi = 9+u,
Fq12 = Fq6[w]/(w^2 - v). G2 is the D-type sextic twist y^2 = x^3 + 3/xi;
untwist (x', y') -> (x'*w^2, y'*w^3) lands on E(Fq12).

Generic (non-sparse) line functions + a full final exponentiation by
(p^12-1)/r: correctness-first; the verifier is host-side and cold.
"""
from __future__ import annotations

from ..fields.bn254 import BN_X, FQ_MOD, FR_MOD

P = FQ_MOD
ATE_LOOP = 6 * BN_X + 2

# ---- Fq2 ---------------------------------------------------------------------


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def f2_inv(a):
    t = pow((a[0] * a[0] + a[1] * a[1]) % P, P - 2, P)
    return (a[0] * t % P, (-a[1] * t) % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)

# ---- Fq6 = Fq2[v]/(v^3 - xi): 3-tuples of Fq2 --------------------------------


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def _mul_xi(a):
    return f2_mul(a, XI)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, _mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), _mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_mul_v(a):
    """a * v  (v^3 = xi)."""
    return (_mul_xi(a[2]), a[0], a[1])


def f6_neg(a):
    return tuple(f2_sub(F2_ZERO, x) for x in a)


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_mul(a0, a0), _mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(_mul_xi(f2_mul(a2, a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_mul(a1, a1), f2_mul(a0, a2))
    t = f2_add(
        f2_mul(a0, c0), _mul_xi(f2_add(f2_mul(a2, c1), f2_mul(a1, c2)))
    )
    ti = f2_inv(t)
    return (f2_mul(c0, ti), f2_mul(c1, ti), f2_mul(c2, ti))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)

# ---- Fq12 = Fq6[w]/(w^2 - v): pairs of Fq6 -----------------------------------


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    c0 = f6_add(t0, f6_mul_v(t1))
    return (c0, c1)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_neg(a):
    return (f6_neg(a[0]), f6_neg(a[1]))


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    a0, a1 = a
    t = f6_inv(f6_sub(f6_mul(a0, a0), f6_mul_v(f6_mul(a1, a1))))
    return (f6_mul(a0, t), f6_neg(f6_mul(a1, t)))


def f12_pow(a, e: int):
    if e < 0:
        return f12_pow(f12_inv(a), -e)
    acc = F12_ONE
    for bit in bin(e)[2:]:
        acc = f12_sqr(acc)
        if bit == "1":
            acc = f12_mul(acc, a)
    return acc


F12_ZERO = (F6_ZERO, F6_ZERO)
F12_ONE = (F6_ONE, F6_ZERO)


def f12_from_fq(x: int):
    return (((x % P, 0), F2_ZERO, F2_ZERO), F6_ZERO)


def f12_from_fq2_w2(x):
    """x * w^2 = x * v for x in Fq2: Fq6 slot (0, x, 0) in c0."""
    return ((F2_ZERO, x, F2_ZERO), F6_ZERO)


def f12_from_fq2_w3(x):
    """x * w^3 = (x*v) * w: Fq6 slot (0, x, 0) in c1."""
    return (F6_ZERO, (F2_ZERO, x, F2_ZERO))


# ---- points on E(Fq12) -------------------------------------------------------


def _pt_neg(pt):
    if pt is None:
        return None
    return (pt[0], f12_neg(pt[1]))


def _pt_double(pt):
    x, y = pt
    l = f12_mul(
        f12_mul(f12_from_fq(3), f12_sqr(x)), f12_inv(f12_add(y, y))
    )
    x3 = f12_sub(f12_sqr(l), f12_add(x, x))
    y3 = f12_sub(f12_mul(l, f12_sub(x, x3)), y)
    return (x3, y3)


def _pt_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return _pt_double(p1)
        return None
    l = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    x3 = f12_sub(f12_sub(f12_sqr(l), x1), x2)
    y3 = f12_sub(f12_mul(l, f12_sub(x1, x3)), y1)
    return (x3, y3)


def _linefunc(p1, p2, t):
    """Value at t of the line through p1, p2 (or tangent if p1 == p2)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
        return f12_sub(f12_mul(m, f12_sub(xt, x1)), f12_sub(yt, y1))
    if y1 == y2:
        m = f12_mul(f12_mul(f12_from_fq(3), f12_sqr(x1)), f12_inv(f12_add(y1, y1)))
        return f12_sub(f12_mul(m, f12_sub(xt, x1)), f12_sub(yt, y1))
    return f12_sub(xt, x1)  # vertical


def untwist(q):
    """G2 affine (Fq2 coords) -> E(Fq12) point."""
    if q is None:
        return None
    x, y = q
    return (f12_from_fq2_w2(x), f12_from_fq2_w3(y))


def embed_g1(p):
    if p is None:
        return None
    return (f12_from_fq(p[0]), f12_from_fq(p[1]))


def _frob_pt(pt):
    """Frobenius on E(Fq12): coordinate-wise x -> x^p."""
    return (f12_pow(pt[0], P), f12_pow(pt[1], P))


def miller_loop(q, p):
    """f_{6x+2, Q}(P) * (Frobenius correction lines); q, p on E(Fq12)."""
    if q is None or p is None:
        return F12_ONE
    r = q
    f = F12_ONE
    for bit in bin(ATE_LOOP)[3:]:
        f = f12_mul(f12_sqr(f), _linefunc(r, r, p))
        r = _pt_double(r)
        if bit == "1":
            f = f12_mul(f, _linefunc(r, q, p))
            r = _pt_add(r, q)
    q1 = _frob_pt(q)
    q2 = _pt_neg(_frob_pt(q1))
    f = f12_mul(f, _linefunc(r, q1, p))
    r = _pt_add(r, q1)
    f = f12_mul(f, _linefunc(r, q2, p))
    return f


FINAL_EXP = (P**12 - 1) // FR_MOD


def final_exponentiation(f):
    # easy part f^((p^6-1)(p^2+1)) via conjugation/inverse, then hard part
    f1 = f12_mul(f12_conj(f), f12_inv(f))          # f^(p^6-1)
    f2 = f12_mul(f12_pow(f1, P * P), f1)           # ^(p^2+1)
    hard = (P**4 - P**2 + 1) // FR_MOD
    return f12_pow(f2, hard)


def pairing(q, p):
    """e(P, Q) with P in G1 (Fq affine), Q in G2 (Fq2 affine)."""
    return final_exponentiation(miller_loop(untwist(q), embed_g1(p)))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 for [(g1_pt, g2_pt), ...]; one final exp."""
    f = F12_ONE
    for g1p, g2q in pairs:
        f = f12_mul(f, miller_loop(untwist(g2q), embed_g1(g1p)))
    return final_exponentiation(f) == F12_ONE
