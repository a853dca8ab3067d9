"""BLS12-381 pairing (host, plain ints) — the c-kzg/blst verification leg.

Role parity with the reference's c-kzg + blst dependency (SURVEY.md section
2.2 native component #3, Cargo.lock:679,605): verifying the EIP-4844
point-evaluation proof carried in BatchHeader.blob_data_proof requires a
real BLS12-381 pairing.

Tower: Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - xi) with xi = 1+u,
Fq12 = Fq6[w]/(w^2 - v). G2 lives on the M-type sextic twist
y^2 = x^3 + 4*xi; untwist (x', y') -> (x'/w^2, y'/w^3) (w^6 = xi).

Miller loop: f_{|x|,Q}(P) with BLS parameter x = -0xd201000000010000
(conjugate at the end since x < 0); no Frobenius correction lines (unlike
BN). Final exponentiation is the generic (q^12-1)/r power — verify-side
host code, cold path, correctness-first.
"""
from __future__ import annotations

from .bls12_381 import G2_GEN, Q as P, R

BLS_X = 0xD201000000010000  # |x|; the BLS parameter is -x

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
XI = (1, 1)
XI_INV = f2_inv(XI)

# ---- Fq6 = Fq2[v]/(v^3 - xi) -------------------------------------------------


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def _mul_xi(a):
    return f2_mul(a, XI)


def f6_mul(a, b):
    c = [F2_ZERO] * 5
    for i in range(3):
        for j in range(3):
            t = f2_mul(a[i], b[j])
            c[i + j] = f2_add(c[i + j], t)
    return (
        f2_add(c[0], _mul_xi(c[3])),
        f2_add(c[1], _mul_xi(c[4])),
        c[2],
    )


def f6_mul_v(a):
    return (_mul_xi(a[2]), a[0], a[1])


def f6_neg(a):
    return tuple(f2_sub(F2_ZERO, x) for x in a)


def f6_inv(a):
    # standard norm-based inversion
    a0, a1, a2 = a
    t0 = f2_sub(f2_mul(a0, a0), _mul_xi(f2_mul(a1, a2)))
    t1 = f2_sub(_mul_xi(f2_mul(a2, a2)), f2_mul(a0, a1))
    t2 = f2_sub(f2_mul(a1, a1), f2_mul(a0, a2))
    norm = f2_add(
        f2_mul(a0, t0), _mul_xi(f2_add(f2_mul(a2, t1), f2_mul(a1, t2)))
    )
    ninv = f2_inv(norm)
    return (f2_mul(t0, ninv), f2_mul(t1, ninv), f2_mul(t2, ninv))


F6_ZERO = (F2_ZERO,) * 3
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)

# ---- Fq12 = Fq6[w]/(w^2 - v) -------------------------------------------------


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def f12_mul(a, b):
    t0 = f6_mul(a[0], b[0])
    t1 = f6_mul(a[1], b[1])
    mid = f6_sub(
        f6_sub(f6_mul(f6_add(a[0], a[1]), f6_add(b[0], b[1])), t0), t1
    )
    return (f6_add(t0, f6_mul_v(t1)), mid)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_neg(a):
    return (f6_neg(a[0]), f6_neg(a[1]))


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    norm = f6_sub(f6_mul(a[0], a[0]), f6_mul_v(f6_mul(a[1], a[1])))
    ninv = f6_inv(norm)
    return (f6_mul(a[0], ninv), f6_neg(f6_mul(a[1], ninv)))


F12_ONE = (F6_ONE, F6_ZERO)
F12_ZERO = (F6_ZERO, F6_ZERO)


def f12_pow(a, e: int):
    out = F12_ONE
    base = a
    while e:
        if e & 1:
            out = f12_mul(out, base)
        base = f12_sqr(base)
        e >>= 1
    return out


# ---- untwist / embed ---------------------------------------------------------


def untwist(q):
    """M-type: (x', y') on E'(Fq2) -> (x'/w^2, y'/w^3) on E(Fq12).
    1/w^2 = v^2/xi  (coefficient xi^{-1} at v^2, w^0 part);
    1/w^3 = (v/xi)*w (coefficient xi^{-1} at v^1, w^1 part)."""
    x2, y2 = q
    xc = f2_mul(x2, XI_INV)
    yc = f2_mul(y2, XI_INV)
    x12 = ((F2_ZERO, F2_ZERO, xc), F6_ZERO)
    y12 = (F6_ZERO, (F2_ZERO, yc, F2_ZERO))
    return (x12, y12)


def embed_g1(p):
    return (
        ((( p[0] % P, 0), F2_ZERO, F2_ZERO), F6_ZERO),
        (((p[1] % P, 0), F2_ZERO, F2_ZERO), F6_ZERO),
    )


# ---- E(Fq12) arithmetic + line functions ------------------------------------


def _pt_neg(pt):
    return (pt[0], f12_neg(pt[1]))


def _pt_double(pt):
    x, y = pt
    x2 = f12_sqr(x)
    three = f12_add(f12_add(x2, x2), x2)
    lam = f12_mul(three, f12_inv(f12_add(y, y)))
    x3 = f12_sub(f12_sub(f12_sqr(lam), x), x)
    y3 = f12_sub(f12_mul(lam, f12_sub(x, x3)), y)
    return (x3, y3)


def _pt_add(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return _pt_double(p1)
    lam = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    x3 = f12_sub(f12_sub(f12_sqr(lam), x1), x2)
    y3 = f12_sub(f12_mul(lam, f12_sub(x1, x3)), y1)
    return (x3, y3)


def _linefunc(p1, p2, t):
    """Line through p1,p2 (tangent if equal) evaluated at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 == x2 and y1 == y2:
        m = f12_mul(
            f12_add(f12_add(f12_sqr(x1), f12_sqr(x1)), f12_sqr(x1)),
            f12_inv(f12_add(y1, y1)),
        )
    elif x1 != x2:
        m = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    else:
        # vertical line
        return f12_sub(xt, x1)
    return f12_sub(f12_sub(yt, y1), f12_mul(m, f12_sub(xt, x1)))


def miller_loop(q, p):
    """f_{|x|,Q}(P), conjugated at the end (the BLS parameter is negative)."""
    if q is None or p is None:
        return F12_ONE
    r = q
    f = F12_ONE
    for bit in bin(BLS_X)[3:]:
        f = f12_mul(f12_sqr(f), _linefunc(r, r, p))
        r = _pt_double(r)
        if bit == "1":
            f = f12_mul(f, _linefunc(r, q, p))
            r = _pt_add(r, q)
    return f12_conj(f)  # x < 0: f_{x} = conj(f_{|x|}) after final exp's easy part


FINAL_EXP = (P**12 - 1) // R


def final_exponentiation(f):
    f1 = f12_mul(f12_conj(f), f12_inv(f))  # f^(p^6-1)
    f2 = f12_mul(f12_pow(f1, P * P), f1)   # ^(p^2+1)
    hard = (P**4 - P**2 + 1) // R
    return f12_pow(f2, hard)


def pairing(g1p, g2q):
    """e(P, Q), P in G1 (Fq affine), Q in G2 (Fq2 affine pair)."""
    return final_exponentiation(miller_loop(untwist(g2q), embed_g1(g1p)))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 for [(g1_pt, g2_pt), ...]; one final exp."""
    f = F12_ONE
    for g1p, g2q in pairs:
        if g1p is None or g2q is None:
            continue
        f = f12_mul(f, miller_loop(untwist(g2q), embed_g1(g1p)))
    return final_exponentiation(f) == F12_ONE


# ---- G2 affine arithmetic over Fq2 (twist curve) -----------------------------


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 != y2:
            return None
        num = f2_mul((3, 0), f2_mul(x1, x1))
        lam = f2_mul(num, f2_inv(f2_add(y1, y1)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_mul(lam, lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(p, k: int):
    k %= R
    out = None
    add = p
    while k:
        if k & 1:
            out = g2_add(out, add)
        add = g2_add(add, add)
        k >>= 1
    return out


def g2_generator():
    return G2_GEN
