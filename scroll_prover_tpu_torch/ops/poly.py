"""Polynomial primitives over Fr limb planes, in PyTorch.

Polynomials are (n, 16) int32 Montgomery coefficient tensors, ascending
degree. Scans are Hillis-Steele (log2(n) full-width rounds), so on the card
every round is one K1 product or one plain add over the whole column.
"""
from __future__ import annotations

import torch

from ..fields.limbs import N_LIMBS, LimbField, ints_to_limbs, limbs_to_torch
from . import field_ops as fo


def _hs_scan(f: LimbField, x, combine, reverse: bool = False):
    """Inclusive Hillis-Steele prefix scan with `combine` (add/mul)."""
    if reverse:
        return _hs_scan(f, x.flip(0), combine).flip(0)
    x = x.clone()
    n, s = x.shape[0], 1
    while s < n:
        x[s:] = combine(f, x[s:], x[:-s])
        s *= 2
    return x


def suffix_sum_mont(f: LimbField, x):
    return _hs_scan(f, x, fo.add_mod, reverse=True)


def prefix_prod_mont(f: LimbField, x):
    return _hs_scan(f, x, fo.mont_mul)


def sum_mont(f: LimbField, x):
    """Total along axis 0 by a halving tree: (n, ..., 16) -> (..., 16)."""
    n = x.shape[0]
    while n > 1:
        h = n // 2
        s = fo.add_mod(f, x[:h], x[h : 2 * h])
        x = torch.cat([s, x[2 * h :]]) if n % 2 else s
        n = x.shape[0]
    return x[0]


def eval_poly_with_powers(f: LimbField, coeffs, pw):
    """f(z) given pw[i] = z^i (both (n, 16) Montgomery)."""
    return sum_mont(f, fo.mont_mul(f, coeffs, pw[: coeffs.shape[0]]))


def powers_mont(f: LimbField, z, n: int):
    """[1, z, z^2, ..., z^(n-1)] from one Montgomery element z: (16,)."""
    base = z[None, :].expand(n, N_LIMBS).clone()
    base[0] = fo.one_mont(f, device=z.device)
    return prefix_prod_mont(f, base)


def eval_poly_mont(f: LimbField, coeffs, z):
    """f(z) for coeffs (n, 16), z (16,), all Montgomery -> (16,)."""
    pw = powers_mont(f, z, coeffs.shape[0])
    return sum_mont(f, fo.mont_mul(f, coeffs, pw))


def kzg_quotient_mont(f: LimbField, coeffs, z):
    """q(X) = (f(X) - f(z)) / (X - z) as (n, 16), top coefficient zero.

    With t_j = f_j z^j: q_i = z^-(i+1) * sum_{j>i} t_j — one powers table,
    one suffix sum, one scale. Requires z != 0."""
    n = coeffs.shape[0]
    pw = powers_mont(f, z, n)
    t = fo.mont_mul(f, coeffs, pw)
    s = suffix_sum_mont(f, t)
    s = torch.cat([s[1:], torch.zeros_like(s[:1])])  # S_i = sum_{j >= i+1} t_j
    zinv = fo.inv_mont(f, z)
    q = fo.mont_mul(f, s, powers_mont(f, zinv, n))
    return fo.mont_mul(f, q, zinv)


def axpy_mont(f: LimbField, a, x, y):
    """a*x + y for scalar a (16,), vectors x, y (n, 16): one K1 launch on
    the card."""
    return fo.mont_mul_add(f, a, x, y)


def powers_outer_mont(f: LimbField, base: int, count: int, *, device):
    """(count, 16) Montgomery table t[i] = base^i as a hi (x) lo outer
    product: two host tables of ~sqrt(count) entries and one device
    product."""
    p = f.modulus
    r = (1 << 256) % p
    nl = 1 << ((count - 1).bit_length() // 2) if count > 1 else 1
    nl = min(nl, count)
    nh = (count + nl - 1) // nl
    w = base % p
    lo_ints, acc = [], 1
    for _ in range(nl):
        lo_ints.append(acc * r % p)
        acc = acc * w % p
    w_nl = pow(w, nl, p)
    hi_ints, acc = [], 1
    for _ in range(nh):
        hi_ints.append(acc * r % p)
        acc = acc * w_nl % p
    lo_m = limbs_to_torch(ints_to_limbs(lo_ints), device)
    hi_m = limbs_to_torch(ints_to_limbs(hi_ints), device)
    out = fo.mont_mul(f, hi_m[:, None, :], lo_m[None, :, :]).reshape(nh * nl, N_LIMBS)
    return out[:count]
