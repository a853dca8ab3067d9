"""BN254 G1 arithmetic on limb planes, plain PyTorch.

Points are homogeneous projective (X, Y, Z) triples of (..., 16) int32
Montgomery limb tensors on Y^2 Z = X^3 + 3 Z^3, added with the complete
formulas of Renes-Costello-Batina 2015 (a = 0, b3 = 9): branch-free and
identity-safe. These are the plain versions the MSM kernels (K3/K4) and the
fixed-base kernel (K5) are held against; csrc/bn254.cuh transcribes the same
formulas, so the projective coordinates agree exactly, not only the points.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..fields.bn254 import FQ_MOD
from ..fields.limbs import FQ_LIMB, N_LIMBS, ints_to_limbs, limbs_from_torch, limbs_to_ints, limbs_to_torch
from . import field_ops as fo

F = FQ_LIMB
_B3_MONT = ints_to_limbs([9 * (1 << 256) % FQ_MOD])[0]
_B3: dict = {}


def _b3(device) -> torch.Tensor:
    t = _B3.get(str(device))
    if t is None:
        t = _B3[str(device)] = limbs_to_torch(_B3_MONT, device)
    return t


class PointP(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def identity(shape=(), *, device) -> PointP:
    zero = torch.zeros((*shape, N_LIMBS), dtype=torch.int32, device=device)
    return PointP(zero, fo.one_mont(F, shape, device=device).clone(), zero.clone())


def select_point(mask, a: PointP, b: PointP) -> PointP:
    return PointP(*(fo.select(mask, u, v) for u, v in zip(a, b)))


def from_affine(xy) -> PointP:
    """(..., 2, 16) Montgomery affine (not the identity) -> projective."""
    x, y = xy[..., 0, :], xy[..., 1, :]
    return PointP(x, y, fo.one_mont(F, x.shape[:-1], device=x.device))


def neg(p: PointP) -> PointP:
    return PointP(p.x, fo.neg_mod(F, p.y), p.z)


def add(p: PointP, q: PointP) -> PointP:
    """Complete projective addition (RCB15 alg. 7, a=0, b3=9)."""
    mul = partial(fo.mont_mul, F)
    add_ = partial(fo.add_mod, F)
    sub = partial(fo.sub_mod, F)
    b3 = _b3(p.x.device)

    t0 = mul(p.x, q.x)
    t1 = mul(p.y, q.y)
    t2 = mul(p.z, q.z)
    t3 = mul(add_(p.x, p.y), add_(q.x, q.y))
    t3 = sub(t3, add_(t0, t1))
    t4 = mul(add_(p.y, p.z), add_(q.y, q.z))
    t4 = sub(t4, add_(t1, t2))
    x3 = mul(add_(p.x, p.z), add_(q.x, q.z))
    y3 = sub(x3, add_(t0, t2))
    x3 = add_(t0, t0)
    t0 = add_(x3, t0)
    t2 = mul(b3, t2)
    z3 = add_(t1, t2)
    t1 = sub(t1, t2)
    y3 = mul(b3, y3)
    x3 = mul(t4, y3)
    t2 = mul(t3, t1)
    x3 = sub(t2, x3)
    y3 = mul(y3, t0)
    t1 = mul(t1, z3)
    y3 = add_(t1, y3)
    t0 = mul(t0, t3)
    z3 = mul(z3, t4)
    z3 = add_(z3, t0)
    return PointP(x3, y3, z3)


def madd(p: PointP, qx, qy) -> PointP:
    """Mixed addition p + (qx, qy, 1) (RCB15 alg. 8, a=0, b3=9); complete in
    p, q must be a real affine point."""
    mul = partial(fo.mont_mul, F)
    add_ = partial(fo.add_mod, F)
    sub = partial(fo.sub_mod, F)
    b3 = _b3(p.x.device)

    t0 = mul(p.x, qx)
    t1 = mul(p.y, qy)
    t3 = add_(qx, qy)
    t4 = add_(p.x, p.y)
    t3 = mul(t3, t4)
    t4 = add_(t0, t1)
    t3 = sub(t3, t4)
    t4 = mul(qy, p.z)
    t4 = add_(t4, p.y)
    y3 = mul(qx, p.z)
    y3 = add_(y3, p.x)
    x3 = add_(t0, t0)
    t0 = add_(x3, t0)
    t2 = mul(b3, p.z)
    z3 = add_(t1, t2)
    t1 = sub(t1, t2)
    y3 = mul(b3, y3)
    x3 = mul(t4, y3)
    t2 = mul(t3, t1)
    x3 = sub(t2, x3)
    y3 = mul(y3, t0)
    t1 = mul(t1, z3)
    y3 = add_(t1, y3)
    t0 = mul(t0, t3)
    z3 = mul(z3, t4)
    z3 = add_(z3, t0)
    return PointP(x3, y3, z3)


def double(p: PointP) -> PointP:
    """Complete projective doubling (RCB15 alg. 9, a=0, b3=9)."""
    mul = partial(fo.mont_mul, F)
    add_ = partial(fo.add_mod, F)
    sub = partial(fo.sub_mod, F)
    b3 = _b3(p.x.device)

    t0 = mul(p.y, p.y)
    z3 = add_(t0, t0)
    z3 = add_(z3, z3)
    z3 = add_(z3, z3)
    t1 = mul(p.y, p.z)
    t2 = mul(p.z, p.z)
    t2 = mul(b3, t2)
    x3 = mul(t2, z3)
    y3 = add_(t0, t2)
    z3 = mul(t1, z3)
    t1 = add_(t2, t2)
    t2 = add_(t1, t2)
    t0 = sub(t0, t2)
    y3 = mul(t0, y3)
    y3 = add_(x3, y3)
    t1 = mul(p.x, p.y)
    x3 = mul(t0, t1)
    x3 = add_(x3, x3)
    return PointP(x3, y3, z3)


def add_reduce(p: PointP) -> PointP:
    """Sum a batch of points (n, 16) -> one point (16,): padded to a power
    of two with the identity, then log2(n) halving rounds of complete adds
    (lane i adds lane i + m/2), as the JAX package orders them."""
    n = p.x.shape[0]
    m = 1 << (n - 1).bit_length() if n > 1 else 1
    if m != n:
        pad = identity((m - n,), device=p.x.device)
        p = PointP(*(torch.cat([a, b]) for a, b in zip(p, pad)))
    while m > 1:
        m //= 2
        p = add(PointP(*(a[:m] for a in p)), PointP(*(a[m:] for a in p)))
    return PointP(*(a[0] for a in p))


# --- host conversion helpers -------------------------------------------------


def encode_affine_mont(points) -> np.ndarray:
    """Host affine int pairs [(x, y) or None ...] -> (n, 2, 16) uint32
    Montgomery; the identity is encoded as (0, 0)."""
    xs, ys = [], []
    for pt in points:
        if pt is None:
            xs.append(0)
            ys.append(0)
        else:
            xs.append(pt[0] * (1 << 256) % FQ_MOD)
            ys.append(pt[1] * (1 << 256) % FQ_MOD)
    return np.stack([ints_to_limbs(xs), ints_to_limbs(ys)], axis=1)


def decode_point(p: PointP):
    """Single projective point -> host affine int pair or None."""
    x, y, z = (limbs_to_ints(limbs_from_torch(v.reshape(1, N_LIMBS)))[0] for v in p)
    rinv = pow(1 << 256, -1, FQ_MOD)
    x, y, z = (v * rinv % FQ_MOD for v in (x, y, z))
    if z == 0:
        return None
    zinv = pow(z, -1, FQ_MOD)
    return (x * zinv % FQ_MOD, y * zinv % FQ_MOD)
