"""The inverse NTT over G1: an FFT whose values are curve points and whose
twiddles are Fr scalars.

Its one consumer is SRS.downsize, which rebuilds the Lagrange basis of a
smaller domain from the prefix of the monomial basis:
lag[i] = (1/n) sum_j omega^(-ij) powers[j], an inverse NTT over the group.
It is a radix-2 Cooley-Tukey ladder as in the JAX package: a bit reversal,
k levels, each a per-lane 254-step double-and-add of b by its twiddle
(`_mul_bits`) and the complete adds a + tb, a - tb, then the product by
n^-1 and one batched inversion of Z.

No kernel of its own: every field operation is ops/ec.py over
ops/field_ops.py, so on a CUDA tensor each product is a K1 launch and each
add, sub or neg a K1as launch; on a CPU tensor they are the plain versions.
The twiddles of a level are built on the tensor's device and their bits cut
from the 16-bit limbs there.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..fields.bn254 import FQ_MOD, FR_MOD, FR_ROOT_OF_UNITY, FR_TWO_ADICITY
from ..fields.limbs import FQ_LIMB, FR_LIMB, N_LIMBS, ints_to_limbs, limbs_from_torch, limbs_to_ints, limbs_to_torch
from . import ec
from . import field_ops as fo
from .ntt import _bitrev_indices
from .poly import powers_outer_mont

NBITS = 254  # Fr scalars are below 2^254


def _bits_dev(scalars_std) -> torch.Tensor:
    """(m, 16) standard-form Fr limbs -> (254, m) bool bit planes, least
    significant first, cut on the limbs' device."""
    i = torch.arange(NBITS, device=scalars_std.device)
    return ((scalars_std[:, i // 16] >> (i % 16)) & 1).T.bool()


def _mul_bits(p: ec.PointP, bits) -> ec.PointP:
    """Per-lane scalar product: p (..., 16) lanes times the scalar whose
    bits (254, ...) are given, least significant first, by a double-and-add
    from the identity. It stops after the highest bit any lane has set: a
    step above it leaves every accumulator as it is."""
    acc = ec.identity(p.x.shape[:-1], device=p.x.device)
    base = p
    live = torch.nonzero(bits.reshape(bits.shape[0], -1).any(1))
    for i in range(int(live.max()) + 1 if live.numel() else 0):
        acc = ec.select_point(bits[i], ec.add(acc, base), acc)
        base = ec.double(base)
    return acc


def _twiddle_bits(w: int, half: int, device) -> torch.Tensor:
    """Bit planes (254, half) of w^0 .. w^(half-1)."""
    pows = powers_outer_mont(FR_LIMB, w, half, device=device)
    return _bits_dev(fo.from_mont(FR_LIMB, pows))


def _contig(p: ec.PointP) -> ec.PointP:
    return ec.PointP(*(a.contiguous() for a in p))


def group_intt_dev(points_affine_mont, k: int):
    """(2^k, 2, 16) Montgomery affine points (no identity) -> their inverse
    NTT as (2^k, 2, 16) Montgomery affine points, the identity as (0, 0)
    the way ec.encode_affine_mont writes it, on the points' device."""
    n = 1 << k
    assert points_affine_mont.shape == (n, 2, N_LIMBS)
    dev = points_affine_mont.device
    rev = torch.from_numpy(_bitrev_indices(n).astype("int64")).to(dev)
    p = ec.from_affine(points_affine_mont.index_select(0, rev))
    p = _contig(p)
    omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - k), FR_MOD)
    omega_inv = pow(omega, -1, FR_MOD)
    for s in range(1, k + 1):
        size = 1 << s
        half = size >> 1
        bits = _twiddle_bits(pow(omega_inv, n >> s, FR_MOD), half, dev)[:, None, :]  # (254, 1, half)
        # lanes as (block, position): a is position j < half, b is j + half
        blocks = ec.PointP(*(a.reshape(n // size, size, N_LIMBS) for a in p))
        a = _contig(ec.PointP(*(c[:, :half] for c in blocks)))
        b = _contig(ec.PointP(*(c[:, half:] for c in blocks)))
        tb = _mul_bits(b, bits)
        hi = ec.add(a, tb)
        lo = ec.add(a, ec.neg(tb))
        p = ec.PointP(*(torch.cat([u, v], dim=1).reshape(n, N_LIMBS) for u, v in zip(hi, lo)))
        del a, b, tb, hi, lo, blocks
    ninv = limbs_to_torch(ints_to_limbs([pow(n, -1, FR_MOD)]), dev)
    p = _mul_bits(p, _bits_dev(ninv))  # (254, 1): one scalar for every lane
    return _affine_mont(p)


def _affine_mont(p: ec.PointP):
    """(n,) projective lanes -> (n, 2, 16) Montgomery affine with one
    batched inversion of Z; Z = 0 gives (0, 0)."""
    zinv = fo.batch_inv_mont(FQ_LIMB, p.z)
    return torch.stack([fo.mont_mul(FQ_LIMB, p.x, zinv), fo.mont_mul(FQ_LIMB, p.y, zinv)], dim=1)


def group_intt_points(points: list, k: int, device=None) -> list:
    """Host affine int pairs (2^k of them, no identity) -> their inverse NTT
    as host affine int pairs, None for the identity: group_intt_dev on
    `device` between the host encoding and decoding."""
    dev = resolve_device(device)
    aff = group_intt_dev(limbs_to_torch(ec.encode_affine_mont(points), dev), k)
    n = aff.shape[0]
    ints = limbs_to_ints(limbs_from_torch(fo.from_mont(FQ_LIMB, aff.reshape(2 * n, N_LIMBS))))
    return [None if x == y == 0 else (x % FQ_MOD, y % FQ_MOD) for x, y in zip(ints[0::2], ints[1::2])]
