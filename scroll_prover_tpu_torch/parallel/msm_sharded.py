"""The MSM with its points split over the mesh's ranks.

Pippenger splits over points: each rank runs a whole MSM over its slice,
the ranks all-gather their partial projective points (96 B each), and each
sums them in rank order with the complete group law, so every rank holds
the same point. The point sum is exact, so the result is the single-device
MSM's point at any world size.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..fields.limbs import N_LIMBS, limbs_to_words, words_to_limbs
from ..ops import ec
from ..ops import msm_tile as mt
from .mesh import shard_axis


def _sum_over_ranks(mesh, part: ec.PointP) -> ec.PointP:
    """Every rank's projective point (16,) limbs -> their sum in rank order,
    on every rank."""
    mine = torch.stack(list(part)).contiguous()  # (3, 16)
    parts = [torch.empty_like(mine) for _ in range(mesh.size())]
    dist.all_gather(parts, mine, group=mesh.get_group())
    every = torch.stack(parts)  # (d, 3, 16)
    return ec.add_reduce(ec.PointP(every[:, 0], every[:, 1], every[:, 2]))


def _local_v2(points, scalars) -> ec.PointP:
    """The v2 MSM (K3, K4) of this rank's slice as a projective point."""
    p = words_to_limbs(mt.msm_v2_proj_batch(points, [scalars])[0])  # (3, 16)
    return ec.PointP(p[0], p[1], p[2])


def msm_sharded(mesh, points_affine_mont, scalar_limbs) -> ec.PointP:
    """points (n, 2, 16) Montgomery affine, scalars (n, 16) standard form,
    the same on every rank; n must split evenly over the mesh. Each rank's
    slice runs the v2 MSM (K3 and K4 on the card, their plain versions on
    the CPU; the JAX package's CPU mesh runs ops/msm.py `msm_padded`, which
    takes ~50 s a call as plain torch on a CPU). Returns the projective sum,
    the same on every rank."""
    pts, scs = shard_axis(mesh, points_affine_mont), shard_axis(mesh, scalar_limbs)
    return _sum_over_ranks(mesh, _local_v2(pts, scs))


def msm_tile_sharded(mesh, points_affine_mont, scalar_limbs):
    """The card's sharded commit: the points padded, as the JAX package pads
    them, to a multiple of the ranks times 1024 with copies of point 0 (and
    zero scalars, which add nothing), each rank's slice through K3 and K4 to
    one projective point, and the ranks' points summed in rank order.
    Returns the host affine point (or None)."""
    n = points_affine_mont.shape[0]
    npad = (-n) % (mesh.size() * mt.SUB_T * 128)
    if npad:
        points_affine_mont = torch.cat([points_affine_mont, points_affine_mont[:1].expand(npad, 2, N_LIMBS)])
        scalar_limbs = torch.cat([scalar_limbs, scalar_limbs.new_zeros(npad, N_LIMBS)])
    pts, scs = shard_axis(mesh, points_affine_mont), shard_axis(mesh, scalar_limbs)
    total = _sum_over_ranks(mesh, _local_v2(pts, scs))
    return mt._affine_columns(limbs_to_words(torch.stack(list(total)))[None].cpu().numpy())[0]
