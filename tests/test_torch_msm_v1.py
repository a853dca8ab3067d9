"""Port parity: the v1 bucket MSM of ops/msm_tile.py (plain K6, the lane
reduction, the device and host window folds) against the JAX package and
host Pippenger, exact.

The JAX K6 runs only in Pallas interpret mode on the CPU, minutes per call,
so the table after K6 is built on the host as tests/test_msm_tile.py builds
its default-tier case, and the whole v1 path is held against host
Pippenger. The end-to-end cases shrink the lane count to SUB_T = 1 (128
lanes): the plain lane reduction costs ~30 us per point add here, and K6 at
the full 1024 lanes is held against this plain version on the card
(chip_smoke.py)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scroll_prover_tpu.ops import msm_tile as jmt
from scroll_prover_tpu_torch.curves.bn254_curve import G1, host_msm_jac
from scroll_prover_tpu_torch.fields.bn254 import FQ_MOD, FR_MOD
from scroll_prover_tpu_torch.fields.limbs import ints_to_limbs, limbs_from_torch, limbs_to_torch
from scroll_prover_tpu_torch.ops import ec as tec
from scroll_prover_tpu_torch.ops import msm_tile as tmt
from scroll_prover_tpu_torch.ops.msm import B4, C4, W4

torch.set_num_threads(2)


def _scalars(n, seed):
    rng = np.random.default_rng(seed)
    s = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(n)]
    s[:4] = [0, 1, FR_MOD - 1, FR_MOD - 2]
    return s


def _points(n, first):
    from scroll_prover_tpu_torch.proof_system.kzg import _batch_base_mul

    return _batch_base_mul(list(range(first, first + n)))


def _lane_table(pts, scalars, lanes):
    """The per-lane projective table (W4, B4, 3, 16, 1, lanes) that K6 would
    leave, built on host ints as tests/test_msm_tile.py builds it: a bucket's
    points round-robin over the lanes, summed per lane, z = 1 (identity
    (0, 1, 0) in empty lanes, bucket 0 all zero)."""
    buckets = {}
    for pt, s in zip(pts, scalars):
        carry = 0
        for w in range(W4):
            d = ((s >> (C4 * w)) & 0xF) + carry
            carry = int(d > 8)
            d -= 16 * carry
            if d > 0:
                buckets.setdefault((w, d), []).append(pt)
            elif d < 0:
                buckets.setdefault((w, -d), []).append((pt[0], (-pt[1]) % FQ_MOD))
        assert carry == 0
    tbl = np.zeros((W4, B4, 3, 16, 1, lanes), dtype=np.uint32)
    one_m = ints_to_limbs([(1 << 256) % FQ_MOD])[0]
    for w in range(W4):
        for b in range(1, B4):
            lane_pts = [None] * lanes
            for i, pt in enumerate(buckets.get((w, b), [])):
                lane_pts[i % lanes] = G1.add(lane_pts[i % lanes], pt)
            filled = [pt for pt in lane_pts if pt is not None]
            enc = tec.encode_affine_mont(filled)
            for i in range(len(filled)):
                tbl[w, b, 0, :, 0, i] = enc[i, 0]
                tbl[w, b, 1, :, 0, i] = enc[i, 1]
                tbl[w, b, 2, :, 0, i] = one_m
            for i in range(len(filled), lanes):
                tbl[w, b, 1, :, 0, i] = one_m
    return tbl


def test_reduce_lanes_and_folds_match_jax():
    """64 points at st = 1, lanes = 4: the lane reduction (projective limbs),
    the device fold `_reduce_buckets` (projective limbs) and the host fold
    `_host_fold` (affine) equal the JAX package's, and host Pippenger."""
    pts = _points(64, 11)
    s = _scalars(64, 71)
    tbl = _lane_table(pts, s, lanes=4)
    want_red = np.asarray(jmt._reduce_lanes(jnp.asarray(tbl)))
    red = tmt._reduce_lanes(limbs_to_torch(tbl, "cpu"))
    np.testing.assert_array_equal(limbs_from_torch(red), want_red)
    want = host_msm_jac(pts, s)
    assert tmt._host_fold(limbs_from_torch(red)) == jmt._host_fold(want_red) == want
    jp = jmt._reduce_buckets(jnp.asarray(want_red))
    tp = tmt._reduce_buckets(red)
    for g, w in zip(tp, jp):
        np.testing.assert_array_equal(limbs_from_torch(g), np.asarray(w))
    assert tec.decode_point(tp) == want


@pytest.fixture
def lanes128(monkeypatch):
    monkeypatch.setattr(tmt, "SUB_T", 1)


@pytest.fixture(scope="module")
def points1100():
    pts = _points(1100, 3)
    return pts, limbs_to_torch(tec.encode_affine_mont(pts), "cpu")


def test_msm_tile_host_matches_host_pippenger(lanes128, points1100):
    """1100 points pad to 1152 (9 tiles of 128 lanes) with zero-scalar
    copies of point 0: plain K6 + lane reduction + host fold."""
    pts, dev = points1100
    s = _scalars(1100, 72)
    got = tmt.msm_tile_host(dev, limbs_to_torch(ints_to_limbs(s), "cpu"))
    assert got == host_msm_jac(pts, s)


def test_msm_tile_host_batch_matches_host_pippenger(lanes128, points1100):
    """Three columns over the shared 1100 points in one plain-K6 pass: a full
    column, a short one (zero-padded) and an all-zero one (None)."""
    pts, dev = points1100
    cols = [_scalars(1100, 73), _scalars(300, 74), [0] * 1100]
    got = tmt.msm_tile_host_batch(dev, [limbs_to_torch(ints_to_limbs(c), "cpu") for c in cols])
    assert got == [host_msm_jac(pts[: len(c)], c) for c in cols]
    assert got[2] is None


def test_plain_k6_leaves_bucket_zero_identity(lanes128, points1100):
    """Zero digits are skipped: bucket 0 of the raw per-lane table is the
    identity (0, 1, 0) everywhere, as K6 leaves it."""
    _, dev = points1100
    s = limbs_to_torch(ints_to_limbs(_scalars(128, 75)), "cpu")
    px, py, digs, signs = tmt._v1_prep(dev[:128], [s])
    raw = tmt._msm_buckets_lanes(px, py, digs[0], signs[0])
    assert raw.shape == (W4, B4, 3, 16, 1, 128)
    ident = torch.stack(list(tec.identity((), device="cpu")))  # (3, 16)
    assert torch.equal(raw[:, 0], ident[None, :, :, None, None].expand(W4, 3, 16, 1, 128))
