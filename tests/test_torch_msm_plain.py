"""Port parity: ops/msm.py's 8-bit Pippengers (digits, the segmented-scan
window, the O(n) scatter MSM and its padding) against the JAX package,
exact: projective limbs where both add in the same order, affine points
against host Pippenger otherwise."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scroll_prover_tpu.ops import ec as jec
from scroll_prover_tpu.ops import msm as jmsm
from scroll_prover_tpu_torch.curves.bn254_curve import host_msm_jac
from scroll_prover_tpu_torch.fields.bn254 import FR_MOD
from scroll_prover_tpu_torch.fields.limbs import ints_to_limbs, limbs_from_torch, limbs_to_torch
from scroll_prover_tpu_torch.ops import ec as tec
from scroll_prover_tpu_torch.ops import msm as tmsm

torch.set_num_threads(2)


def _scalars(n, seed):
    rng = np.random.default_rng(seed)
    s = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(n)]
    s[:4] = [0, 1, FR_MOD - 1, FR_MOD - 2]
    return s


@pytest.fixture(scope="module")
def points():
    """64 distinct affine points: host ints and (n, 2, 16) Montgomery."""
    from scroll_prover_tpu_torch.proof_system.kzg import _batch_base_mul

    pts = _batch_base_mul(list(range(5, 69)))
    return pts, tec.encode_affine_mont(pts)


def _assert_point_equal(got: tec.PointP, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(limbs_from_torch(g), np.asarray(w))


def test_digits_match_jax():
    """Raw 8-bit windows and the signed carry scan on 1024 scalars."""
    s = ints_to_limbs(_scalars(1024, 51))
    t = limbs_to_torch(s, "cpu")
    np.testing.assert_array_equal(tmsm._digits(t).numpy(), np.asarray(jmsm._digits(jnp.asarray(s))))
    td, ts = tmsm._signed_digits(t)
    jd, js = jmsm._signed_digits(jnp.asarray(s))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_bucket_window_matches_jax(points):
    """One window of the legacy scan MSM (stable sort by digit, segmented
    scan, suffix sums), projective limbs; then msm_scan's building block
    against host Pippenger for that window's digits."""
    _, enc = points
    s = ints_to_limbs(_scalars(64, 52))
    d = 20  # a window with all digit values mixed
    jp = jec.from_affine(jnp.asarray(enc))
    want = jmsm._bucket_window(jp, jmsm._digits(jnp.asarray(s))[d])
    tp = tec.from_affine(limbs_to_torch(enc, "cpu"))
    got = tmsm._bucket_window(tp, tmsm._digits(limbs_to_torch(s, "cpu"))[d])
    _assert_point_equal(got, want)


def test_msm_padded_matches_jax(points):
    """50 points pad to 64 (copies of point 0, zero scalars): the O(n)
    scatter MSM's projective result equals the JAX package's limb for limb,
    and its affine form equals host Pippenger."""
    pts, enc = points
    n = 50
    s = _scalars(n, 53)
    sl = ints_to_limbs(s)
    want = jmsm.msm_padded(jnp.asarray(enc[:n]), jnp.asarray(sl))
    got = tmsm.msm_padded(limbs_to_torch(enc[:n], "cpu"), limbs_to_torch(sl, "cpu"))
    _assert_point_equal(got, want)
    assert tec.decode_point(got) == host_msm_jac(pts[:n], s)


def test_pad_size_matches_jax():
    for n in (1, 2, 63, 64, 65, 1000, 1 << 20):
        assert tmsm.pad_size(n) == jmsm.pad_size(n)
