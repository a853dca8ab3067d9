"""Port parity: ops/msm.py's 4-bit paths (signed digits, the select-based
msm_onehot) and the msm_host entry, against the JAX package and host
Pippenger, exact."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

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
    from scroll_prover_tpu_torch.proof_system.kzg import _batch_base_mul

    pts = _batch_base_mul(list(range(7, 71)))
    return pts, tec.encode_affine_mont(pts)


def test_signed_digits4_match_jax():
    """1024 scalars including 0, 1, r - 1 and r - 2."""
    s = ints_to_limbs(_scalars(1024, 61))
    td, ts = tmsm._signed_digits4(limbs_to_torch(s, "cpu"))
    jd, js = jmsm._signed_digits4(jnp.asarray(s))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(td.max()) <= 8


def test_msm_onehot_matches_jax(points):
    """64 points at one lane step: projective limbs equal the JAX
    package's, affine equals host Pippenger."""
    pts, enc = points
    s = _scalars(64, 62)
    sl = ints_to_limbs(s)
    want = jmsm.msm_onehot(jnp.asarray(enc), jnp.asarray(sl))
    got = tmsm.msm_onehot(limbs_to_torch(enc, "cpu"), limbs_to_torch(sl, "cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(limbs_from_torch(g), np.asarray(w))
    assert tec.decode_point(got) == host_msm_jac(pts, s)


def test_msm_host_matches_host_pippenger(points):
    """The host-int entry point at 64 points. Held against host Pippenger,
    not the JAX msm_host: that is the same jitted msm as
    test_torch_msm_plain's msm_padded case, and a second JAX run of it would
    double this file's time."""
    pts, _ = points
    s = _scalars(64, 63)
    assert tmsm.msm_host(pts, s, device="cpu") == host_msm_jac(pts, s)
