"""Port parity: EC formulas, the bucket MSM (plain K3/K4 + host fold) and the
fixed-base walk (plain K5) against the JAX package and host integers, exact.
Points are compared in affine form where the order of additions differs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scroll_prover_tpu.curves.bn254_curve import g1_generator as jax_g1
from scroll_prover_tpu.ops import ec as jec
from scroll_prover_tpu.ops import fixed_base as jfb
from scroll_prover_tpu.ops import msm_tile as jmt
from scroll_prover_tpu_torch.curves.bn254_curve import G1, g1_generator, host_msm_jac
from scroll_prover_tpu_torch.fields.bn254 import FR_MOD
from scroll_prover_tpu_torch.fields.limbs import ints_to_limbs, limbs_from_torch, limbs_to_torch
from scroll_prover_tpu_torch.ops import ec as tec
from scroll_prover_tpu_torch.ops import fixed_base as tfb
from scroll_prover_tpu_torch.ops import msm_tile as tmt

torch.set_num_threads(2)


def _scalars(n, seed):
    rng = np.random.default_rng(seed)
    s = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(n)]
    s[0] = 0
    s[1] = FR_MOD - 1
    s[2] = FR_MOD - 2
    s[3] = 1
    return s


@pytest.fixture(scope="module")
def points():
    """300 distinct affine points, host ints and (n, 2, 16) Montgomery."""
    from scroll_prover_tpu_torch.proof_system.kzg import _batch_base_mul

    pts = _batch_base_mul(_scalars(301, 31)[1:])
    return pts, tec.encode_affine_mont(pts)


@pytest.mark.parametrize("op", ["add", "madd", "double"])
def test_ec_formulas_match_jax(points, op):
    """Same RCB15 formulas, so projective coordinates agree limb for limb."""
    _, enc = points
    a = limbs_to_torch(enc[:64], "cpu")
    b = limbs_to_torch(enc[64:128], "cpu")
    ja, jb = jnp.asarray(enc[:64]), jnp.asarray(enc[64:128])
    p_t, q_t = tec.from_affine(a), tec.from_affine(b)
    p_j, q_j = jec.from_affine(ja), jec.from_affine(jb)
    if op == "add":
        got, want = tec.add(tec.double(p_t), q_t), jec.add(jec.double(p_j), q_j)
    elif op == "madd":
        got, want = tec.madd(tec.double(p_t), b[:, 0], b[:, 1]), jec.madd(jec.double(p_j), jb[:, 0], jb[:, 1])
    else:
        got, want = tec.double(tec.double(p_t)), jec.double(jec.double(p_j))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(limbs_from_torch(g), np.asarray(w))
    pts, _ = points
    if op == "add":  # affine decode of one projective result
        assert tec.decode_point(tec.PointP(*(c[0] for c in got))) == G1.add(G1.double(pts[0]), pts[64])


def test_signed_digits_match_jax():
    """The signed-digit carry scan against the JAX prep at one lane tile."""
    n = 1024
    s = limbs_to_torch(ints_to_limbs(_scalars(n, 32)), "cpu")
    jd, js = jmt._msm_prep_digits(jnp.asarray(limbs_from_torch(s)), 6)
    td, ts = tmt._msm_prep_digits(s, 6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd).reshape(td.shape))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).reshape(ts.shape))


@pytest.mark.parametrize("cols", [1, 3])
def test_msm_matches_host_pippenger(points, cols):
    """Plain K3 + plain K4 + host fold == host_msm_jac, incl. zero scalars
    and scalars near r, columns of unequal length."""
    pts, enc = points
    dev = limbs_to_torch(enc, "cpu")
    cols_ints = [_scalars(300 - 7 * c, 40 + c) for c in range(cols)]
    got = tmt.msm_v2_host_batch(dev, [limbs_to_torch(ints_to_limbs(s), "cpu") for s in cols_ints])
    for s, g in zip(cols_ints, got):
        assert g == host_msm_jac(pts[: len(s)], s)


def test_msm_all_zero_scalars_is_identity(points):
    _, enc = points
    z = limbs_to_torch(ints_to_limbs([0] * 40), "cpu")
    assert tmt.msm_v2_host(limbs_to_torch(enc[:40], "cpu"), z) is None


def test_fixed_base_matches_jax():
    """Plain K5 + normalization == the JAX scan path, incl. the zero scalar
    -> (0, 0) row."""
    s = ints_to_limbs(_scalars(96, 33))
    want = np.asarray(jfb.fixed_base_mul_dev(jax_g1(), jnp.asarray(s)))
    got = limbs_from_torch(tfb.fixed_base_mul_dev(g1_generator(), limbs_to_torch(s, "cpu")))
    np.testing.assert_array_equal(got, want)
    assert not got[0].any()


def test_kernel_wrappers_reject_cpu_tensors(points):
    _, enc = points
    pts = tmt._msm_pack_points(limbs_to_torch(enc[:8], "cpu"))
    sc = limbs_to_torch(ints_to_limbs(_scalars(8, 34)), "cpu")
    d, s = tmt._msm_prep_digits(sc, 6)
    with pytest.raises(ValueError):
        tmt._accum_k3(pts, d, s, 33)
    with pytest.raises(ValueError):
        tfb._accumulate_k5(tfb._table_for(g1_generator(), "cpu"), tfb._digits(sc))
