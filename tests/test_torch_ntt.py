"""Port parity: the tiled four-step NTT (plain K1/K2 on the CPU) against the
JAX package's EvaluationDomain (scan NTT) and ntt_tile host plan, exact."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scroll_prover_tpu.fields.limbs import FR_LIMB as JFR
from scroll_prover_tpu.ops import field_ops as jfo
from scroll_prover_tpu.ops import ntt_tile as jnt
from scroll_prover_tpu.ops.ntt import EvaluationDomain as JaxDomain
from scroll_prover_tpu_torch.fields.limbs import FR_LIMB, limbs_from_torch, limbs_to_torch
from scroll_prover_tpu_torch.ops import field_ops as tfo
from scroll_prover_tpu_torch.ops import ntt_tile as tnt
from scroll_prover_tpu_torch.ops.ntt import EvaluationDomain as TorchDomain

torch.set_num_threads(2)

K, J = 10, 1  # one recursion level (KMAX = 8) plus the base kernel


@pytest.fixture(scope="module")
def domains():
    return JaxDomain(K, J), TorchDomain(K, J)


def _mont(n, seed):
    """n canonical field elements (any canonical value is a Montgomery form)."""
    return tfo.rand_elements(FR_LIMB, np.random.default_rng(seed), n)


@pytest.mark.parametrize("name", ["ntt", "intt", "ntt_extended", "intt_extended"])
def test_single_column_matches_jax(domains, name):
    jd, td = domains
    n = jd.extended_n if "extended" in name else jd.n
    x = _mont(n, 21)
    want = np.asarray(getattr(jd, name)(jnp.asarray(x)))
    got = limbs_from_torch(getattr(td, name)(limbs_to_torch(x, "cpu")))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["ntt_batch", "intt_batch", "ntt_extended_batch", "intt_extended_batch"])
def test_batch_matches_jax(domains, name):
    jd, td = domains
    n = jd.extended_n if "extended" in name else jd.n
    x = np.stack([_mont(n, 22), _mont(n, 23), _mont(n, 24)])
    want = np.asarray(getattr(jd, name)(jnp.asarray(x)))
    got = limbs_from_torch(getattr(td, name)(limbs_to_torch(x, "cpu")))
    np.testing.assert_array_equal(got, want)


def test_plain_bntt_matches_jax_interpret():
    """Plain K2 against the Pallas kernel body in interpret mode at k = 4."""
    k, B = 4, 8
    w = TorchDomain(k).omega
    tw = tnt._twpack(w, k, "cpu")
    v = np.ascontiguousarray(_mont(B << k, 25).reshape(B, 1 << k, 16).transpose(2, 0, 1))
    want = np.asarray(jnt._bntt(jnp.asarray(v), jnp.asarray(limbs_from_torch(tw)), k, interpret=True))
    got = limbs_from_torch(tnt._bntt_plain(limbs_to_torch(v, "cpu"), tw, k))
    np.testing.assert_array_equal(got, want)


def test_host_plan_matches_jax():
    """Pease stage twiddles, level tables and the composed permutation."""
    jtd = jnt.TiledDomain(K, interpret=True)
    ttd = tnt.TiledDomain(K, "cpu")
    np.testing.assert_array_equal(tnt._stored_perm(K), jnt._stored_perm(K))
    for inverse in (False, True):
        for (jp, jm), (tp, tm) in zip(jtd._tables[inverse], ttd._tables[inverse]):
            np.testing.assert_array_equal(limbs_from_torch(tp), np.asarray(jp))
            if jm is None:
                assert tm is None
            else:
                np.testing.assert_array_equal(limbs_from_torch(tm), np.asarray(jm))


def test_plain_lm_mul_matches_jax_mont_mul():
    """Plain K1 on limb-major planes against the JAX field product."""
    x, y = _mont(256, 26), _mont(256, 27)
    want = np.asarray(jfo.mont_mul(JFR, jnp.asarray(x), jnp.asarray(y))).T
    got = limbs_from_torch(tnt.lm_mul(limbs_to_torch(x.T, "cpu"), limbs_to_torch(y.T, "cpu")))
    np.testing.assert_array_equal(got, want)
