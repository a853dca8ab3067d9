"""Port parity: the staged limb-major NTT (plain K7/K8 on the CPU) against the
JAX package's EvaluationDomain and butterflies, exact."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scroll_prover_tpu.fields.limbs import FR_LIMB as JFR
from scroll_prover_tpu.ops import field_ops as jfo
from scroll_prover_tpu.ops.ntt import EvaluationDomain as JaxDomain
from scroll_prover_tpu.ops.ntt_fast import butterfly_t as jax_butterfly_t
from scroll_prover_tpu_torch.fields.limbs import FR_LIMB, limbs_from_torch, limbs_to_torch
from scroll_prover_tpu_torch.ops import field_ops as tfo
from scroll_prover_tpu_torch.ops import ntt_fast as tnf

torch.set_num_threads(2)


def _mont(n, seed):
    return tfo.rand_elements(FR_LIMB, np.random.default_rng(seed), n)


@pytest.mark.parametrize("k,radix", [(6, 2), (7, 4), (6, 4), (1, 2), (1, 4)])
def test_fast_domain_matches_jax(k, radix):
    """Radix 2, radix 4 at even k, and radix 4 at odd k (last level radix 2)."""
    x = _mont(1 << k, 80 + k)
    want = np.asarray(JaxDomain(k).ntt(jnp.asarray(x)))
    got = limbs_from_torch(tnf.FastDomain(k, radix=radix, device="cpu").ntt(limbs_to_torch(x, "cpu")))
    np.testing.assert_array_equal(got, want)


def _jax_level(x, tw, s):
    """One radix-2 DIF level on (n, 16) rows from JAX's plain field ops."""
    n = x.shape[0]
    half = n >> (s + 1)
    arr = x.reshape(1 << s, 2, half, 16)
    u, w = arr[:, 0], arr[:, 1]
    t = tw[(np.arange(half) << s) & (n // 2 - 1)]
    sm = jfo.add_mod(JFR, u, w)
    d = jfo.mont_mul(JFR, jfo.sub_mod(JFR, u, w), t)
    return jnp.stack([sm, d], axis=1).reshape(n, 16)


@pytest.mark.parametrize("s", [0, 2, 4])
def test_butterfly4_plain_matches_two_jax_levels(s):
    """Plain K8 at level pair (s, s+1) of n = 64 against two radix-2 levels
    of JAX's plain add_mod, sub_mod and mont_mul."""
    n = 64
    x, tw = _mont(n, 90 + s), _mont(n // 2, 91)
    want = _jax_level(_jax_level(jnp.asarray(x), jnp.asarray(tw), s), jnp.asarray(tw), s + 1)
    got = tnf._butterfly4_plain(limbs_to_torch(x.T, "cpu"), limbs_to_torch(tw.T, "cpu"), s)
    np.testing.assert_array_equal(limbs_from_torch(got).T, np.asarray(want))


@pytest.mark.parametrize("s", [0, 3, 5])
def test_butterfly_plain_matches_jax_level(s):
    n = 64
    x, tw = _mont(n, 100 + s), _mont(n // 2, 101)
    want = _jax_level(jnp.asarray(x), jnp.asarray(tw), s)
    got = tnf.butterfly_t(limbs_to_torch(x.T, "cpu"), limbs_to_torch(tw.T, "cpu"), s)
    np.testing.assert_array_equal(limbs_from_torch(got).T, np.asarray(want))


def test_butterfly_level0_matches_jax_kernel():
    """Level 0 of an n = 16 plane is the JAX kernel's (u, w, tw) call on its
    two halves (Pallas interpret mode, m = 8)."""
    m = 8
    u, w, t = _mont(m, 110), _mont(m, 111), _mont(m, 112)
    s_, d = jax_butterfly_t(jnp.asarray(u.T), jnp.asarray(w.T), jnp.asarray(t.T), interpret=True)
    want = np.concatenate([np.asarray(s_), np.asarray(d)], axis=1)
    x = limbs_to_torch(np.concatenate([u, w]).T, "cpu")
    got = tnf.butterfly_t(x, limbs_to_torch(t.T, "cpu"), 0)
    np.testing.assert_array_equal(limbs_from_torch(got), want)


def test_bad_level_and_radix_raise():
    x, tw = limbs_to_torch(_mont(16, 120).T, "cpu"), limbs_to_torch(_mont(8, 121).T, "cpu")
    with pytest.raises(ValueError):
        tnf.butterfly_t(x, tw, 4)
    with pytest.raises(ValueError):
        tnf.butterfly4_t(x, tw, 3)
    with pytest.raises(ValueError):
        tnf.FastDomain(4, radix=8, device="cpu")
