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
            else:  # the port keeps twmid as (n1, n2, 16), the layout its pass reads
                np.testing.assert_array_equal(limbs_from_torch(tm).transpose(2, 0, 1), np.asarray(jm))


def _lm_mul_plain(a, b):
    """The engine's former K1 twiddle product on (16, N) limb-major planes."""
    return tfo._mont_mul_plain(FR_LIMB, a.T, b.T).T.contiguous()


def test_plain_lm_mul_matches_jax_mont_mul():
    """The reference composition's twiddle product (`_lm_mul_plain`, on
    limb-major planes) against the JAX field product."""
    x, y = _mont(256, 26), _mont(256, 27)
    want = np.asarray(jfo.mont_mul(JFR, jnp.asarray(x), jnp.asarray(y))).T
    got = limbs_from_torch(_lm_mul_plain(limbs_to_torch(x.T, "cpu"), limbs_to_torch(y.T, "cpu")))
    np.testing.assert_array_equal(got, want)


def _old_level(x, tw, k, stride, twmid):
    """One level as the engine ran it before the passes: the strided rows
    transposed out, _bntt_plain, the twiddle product on limb-major planes,
    the rows transposed back. x: (C, n, 16) -> (C, n, 16)."""
    C, n, L = x.shape
    m = 1 << k
    v = x.permute(2, 0, 1).reshape(L, -1, stride * m)  # (16, C * groups, group)
    B = v.shape[1]
    a = v.reshape(L, B, m, stride).transpose(2, 3).contiguous()  # (16, B, S, m)
    a = tnt._bntt_plain(a.reshape(L, B * stride, m), tw, k)
    if twmid is not None:
        t = twmid.permute(2, 0, 1).reshape(L, 1, stride * m).expand(L, B, stride * m).reshape(L, -1)
        a = _lm_mul_plain(a.reshape(L, -1), t)
    a = a.reshape(L, B, stride, m).transpose(2, 3).contiguous()  # (16, B, m, S)
    return a.reshape(L, C, n).permute(1, 2, 0)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("k", [1, 4, 5, 9, 10])
def test_ntt_pass_matches_old_composition(k, B):
    """Plain K2, each level of the plan, against the former transpose,
    _bntt_plain, twiddle product, transpose."""
    td = tnt.TiledDomain(k, "cpu")
    n, kk = 1 << k, k
    for li, (tw, twmid) in enumerate(td._tables[False]):
        krow = kk if twmid is None else tnt.KMAX
        stride = 1 << (kk - krow)
        x = limbs_to_torch(np.stack([_mont(n, 40 + 7 * li + b) for b in range(B)]), "cpu")
        got = tnt._ntt_pass_plain(x, tw, krow, stride, twmid, None, None, None, False, False)
        np.testing.assert_array_equal(limbs_from_torch(got), limbs_from_torch(_old_level(x, tw, krow, stride, twmid)))
        kk -= krow


def _old_moves(k):
    """The former engine's transposes alone (row NTTs and products left
    out): position q of its output held the element at out[q] of the
    in-place layout."""

    def run(v, kk):
        if kk <= tnt.KMAX:
            return v
        B, n1, n2 = v.shape[0], 1 << (kk - tnt.KMAX), 1 << tnt.KMAX
        a = v.reshape(B, n2, n1).transpose(1, 2).reshape(B, n1, n2)
        a = a.transpose(1, 2).reshape(B * n2, n1)
        a = run(a, kk - tnt.KMAX)
        return a.reshape(B, n2, n1).transpose(1, 2).reshape(B, -1)

    return run(torch.arange(1 << k)[None], k)[0].numpy()


@pytest.mark.parametrize("k", [1, 4, 9, 10, 17, 20])
def test_pass_perm_is_stored_perm_plus_transposes(k):
    """The passes' final permutation, the k-bit reversal that the last pass
    applies to each position, is `_stored_perm` composed with the
    transposes they leave out."""
    np.testing.assert_array_equal(tnt._bitrev(k), _old_moves(k)[tnt._stored_perm(k)])


@pytest.fixture(scope="module")
def small_domains():
    return {k: (JaxDomain(k), tnt.TiledDomain(k, "cpu")) for k in (4, 10)}


@pytest.mark.parametrize("k", [4, 10])
@pytest.mark.parametrize("name", ["ntt", "intt", "ntt_batch", "intt_batch"])
def test_scale_matches_jax_multiply_then_transform(small_domains, k, name):
    """scale= multiplies before a forward and after an inverse transform:
    the JAX package's product then transform (transform then product)."""
    jd, td = small_domains[k]
    n = 1 << k
    s = _mont(n, 50)
    x = np.stack([_mont(n, 51), _mont(n, 52), _mont(n, 53)]) if "batch" in name else _mont(n, 51)
    jfn = getattr(jd, name.removesuffix("_batch"))
    if "batch" in name:
        jfn = lambda v, f=jfn: jnp.stack([f(c) for c in v])  # noqa: E731
    jx, js = jnp.asarray(x), jnp.asarray(s)
    if name.startswith("ntt"):
        want = jfn(jfo.mont_mul(JFR, jx, js))
    else:
        want = jfo.mont_mul(JFR, jfn(jx), js)
    got = getattr(td, name)(limbs_to_torch(x, "cpu"), scale=limbs_to_torch(s, "cpu"))
    np.testing.assert_array_equal(limbs_from_torch(got), np.asarray(want))
