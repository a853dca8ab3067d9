"""The port's group iNTT over G1 (ops/group_ntt.py) and SRS.downsize against
the JAX package, on the CPU, exact equality: twins of
tests/test_params_and_env.py's two downsize tests (one on an SRS made by
generate_fast, whose host lists stay lazy, one on a host SRS), the group
iNTT's host wrapper against the JAX package's on the same points, ec.neg
and ec.add_reduce limb for limb, ops/ntt.py's host tables, and
prover/provers.py's downsize cache."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scroll_prover_tpu.curves.bn254_curve import G1 as JG1
from scroll_prover_tpu.ops import ec as jec
from scroll_prover_tpu.ops import group_ntt as jgn
from scroll_prover_tpu.ops import ntt as jntt
from scroll_prover_tpu.proof_system import kzg as jkzg
from scroll_prover_tpu_torch.curves.bn254_curve import G1, g1_generator
from scroll_prover_tpu_torch.fields.limbs import FR_LIMB, limbs_from_torch, limbs_to_torch
from scroll_prover_tpu_torch.ops import ec
from scroll_prover_tpu_torch.ops import group_ntt as tgn
from scroll_prover_tpu_torch.ops import ntt as tntt
from scroll_prover_tpu_torch.proof_system import kzg
from scroll_prover_tpu_torch.prover.provers import _downsized

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fast6():
    return kzg.SRS.generate_fast(6, device="cpu")


@pytest.fixture(scope="module")
def small4(fast6):
    return _downsized(fast6, 4)


@pytest.fixture(scope="module")
def jax_lag4():
    """The JAX package's group iNTT of its k = 6 SRS's first 16 powers."""
    return jgn.group_intt_points(jkzg.SRS.generate(6).g1_powers[:16], 4)


def test_downsize_preserves_g2_and_truncates(fast6, small4, jax_lag4):
    """tests/test_params_and_env.py:11 on an SRS made on the (CPU) device: the
    Lagrange view is rebuilt without decoding either SRS to host lists, and
    equals generate_fast(4)'s and the JAX package's group iNTT."""
    assert small4._g1_powers is None and small4._g1_lagrange is None and fast6._g1_powers is None
    assert torch.equal(small4.dev_powers(), fast6.dev_powers()[:16])
    assert torch.equal(small4.dev_lagrange(), kzg.SRS.generate_fast(4, device="cpu").dev_lagrange())
    assert small4.g2 is fast6.g2 and small4.s_g2 is fast6.s_g2
    assert small4.n == 16
    assert small4.g1_powers == fast6.g1_powers[:16]
    acc = None
    for pt in small4.g1_lagrange:  # the Lagrange points sum to the all-ones polynomial's commitment, G
        acc = G1.add(acc, pt)
    assert acc == small4.g1_powers[0]
    assert small4.g1_lagrange == jax_lag4


def test_downsize_group_intt_exact():
    """tests/test_params_and_env.py:32 on a host SRS: downsize(5) of k = 7
    equals generate(5) and the JAX package's downsize(5)."""
    small = kzg.SRS.generate(7, device="cpu").downsize(5)
    assert small.g1_lagrange == kzg.SRS.generate(5, device="cpu").g1_lagrange
    assert small.g1_lagrange == jkzg.SRS.generate(7).downsize(5).g1_lagrange


def test_group_intt_points_matches_jax(fast6, small4, jax_lag4):
    got = tgn.group_intt_points(fast6.g1_powers[:16], 4, device="cpu")
    assert got == jax_lag4 == small4.g1_lagrange


def _points(n, seed):
    rng = np.random.default_rng(seed)
    g = g1_generator()
    return [G1.mul(g, int(rng.integers(1, 2**62))) for _ in range(n)]


@pytest.mark.parametrize("n", [1, 5, 8])
def test_ec_neg_and_add_reduce_match_jax(n):
    pts = _points(n, 0x5C2011 + n)
    aff = ec.encode_affine_mont(pts)
    tp = ec.from_affine(limbs_to_torch(aff, "cpu"))
    jp = jec.from_affine(jnp.asarray(aff))
    for got, want in zip(ec.neg(tp), jec.neg(jp)):
        np.testing.assert_array_equal(limbs_from_torch(got), np.asarray(want))
    red, jred = ec.add_reduce(tp), jec.add_reduce(jp)
    for got, want in zip(red, jred):
        np.testing.assert_array_equal(limbs_from_torch(got), np.asarray(want))
    total = None
    for pt in pts:
        total = JG1.add(total, pt)
    assert ec.decode_point(red) == total


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_ntt_host_tables_match_jax(n):
    np.testing.assert_array_equal(tntt._bitrev_indices(n), jntt._bitrev_indices(n))
    w = FR_LIMB.modulus - 5
    np.testing.assert_array_equal(tntt._powers_mont(FR_LIMB, w, n), jntt._powers_mont(jntt.FR_LIMB, w, n))


def test_downsized_cache(fast6, small4):
    assert _downsized(fast6, 4) is small4
    assert _downsized(fast6, 6) is fast6
    with pytest.raises(AssertionError):
        _downsized(fast6, 7)
