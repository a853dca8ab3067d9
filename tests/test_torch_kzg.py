"""Port parity: KZG — SRS generation, the JAX package's weights carried over
(srs_from_numpy, SRS.load of a JAX-written file), commitments and openings."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scroll_prover_tpu.fields.limbs import FR_LIMB as JFR
from scroll_prover_tpu.proof_system import kzg as jkzg
from scroll_prover_tpu_torch.fields.bn254 import FR_MOD
from scroll_prover_tpu_torch.fields.limbs import FR_LIMB, limbs_to_torch
from scroll_prover_tpu_torch.proof_system import kzg as tkzg

torch.set_num_threads(2)

K = 6


@pytest.fixture(scope="module")
def srs_pair():
    return jkzg.SRS.generate(K), tkzg.SRS.generate(K, device="cpu")


def _coeffs(seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % FR_MOD for _ in range(1 << K)]


def test_generate_matches_jax(srs_pair):
    j, t = srs_pair
    assert t.g1_powers == j.g1_powers
    assert t.g1_lagrange == j.g1_lagrange
    assert (t.g2, t.s_g2) == (j.g2, j.s_g2)


def test_generate_fast_matches_generate(srs_pair):
    """Device-path synthesis (fixed-base walk) gives the host points."""
    _, t = srs_pair
    f = tkzg.SRS.generate_fast(K, device="cpu")
    assert f.g1_powers == t.g1_powers and f.g1_lagrange == t.g1_lagrange


def test_srs_from_numpy(srs_pair):
    j, t = srs_pair
    s = tkzg.srs_from_numpy(
        K, np.asarray(j.dev_powers()), np.asarray(j.dev_lagrange()), j.g2, j.s_g2, device="cpu"
    )
    assert torch.equal(s.dev_powers(), t.dev_powers())
    assert torch.equal(s.dev_lagrange(), t.dev_lagrange())
    assert s.g1_powers == j.g1_powers


def test_load_jax_written_file(srs_pair, tmp_path):
    j, t = srs_pair
    path = tmp_path / "params6"
    j.save(str(path))
    s = tkzg.SRS.load(str(path), device="cpu")
    assert s.k == K and s.g1_powers == j.g1_powers and s.g1_lagrange == j.g1_lagrange
    assert (s.g2, s.s_g2) == (j.g2, j.s_g2)
    back = tmp_path / "params6.torch"
    s.save(str(back))
    assert back.read_bytes() == path.read_bytes()


@pytest.mark.parametrize("basis", ["monomial", "lagrange"])
def test_commit_matches_jax(srs_pair, basis):
    j, t = srs_pair
    c = _coeffs(51)
    want = jkzg.kzg_commit(j, jnp.asarray(JFR.encode(c, mont=True)), basis=basis)
    got = tkzg.kzg_commit(t, limbs_to_torch(FR_LIMB.encode(c, mont=True), "cpu"), basis=basis)
    assert got == want


def test_open_matches_jax_and_cross_verifies(srs_pair):
    j, t = srs_pair
    c = _coeffs(52)
    z = 0x1234567890ABCDEF % FR_MOD
    jc = jnp.asarray(JFR.encode(c, mont=True))
    tc = limbs_to_torch(FR_LIMB.encode(c, mont=True), "cpu")
    jv, jw = jkzg.kzg_open(j, jc, z)
    tv, tw = tkzg.kzg_open(t, tc, z)
    assert (tv, tw) == (jv, jw)
    com = tkzg.kzg_commit(t, tc)
    assert tkzg.verify_single_open(t, com, z, tv, tw)
    assert jkzg.verify_single_open(j, com, z, tv, tw)
    assert not tkzg.verify_single_open(t, com, z, (tv + 1) % FR_MOD, tw)


def test_prove_over_a_larger_srs():
    """A circuit at K = 6 proved over an SRS of 2^7 points: the port's value
    columns then commit over the monomial basis from transient coefficient
    forms (the Lagrange basis of a larger SRS is another domain's), and the
    proof bytes equal the JAX package's."""
    from scroll_prover_tpu.proof_system.plonk.keygen import keygen as jkeygen
    from scroll_prover_tpu.proof_system.plonk.prover import prove as jprove
    from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen as tkeygen
    from scroll_prover_tpu_torch.proof_system.plonk.prover import prove as tprove
    from scroll_prover_tpu_torch.proof_system.plonk.verifier import verify as tverify
    from tests.test_torch_plonk import INSTANCE, SEED, JaxMul, TorchMul

    js, ts = jkzg.SRS.generate(K + 1), tkzg.SRS.generate(K + 1, device="cpu")
    jc, tc = JaxMul(), TorchMul()
    jpk, _ = jkeygen(js, K, jc)
    tpk, tvk = tkeygen(ts, K, tc)
    tp = tprove(ts, tpk, tc, INSTANCE, seed=SEED)
    assert tp == jprove(js, jpk, jc, INSTANCE, seed=SEED)
    assert tverify(ts, tvk, INSTANCE, tp)
