"""Port parity for the host BLS12-381 code (curves/bls12_381.py,
curves/bls12_381_pairing.py) and the blob KZG built on it
(aggregator/blob.py): the twin of tests/test_bls12_381.py. Group laws and
the compressed encoding hold in the port; its Lagrange basis, commitments,
openings, pairings and point-evaluation proofs are equal to the JAX
package's, byte for byte."""
import pytest

from scroll_prover_tpu.aggregator import blob as jblob
from scroll_prover_tpu.curves import bls12_381 as jbls
from scroll_prover_tpu.curves import bls12_381_pairing as jbp
from scroll_prover_tpu_torch.aggregator import blob as tblob
from scroll_prover_tpu_torch.curves import bls12_381_pairing as bp
from scroll_prover_tpu_torch.curves.bls12_381 import (
    G1_GEN, R, g1_add, g1_compress, g1_decompress, g1_mul, g1_neg, is_on_curve,
)


@pytest.fixture(scope="module")
def kzgs():
    """Each package's blob KZG singleton (its Lagrange basis from its own
    disk cache, or built)."""
    return tblob._kzg(), jblob._kzg()


def test_group_laws():
    g = G1_GEN
    assert is_on_curve(g)
    assert is_on_curve(g1_add(g, g))
    assert g1_mul(g, R) is None  # group order
    assert g1_add(g, g1_neg(g)) is None
    assert g1_add(g1_add(g, g), g) == g1_mul(g, 3)
    for k in (3, 2**200 + 7, R - 1):
        assert g1_mul(g, k) == jbls.g1_mul(jbls.G1_GEN, k)


def test_compress_roundtrip():
    for k in (1, 2, 12345):
        p = g1_mul(G1_GEN, k)
        b = g1_compress(p)
        assert len(b) == 48 and b[0] & 0x80
        assert b == jbls.g1_compress(jbls.g1_mul(jbls.G1_GEN, k))
        assert g1_decompress(b) == p
    inf = g1_compress(None)
    assert inf[0] == 0xC0 and g1_decompress(inf) is None


def test_lagrange_basis_matches_jax(kzgs):
    """The port's basis, computed here through its fixed-base table (not
    read from a cache), equals the JAX package's."""
    from scroll_prover_tpu_torch.curves.bls12_381 import BlobKzg

    tk, jk = kzgs
    fresh = BlobKzg()
    assert fresh.tau == tk.tau == jk.tau
    assert fresh._lagrange_basis() == jk._lagrange_basis() == tk._lagrange_basis()


def test_fixed_base_matches_double_and_add():
    from scroll_prover_tpu_torch.curves.bls12_381 import _FixedBase

    mul = _FixedBase(G1_GEN)
    for k in (0, 1, 255, 256, 2**254 + 12345, R - 1, R + 5):
        assert mul(k) == g1_mul(G1_GEN, k) == jbls.g1_mul(jbls.G1_GEN, k)


def test_blob_kzg_commit_open(kzgs):
    """Commitment and opening witness equal to the JAX package's; the
    opening re-evaluates; the commitment is linear."""
    tk, jk = kzgs
    coeffs = [0] * 4096
    coeffs[0], coeffs[5], coeffs[4000] = 7, 9, R - 2
    com = tk.commit(coeffs)
    assert is_on_curve(com) and com is not None
    assert g1_compress(com) == jbls.g1_compress(jk.commit(coeffs))
    z = 0xABCDEF
    y, wit = tk.open_at(coeffs, z)
    assert (y, wit) == jk.open_at(coeffs, z)
    assert tk.verify_by_reeval(coeffs, z, y)
    assert is_on_curve(wit)
    com2 = tk.commit([2 * c % R for c in coeffs])
    assert com2 == g1_add(com, com)


def test_pairing_bilinear():
    g2 = bp.g2_generator()
    assert g2 == jbp.g2_generator()
    assert bp.g2_mul(g2, R) is None  # order r
    e1 = bp.pairing(G1_GEN, g2)
    assert e1 != bp.F12_ONE  # nondegenerate
    assert e1 == jbp.pairing(jbls.G1_GEN, jbp.g2_generator())
    e2 = bp.pairing(g1_mul(G1_GEN, 5), bp.g2_mul(g2, 7))
    assert e2 == bp.f12_pow(e1, 35)  # bilinear
    assert bp.pairing_check([(g1_mul(G1_GEN, 9), g2), (g1_neg(g1_mul(G1_GEN, 9)), g2)])


def test_point_evaluation_proof_verifies(kzgs):
    """The point-evaluation package (z, y, commitment, proof) is equal to
    the JAX package's; it verifies under the port's pairing and fails for a
    tampered y or z."""
    blob = bytes(range(256)) * 8
    pkg = tblob.point_evaluation_proof(blob, b"seed")
    assert pkg == jblob.point_evaluation_proof(blob, b"seed")
    assert tblob.blob_versioned_hash(blob) == jblob.blob_versioned_hash(blob)
    assert tblob.verify_blob_proof(pkg["commitment"], pkg["z"], pkg["y"], pkg["proof"])
    assert not tblob.verify_blob_proof(pkg["commitment"], pkg["z"], pkg["y"] + 1, pkg["proof"])
    assert not tblob.verify_blob_proof(pkg["commitment"], pkg["z"] + 1, pkg["y"], pkg["proof"])
