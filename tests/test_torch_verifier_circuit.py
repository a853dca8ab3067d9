"""Port parity for the in-circuit SNARK verifier (gadgets/plonk_verifier.py)
and the layer circuit around it (prover/verifier_circuit.py).

The inner proof is tests/test_torch_plonk.py's MulCircuit at K = 6, proved
by the port under GWC and SHPLONK (that file holds its bytes equal to the
JAX package's); the JAX package reads the port's vk bytes.
A counting run of the port's gadget (min_k()'s pass, captured) gives the
accumulator cells, which must equal the port's and the JAX package's
host accumulator (`instance_for()`, no gadget run) and pass the pairing;
one JAX counting run (SHPLONK, the ladder's scheme) gives the rows, min_k,
the layer circuit's columns, gates, lookups and copies, all equal. The
raw `max_gate_degree` differs (the port counts lookups): the derived
budget, which sets the domain, the quotient pieces and the permutation
chunks, is equal. Exact equality throughout: these are integers."""
import hashlib
import types

import pytest
import torch

from scroll_prover_tpu.proof_system.plonk import keygen as jkeygen_mod
from scroll_prover_tpu.proof_system.plonk import prover as jprover_mod
from scroll_prover_tpu.proof_system.plonk.keygen import VerifyingKey as JVerifyingKey
from scroll_prover_tpu.prover.verifier_circuit import VerifierCircuit as JVerifierCircuit
from scroll_prover_tpu_torch.proof_system import kzg as tkzg
from scroll_prover_tpu_torch.proof_system.plonk import keygen as tkeygen_mod
from scroll_prover_tpu_torch.proof_system.plonk import prover as tprover_mod
from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen as tkeygen
from scroll_prover_tpu_torch.proof_system.plonk.prover import prove as tprove
from scroll_prover_tpu_torch.proof_system.plonk.verifier import acc_from_limbs, check_accumulator
from scroll_prover_tpu_torch.proof_system.plonk.verifier import verify as tverify
from scroll_prover_tpu_torch.prover.verifier_circuit import ACC_CELLS, VerifierCircuit
from tests.test_torch_plonk import INSTANCE, K, TorchMul

torch.set_num_threads(2)

MULTIOPENS = ("gwc", "shplonk")
SEED = b"torch-vc-parity"


@pytest.fixture(scope="module")
def srs():
    return tkzg.SRS.generate(K, device="cpu")


@pytest.fixture(scope="module")
def inners(srs):
    """{mo: (jax vk, torch vk, proof)}: one MulCircuit proof per scheme by
    the port (tests/test_torch_plonk.py holds the proof and vk bytes equal
    to the JAX package's); the JAX package's vk is read from the port's vk
    bytes."""
    circ = TorchMul()
    pk, tvk = tkeygen(srs, K, circ)
    jvk = JVerifyingKey.from_bytes(tvk.to_bytes())
    out = {}
    for mo in MULTIOPENS:
        proof = tprove(srs, pk, circ, INSTANCE, seed=SEED, multiopen=mo)
        assert tverify(srs, tvk, INSTANCE, proof, multiopen=mo)
        out[mo] = (jvk, tvk, proof)
    return out


def _limbs(lhs, rhs) -> list[int]:
    out = []
    for pt in (lhs, rhs):
        for coord in pt:
            out += [(coord >> (88 * i)) & ((1 << 88) - 1) for i in range(3)]
    return out


def _copies_digest(copies) -> str:
    h = hashlib.sha256()
    for (a, ra), (b, rb) in copies:
        h.update(f"{a.kind}{a.index}:{ra},{b.kind}{b.index}:{rb};".encode())
    return h.hexdigest()


def _shape(cs) -> dict:
    return {
        "columns": (cs.num_advice, cs.num_fixed, cs.num_instance),
        "gates": [(name, e.degree(), sorted(e.queries())) for name, e in cs.gates],
        "lookups": [(lk.name, [sorted(e.queries()) for e in lk.inputs], [sorted(e.queries()) for e in lk.tables])
                    for lk in cs.lookups],
        "perm_columns": [(c.kind, c.index) for c in cs.perm_columns],
    }


def _counting(circ, keygen_mod, prover_mod) -> dict:
    """min_k() with its single gadget pass captured: k, rows, the
    accumulator limbs, the layer circuit's shape and degree budget, and a
    digest of the copies the gadget registered (min_k drops them from the
    cs afterwards)."""
    seen = {}
    run = circ._run

    def capture(cs, fixed, adv, n):
        n_copies = len(cs.copies)
        _b, _vg, lhs, rhs, _cells = out = run(cs, fixed, adv, n)
        j = keygen_mod._extended_j(cs)
        seen.update(acc=_limbs(lhs.value, rhs.value), shape=_shape(cs), copies=_copies_digest(cs.copies[n_copies:]),
                    degree=cs.max_gate_degree(), j=j, perm_chunks=prover_mod._perm_chunks(cs), cs=cs)
        return out

    circ._run = capture
    k = circ.min_k()
    del circ._run
    dom = types.SimpleNamespace(n=1 << k, extended_n=1 << (k + seen["j"]))
    seen["n_h"] = prover_mod._n_h(seen.pop("cs"), dom)
    return {"k": k, "rows": circ._rows, **seen}


@pytest.fixture(scope="module")
def torch_counts(inners):
    return {mo: _counting(VerifierCircuit(tvk, proof, INSTANCE[0], inner_multiopen=mo), tkeygen_mod, tprover_mod)
            for mo, (_jvk, tvk, proof) in inners.items()}


@pytest.fixture(scope="module")
def jax_count(inners):
    jvk, _tvk, proof = inners["shplonk"]
    return _counting(JVerifierCircuit(jvk, proof, INSTANCE[0], inner_multiopen="shplonk"), jkeygen_mod, jprover_mod)


@pytest.mark.parametrize("mo", MULTIOPENS)
def test_counting_acc_matches_instance_for(srs, inners, torch_counts, mo):
    """The gadget's accumulator cells equal the host accumulator of both
    packages, and the deferred pairing holds."""
    jvk, tvk, proof = inners[mo]
    want = VerifierCircuit(tvk, proof, INSTANCE[0], inner_multiopen=mo).instance_for()[0]
    jwant = JVerifierCircuit(jvk, proof, INSTANCE[0], inner_multiopen=mo).instance_for()[0]
    assert want == jwant
    assert torch_counts[mo]["acc"] == want[:ACC_CELLS]
    assert want[ACC_CELLS:] == INSTANCE[0]
    assert check_accumulator(srs, *acc_from_limbs(want[:ACC_CELLS]))


def test_rows_and_min_k_match_jax(torch_counts, jax_count):
    t = torch_counts["shplonk"]
    assert (t["rows"], t["k"]) == (jax_count["rows"], jax_count["k"])
    assert t["acc"] == jax_count["acc"]
    assert t["k"] == 21  # the layer over a K = 6 MulCircuit proof (1,125,619 rows)


def test_layer_circuit_shape_matches_jax(torch_counts, jax_count):
    t = torch_counts["shplonk"]
    for key in ("shape", "copies", "j", "n_h", "perm_chunks"):
        assert t[key] == jax_count[key], key
    # raw budgets differ (the port counts the range lookup, 2 + 2 + 1), the
    # derived ones (extended domain, quotient pieces, permutation chunks)
    # are equal: both floor the budget at 5
    assert (jax_count["degree"], t["degree"]) == (3, 5)


def _outcome(circ, srs):
    """'raised' when honest witness generation fails, else whether the
    accumulator's pairing holds, with the limbs."""
    try:
        limbs = circ.instance_for()[0][:ACC_CELLS]
    except (AssertionError, ValueError):
        return "raised"
    return check_accumulator(srs, *acc_from_limbs(limbs)), limbs


@pytest.mark.parametrize("tamper", ["proof", "instance"])
@pytest.mark.parametrize("mo", MULTIOPENS)
def test_tampered_inner_rejected(srs, inners, mo, tamper):
    """A tampered inner proof (GWC: a commitment byte; SHPLONK: the opening
    point W) or a wrong instance: honest witness generation fails, or the
    accumulator fails the pairing; the JAX package's host accumulator does
    the same."""
    jvk, tvk, proof = inners[mo]
    inst = INSTANCE[0]
    if tamper == "proof":
        bad = bytearray(proof)
        bad[7 if mo == "gwc" else -3] ^= 1
        proof = bytes(bad)
    else:
        inst = [8]
    got = _outcome(VerifierCircuit(tvk, proof, inst, inner_multiopen=mo), srs)
    assert got == "raised" or got[0] is False
    assert got == _outcome(JVerifierCircuit(jvk, proof, inst, inner_multiopen=mo), srs)


@pytest.mark.slow
def test_layer1_proof_bytes_identical(inners, monkeypatch):
    """Layer 1 over the SHPLONK inner proof, keygen, prove and verify in
    both packages: identical vk and proof bytes. 32 builder lanes (the
    JAX package's `scripts/prove_ladder20.py` setting) bring the layer from
    k = 21 to k = 16, within reach of a CPU."""
    from scroll_prover_tpu.proof_system import kzg as jkzg
    from scroll_prover_tpu.proof_system.plonk.keygen import keygen as jkeygen
    from scroll_prover_tpu.proof_system.plonk.prover import prove as jprove
    from scroll_prover_tpu.proof_system.plonk.verifier import verify as jverify

    monkeypatch.setenv("SPT_BUILDER_LANES", "32")
    jvk, tvk, proof = inners["shplonk"]
    jcirc = JVerifierCircuit(jvk, proof, INSTANCE[0], inner_multiopen="shplonk")
    tcirc = VerifierCircuit(tvk, proof, INSTANCE[0], inner_multiopen="shplonk")
    k = tcirc.min_k()
    assert k == jcirc.min_k()
    inst = tcirc.instance_for()
    assert inst == jcirc.instance_for()
    js, ts = jkzg.SRS.generate(k), tkzg.SRS.generate(k, device="cpu")
    jpk, jvk1 = jkeygen(js, k, jcirc)
    tpk, tvk1 = tkeygen(ts, k, tcirc)
    assert tvk1.to_bytes() == jvk1.to_bytes()
    tp = tprove(ts, tpk, tcirc, inst, seed=b"vc-l1", multiopen="shplonk")
    jp = jprove(js, jpk, jcirc, inst, seed=b"vc-l1", multiopen="shplonk")
    assert tp == jp
    assert tverify(ts, tvk1, inst, tp, multiopen="shplonk")
    assert jverify(js, jvk1, inst, jp, multiopen="shplonk")
    assert check_accumulator(ts, *acc_from_limbs(inst[0][:ACC_CELLS]))
