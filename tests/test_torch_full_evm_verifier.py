"""Port parity for the EVM verifier (evm/full_verifier.py, evm/verifier_contract.py,
evm/harness.py), the twin of tests/test_full_evm_verifier.py at K = 6.

One module-scoped setup per package proves tests/test_torch_plonk.py's
MulCircuit with the Keccak transcript under GWC (the EVM-facing layer's
settings) and generates the full in-bytecode verifier. Then:

- the deployment bytecode and the YUL source are equal byte for byte, and so
  are the proofs;
- each package's bytecode, read back through its EVMVerifier harness and
  run in its own interpreter, accepts the other package's proof with the
  same gas;
- a proof with a flipped bit and a wrong instance revert in both;
- for the 12-accumulator-cell circuit with has_accumulator=True, proved by
  the port (the JAX package's generator takes the vk read from the port's
  vk bytes): bytecode and YUL equal, the valid deferred pairing accepted by
  both interpreters with the same gas, a changed limb and an unpaired
  accumulator reverting in both;
- the pairing-only contract (gen_verifier_bytecode) is equal and accepts the
  host's pairing inputs with the same gas.

The degree budget: MulCircuit's lookup is degree 5 (2 + 2 + 1), so the
port's budget (which counts lookups) and the JAX package's (gates only,
floored at 5) give the same quotient pieces and permutation chunks."""
import hashlib
from types import SimpleNamespace

import pytest
import torch

from scroll_prover_tpu.curves import bn254_curve as jcurve
from scroll_prover_tpu.evm import full_verifier as jfv
from scroll_prover_tpu.evm import harness as jharness
from scroll_prover_tpu.evm import interpreter as jevm
from scroll_prover_tpu.evm import verifier_contract as jvc
from scroll_prover_tpu.proof_system import kzg as jkzg
from scroll_prover_tpu.proof_system import transcript as jtranscript
from scroll_prover_tpu.proof_system.plonk import keygen as jkeygen
from scroll_prover_tpu.proof_system.plonk import prover as jprover
from scroll_prover_tpu.proof_system.plonk import verifier as jverifier
from scroll_prover_tpu_torch.curves import bn254_curve as tcurve
from scroll_prover_tpu_torch.evm import full_verifier as tfv
from scroll_prover_tpu_torch.evm import harness as tharness
from scroll_prover_tpu_torch.evm import interpreter as tevm
from scroll_prover_tpu_torch.evm import verifier_contract as tvc
from scroll_prover_tpu_torch.fields.bn254 import FR_MOD
from scroll_prover_tpu_torch.proof_system import kzg as tkzg
from scroll_prover_tpu_torch.proof_system import transcript as ttranscript
from scroll_prover_tpu_torch.proof_system.plonk import Circuit as TorchCircuit
from scroll_prover_tpu_torch.proof_system.plonk import cs as tcs
from scroll_prover_tpu_torch.proof_system.plonk import keygen as tkeygen
from scroll_prover_tpu_torch.proof_system.plonk import prover as tprover
from scroll_prover_tpu_torch.proof_system.plonk import verifier as tverifier
from tests.test_torch_plonk import INSTANCE, K, JaxMul, TorchMul

torch.set_num_threads(2)

PKGS = {
    "jax": SimpleNamespace(
        srs=lambda: jkzg.SRS.generate(K), keygen=jkeygen.keygen, prove=jprover.prove, verifier=jverifier,
        keccak=jtranscript.KeccakTranscript, fv=jfv, evm=jevm, vc=jvc, harness=jharness, curve=jcurve,
        mul=JaxMul),
    "torch": SimpleNamespace(
        srs=lambda: tkzg.SRS.generate(K, device="cpu"), keygen=tkeygen.keygen, prove=tprover.prove,
        verifier=tverifier, keccak=ttranscript.KeccakTranscript, fv=tfv, evm=tevm, vc=tvc, harness=tharness,
        curve=tcurve, mul=TorchMul),
}
OTHER = {"jax": "torch", "torch": "jax"}
SEED = b"evm-full"
ACC_SEED = b"acc"
# the toy SRS's tau (SRS.generate's default seed in both packages)
TAU = int.from_bytes(hashlib.sha512(b"scroll-prover-tpu-test-srs").digest(), "little") % FR_MOD


class TorchAcc(TorchCircuit):
    """tests/test_full_evm_verifier.py's _AccCircuit: 12 leading
    accumulator-limb instance cells (the bundle layer-6 instance shape) and
    one squared-witness public input copied from advice."""

    def __init__(self, acc12):
        self.acc12 = acc12

    def instance_list(self):
        return [self.acc12 + [49]]

    def configure(self, cs):
        self.a = cs.advice_column()
        self.sel = cs.selector()
        self.pi = cs.instance_column()
        cs.gate("sq", self.sel.query() * (self.a.query() * self.a.query() - self.a.query(1)))

    def assign(self, cs, n, instance):
        fixed = tcs.empty_assignment(cs.num_fixed, n)
        adv = tcs.empty_assignment(cs.num_advice, n)
        adv[self.a.index][0] = 7
        adv[self.a.index][1] = 49
        fixed[self.sel.index][0] = 1
        cs.copy(self.pi, 12, self.a, 1)  # instance[12] == 49
        return {"fixed": fixed, "advice": adv}


def _calldata(m, inst, proof):
    return m.fv.proof_calldata(list(inst), proof)


def _revert(m, code, calldata) -> bool:
    try:
        m.evm.deploy_and_call(code, calldata)
    except m.evm.EvmRevert:
        return True
    return False


@pytest.fixture(scope="module")
def mul():
    """{package: (srs, vk, Keccak GWC proof, bytecode, yul)} for MulCircuit."""
    out = {}
    for name, m in PKGS.items():
        srs = m.srs()
        circ = m.mul()
        pk, vk = m.keygen(srs, K, circ)
        proof = m.prove(srs, pk, circ, INSTANCE, transcript_cls=m.keccak, seed=SEED)
        code, yul = m.fv.gen_full_verifier(vk, srs, len(INSTANCE[0]))
        out[name] = (srs, vk, proof, code, yul)
    return out


@pytest.fixture(scope="module")
def acc():
    """The accumulator circuit over a valid deferred pairing (R = tau * L),
    proved by the port: (instance, proof, L, {package: (bytecode, yul)})."""
    srs = tkzg.SRS.generate(K, device="cpu")
    lhs = tcurve.G1.mul(tcurve.g1_generator(), 123456789)
    acc12 = tverifier.acc_limbs(lhs, tcurve.G1.mul(lhs, TAU))
    circ = TorchAcc(acc12)
    pk, vk = tkeygen.keygen(srs, K, circ)
    inst = circ.instance_list()
    proof = tprover.prove(srs, pk, circ, inst, transcript_cls=ttranscript.KeccakTranscript, seed=ACC_SEED)
    jvk = jkeygen.VerifyingKey.from_bytes(vk.to_bytes())
    codes = {"torch": tfv.gen_full_verifier(vk, srs, len(inst[0]), has_accumulator=True),
             "jax": jfv.gen_full_verifier(jvk, srs, len(inst[0]), has_accumulator=True)}
    return inst[0], proof, lhs, codes


def test_mul_bytecode_yul_and_proof_identical(mul):
    _s, tvk, tproof, tcode, tyul = mul["torch"]
    _s, jvk, jproof, jcode, jyul = mul["jax"]
    assert tvk.to_bytes() == jvk.to_bytes()
    assert tproof == jproof
    assert tcode == jcode
    assert tyul == jyul
    assert tyul.startswith('object "plonk_verifier"')
    some_commit = next(c for c in tvk.fixed_commitments if c is not None)
    assert f"{some_commit[0]:#x}" in tyul


def test_mul_each_bytecode_accepts_the_other_proof(mul, tmp_path):
    """Through the EVMVerifier harness: each package's bytecode, written as
    DEPLOYMENT_CODE_FILENAME and read back by from_dirs, accepts the other
    package's proof in its own interpreter with the same gas."""
    assert tharness.DEPLOYMENT_CODE_FILENAME == jharness.DEPLOYMENT_CODE_FILENAME == "evm_verifier.bin"
    gas = {}
    for name, m in PKGS.items():
        out = tmp_path / name
        out.mkdir()
        (out / m.harness.DEPLOYMENT_CODE_FILENAME).write_bytes(mul[name][3])
        v = m.harness.EVMVerifier.from_dirs(str(out))
        assert v.deployment_code == mul[name][3]
        gas[name] = v.verify_evm_proof(_calldata(m, INSTANCE[0], mul[OTHER[name]][2]))
    assert gas["torch"] == gas["jax"] > 100_000


@pytest.mark.parametrize("where", ["commitment", "middle", "last word"])
@pytest.mark.parametrize("name", sorted(PKGS))
def test_mul_tampered_proof_bits_revert(mul, name, where):
    m = PKGS[name]
    _s, _vk, proof, code, _yul = mul[name]
    bad = bytearray(proof)
    bad[{"commitment": 0, "middle": len(proof) // 2, "last word": len(proof) - 32}[where]] ^= 1
    assert _revert(m, code, _calldata(m, INSTANCE[0], bytes(bad)))


@pytest.mark.parametrize("name", sorted(PKGS))
def test_mul_wrong_instance_reverts(mul, name):
    m = PKGS[name]
    _s, _vk, proof, code, _yul = mul[name]
    assert _revert(m, code, _calldata(m, [(INSTANCE[0][0] + 1) % 1000], proof))


def test_acc_bytecode_identical_and_same_gas(acc):
    inst, proof, _lhs, codes = acc
    assert codes["torch"] == codes["jax"]
    gas = {name: m.evm.deploy_and_call(codes[name][0], _calldata(m, inst, proof)) for name, m in PKGS.items()}
    assert gas["torch"] == gas["jax"] > 100_000


@pytest.mark.parametrize("case", ["changed limb", "unpaired accumulator"])
@pytest.mark.parametrize("name", sorted(PKGS))
def test_acc_tampered_accumulator_reverts(acc, name, case):
    m = PKGS[name]
    inst, proof, lhs, codes = acc
    if case == "changed limb":
        bad = list(inst)
        bad[0] = (bad[0] + 1) % (1 << 88)
    else:  # on curve, but R != tau * L (the transcript diverges too)
        bad = m.verifier.acc_limbs(lhs, m.curve.G1.mul(lhs, TAU + 1)) + [49]
    assert _revert(m, codes[name][0], _calldata(m, bad, proof))


def test_pairing_only_contract_matches_jax(mul):
    """gen_verifier_bytecode: the same bytes in both packages; each accepts
    the host's pairing inputs of the port's proof with the same gas and
    reverts on a changed coordinate."""
    srs, vk, proof, _code, _yul = mul["torch"]
    a_pt, b_pt = tverifier.verify(srs, vk, INSTANCE, proof, transcript_cls=ttranscript.KeccakTranscript,
                                  return_pairing_inputs=True)
    calldata = b"".join(v.to_bytes(32, "big") for v in (*a_pt, *b_pt))
    codes = {name: m.vc.gen_verifier_bytecode(mul[name][0].g2, mul[name][0].s_g2) for name, m in PKGS.items()}
    assert codes["torch"] == codes["jax"]
    gas = {name: m.evm.deploy_and_call(codes[name], calldata) for name, m in PKGS.items()}
    assert gas["torch"] == gas["jax"] > 100_000
    bad = bytearray(calldata)
    bad[40] ^= 1
    for name, m in PKGS.items():
        assert _revert(m, codes[name], bytes(bad))


def test_harness_returns_none_on_revert(mul, tmp_path):
    """EVMVerifier.verify_evm_proof gives None, not gas, for a reverting
    call, in both packages."""
    (tmp_path / tharness.DEPLOYMENT_CODE_FILENAME).write_bytes(mul["torch"][3])
    bad = bytearray(mul["torch"][2])
    bad[0] ^= 1
    for name, m in PKGS.items():
        assert m.harness.EVMVerifier.from_dirs(str(tmp_path)).verify_evm_proof(
            _calldata(m, INSTANCE[0], bytes(bad))) is None
