"""The Keccak-transcript layer 1 and the full EVM verifier tail in the port,
the twin of tests/test_ladder_evm_tail.py at toy scale.

The outermost compression layer proves with the Keccak transcript and GWC
so that the proof is EVM-verifiable (SURVEY §3.2 layer 6): here a
VerifierCircuit over the K = 6 MulCircuit proof, proved by the port with
the Keccak transcript, verified on the host with its accumulator folded,
then checked by the generated in-bytecode verifier (has_accumulator=True)
in the port's interpreter. The JAX package's generator, given the same vk
(read from the port's vk bytes), emits the same bytecode and YUL, and its
interpreter accepts the port's proof with the same gas; a flipped proof
bit and a changed accumulator limb revert in both.

Slow: 16 builder lanes bring the toy layer to k ~ 17, a keygen and a prove
of minutes on the CPU."""
import pytest
import torch

from scroll_prover_tpu.evm import full_verifier as jfv
from scroll_prover_tpu.evm import interpreter as jevm
from scroll_prover_tpu.proof_system.plonk.keygen import VerifyingKey as JVerifyingKey
from scroll_prover_tpu_torch.evm import full_verifier as tfv
from scroll_prover_tpu_torch.evm import interpreter as tevm
from scroll_prover_tpu_torch.proof_system import kzg
from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen
from scroll_prover_tpu_torch.proof_system.plonk.prover import prove
from scroll_prover_tpu_torch.proof_system.plonk.verifier import acc_from_limbs, verify
from scroll_prover_tpu_torch.proof_system.transcript import KeccakTranscript
from scroll_prover_tpu_torch.prover.verifier_circuit import ACC_CELLS, VerifierCircuit
from tests.test_torch_plonk import INSTANCE, K as INNER_K, TorchMul

torch.set_num_threads(4)


def _reverts(evm, code, calldata) -> bool:
    try:
        evm.deploy_and_call(code, calldata)
    except evm.EvmRevert:
        return True
    return False


@pytest.mark.slow
def test_keccak_layer1_evm_replay(monkeypatch):
    # wide lanes pack the toy verifier gadget into a CPU-sized domain
    monkeypatch.setenv("SPT_BUILDER_LANES", "16")
    monkeypatch.setenv("SPT_BUILDER_LOOKUP_COLS", "64")

    srs = kzg.SRS.generate(INNER_K, device="cpu")
    circuit = TorchMul()
    pk, vk = keygen(srs, INNER_K, circuit)
    proof = prove(srs, pk, circuit, INSTANCE, seed=b"evm-tail")
    assert verify(srs, vk, INSTANCE, proof)

    l1 = VerifierCircuit(vk, proof, INSTANCE[0])
    k1 = l1.min_k()
    srs1 = kzg.SRS.generate(k1, device="cpu")
    pk1, vk1 = keygen(srs1, k1, l1)
    ci = l1.instance_for()
    proof1 = prove(srs1, pk1, l1, ci, seed=b"evm-tail-l1", transcript_cls=KeccakTranscript)
    assert verify(srs1, vk1, ci, proof1, transcript_cls=KeccakTranscript,
                  fold_accumulator=acc_from_limbs(ci[0][:ACC_CELLS]))

    code, yul = tfv.gen_full_verifier(vk1, srs1, len(ci[0]), has_accumulator=True)
    jcode, jyul = jfv.gen_full_verifier(JVerifyingKey.from_bytes(vk1.to_bytes()), srs1, len(ci[0]),
                                        has_accumulator=True)
    assert (code, yul) == (jcode, jyul)
    assert yul.startswith('object "plonk_verifier"')

    calldata = tfv.proof_calldata(ci[0], proof1)
    assert calldata == jfv.proof_calldata(ci[0], proof1)
    gas = tevm.deploy_and_call(code, calldata)
    assert gas == jevm.deploy_and_call(jcode, calldata) > 100_000

    # one proof bit: the transcript diverges
    bad = bytearray(proof1)
    bad[len(bad) // 2] ^= 1
    # one accumulator limb: the folded pairing fails
    bad_inst = list(ci[0])
    bad_inst[0] = (bad_inst[0] + 1) % (1 << 88)
    for evm in (tevm, jevm):
        assert _reverts(evm, code, tfv.proof_calldata(ci[0], bytes(bad)))
        assert _reverts(evm, code, tfv.proof_calldata(bad_inst, proof1))
