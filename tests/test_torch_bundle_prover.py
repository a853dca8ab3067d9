"""Port parity for the bundle side of the prover facade (prover/provers.py
BatchProver.gen_bundle_proof, _dump_release_artifacts, evm_verify_bundle,
BatchVerifier.verify_bundle_proof, prover/proofs.py BundleProof,
integration/prove.py prove_and_verify_bundle), which proves no layer 5 or 6
here (each is at least 2^21 rows).

`_prove_circuit` is replaced by a recorder in both packages. It returns a
stub layer-5 payload and, for layer 6, one real proof made once by the port:
a K = 6 circuit with 12 accumulator cells (a valid deferred pairing) and the
instance layer 6 would carry, proved with the Keccak transcript under GWC.
The JAX package's vk is read from the port's vk bytes. Then:

- the chain links and exposed cells, and gen_bundle_proof's layer inputs
  (context, links, exposed cells, inner multiopen, transcript and multiopen
  of each layer) are equal;
- a broken batch chain, a missing layer-4 vk and mixed multiopens are
  refused by both;
- prove_and_verify_bundle writes the same BundleProof JSON and the same four
  release files in both packages, BundleProof's JSON and calldata() are
  equal, and evm_verify_bundle accepts with the same gas (None for a flipped
  proof byte);
- verify_bundle_proof's verdicts are equal, with the real layer check
  (honest, a flipped proof byte, a missing vk) and with `_verify_layer`
  accepting (pass-through mismatch, wrong last hash, malformed layout).

Headers use the stub blob commitment (SPT_STUB_BLOB_KZG), as in
tests/test_torch_batch_prover.py."""
import dataclasses
import hashlib
import os

import pytest
import torch

from scroll_prover_tpu.aggregator.batch_header import BatchHeader as JBatchHeader
from scroll_prover_tpu.integration import prove as jintegration
from scroll_prover_tpu.proof_system import kzg as jkzg
from scroll_prover_tpu.proof_system.plonk.keygen import VerifyingKey as JVerifyingKey
from scroll_prover_tpu.prover import chunk_info as jci
from scroll_prover_tpu.prover import proofs as jproofs
from scroll_prover_tpu.prover import protocol as jprotocol
from scroll_prover_tpu.prover import provers as jprovers
from scroll_prover_tpu.prover import tasks as jtasks
from scroll_prover_tpu.prover.aggregation_circuit import AggregationCircuit as JAggregationCircuit
from scroll_prover_tpu_torch.aggregator.batch_header import BatchHeader as TBatchHeader
from scroll_prover_tpu_torch.curves.bn254_curve import G1, g1_generator
from scroll_prover_tpu_torch.fields.bn254 import FR_MOD
from scroll_prover_tpu_torch.integration import prove as tintegration
from scroll_prover_tpu_torch.proof_system import kzg as tkzg
from scroll_prover_tpu_torch.proof_system.plonk import Circuit as TorchCircuit
from scroll_prover_tpu_torch.proof_system.plonk.cs import empty_assignment
from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen as tkeygen
from scroll_prover_tpu_torch.proof_system.plonk.prover import prove as tprove
from scroll_prover_tpu_torch.proof_system.plonk.verifier import acc_limbs
from scroll_prover_tpu_torch.proof_system.transcript import KeccakTranscript
from scroll_prover_tpu_torch.prover import chunk_info as tci
from scroll_prover_tpu_torch.prover import proofs as tproofs
from scroll_prover_tpu_torch.prover import protocol as tprotocol
from scroll_prover_tpu_torch.prover import provers as tprovers
from scroll_prover_tpu_torch.prover import tasks as ttasks
from scroll_prover_tpu_torch.prover.aggregation_circuit import AggregationCircuit as TAggregationCircuit
from scroll_prover_tpu_torch.prover.verifier_circuit import ACC_CELLS

torch.set_num_threads(2)

PKGS = {
    "jax": dict(provers=jprovers, proofs=jproofs, protocol=jprotocol, ci=jci, tasks=jtasks, header=JBatchHeader,
                integ=jintegration, agg=JAggregationCircuit, srs=lambda: jkzg.SRS.generate(K)),
    "torch": dict(provers=tprovers, proofs=tproofs, protocol=tprotocol, ci=tci, tasks=ttasks, header=TBatchHeader,
                  integ=tintegration, agg=TAggregationCircuit, srs=lambda: tkzg.SRS.generate(K, device="cpu")),
}
K = 6
N_BATCHES = 2
SEED = b"bundle-layer6"
DIGEST = 49  # the stub layer 5's digest cell, which the layer-6 stand-in copies from advice
M128 = (1 << 128) - 1
TAU = int.from_bytes(hashlib.sha512(b"scroll-prover-tpu-test-srs").digest(), "little") % FR_MOD
RELEASE_FILES = ("evm_verifier.bin", "evm_verifier.yul", "pi_bundle_recursion.data", "proof_bundle_recursion.data",
                 "full_proof_bundle_recursion.json")


class _Layer6(TorchCircuit):
    """The layer-6 stand-in: instance [12 accumulator cells || the bundle
    tail], its first tail cell (the digest) copied from a squared witness."""

    def configure(self, cs):
        self.a = cs.advice_column()
        self.sel = cs.selector()
        self.pi = cs.instance_column()
        cs.gate("sq", self.sel.query() * (self.a.query() * self.a.query() - self.a.query(1)))

    def assign(self, cs, n, instance):
        fixed = empty_assignment(cs.num_fixed, n)
        adv = empty_assignment(cs.num_advice, n)
        adv[self.a.index][0] = 7
        adv[self.a.index][1] = DIGEST
        fixed[self.sel.index][0] = 1
        cs.copy(self.pi, ACC_CELLS, self.a, 1)
        return {"fixed": fixed, "advice": adv}


def _root(i: int) -> str:
    return "0x" + f"{i:02x}" * 32


def _halves(v: int) -> list[int]:
    return [v >> 128, v & M128]


def _batch_proofs(m, vk, broken=False, mos=None) -> list:
    """N_BATCHES chained batch proofs (batch i goes from root i to root
    i + 1, its header's parent the previous header's hash); each layer 4
    carries the batch's statement cells after 12 accumulator cells."""
    out = []
    parent = b"\x11" * 32
    for i in range(N_BATCHES):
        info = m["ci"].ChunkInfo(
            chain_id=534352, prev_state_root=_root(i), post_state_root=_root(i + 1), withdraw_root=_root(0xAA),
            data_hash="0x" + f"{0xD0 + i:02x}" * 32, tx_bytes=bytes([i + 1]) * 40)
        blob = m["integ"].get_blob_from_chunks([info])
        header = m["header"].construct_from_chunks(4, 10 + i, 0, 0, parent, 5, [info], blob)
        parent = b"\x22" * 32 if broken else header.batch_hash()
        bh = header.batch_hash()
        z, y = header.blob_data_proof
        tail = ([1234] + _halves(int.from_bytes(bh, "big")) + _halves(z) + _halves(y) + [77, info.chain_id]
                + _halves(int(info.prev_state_root, 16)) + _halves(int(info.post_state_root, 16))
                + _halves(int(info.data_hash, 16)))
        layers = []
        for acc0 in (10, 20):
            inst = list(range(acc0 + 100 * i, acc0 + 100 * i + ACC_CELLS)) + tail
            mo = (mos or ["shplonk"] * N_BATCHES)[i]
            layers.append(m["proofs"].ProofPayload(
                proof=bytes([i]) * 96, instances=inst,
                protocol=m["protocol"].protocol_from_vk(vk, len(inst), multiopen=mo), vk_id=hex(vk.transcript_repr())))
        out.append(m["proofs"].BatchProofV2(m["proofs"].BatchProofInner(
            layers=layers, batch_hash=bh, batch_header=header, blob_bytes=blob, chunk_infos=[info])))
    return out


def _layer5_tail(batch_proofs) -> list[int]:
    """What layer 5 carries after its 12 accumulator cells: the digest, the
    bundle context, then the exposed cells of the batches' layer 4s."""
    headers = [p.inner.batch_header for p in batch_proofs]
    fp, lh = headers[0].parent_batch_hash, headers[-1].batch_hash()
    ctx = _halves(int.from_bytes(fp, "big")) + _halves(int.from_bytes(lh, "big")) + [len(batch_proofs)]
    l4 = [p.inner.layers[-1].instances for p in batch_proofs]
    return [DIGEST] + ctx + [l4[i][off] for i, off in tprovers._bundle_expose(len(batch_proofs))]


@pytest.fixture(scope="module")
def layer6():
    """{package: vk}, the layer-6 stand-in's instance and its Keccak/GWC
    proof (proved once, by the port), the vks registered in both
    packages' registries for the module."""
    srs = tkzg.SRS.generate(K, device="cpu")
    circ = _Layer6()
    pk, tvk = tkeygen(srs, K, circ)  # the circuit reads no instance value
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPT_STUB_BLOB_KZG", "1")
        tail = _layer5_tail(_batch_proofs(PKGS["torch"], tvk))
    lhs = G1.mul(g1_generator(), 987654321)
    inst = acc_limbs(lhs, G1.mul(lhs, TAU)) + tail
    proof = tprove(srs, pk, circ, [inst], transcript_cls=KeccakTranscript, seed=SEED, multiopen="gwc")
    vks = {"torch": tvk, "jax": JVerifyingKey.from_bytes(tvk.to_bytes())}
    for name, vk in vks.items():
        PKGS[name]["provers"].register_vk(vk)
    yield vks, inst, proof
    for name, vk in vks.items():
        PKGS[name]["provers"]._VK_REGISTRY.pop(hex(vk.transcript_repr()), None)


@pytest.fixture(autouse=True)
def knobs(monkeypatch):
    monkeypatch.setenv("SPT_STUB_BLOB_KZG", "1")
    monkeypatch.delenv("SPT_LADDER_MULTIOPEN", raising=False)


def _fake_prove(name, vks, inst6, proof6, records):
    """_prove_circuit's recorder: layer 5 gets a stub payload whose tail is
    what the AggregationCircuit would expose, layer 6 the real proof."""
    m, vk = PKGS[name], vks[name]

    def fake(self, circuit, shape_id, transcript_cls=None, multiopen="gwc", **_kw):
        tname = None if transcript_cls is None else transcript_cls.__name__
        if isinstance(circuit, m["agg"]):
            records.append({
                "layer": 5, "context": circuit.context, "links": circuit.links, "expose": circuit.expose,
                "blob": circuit.blob_bytes, "inner_multiopen": circuit.inner_multiopen,
                "have_acc": circuit.inners_have_acc, "num_instance": circuit.num_instance(),
                "inners": [(hex(v.transcript_repr()), p, i) for v, p, i in circuit.inners],
                "shape_id": shape_id, "transcript": tname, "multiopen": multiopen,
            })
            tail = [DIGEST] + circuit.context + [circuit.inners[i][2][off] for i, off in circuit.expose]
            inst, proof = list(range(300, 300 + ACC_CELLS)) + tail, b"layer5"
        else:
            records.append({"layer": 6, "inner": circuit.inner_instances, "proof": circuit.inner_proof,
                            "has_acc": circuit.inner_has_acc, "inner_multiopen": circuit.inner_multiopen,
                            "inner_vk": hex(circuit.inner_vk.transcript_repr()),
                            "shape_id": shape_id, "transcript": tname, "multiopen": multiopen})
            assert circuit.passthrough() == inst6[ACC_CELLS:]
            inst, proof = inst6, proof6
        payload = m["proofs"].ProofPayload(proof=proof, instances=inst,
                                           protocol=m["protocol"].protocol_from_vk(vk, len(inst), multiopen=multiopen),
                                           vk_id=hex(vk.transcript_repr()))
        return payload, vk

    return fake


def _prover(m, name, cls="BatchProver"):
    params = {K: m["srs"]()}
    return getattr(m["provers"], cls)(params, device="cpu") if name == "torch" else getattr(m["provers"], cls)(params)


@pytest.fixture(scope="module")
def bundles(layer6, tmp_path_factory):
    """{package: (records, BundleProof, output dir)} of prove_and_verify_bundle
    with the recorder in place (the verifier's layer check is real)."""
    vks, inst6, proof6 = layer6
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPT_STUB_BLOB_KZG", "1")
        mp.delenv("SPT_LADDER_MULTIOPEN", raising=False)
        for name, m in PKGS.items():
            records = []
            mp.setattr(m["provers"].BatchProver, "_prove_circuit", _fake_prove(name, vks, inst6, proof6, records))
            task = m["tasks"].BundleProvingTask(_batch_proofs(m, vks[name]))
            d = str(tmp_path_factory.mktemp(f"bundle_{name}"))
            params = {K: m["srs"]()}
            kw = {"device": "cpu"} if name == "torch" else {}
            proof = m["integ"].prove_and_verify_bundle(params, "", task, d, **kw)
            out[name] = (records, proof, d)
    return out


def test_links_and_expose_match_jax():
    for n in (1, 2, 5):
        assert tprovers._bundle_links(n) == jprovers._bundle_links(n)
        assert tprovers._bundle_expose(n) == jprovers._bundle_expose(n)


def test_gen_bundle_layer_inputs_match_jax(bundles, layer6):
    assert bundles["torch"][0] == bundles["jax"][0]
    l5, l6 = bundles["torch"][0]
    assert l5["links"] == tprovers._bundle_links(N_BATCHES) and l5["expose"] == tprovers._bundle_expose(N_BATCHES)
    assert (l5["inner_multiopen"], l5["multiopen"], l5["transcript"], l5["blob"]) == ("shplonk", "shplonk", None, None)
    assert (l6["transcript"], l6["multiopen"], l6["inner_multiopen"], l6["has_acc"]) == (
        "KeccakTranscript", "gwc", "shplonk", True)
    assert l6["inner"][ACC_CELLS:] == layer6[1][ACC_CELLS:]


def test_bundle_proof_json_and_calldata_match_jax(bundles):
    tp, jp = bundles["torch"][1], bundles["jax"][1]
    assert tp.to_json() == jp.to_json()
    assert tp.calldata() == jp.calldata()
    assert tp.inner is tp and tp.proof == tp.layers[-1].proof
    assert tp.calldata() == tproofs.encode_instances(tp.layers[-1].instances) + tp.proof
    js = tp.to_json()
    assert tproofs.BundleProof.from_json(js).to_json() == js == jproofs.BundleProof.from_json(js).to_json()


@pytest.mark.parametrize("fname", RELEASE_FILES)
def test_release_files_match_jax(bundles, fname):
    got = {}
    for name in PKGS:
        with open(os.path.join(bundles[name][2], fname), "rb") as fh:
            got[name] = fh.read()
    assert got["torch"] == got["jax"] and got["torch"]


def test_evm_verify_bundle_matches_jax(bundles):
    """Each package's evm_verify_bundle runs the other package's artifacts
    on its own proof object: the same gas; None with a flipped proof byte."""
    gas, bad = {}, {}
    for name, m in PKGS.items():
        other = bundles["jax" if name == "torch" else "torch"][2]
        proof = bundles[name][1]
        prover = _prover(m, name)
        gas[name] = prover.evm_verify_bundle(proof, other)
        l6 = proof.layers[-1]
        flipped = bytearray(l6.proof)
        flipped[0] ^= 1
        bad[name] = prover.evm_verify_bundle(
            m["proofs"].BundleProof(layers=[proof.layers[0], dataclasses.replace(l6, proof=bytes(flipped))]), other)
    assert gas["torch"] == gas["jax"] > 100_000
    assert bad["torch"] is bad["jax"] is None


@pytest.mark.parametrize("case", ["broken chain", "missing vk", "mixed multiopen"])
def test_gen_bundle_refusals_match_jax(layer6, monkeypatch, case):
    vks, inst6, proof6 = layer6
    got = {}
    for name, m in PKGS.items():
        records = []
        monkeypatch.setattr(m["provers"].BatchProver, "_prove_circuit", _fake_prove(name, vks, inst6, proof6, records))
        proofs = _batch_proofs(m, vks[name], broken=case == "broken chain",
                               mos=["shplonk", "gwc"] if case == "mixed multiopen" else None)
        if case == "missing vk":
            l4 = proofs[1].inner.layers[-1]
            proofs[1].inner.layers[-1] = dataclasses.replace(l4, vk_id="0x1234")
        try:
            _prover(m, name).gen_bundle_proof(m["tasks"].BundleProvingTask(proofs))
            got[name] = records
        except AssertionError as e:
            got[name] = (type(e), records)
    assert got["torch"] == got["jax"] == (AssertionError, [])


def _tamper(m, proof, case: str):
    l5, l6 = proof.layers
    if case == "pass-through mismatch":
        l5 = dataclasses.replace(l5, instances=l5.instances[:-1] + [l5.instances[-1] + 1])
    elif case == "wrong last hash":
        inst = list(l6.instances)
        inst[ACC_CELLS + 1 + 3] ^= 1  # the declared last hash's lo half
        l5, l6 = dataclasses.replace(l5, instances=l5.instances[:ACC_CELLS] + inst[ACC_CELLS:]), \
            dataclasses.replace(l6, instances=inst)
    elif case == "malformed layout":
        l5 = dataclasses.replace(l5, instances=l5.instances[:ACC_CELLS + 4])
        l6 = dataclasses.replace(l6, instances=l6.instances[:ACC_CELLS + 4])
    elif case == "flipped proof byte":
        bad = bytearray(l6.proof)
        bad[len(bad) // 2] ^= 1
        l6 = dataclasses.replace(l6, proof=bytes(bad))
    elif case == "missing vk":
        l6 = dataclasses.replace(l6, vk_id="0x1234")
    return m["proofs"].BundleProof(layers=[l5, l6])


VERDICTS = {"honest": True, "pass-through mismatch": False, "wrong last hash": False, "malformed layout": False,
            "flipped proof byte": False, "missing vk": False}
REAL_CHECK = ("flipped proof byte", "missing vk")  # the honest case ran the real check in `bundles`


@pytest.mark.parametrize("case", sorted(VERDICTS))
def test_verify_bundle_verdicts_match_jax(bundles, monkeypatch, case):
    got = {}
    for name, m in PKGS.items():
        if case not in REAL_CHECK:
            monkeypatch.setattr(m["provers"].BatchVerifier, "_verify_layer", lambda self, *a, **k: True)
        proof = _tamper(m, bundles[name][1], case)
        got[name] = _prover(m, name, "BatchVerifier").verify_bundle_proof(proof)
    assert got["torch"] == got["jax"] == VERDICTS[case]
