"""Port parity for the batch side of the prover facade (prover/provers.py
BatchProver and BatchVerifier, prover/proofs.py BatchProofV2), which proves
nothing here (a layer 3 or 4 is at least 2^21 rows):

- BatchProofV2's JSON and round trip, the chain links and the exposed
  statement cells are equal to the JAX package's;
- gen_batch_proof's prelude, with `_prove_circuit` replaced by a recorder
  in both packages: the layer-3 circuit's context, links, exposed cells,
  blob width and inner multiopen, and layer 4's inputs are equal, and a
  broken chain, an empty or oversized task and mixed multiopens are refused
  by both;
- verify_batch_proof with `_verify_layer` accepting, in both packages, on
  instances built from a header, a blob and chunk infos: the verdicts are
  equal case by case;
- BatchProver and BatchVerifier refuse to run without a card unless asked
  for the CPU.

Headers use the JAX package's stub blob commitment (SPT_STUB_BLOB_KZG), and
the verifier the blob digest at width 64 (SPT_BLOB_WIDTH): both packages
read the same knobs; tests/test_torch_bls12_381.py holds the real
commitment."""
import dataclasses

import pytest
import torch

import tests.torch_native_cases  # noqa: F401  (both packages' native libraries, built once under a lock)
from scroll_prover_tpu.aggregator.batch_header import BatchHeader as JBatchHeader
from scroll_prover_tpu.integration import prove as jintegration
from scroll_prover_tpu.proof_system.plonk.keygen import VerifyingKey as JVerifyingKey
from scroll_prover_tpu.prover import chunk_info as jci
from scroll_prover_tpu.prover import proofs as jproofs
from scroll_prover_tpu.prover import protocol as jprotocol
from scroll_prover_tpu.prover import provers as jprovers
from scroll_prover_tpu.prover import tasks as jtasks
from scroll_prover_tpu.prover.aggregation_circuit import AggregationCircuit as JAggregationCircuit
from scroll_prover_tpu_torch.aggregator.batch_header import BatchHeader as TBatchHeader
from scroll_prover_tpu_torch.integration import prove as tintegration
from scroll_prover_tpu_torch.proof_system import kzg as tkzg
from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen as tkeygen
from scroll_prover_tpu_torch.prover import chunk_info as tci
from scroll_prover_tpu_torch.prover import proofs as tproofs
from scroll_prover_tpu_torch.prover import protocol as tprotocol
from scroll_prover_tpu_torch.prover import provers as tprovers
from scroll_prover_tpu_torch.prover import tasks as ttasks
from scroll_prover_tpu_torch.prover.aggregation_circuit import AggregationCircuit as TAggregationCircuit
from scroll_prover_tpu_torch.prover.verifier_circuit import ACC_CELLS
from tests.test_torch_plonk import K, TorchMul

torch.set_num_threads(2)

PKGS = {
    "jax": dict(provers=jprovers, proofs=jproofs, protocol=jprotocol, ci=jci, tasks=jtasks, header=JBatchHeader,
                integ=jintegration, agg=JAggregationCircuit),
    "torch": dict(provers=tprovers, proofs=tproofs, protocol=tprotocol, ci=tci, tasks=ttasks, header=TBatchHeader,
                  integ=tintegration, agg=TAggregationCircuit),
}
M128 = (1 << 128) - 1


@pytest.fixture(autouse=True)
def knobs(monkeypatch):
    monkeypatch.setenv("SPT_STUB_BLOB_KZG", "1")
    monkeypatch.setenv("SPT_BLOB_WIDTH", "64")
    monkeypatch.delenv("SPT_LADDER_MULTIOPEN", raising=False)


@pytest.fixture(scope="module")
def vks():
    """{package: vk} of the K = 6 MulCircuit (the JAX vk read from the
    port's bytes), registered in both packages' registries for the test."""
    _pk, tvk = tkeygen(tkzg.SRS.generate(K, device="cpu"), K, TorchMul())
    out = {"torch": tvk, "jax": JVerifyingKey.from_bytes(tvk.to_bytes())}
    yield out
    for name, vk in out.items():
        PKGS[name]["provers"]._VK_REGISTRY.pop(hex(vk.transcript_repr()), None)


@pytest.fixture
def registered(vks):
    for name, vk in vks.items():
        PKGS[name]["provers"].register_vk(vk)
    yield vks
    for name, vk in vks.items():
        PKGS[name]["provers"]._VK_REGISTRY.pop(hex(vk.transcript_repr()), None)


def _root(i: int) -> str:
    return "0x" + f"{i:02x}" * 32


def _infos(m, n: int, broken: bool = False) -> list:
    """n chained chunk infos (chunk i goes from root i to root i + 1)."""
    out = []
    for i in range(n):
        prev = _root(i + 50) if broken and i == n - 1 else _root(i)
        out.append(m["ci"].ChunkInfo(
            chain_id=534352, prev_state_root=prev, post_state_root=_root(i + 1), withdraw_root=_root(0xAA),
            data_hash="0x" + f"{0xD0 + i:02x}" * 32, tx_bytes=bytes([i + 1]) * (40 + i)))
    return out


def _l2_instances(info, acc_seed: int) -> list[int]:
    """A chunk's layer-2 instance: 12 accumulator cells, then the chunk
    instance of the info."""
    def halves(h):
        v = int(h, 16)
        return [v >> 128, v & M128]

    return ([acc_seed + i for i in range(ACC_CELLS)] + [info.chain_id] + halves(info.prev_state_root)
            + halves(info.post_state_root) + halves(info.withdraw_root) + halves(info.data_hash))


def _chunk_proofs(m, vk, infos, mos=None) -> list:
    out = []
    for i, info in enumerate(infos):
        mo = (mos or ["shplonk"] * len(infos))[i]
        inst = _l2_instances(info, 100 * i)
        layer = m["proofs"].ProofPayload(proof=bytes([i]) * 96, instances=inst,
                                         protocol=m["protocol"].protocol_from_vk(vk, len(inst), multiopen=mo),
                                         vk_id=hex(vk.transcript_repr()))
        out.append(m["proofs"].ChunkProofV2(m["proofs"].ChunkProofInner(layers=[layer, layer, layer], chunk_info_=info)))
    return out


def _task(m, vk, n: int = 2, broken: bool = False, mos=None):
    """A task of n chunk proofs; its blob and header carry at most 45 of
    them (one placeholder chunk for an empty task)."""
    infos = _infos(m, n, broken)
    in_blob = infos[:45] or _infos(m, 1)
    blob = m["integ"].get_blob_from_chunks(in_blob)
    header = m["header"].construct_from_chunks(4, 3, 0, 0, b"\x00" * 32, 5, in_blob, blob)
    return m["tasks"].BatchProvingTask(_chunk_proofs(m, vk, infos, mos), header, blob)


@pytest.mark.parametrize("n", [1, 2, 5, 45])
def test_links_and_expose_match_jax(n):
    assert tprovers._chunk_chain_links(n) == jprovers._chunk_chain_links(n)
    assert tprovers._batch_expose(n) == jprovers._batch_expose(n)
    offsets = ("_L2_CHAIN_ID", "_L2_PREV", "_L2_POST", "_L2_DH", "_L4_DIGEST", "_L4_BH", "_L4_Z", "_L4_Y",
               "_L4_BLOB", "_L4_CHAIN_ID", "_L4_FIRST_PREV", "_L4_LAST_POST", "_L4_DH0")
    assert [getattr(tprovers, o) for o in offsets] == [getattr(jprovers, o) for o in offsets]


def _recorded_batch(name, vks, task_args, monkeypatch):
    """gen_batch_proof of `name`'s package with _prove_circuit recording
    its circuits; returns (records, the proof's JSON) or the exception's
    type."""
    m = PKGS[name]
    vk = vks[name]
    records = []

    def fake_prove(self, circuit, shape_id, transcript_cls=None, multiopen="gwc", **_kw):
        if isinstance(circuit, m["agg"]):
            records.append({
                "layer": 3, "context": circuit.context, "links": circuit.links, "expose": circuit.expose,
                "blob_width": circuit.blob_width, "blob": circuit.blob_bytes, "inner_multiopen": circuit.inner_multiopen,
                "have_acc": circuit.inners_have_acc, "num_instance": circuit.num_instance(),
                "inners": [(hex(v.transcript_repr()), p, i) for v, p, i in circuit.inners],
                "shape_id": shape_id, "multiopen": multiopen,
            })
            inst = list(range(circuit.num_instance()))
        else:
            records.append({"layer": 4, "inner": circuit.inner_instances, "proof": circuit.inner_proof,
                            "has_acc": circuit.inner_has_acc, "inner_multiopen": circuit.inner_multiopen,
                            "shape_id": shape_id, "multiopen": multiopen})
            inst = list(range(500, 500 + circuit.num_instance()))
        payload = m["proofs"].ProofPayload(proof=b"layer" + bytes([len(records)]), instances=inst,
                                           protocol=m["protocol"].protocol_from_vk(vk, len(inst), multiopen=multiopen),
                                           vk_id=hex(vk.transcript_repr()))
        return payload, vk

    monkeypatch.setattr(m["provers"].BatchProver, "_prove_circuit", fake_prove)
    prover = m["provers"].BatchProver({}, device="cpu") if name == "torch" else m["provers"].BatchProver({})
    try:
        proof = prover.gen_batch_proof(_task(m, vk, *task_args))
    except AssertionError as e:
        return type(e)
    return records, proof.to_json()


@pytest.mark.parametrize("n", [1, 3])
def test_gen_batch_prelude_matches_jax(registered, monkeypatch, n):
    got = {name: _recorded_batch(name, registered, (n,), monkeypatch) for name in PKGS}
    assert got["torch"] == got["jax"]
    (l3, l4), js = got["torch"]
    assert l3["links"] == tprovers._chunk_chain_links(n) and l3["expose"] == tprovers._batch_expose(n)
    assert (l3["blob_width"], l3["inner_multiopen"], l3["multiopen"]) == (64, "shplonk", "shplonk")
    assert l4["has_acc"] and l4["inner"] == list(range(l3["num_instance"]))
    back = tproofs.BatchProofV2.from_json(js)
    assert back.to_json() == js
    assert jproofs.BatchProofV2.from_json(js).to_json() == js


@pytest.mark.parametrize("case", ["broken chain", "empty", "oversized", "mixed multiopen"])
def test_gen_batch_refusals_match_jax(registered, monkeypatch, case):
    args = {"broken chain": (2, True), "empty": (0,), "oversized": (46,),
            "mixed multiopen": (2, False, ["shplonk", "gwc"])}[case]
    got = {name: _recorded_batch(name, registered, args, monkeypatch) for name in PKGS}
    assert got["torch"] == got["jax"] == AssertionError


def _batch_proof(m, vk, infos, blob_infos=None):
    """A BatchProofV2 whose layer instances are what layers 3 and 4 expose
    for these infos, a header and blob built from them (the blob from
    `blob_infos` when given)."""
    blob = m["integ"].get_blob_from_chunks(blob_infos or infos)
    header = m["header"].construct_from_chunks(4, 3, 0, 0, b"\x00" * 32, 5, infos, blob)
    bh = header.batch_hash()
    z, y = header.blob_data_proof
    ctx = [int.from_bytes(bh[:16], "big"), int.from_bytes(bh[16:], "big"), z >> 128, z & M128, y >> 128, y & M128]
    tail = [1234] + ctx + [m["agg"].host_blob_digest(blob, 64)]
    l2 = [_l2_instances(info, 0)[ACC_CELLS:] for info in infos]
    tail += [l2[0][0], l2[0][1], l2[0][2], l2[-1][3], l2[-1][4]]
    for cells in l2:
        tail += cells[7:9]
    layers = []
    for acc0 in (10, 20):
        inst = list(range(acc0, acc0 + ACC_CELLS)) + tail
        layers.append(m["proofs"].ProofPayload(proof=b"p", instances=inst,
                                               protocol=m["protocol"].protocol_from_vk(vk, len(inst), multiopen="shplonk"),
                                               vk_id=hex(vk.transcript_repr())))
    return m["proofs"].BatchProofV2(m["proofs"].BatchProofInner(
        layers=layers, batch_hash=bh, batch_header=header, blob_bytes=blob, chunk_infos=list(infos)))


def _tamper(proof, case: str):
    inner = proof.inner
    l3, l4 = inner.layers
    if case == "pass-through mismatch":
        inner.layers[0] = dataclasses.replace(l3, instances=l3.instances[:-1] + [l3.instances[-1] + 1])
    elif case == "header context":
        for i in (0, 1):
            lay = inner.layers[i]
            inst = list(lay.instances)
            inst[ACC_CELLS + 3] += 1  # z hi
            inner.layers[i] = dataclasses.replace(lay, instances=inst)
    elif case == "blob byte":
        bad = bytearray(inner.blob_bytes)
        bad[len(bad) // 2] ^= 1
        inner.blob_bytes = bytes(bad)
    elif case == "data-hash cell":
        for i in (0, 1):
            lay = inner.layers[i]
            inner.layers[i] = dataclasses.replace(lay, instances=lay.instances[:-1] + [lay.instances[-1] ^ 1])
    elif case == "no blob bytes":
        inner.blob_bytes = None
    elif case == "no chunk infos":
        inner.chunk_infos = None
    return proof


VERDICTS = {"honest": True, "pass-through mismatch": False, "header context": False, "blob byte": False,
            "data-hash cell": False, "no blob bytes": False, "no chunk infos": False, "chunk count": False}


@pytest.mark.parametrize("case", sorted(VERDICTS))
def test_verify_batch_verdicts_match_jax(vks, monkeypatch, case):
    got = {}
    for name, m in PKGS.items():
        monkeypatch.setattr(m["provers"].BatchVerifier, "_verify_layer", lambda self, *a, **k: True)
        infos = _infos(m, 2)
        blob_infos = _infos(m, 3) if case == "chunk count" else None
        proof = _tamper(_batch_proof(m, vks[name], infos[:2] if blob_infos else infos, blob_infos), case)
        verifier = m["provers"].BatchVerifier({}, device="cpu") if name == "torch" else m["provers"].BatchVerifier({})
        got[name] = verifier.verify_batch_proof(proof)
    assert got["torch"] == got["jax"] == VERDICTS[case]


@pytest.mark.parametrize("cls", ["BatchProver", "BatchVerifier"])
def test_refuses_silent_cpu(cls):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tprovers, cls)({})
    assert getattr(tprovers, cls)({}, device="cpu").device.type == "cpu"


class _Layer(TorchMul):
    """The MulCircuit twin with a layer circuit's min_k, rows and
    instance_for."""

    _rows = 8

    def min_k(self):
        from scroll_prover_tpu_torch.proof_system.plonk.cs import ConstraintSystem

        self.configure(ConstraintSystem())  # as a layer's recording pass does
        return K

    def instance_for(self):
        return [[7]]


def test_prove_circuit_drops_keygen_inputs_and_matches_jax():
    """BatchProver._prove_circuit takes keygen from its cache, which drops
    the vk's copy lists once keygen has them, and releases the vk's domain
    tables after the prove: the proof equals the JAX package's over the same
    circuit and seed, verifies, and a second prove of the shape (a fresh
    circuit against the cached keys, which registers its copies again)
    gives the same bytes."""
    from scroll_prover_tpu.proof_system import kzg as jkzg
    from scroll_prover_tpu.proof_system.plonk.keygen import keygen as jkeygen
    from scroll_prover_tpu.proof_system.plonk.prover import prove as jprove
    from scroll_prover_tpu_torch.proof_system.plonk.verifier import verify as tverify
    from tests.test_torch_plonk import JaxMul

    seed = b"keygen-cache"
    srs = tkzg.SRS.generate(K, device="cpu")
    prover = tprovers.BatchProver({K: srs}, device="cpu")
    circ = _Layer()
    _pk, vk = prover._kg.get(srs, K, circ, tprovers._mo_tag("layer3_cache", "gwc"))
    assert vk.cs.copies == [] and not vk.cs._copy_set
    payload, vk_proved = prover._prove_circuit(circ, "layer3_cache", seed=seed)
    try:
        assert vk_proved is vk and vk.domain._tables == {}
        js = jkzg.SRS.generate(K)
        jcirc = JaxMul()
        jpk, _ = jkeygen(js, K, jcirc)
        assert payload.proof == jprove(js, jpk, jcirc, [[7]], seed=seed, multiopen="gwc")
        assert tverify(srs, vk, [payload.instances], payload.proof, multiopen="gwc")
        again, vk_again = prover._prove_circuit(_Layer(), "layer3_cache", seed=seed)
        assert vk_again is vk and again.proof == payload.proof
    finally:
        tprovers._VK_REGISTRY.pop(payload.vk_id, None)
