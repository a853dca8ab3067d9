"""Port parity for the chunk side of the prover facade: the protocol
descriptor, the proof objects' JSON, the vk registry and assets (fail
closed), the ladder helpers, the production cap profile, the chunk binding,
the device rule of ChunkProver/ChunkVerifier, and the trace_prover CLI.
The inputs are tests/test_torch_plonk.py's MulCircuit at K = 6 and
tests/torch_trace_cases.py's traces; every comparison is exact."""
import json
import os
import subprocess
import sys

import pytest
import torch

from scroll_prover_tpu.l2types import BlockTrace as JBlockTrace
from scroll_prover_tpu.proof_system.plonk.keygen import VerifyingKey as JVerifyingKey
from scroll_prover_tpu.prover import compression as jcompression
from scroll_prover_tpu.prover import proofs as jproofs
from scroll_prover_tpu.prover import protocol as jprotocol
from scroll_prover_tpu.prover import provers as jprovers
from scroll_prover_tpu.prover.chunk_info import ChunkInfo as JChunkInfo
from scroll_prover_tpu.witness import chunk_trace_to_witness_block as jwitness
from scroll_prover_tpu_torch.l2types import BlockTrace as TBlockTrace
from scroll_prover_tpu_torch.proof_system import kzg
from scroll_prover_tpu_torch.proof_system.plonk.keygen import VerifyingKey, keygen
from scroll_prover_tpu_torch.proof_system.plonk.prover import prove
from scroll_prover_tpu_torch.proof_system.plonk.verifier import verify
from scroll_prover_tpu_torch.prover import compression, proofs, protocol
from scroll_prover_tpu_torch.prover import provers as pv
from scroll_prover_tpu_torch.prover.chunk_info import ChunkInfo
from scroll_prover_tpu_torch.witness import chunk_trace_to_witness_block as twitness
from scroll_prover_tpu_torch.zkevm import chunk_instance
from tests.test_torch_plonk import INSTANCE, K, TorchMul
from tests.torch_trace_cases import trace_dict

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MULTIOPENS = ("gwc", "shplonk")
GIT = "abc1234"


@pytest.fixture(autouse=True)
def clean_registries():
    """A vk registered by one test must not make another pass."""
    pv._VK_REGISTRY.clear()
    jprovers._VK_REGISTRY.clear()
    yield
    pv._VK_REGISTRY.clear()
    jprovers._VK_REGISTRY.clear()


@pytest.fixture(scope="module")
def srs():
    return kzg.SRS.generate(K, device="cpu")


@pytest.fixture(scope="module")
def mul(srs):
    """(vk, {mo: proof}) of the MulCircuit, by the port."""
    circ = TorchMul()
    pk, vk = keygen(srs, K, circ)
    return vk, {mo: prove(srs, pk, circ, INSTANCE, seed=b"chunk-prover", multiopen=mo) for mo in MULTIOPENS}


@pytest.mark.parametrize("mo", MULTIOPENS)
def test_protocol_json_matches_jax(mul, mo):
    vk, _ = mul
    got = protocol.protocol_from_vk(vk, 1, multiopen=mo)
    want = jprotocol.protocol_from_vk(JVerifyingKey.from_bytes(vk.to_bytes()), 1, multiopen=mo)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert protocol.protocol_to_b64(got) == jprotocol.protocol_to_b64(want)
    assert protocol.protocols_equal(protocol.protocol_from_b64(protocol.protocol_to_b64(got)), got)
    assert got["multiopen"] == mo and got["domain"]["k"] == K


def _chunk_proof(pkg_proofs, pkg_protocol, chunk_info_cls, vk, proof):
    """A three-layer ChunkProofV2 of one package, its layers carrying the
    MulCircuit's proof, instance and protocol."""
    layers = [
        pkg_proofs.ProofPayload(
            proof=proof[: 32 * (i + 1)] + bytes([i]), instances=[7 + i, 2**200 + i],
            protocol=pkg_protocol.protocol_from_vk(vk, 2, multiopen="shplonk"), vk_id=hex(vk.transcript_repr()),
        )
        for i in range(3)
    ]
    info = chunk_info_cls(chain_id=534352, prev_state_root="0x" + "01" * 32, post_state_root="0x" + "02" * 32,
                          withdraw_root="0x" + "03" * 32, data_hash="0x" + "04" * 32, tx_bytes=b"\x05\x06")
    return pkg_proofs.ChunkProofV2(pkg_proofs.ChunkProofInner(
        layers=layers, chunk_info_=info, row_usages=[{"name": "evm", "row_number": 3}], git_version=GIT))


def test_chunk_proof_json_matches_jax(mul, tmp_path):
    vk, by_mo = mul
    ours = _chunk_proof(proofs, protocol, ChunkInfo, vk, by_mo["shplonk"])
    theirs = _chunk_proof(jproofs, jprotocol, JChunkInfo, JVerifyingKey.from_bytes(vk.to_bytes()), by_mo["shplonk"])
    assert ours.to_json() == theirs.to_json()
    path = ours.dump(str(tmp_path / "torch"), "c1")
    jpath = theirs.dump(str(tmp_path / "jax"), "c1")
    with open(path, "rb") as fh, open(jpath, "rb") as jfh:
        assert fh.read() == jfh.read()
    back = proofs.ChunkProofV2.from_file(jpath)
    assert back.to_json() == ours.to_json()
    assert back.inner.layers[1] == ours.inner.layers[1]
    assert back.inner.proof == ours.inner.layers[-1].proof
    payload = ours.inner.layers[0]
    assert proofs.ProofPayload.from_json(jproofs.ProofPayload.from_json(payload.to_json()).to_json()) == payload
    assert proofs.decode_instances(jproofs.encode_instances([1, 2**255])) == [1, 2**255]


def test_vk_roundtrip_and_verify_from_bytes(srs, mul):
    vk, by_mo = mul
    proof = by_mo["gwc"]
    vk2 = VerifyingKey.from_bytes(vk.to_bytes())
    assert vk2.transcript_repr() == vk.transcript_repr()
    assert verify(srs, vk2, INSTANCE, proof)
    bad = bytearray(proof)
    bad[70] ^= 1
    try:
        ok = verify(srs, vk2, INSTANCE, bytes(bad))
    except (AssertionError, ValueError):
        ok = False
    assert not ok


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_register_and_load_vk_via_assets(mul, tmp_path, writer):
    """A vk registered with an assets dir (by either package: the files are
    the same bytes) loads from disk alone in a fresh registry, and not at
    all without the assets dir."""
    vk, _ = mul
    vk_id = hex(vk.transcript_repr())
    assets = str(tmp_path)
    if writer == "torch":
        pv.register_vk(vk, assets)
    else:
        jprovers.register_vk(JVerifyingKey.from_bytes(vk.to_bytes()), assets)
    with open(os.path.join(assets, f"vk_{vk_id}.vkey"), "rb") as fh:
        assert fh.read() == vk.to_bytes()
    pv._VK_REGISTRY.clear()
    got = pv.load_vk(vk_id, assets)
    assert got is not None and hex(got.transcript_repr()) == vk_id
    pv._VK_REGISTRY.clear()
    assert pv.load_vk(vk_id, "") is None


def test_load_vk_rejects_a_file_that_fails_its_digest(mul, tmp_path):
    vk, _ = mul
    with open(tmp_path / "vk_0xdeadbeef.vkey", "wb") as fh:
        fh.write(vk.to_bytes())
    assert pv.load_vk("0xdeadbeef", str(tmp_path)) is None


def test_verify_chunk_proof_fails_closed(srs, mul, tmp_path):
    """A layer-2 payload whose vk is neither registered nor in the assets
    dir is REJECTED, not verified against a self-supplied vk."""
    vk, by_mo = mul
    proof = _chunk_proof(proofs, protocol, ChunkInfo, vk, by_mo["shplonk"])
    verifier = pv.ChunkVerifier({K: srs}, assets_dir=str(tmp_path), device="cpu")
    assert verifier.verify_chunk_proof(proof) is False
    pv.register_vk(vk)
    payload = proof.inner.layers[-1]
    payload.proof, payload.instances = by_mo["shplonk"], INSTANCE[0]
    # the registered vk verifies the SNARK; its instance is no accumulator
    assert verifier._verify_outer(payload) is False


@pytest.mark.parametrize("base", [None, "16", "5"])
def test_canonical_k_and_field_elems_match_jax(monkeypatch, base):
    if base is None:
        monkeypatch.delenv("SPT_LADDER_K", raising=False)
    else:
        monkeypatch.setenv("SPT_LADDER_K", base)
    for k in (1, 8, 13, 14, 21):
        assert compression._canonical_k(k) == jcompression._canonical_k(k)
    assert compression._canonical_k(8) == (13 if base is None else max(8, int(base)))
    for blob in (b"", b"\x01", bytes(range(31)), bytes(range(256)) * 3):
        elems = compression.proof_to_field_elems(blob)
        assert elems == jcompression.proof_to_field_elems(blob)
        assert elems[-1] == len(blob) and all(e < 2**248 for e in elems[:-1])


CAPS = ("SPT_SIG_CAP", "SPT_KECCAK_CAP", "SPT_MPT_CAP", "SPT_SHA256_CAP", "SPT_ECC_CAP", "SPT_MODEXP_CAP")


@pytest.mark.parametrize("explicit", [None, "0"])
def test_production_cap_profile_matches_jax(monkeypatch, explicit):
    """Unset caps default to the witness demand; an explicit one wins. Each
    package runs on its own copy of the environment."""
    trace = trace_dict(num_txs=2, num_logs=20, precompiles=True, signed=True)
    resolved = {}
    for side, (block_trace, apply) in {
        "torch": (TBlockTrace, pv.apply_production_cap_profile),
        "jax": (JBlockTrace, jprovers.apply_production_cap_profile),
    }.items():
        env = {k: v for k, v in os.environ.items() if k not in CAPS}
        if explicit is not None:
            env["SPT_SIG_CAP"] = explicit
        monkeypatch.setattr(os, "environ", env)
        resolved[side] = apply([block_trace.from_json(trace)])
        assert {k: int(env[k]) for k in CAPS} == resolved[side]
    assert resolved["torch"] == resolved["jax"]
    assert resolved["torch"]["SPT_SIG_CAP"] == (2 if explicit is None else 0)


def test_chunk_binding():
    traces = [trace_dict(num_txs=2, num_logs=20)]
    wb = twitness([TBlockTrace.from_json(t) for t in traces])
    jwb = jwitness([JBlockTrace.from_json(t) for t in traces])
    info = ChunkInfo.from_witness_block(wb)
    assert info.to_json() == JChunkInfo.from_witness_block(jwb).to_json()
    passthrough = chunk_instance(wb)
    verifier = pv.ChunkVerifier({}, device="cpu")
    assert verifier._check_chunk_binding(passthrough, info)
    for i in (0, 3, 7, 8):  # chain id, a state root half, the data hash halves
        bad = list(passthrough)
        bad[i] += 1
        assert not verifier._check_chunk_binding(bad, info)


@pytest.mark.parametrize("cls", ["ChunkProver", "ChunkVerifier"])
def test_facade_refuses_silent_cpu(cls):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(pv, cls)({})
    assert getattr(pv, cls)({}, device="cpu").device.type == "cpu"


def test_trace_prover_cli_without_traces(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, SCROLL_PROVER_OUTPUT_DIR=str(tmp_path / "out"))
    out = subprocess.run(
        [sys.executable, "-m", "scroll_prover_tpu_torch.bin.trace_prover", "--trace", str(empty),
         "--params", str(tmp_path / "params"), "--assets", str(tmp_path / "assets"), "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 1, out.stderr[-2000:]
    assert "no traces found" in out.stderr
