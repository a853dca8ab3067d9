"""Port parity for the witness side of the chunk proof: trace ingestion,
witness block, capacity checking, chunk public data, the zktrie and
secp256k1 recovery, each against the JAX package on the same input.

Every comparison is exact equality (integers, bytes, host dataclasses).
Both packages get the same JSON dict (tests/torch_trace_cases.py)."""
import copy
import dataclasses
import random

import pytest
import torch

import tests.torch_native_cases  # noqa: F401  (both packages' native libraries, built once under a lock)
from scroll_prover_tpu.curves import secp256k1 as jsecp
from scroll_prover_tpu.l2types import BlockTrace as JBlockTrace
from scroll_prover_tpu.prover.chunk_info import ChunkInfo as JChunkInfo
from scroll_prover_tpu.trie import PyZkTrie as JPyZkTrie
from scroll_prover_tpu.trie import verify_merkle_proof as jverify_proof
from scroll_prover_tpu.witness import calculate_row_usage_of_witness_block as jrows
from scroll_prover_tpu.witness import chunk_trace_to_witness_block as jwitness
from scroll_prover_tpu.witness import capacity as jcap
from scroll_prover_tpu.zkevm.super_circuit import chunk_instance as jchunk_instance
from scroll_prover_tpu_torch.curves import secp256k1 as tsecp
from scroll_prover_tpu_torch.l2types import BlockTrace as TBlockTrace
from scroll_prover_tpu_torch.prover import ChunkInfo as TChunkInfo
from scroll_prover_tpu_torch.prover import ChunkProvingTask
from scroll_prover_tpu_torch.trie import PyZkTrie as TPyZkTrie
from scroll_prover_tpu_torch.trie import ZkTrie as TZkTrie
from scroll_prover_tpu_torch.trie import verify_merkle_proof as tverify_proof
from scroll_prover_tpu_torch.trie import zktrie as tzktrie
from scroll_prover_tpu_torch.witness import calculate_row_usage_of_witness_block as trows
from scroll_prover_tpu_torch.witness import chunk_trace_to_witness_block as twitness
from scroll_prover_tpu_torch.witness import capacity as tcap
from scroll_prover_tpu_torch.zkevm.super_circuit import chunk_instance as tchunk_instance
from tests.torch_trace_cases import trace_dict

torch.set_num_threads(2)

# (name, [trace dict per block])
SHAPES = {
    "plain": lambda: [trace_dict()],
    "two_blocks": lambda: [trace_dict(), trace_dict(num_txs=1, num_logs=12)],
    "precompiles_signed": lambda: [trace_dict(num_txs=2, num_logs=20, precompiles=True, signed=True)],
    "wide": lambda: [trace_dict(num_txs=4, num_logs=200)],
}


def _plain(obj):
    """A host dataclass tree as plain data, so that the two packages'
    classes compare by value."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__, {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return (type(obj).__name__, {k: _plain(v) for k, v in vars(obj).items()})
    return obj


@pytest.fixture(scope="module", params=sorted(SHAPES))
def blocks(request):
    dicts = SHAPES[request.param]()
    jt = [JBlockTrace.from_json(copy.deepcopy(d)) for d in dicts]
    tt = [TBlockTrace.from_json(copy.deepcopy(d)) for d in dicts]
    return request.param, jt, tt, jwitness(jt), twitness(tt)


def test_block_trace_identical(blocks):
    _name, jt, tt, _jwb, _twb = blocks
    assert [_plain(t) for t in tt] == [_plain(t) for t in jt]


def test_witness_block_identical(blocks):
    name, _jt, _tt, jwb, twb = blocks
    assert [_plain(s) for s in twb.steps] == [_plain(s) for s in jwb.steps]
    assert [_plain(r) for r in twb.rw_rows] == [_plain(r) for r in jwb.rw_rows]
    assert twb.bytecode_map == jwb.bytecode_map
    assert [_plain(e) for e in twb.keccak_events] == [_plain(e) for e in jwb.keccak_events]
    assert twb.data_hash() == jwb.data_hash()
    assert twb.precompile_calls == jwb.precompile_calls
    tsig, jsig = twb.sig_events(), jwb.sig_events()
    assert [_plain(e) for e in tsig] == [_plain(e) for e in jsig]
    if name == "precompiles_signed":
        assert len(tsig) == 2
        assert {"ecadd", "ecmul", "modexp", "sha256"} <= set(twb.precompile_calls)
        assert len(twb.ecc_events) == 4 and len(twb.modexp_raw) == 2
    # and every other field of the block
    assert _plain(twb) == _plain(jwb)


def test_row_usage_and_ccc_modes_identical(blocks):
    _name, jt, tt, jwb, twb = blocks
    assert [(d.name, d.row_number) for d in trows(twb)] == [(d.name, d.row_number) for d in jrows(jwb)]
    assert tcap.metric_of_witness_block(twb) == jcap.metric_of_witness_block(jwb)
    for mode in ("ccc_by_chunk", "ccc_as_signer", "ccc_as_follower_full"):
        t_ru, j_ru = getattr(tcap, mode)(tt), getattr(jcap, mode)(jt)
        assert t_ru.as_dict() == j_ru.as_dict()
        assert t_ru.is_ok == j_ru.is_ok
    ck_t, ck_j = tcap.CircuitCapacityChecker(), jcap.CircuitCapacityChecker()
    for a, b in zip(tt, jt):
        assert ck_t.estimate_circuit_capacity(a).as_dict() == ck_j.estimate_circuit_capacity(b).as_dict()
    assert ck_t.get_acc_row_usage().as_dict() == ck_j.get_acc_row_usage().as_dict()


def test_chunk_instance_and_info_identical(blocks):
    _name, _jt, tt, jwb, twb = blocks
    assert tchunk_instance(twb) == jchunk_instance(jwb)
    assert TChunkInfo.from_witness_block(twb).to_json() == JChunkInfo.from_witness_block(jwb).to_json()
    task = ChunkProvingTask.new(tt)
    assert task.identifier() == str(tt[0].number) and not task.is_empty()


def test_zktrie_roots_and_proofs_identical():
    rnd = random.Random(0x7121)
    jt, tt = JPyZkTrie(), TPyZkTrie()
    keys = [rnd.getrandbits(250) for _ in range(24)] + [5, 6, (1 << 60) + 5]
    for i, k in enumerate(keys):
        jt.update(k, i + 1)
        tt.update(k, i + 1)
        if i % 6 == 0:
            assert tt.root() == jt.root()
    tt.update(keys[3], 0)
    jt.update(keys[3], 0)
    root = tt.root()
    assert root == jt.root()
    for k in rnd.sample(keys, 6):
        sib = tt.prove(k)
        assert sib == jt.prove(k)
        val = tt.get(k)
        if val is None:
            continue
        assert tverify_proof(root, k, val, sib) and jverify_proof(root, k, val, sib)
        assert not tverify_proof(root, k, val + 1, sib) and not jverify_proof(root, k, val + 1, sib)


def test_native_zktrie_built_in_port():
    """The port's C++ trie builds from its own source into its own build
    directory and agrees with the Python trie."""
    if not tzktrie.native_available():
        pytest.skip("no C++ compiler to build the native zktrie")
    assert tzktrie._lib_path().startswith(tzktrie._BUILD_DIR)
    t1, t2 = TZkTrie(), TPyZkTrie()
    for k, v in [(5, 100), (6, 200), (1 << 50, 300), (7, 400)]:
        t1.update(k, v)
        t2.update(k, v)
    assert t1.root() == t2.root()
    assert t1.prove(6) == t2.prove(6)


def test_secp256k1_recovery_identical():
    rnd = random.Random(0x5EC9)
    for _ in range(3):
        d = rnd.randrange(1, tsecp.N)
        z = rnd.getrandbits(256) % tsecp.N
        k = rnd.randrange(1, tsecp.N)
        rp = tsecp.mul(tsecp.G, k)
        r = rp[0] % tsecp.N
        s = pow(k, -1, tsecp.N) * (z + r * d) % tsecp.N
        q = tsecp.mul(tsecp.G, d)
        assert q == jsecp.mul(jsecp.G, d)
        got = tsecp.ecrecover(z, rp[1] & 1, r, s)
        assert got == q == jsecp.ecrecover(z, rp[1] & 1, r, s)
        assert tsecp.ecdsa_verify(z, r, s, q) and jsecp.ecdsa_verify(z, r, s, q)
        assert tsecp.glv_split(z) == jsecp.glv_split(z)


def test_load_chunk_and_env_identical(tmp_path, monkeypatch):
    """utils: a chunk directory of block files (numeric order, one wrapped in
    a jsonrpc envelope) loads to the same traces in both packages;
    init_env_and_log makes its run directory under the output root."""
    import json
    import logging

    from scroll_prover_tpu.utils import load_chunk as jload
    from scroll_prover_tpu_torch.utils import dump_as_json, init_env_and_log, load_chunk, read_json

    chunk = tmp_path / "chunk_3"
    for i, d in ((10, trace_dict(num_txs=1, num_logs=8)), (2, trace_dict())):
        body = {"result": {"blockTrace": d}} if i == 10 else d
        (chunk / f"block_{i}.json").parent.mkdir(exist_ok=True)
        (chunk / f"block_{i}.json").write_text(json.dumps(body))
    got, want = load_chunk(str(chunk)), jload(str(chunk))
    assert [len(t.transactions) for t in got] == [2, 1]
    assert [_plain(t) for t in got] == [_plain(t) for t in want]
    monkeypatch.setenv("SCROLL_PROVER_OUTPUT_DIR", str(tmp_path / "out"))
    root = logging.getLogger()
    handlers = list(root.handlers)
    try:
        out = init_env_and_log("chunk_test")
    finally:
        for h in root.handlers[len(handlers):]:
            root.removeHandler(h)
            h.close()
    assert out.startswith(str(tmp_path / "out")) and (tmp_path / "out").is_dir()
    path = dump_as_json(out, "info", {"k": 20})
    assert read_json(path) == {"k": 20}
