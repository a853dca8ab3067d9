"""The orchestration layer and the chain_prover CLI against the JAX
package's (tests/test_orchestration.py's cases): builders, clients behind
fake transports, the isolated prove wrappers and chain_prover's block and
txtx_ccc loops, each given the same inputs in both packages with the same
results."""
import copy
import logging
import os

import numpy as np
import pytest
import torch

import scroll_prover_tpu.orchestration as J
import scroll_prover_tpu.orchestration.prove_utils as jpu
import scroll_prover_tpu_torch.orchestration as T
import scroll_prover_tpu_torch.orchestration.prove_utils as tpu
from scroll_prover_tpu.l2types import BlockTrace as JBlockTrace
from scroll_prover_tpu.prover.chunk_info import ChunkInfo as JChunkInfo
from scroll_prover_tpu_torch.bin import chain_prover as tcp
from scroll_prover_tpu_torch.l2types import BlockTrace
from scroll_prover_tpu_torch.prover.chunk_info import ChunkInfo
from tests.torch_trace_cases import trace_dict

SIDES = {"jax": (J, JBlockTrace, JChunkInfo), "port": (T, BlockTrace, ChunkInfo)}
TRACE_JSON = {
    "chainID": 5, "version": "t", "coinbase": {"address": "0x0"},
    "header": {"number": "0x10"}, "transactions": [],
    "storageTrace": {}, "executionResults": [],
}


def _both(fn):
    """fn(side) for the JAX package and the port; asserts equal results."""
    out = {name: fn(*side) for name, side in SIDES.items()}
    assert out["port"] == out["jax"], out
    return out["port"]


def _info(chunk_info_cls, tx_bytes):
    return chunk_info_cls(
        chain_id=1, prev_state_root="0x" + "00" * 32, post_state_root="0x" + "01" * 32,
        withdraw_root="0x" + "02" * 32, data_hash="0x" + "03" * 32, tx_bytes=tx_bytes,
    )


def test_chunk_builder_seals_like_jax():
    d = trace_dict(num_txs=2, num_logs=30)

    def run(pkg, block_trace, _ci):
        cb = pkg.ChunkBuilder()
        sealed = [cb.add(block_trace.from_json(copy.deepcopy(d))) for _ in range(12)]
        rest = cb.flush()
        return [None if s is None else len(s) for s in sealed], len(rest or [])

    sealed, rest = _both(run)
    assert any(sealed) or rest


@pytest.mark.parametrize("payload", ["count", "blob_size"])
def test_batch_builder_seals_like_jax(payload):
    rng = np.random.default_rng(7)
    blobs = [rng.bytes(30_000) for _ in range(10)]

    def run(pkg, _bt, chunk_info_cls):
        bb = pkg.BatchBuilder()
        for i in range(46 if payload == "count" else 10):
            sealed = bb.add(_info(chunk_info_cls, b"x" * 10 if payload == "count" else blobs[i]))
            if sealed:
                return i, len(sealed), bb.batch_index, len(bb.flush())
        return None

    got = _both(run)
    assert got is not None
    if payload == "count":
        assert got[1] == 45


def test_l2geth_client_like_jax():
    def run(pkg, _bt, _ci):
        seen = []

        def transport(payload):
            seen.append((payload["method"], payload["params"]))
            return {"jsonrpc": "2.0", "id": 1, "result": TRACE_JSON}

        c = pkg.L2gethClient("http://fake", transport=transport)
        a = c.get_block_trace_by_num(16, override_curie=True)
        b = c.get_block_trace_by_num(16)
        return seen, (a.number, a.chain_id, b.number, b.chain_id)

    seen, nums = _both(run)
    assert seen[0][1] == ["0x10", {"overrides": {"curieBlock": 1}}]
    assert seen[1][1] == ["0x10", {"StorageProofFormat": "legacy"}]
    assert nums == (16, 5, 16, 5)


def test_l2geth_client_raises_on_rpc_error_like_jax():
    def run(pkg, _bt, _ci):
        c = pkg.L2gethClient("http://fake", transport=lambda p: {"error": {"code": -1, "message": "no"}})
        with pytest.raises(RuntimeError) as e:
            c.get_block_number()
        return str(e.value)

    _both(run)


def test_rollupscan_client_like_jax():
    def run(pkg, _bt, _ci):
        def transport(url):
            assert "batch_index=3" in url
            return {"batch_index": 3, "chunks": [{"index": 9, "start_block_number": 100, "end_block_number": 110}]}

        out = pkg.RollupscanClient("http://fake", transport=transport).get_chunk_info_by_batch_index(3)
        return [(c.index, c.start_block_number, c.end_block_number) for c in out]

    assert _both(run) == [(9, 100, 110)]


def test_prove_chunk_isolation_and_modes_like_jax(monkeypatch):
    """CIRCUIT=none skips, CIRCUIT=ccc hands the traces to the mock prover
    (recorded here), a failure never raises; the port's wrappers take a
    device and isolate a missing card as well."""
    import scroll_prover_tpu.prover.mock as jmock
    import scroll_prover_tpu_torch.prover.mock as tmock

    d = trace_dict()
    out = {}
    for name, (pu, mock, block_trace) in {"jax": (jpu, jmock, JBlockTrace), "port": (tpu, tmock, BlockTrace)}.items():
        kw = {"device": "cpu"} if name == "port" else {}
        mocked = []
        monkeypatch.setattr(mock, "mock_prove_target_circuit_chunk", lambda traces: mocked.append(len(traces)))
        got = []
        for mode in ("none", "ccc", "real"):
            monkeypatch.setenv("CIRCUIT", mode)
            traces = [] if mode == "real" else [block_trace.from_json(copy.deepcopy(d))]
            got.append(pu.prove_chunk({}, "", traces, **kw))
        got.append(pu.prove_batch({}, "", None, **kw))
        got.append(pu.mock_prove([]))
        out[name] = (got, mocked)
    assert out["port"] == out["jax"] == ([None, None, None, None, True], [1, 0])
    if not torch.cuda.is_available():
        # without a card and without device="cpu", ChunkProver raises inside
        # (after the production cap profile has set its SPT_*_CAP variables:
        # they are put back, so later tests see the environment they had)
        monkeypatch.setenv("CIRCUIT", "real")
        saved = dict(os.environ)
        try:
            assert tpu.prove_chunk({}, "", [BlockTrace.from_json(copy.deepcopy(d))]) is None
        finally:
            os.environ.clear()
            os.environ.update(saved)


def test_mock_prove_accepts_the_synthetic_block():
    """The port's mock tier on tests/test_witness_ccc.py's synthetic block
    (tests/test_orchestration.py holds the JAX package's: True)."""
    assert tpu.mock_prove([BlockTrace.from_json(trace_dict())])
    assert not tpu.mock_prove([])


def test_chain_prover_block_and_ccc_modes_like_jax(tmp_path, monkeypatch, caplog):
    """chain_prover's block loop (CIRCUIT=none: the builders and chunk
    infos without a prover) and txtx_ccc over a fake l2geth: the same chunks
    handed to prove_chunk and the same log lines in both packages."""
    import importlib
    import sys

    monkeypatch.setenv("CIRCUIT", "none")
    monkeypatch.setenv("SCROLL_PROVER_OUTPUT_DIR", str(tmp_path))
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "bin"))
    try:
        jcp = importlib.import_module("chain_prover")
    finally:
        sys.path.pop(0)
    d = trace_dict()
    out = {}
    for name, (cp, pkg, pu, block_trace) in {
        "jax": (jcp, J, jpu, JBlockTrace), "port": (tcp, T, tpu, BlockTrace),
    }.items():
        calls = []
        real = pu.prove_chunk
        monkeypatch.setattr(pu, "prove_chunk", lambda p, a, blocks, *r, **kw: calls.append((len(blocks), r, kw))
                            or real(p, a, blocks, *r, **kw))

        class FakeClient:
            def get_block_trace_by_num(self, n):
                return block_trace.from_json(copy.deepcopy(d))

        setting = pkg.Setting(
            l2geth_api_url="", rollupscan_api_url="", begin_batch=1, end_batch=1, begin_block=1, end_block=3,
            test_mode="block_prove", params_dir=str(tmp_path), assets_dir=str(tmp_path),
        )
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="chain_prover"):
            if name == "port":
                cp.prove_by_block(setting, FakeClient(), device="cpu")
            else:
                cp.prove_by_block(setting, FakeClient())
            cp.txtx_ccc(setting, FakeClient())
        out[name] = ([c[0] for c in calls], [r.getMessage() for r in caplog.records if r.name == "chain_prover"])
        if name == "port":
            assert all(c[2] == {"device": "cpu"} for c in calls)
    assert out["port"] == out["jax"]
    assert out["port"][0] and len(out["port"][1]) >= 3


def test_setting_reads_the_environment_like_jax(monkeypatch):
    monkeypatch.setenv("TEST_MODE", "txtx_ccc")
    monkeypatch.setenv("PROVE_BEGIN_BLOCK", "5")
    monkeypatch.setenv("PROVE_END_BLOCK", "9")
    monkeypatch.setenv("L2GETH_API_URL", "http://node")
    assert vars(T.Setting.new()) == vars(J.Setting.new())
    assert T.Setting.new().begin_block == 5


def test_padded_batch_like_jax():
    def run(_pkg, _bt, chunk_info_cls):
        padded = _pkg.BatchBuilder.padded([_info(chunk_info_cls, b"abc")])
        return len(padded), [ci.tx_bytes for ci in padded[1:3]]

    _both(run)
