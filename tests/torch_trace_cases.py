"""Synthetic block traces as JSON dicts, for the port's parity tests.

`trace_dict(num_txs, num_logs)` is the JSON that
tests/test_witness_ccc.py:synthetic_trace feeds to the JAX package's
`BlockTrace.from_json` (that helper returns a JAX-side object, so both
packages get this dict instead). Options add what the plain generator lacks:
precompile sub-calls with real operands (ecAdd, ecMul, modexp, sha256) and
transactions signed with a known secp256k1 key, so that signature recovery
yields events."""
from __future__ import annotations

import copy

from scroll_prover_tpu_torch.curves import secp256k1
from scroll_prover_tpu_torch.curves.bn254_curve import G1, g1_generator
from scroll_prover_tpu_torch.hashes.keccak import keccak256

SIGNER_KEY = 0x1F2E3D4C5B6A79880123456789ABCDEF0FEDCBA9876543210112233445566778


def synthetic_program(num_logs):
    """(code_hex, structLogs), positionally consistent: the opcode byte at
    each logged pc is the logged op (tests/test_witness_ccc.py)."""
    ops = ["PUSH1", "SLOAD", "MSTORE", "SHA3", "CALLDATACOPY"] * (num_logs // 5 + 1)
    code = bytearray()
    logs = []
    for op in ops[:num_logs]:
        pc = len(code)
        logs.append({"pc": pc, "op": op, "gas": 100000 - pc, "gasCost": 3, "depth": 1})
        if op == "PUSH1":
            code += bytes([0x60, 0x01])
        else:
            code.append({"SLOAD": 0x54, "MSTORE": 0x52, "SHA3": 0x20, "CALLDATACOPY": 0x37}[op])
    return "0x" + code.hex(), logs


def _w(v: int) -> bytes:
    return v.to_bytes(32, "big")


def _precompile_calls() -> list[dict]:
    """ecAdd(G, 2G), ecMul(G, k), modexp(3^5 mod 1000003) and sha256 calls
    with their true outputs."""
    g = g1_generator()
    g2 = G1.add(g, g)
    k = 0x1234567890ABCDEF
    add_out = G1.add(g, g2)
    mul_out = G1.mul(g, k)
    mod_in = _w(32) + _w(32) + _w(32) + _w(3) + _w(5) + _w(1000003)
    sha_in = b"\x00" * 64
    import hashlib

    calls = [
        ("0x" + "00" * 19 + "06", _w(g[0]) + _w(g[1]) + _w(g2[0]) + _w(g2[1]), _w(add_out[0]) + _w(add_out[1])),
        ("0x" + "00" * 19 + "07", _w(g[0]) + _w(g[1]) + _w(k), _w(mul_out[0]) + _w(mul_out[1])),
        ("0x" + "00" * 19 + "05", mod_in, _w(pow(3, 5, 1000003))),
        ("0x" + "00" * 19 + "02", sha_in, hashlib.sha256(sha_in).digest()),
    ]
    return [{"type": "STATICCALL", "from": "0x" + "22" * 20, "to": to,
             "input": "0x" + inp.hex(), "output": "0x" + out.hex()} for to, inp, out in calls]


def _sign(tx: dict, sig_hash: bytes) -> None:
    """Legacy (v = 27/28) signature of `sig_hash` by SIGNER_KEY, and the
    signer's address as `from`."""
    z = int.from_bytes(sig_hash, "big") % secp256k1.N
    nonce = (int.from_bytes(keccak256(sig_hash + SIGNER_KEY.to_bytes(32, "big")), "big") % (secp256k1.N - 1)) + 1
    rp = secp256k1.mul(secp256k1.G, nonce)
    r = rp[0] % secp256k1.N
    s = pow(nonce, -1, secp256k1.N) * (z + r * SIGNER_KEY) % secp256k1.N
    parity = rp[1] & 1
    if s > secp256k1.N // 2:
        s, parity = secp256k1.N - s, parity ^ 1
    q = secp256k1.mul(secp256k1.G, SIGNER_KEY)
    addr = keccak256(q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big"))[12:]
    tx.update({"v": hex(27 + parity), "r": hex(r), "s": hex(s), "from": "0x" + addr.hex()})


def trace_dict(num_txs=2, num_logs=30, precompiles=False, signed=False) -> dict:
    txs, ers = [], []
    for i in range(num_txs):
        txs.append(
            {
                "type": 0, "nonce": i, "txHash": "0x" + "ab" * 32,
                "gas": 21000 + 500 * i, "gasPrice": "0x3b9aca00",
                "from": "0x" + "11" * 20, "to": "0x" + "22" * 20,
                "chainId": "0x82750", "value": "0x1", "data": "0xdeadbeef",
                "isCreate": False, "v": "0x1", "r": "0x2", "s": "0x3",
            }
        )
        code_hex, logs = synthetic_program(num_logs)
        call = {
            "type": "CALL", "from": "0x" + "11" * 20,
            "to": "0x0000000000000000000000000000000000000002",
            "input": "0x" + "00" * 64,
        }
        if precompiles:
            call["calls"] = _precompile_calls()
        ers.append(
            {
                "gas": 21000, "failed": False, "returnValue": "",
                "from": {"address": "0x" + "11" * 20, "nonce": i},
                "byteCode": code_hex,
                "structLogs": logs,
                "callTrace": call,
            }
        )
    d = {
        "chainID": 534352,
        "version": "test",
        "coinbase": {"address": "0x" + "33" * 20},
        "header": {"number": "0x64", "gasUsed": "0xa410", "timestamp": "0x5"},
        "transactions": txs,
        "storageTrace": {
            "rootBefore": "0x" + "01" * 32,
            "rootAfter": "0x" + "02" * 32,
            "proofs": {"0x" + "11" * 20: ["0xaa", "0xbb"]},
            "storageProofs": {"0x" + "22" * 20: {"0x0": ["0xcc"]}},
        },
        "executionResults": ers,
        "withdraw_trie_root": "0x" + "03" * 32,
        "startL1QueueIndex": 7,
    }
    if signed:
        from scroll_prover_tpu_torch.l2types import BlockTrace
        from scroll_prover_tpu_torch.witness.sig import tx_sig_hash

        bt = BlockTrace.from_json(copy.deepcopy(d))
        for tx, ttx in zip(d["transactions"], bt.transactions):
            _sign(tx, tx_sig_hash(ttx))
            ers_from = d["executionResults"][tx["nonce"]]["from"]
            ers_from["address"] = tx["from"]
    return d


WORD_OPS = {"MUL": 0x02, "DIV": 0x04, "MOD": 0x06, "LT": 0x10, "GT": 0x11, "EQ": 0x14, "ISZERO": 0x15, "NOT": 0x19}


def word_arith_trace_dict(plan) -> dict:
    """trace_dict(1 transaction) whose program runs the EVM word-arithmetic
    steps of `plan` (opcode names of WORD_OPS), each on PUSH1 operands and
    followed by a POP: PUSH1 a, PUSH1 b, OP, POP (PUSH1 a, OP, POP for
    ISZERO/NOT)."""
    code = bytearray()
    logs = []

    def step(op, byte, imm=None):
        logs.append({"pc": len(code), "op": op, "gas": 100000 - len(code), "gasCost": 3, "depth": 1})
        code.append(byte)
        if imm is not None:
            code.append(imm)

    for i, op in enumerate(plan):
        if op in ("ISZERO", "NOT"):
            step("PUSH1", 0x60, i % 3)
        else:
            step("PUSH1", 0x60, 7 + i % 50)
            step("PUSH1", 0x60, 3 + i % 13)
        step(op, WORD_OPS[op])
        step("POP", 0x50)
    d = trace_dict(num_txs=1, num_logs=5)
    d["executionResults"][0]["byteCode"] = "0x" + code.hex()
    d["executionResults"][0]["structLogs"] = logs
    return d
