"""Traffic of kind "chunk_traces": one chunk of block traces per task,
after the synthetic trace of the repo's witness tests (chip_smoke.py
`synthetic_trace` / `synthetic_program`), made seeded and made to replay.

Each transaction is a CALL into a contract whose straight-line program the
generator writes: a preamble that stores two seeded words and hashes them
with a STATICCALL into the mix's precompile, then the mix's instruction
cycle until the transaction has its count of struct logs. Every
instruction is preceded by the pushes it pops (the generator refuses a
cycle that underflows the stack or leaves it growing), and each struct
log's gas is the gas left before it, by the Berlin schedule with memory
expansion, so that a per-opcode replay of the program meets every log.
The log counts of a chunk are the mix's fixed list in a seeded order, so
every seed does the same amount of work; hashes, roots, nonces, values,
calldata, the preamble's words and every PUSH operand come from the seed.
Each transaction is signed (EIP-155) by the sender's key, drawn from the
seed, and its hash is that of the signed transaction.
"""
from __future__ import annotations

import hashlib

from benchlib import ethtx

# opcode: (byte, PUSH width, pops, pushes)
OPCODES = {
    "STOP": (0x00, 0, 0, 0), "ADD": (0x01, 0, 2, 1), "MUL": (0x02, 0, 2, 1), "SHA3": (0x20, 0, 2, 1),
    "CALLDATACOPY": (0x37, 0, 3, 0), "POP": (0x50, 0, 1, 0), "MLOAD": (0x51, 0, 1, 1),
    "MSTORE": (0x52, 0, 2, 0), "SLOAD": (0x54, 0, 1, 1), "JUMPDEST": (0x5B, 0, 0, 0),
    "PUSH1": (0x60, 1, 0, 1), "PUSH2": (0x61, 2, 0, 1), "PUSH32": (0x7F, 32, 0, 1), "DUP1": (0x80, 0, 1, 2),
    "STATICCALL": (0xFA, 0, 6, 1),
}
STATIC = {"STOP": 0, "JUMPDEST": 1, "POP": 2, "ADD": 3, "MUL": 5, "MLOAD": 3, "MSTORE": 3, "SHA3": 30,
          "CALLDATACOPY": 3, "DUP1": 3, "PUSH1": 3, "PUSH2": 3, "PUSH32": 3}
SLOAD_COLD, SLOAD_WARM, CALL_WARM = 2100, 100, 100
PRECOMPILE_GAS = {2: (60, 12), 3: (600, 120), 4: (15, 3)}  # sha256, ripemd160, identity: base, per word


def _words(n: int) -> int:
    return (n + 31) // 32


def _mem_cost(words: int) -> int:
    return 3 * words + words * words // 512


class _Program:
    """The code and struct logs of one transaction, with its gas and memory."""

    def __init__(self, gas: int):
        self.code = bytearray()
        self.logs = []
        self.gas = gas
        self.mem_words = 0
        self.warm: set[int] = set()
        self.stack: list[int] = []  # the values, as far as the gas schedule needs them

    def _expand(self, end: int) -> int:
        words = max(self.mem_words, _words(end))
        cost = _mem_cost(words) - _mem_cost(self.mem_words)
        self.mem_words = words
        return cost

    def emit(self, op: str, operand: int | None = None) -> None:
        byte, width, pops, pushes = OPCODES[op]
        if len(self.stack) < pops:
            raise ValueError(f"{op} pops {pops} from a stack of {len(self.stack)}")
        args = [self.stack.pop() for _ in range(pops)]  # top first, as the EVM pops
        cost = STATIC.get(op, 0)
        if op == "SLOAD":
            cost = SLOAD_WARM if args[0] in self.warm else SLOAD_COLD
            self.warm.add(args[0])
        elif op == "MSTORE":
            cost += self._expand(args[0] + 32)
        elif op == "MLOAD":
            cost += self._expand(args[0] + 32)
        elif op == "SHA3":
            cost += 6 * _words(args[1]) + (self._expand(args[0] + args[1]) if args[1] else 0)
        elif op == "CALLDATACOPY":
            cost += 3 * _words(args[2]) + (self._expand(args[0] + args[2]) if args[2] else 0)
        elif op == "STATICCALL":
            _g, to, in_off, in_size, out_off, out_size = args
            base, per_word = PRECOMPILE_GAS[to]
            cost = CALL_WARM + self._expand(max(in_off + in_size, out_off + out_size)) + base + per_word * _words(in_size)
        self.logs.append({"pc": len(self.code), "op": op, "gas": self.gas, "gasCost": cost, "depth": 1})
        self.gas -= cost
        self.code.append(byte)
        if width:
            self.code += operand.to_bytes(width, "big")
            self.stack.append(operand)
        else:
            self.stack += [0] * pushes  # results the schedule never reads back


def _hexbytes(rng, n: int) -> str:
    return "0x" + rng.randbytes(n).hex()


def check_cycle(cycle: list) -> None:
    """A cycle must start and end on an empty stack and never underflow."""
    depth = 0
    for ins in cycle:
        _b, _w, pops, pushes = OPCODES[ins[0]]
        if depth < pops:
            raise ValueError(f"the cycle's {ins[0]} underflows the stack")
        depth += pushes - pops
    if depth:
        raise ValueError(f"the cycle leaves {depth} values on the stack")


def program(rng, p: dict, num_logs: int, gas: int):
    """(code hex, struct logs, precompile input, its output) of one transaction."""
    check_cycle(p["cycle"])
    prog = _Program(gas)
    words = [rng.randbytes(32) for _ in range(p["precompile_input_bytes"] // 32)]
    for i, w in enumerate(words):
        prog.emit("PUSH32", int.from_bytes(w, "big"))
        prog.emit("PUSH1", 32 * i)
        prog.emit("MSTORE")
    data = b"".join(words)
    to = int(p["precompile"], 16)
    for v in (32, 0, len(data), 0, to):  # out size, out offset, in size, in offset, address
        prog.emit("PUSH1", v)
    prog.emit("PUSH2", 0xFFFF)
    prog.emit("STATICCALL")
    prog.emit("POP")
    while len(prog.logs) < num_logs:
        for ins in p["cycle"]:
            if len(prog.logs) == num_logs:
                break
            prog.emit(ins[0], rng.randrange(ins[1], ins[2]) if len(ins) > 1 else None)
    out = {2: lambda d: hashlib.sha256(d).digest(), 4: lambda d: d}[to](data)
    return "0x" + prog.code.hex(), prog.logs, gas - prog.gas, data, out


def make(p: dict, rng, task_seed) -> dict:
    """The inputs of one task: its chunk's traces and its blinding seed."""
    traces = []
    for _b in range(p["blocks"]):
        counts = list(p["logs_per_tx"])
        rng.shuffle(counts)
        key = rng.randrange(1, ethtx.N)
        sender, callee = ethtx.address(key), "0x" + "22" * 20
        txs, results = [], []
        nonce = rng.randrange(1 << 32)
        for num_logs in counts:
            nonce += 1
            calldata = rng.randbytes(p["calldata_bytes"])
            value, gas_price, gas = rng.randrange(1, 1 << 64), 10**9, 21000 + p["gas"]
            code, logs, used, pre_in, pre_out = program(rng, p, num_logs, p["gas"])
            sig = ethtx.sign_legacy(key, p["chain_id"], nonce, gas_price, gas, callee, value, calldata)
            txs.append({
                "type": 0, "nonce": nonce, "txHash": sig["txHash"],
                "gas": gas, "gasPrice": hex(gas_price), "from": sender, "to": callee,
                "chainId": hex(p["chain_id"]), "value": hex(value),
                "data": "0x" + calldata.hex(), "isCreate": False, "v": sig["v"], "r": sig["r"], "s": sig["s"],
            })
            calldata = "0x" + calldata.hex()
            results.append({
                "gas": 21000 + used, "failed": False, "returnValue": "",
                "from": {"address": sender, "nonce": nonce}, "byteCode": code, "structLogs": logs,
                "callTrace": {"type": "CALL", "from": sender, "to": callee, "input": calldata,
                              "calls": [{"type": "STATICCALL", "from": callee, "to": p["precompile"],
                                         "input": "0x" + pre_in.hex(), "output": "0x" + pre_out.hex()}]},
            })
        traces.append({
            "chainID": p["chain_id"], "version": "bench",
            "coinbase": {"address": "0x" + "33" * 20},
            "header": {"number": hex(rng.randrange(1, 1 << 40)), "gasUsed": hex(sum(r["gas"] for r in results)),
                       "timestamp": hex(rng.randrange(1, 1 << 40))},
            "transactions": txs,
            "storageTrace": {
                "rootBefore": _hexbytes(rng, 32), "rootAfter": _hexbytes(rng, 32),
                "proofs": {sender: ["0xaa", "0xbb"]}, "storageProofs": {callee: {"0x0": ["0xcc"]}},
            },
            "executionResults": results,
            "withdraw_trie_root": _hexbytes(rng, 32),
            "startL1QueueIndex": rng.randrange(1 << 16),
        })
    return {"traces": traces, "prove_seed": task_seed("blind")}
