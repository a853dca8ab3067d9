"""BlockTrace dataclasses + JSON codec.

Field names follow the l2geth `scroll_getBlockTraceByNumberOrHash` JSON
schema exactly (reference fixture layout documented in SURVEY.md section
2.4 "BlockTrace JSON schema"); unknown fields are preserved in `extra` so
re-serialization round-trips.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

from ..trace import spanned


def _hex_int(v, default=0) -> int:
    if v is None:
        return default
    if isinstance(v, int):
        return v
    s = str(v)
    return int(s, 16) if s.startswith("0x") else int(s)


@dataclass
class AccountWrapper:
    address: str = ""
    nonce: int = 0
    balance: int = 0
    keccak_code_hash: str = ""
    poseidon_code_hash: str = ""
    code_size: int = 0

    @classmethod
    def from_json(cls, d: dict | None) -> "AccountWrapper":
        d = d or {}
        return cls(
            address=d.get("address", ""),
            nonce=_hex_int(d.get("nonce")),
            balance=_hex_int(d.get("balance")),
            keccak_code_hash=d.get("keccakCodeHash", ""),
            poseidon_code_hash=d.get("poseidonCodeHash", ""),
            code_size=_hex_int(d.get("codeSize")),
        )


@dataclass
class TransactionTrace:
    type: int = 0
    nonce: int = 0
    tx_hash: str = ""
    gas: int = 0
    gas_price: int = 0
    gas_tip_cap: int = 0
    gas_fee_cap: int = 0
    from_addr: str = ""
    to_addr: str | None = None
    chain_id: int = 0
    value: int = 0
    data: str = "0x"
    is_create: bool = False
    access_list: list = field(default_factory=list)
    v: int = 0
    r: str = "0x0"
    s: str = "0x0"

    @classmethod
    def from_json(cls, d: dict) -> "TransactionTrace":
        return cls(
            type=_hex_int(d.get("type")),
            nonce=_hex_int(d.get("nonce")),
            tx_hash=d.get("txHash", ""),
            gas=_hex_int(d.get("gas")),
            gas_price=_hex_int(d.get("gasPrice")),
            gas_tip_cap=_hex_int(d.get("gasTipCap")),
            gas_fee_cap=_hex_int(d.get("gasFeeCap")),
            from_addr=d.get("from", ""),
            to_addr=d.get("to"),
            chain_id=_hex_int(d.get("chainId")),
            value=_hex_int(d.get("value")),
            data=d.get("data", "0x"),
            is_create=bool(d.get("isCreate", False)),
            access_list=d.get("accessList") or [],
            v=_hex_int(d.get("v")),
            r=d.get("r", "0x0"),
            s=d.get("s", "0x0"),
        )

    @property
    def call_data(self) -> bytes:
        return bytes.fromhex(self.data[2:]) if self.data.startswith("0x") else b""

    @property
    def is_l1_msg(self) -> bool:
        return self.type == 0x7E  # L1MessageTx


@dataclass
class StructLog:
    pc: int
    op: str
    gas: int
    gas_cost: int
    depth: int
    extra: dict = field(default_factory=dict)

    @classmethod
    def from_json(cls, d: dict) -> "StructLog":
        known = {"pc", "op", "gas", "gasCost", "depth"}
        return cls(
            pc=d.get("pc", 0),
            op=d.get("op", ""),
            gas=d.get("gas", 0),
            gas_cost=d.get("gasCost", 0),
            depth=d.get("depth", 1),
            extra={k: v for k, v in d.items() if k not in known},
        )


@dataclass
class ExecutionResult:
    l1_data_fee: int = 0
    gas: int = 0
    failed: bool = False
    return_value: str = ""
    from_acc: AccountWrapper | None = None
    to_acc: AccountWrapper | None = None
    account_after: list = field(default_factory=list)
    poseidon_code_hash: str = ""
    byte_code: str = ""
    struct_logs: list[StructLog] = field(default_factory=list)
    call_trace: dict = field(default_factory=dict)
    prestate: dict = field(default_factory=dict)

    @classmethod
    def from_json(cls, d: dict) -> "ExecutionResult":
        return cls(
            l1_data_fee=_hex_int(d.get("l1DataFee")),
            gas=_hex_int(d.get("gas")),
            failed=bool(d.get("failed", False)),
            return_value=d.get("returnValue", ""),
            from_acc=AccountWrapper.from_json(d.get("from")),
            to_acc=AccountWrapper.from_json(d.get("to")) if d.get("to") else None,
            account_after=d.get("accountAfter") or [],
            poseidon_code_hash=d.get("poseidonCodeHash", ""),
            byte_code=d.get("byteCode", ""),
            struct_logs=[StructLog.from_json(s) for s in d.get("structLogs") or []],
            call_trace=d.get("callTrace") or {},
            prestate=d.get("prestate") or {},
        )


@dataclass
class StorageTrace:
    root_before: str = "0x" + "00" * 32
    root_after: str = "0x" + "00" * 32
    proofs: dict = field(default_factory=dict)
    storage_proofs: dict = field(default_factory=dict)

    @classmethod
    def from_json(cls, d: dict | None) -> "StorageTrace":
        d = d or {}
        return cls(
            root_before=d.get("rootBefore", "0x" + "00" * 32),
            root_after=d.get("rootAfter", "0x" + "00" * 32),
            proofs=d.get("proofs") or {},
            storage_proofs=d.get("storageProofs") or {},
        )


@dataclass
class BlockTrace:
    chain_id: int = 0
    version: str = ""
    coinbase: AccountWrapper = field(default_factory=AccountWrapper)
    header: dict = field(default_factory=dict)
    transactions: list[TransactionTrace] = field(default_factory=list)
    storage_trace: StorageTrace = field(default_factory=StorageTrace)
    tx_storage_traces: list[StorageTrace] = field(default_factory=list)
    execution_results: list[ExecutionResult] = field(default_factory=list)
    withdraw_trie_root: str = "0x" + "00" * 32
    start_l1_queue_index: int = 0
    extra: dict = field(default_factory=dict)

    @classmethod
    @spanned("witness.parse")
    def from_json(cls, d: dict) -> "BlockTrace":
        known = {
            "chainID", "version", "coinbase", "header", "transactions",
            "storageTrace", "txStorageTraces", "executionResults",
            "withdraw_trie_root", "startL1QueueIndex",
        }
        return cls(
            chain_id=_hex_int(d.get("chainID")),
            version=d.get("version", ""),
            coinbase=AccountWrapper.from_json(d.get("coinbase")),
            header=d.get("header") or {},
            transactions=[TransactionTrace.from_json(t) for t in d.get("transactions") or []],
            storage_trace=StorageTrace.from_json(d.get("storageTrace")),
            tx_storage_traces=[StorageTrace.from_json(t) for t in d.get("txStorageTraces") or []],
            execution_results=[ExecutionResult.from_json(e) for e in d.get("executionResults") or []],
            withdraw_trie_root=d.get("withdraw_trie_root", "0x" + "00" * 32),
            start_l1_queue_index=_hex_int(d.get("startL1QueueIndex")),
            extra={k: v for k, v in d.items() if k not in known},
        )

    @property
    def number(self) -> int:
        return _hex_int(self.header.get("number"))

    @property
    def gas_used(self) -> int:
        return _hex_int(self.header.get("gasUsed"))

    @property
    def timestamp(self) -> int:
        return _hex_int(self.header.get("timestamp"))

    @property
    def state_root_before(self) -> str:
        return self.storage_trace.root_before

    @property
    def state_root_after(self) -> str:
        return self.storage_trace.root_after

    def sub_trace_for_tx(self, i: int) -> "BlockTrace":
        """Single-tx slice (the per-tx CCC path, reference
        capacity_checker.rs:130-140)."""
        return BlockTrace(
            chain_id=self.chain_id,
            version=self.version,
            coinbase=self.coinbase,
            header=self.header,
            transactions=[self.transactions[i]],
            storage_trace=(
                self.tx_storage_traces[i]
                if i < len(self.tx_storage_traces)
                else self.storage_trace
            ),
            tx_storage_traces=[],
            execution_results=[self.execution_results[i]]
            if i < len(self.execution_results)
            else [],
            withdraw_trie_root=self.withdraw_trie_root,
            start_l1_queue_index=self.start_l1_queue_index,
        )


def get_block_trace_from_file(path: str) -> BlockTrace:
    with open(path) as fh:
        d = json.load(fh)
    # coordinator dumps wrap the trace in jsonrpc envelopes
    if "result" in d and isinstance(d["result"], dict):
        d = d["result"]
    if "blockTrace" in d:
        d = d["blockTrace"]
    return BlockTrace.from_json(d)


_CHAIN_CONSTANTS: dict[str, Any] = {}


def set_scroll_block_constants_with_trace(trace: BlockTrace) -> None:
    """Record per-chain constants from a trace (reference:
    bin/src/trace_prover.rs:33)."""
    _CHAIN_CONSTANTS.update(
        chain_id=trace.chain_id,
        version=trace.version,
        coinbase=trace.coinbase.address,
    )


def scroll_block_constants() -> dict:
    return dict(_CHAIN_CONSTANTS)
