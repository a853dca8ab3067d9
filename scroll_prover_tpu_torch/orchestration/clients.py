"""HTTP clients: l2geth JSON-RPC + rollupscan coordinator API.

Mirrors integration/src/l2geth.rs (`get_block_trace_by_num` via
`scroll_getBlockTraceByNumberOrHash`, `get_txbytx_trace_by_num` via
`scroll_getTxByTxBlockTrace`, `get_block_number`) and
bin/src/rollupscan_client.rs (`get_chunk_info_by_batch_index`).
Network access is deployment-only; tests inject a transport.
"""
from __future__ import annotations

import json
import urllib.request
from dataclasses import dataclass


def _http_json(url: str, payload: dict | None = None, timeout: float = 30.0):
    if payload is not None:
        req = urllib.request.Request(
            url,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
    else:
        req = urllib.request.Request(url)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


class L2gethClient:
    def __init__(self, api_url: str, transport=None):
        self.api_url = api_url
        self._post = transport or (lambda payload: _http_json(self.api_url, payload))
        self._id = 0

    def _rpc(self, method: str, params: list):
        self._id += 1
        out = self._post(
            {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        )
        if "error" in out and out["error"]:
            raise RuntimeError(f"rpc {method}: {out['error']}")
        return out["result"]

    def get_block_number(self) -> int:
        return int(self._rpc("eth_blockNumber", []), 16)

    def get_block_trace_by_num(self, number: int, override_curie: bool = False):
        """Fetch a block trace. With override_curie=True the node is asked to
        force the Curie hard fork while tracing via the chain-config override
        {"overrides": {"curieBlock": 1}} — parity with the reference's
        get_block_trace_by_num(…, override_curie) (integration/src/l2geth.rs:
        36-66; any small curieBlock value works, 1 chosen like the
        reference)."""
        from ..l2types.block_trace import BlockTrace

        params = (
            [hex(number), {"overrides": {"curieBlock": 1}}]
            if override_curie
            else [hex(number), {"StorageProofFormat": "legacy"}]
        )
        res = self._rpc("scroll_getBlockTraceByNumberOrHash", params)
        return BlockTrace.from_json(res)

    def get_block_trace_raw(self, number: int) -> dict:
        """Raw trace JSON as returned by the node — what the fixture dumper
        persists byte-for-byte (reference trace_dumper.py saves
        response.json()['result'] verbatim)."""
        return self._rpc(
            "scroll_getBlockTraceByNumberOrHash",
            [hex(number), {"StorageProofFormat": "legacy"}],
        )

    def get_txbytx_trace_by_num(self, number: int):
        from ..l2types.block_trace import BlockTrace

        res = self._rpc(
            "scroll_getTxByTxBlockTrace",
            [hex(number), {"StorageProofFormat": "legacy"}],
        )
        return [BlockTrace.from_json(t) for t in res]


@dataclass
class ChunkRange:
    index: int
    start_block_number: int
    end_block_number: int


class RollupscanClient:
    def __init__(self, api_url: str, transport=None):
        self.api_url = api_url
        self._get = transport or (lambda url: _http_json(url))

    def get_chunk_info_by_batch_index(self, batch_index: int) -> list[ChunkRange]:
        out = self._get(f"{self.api_url}?batch_index={batch_index}")
        chunks = (out.get("data") or out).get("chunks") or []
        return [
            ChunkRange(
                index=c["index"],
                start_block_number=c["start_block_number"],
                end_block_number=c["end_block_number"],
            )
            for c in chunks
        ]
