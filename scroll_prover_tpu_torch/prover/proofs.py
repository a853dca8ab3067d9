"""Proof objects + artifact serialization.

Wire shapes mirror the reference's chunk-proof JSON (SURVEY.md section 2.4:
`{protocol(b64), proof(b64), instances(b64, 32B BE words), vk(b64),
chunk_info, git_version, row_usages}`) and the Batch/Bundle wrappers
(`BatchProofV2.inner.batch_hash`, `BundleProof::calldata()` — SURVEY.md
section 2.3).
"""
from __future__ import annotations

import base64
from dataclasses import dataclass, field

from ..utils.env import short_git_version
from ..utils.io import dump_as_json, read_json
from .chunk_info import ChunkInfo


def encode_instances(instances: list[int]) -> bytes:
    return b"".join(int(v).to_bytes(32, "big") for v in instances)


def decode_instances(b: bytes) -> list[int]:
    return [int.from_bytes(b[i : i + 32], "big") for i in range(0, len(b), 32)]


@dataclass
class ProofPayload:
    """One PLONK proof + its metadata (protocol/instances/vk digest)."""

    proof: bytes
    instances: list[int]
    protocol: dict
    vk_id: str  # digest identifying the verifying key

    def to_json(self) -> dict:
        from .protocol import protocol_to_b64

        return {
            "proof": base64.b64encode(self.proof).decode(),
            "instances": base64.b64encode(encode_instances(self.instances)).decode(),
            "protocol": protocol_to_b64(self.protocol),
            "vk": self.vk_id,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ProofPayload":
        from .protocol import protocol_from_b64

        return cls(
            proof=base64.b64decode(d["proof"]),
            instances=decode_instances(base64.b64decode(d["instances"])),
            protocol=protocol_from_b64(d["protocol"]),
            vk_id=d["vk"],
        )


@dataclass
class ChunkProofInner:
    layers: list[ProofPayload]  # [inner, layer1, layer2]
    chunk_info_: ChunkInfo
    row_usages: list[dict] = field(default_factory=list)
    git_version: str = ""

    def chunk_info(self) -> ChunkInfo:
        return self.chunk_info_

    @property
    def proof(self) -> bytes:
        return self.layers[-1].proof


@dataclass
class ChunkProofV2:
    inner: ChunkProofInner

    def to_json(self) -> dict:
        top = self.inner.layers[-1].to_json()
        top.update(
            {
                "layers": [l.to_json() for l in self.inner.layers],
                "chunk_info": self.inner.chunk_info_.to_json(),
                "git_version": self.inner.git_version or short_git_version(),
                "row_usages": self.inner.row_usages,
            }
        )
        return top

    @classmethod
    def from_json(cls, d: dict) -> "ChunkProofV2":
        layers = [ProofPayload.from_json(l) for l in d["layers"]]
        return cls(
            ChunkProofInner(
                layers=layers,
                chunk_info_=ChunkInfo.from_json(d["chunk_info"]),
                row_usages=d.get("row_usages", []),
                git_version=d.get("git_version", ""),
            )
        )

    def dump(self, dir_path: str, name: str) -> str:
        return dump_as_json(dir_path, f"full_proof_chunk_{name}", self.to_json())

    @classmethod
    def from_file(cls, path: str) -> "ChunkProofV2":
        return cls.from_json(read_json(path))


@dataclass
class BatchProofInner:
    layers: list[ProofPayload]  # [layer3, layer4]
    batch_hash: bytes
    batch_header: object = None
    blob_bytes: bytes | None = None  # DA payload (verifier recomputes the
    # in-circuit blob-coefficient digest from these bytes)
    chunk_infos: list = None  # ChunkInfo per aggregated chunk (verifier
    # re-derives blob payload segments + data-hash binding from these)

    @property
    def proof(self) -> bytes:
        return self.layers[-1].proof


@dataclass
class BatchProofV2:
    inner: BatchProofInner

    def to_json(self) -> dict:
        return {
            "layers": [l.to_json() for l in self.inner.layers],
            "batch_hash": "0x" + self.inner.batch_hash.hex(),
            "batch_header": self.inner.batch_header.to_json()
            if self.inner.batch_header is not None
            else None,
            "blob_bytes": "0x" + self.inner.blob_bytes.hex()
            if self.inner.blob_bytes is not None
            else None,
            "chunk_infos": [ci.to_json() for ci in self.inner.chunk_infos]
            if self.inner.chunk_infos is not None
            else None,
        }

    @classmethod
    def from_json(cls, d: dict) -> "BatchProofV2":
        from ..aggregator.batch_header import BatchHeader

        return cls(
            BatchProofInner(
                layers=[ProofPayload.from_json(l) for l in d["layers"]],
                batch_hash=bytes.fromhex(d["batch_hash"][2:]),
                batch_header=BatchHeader.from_json(d["batch_header"])
                if d.get("batch_header")
                else None,
                blob_bytes=bytes.fromhex(d["blob_bytes"][2:])
                if d.get("blob_bytes")
                else None,
                chunk_infos=[
                    ChunkInfo.from_json(ci) for ci in d["chunk_infos"]
                ]
                if d.get("chunk_infos")
                else None,
            )
        )

    def dump(self, dir_path: str, name: str) -> str:
        return dump_as_json(dir_path, f"full_proof_batch_{name}", self.to_json())


@dataclass
class BundleProof:
    layers: list[ProofPayload]  # [layer5, layer6]

    @property
    def inner(self):
        return self

    @property
    def proof(self) -> bytes:
        return self.layers[-1].proof

    def calldata(self) -> bytes:
        """instances (32B BE words) || proof — the EVM verifier input shape
        (reference BundleProof::calldata, unit_tests.rs:79-81)."""
        return encode_instances(self.layers[-1].instances) + self.layers[-1].proof

    def to_json(self) -> dict:
        return {"layers": [l.to_json() for l in self.layers]}

    @classmethod
    def from_json(cls, d: dict) -> "BundleProof":
        return cls([ProofPayload.from_json(l) for l in d["layers"]])

    def dump(self, dir_path: str, name: str) -> str:
        return dump_as_json(dir_path, f"full_proof_bundle_{name}", self.to_json())
