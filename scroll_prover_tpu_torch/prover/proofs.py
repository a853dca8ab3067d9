"""Proof objects + artifact serialization.

Wire shapes mirror the reference's chunk-proof JSON (SURVEY.md section 2.4:
`{protocol(b64), proof(b64), instances(b64, 32B BE words), vk(b64),
chunk_info, git_version, row_usages}`). The chunk side only: the batch and
bundle wrappers come with the aggregator.
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
