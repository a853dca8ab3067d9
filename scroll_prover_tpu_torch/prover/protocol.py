"""PlonkProtocol: the serialized proving-protocol descriptor.

Mirrors the snark-verifier `PlonkProtocol` JSON the reference ships as
`chunk.protocol` (decoded layout in SURVEY.md section 2.4: domain{k, n,
n_inv, gen, gen_inv}, preprocessed commitments, num_instance, num_witness,
num_challenge, transcript_initial_state, accumulator_indices). Generated
from our VerifyingKey; used for cross-layer compatibility checks (the env
plumbing HALO2_CHUNK_PROTOCOL, reference integration/src/prove.rs:15).
"""
from __future__ import annotations

import base64
import json

from ..fields.bn254 import FR_MOD
from ..proof_system.plonk.keygen import VerifyingKey


def protocol_from_vk(
    vk: VerifyingKey, num_instance: int, multiopen: str = "gwc"
) -> dict:
    dom = vk.domain
    pre = []
    for c in vk.fixed_commitments + vk.sigma_commitments:
        pre.append(None if c is None else [hex(c[0]), hex(c[1])])
    return {
        "domain": {
            "k": vk.k,
            "n": dom.n,
            "n_inv": hex(dom.n_inv),
            "gen": hex(dom.omega),
            "gen_inv": hex(dom.omega_inv),
        },
        "preprocessed": pre,
        "num_instance": [num_instance],
        "num_witness": [vk.cs.num_advice],
        "num_challenge": [4],  # theta, beta/gamma, y, x phases
        "num_gates": len(vk.cs.gates),
        "num_lookups": len(vk.cs.lookups),
        "transcript_initial_state": hex(vk.transcript_repr()),
        "accumulator_indices": [],
        # GWC19 | SHPLONK/BDFG21 (reference snark-verifier PolynomialCommitmentScheme)
        "multiopen": multiopen,
    }


def protocol_to_b64(protocol: dict) -> str:
    return base64.b64encode(json.dumps(protocol, sort_keys=True).encode()).decode()


def protocol_from_b64(b: str) -> dict:
    return json.loads(base64.b64decode(b))


def protocols_equal(a: dict, b: dict) -> bool:
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
