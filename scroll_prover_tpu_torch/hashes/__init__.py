"""Hash primitives: Poseidon (transcripts, zktrie, code hash), Keccak-256
(EVM transcript, data hashes), plus stdlib Blake2b/SHA256 where needed.

Capability parity: reference pins poseidon/poseidon-base/poseidon-circuit
(SURVEY.md section 2.2, Cargo.lock:2927-2957) and uses Keccak transcripts for
the final bundle layer (SURVEY.md section 3.2 layer6).
"""
from .poseidon import Poseidon, poseidon_fr  # noqa: F401
from .keccak import keccak256  # noqa: F401
