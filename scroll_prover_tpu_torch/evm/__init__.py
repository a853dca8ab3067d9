"""EVM execution + verifier-contract generation.

Capability parity targets (SURVEY.md section 2.2): the reference's `revm`
usage — `deploy_and_call(bytecode, calldata)` executing the YUL verifier
in-process (integration/src/verifier.rs:18-22) — and snark-verifier's
"EVM loader -> YUL codegen" producing evm_verifier.yul. The interpreter is
also what the witness replay reaches for the BN254 precompile calls
(addresses 6-8).
"""
from .interpreter import EVM, EvmRevert, deploy_and_call  # noqa: F401
from .verifier_contract import gen_verifier_bytecode  # noqa: F401
from .harness import DEPLOYMENT_CODE_FILENAME, EVMVerifier  # noqa: F401
