"""EVMVerifier harness (reference integration/src/verifier.rs).

`EVMVerifier.from_dirs` reads the deployment bytecode artifact
(DEPLOYMENT_CODE_FILENAME, verifier.rs:3,13); `verify_evm_proof(calldata)`
executes it under the in-process EVM (deploy_and_call, verifier.rs:18-22)
and returns gas used on success.
"""
from __future__ import annotations

import logging
import os

from .interpreter import EvmRevert, deploy_and_call

log = logging.getLogger(__name__)

DEPLOYMENT_CODE_FILENAME = "evm_verifier.bin"


class EVMVerifier:
    def __init__(self, deployment_code: bytes):
        self.deployment_code = deployment_code

    @classmethod
    def from_dirs(cls, output_dir: str) -> "EVMVerifier":
        path = os.path.join(output_dir, DEPLOYMENT_CODE_FILENAME)
        with open(path, "rb") as fh:
            return cls(fh.read())

    def verify_evm_proof(self, calldata: bytes) -> int | None:
        try:
            gas = deploy_and_call(self.deployment_code, calldata)
            log.info("EVM verification passed, gas = %d", gas)
            return gas
        except EvmRevert as e:
            log.error("EVM verification reverted: %s", e)
            return None
