"""EVM execution: the interpreter that the witness replay reaches for the
BN254 precompile calls (addresses 6-8). The verifier contract and its
harness are not part of this package yet."""
from .interpreter import EVM, EvmRevert, deploy_and_call  # noqa: F401
