"""zkEVM circuits: the ScrollSuperCircuit and its 15 subcircuits.

Capability parity with the reference's zkevm-circuits crate (SURVEY.md L3a:
evm, state, bytecode, copy, keccak, sha256, tx, rlp, exp, mod_exp, pi,
poseidon, sig, ecc, mpt — names and live row usage confirmed from fixture
batch_task_293205.json). Subcircuits assign witness tables from a
WitnessBlock; constraint depth varies by subcircuit (see subcircuits.py
docstrings) and deepens each round — the structure, row accounting, and
public-input layout are the stable contract.
"""
from .super_circuit import ScrollSuperCircuit, INNER_DEGREE, chunk_instance  # noqa: F401
