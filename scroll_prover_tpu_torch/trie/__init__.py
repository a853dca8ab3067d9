"""zktrie: Poseidon sparse Merkle trie (state/storage witness).

Native C++ backend (native/zktrie_src, SURVEY.md section 2.2 native
component #1 — replaces the reference's Go zktrie) with a pure-Python
reference implementation for cross-checking and fallback.
"""
from .zktrie import ZkTrie, PyZkTrie, verify_merkle_proof  # noqa: F401
