"""ZkTrie bindings (C++ backend) + PyZkTrie reference implementation.

Trie spec (both implementations, cross-checked in tests):
  empty subtree = 0
  leaf hash     = poseidon(key, value, domain=1)
  internal node = poseidon(left, right, domain=0)
  path          = little-endian key bits, max DEPTH=64 levels,
                  PATH-COMPRESSED: a subtree holding exactly one leaf
                  hashes to that leaf directly (Scroll-zktrie-style early
                  termination), so proof length = O(log n_leaves) and the
                  in-circuit MPT verifier pays per-level Poseidon cost
                  only down to the leaf's actual depth
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

from ..fields.bn254 import FR_MOD
from ..hashes.poseidon import poseidon_fr

DEPTH = 64
# the C++ source lives in this package; the library is built from it at
# first use into a git-ignored directory named by the source's hash, so an
# edited source rebuilds
_SRC = os.path.join(os.path.dirname(__file__), "..", "native", "zktrie_src", "zktrie.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "native", "build")
_lib = None
_tried = False


def _fr_bytes(v: int) -> bytes:
    return int(v % FR_MOD).to_bytes(32, "little")


def _lib_path() -> str:
    with open(_SRC, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libspt_zktrie_{tag}.so")


def _build(path: str) -> None:
    """g++ into a temporary name, then an atomic rename (parallel test
    workers may build at once)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(
        [os.environ.get("CXX", "g++"), "-O2", "-fPIC", "-shared", "-std=c++17", "-o", tmp, _SRC],
        capture_output=True, timeout=180, check=True,
    )
    os.replace(tmp, path)


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _lib_path()
    if not os.path.exists(path):
        try:
            _build(path)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    c_char_p = ctypes.c_char_p
    lib.spt_zktrie_init.argtypes = [
        c_char_p, c_char_p, c_char_p, c_char_p, c_char_p,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.spt_zktrie_hash2.argtypes = [
        c_char_p, c_char_p, ctypes.c_ubyte, ctypes.c_char_p,
    ]
    h = poseidon_fr
    rc = b"".join(_fr_bytes(c) for row in h.rc for c in row)
    mds = b"".join(_fr_bytes(c) for row in h.mds for c in row)
    n0inv = (-pow(FR_MOD, -1, 1 << 64)) % (1 << 64)
    r2 = pow(1 << 256, 2, FR_MOD)
    lib.spt_zktrie_init(
        FR_MOD.to_bytes(32, "little"),  # NOT _fr_bytes: p % p == 0
        n0inv.to_bytes(8, "little"), _fr_bytes(r2),
        rc, mds, h.r_f, h.r_p,
    )
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


class ZkTrie:
    """C++-backed trie (falls back to PyZkTrie when the lib is missing)."""

    def __new__(cls, *a, **k):
        if _load() is None:
            return PyZkTrie()
        return super().__new__(cls)

    def __init__(self):
        self._h = _load().spt_zktrie_new()

    def update(self, key: int, value: int) -> None:
        _lib.spt_zktrie_update(self._h, _fr_bytes(key), _fr_bytes(value))

    def get(self, key: int) -> int | None:
        out = ctypes.create_string_buffer(32)
        rc = _lib.spt_zktrie_get(self._h, _fr_bytes(key), out)
        if rc != 0:
            return None
        return int.from_bytes(out.raw, "little")

    def root(self) -> int:
        out = ctypes.create_string_buffer(32)
        assert _lib.spt_zktrie_root(self._h, out) == 0
        return int.from_bytes(out.raw, "little")

    def prove(self, key: int) -> list[int]:
        buf = ctypes.create_string_buffer(32 * DEPTH)
        n = _lib.spt_zktrie_prove(self._h, _fr_bytes(key), buf, DEPTH)
        assert n >= 0
        return [
            int.from_bytes(buf.raw[32 * i : 32 * (i + 1)], "little")
            for i in range(n)
        ]

    def __del__(self):
        try:
            if _lib is not None:
                _lib.spt_zktrie_free(self._h)
        except Exception:
            pass


class PyZkTrie:
    """Pure-Python reference implementation (same spec)."""

    def __init__(self):
        self.leaves: dict[int, int] = {}

    def update(self, key: int, value: int) -> None:
        key %= FR_MOD
        if value % FR_MOD == 0:
            self.leaves.pop(key, None)
        else:
            self.leaves[key] = value % FR_MOD

    def get(self, key: int) -> int | None:
        return self.leaves.get(key % FR_MOD)

    def _subtree(self, kv: list[tuple[int, int]], level: int) -> int:
        if not kv:
            return 0
        if len(kv) == 1 or level == DEPTH:
            k, v = kv[0]
            return poseidon_fr.hash2(k, v, domain=1)
        zeros = [p for p in kv if not (p[0] >> level) & 1]
        ones = [p for p in kv if (p[0] >> level) & 1]
        l = self._subtree(zeros, level + 1)
        r = self._subtree(ones, level + 1)
        return poseidon_fr.hash2(l, r, domain=0)

    def root(self) -> int:
        return self._subtree(sorted(self.leaves.items()), 0)

    def prove(self, key: int) -> list[int]:
        """Siblings along the key's path, root-side first; the path stops
        at the leaf's compressed depth (the first level where the key's
        subtree holds <= 1 leaf)."""
        key %= FR_MOD
        kv = sorted(self.leaves.items())
        out = []
        level = 0
        while len(kv) >= 2 and level < DEPTH:
            bit = (key >> level) & 1
            zeros = [p for p in kv if not (p[0] >> level) & 1]
            ones = [p for p in kv if (p[0] >> level) & 1]
            out.append(self._subtree(zeros if bit else ones, level + 1))
            kv = ones if bit else zeros
            level += 1
        return out


def verify_merkle_proof(root: int, key: int, value: int, siblings: list[int]) -> bool:
    """Recompute the root from a leaf + sibling path (root-side first);
    the leaf sits at depth len(siblings) (path-compressed placement)."""
    h = poseidon_fr.hash2(key % FR_MOD, value % FR_MOD, domain=1)
    for level in range(len(siblings) - 1, -1, -1):
        bit = (key >> level) & 1
        sib = siblings[level]
        h = poseidon_fr.hash2(sib, h, domain=0) if bit else poseidon_fr.hash2(h, sib, domain=0)
    return h == root
