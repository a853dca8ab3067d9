"""ctypes binding for the native zstd codec (zstd_src/zstd_codec.cpp over the
system libzstd), built with g++ at first use into the git-ignored
native/build/, named by the source's hash.

Falls back to "unavailable" (raw blob envelope) when no compiler/libzstd
exists; blob encode/decode stays functional either way.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "zstd_src", "zstd_codec.cpp")
_BUILD_DIR = os.path.join(_DIR, "build")
_lib = None
_tried = False


def _lib_path() -> str:
    with open(_SRC, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libspt_zstd_{tag}.so")


def _build(path: str) -> None:
    """g++ into a temporary name, then an atomic rename (parallel test
    workers may build at once)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(
        [os.environ.get("CXX", "g++"), "-O2", "-fPIC", "-shared", "-std=c++17", "-o", tmp, _SRC, "-lzstd"],
        capture_output=True, timeout=120, check=True,
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
        lib.spt_zstd_compress.restype = ctypes.c_size_t
        lib.spt_zstd_decompress.restype = ctypes.c_size_t
        lib.spt_zstd_compress_bound.restype = ctypes.c_size_t
        _lib = lib
    except OSError:
        _lib = None
    return _lib


# Scroll's zstd fork strips the 4-byte frame magic from its output and
# its decoder expects magic-less input (aggregator blob convention —
# verified against the reference fixture: test_data/batch-task-with-blob
# .json's envelope-0x01 body decodes with VANILLA libzstd once the magic
# is re-added, i.e. the fork's frame IS standard zstd minus the header).
ZSTD_MAGIC = bytes.fromhex("28b52ffd")


def zstd_available() -> bool:
    return _load() is not None


def zstd_compress(data: bytes, strip_magic: bool = True) -> bytes:
    """Compress; by default emit the scroll-fork magic-less frame."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native zstd codec unavailable")
    bound = lib.spt_zstd_compress_bound(len(data))
    dst = ctypes.create_string_buffer(bound)
    n = lib.spt_zstd_compress(data, len(data), dst, bound)
    if n == 0:
        raise RuntimeError("zstd compression failed")
    out = dst.raw[:n]
    if strip_magic and out[:4] == ZSTD_MAGIC:
        out = out[4:]
    return out


def zstd_decompress(data: bytes, max_size: int = 1 << 22) -> bytes:
    """Decompress either a full frame or a scroll-style magic-less one."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native zstd codec unavailable")
    if data[:4] != ZSTD_MAGIC:
        data = ZSTD_MAGIC + data
    dst = ctypes.create_string_buffer(max_size)
    n = lib.spt_zstd_decompress(data, len(data), dst, max_size)
    if n == 0:
        raise RuntimeError("zstd decompression failed")
    return dst.raw[:n]
