"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc for sm_90a into its own shared library with a
plain C interface, loaded with ctypes. Sources build in parallel (one nvcc
per file, all started together) at first use, from the package's sources
only, into csrc/build/ (listed in .gitignore). A library's file name carries
a hash of its sources, so an edited kernel never loads a stale build.

Every C entry launches on the stream it is given and returns
cudaGetLastError(); `check` raises if that is not 0. Nothing here imports or
builds anything at module import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

from ..fields.limbs import FQ_LIMB, LimbField

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD = os.path.join(CSRC, "build")
SOURCES = ("mont_mul", "ntt", "msm", "fixed_base", "msm4", "ntt_fast")
HEADER = "bn254.cuh"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # source -> ptxas register/spill report


class FieldParams(ctypes.Structure):
    """Montgomery constants in 32-bit words: p and n0 = -p^-1 mod 2^32."""

    _fields_ = [("p", ctypes.c_uint32 * 8), ("n0", ctypes.c_uint32)]


class CurveParams(ctypes.Structure):
    """BN254 G1 over Fq: field params plus Montgomery one."""

    _fields_ = [
        ("fq", FieldParams),
        ("one", ctypes.c_uint32 * 8),
    ]


def _words(x: int) -> list[int]:
    return [(x >> (32 * j)) & 0xFFFFFFFF for j in range(8)]


_FIELD_PARAMS: dict[int, FieldParams] = {}


def field_params(f: LimbField) -> FieldParams:
    fp = _FIELD_PARAMS.get(f.modulus)
    if fp is None:
        p = f.modulus
        fp = FieldParams((ctypes.c_uint32 * 8)(*_words(p)), (-pow(p, -1, 1 << 32)) % (1 << 32))
        _FIELD_PARAMS[f.modulus] = fp
    return fp


_CURVE: list = []


def curve_params() -> CurveParams:
    if not _CURVE:
        p = FQ_LIMB.modulus
        r = (1 << 256) % p
        _CURVE.append(
            CurveParams(field_params(FQ_LIMB), (ctypes.c_uint32 * 8)(*_words(r)))
        )
    return _CURVE[0]


def _digest(name: str) -> str:
    h = hashlib.sha1()
    for fn in (f"{name}.cu", HEADER):
        with open(os.path.join(CSRC, fn), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def _so_path(name: str) -> str:
    return os.path.join(BUILD, f"{name}-{_digest(name)}.so")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the CUDA toolkit")
    return nvcc


def build_all() -> dict[str, float]:
    """Compile every missing library, all nvcc processes started together.
    Returns {source: seconds} for the ones built now."""
    todo = [s for s in SOURCES if not os.path.exists(_so_path(s))]
    if not todo:
        return {}
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for s in todo:
        tmp = _so_path(s) + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{s}.cu")]
        procs[s] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failed, seconds = [], {}
    for s, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[s] = out.decode(errors="replace")
        seconds[s] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(s)
        else:
            os.replace(tmp, _so_path(s))
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(BUILD_LOG[s][-4000:] for s in failed)
        )
    return seconds


_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# C entry signatures (csrc/*.cu); every pointer and the stream is c_void_p
_SIGS = {
    "mont_mul": {
        "spt_field": [_INT, _VP, _VP, _LL, _LL, _VP, _LL, _LL, _VP, _LL, _LL, _LL, FieldParams, _VP],
    },
    "ntt": {
        "spt_ntt_pass": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _INT, FieldParams, _VP],
        "spt_ntt_pass_occupancy": [_INT, _VP],
    },
    "msm": {
        "spt_msm_accum": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL, _LL, _LL, _INT, CurveParams, _VP],
        "spt_msm_slot_sums": [_VP, _VP, _LL, _INT, CurveParams, _VP],
        "spt_msm_window_fold": [_VP, _VP, _LL, _INT, _INT, CurveParams, _VP],
    },
    "fixed_base": {"spt_fixed_base": [_VP, _VP, _VP, _LL, CurveParams, _VP]},
    "msm4": {"spt_msm4_lanes": [_VP, _VP, _VP, _VP, _VP, _LL, _LL, _LL, CurveParams, _VP]},
    "ntt_fast": {
        "spt_butterfly": [_VP, _VP, _VP, _INT, _INT, _INT, FieldParams, _VP],
        "spt_butterfly4": [_VP, _VP, _VP, _INT, _INT, _INT, FieldParams, _VP],
        "spt_butterfly_occupancy": [_INT, _INT, _VP],
    },
}


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building all sources first if
    any is missing."""
    h = _LIBS.get(name)
    if h is None:
        if not os.path.exists(_so_path(name)):
            build_all()
        h = ctypes.CDLL(_so_path(name))
        for fn, argtypes in _SIGS[name].items():
            getattr(h, fn).argtypes = argtypes
            getattr(h, fn).restype = ctypes.c_int
        _LIBS[name] = h
    return h


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {rc}")

