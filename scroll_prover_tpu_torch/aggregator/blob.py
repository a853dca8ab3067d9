"""EIP-4844 blob math: coefficients, barycentric evaluation, point eval.

Role parity with the reference's c-kzg + bls12_381 usage (SURVEY.md section
2.2 native component #3; the BatchCircuit's "barycentric evaluation of
4096-coeff BLS12-381 blob poly"). The scalar-field math (coefficient
packing, barycentric evaluation at the Fiat-Shamir challenge — what the
aggregation circuit constrains) is fully implemented over the real
BLS12-381 scalar field. The curve-side work is REAL by default:
`blob_commitment` computes a BLS12-381 G1 KZG commitment over a
Lagrange-basis SRS and `point_evaluation_proof` is verified with the real
pairing (curves/bls12_381_pairing.py). SPT_STUB_BLOB_KZG=1 opts hermetic
speed-sensitive tests into a hash stub with the same wire shape — never
consensus-facing.
"""
from __future__ import annotations

import hashlib

from ..hashes.keccak import keccak256
from .constants import BLOB_WIDTH, N_BLOB_BYTES, N_DATA_BYTES_PER_COEFFICIENT

# BLS12-381 scalar field and its 2^12 root of unity (the blob domain)
BLS_MODULUS = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
_PRIMITIVE_ROOT = 7
ROOT_OF_UNITY_4096 = pow(
    _PRIMITIVE_ROOT, (BLS_MODULUS - 1) // BLOB_WIDTH, BLS_MODULUS
)


def blob_to_coefficients(blob_bytes: bytes) -> list[int]:
    """blob bytes -> 4096 field elements, 31 data bytes per coefficient
    (big-endian in the low bytes — matches the reference packing where each
    coefficient's top byte is zero; bin/src/constants.rs:8)."""
    assert len(blob_bytes) <= N_BLOB_BYTES
    padded = blob_bytes + b"\x00" * (N_BLOB_BYTES - len(blob_bytes))
    coeffs = []
    for i in range(BLOB_WIDTH):
        chunk = padded[i * N_DATA_BYTES_PER_COEFFICIENT : (i + 1) * N_DATA_BYTES_PER_COEFFICIENT]
        coeffs.append(int.from_bytes(chunk, "big"))
    return coeffs


def coefficients_to_blob(coeffs: list[int]) -> bytes:
    out = bytearray()
    for c in coeffs:
        out += int(c).to_bytes(N_DATA_BYTES_PER_COEFFICIENT, "big")
    return bytes(out)


def _roots_of_unity_brp() -> list[int]:
    """Bit-reversal-permuted domain (EIP-4844 evaluation-form convention)."""
    roots = [1] * BLOB_WIDTH
    for i in range(1, BLOB_WIDTH):
        roots[i] = roots[i - 1] * ROOT_OF_UNITY_4096 % BLS_MODULUS
    bits = BLOB_WIDTH.bit_length() - 1
    return [roots[int(bin(i)[2:].zfill(bits)[::-1], 2)] for i in range(BLOB_WIDTH)]


_DOMAIN = None


def _domain() -> list[int]:
    global _DOMAIN
    if _DOMAIN is None:
        _DOMAIN = _roots_of_unity_brp()
    return _DOMAIN


def barycentric_evaluate(coeffs: list[int], z: int) -> int:
    """Evaluate the blob polynomial (given in evaluation form over the
    bit-reversed 4096 domain) at z using the barycentric formula:
        p(z) = (z^N - 1)/N * sum_i f_i * w_i / (z - w_i)
    This is exactly what the reference BatchCircuit constrains in-circuit.
    """
    p = BLS_MODULUS
    z %= p
    dom = _domain()
    for i, w in enumerate(dom):
        if z == w:
            return coeffs[i] % p
    zn = pow(z, BLOB_WIDTH, p)
    factor = (zn - 1) * pow(BLOB_WIDTH, -1, p) % p
    total = 0
    # batch the modular inverses (Montgomery's trick)
    denoms = [(z - w) % p for w in dom]
    prefix = [1] * (BLOB_WIDTH + 1)
    for i, d in enumerate(denoms):
        prefix[i + 1] = prefix[i] * d % p
    inv_all = pow(prefix[-1], -1, p)
    invs = [0] * BLOB_WIDTH
    for i in range(BLOB_WIDTH - 1, -1, -1):
        invs[i] = inv_all * prefix[i] % p
        inv_all = inv_all * denoms[i] % p
    for i, w in enumerate(dom):
        total = (total + coeffs[i] * w % p * invs[i]) % p
    return total * factor % p


import os

_BLOB_KZG = None
_COMMIT_CACHE: dict[bytes, bytes] = {}


def _kzg():
    """Module singleton with a disk-cached Lagrange basis (the basis build
    costs ~20 s host-side; the toy-SRS seed is deterministic so the cache
    is safe). Production would load the ceremony's trusted_setup file here
    (reference c-kzg kzg_settings). The cache file is the port's own
    (`.cache/bls_basis_torch.bin` at the repository root), written under a
    temporary name and renamed, so that parallel workers never read half a
    file."""
    global _BLOB_KZG
    if _BLOB_KZG is None:
        from ..curves.bls12_381 import BlobKzg

        _BLOB_KZG = BlobKzg()
        cache = os.path.join(
            os.path.dirname(__file__), "..", "..", ".cache", "bls_basis_torch.bin"
        )
        try:
            if os.path.exists(cache):
                import pickle

                with open(cache, "rb") as f:
                    tau, basis = pickle.load(f)
                if tau == _BLOB_KZG.tau:
                    _BLOB_KZG._lagrange = basis
            else:
                _BLOB_KZG._lagrange_basis()
                os.makedirs(os.path.dirname(cache), exist_ok=True)
                import pickle

                tmp = f"{cache}.{os.getpid()}.tmp"
                with open(tmp, "wb") as f:
                    pickle.dump((_BLOB_KZG.tau, _BLOB_KZG._lagrange), f)
                os.replace(tmp, cache)
        except Exception:  # cache is best-effort
            pass
    return _BLOB_KZG


def blob_commitment(blob_bytes: bytes) -> bytes:
    """48-byte blob commitment: a REAL BLS12-381 G1 KZG commitment over the
    Lagrange-basis SRS by DEFAULT (the consensus-critical value must have
    on-chain semantics). SPT_STUB_BLOB_KZG=1 opts into a
    hash stub with the same wire shape for hermetic speed-sensitive tests —
    never for anything consensus-facing."""
    if os.environ.get("SPT_STUB_BLOB_KZG"):
        h = hashlib.sha512(b"spt-blob-commit" + blob_bytes).digest()
        return h[:48]
    key = hashlib.sha256(blob_bytes).digest()
    got = _COMMIT_CACHE.get(key)
    if got is None:
        from ..curves.bls12_381 import g1_compress

        got = g1_compress(_kzg().commit(blob_to_coefficients(blob_bytes)))
        if len(_COMMIT_CACHE) > 64:
            _COMMIT_CACHE.clear()
        _COMMIT_CACHE[key] = got
    return got


def blob_versioned_hash(blob_bytes: bytes) -> bytes:
    """0x01 || sha256(commitment)[1:] (EIP-4844 versioned hash shape)."""
    c = blob_commitment(blob_bytes)
    return bytes([0x01]) + hashlib.sha256(c).digest()[1:]


def point_evaluation(blob_bytes: bytes, challenge_seed: bytes) -> tuple[int, int]:
    """(z, y): Fiat-Shamir challenge point and the barycentric evaluation —
    the `blob_data_proof` pair carried in BatchHeader (reference fixture
    batch_task_293205.json)."""
    z = int.from_bytes(keccak256(challenge_seed + blob_versioned_hash(blob_bytes)), "big") % BLS_MODULUS
    coeffs = blob_to_coefficients(blob_bytes)
    y = barycentric_evaluate(coeffs, z)
    return z, y


def point_evaluation_proof(blob_bytes: bytes, challenge_seed: bytes) -> dict:
    """Full EIP-4844 point-evaluation package: challenge z, claimed y, the
    48-byte blob commitment, and the 48-byte KZG opening proof W for
    (f(X) - y)/(X - z) — what the point-evaluation precompile takes as
    input (reference c-kzg compute_kzg_proof)."""
    from ..curves.bls12_381 import g1_compress

    z, y = point_evaluation(blob_bytes, challenge_seed)
    coeffs = blob_to_coefficients(blob_bytes)
    y2, w = _kzg().open_at(coeffs, z)
    assert y2 == y
    return {
        "z": z,
        "y": y,
        "commitment": blob_commitment(blob_bytes),
        "proof": g1_compress(w),
    }


def verify_blob_proof(commitment48: bytes, z: int, y: int, proof48: bytes) -> bool:
    """Pairing-check the point-evaluation proof: e(W, [tau - z]_2) ==
    e(C - [y]_1, G2) over real BLS12-381 (the precompile's verification
    equation; reference c-kzg verify_kzg_proof via blst)."""
    from ..curves.bls12_381 import g1_decompress

    return _kzg().verify(
        g1_decompress(commitment48), z, y, g1_decompress(proof48)
    )
