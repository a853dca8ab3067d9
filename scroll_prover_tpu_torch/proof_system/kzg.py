"""KZG polynomial commitment over BN254 (SRS, commit, open, verify).

An SRS holds monomial and Lagrange G1 bases plus G2 / s*G2. Commits of at
least DEVICE_MSM_THRESHOLD points run the bucket MSM (ops/msm_tile.py: K3/K4
on the card), over a process group's ranks once `set_commit_mesh` gives a
mesh; smaller ones the host Pippenger, as in the JAX package.
Verification is the host pairing (curves/pairing.py).

SRS generation from a seed tau is INSECURE (tau is derivable): tests and
benchmarks only. A deployment loads a ceremony file (`SRS.load`), or carries
the JAX package's device arrays across with `srs_from_numpy`.
"""
from __future__ import annotations

import hashlib
import os
import struct

import numpy as np
import torch

from ..curves import pairing as pr
from ..curves.bn254_curve import G1, G2, g1_generator, g2_generator
from ..device import resolve_device
from ..fields.bn254 import FQ_MOD, FR_MOD, FR_ROOT_OF_UNITY, FR_TWO_ADICITY
from ..fields.limbs import (
    FQ_LIMB, FR_LIMB, N_LIMBS, ints_to_limbs, limbs_from_torch, limbs_to_ints, limbs_to_torch,
)
from ..ops import ec
from ..ops import field_ops as fo
from ..ops import poly as poly_ops

_SRS_CACHE: dict = {}

# below this size a host Pippenger commit is cheaper than the device MSM;
# SPT_DEVICE_MSM_THRESHOLD, read at each commit (`_threshold`), moves it,
# as in the JAX package
DEVICE_MSM_THRESHOLD = 65536
# columns per batched device commit (one K3 launch) of up to COMMIT_POINTS
# points each; longer columns go fewer at a time, so that a launch's digits,
# signs and bucket runs stay the size of 8 columns of 2^22 (their 43 GiB at
# 8 columns of 2^23 did not fit beside a k = 23 prove)
COMMIT_GROUP = 8
COMMIT_POINTS = 1 << 22


def commit_group(n: int) -> int:
    """Columns of n points per batched device commit."""
    return max(1, COMMIT_GROUP * COMMIT_POINTS // max(n, COMMIT_POINTS))


class SRS:
    """Structured reference string for degrees up to 2^k, with device views
    on `device`. Host point lists decode lazily when the SRS was made on the
    device (generate_fast): the prove path touches only the device views."""

    def __init__(self, k: int, g1_powers, g1_lagrange, g2, s_g2, device=None):
        self.k = k
        self.n = 1 << k
        self.device = resolve_device(device)
        self._g1_powers = g1_powers  # list of affine int pairs (or None), len n
        self._g1_lagrange = g1_lagrange
        self.g2 = g2
        self.s_g2 = s_g2
        self._dev_powers = None
        self._dev_lagrange = None

    @staticmethod
    def _decode_host(dev) -> list:
        n = dev.shape[0]
        ints = limbs_to_ints(limbs_from_torch(fo.from_mont(FQ_LIMB, dev.reshape(2 * n, N_LIMBS))))
        return [None if x == y == 0 else (x, y) for x, y in zip(ints[0::2], ints[1::2])]

    @property
    def g1_powers(self) -> list:
        if self._g1_powers is None:
            self._g1_powers = self._decode_host(self._dev_powers)
        return self._g1_powers

    @property
    def g1_lagrange(self) -> list:
        if self._g1_lagrange is None:
            self._g1_lagrange = self._decode_host(self._dev_lagrange)
        return self._g1_lagrange

    # -- generation / io --------------------------------------------------

    @classmethod
    def generate(cls, k: int, seed: bytes = b"scroll-prover-tpu-test-srs", device=None):
        """Deterministic toy SRS from a seed, on the host (INSECURE)."""
        dev = resolve_device(device)
        key = ("host", k, seed, str(dev))
        if key in _SRS_CACHE:
            return _SRS_CACHE[key]
        tau = int.from_bytes(hashlib.sha512(seed).digest(), "little") % FR_MOD
        n = 1 << k
        powers_scalars = [1] * n
        for i in range(1, n):
            powers_scalars[i] = powers_scalars[i - 1] * tau % FR_MOD
        g1_powers = _batch_base_mul(powers_scalars)
        # L_i(tau) = omega^i (tau^n - 1) / (n (tau - omega^i))
        omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - k), FR_MOD)
        vanish = (pow(tau, n, FR_MOD) - 1) % FR_MOD
        ninv = pow(n, -1, FR_MOD)
        lag_scalars = []
        wi = 1
        for _ in range(n):
            denom = (tau - wi) % FR_MOD
            lag_scalars.append(
                wi * vanish % FR_MOD * ninv % FR_MOD * pow(denom, -1, FR_MOD) % FR_MOD
            )
            wi = wi * omega % FR_MOD
        g1_lagrange = _batch_base_mul(lag_scalars)
        h = g2_generator()
        srs = cls(k, g1_powers, g1_lagrange, h, G2.mul(h, tau), dev)
        _SRS_CACHE[key] = srs
        return srs

    @classmethod
    def generate_fast(cls, k: int, seed: bytes = b"scroll-prover-tpu-test-srs", device=None):
        """Device twin of generate(): tau powers, Lagrange scalars, the
        fixed-base multiplications (K5) and the affine normalization all run
        on `device`. Bit-identical points to generate()."""
        from ..ops.fixed_base import fixed_base_mul_dev

        dev = resolve_device(device)
        key = ("fast", k, seed, str(dev))
        if key in _SRS_CACHE:
            return _SRS_CACHE[key]
        tau = int.from_bytes(hashlib.sha512(seed).digest(), "little") % FR_MOD
        n = 1 << k
        F = FR_LIMB
        tau_m = _mont_fr(tau, dev)
        pow_m = poly_ops.powers_mont(F, tau_m, n)  # tau^i
        omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - k), FR_MOD)
        om_m = poly_ops.powers_mont(F, _mont_fr(omega, dev), n)
        denom = fo.sub_mod(F, tau_m.expand(n, N_LIMBS), om_m)
        vanish_ninv = (pow(tau, n, FR_MOD) - 1) % FR_MOD * pow(n, -1, FR_MOD) % FR_MOD
        lag_m = fo.mont_mul(
            F, fo.mont_mul(F, om_m, fo.batch_inv_mont(F, denom)), _mont_fr(vanish_ninv, dev)
        )
        g = g1_generator()
        dev_powers = fixed_base_mul_dev(g, fo.from_mont(F, pow_m))
        dev_lagrange = fixed_base_mul_dev(g, fo.from_mont(F, lag_m))
        h = g2_generator()
        srs = cls(k, None, None, h, G2.mul(h, tau), dev)
        srs._dev_powers = dev_powers
        srs._dev_lagrange = dev_lagrange
        _SRS_CACHE[key] = srs
        return srs

    def save(self, path: str):
        with open(path, "wb") as fh:
            fh.write(struct.pack("<I", self.k))
            for plist in (self.g1_powers, self.g1_lagrange):
                for pt in plist:
                    fh.write(_enc_g1(pt))
            for pt in (self.g2, self.s_g2):
                fh.write(_enc_g2(pt))

    @classmethod
    def load(cls, path: str, device=None) -> "SRS":
        """Read a file written by `save` here or by the JAX package's
        SRS.save (same layout, byte for byte)."""
        with open(path, "rb") as fh:
            (k,) = struct.unpack("<I", fh.read(4))
            n = 1 << k
            powers = [_dec_g1(fh.read(64)) for _ in range(n)]
            lagrange = [_dec_g1(fh.read(64)) for _ in range(n)]
            g2 = _dec_g2(fh.read(128))
            s_g2 = _dec_g2(fh.read(128))
        return cls(k, powers, lagrange, g2, s_g2, device)

    def downsize(self, k: int) -> "SRS":
        """The SRS of degree k <= self.k on the same device: g2 and s_g2
        shared, the monomial basis a prefix of this one, the Lagrange basis
        rebuilt from that prefix by the group iNTT (ops/group_ntt.py) into
        the device view. Host lists stay lazy: an SRS made on the device is
        not decoded, and a host one gives its prefix."""
        assert k <= self.k
        if k == self.k:
            return self
        from ..ops.group_ntt import group_intt_dev

        n = 1 << k
        small = SRS(k, None if self._g1_powers is None else self._g1_powers[:n], None, self.g2, self.s_g2,
                    self.device)
        if self._dev_powers is not None:
            small._dev_powers = self._dev_powers[:n]
        small._dev_lagrange = group_intt_dev(small.dev_powers(), k)
        return small

    # -- device views ------------------------------------------------------

    def dev_powers(self):
        """(n, 2, 16) int32 Montgomery affine monomial basis on self.device."""
        if self._dev_powers is None:
            self._dev_powers = limbs_to_torch(ec.encode_affine_mont(self.g1_powers), self.device)
        return self._dev_powers

    def dev_lagrange(self):
        if self._dev_lagrange is None:
            self._dev_lagrange = limbs_to_torch(ec.encode_affine_mont(self.g1_lagrange), self.device)
        return self._dev_lagrange


def srs_from_numpy(k: int, powers, lagrange, g2, s_g2, device=None) -> SRS:
    """Build the port's SRS from the JAX package's arrays: `powers` and
    `lagrange` are (n, 2, 16) uint32 affine-Montgomery limbs
    (ec.encode_affine_mont output, or np.asarray(srs.dev_powers())); g2 and
    s_g2 are the G2 affine Fq2 pairs."""
    n = 1 << k
    powers = np.asarray(powers, dtype=np.uint32)
    lagrange = np.asarray(lagrange, dtype=np.uint32)
    if powers.shape != (n, 2, N_LIMBS) or lagrange.shape != (n, 2, N_LIMBS):
        raise ValueError(f"expected ({n}, 2, {N_LIMBS}) point arrays")
    srs = SRS(k, None, None, g2, s_g2, device)
    srs._dev_powers = limbs_to_torch(powers, srs.device)
    srs._dev_lagrange = limbs_to_torch(lagrange, srs.device)
    return srs


def _mont_fr(v: int, device) -> torch.Tensor:
    return limbs_to_torch(ints_to_limbs([v % FR_MOD * (1 << 256) % FR_MOD])[0], device)


def _enc_g1(pt) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return pt[0].to_bytes(32, "little") + pt[1].to_bytes(32, "little")


def _dec_g1(b: bytes):
    x = int.from_bytes(b[:32], "little")
    y = int.from_bytes(b[32:64], "little")
    return None if x == y == 0 else (x, y)


def _enc_g2(pt) -> bytes:
    (x0, x1), (y0, y1) = pt
    return b"".join(v.to_bytes(32, "little") for v in (x0, x1, y0, y1))


def _dec_g2(b: bytes):
    v = [int.from_bytes(b[32 * i : 32 * (i + 1)], "little") for i in range(4)]
    return ((v[0], v[1]), (v[2], v[3]))


def _batch_base_mul(scalars):
    """[s*G for s in scalars] via a fixed-base window table (host, Jacobian
    accumulation with one batched normalization at the end)."""
    from ..curves.bn254_curve import jac_add_affine, jac_double, jac_from_affine, jac_to_affine

    c = 8
    windows = 256 // c
    table = []  # table[w][d] = d * 2^(cw) * G, affine
    base = jac_from_affine(g1_generator())
    for _w in range(windows):
        row_j = []
        acc = None
        base_aff = jac_to_affine(base)
        for _d in range(1, 1 << c):
            acc = jac_add_affine(acc, base_aff)
            row_j.append(acc)
        table.append([None] + _batch_to_affine(row_j))
        for _ in range(c):
            base = jac_double(base)
    out_j = []
    for s in scalars:
        acc = None
        s = int(s) % FR_MOD
        for w in range(windows):
            d = (s >> (c * w)) & ((1 << c) - 1)
            if d:
                acc = jac_add_affine(acc, table[w][d])
        out_j.append(acc)
    return _batch_to_affine(out_j)


def _batch_to_affine(jacs):
    """Batch-normalize Jacobian points (one field inversion total)."""
    P = FQ_MOD
    idx = [i for i, j in enumerate(jacs) if j is not None and j[2] % P != 0]
    zs = [jacs[i][2] for i in idx]
    out = [None] * len(jacs)
    if not zs:
        return out
    prefix = [1]
    for z in zs:
        prefix.append(prefix[-1] * z % P)
    inv = pow(prefix[-1], P - 2, P)
    invs = [0] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        invs[i] = inv * prefix[i] % P
        inv = inv * zs[i] % P
    for k, i in enumerate(idx):
        x, y, _z = jacs[i]
        zi = invs[k]
        z2 = zi * zi % P
        out[i] = (x * z2 % P, y * z2 % P * zi % P)
    return out


# --- commit / open -------------------------------------------------------------


# the mesh a commit of at least _threshold() points fans out over
# (parallel/msm_sharded.py); None commits on this process's device alone.
# Bit-identical either way: the point sum is exact at any world size
_COMMIT_MESH = None


def set_commit_mesh(mesh) -> None:
    global _COMMIT_MESH
    _COMMIT_MESH = mesh


def _threshold() -> int:
    return int(os.environ.get("SPT_DEVICE_MSM_THRESHOLD", str(DEVICE_MSM_THRESHOLD)))


def _commit_sharded(srs: SRS, coeffs_mont, basis: str):
    """One commit over _COMMIT_MESH: each rank's slice of the points through
    the v2 MSM (K3/K4 on the card, their plain versions on the CPU, where
    the JAX package takes `msm_sharded` because its kernels do not run
    there), the partial points summed in rank order."""
    from ..parallel.msm_sharded import msm_tile_sharded

    n = coeffs_mont.shape[0]
    base = srs.dev_powers() if basis == "monomial" else srs.dev_lagrange()
    return msm_tile_sharded(_COMMIT_MESH, base[:n], fo.from_mont(FR_LIMB, coeffs_mont))


def kzg_commit(srs: SRS, coeffs_mont, basis: str = "monomial"):
    """Commit to (n, 16) Montgomery coefficients (or Lagrange evaluations).
    Returns a host affine point (or None)."""
    n = coeffs_mont.shape[0]
    assert n <= srs.n
    if _COMMIT_MESH is not None and n >= _threshold():
        return _commit_sharded(srs, coeffs_mont, basis)
    scalars = fo.from_mont(FR_LIMB, coeffs_mont)
    if n < _threshold():
        from ..curves.bn254_curve import host_msm_jac

        host_pts = srs.g1_powers if basis == "monomial" else srs.g1_lagrange
        return host_msm_jac(host_pts[:n], limbs_to_ints(limbs_from_torch(scalars)))
    from ..ops.msm_tile import msm_v2_host

    base = srs.dev_powers() if basis == "monomial" else srs.dev_lagrange()
    return msm_v2_host(base[:n], scalars)


def kzg_commit_batch(srs: SRS, coeffs_list, basis: str = "monomial"):
    """Commit to several columns over the same basis: device-size columns go
    commit_group(n) at a time through one batched MSM (one K3 launch each);
    with a commit mesh set, column by column over the mesh."""
    coeffs_list = list(coeffs_list)
    if not coeffs_list:
        return []
    n_max = max(c.shape[0] for c in coeffs_list)
    if n_max < _threshold() or _COMMIT_MESH is not None:
        return [kzg_commit(srs, c, basis) for c in coeffs_list]
    from ..ops.msm_tile import msm_v2_host_batch

    base = srs.dev_powers() if basis == "monomial" else srs.dev_lagrange()
    out = []
    group = commit_group(n_max)
    for i in range(0, len(coeffs_list), group):
        grp = coeffs_list[i : i + group]
        out.extend(msm_v2_host_batch(base[:n_max], [fo.from_mont(FR_LIMB, c) for c in grp]))
    return out


def kzg_open(srs: SRS, coeffs_mont, z: int):
    """Open f at z: returns (f(z) as int, witness commitment W)."""
    zm = _mont_fr(z, coeffs_mont.device)
    ev = poly_ops.eval_poly_mont(FR_LIMB, coeffs_mont, zm)
    q = poly_ops.kzg_quotient_mont(FR_LIMB, coeffs_mont, zm)
    w = kzg_commit(srs, q)
    return FR_LIMB.decode(limbs_from_torch(ev)[None, :])[0], w


def verify_single_open(srs: SRS, commitment, z: int, value: int, witness) -> bool:
    """e(C - v*G + z*W, G2) == e(W, s*G2)."""
    g = g1_generator()
    lhs = G1.add(G1.add(commitment, G1.neg(G1.mul(g, value))), G1.mul(witness, z))
    return pr.pairing_check([(lhs, srs.g2), (G1.neg(witness), srs.s_g2)])
