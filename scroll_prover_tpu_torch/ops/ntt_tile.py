"""Tiled four-step NTT over BN254 Fr: kernels K1 and K2 and their host plan.

The plan is the JAX package's (ops/ntt_tile.py): a 2^k transform splits as
n = n1 * n2 with n2 = 2^KMAX rows; every length-2^k2 row NTT runs all its
radix-2 DIF stages inside one kernel (K2, `_bntt`), with Pease constant
geometry, so every stage pairs v[i] with v[i + m/2] and the output stays
digit-reversed; each level's inter-phase twiddle multiply is the flat
limb-major Montgomery product (K1, `lm_mul`); one gather by the composed
permutation (`_stored_perm`) restores natural order at the end.

Layout: limb-major (16, B, m) int32 planes inside the engine, (n, 16) at the
public functions. Unlike the TPU version, the tiled domain works at any
k >= 1 (no Mosaic lane minimum), so the CPU tests run it at small k with the
plain versions of K1 and K2.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..fields.limbs import FR_LIMB, LIMB_DTYPE, N_LIMBS, LimbField, ints_to_limbs, limbs_to_torch
from . import cuda_lib
from . import field_ops as fo

F = FR_LIMB
KMAX = 8  # K2 handles NTTs of length <= 2^KMAX in one block


# --- K1: flat limb-major Montgomery product -----------------------------------


def lm_mul(a, b):
    """(16, N) x (16, N) -> (16, N) limb-major Montgomery product over Fr.
    CUDA tensors go through K1 (field_ops.mont_mul_k1), CPU tensors through
    its plain version."""
    if a.is_cuda or b.is_cuda:
        return fo.mont_mul_k1(F, a, b, limb_axis=0)
    return _lm_mul_plain(a, b)


def _lm_mul_plain(a, b):
    return fo._mont_mul_plain(F, a.T, b.T).T.contiguous()


# --- K2: batched in-block NTT -------------------------------------------------


def _bntt_plain(v, twpease, k: int):
    """Plain K2: all k Pease DIF stages of a batched 2^k NTT.
    v: (16, B, m) -> (16, B, m) bit-reversed; twpease: (k, 16, m/2)."""
    L, B, m = v.shape
    h = m // 2
    x = v.permute(1, 2, 0)  # (B, m, 16)
    for s in range(k):
        tw = twpease[s].T  # (h, 16)
        u, w = x[:, :h], x[:, h:]
        s_ = fo._add_mod_plain(F, u, w)
        d = fo._mont_mul_plain(F, fo._sub_mod_plain(F, u, w), tw)
        x = torch.stack([s_, d], dim=2).reshape(B, m, L)
    return x.permute(2, 0, 1).contiguous()


def _bntt_k2(v, twpease, k: int):
    """K2 wrapper: one CUDA block per row of m = 2^k <= 256 elements, held
    in shared memory as 8 x 32-bit words, the k stages looped inside.

    Replaces ops/ntt_tile.py `_bntt_kernel` (called through `_bntt`) of the JAX
    package. Launch count: `_bntt_k2.launches`."""
    L, B, m = v.shape
    if not (v.is_cuda and twpease.is_cuda):
        raise ValueError("_bntt_k2 takes CUDA tensors")
    if L != N_LIMBS or m != 1 << k or not 1 <= k <= KMAX:
        raise ValueError(f"bad K2 shape {tuple(v.shape)} for k={k}")
    if twpease.shape != (k, N_LIMBS, m // 2) or v.dtype != LIMB_DTYPE:
        raise ValueError("bad K2 twiddle table")
    v = v.contiguous()
    tw = twpease.contiguous()
    out = torch.empty_like(v)
    if B:
        rc = cuda_lib.lib("ntt").spt_bntt(
            out.data_ptr(), v.data_ptr(), tw.data_ptr(), k, B,
            cuda_lib.field_params(F), cuda_lib.stream_ptr(out),
        )
        cuda_lib.check(rc, "K2 bntt")
        _bntt_k2.launches += 1
    return out


_bntt_k2.launches = 0


def _bntt(v, twpease, k: int):
    """v: (16, B, m) -> (16, B, m), NTT along the last axis, bit-reversed."""
    if v.is_cuda:
        return _bntt_k2(v, twpease, k)
    return _bntt_plain(v, twpease, k)


# --- host-side tables and plan ----------------------------------------------


def _bitrev(k: int) -> np.ndarray:
    n = 1 << k
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for b in range(k):
        out |= ((idx >> b) & 1) << (k - 1 - b)
    return out


def _stored_perm(k: int) -> np.ndarray:
    """Natural index -> stored index after the digit-reversed recursion."""
    if k <= KMAX:
        return _bitrev(k)
    k2 = KMAX
    k1 = k - k2
    n2 = 1 << k2
    sub = _stored_perm(k1)
    r2 = _bitrev(k2)
    kk = np.arange(1 << k, dtype=np.int64)
    hi, lo = kk >> k2, kk & (n2 - 1)
    return sub[hi] * n2 + r2[lo]


def _pow_table_mont(f: LimbField, w: int, n: int) -> np.ndarray:
    """(n, 16) Montgomery limb table of w^0..w^(n-1) (host, small n)."""
    p = f.modulus
    acc, vals = (1 << 256) % p, []
    wm = w % p
    for _ in range(n):
        vals.append(acc)
        acc = acc * wm % p
    return ints_to_limbs(vals)


def _twpack(w: int, k: int, device) -> torch.Tensor:
    """(k, 16, 2^(k-1)) Pease constant-geometry stage twiddles for root w:
    stage s storage position q (< m/2) holds natural DIF index
    nu = ror_k(q, s), whose twiddle is W^((nu mod 2^(k-s)) << s)."""
    m = 1 << k
    h = max(m // 2, 1)
    pows = _pow_table_mont(F, w, h)
    pk = np.zeros((max(k, 1), N_LIMBS, h), dtype=np.uint32)
    q = np.arange(h, dtype=np.int64)
    for s in range(k):
        nu = (q >> s) | ((q & ((1 << s) - 1)) << (k - s))
        exp = ((nu & ((1 << (k - s)) - 1)) << s) & (h - 1)
        pk[s] = pows[exp].T
    return limbs_to_torch(pk, device)


class TiledDomain:
    """2^k NTT/INTT via the four-step plan: ntt/intt on (n, 16) Montgomery
    tensors in natural order, on `device`."""

    def __init__(self, k: int, device=None):
        assert k >= 1
        self.device = resolve_device(device)
        self.k = k
        self.n = 1 << k
        p = F.modulus
        from .ntt import EvaluationDomain

        omega = EvaluationDomain(k).omega
        self._tables = {
            inv: self._build_tables(pow(omega, p - 2, p) if inv else omega)
            for inv in (False, True)
        }
        self._perm = torch.from_numpy(_stored_perm(k)).to(self.device)
        n_inv = pow(self.n, p - 2, p)
        self._n_inv = limbs_to_torch(ints_to_limbs([n_inv * (1 << 256) % p])[0], self.device)

    def _build_tables(self, w: int):
        """Per-level (twpack, twmid) tables, leaves first (see JAX
        TiledDomain._build_tables)."""
        p = F.modulus
        levels = []
        kk = self.k
        w_level = w
        while kk > KMAX:
            k1, k2 = kk - KMAX, KMAX
            n1, n2 = 1 << k1, 1 << k2
            levels.append(self._level_tables(pow(w_level, n1, p), k2, w_level, k1))
            kk = k1
            w_level = pow(w_level, n2, p)
        levels.append((_twpack(w_level, kk, self.device), None))
        return levels

    def _level_tables(self, w_row: int, k2: int, w_level: int, k1: int):
        """twpack for the length-n2 rows and twmid[n1_idx, r2] =
        w_level^(n1_idx * bitrev(r2)), limb-major (16, n1, n2). The power
        table is built on the device (an outer product of two sqrt-size
        host tables) and gathered: values identical to the JAX host build."""
        from .poly import powers_outer_mont

        n1, n2 = 1 << k1, 1 << k2
        twpack = _twpack(w_row, k2, self.device)
        pows = powers_outer_mont(F, w_level, n1 * n2, device=self.device)
        r2k = torch.from_numpy(_bitrev(k2)).to(self.device)
        e = (torch.arange(n1, device=self.device)[:, None] * r2k[None, :]) % (n1 * n2)
        twmid = pows.index_select(0, e.reshape(-1)).T.reshape(N_LIMBS, n1, n2)
        return twpack, twmid.contiguous()

    def _run(self, v, k: int, levels, li: int):
        """v: (16, B, 2^k) -> digit-reversed NTT along the last axis."""
        twpack, twmid = levels[li]
        if k <= KMAX:
            return _bntt(v, twpack, k)
        L, B, _ = v.shape
        k1, k2 = k - KMAX, KMAX
        n1, n2 = 1 << k1, 1 << k2
        a = v.reshape(L, B, n2, n1).transpose(2, 3).contiguous()  # (L, B, n1, n2)
        a = _bntt(a.reshape(L, B * n1, n2), twpack, k2)
        tw = twmid.reshape(L, 1, n1 * n2).expand(L, B, n1 * n2).reshape(L, B * n1 * n2)
        a = lm_mul(a.reshape(L, B * n1 * n2), tw)
        a = a.reshape(L, B, n1, n2).transpose(2, 3).contiguous()  # (L, B, r2, n1)
        a = self._run(a.reshape(L, B * n2, n1), k1, levels, li + 1)
        a = a.reshape(L, B, n2, n1).transpose(2, 3).contiguous()
        return a.reshape(L, B, n1 * n2)

    def _transform(self, x, inverse: bool):
        out = self._run(_to_lm(x), self.k, self._tables[inverse], 0)
        return _finish(out, self._perm, self._n_inv if inverse else None)

    def ntt(self, x):
        """(n, 16) Montgomery coefficients -> natural-order evaluations."""
        return self._transform(x, False)

    def intt(self, y):
        """(n, 16) natural-order evaluations -> coefficients."""
        return self._transform(y, True)

    def _transform_batch(self, x, inverse: bool):
        out = self._run(_to_lm_batch(x), self.k, self._tables[inverse], 0)
        return _finish_batch(out, self._perm, self._n_inv if inverse else None)

    def ntt_batch(self, x):
        """(C, n, 16) Montgomery coefficients -> natural-order evaluations."""
        return self._transform_batch(x, False)

    def intt_batch(self, y):
        """(C, n, 16) natural-order evaluations -> coefficients."""
        return self._transform_batch(y, True)


def _to_lm(x):
    return x.T.contiguous()[:, None, :]  # (16, 1, n)


def _to_lm_batch(x):
    return x.permute(2, 0, 1).contiguous()  # (16, C, n)


def _finish_batch(out, perm, n_inv):
    """(16, C, n) stored order -> (C, n, 16) natural order, optionally
    scaled by n^-1 (K1 on the card)."""
    y = out.index_select(2, perm).permute(1, 2, 0)
    if n_inv is not None:
        return fo.mont_mul(F, y, n_inv)
    return y.contiguous()


def _finish(out, perm, n_inv):
    return _finish_batch(out, perm, n_inv)[0]
