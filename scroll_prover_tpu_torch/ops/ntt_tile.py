"""Tiled four-step NTT over BN254 Fr: kernel K2 and its host plan.

The plan is the JAX package's (ops/ntt_tile.py): a 2^k transform splits as
n = n1 * n2 with n2 = 2^KMAX; every length-2^k2 row NTT runs all its radix-2
DIF stages with Pease constant geometry (the JAX `_bntt`, here
`_bntt_plain`), so every stage pairs v[i] with v[i + m/2] and the output
stays bit-reversed; each level's inter-phase twiddle multiply uses the same
tables (`twmid`).

On the card a level is one K2 launch, a *pass* (`_ntt_pass`): it reads the
level's rows where they lie (row i1 of a group of n1 * n2 elements at stride
n1), runs their NTTs, multiplies by the twiddles and writes each output back
into the slot it read, which is the layout the next level reads, so no
transpose runs between levels. The first pass may scale its input by a
per-position table, the last writes natural order (the passes leave element
i at the k-bit reversal of i, so the kernel bit-reverses each position) and
applies n^-1 and a per-position table. Data
stays (C, n, 16) int32, 64 contiguous bytes per element, throughout. Unlike
the TPU version, the tiled domain works at any k >= 1 (no Mosaic lane
minimum), so the CPU tests run it at small k with the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..device import resolve_device
from ..fields.limbs import FR_LIMB, LIMB_DTYPE, N_LIMBS, LimbField, ints_to_limbs, limbs_to_torch
from . import cuda_lib
from . import field_ops as fo

F = FR_LIMB
KMAX = 8  # one pass runs NTTs of rows of length <= 2^KMAX


# --- K2: one pass of the four-step plan ---------------------------------------


def _bntt_plain(v, twpease, k: int):
    """The row core of plain K2: all k Pease DIF stages of a batched 2^k NTT.
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


def _ntt_pass_plain(x, tw, k: int, stride: int, twmid, pre, post, n_inv, last: bool, inplace: bool):
    """Plain K2, one pass: x (C, n, 16); row i1 < stride of each group of
    stride * 2^k elements is the 2^k elements at group + i1 + i * stride.
    Scales by `pre` (n, 16), runs the row NTTs, multiplies slot q of row i1
    by twmid[i1, q] ((stride, 2^k, 16)) and writes slot q back to
    group + i1 + q * stride; with `last` the element at position p goes to
    the bit reversal of p instead, times n_inv (16,) and `post` (n, 16).
    Returns a new tensor (`inplace` is the kernel's)."""
    del inplace
    C, n, L = x.shape
    m = 1 << k
    if pre is not None:
        x = fo._mont_mul_plain(F, x, pre)
    rows = x.reshape(C, n // (stride * m), m, stride, L).transpose(2, 3)  # (C, groups, i1, i, 16)
    y = _bntt_plain(rows.reshape(-1, m, L).permute(2, 0, 1), tw, k).permute(1, 2, 0)
    y = y.reshape(rows.shape)
    if twmid is not None:
        y = fo._mont_mul_plain(F, y, twmid)
    y = y.transpose(2, 3).reshape(C, n, L)
    if not last:
        return y.contiguous()
    out = y.index_select(1, torch.from_numpy(_bitrev(n.bit_length() - 1)).to(y.device))
    if n_inv is not None:
        out = fo._mont_mul_plain(F, out, n_inv)
    if post is not None:
        out = fo._mont_mul_plain(F, out, post)
    return out


def _ntt_pass_k2(x, tw, k: int, stride: int, twmid, pre, post, n_inv, last: bool, inplace: bool,
                 lg_tile: int = 0):
    """K2 wrapper: one pass on CUDA tensors, the arguments of
    `_ntt_pass_plain`; with `inplace` (not `last`) the output overwrites x.
    A block takes 2^lg_tile / 2^k rows of one column in shared memory as
    8 x 32-bit words (csrc/ntt.cu; lg_tile 0 is the default, the only tile
    the engine uses: 512 elements, 256 at k <= 4); a strided pass needs
    stride >= 2^lg_tile / 2^k, as every four-step level of the plan has at
    the default.

    Replaces ops/ntt_tile.py `_bntt_kernel` (called through `_bntt`) of the
    JAX package, with the four-step twiddle product of `_mul_kernel` (through
    `lm_mul`) folded in. Launch count: `_ntt_pass_k2.launches`."""
    tables = (tw, twmid, pre, post, n_inv)
    if not (x.is_cuda and all(t is None or t.is_cuda for t in tables)):
        raise ValueError("_ntt_pass_k2 takes CUDA tensors")
    if x.dim() != 3 or x.shape[2] != N_LIMBS or x.dtype != LIMB_DTYPE or not x.is_contiguous():
        raise ValueError(f"bad K2 input {tuple(x.shape)} {x.dtype}: contiguous (C, n, 16) int32 limbs")
    C, n, _ = x.shape
    m = 1 << k
    lg_n, lg_s = n.bit_length() - 1, stride.bit_length() - 1
    if (not 1 <= k <= KMAX or n != 1 << lg_n or stride != 1 << lg_s or n % (stride * m)
            or 1 < stride < min(1 << (lg_tile or (8 if k <= 4 else 9)), n) // m or (last and stride != 1)):
        raise ValueError(f"bad K2 pass: n={n}, k={k}, stride={stride}")
    want = {"tw": (tw, (k, N_LIMBS, m // 2)), "twmid": (twmid, (stride, m, N_LIMBS)),
            "pre": (pre, (n, N_LIMBS)), "post": (post, (n, N_LIMBS)), "n_inv": (n_inv, (N_LIMBS,))}
    for name, (t, shape) in want.items():
        if t is not None and (tuple(t.shape) != shape or t.dtype != torch.int32 or not t.is_contiguous()):
            raise ValueError(f"bad K2 table {name}: {tuple(t.shape)} {t.dtype}, want {shape} int32")
    if inplace and last:
        raise ValueError("a K2 pass that permutes cannot run in place")
    out = x if inplace else torch.empty_like(x)
    if C:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        rc = cuda_lib.lib("ntt").spt_ntt_pass(
            out.data_ptr(), x.data_ptr(), *(ptr(t) for t in tables), int(last), k, lg_s, lg_n, lg_tile, C,
            cuda_lib.field_params(F), cuda_lib.stream_ptr(out),
        )
        cuda_lib.check(rc, "K2 ntt_pass")
        _ntt_pass_k2.launches += 1
    return out


_ntt_pass_k2.launches = 0


def _ntt_pass(x, tw, k: int, stride: int, twmid, pre, post, n_inv, last: bool, inplace: bool):
    """One pass of the plan (see `_ntt_pass_plain`): K2 for CUDA tensors,
    its plain version for CPU tensors. Arguments are positional: chip_smoke
    hooks the wrapper with them."""
    if x.is_cuda:
        return _ntt_pass_k2(x, tw, k, stride, twmid, pre, post, n_inv, last, inplace)
    return _ntt_pass_plain(x, tw, k, stride, twmid, pre, post, n_inv, last, inplace)


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
    tensors in natural order, on `device`, one pass per level (K2 on the
    card). `scale=` takes an (n, 16) table that multiplies the input of a
    forward transform or the output of an inverse one, element by element."""

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
        n_inv = pow(self.n, p - 2, p)
        self._n_inv = limbs_to_torch(ints_to_limbs([n_inv * (1 << 256) % p])[0], self.device)

    def _build_tables(self, w: int):
        """Per-level (twpack, twmid) tables, the whole transform's level
        first, the leaf (twmid None) last (see JAX
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
        w_level^(n1_idx * bitrev(r2)), (n1, n2, 16) as the pass reads it.
        The power table is built on the device (an outer product of two
        sqrt-size host tables) and gathered: values identical to the JAX
        host build."""
        from .poly import powers_outer_mont

        n1, n2 = 1 << k1, 1 << k2
        twpack = _twpack(w_row, k2, self.device)
        pows = powers_outer_mont(F, w_level, n1 * n2, device=self.device)
        r2k = torch.from_numpy(_bitrev(k2)).to(self.device)
        e = (torch.arange(n1, device=self.device)[:, None] * r2k[None, :]) % (n1 * n2)
        return twpack, pows.index_select(0, e.reshape(-1)).reshape(n1, n2, N_LIMBS)

    def _transform(self, x, inverse: bool, scale):
        """x: (C, n, 16) -> (C, n, 16), one pass per level: the first reads
        x (and applies `scale` before a forward transform), the middle ones
        run in place, the last writes natural order (times n^-1 and `scale`
        after an inverse one)."""
        with trace.span("ntt", columns=x.shape[0]):
            levels = self._tables[inverse]
            y, kk = x.contiguous(), self.k
            for li, (twpack, twmid) in enumerate(levels):
                first, last = li == 0, li == len(levels) - 1
                krow = kk if twmid is None else KMAX
                y = _ntt_pass(
                    y, twpack, krow, 1 << (kk - krow), twmid,
                    scale if first and not inverse else None,
                    scale if last and inverse else None,
                    self._n_inv if last and inverse else None,
                    last,
                    not (first or last),
                )
                kk -= krow
            return y

    def ntt(self, x, scale=None):
        """(n, 16) Montgomery coefficients -> natural-order evaluations."""
        return self._transform(x[None], False, scale)[0]

    def intt(self, y, scale=None):
        """(n, 16) natural-order evaluations -> coefficients."""
        return self._transform(y[None], True, scale)[0]

    def ntt_batch(self, x, scale=None):
        """(C, n, 16) Montgomery coefficients -> natural-order evaluations."""
        return self._transform(x, False, scale)

    def intt_batch(self, y, scale=None):
        """(C, n, 16) natural-order evaluations -> coefficients."""
        return self._transform(y, True, scale)
