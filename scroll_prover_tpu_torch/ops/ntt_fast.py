"""Staged limb-major NTT over BN254 Fr: kernels K7 (radix 2) and K8 (radix 4).

The JAX package's alternative to the tiled four-step engine (ops/ntt_tile.py):
data lives limb-major (16, n); each radix-2 DIF level is one launch of K7
(`butterfly_t`), or each pair of levels one launch of K8 (`butterfly4_t`,
radix 4; an odd k ends with one radix-2 level); one gather by the bit
reversal restores natural order. The output equals EvaluationDomain(k).ntt
exactly.

The JAX stage cut u and w out of the (16, blocks, 2, half) view, gathered its
twiddles with jnp.take and stacked the outputs. The kernels here read both
from the stage's view by stride and the twiddle (j << s) & (n/2 - 1) from
the one (16, n/2) table: the stage is one launch, x -> x'. The JAX
package's `SPT_NTT_RADIX4` switch is the constructor argument `radix`.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..fields.limbs import FR_LIMB, LIMB_DTYPE, N_LIMBS, limbs_to_torch
from . import cuda_lib
from . import field_ops as fo
from .ntt_tile import _bitrev, _pow_table_mont

F = FR_LIMB


def _add(a, b):
    return fo._add_mod_plain(F, a, b)


def _dmul(a, b, t):
    """(a - b) * t."""
    return fo._mont_mul_plain(F, fo._sub_mod_plain(F, a, b), t)


def _check(x, tw, s: int, levels: int, name: str):
    """-> k for a (16, n) plane, n = 2^k, and a (16, n/2) twiddle table."""
    L, n = x.shape
    k = n.bit_length() - 1
    if L != N_LIMBS or n != 1 << k or tw.shape != (N_LIMBS, n // 2):
        raise ValueError(f"{name}: bad shapes {tuple(x.shape)}, {tuple(tw.shape)}")
    if not 0 <= s <= k - levels:
        raise ValueError(f"{name}: level {s} out of range for k={k}")
    return k


# --- K7: one radix-2 DIF level ---------------------------------------------------


def _butterfly_plain(x, tw, s: int):
    """Plain K7: level s of the staged DIF on x (16, n) with twiddles
    tw (16, n/2) -> (16, n)."""
    _check(x, tw, s, 1, "butterfly")
    L, n = x.shape
    nh, half = n // 2, n >> (s + 1)
    arr = x.T.reshape(1 << s, 2, half, L)
    u, w = arr[:, 0], arr[:, 1]
    jj = torch.arange(half, device=x.device)
    t = tw.T[(jj << s) & (nh - 1)]  # (half, 16)
    return torch.stack([_add(u, w), _dmul(u, w, t)], dim=1).reshape(n, L).T.contiguous()


def _butterfly_k7(x, tw, s: int):
    """K7 wrapper: one CUDA thread per radix-2 butterfly.

    Replaces ops/ntt_fast.py `_butterfly_kernel` (called through
    `butterfly_t`) of the JAX package. Launch count: `_butterfly_k7.launches`."""
    if not (x.is_cuda and tw.is_cuda) or x.dtype != LIMB_DTYPE or tw.dtype != LIMB_DTYPE:
        raise ValueError("_butterfly_k7 takes int32 CUDA tensors")
    k = _check(x, tw, s, 1, "K7")
    x, tw = x.contiguous(), tw.contiguous()
    out = torch.empty_like(x)
    rc = cuda_lib.lib("ntt_fast").spt_butterfly(
        out.data_ptr(), x.data_ptr(), tw.data_ptr(), k, s,
        cuda_lib.field_params(F), cuda_lib.stream_ptr(out),
    )
    cuda_lib.check(rc, "K7 butterfly")
    _butterfly_k7.launches += 1
    return out


_butterfly_k7.launches = 0


def butterfly_t(x, tw, s: int):
    """Level s of the staged DIF on limb-major x (16, n) -> (16, n)."""
    if x.is_cuda:
        return _butterfly_k7(x, tw, s)
    return _butterfly_plain(x, tw, s)


# --- K8: two fused DIF levels (radix 4) ----------------------------------------


def _butterfly4_plain(x, tw, s: int):
    """Plain K8: levels s and s + 1 of the staged DIF on x (16, n) -> (16, n)."""
    _check(x, tw, s, 2, "butterfly4")
    L, n = x.shape
    nh, q = n // 2, n >> (s + 2)
    v = x.T.reshape(1 << s, 4, q, L)
    jp = torch.arange(q, device=x.device)
    twr = tw.T
    ta, tb, tc = twr[(jp << s) & (nh - 1)], twr[((jp + q) << s) & (nh - 1)], twr[(jp << (s + 1)) & (nh - 1)]
    s0, d0 = _add(v[:, 0], v[:, 2]), _dmul(v[:, 0], v[:, 2], ta)
    s1, d1 = _add(v[:, 1], v[:, 3]), _dmul(v[:, 1], v[:, 3], tb)
    y = [_add(s0, s1), _dmul(s0, s1, tc), _add(d0, d1), _dmul(d0, d1, tc)]
    return torch.stack(y, dim=1).reshape(n, L).T.contiguous()


def _butterfly4_k8(x, tw, s: int):
    """K8 wrapper: one CUDA thread per radix-4 butterfly.

    Replaces ops/ntt_fast.py `_butterfly4_kernel` (called through
    `butterfly4_t`) of the JAX package. Launch count:
    `_butterfly4_k8.launches`."""
    if not (x.is_cuda and tw.is_cuda) or x.dtype != LIMB_DTYPE or tw.dtype != LIMB_DTYPE:
        raise ValueError("_butterfly4_k8 takes int32 CUDA tensors")
    k = _check(x, tw, s, 2, "K8")
    x, tw = x.contiguous(), tw.contiguous()
    out = torch.empty_like(x)
    rc = cuda_lib.lib("ntt_fast").spt_butterfly4(
        out.data_ptr(), x.data_ptr(), tw.data_ptr(), k, s,
        cuda_lib.field_params(F), cuda_lib.stream_ptr(out),
    )
    cuda_lib.check(rc, "K8 butterfly4")
    _butterfly4_k8.launches += 1
    return out


_butterfly4_k8.launches = 0


def butterfly4_t(x, tw, s: int):
    """Levels s and s + 1 of the staged DIF on x (16, n) -> (16, n)."""
    if x.is_cuda:
        return _butterfly4_k8(x, tw, s)
    return _butterfly4_plain(x, tw, s)


class FastDomain:
    """Staged 2^k NTT on `device`: k radix-2 levels (radix=2), or k // 2
    radix-4 level pairs and, for odd k, one last radix-2 level (radix=4)."""

    def __init__(self, k: int, radix: int = 2, device=None):
        if radix not in (2, 4):
            raise ValueError("radix must be 2 or 4")
        if k < 1:
            raise ValueError("FastDomain needs k >= 1")
        from .ntt import EvaluationDomain

        self.device = resolve_device(device)
        self.k, self.n, self.radix = k, 1 << k, radix
        self.domain = EvaluationDomain(k)
        # twiddles omega^0 .. omega^(n/2 - 1), limb-major (16, n/2)
        self.tw = limbs_to_torch(_pow_table_mont(F, self.domain.omega, self.n // 2).T, self.device)
        self.br = torch.from_numpy(_bitrev(k)).to(self.device)

    def ntt(self, x):
        """(n, 16) Montgomery coefficients -> natural-order evaluations."""
        if x.shape != (self.n, N_LIMBS):
            raise ValueError(f"expected ({self.n}, {N_LIMBS}), got {tuple(x.shape)}")
        y = x.T.contiguous()
        s = 0
        while s < self.k:
            if self.radix == 4 and s + 1 < self.k:
                y = butterfly4_t(y, self.tw, s)
                s += 2
            else:
                y = butterfly_t(y, self.tw, s)
                s += 1
        return y.index_select(1, self.br).T.contiguous()
