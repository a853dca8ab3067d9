"""Staged limb-major NTT over BN254 Fr: kernels K7 (radix 2) and K8 (radix 4).

The JAX package's alternative to the tiled four-step engine (ops/ntt_tile.py):
data lives limb-major (16, n); each radix-2 DIF level is one launch of K7
(`butterfly_t`), or each pair of levels one launch of K8 (`butterfly4_t`,
radix 4; an odd k ends with one radix-2 level); one gather by the bit
reversal restores natural order. The output equals EvaluationDomain(k).ntt
exactly.

The JAX stage cut u and w out of the (16, blocks, 2, half) view, gathered its
twiddles with jnp.take and stacked the outputs. The kernels here read both
from the stage's view and write back where they read: the stage is one
launch, x -> x'. Twiddles come from per-level tables (`level_tables`, built
once per domain): level s holds omega^(jj * 2^s) for jj < n >> (s+1), the
first period of the plane the JAX stage gathers, so a tile's twiddles are
runs of consecutive entries. The JAX package's `SPT_NTT_RADIX4` switch is the
constructor argument `radix`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..fields.limbs import FR_LIMB, LIMB_DTYPE, N_LIMBS, limbs_to_torch
from . import cuda_lib
from . import field_ops as fo
from .ntt_tile import _bitrev, _pow_table_mont

F = FR_LIMB
LG_TILE = 8  # K7/K8's default tile: 2^8 elements (csrc/ntt_fast.cu)
LG_TILE_MAX = 10


def _add(a, b):
    return fo._add_mod_plain(F, a, b)


def _dmul(a, b, t):
    """(a - b) * t."""
    return fo._mont_mul_plain(F, fo._sub_mod_plain(F, a, b), t)


def level_tables(tw):
    """(16, n/2) twiddles tw[j] = omega^j -> the (16, n) per-level tables:
    level s, omega^(jj * 2^s) for jj < n >> (s+1), at columns
    [n - (n >> s), n - (n >> (s+1))); column n - 1 is zero padding."""
    L, nh = tw.shape
    n, k = 2 * nh, (2 * nh).bit_length() - 1
    if L != N_LIMBS or n != 1 << k:
        raise ValueError(f"level_tables: bad shape {tuple(tw.shape)}")
    return torch.cat([tw[:, :: 1 << s] for s in range(k)] + [torch.zeros_like(tw[:, :1])], dim=1)


def _level(tw, s: int):
    """Level s's table (16, n >> (s+1)) of the per-level tables tw (16, n)."""
    n = tw.shape[1]
    return tw[:, n - (n >> s): n - (n >> (s + 1))]


def _check(x, tw, s: int, levels: int, name: str):
    """-> k for a (16, n) plane, n = 2^k, and (16, n) per-level tables."""
    L, n = x.shape
    k = n.bit_length() - 1
    if L != N_LIMBS or n != 1 << k or tw.shape != (N_LIMBS, n):
        raise ValueError(f"{name}: bad shapes {tuple(x.shape)}, {tuple(tw.shape)}")
    if not 0 <= s <= k - levels:
        raise ValueError(f"{name}: level {s} out of range for k={k}")
    return k


def _lg_tile(k: int, s: int, levels: int, lg_tile=None) -> int:
    """log2 of the elements per tile of a K7 (levels = 1) or K8 (levels =
    2) launch at level s of 2^k (csrc/ntt_fast.cu `kf_lg_tile`): the
    requested tile (default LG_TILE), at most the plane; a tile of R =
    2^levels runs needs at least 4 elements in each, and two buffers of
    2^LG_TILE_MAX elements fill an SM's shared memory."""
    lg = min(LG_TILE if lg_tile is None else lg_tile, k)
    if not 1 <= lg <= LG_TILE_MAX or (k - s > lg and lg - levels < 2):
        raise ValueError(f"tile 2^{lg_tile} out of range for level {s} of 2^{k}")
    return lg


def _tile_plan(k: int, s: int, lg_tile, levels: int):
    """The tiles of a K7 (levels = 1) or K8 (levels = 2) launch at level s
    of 2^k, as csrc/ntt_fast.cu computes them (`kf_geom`, `kf_pos`,
    `kf_swz`, `kf_stage`). Returns int64 arrays: pos (tiles, E), the plane
    position of each tile element e; slot (tiles, E), its slot in each limb
    plane of shared memory, e ^ kf_swz(e); ops (E / R, R), the tile
    elements of group m's R operands (the same in every tile); jp (tiles,
    E / R), group m's index into level s's table."""
    lg_r, lg_h = levels, k - s - levels
    lg_e = _lg_tile(k, s, levels, lg_tile)
    if lg_h + lg_r <= lg_e:  # whole butterfly blocks: one run
        lg_hl, lg_tpb = lg_h, 0
    else:  # 2^lg_tpb tiles per butterfly block, R runs each
        lg_hl, lg_tpb = lg_e - lg_r, lg_h + lg_r - lg_e
    t = np.arange(1 << (k - lg_e))[:, None]
    jp0 = (t & ((1 << lg_tpb) - 1)) << lg_hl
    base = (t >> lg_tpb) << (lg_h + lg_r) if lg_tpb else t << lg_e
    base = base + jp0
    e = np.arange(1 << lg_e)
    pos = base + ((e >> (lg_hl + lg_r)) << (lg_h + lg_r)) + (((e >> lg_hl) & ((1 << lg_r) - 1)) << lg_h) \
        + (e & ((1 << lg_hl) - 1))
    if lg_hl >= 5:
        swz = 0 * e
    elif lg_hl + lg_r <= 5:
        swz = ((e >> 5) & ((1 << lg_r) - 1)) << lg_hl
    else:
        swz = ((e >> (lg_hl + lg_r)) & ((32 >> lg_hl) - 1)) << lg_hl
    m = np.arange(1 << (lg_e - lg_r))
    e0 = ((m >> lg_hl) << (lg_hl + lg_r)) + (m & ((1 << lg_hl) - 1))
    ops = e0[:, None] + (np.arange(1 << lg_r) << lg_hl)
    jp = jp0 + (m & ((1 << lg_hl) - 1))
    return pos, np.broadcast_to(e ^ swz, pos.shape), ops, jp


def _launch(name: str, entry: str, x, tw, s: int, levels: int, lg_tile):
    """The K7/K8 launch on CUDA tensors; raises on what the kernel does not
    take (the tile's 16-byte accesses need 16-byte aligned planes)."""
    if not (x.is_cuda and tw.is_cuda) or x.dtype != LIMB_DTYPE or tw.dtype != LIMB_DTYPE:
        raise ValueError(f"{name} takes int32 CUDA tensors")
    k = _check(x, tw, s, levels, name)
    lg = _lg_tile(k, s, levels, lg_tile)
    x, tw = x.contiguous(), tw.contiguous()
    if x.data_ptr() % 16 or tw.data_ptr() % 16:
        raise ValueError(f"{name}: the plane and the tables must start on a 16-byte boundary")
    out = torch.empty_like(x)
    rc = getattr(cuda_lib.lib("ntt_fast"), entry)(
        out.data_ptr(), x.data_ptr(), tw.data_ptr(), k, s, lg, cuda_lib.field_params(F), cuda_lib.stream_ptr(out))
    cuda_lib.check(rc, name)
    return out


# --- K7: one radix-2 DIF level ---------------------------------------------------


def _butterfly_plain(x, tw, s: int):
    """Plain K7: level s of the staged DIF on x (16, n) with the per-level
    tables tw (16, n) -> (16, n)."""
    _check(x, tw, s, 1, "butterfly")
    L, n = x.shape
    half = n >> (s + 1)
    arr = x.T.reshape(1 << s, 2, half, L)
    u, w = arr[:, 0], arr[:, 1]
    t = _level(tw, s).T  # (half, 16)
    return torch.stack([_add(u, w), _dmul(u, w, t)], dim=1).reshape(n, L).T.contiguous()


def _butterfly_k7(x, tw, s: int, lg_tile=None):
    """K7 wrapper: tiles of 2^lg_tile elements, LG_TILE by default
    (csrc/ntt_fast.cu).

    Replaces ops/ntt_fast.py `_butterfly_kernel` (called through
    `butterfly_t`) of the JAX package. Launch count: `_butterfly_k7.launches`."""
    out = _launch("K7 butterfly", "spt_butterfly", x, tw, s, 1, lg_tile)
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
    """Plain K8: levels s and s + 1 of the staged DIF on x (16, n) with the
    per-level tables tw (16, n) -> (16, n)."""
    _check(x, tw, s, 2, "butterfly4")
    L, n = x.shape
    q = n >> (s + 2)
    v = x.T.reshape(1 << s, 4, q, L)
    lvl = _level(tw, s).T  # (2q, 16)
    ta, tb, tc = lvl[:q], lvl[q:], _level(tw, s + 1).T
    s0, d0 = _add(v[:, 0], v[:, 2]), _dmul(v[:, 0], v[:, 2], ta)
    s1, d1 = _add(v[:, 1], v[:, 3]), _dmul(v[:, 1], v[:, 3], tb)
    y = [_add(s0, s1), _dmul(s0, s1, tc), _add(d0, d1), _dmul(d0, d1, tc)]
    return torch.stack(y, dim=1).reshape(n, L).T.contiguous()


def _butterfly4_k8(x, tw, s: int, lg_tile=None):
    """K8 wrapper: tiles of 2^lg_tile elements, LG_TILE by default
    (csrc/ntt_fast.cu).

    Replaces ops/ntt_fast.py `_butterfly4_kernel` (called through
    `butterfly4_t`) of the JAX package. Launch count:
    `_butterfly4_k8.launches`."""
    out = _launch("K8 butterfly4", "spt_butterfly4", x, tw, s, 2, lg_tile)
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
        # per-level twiddle tables, limb-major (16, n), from omega^0 .. omega^(n/2 - 1)
        self.tw = level_tables(limbs_to_torch(_pow_table_mont(F, self.domain.omega, self.n // 2).T, self.device))
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
