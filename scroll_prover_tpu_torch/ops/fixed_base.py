"""Fixed-base scalar multiplication s_i * G for a vector of scalars: kernel K5.

The host precomputes table[w][d] = d * 2^(4w) * G (64 windows of 4 bits,
affine, Montgomery-encoded). K5 walks the 64 windows per scalar, one complete
mixed add per non-zero digit; a zero digit keeps the accumulator, so a zero
scalar stays the projective identity. `_normalize` then converts to affine
with one batched inversion; z = 0 maps to (0, 0), the identity encoding of
ec.encode_affine_mont. Used to synthesize the SRS at 2^20
(kzg.SRS.generate_fast), where the host window walk takes hours.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields.limbs import FQ_LIMB, LIMB_DTYPE, N_LIMBS, limbs_to_torch
from . import cuda_lib
from . import ec
from . import field_ops as fo

C_BITS = 4  # window width: 64 windows x 15 non-zero digits
WINDOWS = 256 // C_BITS


def _host_table(base_affine) -> np.ndarray:
    """(WINDOWS, 2^c, 2, 16) Montgomery affine: table[w][d] = d*2^(cw)*G.
    Entry d=0 is a placeholder (never selected)."""
    from ..curves.bn254_curve import G1

    rows = []
    p = base_affine
    for _ in range(WINDOWS):
        row = [p, p]  # d=0 placeholder, then d=1
        acc = p
        for _d in range(2, 1 << C_BITS):
            acc = G1.add(acc, p)
            row.append(acc)
        rows.append(row)
        for _ in range(C_BITS):
            p = G1.double(p)
    return np.stack([ec.encode_affine_mont(r) for r in rows])


# bounded per-(base, device) table cache; rebuilding a table is milliseconds
_TABLES: dict = {}
_TABLES_MAX = 8


def _table_for(base_affine, device) -> torch.Tensor:
    key = (base_affine, str(device))
    t = _TABLES.get(key)
    if t is None:
        if len(_TABLES) >= _TABLES_MAX:
            _TABLES.pop(next(iter(_TABLES)))
        t = _TABLES[key] = limbs_to_torch(_host_table(base_affine), device)
    return t


def _digits(scalars_std):
    """(n, 16) standard 16-bit limbs -> (WINDOWS, n) int32 digits in [0, 16)."""
    per_limb = 16 // C_BITS
    cols = []
    for w in range(WINDOWS):
        sh = C_BITS * (w % per_limb)
        cols.append((scalars_std[:, w // per_limb] >> sh) & ((1 << C_BITS) - 1))
    return torch.stack(cols)


def _accumulate_plain(table, digs) -> ec.PointP:
    """Plain K5: the window walk vectorized over the scalars."""
    n = digs.shape[1]
    acc = ec.identity((n,), device=digs.device)
    for w in range(WINDOWS):
        d = digs[w].to(torch.int64)
        q = table[w].index_select(0, d)  # (n, 2, 16); d=0 rows are unused
        nxt = ec.madd(acc, q[:, 0], q[:, 1])
        acc = ec.select_point(d == 0, acc, nxt)
    return acc


def _accumulate_k5(table, digs) -> ec.PointP:
    """K5 wrapper: one CUDA thread per scalar walks the 64 windows, the
    table in shared memory.

    Replaces ops/fixed_base.py `_fb_kernel` (called through `_accumulate_tile`) of
    the JAX package. Launch count: `_accumulate_k5.launches`."""
    if not (table.is_cuda and digs.is_cuda) or {table.dtype, digs.dtype} != {LIMB_DTYPE}:
        raise ValueError("_accumulate_k5 takes int32 CUDA tensors")
    if table.shape != (WINDOWS, 1 << C_BITS, 2, N_LIMBS) or digs.shape[0] != WINDOWS:
        raise ValueError("bad K5 operand shapes")
    n = digs.shape[1]
    table, digs = table.contiguous(), digs.contiguous()
    out = torch.empty((3, n, N_LIMBS), dtype=LIMB_DTYPE, device=digs.device)
    if n:
        rc = cuda_lib.lib("fixed_base").spt_fixed_base(
            out.data_ptr(), table.data_ptr(), digs.data_ptr(), n,
            cuda_lib.curve_params(), cuda_lib.stream_ptr(out),
        )
        cuda_lib.check(rc, "K5 fixed_base")
        _accumulate_k5.launches += 1
    return ec.PointP(out[0], out[1], out[2])


_accumulate_k5.launches = 0


def _accumulate(table, digs) -> ec.PointP:
    if digs.is_cuda:
        return _accumulate_k5(table, digs)
    return _accumulate_plain(table, digs)


def _normalize(p: ec.PointP):
    zinv = fo.batch_inv_mont(FQ_LIMB, p.z)
    x = fo.mont_mul(FQ_LIMB, p.x, zinv)
    y = fo.mont_mul(FQ_LIMB, p.y, zinv)
    return torch.stack([x, y], dim=1)  # (n, 2, 16) Montgomery affine


def fixed_base_mul_dev(base_affine, scalars_std):
    """base_affine: host affine int pair; scalars_std: (n, 16) standard-form
    limbs on the device that does the work. Returns (n, 2, 16) Montgomery
    affine points s_i * base; a zero scalar yields the (0, 0) row."""
    table = _table_for(base_affine, scalars_std.device)
    return _normalize(_accumulate(table, _digits(scalars_std)))
