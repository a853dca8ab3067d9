"""Bucket MSMs over BN254 G1: the JAX package's v2 pipeline (kernels K3 and
K4, the host-side digit prep and the host window fold) and its v1 pipeline
(kernel K6, the lane reduction and the folds).

v2, the pipeline kzg_commit uses:

    points --_msm_pack_points--> packed affine table (n, 2, 8) words
    scalars --_msm_prep_digits--> signed c-bit digits (W, n)
    K3 `_accum_v2`:    a counting sort of every column-window cw's live
                       points by bucket |digit| (digit 0 skipped) into runs
                       in ascending point order; run entry j of bucket b
                       goes to slot j mod 4S, a thread per (cw, b, slot)
                       mixed-adds its entries in order with the bucket in
                       registers (y negated by the sign), and slots s,
                       s + S, s + 2S, s + 3S fold into s -> per-slot
                       buckets (CW, S, B-1, 3, 8) words, S <= 64 slots
    K4 `_lane_reduce`: log2(S) halving rounds of complete projective adds
                       -> one bucket table (CW, B, 3, 16) limbs
    host `_host_fold_mont`: suffix sums and the window fold on Python ints,
                       one inversion at the end -> affine point.

Blocks on Hopper run in no order, so no bucket is carried from block to
block as the TPU kernel carried its VMEM buckets along the sequential grid:
every (cw, slot, bucket) owns its bucket, and K4 sums the slots in a fixed
tree. The order of additions is the same in the kernels and their plain
versions (per (cw, slot, bucket), ascending point index), so their
projective buckets agree exactly; the folded affine point agrees with the
JAX package and with host Pippenger.

v1 (`msm_tile`, `msm_tile_host`, `msm_tile_host_batch`): signed 4-bit digits
(64 windows x 9 buckets); point i goes to lane i mod LANES (LANES = SUB_T x
128 = 1024), and K6 `_msm_buckets_lanes` gives every (column, window, lane)
its own 8 live buckets, walked in ascending tile order -> a raw per-lane
table (W4, B4, 3, 16, SUB_T, 128); `_reduce_lanes` (plain torch complete
adds) sums the lanes, then `_reduce_buckets` (device) or `_host_fold`
(host ints) folds the windows. Zero digits are skipped, so bucket 0 stays
the identity in the kernel and in its plain version alike; the folds never
read it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields.bn254 import FQ_MOD
from ..fields.limbs import (
    FQ_LIMB, LIMB_DTYPE, N_LIMBS, limbs_from_torch, limbs_to_words, words_to_limbs,
)
from . import cuda_lib
from . import ec
from . import field_ops as fo
from .msm import B4, C4, W4, _fold_windows, _signed_digits4, _weighted_windows

FQ = FQ_LIMB
MSM_C = 6  # signed 6-bit windows: 43 windows x 33 buckets
K3_MAX_SLOTS = 64  # S: slots per bucket run, so K4 takes log2(S) <= 6 rounds
K3_MIN_POINTS = 1024  # column points per slot at the least (S = 64 from n = 2^16 up)
K3_TILE = 4096  # points per counting-sort tile (csrc/msm.cu)
K3_FOLD = 4  # accumulating slots per output slot (csrc/msm.cu)


def _wb(c: int):
    """Window count / bucket count for signed c-bit digits (scalars < 2^254,
    so the top digit plus one carry stays <= 2^(c-1) for c in 4..8)."""
    W = -(-256 // c)
    B = (1 << (c - 1)) + 1
    return W, B


def _slots(n: int) -> int:
    """S: slots per bucket run of an n-point column, a power of two so K4
    halves evenly."""
    S = 1
    while S < K3_MAX_SLOTS and n >= 2 * S * K3_MIN_POINTS:
        S *= 2
    return S


def _msm_pack_points(points_affine_mont):
    """(n, 2, 16) Montgomery affine limbs -> the packed affine table K3
    reads: (n, 2, 8) 32-bit words, 64 B per point."""
    return limbs_to_words(points_affine_mont).contiguous()


def _msm_prep_digits(scalar_limbs, c: int):
    """(n, 16) standard scalar limbs -> signed digits and signs, each (W, n)
    int32: raw c-bit windows, then the carry scan (a digit above 2^(c-1)
    becomes 2^c - digit with its sign set and carries one up)."""
    W, _B = _wb(c)
    mask = (1 << c) - 1
    half, full = 1 << (c - 1), 1 << c
    digs, signs = [], []
    carry = torch.zeros_like(scalar_limbs[:, 0])
    for w in range(W):
        bit = w * c
        limb, sh = bit // 16, bit % 16
        v = scalar_limbs[:, limb] >> sh
        if sh + c > 16 and limb + 1 < N_LIMBS:
            v = v | (scalar_limbs[:, limb + 1] << (16 - sh))
        e = (v & mask) + carry
        neg = e > half
        digs.append(torch.where(neg, full - e, e))
        carry = neg.to(LIMB_DTYPE)
        signs.append(carry)
    return torch.stack(digs), torch.stack(signs)


def _pad_points_scalars(points, scalars_list):
    """Zero-pad each scalar column to the point count (zero digits are
    skipped, so padding adds nothing)."""
    n = points.shape[0]
    out = []
    for sl in scalars_list:
        if sl.shape[0] < n:
            sl = torch.cat([sl, sl.new_zeros(n - sl.shape[0], N_LIMBS)])
        out.append(sl)
    return points, out


# --- K3: bucket sort and per-slot accumulation --------------------------------


def _accum_v2_plain(pts, digs, signs, B: int):
    """Plain K3, in K3's order: every live (cw, point) joins the run of
    (cw, bucket |digit|) in ascending point index; run entry j goes to slot
    u = j mod 4S, and step k mixed-adds, for every (cw, slot, bucket) at
    once, its entry j = 4S k + u; then output slot s = (u_s + u_{s+2S}) +
    (u_{s+S} + u_{s+3S}) in complete adds. pts (n, 2, 8) words; returns
    bucket words (CW, S, B-1, 3, 8)."""
    CW, n = digs.shape
    S = _slots(n)
    SF = S * K3_FOLD
    NB = B - 1
    dev = digs.device
    X, Y, Z = ec.identity((CW * SF * NB,), device=dev)
    cw, i = torch.nonzero(digs, as_tuple=True)  # ascending (cw, i)
    if i.numel():
        d = digs[cw, i].to(torch.int64) - 1
        neg = signs[cw, i] != 0
        g, order = torch.sort(cw * NB + d, stable=True)  # runs, each in ascending i
        i, neg = i[order], neg[order]
        at = torch.arange(g.numel(), device=dev)
        first = torch.ones_like(g, dtype=torch.bool)
        first[1:] = g[1:] != g[:-1]
        j = at - torch.cummax(torch.where(first, at, 0), 0).values  # entry index in its run
        rows = ((g // NB) * SF + j % SF) * NB + g % NB  # (cw, slot, bucket)
        step = j // SF
        # entries grouped by step once: a step is then one contiguous slice
        # (no row occurs twice in a step, so the order inside one is free)
        by_step = torch.argsort(step, stable=True)
        rows, i, neg = rows[by_step], i[by_step], neg[by_step]
        q = words_to_limbs(pts)
        a = 0
        for b in torch.bincount(step).cumsum(0).tolist():
            r, ii = rows[a:b], i[a:b]
            qy = fo.select(neg[a:b], fo.neg_mod(FQ, q[ii, 1]), q[ii, 1])
            nxt = ec.madd(ec.PointP(X[r], Y[r], Z[r]), q[ii, 0], qy)
            X[r], Y[r], Z[r] = nxt.x, nxt.y, nxt.z
            a = b
    t = ec.PointP(*(c.reshape(CW, SF, NB, N_LIMBS) for c in (X, Y, Z)))
    while t.x.shape[1] > S:  # fold: slot u < h adds slot u + h, h = 2S, S
        h = t.x.shape[1] // 2
        t = ec.add(ec.PointP(*(c[:, :h] for c in t)), ec.PointP(*(c[:, h:] for c in t)))
    return limbs_to_words(torch.stack(list(t), dim=3))


def _accum_k3(pts, digs, signs, B: int):
    """K3 wrapper: a counting sort of the live points into bucket runs, then
    one CUDA thread per (column-window, bucket, slot) with its bucket in
    registers, four slots folded into each output slot; four kernels, one
    call.

    Replaces ops/msm_tile.py `_msm_accum_kernel` (called through `_accum_v2`) of
    the JAX package. Launch count: `_accum_k3.launches`."""
    CW, n = digs.shape
    for t in (pts, digs, signs):
        if not t.is_cuda or t.dtype != LIMB_DTYPE:
            raise ValueError("_accum_k3 takes int32 CUDA tensors")
    if pts.shape != (n, 2, 8) or signs.shape != (CW, n):
        raise ValueError("bad K3 operand shapes")
    if B != (1 << (MSM_C - 1)) + 1 or n >= 1 << 31:
        raise ValueError(f"K3 is built for c={MSM_C} (B={(1 << (MSM_C - 1)) + 1}) and n < 2^31")
    S, NB = _slots(n), B - 1
    tiles = -(-n // K3_TILE)
    pts, digs, signs = (t.contiguous() for t in (pts, digs, signs))
    if pts.data_ptr() % 16:
        raise ValueError("K3 reads the point table with 16-byte loads: it must be 16-byte aligned")
    dev = pts.device
    out = torch.empty((CW, S, NB, 3, 8), dtype=LIMB_DTYPE, device=dev)
    perm = torch.empty((CW, n), dtype=LIMB_DTYPE, device=dev)  # bucket runs
    cnt = torch.empty((CW, NB, tiles), dtype=LIMB_DTYPE, device=dev)  # counts, then run offsets
    run = torch.empty((CW, NB, 2), dtype=LIMB_DTYPE, device=dev)  # run start and length
    rc = cuda_lib.lib("msm").spt_msm_accum(
        out.data_ptr(), pts.data_ptr(), digs.data_ptr(), signs.data_ptr(),
        perm.data_ptr(), cnt.data_ptr(), run.data_ptr(),
        n, CW, S, tiles, cuda_lib.curve_params(), cuda_lib.stream_ptr(out),
    )
    cuda_lib.check(rc, "K3 msm_accum")
    _accum_k3.launches += 1
    return out


_accum_k3.launches = 0


def _accum_v2(pts, digs, signs, B: int):
    """pts (n, 2, 8) words; digs/signs (CW, n) -> per-slot bucket words."""
    if pts.is_cuda:
        return _accum_k3(pts, digs, signs, B)
    return _accum_v2_plain(pts, digs, signs, B)


# --- K4: slot reduction -----------------------------------------------------


def _lane_reduce_plain(tbl):
    """Plain K4: (CW, S, NB, 3, 8) words -> (CW, 1, NB, 3, 8) by halving
    rounds tbl[:, :h] + tbl[:, h:] of complete projective adds."""
    while tbl.shape[1] > 1:
        h = tbl.shape[1] // 2
        lo, hi = words_to_limbs(tbl[:, :h]), words_to_limbs(tbl[:, h:])
        s = ec.add(
            ec.PointP(lo[..., 0, :], lo[..., 1, :], lo[..., 2, :]),
            ec.PointP(hi[..., 0, :], hi[..., 1, :], hi[..., 2, :]),
        )
        tbl = limbs_to_words(torch.stack(list(s), dim=-2))
    return tbl


def _lane_reduce_k4(tbl):
    """K4 wrapper: each halving round is one launch, one thread per
    (cw, s, bucket) summing slots s and s + S/2.

    Replaces ops/msm_tile.py `_lane_reduce_kernel` (called through
    `_lane_reduce_v2`) of the JAX package. Launch count:
    `_lane_reduce_k4.launches`."""
    if not tbl.is_cuda or tbl.dtype != LIMB_DTYPE or tbl.shape[3:] != (3, 8):
        raise ValueError("_lane_reduce_k4 takes (CW, S, NB, 3, 8) int32 CUDA words")
    CW, S = tbl.shape[:2]
    if S & (S - 1):
        raise ValueError("K4 needs a power-of-two slot count")
    lib = cuda_lib.lib("msm")
    tbl = tbl.contiguous()
    while S > 1:
        h = S // 2
        out = torch.empty((CW, h) + tuple(tbl.shape[2:]), dtype=LIMB_DTYPE, device=tbl.device)
        rc = lib.spt_msm_reduce(
            out.data_ptr(), tbl.data_ptr(), CW, h * tbl.shape[2],
            cuda_lib.curve_params(), cuda_lib.stream_ptr(out),
        )
        cuda_lib.check(rc, "K4 msm_reduce")
        _lane_reduce_k4.launches += 1
        tbl, S = out, h
    return tbl


_lane_reduce_k4.launches = 0


def _lane_reduce_v2(tbl):
    """(CW, S, B-1, 3, 8) per-slot bucket words -> (CW, B, 3, 16) limb
    table with bucket 0 the identity (0, 1, 0) (the fold never reads it)."""
    red = _lane_reduce_k4(tbl) if tbl.is_cuda else _lane_reduce_plain(tbl)
    limbs = words_to_limbs(red[:, 0])  # (CW, NB, 3, 16)
    ident = torch.stack(list(ec.identity((limbs.shape[0],), device=limbs.device)), dim=1)
    return torch.cat([ident[:, None], limbs], dim=1)


# --- host projective fold (Montgomery in, one inversion out) -------------

_R_INV = pow(1 << 256, -1, FQ_MOD)


def _decode_mont_table(tbl: np.ndarray) -> list:
    """Flatten a (..., 16) uint32 Montgomery table to standard-form ints."""
    m = tbl.size // N_LIMBS
    buf = np.ascontiguousarray(tbl.reshape(m, N_LIMBS)).astype("<u2").tobytes()
    return [int.from_bytes(buf[32 * i : 32 * (i + 1)], "little") * _R_INV % FQ_MOD for i in range(m)]


def _host_fold_mont(tbl: np.ndarray, c: int):
    """(W, B, 3, 16) uint32 Montgomery projective bucket table -> affine int
    point or None: complete projective adds (RCB15 alg 7, a=0) on Python
    ints, suffix sums per window, double-and-add across windows, one
    inversion at the end."""
    P = FQ_MOD
    W, B = tbl.shape[-4], tbl.shape[-3]
    vals = _decode_mont_table(tbl)

    def proj_add(a, b):
        X1, Y1, Z1 = a
        X2, Y2, Z2 = b
        t0 = X1 * X2 % P
        t1 = Y1 * Y2 % P
        t2 = Z1 * Z2 % P
        t3 = ((X1 + Y1) * (X2 + Y2) - t0 - t1) % P
        t4 = ((Y1 + Z1) * (Y2 + Z2) - t1 - t2) % P
        y3 = ((X1 + Z1) * (X2 + Z2) - t0 - t2) % P
        x3 = 3 * t0 % P
        t2b = 9 * t2 % P
        z3 = (t1 + t2b) % P
        t1b = (t1 - t2b) % P
        y3b = 9 * y3 % P
        X3 = (t3 * t1b - t4 * y3b) % P
        Y3 = (t1b * z3 + y3b * x3) % P
        Z3 = (t4 * z3 + t3 * x3) % P
        return X3, Y3, Z3

    IDENT = (0, 1, 0)
    total = IDENT
    for w in range(W - 1, -1, -1):
        if total != IDENT:
            for _ in range(c):
                total = proj_add(total, total)
        run = IDENT
        acc = IDENT
        for b in range(B - 1, 0, -1):
            i = (w * B + b) * 3
            pt = (vals[i], vals[i + 1], vals[i + 2])
            if pt[2] != 0:
                run = proj_add(run, pt) if run != IDENT else pt
            if run != IDENT:
                acc = proj_add(acc, run) if acc != IDENT else run
        if acc != IDENT:
            total = proj_add(total, acc) if total != IDENT else acc
    if total == IDENT or total[2] == 0:
        return None
    zi = pow(total[2], -1, P)
    return (total[0] * zi % P, total[1] * zi % P)


def msm_v2_host_batch(points_affine_mont, scalar_limbs_list):
    """C MSMs over shared points (n, 2, 16) Montgomery affine; each scalar
    column (n_i <= n, 16) in standard form. One K3 launch for all columns,
    K4, one small readback, then the host fold. Returns C affine points (or
    None)."""
    W, B = _wb(MSM_C)
    points, scalars = _pad_points_scalars(points_affine_mont, scalar_limbs_list)
    pts = _msm_pack_points(points)
    prepped = [_msm_prep_digits(sl, MSM_C) for sl in scalars]
    digs = torch.cat([d for d, _ in prepped])  # (C*W, n)
    signs = torch.cat([s for _, s in prepped])
    tbl = _lane_reduce_v2(_accum_v2(pts, digs, signs, B))
    tbl_h = limbs_from_torch(tbl).reshape(len(scalars), W, B, 3, N_LIMBS)
    return [_host_fold_mont(t, MSM_C) for t in tbl_h]


def msm_v2_host(points_affine_mont, scalar_limbs):
    return msm_v2_host_batch(points_affine_mont, [scalar_limbs])[0]


# --- v1: signed 4-bit windows, per-lane buckets (K6) ---------------------------

SUB_T = 8  # sublanes per point tile: LANES = SUB_T * 128 lanes


def _msm_buckets_lanes_plain(px, py, digs, signs):
    """Plain K6, in K6's order: for each tile t in turn, every (cw, lane)
    mixed-adds point t * M + lane into its bucket digit (one-hot select read
    and write; digit 0 is skipped). px/py (16, tiles, st, lanes); digs/signs
    (CW, tiles, st, lanes) int32 -> (CW, B4, 3, 16, st, lanes), bucket 0 the
    identity."""
    L, tiles, st, lanes = px.shape
    CW, M = digs.shape[0], st * lanes
    dev = px.device
    qx_t, qy_t = px.reshape(L, tiles, M), py.reshape(L, tiles, M)
    d_t, s_t = digs.reshape(CW, tiles, M), signs.reshape(CW, tiles, M)
    acc = ec.identity((CW, B4 - 1, M), device=dev)
    b_idx = torch.arange(1, B4, dtype=digs.dtype, device=dev)[None, :, None]
    for t in range(tiles):
        sel = (d_t[:, t][:, None, :] == b_idx)[..., None]  # (CW, 8, M, 1); digit 0 selects none
        cur = ec.PointP(*(torch.where(sel, a, 0).sum(dim=1, dtype=LIMB_DTYPE) for a in acc))
        qx = qx_t[:, t].T.expand(CW, M, N_LIMBS)
        qy = qy_t[:, t].T.expand(CW, M, N_LIMBS)
        qy = fo.select(s_t[:, t] != 0, fo.neg_mod(FQ, qy), qy)
        new = ec.madd(cur, qx, qy)
        acc = ec.PointP(*(torch.where(sel, nw[:, None], a) for nw, a in zip(new, acc)))
    ident = ec.identity((CW, 1, M), device=dev)
    coords = [torch.cat([i, a], dim=1) for i, a in zip(ident, acc)]  # (CW, B4, M, 16)
    return torch.stack(coords, dim=2).permute(0, 1, 2, 4, 3).reshape(CW, B4, 3, L, st, lanes)


def _msm_buckets_lanes_k6(px, py, digs, signs):
    """K6 wrapper: one CUDA thread per (column-window cw, lane) holds the
    lane's 8 live buckets and walks its points in ascending tile order.

    Replaces ops/msm_tile.py `_msm_kernel` (called through
    `_msm_buckets_lanes` and `_msm_buckets_lanes_batch`) of the JAX package.
    Launch count: `_msm_buckets_lanes_k6.launches`."""
    for t in (px, py, digs, signs):
        if not t.is_cuda or t.dtype != LIMB_DTYPE:
            raise ValueError("_msm_buckets_lanes_k6 takes int32 CUDA tensors")
    L, tiles, st, lanes = px.shape
    CW = digs.shape[0]
    if L != N_LIMBS or py.shape != px.shape or digs.shape != (CW, tiles, st, lanes) or signs.shape != digs.shape:
        raise ValueError("bad K6 operand shapes")
    M = st * lanes
    px, py, digs, signs = (t.contiguous() for t in (px, py, digs, signs))
    out = torch.empty((CW, B4, 3, N_LIMBS, st, lanes), dtype=LIMB_DTYPE, device=px.device)
    if CW and M:
        rc = cuda_lib.lib("msm4").spt_msm4_lanes(
            out.data_ptr(), px.data_ptr(), py.data_ptr(), digs.data_ptr(), signs.data_ptr(),
            tiles * M, CW, M, cuda_lib.curve_params(), cuda_lib.stream_ptr(out),
        )
        cuda_lib.check(rc, "K6 msm4_lanes")
        _msm_buckets_lanes_k6.launches += 1
    return out


_msm_buckets_lanes_k6.launches = 0


def _msm_buckets_lanes(px, py, digs, signs):
    """px/py (16, tiles, SUB_T, 128); digs/signs (W4, tiles, SUB_T, 128) ->
    the raw (W4, B4, 3, 16, SUB_T, 128) per-lane bucket table."""
    if px.is_cuda:
        return _msm_buckets_lanes_k6(px, py, digs, signs)
    return _msm_buckets_lanes_plain(px, py, digs, signs)


def _msm_buckets_lanes_batch(px, py, digs, signs):
    """C columns over shared points in one launch: digs/signs (C, W4, tiles,
    SUB_T, 128) -> (C, W4, B4, 3, 16, SUB_T, 128)."""
    C = digs.shape[0]
    out = _msm_buckets_lanes(px, py, digs.reshape(C * W4, *digs.shape[2:]),
                             signs.reshape(C * W4, *signs.shape[2:]))
    return out.reshape(C, W4, *out.shape[1:])


def _reduce_lanes(tbl):
    """(..., B, 3, 16, st, lanes) per-lane buckets -> (..., B, 3, 16) by
    log2(st * lanes) halving rounds of vectorized complete adds."""
    *lead, B, _, L, st, lanes = tbl.shape
    m = st * lanes
    p = ec.PointP(*(tbl.select(-4, c).reshape(*lead, B, L, m).transpose(-1, -2) for c in range(3)))
    while m > 1:
        h = m // 2
        p = ec.add(ec.PointP(*(a[..., :h, :] for a in p)), ec.PointP(*(a[..., h:, :] for a in p)))
        m = h
    return torch.stack([a[..., 0, :] for a in p], dim=-2)


def _msm_buckets(px, py, digs, signs):
    """Accumulate + lane-reduce: the (W4, B4, 3, 16) bucket table."""
    return _reduce_lanes(_msm_buckets_lanes(px, py, digs, signs))


def _v1_prep(points_affine_mont, scalar_list):
    """Pad the points to a lane multiple with copies of point 0 and every
    scalar column with zeros (zero digits add nothing) -> px, py (16, tiles,
    SUB_T, 128) and digs, signs (C, W4, tiles, SUB_T, 128) int32."""
    n = points_affine_mont.shape[0]
    npad = (-n) % (SUB_T * 128)
    if npad:
        reps = points_affine_mont[:1].expand(npad, 2, N_LIMBS)
        points_affine_mont = torch.cat([points_affine_mont, reps])
    points, cols = _pad_points_scalars(points_affine_mont, scalar_list)
    shape = (N_LIMBS, (n + npad) // (SUB_T * 128), SUB_T, 128)
    px = points[:, 0, :].T.reshape(shape)
    py = points[:, 1, :].T.reshape(shape)
    prepped = [_signed_digits4(s) for s in cols]
    digs = torch.stack([d.reshape(W4, *shape[1:]) for d, _ in prepped])
    signs = torch.stack([s.to(LIMB_DTYPE).reshape(W4, *shape[1:]) for _, s in prepped])
    return px, py, digs, signs


def _msm_tbl(points_affine_mont, scalar_limbs):
    """Pad, digit-decompose, accumulate, lane-reduce: the (W4, B4, 3, 16)
    device bucket table of one MSM."""
    px, py, digs, signs = _v1_prep(points_affine_mont, [scalar_limbs])
    return _msm_buckets(px, py, digs[0], signs[0])


def _reduce_buckets(tbl) -> ec.PointP:
    """(W4, B4, 3, 16) lane-reduced buckets -> one projective point (device
    weighted sums, then the window fold)."""
    buckets = ec.PointP(tbl[:, :, 0], tbl[:, :, 1], tbl[:, :, 2])
    return _fold_windows(_weighted_windows(buckets), C4)


def msm_tile(points_affine_mont, scalar_limbs) -> ec.PointP:
    """points: (n, 2, 16) Montgomery affine; scalars: (n, 16) standard limbs.
    Returns one projective point."""
    return _reduce_buckets(_msm_tbl(points_affine_mont, scalar_limbs))


def msm_tile_host(points_affine_mont, scalar_limbs):
    """msm_tile with the small (W4 x B4) fold on host ints: returns a host
    affine point or None."""
    return _host_fold(limbs_from_torch(_msm_tbl(points_affine_mont, scalar_limbs)))


def msm_tile_host_batch(points_affine_mont, scalar_limbs_list):
    """C MSMs over shared points in one K6 launch and one readback. Scalar
    columns (n_i <= n, 16) are zero-padded. Returns C host affine points (or
    None)."""
    if len(scalar_limbs_list) == 1:
        k = scalar_limbs_list[0]
        return [msm_tile_host(points_affine_mont[: k.shape[0]], k)]
    px, py, digs, signs = _v1_prep(points_affine_mont, scalar_limbs_list)
    tbls = limbs_from_torch(_reduce_lanes(_msm_buckets_lanes_batch(px, py, digs, signs)))
    return [_host_fold(t) for t in tbls]


def _host_fold(tbl: np.ndarray):
    """(W4, B4, 3, 16) uint32 Montgomery projective bucket table -> host
    affine point (or None): suffix sums per window, then double-and-add
    across windows, on affine host ints."""
    from ..curves.bn254_curve import G1

    vals = _decode_mont_table(tbl)
    total = None
    for w in range(W4 - 1, -1, -1):
        for _ in range(C4):
            total = G1.double(total) if total is not None else None
        run = acc = None
        for b in range(B4 - 1, 0, -1):
            i = (w * B4 + b) * 3
            pt = _proj_to_affine(vals[i], vals[i + 1], vals[i + 2])
            if pt is not None:
                run = G1.add(run, pt)
            if run is not None:
                acc = G1.add(acc, run)
        if acc is not None:
            total = G1.add(total, acc)
    return total


def _proj_to_affine(X: int, Y: int, Z: int):
    if Z % FQ_MOD == 0:
        return None
    zi = pow(Z, -1, FQ_MOD)
    return (X * zi % FQ_MOD, Y * zi % FQ_MOD)
