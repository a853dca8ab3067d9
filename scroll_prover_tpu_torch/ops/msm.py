"""Pippenger multi-scalar multiplication over BN254 G1 in plain PyTorch: the
JAX package's ops/msm.py, operation for operation.

MSM(points, scalars) = sum_i scalars[i] * points[i]. Three variants, each
returning one projective point whose limbs equal the JAX package's:

  * `msm_scan`: the legacy O(n log n) one. Per 8-bit window, points sorted
    by digit, bucket sums from one segmented Hillis-Steele scan of complete
    adds, then suffix sums.
  * `msm` (`msm_padded`, `msm_host`): O(n) scatter accumulation with signed
    8-bit digits. Lane l of window w owns bucket row T[w, l, :]; each step
    does one mixed add per (w, l), then log2(V) halving rounds, the weighted
    sum by two scans over the buckets, and the window fold.
  * `msm_onehot`: the same with signed 4-bit digits (64 windows x 9 buckets)
    and one-hot select updates in place of the scatter. `_signed_digits4`
    and `_hs_scan_points` are shared with the v1 kernel path
    (ops/msm_tile.py, K6).

No kernel of its own: every point operation is ops/ec.py, whose Montgomery
products run K1 on a CUDA tensor. The JAX package's `SPT_MSM_LANES`
environment knob is the constant MSM_LANES4 = 256 here.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..fields.limbs import LIMB_BITS, LIMB_DTYPE, N_LIMBS, ints_to_limbs, limbs_to_torch
from . import ec
from . import field_ops as fo

C = 8  # window bits; 256/C windows, 2^C buckets
N_WINDOWS = 256 // C
N_BUCKETS = 1 << C


def _digits(scalars):
    """(n, 16) standard-form scalar limbs -> (N_WINDOWS, n) int32 digits,
    window 0 the least significant."""
    per_limb = LIMB_BITS // C
    return torch.stack([
        (scalars[:, w // per_limb] >> ((w % per_limb) * C)) & (N_BUCKETS - 1)
        for w in range(N_WINDOWS)
    ])


def _take(p: ec.PointP, idx) -> ec.PointP:
    return ec.PointP(*(a[idx] for a in p))


def _seg_scan(pts: ec.PointP, flags) -> ec.PointP:
    """Segmented inclusive prefix scan of point addition along axis 0;
    flags[i] marks the start of a segment (Hillis-Steele, ceil(log2 n)
    rounds of one vectorized complete add)."""
    n = flags.shape[0]
    pos = torch.arange(n, device=flags.device)
    v, f = pts, flags
    for k in range(max((n - 1).bit_length(), 1)):
        s = 1 << k
        vs = ec.PointP(*(torch.roll(a, s, dims=0) for a in v))
        fs = torch.roll(f, s, dims=0)
        valid = (pos >= s) & ~f
        v = ec.select_point(valid, ec.add(v, vs), v)
        f = f | torch.where(pos >= s, fs, True)
    return v


def _flip(p: ec.PointP, dim: int) -> ec.PointP:
    return ec.PointP(*(a.flip(dim) for a in p))


def _scan_points(pts: ec.PointP, reverse: bool = False) -> ec.PointP:
    """Plain inclusive prefix (or suffix) scan of point addition."""
    n = pts.x.shape[0]
    flags = torch.zeros(n, dtype=torch.bool, device=pts.x.device)
    flags[0] = True
    if reverse:
        return _flip(_seg_scan(_flip(pts, 0), flags), 0)
    return _seg_scan(pts, flags)


def _bucket_window(points: ec.PointP, digits) -> ec.PointP:
    """One window: S = sum_j j * B_j as a single projective point."""
    n = digits.shape[0]
    dev = digits.device
    order = torch.argsort(digits, stable=True)
    d_sorted = digits[order]
    # zero digits contribute nothing: their segment sums to the identity
    pts = ec.select_point(d_sorted != 0, _take(points, order), ec.identity((n,), device=dev))
    flags = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), d_sorted[1:] != d_sorted[:-1]])
    prefix = _seg_scan(pts, flags)
    # bucket totals j = 1..B-1 sit at the last element of each digit's run
    js = torch.arange(1, N_BUCKETS, dtype=d_sorted.dtype, device=dev)
    starts = torch.searchsorted(d_sorted, js)
    stops = torch.searchsorted(d_sorted, js, right=True)
    has = stops > starts
    ends = torch.where(has, stops - 1, 0)
    bsum = ec.select_point(has, _take(prefix, ends), ec.identity((N_BUCKETS - 1,), device=dev))
    # sum_j j*B_j = sum_j suffix_j: a suffix scan, then the total of a prefix scan
    total = _scan_points(_scan_points(bsum, reverse=True))
    return _take(total, -1)


def _add1(acc: ec.PointP, s: ec.PointP) -> ec.PointP:
    """acc + s for single (16,) points."""
    out = ec.add(ec.PointP(*(a[None] for a in acc)), ec.PointP(*(a[None] for a in s)))
    return _take(out, 0)


def _fold_windows(win: ec.PointP, c: int) -> ec.PointP:
    """Fold window sums (W,) MSB -> LSB with c doublings per window."""
    acc = ec.identity(device=win.x.device)
    for i in range(win.x.shape[0] - 1, -1, -1):
        for _ in range(c):
            acc = ec.double(acc)
        acc = _add1(acc, _take(win, i))
    return acc


def msm_scan(points_affine_mont, scalar_limbs) -> ec.PointP:
    """Legacy O(n log n) segmented-scan MSM (kept for cross-validation)."""
    pts = ec.from_affine(points_affine_mont)
    acc = ec.identity(device=points_affine_mont.device)
    for d in _digits(scalar_limbs).flip(0):
        for _ in range(C):
            acc = ec.double(acc)
        acc = _add1(acc, _bucket_window(pts, d))
    return acc


# --- O(n) bucket-matrix Pippenger ---------------------------------------------
#
# Signed digits in [-2^(C-1), 2^(C-1)] (a carry chain across windows; BN254
# scalars < 2^254 leave the top window carry-free), so each window needs
# 2^(C-1) + 1 buckets, negative digits adding the negated point. Digit 0
# lands in bucket 0, which the weighted sum discards.

SIGNED_B = (1 << (C - 1)) + 1  # buckets 0..128; bucket 0 discarded
MSM_LANES = 128  # V: lanes per window


def _signed_carry(digs, c: int):
    """Raw c-bit window digits (W, n) -> signed digits in [0, 2^(c-1)] and
    signs (W, n) bool, scalar = sum_w (-1)^sign_w * digit_w * 2^(c*w)."""
    half, full = 1 << (c - 1), 1 << c
    carry = torch.zeros_like(digs[0])
    out, signs = [], []
    for d in digs:
        e = d + carry
        neg = e > half
        out.append(torch.where(neg, full - e, e))
        signs.append(neg)
        carry = neg.to(digs.dtype)
    return torch.stack(out), torch.stack(signs)


def _signed_digits(scalar_limbs):
    """(n, 16) standard limbs -> digits (N_WINDOWS, n) int32 in [0, 128] and
    signs (N_WINDOWS, n) bool."""
    return _signed_carry(_digits(scalar_limbs), C)


def _neg_y(qy, signs):
    return fo.select(signs, fo.neg_mod(ec.F, qy), qy)


def _lane_halve(tbl: ec.PointP) -> ec.PointP:
    """(W, V, B) -> (W, 1, B) by log2(V) halving rounds of complete adds."""
    while tbl.x.shape[1] > 1:
        h = tbl.x.shape[1] // 2
        tbl = ec.add(ec.PointP(*(a[:, :h] for a in tbl)), ec.PointP(*(a[:, h:] for a in tbl)))
    return tbl


def _weighted_windows(buckets: ec.PointP) -> ec.PointP:
    """(W, B) bucket sums -> (W,) window sums sum_{b>=1} b * S_b."""
    bsum = ec.PointP(*(a[:, 1:] for a in buckets))
    total = _hs_scan_points(_hs_scan_points(bsum, reverse=True))
    return ec.PointP(*(a[:, -1] for a in total))


def msm(points_affine_mont, scalar_limbs) -> ec.PointP:
    """points: (n, 2, 16) Montgomery affine; scalars: (n, 16) standard-form
    limbs. Returns one projective point. O(n) point adds."""
    n = points_affine_mont.shape[0]
    dev = points_affine_mont.device
    V = min(MSM_LANES, n)
    steps = n // V
    W = N_WINDOWS
    digs, signs = _signed_digits(scalar_limbs)
    px = points_affine_mont[:, 0, :].reshape(steps, V, N_LIMBS)
    py = points_affine_mont[:, 1, :].reshape(steps, V, N_LIMBS)
    d_s = digs.reshape(W, steps, V).transpose(0, 1)  # (steps, W, V)
    s_s = signs.reshape(W, steps, V).transpose(0, 1)

    X, Y, Z = (a.clone() for a in ec.identity((W, V, SIGNED_B), device=dev))
    w_idx = torch.arange(W, device=dev)[:, None]
    l_idx = torch.arange(V, device=dev)[None, :]
    for t in range(steps):
        d = d_s[t].to(torch.int64)  # (W, V)
        qx = px[t].expand(W, V, N_LIMBS)
        qy = _neg_y(py[t].expand(W, V, N_LIMBS), s_s[t])
        cur = ec.PointP(X[w_idx, l_idx, d], Y[w_idx, l_idx, d], Z[w_idx, l_idx, d])
        new = ec.madd(cur, qx, qy)
        X[w_idx, l_idx, d], Y[w_idx, l_idx, d], Z[w_idx, l_idx, d] = new
    buckets = ec.PointP(*(a[:, 0] for a in _lane_halve(ec.PointP(X, Y, Z))))  # (W, B)
    return _fold_windows(_weighted_windows(buckets), C)


def _hs_scan_points(pts: ec.PointP, reverse: bool = False) -> ec.PointP:
    """Inclusive Hillis-Steele prefix scan of point addition along axis 1
    (batched over axis 0). Small inputs only (the weighted bucket sum)."""
    if reverse:
        return _flip(_hs_scan_points(_flip(pts, 1)), 1)
    n = pts.x.shape[1]
    pos = torch.arange(n, device=pts.x.device)[None, :]
    v = pts
    for k in range(max((n - 1).bit_length(), 1)):
        s = 1 << k
        vs = ec.PointP(*(torch.roll(a, s, dims=1) for a in v))
        keep = (pos >= s).expand(v.x.shape[:2])
        v = ec.select_point(keep, ec.add(v, vs), v)
    return v


MIN_PAD = 64  # canonical minimum size: small MSMs share one shape


def pad_size(n: int) -> int:
    return max(MIN_PAD, 1 << max(n - 1, 1).bit_length())


def msm_padded(points_affine_mont, scalar_limbs) -> ec.PointP:
    """msm() with inputs padded to a power-of-two size: padding scalars are
    zero, so the padding points (copies of row 0) add nothing."""
    n = points_affine_mont.shape[0]
    m = pad_size(n)
    if m != n:
        reps = points_affine_mont[:1].expand(m - n, *points_affine_mont.shape[1:])
        points_affine_mont = torch.cat([points_affine_mont, reps])
        scalar_limbs = torch.cat([scalar_limbs, scalar_limbs.new_zeros(m - n, N_LIMBS)])
    return msm(points_affine_mont, scalar_limbs)


def msm_host(points, scalars, device=None):
    """Host convenience: int points/scalars -> affine int result (or None).
    Runs on `device` (default cuda)."""
    dev = resolve_device(device)
    pa = limbs_to_torch(ec.encode_affine_mont(points), dev)
    sl = limbs_to_torch(ints_to_limbs([int(s) for s in scalars]), dev)
    return ec.decode_point(msm_padded(pa, sl))


# --- select-based bucket MSM: 4-bit signed windows ---------------------------

C4 = 4
W4 = 256 // C4  # 64 windows
B4 = (1 << (C4 - 1)) + 1  # buckets 0..8 (signed digits), bucket 0 discarded
MSM_LANES4 = 256


def _signed_digits4(scalar_limbs):
    """(n, 16) standard limbs -> digits (W4, n) int32 in [0, 8], signs
    (W4, n) bool."""
    per_limb = LIMB_BITS // C4
    raw = torch.stack([
        (scalar_limbs[:, w // per_limb] >> ((w % per_limb) * C4)) & 15 for w in range(W4)
    ])
    return _signed_carry(raw, C4)


def msm_onehot(points_affine_mont, scalar_limbs) -> ec.PointP:
    """O(n) bucket MSM with select-based accumulation. points: (n, 2, 16)
    Montgomery affine; scalars: (n, 16) standard limbs -> projective point."""
    n = points_affine_mont.shape[0]
    dev = points_affine_mont.device
    V = min(MSM_LANES4, n)
    steps = n // V
    if steps * V != n:
        raise ValueError("n must be a multiple of the lane count")
    digs, signs = _signed_digits4(scalar_limbs)
    px = points_affine_mont[:, 0, :].reshape(steps, V, N_LIMBS)
    py = points_affine_mont[:, 1, :].reshape(steps, V, N_LIMBS)
    d_s = digs.reshape(W4, steps, V).transpose(0, 1)  # (steps, W4, V)
    s_s = signs.reshape(W4, steps, V).transpose(0, 1)

    tbl = ec.identity((W4, V, B4), device=dev)
    b_idx = torch.arange(B4, dtype=digs.dtype, device=dev)
    for t in range(steps):
        qx = px[t].expand(W4, V, N_LIMBS)
        qy = _neg_y(py[t].expand(W4, V, N_LIMBS), s_s[t])
        sel = (d_s[t][..., None] == b_idx)[..., None]  # (W4, V, B4, 1) one-hot
        cur = ec.PointP(*(torch.where(sel, a, 0).sum(dim=2, dtype=LIMB_DTYPE) for a in tbl))
        new = ec.madd(cur, qx, qy)
        tbl = ec.PointP(*(torch.where(sel, nw[:, :, None], a) for nw, a in zip(new, tbl)))
    buckets = ec.PointP(*(a[:, 0] for a in _lane_halve(tbl)))  # (W4, B4)
    return _fold_windows(_weighted_windows(buckets), C4)
