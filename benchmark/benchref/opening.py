"""The check of a proof's evaluations and its SHPLONK opening, with tau
known, on plain integers and NumPy.

The hooks hand over, of one proof: every opened polynomial (Montgomery
coefficient limbs, keyed by its label), each query's point and claimed
value, the challenges v and u, the quotient's chunks, SHPLONK's h and W
polynomials with the points committed for them, the points the transcript
took and the key's commitments. The reference evaluates every polynomial
itself, at tau and at each of its points, and counts:

  eval_bad    claimed values that differ from the polynomial's value at
              the query's point;
  commit_bad  polynomials whose commitment [p(tau)] G1 is not among the
              proof's or the key's points (the quotient's chunks too), and
              a combined quotient that is not sum_a x^(n a) h_a;
  opening_bad the SHPLONK relations that fail at tau:
              h(tau) = sum_i (comb_i(tau) - r_i(tau)) / Z_{S_i}(tau),
              [h(tau)] G1 = H, [w(tau)] G1 = W, and
              (tau - u) w(tau) = sum_i Z_{T \\ S_i}(u) (comb_i(tau) - r_i(u))
                                 - Z_T(u) h(tau),
              where poly j (in the order of first query) weighs v^j, comb_i
              sums the polys whose point set is S_i, r_i interpolates their
              combined claimed values over S_i and T is every point: the
              pairing check e(W, [tau] G2) = e(u W + L, G2) with tau known.

Evaluating many polynomials at a few points is one integer product: with
the coefficient's 16-bit limbs c_kl and the 16-bit digits d_km of
t_k = z^k 2^-256 mod r, p(z) = sum_lm 2^(16 (l + m)) sum_k c_kl d_km, and
every sum_k over a block of rows is exact in float64 (under 2^53), so a
BLAS matrix product does the work.
"""
from __future__ import annotations

import numpy as np

from . import curve
from .field import MONT_R_INV, R

BLOCK = 1 << 13  # rows a product: 2^13 * (2^16)^2 < 2^53


def _digits(z: int, n: int) -> np.ndarray:
    """(n, 16) 16-bit digits of z^k 2^-256 mod r, k < n."""
    vals, t = [], MONT_R_INV
    for _ in range(n):
        vals.append(t)
        t = t * z % R
    return np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), dtype="<u2").reshape(n, 16)


def eval_many(arrays: list, points: list[int]) -> list[list[int]]:
    """[[p_j(z) for z in points] for each array]: arrays are (m_j, 16) limb
    columns of Montgomery coefficients (any integer dtype)."""
    n = max(len(a) for a in arrays)
    k = len(points)
    digits = np.concatenate([_digits(z, n) for z in points], axis=1).astype(np.float64)  # (n, 16 k)
    acc = np.zeros((len(arrays) * 16, 16 * k), dtype=np.int64)
    for k0 in range(0, n, BLOCK):
        k1 = min(n, k0 + BLOCK)
        a = np.zeros((len(arrays) * 16, k1 - k0), dtype=np.float64)
        for j, arr in enumerate(arrays):
            if k0 < len(arr):
                part = np.asarray(arr[k0:k1])
                a[16 * j:16 * j + 16, :len(part)] = part.T
        acc += (a @ digits[k0:k1]).astype(np.int64)
    # acc[16 j + l, 16 i + m] = sum_k c_kl d_km: fold l + m into one power
    acc = acc.reshape(len(arrays), 16, k, 16)
    folded = np.zeros((len(arrays), k, 31), dtype=np.int64)
    for l in range(16):
        folded[:, :, l:l + 16] += acc[:, l, :, :]
    out = []
    for j in range(len(arrays)):
        row = []
        for i in range(k):
            v = 0
            for s in range(30, -1, -1):
                v = (v << 16) + int(folded[j, i, s])
            row.append(v % R)
        out.append(row)
    return out


def _z(points, z: int) -> int:
    acc = 1
    for t in points:
        acc = acc * (z - t) % R
    return acc


def _interp_at(points, values, z: int) -> int:
    """The polynomial through (points, values), at z (Lagrange's form)."""
    total = 0
    for i, (xi, yi) in enumerate(zip(points, values)):
        num = den = 1
        for j, xj in enumerate(points):
            if j != i:
                num = num * (z - xj) % R
                den = den * (xi - xj) % R
        total += yi * num * pow(den, -1, R)
    return total % R


def _g1(s: int):
    return curve.mul(curve.G1, s)


def check_proof(rec: dict, tau: int, pool=None) -> dict:
    """{eval_bad, commit_bad, opening_bad} of one proof's record."""
    if "queries" not in rec or len(rec["commits"]) != 2 or rec["h_chunks"] is None:
        return {"eval_bad": 0, "commit_bad": 0, "opening_bad": 1}  # the opening was never seen whole
    labels, queries, v, u = rec["labels"], rec["queries"], rec["v"], rec["u"]
    order = list(dict.fromkeys(labels))  # polys in the order of first query
    pts_of = {lab: [] for lab in order}
    for lab, (pt, _val) in zip(labels, queries):
        if pt not in pts_of[lab]:
            pts_of[lab].append(pt)
    points = [tau] + list(dict.fromkeys(pt for pt, _ in queries))
    where = {z: i for i, z in enumerate(points)}
    (h_arr, h_pt), (w_arr, w_pt) = rec["commits"]
    arrays = [rec["polys"][lab] for lab in order] + list(rec["h_chunks"]) + [h_arr, w_arr]
    vals = eval_many(arrays, points)
    at = {lab: vals[j] for j, lab in enumerate(order)}
    chunks_tau = [row[0] for row in vals[len(order):len(order) + len(rec["h_chunks"])]]
    h_tau, w_tau = vals[-2][0], vals[-1][0]

    eval_bad = sum(at[lab][where[pt]] != val % R for lab, (pt, val) in zip(labels, queries))

    # every polynomial's commitment is a point of the proof or of its key
    committed = [lab for lab in order if lab[0] != "h"]
    scalars = [at[lab][0] for lab in committed] + chunks_tau + [h_tau, w_tau]
    pts = pool.map(_g1, scalars, chunksize=16) if pool is not None else [_g1(s) for s in scalars]
    known = set(rec["written"]) | set(rec["key_points"])
    commit_bad = sum(p not in known for p in pts[:len(committed) + len(chunks_tau)])
    h_lab = [lab for lab in order if lab[0] == "h"]
    if h_lab:  # the opened quotient is sum_a (x^n)^a h_a
        (x,) = pts_of[h_lab[0]]
        xn, comb = pow(x, rec["n"], R), 0
        for c in reversed(chunks_tau):
            comb = (comb * xn + c) % R
        commit_bad += at[h_lab[0]][0] != comb

    # SHPLONK at tau: groups of polys by their point sets, in the order of
    # the points' first appearance
    t_all = points[1:]
    groups: dict[tuple, list] = {}
    for j, lab in enumerate(order):
        key = tuple(p for p in t_all if p in pts_of[lab])
        groups.setdefault(key, []).append((j, lab))
    value = {(lab, pt): val % R for lab, (pt, val) in zip(labels, queries)}
    h_want, l_tau = 0, 0
    for key, members in groups.items():
        comb_tau, combined = 0, []
        for j, lab in members:
            comb_tau = (comb_tau + pow(v, j, R) * at[lab][0]) % R
        for p in key:
            combined.append(sum(pow(v, j, R) * value[(lab, p)] for j, lab in members) % R)
        h_want = (h_want + (comb_tau - _interp_at(key, combined, tau)) * pow(_z(key, tau), -1, R)) % R
        others = [t for t in t_all if t not in key]
        l_tau = (l_tau + _z(others, u) * (comb_tau - _interp_at(key, combined, u))) % R
    l_tau = (l_tau - _z(t_all, u) * h_tau) % R
    opening_bad = int(h_tau != h_want) + int(pts[-2] != h_pt) + int(pts[-1] != w_pt)
    opening_bad += int((tau - u) * w_tau % R != l_tau)
    return {"eval_bad": eval_bad, "commit_bad": commit_bad, "opening_bad": opening_bad}
