"""SHPLONK (BDFG21) multiopen — prover and verifier halves.

The reference halo2 fork ships both GWC19 and SHPLONK/BDFG21 multiopen
strategies (Cargo.lock halo2_proofs features; scroll uses SHPLONK for the
inner/compression layers and GWC for the EVM-facing layer). prover.py's
phase 6 and verifier.py's final fold dispatch here when the protocol says
`multiopen == "shplonk"`.

Scheme (self-consistent transcript; our protocol, not halo2 byte-parity):
  after the evals are written and v is squeezed,
    - every queried poly f_j gets weight v^j (global order = query order);
      polys are grouped by their exact point set S_i
    - h = sum_i (comb_i - r_i) / Z_{S_i}   (r_i = interpolation of comb_i's
      values over S_i; the division is exact, one linear-factor division
      per point via ops/poly.kzg_quotient_mont)
    - write H = commit(h); squeeze u
    - L(X) = sum_i Z_{T\\S_i}(u) * (comb_i(X) - r_i(u)) - Z_T(u) * h(X)
      (T = union of all points); L(u) = 0 by construction
    - write W = commit(L / (X - u))
  verification: e(W, [s]G2) == e(u*W + L_com, G2) with
    L_com = sum_i Z_{T\\S_i}(u) * (Com_i - [r_i(u)]G) - Z_T(u) * H
  — the same (lhs, rhs) deferred-pairing shape as GWC, so the KZG
  accumulator fold and the EVM pairing check are scheme-agnostic.

Proof cost: 2 G1 points total vs GWC's one per distinct point (5 here).
"""
from __future__ import annotations

import torch

from ...curves.bn254_curve import G1, g1_generator
from ...fields.bn254 import FR_MOD
from ...fields.limbs import FR_LIMB
from ...ops import field_ops as fo
from ...ops import poly as poly_ops

F = FR_LIMB


# --- shared grouping --------------------------------------------------------


def query_labels(qs, m: int, n_chunks: int, n_lookups: int) -> list[tuple]:
    """Structural identity label per query, parallel to the canonical query
    order both prover.py and verifier.py construct. Labels — not object
    identity — key the grouping: two all-zero fixed columns would both
    commit to the identity (None) and must still stay distinct polys."""
    labels = [("advice", c) for c, _ in qs.advice]
    labels += [("fixed", c) for c, _ in qs.fixed]
    labels += [("sigma", j) for j in range(m)]
    for a in range(n_chunks):
        labels += [("permz", a)] * (3 if a < n_chunks - 1 else 2)
    for li in range(n_lookups):
        labels += [("lkz", li), ("lkz", li), ("lka", li), ("lka", li), ("lks", li)]
    labels.append(("random", 0))
    labels.append(("h", 0))
    return labels


def group_queries(queries, labels):
    """queries: [(obj, point, value)] in the canonical shared order (obj is
    a device poly on the prover side, a G1 commitment on the verifier
    side); labels: query_labels(...) output, parallel to queries.

    Returns (groups, pt_order): groups is a list of
    (points_tuple, [(obj, vpow_index, {point: value})]) with v-powers
    assigned by global first-appearance order of each poly; pt_order is the
    global first-appearance order of points (T)."""
    assert len(labels) == len(queries), (len(labels), len(queries))
    pt_order: list[int] = []
    polys: list[list] = []  # [obj, [(point, value)...]]
    index: dict[tuple, int] = {}  # label -> polys index
    for (obj, point, value), lab in zip(queries, labels):
        if point not in pt_order:
            pt_order.append(point)
        i = index.get(lab)
        if i is None:
            index[lab] = len(polys)
            polys.append([obj, []])
            i = len(polys) - 1
        polys[i][1].append((point, value))

    groups: list[tuple] = []
    by_key: dict[tuple, int] = {}
    for j, (obj, pv) in enumerate(polys):
        pts = set(p for p, _ in pv)
        key = tuple(p for p in pt_order if p in pts)
        if key not in by_key:
            by_key[key] = len(groups)
            groups.append((key, []))
        groups[by_key[key]][1].append((obj, j, dict(pv)))
    return groups, pt_order


def _interp(points: tuple, values: list[int]) -> list[int]:
    """Lagrange interpolation -> coefficient list (degree < len(points))."""
    k = len(points)
    coeffs = [0] * k
    for i, (xi, yi) in enumerate(zip(points, values)):
        # basis poly prod_{j!=i} (X - xj) / (xi - xj)
        basis = [1]
        den = 1
        for j, xj in enumerate(points):
            if j == i:
                continue
            nxt = [0] * (len(basis) + 1)
            for d, c in enumerate(basis):
                nxt[d + 1] = (nxt[d + 1] + c) % FR_MOD
                nxt[d] = (nxt[d] - c * xj) % FR_MOD
            basis = nxt
            den = den * (xi - xj) % FR_MOD
        scale = yi * pow(den, -1, FR_MOD) % FR_MOD
        for d, c in enumerate(basis):
            coeffs[d] = (coeffs[d] + c * scale) % FR_MOD
    return coeffs


def _eval_host(coeffs: list[int], z: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % FR_MOD
    return acc


def _z_at(points, z: int) -> int:
    acc = 1
    for t in points:
        acc = acc * ((z - t) % FR_MOD) % FR_MOD
    return acc


# --- prover half -------------------------------------------------------------


def _axpy_pad(a_int: int, x, y, mont_scalar):
    """y + a*x with length padding (device)."""
    if y is None:
        y = torch.zeros_like(x)
    if x.shape[0] < y.shape[0]:
        x = torch.cat([x, x.new_zeros(y.shape[0] - x.shape[0], x.shape[1])])
    elif y.shape[0] < x.shape[0]:
        y = torch.cat([y, y.new_zeros(x.shape[0] - y.shape[0], y.shape[1])])
    return poly_ops.axpy_mont(F, mont_scalar(a_int), x, y)


def shplonk_open(
    srs, queries, labels, v_ch: int, tr, kzg_commit, mont_scalar, encode_mont
):
    """Prover phase 6 (SHPLONK). Writes H and W to the transcript."""
    groups, pt_order = group_queries(queries, labels)

    combs = []  # per group: (points, comb_poly_dev, {point: combined value})
    for points, members in groups:
        comb = None
        vals = {p: 0 for p in points}
        for obj, j, pv in members:
            if hasattr(obj, "get"):  # lazy coefficient column (prover._LazyPoly)
                obj = obj.get()
            vj = pow(v_ch, j, FR_MOD)
            comb = _axpy_pad(vj, obj, comb, mont_scalar)
            for p in points:
                vals[p] = (vals[p] + vj * pv[p]) % FR_MOD
        combs.append((points, comb, vals))

    h = None
    for points, comb, vals in combs:
        r = _interp(points, [vals[p] for p in points])
        num = fo.sub_mod(F, comb, _pad_coeffs(r, comb.shape[0], encode_mont))
        for p in points:
            num = poly_ops.kzg_quotient_mont(F, num, mont_scalar(p))
        h = _axpy_pad(1, num, h, mont_scalar)
    tr.write_point(kzg_commit(srs, h))

    u = tr.squeeze_challenge()

    L = None
    const = 0
    for points, comb, vals in combs:
        others = [t for t in pt_order if t not in points]
        zi_u = _z_at(others, u)
        L = _axpy_pad(zi_u, comb, L, mont_scalar)
        r = _interp(points, [vals[p] for p in points])
        const = (const + zi_u * _eval_host(r, u)) % FR_MOD
    zt_u = _z_at(pt_order, u)
    L = _axpy_pad(FR_MOD - zt_u, h, L, mont_scalar)
    # subtract the constant sum_i Z_i(u) r_i(u)
    cvec = [FR_MOD - const] + [0] * (L.shape[0] - 1)
    L = fo.add_mod(F, L, _pad_coeffs(cvec, L.shape[0], encode_mont))
    W = poly_ops.kzg_quotient_mont(F, L, mont_scalar(u))
    tr.write_point(kzg_commit(srs, W))


def _pad_coeffs(coeffs: list[int], n: int, encode_mont):
    return encode_mont(list(coeffs) + [0] * (n - len(coeffs)))


# --- verifier half ------------------------------------------------------------


def shplonk_fold(queries, labels, v_ch: int, tr):
    """Verifier final fold (SHPLONK). Reads H/W; returns (lhs, rhs, u) G1
    pairing inputs: accept iff e(lhs, [s]G2) == e(rhs, G2)."""
    groups, pt_order = group_queries(queries, labels)

    H = tr.read_point()
    u = tr.squeeze_challenge()
    W = tr.read_point()

    g = g1_generator()
    L_com = None
    const = 0
    for points, members in groups:
        com_i = None
        vals = {p: 0 for p in points}
        for obj, j, pv in members:
            vj = pow(v_ch, j, FR_MOD)
            com_i = G1.add(com_i, obj if vj == 1 else G1.mul(obj, vj))
            for p in points:
                vals[p] = (vals[p] + vj * pv[p]) % FR_MOD
        others = [t for t in pt_order if t not in points]
        zi_u = _z_at(others, u)
        r = _interp(points, [vals[p] for p in points])
        const = (const + zi_u * _eval_host(r, u)) % FR_MOD
        L_com = G1.add(L_com, G1.mul(com_i, zi_u))
    zt_u = _z_at(pt_order, u)
    L_com = G1.add(L_com, G1.neg(G1.mul(g, const)))
    L_com = G1.add(L_com, G1.neg(G1.mul(H, zt_u)))

    lhs = W
    rhs = G1.add(G1.mul(W, u), L_com)
    return lhs, rhs, u
