"""PLONKish prover: device NTT/MSM/scans + host orchestration (PyTorch).

Protocol (halo2-shaped; verifier.py mirrors it exactly):
  1. absorb vk digest + declared instance values; commit advice columns
  2. theta; per lookup commit permuted (A', S')
  3. beta, gamma; commit permutation grand-product chunks Z_a and lookup Zs
  4. commit random poly; y; build quotient h on the extended coset domain,
     commit chunks
  5. x; write evals of all queried polys at their rotations
  6. v; GWC (or SHPLONK) multiopen

This is the JAX package's fully resident path, on the device of the SRS:
every column stays on the card from assignment to opening, and the quotient
runs on the full extended domain (`_quotient_full`). Proof bytes are
identical to the JAX package's for the same seed.
"""
from __future__ import annotations

import hashlib
import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from ...fields.bn254 import FR_MOD
from ...fields.limbs import (
    FR_LIMB, N_LIMBS, ints_to_limbs, ints_to_packed, limbs_to_torch, packed_to_ints, pack_host,
    limbs_from_torch, objcol_to_packed, unpack_host,
)
from ...ops import field_ops as fo
from ...ops import poly as poly_ops
from ..kzg import SRS, kzg_commit, kzg_commit_batch
from ..transcript import PoseidonTranscript
from .cs import ConstraintSystem
from .keygen import DELTA, ProvingKey
from .mock import _pad_instance

F = FR_LIMB
log = logging.getLogger(__name__)

# field elements per batched NTT group (2^22 = 256 MiB of int32 limbs)
NTT_BATCH_BUDGET = 1 << 22


def _encode_mont(vals, device) -> torch.Tensor:
    """Host ints, an object column or packed (n, 8) uint32 words -> (n, 16)
    Montgomery limbs on `device` (one to_mont product there)."""
    if isinstance(vals, np.ndarray) and vals.dtype == np.uint32 and vals.ndim == 2:
        std = unpack_host(vals) if vals.shape[1] == N_LIMBS // 2 else vals
    else:
        std = unpack_host(objcol_to_packed(vals))
    return fo.to_mont(F, limbs_to_torch(std, device))


def _mont_scalar(v: int, device) -> torch.Tensor:
    return limbs_to_torch(ints_to_limbs([int(v) % FR_MOD * (1 << 256) % FR_MOD])[0], device)


def _bcast(s: torch.Tensor, n: int) -> torch.Tensor:
    return s[None, :].expand(n, s.shape[-1])


def _blind(seed: bytes, tag: str, count: int) -> list[int]:
    out = []
    for i in range(count):
        h = hashlib.sha256(seed + tag.encode() + i.to_bytes(4, "big")).digest()
        out.append(int.from_bytes(h, "little") % FR_MOD)
    return out


def _blind_packed(seed: bytes, tag: str, count: int) -> np.ndarray:
    return ints_to_packed(_blind(seed, tag, count))


@dataclass
class _Queries:
    """Canonical query orders shared by prover and verifier."""

    advice: list[tuple[int, int]]
    fixed: list[tuple[int, int]]
    instance: list[tuple[int, int]]

    @classmethod
    def from_cs(cls, cs: ConstraintSystem) -> "_Queries":
        adv, fix, inst = set(), set(), set()
        exprs = [e for _, e in cs.gates]
        for lk in cs.lookups:
            exprs += lk.inputs + lk.tables
        for e in exprs:
            for kind, col, rot in e.queries():
                {"advice": adv, "fixed": fix, "instance": inst}[kind].add((col, rot))
        for c in cs.perm_columns:  # permutation argument queries rot 0
            {"advice": adv, "fixed": fix, "instance": inst}[c.kind].add((c.index, 0))
        return cls(sorted(adv), sorted(fix), sorted(inst))


def _ntt_group(n: int) -> int:
    """Columns per batched NTT: the stacked group stays near the budget."""
    return max(1, NTT_BATCH_BUDGET // max(n, 1))


def _intt_cols(dom, cols) -> list:
    """Batched inverse NTT over same-length columns."""
    cols = list(cols)
    out: list = []
    g = _ntt_group(dom.n)
    for i in range(0, len(cols), g):
        grp = cols[i : i + g]
        if len(grp) == 1:
            out.append(dom.intt(grp[0]))
        else:
            out.extend(dom.intt_batch(torch.stack(grp)).unbind(0))
    return out


def _n_h(cs: ConstraintSystem, dom) -> int:
    """Quotient piece count: deg(h) < (d-1)n for term-degree budget d."""
    d = max(cs.max_gate_degree(), 5)
    return min(dom.extended_n // dom.n, max(1, d - 1))


def _perm_chunks(cs: ConstraintSystem) -> int:
    return max(1, max(cs.max_gate_degree(), 5) - 2)


def absorb_instances(tr, vk, instance) -> None:
    """Shared prover/verifier transcript preamble: vk digest, then per
    instance column its declared length and values."""
    tr.common_scalar(vk.transcript_repr())
    for col in range(vk.cs.num_instance):
        src = instance[col] if instance and col < len(instance) else []
        tr.common_scalar(len(src))
        for v in src:
            tr.common_scalar(int(v) % FR_MOD)


def prove(
    srs: SRS,
    pk: ProvingKey,
    circuit,
    instance,
    transcript_cls=PoseidonTranscript,
    seed: bytes | None = None,
    multiopen: str = "gwc",
) -> bytes:
    """Prove `circuit` on the SRS's device. A fixed `seed` (deterministic
    blinding) is for tests only; by default every proof draws fresh entropy."""
    if seed is None:
        import os

        seed = os.urandom(32)
    device = srs.device
    vk = pk.vk
    cs: ConstraintSystem = vk.cs
    dom = vk.domain
    n = dom.n
    usable = cs.usable_rows(n)
    u = usable - 1
    omega = dom.omega
    enc = lambda vals: _encode_mont(vals, device)  # noqa: E731
    msc = lambda v: _mont_scalar(v, device)  # noqa: E731

    _t0 = time.perf_counter()

    def _mark(msg):
        log.info("prove[%s] %.1fs", msg, time.perf_counter() - _t0)

    inst = _pad_instance(cs, n, instance)
    tables = circuit.assign(cs, n, inst)
    advice_vals = []
    for i in range(cs.num_advice):
        col = [int(v) % FR_MOD for v in tables["advice"][i]]
        col[usable:] = _blind(seed, f"adv{i}", n - usable)
        advice_vals.append(col)

    tr = transcript_cls()
    absorb_instances(tr, vk, instance)

    # --- device value tables (base domain, Montgomery form) ---------------
    advice_dev = [enc(col) for col in advice_vals]
    fixed_dev = _fixed_dev(pk, device)
    inst_dev = [enc([int(v) for v in inst[i]]) for i in range(cs.num_instance)]
    vals_dev = {"advice": advice_dev, "fixed": fixed_dev, "instance": inst_dev}
    ones_n = fo.one_mont(F, (n,), device=device)

    def eval_expr_dev(expr, theta: int):
        """Evaluate an expression over full columns on device -> (n, 16)."""
        theta_b = _bcast(msc(theta), n)

        def q(kind, col, rot):
            arr = vals_dev[kind][col]
            return torch.roll(arr, -rot, dims=0) if rot else arr

        return expr.evaluate(
            constant=lambda c: _bcast(msc(c), n),
            query=q,
            challenge=lambda i: theta_b,
            add=lambda a, b: fo.add_mod(F, a, b),
            mul=lambda a, b: fo.mont_mul(F, a, b),
            neg=lambda a: fo.neg_mod(F, a),
        )

    # --- phase 1: advice commitments -------------------------------------
    advice_polys = _intt_cols(dom, advice_dev)
    for c in kzg_commit_batch(srs, advice_polys):
        tr.write_point(c)

    _mark("advice committed")
    theta = tr.squeeze_challenge()

    # --- phase 2: lookups -------------------------------------------------
    def compress_dev(exprs):
        acc = None
        theta_b = _bcast(msc(theta), n)
        for e in exprs:
            v = eval_expr_dev(e, theta)
            acc = v if acc is None else fo.mont_mul_add(F, acc, theta_b, v)
        return acc

    _zpad = lambda m_: np.zeros((m_, 8), np.uint32)  # noqa: E731

    lookups = []
    for li, lk in enumerate(cs.lookups):
        a_dev = compress_dev(lk.inputs)
        s_dev = compress_dev(lk.tables)
        a_vals = np.concatenate([_decode_mont_packed(a_dev, usable), _zpad(n - usable)])
        s_vals = np.concatenate([_decode_mont_packed(s_dev, usable), _zpad(n - usable)])
        # grand product (hence multiset equality) covers rows 0..u-1
        a_perm, s_perm = _permute_lookup_packed(a_vals[:u], s_vals[:u])
        lookups.append({
            "a_dev": a_dev,
            "s_dev": s_dev,
            "a_perm": np.concatenate([a_perm, _blind_packed(seed, f"lkA{li}", n - u)]),
            "s_perm": np.concatenate([s_perm, _blind_packed(seed, f"lkS{li}", n - u)]),
        })
    for lk in lookups:
        lk["a_perm_dev"] = enc(lk["a_perm"])
        lk["s_perm_dev"] = enc(lk["s_perm"])
    lk_polys = _intt_cols(
        dom, [d for lk in lookups for d in (lk["a_perm_dev"], lk["s_perm_dev"])]
    )
    for i, lk in enumerate(lookups):
        lk["a_poly"] = lk_polys[2 * i]
        lk["s_poly"] = lk_polys[2 * i + 1]
    for c in kzg_commit_batch(srs, lk_polys):
        tr.write_point(c)

    _mark("lookups committed")
    beta = tr.squeeze_challenge()
    gamma = tr.squeeze_challenge()

    # --- phase 3: grand products (device scans + batched inversion) -------
    beta_b = _bcast(msc(beta), n)
    gamma_b = _bcast(msc(gamma), n)
    om_pows_dev = poly_ops.powers_mont(F, msc(omega), n)
    row_idx = torch.arange(n, device=device)

    def grand_product(num_dev, den_dev, z0_dev):
        """z[0] = z0; z[i+1] = z[i] * num[i]/den[i] for i < u; rows > u are
        z[u] (overwritten by blinding later). Returns (z_dev, z_u_dev)."""
        ratio = fo.mont_mul(F, num_dev, fo.batch_inv_mont(F, den_dev))
        ratio = fo.select(row_idx < u, ratio, ones_n)
        pp = poly_ops.prefix_prod_mont(F, ratio)
        shifted = torch.cat([ones_n[:1], pp[:-1]])
        z = fo.mont_mul(F, z0_dev, shifted)
        z_u = fo.mont_mul(F, z0_dev, pp[u - 1]) if u > 0 else z0_dev
        return z, z_u

    def with_blinding(z_dev, tag: str):
        z_dev = z_dev.clone()
        z_dev[u + 1 :] = enc(_blind(seed, tag, n - u - 1))
        return z_dev

    chunk_len = _perm_chunks(cs)
    m = len(cs.perm_columns)
    chunks = [list(range(a, min(a + chunk_len, m))) for a in range(0, m, chunk_len)]
    sigma_dev = _sigma_dev(pk)

    perm_z_devs = []
    last_z = fo.one_mont(F, device=device)
    for chunk in chunks:
        num = ones_n
        den = ones_n
        for jj in chunk:
            cref = cs.perm_columns[jj]
            v = vals_dev[cref.kind][cref.index]
            dj = msc(beta * pow(DELTA, jj, FR_MOD) % FR_MOD)
            num = fo.mont_mul(
                F, num, fo.add_mod(F, fo.mont_mul_add(F, dj, om_pows_dev, v), gamma_b)
            )
            den = fo.mont_mul(
                F, den,
                fo.add_mod(F, fo.mont_mul_add(F, beta_b, sigma_dev[jj], v), gamma_b),
            )
        z, last_z = grand_product(num, den, last_z)
        perm_z_devs.append(with_blinding(z, f"permz{len(perm_z_devs)}"))

    lookup_z_devs = []
    one_sc = fo.one_mont(F, device=device)
    for li, lk in enumerate(lookups):
        num = fo.mont_mul(F, fo.add_mod(F, lk["a_dev"], beta_b), fo.add_mod(F, lk["s_dev"], gamma_b))
        den = fo.mont_mul(
            F, fo.add_mod(F, lk["a_perm_dev"], beta_b), fo.add_mod(F, lk["s_perm_dev"], gamma_b)
        )
        z, _ = grand_product(num, den, one_sc)
        lookup_z_devs.append(with_blinding(z, f"lkz{li}"))

    # one commit chain for perm Zs + lookup Zs + the random poly: no
    # challenge is squeezed between these transcript writes
    perm_z_polys = _intt_cols(dom, perm_z_devs)
    lookup_z_polys = _intt_cols(dom, lookup_z_devs)
    random_poly = dom.intt(enc(_blind(seed, "rand", n)))
    for c in kzg_commit_batch(srs, perm_z_polys + lookup_z_polys + [random_poly]):
        tr.write_point(c)

    # --- phase 4: vanishing / quotient ------------------------------------
    _mark("grand products committed")
    y = tr.squeeze_challenge()

    instance_polys = _intt_cols(dom, inst_dev)
    # release base-domain value tables before the extended-domain walk
    vals_dev = advice_dev = inst_dev = fixed_dev = None
    perm_z_devs = lookup_z_devs = None
    for lk in lookups:
        for key in ("a_dev", "s_dev", "a_perm_dev", "s_perm_dev"):
            lk.pop(key, None)
    h_chunk_polys = _build_quotient(
        pk, dom, cs, advice_polys, list(pk.fixed_polys), instance_polys,
        pk.sigma_polys, perm_z_polys, lookups, lookup_z_polys,
        chunks, theta, beta, gamma, y, u, device,
    )
    _mark("quotient built")
    for c in kzg_commit_batch(srs, h_chunk_polys):
        tr.write_point(c)
    _mark("quotient committed")

    x = tr.squeeze_challenge()

    # --- phase 5: evaluations --------------------------------------------
    qs = _Queries.from_cs(cs)

    xw = x * omega % FR_MOD
    xwi = x * pow(omega, -1, FR_MOD) % FR_MOD
    xu = x * pow(omega, u, FR_MOD) % FR_MOD

    plan5: list[tuple] = []  # (poly, point, write_to_transcript)

    def emit(polyc, point, write=True):
        plan5.append((polyc, point, write))

    for col, rot in qs.advice:
        emit(advice_polys[col], _rot_point(x, omega, rot))
    for col, rot in qs.fixed:
        emit(pk.fixed_polys[col], _rot_point(x, omega, rot))
    for j in range(m):
        emit(pk.sigma_polys[j], x)
    for a, zp in enumerate(perm_z_polys):
        emit(zp, x)
        emit(zp, xw)
        if a < len(perm_z_polys) - 1:
            emit(zp, xu)
    for li, zp in enumerate(lookup_z_polys):
        emit(zp, x)
        emit(zp, xw)
        emit(lookups[li]["a_poly"], x)
        emit(lookups[li]["a_poly"], xwi)
        emit(lookups[li]["s_poly"], x)
    emit(random_poly, x)

    # h_combined: linear combo of chunks with x^{n a}; opened at x (value not
    # written — the verifier recomputes it from the constraint system)
    xn = pow(x, n, FR_MOD)
    h_comb = h_chunk_polys[0]
    wpow = 1
    for a in range(1, len(h_chunk_polys)):
        wpow = wpow * xn % FR_MOD
        h_comb = poly_ops.axpy_mont(F, msc(wpow), h_chunk_polys[a], h_comb)
    emit(h_comb, x, write=False)

    # one powers table per distinct point, shared by every opening there
    pw_tables: dict[int, torch.Tensor] = {}
    for _, pt, _w in plan5:
        if pt not in pw_tables:
            pw_tables[pt] = _coset_x_outer(1, 1, n, dom.k, device, base=pt)
    ev_dev = [poly_ops.eval_poly_with_powers(F, p, pw_tables[pt]) for p, pt, _ in plan5]
    ev_vals = F.decode(limbs_from_torch(torch.stack(ev_dev)))
    del pw_tables
    queries: list[tuple] = []  # (poly, point, value)
    for (p, pt, write), v in zip(plan5, ev_vals):
        v = int(v)
        if write:
            tr.write_scalar(v)
        queries.append((p, pt, v))

    _mark("evals written")
    v_ch = tr.squeeze_challenge()

    if multiopen == "shplonk":
        from .multiopen import query_labels, shplonk_open

        labels = query_labels(qs, m, len(chunks), len(lookups))
        shplonk_open(srs, queries, labels, v_ch, tr, kzg_commit, msc, enc)
        _mark("multiopen done (shplonk)")
        return tr.finalize()

    # --- phase 6: GWC multiopen ------------------------------------------
    points_order: list[int] = []
    for _, point, _ in queries:
        if point not in points_order:
            points_order.append(point)
    wit_polys = []
    for point in points_order:
        group = [(p, val) for (p, pt, val) in queries if pt == point]
        comb = _combine(group, v_ch, device)
        wit_polys.append(poly_ops.kzg_quotient_mont(F, comb, msc(point)))
    for c in kzg_commit_batch(srs, wit_polys):
        tr.write_point(c)

    _mark("multiopen done")
    return tr.finalize()


# --- per-pk device caches (encode fixed/sigma value tables once) -------------


def _fixed_dev(pk: ProvingKey, device):
    cache = getattr(pk, "_fixed_dev", None)
    if cache is None:
        cache = pk._fixed_dev = [_encode_mont(col, device) for col in pk.fixed_values]
    return cache


def _sigma_dev(pk: ProvingKey):
    cache = getattr(pk, "_sigma_dev", None)
    if cache is None:
        cache = pk._sigma_dev = [pk.sigma_col_mont(j) for j in range(len(pk.sigma_values))]
    return cache


def _combine(group, v_ch, device):
    """sum_i v^i f_i over (poly, eval) pairs; f_0 gets v^0. Stacked in
    chunks of NTT_BATCH_BUDGET elements: one product by the v-power column
    and one halving tree-sum per chunk."""
    maxlen = max(p.shape[0] for p, _ in group)
    batch = max(1, NTT_BATCH_BUDGET // max(maxlen, 1))
    vpows, vp = [], 1
    for _ in group:
        vpows.append(vp)
        vp = vp * v_ch % FR_MOD
    acc = None
    for b0 in range(0, len(group), batch):
        chunk = group[b0 : b0 + batch]
        padded = []
        for polyc, _ in chunk:
            if polyc.shape[0] < maxlen:
                polyc = torch.cat([polyc, polyc.new_zeros(maxlen - polyc.shape[0], N_LIMBS)])
            padded.append(polyc)
        stacked = torch.stack(padded)  # (B, n, 16)
        vp_m = _encode_mont(vpows[b0 : b0 + batch], device)  # (B, 16)
        weighted = fo.mont_mul_big(F, stacked, vp_m[:, None, :])
        part = poly_ops.sum_mont(F, weighted)
        acc = part if acc is None else fo.add_mod(F, acc, part)
    return acc


def _rot_point(x: int, omega: int, rot: int) -> int:
    if rot >= 0:
        return x * pow(omega, rot, FR_MOD) % FR_MOD
    return x * pow(pow(omega, -1, FR_MOD), -rot, FR_MOD) % FR_MOD


def _decode_mont_packed(arr, count: int | None = None) -> np.ndarray:
    """(n, 16) Montgomery device tensor -> host (count, 8) packed uint32
    words in standard form."""
    std = fo.from_mont(F, arr if count is None else arr[:count])
    return pack_host(limbs_from_torch(std))


def _permute_lookup_packed(a: np.ndarray, s: np.ndarray):
    """Vectorized halo2 lookup permutation over packed (u, 8) uint32 rows:
    A' value-sorted; each first occurrence of an A'-run aligned with one
    matching S' entry; leftovers fill the rest."""
    u = a.shape[0]
    order_a = np.lexsort(tuple(a[:, w] for w in range(a.shape[1])))
    a_perm = a[order_a]
    first = np.empty(u, dtype=bool)
    first[0] = True
    np.any(a_perm[1:] != a_perm[:-1], axis=1, out=first[1:])
    distinct = a_perm[first]
    # merge distinct-A (flag 0) with S rows (flag 1), value-major sort with
    # the flag as the final minor key
    comb = np.concatenate([distinct, s])
    flag = np.concatenate(
        [np.zeros(len(distinct), np.uint32), np.ones(s.shape[0], np.uint32)]
    )
    keys = (flag,) + tuple(comb[:, w] for w in range(comb.shape[1]))
    oc = np.lexsort(keys)
    cs_rows, cf = comb[oc], flag[oc]
    run_start = np.empty(len(cs_rows), dtype=bool)
    run_start[0] = True
    np.any(cs_rows[1:] != cs_rows[:-1], axis=1, out=run_start[1:])
    run_id = np.cumsum(run_start) - 1
    n_runs = run_id[-1] + 1 if len(run_id) else 0
    has_d = np.zeros(n_runs, bool)
    has_d[run_id[cf == 0]] = True
    s_count = np.bincount(run_id[cf == 1], minlength=n_runs)
    if (has_d & (s_count == 0)).any():
        bad = np.nonzero(has_d & (s_count == 0))[0][0]
        bad_val = cs_rows[np.searchsorted(run_id, bad)]
        raise ValueError(f"lookup value {packed_to_ints(bad_val[None, :])[0]} not in table")
    left_counts = s_count - has_d.astype(np.int64)
    run_vals = cs_rows[run_start]
    leftovers = np.repeat(run_vals, left_counts, axis=0)
    s_perm = np.empty_like(a_perm)
    s_perm[first] = distinct
    s_perm[~first] = leftovers[: u - len(distinct)]
    return a_perm, s_perm


def _quotient_walk(cs, chunks, theta, beta, gamma, u, env):
    """The constraint walk: emits every gate / permutation / lookup term
    through env.fold in the canonical order the verifier folds them."""
    mm, ad, sb, neg, mad, msb = env.mm, env.ad, env.sb, env.neg, env.mad, env.msb
    const, q, roll, fold = env.const, env.q, env.roll, env.fold

    for _, expr in cs.gates:
        fold(
            expr.evaluate(
                constant=const, query=q,
                challenge=lambda i: const(theta),
                add=ad, mul=mm, neg=neg,
            )
        )

    if env.n_perm_z:
        z_vals = lambda a: env.zcol(("permz", a))  # noqa: E731
        fold(mm(env.l0, sb(env.one, z_vals(0))))
        zl = z_vals(env.n_perm_z - 1)
        fold(mm(env.llast, msb(zl, zl, zl)))
        del zl
        for a in range(1, len(chunks)):
            fold(mm(env.l0, sb(z_vals(a), roll(z_vals(a - 1), u))))
        beta_c = const(beta)
        gamma_c = const(gamma)
        for a, chunk in enumerate(chunks):
            za = z_vals(a)
            left = roll(za, 1)  # Z(omega X)
            right = za
            for jj in chunk:
                cref = cs.perm_columns[jj]
                v = q(cref.kind, cref.index, 0)
                sig = env.zcol(("sigma", jj))
                left = mm(left, ad(mad(beta_c, sig, v), gamma_c))
                idterm = mm(const(pow(DELTA, jj, FR_MOD)), env.x_vals)
                right = mm(right, ad(mad(beta_c, idterm, v), gamma_c))
            fold(mm(env.lact, sb(left, right)))

    for li, lkexprs in enumerate(cs.lookups):
        z_v = env.zcol(("lkz", li))
        a_v = env.zcol(("lka", li))
        s_v = env.zcol(("lks", li))

        def compress(exprs):
            acc = None
            for e in exprs:
                v = e.evaluate(
                    constant=const, query=q,
                    challenge=lambda i: const(theta),
                    add=ad, mul=mm, neg=neg,
                )
                acc = v if acc is None else mad(acc, const(theta), v)
            return acc

        in_v = compress(lkexprs.inputs)
        tb_v = compress(lkexprs.tables)
        beta_c = const(beta)
        gamma_c = const(gamma)
        fold(mm(env.l0, sb(env.one, z_v)))
        fold(mm(env.llast, msb(z_v, z_v, z_v)))
        lhs = mm(roll(z_v, 1), mm(ad(a_v, beta_c), ad(s_v, gamma_c)))
        rhs = mm(z_v, mm(ad(in_v, beta_c), ad(tb_v, gamma_c)))
        fold(mm(env.lact, sb(lhs, rhs)))
        a_prev = roll(a_v, -1)  # A'(omega^{-1} X)
        fold(mm(env.lact, mm(sb(a_v, s_v), sb(a_v, a_prev))))
        fold(mm(env.l0, sb(a_v, s_v)))


class _WalkEnv:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _build_quotient(
    pk, dom, cs, advice_polys, fixed_polys, instance_polys, sigma_polys,
    perm_z_polys, lookups, lookup_z_polys, chunks, theta, beta, gamma, y, u,
    device,
):
    """Evaluate all constraints on the extended coset domain, combine with y
    powers, divide by the vanishing poly, return h chunks (each (n, 16))."""
    ext_n = dom.extended_n
    n = dom.n
    ratio = ext_n // n
    lact_vals = np.zeros(n, dtype=np.int64)
    lact_vals[:u] = 1
    lact_poly = dom.intt(_encode_mont(lact_vals, device))
    by_kind = {"advice": advice_polys, "fixed": fixed_polys, "instance": instance_polys}
    zpolys = {}
    for jj in range(len(cs.perm_columns)):
        zpolys[("sigma", jj)] = sigma_polys[jj]
    for a, zp in enumerate(perm_z_polys):
        zpolys[("permz", a)] = zp
    for li, lk in enumerate(lookups):
        zpolys[("lkz", li)] = lookup_z_polys[li]
        zpolys[("lka", li)] = lk["a_poly"]
        zpolys[("lks", li)] = lk["s_poly"]

    # vanishing values (zeta^n * w_ext^(i n) - 1) cycle with period ratio
    zn = pow(dom.g_coset, n, FR_MOD)
    wn = pow(dom.extended_omega, n, FR_MOD)
    vshort, a0 = [], zn
    for _ in range(ratio):
        vshort.append(pow((a0 - 1) % FR_MOD, -1, FR_MOD))
        a0 = a0 * wn % FR_MOD

    acc_ext = _quotient_full(
        pk, dom, cs, by_kind, zpolys, lact_poly, chunks,
        theta, beta, gamma, y, u, vshort, device,
    )
    h_coeffs = dom.intt_extended(acc_ext)
    # pieces beyond the degree bound are identically zero (see _n_h)
    return [h_coeffs[a * n : (a + 1) * n] for a in range(_n_h(cs, dom))]


def _quotient_full(
    pk, dom, cs, by_kind, zpolys, lact_poly, chunks, theta, beta, gamma, y,
    u, vshort, device,
):
    """Full-domain quotient path: every queried column extended to
    2^(k+j) once (batched), the walk over whole extended columns. At k=20,
    j=3 that holds ~16 columns of 2^23 rows (512 MiB each as int32) — it
    fits the 80 GB card, which is why this path, not the JAX package's
    coset-streaming one, is the port's."""
    ext_n = dom.extended_n
    n = dom.n
    ratio = ext_n // n
    mm = lambda a, b: fo.mont_mul_big(F, a, b)  # noqa: E731
    ad = lambda a, b: fo.add_mod(F, a, b)  # noqa: E731
    sb = lambda a, b: fo.sub_mod(F, a, b)  # noqa: E731
    neg = lambda a: fo.neg_mod(F, a)  # noqa: E731
    cache: dict = {}

    def padded(polyc):
        return torch.cat([polyc, polyc.new_zeros(ext_n - polyc.shape[0], N_LIMBS)])

    def ext(polyc, tag):
        if tag not in cache:
            cache[tag] = dom.ntt_extended(padded(polyc))
        return cache[tag]

    qs = _Queries.from_cs(cs)
    plan: list[tuple] = []
    for kind in ("advice", "fixed", "instance"):
        for col in sorted({c for c, _ in getattr(qs, kind)}):
            plan.append(((kind, col), by_kind[kind][col]))
    plan += [(tag, p) for tag, p in zpolys.items()]
    plan += [("l0", pk.l0), ("l_last", pk.l_last), ("l_active", lact_poly)]
    g = _ntt_group(ext_n)
    for i in range(0, len(plan), g):
        grp = plan[i : i + g]
        if len(grp) == 1:
            ext(grp[0][1], grp[0][0])
            continue
        stacked = torch.stack([padded(p) for _, p in grp])
        for (t, _), r in zip(grp, dom.ntt_extended_batch(stacked).unbind(0)):
            cache[t] = r
        del stacked

    def q(kind, col, rot):
        e = ext(by_kind[kind][col], (kind, col))
        return torch.roll(e, -rot * ratio, dims=0) if rot else e

    def const(c):
        return _bcast(_mont_scalar(c, device), ext_n)

    # X values on the extended coset: g * w_ext^i (hi (x) lo outer product)
    x_e = _coset_x_outer(dom.g_coset, dom.extended_omega, ext_n, dom.extended_k, device)

    acc = torch.zeros((ext_n, N_LIMBS), dtype=torch.int32, device=device)
    y_c = const(y)

    def fold(t):
        nonlocal acc
        acc = fo.mont_mul_add(F, acc, y_c, t)

    env = _WalkEnv(
        mm=mm, ad=ad, sb=sb, neg=neg, const=const, q=q, fold=fold,
        mad=lambda a, b, c: fo.mont_mul_add(F, a, b, c),
        msb=lambda a, b, c: fo.mont_mul_add(F, a, b, c, sub=True),
        zcol=lambda tag: ext(zpolys[tag], tag),
        l0=ext(pk.l0, "l0"), llast=ext(pk.l_last, "l_last"),
        lact=ext(lact_poly, "l_active"),
        x_vals=x_e, one=fo.one_mont(F, (ext_n,), device=device),
        roll=lambda arr, k: torch.roll(arr, -k * ratio, dims=0),
        n_perm_z=len([1 for t in zpolys if t[0] == "permz"]),
    )
    _quotient_walk(cs, chunks, theta, beta, gamma, u, env)
    cache.clear()

    # vanishing inverse: period `ratio` over the extended domain
    vinv = _encode_mont(vshort, device).repeat(ext_n // ratio, 1)
    return mm(acc, vinv)


def _coset_x_outer(g: int, w: int, count: int, k: int, device, base: int | None = None):
    """(count, 16) Montgomery table t[i] = g * w^i (or base^i when base is
    given), as a hi (x) lo outer product of two host tables."""
    P = FR_MOD
    if base is not None:
        g, w = 1, base
    nl = 1 << (k // 2)
    nh = count // nl
    lo_ints, acc = [], g % P
    for _ in range(nl):
        lo_ints.append(acc)
        acc = acc * w % P
    w_nl = pow(w, nl, P)
    hi_ints, acc = [], 1
    for _ in range(nh):
        hi_ints.append(acc)
        acc = acc * w_nl % P
    lo_m = _encode_mont(lo_ints, device)
    hi_m = _encode_mont(hi_ints, device)
    return fo.mont_mul_big(F, hi_m[:, None, :], lo_m[None, :, :]).reshape(count, N_LIMBS)
