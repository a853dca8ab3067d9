"""PLONKish prover: device NTT/MSM/scans + host orchestration (PyTorch).

Protocol (halo2-shaped; verifier.py mirrors it exactly):
  1. absorb vk digest + declared instance values; commit advice columns
  2. theta; per lookup commit permuted (A', S')
  3. beta, gamma; commit permutation grand-product chunks Z_a and lookup Zs
  4. commit random poly; y; build quotient h on the extended coset domain,
     commit chunks
  5. x; write evals of all queried polys at their rotations
  6. v; GWC (or SHPLONK) multiopen

It runs on the device of the SRS. Value columns are committed over the
Lagrange basis and turned into coefficient forms one by one
(`_intt_consume`); the quotient walks the extended domain one coset of n
rows at a time (`_quotient_cosets`), so no column is ever held at the
extended size. Proof bytes are identical to the JAX package's for the same
seed.
"""
from __future__ import annotations

import hashlib
import logging
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ...device import resolve_device
from ...fields.bn254 import FR_MOD
from ...fields.limbs import (
    FR_LIMB, N_LIMBS, ints_to_limbs, ints_to_packed, limbs_from_torch, limbs_to_torch, limbs_to_words,
    objcol_to_packed, packed_to_ints,
)
from ...ops import field_ops as fo
from ...ops import poly as poly_ops
from ..kzg import SRS, kzg_commit, kzg_commit_batch
from ..transcript import PoseidonTranscript
from .cs import ConstraintSystem
from .keygen import DELTA, ProvingKey, encode_column
from .mock import _pad_instance

F = FR_LIMB
log = logging.getLogger(__name__)

# field elements per batched NTT group (2^22 = 256 MiB of int32 limbs)
NTT_BATCH_BUDGET = 1 << 22


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
        seed = os.urandom(32)
    device = resolve_device(srs.device)
    vk = pk.vk
    cs: ConstraintSystem = vk.cs
    dom = vk.domain
    n = dom.n
    usable = cs.usable_rows(n)
    u = usable - 1
    omega = dom.omega
    enc = lambda vals: encode_column(vals, device)  # noqa: E731
    msc = lambda v: _mont_scalar(v, device)  # noqa: E731
    commit_vals = lambda cols: _commit_values(srs, dom, cols)  # noqa: E731

    _t0 = time.perf_counter()

    def _mark(msg):
        log.info("prove[%s] %.1fs", msg, time.perf_counter() - _t0)

    inst = _pad_instance(cs, n, instance)
    tables = circuit.assign(cs, n, inst)
    # host packed standard-form advice values, blinding rows in place
    advice_host = []
    for i in range(cs.num_advice):
        col = objcol_to_packed(tables["advice"][i])
        col[usable:] = _blind_packed(seed, f"adv{i}", n - usable)
        advice_host.append(col)
    tables = None
    _mark("assigned")

    tr = transcript_cls()
    absorb_instances(tr, vk, instance)

    # --- device value tables (base domain, Montgomery form) ---------------
    # Phases 1-3 work on values and commit them (over the Lagrange basis
    # when the SRS is the domain's size: the same points); coefficient forms
    # are made after phase 3, each value column freed as its coefficients
    # appear (_intt_consume), so values and coefficients never coexist.
    advice_dev = [enc(col) for col in advice_host]
    fixed_dev = [enc(col) for col in pk.fixed_values]
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
    for c in commit_vals(advice_dev):
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

    # compressed input/table columns and their permutations (made on the
    # device) stay on the host, packed; phases 3 and 4 bring them back as
    # they need them
    lookups = []
    for li, lk in enumerate(cs.lookups):
        a_w = _std_words(compress_dev(lk.inputs), usable, n)
        s_w = _std_words(compress_dev(lk.tables), usable, n)
        # grand product (hence multiset equality) covers rows 0..u-1
        a_perm, s_perm = _permute_lookup(a_w[:u], s_w[:u])
        lookups.append({
            "a": _words_host(a_w),
            "s": _words_host(s_w),
            "a_perm": np.concatenate([_words_host(a_perm), _blind_packed(seed, f"lkA{li}", n - u)]),
            "s_perm": np.concatenate([_words_host(s_perm), _blind_packed(seed, f"lkS{li}", n - u)]),
        })
    perm_host = [lk[key] for lk in lookups for key in ("a_perm", "s_perm")]
    g = _ntt_group(n)
    for i in range(0, len(perm_host), g):
        for c in commit_vals([enc(col) for col in perm_host[i : i + g]]):
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
                fo.add_mod(F, fo.mont_mul_add(F, beta_b, pk.sigma_col_mont(jj), v), gamma_b),
            )
        z, last_z = grand_product(num, den, last_z)
        perm_z_devs.append(with_blinding(z, f"permz{len(perm_z_devs)}"))

    # the fixed value tables served their last use
    vals_dev["fixed"] = fixed_dev = None
    lookup_z_devs = []
    one_sc = fo.one_mont(F, device=device)
    for li, lk in enumerate(lookups):
        num = fo.mont_mul(F, fo.add_mod(F, enc(lk.pop("a")), beta_b), fo.add_mod(F, enc(lk.pop("s")), gamma_b))
        den = fo.mont_mul(
            F, fo.add_mod(F, enc(lk["a_perm"]), beta_b), fo.add_mod(F, enc(lk["s_perm"]), gamma_b)
        )
        z, _ = grand_product(num, den, one_sc)
        lookup_z_devs.append(with_blinding(z, f"lkz{li}"))

    # one commit chain for perm Zs + lookup Zs + the random poly: no
    # challenge is squeezed between these transcript writes
    rand_dev = enc(_blind(seed, "rand", n))
    for c in commit_vals(perm_z_devs + lookup_z_devs + [rand_dev]):
        tr.write_point(c)

    # --- phase 4: vanishing / quotient ------------------------------------
    _mark("grand products committed")
    y = tr.squeeze_challenge()

    # values -> coefficient forms, each value column freed as its
    # coefficients appear
    vals_dev = None
    advice_polys = _intt_consume(dom, advice_dev)
    instance_polys = _intt_consume(dom, inst_dev)
    perm_z_polys = _intt_consume(dom, perm_z_devs)
    lookup_z_polys = _intt_consume(dom, lookup_z_devs)
    random_poly = _intt_consume(dom, [rand_dev])[0]
    advice_dev = inst_dev = perm_z_devs = lookup_z_devs = rand_dev = None
    lk_polys = []
    for i in range(0, len(perm_host), g):
        lk_polys += _intt_consume(dom, [enc(col) for col in perm_host[i : i + g]])
    for i, lk in enumerate(lookups):
        lk["a_poly"] = lk_polys[2 * i]
        lk["s_poly"] = lk_polys[2 * i + 1]
    _mark("coefficient forms")
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
            pw_tables[pt] = _pow_table(pt, n, dom.k, device)
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


def _commit_values(srs: SRS, dom, cols) -> list:
    """Commitments of value columns over H, in order: over the Lagrange
    basis when the SRS has the domain's size, else over the monomial basis
    from transient coefficient forms (one NTT group at a time). The points
    are the same either way."""
    if srs.n == dom.n:
        return kzg_commit_batch(srs, cols, basis="lagrange")
    out = []
    g = _ntt_group(dom.n)
    for i in range(0, len(cols), g):
        out += kzg_commit_batch(srs, _intt_cols(dom, cols[i : i + g]))
    return out


def _intt_consume(dom, cols: list) -> list:
    """_intt_cols that frees each value column as its coefficient form
    appears (the caller's list is emptied in place), so values and
    coefficients never fully coexist: the extra device memory is one NTT
    group, not a second copy of every column."""
    out: list = []
    g = _ntt_group(dom.n)
    for i in range(0, len(cols), g):
        grp = cols[i : i + g]
        if len(grp) == 1:
            out.append(dom.intt(grp[0]))
        else:
            out.extend(dom.intt_batch(torch.stack(grp)).unbind(0))
        cols[i : i + g] = [None] * len(grp)
        del grp
    cols.clear()
    return out


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
        vp_m = encode_column(vpows[b0 : b0 + batch], device)  # (B, 16)
        weighted = fo.mont_mul_big(F, stacked, vp_m[:, None, :])
        part = poly_ops.sum_mont(F, weighted)
        acc = part if acc is None else fo.add_mod(F, acc, part)
    return acc


def _rot_point(x: int, omega: int, rot: int) -> int:
    if rot >= 0:
        return x * pow(omega, rot, FR_MOD) % FR_MOD
    return x * pow(pow(omega, -1, FR_MOD), -rot, FR_MOD) % FR_MOD


def _std_words(arr: torch.Tensor, count: int, n: int) -> torch.Tensor:
    """(n, 16) Montgomery tensor -> (n, 8) int32 standard-form words (the
    bit patterns of the packed uint32 words) of its first `count` rows,
    zero below, on its device."""
    words = limbs_to_words(fo.from_mont(F, arr[:count]))
    return torch.cat([words, words.new_zeros(n - count, words.shape[1])])


def _words_host(words: torch.Tensor) -> np.ndarray:
    return words.cpu().numpy().view(np.uint32)


def _value_order(words: torch.Tensor, minor: torch.Tensor | None = None) -> torch.Tensor:
    """Stable value order of (m, 8) int32 word rows (little-endian 256-bit
    values), with `minor` as the least significant key: stable sorts from
    the least significant key to the most, each word as a non-negative
    int64 (np.lexsort's order)."""
    order = torch.arange(words.shape[0], device=words.device)
    keys = ([minor] if minor is not None else []) + [words[:, w] for w in range(words.shape[1])]
    for key in keys:
        k = key.to(torch.int64) & 0xFFFFFFFF
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _run_starts(rows: torch.Tensor) -> torch.Tensor:
    starts = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    starts[1:] = (rows[1:] != rows[:-1]).any(dim=1)
    return starts


def _permute_lookup(a: torch.Tensor, s: torch.Tensor):
    """halo2 lookup permutation over (u, 8) int32 word rows, on their
    device: A' value-sorted; each first occurrence of an A'-run aligned
    with one matching S' entry; leftovers, in value order, fill the rest.
    The result is a function of the values alone."""
    u = a.shape[0]
    a_perm = a[_value_order(a)]
    first = _run_starts(a_perm)
    distinct = a_perm[first]
    # merge distinct-A (flag 0) with S rows (flag 1): value order, the flag
    # as the least significant key
    comb = torch.cat([distinct, s])
    flag = torch.cat([torch.zeros(distinct.shape[0], dtype=torch.int32, device=a.device),
                      torch.ones(s.shape[0], dtype=torch.int32, device=a.device)])
    oc = _value_order(comb, flag)
    cs_rows, cf = comb[oc], flag[oc]
    run_start = _run_starts(cs_rows)
    run_id = torch.cumsum(run_start.to(torch.int64), 0) - 1
    n_runs = int(run_start.sum())
    has_d = torch.zeros(n_runs, dtype=torch.bool, device=a.device)
    has_d[run_id[cf == 0]] = True
    s_count = torch.bincount(run_id[cf == 1], minlength=n_runs)
    missing = has_d & (s_count == 0)
    if bool(missing.any()):
        bad = int(torch.nonzero(missing)[0])
        bad_val = cs_rows[run_start][bad]
        raise ValueError(f"lookup value {packed_to_ints(_words_host(bad_val[None, :]))[0]} not in table")
    leftovers = torch.repeat_interleave(cs_rows[run_start], s_count - has_d.to(torch.int64), dim=0)
    s_perm = torch.empty_like(a_perm)
    s_perm[first] = distinct
    s_perm[~first] = leftovers[: u - distinct.shape[0]]
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
    lact_poly = dom.intt(encode_column(lact_vals, device))
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

    # the final transform's tables exist before the cache is sized, so every
    # prove with this domain sizes it alike
    dom.prepare_intt_extended(lact_poly.device)
    acc_ext = _quotient_cosets(
        pk, dom, cs, by_kind, zpolys, lact_poly, chunks,
        theta, beta, gamma, y, u, vshort, device,
    )
    by_kind = zpolys = None
    h_coeffs = dom.intt_extended(acc_ext)
    # pieces beyond the degree bound are identically zero (see _n_h)
    return [h_coeffs[a * n : (a + 1) * n] for a in range(_n_h(cs, dom))]


def _quotient_plan(cs, by_kind, zpolys, pk, lact_poly):
    """[(tag, coefficient column)] of every column the walk reads."""
    qs = _Queries.from_cs(cs)
    plan: list[tuple] = []
    for kind in ("advice", "fixed", "instance"):
        for col in sorted({c for c, _ in getattr(qs, kind)}):
            plan.append(((kind, col), by_kind[kind][col]))
    plan += [(tag, p) for tag, p in zpolys.items()]
    plan += [("l0", pk.l0), ("l_last", pk.l_last), ("l_active", lact_poly)]
    return plan


def _static_uses(cs, zpolys) -> dict:
    """Reads of each column by the walk, from the constraint system alone
    (witness-independent); l0, l_last and l_active rank first."""
    uses: dict = {}

    def count(tag):
        uses[tag] = uses.get(tag, 0) + 1

    for _, expr in cs.gates:
        for kind, c_, _rot in expr.queries():
            count((kind, c_))
    for jj, cref in enumerate(cs.perm_columns):
        count((cref.kind, cref.index))
        count(("sigma", jj))
    for a in range(len([t for t in zpolys if t[0] == "permz"])):
        uses[("permz", a)] = uses.get(("permz", a), 0) + 3
    for li, lkexprs in enumerate(cs.lookups):
        for e in lkexprs.inputs + lkexprs.tables:
            for kind, c_, _rot in e.queries():
                count((kind, c_))
        uses[("lkz", li)] = 3
        uses[("lka", li)] = 4
        uses[("lks", li)] = 2
    for t in ("l0", "l_last", "l_active"):
        uses[t] = 1 << 30  # read by nearly every non-gate term
    return uses


# device memory the coset walk keeps free for its transients (an NTT
# group's working set, the terms of one constraint) when it sizes its cache
COSET_RESERVE_BYTES = 8 << 30


def _coset_cache_cap(n: int, n_cols: int, device):
    """Columns one coset's cache may hold: SPT_COSET_CACHE_COLS when set;
    else on the card the plan's n_cols, limited to what the card's total
    memory holds beyond the tensors allocated now and COSET_RESERVE_BYTES
    (so the cap depends on the prove, not on memory held outside it); else
    (the CPU) no cap."""
    device = resolve_device(device)
    env = os.environ.get("SPT_COSET_CACHE_COLS")
    if env:
        return int(env)
    if device.type != "cuda":
        return None
    room = torch.cuda.get_device_properties(device).total_memory - torch.cuda.memory_allocated(device)
    return max(0, min(n_cols, (room - COSET_RESERVE_BYTES) // (n * N_LIMBS * 4)))


def _quotient_cosets(
    pk, dom, cs, by_kind, zpolys, lact_poly, chunks, theta, beta, gamma, y,
    u, vshort, device,
):
    """Coset-streaming quotient path. The extended coset g*H_ext is the
    disjoint union of `ratio` cosets shift_r*H, shift_r = g*w_ext^r; the
    walk runs once per coset with every column at n rows, so the peak is
    the coefficient forms plus one coset's cache instead of every queried
    column at 2^(k+j) rows. Rotations by omega stay inside a coset
    (omega = w_ext^ratio), the vanishing inverse is a per-coset constant,
    and one interleave gives the evaluations on the whole extended coset.
    The cache holds at most _coset_cache_cap columns, filled in the order of
    their static use count; a column beyond it is re-transformed at each
    read."""
    ext_n = dom.extended_n
    n = dom.n
    ratio = ext_n // n
    P = FR_MOD
    mm = lambda a, b: fo.mont_mul_big(F, a, b)  # noqa: E731
    ad = lambda a, b: fo.add_mod(F, a, b)  # noqa: E731
    sb = lambda a, b: fo.sub_mod(F, a, b)  # noqa: E731
    neg = lambda a: fo.neg_mod(F, a)  # noqa: E731
    plan = _quotient_plan(cs, by_kind, zpolys, pk, lact_poly)
    cache_cap = _coset_cache_cap(n, len(plan), device)
    log.info("quotient coset cache: %s of %d columns", cache_cap, len(plan))
    if cache_cap is not None:
        uses = _static_uses(cs, zpolys)
        plan.sort(key=lambda e: -uses.get(e[0], 0))
    om_pows = _pow_table(dom.omega, n, dom.k, device)
    g = _ntt_group(n)
    accs = []
    for r in range(ratio):
        shift = dom.g_coset * pow(dom.extended_omega, r, P) % P
        scale = _pow_table(shift, n, dom.k, device)  # shift^j
        cache: dict = {}
        prefill = plan if cache_cap is None else plan[:cache_cap]
        for i in range(0, len(prefill), g):
            grp = prefill[i : i + g]
            if len(grp) == 1:
                t_, p_ = grp[0]
                cache[t_] = dom.ntt(mm(p_, scale))
                continue
            scaled = mm(torch.stack([p_ for _, p_ in grp]), scale[None])
            for (t_, _), e_ in zip(grp, dom.ntt_batch(scaled).unbind(0)):
                cache[t_] = e_
            del scaled

        def col(polyc, tag):
            if tag in cache:
                return cache[tag]
            return dom.ntt(mm(polyc, scale))

        def q(kind, c_, rot):
            e = col(by_kind[kind][c_], (kind, c_))
            return torch.roll(e, -rot, dims=0) if rot else e

        def const(c):
            return _bcast(_mont_scalar(c, device), n)

        acc = torch.zeros((n, N_LIMBS), dtype=torch.int32, device=device)
        y_c = const(y)

        def fold(t):
            nonlocal acc
            acc = fo.mont_mul_add(F, acc, y_c, t)

        env = _WalkEnv(
            mm=mm, ad=ad, sb=sb, neg=neg, const=const, q=q, fold=fold,
            mad=lambda a, b, c: fo.mont_mul_add(F, a, b, c),
            msb=lambda a, b, c: fo.mont_mul_add(F, a, b, c, sub=True),
            zcol=lambda tag: col(zpolys[tag], tag),
            l0=col(pk.l0, "l0"), llast=col(pk.l_last, "l_last"),
            lact=col(lact_poly, "l_active"),
            x_vals=mm(om_pows, _bcast(_mont_scalar(shift, device), n)),
            one=fo.one_mont(F, (n,), device=device),
            roll=lambda arr, k: torch.roll(arr, -k, dims=0),
            n_perm_z=len([1 for t in zpolys if t[0] == "permz"]),
        )
        _quotient_walk(cs, chunks, theta, beta, gamma, u, env)
        env = None
        cache.clear()
        # the vanishing inverse is constant on this coset
        accs.append(mm(acc, _bcast(_mont_scalar(vshort[r], device), n)))
        del acc
        log.info("quotient coset %d/%d done", r + 1, ratio)
    # interleave: extended position i*ratio + r <-> shift_r * omega^i
    return torch.stack(accs, dim=1).reshape(ext_n, N_LIMBS)


def _pow_table(base: int, count: int, k: int, device):
    """(count, 16) Montgomery table t[i] = base^i, as a hi (x) lo outer
    product of two host tables."""
    P = FR_MOD
    nl = 1 << (k // 2)
    nh = count // nl
    lo_ints, acc = [], 1
    for _ in range(nl):
        lo_ints.append(acc)
        acc = acc * base % P
    w_nl = pow(base, nl, P)
    hi_ints, acc = [], 1
    for _ in range(nh):
        hi_ints.append(acc)
        acc = acc * w_nl % P
    lo_m = encode_column(lo_ints, device)
    hi_m = encode_column(hi_ints, device)
    return fo.mont_mul_big(F, hi_m[:, None, :], lo_m[None, :, :]).reshape(count, N_LIMBS)
