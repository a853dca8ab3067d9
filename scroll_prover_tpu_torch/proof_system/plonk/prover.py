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

from ... import trace
from ...device import resolve_device
from ...fields.bn254 import FR_MOD
from ...fields.limbs import (
    FR_LIMB, N_LIMBS, ints_to_limbs, ints_to_packed, limbs_from_torch, limbs_to_torch, limbs_to_words,
    packed_to_ints, packed_to_torch, words_to_limbs,
)
from ...ops import field_ops as fo
from ...ops import poly as poly_ops
from ..kzg import SRS, commit_group, kzg_commit, kzg_commit_batch
from ..transcript import PoseidonTranscript
from .cs import ConstraintSystem, assign_cached, packed_column
from .keygen import DELTA, ProvingKey, encode_column
from .mock import _pad_instance

F = FR_LIMB
log = logging.getLogger(__name__)

# field elements per batched NTT group (2^22 = 256 MiB of int32 limbs)
NTT_BATCH_BUDGET = 1 << 22

# SPT_PACK_RESIDENT=1: columns held on the device between their uses are
# kept as (n, 8) words (two 16-bit limbs per int32) instead of (n, 16)
# limbs, half the bytes, and unpacked at each use
_PACK = os.environ.get("SPT_PACK_RESIDENT") == "1"

# SPT_LOWMEM=1: bounded residency. Value columns are served from the host's
# packed copies through an LRU (_ValSource, SPT_VALS_RESIDENT columns), the
# permutation's columns pinned for the grand products; after phase 3 only
# SPT_ADVICE_COEFF_RESIDENT advice coefficient forms are made, the others,
# the lookups' permuted columns and (after a lowmem keygen) the fixed and
# sigma columns are rebuilt at each use (_LazyPoly). Proof bytes are those
# of the default path; a checkpointed prove (ckpt=) requires it.
_LOWMEM = os.environ.get("SPT_LOWMEM") == "1"


def _P(x: torch.Tensor) -> torch.Tensor:
    """Pack a resident (n, 16) limb column into (n, 8) words (only under
    SPT_PACK_RESIDENT=1; idempotent by shape)."""
    return limbs_to_words(x) if _PACK and x.shape[-1] == N_LIMBS else x


def _U(x: torch.Tensor) -> torch.Tensor:
    """Unpack a packed column at its point of use (no-op on limbs)."""
    return words_to_limbs(x) if x.shape[-1] == N_LIMBS // 2 else x


class _ValSource:
    """LRU-bounded device view over host packed value columns (lowmem).

    A column is encoded on demand from its host packed words (one upload,
    one split into limbs, one to-Montgomery product) and the least recently
    used beyond `cap` are dropped; the permutation's columns can be pinned
    for the grand products. SPT_VALS_RESIDENT caps the pool (unset: no cap,
    every column stays once loaded)."""

    def __init__(self, cols_host, enc):
        from collections import OrderedDict

        self.cols = cols_host
        self.enc = enc
        self.cap = int(os.environ.get("SPT_VALS_RESIDENT", "0")) or (1 << 60)
        self.live = OrderedDict()
        self.pinned: dict = {}

    def _load(self, i):
        return _P(self.enc(self.cols[i]))

    def __len__(self):
        return len(self.cols)

    def __getitem__(self, i):
        if i in self.pinned:
            return self.pinned[i]
        if i in self.live:
            self.live.move_to_end(i)
            return self.live[i]
        d = self._load(i)
        self.live[i] = d
        while len(self.live) > self.cap:
            self.live.popitem(last=False)
        return d

    def pin(self, i):
        if i not in self.pinned:
            d = self.live.pop(i, None)
            self.pinned[i] = d if d is not None else self._load(i)

    def take(self, i):
        """Column i, dropped from the pool (consume-as-you-go)."""
        d = self.pinned.pop(i, None)
        if d is None:
            d = self.live.pop(i, None)
        return d if d is not None else self._load(i)

    def clear(self):
        self.live.clear()
        self.pinned.clear()


class _LazyPoly:
    """A coefficient column made at each use and dropped after it: an NTT
    of host values (advice beyond the resident budget, the lookups'
    permuted columns, fixed columns after a lowmem keygen) or of the sigma
    gather on the device."""

    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn

    def get(self):
        return self.fn()


def _R(pol):
    """Resolve a possibly lazy column handle to its device tensor."""
    return pol.get() if isinstance(pol, _LazyPoly) else pol


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


def _advice_coeffs_lowmem(dom, src: _ValSource, cs, enc) -> list:
    """Advice value source -> coefficient columns under a residency budget.

    Columns are ranked by their static use count over gates, lookups and
    the permutation (witness-independent); the first
    SPT_ADVICE_COEFF_RESIDENT get coefficient forms, made consume-as-you-go,
    and the rest become _LazyPoly rebuilds from the host values (blinding
    rows included)."""
    cap = int(os.environ.get("SPT_ADVICE_COEFF_RESIDENT", "0")) or (1 << 60)
    n_cols = len(src)
    if cap >= n_cols:
        resident = set(range(n_cols))
    else:
        uses: dict[int, int] = {}
        for _, expr in cs.gates:
            for kind, c_, _rot in expr.queries():
                if kind == "advice":
                    uses[c_] = uses.get(c_, 0) + 1
        for lk in cs.lookups:
            for e in lk.inputs + lk.tables:
                for kind, c_, _rot in e.queries():
                    if kind == "advice":
                        uses[c_] = uses.get(c_, 0) + 1
        for cref in cs.perm_columns:
            if cref.kind == "advice":
                uses[cref.index] = uses.get(cref.index, 0) + 2
        order = sorted(range(n_cols), key=lambda i: -uses.get(i, 0))
        resident = set(order[:cap])
    out: list = [None] * n_cols
    g = _ntt_group(dom.n)
    batch: list[int] = []

    def flush():
        if not batch:
            return
        grp = [_U(src.take(j)) for j in batch]
        if len(grp) == 1:
            out[batch[0]] = _P(dom.intt(grp[0]))
        else:
            for j, e in zip(batch, dom.intt_batch(torch.stack(grp)).unbind(0)):
                out[j] = _P(e)
        batch.clear()

    for i in range(n_cols):
        if i in resident:
            batch.append(i)
            if len(batch) >= g:
                flush()
        else:
            src.live.pop(i, None)
            src.pinned.pop(i, None)
            out[i] = _LazyPoly(lambda i=i: dom.intt(enc(src.cols[i])))
    flush()
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


@trace.spanned("prove")
def prove(
    srs: SRS,
    pk: ProvingKey,
    circuit,
    instance,
    transcript_cls=PoseidonTranscript,
    seed: bytes | None = None,
    multiopen: str = "gwc",
    ckpt=None,
) -> bytes:
    """Prove `circuit` on the SRS's device. A fixed `seed` (deterministic
    blinding) is for tests only; by default every proof draws fresh entropy.
    With `ckpt` (a checkpoint.ProveCheckpoint; SPT_LOWMEM=1 required) the
    seed is the checkpoint's, and every commit group, lookup, quotient coset
    and the evaluations are memoized there, so that a prove resumed in a new
    process replays the transcript to the same bytes.

    The prove is the span "prove", with one child span a phase
    ("prove.assign" ... "prove.multiopen"); each phase's end logs
    "prove[<label>] <seconds>" at INFO."""
    if ckpt is not None:
        assert _LOWMEM, "checkpointed proves require SPT_LOWMEM=1"
        seed = ckpt.seed
    elif seed is None:
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

    def memo(tag, fn):
        return fn() if ckpt is None else ckpt.points(tag, fn)

    def commit_cols(cols):
        """Commitments of value columns (handles or a _ValSource), one
        commit group unpacked at a time."""
        out = []
        g_c = commit_group(n)
        for i in range(0, len(cols), g_c):
            out += _commit_values(srs, dom, [_U(cols[j]) for j in range(i, min(i + g_c, len(cols)))])
        return out

    _t0 = time.perf_counter()
    phase = [trace.span("prove.assign").__enter__()]

    def _mark(msg, nxt=None):
        """End the open phase's span, log its label, open the span `nxt`."""
        phase[0].__exit__(None, None, None)
        log.info("prove[%s] %.1fs", msg, time.perf_counter() - _t0)
        if nxt:
            phase[0] = trace.span(nxt).__enter__()

    inst = _pad_instance(cs, n, instance)
    tables = assign_cached(circuit, cs, n, inst)
    # host packed standard-form advice values, blinding rows in place
    advice_host = []
    for i in range(cs.num_advice):
        raw = tables["advice"][i]
        col = packed_column(raw)
        if col is raw:  # the assignment cache's words (a read-only map)
            col = np.array(col)
        col[usable:] = _blind_packed(seed, f"adv{i}", n - usable)
        advice_host.append(col)
    tables = None
    _mark("assigned", "prove.advice")

    tr = transcript_cls()
    absorb_instances(tr, vk, instance)

    # --- device value tables (base domain, Montgomery form) ---------------
    # Phases 1-3 work on values and commit them (over the Lagrange basis
    # when the SRS is the domain's size: the same points); coefficient forms
    # are made after phase 3, each value column freed as its coefficients
    # appear (_intt_consume), so values and coefficients never coexist.
    # Lowmem: LRU-bounded sources instead of resident lists.
    if _LOWMEM:
        advice_dev = _ValSource(advice_host, enc)
        fixed_dev = _ValSource(pk.fixed_values, enc)
    else:
        advice_dev = [_P(enc(col)) for col in advice_host]
        fixed_dev = [_P(enc(col)) for col in pk.fixed_values]
    inst_dev = [_P(enc([int(v) for v in inst[i]])) for i in range(cs.num_instance)]
    if _PACK:
        # the keys' resident coefficient forms, packed for this prove
        # (idempotent; a lowmem keygen left fixed and sigma to the prove)
        for name in ("fixed_polys", "sigma_polys"):
            if getattr(pk, name) is not None:
                setattr(pk, name, [p if isinstance(p, _LazyPoly) else _P(p) for p in getattr(pk, name)])
        pk.l0 = _P(pk.l0)
        pk.l_last = _P(pk.l_last)
    vals_dev = {"advice": advice_dev, "fixed": fixed_dev, "instance": inst_dev}
    ones_n = fo.one_mont(F, (n,), device=device)

    def eval_expr_dev(expr, theta: int):
        """Evaluate an expression over full columns on device -> (n, 16)."""
        theta_b = _bcast(msc(theta), n)

        def q(kind, col, rot):
            arr = _U(vals_dev[kind][col])
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
    # lowmem: the columns stream through the LRU, a commit group at a time
    for c in memo("p1_advice", lambda: commit_cols(advice_dev)):
        tr.write_point(c)

    _mark("advice committed", "prove.lookups")
    theta = tr.squeeze_challenge()

    # --- phase 2: lookups -------------------------------------------------
    def compress_dev(exprs):
        acc = None
        theta_b = _bcast(msc(theta), n)
        for e in exprs:
            v = eval_expr_dev(e, theta)
            acc = v if acc is None else fo.mont_mul_add(F, acc, theta_b, v)
        return acc

    def build_lookup(lk, li):
        """Compressed input/table columns and their permutations (made on
        the device), read back to the host as packed words."""
        a_w = _std_words(compress_dev(lk.inputs), usable, n)
        s_w = _std_words(compress_dev(lk.tables), usable, n)
        # grand product (hence multiset equality) covers rows 0..u-1
        a_perm, s_perm = _permute_lookup(a_w[:u], s_w[:u])
        return {
            "a": _words_host(a_w),
            "s": _words_host(s_w),
            "a_perm": np.concatenate([_words_host(a_perm), _blind_packed(seed, f"lkA{li}", n - u)]),
            "s_perm": np.concatenate([_words_host(s_perm), _blind_packed(seed, f"lkS{li}", n - u)]),
        }

    # the lookups' columns stay on the host, packed; phases 3 and 4 bring
    # them back as they need them
    lookups = []
    for li, lk in enumerate(cs.lookups):
        if ckpt is None:
            lookups.append(build_lookup(lk, li))
        else:
            lookups.append(ckpt.lookup(li, lambda lk=lk, li=li: build_lookup(lk, li)))
    perm_host = [lk[key] for lk in lookups for key in ("a_perm", "s_perm")]
    g = _ntt_group(n)

    def p2_commits():
        out = []
        for i in range(0, len(perm_host), g):
            out += _commit_values(srs, dom, [enc(col) for col in perm_host[i : i + g]])
        return out

    for c in memo("p2_perm", p2_commits):
        tr.write_point(c)

    _mark("lookups committed", "prove.grand_products")
    beta = tr.squeeze_challenge()
    gamma = tr.squeeze_challenge()
    if _LOWMEM:
        # the value tables served their last broad use: pin the columns of
        # the permutation for the grand products and release the rest
        for cref in cs.perm_columns:
            if cref.kind in ("advice", "fixed"):
                vals_dev[cref.kind].pin(cref.index)
        advice_dev.live.clear()
        fixed_dev.live.clear()

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
            v = _U(vals_dev[cref.kind][cref.index])
            dj = msc(beta * pow(DELTA, jj, FR_MOD) % FR_MOD)
            num = fo.mont_mul(
                F, num, fo.add_mod(F, fo.mont_mul_add(F, dj, om_pows_dev, v), gamma_b)
            )
            # sigma streams from the keys' gather at its point of use
            den = fo.mont_mul(
                F, den,
                fo.add_mod(F, fo.mont_mul_add(F, beta_b, pk.sigma_col_mont(jj), v), gamma_b),
            )
        z, last_z = grand_product(num, den, last_z)
        perm_z_devs.append(_P(with_blinding(z, f"permz{len(perm_z_devs)}")))

    # the fixed value tables served their last use
    if _LOWMEM:
        fixed_dev.clear()
    vals_dev["fixed"] = fixed_dev = None
    lookup_z_devs = []
    one_sc = fo.one_mont(F, device=device)
    for li, lk in enumerate(lookups):
        num = fo.mont_mul(F, fo.add_mod(F, enc(lk.pop("a")), beta_b), fo.add_mod(F, enc(lk.pop("s")), gamma_b))
        den = fo.mont_mul(
            F, fo.add_mod(F, enc(lk["a_perm"]), beta_b), fo.add_mod(F, enc(lk["s_perm"]), gamma_b)
        )
        z, _ = grand_product(num, den, one_sc)
        lookup_z_devs.append(_P(with_blinding(z, f"lkz{li}")))

    # one commit chain for perm Zs + lookup Zs + the random poly: no
    # challenge is squeezed between these transcript writes
    rand_dev = enc(_blind(seed, "rand", n))
    for c in memo("p3", lambda: commit_cols(perm_z_devs + lookup_z_devs + [rand_dev])):
        tr.write_point(c)

    # --- phase 4: vanishing / quotient ------------------------------------
    _mark("grand products committed", "prove.coeff_forms")
    y = tr.squeeze_challenge()

    # values -> coefficient forms, each value column freed as its
    # coefficients appear; lowmem: only the budget's advice columns, the
    # rest, the lookups' permuted columns and deferred fixed/sigma columns
    # are rebuilt at each use
    vals_dev = None
    if _LOWMEM:
        advice_polys = _advice_coeffs_lowmem(dom, advice_dev, cs, enc)
        advice_dev.clear()
    else:
        advice_polys = _intt_consume(dom, advice_dev)
    instance_polys = _intt_consume(dom, inst_dev)
    perm_z_polys = _intt_consume(dom, perm_z_devs)
    lookup_z_polys = _intt_consume(dom, lookup_z_devs)
    random_poly = _intt_consume(dom, [rand_dev])[0]
    advice_dev = inst_dev = perm_z_devs = lookup_z_devs = rand_dev = None
    if _LOWMEM:
        for lk in lookups:
            for key, pkey in (("a_perm", "a_poly"), ("s_perm", "s_poly")):
                lk[pkey] = _LazyPoly(lambda col=lk[key]: dom.intt(enc(col)))
    else:
        lk_polys = []
        for i in range(0, len(perm_host), g):
            lk_polys += _intt_consume(dom, [enc(col) for col in perm_host[i : i + g]])
        for i, lk in enumerate(lookups):
            lk["a_poly"] = lk_polys[2 * i]
            lk["s_poly"] = lk_polys[2 * i + 1]
    if pk.fixed_polys is None:
        # a lowmem keygen committed fixed and sigma from their values: their
        # coefficient forms are an upload and an NTT of the host words, and
        # a gather and an NTT, at each use
        pk.fixed_polys = [
            _LazyPoly(lambda j=j: dom.intt(enc(pk.fixed_values[j]))) for j in range(len(pk.fixed_values))
        ]
    if pk.sigma_polys is None:
        pk.sigma_polys = [_LazyPoly(lambda j=j: dom.intt(pk.sigma_col_mont(j))) for j in range(len(pk.sigma_values))]
    _mark("coefficient forms", "prove.quotient")
    h_chunk_polys = _build_quotient(
        pk, dom, cs, advice_polys, list(pk.fixed_polys), instance_polys,
        pk.sigma_polys, perm_z_polys, lookups, lookup_z_polys,
        chunks, theta, beta, gamma, y, u, device, ckpt=ckpt,
    )
    _mark("quotient built", "prove.quotient_commit")
    for c in memo("p4_h", lambda: kzg_commit_batch(srs, h_chunk_polys)):
        tr.write_point(c)
    _mark("quotient committed", "prove.evals")

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

    def compute_evals():
        # one powers table per distinct point, shared by every opening there
        pw_tables: dict[int, torch.Tensor] = {}
        for _, pt, _w in plan5:
            if pt not in pw_tables:
                pw_tables[pt] = _pow_table(pt, n, dom.k, device)
        ev_dev = [poly_ops.eval_poly_with_powers(F, _U(_R(p)), pw_tables[pt]) for p, pt, _ in plan5]
        return F.decode(limbs_from_torch(torch.stack(ev_dev)))

    ev_vals = compute_evals() if ckpt is None else ckpt.scalars("p5_evals", compute_evals)
    queries: list[tuple] = []  # (poly, point, value)
    for (p, pt, write), v in zip(plan5, ev_vals):
        v = int(v)
        if write:
            tr.write_scalar(v)
        queries.append((p, pt, v))

    _mark("evals written", "prove.multiopen")
    v_ch = tr.squeeze_challenge()

    if multiopen == "shplonk":
        from .multiopen import query_labels, shplonk_open

        labels = query_labels(qs, m, len(chunks), len(lookups))
        queries = [(p if isinstance(p, _LazyPoly) else _U(p), pt, val) for (p, pt, val) in queries]
        shplonk_open(srs, queries, labels, v_ch, tr, kzg_commit, msc, enc)
        _mark("multiopen done (shplonk)")
        return tr.finalize()

    # --- phase 6: GWC multiopen ------------------------------------------
    points_order: list[int] = []
    for _, point, _ in queries:
        if point not in points_order:
            points_order.append(point)

    def p6_commits():
        wit_polys = []
        for point in points_order:
            group = [(p, val) for (p, pt, val) in queries if pt == point]
            comb = _combine(group, v_ch, device)
            wit_polys.append(poly_ops.kzg_quotient_mont(F, comb, msc(point)))
        return kzg_commit_batch(srs, wit_polys)

    for c in memo("p6_w", p6_commits):
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
        grp = [_U(c) for c in cols[i : i + g]]
        if len(grp) == 1:
            out.append(_P(dom.intt(grp[0])))
        else:
            out.extend(_P(e) for e in dom.intt_batch(torch.stack(grp)).unbind(0))
        cols[i : i + g] = [None] * len(grp)
        del grp
    cols.clear()
    return out


def _combine(group, v_ch, device):
    """sum_i v^i f_i over (poly, eval) pairs; f_0 gets v^0. Stacked in
    chunks of NTT_BATCH_BUDGET elements: one product by the v-power column
    and one halving tree-sum per chunk. Lazy columns are made as their
    chunk is stacked (the length comes from the others: a lazy column is a
    whole-domain NTT output, never longer than them)."""
    eager_lens = [p.shape[0] for p, _ in group if not isinstance(p, _LazyPoly)]
    if eager_lens:
        maxlen = max(eager_lens)
    else:
        first = _R(group[0][0])
        group = [(first, group[0][1])] + list(group[1:])
        maxlen = first.shape[0]
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
            polyc = _U(_R(polyc))
            assert polyc.shape[0] <= maxlen, "a lazy column is longer than its group's columns"
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
    device, ckpt=None,
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
        theta, beta, gamma, y, u, vshort, device, ckpt,
    )
    by_kind = zpolys = None
    h_coeffs = dom.intt_extended(acc_ext)
    acc_ext = None
    # the extended domain's tables go until the next prove rebuilds them,
    # and the pieces leave the extended buffer: at k = 23 the tables and
    # the pieces beyond the bound are 6 GiB that the commits after need
    dom.release_extended(h_coeffs.device)
    # pieces beyond the degree bound are identically zero (see _n_h)
    return [h_coeffs[a * n : (a + 1) * n].clone() for a in range(_n_h(cs, dom))]


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
# group's working set, the terms of one constraint) when it sizes its cache:
# COSET_RESERVE_COLS columns of n rows, at least COSET_RESERVE_BYTES (the
# transients grow with n: at k = 23 a reserve of 8 GiB ran out in the
# first coset)
COSET_RESERVE_BYTES = 8 << 30
COSET_RESERVE_COLS = 32


def _coset_cache_cap(n: int, n_cols: int, device):
    """Columns one coset's cache may hold: SPT_COSET_CACHE_COLS when set;
    else on the card the plan's n_cols, limited to what the card's total
    memory holds beyond the tensors allocated now and the reserve (so the
    cap depends on the prove, not on memory held outside it); else (the
    CPU) no cap."""
    device = resolve_device(device)
    env = os.environ.get("SPT_COSET_CACHE_COLS")
    if env:
        return int(env)
    if device.type != "cuda":
        return None
    col_bytes = n * N_LIMBS * 4
    reserve = max(COSET_RESERVE_BYTES, COSET_RESERVE_COLS * col_bytes)
    room = torch.cuda.get_device_properties(device).total_memory - torch.cuda.memory_allocated(device)
    return max(0, min(n_cols, (room - reserve) // col_bytes))


def _quotient_cosets(
    pk, dom, cs, by_kind, zpolys, lact_poly, chunks, theta, beta, gamma, y,
    u, vshort, device, ckpt=None,
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
    read (a lazy one made again first). With `ckpt` each finished coset's
    accumulator is kept there as packed Montgomery words, and a coset found
    there is not walked again."""
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
        if ckpt is not None and ckpt.has_coset(r):
            accs.append(packed_to_torch(ckpt.coset(r, None), device))
            log.info("quotient coset %d/%d (checkpoint)", r + 1, ratio)
            continue
        shift = dom.g_coset * pow(dom.extended_omega, r, P) % P
        scale = _pow_table(shift, n, dom.k, device)  # shift^j
        cache: dict = {}
        prefill = plan if cache_cap is None else plan[:cache_cap]
        for i in range(0, len(prefill), g):
            grp = prefill[i : i + g]
            if len(grp) == 1:
                t_, p_ = grp[0]
                cache[t_] = _P(dom.ntt(_U(_R(p_)), scale=scale))
                continue
            evals = dom.ntt_batch(torch.stack([_U(_R(p_)) for _, p_ in grp]), scale=scale)
            for (t_, _), e_ in zip(grp, evals.unbind(0)):
                cache[t_] = _P(e_)
            del evals

        def col(polyc, tag):
            if tag in cache:
                return _U(cache[tag])
            return dom.ntt(_U(_R(polyc)), scale=scale)

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
        acc = mm(acc, _bcast(_mont_scalar(vshort[r], device), n))
        if ckpt is not None:
            ckpt.coset(r, lambda: _words_host(limbs_to_words(acc)))
        accs.append(acc)
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
