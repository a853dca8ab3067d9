"""PLONKish verifier (host; pairing-based).

Mirror image of prover.py — transcript order, query order, and constraint
list must match exactly. Replaces halo2 verify_proof as consumed by the
reference's ChunkVerifier/BatchVerifier (SURVEY.md section 2.3).
"""
from __future__ import annotations

from ...curves.bn254_curve import G1, g1_generator
from ...curves import pairing as pr
from ...fields.bn254 import FR_MOD
from ..kzg import SRS
from ..transcript import PoseidonTranscript
from .cs import ConstraintSystem
from .keygen import DELTA, VerifyingKey
from .prover import _Queries, _n_h, _perm_chunks, _rot_point, absorb_instances


def verify(
    srs: SRS, vk: VerifyingKey, instance, proof: bytes,
    transcript_cls=PoseidonTranscript,
    _debug: dict | None = None,
    return_pairing_inputs: bool = False,
    fold_accumulator=None,
    multiopen: str = "gwc",
):
    """Fail-closed wrapper: malformed proof bytes (bad point encodings,
    truncated transcript) reject instead of raising. return_pairing_inputs
    callers (the in-circuit gadget's host twin) keep the exception."""
    try:
        return _verify(
            srs, vk, instance, proof, transcript_cls, _debug,
            return_pairing_inputs, fold_accumulator, multiopen,
        )
    except (AssertionError, ValueError, IndexError):
        if return_pairing_inputs:
            raise
        return False


def _verify(
    srs: SRS, vk: VerifyingKey, instance, proof: bytes,
    transcript_cls=PoseidonTranscript,
    _debug: dict | None = None,
    return_pairing_inputs: bool = False,
    fold_accumulator=None,
    multiopen: str = "gwc",
):
    """fold_accumulator: optional ((lhs, rhs)) pair of G1 points from an
    accumulator-carrying inner proof's first 12 instance cells; folded into
    the pairing inputs with a fresh squeezed challenge, mirroring
    gadgets/plonk_verifier.py exactly (the in-circuit and host transcripts
    must squeeze the same stream)."""
    cs: ConstraintSystem = vk.cs
    dom = vk.domain
    n = dom.n
    usable = cs.usable_rows(n)
    u = usable - 1
    omega = dom.omega
    m = len(cs.perm_columns)
    chunk_len = _perm_chunks(cs)
    chunks = [list(range(a, min(a + chunk_len, m))) for a in range(0, m, chunk_len)]

    inst_cols = []
    for col in range(cs.num_instance):
        src = instance[col] if instance and col < len(instance) else []
        inst_cols.append([int(v) % FR_MOD for v in src])

    tr = transcript_cls(proof)
    absorb_instances(tr, vk, instance)

    advice_coms = [tr.read_point() for _ in range(cs.num_advice)]
    theta = tr.squeeze_challenge()
    lookup_coms = [(tr.read_point(), tr.read_point()) for _ in cs.lookups]
    beta = tr.squeeze_challenge()
    gamma = tr.squeeze_challenge()
    perm_z_coms = [tr.read_point() for _ in chunks]
    lookup_z_coms = [tr.read_point() for _ in cs.lookups]
    random_com = tr.read_point()
    y = tr.squeeze_challenge()
    n_h = _n_h(cs, dom)
    h_coms = [tr.read_point() for _ in range(n_h)]
    x = tr.squeeze_challenge()

    xw = x * omega % FR_MOD
    xwi = x * pow(omega, -1, FR_MOD) % FR_MOD
    xu = x * pow(omega, u, FR_MOD) % FR_MOD

    qs = _Queries.from_cs(cs)
    queries: list[tuple] = []  # (commitment, point, value)

    adv_evals = {}
    for col, rot in qs.advice:
        v = tr.read_scalar()
        adv_evals[(col, rot)] = v
        queries.append((advice_coms[col], _rot_point(x, omega, rot), v))
    fix_evals = {}
    for col, rot in qs.fixed:
        v = tr.read_scalar()
        fix_evals[(col, rot)] = v
        queries.append((vk.fixed_commitments[col], _rot_point(x, omega, rot), v))
    sigma_evals = []
    for j in range(m):
        v = tr.read_scalar()
        sigma_evals.append(v)
        queries.append((vk.sigma_commitments[j], x, v))
    perm_z_evals = []
    for a in range(len(chunks)):
        zx = tr.read_scalar()
        zwx = tr.read_scalar()
        queries.append((perm_z_coms[a], x, zx))
        queries.append((perm_z_coms[a], xw, zwx))
        zu = None
        if a < len(chunks) - 1:
            zu = tr.read_scalar()
            queries.append((perm_z_coms[a], xu, zu))
        perm_z_evals.append((zx, zwx, zu))
    lookup_evals = []
    for li in range(len(cs.lookups)):
        zx = tr.read_scalar()
        zwx = tr.read_scalar()
        ax = tr.read_scalar()
        awi = tr.read_scalar()
        sx = tr.read_scalar()
        a_com, s_com = lookup_coms[li]
        queries.append((lookup_z_coms[li], x, zx))
        queries.append((lookup_z_coms[li], xw, zwx))
        queries.append((a_com, x, ax))
        queries.append((a_com, xwi, awi))
        queries.append((s_com, x, sx))
        lookup_evals.append((zx, zwx, ax, awi, sx))
    random_eval = tr.read_scalar()
    queries.append((random_com, x, random_eval))

    # --- instance + lagrange helpers -------------------------------------
    xn = pow(x, n, FR_MOD)
    vanish_x = (xn - 1) % FR_MOD

    _om_cache: dict[int, int] = {}

    def _om(i: int) -> int:
        v = _om_cache.get(i)
        if v is None:
            v = pow(omega, i, FR_MOD)
            _om_cache[i] = v
        return v

    def lagrange_at(i: int, z: int) -> int:
        zi = pow(z, n, FR_MOD)
        wi = _om(i)
        num = wi * ((zi - 1) % FR_MOD) % FR_MOD
        den = n * ((z - wi) % FR_MOD) % FR_MOD
        return num * pow(den, -1, FR_MOD) % FR_MOD

    def inst_eval(col: int, rot: int) -> int:
        # instance polys are zero beyond the declared values, so the
        # barycentric sum only ranges over them (O(#instances), not O(n))
        z = _rot_point(x, omega, rot)
        acc = 0
        for i, v in enumerate(inst_cols[col]):
            if v:
                acc = (acc + v * lagrange_at(i, z)) % FR_MOD
        return acc

    def qv(kind, col, rot):
        if kind == "advice":
            return adv_evals[(col, rot)]
        if kind == "fixed":
            return fix_evals[(col, rot)]
        return inst_eval(col, rot)

    l0_x = lagrange_at(0, x)
    llast_x = lagrange_at(u, x)
    # prover's l_active poly is 1 on rows 0..u-1: 1 - sum_{i>=u} l_i(x)
    lact_x = (1 - sum(lagrange_at(i, x) for i in range(u, n))) % FR_MOD

    def eval_gate(expr):
        return expr.evaluate(
            constant=lambda c: c % FR_MOD,
            query=qv,
            challenge=lambda i: theta,
            add=lambda a, b: (a + b) % FR_MOD,
            mul=lambda a, b: (a * b) % FR_MOD,
            neg=lambda a: (-a) % FR_MOD,
        )

    terms = [eval_gate(e) for _, e in cs.gates]

    if chunks:
        z0x = perm_z_evals[0][0]
        terms.append(l0_x * ((1 - z0x) % FR_MOD) % FR_MOD)
        zl = perm_z_evals[-1][0]
        terms.append(llast_x * ((zl * zl - zl) % FR_MOD) % FR_MOD)
        for a in range(1, len(chunks)):
            terms.append(
                l0_x * ((perm_z_evals[a][0] - perm_z_evals[a - 1][2]) % FR_MOD) % FR_MOD
            )
        for a, chunk in enumerate(chunks):
            left = perm_z_evals[a][1]
            right = perm_z_evals[a][0]
            for jj in chunk:
                cref = cs.perm_columns[jj]
                v = qv(cref.kind, cref.index, 0)
                left = left * ((v + beta * sigma_evals[jj] + gamma) % FR_MOD) % FR_MOD
                right = (
                    right
                    * ((v + beta * pow(DELTA, jj, FR_MOD) % FR_MOD * x + gamma) % FR_MOD)
                    % FR_MOD
                )
            terms.append(lact_x * ((left - right) % FR_MOD) % FR_MOD)

    for li, lk in enumerate(cs.lookups):
        zx, zwx, ax, awi, sx = lookup_evals[li]

        def compress(exprs):
            acc = 0
            for e in exprs:
                acc = (acc * theta + eval_gate(e)) % FR_MOD
            return acc

        in_x = compress(lk.inputs)
        tb_x = compress(lk.tables)
        terms.append(l0_x * ((1 - zx) % FR_MOD) % FR_MOD)
        terms.append(llast_x * ((zx * zx - zx) % FR_MOD) % FR_MOD)
        lhs = zwx * ((ax + beta) % FR_MOD) % FR_MOD * ((sx + gamma) % FR_MOD) % FR_MOD
        rhs = zx * ((in_x + beta) % FR_MOD) % FR_MOD * ((tb_x + gamma) % FR_MOD) % FR_MOD
        terms.append(lact_x * ((lhs - rhs) % FR_MOD) % FR_MOD)
        terms.append(lact_x * ((ax - sx) % FR_MOD) % FR_MOD * ((ax - awi) % FR_MOD) % FR_MOD)
        terms.append(l0_x * ((ax - sx) % FR_MOD) % FR_MOD)

    acc = 0
    for t in terms:
        acc = (acc * y + t) % FR_MOD
    expected_h = acc * pow(vanish_x, -1, FR_MOD) % FR_MOD

    # combined h commitment
    h_comb = None
    wpow = 1
    for a, c in enumerate(h_coms):
        term = c if wpow == 1 else G1.mul(c, wpow)
        h_comb = G1.add(h_comb, term)
        wpow = wpow * xn % FR_MOD
    queries.append((h_comb, x, expected_h))
    if _debug is not None:
        _debug.update(
            theta=theta, beta=beta, gamma=gamma, y=y, x=x, h_x=expected_h,
            evals=[(pt, val) for _, pt, val in queries], terms=terms,
        )

    v_ch = tr.squeeze_challenge()

    if multiopen == "shplonk":
        from .multiopen import query_labels, shplonk_fold

        labels = query_labels(qs, m, len(chunks), len(cs.lookups))
        lhs_acc, rhs_acc, _u = shplonk_fold(queries, labels, v_ch, tr)
        mu = tr.squeeze_challenge() if fold_accumulator is not None else None
    else:
        points_order = []
        for _, point, _ in queries:
            if point not in points_order:
                points_order.append(point)
        fs, es = [], []
        for point in points_order:
            group = [(c, val) for (c, pt, val) in queries if pt == point]
            fk = None
            ek = 0
            vpow = 1
            for c, val in group:
                fk = G1.add(fk, c if vpow == 1 else G1.mul(c, vpow))
                ek = (ek + vpow * val) % FR_MOD
                vpow = vpow * v_ch % FR_MOD
            fs.append(fk)
            es.append(ek)
        ws = [tr.read_point() for _ in points_order]
        u_ch = tr.squeeze_challenge()
        mu = tr.squeeze_challenge() if fold_accumulator is not None else None

        g = g1_generator()
        lhs_acc = None  # sum u^k W_k
        rhs_acc = None  # sum u^k (z_k W_k + F_k - e_k G)
        upow = 1
        for k_i, point in enumerate(points_order):
            w = ws[k_i]
            lhs_acc = G1.add(lhs_acc, w if upow == 1 else G1.mul(w, upow))
            term = G1.add(
                G1.add(G1.mul(w, point), fs[k_i]), G1.neg(G1.mul(g, es[k_i]))
            )
            rhs_acc = G1.add(rhs_acc, term if upow == 1 else G1.mul(term, upow))
            upow = upow * u_ch % FR_MOD

    if fold_accumulator is not None:
        lhs_in, rhs_in = fold_accumulator
        lhs_acc = G1.add(lhs_acc, G1.mul(lhs_in, mu))
        rhs_acc = G1.add(rhs_acc, G1.mul(rhs_in, mu))

    if return_pairing_inputs:
        # (A, B) with acceptance condition e(A, s*G2) == e(B, G2) — the
        # EVM verifier contract consumes these (evm/verifier_contract.py)
        return lhs_acc, rhs_acc
    return pr.pairing_check(
        [(lhs_acc, srs.s_g2), (G1.neg(rhs_acc), srs.g2)]
    )


def accumulator_for(
    vk: VerifyingKey, instance, proof: bytes, inner_acc=None,
    multiopen: str = "gwc",
):
    """Host twin of the in-circuit verifier: the KZG accumulator (lhs, rhs)
    an outer VerifierCircuit exposes as its first 12 instance cells."""
    return verify(
        None, vk, instance, proof,
        return_pairing_inputs=True, fold_accumulator=inner_acc,
        multiopen=multiopen,
    )


def check_accumulator(srs: SRS, lhs, rhs) -> bool:
    """Deferred pairing: e(lhs, s*G2) == e(rhs, G2)."""
    return pr.pairing_check([(lhs, srs.s_g2), (G1.neg(rhs), srs.g2)])


def acc_limbs(lhs, rhs) -> list[int]:
    """(lhs, rhs) -> the 12 instance cells (3 x 88-bit limbs per coord)."""
    out = []
    for pt in (lhs, rhs):
        for coord in (pt[0], pt[1]):
            for i in range(3):
                out.append((coord >> (88 * i)) & ((1 << 88) - 1))
    return out


def acc_from_limbs(limbs: list[int]):
    """Instance cells -> (lhs, rhs); coordinates reduced mod p (limb
    encodings are unique only up to + p, which maps to the same point)."""
    from ...fields.bn254 import FQ_MOD

    assert len(limbs) >= 12
    coords = []
    for c in range(4):
        v = sum(int(limbs[c * 3 + i]) << (88 * i) for i in range(3))
        coords.append(v % FQ_MOD)
    lhs = (coords[0], coords[1])
    rhs = (coords[2], coords[3])
    for x, y in (lhs, rhs):
        assert (y * y - x * x * x - 3) % FQ_MOD == 0, "accumulator not on curve"
    return lhs, rhs
