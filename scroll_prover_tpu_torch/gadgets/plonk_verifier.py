"""In-circuit PLONK/KZG verifier ("halo2 loader" equivalent).

Verifies an inner proof produced by proof_system/plonk/prover.py ENTIRELY
in constraints: the Fiat-Shamir transcript (gadgets/transcript.py), all
scalar-field verification arithmetic (gate/permutation/lookup identities,
barycentric instance evaluation, quotient check), and the GWC multiopen
fold as one joint non-native MSM (gadgets/ecc.py) — leaving only the final
pairing deferred as a KZG accumulator (lhs, rhs) of two G1 points, exposed
by the wrapping circuit as its first 12 instance cells (matching the
reference's accumulator_indices=[[0,0]..[0,11]] in
the reference release-v0.13.1 chunk.protocol; role parity with
snark-verifier's KZG accumulation scheme + halo2-ecc loader, SURVEY.md
section 2.2).

Mirror discipline: this module tracks proof_system/plonk/verifier.py
statement-for-statement — transcript order, query order, and term order
must match exactly, because both derive the same challenges.

An optional inner accumulator (the first 12 instance cells of an
accumulator-carrying inner proof) is folded into the output accumulator
with a fresh squeezed challenge, so recursion composes: verifying the
outermost proof plus one pairing on its accumulator transitively verifies
the whole chain.
"""
from __future__ import annotations

from ..curves.bn254_curve import g1_generator
from ..fields.bn254 import FR_MOD
from ..proof_system.plonk.keygen import DELTA, VerifyingKey
from ..proof_system.plonk.prover import _n_h, _Queries, _perm_chunks
from .builder import Builder, Cell
from .ecc import EccChip, EcPointNN
from .transcript import InCircuitTranscript


def _rot_point_cell(b: Builder, x: Cell, omega: int, rot: int) -> Cell:
    if rot == 0:
        return x
    if rot >= 0:
        c = pow(omega, rot, FR_MOD)
    else:
        c = pow(pow(omega, -1, FR_MOD), -rot, FR_MOD)
    return b.lin([(c, x)])


class VerifierGadget:
    def __init__(
        self,
        b: Builder,
        pos,  # configured PoseidonSubCircuit
        ec: EccChip,
        vk: VerifyingKey,
        instance_cells: list[list[Cell]],
        proof: bytes,
        inner_acc_cells: list[Cell] | None = None,
        multiopen: str = "gwc",
    ):
        self.b = b
        self.pos = pos
        self.ec = ec
        self.vk = vk
        self.instance_cells = instance_cells
        self.proof = proof
        self.inner_acc_cells = inner_acc_cells
        assert multiopen in ("gwc", "shplonk")
        self.multiopen = multiopen

    # -- Fr helpers --------------------------------------------------------

    def _mul(self, a: Cell, c: Cell) -> Cell:
        return self.b.mul(a, c)

    def _inv_assert(self, num: Cell, den: Cell) -> Cell:
        """Cell q with q * den == num (den != 0 by transcript randomness)."""
        b = self.b
        dv = den.val
        q = b.witness(num.val * pow(dv, -1, FR_MOD) % FR_MOD if dv else 0)
        assert dv != 0, "division by zero in verifier arithmetic"
        b.assert_mul(q, den, num)
        return q

    # -- main --------------------------------------------------------------

    def run(self, transcript_row0: int = 0):
        b = self.b
        vk = self.vk
        cs = vk.cs
        dom = vk.domain
        n = dom.n
        usable = cs.usable_rows(n)
        u_row = usable - 1
        omega = dom.omega
        m = len(cs.perm_columns)
        chunk_len = _perm_chunks(cs)
        chunks = [
            list(range(a, min(a + chunk_len, m))) for a in range(0, m, chunk_len)
        ]

        inst_cols = self.instance_cells

        tr = InCircuitTranscript(b, self.pos, self.proof, row0=transcript_row0)
        # absorb_instances preamble (prover.py absorb_instances)
        tr.common_scalar_const(vk.transcript_repr())
        for col in range(cs.num_instance):
            src = inst_cols[col] if col < len(inst_cols) else []
            tr.common_scalar_const(len(src))
            for c in src:
                tr.common_scalar_cell(c)

        ec = self.ec
        advice_coms = [tr.read_point(ec) for _ in range(cs.num_advice)]
        theta = tr.squeeze()
        lookup_coms = [(tr.read_point(ec), tr.read_point(ec)) for _ in cs.lookups]
        beta = tr.squeeze()
        gamma = tr.squeeze()
        perm_z_coms = [tr.read_point(ec) for _ in chunks]
        lookup_z_coms = [tr.read_point(ec) for _ in cs.lookups]
        random_com = tr.read_point(ec)
        y = tr.squeeze()
        n_h = _n_h(cs, dom)
        h_coms = [tr.read_point(ec) for _ in range(n_h)]
        x = tr.squeeze()

        # rotated points as cells; rot ids keep grouping static
        omega_inv = pow(omega, -1, FR_MOD)
        xw = b.lin([(omega, x)])
        xwi = b.lin([(omega_inv, x)])
        xu = b.lin([(pow(omega, u_row, FR_MOD), x)])
        rot_cells = {0: x, 1: xw, -1: xwi, "u": xu}

        qs = _Queries.from_cs(cs)
        # queries: (com_handle, rot_id, value_cell); handles:
        #   ("w", EcPointNN) witness commitment | ("c", host_point|None) const
        queries: list[tuple] = []

        def rot_id_of(rot: int):
            return rot if rot in (0, 1, -1) else ("r", rot)

        def rot_cell_of(rid) -> Cell:
            if rid not in rot_cells:
                assert isinstance(rid, tuple)
                rot_cells[rid] = _rot_point_cell(b, x, omega, rid[1])
            return rot_cells[rid]

        adv_evals = {}
        for col, rot in qs.advice:
            v = tr.read_scalar()
            adv_evals[(col, rot)] = v
            queries.append((("w", advice_coms[col]), rot_id_of(rot), v))
        fix_evals = {}
        for col, rot in qs.fixed:
            v = tr.read_scalar()
            fix_evals[(col, rot)] = v
            queries.append((("c", vk.fixed_commitments[col]), rot_id_of(rot), v))
        sigma_evals = []
        for j in range(m):
            v = tr.read_scalar()
            sigma_evals.append(v)
            queries.append((("c", vk.sigma_commitments[j]), 0, v))
        perm_z_evals = []
        for a in range(len(chunks)):
            zx = tr.read_scalar()
            zwx = tr.read_scalar()
            queries.append((("w", perm_z_coms[a]), 0, zx))
            queries.append((("w", perm_z_coms[a]), 1, zwx))
            zu = None
            if a < len(chunks) - 1:
                zu = tr.read_scalar()
                queries.append((("w", perm_z_coms[a]), "u", zu))
            perm_z_evals.append((zx, zwx, zu))
        lookup_evals = []
        for li in range(len(cs.lookups)):
            zx = tr.read_scalar()
            zwx = tr.read_scalar()
            ax = tr.read_scalar()
            awi = tr.read_scalar()
            sx = tr.read_scalar()
            a_com, s_com = lookup_coms[li]
            queries.append((("w", lookup_z_coms[li]), 0, zx))
            queries.append((("w", lookup_z_coms[li]), 1, zwx))
            queries.append((("w", a_com), 0, ax))
            queries.append((("w", a_com), -1, awi))
            queries.append((("w", s_com), 0, sx))
            lookup_evals.append((zx, zwx, ax, awi, sx))
        random_eval = tr.read_scalar()
        queries.append((("w", random_com), 0, random_eval))

        # --- scalar-side verification arithmetic --------------------------
        one = b.const(1)
        xn = x
        for _ in range(vk.k):
            xn = b.mul(xn, xn)
        vanish_x = b.lin([(1, xn)], -1)

        n_inv = pow(n, -1, FR_MOD)
        _lag_cache: dict[tuple[int, int], Cell] = {}

        def lagrange_at(i: int, rid) -> Cell:
            key = (i, rid if not isinstance(rid, tuple) else rid[1])
            got = _lag_cache.get(key)
            if got is not None:
                return got
            z = rot_cell_of(rid) if rid != 0 else x
            wi = pow(omega, i, FR_MOD)
            # li * n * (z - wi) == wi * (z^n - 1)   [z^n == x^n for all rots]
            num = b.lin([(wi, xn)], -wi)
            den = b.lin([(n, z)], -n * wi)
            li = self._inv_assert(num, den)
            _lag_cache[key] = li
            return li

        _inst_cache: dict[tuple[int, int], Cell] = {}

        def inst_eval(col: int, rot: int) -> Cell:
            got = _inst_cache.get((col, rot))
            if got is not None:
                return got
            rid = rot_id_of(rot)
            vals = inst_cols[col] if col < len(inst_cols) else []
            pairs = [(v, lagrange_at(i, rid)) for i, v in enumerate(vals)]
            out = b.dot_acc(pairs) if pairs else b.const(0)
            _inst_cache[(col, rot)] = out
            return out

        def qv(kind, col, rot):
            if kind == "advice":
                return adv_evals[(col, rot)]
            if kind == "fixed":
                return fix_evals[(col, rot)]
            return inst_eval(col, rot)

        l0_x = lagrange_at(0, 0)
        llast_x = lagrange_at(u_row, 0)
        lact_terms = [(FR_MOD - 1, lagrange_at(i, 0)) for i in range(u_row, n)]
        lact_x = b.lin(lact_terms, 1)

        _const_cache: dict[int, Cell] = {}

        def ccell(v: int) -> Cell:
            v = v % FR_MOD
            got = _const_cache.get(v)
            if got is None:
                got = b.const(v)
                _const_cache[v] = got
            return got

        def eval_gate(expr) -> Cell:
            return expr.evaluate(
                constant=lambda c: ccell(c),
                query=qv,
                challenge=lambda i: theta,
                add=lambda p, q: b.add(p, q),
                mul=lambda p, q: b.mul(p, q),
                neg=lambda p: b.lin([(FR_MOD - 1, p)]),
            )

        terms = [eval_gate(e) for _, e in cs.gates]

        if chunks:
            z0x = perm_z_evals[0][0]
            terms.append(b.mul(l0_x, b.lin([(FR_MOD - 1, z0x)], 1)))
            zl = perm_z_evals[-1][0]
            terms.append(b.mul(llast_x, b.lin([(1, b.mul(zl, zl)), (FR_MOD - 1, zl)])))
            for a in range(1, len(chunks)):
                terms.append(
                    b.mul(
                        l0_x,
                        b.sub(perm_z_evals[a][0], perm_z_evals[a - 1][2]),
                    )
                )
            bx = b.mul(beta, x)
            for a, chunk in enumerate(chunks):
                left = perm_z_evals[a][1]
                right = perm_z_evals[a][0]
                for jj in chunk:
                    cref = cs.perm_columns[jj]
                    v = qv(cref.kind, cref.index, 0)
                    # left factor: v + beta*sigma_j(x) + gamma
                    left = b.mul(
                        left,
                        b.lin(
                            [(1, v), (1, b.mul(beta, sigma_evals[jj])), (1, gamma)]
                        ),
                    )
                    # right factor: v + beta*delta^j*x + gamma
                    right = b.mul(
                        right,
                        b.lin([(1, v), (pow(DELTA, jj, FR_MOD), bx), (1, gamma)]),
                    )
                terms.append(b.mul(lact_x, b.sub(left, right)))

        for li, lk in enumerate(cs.lookups):
            zx, zwx, ax, awi, sx = lookup_evals[li]

            def compress(exprs):
                acc = None
                for e in exprs:
                    ev = eval_gate(e)
                    acc = ev if acc is None else b.mul_add(acc, theta, ev)
                return acc if acc is not None else ccell(0)

            in_x = compress(lk.inputs)
            tb_x = compress(lk.tables)
            terms.append(b.mul(l0_x, b.lin([(FR_MOD - 1, zx)], 1)))
            terms.append(
                b.mul(llast_x, b.lin([(1, b.mul(zx, zx)), (FR_MOD - 1, zx)]))
            )
            lhs_t = b.mul(b.mul(zwx, b.add(ax, beta)), b.add(sx, gamma))
            rhs_t = b.mul(b.mul(zx, b.add(in_x, beta)), b.add(tb_x, gamma))
            terms.append(b.mul(lact_x, b.sub(lhs_t, rhs_t)))
            terms.append(b.mul(b.mul(lact_x, b.sub(ax, sx)), b.sub(ax, awi)))
            terms.append(b.mul(l0_x, b.sub(ax, sx)))

        acc_c = None
        for t in terms:
            acc_c = t if acc_c is None else b.mul_add(acc_c, y, t)
        expected_h = self._inv_assert(acc_c, vanish_x)

        # h chunks: folded with xn^a inside the x-point group (the host
        # appends one h_comb query; here each chunk is its own MSM entry
        # whose coefficient carries the extra xn^a factor)
        h_entry = ("h", tuple(h_coms))
        queries.append((h_entry, 0, expected_h))

        v_ch = tr.squeeze()

        if self.multiopen == "shplonk":
            return self._shplonk_fold(
                queries, v_ch, tr, rot_cell_of, xn, one, n_h
            )

        # --- grouping (must match host verifier exactly) ------------------
        points_order: list = []
        for _, rid, _ in queries:
            if rid not in points_order:
                points_order.append(rid)
        groups = [
            [(h, val) for (h, rid2, val) in queries if rid2 == rid]
            for rid in points_order
        ]

        ws = [tr.read_point(ec) for _ in points_order]
        u_ch = tr.squeeze()

        inner_acc = None
        mu = None
        if self.inner_acc_cells is not None:
            cells = self.inner_acc_cells
            assert len(cells) == 12
            lhs_in = ec.load_from_limbs(cells[0:6])
            rhs_in = ec.load_from_limbs(cells[6:12])
            mu = tr.squeeze()
            inner_acc = (lhs_in, rhs_in)

        # --- assemble the two joint MSMs ----------------------------------
        # per-commitment flat coefficients: sum_k u^k v^{j}
        coeff: dict[int, Cell] = {}
        handles: dict[int, tuple] = {}
        e_total: Cell | None = None  # sum_k u^k e_k
        wz_scalars: list[Cell] = []  # u^k * z_k per W
        upow: Cell | None = None
        xn_pows: list[Cell] = [one]
        for _ in range(1, n_h):
            xn_pows.append(b.mul(xn_pows[-1], xn))
        for k_i, rid in enumerate(points_order):
            upow = one if k_i == 0 else b.mul(upow, u_ch)
            vpow: Cell = one
            ek: Cell | None = None
            for j, (h, val) in enumerate(groups[k_i]):
                if j > 0:
                    vpow = b.mul(vpow, v_ch)
                if k_i == 0:
                    uv = vpow  # u^0 = 1
                elif j == 0:
                    uv = upow  # v^0 = 1
                else:
                    uv = b.mul(upow, vpow)
                if h[0] == "h":
                    for a, hp in enumerate(h[1]):
                        s = uv if a == 0 else b.mul(uv, xn_pows[a])
                        kid = ("w", id(hp))
                        if kid in coeff:
                            coeff[kid] = b.add(coeff[kid], s)
                        else:
                            coeff[kid] = s
                            handles[kid] = ("w", hp)
                else:
                    kid = (
                        ("w", id(h[1])) if h[0] == "w" else ("c", h[1])
                    )
                    if kid in coeff:
                        coeff[kid] = b.add(coeff[kid], uv)
                    else:
                        coeff[kid] = uv
                        handles[kid] = h
                term = b.mul(vpow, val) if j > 0 else val
                ek = term if ek is None else b.add(ek, term)
            z_k = rot_cell_of(rid)
            wz_scalars.append(b.mul(upow, z_k) if k_i > 0 else z_k)
            ue = b.mul(upow, ek) if k_i > 0 else ek
            e_total = ue if e_total is None else b.add(e_total, ue)

        g_pt = g1_generator()
        neg_e = b.lin([(FR_MOD - 1, e_total)])

        # lhs = sum u^k W_k (+ mu * inner_lhs)
        lhs_scalars: list[Cell] = []
        lhs_points: list[EcPointNN] = []
        upow = one
        for k_i, w in enumerate(ws):
            if k_i > 0:
                upow = b.mul(upow, u_ch)
            lhs_scalars.append(upow)
            lhs_points.append(w)
        if inner_acc is not None:
            lhs_scalars.append(mu)
            lhs_points.append(inner_acc[0])
        lhs = ec.msm(lhs_scalars, lhs_points)

        # rhs = sum u^k z_k W_k + sum coeff_C C - e_total G (+ mu inner_rhs)
        rhs_scalars: list[Cell] = []
        rhs_points: list[EcPointNN] = []
        for k_i, w in enumerate(ws):
            rhs_scalars.append(wz_scalars[k_i])
            rhs_points.append(w)
        const_merge: dict[tuple, Cell] = {}
        for kid, s in coeff.items():
            h = handles[kid]
            if h[0] == "w":
                rhs_scalars.append(s)
                rhs_points.append(h[1])
            else:
                pt = h[1]
                if pt is None:
                    continue  # identity commitment contributes nothing
                if pt in const_merge:
                    const_merge[pt] = b.add(const_merge[pt], s)
                else:
                    const_merge[pt] = s
        if g_pt in const_merge:
            const_merge[g_pt] = b.add(const_merge[g_pt], neg_e)
        else:
            const_merge[g_pt] = neg_e
        for pt, s in const_merge.items():
            rhs_scalars.append(s)
            rhs_points.append(self.ec.load_constant(pt))
        if inner_acc is not None:
            rhs_scalars.append(mu)
            rhs_points.append(inner_acc[1])
        rhs = ec.msm(rhs_scalars, rhs_points)

        self.transcript_rows = tr.rows_used()
        return lhs, rhs

    # -- SHPLONK (BDFG21) fold --------------------------------------------

    def _shplonk_fold(self, queries, v_ch, tr, rot_cell_of, xn, one, n_h):
        """In-circuit mirror of proof_system/plonk/multiopen.shplonk_fold:
        reads H, squeezes u, reads W, assembles

          lhs = W (+ mu inner_lhs)
          rhs = u W + sum_i Z_{T\\S_i}(u) com_i - [sum_i Z_i(u) r_i(u)] G
                - Z_T(u) H (+ mu inner_rhs)

        as two joint non-native MSMs. Groups/v-powers follow
        multiopen.group_queries exactly: polys keyed by structural label
        (query_labels), v^j by global first-appearance order, groups by
        exact point set. r_i(u) is evaluated in-circuit by the Lagrange
        formula with _inv_assert divisions (points are distinct transcript
        scalars). Proof cost: reads 2 G1 points instead of one per
        distinct rotation (5)."""
        from ..proof_system.plonk.multiopen import query_labels
        from ..proof_system.plonk.prover import _perm_chunks as _pc

        b = self.b
        ec = self.ec
        cs = self.vk.cs
        qs = _Queries.from_cs(cs)
        m = len(cs.perm_columns)
        n_chunks = (m + _pc(cs) - 1) // _pc(cs) if m else 0
        labels = query_labels(qs, m, n_chunks, len(cs.lookups))
        assert len(labels) == len(queries), (len(labels), len(queries))

        # group by label -> poly, then by exact point set (mirror of
        # multiopen.group_queries, over rot-ids instead of point values —
        # distinct rot ids are distinct points for a random x)
        pt_order: list = []
        polys: list[list] = []  # [handle, [(rid, val_cell), ...]]
        index: dict = {}
        for (h, rid, val), lab in zip(queries, labels):
            if rid not in pt_order:
                pt_order.append(rid)
            i = index.get(lab)
            if i is None:
                index[lab] = len(polys)
                polys.append([h, []])
                i = len(polys) - 1
            polys[i][1].append((rid, val))
        groups: list = []  # (key, [(handle, j, {rid: val_cell})])
        by_key: dict = {}
        for j, (h, pv) in enumerate(polys):
            pts = {r for r, _ in pv}
            key = tuple(r for r in pt_order if r in pts)
            if key not in by_key:
                by_key[key] = len(groups)
                groups.append((key, []))
            groups[by_key[key]][1].append((h, j, dict(pv)))

        H_pt = tr.read_point(ec)
        u_ch = tr.squeeze()
        W_pt = tr.read_point(ec)

        inner_acc = None
        mu = None
        if self.inner_acc_cells is not None:
            cells = self.inner_acc_cells
            assert len(cells) == 12
            lhs_in = ec.load_from_limbs(cells[0:6])
            rhs_in = ec.load_from_limbs(cells[6:12])
            mu = tr.squeeze()
            inner_acc = (lhs_in, rhs_in)

        # v^j per global poly index
        vpows: list[Cell] = [one]
        for _ in range(1, len(polys)):
            vpows.append(b.mul(vpows[-1], v_ch))
        # u - p_t per point (shared by every Z factor)
        u_minus = {rid: b.sub(u_ch, rot_cell_of(rid)) for rid in pt_order}
        xn_pows: list[Cell] = [one]
        for _ in range(1, n_h):
            xn_pows.append(b.mul(xn_pows[-1], xn))

        def prod(cells_):
            acc = None
            for c in cells_:
                acc = c if acc is None else b.mul(acc, c)
            return acc if acc is not None else one

        rhs_scalars: list[Cell] = [u_ch]
        rhs_points: list[EcPointNN] = [W_pt]
        const_merge: dict = {}
        const_total: Cell | None = None
        for key, members in groups:
            others = [r for r in pt_order if r not in key]
            zi_u = prod([u_minus[r] for r in others])
            # r_i(u): Lagrange over the group's points, evaluated at u
            vals = {
                r: None for r in key
            }  # combined sum_j v^j val_{j,r} as cells
            for h, j, pv in members:
                for r in key:
                    term = b.mul(vpows[j], pv[r]) if j > 0 else pv[r]
                    vals[r] = term if vals[r] is None else b.add(vals[r], term)
            if len(key) == 1:
                r_u = vals[key[0]]
            else:
                r_u = None
                for t in key:
                    num = prod([u_minus[r] for r in key if r != t])
                    den = prod(
                        [
                            b.sub(rot_cell_of(t), rot_cell_of(r))
                            for r in key
                            if r != t
                        ]
                    )
                    basis = self._inv_assert(num, den)
                    term = b.mul(vals[t], basis)
                    r_u = term if r_u is None else b.add(r_u, term)
            contrib = b.mul(zi_u, r_u)
            const_total = (
                contrib if const_total is None else b.add(const_total, contrib)
            )
            # MSM coefficients: v^j * Z_{T\S_i}(u) per member poly
            for h, j, _pv in members:
                coeff = b.mul(vpows[j], zi_u) if j > 0 else zi_u
                if h[0] == "h":
                    for a, hp in enumerate(h[1]):
                        s = coeff if a == 0 else b.mul(coeff, xn_pows[a])
                        rhs_scalars.append(s)
                        rhs_points.append(hp)
                elif h[0] == "w":
                    rhs_scalars.append(coeff)
                    rhs_points.append(h[1])
                else:
                    pt = h[1]
                    if pt is None:
                        continue  # identity commitment contributes nothing
                    if pt in const_merge:
                        const_merge[pt] = b.add(const_merge[pt], coeff)
                    else:
                        const_merge[pt] = coeff

        zt_u = prod([u_minus[r] for r in pt_order])
        neg1 = FR_MOD - 1
        g_pt = g1_generator()
        neg_const = b.lin([(neg1, const_total)])
        if g_pt in const_merge:
            const_merge[g_pt] = b.add(const_merge[g_pt], neg_const)
        else:
            const_merge[g_pt] = neg_const
        for pt, s in const_merge.items():
            rhs_scalars.append(s)
            rhs_points.append(ec.load_constant(pt))
        rhs_scalars.append(b.lin([(neg1, zt_u)]))
        rhs_points.append(H_pt)
        if inner_acc is not None:
            rhs_scalars.append(mu)
            rhs_points.append(inner_acc[1])
        rhs = ec.msm(rhs_scalars, rhs_points)

        lhs_scalars: list[Cell] = [one]
        lhs_points: list[EcPointNN] = [W_pt]
        if inner_acc is not None:
            lhs_scalars.append(mu)
            lhs_points.append(inner_acc[0])
        lhs = ec.msm(lhs_scalars, lhs_points)

        self.transcript_rows = tr.rows_used()
        return lhs, rhs
