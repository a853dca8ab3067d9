"""Non-native big-int arithmetic over the Fr-circuit: 3 x 88-bit limbs.

The emulated modulus is a chip parameter (default BN254 Fq); the sig
circuit instantiates the same chip for secp256k1's base and scalar fields
(gadgets/ecdsa.py).

Mirrors the halo2-ecc CRT integer design the reference's aggregation
circuits are built on ("limb_bits": 88, "num_limbs": 3 in every
the reference's integration/configs/layer*.config). Multiplication is
checked by the full schoolbook identity  a*b + K*p = q*p + r  over the
integers, expressed as limb-convolution equations with range-checked signed
carries — sound without a separate native-field CRT leg because every
convolution position is constrained and every intermediate magnitude stays
far below the native field size (~2^180 vs 2^253).

Values carry a host-side magnitude bound (`max_limb`); ops auto-reduce
operands when a product would overflow the carry analysis. All witnesses
(limbs, quotients, carries) are range-checked through the builder's lookup
table. The bound bookkeeping is shape-deterministic (derived from bounds,
never witness values), so keygen and prove assignments stay congruent.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..fields.bn254 import FQ_MOD, FR_MOD
from .builder import Builder, Cell

NN_LIMB_BITS = 88
NN_LIMBS = 3
NN_BASE = 1 << NN_LIMB_BITS
_P_LIMBS = [(FQ_MOD >> (NN_LIMB_BITS * i)) & (NN_BASE - 1) for i in range(NN_LIMBS)]

# operand limb ceiling for mul (inputs above this are reduced first)
_MUL_LIMB_BOUND = 1 << (NN_LIMB_BITS + 2)
# ceiling for the r-side (sub_out) of a constrained mul
_R_LIMB_BOUND = 1 << (NN_LIMB_BITS + 14)


@dataclass
class NnInt:
    """Non-native integer: limb cells (low first) + strict per-limb bound."""

    limbs: list[Cell]
    max_limb: int

    @property
    def value(self) -> int:
        return sum(c.val << (NN_LIMB_BITS * i) for i, c in enumerate(self.limbs))

    @property
    def max_value(self) -> int:
        return self.max_limb * sum(
            1 << (NN_LIMB_BITS * i) for i in range(len(self.limbs))
        )


class NonNativeChip:
    def __init__(self, b: Builder, p: int = FQ_MOD):
        assert p.bit_length() <= NN_LIMB_BITS * NN_LIMBS
        self.b = b
        self.p = p
        self.p_limbs = [
            (p >> (NN_LIMB_BITS * i)) & (NN_BASE - 1) for i in range(NN_LIMBS)
        ]

    # -- loading -----------------------------------------------------------

    def load_witness(self, v: int) -> NnInt:
        """Witness a canonical Fq value (reduced mod p), limbs range-checked."""
        v = int(v) % self.p
        cells = []
        for i in range(NN_LIMBS):
            li = (v >> (NN_LIMB_BITS * i)) & (NN_BASE - 1)
            cells.append(self.b.witness_ranged(li, NN_LIMB_BITS))
        return NnInt(cells, NN_BASE)

    def load_constant(self, v: int) -> NnInt:
        v = int(v) % self.p
        cells = [
            self.b.const((v >> (NN_LIMB_BITS * i)) & (NN_BASE - 1))
            for i in range(NN_LIMBS)
        ]
        return NnInt(cells, NN_BASE)

    def load_u256(self, hi, lo) -> NnInt:
        """NnInt exactly equal to hi*2^128 + lo (two existing 128-bit half
        cells, e.g. table columns). Splits the middle limb at bit 40 so
        both binding identities stay inside Fr:
            lo = l0 + l1a*2^88          (l0: 88 bits, l1a: 40 bits)
            hi = l1b + l2*2^48          (l1b: 48 bits, l2: 80 bits)
        As a side effect hi/lo are range-constrained to 128 bits."""
        b = self.b
        v = (int(hi.val) << 128) | int(lo.val)
        l0 = v & (NN_BASE - 1)
        l1 = (v >> NN_LIMB_BITS) & (NN_BASE - 1)
        l2 = v >> (2 * NN_LIMB_BITS)
        l1a, l1b = l1 & ((1 << 40) - 1), l1 >> 40
        c0 = b.witness_ranged(l0, NN_LIMB_BITS)
        c1a = b.witness_ranged(l1a, 40)
        c1b = b.witness_ranged(l1b, 48)
        c2 = b.witness_ranged(l2, 80)
        c1 = b.lin([(1, c1a), (1 << 40, c1b)])
        b.assert_lin_zero([(1, c0), (1 << NN_LIMB_BITS, c1a), (-1, lo)])
        b.assert_lin_zero([(1, c1b), (1 << 48, c2), (-1, hi)])
        return NnInt([c0, c1, c2], NN_BASE)

    # -- linear ops (lazy: no carries, bounds tracked) ---------------------

    def add(self, a: NnInt, b: NnInt) -> NnInt:
        cells = [self.b.add(x, y) for x, y in zip(a.limbs, b.limbs)]
        return NnInt(cells, a.max_limb + b.max_limb)

    def sub(self, a: NnInt, b: NnInt) -> NnInt:
        """a - b + k*p, with k*p decomposed borrow-free so every output limb
        stays non-negative."""
        corr = _borrow_free_multiple(b.max_limb, self.p)
        cells = [
            self.b.lin([(1, a.limbs[i]), (-1, b.limbs[i])], corr[i])
            for i in range(NN_LIMBS)
        ]
        return NnInt(cells, a.max_limb + max(corr) + 1)

    def neg(self, a: NnInt) -> NnInt:
        corr = _borrow_free_multiple(a.max_limb, self.p)
        cells = [
            self.b.lin([(-1, a.limbs[i])], corr[i]) for i in range(NN_LIMBS)
        ]
        return NnInt(cells, max(corr) + 1)

    def scale(self, a: NnInt, k: int) -> NnInt:
        assert k >= 0
        cells = [self.b.lin([(k, x)]) for x in a.limbs]
        return NnInt(cells, a.max_limb * k + 1)

    def select(self, bit: Cell, a: NnInt, b: NnInt) -> NnInt:
        cells = [self.b.select(bit, x, y) for x, y in zip(a.limbs, b.limbs)]
        return NnInt(cells, max(a.max_limb, b.max_limb))

    # -- reduction / multiplication ----------------------------------------

    def reduce(self, a: NnInt) -> NnInt:
        """Fresh canonical representative r ≡ a (mod p), limbs < 2^88."""
        if a.max_limb <= NN_BASE:
            return a
        av = a.value
        r = self.load_witness(av % self.p)
        q_val = av // self.p
        q_bits = max((a.max_value // self.p).bit_length(), 1)
        assert q_bits <= NN_LIMB_BITS, "reduce: bound bug (quotient too large)"
        q = self.b.witness_ranged(q_val, q_bits)
        eqs, pos, neg = [], [], []
        for k in range(NN_LIMBS):
            eqs.append(
                [(1, a.limbs[k]), (-self.p_limbs[k], q), (-1, r.limbs[k])]
            )
            pos.append(a.max_limb)
            neg.append((self.p_limbs[k] << q_bits) + NN_BASE)
        self._assert_limbs_zero(eqs, pos, neg)
        return r

    def mul(self, a: NnInt, b: NnInt, sub_out: NnInt | None = None) -> NnInt:
        """r = a*b mod p (fresh canonical limbs). With sub_out given,
        CONSTRAINS a*b ≡ sub_out (mod p) instead and returns sub_out —
        saves an equality when the caller already holds the target.

        Identity checked: a*b + K*p = q*p + r  with fixed K ≥ max(r)/p so
        the witnessed quotient q is non-negative."""
        if a.max_limb > _MUL_LIMB_BOUND:
            a = self.reduce(a)
        if b.max_limb > _MUL_LIMB_BOUND:
            b = self.reduce(b)
        if sub_out is None:
            r = self.load_witness(a.value * b.value % self.p)
        else:
            r = sub_out
            assert r.max_limb <= _R_LIMB_BOUND, "mul: sub_out bound too loose"
            assert (a.value * b.value - r.value) % self.p == 0, "mul: mismatch"
        # fixed offset K*p >= max possible r (deterministic from bounds)
        K = r.max_value // self.p + 1
        prod = a.value * b.value
        q_val = (prod + K * self.p - r.value) // self.p
        assert (prod + K * self.p - r.value) % self.p == 0
        q_max = (a.max_value * b.max_value + K * self.p) // self.p
        q_bits = max(q_max.bit_length(), 1)
        qn = self._witness_big(q_val, q_bits)
        kp_limbs = _int_limbs(K * self.p)

        pij = {}
        for i in range(NN_LIMBS):
            for j in range(NN_LIMBS):
                pij[(i, j)] = self.b.mul(a.limbs[i], b.limbs[j])

        n_pos = max(2 * NN_LIMBS - 1, len(qn.limbs) + NN_LIMBS - 1, len(kp_limbs))
        eqs, pos, neg = [], [], []
        ab_term = a.max_limb * b.max_limb
        for k in range(n_pos):
            terms = []
            konst = kp_limbs[k] if k < len(kp_limbs) else 0
            p_b = konst
            n_b = 1
            for i in range(NN_LIMBS):
                j = k - i
                if 0 <= j < NN_LIMBS:
                    terms.append((1, pij[(i, j)]))
                    p_b += ab_term
            for i, qc in enumerate(qn.limbs):
                j = k - i
                if 0 <= j < NN_LIMBS:
                    terms.append((-self.p_limbs[j], qc))
                    n_b += self.p_limbs[j] * qn.max_limb
            if k < len(r.limbs):
                terms.append((-1, r.limbs[k]))
                n_b += r.max_limb
            eqs.append((terms, konst))
            pos.append(p_b)
            neg.append(n_b)
        self._assert_limbs_zero([t for t, _ in eqs], pos, neg,
                                consts=[c for _, c in eqs])
        return r

    def _witness_big(self, v: int, bits: int) -> NnInt:
        """Witness a non-negative integer < 2^bits as 88-bit limbs."""
        n_l = (bits + NN_LIMB_BITS - 1) // NN_LIMB_BITS
        cells = []
        for i in range(n_l):
            li = (v >> (NN_LIMB_BITS * i)) & (NN_BASE - 1)
            top = bits - NN_LIMB_BITS * (n_l - 1)
            cells.append(
                self.b.witness_ranged(li, NN_LIMB_BITS if i < n_l - 1 else top)
            )
        return NnInt(cells, NN_BASE)

    def _assert_limbs_zero(self, eqs, pos_bound, neg_bound, consts=None):
        """Constrain sum_k eq_k * B^k == 0 over the integers.

        eq_k is a list of (coeff, Cell) whose signed value lies in
        (-neg_bound[k], pos_bound[k]); consts[k] is an optional constant
        addend (already counted in pos_bound). Carries are signed; each is
        range-proved via an offset shift. Soundness: every equation holds
        mod the native field and every magnitude is < 2^200 << r/2, so the
        mod-r equations imply the integer identity."""
        B = NN_BASE
        carry_prev: Cell | None = None
        off_prev = 0
        bound_prev = 0
        for k, terms in enumerate(eqs):
            konst = consts[k] if consts else 0
            val = sum(co * c.val for co, c in terms) + konst
            if carry_prev is not None:
                val += carry_prev.val - off_prev
                terms = terms + [(1, carry_prev)]
                konst -= off_prev
            if k == len(eqs) - 1:
                assert val == 0, "limb identity violated (witness bug)"
                self.b.assert_lin_zero(terms, konst)
                return
            assert val % B == 0, "limb equation not divisible (witness bug)"
            carry = val // B
            hi = (pos_bound[k] * 3 + neg_bound[k] + bound_prev) // B + 2
            cb = hi.bit_length() + 1
            off = 1 << (cb - 1)
            assert -off < carry < off, "carry bound too tight (bound bug)"
            c_cell = self.b.witness_ranged(carry + off, cb)
            self.b.assert_lin_zero(terms + [(-B, c_cell)], konst + B * off)
            carry_prev = c_cell
            off_prev = off
            bound_prev = off
        raise AssertionError("unreachable")

    # -- equality / zero ---------------------------------------------------

    def assert_equal(self, a: NnInt, b: NnInt):
        """a ≡ b (mod p): d = a - b + k*p has non-negative limbs; then d is
        constrained to be an exact multiple of p."""
        self.assert_zero(self.sub(a, b))

    def assert_zero(self, a: NnInt):
        """a ≡ 0 (mod p): witness q with a == q*p exactly (a's limbs are
        non-negative by construction)."""
        av = a.value
        assert av % self.p == 0, "assert_zero: witness bug"
        q_val = av // self.p
        q_bits = max((a.max_value // self.p).bit_length(), 1)
        assert q_bits <= NN_LIMB_BITS
        q = self.b.witness_ranged(q_val, q_bits)
        eqs = [[(1, a.limbs[k]), (-self.p_limbs[k], q)] for k in range(NN_LIMBS)]
        self._assert_limbs_zero(
            eqs,
            pos_bound=[a.max_limb] * NN_LIMBS,
            neg_bound=[(self.p_limbs[k] << q_bits) + 1 for k in range(NN_LIMBS)],
        )


def _int_limbs(v: int) -> list[int]:
    out = []
    while v:
        out.append(v & (NN_BASE - 1))
        v >>= NN_LIMB_BITS
    return out or [0]


def _borrow_free_multiple(m: int, p: int = FQ_MOD) -> list[int]:
    """Limbs c_i (sum c_i B^i == k*p for some k) with every c_i >= m, so
    (a - b + c) has non-negative limbs whenever b's limbs are < m. Derived
    from the bound only — shape-deterministic."""
    B = NN_BASE
    # k*p must reach m*(1 + B + B^2) so every limb can be raised to >= m
    # by borrowing; works for any modulus width (BN254 Fq, secp fields,
    # modexp event moduli)
    k = (m * (1 + B + B * B)) // p + 2
    kp = k * p
    c = [kp & (B - 1), (kp >> NN_LIMB_BITS) & (B - 1), kp >> (2 * NN_LIMB_BITS)]
    for i in range(NN_LIMBS - 1):
        if c[i] < m:
            borrow = (m - c[i] + B - 1) // B
            c[i] += borrow * B
            c[i + 1] -= borrow
    assert all(v >= m for v in c), "borrow-free correction failed"
    assert sum(v << (NN_LIMB_BITS * i) for i, v in enumerate(c)) == kp
    return c
