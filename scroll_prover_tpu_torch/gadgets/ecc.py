"""In-circuit short-Weierstrass arithmetic over non-native fields (3 x
88-bit limbs). Default curve: BN254 G1; the sig circuit instantiates the
same chip for secp256k1 (gadgets/ecdsa.py).

The halo2-ecc equivalent (SURVEY.md section 2.2 halo2-base/halo2-ecc row;
the reference's aggregation layers parameterize the same gadget family via
"limb_bits": 88, "num_limbs": 3 in the
reference's integration/configs/layer*.config). This chip supplies the
EC operations the in-circuit PLONK verifier (gadgets/plonk_verifier.py)
needs: strict unequal addition, doubling, and a shared-doubling windowed
MSM with signed odd digits.

Soundness notes:
  * `add_unequal` CONSTRAINS x1 != x2 (witnessed inverse of the
    difference), so a malicious prover cannot exploit the incomplete
    formulas; `double` needs no guard because BN254 G1 has prime order
    (no 2-torsion => y != 0 for every curve point).
  * Loaded witness points are constrained to lie on y^2 = x^3 + 3 and are
    therefore never the identity ((0,0) fails the curve equation). The
    identity never arises in an honest verifier run (commitments are
    blinded); a proof containing an identity point is rejected at witness
    generation.
  * MSM digit recomposition is checked mod r only; a prover choosing
    digits of s + m*r computes [s + m*r]P = [s]P, so aliasing is harmless.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..fields.bn254 import FQ_MOD, FR_MOD
from .builder import Builder, Cell
from .nonnative import NN_BASE, NN_LIMB_BITS, NN_LIMBS, NnInt, NonNativeChip

B_COEFF = 3  # default curve: y^2 = x^3 + 3 (BN254 G1)


@dataclass
class EcPointNN:
    """Affine, never-identity curve point with non-native coordinates."""

    x: NnInt
    y: NnInt
    modulus: int = FQ_MOD

    @property
    def value(self) -> tuple[int, int]:
        return (self.x.value % self.modulus, self.y.value % self.modulus)


class EccChip:
    def __init__(self, nn: NonNativeChip, b_coeff: int = B_COEFF):
        self.nn = nn
        self.p = nn.p
        self.b_coeff = b_coeff
        self.b: Builder = nn.b
        self._one = None

    def _pt(self, x: NnInt, y: NnInt) -> EcPointNN:
        return EcPointNN(x, y, self.p)

    def _one_nn(self) -> NnInt:
        if self._one is None:
            self._one = self.nn.load_constant(1)
        return self._one

    # -- loading -----------------------------------------------------------

    def load_point(self, pt: tuple[int, int], check: bool = True) -> EcPointNN:
        assert pt is not None, "identity point cannot be loaded in-circuit"
        p = self._pt(self.nn.load_witness(pt[0]), self.nn.load_witness(pt[1]))
        if check:
            self.assert_on_curve(p)
        return p

    def load_constant(self, pt: tuple[int, int]) -> EcPointNN:
        assert pt is not None
        return self._pt(self.nn.load_constant(pt[0]), self.nn.load_constant(pt[1]))

    def load_from_limbs(self, limbs: list[Cell], check: bool = True) -> EcPointNN:
        """Build a point from 6 existing cells (x0,x1,x2,y0,y1,y2 — low limb
        first), range-checking each to 88 bits. Used to reconstruct an inner
        proof's accumulator from its instance cells."""
        assert len(limbs) == 2 * NN_LIMBS
        for c in limbs:
            self.b.range_check(c, NN_LIMB_BITS)
        p = self._pt(
            NnInt(list(limbs[:NN_LIMBS]), NN_BASE),
            NnInt(list(limbs[NN_LIMBS:]), NN_BASE),
        )
        if check:
            self.assert_on_curve(p)
        return p

    def assert_on_curve(self, p: EcPointNN):
        x2 = self.nn.mul(p.x, p.x)
        y2v = (p.y.value * p.y.value - self.b_coeff) % self.p
        # x * x2 == y^2 - 3  (sub_out carries the constant offset)
        rhs = self.nn.load_witness(y2v)
        self.nn.mul(p.x, x2, sub_out=rhs)
        three = self.nn.load_constant(self.b_coeff)
        self.nn.mul(p.y, p.y, sub_out=self.nn.reduce(self.nn.add(rhs, three)))

    # -- group ops ---------------------------------------------------------

    def neg(self, p: EcPointNN) -> EcPointNN:
        return self._pt(p.x, self.nn.reduce(self.nn.neg(p.y)))

    def select(self, bit: Cell, a: EcPointNN, b: EcPointNN) -> EcPointNN:
        return self._pt(
            self.nn.select(bit, a.x, b.x), self.nn.select(bit, a.y, b.y)
        )

    def add_unequal(self, p: EcPointNN, q: EcPointNN) -> EcPointNN:
        """p + q with x_p != x_q enforced (witnessed inverse)."""
        nn = self.nn
        dx = nn.reduce(nn.sub(q.x, p.x))
        dxv = dx.value % self.p
        assert dxv != 0, "add_unequal: x collision (honest-run probability ~0)"
        inv = nn.load_witness(pow(dxv, -1, self.p))
        nn.mul(dx, inv, sub_out=self._one_nn())
        dy = nn.sub(q.y, p.y)
        lam_v = (dy.value % self.p) * pow(dxv, -1, self.p) % self.p
        lam = nn.load_witness(lam_v)
        nn.mul(lam, dx, sub_out=nn.reduce(dy))
        x3v = (lam_v * lam_v - p.x.value - q.x.value) % self.p
        x3 = nn.load_witness(x3v)
        nn.mul(lam, lam, sub_out=nn.reduce(nn.add(x3, nn.add(p.x, q.x))))
        y3v = (lam_v * ((p.x.value - x3v) % self.p) - p.y.value) % self.p
        y3 = nn.load_witness(y3v)
        nn.mul(lam, nn.sub(p.x, x3), sub_out=nn.reduce(nn.add(y3, p.y)))
        return self._pt(x3, y3)

    def double(self, p: EcPointNN) -> EcPointNN:
        nn = self.nn
        xv, yv = p.x.value % self.p, p.y.value % self.p
        x2 = nn.mul(p.x, p.x)
        lam_v = 3 * x2.value % self.p * pow(2 * yv % self.p, -1, self.p) % self.p
        lam = nn.load_witness(lam_v)
        # lam * 2y == 3 x^2
        nn.mul(lam, nn.scale(p.y, 2), sub_out=nn.reduce(nn.scale(x2, 3)))
        x3v = (lam_v * lam_v - 2 * xv) % self.p
        x3 = nn.load_witness(x3v)
        nn.mul(lam, lam, sub_out=nn.reduce(nn.add(x3, nn.scale(p.x, 2))))
        y3v = (lam_v * ((xv - x3v) % self.p) - yv) % self.p
        y3 = nn.load_witness(y3v)
        nn.mul(lam, nn.sub(p.x, x3), sub_out=nn.reduce(nn.add(y3, p.y)))
        return self._pt(x3, y3)

    # -- scalar decomposition ----------------------------------------------

    WINDOW = 4

    def _signed_digits(self, scalar: Cell, n_digits: int) -> list[list[Cell]]:
        """Decompose `scalar` into n_digits signed odd base-16 digits
        d_i = 2 e_i - 15 (e_i in [0,15], witnessed as 4 boolean cells,
        LSB-first), constraining sum d_i 16^i == scalar (mod r). Returns the
        per-digit bit cells [b0,b1,b2,b3] (digit = 2*(b0+2b1+4b2+8b3)-15),
        most significant digit LAST."""
        b = self.b
        w = self.WINDOW
        v = scalar.val
        if v % 2 == 0:
            v += FR_MOD  # odd representative of the same scalar class
        assert v < (1 << (self.WINDOW * n_digits - 1)), (
            "scalar too wide for digit count (even scalars need full width)"
        )
        # all-odd signed-digit recoding: d = x mod 2^w, with d -= 2^w when
        # the next quotient would be even (keeps every quotient odd, so
        # every digit is odd); the final digit is the remaining quotient.
        digits = []
        x = v
        for _ in range(n_digits - 1):
            d = x % (1 << w)
            if (((x - d) >> w) % 2) == 0:
                d -= 1 << w
            assert d % 2 == 1 and -15 <= d <= 15
            digits.append(d)
            x = (x - d) >> w
        assert x % 2 == 1 and 1 <= x <= 15, "scalar too wide for digit count"
        digits.append(x)
        digit_bits: list[list[Cell]] = []
        recomb: list[tuple[int, Cell]] = []
        const_off = 0
        for i, d in enumerate(digits):
            e = (d + 15) // 2
            bits = [b.assert_bit(b.witness((e >> j) & 1)) for j in range(w)]
            digit_bits.append(bits)
            for j in range(w):
                recomb.append(((2 << j) * (1 << (w * i)) % FR_MOD, bits[j]))
            const_off = (const_off - 15 * (1 << (w * i))) % FR_MOD
        recomb.append((FR_MOD - 1, scalar))
        b.assert_lin_zero(recomb, const_off)
        return digit_bits

    def _window_table(self, p: EcPointNN) -> list[EcPointNN]:
        """Odd multiples [1P, 3P, ..., 15P]."""
        two_p = self.double(p)
        tbl = [p]
        for _ in range(7):
            tbl.append(self.add_unequal(tbl[-1], two_p))
        return tbl

    def _select_digit(self, bits: list[Cell], tbl: list[EcPointNN]) -> EcPointNN:
        """Table entry for signed digit 2e-15: |d| selected from tbl by
        t = e-8 (e>=8) or 7-e (e<8) — i.e. bits b0..b2 conditionally
        complemented by the sign bit b3; y negated when b3 == 0."""
        b = self.b
        sign = bits[3]  # 1 => digit positive
        t_bits = [b.select(sign, bits[j], b.sub(self._const1(), bits[j])) for j in range(3)]
        # 8-way select tree over the 6 coordinate limbs
        cur = tbl
        for j in range(3):
            nxt = []
            for i in range(0, len(cur), 2):
                lo, hi = cur[i], cur[i + 1]
                nxt.append(
                    self._pt(
                        NnInt(
                            [b.select(t_bits[j], hi.x.limbs[k], lo.x.limbs[k]) for k in range(NN_LIMBS)],
                            max(lo.x.max_limb, hi.x.max_limb),
                        ),
                        NnInt(
                            [b.select(t_bits[j], hi.y.limbs[k], lo.y.limbs[k]) for k in range(NN_LIMBS)],
                            max(lo.y.max_limb, hi.y.max_limb),
                        ),
                    )
                )
            cur = nxt
        sel = cur[0]
        neg_y = self.nn.reduce(self.nn.neg(sel.y))
        y = self.nn.select(sign, sel.y, neg_y)
        return self._pt(sel.x, y)

    def _const1(self) -> Cell:
        c = getattr(self, "_c1", None)
        if c is None:
            c = self.b.const(1)
            self._c1 = c
        return c

    # -- MSM ----------------------------------------------------------------

    def msm(
        self, scalars: list[Cell], points: list[EcPointNN], max_bits: int | None = None
    ) -> EcPointNN:
        """sum scalars[i] * points[i], shared-doubling windowed (w=4, signed
        odd digits). Scalars are full-width Fr cells (pass max_bits for
        statically narrower scalars — they must then be odd, since the
        even-scalar fallback re-encodes s as s + r which is full width).
        The result accumulator is seeded with the first round's first term,
        so the honest-case collision probability is negligible and malicious
        collisions are rejected by add_unequal's strictness."""
        assert len(scalars) == len(points) and points
        w = self.WINDOW
        bits = FR_MOD.bit_length() + 1 if max_bits is None else max_bits + 1
        n_digits = (bits + w - 1) // w + 1  # covers s (+ r when widened)
        all_bits = [self._signed_digits(s, n_digits) for s in scalars]
        return self._msm_from_digits(all_bits, points)

    def _msm_from_digits(
        self, all_bits: list[list[list[Cell]]], points: list[EcPointNN]
    ) -> EcPointNN:
        w = self.WINDOW
        n_digits = len(all_bits[0])
        tables = [self._window_table(p) for p in points]
        acc: EcPointNN | None = None
        for round_i in range(n_digits - 1, -1, -1):
            if acc is not None:
                for _ in range(w):
                    acc = self.double(acc)
            for pi in range(len(points)):
                term = self._select_digit(all_bits[pi][round_i], tables[pi])
                acc = term if acc is None else self.add_unequal(acc, term)
        return acc

    def _signed_digits_wide(
        self, u: NnInt, n_digits: int, nn_s: NonNativeChip
    ) -> list[list[Cell]]:
        """Signed odd base-16 digits of a NON-NATIVE scalar (u mod the
        curve's group order nn_s.p, e.g. secp256k1 n > the native Fr).
        The digit recomposition is re-assembled into 88-bit limb cells
        (each an exact in-Fr linear form of 22 digits' bits, offset to
        stay non-negative) and constrained ≡ u (mod nn_s.p) through the
        scalar-field chip. Digit aliasing by multiples of the group order
        is harmless: [u + m*ord]P = [u]P."""
        b = self.b
        w = self.WINDOW
        per = NN_LIMB_BITS // w  # digits per 88-bit limb
        assert w * n_digits == NN_LIMB_BITS * NN_LIMBS, "digit/limb mismatch"
        v = u.value
        if v % 2 == 0:
            v += nn_s.p  # odd representative of the same scalar class
        assert v < (1 << (w * n_digits - 1)), "scalar too wide"
        digits = []
        x = v
        for _ in range(n_digits - 1):
            d = x % (1 << w)
            if (((x - d) >> w) % 2) == 0:
                d -= 1 << w
            assert d % 2 == 1 and -15 <= d <= 15
            digits.append(d)
            x = (x - d) >> w
        assert x % 2 == 1 and 1 <= x <= 15, "scalar too wide for digit count"
        digits.append(x)
        digit_bits = [
            [b.assert_bit(b.witness(((d + 15) // 2 >> j) & 1)) for j in range(w)]
            for d in digits
        ]
        # limb k = sum_i d_{per*k+i} 16^i + (2^88 - 1)  (non-negative)
        limb_cells = []
        for k in range(NN_LIMBS):
            terms = []
            for i in range(per):
                for j in range(w):
                    terms.append(
                        ((2 << j) * (1 << (w * i)), digit_bits[k * per + i][j])
                    )
            limb_cells.append(b.lin(terms))
        d_nn = NnInt(limb_cells, 1 << (NN_LIMB_BITS + 1))
        off = (NN_BASE - 1) * (1 + NN_BASE + NN_BASE * NN_BASE)
        nn_s.assert_equal(d_nn, nn_s.add(u, nn_s.load_constant(off)))
        return digit_bits

    def _signed_digits_short(self, v2: int, n_digits: int):
        """Witness signed odd base-16 digits of a SMALL ODD positive
        integer v2 < 2^(4*n_digits - 1) (a GLV half + parity bump).
        Returns (digit_bits, limb_cells, limb_offsets): limb_cells[j] is
        an exact in-Fr linear form of up to 22 digits' bits shifted by
        limb_offsets[j] so the cell value stays non-negative —
        limb_value[j] = sum_i d_(22j+i) 16^i + limb_offsets[j]."""
        b = self.b
        w = self.WINDOW
        assert v2 % 2 == 1 and v2 < (1 << (w * n_digits - 1))
        digits = []
        x = v2
        for _ in range(n_digits - 1):
            d = x % (1 << w)
            if (((x - d) >> w) % 2) == 0:
                d -= 1 << w
            assert d % 2 == 1 and -15 <= d <= 15
            digits.append(d)
            x = (x - d) >> w
        assert x % 2 == 1 and 1 <= x <= 15
        digits.append(x)
        digit_bits = [
            [b.assert_bit(b.witness(((d + 15) // 2 >> j) & 1)) for j in range(w)]
            for d in digits
        ]
        per = NN_LIMB_BITS // w  # 22 digits per 88-bit limb
        limb_cells, limb_offsets = [], []
        for k in range((n_digits + per - 1) // per):
            terms = []
            cnt = 0
            for i in range(per):
                di = k * per + i
                if di >= n_digits:
                    break
                cnt += 1
                for j in range(w):
                    terms.append(((2 << j) * (1 << (w * i)), digit_bits[di][j]))
            # digit d_i = 2e_i - 15 and the lin terms encode 2e_i*16^i, so
            # the cell value is sum_i d_i 16^i + (16^cnt - 1) already —
            # offset implicit, no constant addend
            off = (1 << (w * cnt)) - 1
            limb_cells.append(b.lin(terms))
            limb_offsets.append(off)
        return digit_bits, limb_cells, limb_offsets

    def msm_wide(
        self, scalars: list[NnInt], points: list[EcPointNN],
        nn_scalar: NonNativeChip,
    ) -> EcPointNN:
        """sum scalars[i] * points[i] for non-native (264-bit) scalars mod
        the curve group order nn_scalar.p (ECDSA's u1*G + u2*Q shape)."""
        n_digits = NN_LIMB_BITS * NN_LIMBS // self.WINDOW
        all_bits = [
            self._signed_digits_wide(s, n_digits, nn_scalar) for s in scalars
        ]
        return self._msm_from_digits(all_bits, points)
