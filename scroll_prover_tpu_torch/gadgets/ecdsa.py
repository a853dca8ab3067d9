"""In-circuit ECDSA verification over secp256k1 (the sig circuit's core).

Reference scope: zkevm-circuits' sig_circuit verifies every tx signature
with halo2-ecc's ECDSA chip (SURVEY.md section 2.2). Same non-native
machinery as the BN254 aggregation gadgets, instantiated for secp256k1's
base field p and scalar field n:

    assert r, s non-zero mod n (witnessed inverses)
    u1*s ≡ z (mod n),  u2*s ≡ r (mod n)      (so u1 = z/s, u2 = r/s)
    R = u1*G + u2*Q                           (msm_wide, 264-bit scalars)
    R.x = r + f*n over the integers, f in {0,1}   (x_R ≡ r mod n)

Q is range/on-curve checked at load. The (r, s, z) operands enter as
128-bit half cells (hi, lo) and are bound to their 88-bit limb
decompositions with exact in-Fr linear identities — the caller's table
cells therefore ARE the verified values.
"""
from __future__ import annotations

from ..curves import secp256k1 as secp
from .builder import Builder, Cell
from .ecc import EccChip, EcPointNN
from .nonnative import NN_BASE, NN_LIMB_BITS, NnInt, NonNativeChip


class EcdsaChip:
    def __init__(self, b: Builder):
        self.b = b
        self.nn_p = NonNativeChip(b, secp.P)
        self.nn_n = NonNativeChip(b, secp.N)
        self.ec = EccChip(self.nn_p, b_coeff=secp.B)

    def load_u256(self, hi: Cell, lo: Cell) -> NnInt:
        return self.nn_n.load_u256(hi, lo)

    def _assert_nonzero_mod_n(self, x: NnInt):
        nn = self.nn_n
        xv = x.value % nn.p
        assert xv != 0, "ecdsa: zero r/s in witness"
        inv = nn.load_witness(pow(xv, -1, nn.p))
        nn.mul(x, inv, sub_out=nn.load_constant(1))

    def _glv_scalar(self, u: NnInt):
        """GLV-decompose u ≡ k1 + LAMBDA*k2 (mod n), |k_i| <= 2^128, and
        CONSTRAIN the congruence against the witnessed signed-odd digit
        decompositions. Each half is witnessed as 33 signed odd base-16
        digits of |k_i| + e_i (e_i a parity-bump bit, since the all-odd
        recoding needs an odd value) plus a sign bit. Returns
        [(digit_bits, sign_cell, e_cell)] * 2 for the MSM side; soundness
        does not depend on the prover's choice of e/sign — any
        (digits, sign, e) satisfying the mod-n congruence computes the
        same [u]-combination, and scalar aliasing by multiples of n is
        harmless."""
        b = self.b
        nn = self.nn_n
        k1, k2 = secp.glv_split(u.value % nn.p)
        zero_c = b.const(0)
        halves, terms = [], []
        for k in (k1, k2):
            s_pos = 1 if k >= 0 else 0
            e = (abs(k) % 2) ^ 1
            v2 = abs(k) + e
            bits, limbs, offs = self.ec._signed_digits_short(v2, self.GLV_DIGITS)
            e_cell = b.assert_bit(b.witness(e))
            s_cell = b.assert_bit(b.witness(s_pos))
            off_total = sum(o << (NN_LIMB_BITS * j) for j, o in enumerate(offs))
            while len(limbs) < 3:
                limbs = limbs + [zero_c]
            v_nn = NnInt(list(limbs), 1 << (NN_LIMB_BITS + 1))
            t = nn.sub(v_nn, nn.load_constant(off_total))
            t = nn.sub(t, NnInt([e_cell, zero_c, zero_c], 2))
            ts = nn.select(s_cell, t, nn.neg(t))
            halves.append((bits, s_cell, e_cell))
            terms.append(ts)
        lam = nn.load_constant(secp.LAMBDA)
        total = nn.add(terms[0], nn.mul(lam, terms[1]))
        nn.mul(total, nn.load_constant(1), sub_out=u)
        return halves

    GLV_DIGITS = 33  # 131-bit capacity for the 128-bit halves + parity bump

    def verify(self, z: NnInt, r: NnInt, s: NnInt,
               pubkey: tuple[int, int]) -> EcPointNN:
        """Constrain ECDSA-verify(z, r, s, pubkey); returns the loaded
        (on-curve-checked) pubkey point for further binding.

        R = u1*G + u2*Q runs GLV-accelerated: both scalars split against
        the secp256k1 endomorphism phi(x,y) = (BETA*x, y) into 128-bit
        halves, so the shared-doubling MSM does 33 rounds of 4 tables
        instead of 66 rounds of 2 — half the in-circuit doublings
        (reference sig-circuit cost scale, VERDICT round-3 item 6)."""
        nn = self.nn_n
        ec = self.ec
        self._assert_nonzero_mod_n(r)
        self._assert_nonzero_mod_n(s)
        w = pow(s.value % nn.p, -1, nn.p)
        u1 = nn.load_witness(z.value % nn.p * w % nn.p)
        u2 = nn.load_witness(r.value % nn.p * w % nn.p)
        nn.mul(u1, s, sub_out=z)
        nn.mul(u2, s, sub_out=r)
        q = ec.load_point(pubkey)
        g = ec.load_constant(secp.G)
        phi_g = ec.load_constant((secp.BETA * secp.G[0] % secp.P, secp.G[1]))
        beta = self.nn_p.load_constant(secp.BETA)
        phi_q = ec._pt(self.nn_p.mul(beta, q.x), q.y)  # phi preserves the curve
        halves = self._glv_scalar(u1) + self._glv_scalar(u2)
        base_pts = [g, phi_g, q, phi_q]
        pts = [
            ec.select(s_cell, p, ec.neg(p))
            for (_bits, s_cell, _e), p in zip(halves, base_pts)
        ]
        rp = ec._msm_from_digits([h[0] for h in halves], pts)
        # parity-bump corrections: subtract e_i * P_i.
        #
        # add_unequal is computed even when e_cell = 0 (result discarded by
        # the select). Soundness is unconditional: add_unequal enforces
        # dx * inv == 1 (ecc.py), so a malicious witness with x(rp) ==
        # x(p) has NO satisfying assignment — the gate cannot be abused to
        # forge a bump. The residual hazard is COMPLETENESS only: an honest
        # run crashes iff x(rp) == x(±p) at a correction step, i.e. the
        # partial MSM output lands exactly on the correction point's x.
        # rp = R' is a deterministic function of (z, r, s, Q) through the
        # GLV digit decomposition; forcing the collision requires finding a
        # VALID signature whose verification walk hits a specific x in Fp —
        # a ~2^-256 event per try with no known structure to grind (the
        # adversary would need preimage control over x(R') vs x(Q), which
        # is the ECDLP-hard relation itself). Accepted as cryptographically
        # unreachable; a complete-add gadget would double the correction
        # cost for no practical gain (ADVICE round-4 low #2).
        for (_bits, _s, e_cell), p in zip(halves, pts):
            cand = ec.add_unequal(rp, ec.neg(p))
            rp = ec.select(e_cell, cand, rp)  # select keeps canonical limbs
        # x_R ≡ r (mod n): x_R is canonical (< p < 2n), so x_R = r + f*n
        # exactly over the integers with a single bit f
        xr = rp.x
        assert xr.max_limb <= NN_BASE, "msm output not canonical"
        f_val = int(xr.value >= secp.N)
        f = self.b.assert_bit(self.b.witness(f_val))
        n_limbs = self.nn_n.p_limbs
        eqs = [
            [(1, xr.limbs[k]), (-1, r.limbs[k]), (-n_limbs[k], f)]
            for k in range(len(n_limbs))
        ]
        self.nn_p._assert_limbs_zero(
            eqs,
            pos_bound=[NN_BASE] * 3,
            neg_bound=[NN_BASE + n_limbs[k] for k in range(3)],
        )
        return q
