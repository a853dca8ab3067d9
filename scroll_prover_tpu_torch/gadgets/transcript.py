"""In-circuit duplex Poseidon transcript (the halo2-loader transcript).

Constrained mirror of proof_system/transcript.PoseidonTranscript: same
state machine (t=3 rate-2 duplex over Fr, queue drained at each squeeze
after a constant `1` separation marker), so the challenges an outer
circuit derives in-constraints equal the ones the host prover/verifier
derive for the inner proof. Role parity: snark-verifier's
`PoseidonTranscript<NativeLoader/...>` used by the reference's
aggregation circuits for layers 1-5 (SURVEY.md section 2.2
snark-verifier row).

Layout: one contiguous region in the PoseidonSubCircuit's columns —
absorb row (sel_absorb adds the two copy-constrained elem cells into the
state) followed by 65 constrained permutation rows per rate-2 chunk; the
first absorb row is pinned to the zero state by sel_init. Challenge
cells are the region's s[0] output cells; absorbed values are Builder
cells copy-bound into the elem columns.
"""
from __future__ import annotations

from ..fields.bn254 import FQ_MOD, FR_MOD
from ..hashes.poseidon import poseidon_fr
from .builder import Builder, Cell
from .ecc import EccChip, EcPointNN
from .nonnative import NN_LIMB_BITS

_MASK128 = (1 << 128) - 1


class InCircuitTranscript:
    """Reader-mode transcript over a proof byte string."""

    def __init__(
        self,
        b: Builder,
        pos,  # PoseidonSubCircuit (configured)
        proof: bytes,
        row0: int = 0,
    ):
        self.b = b
        self.pos = pos
        self.cs = b.cs
        self.fixed = b.fixed
        self.adv = b.adv
        self._proof = memoryview(proof)
        self._pos = 0
        self._row = row0
        self._state = [0, 0, 0]
        self._pending: list[Cell] = []
        self._started = False

    # -- sponge region emission -------------------------------------------

    def _emit_chunk(self, e0: Cell, e1: Cell | None):
        """One absorb row + 65 permutation rows in the poseidon columns."""
        pos, adv, fixed = self.pos, self.adv, self.fixed
        r = self._row
        if not self._started:
            fixed[pos.sel_init.index][r] = 1
            self._started = True
        s = self._state
        for j in range(3):
            adv[pos.s[j].index][r] = s[j]
        adv[pos.elem[0].index][r] = e0.val
        self.cs.copy(pos.elem[0], r, e0.col, e0.row)
        e1v = e1.val if e1 is not None else 0
        adv[pos.elem[1].index][r] = e1v
        if e1 is not None:
            self.cs.copy(pos.elem[1], r, e1.col, e1.row)
        else:
            # rate-1 tail chunk: elem1 must be constrained to zero
            z = self.b.const(0)
            self.cs.copy(pos.elem[1], r, z.col, z.row)
        fixed[pos.sel_absorb.index][r] = 1
        r += 1
        s = [(s[0] + e0.val) % FR_MOD, (s[1] + e1v) % FR_MOD, s[2]]
        h = poseidon_fr
        half = h.r_f // 2
        rnd = 0
        for phase, count in ((0, half), (1, h.r_p), (0, half)):
            for _k in range(count):
                rcs = h.rc[rnd]
                for j in range(3):
                    adv[pos.s[j].index][r] = s[j]
                    fixed[pos.rc[j].index][r] = rcs[j]
                sbox_in = [(s[j] + rcs[j]) % FR_MOD for j in range(3)]
                for j in (range(3) if phase == 0 else (0,)):
                    x2 = sbox_in[j] * sbox_in[j] % FR_MOD
                    adv[pos.x2[j].index][r] = x2
                    adv[pos.x4[j].index][r] = x2 * x2 % FR_MOD
                if phase == 0:
                    fixed[pos.sel_full.index][r] = 1
                    sboxed = [pow(x, 5, FR_MOD) for x in sbox_in]
                else:
                    fixed[pos.sel_part.index][r] = 1
                    sboxed = [pow(sbox_in[0], 5, FR_MOD), sbox_in[1], sbox_in[2]]
                s = [
                    sum(h.mds[i][j] * sboxed[j] for j in range(3)) % FR_MOD
                    for i in range(3)
                ]
                rnd += 1
                r += 1
        for j in range(3):
            adv[pos.s[j].index][r] = s[j]
        self._state = s
        self._row = r  # output row doubles as the next absorb row

    def _drain(self):
        q, self._pending = self._pending, []
        for i in range(0, len(q), 2):
            self._emit_chunk(q[i], q[i + 1] if i + 1 < len(q) else None)

    # -- transcript surface ------------------------------------------------

    def common_scalar_cell(self, c: Cell):
        self._pending.append(c)

    def common_scalar_const(self, v: int) -> Cell:
        c = self.b.const(v)
        self._pending.append(c)
        return c

    def common_point_cells(self, cells: list[Cell]):
        """Absorb a point already split into [x_lo, x_hi, y_lo, y_hi]."""
        assert len(cells) == 4
        self._pending.extend(cells)

    def absorb_point(self, p: EcPointNN):
        """Split an in-circuit point's coordinates into 128-bit halves
        (matching the host transcript's encoding) and absorb them."""
        for coord in (p.x, p.y):
            self._pending.extend(self._split_coord(coord))

    def _split_coord(self, nn_val) -> list[Cell]:
        """(l0,l1,l2) 88-bit limbs -> (lo128, hi) with
        lo = l0 + 2^88 * (l1 mod 2^40), hi = (l1 >> 40) + 2^48 * l2."""
        b = self.b
        l0, l1, l2 = nn_val.limbs
        assert nn_val.max_limb <= (1 << NN_LIMB_BITS)
        a_v = l1.val & ((1 << 40) - 1)
        c_v = l1.val >> 40
        a = b.witness_ranged(a_v, 40)
        cc = b.witness_ranged(c_v, 48)
        b.assert_lin_zero([(1, a), (1 << 40, cc), (-1, l1)])
        lo = b.lin([(1, l0), (1 << 88, a)])
        hi = b.lin([(1, cc), (1 << 48, l2)])
        return [lo, hi]

    def read_scalar(self) -> Cell:
        raw = bytes(self._proof[self._pos : self._pos + 32])
        self._pos += 32
        v = int.from_bytes(raw, "little")
        assert v < FR_MOD, "proof scalar out of range"
        c = self.b.witness(v)
        self._pending.append(c)
        return c

    def read_point(self, ec: EccChip) -> EcPointNN:
        raw = bytes(self._proof[self._pos : self._pos + 64])
        self._pos += 64
        x = int.from_bytes(raw[:32], "little")
        y = int.from_bytes(raw[32:], "little")
        assert not (x == 0 and y == 0), (
            "identity commitment in proof (not representable in-circuit)"
        )
        assert x < FQ_MOD and y < FQ_MOD, "point coordinate out of range"
        p = ec.load_point((x, y))  # on-curve constrained
        self.absorb_point(p)
        return p

    def squeeze(self) -> Cell:
        one = self.b.const(1)
        self._pending.append(one)
        self._drain()
        return Cell(self.pos.s[0], self._row, self._state[0])

    def rows_used(self) -> int:
        return self._row + 1
