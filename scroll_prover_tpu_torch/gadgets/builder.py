"""Row-oriented arithmetic chip: the gadget substrate.

LANES parallel copies of one wide custom gate, each over 5 advice columns
w0..w4 with per-row fixed coefficients (all fixed columns, zero outside
used rows, so the gate vanishes on blinding rows):

    qm*(w0*w1) + qm2*(w2*w3) + qa*w0 + qb*w1 + qc*w2 + qd*w3 + qe*w4 + qk = 0

plus a boolean toggle gate `qbool * w0 * (w0 - 1)` per lane. Primitive ops
are dealt round-robin across lanes, so a gadget program of N ops occupies
ceil(N / lanes) rows — the width/rows trade the reference tunes with
num_advice in its layer configs (integration/configs/layer*.config; zkevm-circuits' sig circuit packs ~100 advice columns the
same way). Range checks live on a SEPARATE set of lookup-advice columns
(halo2-base's num_lookup_advice design): each lookup column carries one
fixed-selector lookup into the shared 2^lookup_bits table, and range
chunks fill lookup slots round-robin with their own row cursor — so the
lookup-argument count is set by `lookup_cols`, not by lane count, and
range-heavy programs advance the two cursors independently.

Values flow between rows/lanes via copy (permutation) constraints — the
flattened-layouter equivalent of halo2-base's vertical gate (SURVEY.md
section 2.2 halo2-base row).

The builder runs the SAME op sequence at keygen (dummy witness) and prove
time; fixed-column content derives only from the op sequence, so circuit
programs must be value-independent (no branching on witness values).

Shape knobs: `lanes` / `lookup_cols` arguments, or SPT_BUILDER_LANES /
SPT_BUILDER_LOOKUP_COLS env defaults.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from ..fields.bn254 import FR_MOD
from ..proof_system.plonk.cs import ConstraintSystem


@dataclass(frozen=True)
class Cell:
    col: object  # ColumnRef
    row: int
    val: int  # witness value mod FR_MOD (host-side shadow)


# fixed-coefficient slots, in declaration order
_COEFFS = ("qm", "qm2", "qa", "qb", "qc", "qd", "qe", "qk")


class Builder:
    """Declares columns/gates (configure) and assigns rows (assign)."""

    W = 5

    def configure(
        self,
        cs: ConstraintSystem,
        lookup_bits: int = 12,
        lanes: int | None = None,
        lookup_cols: int | None = None,
    ):
        self.lookup_bits = lookup_bits
        self.lanes = (
            lanes
            if lanes is not None
            else max(int(os.environ.get("SPT_BUILDER_LANES", "1")), 1)
        )
        if lookup_cols is None:
            lookup_cols = int(
                os.environ.get("SPT_BUILDER_LOOKUP_COLS", str(4 * self.lanes))
            )
        self.n_lookup = max(min(lookup_cols, 64), 1)
        self.w = []      # lane -> [5 advice columns]
        self.q = []      # lane -> {coeff name -> fixed column}
        self.qbool = []  # lane -> fixed column
        for _lane in range(self.lanes):
            wl = [cs.advice_column() for _ in range(self.W)]
            ql = {name: cs.fixed_column() for name in _COEFFS}
            qb = cs.fixed_column()
            self.w.append(wl)
            self.q.append(ql)
            self.qbool.append(qb)
            for wc in wl:
                cs.enable_permutation(wc)
            qq = {k: c.query() for k, c in ql.items()}
            wq = [c.query() for c in wl]
            cs.gate(
                f"gadget/arith{_lane}",
                qq["qm"] * (wq[0] * wq[1]) + qq["qm2"] * (wq[2] * wq[3])
                + qq["qa"] * wq[0] + qq["qb"] * wq[1] + qq["qc"] * wq[2]
                + qq["qd"] * wq[3] + qq["qe"] * wq[4] + qq["qk"],
            )
            cs.gate(f"gadget/bool{_lane}", qb.query() * wq[0] * (wq[0] - 1))
        self.range_table = cs.fixed_column()
        self.lk = [cs.advice_column() for _ in range(self.n_lookup)]
        self.q_lk = [cs.fixed_column() for _ in range(self.n_lookup)]
        for j in range(self.n_lookup):
            cs.enable_permutation(self.lk[j])
            cs.lookup(
                f"gadget/range_lk{j}",
                [self.q_lk[j].query() * self.lk[j].query()],
                [self.range_table.query()],
            )
        return self

    # -- assignment --------------------------------------------------------

    def begin(self, cs: ConstraintSystem, fixed, adv, n: int, row0: int):
        self.cs = cs
        self.fixed = fixed
        self.adv = adv
        self.n = n
        self.row0 = row0
        self._op = 0       # arithmetic op counter (round-robin over lanes)
        self._lkslot = 0   # range-chunk counter (round-robin over lk cols)
        for v in range(1 << self.lookup_bits):
            fixed[self.range_table.index][v] = v
        return self

    @property
    def row(self) -> int:
        """Next free arithmetic row (absolute)."""
        return self.row0 + (self._op + self.lanes - 1) // self.lanes

    def rows_used(self) -> int:
        arith = (self._op + self.lanes - 1) // self.lanes
        rng = (self._lkslot + self.n_lookup - 1) // self.n_lookup
        return self.row0 + max(arith, rng)

    def _emit(self, coeffs: dict, vals: list, copies=(), qbool: bool = False) -> list[Cell]:
        """One gate row on the next round-robin lane. vals[i] may be None
        (unused slot -> 0). copies is a list of (slot, Cell)
        equal-constraints."""
        lane = self._op % self.lanes
        r = self.row0 + self._op // self.lanes
        assert r < self.n - 8, "gadget region overflow"
        cells = []
        for i in range(self.W):
            v = int(vals[i]) % FR_MOD if vals[i] is not None else 0
            self.adv[self.w[lane][i].index][r] = v
            cells.append(Cell(self.w[lane][i], r, v))
        for name, cv in coeffs.items():
            self.fixed[self.q[lane][name].index][r] = int(cv) % FR_MOD
        for slot, src in copies:
            self.cs.copy(self.w[lane][slot], r, src.col, src.row)
        if qbool:
            self.fixed[self.qbool[lane].index][r] = 1
        self._op += 1
        return cells

    # -- primitive ops -----------------------------------------------------

    def const(self, v: int) -> Cell:
        v = int(v) % FR_MOD
        c = self._emit({"qa": 1, "qk": -v}, [v, None, None, None, None])
        return c[0]

    def add(self, a: Cell, b: Cell) -> Cell:
        out = (a.val + b.val) % FR_MOD
        c = self._emit(
            {"qa": 1, "qb": 1, "qe": -1},
            [a.val, b.val, None, None, out],
            copies=[(0, a), (1, b)],
        )
        return c[4]

    def sub(self, a: Cell, b: Cell) -> Cell:
        out = (a.val - b.val) % FR_MOD
        c = self._emit(
            {"qa": 1, "qb": -1, "qe": -1},
            [a.val, b.val, None, None, out],
            copies=[(0, a), (1, b)],
        )
        return c[4]

    def mul(self, a: Cell, b: Cell) -> Cell:
        out = a.val * b.val % FR_MOD
        c = self._emit(
            {"qm": 1, "qe": -1},
            [a.val, b.val, None, None, out],
            copies=[(0, a), (1, b)],
        )
        return c[4]

    def mul_add(self, a: Cell, b: Cell, d: Cell) -> Cell:
        """a*b + d."""
        out = (a.val * b.val + d.val) % FR_MOD
        c = self._emit(
            {"qm": 1, "qd": 1, "qe": -1},
            [a.val, b.val, None, d.val, out],
            copies=[(0, a), (1, b), (3, d)],
        )
        return c[4]

    def lin(self, terms: list[tuple[int, Cell]], k: int = 0) -> Cell:
        """sum coeff_i * cell_i + k. Chains rows 4 terms at a time."""
        acc: Cell | None = None
        pending = list(terms)
        kk = int(k) % FR_MOD
        while True:
            batch, pending = pending[:3], pending[3:]
            slots = [None, None, None, None, None]
            coeffs = {"qe": -1}
            copies = []
            out = kk if acc is None else (kk + acc.val) % FR_MOD
            names = ("qa", "qb", "qc", "qd")
            idx = 0
            if acc is not None:
                slots[idx] = acc.val
                coeffs[names[idx]] = 1
                copies.append((idx, acc))
                idx += 1
            for co, cell in batch:
                slots[idx] = cell.val
                coeffs[names[idx]] = int(co) % FR_MOD
                copies.append((idx, cell))
                out = (out + co * cell.val) % FR_MOD
                idx += 1
            if kk:
                coeffs["qk"] = kk
                kk = 0
            slots[4] = out
            acc = self._emit(coeffs, slots, copies=copies)[4]
            if not pending:
                return acc

    def assert_lin_zero(self, terms: list[tuple[int, Cell]], k: int = 0):
        """Constrain sum coeff_i * cell_i + k == 0 (chained; final row has
        no output slot)."""
        if len(terms) > 4:
            head = self.lin(terms[:3], k)
            return self.assert_lin_zero([(1, head)] + terms[3:], 0)
        slots = [None] * self.W
        coeffs = {}
        copies = []
        names = ("qa", "qb", "qc", "qd")
        acc = int(k) % FR_MOD
        for i, (co, cell) in enumerate(terms):
            slots[i] = cell.val
            coeffs[names[i]] = int(co) % FR_MOD
            copies.append((i, cell))
            acc = (acc + co * cell.val) % FR_MOD
        if k:
            coeffs["qk"] = int(k) % FR_MOD
        assert acc % FR_MOD == 0, "assert_lin_zero: unsatisfied (witness bug)"
        self._emit(coeffs, slots, copies=copies)

    def assert_equal(self, a: Cell, b: Cell):
        assert a.val == b.val, "assert_equal: unsatisfied (witness bug)"
        self.cs.copy(a.col, a.row, b.col, b.row)

    def assert_mul(self, a: Cell, b: Cell, prod: Cell):
        """Constrain a*b == prod without allocating an output."""
        assert a.val * b.val % FR_MOD == prod.val, "assert_mul unsatisfied"
        self._emit(
            {"qm": 1, "qc": -1},
            [a.val, b.val, prod.val, None, None],
            copies=[(0, a), (1, b), (2, prod)],
        )

    def dot_acc(self, pairs: list[tuple[Cell, Cell]], init: Cell | None = None) -> Cell:
        """sum a_i*b_i (+ init): two products per row, accumulator chained
        through w2 (qc slot) so each row is out = a0*b0 + a1*b1 + acc."""
        acc = init
        pending = list(pairs)
        if not pending:
            return acc if acc is not None else self.const(0)
        while pending:
            batch, pending = pending[:2], pending[2:]
            slots = [None] * self.W
            coeffs = {"qe": -1}
            copies = []
            out = acc.val if acc is not None else 0
            a0, b0 = batch[0]
            slots[0], slots[1] = a0.val, b0.val
            coeffs["qm"] = 1
            copies += [(0, a0), (1, b0)]
            out = (out + a0.val * b0.val) % FR_MOD
            if len(batch) == 2:
                a1, b1 = batch[1]
                slots[2], slots[3] = a1.val, b1.val
                coeffs["qm2"] = 1
                copies += [(2, a1), (3, b1)]
                out = (out + a1.val * b1.val) % FR_MOD
                if acc is not None:
                    # no free input slot this row: fold acc via an add row
                    slots[4] = (out - acc.val) % FR_MOD
                    t = self._emit(coeffs, slots, copies=copies)[4]
                    acc = self.add(acc, t)
                    continue
            elif acc is not None:
                slots[2] = acc.val
                coeffs["qc"] = 1
                copies.append((2, acc))
            slots[4] = out
            acc = self._emit(coeffs, slots, copies=copies)[4]
        return acc

    def witness(self, v: int) -> Cell:
        """Unconstrained advice cell (callers must constrain it)."""
        c = self._emit({}, [int(v) % FR_MOD, None, None, None, None])
        return c[0]

    def assert_bit(self, c: Cell):
        """Boolean-constrain a cell in place: re-expose it on a qbool row."""
        out = self._emit(
            {}, [c.val, None, None, None, None], copies=[(0, c)], qbool=True
        )
        return out[0]

    def select(self, bit: Cell, a: Cell, b: Cell) -> Cell:
        """bit ? a : b  (bit must already be boolean-constrained)."""
        d = self.sub(a, b)
        return self.mul_add(bit, d, b)

    def is_zero(self, a: Cell) -> Cell:
        """1 if a == 0 else 0. inv is a free witness: z = 1 - a*inv forces
        z=0 when a!=0 (via a*z=0), z=1 when a=0."""
        inv = pow(a.val, -1, FR_MOD) if a.val else 0
        z_val = 0 if a.val else 1
        z = self._emit(
            {"qm": 1, "qe": 1, "qk": -1},
            [a.val, inv, None, None, z_val],
            copies=[(0, a)],
        )[4]
        self._emit(
            {"qm": 1}, [a.val, z.val, None, None, None], copies=[(0, a), (1, z)]
        )
        return z

    # -- range machinery ---------------------------------------------------

    def _lk_slot(self, v: int) -> Cell:
        """Place a value in the next lookup-advice slot (range-checked to
        lookup_bits by the column's lookup argument)."""
        assert 0 <= int(v) < (1 << self.lookup_bits)
        j = self._lkslot % self.n_lookup
        r = self.row0 + self._lkslot // self.n_lookup
        assert r < self.n - 8, "lookup region overflow"
        self.adv[self.lk[j].index][r] = int(v)
        self.fixed[self.q_lk[j].index][r] = 1
        self._lkslot += 1
        return Cell(self.lk[j], r, int(v))

    def range_row(self, vals: list[int]) -> list[Cell]:
        """Range-checked witnesses (lookup-advice slots)."""
        return [self._lk_slot(v) for v in vals]

    def range_check(self, c: Cell, bits: int) -> None:
        """Constrain c < 2^bits via lookup_bits-chunk decomposition."""
        b = self.lookup_bits
        n_chunks = (bits + b - 1) // b
        v = c.val
        assert v < (1 << bits), f"range_check witness {v} >= 2^{bits}"
        chunks = [(v >> (b * i)) & ((1 << b) - 1) for i in range(n_chunks)]
        top_bits = bits - b * (n_chunks - 1)
        chunk_cells = [self._lk_slot(ch) for ch in chunks]
        if top_bits < b:
            # shifted top chunk must also be < 2^b  =>  top < 2^top_bits
            shifted = chunks[-1] << (b - top_bits)
            sc = self._lk_slot(shifted)
            self.assert_lin_zero(
                [(1 << (b - top_bits), chunk_cells[-1]), (-1, sc)]
            )
        # recomposition: sum chunk_i * 2^(b i) == c
        self.assert_lin_zero(
            [(1 << (b * i), cc) for i, cc in enumerate(chunk_cells)] + [(-1, c)]
        )

    def witness_ranged(self, v: int, bits: int) -> Cell:
        if bits <= self.lookup_bits:
            c = self._lk_slot(int(v))
            if bits < self.lookup_bits:
                sc = self._lk_slot(int(v) << (self.lookup_bits - bits))
                self.assert_lin_zero(
                    [(1 << (self.lookup_bits - bits), c), (-1, sc)]
                )
            return c
        c = self.witness(v)
        self.range_check(c, bits)
        return c

    def decompose_bits(self, c: Cell, n_bits: int) -> list[Cell]:
        """LSB-first boolean decomposition of c (must satisfy c < 2^n_bits)."""
        v = c.val
        assert v < (1 << n_bits)
        bits = []
        for i in range(n_bits):
            bc = self.witness((v >> i) & 1)
            bits.append(self.assert_bit(bc))
        self.assert_lin_zero(
            [(1 << i, bc) for i, bc in enumerate(bits)] + [(-1, c)]
        )
        return bits

    def expose_public(self, c: Cell, instance_col, instance_row: int):
        self.cs.copy(instance_col, instance_row, c.col, c.row)
