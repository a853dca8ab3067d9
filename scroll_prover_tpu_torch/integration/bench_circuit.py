"""BenchCircuit: the gate + lookup + copy workload of the JAX package's k=20
prove stage (bench.py `stage_prove20`), with its row count a constructor
argument so a test can run it at a small degree.

The protocol cost of a prove is set by the degree and the column count, not
by the gate content: 3 advice, 1 selector, 1 fixed table, 1 instance column,
one degree-3 gate, one lookup and one copy.
"""
from __future__ import annotations

from ..fields.bn254 import FR_MOD
from ..proof_system.plonk.cs import Circuit, empty_assignment


class BenchCircuit(Circuit):
    def __init__(self, rows: int = 4096):
        self.rows = rows

    def configure(self, cs):
        self.a = cs.advice_column()
        self.b = cs.advice_column()
        self.c = cs.advice_column()
        self.sel = cs.selector()
        self.tbl = cs.fixed_column()
        self.pi = cs.instance_column()
        cs.gate("mul", self.sel.query() * (self.a.query() * self.b.query() - self.c.query()))
        cs.lookup("a_range", [self.sel.query() * self.a.query()], [self.tbl.query()])

    def assign(self, cs, n, instance):
        rows = self.rows
        if 2 * rows > cs.usable_rows(n):
            raise ValueError(f"{rows} rows need a table of {2 * rows} usable rows; n={n}")
        fixed = empty_assignment(cs.num_fixed, n)
        advice = empty_assignment(cs.num_advice, n)
        pi0 = int(instance[self.pi.index][0])
        for i in range(rows):
            a = (pi0 + i) % (2 * rows)
            b = i + 5
            advice[self.a.index][i] = a
            advice[self.b.index][i] = b
            advice[self.c.index][i] = a * b % FR_MOD
            fixed[self.sel.index][i] = 1
        for i in range(2 * rows):
            fixed[self.tbl.index][i] = i
        cs.copy(self.pi, 0, self.a, 0)  # idempotent (cs dedupes)
        return {"fixed": fixed, "advice": advice}
