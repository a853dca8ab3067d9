"""MockProver: constraint-satisfaction checking without proving.

Functional mirror of halo2's MockProver as the reference consumes it
(integration/src/mock.rs:22-23 `MockProver::run(...).verify_par()`,
SURVEY.md section 3.5): evaluate every gate on every usable row, check every
copy constraint and lookup containment, and report per-failure details.

Host-side (numpy object arrays of ints): witness debugging wants arbitrary
breakpoints and exact row reporting, not device throughput.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...fields.bn254 import FR_MOD
from .cs import Circuit, ConstraintSystem


@dataclass
class Failure:
    kind: str  # "gate" | "copy" | "lookup"
    name: str
    row: int
    detail: str = ""

    def __str__(self):
        return f"{self.kind} '{self.name}' violated at row {self.row} {self.detail}"


class MockProver:
    def __init__(self, cs: ConstraintSystem, n: int, tables: dict, instance):
        self.cs = cs
        self.n = n
        self.fixed = tables["fixed"]
        self.advice = tables["advice"]
        self.instance = instance

    @classmethod
    def run(cls, k: int, circuit: Circuit, instance) -> "MockProver":
        cs = ConstraintSystem()
        circuit.configure(cs)
        n = 1 << k
        inst = _pad_instance(cs, n, instance)
        tables = circuit.assign(cs, n, inst)
        return cls(cs, n, tables, inst)

    # -- checking ---------------------------------------------------------
    def _value(self, kind: str, col: int, rot: int, row: int) -> int:
        r = (row + rot) % self.n
        if kind == "fixed":
            return int(self.fixed[col][r])
        if kind == "advice":
            return int(self.advice[col][r])
        return int(self.instance[col][r])

    def verify(self) -> list[Failure]:
        cs, n = self.cs, self.n
        failures: list[Failure] = []
        usable = cs.usable_rows(n)

        for name, expr in cs.gates:
            for row in range(usable):
                v = expr.evaluate(
                    constant=lambda c: c % FR_MOD,
                    query=lambda k, c, r, _row=row: self._value(k, c, r, _row),
                    challenge=lambda i: 1,  # challenges unused in mock gates
                    add=lambda a, b: (a + b) % FR_MOD,
                    mul=lambda a, b: (a * b) % FR_MOD,
                    neg=lambda a: (-a) % FR_MOD,
                )
                if v != 0:
                    failures.append(Failure("gate", name, row, f"= {v}"))

        for (ca, ra), (cb, rb) in cs.copies:
            va = self._value(ca.kind, ca.index, 0, ra)
            vb = self._value(cb.kind, cb.index, 0, rb)
            if va != vb:
                failures.append(
                    Failure(
                        "copy",
                        f"{ca.kind}{ca.index}[{ra}] = {cb.kind}{cb.index}[{rb}]",
                        ra,
                        f"{va} != {vb}",
                    )
                )

        # lookup argument covers rows 0..usable-2 (the grand-product range)
        for lk in cs.lookups:
            table_rows = set()
            for row in range(usable - 1):
                table_rows.add(
                    tuple(self._eval_expr(e, row) for e in lk.tables)
                )
            for row in range(usable - 1):
                tup = tuple(self._eval_expr(e, row) for e in lk.inputs)
                if tup not in table_rows:
                    failures.append(
                        Failure("lookup", lk.name, row, f"{tup} not in table")
                    )
        return failures

    # -- vectorized checking (the reference's verify_par entry point,
    # integration/src/mock.rs:23) -----------------------------------------

    def _col_view(self, kind: str, col: int):
        if kind == "fixed":
            return self.fixed[col]
        if kind == "advice":
            return self.advice[col]
        return self.instance[col]

    def _eval_expr_vec(self, expr, usable: int):
        """Evaluate an expression over rows [0, usable) as a numpy object
        array of ints (mod-reduced after every node)."""
        n = self.n

        def q(kind, col, rot):
            arr = self._col_view(kind, col)
            if rot:
                arr = np.roll(arr, -rot)
            return arr[:usable]

        out = expr.evaluate(
            constant=lambda c: c % FR_MOD,
            query=q,
            challenge=lambda i: 1,
            add=lambda a, b: (a + b) % FR_MOD,
            mul=lambda a, b: (a * b) % FR_MOD,
            neg=lambda a: (-a) % FR_MOD,
        )
        if not isinstance(out, np.ndarray):
            out = np.full(usable, out % FR_MOD, dtype=object)
        return out

    def verify_par(self, max_failures: int = 50) -> list[Failure]:
        """Vectorized verify: every gate / copy / lookup checked over whole
        columns with numpy object arithmetic — minutes at k=20 where the
        row-loop verify() is infeasible (the production mock tier,
        mirroring the reference's MockProver::verify_par)."""
        cs, n = self.cs, self.n
        failures: list[Failure] = []
        usable = cs.usable_rows(n)

        for name, expr in cs.gates:
            v = self._eval_expr_vec(expr, usable)
            bad = np.nonzero(v)[0]
            for row in bad[: max(max_failures - len(failures), 0)]:
                failures.append(Failure("gate", name, int(row), f"= {v[row]}"))
            if len(failures) >= max_failures:
                return failures

        if cs.copies:
            m = len(cs.copies)
            va = np.empty(m, dtype=object)
            vb = np.empty(m, dtype=object)
            for i, ((ca, ra), (cb, rb)) in enumerate(cs.copies):
                va[i] = self._col_view(ca.kind, ca.index)[ra % n]
                vb[i] = self._col_view(cb.kind, cb.index)[rb % n]
            bad = np.nonzero(va != vb)[0]
            for i in bad[: max(max_failures - len(failures), 0)]:
                (ca, ra), (cb, rb) = cs.copies[i]
                failures.append(
                    Failure(
                        "copy",
                        f"{ca.kind}{ca.index}[{ra}] = {cb.kind}{cb.index}[{rb}]",
                        ra,
                        f"{va[i]} != {vb[i]}",
                    )
                )
            if len(failures) >= max_failures:
                return failures

        for lk in cs.lookups:
            t_cols = [self._eval_expr_vec(e, usable - 1) for e in lk.tables]
            i_cols = [self._eval_expr_vec(e, usable - 1) for e in lk.inputs]
            table = set(zip(*(c.tolist() for c in t_cols)))
            inputs = list(zip(*(c.tolist() for c in i_cols)))
            for row, tup in enumerate(inputs):
                if tup not in table:
                    failures.append(
                        Failure("lookup", lk.name, row, f"{tup} not in table")
                    )
                    if len(failures) >= max_failures:
                        return failures
        return failures

    def _eval_expr(self, expr, row: int) -> int:
        return expr.evaluate(
            constant=lambda c: c % FR_MOD,
            query=lambda k, c, r: self._value(k, c, r, row),
            challenge=lambda i: 1,
            add=lambda a, b: (a + b) % FR_MOD,
            mul=lambda a, b: (a * b) % FR_MOD,
            neg=lambda a: (-a) % FR_MOD,
        )

    def assert_satisfied(self):
        fails = self.verify()
        if fails:
            msg = "\n".join(str(f) for f in fails[:20])
            raise AssertionError(f"{len(fails)} constraint failures:\n{msg}")


def _pad_instance(cs: ConstraintSystem, n: int, instance) -> np.ndarray:
    inst = np.empty((cs.num_instance, n), dtype=object)
    inst[:] = 0
    for i, col in enumerate(instance or []):
        for j, v in enumerate(col):
            inst[i][j] = int(v) % FR_MOD
    return inst
