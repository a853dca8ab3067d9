"""Constraint system + circuit/assignment model.

A ConstraintSystem declares columns, gates, copy constraints, and lookups; a
Circuit configures one and produces a full assignment (host numpy object
arrays of python ints — field elements). This replaces halo2's
ConstraintSystem/Layouter as consumed by the reference's circuits
(SURVEY.md L1/L3a); the region/layouter machinery is deliberately flattened:
TPU witness generation wants whole-column tables, not cell-by-cell closures.

Row layout (halo2-compatible): the last `blinding_factors + 1` rows of every
advice column are blinding rows; usable rows = n - (blinding_factors + 1).
l_last marks row u = usable_rows - 1... (halo2: l_last at index u; active
gate rows are 0..u-1 for lookups/permutation wrap).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ...fields.bn254 import FR_MOD
from .expression import Advice, Expression, Fixed, Instance


@dataclass(frozen=True)
class ColumnRef:
    kind: str  # "fixed" | "advice" | "instance"
    index: int

    def query(self, rot: int = 0) -> Expression:
        return {"fixed": Fixed, "advice": Advice, "instance": Instance}[self.kind](
            self.index, rot
        )


@dataclass
class Lookup:
    name: str
    inputs: list[Expression]
    tables: list[Expression]


class ConstraintSystem:
    def __init__(self):
        self.num_fixed = 0
        self.num_advice = 0
        self.num_instance = 0
        self.num_challenges = 0
        self.gates: list[tuple[str, Expression]] = []
        self.lookups: list[Lookup] = []
        # permutation: columns participating in copy constraints
        self.perm_columns: list[ColumnRef] = []
        # copies: list of ((colref, row), (colref, row))
        self.copies: list[tuple[tuple[ColumnRef, int], tuple[ColumnRef, int]]] = []
        self._copy_set: set = set()

    # -- declaration ------------------------------------------------------
    def fixed_column(self) -> ColumnRef:
        self.num_fixed += 1
        return ColumnRef("fixed", self.num_fixed - 1)

    def advice_column(self) -> ColumnRef:
        self.num_advice += 1
        return ColumnRef("advice", self.num_advice - 1)

    def instance_column(self) -> ColumnRef:
        self.num_instance += 1
        return ColumnRef("instance", self.num_instance - 1)

    def selector(self) -> ColumnRef:
        return self.fixed_column()

    def challenge(self) -> int:
        self.num_challenges += 1
        return self.num_challenges - 1

    def gate(self, name: str, exprs):
        if isinstance(exprs, Expression):
            exprs = [exprs]
        for i, e in enumerate(exprs):
            self.gates.append((f"{name}[{i}]" if len(exprs) > 1 else name, e))

    def lookup(self, name: str, inputs, tables):
        assert len(inputs) == len(tables)
        self.lookups.append(Lookup(name, list(inputs), list(tables)))

    def enable_permutation(self, col: ColumnRef):
        # set-backed membership: the list scan was 80 s of a production
        # assignment (7.4M calls x ~250 columns, round-5 profile)
        seen = getattr(self, "_perm_set", None)
        if seen is None:
            seen = self._perm_set = set(self.perm_columns)
        if col not in seen:
            seen.add(col)
            self.perm_columns.append(col)

    def copy(self, a: ColumnRef, a_row: int, b: ColumnRef, b_row: int):
        """Constrain cell (a, a_row) == (b, b_row). Idempotent: re-registering
        an identical copy is ignored, because keygen's sigma construction is a
        cycle SPLICE (keygen._build_next) — applying the same transposition
        twice would undo it. This lets circuits register data-dependent copies
        inside assign(), which runs once in keygen and again in prove()."""
        # keyed by the columns' (kind, index): a gadget pass registers
        # millions of copies, and a ColumnRef's generated hash is Python code
        ka, kb = (a.kind, a.index), (b.kind, b.index)
        copy_set = self._copy_set
        n_before = len(copy_set)
        copy_set.add((ka, a_row, kb, b_row))
        if len(copy_set) == n_before:
            return
        perm = self.__dict__.get("_perm_keys")
        if perm is None or ka not in perm or kb not in perm:
            self.enable_permutation(a)
            self.enable_permutation(b)
            self._perm_keys = {(c.kind, c.index) for c in self.perm_columns}
        self.copies.append(((a, a_row), (b, b_row)))

    # -- shape ------------------------------------------------------------
    def max_gate_degree(self) -> int:
        """Degree budget of the quotient's terms (it sets the extended
        domain, the quotient's piece count and the permutation chunk): the
        gates' degree, at least 3, and each lookup's term
        l_active * z * (input + beta) * (table + gamma), of degree
        2 + deg(input) + deg(table). The JAX package counts the gates only,
        so a circuit whose lookups exceed its gates' budget (the super
        circuit's evm/push_immediate: 2 + 4 + 3 = 9 against 5) gets a
        quotient too short to verify there; here its budget covers them."""
        d = max((e.degree() for _, e in self.gates), default=1)
        for lk in self.lookups:
            d = max(d, 2 + max(e.degree() for e in lk.inputs) + max(e.degree() for e in lk.tables))
        # permutation/lookup arguments contribute degree perm_chunk + 2
        return max(d, 3)

    def blinding_factors(self) -> int:
        # halo2: enough blinding rows for ZK across all queried rotations;
        # a small fixed count covers our query patterns
        return 5

    def usable_rows(self, n: int) -> int:
        return n - (self.blinding_factors() + 1)


class Circuit:
    """Subclass: implement configure() and assign().

    configure(cs) declares columns/gates/lookups; assign(cs, n, instance)
    returns {"fixed": (num_fixed, n) object array, "advice": ..., and
    registers copies via cs.copy during assignment if data-dependent}.
    """

    def configure(self, cs: ConstraintSystem):  # pragma: no cover
        raise NotImplementedError

    def assign(self, cs: ConstraintSystem, n: int, instance):  # pragma: no cover
        raise NotImplementedError


def empty_assignment(num_cols: int, n: int) -> np.ndarray:
    return np.zeros((num_cols, n), dtype=object)  # python int 0 in every cell
