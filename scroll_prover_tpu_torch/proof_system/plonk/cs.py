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

from ... import trace
from ...fields.bn254 import FR_MOD
from ...fields.limbs import objcol_to_packed
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


def packed_column(col) -> np.ndarray:
    """Assignment column -> (n, 8) packed standard-form words: a column the
    assignment cache gave back is packed already (possibly a read-only
    memory map), anything else is converted."""
    if isinstance(col, np.ndarray) and col.dtype == np.uint32 and col.ndim == 2:
        return col
    with trace.span("codec", elements=len(col)):
        return objcol_to_packed(col)


def assign_cached(circuit: Circuit, cs: ConstraintSystem, n: int, instance):
    """circuit.assign with an optional disk cache (SPT_ASSIGN_CACHE=dir).

    A production-width assignment is minutes of host Python and runs in
    keygen and again in prove. The cache keeps the assignment as packed
    (cols, n, 8) u32 .npy files plus the data-dependent copy constraints,
    so later runs, and resumes of a checkpointed prove, load it in seconds.
    It is valid only for circuits whose assignment ignores the instance
    values passed in; the cache's directory is the caller's key. Without
    SPT_ASSIGN_CACHE this is circuit.assign, nothing else.

    The files are the JAX package's: `copies.pkl` names the column class
    under the JAX package's module path (keygen's vk pickler), and either
    package reads the other's cache. Cached tables come back as packed
    words (memory-mapped), which keygen and prove take as they take
    object columns (packed_column). The span "circuit.assign" covers it,
    with cache_hit 1 where the cache gave the tables back."""
    import json
    import os

    with trace.span("circuit.assign", cache_hit=0) as sp:
        path = os.environ.get("SPT_ASSIGN_CACHE")
        if not path:
            return circuit.assign(cs, n, instance)
        from .keygen import _JaxNamesPickler, _PortUnpickler

        meta_p = os.path.join(path, "meta.json")
        if os.path.exists(meta_p):
            with open(meta_p) as fh:
                meta = json.load(fh)
            if meta["n"] == n and meta["num_advice"] == cs.num_advice and meta["num_fixed"] == cs.num_fixed:
                adv = np.load(os.path.join(path, "advice.npy"), mmap_mode="r")
                fx = np.load(os.path.join(path, "fixed.npy"), mmap_mode="r")
                with open(os.path.join(path, "copies.pkl"), "rb") as fh:
                    saved = _PortUnpickler(fh).load()
                for (a, ra), (b, rb) in saved["copies"]:
                    cs.copy(a, ra, b, rb)  # idempotent
                if saved.get("row_usages") is not None:
                    circuit.row_usages_ = saved["row_usages"]
                sp.set(cache_hit=1)
                return {"advice": adv, "fixed": fx}
        tables = circuit.assign(cs, n, instance)
        os.makedirs(path, exist_ok=True)
        adv = np.stack([packed_column(tables["advice"][i]) for i in range(cs.num_advice)])
        fx = np.stack([packed_column(tables["fixed"][i]) for i in range(cs.num_fixed)])
        np.save(os.path.join(path, "advice.npy"), adv)
        np.save(os.path.join(path, "fixed.npy"), fx)
        with open(os.path.join(path, "copies.pkl"), "wb") as fh:
            _JaxNamesPickler(fh, 4).dump({"copies": cs.copies, "row_usages": getattr(circuit, "row_usages_", None)})
        with open(meta_p, "w") as fh:
            json.dump({"n": n, "num_advice": cs.num_advice, "num_fixed": cs.num_fixed}, fh)
        return {"advice": adv, "fixed": fx}
