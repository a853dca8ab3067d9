"""VerifierCircuit: the proof-carrying layer circuit with REAL in-circuit
SNARK verification (replaces hash-binding CompressionCircuit for the chunk
ladder layers 1/2).

Role parity with the reference aggregator's CompressionCircuit, which
"verifies the inner proof inside the circuit" over halo2-ecc non-native
arithmetic and carries the deferred pairing as a 12-cell KZG accumulator in
the instance (SURVEY.md section 3.1 layer1/layer2;
the reference release-v0.13.1 chunk.protocol accumulator_indices
[[0,0]..[0,11]]).

Instance layout: [12 accumulator limb cells (lhs.x, lhs.y, rhs.x, rhs.y as
3 x 88-bit limbs each) || pass-through of the inner proof's non-accumulator
instances]. When the inner proof itself carries an accumulator
(inner_has_acc), its 12 cells are folded into this circuit's accumulator
with a fresh transcript challenge instead of being passed through — so
recursion composes and the outermost accumulator transitively attests to
the whole chain.
"""
from __future__ import annotations

import contextlib
import gc
import logging
import time

from ..fields.bn254 import FR_MOD
from ..gadgets.builder import Builder
from ..gadgets.ecc import EccChip
from ..gadgets.nonnative import NonNativeChip
from ..gadgets.plonk_verifier import VerifierGadget
from ..proof_system.plonk.cs import Circuit, ConstraintSystem, empty_assignment
from ..proof_system.plonk.keygen import VerifyingKey
from ..proof_system.plonk.verifier import (
    acc_from_limbs,
    acc_limbs,
    accumulator_for,
)
from ..zkevm.subcircuits import PoseidonSubCircuit
from .compression import _canonical_k

ACC_CELLS = 12
LOOKUP_BITS = 12
# rows of the tables a layer's recording pass starts with (they grow by
# doubling as the program reaches them)
RECORD_ROWS = 1 << 20

log = logging.getLogger(__name__)


class _Sink:
    def __setitem__(self, k, v):
        pass


_SINK = _Sink()


class _SinkCols:
    """Columns that discard what is written: a counting pass writes cells
    as cols[i][r] or cols[i, r]."""

    def __getitem__(self, i):
        return _SINK

    def __setitem__(self, k, v):
        pass


def recording_pass(circuit):
    """min_k()'s pass of a layer circuit's gadget program (`circuit._run`),
    written into tables that grow with it: the program does not depend on
    n, so assign() takes its assignment from this pass instead of running
    it a second time. Returns (the program's outputs, the record: tables,
    the copies the pass registered, outputs)."""
    cs = ConstraintSystem()
    circuit.configure(cs)
    n_copies = len(cs.copies)
    out = circuit._run(cs, empty_assignment(cs.num_fixed, RECORD_ROWS),
                       empty_assignment(cs.num_advice, RECORD_ROWS), 1 << 30)
    b = circuit.b
    record = (b.fixed, b.adv, cs.copies[n_copies:], out)
    b.fixed = b.adv = None  # the record holds the tables now
    return out, record


def fit_record(record, n: int):
    """The record with its tables made n rows long (every row the pass
    wrote lies below n)."""
    fixed, adv, copies, out = record
    tables = []
    for t in (fixed, adv):
        if t.shape[1] != n:
            m = min(n, t.shape[1])
            fitted = empty_assignment(t.shape[0], n)
            fitted[:, :m] = t[:, :m]
            t = fitted
        tables.append(t)
    return tables[0], tables[1], copies, out


def replay_record(cs, record, n: int, tag: str):
    """assign()'s tables and program outputs from min_k()'s record (None
    when there is none for n): its copies are registered on `cs` in the
    pass's order, at once when `cs` holds none yet."""
    if record is None or record[0].shape[1] != n:
        return None
    t0 = time.time()
    log.info("%s assignment replay start", tag)
    fixed, adv, copies, out = record
    register_copies(cs, copies)
    log.info("%s assignment replay done: %d copies, %.1fs", tag, len(copies), time.time() - t0)
    return fixed, adv, out


# objects in the permanent generation before any block below ran: CPython
# 3.12 starts with a few hundred of its own tuples there
_FROZEN_AT_IMPORT = gc.get_freeze_count()


@contextlib.contextmanager
def collector_off():
    """The cyclic collector off for a block that allocates millions of
    long-lived objects and almost no cyclic garbage (a gadget pass, a copy
    registration): with it on, its collections over them took about half
    of a pass. On the way out the block's objects go straight to the
    oldest generation (gc.freeze, then gc.unfreeze, which also moves the
    interpreter's own frozen tuples there): left young, the next
    collections walked them all, 7-22 s each on the card's host (phase 7 of
    chip_smoke.py). The price: cyclic garbage made in the block goes there
    too, and only a full collection reclaims it. Where other code froze
    objects since this module's import, they stay frozen and the block's
    objects stay young."""
    collecting = gc.isenabled()
    promote = gc.get_freeze_count() <= _FROZEN_AT_IMPORT
    gc.disable()
    try:
        yield
    finally:
        if promote:
            gc.freeze()
            gc.unfreeze()
        if collecting:
            gc.enable()


def register_copies(cs, copies) -> None:
    """Register `copies` on `cs` in their order, at once when `cs` holds
    none yet."""
    with collector_off():
        if cs.copies:
            for (a, ra), (b, rb) in copies:
                cs.copy(a, ra, b, rb)
        else:
            perm = {(c.kind, c.index) for c in cs.perm_columns}
            for (a, _ra), (b, _rb) in copies:
                if (a.kind, a.index) not in perm or (b.kind, b.index) not in perm:
                    cs.enable_permutation(a)
                    cs.enable_permutation(b)
                    perm.update(((a.kind, a.index), (b.kind, b.index)))
            cs._copy_set.update(((a.kind, a.index), ra, (b.kind, b.index), rb) for (a, ra), (b, rb) in copies)
            cs.copies.extend(copies)


class VerifierCircuit(Circuit):
    def __init__(
        self,
        inner_vk: VerifyingKey,
        inner_proof: bytes,
        inner_instances: list[int],
        inner_has_acc: bool = False,
        inner_multiopen: str = "gwc",
    ):
        assert inner_vk.cs.num_instance <= 1, "single instance column expected"
        self.inner_vk = inner_vk
        self.inner_proof = inner_proof
        self.inner_instances = [int(v) % FR_MOD for v in inner_instances]
        self.inner_has_acc = inner_has_acc
        self.inner_multiopen = inner_multiopen
        if inner_has_acc:
            assert len(self.inner_instances) >= ACC_CELLS
        self._min_k: int | None = None
        self._record = None  # min_k()'s pass, which assign() takes its tables from
        # n -> (tables, the copies their assignment registered)
        self._assign_cache: dict[int, tuple] = {}

    # -- layout ------------------------------------------------------------

    def passthrough(self) -> list[int]:
        return (
            self.inner_instances[ACC_CELLS:]
            if self.inner_has_acc
            else self.inner_instances
        )

    def num_instance(self) -> int:
        return ACC_CELLS + len(self.passthrough())

    def configure(self, cs: ConstraintSystem):
        self.instance = cs.instance_column()
        cs.enable_permutation(self.instance)
        self.b = Builder().configure(cs, lookup_bits=LOOKUP_BITS)
        self.pos = PoseidonSubCircuit().configure(cs)
        for col in (self.pos.s[0], self.pos.elem[0], self.pos.elem[1]):
            cs.enable_permutation(col)
        return self

    # -- the gadget program ------------------------------------------------

    def _run(self, cs, fixed, adv, n: int):
        import logging
        import time as _time

        _vlog = logging.getLogger(__name__)
        _t0 = _time.time()
        _vlog.info("verifier-gadget build start (n=%d)", n)
        b = self.b.begin(cs, fixed, adv, n, 0)
        ec = EccChip(NonNativeChip(b))
        inst_cells = [[b.witness(v) for v in self.inner_instances]]
        acc_cells = (
            inst_cells[0][:ACC_CELLS] if self.inner_has_acc else None
        )
        vg = VerifierGadget(
            b, self.pos, ec, self.inner_vk, inst_cells, self.inner_proof,
            inner_acc_cells=acc_cells, multiopen=self.inner_multiopen,
        )
        with collector_off():
            lhs, rhs = vg.run()
        _vlog.info(
            "verifier-gadget build done: %d rows, %.1fs",
            b.rows_used(), _time.time() - _t0,
        )
        return b, vg, lhs, rhs, inst_cells

    def min_k(self) -> int:
        if self._min_k is None:
            (b, vg, _l, _r, _i), record = recording_pass(self)
            rows = max(b.rows_used(), vg.transcript_rows, 1 << LOOKUP_BITS)
            self._rows = rows
            self._min_k = _canonical_k(max((rows + 64).bit_length(), 8))
            self._record = fit_record(record, 1 << self._min_k)
        return self._min_k

    def assign(self, cs: ConstraintSystem, n: int, instance):
        cached = self._assign_cache.get(n)
        if cached is not None:
            out, copies = cached
            if not getattr(cs, "_vc_copies_done", False):
                # a constraint system that has not seen this circuit's copies
                # (a second keygen of the same circuit, a mock run): the
                # record went to the first assignment, its copies stay here
                register_copies(cs, copies)
                cs._vc_copies_done = True
            return out
        # copies are shape-deterministic: when a cached pk's cs already holds
        # them (a fresh VerifierCircuit proving against a cached keygen),
        # drop the duplicates this run registers
        copies_start = len(cs.copies)
        had_copies = getattr(cs, "_vc_copies_done", False)
        replayed = replay_record(cs, self._record, n, "verifier-gadget")
        self._record = None
        if replayed is not None:
            fixed, adv, (_b, _vg, lhs, rhs, inst_cells) = replayed
        else:
            fixed = empty_assignment(cs.num_fixed, n)
            adv = empty_assignment(cs.num_advice, n)
            _b, _vg, lhs, rhs, inst_cells = self._run(cs, fixed, adv, n)
        limb_cells = [*lhs.x.limbs, *lhs.y.limbs, *rhs.x.limbs, *rhs.y.limbs]
        assert len(limb_cells) == ACC_CELLS
        for i, c in enumerate(limb_cells):
            cs.copy(self.instance, i, c.col, c.row)
        pt_cells = (
            inst_cells[0][ACC_CELLS:] if self.inner_has_acc else inst_cells[0]
        )
        for i, c in enumerate(pt_cells):
            cs.copy(self.instance, ACC_CELLS + i, c.col, c.row)
        copies = cs.copies[copies_start:]
        if had_copies:
            del cs.copies[copies_start:]
        else:
            cs._vc_copies_done = True
        out = {"fixed": fixed, "advice": adv}
        self._assign_cache[n] = (out, copies)
        return out

    def instance_for(self) -> list[list[int]]:
        inner_acc = (
            acc_from_limbs(self.inner_instances[:ACC_CELLS])
            if self.inner_has_acc
            else None
        )
        lhs, rhs = accumulator_for(
            self.inner_vk, [self.inner_instances], self.inner_proof, inner_acc,
            multiopen=self.inner_multiopen,
        )
        return [[*acc_limbs(lhs, rhs), *self.passthrough()]]
