"""min_k and the EVM word-arithmetic region: a block of comparisons and
divisions with few MULs.

The JAX package's ScrollSuperCircuit.min_k sizes the EVM's word-arithmetic
builder region from MUL steps alone, at 60 rows each; the builder also
places rows for DIV/MOD, LT/GT, EQ, ISZERO and NOT, and MUL takes 101. On
such a block its domain is too small and the builder's "gadget region
overflow" assert fires. The port counts every one of these steps at the
rows the builder places for it, so its k fits the block (and exceeds the
JAX package's); on blocks without these steps the two agree. Rows are
counted (the EVM sub-circuit's assignment at min_k), nothing is proved."""
import copy

import pytest

import tests.torch_native_cases  # noqa: F401  (both packages' native libraries, built once under a lock)
from scroll_prover_tpu.l2types import BlockTrace as JBlockTrace
from scroll_prover_tpu.proof_system.plonk.cs import ConstraintSystem as JCS
from scroll_prover_tpu.proof_system.plonk.cs import empty_assignment as jempty
from scroll_prover_tpu.witness import chunk_trace_to_witness_block as jwitness
from scroll_prover_tpu.zkevm import ScrollSuperCircuit as JSuper
from scroll_prover_tpu_torch.l2types import BlockTrace
from scroll_prover_tpu_torch.proof_system.plonk.cs import ConstraintSystem, empty_assignment
from scroll_prover_tpu_torch.witness import chunk_trace_to_witness_block
from scroll_prover_tpu_torch.zkevm import ScrollSuperCircuit
from scroll_prover_tpu_torch.zkevm.super_circuit import _WORD_ROWS
from tests.torch_trace_cases import WORD_OPS, trace_dict, word_arith_trace_dict

# 56 comparison/division/unary steps beside one MUL: the JAX package's
# min_k gives 11 (its region then needs ~7,000 rows), the port's 13
PLAN = ["LT", "GT", "EQ", "DIV", "MOD", "ISZERO", "NOT"] * 8 + ["MUL"]

PORT = (BlockTrace, chunk_trace_to_witness_block, ScrollSuperCircuit, ConstraintSystem, empty_assignment)
JAX = (JBlockTrace, jwitness, JSuper, JCS, jempty)


def _evm_region(side, d, k=None):
    """(k, the EVM's assignment at 2^k rows: its builder rows, or the
    AssertionError it raised); k defaults to the package's min_k."""
    block_trace, witness, super_circuit, cs_cls, empty = side
    wb = witness([block_trace.from_json(copy.deepcopy(d))])
    circ = super_circuit.new_from_block(wb)
    k = circ.min_k() if k is None else k
    n = 1 << k
    cs = cs_cls()
    circ.configure(cs)
    try:
        circ.evm.assign(cs, empty(cs.num_fixed, n), empty(cs.num_advice, n), n, wb, 0)
    except AssertionError as e:
        return k, e
    return k, circ.evm._builder_rows


def test_jax_min_k_undersizes_the_word_region():
    k, got = _evm_region(JAX, word_arith_trace_dict(PLAN))
    assert isinstance(got, AssertionError) and "gadget region overflow" in str(got), (k, got)


def test_port_min_k_fits_the_word_region():
    d = word_arith_trace_dict(PLAN)
    k, rows = _evm_region(PORT, d)
    jk, _ = _evm_region(JAX, d)
    assert not isinstance(rows, AssertionError), rows
    assert rows < (1 << k) - 8
    assert k > jk
    # the port's own region at the JAX package's k overflows as the JAX one does
    _, at_jax_k = _evm_region(PORT, d, jk)
    assert isinstance(at_jax_k, AssertionError)


@pytest.mark.parametrize("op", sorted(WORD_OPS))
def test_word_rows_per_step(op):
    """The builder rows of 3 and of 6 steps of `op`: _WORD_ROWS[op] each."""
    rows = [_evm_region(PORT, word_arith_trace_dict([op] * count), 14)[1] for count in (3, 6)]
    assert rows[1] - rows[0] == 3 * _WORD_ROWS[WORD_OPS[op]]


def test_min_k_agrees_without_word_steps():
    """The repo's synthetic block (PUSH1, SLOAD, MSTORE, SHA3, CALLDATACOPY)
    gets the same k in both packages."""
    d = trace_dict()
    pk = ScrollSuperCircuit.new_from_block(chunk_trace_to_witness_block([BlockTrace.from_json(copy.deepcopy(d))]))
    jk = JSuper.new_from_block(jwitness([JBlockTrace.from_json(copy.deepcopy(d))]))
    assert pk.min_k() == jk.min_k()
