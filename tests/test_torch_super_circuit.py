"""Port parity for ScrollSuperCircuit: its constraint system under the
default caps and under SPT_ECC_CAP=0 SPT_MODEXP_CAP=0, its assignment at
min_k, the port's MockProver on it, and (marked slow) the whole slice's
keygen, prove and verify against the JAX package, byte for byte.

Exact equality throughout: gates, lookups and the permutation compare as
the pickled constraint-system shape the verifying key carries."""
import copy
import pickle
import time

import pytest
import torch

import tests.torch_native_cases  # noqa: F401  (both packages' native libraries, built once under a lock)
from scroll_prover_tpu.l2types import BlockTrace as JBlockTrace
from scroll_prover_tpu.proof_system.plonk import Circuit as JCircuit
from scroll_prover_tpu.proof_system.plonk.cs import ConstraintSystem as JCS
from scroll_prover_tpu.proof_system.plonk.keygen import _extended_j as j_extended_j
from scroll_prover_tpu.proof_system.plonk.mock import _pad_instance as j_pad_instance
from scroll_prover_tpu.witness import chunk_trace_to_witness_block as jwitness
from scroll_prover_tpu.zkevm import ScrollSuperCircuit as JSuper
from scroll_prover_tpu.zkevm import chunk_instance as jchunk_instance
from scroll_prover_tpu_torch.l2types import BlockTrace as TBlockTrace
from scroll_prover_tpu_torch.proof_system.plonk import MockProver
from scroll_prover_tpu_torch.proof_system.plonk import Circuit as TCircuit
from scroll_prover_tpu_torch.proof_system.plonk.cs import ConstraintSystem as TCS
from scroll_prover_tpu_torch.proof_system.plonk.cs import empty_assignment
from scroll_prover_tpu_torch.proof_system.plonk.keygen import _extended_j as t_extended_j
from scroll_prover_tpu_torch.proof_system.plonk.keygen import _pickle_shape
from scroll_prover_tpu_torch.proof_system.plonk.mock import _pad_instance as t_pad_instance
from scroll_prover_tpu_torch.prover import mock_prove_witness_block
from scroll_prover_tpu_torch.witness import chunk_trace_to_witness_block as twitness
from scroll_prover_tpu_torch.zkevm import ScrollSuperCircuit as TSuper
from scroll_prover_tpu_torch.zkevm import chunk_instance as tchunk_instance
from tests.torch_trace_cases import trace_dict

torch.set_num_threads(2)

CAPS = {"default": {}, "no_ecc_modexp": {"SPT_ECC_CAP": "0", "SPT_MODEXP_CAP": "0"}}


def _witness_blocks(d):
    return (jwitness([JBlockTrace.from_json(copy.deepcopy(d))]),
            twitness([TBlockTrace.from_json(copy.deepcopy(d))]))


@pytest.fixture(scope="module")
def wbs():
    return _witness_blocks(trace_dict())


def _shape(cs):
    return {"gates": cs.gates, "lookups": cs.lookups, "perm_columns": cs.perm_columns,
            "num_fixed": cs.num_fixed, "num_advice": cs.num_advice,
            "num_instance": cs.num_instance, "num_challenges": cs.num_challenges}


@pytest.fixture(scope="module", params=sorted(CAPS))
def configured(request, wbs):
    """Both circuits configured and assigned at min_k under one cap set."""
    mp = pytest.MonkeyPatch()
    for key in ("SPT_ECC_CAP", "SPT_MODEXP_CAP", "SPT_INNER_K"):
        mp.delenv(key, raising=False)
    for key, v in CAPS[request.param].items():
        mp.setenv(key, v)
    try:
        jwb, twb = wbs
        jc, tc = JSuper.new_from_block(jwb), TSuper.new_from_block(twb)
        k = tc.min_k()
        assert jc.min_k() == k
        n = 1 << k
        jcs, tcs = JCS(), TCS()
        jc.configure(jcs)
        tc.configure(tcs)
        jtab = jc.assign(jcs, n, j_pad_instance(jcs, n, [jchunk_instance(jwb)]))
        ttab = tc.assign(tcs, n, t_pad_instance(tcs, n, [tchunk_instance(twb)]))
    finally:
        mp.undo()
    return request.param, k, (jc, jcs, jtab), (tc, tcs, ttab)


def test_constraint_system_identical(configured):
    caps, _k, (_jc, jcs, _jt), (_tc, tcs, _tt) = configured
    counts = lambda cs: (cs.num_advice, cs.num_fixed, cs.num_instance,  # noqa: E731
                         len(cs.perm_columns), len(cs.lookups), len(cs.gates))
    assert counts(tcs) == counts(jcs)
    if caps == "default":
        assert counts(tcs) == (204, 117, 1, 45, 68, 140)
    else:
        assert (tcs.num_advice, tcs.num_fixed) == (186, 89)
    assert [(name, e.degree()) for name, e in tcs.gates] == [(name, e.degree()) for name, e in jcs.gates]
    assert [lk.name for lk in tcs.lookups] == [lk.name for lk in jcs.lookups]
    assert [(c.kind, c.index) for c in tcs.perm_columns] == [(c.kind, c.index) for c in jcs.perm_columns]
    # the port's degree budget counts the lookups (2 + 4 + 3 = 9 for
    # evm/push_immediate): j = 4 where the JAX package's gate-only budget
    # of 5 gives 3 (tests/test_torch_super_circuit.py::test_lookup_degree_budget)
    assert tcs.max_gate_degree() == 9 and jcs.max_gate_degree() == 5
    assert (t_extended_j(tcs), j_extended_j(jcs)) == (4, 3)
    # gate and lookup expressions, structurally: the vk's pickled shape
    assert _pickle_shape(_shape(tcs)) == pickle.dumps(_shape(jcs))


def test_assignment_identical(configured):
    _caps, _k, (jc, jcs, jtab), (tc, tcs, ttab) = configured
    for kind in ("fixed", "advice"):
        j, t = jtab[kind], ttab[kind]
        assert len(j) == len(t)
        for i in range(len(j)):
            assert [int(v) for v in t[i]] == [int(v) for v in j[i]], (kind, i)
    key = lambda cp: [((a.kind, a.index, ra), (b.kind, b.index, rb)) for (a, ra), (b, rb) in cp]  # noqa: E731
    assert key(tcs.copies) == key(jcs.copies)
    assert tc.row_usages_ == jc.row_usages_


def test_mock_satisfied(wbs):
    _jwb, twb = wbs
    circuit = TSuper.new_from_block(twb)
    prover = MockProver.run(circuit.min_k(), circuit, [tchunk_instance(twb)])
    prover.assert_satisfied()
    assert circuit.row_usages_["evm"] > 0 and circuit.row_usages_["pi"] == 9
    mock_prove_witness_block(twb)


def test_mock_catches_witness_tampering(wbs):
    """tests/test_super_circuit.py's tampering, on the port: a broken gas
    accumulation fails the tx gate; a wrong instance fails a copy."""
    _jwb, twb = wbs
    circuit = TSuper.new_from_block(twb)
    k = circuit.min_k()
    orig_assign = circuit.assign

    def bad_assign(cs, n, instance):
        tables = orig_assign(cs, n, instance)
        tables["advice"][circuit.tx.gas_acc.index][1] += 1
        return tables

    circuit.assign = bad_assign
    fails = MockProver.run(k, circuit, [tchunk_instance(twb)]).verify()
    assert any("tx/gas_acc" in f.name for f in fails)
    inst = tchunk_instance(twb)
    inst[3] = (inst[3] + 1) % (2**128)
    fails = MockProver.run(k, TSuper.new_from_block(twb), [inst]).verify()
    assert any(f.kind == "copy" for f in fails)


class _HighLookupBody:
    """A lookup of degree-3 input: its quotient term has degree
    2 + 3 + 1 = 6, over the JAX package's gate-only budget of 5."""

    def configure(self, cs):
        self.a = cs.advice_column()
        self.b = cs.advice_column()
        self.sel = cs.selector()
        self.tbl = cs.fixed_column()
        self.pi = cs.instance_column()
        cs.lookup("ab_range", [self.sel.query() * self.a.query() * self.b.query()], [self.tbl.query()])

    def assign(self, cs, n, instance):
        fixed = empty_assignment(cs.num_fixed, n)
        advice = empty_assignment(cs.num_advice, n)
        for i in range(8):
            advice[self.a.index][i] = i + 1
            advice[self.b.index][i] = 3
            fixed[self.sel.index][i] = 1
        for v in range(41):
            fixed[self.tbl.index][v] = v
        cs.copy(self.pi, 0, self.a, 0)
        return {"fixed": fixed, "advice": advice}


class _JaxHighLookup(_HighLookupBody, JCircuit):
    pass


class _TorchHighLookup(_HighLookupBody, TCircuit):
    pass


def _jax_degree_rule_of_the_port(monkeypatch):
    """The JAX package with the port's degree budget (lookups counted), for
    byte parity where the JAX package's own budget is too small."""
    monkeypatch.setattr(JCS, "max_gate_degree", lambda self: TCS.max_gate_degree(self))


def test_lookup_degree_budget(monkeypatch):
    """The fault in the JAX package that the port departs from, at K = 6: a
    lookup of degree 6 against the gate-only budget of 5 gives a proof that
    the JAX package's own verifier rejects; the port's proof verifies, its
    vk bytes equal the JAX package's, and under the port's degree rule the
    JAX package's proof bytes equal the port's."""
    from scroll_prover_tpu.proof_system import kzg as jkzg
    from scroll_prover_tpu.proof_system.plonk.keygen import keygen as jkeygen
    from scroll_prover_tpu.proof_system.plonk.prover import prove as jprove
    from scroll_prover_tpu.proof_system.plonk.verifier import verify as jverify
    from scroll_prover_tpu_torch.proof_system import kzg as tkzg
    from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen as tkeygen
    from scroll_prover_tpu_torch.proof_system.plonk.prover import prove as tprove
    from scroll_prover_tpu_torch.proof_system.plonk.verifier import verify as tverify

    k, inst, seed = 6, [[1]], b"lookup-degree"
    js, ts = jkzg.SRS.generate(k), tkzg.SRS.generate(k, device="cpu")
    jc, tc = _JaxHighLookup(), _TorchHighLookup()
    jpk, jvk = jkeygen(js, k, jc)
    tpk, tvk = tkeygen(ts, k, tc)
    assert tvk.to_bytes() == jvk.to_bytes()
    assert not jverify(js, jvk, inst, jprove(js, jpk, jc, inst, seed=seed))
    tp = tprove(ts, tpk, tc, inst, seed=seed)
    assert tverify(ts, tvk, inst, tp)
    _jax_degree_rule_of_the_port(monkeypatch)
    jpk, jvk = jkeygen(js, k, jc)
    jp = jprove(js, jpk, jc, inst, seed=seed)
    assert jp == tp
    assert jverify(js, jvk, inst, tp)


@pytest.mark.slow
def test_super_circuit_proof_bytes_identical(monkeypatch):
    """The whole slice on both packages at min_k: keygen, prove (fixed seed,
    SHPLONK) and verify of the super circuit on the synthetic trace, the
    JAX package under the port's degree budget (test_lookup_degree_budget);
    identical vk bytes and transcript_repr, identical proof bytes, each
    verifier accepting the other's proof. Slow: the JAX keygen and prove
    take many minutes on the CPU."""
    from scroll_prover_tpu.proof_system import kzg as jkzg
    from scroll_prover_tpu.proof_system.plonk.keygen import keygen as jkeygen
    from scroll_prover_tpu.proof_system.plonk.prover import prove as jprove
    from scroll_prover_tpu.proof_system.plonk.verifier import verify as jverify
    from scroll_prover_tpu_torch.proof_system import kzg as tkzg
    from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen as tkeygen
    from scroll_prover_tpu_torch.proof_system.plonk.prover import prove as tprove
    from scroll_prover_tpu_torch.proof_system.plonk.verifier import verify as tverify

    _jax_degree_rule_of_the_port(monkeypatch)
    jwb, twb = _witness_blocks(trace_dict())
    jc, tc = JSuper.new_from_block(jwb), TSuper.new_from_block(twb)
    k = tc.min_k()
    inst = [tchunk_instance(twb)]
    assert [jchunk_instance(jwb)] == inst
    seed = b"super-circuit-parity"
    t0 = time.perf_counter()
    ts = tkzg.SRS.generate(k, device="cpu")
    tpk, tvk = tkeygen(ts, k, tc)
    tp = tprove(ts, tpk, tc, inst, seed=seed, multiopen="shplonk")
    t1 = time.perf_counter()
    js = jkzg.SRS.generate(k)
    jpk, jvk = jkeygen(js, k, jc)
    jp = jprove(js, jpk, jc, inst, seed=seed, multiopen="shplonk")
    t2 = time.perf_counter()
    print(f"k={k}: port {t1 - t0:.1f} s, JAX {t2 - t1:.1f} s")
    assert tvk.to_bytes() == jvk.to_bytes()
    assert tvk.transcript_repr() == jvk.transcript_repr()
    assert tp == jp
    assert tverify(ts, tvk, inst, jp, multiopen="shplonk")
    assert jverify(js, jvk, inst, tp, multiopen="shplonk")
    bad = bytearray(tp)
    bad[100] ^= 1
    assert not tverify(ts, tvk, inst, bytes(bad), multiopen="shplonk")

