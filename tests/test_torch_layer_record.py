"""The layer circuits take their assignment from min_k()'s pass
(prover/verifier_circuit.py `recording_pass`, `fit_record`,
`replay_record`: the gadget program writes into tables that grow with it)
instead of running the program a second time. The assignment and the
copies so obtained equal those of a second run of the program, here for the
AggregationCircuit with the blob (whose program holds a verifier gadget, so
the VerifierCircuit's path is the same code), at k = 21; and a second
assignment of the same circuit object registers the same copies on a fresh
constraint system (tests/test_torch_verifier_circuit.py holds the same for
the VerifierCircuit)."""
import numpy as np
import pytest
import torch

from scroll_prover_tpu_torch.proof_system.plonk.cs import ConstraintSystem
from scroll_prover_tpu_torch.prover.aggregation_circuit import AggregationCircuit
from tests.test_torch_aggregation_circuit import BLOB, WIDTH, blob_context
from tests.test_torch_aggregation_circuit import inners, srs  # noqa: F401  (module fixtures)

torch.set_num_threads(2)


def _assigned(circ, n):
    cs = ConstraintSystem()
    circ.configure(cs)
    tables = circ.assign(cs, n, None)
    return tables, list(cs.copies), [(c.kind, c.index) for c in cs.perm_columns]


@pytest.fixture(scope="module")
def replayed(inners):  # noqa: F811
    """An AggregationCircuit (one inner, the blob) after min_k()'s pass and
    its first assignment at n = 2^min_k: (a maker of fresh circuits, the
    circuit, n, the assignment)."""
    (vk, proof, inst), _other = inners[0]

    def make():
        return AggregationCircuit([(vk, proof, inst)], context=blob_context(), inners_have_acc=False,
                                  expose=[(0, 0)], blob_bytes=BLOB, blob_width=WIDTH)

    circ = make()
    n = 1 << circ.min_k()
    assert circ._record is not None and circ._record[0].shape[1] == n
    got = _assigned(circ, n)
    assert circ._record is None  # taken once, then dropped
    return make, circ, n, got


def test_replayed_assignment_equals_a_second_run(replayed):
    make, _circ, n, got = replayed
    want = _assigned(make(), n)  # no min_k: the program runs again
    for kind in ("fixed", "advice"):
        assert got[0][kind].shape == want[0][kind].shape == (want[0][kind].shape[0], n)
        assert np.array_equal(got[0][kind], want[0][kind]), kind
    assert got[1] == want[1] and got[2] == want[2]
    assert len(got[1]) > 1000


def test_second_assign_registers_the_copies(replayed):
    """The same circuit assigned on a fresh constraint system (a second
    keygen of the same object, a mock run): the tables come from the cache,
    and the copies the first assignment registered are registered again,
    in order, with the same permutation columns (before, none were, and
    keygen built an identity permutation and another vk)."""
    _make, circ, n, got = replayed
    again = _assigned(circ, n)
    assert again[0] is got[0]
    assert again[1] == got[1] and again[2] == got[2]
