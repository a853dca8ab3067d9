"""Port parity for the AggregationCircuit's shape: one counting run of each
package over a single MulCircuit inner (K = 6, GWC) with the blob at width
64 gives equal rows, min_k, columns, gates, lookups, copies, digest and
fold, and the same derived degree budget (extended domain, quotient pieces,
permutation chunks). The raw `max_gate_degree` differs, as for the layer
circuit (tests/test_torch_verifier_circuit.py): the port counts the range
lookup."""
import types

import pytest
import torch

from scroll_prover_tpu.proof_system.plonk import keygen as jkeygen_mod
from scroll_prover_tpu.proof_system.plonk import prover as jprover_mod
from scroll_prover_tpu.prover.aggregation_circuit import AggregationCircuit as JAggregationCircuit
from scroll_prover_tpu_torch.proof_system.plonk import keygen as tkeygen_mod
from scroll_prover_tpu_torch.proof_system.plonk import prover as tprover_mod
from scroll_prover_tpu_torch.prover.aggregation_circuit import AggregationCircuit
from tests.test_torch_aggregation_circuit import BLOB, WIDTH, blob_context, limbs
from tests.test_torch_aggregation_circuit import inners, srs  # noqa: F401  (module fixtures)
from tests.test_torch_verifier_circuit import _copies_digest, _shape

torch.set_num_threads(2)


def _counting(circ, keygen_mod, prover_mod) -> dict:
    """min_k() with its single gadget pass captured (see
    tests/test_torch_verifier_circuit.py `_counting`)."""
    seen = {}
    run = circ._run

    def capture(cs, fixed, adv, n):
        n_copies = len(cs.copies)
        out = run(cs, fixed, adv, n)
        _b, lhs, rhs, digest, ctx_cells, exp_cells = out
        seen.update(acc=limbs(lhs.value, rhs.value), digest=digest.val, ctx=[c.val for c in ctx_cells],
                    shape=_shape(cs), copies=_copies_digest(cs.copies[n_copies:]), degree=cs.max_gate_degree(),
                    j=keygen_mod._extended_j(cs), perm_chunks=prover_mod._perm_chunks(cs), cs=cs)
        return out

    circ._run = capture
    k = circ.min_k()
    del circ._run
    dom = types.SimpleNamespace(n=1 << k, extended_n=1 << (k + seen["j"]))
    seen["n_h"] = prover_mod._n_h(seen.pop("cs"), dom)
    return {"k": k, "rows": circ._rows, "sponge_rows": circ._sponge_rows, **seen}


AGG1 = dict(context=blob_context(), inners_have_acc=False, expose=[(0, 0)], blob_bytes=BLOB, blob_width=WIDTH)


@pytest.fixture(scope="module")
def counts(inners):  # noqa: F811
    return (_counting(AggregationCircuit(inners[0][:1], **AGG1), tkeygen_mod, tprover_mod),
            _counting(JAggregationCircuit(inners[1][:1], **AGG1), jkeygen_mod, jprover_mod))


def test_rows_and_min_k_match_jax(counts):
    t, j = counts
    assert (t["rows"], t["sponge_rows"], t["k"]) == (j["rows"], j["sponge_rows"], j["k"])
    assert t["k"] == 21  # one verifier gadget over a K = 6 proof and the blob at width 64


def test_fold_and_digest_match_jax(counts, inners):  # noqa: F811
    t, j = counts
    for key in ("acc", "digest", "ctx"):
        assert t[key] == j[key], key
    want = AggregationCircuit(inners[0][:1], **AGG1).instance_for()[0]
    assert t["acc"] + [t["digest"]] + t["ctx"] == want[:-1]


def test_circuit_shape_matches_jax(counts):
    t, j = counts
    for key in ("shape", "copies", "j", "n_h", "perm_chunks"):
        assert t[key] == j[key], key
    assert (j["degree"], t["degree"]) == (3, 5)
