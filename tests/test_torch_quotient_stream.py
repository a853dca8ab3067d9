"""The port's coset-streaming quotient against the JAX package's resident one
(GWC; tests/test_torch_quotient_stream_shplonk.py runs SHPLONK).

The port's only quotient, `_quotient_cosets` (with no cache cap and with a
tight SPT_COSET_CACHE_COLS), must give proof bytes identical to the JAX
package's `_quotient_full` proof on the two circuits of
tests/test_torch_plonk.py at K = 6. Integer arithmetic: exact equality."""
import numpy as np
import pytest
import torch

from scroll_prover_tpu_torch.fields.limbs import FR_LIMB, limbs_to_torch
from scroll_prover_tpu_torch.ops import field_ops as fo
from scroll_prover_tpu_torch.ops.ntt import EvaluationDomain
from scroll_prover_tpu_torch.proof_system.plonk import prover as tprover
from scroll_prover_tpu_torch.proof_system.plonk.verifier import verify as tverify
from tests.test_torch_plonk import CIRCUITS, INSTANCE, K
from tests.torch_stream_cases import CAPS, jax_proofs, make_keys, streamed

torch.set_num_threads(2)

MO = "gwc"


@pytest.fixture(scope="module")
def keys():
    return make_keys()


@pytest.fixture(scope="module")
def jax_ref(keys):
    return jax_proofs(keys, MO)


@pytest.mark.parametrize("cap", CAPS, ids=lambda c: f"cap{c}")
@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_streamed_proof_bytes_identical(monkeypatch, keys, jax_ref, name, cap):
    sp = streamed(monkeypatch, keys, name, MO, cap)
    assert sp == jax_ref[name]
    _js, ts, *_rest, tvk = keys[name]
    assert tverify(ts, tvk, INSTANCE, sp, multiopen=MO)


def test_cache_cap_and_plan_order(monkeypatch, keys):
    """SPT_COSET_CACHE_COLS sets the cap (none on the CPU without it), and
    the plan ranked by static use puts l0, l_last, l_active first."""
    _js, ts, _jc, tcirc, _jpk, tpk, _tvk = keys["bench"]
    monkeypatch.setenv("SPT_COSET_CACHE_COLS", "3")
    assert tprover._coset_cache_cap(1 << K, 40, "cpu") == 3
    monkeypatch.delenv("SPT_COSET_CACHE_COLS")
    assert tprover._coset_cache_cap(1 << K, 40, "cpu") is None
    cs = tpk.vk.cs
    zpolys = {("sigma", j): None for j in range(len(cs.perm_columns))}
    zpolys[("permz", 0)] = None
    uses = tprover._static_uses(cs, zpolys)
    plan = tprover._quotient_plan(cs, {"advice": [None] * cs.num_advice, "fixed": [None] * cs.num_fixed,
                                       "instance": [None] * cs.num_instance}, zpolys, tpk, None)
    plan.sort(key=lambda e: -uses.get(e[0], 0))
    assert {t for t, _ in plan[:3]} == {"l0", "l_last", "l_active"}


def test_intt_consume_frees_and_matches(rng):
    dom = EvaluationDomain(4)
    vals = [fo.to_mont(FR_LIMB, limbs_to_torch(rng.integers(0, 1 << 16, (16, 16), dtype="u4"), "cpu"))
            for _ in range(3)]
    want = tprover._intt_cols(dom, vals)
    cols = list(vals)
    got = tprover._intt_consume(dom, cols)
    assert cols == []
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("live", [0, 5, 40])
def test_device_lookup_permutation_matches_jax(rng, live):
    """The port permutes lookup columns on their device in plain torch; its
    A' and S' equal the JAX package's numpy permutation (repeated values,
    unmatched table rows, an all-padding input), and a value outside the
    table raises."""
    from scroll_prover_tpu.proof_system.plonk.prover import _permute_lookup_packed as jperm

    u = 64
    tbl = rng.integers(0, 1 << 32, (24, 8), dtype=np.uint32)
    tbl[::3, 4:] = 0
    s = np.zeros((u, 8), np.uint32)
    s[: len(tbl)] = tbl
    a = np.zeros((u, 8), np.uint32)
    a[:live] = tbl[rng.integers(0, len(tbl), live)]
    ja, js = jperm(a, s)
    ta, ts = tprover._permute_lookup(torch.from_numpy(a.view(np.int32)), torch.from_numpy(s.view(np.int32)))
    assert np.array_equal(ta.numpy().view(np.uint32), ja)
    assert np.array_equal(ts.numpy().view(np.uint32), js)
    a[1] = tbl[0] + 1
    with pytest.raises(ValueError, match="not in table"):
        tprover._permute_lookup(torch.from_numpy(a.view(np.int32)), torch.from_numpy(s.view(np.int32)))


def test_intt_extended_tables_built_before_the_quotient():
    """The quotient builds intt_extended's tables before it sizes its cache;
    intt_extended then finds them and builds none."""
    dom = EvaluationDomain(3, 2)
    dom.prepare_intt_extended(torch.device("cpu"))
    built = dict(dom._tables)
    assert {name for name, _dev in built} == {"tiled_ext", "coset_pow_inv"}
    y = torch.zeros((dom.extended_n, 16), dtype=torch.int32)
    dom.intt_extended(y)
    assert dom._tables == built
