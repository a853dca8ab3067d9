"""The port's coset-streaming quotient against the JAX package's resident
one under SHPLONK (the ladder's scheme); GWC and the streaming helpers are in
tests/test_torch_quotient_stream.py. Exact equality of proof bytes."""
import pytest
import torch

from scroll_prover_tpu_torch.proof_system.plonk.verifier import verify as tverify
from tests.test_torch_plonk import CIRCUITS, INSTANCE
from tests.torch_stream_cases import CAPS, jax_proofs, make_keys, streamed

torch.set_num_threads(2)

MO = "shplonk"


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
