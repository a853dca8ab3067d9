"""Shared cases of the streamed-quotient parity tests
(tests/test_torch_quotient_stream*.py): keys of the two circuits of
tests/test_torch_plonk.py at K = 6 on both packages, the JAX package's
resident proofs, and the port's proof, whose quotient is `_quotient_cosets`."""
import pytest

from scroll_prover_tpu.proof_system import kzg as jkzg
from scroll_prover_tpu.proof_system.plonk.keygen import keygen as jkeygen
from scroll_prover_tpu.proof_system.plonk.prover import prove as jprove
from scroll_prover_tpu_torch.proof_system import kzg as tkzg
from scroll_prover_tpu_torch.proof_system.plonk import prover as tprover
from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen as tkeygen
from tests.test_torch_plonk import CIRCUITS, INSTANCE, K, SEED

# None: every column cached per coset; 3: l0, l_last, l_active only, the
# rest re-transformed at each read
CAPS = (None, 3)


def make_keys():
    js, ts = jkzg.SRS.generate(K), tkzg.SRS.generate(K, device="cpu")
    out = {}
    for name, (jc, tc) in CIRCUITS.items():
        jcirc, tcirc = jc(), tc()
        out[name] = (js, ts, jcirc, tcirc, jkeygen(js, K, jcirc)[0], *tkeygen(ts, K, tcirc))
    return out


def jax_proofs(keys, mo):
    """The JAX package's proof per circuit through its resident
    `_quotient_full` (the JAX package streams on the CPU only under its own
    SPT_FORCE_STREAM)."""
    mp = pytest.MonkeyPatch()
    mp.delenv("SPT_FORCE_STREAM", raising=False)
    try:
        return {name: jprove(js, jpk, jcirc, INSTANCE, seed=SEED, multiopen=mo)
                for name, (js, _ts, jcirc, _tc, jpk, _tpk, _tvk) in keys.items()}
    finally:
        mp.undo()


def streamed(monkeypatch, keys, name, mo, cap):
    """The port's proof under the cache cap `cap` (None: SPT_COSET_CACHE_COLS
    unset); asserts that the quotient walked `_quotient_cosets` once."""
    _js, ts, _jc, tcirc, _jpk, tpk, _tvk = keys[name]
    if cap is None:
        monkeypatch.delenv("SPT_COSET_CACHE_COLS", raising=False)
    else:
        monkeypatch.setenv("SPT_COSET_CACHE_COLS", str(cap))
    walked = []
    orig = tprover._quotient_cosets
    monkeypatch.setattr(tprover, "_quotient_cosets", lambda *a: walked.append(1) or orig(*a))
    proof = tprover.prove(ts, tpk, tcirc, INSTANCE, seed=SEED, multiopen=mo)
    assert walked == [1]
    return proof
