"""The port's twins of tests/test_prove_checkpoint.py at K = 6, held against
the JAX package's proof bytes through JAX_PROOF_SHA256 (which
test_torch_checkpoint.py holds against a live JAX prove of the same circuit
and seed).

Full-then-resume, resume after phases 1 and 2 (of a port-written directory:
test_torch_checkpoint.py shows it is the JAX-written one's files bit for
bit, and resumes that one from the later cuts), partial cosets, the
fingerprint reset, the assignment cache cold and warm, and bounded
residency (SPT_VALS_RESIDENT, SPT_ADVICE_COEFF_RESIDENT), with and without
SPT_PACK_RESIDENT."""
import hashlib
import shutil

import pytest

from scroll_prover_tpu_torch.proof_system.plonk import prover as TPR
from scroll_prover_tpu_torch.proof_system.plonk.checkpoint import ProveCheckpoint
from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen as tkeygen
from tests.torch_checkpoint_cases import (
    FP, INST, JAX_PROOF_SHA256, K, PHASES, SEED, TorchC, cut_phases, lowmem_env, port_prove, seeded,
)


def sha(proof: bytes) -> str:
    return hashlib.sha256(proof).hexdigest()


@pytest.fixture(scope="module")
def port_full(tmp_path_factory):
    """The port's checkpointed prove from a directory holding only SEED:
    the JAX package's bytes."""
    path = tmp_path_factory.mktemp("port") / "ck"
    with pytest.MonkeyPatch.context() as mp:
        lowmem_env(mp)
        proof, _vk, _srs = port_prove(seeded(path))
    assert sha(proof) == JAX_PROOF_SHA256
    return str(path)


@pytest.fixture()
def lowmem(monkeypatch):
    lowmem_env(monkeypatch)


def test_full_then_resume_identical(port_full, lowmem, tmp_path):
    """Everything cached: a fresh process state re-proves the same bytes."""
    path = tmp_path / "ck"
    shutil.copytree(port_full, path)
    proof, _vk, _srs = port_prove(ProveCheckpoint(str(path), FP))
    assert sha(proof) == JAX_PROOF_SHA256


# ~6 s each on the CPU: slow tier, to keep the new files inside tier-1's time
@pytest.mark.parametrize(
    "cut", [pytest.param(c, marks=pytest.mark.slow, id=f"after_{PHASES[c - 1]}") for c in (1, 2)]
)
def test_resume_from_each_phase(port_full, lowmem, tmp_path, cut):
    path = tmp_path / "ck"
    shutil.copytree(port_full, path)
    cut_phases(path, cut)
    proof, _vk, _srs = port_prove(ProveCheckpoint(str(path), FP))
    assert sha(proof) == JAX_PROOF_SHA256, f"resume after cutting {PHASES[cut:]} diverged"


def test_partial_cosets_resume(port_full, lowmem, tmp_path):
    path = tmp_path / "ck"
    shutil.copytree(port_full, path)
    cut_phases(path, 3, cosets="half")
    assert len(list(path.glob("coset_*.npy"))) == 4
    proof, _vk, _srs = port_prove(ProveCheckpoint(str(path), FP))
    assert sha(proof) == JAX_PROOF_SHA256
    assert len(list(path.glob("coset_*.npy"))) == 8


def test_fingerprint_mismatch_resets(port_full, tmp_path):
    path = tmp_path / "ck"
    shutil.copytree(port_full, path)
    ck = ProveCheckpoint(str(path), FP)
    ck2 = ProveCheckpoint(str(path), "fp-2")
    assert not ck2.has_points("p1_advice") and not ck2.has_coset(0) and not ck2.has_lookup(0)
    assert ck2.seed != ck.seed
    assert sorted(p.name for p in path.iterdir()) == ["meta.json"]


def test_unreadable_checkpoint_is_an_error(port_full, tmp_path):
    """A checkpoint file that does not read raises: no silent fresh start."""
    path = tmp_path / "ck"
    shutil.copytree(port_full, path)
    (path / "coset_0.npy").write_bytes(b"not an array")
    with pytest.raises(ValueError):
        ProveCheckpoint(str(path), FP).coset(0, lambda: pytest.fail("recomputed"))


def test_assign_cache_cold_then_warm(lowmem, tmp_path, monkeypatch):
    """Keygen writes the cache (cold), the prove reads it (warm): the JAX
    package's bytes; a second keygen reads it without assigning, to the
    same vk."""
    cache = tmp_path / "assign"
    monkeypatch.setenv("SPT_ASSIGN_CACHE", str(cache))
    proof, vk, srs = port_prove(seed=SEED)
    assert (cache / "advice.npy").exists() and (cache / "copies.pkl").exists()
    assert sha(proof) == JAX_PROOF_SHA256
    calls = []
    monkeypatch.setattr(TorchC, "assign", lambda *a: calls.append(a))
    _pk, warm_vk = tkeygen(srs, K, TorchC(), INST)
    assert calls == [] and warm_vk.to_bytes() == vk.to_bytes()


# the packed case bounds residency too; the limbs case (~8 s) is slow tier
@pytest.mark.parametrize(
    "pack", [pytest.param(False, marks=pytest.mark.slow, id="limbs"), pytest.param(True, id="packed")]
)
def test_bounded_residency_identical(lowmem, monkeypatch, pack):
    """SPT_VALS_RESIDENT / SPT_ADVICE_COEFF_RESIDENT bound the device
    columns (LRU value sources, lazy advice coefficient forms) and
    SPT_PACK_RESIDENT packs what stays; a fresh prove gives the JAX
    package's bytes."""
    monkeypatch.setenv("SPT_VALS_RESIDENT", "2")
    monkeypatch.setenv("SPT_ADVICE_COEFF_RESIDENT", "1")
    monkeypatch.setattr(TPR, "_PACK", pack)
    proof, _vk, _srs = port_prove(seed=SEED)
    assert sha(proof) == JAX_PROOF_SHA256
