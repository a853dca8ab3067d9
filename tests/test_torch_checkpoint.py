"""Checkpoint/resume parity at K = 6 across the two packages
(tests/test_prove_checkpoint.py's circuit and cuts).

One JAX lowmem keygen and checkpointed prove (seed SEED, assignment cache
on) is shared by the file; its proof's sha256 is the pin the port-only file
(test_torch_checkpoint_port.py) holds the port's proofs against. Here: the
port's lowmem vk bytes and keygen commits equal the JAX package's; a
checkpoint the port writes from its seed holds the JAX package's files bit
for bit and gives its proof; the JAX-written checkpoint, cut at each later
phase boundary from phase 3 on, resumes in the port to the JAX package's
bytes (the cut before the first phase is the port's own from-seed prove,
the cuts after phases 1 and 2 are in the port-only file); a port-written
checkpoint, cut inside the quotient, resumes in the JAX package to the same
bytes; and each package's assignment cache loads in the other."""
import hashlib
import json
import os
import shutil

import numpy as np
import pytest

import scroll_prover_tpu.proof_system.plonk.prover as JPR
from scroll_prover_tpu.proof_system import kzg as jkzg
from scroll_prover_tpu.proof_system.plonk.checkpoint import ProveCheckpoint as JCheckpoint
from scroll_prover_tpu.proof_system.plonk.keygen import keygen as jkeygen
from scroll_prover_tpu_torch.proof_system import kzg as tkzg
from scroll_prover_tpu_torch.proof_system.plonk.checkpoint import ProveCheckpoint
from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen as tkeygen
from tests.torch_checkpoint_cases import (
    FP, INST, JAX_PROOF_SHA256, K, PHASES, C, TorchC, cut_phases, lowmem_env, port_prove, seeded,
)


def _jax_prove(ck_dir, assign_dir=None):
    """The JAX package's lowmem keygen and checkpointed prove over `ck_dir`
    (seeded with SEED when new). Returns (proof, vk)."""
    with pytest.MonkeyPatch.context() as mp:
        lowmem_env(mp)
        if assign_dir is not None:
            mp.setenv("SPT_ASSIGN_CACHE", str(assign_dir))
        srs = jkzg.SRS.generate(K)
        ck = JCheckpoint(str(ck_dir), FP)
        if not ck.meta["points"]:
            ck = seeded(ck_dir, cls=JCheckpoint)
        circ = C()
        pk, vk = jkeygen(srs, K, circ, INST, ckpt=ck)
        return JPR.prove(srs, pk, circ, INST, ckpt=ck), vk


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's run: vk bytes, proof bytes, checkpoint directory and
    assignment cache."""
    root = tmp_path_factory.mktemp("jax")
    proof, vk = _jax_prove(root / "ck", root / "assign")
    return {"vk": vk.to_bytes(), "proof": proof, "dir": str(root / "ck"), "assign": str(root / "assign")}


@pytest.fixture(scope="module")
def port_full(tmp_path_factory):
    """The port's lowmem keygen and checkpointed prove from a directory
    that holds only SEED (test_torch_checkpoint_port.py verifies it)."""
    path = tmp_path_factory.mktemp("port") / "ck"
    with pytest.MonkeyPatch.context() as mp:
        lowmem_env(mp)
        proof, vk, _srs = port_prove(seeded(path))
    return {"proof": proof, "dir": str(path), "vk": vk.to_bytes()}


@pytest.fixture()
def lowmem(monkeypatch):
    lowmem_env(monkeypatch)


def test_jax_proof_is_the_pinned_proof(jax_ref):
    assert hashlib.sha256(jax_ref["proof"]).hexdigest() == JAX_PROOF_SHA256


def test_lowmem_vk_bytes_equal_jax(jax_ref, port_full, lowmem, monkeypatch):
    assert port_full["vk"] == jax_ref["vk"]
    with open(os.path.join(jax_ref["dir"], "meta.json")) as fh:
        jmeta = json.load(fh)
    with open(os.path.join(port_full["dir"], "meta.json")) as fh:
        tmeta = json.load(fh)
    for tag in ("kg_fixed", "kg_sigma"):
        assert tmeta["points"][tag] == jmeta["points"][tag]
    # the resident keygen's vk is the same
    monkeypatch.delenv("SPT_LOWMEM")
    _pk, vk = tkeygen(tkzg.SRS.generate(K, device="cpu"), K, TorchC(), INST)
    assert vk.to_bytes() == jax_ref["vk"]


def test_port_checkpoint_is_the_jax_checkpoint(jax_ref, port_full):
    """The port's from-seed checkpoint (the cut before the first phase): the
    JAX package's proof, and its files bit for bit."""
    assert port_full["proof"] == jax_ref["proof"]
    jdir, tdir = jax_ref["dir"], port_full["dir"]
    names = sorted(f for f in os.listdir(jdir) if f.endswith((".npy", ".npz")))
    assert names == sorted(f for f in os.listdir(tdir) if f.endswith((".npy", ".npz")))
    assert any(f.startswith("coset_") for f in names) and any(f.startswith("lookup_") for f in names)
    for f in names:
        if f.endswith(".npy"):
            got, want = np.load(os.path.join(tdir, f)), np.load(os.path.join(jdir, f))
            assert got.dtype == want.dtype == np.uint32 and np.array_equal(got, want), f
            continue
        with np.load(os.path.join(tdir, f)) as got, np.load(os.path.join(jdir, f)) as want:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                assert got[key].dtype == want[key].dtype == np.uint32, (f, key)
                assert np.array_equal(got[key], want[key]), (f, key)
    with open(os.path.join(tdir, "meta.json")) as fh, open(os.path.join(jdir, "meta.json")) as gh:
        assert json.load(fh) == json.load(gh)


@pytest.mark.parametrize("cut", [3, 4], ids=[f"after_{p}" for p in PHASES[2:4]])
def test_jax_checkpoint_resumes_from_each_phase(jax_ref, lowmem, tmp_path, cut):
    """test_prove_checkpoint's resume_from_each_phase, on a copy of the
    JAX-written directory, resumed by the port: the cuts inside and after
    the quotient. The earlier cuts resume from the port-written directory
    in test_torch_checkpoint_port.py, which is this one's files bit for bit
    (test_port_checkpoint_is_the_jax_checkpoint)."""
    path = tmp_path / "ck"
    shutil.copytree(jax_ref["dir"], path)
    cut_phases(path, cut)
    proof, _vk, _srs = port_prove(ProveCheckpoint(str(path), FP))
    assert proof == jax_ref["proof"], f"resume after cutting {PHASES[cut:]} diverged"


def test_port_checkpoint_resumes_in_jax(jax_ref, port_full, tmp_path):
    """A port-written checkpoint, cut after phase 3 with half of its cosets
    left, resumed by the JAX package."""
    path = tmp_path / "ck"
    shutil.copytree(port_full["dir"], path)
    cut_phases(path, 3, cosets="half")
    proof, _vk = _jax_prove(path)
    assert proof == jax_ref["proof"]


def test_assign_caches_load_across_packages(jax_ref, lowmem, tmp_path, monkeypatch):
    """The JAX package's assignment cache (written by its keygen) loads in
    the port's keygen, and the port's in the JAX package's: the same vk
    either way (neither keygen assigns), and the two caches' tables are the
    same words."""
    monkeypatch.setenv("SPT_ASSIGN_CACHE", jax_ref["assign"])
    _pk, vk = tkeygen(tkzg.SRS.generate(K, device="cpu"), K, _Loaded(TorchC)(), INST)
    assert vk.to_bytes() == jax_ref["vk"]
    mine = tmp_path / "assign"
    monkeypatch.setenv("SPT_ASSIGN_CACHE", str(mine))
    tkeygen(tkzg.SRS.generate(K, device="cpu"), K, TorchC(), INST)
    for f in ("advice.npy", "fixed.npy"):
        assert np.array_equal(np.load(mine / f), np.load(os.path.join(jax_ref["assign"], f))), f
    with open(mine / "meta.json") as fh, open(os.path.join(jax_ref["assign"], "meta.json")) as gh:
        assert json.load(fh) == json.load(gh)
    _pk, jvk = jkeygen(jkzg.SRS.generate(K), K, _Loaded(C)(), INST)
    assert jvk.to_bytes() == jax_ref["vk"]


def _Loaded(cls):
    """`cls` whose assign() must not run: its tables come from a cache."""

    class Loaded(cls):
        def assign(self, cs, n, instance):
            raise AssertionError("assigned instead of loading the cache")

    return Loaded
