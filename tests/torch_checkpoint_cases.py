"""Shared pieces of the checkpoint/resume parity tests at K = 6
(test_torch_checkpoint.py, test_torch_checkpoint_port.py).

The circuit is tests/test_prove_checkpoint.py's (a multiplication gate, a
range lookup, one instance cell copied into the witness), against the port's
API. JAX_PROOF_SHA256 is the sha256 of the JAX package's proof of it with
seed SEED: test_torch_checkpoint.py holds it against a live JAX prove, so a
port proof that matches it matches the JAX package's bytes."""
import torch

import scroll_prover_tpu.proof_system.plonk.prover as JPR
from scroll_prover_tpu_torch.proof_system import kzg as tkzg
from scroll_prover_tpu_torch.proof_system.plonk import Circuit as TorchCircuit
from scroll_prover_tpu_torch.proof_system.plonk import prover as TPR
from scroll_prover_tpu_torch.proof_system.plonk.checkpoint import ProveCheckpoint
from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen as tkeygen
from tests.test_prove_checkpoint import INST, K, C

SEED = bytes(range(32))
FP = "fp-1"
JAX_PROOF_SHA256 = "14dfe4fd38c90c3edb236d514d8786b13c173b298c63350e45e1f1852b60dac5"
# test_prove_checkpoint's phase order: a crash after phase i leaves the
# tags before it
PHASES = ["p1_advice", "p2_perm", "p3", "p4_h", "p6_w"]

__all__ = ["C", "FP", "INST", "JAX_PROOF_SHA256", "K", "PHASES", "SEED", "TorchC", "lowmem_env", "port_prove",
           "seeded", "cut_phases"]


class TorchC(TorchCircuit):
    """tests/test_prove_checkpoint.py's circuit against the port's API."""

    configure = C.configure
    assign = C.assign


def seeded(path, fingerprint=FP, cls=ProveCheckpoint):
    """A checkpoint holding only SEED, as a directory resumed from a crash
    before its first commit would."""
    ck = cls(str(path), fingerprint)
    ck.meta["seed"] = SEED.hex()
    ck._flush()
    return ck


def lowmem_env(mp):
    """SPT_LOWMEM in both packages (keygen reads the variable, the provers
    their module switch), and the JAX package's coset-streaming quotient."""
    mp.setenv("SPT_LOWMEM", "1")
    mp.setenv("SPT_FORCE_STREAM", "1")
    mp.setattr(JPR, "_LOWMEM", True)
    mp.setattr(TPR, "_LOWMEM", True)


def port_prove(ck=None, seed=None):
    """A fresh process's prove: new SRS handle, circuit, keygen and prove
    (checkpointed when `ck` is given, else with `seed`). Returns (proof, vk,
    srs)."""
    torch.set_num_threads(2)
    srs = tkzg.SRS.generate(K, device="cpu")
    circ = TorchC()
    pk, vk = tkeygen(srs, K, circ, INST, ckpt=ck)
    proof = TPR.prove(srs, pk, circ, INST, ckpt=ck, seed=seed)
    return proof, vk, srs


def cut_phases(path, cut: int, cosets: str = "all") -> None:
    """Cut a checkpoint directory as a crash after PHASES[cut - 1] leaves
    it (test_prove_checkpoint's resume_from_each_phase): the later commit
    groups and the evaluations go, the lookups too when cut == 0, and every
    coset file when cut <= 3 (cosets="all") or the second half of them
    (cosets="half")."""
    import json
    import os

    meta_path = os.path.join(path, "meta.json")
    with open(meta_path) as fh:
        meta = json.load(fh)
    for tag in PHASES[cut:]:
        meta["points"].pop(tag, None)
    meta["scalars"].pop("p5_evals", None)
    with open(meta_path, "w") as fh:
        json.dump(meta, fh)
    names = sorted(os.listdir(path))
    cosets_ = sorted((f for f in names if f.startswith("coset_")), key=lambda f: int(f[6:-4]))
    if cosets == "half":
        gone = cosets_[len(cosets_) // 2 :]
    else:
        gone = cosets_ if cut <= 3 else []
    if cut == 0:
        gone += [f for f in names if f.startswith("lookup_")]
    for f in gone:
        os.remove(os.path.join(path, f))
