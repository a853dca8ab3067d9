"""Rank bodies of the port's tests over torch.distributed: gloo ranks on the
CPU, started from a file store, one process each.

A spawned child imports the module of the function it runs, and the test
files import the JAX package, so the ranks' code lives here: this module
imports torch and the port only. `spawn` starts `world` ranks of one case
and returns each rank's result (a rank pickles it into the run's
directory)."""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def spawn(world: int, tmp_dir: str, case: str, *args) -> list:
    """Run `case(mesh, *args)` on `world` gloo ranks (threads capped at one
    each) under tmp_dir; returns the ranks' results in rank order."""
    import torch.multiprocessing as mp

    run_dir = os.path.join(tmp_dir, f"{case}_world{world}")
    os.makedirs(run_dir)
    mp.start_processes(_rank_main, args=(world, run_dir, case, args), nprocs=world, join=True,
                       start_method="spawn")
    out = []
    for rank in range(world):
        with open(os.path.join(run_dir, f"rank{rank}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _rank_main(rank: int, world: int, run_dir: str, case: str, args) -> None:
    import torch.distributed as dist

    from scroll_prover_tpu_torch.parallel import init_process_group, make_mesh

    torch.set_num_threads(1)
    init_process_group(os.path.join(run_dir, "store"), rank, world, "cpu")
    try:
        out = globals()[case](make_mesh(world), *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(run_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def sharded_cases(mesh, msm_cases, ntt_cases) -> dict:
    """msm_cases: [(points (n, 2, 16) uint32 Montgomery affine, scalars (n,
    16) uint32 standard)]; ntt_cases: [(k, k1 or None, x (2^k, 16) uint32
    Montgomery)]. Returns each MSM's point by `msm_sharded` (decoded) and by
    `msm_tile_sharded`, and each NTT's `ShardedDomain.ntt_flat` limbs."""
    from scroll_prover_tpu_torch.fields.limbs import limbs_from_torch, limbs_to_torch
    from scroll_prover_tpu_torch.ops import ec
    from scroll_prover_tpu_torch.ops.ntt import EvaluationDomain
    from scroll_prover_tpu_torch.parallel.msm_sharded import msm_sharded, msm_tile_sharded
    from scroll_prover_tpu_torch.parallel.ntt_sharded import ShardedDomain

    out = {"msm": [], "msm_tile": [], "ntt": []}
    for pts, scs in msm_cases:
        p, s = limbs_to_torch(pts, "cpu"), limbs_to_torch(scs, "cpu")
        out["msm"].append(ec.decode_point(msm_sharded(mesh, p, s)))
        out["msm_tile"].append(msm_tile_sharded(mesh, p, s))
    for k, k1, x in ntt_cases:
        sdom = ShardedDomain(EvaluationDomain(k), mesh, k1)
        out["ntt"].append(limbs_from_torch(sdom.ntt_flat(limbs_to_torch(x, "cpu"))))
    return out


def routed_proof(mesh, k: int, rows: int, instance, seed: bytes, multiopen: str) -> dict:
    """BenchCircuit(rows) keyed and proved at degree k on the CPU with every
    commit of at least 2^k points routed over the mesh
    (SPT_DEVICE_MSM_THRESHOLD = 2^k). Returns the proof bytes and the count
    of routed and host commits."""
    from scroll_prover_tpu_torch.curves import bn254_curve
    from scroll_prover_tpu_torch.integration.bench_circuit import BenchCircuit
    from scroll_prover_tpu_torch.proof_system import kzg
    from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen
    from scroll_prover_tpu_torch.proof_system.plonk.prover import prove

    srs = kzg.SRS.generate(k, device="cpu")
    circ = BenchCircuit(rows)
    pk, _vk = keygen(srs, k, circ)
    counts = {"routed": 0, "host": 0}
    sharded, host = kzg._commit_sharded, bn254_curve.host_msm_jac

    def routed(*a):
        counts["routed"] += 1
        return sharded(*a)

    def on_host(*a):
        counts["host"] += 1
        return host(*a)

    os.environ["SPT_DEVICE_MSM_THRESHOLD"] = str(1 << k)
    kzg._commit_sharded, bn254_curve.host_msm_jac = routed, on_host
    kzg.set_commit_mesh(mesh)
    try:
        proof = prove(srs, pk, circ, instance, seed=seed, multiopen=multiopen)
    finally:
        kzg.set_commit_mesh(None)
        kzg._commit_sharded, bn254_curve.host_msm_jac = sharded, host
        del os.environ["SPT_DEVICE_MSM_THRESHOLD"]
    return {"proof": proof, **counts}


def as_arrays(points, scalars):
    """Host points and scalars -> the uint32 arrays `sharded_cases` takes."""
    from scroll_prover_tpu_torch.fields.limbs import ints_to_limbs
    from scroll_prover_tpu_torch.ops import ec

    return np.asarray(ec.encode_affine_mont(points)), np.asarray(ints_to_limbs(scalars))
