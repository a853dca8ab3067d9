"""A CPU-sized cell added from new files alone: a copy of the benchmark
beside a new driver, configuration, traffic mix and metric, and a
BENCHMARK.json with the new cell and metric entries. The tests drive
whole runs of it on the CPU through `harness.run`, which skips the look
for a card."""
from __future__ import annotations

import json
import os
import shutil
import time

from conftest import BENCH, ROOT

DRIVER = '''"""An inner BenchCircuit proof per task."""
from benchlib import traffic


def setup(ctx):
    from scroll_prover_tpu_torch.integration.bench_circuit import BenchCircuit
    from scroll_prover_tpu_torch.proof_system.kzg import SRS
    from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen
    from scroll_prover_tpu_torch.proof_system.plonk.prover import prove

    cfg = ctx.config
    srs = SRS.generate_fast(cfg["k"], seed=ctx.srs_seed, device=ctx.device)
    ctx.hooks.register_srs(srs)
    first = traffic.make_task(ctx.traffic, ctx.seed, -1)
    circ = BenchCircuit(cfg["rows"])
    pk, vk = keygen(srs, cfg["k"], circ, [first["instance"]])
    with ctx.hooks.prove():
        prove(srs, pk, circ, [first["instance"]], seed=first["prove_seed"], multiopen=cfg["multiopen"])
    return {"srs": srs, "pk": pk, "vk": vk, "circ": circ}


def task(state, ctx, inputs):
    from scroll_prover_tpu_torch.proof_system.plonk.prover import prove

    inst = list(inputs["instance"])
    if "instance" in ctx.faults:
        inst[1] += 1
    with ctx.tracer.span("prove"), ctx.hooks.prove():
        proof = prove(state["srs"], state["pk"], state["circ"], [inst], seed=inputs["prove_seed"],
                      multiopen=ctx.config["multiopen"])
    return {"proofs": [(proof, inst)], "instance": inst, "inner_instance": inputs["instance"]}


def verify(state, ctx, records):
    from scroll_prover_tpu_torch.proof_system.plonk.verifier import verify as pv_verify

    return sum(not pv_verify(state["srs"], state["vk"], [inst], proof, multiopen=ctx.config["multiopen"])
               for r in records for proof, inst in r["proofs"])


def reference(ctx, records, tau):
    return {"instance_bad": sum(r["instance"] != r["inner_instance"] for r in records)}
'''

METRIC = '''def read(r):
    return float(r.tasks)
'''

GENERATOR = '''"""One inner proof's public instance per task: a 9-cell chunk instance,
cell 0 below the mix's bound, the others 128-bit halves."""


def make(p, rng, task_seed):
    inst = [rng.randrange(p["cell0_below"])] + [rng.randrange(1 << 128) for _ in range(p["instance_cells"] - 1)]
    return {"instance": inst, "prove_seed": task_seed("blind")}
'''

CELL = "tiny.inner"


def build(dest: str) -> str:
    """The copy and the new files under `dest`; returns the new root."""
    shutil.copytree(BENCH, os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = os.path.join(dest, "benchmark")
    with open(os.path.join(b, "drivers", "tiny_inner.py"), "w") as fh:
        fh.write(DRIVER)
    with open(os.path.join(b, "metrics", "tasks_done.py"), "w") as fh:
        fh.write(METRIC)
    with open(os.path.join(b, "generators", "tiny_instances.py"), "w") as fh:
        fh.write(GENERATOR)
    with open(os.path.join(b, "configs", "tiny_k6.json"), "w") as fh:
        json.dump({"name": "tiny_k6", "driver": "tiny_inner", "k": 6, "rows": 16, "multiopen": "shplonk"}, fh)
    with open(os.path.join(b, "traffic", "tiny_inner.json"), "w") as fh:
        json.dump({"kind": "tiny_instances", "loop": "closed", "clients": 1, "instance_cells": 9,
                   "cell0_below": 32}, fh)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["configs"].append({"name": "tiny_k6", "source": "https://example.org/tiny", "why": "CPU test",
                            "file": "benchmark/configs/tiny_k6.json", "reduced": []})
    spec["workloads"].append({"name": CELL, "config": "tiny_k6", "traffic": "tiny_inner", "chips": 1,
                              "why": "CPU test"})
    spec["end_to_end"].append({"name": "tasks_done", "unit": "tasks", "better": "higher", "bound": 0.01,
                               "source": "host_clock", "workloads": [CELL]})
    for m in spec["per_layer"]:
        if m["name"] == "prove_s":
            m["workloads"].append(CELL)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return dest


def run(root: str, capsys, seed: int = 2**31 + 17, trace: int = 0, fault: str | None = None,
        seconds: float = 0.01):
    """One whole run on the CPU; returns (result, stderr lines)."""
    import torch
    from benchlib.harness import parse, run as harness_run

    from scroll_prover_tpu_torch.proof_system import kzg

    argv = ["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    if fault:
        argv += ["--fault", fault]
    saved = kzg.DEVICE_MSM_THRESHOLD
    kzg.DEVICE_MSM_THRESHOLD = 16  # the CPU's commits through the device MSM's entry
    try:
        capsys.readouterr()
        rc = harness_run(parse(argv), torch.device("cpu"), root, time.perf_counter())
    finally:
        kzg.DEVICE_MSM_THRESHOLD = saved
    out, err = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1]), err.strip().splitlines()
