"""Driver for the chunk's inner proof (configurations of "driver":
"chunk_inner"): each task is a chunk of block traces, turned into a
witness block and a ScrollSuperCircuit by the port's frontend, keyed, and
proved.

Each chunk is keyed anew: the port's super circuit holds chunk data in
some fixed columns, so a key made for one chunk does not prove another
(the port's verifier rejects the proof, or the prove stops on a lookup;
PERF.md, Open questions). Keying every chunk is the path on which the port
proves a chunk correctly today.

Set-up: the SRS from the seed on the card (SRS.generate_fast, K5), and one
warm-up task (task -1 of the mix: witness, keygen, prove), which builds
the prover's device tables and counts the NTT and MSM calls a prove
makes."""
from __future__ import annotations

from benchlib import traffic


def _frontend(traces, k: int):
    """Witness block, circuit and instance of a chunk. Every transaction
    must replay opcode by opcode: a statistical witness (the port's
    fallback) is not what a chunk of real traces makes."""
    from scroll_prover_tpu_torch.l2types import BlockTrace
    from scroll_prover_tpu_torch.witness import chunk_trace_to_witness_block
    from scroll_prover_tpu_torch.zkevm import ScrollSuperCircuit, chunk_instance

    wb = chunk_trace_to_witness_block([BlockTrace.from_json(t) for t in traces])
    if wb.replayed_txs != wb.num_txs:
        raise RuntimeError(f"{wb.num_txs - wb.replayed_txs} of the chunk's {wb.num_txs} transactions did not replay")
    circ = ScrollSuperCircuit.new_from_block(wb)
    got = circ.min_k()
    if got != k:
        raise RuntimeError(f"the chunk's min_k is {got}, not the configuration's {k}")
    return circ, [chunk_instance(wb)]


def _slim(traces):
    """What the reference needs of a chunk's traces: no struct logs."""
    return [{key: v for key, v in t.items() if key != "executionResults"} for t in traces]


def setup(ctx) -> dict:
    from scroll_prover_tpu_torch.proof_system.kzg import SRS

    srs = SRS.generate_fast(ctx.config["k"], seed=ctx.srs_seed, device=ctx.device)
    ctx.hooks.register_srs(srs)
    state = {"srs": srs}
    out = task(state, ctx, traffic.make_task(ctx.traffic, ctx.seed, -1))
    if out["shape"] != ctx.config["columns"]:
        raise RuntimeError(f"the circuit's shape {out['shape']} is not the configuration's {ctx.config['columns']}")
    return state


def task(state, ctx, inputs) -> dict:
    from scroll_prover_tpu_torch.proof_system.plonk import prover as pv
    from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen

    cfg = ctx.config
    with ctx.tracer.span("witness"):
        circ, inst = _frontend(inputs["traces"], cfg["k"])
    if "instance" in ctx.faults:
        inst = [inst[0][:-1] + [inst[0][-1] + 1]]
    with ctx.tracer.span("keygen"):
        pk, vk = keygen(state["srs"], cfg["k"], circ, inst)
    with ctx.tracer.span("prove"), ctx.hooks.prove():
        proof = pv.prove(state["srs"], pk, circ, inst, seed=inputs["prove_seed"], multiopen=cfg["multiopen"])
    cs = vk.cs
    vk.cs.copies, vk.cs._copy_set = [], set()  # keygen's input; the verifier needs none
    return {"proofs": [(proof, inst[0], vk)], "instance": inst[0], "traces": _slim(inputs["traces"]),
            "shape": {"advice": cs.num_advice, "fixed": cs.num_fixed, "permutation": len(cs.perm_columns),
                      "lookups": len(cs.lookups), "gates": len(cs.gates)}}


def verify(state, ctx, records) -> int:
    """Proofs that the port's own verifier rejects, each with its chunk's vk."""
    from scroll_prover_tpu_torch.proof_system.plonk.verifier import verify as pv_verify

    return sum(not pv_verify(state["srs"], vk, [inst], proof, multiopen=ctx.config["multiopen"])
               for r in records for proof, inst, vk in r["proofs"])


def reference(ctx, records, tau: int) -> dict:
    """{number: value} of the driver's own comparisons: public instances
    that differ from the reference's, worked out from the traces."""
    from benchref import checks

    return {"instance_bad": sum(r["instance"] != checks.chunk_instance(r["traces"]) for r in records)}
