"""The port's spans and counters (scroll_prover_tpu_torch/trace.py) on the
CPU: nothing recorded and no profiler range while tracing is off; span
trees, threads and the collector's pauses while it is on; a small keygen
and prove (tests/test_torch_plonk.py's circuit with a lookup, K = 6) giving
the prove's nine phases in protocol order and the circuit assigned once in
keygen and once in the prove; the prover's "prove[...]" log lines either
way; each span once as a "spt." range of a torch.profiler profile; and a
replayed transaction through the frontend and the super circuit's
assignment, one span a sub-circuit."""
import gc
import logging
import threading
from collections import Counter

import pytest
import torch

from scroll_prover_tpu_torch import trace
from scroll_prover_tpu_torch.proof_system import kzg
from scroll_prover_tpu_torch.proof_system.plonk import prover
from scroll_prover_tpu_torch.proof_system.plonk.keygen import keygen
from tests.test_torch_plonk import INSTANCE, SEED, TorchMul
from tests.torch_trace_cases import word_arith_trace_dict

torch.set_num_threads(2)

K = 6
PHASES = ["prove.assign", "prove.advice", "prove.lookups", "prove.grand_products", "prove.coeff_forms",
          "prove.quotient", "prove.quotient_commit", "prove.evals", "prove.multiopen"]
# the labels of the prove's log lines (chip_smoke.py's prove_marks reads them), a SHPLONK prove
LABELS = ["assigned", "advice committed", "lookups committed", "grand products committed", "coefficient forms",
          "quotient built", "quotient committed", "evals written", "multiopen done (shplonk)"]
# the super circuit's sub-circuits in the order they are assigned
SUB_CIRCUITS = ["pi", "tx", "keccak", "bytecode", "evm", "copy", "state", "exp", "poseidon", "mpt", "sig",
                "ecc", "mod_exp", "keccak_f", "rlp", "sha256"]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _run(srs, on: bool) -> dict:
    """Keygen and a SHPLONK prove under a CPU profile, with tracing on or off
    inside it: the spans, the profile's "spt." ranges, the prove's log lines
    and the proof."""
    lines = _Lines()
    log = logging.getLogger(prover.__name__)
    level = log.level
    log.setLevel(logging.INFO)
    log.addHandler(lines)
    trace.drain()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            trace.enable(on)
            try:
                circ = TorchMul()
                pk, _vk = keygen(srs, K, circ)
                proof = prover.prove(srs, pk, circ, INSTANCE, seed=SEED, multiopen="shplonk")
            finally:
                trace.enable(False)
    finally:
        log.removeHandler(lines)
        log.setLevel(level)
    events = prof.profiler.kineto_results.events()  # raw events: a prove's FunctionEvents take tens of seconds to build
    return {"spans": trace.drain(), "ranges": [e.name() for e in events if e.name().startswith("spt.")],
            "lines": [m for m in lines.lines if m.startswith("prove[")], "proof": proof}


@pytest.fixture(scope="module")
def runs():
    srs = kzg.SRS.generate(K, device="cpu")
    return {"off": _run(srs, False), "on": _run(srs, True)}


def test_off_records_nothing(runs):
    assert trace.span("anything", columns=1) is trace.OFF
    with trace.span("anything") as sp:
        sp.set(rows=1)
    assert trace.drain() == []
    off = runs["off"]
    assert off["spans"] == [] and off["ranges"] == []
    assert off["proof"] == runs["on"]["proof"]  # tracing changes no byte of the proof


def test_span_tree_and_threads():
    trace.drain()
    trace.enable(True)
    try:
        with trace.span("outer", columns=2) as outer:
            with trace.span("inner") as inner:
                with trace.span("leaf") as leaf:
                    leaf.set(rows=3)
            got = {}

            def work():
                with trace.span("other") as sp:
                    got["other"] = sp

            t = threading.Thread(target=work)
            t.start()
            t.join()
            with trace.span("second") as second:
                pass
    finally:
        trace.enable(False)
    spans = {s.name: s for s in trace.drain() if s.name != "gc"}
    assert sorted(spans) == ["inner", "leaf", "other", "outer", "second"]
    assert (outer.parent, outer.root) == (0, outer.id)
    assert (inner.parent, inner.root) == (outer.id, outer.id)
    assert (leaf.parent, leaf.root) == (inner.id, outer.id)
    assert (second.parent, second.root) == (outer.id, outer.id)
    other = got["other"]
    assert (other.parent, other.root) == (0, other.id)  # the thread's own tree
    assert outer.attrs == {"columns": 2} and leaf.attrs == {"rows": 3}
    for sp in spans.values():
        assert 0 < sp.start_ns <= sp.end_ns
    for child, parent in ((inner, outer), (leaf, inner), (second, outer)):
        assert parent.start_ns <= child.start_ns and child.end_ns <= parent.end_ns


def test_prove_phases_and_assignments(runs):
    spans = runs["on"]["spans"]
    by_id = {s.id: s for s in spans}
    (prove,) = [s for s in spans if s.name == "prove"]
    (kg,) = [s for s in spans if s.name == "keygen"]
    phases = [s for s in spans if s.parent == prove.id and s.name != "gc"]
    assert [s.name for s in phases] == PHASES
    for a, b in zip(phases, phases[1:]):
        assert a.end_ns <= b.start_ns
    assert all(prove.start_ns <= s.start_ns and s.end_ns <= prove.end_ns for s in phases)
    assigned = [s for s in spans if s.name == "circuit.assign"]
    assert [by_id[s.parent].name for s in assigned] == ["keygen", "prove.assign"]
    assert assigned[0].root == kg.id and assigned[1].root == prove.id
    assert all(s.attrs == {"cache_hit": 0} for s in assigned)
    kids = Counter(s.name for s in spans if s.parent == kg.id)
    assert {"circuit.assign", "keygen.permutation", "keygen.fixed", "keygen.sigma"} <= set(kids)
    # the transforms and the codec run inside the phases they serve
    assert any(s.name == "ntt" and by_id[s.parent].name == "prove.coeff_forms" for s in spans)
    assert any(s.name == "codec" and by_id[s.parent].name == "prove.advice" for s in spans)


@pytest.mark.parametrize("side", ["off", "on"])
def test_prove_log_lines(runs, side):
    """chip_smoke.py's reader takes the label between "prove[" and "]"."""
    lines = runs[side]["lines"]
    assert [m[len("prove["):m.index("]")] for m in lines] == LABELS
    secs = [float(m[m.index("] ") + 2:].removesuffix("s")) for m in lines]
    assert secs == sorted(secs)


def test_collector_pause_is_a_span():
    trace.drain()
    trace.enable(True)
    try:
        with trace.span("work") as work:
            gc.collect()
    finally:
        trace.enable(False)
    assert gc.callbacks.count(trace._on_gc) == 0
    spans = trace.drain()
    pauses = [s for s in spans if s.name == "gc" and s.parent == work.id]
    assert pauses and pauses[0].attrs == {}
    assert work.start_ns <= pauses[0].start_ns <= pauses[0].end_ns <= work.end_ns


def test_profile_ranges_match_spans(runs):
    on = runs["on"]
    assert Counter(on["ranges"]) == Counter("spt." + s.name for s in on["spans"])


def test_summary_counts_the_outermost_span_of_a_name(runs):
    trace.drain()
    trace.enable(True)
    try:
        with trace.span("codec") as outer:
            with trace.span("codec") as inner:
                pass
            with trace.span("ntt"):
                pass
    finally:
        trace.enable(False)
    rows = trace.summary([s for s in trace.drain() if s.name != "gc"])
    assert rows["codec"]["calls"] == 2 and rows["codec"]["attrs"] == {}
    assert rows["codec"]["total_s"] == (outer.end_ns - outer.start_ns) / 1e9
    assert 0 <= rows["codec"]["self_s"] <= rows["codec"]["total_s"] + (inner.end_ns - inner.start_ns) / 1e9
    # over the traced prove: the self seconds of the prove's tree add up to the prove
    spans = runs["on"]["spans"]
    (prove,) = [s for s in spans if s.name == "prove"]
    rows = trace.summary([s for s in spans if s.root == prove.id])
    whole = (prove.end_ns - prove.start_ns) / 1e9
    assert rows["prove"]["calls"] == 1 and rows["prove"]["total_s"] == whole
    assert sum(r["self_s"] for r in rows.values()) == pytest.approx(whole, rel=1e-3)
    assert all(r["self_s"] >= 0 for r in rows.values())
    # counts are summed by name: the elements of every column the prove encodes
    codec = [s for s in spans if s.name == "codec" and s.root == prove.id]
    assert codec and all(0 < s.attrs["elements"] <= 1 << K for s in codec)
    assert rows["codec"]["attrs"] == {"elements": sum(s.attrs["elements"] for s in codec)}


def test_frontend_and_assignment_spans():
    """A transaction that replays: the witness block's replay, its absorption
    and the hashing under it; the circuit's assignment one span a
    sub-circuit, in the order they are assigned."""
    from scroll_prover_tpu_torch.l2types import BlockTrace
    from scroll_prover_tpu_torch.proof_system.plonk.cs import ConstraintSystem, assign_cached
    from scroll_prover_tpu_torch.proof_system.plonk.mock import _pad_instance
    from scroll_prover_tpu_torch.witness import chunk_trace_to_witness_block
    from scroll_prover_tpu_torch.zkevm import ScrollSuperCircuit, chunk_instance

    trace.drain()
    trace.enable(True)
    try:
        wb = chunk_trace_to_witness_block([BlockTrace.from_json(word_arith_trace_dict(["MUL", "LT"]))])
        circ = ScrollSuperCircuit.new_from_block(wb)
        k = circ.min_k()
        cs = ConstraintSystem()
        circ.configure(cs)
        assign_cached(circ, cs, 1 << k, _pad_instance(cs, 1 << k, [chunk_instance(wb)]))
    finally:
        trace.enable(False)
    spans = [s for s in trace.drain() if s.name != "gc"]
    by_id = {s.id: s for s in spans}
    assert wb.replayed_txs == wb.num_txs == 1
    tops = [s.name for s in spans if s.parent == 0 and s.name != "keccak"]
    assert tops == ["witness.parse", "witness.block", "circuit.new_from_block", "circuit.min_k", "circuit.assign"]
    (block,) = [s for s in spans if s.name == "witness.block"]
    kids = [s.name for s in spans if s.parent == block.id and s.name != "keccak"]
    assert kids == ["witness.replay", "witness.absorb"]
    (replay,) = [s for s in spans if s.name == "witness.replay"]
    assert replay.attrs == {"steps": wb.num_steps}
    hashed = {by_id[s.parent].name for s in spans if s.name == "keccak" and s.root == block.id}
    assert {"witness.block", "witness.replay", "witness.absorb"} <= hashed
    (assign,) = [s for s in spans if s.name == "circuit.assign"]
    subs = [s.name for s in spans if s.parent == assign.id and s.name != "keccak"]
    assert subs == ["circuit.assign." + name for name in SUB_CIRCUITS]
